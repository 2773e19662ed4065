"""Host-side plan types (counterpart of `occuseg_tpu/core/topology.py`).

A plan is built on the host as NumPy arrays (`native/plan.py`), gains its
chunk rulebooks (`ops/kernels/chunk_conv.py`) and sorted point layout
(`core/point_layout.py`), and is then moved to a device with `.to(device)`,
which returns the same dataclasses with the arrays the device reads (chunk
rulebooks, point arrays) as torch tensors there. Active-row counts
stay on the host as Python ints (a tuple of per-scene ints under the
blocked multi-scene layout of `native/blocked.py`), so masks need no
device round trip.

Maps (all padded, -1 = missing):
  * per level: Morton-sorted voxel keys/coords, the submanifold
    neighbor map `nbr[cap, K]` and the orientation class `orient[cap]`
    of each site (zeros unless the plan was built with point normals);
  * per level transition: `child[cap_coarse, 8]` (fine rows feeding each
    coarse site, the strided-conv rulebook) and `up[cap_fine, 8]` (the
    coarse row feeding each fine site, the deconvolution rulebook);
  * `p2v[P]`: point -> level-0 voxel row.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch


def _offsets(kernel: int, dilation: int = 1) -> np.ndarray:
    """Filter offsets [K^3, 3] in (dz,dy,dx), z-major order."""
    lo = -(kernel // 2) if kernel % 2 == 1 else 0
    r = np.arange(lo, lo + kernel) * dilation
    g = np.stack(np.meshgrid(r, r, r, indexing="ij"), axis=-1)
    return g.reshape(-1, 3).astype(np.int32)


def _even_offsets(kernel: int) -> np.ndarray:
    """Offsets [K^3,3] for even (strided) kernels: 0..kernel-1 per axis."""
    r = np.arange(kernel)
    g = np.stack(np.meshgrid(r, r, r, indexing="ij"), axis=-1)
    return g.reshape(-1, 3).astype(np.int32)


def _to(a, device):
    """numpy -> torch tensor on `device`; tensors move; None passes. From
    page-locked memory (`pin`) the copy is queued without the host waiting
    for it, and the host allocator keeps the source block until it is
    done."""
    if a is None:
        return None
    if not isinstance(a, torch.Tensor):
        a = torch.from_numpy(np.ascontiguousarray(a))
    return a.to(device, non_blocking=True)


def pin(a):
    """A copy of NumPy array `a` in page-locked host memory, as a CPU torch
    tensor; None passes. Loader threads pin what a step uploads, so that
    the upload on the main thread neither stages through pageable memory
    nor waits. The tensor itself is the upload's source: its block belongs
    to the CUDA host allocator, which records the copy and does not hand
    the block out again before the copy has run."""
    if a is None:
        return None
    return torch.from_numpy(np.ascontiguousarray(a)).pin_memory()


def _counts(num_active):
    """Host form of an active count: an int, or a tuple of per-scene ints
    for a blocked plan's [ns] vector."""
    if np.ndim(num_active) == 0:
        return int(num_active)
    return tuple(int(n) for n in np.asarray(num_active).reshape(-1))


class _DeviceArrays:
    """`to(device)` and `pinned()` over the arrays a device reads, which
    each plan class names once, in `_map(fn)`. The neighbour, child and up
    maps, keys and coords stay on the host: the model reads only their
    shapes, and the chunk rulebooks and the point arrays on the device
    (and, at a level with normals, `LevelTopology.guided`, the neighbour
    map and the orientation classes)."""

    def _map(self, fn):
        raise NotImplementedError

    def to(self, device):
        """The plan on `device` (active counts as host ints)."""
        return self._map(lambda a: _to(a, device))

    def pinned(self):
        """The arrays `to` uploads, in page-locked host memory (`pin`)."""
        return self._map(pin)


def _map_each(obj, fn):
    return None if obj is None else obj._map(fn)


@dataclasses.dataclass(frozen=True)
class ChunkPlan(_DeviceArrays):
    """Chunk rulebook of one map (host-built by `build_chunk_arrays`):
    chunk c covers output rows [c*M, (c+1)*M); `in_idx[c]` lists the
    sorted distinct input rows they reference (-1 pad at the end) and
    `lidx[c, k, m]` is the position in that list of output row c*M+m's
    neighbor at offset k (-1 missing)."""

    in_idx: object  # int32 [C, U]
    lidx: object    # int32 [C, K, M]

    def _map(self, fn) -> "ChunkPlan":
        return ChunkPlan(in_idx=fn(self.in_idx), lidx=fn(self.lidx))


@dataclasses.dataclass(frozen=True)
class LevelTopology(_DeviceArrays):
    """Active-site set of one scale and its submanifold neighbor map.

    `orient` holds each site's orientation class {0, 2, 4} for the
    normal-guided convolutions (`ops/normal_guide.py`); `guided` says the
    plan carried normals down to this level (`PlanSpec.guide_levels`).
    Its normal-guided convolutions then read `nbr` and `orient` on the
    device, so both are uploaded; elsewhere `orient` is all zeros (the
    identity filter), the chunk rulebook serves them, and both stay on
    the host."""

    keys: object        # int64 [cap], sorted, KEY_PAD padding
    coords: object      # int32 [cap, 4] (b,z,y,x), -1 padding
    num_active: object  # int, or int32 [ns] per-scene counts (blocked)
    nbr: object         # int32 [cap, K] neighbor rows, -1 missing
    orient: object = None  # int32 [cap] orientation class, zeros = identity
    guided: bool = False
    chunks: Optional[ChunkPlan] = None

    @property
    def cap(self) -> int:
        return self.nbr.shape[0]

    def _map(self, fn) -> "LevelTopology":
        guided = fn if self.guided else (lambda a: a)
        return dataclasses.replace(
            self, num_active=_counts(self.num_active), nbr=guided(self.nbr),
            orient=guided(self.orient), chunks=_map_each(self.chunks, fn))


@dataclasses.dataclass(frozen=True)
class LevelTransition(_DeviceArrays):
    """Size-2 stride-2 down/up maps between level l (fine) and l+1
    (coarse)."""

    child: object  # int32 [cap_coarse, 8] fine rows per coarse site
    up: object     # int32 [cap_fine, 8] coarse rows per fine site
    child_chunks: Optional[ChunkPlan] = None
    up_chunks: Optional[ChunkPlan] = None

    def _map(self, fn) -> "LevelTransition":
        return dataclasses.replace(
            self, child_chunks=_map_each(self.child_chunks, fn),
            up_chunks=_map_each(self.up_chunks, fn))


@dataclasses.dataclass(frozen=True)
class Topology(_DeviceArrays):
    """Full multi-scale plan for one scene."""

    levels: Tuple[LevelTopology, ...]
    transitions: Tuple[LevelTransition, ...]
    p2v: object          # int32 [P] point -> level-0 voxel row (-1 pad)
    num_points: int
    # sorted point layout (core/point_layout.py)
    vox_seg: object = None     # int32 [B, 1, R] block-local voxel ids
    vox_counts: object = None  # f32 [cap0] points per voxel
    point_perm: object = None  # int32 [P] slot -> original point (-1 pad)
    # U tier the chunk planner settled on (diagnostics only)
    chunk_tier: object = None

    def _map(self, fn) -> "Topology":
        return dataclasses.replace(
            self, levels=tuple(l._map(fn) for l in self.levels),
            transitions=tuple(t._map(fn) for t in self.transitions),
            p2v=fn(self.p2v), num_points=int(self.num_points),
            vox_seg=fn(self.vox_seg), vox_counts=fn(self.vox_counts),
            point_perm=fn(self.point_perm))


@dataclasses.dataclass(frozen=True)
class PlanSpec:
    """Static description of the multiscale topology a network needs:
    caps[l] is the padded active-site budget at level l. `guide_levels`
    only matters for plans built with point normals."""

    caps: Tuple[int, ...]
    kernel: int = 3
    dilation: int = 1
    down_size: int = 2
    down_stride: int = 2
    # levels 0..guide_levels-1 carry normals and orientation classes (the
    # reference's normal_guide_scale cutoff); None = every level
    guide_levels: Optional[int] = None

    @property
    def num_levels(self) -> int:
        return len(self.caps)
