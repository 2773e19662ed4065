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
  * per level transition of size s and stride t: `child[cap_coarse, s^3]`
    (fine rows feeding each coarse site, the strided-conv rulebook) and
    `up[cap_fine, s^3]` (the coarse row feeding each fine site at each
    offset, the deconvolution rulebook);
  * `p2v[P]`: point -> level-0 voxel row.

The planner that runs on a tensor's device (`build_plan`, counterpart of
the JAX package's in-jit planner) builds the same plan from padded point
coordinates with sorts, searches and lookups over the packed keys of
`core/coords.py`: bit-identical to the JAX planner, and to the host plan
where both apply. It also builds what only it can: dilated
nearest-neighbour maps (`PlanSpec.nn_search`) and permutohedral lattices
(`PlanSpec.lattice`), and the grown level of a `FullConvolution`
(`full_conv_plan`). Its arrays are tensors on that device from the start,
each map also held in the gather convolution's orientation, so `to`
copies nothing; it has no chunk rulebooks and no sorted point layout
(every convolution takes the gather path, the InputLayer the scatter
sum), and its counts are read to the host once, at its end.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import numpy as np
import torch

from occuseg_tpu_torch.core import coords as C
from occuseg_tpu_torch.utils.profiling import count_tensor, span


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
    if not isinstance(a, torch.Tensor):
        a = torch.from_numpy(np.ascontiguousarray(a))
    return a.pin_memory()


def _counts(num_active):
    """Host form of an active count: an int, or a tuple of per-scene ints
    for a blocked plan's [ns] vector."""
    if np.ndim(num_active) == 0:
        return int(num_active)
    return tuple(int(n) for n in np.asarray(num_active).reshape(-1))


class _DeviceArrays:
    """`to(device)` and `pinned()` over the arrays a device reads, which
    each plan class names once, in `_map(fn)`. Keys and coords stay on the
    host, and so do the neighbour, child and up maps themselves: the chunk
    kernels read the rulebooks, and the gather convolution reads each map
    in its kernel's orientation (`_GatherMaps`). The point arrays always
    go, and at a level with normals (`LevelTopology.guided`) the
    neighbour map and the orientation classes."""

    def _map(self, fn):
        raise NotImplementedError

    def to(self, device):
        """The plan on `device` (active counts as host ints)."""
        return self._map(lambda a: _to(a, device))

    def pinned(self):
        """The arrays `to` uploads, in page-locked host memory (`pin`)."""
        return self._map(pin)


def _keep(a):
    return a


def _kn(a):
    """A [rows, K] map in the gather-conv kernel's orientation: [K, rows]
    int32, contiguous (a tensor stays on its device)."""
    if isinstance(a, torch.Tensor):
        return a.t().to(torch.int32).contiguous()
    return np.ascontiguousarray(np.asarray(a).T, dtype=np.int32)


class _GatherMaps:
    """The maps the gather convolution reads (`ops/conv.gather_conv_kn`),
    in its kernel's orientation (`_kn`), one copy per plan object in
    `self.kn` (name -> tensor). The maps that have no chunk rulebook are
    the gather path's for every width, so `to` and `pinned` carry them
    along with the other device arrays (page-locked, queued without a
    wait); a map that keeps a rulebook is read here only by a module whose
    widths the chunk kernels do not take, and is uploaded on its first
    read. Either way a plan copies each map to a device once."""

    def gather_map(self, name: str, device) -> torch.Tensor:
        """Map `name` ("nbr", "child" or "up") as [K, rows] int32 on
        `device`."""
        m = self.kn.get(name)
        if m is None:
            m = self.kn[name] = _to(_kn(getattr(self, name)), device)
        return m

    def _map_kn(self, new, fn, names):
        """Carry `self.kn` through `fn` into `new`, and add the maps of
        `names` (those without a chunk rulebook)."""
        for name in names:
            if name not in self.kn:
                new.kn[name] = fn(_kn(getattr(self, name)))
        for name, m in self.kn.items():
            new.kn[name] = fn(m)
        return new


def _kn_cache():
    return dataclasses.field(default_factory=dict, init=False, repr=False,
                             compare=False)


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
class HaloExchange(_DeviceArrays, _GatherMaps):
    """The spatial-sharding exchange of ONE map, on a rank's slice of a
    sharded plan (`parallel/spatial_model.build_spatial_topology`): the
    owning map's values then index the extended rows [local | left halo |
    right halo | pool] that `parallel/comm.extend_features` builds from
    these lists, and the convolution modules extend their features
    before they convolve (`nn/modules._sharded_conv`). `nbr_t` is the
    owning map's transpose over the extended rows, offsets flipped
    (`parallel/spatial.transpose_ext_map`; the gather convolution's
    backward map, read through `gather_map("nbr_t", device)`), and
    `chunks_t` the chunk rulebook of its same-offset form `nbr_t[:, ::-1]`
    (the chunk kernels' transpose plan), or None. `sent` is how many
    leading entries of the left, right and publish lists any shard
    fills: what an exchange carries."""

    send_left: object    # int32 [H] local rows shipped to shard d-1
    send_right: object   # int32 [H] local rows shipped to shard d+1
    publish: object      # int32 [P] local rows published to the pool
    nbr_t: object        # int32 [ext, K] offset-flipped transpose
    halo: int = 0
    chunks_t: Optional[ChunkPlan] = None
    sent: Tuple[int, int, int] = (0, 0, 0)
    kn: dict = _kn_cache()

    def _map(self, fn) -> "HaloExchange":
        return self._map_kn(dataclasses.replace(
            self, send_left=fn(self.send_left),
            send_right=fn(self.send_right), publish=fn(self.publish),
            chunks_t=_map_each(self.chunks_t, fn)), fn,
            ("nbr_t",) if self.chunks_t is None else ())


@dataclasses.dataclass(frozen=True)
class LevelTopology(_DeviceArrays, _GatherMaps):
    """Active-site set of one scale and its submanifold neighbor map.

    `orient` holds each site's orientation class {0, 2, 4} for the
    normal-guided convolutions (`ops/normal_guide.py`); `guided` says the
    plan carried normals down to this level (`PlanSpec.guide_levels`).
    Its normal-guided convolutions then read `nbr` and `orient` on the
    device, so both are uploaded; elsewhere `orient` is all zeros (the
    identity filter) and stays on the host. The gather convolution reads
    `nbr` through `gather_map("nbr", device)`."""

    keys: object        # int64 [cap], sorted, KEY_PAD padding
    coords: object      # int32 [cap, 4] (b,z,y,x), -1 padding
    num_active: object  # int, or int32 [ns] per-scene counts (blocked)
    nbr: object         # int32 [cap, K] neighbor rows, -1 missing
    orient: object = None  # int32 [cap] orientation class, zeros = identity
    guided: bool = False
    chunks: Optional[ChunkPlan] = None
    # set on a rank's slice of a spatially sharded plan: `nbr` then
    # indexes the extended rows of this exchange
    halo_ex: Optional[HaloExchange] = None
    kn: dict = _kn_cache()
    # (name, device) -> keys or coords copied there (`device_array`)
    arrays: dict = _kn_cache()
    # the odd cubic stencil of a second neighbour map this level carries
    # beside `nbr` (`PlanSpec.stem_kernel`), built on the device at its
    # first use (`stencil_map`)
    stem_kernel: Optional[int] = None

    @property
    def cap(self) -> int:
        return self.nbr.shape[0]

    def stencil_map(self, volume: int, device) -> torch.Tensor:
        """The map of the level's second stencil (`stem_kernel`) whose
        volume is `volume`, as [K, cap] int32 on `device` in the gather
        kernel's orientation: built there from the level's keys at the
        first call (`stencil_map_kn`, the span `plan.stem_map`; its pairs
        add to the counter `plan.stem_pairs`), then kept with the level.
        Raises ValueError where the level carries no map of that
        volume."""
        kernel = self.stem_kernel
        if kernel is None or kernel ** 3 != volume:
            raise ValueError(f"the plan's level has no map of kernel volume "
                             f"{volume} (its maps: {self.nbr.shape[1]}"
                             f"{'' if kernel is None else f', {kernel ** 3}'})")
        name = f"nbr{kernel}"
        m = self.kn.get(name)
        if m is None:
            with span("plan.stem_map"):
                m = stencil_map_kn(self.device_array("keys", device), kernel,
                                   np.size(self.num_active))
                count_tensor("plan.stem_pairs", (m >= 0).sum())
            self.kn[name] = m
        return m

    def device_array(self, name: str, device) -> torch.Tensor:
        """Array `name` ("keys" or "coords") as a tensor on `device`: a
        plan built there holds it, a host plan's copy is made once per
        plan object and device (`to` and `pinned` do not carry it)."""
        a = getattr(self, name)
        device = torch.device(device)
        if isinstance(a, torch.Tensor) and a.device == device:
            return a
        m = self.arrays.get((name, device))
        if m is None:
            m = self.arrays[name, device] = _to(a, device)
        return m

    def _map(self, fn) -> "LevelTopology":
        guided = fn if self.guided else _keep
        return self._map_kn(dataclasses.replace(
            self, num_active=_counts(self.num_active), nbr=guided(self.nbr),
            orient=guided(self.orient), chunks=_map_each(self.chunks, fn),
            halo_ex=_map_each(self.halo_ex, fn)),
            fn, ("nbr",) if self.chunks is None else ())


@dataclasses.dataclass(frozen=True)
class LevelTransition(_DeviceArrays, _GatherMaps):
    """Down/up maps of a size-s stride-t transition between level l
    (fine) and l+1 (coarse), K = s^3 offsets. The chunk rulebooks come in
    pairs (each is the other's transpose plan): both or neither, except
    on a rank's slice of a sharded plan, whose transpose plans are its
    exchanges' `chunks_t`."""

    child: object  # int32 [cap_coarse, K] fine rows per coarse site
    up: object     # int32 [cap_fine, K] coarse rows per fine site
    size: int = 2
    stride: int = 2
    child_chunks: Optional[ChunkPlan] = None
    up_chunks: Optional[ChunkPlan] = None
    # spatial sharding: the exchanges of the child and up maps
    child_ex: Optional[HaloExchange] = None
    up_ex: Optional[HaloExchange] = None
    kn: dict = _kn_cache()

    def _map(self, fn) -> "LevelTransition":
        return self._map_kn(dataclasses.replace(
            self, child_chunks=_map_each(self.child_chunks, fn),
            up_chunks=_map_each(self.up_chunks, fn),
            child_ex=_map_each(self.child_ex, fn),
            up_ex=_map_each(self.up_ex, fn)), fn,
            ("child", "up") if self.child_chunks is None else ())


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
    # the process group of a rank's slice of a spatially sharded plan (the
    # JAX plan's `axis_name`): the exchanges and the BN and loss sums run
    # over it
    group: object = None

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
    # dilated offsets with no active site fall back to the nearest active
    # site within Chebyshev radius dilation // 2 (`build_level`)
    nn_search: bool = False
    # "cubic" (the K^3 stencil) or "permutohedral" (the 13 lattice
    # neighbours; coordinates pre-mapped with ops/permutohedral.embed_points)
    lattice: str = "cubic"
    # level 0 also carries the map of this odd cubic stencil (a 5^3 input
    # convolution beside the 3^3 ones), built on the device at its first
    # use (`LevelTopology.stencil_map`); None = no second map
    stem_kernel: Optional[int] = None
    # how a host plan's chunk budgets grow where a map overflows them
    # (`ops/kernels/chunk_conv.augment_plan_with_chunks`): "plan", the JAX
    # package's rule (a level alone, then the whole plan), or "map" (each
    # map alone)
    chunk_escalation: str = "plan"

    def level_offsets(self) -> Optional[np.ndarray]:
        """The offsets of every level's neighbour map where they are not
        the cubic stencil's."""
        if self.lattice == "permutohedral":
            from occuseg_tpu_torch.ops.permutohedral import (
                permutohedral_offsets,
            )
            return permutohedral_offsets(3)
        return None

    @property
    def num_levels(self) -> int:
        return len(self.caps)


# --- the planner on a tensor's device ------------------------------------

def _table(offsets: np.ndarray, device: torch.device) -> torch.Tensor:
    """An int32 offset table [K, 3] on `device`, copied there once per
    table and device (later builds make no copy, and no host wait)."""
    return _device_table(np.ascontiguousarray(offsets, np.int32).tobytes(),
                         torch.device(device))


@functools.lru_cache(maxsize=64)
def _device_table(raw: bytes, device: torch.device) -> torch.Tensor:
    t = np.frombuffer(raw, np.int32).reshape(-1, 3).copy()
    with torch.inference_mode(False):   # usable outside inference mode
        return torch.from_numpy(t).to(device)


def _chebyshev_shells(max_radius: int) -> np.ndarray:
    """All integer offsets with Chebyshev norm <= max_radius, by radius,
    then lexicographically ((0, 0, 0) first)."""
    deltas = []
    for r in range(max_radius + 1):
        for i in range(-r, r + 1):
            for j in range(-r, r + 1):
                for k in range(-r, r + 1):
                    if max(abs(i), abs(j), abs(k)) == r:
                        deltas.append((i, j, k))
    return np.asarray(deltas, np.int32)


def _with_batch(coords: torch.Tensor, spatial: torch.Tensor) -> torch.Tensor:
    """coords [..., N, 4]'s batch column before spatial [..., N, 3]
    (broadcast over spatial's leading axes)."""
    b = coords[..., :1].expand(spatial.shape[:-1] + (1,))
    return torch.cat([b, spatial], dim=-1)


def _level(keys: torch.Tensor, kernel: int = 3, dilation: int = 1,
           orient: Optional[torch.Tensor] = None, nn_search: bool = False,
           offsets: Optional[np.ndarray] = None) -> LevelTopology:
    """`build_level` with its count left on the device (0-d int32)."""
    dev = keys.device
    coords = C.unpack(keys)
    num_active = (keys < C.KEY_PAD).sum(dtype=torch.int32)
    offs = _table(_offsets(kernel, dilation) if offsets is None
                  else offsets, dev)
    K = offs.shape[0]
    if nn_search and dilation > 1:
        deltas = _table(_chebyshev_shells(dilation // 2), dev)  # [S, 3]
        S = deltas.shape[0]
        cols = []
        for k in range(K):   # [N, S] candidates per offset, radius order
            cand = coords[:, None, 1:] + offs[k] + deltas[None]
            q = _with_batch(coords[:, None], cand)
            rows = C.lookup(keys, C.pack(q.reshape(-1, 4))).reshape(-1, S)
            hit = rows >= 0
            first = hit.to(torch.int32).argmax(dim=1)  # first maximal
            pick = rows.gather(1, first[:, None])[:, 0]
            cols.append(torch.where(hit.any(dim=1), pick, -1))
        nbr_kn = torch.stack(cols)
    else:
        shifted = coords[None, :, 1:] + offs[:, None, :]         # [K, N, 3]
        q = _with_batch(coords[None], shifted)
        nbr_kn = C.lookup(keys, C.pack(q.reshape(-1, 4))).reshape(K, -1)
    if orient is None:
        orient = torch.zeros(keys.shape[0], dtype=torch.int32, device=dev)
    lvl = LevelTopology(keys=keys, coords=coords, num_active=num_active,
                        nbr=nbr_kn.t(), orient=orient)
    lvl.kn["nbr"] = nbr_kn
    return lvl


def stencil_map_kn(keys: torch.Tensor, kernel: int, blocks: int = 1
                   ) -> torch.Tensor:
    """The submanifold map [kernel^3, cap] int32 of the odd cubic stencil
    over a level's keys [cap] on their device, in the gather kernel's
    orientation: entry (k, r) is the row of the site at row r's
    coordinates + offset k (z-major, as `_offsets`), -1 where there is
    none. The keys are `blocks` equal blocks, each sorted with its
    KEY_PAD rows last (one block: a one-scene plan; ns blocks: the
    blocked layout, `native/blocked.py`), searched side by side (a
    batched `searchsorted`), one z offset (kernel^2 offsets) a search.
    A neighbour's key is built from the row's key by a dilated addition
    in each axis's Morton bits (the other bits set to 1 carry through
    them; the wrap of a coordinate past the domain is masked by the
    row's coordinates), so an offset costs two ORs of the three axes'
    shifted bits, not a pack. About a hundred launches whatever the
    blocks (the stepping thread shares the interpreter with the plan
    workers, so it issues few operations); no host wait."""
    dev = keys.device
    n, cap = kernel, keys.shape[0]
    if cap % blocks:
        raise ValueError(f"stencil_map_kn: cap {cap} is not a multiple of "
                         f"{blocks} blocks")
    sc = cap // blocks
    kb = keys.reshape(blocks, sc)
    c = C.unpack(keys).reshape(blocks, sc, 4)
    delta = torch.arange(-(n // 2), n // 2 + 1, device=dev)     # [n]
    spread = C._spread3(delta % C.AXIS_SIZE)                    # x bits
    x_bits = sum(1 << (3 * i) for i in range(C.AXIS_BITS))
    parts, oks = [], []
    all_bits = 0
    for a in range(3):                                          # z, y, x
        m = x_bits << (2 - a)
        all_bits |= m
        dil = (spread << (2 - a))[:, None, None]
        parts.append(((kb | ~m)[None] + dil) & m)               # [n, B, sc]
        v = c[None, :, :, 1 + a] + delta[:, None, None]
        oks.append((v >= 0) & (v < C.AXIS_SIZE))
    zy = (kb & ~all_bits)[None, None] | parts[0][:, None] | parts[1][None]
    zy_ok = oks[0][:, None] & oks[1][None] & (kb < C.KEY_PAD)
    base = (torch.arange(blocks, device=dev) * sc)[:, None]
    out = torch.empty((n, n, n, cap), dtype=torch.int32, device=dev)
    for i in range(n):
        q = zy[i][:, None] | parts[2][None]                     # [n,n,B,sc]
        q = torch.where(zy_ok[i][:, None] & oks[2][None], q, C.KEY_PAD)
        qb = q.permute(2, 0, 1, 3).reshape(blocks, -1)          # [B, n*n*sc]
        pos = torch.searchsorted(kb, qb).clamp(max=sc - 1)
        hit = (kb.gather(1, pos) == qb) & (qb < C.KEY_PAD)
        rows = torch.where(hit, pos + base, -1).to(torch.int32)
        out[i] = rows.reshape(blocks, n, n, sc).permute(1, 2, 0, 3) \
            .reshape(n, n, cap)
    return out.reshape(n ** 3, cap)


def build_level(keys: torch.Tensor, kernel: int = 3, dilation: int = 1,
                orient: Optional[torch.Tensor] = None, nn_search: bool = False,
                offsets: Optional[np.ndarray] = None) -> LevelTopology:
    """LevelTopology of sorted unique KEY_PAD-padded keys on their device:
    coords, the count of real keys and the neighbour map over the K^3
    cubic offsets (or explicit `offsets` [K, 3], e.g. the permutohedral
    lattice's), all K lookups in one search. With `nn_search` (dilation >
    1 only), a dilated offset with no active site falls back to the
    nearest active site within Chebyshev radius dilation // 2, the first
    hit in radius order, one offset at a time over [N, S] candidates."""
    return _on_host_counts(_level(keys, kernel, dilation, orient, nn_search,
                                  offsets))


def _voxelize(point_coords: torch.Tensor, cap: int):
    """(sorted unique keys [cap], p2v [P] int32, the points' segment ids
    in key order): the points sorted by key (a stable sort, so a voxel's
    points keep their order), their distinct keys left-packed."""
    skeys, order = torch.sort(C.pack(point_coords), stable=True)
    _, seg, _ = C.unique_consecutive(skeys)
    unique_keys, _, _ = C.compact_unique(skeys, cap)
    vox_row = torch.where(seg < cap, seg, -1)
    p2v = torch.empty_like(vox_row).scatter_(0, order, vox_row)
    return unique_keys, p2v, order, seg


def voxelize_coords(point_coords: torch.Tensor, cap: int):
    """(sorted unique voxel keys [cap], p2v [P] int32) of padded point
    coords [P, 4] (-1 rows are padding). A point past the cap, or a pad
    point, gets p2v -1; as in the JAX package, a pad point gets row P
    instead where P < cap (the unique-key index it is given is P)."""
    keys, p2v, _, _ = _voxelize(torch.as_tensor(point_coords), cap)
    return keys, p2v


def downsample_keys(level: LevelTopology, size: int, stride: int, cap: int
                    ) -> torch.Tensor:
    """Sorted padded keys of the output sites of a size/stride convolution
    over `level`: at 2/2 the parent keys, already sorted (no sort); else
    every output site whose window covers an active site (ceil(size /
    stride)^3 candidates each), sorted and deduplicated."""
    if size == stride == 2:
        return C.compact_unique(C.parent_keys(level.keys), cap)[0]
    c = level.coords
    sp = c[:, 1:]
    ncand = -(-size // stride)
    base = torch.where(sp >= 0, torch.div(sp, stride, rounding_mode="floor"),
                       -1)
    cands = []
    for tz in range(ncand):
        for ty in range(ncand):
            for tx in range(ncand):
                j = torch.stack([base[:, 0] - tz, base[:, 1] - ty,
                                 base[:, 2] - tx], dim=1)
                # output j covers input i iff j*stride <= i < j*stride + size
                ok = ((j >= 0) & (sp - j * stride < size)).all(dim=1) \
                    & (c[:, 0] >= 0)
                cc = torch.where(ok[:, None], torch.cat([c[:, :1], j], 1), -1)
                cands.append(C.pack(cc))
    skeys = torch.sort(torch.cat(cands)).values
    return C.compact_unique(skeys, cap)[0]


def grow_keys(level: LevelTopology, size: int, stride: int, cap_out: int
              ) -> torch.Tensor:
    """Sorted padded keys of a full (active-set-growing) transposed
    convolution's output: every active site c gives c * stride + off for
    each off in [0, size)^3."""
    c = level.coords
    offs = _table(_even_offsets(size), c.device)                # [K, 3]
    cand = _with_batch(c[None], c[None, :, 1:] * stride + offs[:, None, :])
    cand = torch.where(c[None, :, :1] >= 0, cand, -1)
    skeys = torch.sort(C.pack(cand.reshape(-1, 4))).values
    return C.compact_unique(skeys, cap_out)[0]


def build_transition(fine: LevelTopology, coarse: LevelTopology,
                     size: int, stride: int) -> LevelTransition:
    """Child and up maps between two levels built on one device, one
    lookup for all offsets each way: child[j, k] is the fine row at
    coarse site j * stride + off_k, up[i, k] the coarse row j with
    j * stride + off_k = fine site i."""
    cc, fc = coarse.coords, fine.coords
    offs = _table(_even_offsets(size), cc.device)               # [K, 3]
    K = offs.shape[0]
    tgt = _with_batch(cc[None], cc[None, :, 1:] * stride + offs[:, None, :])
    tgt = torch.where(cc[None, :, :1] >= 0, tgt, -1)
    child_kn = C.lookup(fine.keys, C.pack(tgt.reshape(-1, 4))).reshape(K, -1)
    num = fc[None, :, 1:] - offs[:, None, :]                    # [K, N, 3]
    divisible = ((num % stride == 0) & (num >= 0)).all(dim=-1)
    j = _with_batch(fc[None], torch.div(num, stride, rounding_mode="floor"))
    j = torch.where((divisible & (fc[None, :, 0] >= 0))[..., None], j, -1)
    up_kn = C.lookup(coarse.keys, C.pack(j.reshape(-1, 4))).reshape(K, -1)
    tr = LevelTransition(child=child_kn.t(), up=up_kn.t(), size=size,
                         stride=stride)
    tr.kn.update(child=child_kn, up=up_kn)
    return tr


def _on_device(level: LevelTopology, device) -> LevelTopology:
    """`level` with its keys and coords as tensors on `device` (a host
    plan's stay on the host)."""
    if isinstance(level.keys, torch.Tensor) and level.keys.device == device:
        return level
    return dataclasses.replace(
        level, keys=torch.tensor(level.keys, device=device),
        coords=torch.tensor(level.coords, device=device))


def _with_count(level: LevelTopology, n: int, **fields) -> LevelTopology:
    new = dataclasses.replace(level, num_active=n, **fields)
    new.kn.update(level.kn)
    return new


def _on_host_counts(*levels: LevelTopology):
    """The levels with their device counts read to host ints, in one read
    (one level: the level itself)."""
    counts = torch.stack([l.num_active for l in levels]).tolist()
    out = tuple(_with_count(l, n) for l, n in zip(levels, counts))
    return out[0] if len(out) == 1 else out


def full_conv_plan(level: LevelTopology, size: int, stride: int,
                   cap_out: int, kernel: int = 3, build_nbr: bool = True,
                   device=None) -> Tuple[LevelTopology, LevelTransition]:
    """The grown output level of a FullConvolution over `level` and the
    transition from it (fine: the grown level, coarse: `level`), on
    `device` (default: where the level's keys are, the CPU for a host
    plan). The convolution is the deconvolution over the transition's
    `up` map; its `child` map is the backward's. `build_nbr=False` skips
    the grown level's neighbour map ([cap_out, 1] of -1)."""
    if device is None:
        device = (level.keys.device if isinstance(level.keys, torch.Tensor)
                  else torch.device("cpu"))
    level = _on_device(level, torch.device(device))
    out_keys = grow_keys(level, size, stride, cap_out)
    if build_nbr:
        out = _level(out_keys, kernel)
    else:
        nbr_kn = torch.full((1, cap_out), -1, dtype=torch.int32,
                            device=out_keys.device)
        out = LevelTopology(
            keys=out_keys, coords=C.unpack(out_keys),
            num_active=(out_keys < C.KEY_PAD).sum(dtype=torch.int32),
            nbr=nbr_kn.t(), orient=torch.zeros(cap_out, dtype=torch.int32,
                                               device=out_keys.device))
        out.kn["nbr"] = nbr_kn
    tr = build_transition(out, level, size, stride)
    return _on_host_counts(out), tr


def _normalize(v: torch.Tensor) -> torch.Tensor:
    """v / max(|v|, 1e-8) per row of [N, 3], the squares summed in axis
    order on every device."""
    n = torch.sqrt(v[:, :1] * v[:, :1] + v[:, 1:2] * v[:, 1:2]
                   + v[:, 2:] * v[:, 2:])
    return v / torch.clamp(n, min=1e-8)


def _child_normals(normals: torch.Tensor, child_kn: torch.Tensor
                   ) -> torch.Tensor:
    """Normalised sums of each coarse site's children's normals, summed in
    offset order."""
    g = normals[child_kn.clamp(min=0).long()] * (child_kn >= 0)[..., None]
    s = g[0]
    for k in range(1, g.shape[0]):
        s = s + g[k]
    return _normalize(s)


def build_plan(point_coords, spec: PlanSpec, point_normals=None
               ) -> Topology:
    """The full topology of padded point coords [P, 4] (b, z, y, x; -1
    rows are padding), planned on their device (a NumPy array plans on the
    CPU). With point normals [P, 3] (x, y, z) each voxel's normal is the
    normalised sum of its points' (summed in the points' order, one
    segment at a time: the same bits on every run), carried down by the
    children's sums to `spec.guide_levels`, and each such level gets its
    orientation classes. The counts are read to the host once, at the
    end; the plan carries the points per voxel (`vox_counts`), no chunk
    rulebook and no point layout."""
    from occuseg_tpu_torch.ops.normal_guide import oriented_filter

    pc = torch.as_tensor(point_coords)
    dev = pc.device
    cap0 = spec.caps[0]
    keys0, p2v, order, seg = _voxelize(pc, cap0)
    num_points = (C.pack(pc) < C.KEY_PAD).sum(dtype=torch.int32)
    bounds = torch.searchsorted(seg, torch.arange(cap0 + 1, dtype=torch.int32,
                                                  device=dev))
    vox_counts = (bounds[1:] - bounds[:-1]).to(torch.float32)

    normals = orient = None
    if point_normals is not None:
        pn = torch.as_tensor(point_normals, device=dev).to(torch.float32)
        nsum = torch.segment_reduce(pn[order], "sum", offsets=bounds,
                                    axis=0, unsafe=True)
        normals = _normalize(nsum)
        orient = oriented_filter(normals)
    offsets = spec.level_offsets()

    def level(keys, orient_l):
        return _level(keys, spec.kernel, spec.dilation, orient_l,
                      spec.nn_search, offsets)

    levels = [level(keys0, orient)]
    guided = [normals is not None]
    transitions = []
    for li in range(1, spec.num_levels):
        keys = downsample_keys(levels[-1], spec.down_size, spec.down_stride,
                               spec.caps[li])
        lvl = level(keys, None)
        tr = build_transition(levels[-1], lvl, spec.down_size,
                              spec.down_stride)
        if spec.guide_levels is not None and li >= spec.guide_levels:
            normals = None
        if normals is not None:
            normals = _child_normals(normals, tr.kn["child"])
            lvl = _with_count(lvl, lvl.num_active,
                              orient=oriented_filter(normals))
        guided.append(normals is not None)
        transitions.append(tr)
        levels.append(lvl)
    counts = torch.stack([l.num_active for l in levels]
                         + [num_points]).tolist()
    levels = tuple(_with_count(l, n, guided=g,
                               stem_kernel=spec.stem_kernel if i == 0
                               else None)
                   for i, (l, n, g) in enumerate(zip(levels, counts,
                                                     guided)))
    return Topology(levels=levels, transitions=tuple(transitions), p2v=p2v,
                    num_points=counts[-1], vox_counts=vox_counts)


def _np(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)


def _active_rows(num_active, cap: int) -> np.ndarray:
    """Real rows of either layout: the prefix [0, n), or per-scene blocks
    of a blocked plan's tuple of counts."""
    if np.ndim(num_active) == 0:
        return np.arange(int(num_active))
    counts = list(num_active)
    if not counts:
        return np.arange(0)
    sc = cap // len(counts)
    return np.concatenate([s * sc + np.arange(int(c))
                           for s, c in enumerate(counts)]).astype(np.int64)


def validate_plan(plan: Topology) -> dict:
    """Violation counts of a plan's invariants, all zeros on a healthy
    plan (host NumPy; a host or a device plan, prefix or blocked):
    "overflow" (a level filled its cap, per scene when blocked); per level
    keys not strictly increasing within a scene, neighbour-map centres
    that are not the row itself, and asymmetric pairs (nbr[r, k] = i
    without nbr[i, K-1-k] = r); per transition child entries whose up
    entry does not point back and, where size == stride, active fine rows
    no coarse site covers."""
    out = {"overflow": 0}
    for lvl in plan.levels:
        cap = _np(lvl.keys).shape[0]
        n = lvl.num_active
        if np.ndim(n) == 0:
            out["overflow"] |= int(int(n) >= cap)
        else:
            out["overflow"] |= int(any(int(c) >= cap // len(n) for c in n))
    for li, lvl in enumerate(plan.levels):
        keys = _np(lvl.keys)
        rows = _active_rows(lvl.num_active, keys.shape[0])
        kv = keys[rows].astype(np.int64)
        same_blk = np.diff(rows) == 1
        out[f"level{li}_unsorted_or_dup"] = int(
            not np.all(np.diff(kv)[same_blk] > 0))
        nbr = _np(lvl.nbr)
        K = nbr.shape[1]
        out[f"level{li}_bad_center"] = int(np.sum(nbr[rows, K // 2] != rows))
        bad_sym = 0
        for k in range(K):
            col = nbr[rows, k]
            hit = col >= 0
            bad_sym += int(np.sum(nbr[col[hit], K - 1 - k] != rows[hit]))
        out[f"level{li}_asymmetric"] = bad_sym
    for ti, tr in enumerate(plan.transitions):
        child, up = _np(tr.child), _np(tr.up)
        fine, coarse = plan.levels[ti], plan.levels[ti + 1]
        fine_rows = _active_rows(fine.num_active, _np(fine.keys).shape[0])
        crows = _active_rows(coarse.num_active, _np(coarse.keys).shape[0])
        bad = 0
        for k in range(child.shape[1]):
            col = child[crows, k]
            hit = col >= 0
            bad += int(np.sum(up[col[hit], k] != crows[hit]))
        out[f"transition{ti}_child_up_mismatch"] = bad
        if tr.size == tr.stride:
            covered = np.zeros(_np(fine.keys).shape[0], bool)
            flat = child[crows].reshape(-1)
            covered[flat[flat >= 0]] = True
            out[f"transition{ti}_uncovered_fine"] = int(
                np.sum(~covered[fine_rows]))
    return out
