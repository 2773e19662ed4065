"""Host-side topology plan builder (counterpart of
`occuseg_tpu/native/plan.py:build_plan_host`).

Runs the C++ planner (`csrc/native.cpp`) through the port's binding and
returns NumPy plan dataclasses bit-identical to the JAX package's host
plan, orientation classes included. Size-2 stride-2 transitions run in the
C++ planner; any other size and stride (a VGG "Plus" down_size=3, say)
runs `_general_downsample_np`, the JAX package's NumPy output-region
transition, with s^3 offsets per map. Dilated nearest-neighbour searches
(`PlanSpec.nn_search`) and permutohedral lattices (`PlanSpec.lattice`)
are planned only on the device (`core/topology.build_plan`): for such a
spec `build_plan_host` returns None, as the JAX package's host planner
does.

With point normals [P, 3] (x, y, z) the plan carries normals for the
normal-guided convolutions: a level-0 voxel's normal is the normalised sum
of its points' normals, a coarse site's the normalised sum of its
children's, down to `PlanSpec.guide_levels` (coarser levels keep the
identity orientation, as the reference's normal_guide_scale cutoff does).
Each carrying level gets its sites' dominant-axis class {0, 2, 4}.

A spec with a `stem_kernel` marks level 0 with it: that second map (125
probes a voxel at 5^3) is built on the device at its first use
(`LevelTopology.stencil_map`), not here.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from occuseg_tpu_torch import native
from occuseg_tpu_torch.core.topology import (
    LevelTopology,
    LevelTransition,
    PlanSpec,
    Topology,
    _even_offsets,
    _offsets,
)


_KEY_PAD = np.int64(1) << np.int64(62)
_SPATIAL_BITS = 36


def _spread3(v: np.ndarray) -> np.ndarray:
    x = v.astype(np.int64) & 0x1FFFFF
    x = (x | (x << 32)) & 0x1F00000000FFFF
    x = (x | (x << 16)) & 0x1F0000FF0000FF
    x = (x | (x << 8)) & 0x100F00F00F00F00F
    x = (x | (x << 4)) & 0x10C30C30C30C30C3
    x = (x | (x << 2)) & 0x1249249249249249
    return x


def _compact3(v: np.ndarray) -> np.ndarray:
    x = v & 0x1249249249249249
    x = (x | (x >> 2)) & 0x10C30C30C30C30C3
    x = (x | (x >> 4)) & 0x100F00F00F00F00F
    x = (x | (x >> 8)) & 0x1F0000FF0000FF
    x = (x | (x >> 16)) & 0x1F00000000FFFF
    x = (x | (x >> 32)) & 0x1FFFFF
    return x


def _pack(coords: np.ndarray) -> np.ndarray:
    """Morton keys of coords [N, 4] (b, z, y, x); a row with a negative
    or out-of-range (>= 4096) component is _KEY_PAD."""
    c = coords.astype(np.int64)
    invalid = (c < 0).any(axis=1) | (c[:, 1:] >= 4096).any(axis=1)
    key = ((c[:, 0] << _SPATIAL_BITS) | (_spread3(c[:, 1]) << 2)
           | (_spread3(c[:, 2]) << 1) | _spread3(c[:, 3]))
    return np.where(invalid, _KEY_PAD, key)


def _unpack(keys: np.ndarray) -> np.ndarray:
    """Inverse of `_pack`: int32 coords [N, 4], -1 rows for _KEY_PAD."""
    morton = keys & ((np.int64(1) << _SPATIAL_BITS) - 1)
    out = np.stack([keys >> _SPATIAL_BITS, _compact3(morton >> 2),
                    _compact3(morton >> 1), _compact3(morton)],
                   axis=-1).astype(np.int32)
    return np.where((keys >= _KEY_PAD)[:, None], np.int32(-1), out)


def _lookup(keys: np.ndarray, q: np.ndarray) -> np.ndarray:
    """Row of each query key in sorted `keys`, -1 where absent."""
    pos = np.clip(np.searchsorted(keys, q), 0, len(keys) - 1)
    hit = (keys[pos] == q) & (q < _KEY_PAD)
    return np.where(hit, pos, -1).astype(np.int32)


def _general_downsample_np(keys: np.ndarray, coords: np.ndarray,
                           cap_c: int, size: int, stride: int):
    """(coarse keys, coarse coords, coarse count, child [cap_c, size^3],
    up [cap, size^3]) of an output-region transition of any size and
    stride: coarse site j covers fine sites j*stride + [0, size)^3 (the
    reference's OutputRegionCalculator); up[i, k] is the coarse site that
    reaches fine site i through offset k."""
    valid = coords[:, 0] >= 0
    sp = coords[:, 1:]
    ncand = -(-size // stride)
    cand = []
    for tz in range(ncand):
        for ty in range(ncand):
            for tx in range(ncand):
                j = sp // stride - np.array([tz, ty, tx], np.int32)
                ok = valid & (j >= 0).all(1) & (sp - j * stride < size).all(1)
                cc = np.concatenate([coords[:, :1], j], axis=1)
                cc[~ok] = -1
                cand.append(_pack(cc))
    u = np.unique(np.concatenate(cand))
    u = u[u < _KEY_PAD][:cap_c]
    ckeys = np.full(cap_c, _KEY_PAD, np.int64)
    ckeys[:len(u)] = u
    ccoords = _unpack(ckeys)

    offs = _even_offsets(size)
    K = offs.shape[0]
    child = np.full((cap_c, K), -1, np.int32)
    up = np.full((coords.shape[0], K), -1, np.int32)
    cvalid = ccoords[:, 0] >= 0
    for k, off in enumerate(offs):
        tgt = np.concatenate(
            [ccoords[:, :1], ccoords[:, 1:] * stride + off], axis=1)
        tgt[~cvalid] = -1
        child[:, k] = _lookup(keys, _pack(tgt))
        num = sp - off
        div = valid & (num >= 0).all(1) & (num % stride == 0).all(1)
        j = np.concatenate([coords[:, :1], num // stride], axis=1)
        j[~div] = -1
        up[:, k] = _lookup(ckeys, _pack(j))
    return ckeys, ccoords, len(u), child, up


def _orient_class(normals: np.ndarray) -> np.ndarray:
    """Dominant-axis orientation class {0, 2, 4} (x / y / z), as
    `ops/normal_guide.oriented_filter` computes it."""
    a = np.abs(normals)
    x, y, z = a[:, 0], a[:, 1], a[:, 2]
    return np.where((x >= y) & (x >= z), 0,
                    np.where((y >= x) & (y >= z), 2, 4)).astype(np.int32)


def _normalize(v: np.ndarray) -> np.ndarray:
    n = np.linalg.norm(v, axis=1, keepdims=True)
    return v / np.maximum(n, 1e-8)


def build_plan_host(point_coords: np.ndarray, spec: PlanSpec,
                    point_normals: Optional[np.ndarray] = None
                    ) -> Optional[Topology]:
    """NumPy Topology for padded point coords [P,4] (b,z,y,x; -1 pad),
    with orientation classes from `point_normals` [P, 3] when given; None
    for a spec only the device planner builds (`nn_search`, a lattice
    other than "cubic")."""
    if spec.nn_search or spec.lattice != "cubic":
        return None
    fast_down = spec.down_size == 2 and spec.down_stride == 2
    offs = _offsets(spec.kernel, spec.dilation)
    K = offs.shape[0]

    keys, coords, p2v, n0 = native.plan_voxelize(point_coords, spec.caps[0])
    normals = None
    if point_normals is not None:
        pn = np.asarray(point_normals, np.float32)
        acc = np.zeros((spec.caps[0], 3), np.float32)
        valid = p2v >= 0
        np.add.at(acc, p2v[valid], pn[valid])
        normals = _normalize(acc)

    # Phase 1: the downsample chain (keys/coords/normals/transitions)
    lvl_data = []  # (keys, coords, num_active, normals or None) per level
    transitions = []
    cur = (keys, coords, n0)
    for li, cap in enumerate(spec.caps):
        lvl_data.append((*cur, normals))
        if li + 1 < len(spec.caps):
            if fast_down:
                ckeys, ccoords, child, up, nc = native.plan_downsample(
                    cur[0], cur[1], cur[2], spec.caps[li + 1])
            else:
                ckeys, ccoords, nc, child, up = _general_downsample_np(
                    cur[0], cur[1], spec.caps[li + 1], spec.down_size,
                    spec.down_stride)
            transitions.append(LevelTransition(
                child=child, up=up, size=spec.down_size,
                stride=spec.down_stride))
            if spec.guide_levels is not None and li + 1 >= spec.guide_levels:
                normals = None
            if normals is not None:
                gathered = np.where((child >= 0)[..., None],
                                    normals[np.clip(child, 0, None)], 0.0)
                normals = _normalize(gathered.sum(axis=1))
            cur = (ckeys, ccoords, nc)

    # Phase 2: neighbor maps, coarsest first. A fine level derives its map
    # from the parent's when that is bit-identical to probing: a 3^3
    # dilation-1 kernel, a size-2 stride-2 transition and a coarse level
    # that did not hit its cap.
    small3 = K == 27 and bool((np.abs(offs) <= 1).all())
    nbrs = [None] * len(spec.caps)
    for li in reversed(range(len(spec.caps))):
        lk, lc, ln, _ = lvl_data[li]
        nbr = None
        if (small3 and fast_down and li + 1 < len(spec.caps)
                and lvl_data[li + 1][2] < spec.caps[li + 1]):
            tr = transitions[li]
            nbr = native.plan_neighbor_map_derived(
                lc, ln, offs, tr.up, tr.child, nbrs[li + 1])
        if nbr is None:
            nbr = native.plan_neighbor_map(lk, lc, ln, offs)
        nbrs[li] = nbr

    levels = tuple(
        LevelTopology(keys=lk, coords=lc, num_active=int(ln), nbr=nbrs[li],
                      orient=(np.zeros(spec.caps[li], np.int32) if ls is None
                              else _orient_class(ls)),
                      guided=ls is not None,
                      stem_kernel=spec.stem_kernel if li == 0 else None)
        for li, (lk, lc, ln, ls) in enumerate(lvl_data))
    return Topology(levels=levels, transitions=tuple(transitions), p2v=p2v,
                    num_points=int((p2v >= 0).sum()))
