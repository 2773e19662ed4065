"""Host-side topology plan builder (counterpart of
`occuseg_tpu/native/plan.py:build_plan_host`).

Runs the C++ planner (`csrc/native.cpp`) through the port's binding and
returns NumPy plan dataclasses bit-identical to the JAX package's host
plan, orientation classes included. Only the UNet default is supported: a
cubic kernel with stride-2, size-2 transitions; any other spec raises.

With point normals [P, 3] (x, y, z) the plan carries normals for the
normal-guided convolutions: a level-0 voxel's normal is the normalised sum
of its points' normals, a coarse site's the normalised sum of its
children's, down to `PlanSpec.guide_levels` (coarser levels keep the
identity orientation, as the reference's normal_guide_scale cutoff does).
Each carrying level gets its sites' dominant-axis class {0, 2, 4}.
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
    _offsets,
)


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
                    point_normals: Optional[np.ndarray] = None) -> Topology:
    """NumPy Topology for padded point coords [P,4] (b,z,y,x; -1 pad),
    with orientation classes from `point_normals` [P, 3] when given."""
    if not (spec.down_size == 2 and spec.down_stride == 2):
        raise NotImplementedError(
            f"build_plan_host: only size-2 stride-2 transitions are ported "
            f"(got size {spec.down_size}, stride {spec.down_stride})")
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
            ckeys, ccoords, child, up, nc = native.plan_downsample(
                cur[0], cur[1], cur[2], spec.caps[li + 1])
            transitions.append(LevelTransition(child=child, up=up))
            if spec.guide_levels is not None and li + 1 >= spec.guide_levels:
                normals = None
            if normals is not None:
                gathered = np.where((child >= 0)[..., None],
                                    normals[np.clip(child, 0, None)], 0.0)
                normals = _normalize(gathered.sum(axis=1))
            cur = (ckeys, ccoords, nc)

    # Phase 2: neighbor maps, coarsest first. A fine level derives its map
    # from the parent's when that is bit-identical to probing: a 3^3
    # dilation-1 kernel and a coarse level that did not hit its cap.
    small3 = K == 27 and bool((np.abs(offs) <= 1).all())
    nbrs = [None] * len(spec.caps)
    for li in reversed(range(len(spec.caps))):
        lk, lc, ln, _ = lvl_data[li]
        nbr = None
        if (small3 and li + 1 < len(spec.caps)
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
                      guided=ls is not None)
        for li, (lk, lc, ln, ls) in enumerate(lvl_data))
    return Topology(levels=levels, transitions=tuple(transitions), p2v=p2v,
                    num_points=int((p2v >= 0).sum()))
