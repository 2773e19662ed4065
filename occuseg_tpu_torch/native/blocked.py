"""Blocked multi-scene batch plans (counterpart of
`occuseg_tpu/native/blocked.py`).

Every level pads each scene of an ns-scene batch to the same per-scene cap
(`blocked_scene_caps`); scene s owns rows [s*sub_cap, s*sub_cap + n_s).
Each scene is planned alone by the C++ host planner (`native/plan.py`) at
the per-scene caps, and the plans are merged with per-level row offsets:
`num_active` becomes an [ns] vector of per-scene counts, and every row map
(nbr, child, up, p2v) shifts its valid entries by the owning scene's block
offset. The math is that of one plan over the concatenated scenes; only
the row numbering changes.

Chunks never straddle scenes (sub-caps are multiples of the chunk size),
so `augment_plan_with_chunks` plans a merged map as it is: each chunk's
sorted input list is its scene's own list shifted by the scene's offset.
The port keeps those global row numbers in `ChunkPlan.in_idx` (the JAX
package keeps them scene-local and adds the offset when it stages rows).
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Optional, Sequence, Tuple

import numpy as np

from occuseg_tpu_torch.core.topology import (
    LevelTopology,
    LevelTransition,
    PlanSpec,
    Topology,
)
from occuseg_tpu_torch.native.plan import build_plan_host

log = logging.getLogger("occuseg_tpu_torch")

# per-scene caps tile both the chunk geometry (M=128) and the sorted point
# layout's voxel blocks (W=192): lcm = 384
SCENE_CAP_ALIGN = 384


def blocked_scene_caps(caps: Tuple[int, ...], ns: int) -> Tuple[int, ...]:
    """Per-scene caps: ceil(cap / ns) rounded up to SCENE_CAP_ALIGN."""
    a = SCENE_CAP_ALIGN
    return tuple(-(-(-(-c // ns)) // a) * a for c in caps)


def _off(a: np.ndarray, off: int) -> np.ndarray:
    """Shift valid (>= 0) row indices by a scene's block offset."""
    a = np.asarray(a)
    return np.where(a >= 0, a + np.int32(off), a).astype(np.int32)


def merge_scene_plans(plans: Sequence[Topology],
                      scaps: Tuple[int, ...]) -> Topology:
    """Concatenate per-scene plans, all built at the per-scene caps
    `scaps`, into one blocked plan. Row maps shift by the owning scene's
    block offset; `num_active` becomes an int32 [ns] vector. p2v is not
    merged here (see `build_plan_host_blocked`)."""
    levels = []
    for li, cap in enumerate(scaps):
        lvls = [p.levels[li] for p in plans]
        levels.append(LevelTopology(
            keys=np.concatenate([np.asarray(l.keys) for l in lvls]),
            coords=np.concatenate([np.asarray(l.coords) for l in lvls]),
            num_active=np.asarray([int(l.num_active) for l in lvls],
                                  np.int32),
            nbr=np.concatenate([_off(l.nbr, s * cap)
                                for s, l in enumerate(lvls)]),
            orient=np.concatenate([np.asarray(l.orient) for l in lvls]),
            guided=lvls[0].guided))
    transitions = []
    for ti in range(len(scaps) - 1):
        fine_cap, coarse_cap = scaps[ti], scaps[ti + 1]
        trs = [p.transitions[ti] for p in plans]
        transitions.append(LevelTransition(
            child=np.concatenate([_off(t.child, s * fine_cap)
                                  for s, t in enumerate(trs)]),
            up=np.concatenate([_off(t.up, s * coarse_cap)
                               for s, t in enumerate(trs)])))
    return Topology(levels=tuple(levels), transitions=tuple(transitions),
                    p2v=np.full((1,), -1, np.int32),
                    num_points=sum(int(p.num_points) for p in plans))


def build_plan_host_blocked(point_coords: np.ndarray, spec: PlanSpec,
                            ns: int, point_normals: Optional[np.ndarray] = None
                            ) -> Topology:
    """Blocked plan of an ns-scene batch: point_coords [P, 4] (b, z, y, x)
    with b in [0, ns) and -1 pad rows, and optionally the points' normals
    [P, 3] (each scene's plan takes its own points' normals). ns <= 1 is
    the one-scene plan. The returned p2v maps the ORIGINAL point order into
    blocked voxel rows; the sorted point layout (`core/point_layout.py`)
    then groups each scene's points, since its slots follow voxel
    blocks."""
    if ns <= 1:
        return build_plan_host(point_coords, spec, point_normals)
    scaps = blocked_scene_caps(spec.caps, ns)
    sspec = dataclasses.replace(spec, caps=scaps)
    coords = np.asarray(point_coords)
    normals = None if point_normals is None else np.asarray(point_normals)
    plans, idxs = [], []
    for s in range(ns):
        idx = np.nonzero(coords[:, 0] == s)[0]
        pts = coords[idx] if idx.size else np.full((1, 4), -1, np.int32)
        nrm = None
        if normals is not None:
            nrm = normals[idx] if idx.size else np.zeros((1, 3), np.float32)
        sub = build_plan_host(np.ascontiguousarray(pts, np.int32), sspec,
                              nrm)
        if int(sub.levels[0].num_active) >= scaps[0]:
            log.warning("blocked batch: scene %d hit its per-scene cap (%d "
                        "level-0 voxels); voxels past it are dropped", s,
                        scaps[0])
        plans.append(sub)
        idxs.append(idx)
    merged = merge_scene_plans(plans, scaps)
    p2v = np.full(coords.shape[0], -1, np.int32)
    for s, (sub, idx) in enumerate(zip(plans, idxs)):
        if idx.size:
            p2v[idx] = _off(sub.p2v, s * scaps[0])
    return dataclasses.replace(merged, p2v=p2v)
