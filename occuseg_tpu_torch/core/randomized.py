"""Randomized-stride downsampling (counterpart of
`occuseg_tpu/core/randomized.py`): the fractional-pooling augmentation of
the reference's RandomizedStrideConvolution and RandomizedStrideMaxPooling.

Each axis gets shuffled window steps of stride - 1, stride and stride + 1
(`randomized_ticks`, drawn from a `numpy.random.Generator` on the host, in
the JAX package's order), whose per-coordinate tables of covering windows
(`_axis_tables`) are uploaded to the device of the coordinates in one copy
per transition. The coarse sites, their `child` map (the fine row at each
window start + offset) and the `up` map (the coarse row whose window start
+ offset is each fine site) are built there with the sorts, searches and
lookups of `core/coords.py`, bit for bit as the JAX package builds them.
The candidates' lookups do not depend on the offset and run once for all
offsets; the JAX package repeats them per offset, with the same results.
The plan carries no chunk rulebooks, so its convolutions take #9's gather
convolution; its counts are read to the host once, at its end.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from occuseg_tpu_torch.core import coords as C
from occuseg_tpu_torch.core.topology import (
    LevelTopology,
    LevelTransition,
    PlanSpec,
    Topology,
    _even_offsets,
    _level,
    _on_host_counts,
    _table,
    _voxelize,
    _with_count,
)


def randomized_ticks(rng: np.random.Generator, in_size: int, size: int,
                     stride: int) -> np.ndarray:
    """Per-axis left window edges (the reference's RSRTicks): out_size - 1
    shuffled steps, a third each of stride - 1 and stride + 1 and the rest
    stride, the output count rounded up so a clipped last window covers
    the tail."""
    out_size = max(-((size - in_size) // stride) + 1, 1)
    steps = np.full(out_size - 1, stride, np.int64)
    third = (out_size - 1) // 3
    steps[:third] = stride - 1
    steps[third:2 * third] = stride + 1
    rng.shuffle(steps)
    input_l = np.concatenate([[0], np.cumsum(steps)])
    return input_l.astype(np.int32)


def _axis_tables(input_l: np.ndarray, size: int, extent: int
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Dense per-coordinate [extent] tables: the first and last output
    window covering each input coordinate (-1 if none)."""
    out_min = np.full(extent, np.iinfo(np.int32).max, np.int32)
    out_max = np.full(extent, -1, np.int32)
    for j, l in enumerate(input_l):
        for c in range(l, min(l + size, extent)):
            out_min[c] = min(out_min[c], j)
            out_max[c] = max(out_max[c], j)
    out_min[out_min == np.iinfo(np.int32).max] = -1
    return out_min, out_max


def _upload(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array on `device`; to a card from page-locked memory,
    queued without the host waiting."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def _transition(fine: LevelTopology, rng: np.random.Generator, size: int,
                stride: int, cap: int, extent: int, kernel: int = 3
                ) -> Tuple[LevelTopology, LevelTransition]:
    """`build_randomized_transition` with the coarse count left on the
    device."""
    ticks = [randomized_ticks(rng, extent, size, stride) for _ in range(3)]
    tabs = [_axis_tables(t, size, extent) for t in ticks]
    nt = len(ticks[0])
    dev = fine.keys.device
    host = np.concatenate([np.stack([t[0] for t in tabs]),
                           np.stack([t[1] for t in tabs])], axis=1)
    host = np.concatenate([host, np.stack(ticks)], axis=1)  # [3, 2E + nt]
    tables = _upload(host, dev)
    o_min, o_max = tables[:, :extent], tables[:, extent:2 * extent]
    input_l = tables[:, 2 * extent:]

    fc = fine.coords
    valid = fc[:, 0] >= 0
    safe = fc[:, 1:].clamp(0, extent - 1).long()
    ncand = size

    def axis_cand(a):    # [ncand, N] the candidate windows of axis a
        lo = o_min[a][safe[:, a]]
        hi = o_max[a][safe[:, a]]
        o = lo[None] + torch.arange(ncand, dtype=lo.dtype,
                                    device=dev)[:, None]
        return torch.where(o <= hi[None], o, -1)

    oz, oy, ox = axis_cand(0), axis_cand(1), axis_cand(2)
    T = ncand ** 3
    q = torch.stack(torch.broadcast_tensors(
        fc[None, None, None, :, 0], oz[:, None, None], oy[None, :, None],
        ox[None, None, :]), dim=-1).reshape(T, -1, 4)    # [T, N, 4], z-major
    ok = valid[None] & (q[..., 1:] >= 0).all(dim=-1)
    q = torch.where(ok[..., None], q, -1)
    cand = C.pack(q)                                     # [T, N]
    skeys = torch.sort(cand.reshape(-1)).values
    coarse_keys, _, _ = C.compact_unique(skeys, cap)
    coarse = _level(coarse_keys, kernel)

    # child[j, k]: the fine row at window_start(j) + off_k
    cc = coarse.coords
    cvalid = cc[:, 0] >= 0
    csafe = cc[:, 1:].clamp(0, nt - 1).long()
    starts = torch.stack([input_l[a][csafe[:, a]] for a in range(3)], dim=1)
    offs = _table(_even_offsets(size), dev)                  # [K, 3]
    K = offs.shape[0]
    tgt = torch.cat([cc[None, :, :1].expand(K, -1, 1),
                     starts[None] + offs[:, None]], dim=-1)
    tgt = torch.where(cvalid[None, :, None], tgt, -1)
    child_kn = C.lookup(fine.keys, C.pack(tgt.reshape(-1, 4))).reshape(K, -1)

    # up[i, k]: the coarse row whose window start + off_k is fine site i;
    # the candidate windows' rows are looked up once, and of those whose
    # start matches, the last in candidate order is kept (at most one can)
    j = C.lookup(coarse.keys, cand.reshape(-1)).reshape(T, -1)   # [T, N]
    st = starts[j.clamp(0, cap - 1).long()]                      # [T, N, 3]
    hit = (j >= 0) & ok
    cols = []
    order = torch.arange(T, device=dev)[:, None]
    for k in range(K):
        m = (st + offs[k] == fc[None, :, 1:]).all(dim=-1) & hit
        last = torch.where(m, order, -1).amax(dim=0)
        pick = j.gather(0, last.clamp(min=0)[None])[0]
        cols.append(torch.where(last >= 0, pick, -1))
    up_kn = torch.stack(cols).to(torch.int32)
    tr = LevelTransition(child=child_kn.t(), up=up_kn.t(), size=size,
                         stride=stride)
    tr.kn.update(child=child_kn, up=up_kn)
    return coarse, tr


def build_randomized_transition(fine: LevelTopology,
                                rng: np.random.Generator, size: int,
                                stride: int, cap: int, extent: int,
                                kernel: int = 3
                                ) -> Tuple[LevelTopology, LevelTransition]:
    """(coarse level, transition) with jittered windows over `fine` (a
    level built on a device, e.g. by `core/topology.build_level`).
    `extent` bounds the fine coordinates (the tables' size); with steps
    as small as stride - 1, up to `size` windows cover one coordinate per
    axis, and all are candidates."""
    coarse, tr = _transition(fine, rng, size, stride, cap, extent, kernel)
    return _on_host_counts(coarse), tr


def build_randomized_plan(point_coords, spec: PlanSpec,
                          rng: np.random.Generator, extent: int) -> Topology:
    """The multi-scale topology whose every transition has jittered
    windows, planned on the device of `point_coords` [P, 4] (a NumPy array
    plans on the CPU): what a network of RandomizedStrideConvolution and
    RandomizedStrideMaxPooling modules trains on. The ticks are drawn
    from `rng`, per level three axes in turn; a level's extent is the
    previous level's window count (at least 2). The plan carries the
    points per voxel and no chunk rulebooks."""
    pc = torch.as_tensor(point_coords)
    dev = pc.device
    cap0 = spec.caps[0]
    keys0, p2v, _, seg = _voxelize(pc, cap0)
    num_points = (C.pack(pc) < C.KEY_PAD).sum(dtype=torch.int32)
    bounds = torch.searchsorted(seg, torch.arange(cap0 + 1, dtype=torch.int32,
                                                  device=dev))
    vox_counts = (bounds[1:] - bounds[:-1]).to(torch.float32)
    levels = [_level(keys0, spec.kernel, spec.dilation)]
    transitions = []
    ext = extent
    for li in range(1, spec.num_levels):
        coarse, tr = _transition(levels[-1], rng, spec.down_size,
                                 spec.down_stride, spec.caps[li], ext,
                                 spec.kernel)
        levels.append(coarse)
        transitions.append(tr)
        ext = max(len(randomized_ticks(np.random.default_rng(0), ext,
                                       spec.down_size, spec.down_stride)), 2)
    counts = torch.stack([l.num_active for l in levels]
                         + [num_points]).tolist()
    levels = tuple(_with_count(l, n) for l, n in zip(levels, counts))
    return Topology(levels=levels, transitions=tuple(transitions), p2v=p2v,
                    num_points=counts[-1], vox_counts=vox_counts)
