"""Supervoxel (region) feature aggregation (counterpart of
`occuseg_tpu/cluster/supervoxel.py`).

Per-region gaussian-weighted means of embedding, pose embedding and
bandwidth, the max offset, point counts, the majority semantic class, the
mean occupancy and the mean xyz (reference `evaluate_instance.py:119-133`
and `:485-535`), over regions padded to a static `r_cap`.

Two rules of `jax.ops.segment_*` and JAX indexing are kept on purpose,
because region ids reach `r_cap` and beyond in practice (more regions than
`--region_cap`, or the `arange // 16` fallback on a large scene): a
reduction DROPS the rows whose id is out of range, and a gather by region
id CLAMPS the id to the last row.

Every reduction runs in a fixed order (`Segments`): a float `index_add_`
on a card adds by atomics, so its bits would change from run to run, and
with them the `> 0.5` memberships, the argmaxes and the merge's threshold
downstream; the offline clustering (`evaluate_instance --from_dump`) must
reproduce the inline proposals exactly.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F


class RegionFeatures(NamedTuple):
    embedding: torch.Tensor       # [R, E] gaussian-weighted mean embedding
    pose_embedding: torch.Tensor  # [R, 3] gw-mean of (xyz - displacement)
    bw: torch.Tensor              # [R, 2] gw-mean bandwidths
    offset: torch.Tensor          # [R] max centredness
    count: torch.Tensor           # [R] point count
    semantic: torch.Tensor        # [R] majority predicted class (int32)
    occupancy: torch.Tensor       # [R] mean log-occupancy
    center: torch.Tensor          # [R, 3] mean xyz
    valid: torch.Tensor           # [R] bool


class Segments:
    """Reductions over the segments [0, num) of `ids` [P] in a fixed order:
    the rows are stably sorted by id once, and `torch.segment_reduce` then
    reduces each segment's rows in their original order, so the result
    has the same bits in every run. Rows whose id is outside [0, num) are
    dropped, as `jax.ops.segment_sum` and `segment_max` drop them; a
    gather by an id past the end takes the last row, as JAX indexing
    clamps it."""

    def __init__(self, ids: torch.Tensor, num: int):
        ids = ids.long()
        bucket = torch.where((ids >= 0) & (ids < num), ids, num)
        self.num = num
        self.clamped = torch.clamp(ids, max=num - 1)
        self.order = torch.argsort(bucket, stable=True)
        # integer adds are exact in any order; the last bucket is dropped
        self.lengths = torch.zeros(num + 1, dtype=torch.long,
                                   device=ids.device).scatter_add_(
            0, bucket, torch.ones_like(bucket))

    @property
    def count(self) -> torch.Tensor:
        """Rows per segment [num], f32."""
        return self.lengths[:self.num].float()

    def reduce(self, values: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """[num, ...] per-segment "sum" or "max" of `values` [P, ...]; an
        empty segment sums to 0 and has the max -inf."""
        out = torch.segment_reduce(values[self.order], op,
                                   lengths=self.lengths, axis=0,
                                   unsafe=True)
        return out[:self.num]

    def gather(self, table: torch.Tensor) -> torch.Tensor:
        """[P, ...] rows of a per-segment `table` [num, ...]."""
        return table[self.clamped]


def _gw_region_mean(values: torch.Tensor, segs: Segments, r_cap: int
                    ) -> torch.Tensor:
    """Gaussian-weighted per-region mean (reference
    `evaluate_instance.py:119-133`): weight_p = exp(-(||v_p - mean_r|| /
    ||std_r||)^2), then weighted mean. `segs` hold r_cap + 1 segments
    (the last one holds the padding points)."""
    v = values.float()
    cnt = segs.count
    mean = segs.reduce(v) / torch.clamp(cnt[:, None], min=1)
    centered = v - segs.gather(mean)
    var = segs.reduce(centered * centered)
    # unbiased per-dim std, as torch_scatter scatter_std
    std = torch.sqrt(var / torch.clamp(cnt[:, None] - 1, min=1))
    std_norm = torch.sqrt(torch.sum((std + 1e-8) ** 2, dim=1))
    # no epsilon inside this sqrt: for a region of identical values d must
    # be exactly 0 so the weight is 1, as in the reference
    d = torch.sqrt(torch.sum(centered * centered, dim=1))
    w = torch.exp(-((d / torch.clamp(segs.gather(std_norm), min=1e-12))
                    ** 2))
    wsum = segs.reduce(w)
    wmean = segs.reduce(v * w[:, None])
    gw = wmean / torch.clamp(wsum[:, None], min=1e-12)
    # degenerate fallback: if all weights underflowed, use the plain mean
    return torch.where(wsum[:, None] > 1e-12, gw, mean)[:r_cap]


def aggregate_regions(embedding: torch.Tensor, displacement: torch.Tensor,
                      xyz: torch.Tensor, bw: torch.Tensor,
                      offset: torch.Tensor, semantic_pred: torch.Tensor,
                      occupancy: torch.Tensor, region: torch.Tensor,
                      r_cap: int, num_classes: int = 20) -> RegionFeatures:
    """region: [P] int supervoxel id per point (-1 = padding point); ids at
    or above r_cap fall out of every region."""
    segs = Segments(torch.where(region >= 0, region, r_cap), r_cap + 1)
    ones = (region >= 0).float()
    cnt = segs.count[:r_cap]

    emb_r = _gw_region_mean(embedding, segs, r_cap)
    pose_emb_r = _gw_region_mean(xyz - displacement, segs, r_cap)
    bw_r = _gw_region_mean(bw, segs, r_cap)

    off_r = segs.reduce(torch.where(region >= 0, offset.reshape(-1),
                                    float("-inf")), "max")[:r_cap]
    off_r = torch.where(cnt > 0, off_r, 0.0)

    # majority class via one-hot histogram (stats.mode analog); ties go to
    # the first class, as jnp.argmax and torch.argmax both do
    onehot = F.one_hot(torch.clamp(semantic_pred.long(), 0, num_classes - 1),
                       num_classes).float() * ones[:, None]
    hist = segs.reduce(onehot)[:r_cap]
    sem_r = torch.argmax(hist, dim=-1).int()

    occ_sum = segs.reduce(torch.where(region >= 0, occupancy.reshape(-1),
                                      0))[:r_cap]
    occ_r = occ_sum / torch.clamp(cnt, min=1)

    ctr = segs.reduce(xyz * ones[:, None])[:r_cap]
    ctr = ctr / torch.clamp(cnt[:, None], min=1)

    return RegionFeatures(embedding=emb_r, pose_embedding=pose_emb_r,
                          bw=bw_r, offset=off_r, count=cnt,
                          semantic=sem_r, occupancy=occ_r, center=ctr,
                          valid=cnt > 0)
