"""Occupancy-aware cross-modal mean-shift instance extraction (counterpart
of `occuseg_tpu/cluster/meanshift.py`).

Reference: `occupancy_aware_region_based_cross_modal_meanshift_clustering`
(`evaluate_instance.py:485-645`), over region-level tensors:

  repeat until no seeds left (or 300 instances):
    seed   = argmax remaining region offset               (:542)
    prob_r = exp(-(||e_r-c_e||*b1)^2 - (||p_r-c_p||*b2)^2) (:546, the
             learned bandwidths MULTIPLY the distances, as in training)
    flag   = prob > 0.5 & background                       (:547)
    c      = sum_r w_r * feat_r / sum w_r,
             w_r = N(||(e,p)_r - c||; mean bw) * count_r   (:548-551)
    b      = mean bw over flagged regions * bw_relax       (:554)
    stop inner loop when ||shift|| < 1e-5                  (:563-565)
    assign instance, clear background + offsets            (:617-645)

Regions whose majority class is wall/floor (< 2) are pre-removed (:535-539).

The JAX package runs this as one device `lax.while_loop` around an 11-step
`fori_loop`. Here the outer loop is Python, with ONE host read per
instance (the loop condition); the 11 inner steps read nothing back: the
early stop freezes the carry with `torch.where`, as the JAX loop does, and
the seed is selected by index tensors, never by `.item()`. The instance id
is the loop count, empty seeds included, so the ids equal JAX's (with gaps
where a seed took no region).
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from occuseg_tpu_torch.cluster.supervoxel import RegionFeatures

_SQRT_2PI = math.sqrt(2 * math.pi)


def _cross_modal_prob(emb, pose, c_emb, c_pose, b1, b2):
    d1 = torch.sqrt(torch.sum((emb - c_emb) ** 2, dim=1) + 1e-12) * b1
    d2 = torch.sqrt(torch.sum((pose - c_pose) ** 2, dim=1) + 1e-12) * b2
    return torch.exp(-d1 * d1 - d2 * d2)


def meanshift_cluster(regions: RegionFeatures,
                      bw_relax_factor: float = 1.0,
                      max_instances: int = 300,
                      ms_iters: int = 11,
                      foreground_class_threshold: int = 2
                      ) -> Tuple[torch.Tensor, int]:
    """Returns (region_instance [R] int32 with -1 = background/none,
    num_instances)."""
    R = regions.count.shape[0]
    emb = regions.embedding.float()
    pose = regions.pose_embedding.float()
    E = emb.shape[1]
    feat = torch.cat([emb, pose], dim=1)
    bw = regions.bw.float()
    cnt = regions.count.float()
    rows = torch.arange(R, device=emb.device)

    background = regions.valid & (
        regions.semantic >= foreground_class_threshold)
    offsets = torch.where(background, regions.offset, 0.0)
    labels = torch.full((R,), -1, dtype=torch.int32, device=emb.device)

    count = 0
    while count < max_instances and bool(background.any()):  # a host read
        seed = torch.argmax(offsets).view(1)
        c = feat.index_select(0, seed)[0]
        b = bw.index_select(0, seed)[0] * bw_relax_factor
        flag = torch.zeros(R, dtype=torch.bool, device=emb.device)
        done = torch.zeros((), dtype=torch.bool, device=emb.device)
        for i in range(ms_iters):
            prob = _cross_modal_prob(emb, pose, c[:E], c[E:], b[0], b[1])
            new_flag = (prob > 0.5) & background
            d = torch.sqrt(torch.sum((feat - c) ** 2, dim=1) + 1e-12)
            bm = torch.clamp(torch.mean(b), min=1e-8)
            w = torch.exp(-0.5 * (d / bm) ** 2) / (bm * _SQRT_2PI)
            w = torch.where(new_flag, w * cnt, 0.0)
            wsum = torch.clamp(torch.sum(w), min=1e-12)
            new_c = torch.sum(feat * w[:, None], dim=0) / wsum
            nflag = torch.clamp(torch.sum(new_flag.float()), min=1.0)
            new_b = (torch.sum(torch.where(new_flag[:, None], bw, 0.0),
                               dim=0) / nflag) * bw_relax_factor
            # keep the old centroid if nothing was flagged (degenerate seed)
            any_flag = torch.any(new_flag)
            new_c = torch.where(any_flag, new_c, c)
            new_b = torch.where(any_flag, new_b, b)
            # reference break (:563-565): stop refining once the shift is
            # < 1e-5; the first (seeded) iteration has no break check, hence
            # i > 0. Freezing the carry == the reference's break.
            new_done = done
            if i > 0:
                shift = torch.sqrt(torch.sum((c - new_c) ** 2))
                new_done = done | (shift < 1e-5)
            c = torch.where(done, c, new_c)
            b = torch.where(done, b, new_b)
            flag = torch.where(done, flag, new_flag)
            done = new_done
        labels = labels.masked_fill(flag, count)
        # always consume the seed even if its cluster was empty, so the loop
        # can't spin on the same seed forever
        taken = flag | (rows == seed)
        background = background & ~taken
        offsets = offsets.masked_fill(taken, 0.0)
        count += 1
    return labels, count


def labels_to_points(region_labels: torch.Tensor, region: torch.Tensor
                     ) -> torch.Tensor:
    """Broadcast region instance ids back to points (-1 for padding); ids
    at or above R take the last region's id, as the JAX gather clamps."""
    safe = torch.clamp(region.long(), 0, region_labels.shape[0] - 1)
    out = region_labels[safe]
    return torch.where(region >= 0, out, -1)
