"""Joint semantic-instance refinement (counterpart of
`occuseg_tpu/cluster/refine.py`).

Reference `joint_semantic_instance_segmentation`
(`evaluate_instance.py:809-964`): greedily seed instances at the region
with the largest remaining centredness offset, take single-shot
cross-modal gaussian membership around the seed's (embedding, regressed
pose) with the seed's learned bandwidths x `bw_relax_factor`
(probabilities below 0.3 zeroed, membership at > 0.5), and REFINE the
instance's semantic class as the argmax of region softmax probabilities
weighted by membership probability x region point count.

As in the JAX package, every member region of the instance receives the
refined label (the reference stores it at the seed region only). The loop
is Python with one host read per instance, as in `meanshift_cluster`.
"""

from __future__ import annotations

from typing import Tuple

import torch

from occuseg_tpu_torch.cluster.meanshift import _cross_modal_prob
from occuseg_tpu_torch.cluster.supervoxel import RegionFeatures, Segments


def region_semantic_probability(logits: torch.Tensor, region: torch.Tensor,
                                r_cap: int) -> torch.Tensor:
    """Per-region mean softmax class probability [R, C] (reference
    `evaluate_instance.py:825-827`: point softmax then scatter_mean)."""
    p = torch.softmax(logits.float(), dim=-1)
    return region_mean(p, region, r_cap)


def region_mean(values: torch.Tensor, region: torch.Tensor, r_cap: int
                ) -> torch.Tensor:
    """Per-region mean [r_cap, C] of point rows [P, C]; padding points
    (-1) and ids at or above r_cap belong to no region."""
    seg = torch.where(region >= 0, region, r_cap)
    segs = Segments(seg, r_cap + 1)
    num = segs.reduce(values)[:r_cap]
    return num / torch.clamp(segs.count[:r_cap, None], min=1.0)


def joint_refine(regions: RegionFeatures, region_sem_prob: torch.Tensor,
                 bw_relax_factor: float = 1.0,
                 max_instances: int = 300,
                 min_instance_size: int = 0
                 ) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """Returns (region_instance [R] int32, -1 = none;
    region_semantic_refined [R] int32, unassigned regions keep the
    majority-vote class; num_instances)."""
    R = regions.count.shape[0]
    emb = regions.embedding.float()
    pose = regions.pose_embedding.float()
    bw = regions.bw.float()
    cnt = regions.count.float()
    rows = torch.arange(R, device=emb.device)

    background = regions.valid
    offsets = torch.where(background, regions.offset, 0.0)
    labels = torch.full((R,), -1, dtype=torch.int32, device=emb.device)
    sem = regions.semantic.int()

    count = 0
    while count < max_instances and bool(background.any()):  # a host read
        seed = torch.argmax(offsets).view(1)
        b = bw.index_select(0, seed)[0] * bw_relax_factor
        prob = _cross_modal_prob(emb, pose, emb.index_select(0, seed)[0],
                                 pose.index_select(0, seed)[0], b[0], b[1])
        prob = torch.where(prob < 0.3, 0.0, prob)         # :872
        flag = (prob > 0.5) & background                  # :873
        # semantic refinement: membership- and size-weighted vote (:928)
        w = cnt * prob
        vote = torch.argmax(torch.sum(region_sem_prob * w[:, None], dim=0)
                            / torch.clamp(torch.sum(w), min=1e-12)).int()
        big = torch.sum(flag.int()) > min_instance_size
        inst = torch.where(big, count + 1, -1).int()
        labels = torch.where(flag, inst, labels)
        sem = torch.where(flag & big, vote, sem)
        background = background & ~flag & (rows != seed)
        offsets = torch.where(background, offsets, 0.0)
        count += 1
    return labels, sem, count
