"""Cap buckets: pick the smallest cap set that fits each batch
(counterpart of `occuseg_tpu/train/bucketing.py`).

Padding rows cost full compute under static caps, and scenes vary ~4x in
voxel count, so the loader offers a few cap sets (buckets) and each batch
takes the smallest one whose level-0 cap fits its voxel count, with a
retry into bigger buckets on overflow. The same `PlanSpec` tuple a bucket
names also names the shapes of the step that runs it.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple
import warnings

import numpy as np

from occuseg_tpu_torch import native
from occuseg_tpu_torch.core.topology import PlanSpec, Topology
from occuseg_tpu_torch.infer import host_plan
from occuseg_tpu_torch.train.config import CAP_RATIOS


def bucket_specs(max_voxel_cap: int, num_levels: int,
                 num_buckets: int = 3, spec: PlanSpec = PlanSpec(caps=())
                 ) -> List[PlanSpec]:
    """`spec` at cap sets of max_voxel_cap / 2^k, smallest first, each
    level rounded up to a multiple of 1024 with the measured per-level
    ratios."""
    specs = []
    for k in reversed(range(num_buckets)):
        n0 = max(max_voxel_cap >> k, 2048)
        caps = tuple(
            max((int(n0 * CAP_RATIOS[min(l, len(CAP_RATIOS) - 1)]) + 1023)
                // 1024 * 1024, 1024)
            for l in range(num_levels))
        specs.append(dataclasses.replace(spec, caps=caps))
    return specs


def count_voxels(coords: np.ndarray) -> int:
    """Level-0 active voxel count (C++ hash voxelizer)."""
    p2v = native.voxelize_points(coords)
    return int(p2v.max()) + 1 if p2v.size and p2v.max() >= 0 else 0


def pick_bucket(specs: Sequence[PlanSpec], coords: np.ndarray,
                margin: float = 1.05) -> int:
    """Smallest bucket whose level-0 cap fits the batch's voxel count with
    `margin`; the last (biggest) when none does."""
    n0 = count_voxels(coords)
    for i, spec in enumerate(specs):
        if n0 * margin <= spec.caps[0]:
            return i
    return len(specs) - 1


def plan_for_batch(specs: Sequence[PlanSpec], coords: np.ndarray,
                   normals: Optional[np.ndarray] = None, ns: int = 1
                   ) -> Tuple[int, Topology]:
    """(bucket index, host plan) with overflow retry into bigger buckets,
    with orientation classes from the points' `normals` when given. ns > 1
    builds the blocked layout, whose overflow is per scene against its
    sub-cap (the batch's largest scene binds). A single spec is planned
    as it is: nothing to count, pick or retry."""
    if len(specs) == 1:
        return 0, host_plan(coords, specs[0], ns, normals)
    i = pick_bucket(specs, coords)
    while True:
        plan = host_plan(coords, specs[i], ns, normals)
        hot = [li for li, l in enumerate(plan.levels)
               if (np.asarray(l.num_active)
                   >= np.shape(l.keys)[0] // max(ns, 1)).any()]
        if not hot or i == len(specs) - 1:
            if hot:
                warnings.warn(
                    f"plan_for_batch: largest bucket (caps={specs[i].caps}) "
                    f"still overflows at levels {hot} with ns={ns}; voxels "
                    "were dropped: raise the bucket caps or lower the batch "
                    "size", RuntimeWarning)
            return i, plan
        i += 1
