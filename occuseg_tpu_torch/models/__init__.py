"""The port's models, and `ARCHS`, the architectures that `--arch` names.

An entry holds what the name decides: `widths(m)`, the per-level widths
(the config's `unet_structure`) for the flag --m; `build(config,
generator)`, the config's model (`train.loop.build_model`); and `plan()`,
the `PlanSpec` fields the model needs beyond the caps, the stencil and
the guide levels (`train.loop.build_spec`). Entries read `MINKUNET34C`
when they are called, so a caller may narrow the preset first.
"""

from __future__ import annotations

from typing import Callable, Dict, List, NamedTuple, Optional

import torch

from occuseg_tpu_torch.models.occuseg import (  # noqa: F401
    ClusterSegNet,
    DenseUNet_BN,
    InstanceDenseUNet,
    LearningBWDenseUNet,
    OccuSegOutputs,
    ThreeVoxelKernel,
)
from occuseg_tpu_torch.models.minkunet import (  # noqa: F401
    MINKUNET34C,
    MinkUNet,
    MinkUNet34C,
    SemanticOutputs,
)


class Arch(NamedTuple):
    widths: Callable[[int], List[int]]
    build: Callable[[Dict, Optional[torch.Generator]], torch.nn.Module]
    plan: Callable[[], Dict]


def _occuseg(config: Dict, generator: Optional[torch.Generator]):
    """LearningBWDenseUNet under `use_dense_model`, else InstanceDenseUNet,
    over the config's widths, with normal-guided convolutions under
    `use_normal`."""
    planes = tuple(int(x) for x in config["unet_structure"])
    cls = (LearningBWDenseUNet if config.get("use_dense_model")
           else InstanceDenseUNet)
    return cls(planes, num_classes=config.get("class_num", 20),
               block_reps=config.get("block_reps", 1),
               residual_blocks=config.get("residual_blocks", True),
               in_features=int(config.get("input_feature_number", 3)),
               normal_guided=bool(config.get("use_normal", False)),
               generator=generator)


def _minkunet34c(config: Dict, generator: Optional[torch.Generator]):
    if config.get("use_normal"):
        raise ValueError("--use_normal: MinkUNet34C has no "
                         "normal-guided convolutions")
    return MinkUNet34C(int(config.get("input_feature_number", 3)),
                       config.get("class_num", 20), generator=generator)


def _minkunet34c_widths(m: int) -> List[int]:
    # one entry a level: the stem's width, then each encoder stage's
    planes = MINKUNET34C["planes"]
    return [MINKUNET34C["init_dim"]] + list(planes[:len(planes) // 2])


ARCHS: Dict[str, Arch] = {
    "occuseg": Arch(
        widths=lambda m: [m, 2 * m, 3 * m, 4 * m, 5 * m, 6 * m],
        build=_occuseg, plan=dict),
    # the 5^3 stem stencil at level 0, and each map's chunk budget grown
    # alone: its 8-room 2 cm batches overflow the budgets at most levels,
    # and the whole-plan rule then stages up to 1.7x the rows in every map
    # of a step, a different share of the steps each run (614k-736k
    # voxels/s over three seeds on one H100 against 744k-765k over six)
    "minkunet34c": Arch(
        widths=_minkunet34c_widths, build=_minkunet34c,
        plan=lambda: dict(stem_kernel=MINKUNET34C["stem_kernel"],
                          chunk_escalation="map")),
}
