"""OccuSeg model family (counterpart of `occuseg_tpu/models/occuseg.py`).
`model.train()` switches every BatchNormalization to batch statistics;
nothing else depends on the mode.

* `_Backbone`: InputLayer -> SubmanifoldConv(in, m) -> UNet -> BN-ReLU ->
  OutputLayer. `in_features` is the point feature width (the config's
  `input_feature_number`: 3 for colours, 6 for colours and normals);
  `normal_guided` (--use_normal) rotates every submanifold convolution's
  filter by the plan's orientation classes. `compute_dtype` (bf16 on the
  card) is the dtype of every activation; parameters stay f32 and are
  cast at each use; BN statistics and conv accumulation are f32; the
  per-point output is cast to f32.
* `InstanceDenseUNet`: backbone + semantic, embedding, offset (sigmoid)
  and displacement heads, each fc -> linear in f32 with no activation in
  between.
* `LearningBWDenseUNet`: the flagship model, adding the bandwidth
  (2-dim softplus) and occupancy (1-dim softplus) heads.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import torch
from torch import nn
import torch.nn.functional as F

from occuseg_tpu_torch.core.topology import Topology
from occuseg_tpu_torch.nn.modules import (
    BatchNormReLU,
    InputLayer,
    OutputLayer,
    SubmanifoldConvolution,
)
from occuseg_tpu_torch.nn.unet import UNet


class OccuSegOutputs(NamedTuple):
    """Per-point predictions, all [P, ...] f32; padding rows are zero in
    the backbone features (heads add their biases)."""

    semantics: torch.Tensor       # [P, num_classes] logits
    features: torch.Tensor        # [P, m] backbone features
    embedding: torch.Tensor       # [P, m]
    offset: torch.Tensor          # [P, 1] sigmoid centredness
    displacement: torch.Tensor    # [P, 3] offset to the instance center
    bw: Optional[torch.Tensor] = None         # [P, 2] softplus bandwidths
    occupancy: Optional[torch.Tensor] = None  # [P, 1] softplus occupancy


def _linear(cin: int, cout: int, generator: Optional[torch.Generator]
            ) -> nn.Linear:
    """Dense layer initialised like flax's default: LeCun-normal kernel
    (std 1/sqrt(fan_in)), zero bias."""
    lin = nn.Linear(cin, cout)
    with torch.no_grad():
        lin.weight.copy_(torch.randn((cout, cin), generator=generator)
                         / cin ** 0.5)
        lin.bias.zero_()
    return lin


class _Backbone(nn.Module):
    def __init__(self, n_planes: Sequence[int], block_reps: int = 1,
                 residual_blocks: bool = True,
                 compute_dtype: torch.dtype = torch.float32,
                 in_features: int = 3, normal_guided: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.input = InputLayer()
        self.sub = SubmanifoldConvolution(in_features, n_planes[0],
                                          normal_guided=normal_guided,
                                          generator=generator)
        self.unet = UNet(block_reps, tuple(n_planes),
                         residual_blocks=residual_blocks,
                         normal_guided=normal_guided, generator=generator)
        self.bn = BatchNormReLU(n_planes[0])
        self.output = OutputLayer()

    def forward(self, point_features: torch.Tensor,
                plan: Topology) -> torch.Tensor:
        x = self.input(point_features.to(self.compute_dtype), plan)
        x = self.sub(x, plan)
        x = self.unet(x, plan)
        x = self.bn(x, plan)
        return self.output(x, plan).float()


class InstanceDenseUNet(nn.Module):
    """Backbone + semantic / embedding / offset / displacement heads."""

    def __init__(self, n_planes: Sequence[int], num_classes: int = 20,
                 block_reps: int = 1, residual_blocks: bool = True,
                 compute_dtype: torch.dtype = torch.float32,
                 in_features: int = 3, normal_guided: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        m = n_planes[0]
        self.backbone = _Backbone(n_planes, block_reps, residual_blocks,
                                  compute_dtype, in_features, normal_guided,
                                  generator)
        self.linear = _linear(m, num_classes, generator)
        self.fc_embedding = _linear(m, m, generator)
        self.linear_embedding = _linear(m, m, generator)
        self.fc_regress = _linear(m, m, generator)
        self.linear_regress = _linear(m, 1, generator)
        self.fc_displacement = _linear(m, m, generator)
        self.linear_displacement = _linear(m, 3, generator)

    def forward(self, point_features: torch.Tensor,
                plan: Topology) -> OccuSegOutputs:
        f = self.backbone(point_features, plan)
        return OccuSegOutputs(
            semantics=self.linear(f),
            features=f,
            embedding=self.linear_embedding(self.fc_embedding(f)),
            offset=torch.sigmoid(self.linear_regress(self.fc_regress(f))),
            displacement=self.linear_displacement(self.fc_displacement(f)))


class LearningBWDenseUNet(nn.Module):
    """The flagship OccuSeg model."""

    def __init__(self, n_planes: Sequence[int], num_classes: int = 20,
                 block_reps: int = 1, residual_blocks: bool = True,
                 compute_dtype: torch.dtype = torch.float32,
                 in_features: int = 3, normal_guided: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        m = n_planes[0]
        self.backbone = InstanceDenseUNet(n_planes, num_classes, block_reps,
                                          residual_blocks, compute_dtype,
                                          in_features, normal_guided,
                                          generator)
        self.fc_bw = _linear(m, m, generator)
        self.linear_bw = _linear(m, 2, generator)
        self.fc_occupancy = _linear(m, m, generator)
        self.linear_occupancy = _linear(m, 1, generator)

    def forward(self, point_features: torch.Tensor,
                plan: Topology) -> OccuSegOutputs:
        base = self.backbone(point_features, plan)
        bw = F.softplus(self.linear_bw(self.fc_bw(base.features)))
        occupancy = F.softplus(self.linear_occupancy(
            self.fc_occupancy(base.features)))
        return base._replace(bw=bw, occupancy=occupancy)
