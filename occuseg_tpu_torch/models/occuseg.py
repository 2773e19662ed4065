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
* `ThreeVoxelKernel`: backbone + semantic, embedding and offset heads
  (its displacement is zeros).
* `ClusterSegNet`: supervoxel-cluster classifier, a point MLP, a
  per-cluster max and a cluster MLP, with flax's plain batch norm
  (`_DenseBatchNorm`) and leaky ReLU (slope 0.01).
* `DenseUNet_BN`: the dense-skip UNet with gated cross-scale fusion
  (`CrossScaleFusion`, `_RepResidualBlock`) over a plan's levels.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import torch
from torch import nn
import torch.nn.functional as F

from occuseg_tpu_torch.core.sparse_tensor import SparseTensor, add_features
from occuseg_tpu_torch.core.topology import Topology
from occuseg_tpu_torch.nn.extras import upsample_feature
from occuseg_tpu_torch.nn.modules import (
    BatchNormLeakyReLU,
    BatchNormReLU,
    Convolution,
    Deconvolution,
    InputLayer,
    NetworkInNetwork,
    OutputLayer,
    SubmanifoldConvolution,
)
from occuseg_tpu_torch.nn.unet import UNet, _Block
from occuseg_tpu_torch.ops import acc
from occuseg_tpu_torch.ops.pool import segment_max


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
                 generator: Optional[torch.Generator] = None,
                 down_size: int = 2, down_stride: int = 2):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.input = InputLayer()
        self.sub = SubmanifoldConvolution(in_features, n_planes[0],
                                          normal_guided=normal_guided,
                                          generator=generator)
        self.unet = UNet(block_reps, tuple(n_planes),
                         residual_blocks=residual_blocks,
                         normal_guided=normal_guided, generator=generator,
                         down_size=down_size, down_stride=down_stride)
        self.bn = BatchNormReLU(n_planes[0])
        self.output = OutputLayer()

    def forward(self, point_features: torch.Tensor,
                plan: Topology) -> torch.Tensor:
        x = self.input(point_features.to(self.compute_dtype), plan)
        x = self.sub(x, plan)
        x = self.unet(x, plan)
        x = self.bn(x, plan)
        return acc(self.output(x, plan))


class InstanceDenseUNet(nn.Module):
    """Backbone + semantic / embedding / offset / displacement heads."""

    def __init__(self, n_planes: Sequence[int], num_classes: int = 20,
                 block_reps: int = 1, residual_blocks: bool = True,
                 compute_dtype: torch.dtype = torch.float32,
                 in_features: int = 3, normal_guided: bool = False,
                 generator: Optional[torch.Generator] = None,
                 down_size: int = 2, down_stride: int = 2):
        super().__init__()
        m = n_planes[0]
        self.backbone = _Backbone(n_planes, block_reps, residual_blocks,
                                  compute_dtype, in_features, normal_guided,
                                  generator, down_size, down_stride)
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
                 generator: Optional[torch.Generator] = None,
                 down_size: int = 2, down_stride: int = 2):
        super().__init__()
        m = n_planes[0]
        self.backbone = InstanceDenseUNet(n_planes, num_classes, block_reps,
                                          residual_blocks, compute_dtype,
                                          in_features, normal_guided,
                                          generator, down_size, down_stride)
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


class ThreeVoxelKernel(nn.Module):
    """Backbone + semantic / embedding / offset heads; the displacement
    is zeros."""

    def __init__(self, n_planes: Sequence[int], num_classes: int = 20,
                 block_reps: int = 1, residual_blocks: bool = True,
                 compute_dtype: torch.dtype = torch.float32,
                 in_features: int = 3, normal_guided: bool = False,
                 generator: Optional[torch.Generator] = None,
                 down_size: int = 2, down_stride: int = 2):
        super().__init__()
        m = n_planes[0]
        self.backbone = _Backbone(n_planes, block_reps, residual_blocks,
                                  compute_dtype, in_features, normal_guided,
                                  generator, down_size, down_stride)
        self.linear = _linear(m, num_classes, generator)
        self.fc_embedding = _linear(m, m, generator)
        self.linear_embedding = _linear(m, m, generator)
        self.fc_regress = _linear(m, m, generator)
        self.linear_regress = _linear(m, 1, generator)

    def forward(self, point_features: torch.Tensor,
                plan: Topology) -> OccuSegOutputs:
        f = self.backbone(point_features, plan)
        return OccuSegOutputs(
            semantics=self.linear(f),
            features=f,
            embedding=self.linear_embedding(self.fc_embedding(f)),
            offset=torch.sigmoid(self.linear_regress(self.fc_regress(f))),
            displacement=torch.zeros(f.shape[:1] + (3,), dtype=f.dtype,
                                     device=f.device))


class _DenseBatchNorm(nn.Module):
    """flax's plain `nn.BatchNorm` over every row of [N, C] (pad rows
    included): in training mode the batch mean and the biased variance
    mean(x^2) - mean(x)^2 (clipped at 0) normalise, and the running
    statistics decay by `momentum` toward them (the biased variance: not
    `torch.nn.BatchNorm1d`'s unbiased update); eval mode uses the running
    ones. y = (x - mean) * (rsqrt(var + eps) * weight) + bias."""

    def __init__(self, num_channels: int, momentum: float = 0.9,
                 eps: float = 1e-4):
        super().__init__()
        self.momentum, self.eps = momentum, eps
        self.weight = nn.Parameter(torch.ones(num_channels))
        self.bias = nn.Parameter(torch.zeros(num_channels))
        self.register_buffer("running_mean", torch.zeros(num_channels))
        self.register_buffer("running_var", torch.ones(num_channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        f = acc(x)
        if self.training:
            mean = f.mean(0)
            var = torch.clamp((f * f).mean(0) - mean * mean, min=0)
            with torch.no_grad():
                self.running_mean.mul_(self.momentum).add_(
                    (1 - self.momentum) * mean)
                self.running_var.mul_(self.momentum).add_(
                    (1 - self.momentum) * var)
        else:
            mean, var = acc(self.running_mean), acc(self.running_var)
        mul = torch.rsqrt(var + self.eps) * acc(self.weight)
        return ((f - mean) * mul + acc(self.bias)).to(x.dtype)


def _leaky(h: torch.Tensor, slope: float = 0.01) -> torch.Tensor:
    """flax's `nn.leaky_relu`: x >= 0 ? x : slope * x."""
    return torch.where(h >= 0, h, slope * h)


class ClusterSegNet(nn.Module):
    """Supervoxel-cluster semantic classifier: point MLP (in -> 128 ->
    256, each Dense -> batch norm -> leaky ReLU), the max over each
    cluster's points (clusters given per point, -1 none; an empty cluster
    gives 0), cluster MLP (256 -> 128 -> num_classes). Returns
    [num_clusters, num_classes] logits."""

    def __init__(self, in_features: int, num_classes: int = 20,
                 num_clusters: int = 1024,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.num_clusters = num_clusters
        g = generator
        self.mlp1, self.l1_bn = _linear(in_features, 128, g), \
            _DenseBatchNorm(128)
        self.mlp2, self.l2_bn = _linear(128, 256, g), _DenseBatchNorm(256)
        self.mlp3, self.l3_bn = _linear(256, 128, g), _DenseBatchNorm(128)
        self.mlp4 = _linear(128, num_classes, g)

    def forward(self, features: torch.Tensor,
                cluster_index: torch.Tensor) -> torch.Tensor:
        y = _leaky(self.l1_bn(self.mlp1(features)))
        y = _leaky(self.l2_bn(self.mlp2(y)))
        n = self.num_clusters
        seg = torch.where(cluster_index >= 0, cluster_index, n)
        pooled = segment_max(y, seg, n + 1)
        pooled = torch.where(torch.isfinite(pooled), pooled,
                             torch.zeros((), dtype=pooled.dtype,
                                         device=pooled.device))[:n]
        z = _leaky(self.l3_bn(self.mlp3(pooled)))
        return self.mlp4(z)


class CrossScaleFusion(nn.Module):
    """Gated projection: linear(x) * sigmoid(reweight(x)), the one-wide
    gate broadcast over the output. The Dense layers run in f32 and the
    result is cast to the features' dtype (flax would keep a bf16 input's
    result in f32; in f32 the two agree)."""

    def __init__(self, in_features: int, out_features: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.linear = _linear(in_features, out_features, generator)
        self.reweight = _linear(in_features, 1, generator)

    def forward(self, x: SparseTensor, plan: Topology = None
                ) -> SparseTensor:
        f = acc(x.features)
        out = self.linear(f) * torch.sigmoid(self.reweight(f))
        return x.with_features(out.to(x.features.dtype))


class _RepResidualBlock(nn.Module):
    """`reps` chained pre-activated residual blocks (res0, res1, ...)."""

    def __init__(self, in_features: int, out_features: int, reps: int = 1,
                 leakiness: float = 0.0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.reps = reps
        for i in range(reps):
            cin = in_features if i == 0 else out_features
            self.add_module(f"res{i}", _Block(cin, out_features, True,
                                              generator=generator,
                                              leakiness=leakiness))

    def forward(self, x: SparseTensor, plan: Topology) -> SparseTensor:
        for i in range(self.reps):
            x = getattr(self, f"res{i}")(x, plan)
        return x


class DenseUNet_BN(nn.Module):
    """Dense-skip UNet with gated cross-scale fusion over widths n_planes
    (one per level; the input has n_planes[0]): an encoder of residual
    blocks and 2/2 strided convolutions; each decoder level deconvolves
    the level below (BN-LeakyReLU first), gates it through a biased NIN
    (`reweight`), adds the encoder skip, runs residual blocks, then ADDS
    the `CrossScaleFusion` projections of the deepest encoder output and
    of every earlier decoder output, each brought up by a chain of
    nearest `upsample_feature` calls, one level at a time, and ends in
    BN-LeakyReLU. `output_feature_lvl` > 0 stops the decoder there and
    brings its output up to level 0 the same way."""

    def __init__(self, n_planes: Sequence[int], block_reps: int = 1,
                 leakiness: float = 0.0, output_feature_lvl: int = 0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        p = tuple(n_planes)
        L, lk, g = len(p), leakiness, generator
        self.L, self.output_feature_lvl = L, output_feature_lvl
        for idx in range(L):
            self.add_module(f"res{idx}", _RepResidualBlock(
                p[idx], p[idx], block_reps, lk, g))
            if idx < L - 1:
                self.add_module(f"bn0_{idx}", BatchNormLeakyReLU(
                    p[idx], leakiness=lk))
                self.add_module(f"conv{idx}", Convolution(
                    p[idx], p[idx + 1], 2, 2, generator=g))
        for count in range(L - 1 - output_feature_lvl):
            li = L - 2 - count
            self.add_module(f"bn1_{li}", BatchNormLeakyReLU(
                p[li + 1], leakiness=lk))
            self.add_module(f"deconv{li}", Deconvolution(
                p[li + 1], p[li], 2, 2, generator=g))
            self.add_module(f"reweight{li}", NetworkInNetwork(
                p[li], p[li], use_bias=True, generator=g))
            self.add_module(f"res2_{li}", _RepResidualBlock(
                p[li], p[li], block_reps, lk, g))
            self.add_module(f"csf_deep_{li}", CrossScaleFusion(
                p[L - 1], p[li], g))
            for j in range(count):
                self.add_module(f"csf{j}_{li}", CrossScaleFusion(
                    p[L - 2 - j], p[li], g))
            self.add_module(f"bn2_{li}", BatchNormLeakyReLU(
                p[li], leakiness=lk))

    @staticmethod
    def _up_by(t: SparseTensor, to_level: int, plan: Topology
               ) -> SparseTensor:
        while t.level > to_level:
            t = upsample_feature(t, t.level - 1, plan, stride=2)
        return t

    def forward(self, x: SparseTensor, plan: Topology) -> SparseTensor:
        L = self.L
        m = lambda name: getattr(self, name)  # noqa: E731
        features = []
        cur = x
        for idx in range(L - 1):
            cur = m(f"res{idx}")(cur, plan)
            features.append(cur)
            cur = m(f"conv{idx}")(m(f"bn0_{idx}")(cur, plan), plan)
        features.append(m(f"res{L - 1}")(cur, plan))

        features2 = []
        for count in range(L - 1 - self.output_feature_lvl):
            li = L - 2 - count
            src = features[li + 1] if count == 0 else features2[-1]
            u = m(f"deconv{li}")(m(f"bn1_{li}")(src, plan), plan)
            u = m(f"reweight{li}")(u, plan)
            a = m(f"res2_{li}")(add_features(features[li], u), plan)
            b = m(f"csf_deep_{li}")(features[-1], plan)
            a = add_features(a, self._up_by(b, li, plan))
            for j in range(count):
                b = m(f"csf{j}_{li}")(features2[j], plan)
                a = add_features(a, self._up_by(b, li, plan))
            features2.append(m(f"bn2_{li}")(a, plan))
        out = features2[-1]
        if self.output_feature_lvl > 0:
            out = self._up_by(out, 0, plan)
        return out
