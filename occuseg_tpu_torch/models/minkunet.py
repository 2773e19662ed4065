"""MinkUNet (Choy, Gwak and Savarese, "4D Spatio-Temporal ConvNets:
Minkowski Convolutional Neural Networks", CVPR 2019; MinkowskiEngine's
`examples/minkunet.py`, `MinkUNetBase`), the semantic segmentation UNet
that `examples/indoor.py` runs on ScanNet at 2 cm, built from the port's
sparse modules over a plan of `len(planes) // 2 + 1` levels.

* stem: a `stem_kernel`^3 submanifold convolution in_features ->
  init_dim (the plan's second stencil at level 0, `PlanSpec.stem_kernel`),
  BN, ReLU: `out_p1`;
* encoder stage i (level i + 1): a size-2 stride-2 convolution of the
  current width onto itself, BN, ReLU, then `layers[i]` BasicBlocks at
  `planes[i]`;
* decoder stage i (level E - 1 - i, E encoder stages): a size-2 stride-2
  deconvolution to `planes[E + i]`, BN, ReLU, the channel concat with the
  encoder's output at that level (`out_p1` at level 0), then
  `layers[E + i]` BasicBlocks at `planes[E + i]`;
* `final`: a 1x1 convolution with bias to the classes, on the voxels,
  whose logits `OutputLayer` copies to the points.

A BasicBlock is post-activation: conv 3^3, BN, ReLU, conv 3^3, BN, plus
the shortcut (a 1x1 convolution and BN where the width changes, else the
input), ReLU. No convolution but `final` has a bias. BN is eps 1e-5 and
momentum 0.1 in PyTorch's sense (the port's decay 0.9), with the port's
masked batch statistics. `MinkUNet34C` is the published preset: init_dim
32, layers (2, 3, 4, 6, 2, 2, 2, 2), planes (32, 64, 128, 256, 256, 128,
96, 96), a 5^3 stem; 37,856,052 parameters at 3 inputs and 20 classes.

The model is semantic-only (`semantic_only`): its forward returns
`SemanticOutputs`, the semantic logits per point, which `Trainer.step`
trains with the plain cross-entropy (`losses/semantic.semantic_step_loss`)
and `train.loop.evaluate_semantic` reads as `.semantics`. The stem
convolution's forward is the span `model.stem` (with the first use of the
plan's 5^3 map inside it, `plan.stem_map`).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch
from torch import nn

from occuseg_tpu_torch.core.sparse_tensor import (
    SparseTensor,
    add_features,
    concat_features,
)
from occuseg_tpu_torch.core.topology import Topology
from occuseg_tpu_torch.nn.modules import (
    BatchNormalization,
    BatchNormReLU,
    Convolution,
    Deconvolution,
    InputLayer,
    NetworkInNetwork,
    OutputLayer,
    SubmanifoldConvolution,
)
from occuseg_tpu_torch.ops import acc
from occuseg_tpu_torch.utils.profiling import span

BN_EPS = 1e-5

MINKUNET34C = dict(init_dim=32, layers=(2, 3, 4, 6, 2, 2, 2, 2),
                   planes=(32, 64, 128, 256, 256, 128, 96, 96),
                   stem_kernel=5)


class SemanticOutputs(NamedTuple):
    """Per-point predictions of a semantic-only model: the class logits
    [P, num_classes] f32 (padding points' rows carry the bias)."""

    semantics: torch.Tensor


def _bn(c: int) -> BatchNormalization:
    return BatchNormalization(c, eps=BN_EPS)


def _bn_relu(c: int) -> BatchNormReLU:
    return BatchNormReLU(c, eps=BN_EPS)


def _relu(x: SparseTensor) -> SparseTensor:
    return x.with_features(torch.relu(x.features))


class BasicBlock(nn.Module):
    """Post-activation residual block of two 3^3 submanifold
    convolutions (MinkowskiEngine's `BasicBlock`)."""

    def __init__(self, cin: int, cout: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.conv1 = SubmanifoldConvolution(cin, cout, generator=generator)
        self.bn1 = _bn_relu(cout)
        self.conv2 = SubmanifoldConvolution(cout, cout, generator=generator)
        self.bn2 = _bn(cout)
        if cin != cout:
            self.shortcut = NetworkInNetwork(cin, cout, generator=generator)
            self.shortcut_bn = _bn(cout)
        else:
            self.shortcut = self.shortcut_bn = None

    def forward(self, x: SparseTensor, plan: Topology) -> SparseTensor:
        y = self.bn1(self.conv1(x, plan), plan)
        y = self.bn2(self.conv2(y, plan), plan)
        sc = x if self.shortcut is None else \
            self.shortcut_bn(self.shortcut(x, plan), plan)
        return _relu(add_features(y, sc))


def _stage(cin: int, cout: int, reps: int,
           generator: Optional[torch.Generator]) -> nn.ModuleList:
    return nn.ModuleList(BasicBlock(cin if i == 0 else cout, cout, generator)
                         for i in range(reps))


class _Step(nn.Module):
    """A size-2 stride-2 convolution (down) or deconvolution (up), BN,
    ReLU."""

    def __init__(self, cin: int, cout: int, up: bool,
                 generator: Optional[torch.Generator]):
        super().__init__()
        cls = Deconvolution if up else Convolution
        self.conv = cls(cin, cout, 2, 2, generator=generator)
        self.bn = _bn_relu(cout)

    def forward(self, x: SparseTensor, plan: Topology) -> SparseTensor:
        return self.bn(self.conv(x, plan), plan)


class MinkUNet(nn.Module):
    """MinkUNetBase over `len(planes) // 2` encoder and as many decoder
    stages (module docstring); `layers[i]` BasicBlocks in stage i."""

    semantic_only = True

    def __init__(self, in_features: int = 3, num_classes: int = 20,
                 init_dim: int = 32,
                 layers: Sequence[int] = MINKUNET34C["layers"],
                 planes: Sequence[int] = MINKUNET34C["planes"],
                 stem_kernel: int = 5,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if len(planes) % 2 or len(layers) != len(planes):
            raise ValueError("MinkUNet: planes and layers name an encoder "
                             "and a decoder stage each, alike in number")
        E = len(planes) // 2
        self.num_levels = E + 1
        self.stem_kernel = stem_kernel
        self.input = InputLayer()
        self.stem = SubmanifoldConvolution(in_features, init_dim,
                                           kernel=stem_kernel,
                                           generator=generator)
        self.stem_bn = _bn_relu(init_dim)
        self.down, self.enc = nn.ModuleList(), nn.ModuleList()
        skips, c = [init_dim], init_dim
        for i in range(E):
            self.down.append(_Step(c, c, False, generator))
            self.enc.append(_stage(c, planes[i], layers[i], generator))
            c = planes[i]
            skips.append(c)
        self.up, self.dec = nn.ModuleList(), nn.ModuleList()
        for i in range(E):
            p = planes[E + i]
            self.up.append(_Step(c, p, True, generator))
            skip = skips[E - 1 - i]
            self.dec.append(_stage(p + skip, p, layers[E + i], generator))
            c = p
        self.final = NetworkInNetwork(c, num_classes, use_bias=True,
                                      generator=generator)
        self.output = OutputLayer()

    def forward(self, point_features: torch.Tensor,
                plan: Topology) -> SemanticOutputs:
        x = self.input(point_features, plan)
        with span("model.stem"):
            x = self.stem(x, plan)
        x = self.stem_bn(x, plan)
        skips = [x]
        for down, stage in zip(self.down, self.enc):
            x = down(x, plan)
            for block in stage:
                x = block(x, plan)
            skips.append(x)
        skips.pop()
        for up, stage in zip(self.up, self.dec):
            x = concat_features(up(x, plan), skips.pop())
            for block in stage:
                x = block(x, plan)
        x = self.final(x, plan)
        return SemanticOutputs(semantics=acc(self.output(x, plan)))

    def plan_muladds(self, plan: Topology) -> int:
        """MulAdds of one forward on a host plan (the training loop's
        counter), the real rulebook pairs times the widths, and the 1x1
        shortcuts and `final` over the active rows; the stem's 5^3 pairs
        are not on a host plan (its map is built on the device: the
        counter `plan.stem_pairs`) and are left out."""
        from occuseg_tpu_torch.ops.conv import conv_flops

        def rows(level):
            return int(np.sum(plan.levels[level].num_active))

        def stage(blocks, level):
            n = 0
            for b in blocks:
                for conv in (b.conv1, b.conv2):
                    _, cin, cout = conv.weight.shape
                    n += conv_flops(plan.levels[level].nbr, cin, cout)
                if b.shortcut is not None:
                    n += rows(level) * b.shortcut.weight.numel()
            return n

        E = len(self.enc)
        total = 0
        for i in range(E):
            _, cin, cout = self.down[i].conv.weight.shape
            total += conv_flops(plan.transitions[i].child, cin, cout)
            total += stage(self.enc[i], i + 1)
            _, cin, cout = self.up[i].conv.weight.shape
            total += conv_flops(plan.transitions[E - 1 - i].up, cin, cout)
            total += stage(self.dec[i], E - 1 - i)
        return total + rows(0) * self.final.weight.numel()


def MinkUNet34C(in_features: int = 3, num_classes: int = 20,
                generator: Optional[torch.Generator] = None) -> MinkUNet:
    """The published MinkUNet34C (module docstring)."""
    return MinkUNet(in_features, num_classes, generator=generator,
                    **MINKUNET34C)

