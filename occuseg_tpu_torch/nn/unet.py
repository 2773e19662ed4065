"""Recursive sparse UNet (counterpart of `occuseg_tpu/nn/unet.py`).

Per level: `reps` encoder blocks, then [identity | BN-ReLU -> strided conv
-> UNet(deeper) -> BN-ReLU -> deconv] joined by channel concat, then `reps`
decoder blocks, the first consuming twice the channels. Child names match
the flax modules one to one (enc0, down_bn, down_conv, inner, up_bn,
up_conv, dec0; in a block shortcut, bn1, conv1, bn2, conv2), so flax
parameter paths map directly onto the state_dict (`convert.py`).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from occuseg_tpu_torch.core.sparse_tensor import (
    SparseTensor,
    add_features,
    concat_features,
)
from occuseg_tpu_torch.core.topology import Topology
from occuseg_tpu_torch.nn.modules import (
    BatchNormReLU,
    Convolution,
    Deconvolution,
    NetworkInNetwork,
    SubmanifoldConvolution,
)


class _Block(nn.Module):
    """One VGG or pre-activated residual block (BN-ReLU before each
    convolution)."""

    def __init__(self, in_features: int, out_features: int, residual: bool,
                 normal_guided: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        a, b = in_features, out_features
        ng = normal_guided
        self.residual = residual
        if residual and a != b:
            self.shortcut = NetworkInNetwork(a, b, generator=generator)
        self.bn1 = BatchNormReLU(a)
        self.conv1 = SubmanifoldConvolution(a, b, normal_guided=ng,
                                            generator=generator)
        if residual:
            self.bn2 = BatchNormReLU(b)
            self.conv2 = SubmanifoldConvolution(b, b, normal_guided=ng,
                                                generator=generator)

    def forward(self, x: SparseTensor, plan: Topology) -> SparseTensor:
        y = self.conv1(self.bn1(x, plan), plan)
        if not self.residual:
            return y
        shortcut = self.shortcut(x, plan) if hasattr(self, "shortcut") else x
        y = self.conv2(self.bn2(y, plan), plan)
        return add_features(shortcut, y)


class UNet(nn.Module):
    """Recursive sparse UNet over widths n_planes (one per level);
    `normal_guided` applies to every submanifold convolution, and every
    level change is a convolution of `down_size` and `down_stride` (the
    plan's transitions must match)."""

    def __init__(self, reps: int, n_planes: Sequence[int],
                 residual_blocks: bool = False, normal_guided: bool = False,
                 generator: Optional[torch.Generator] = None,
                 down_size: int = 2, down_stride: int = 2):
        super().__init__()
        p = tuple(n_planes)
        ng = normal_guided
        self.reps = reps
        self.deep = len(p) > 1
        for i in range(reps):
            self.add_module(f"enc{i}", _Block(p[0], p[0], residual_blocks,
                                              ng, generator))
        if not self.deep:
            return
        self.down_bn = BatchNormReLU(p[0])
        ds = (down_size, down_stride)
        self.down_conv = Convolution(p[0], p[1], *ds, generator=generator)
        self.inner = UNet(reps, p[1:], residual_blocks, ng, generator, *ds)
        self.up_bn = BatchNormReLU(p[1])
        self.up_conv = Deconvolution(p[1], p[0], *ds, generator=generator)
        for i in range(reps):
            cin = p[0] * (2 if i == 0 else 1)
            self.add_module(f"dec{i}", _Block(cin, p[0], residual_blocks,
                                              ng, generator))

    def forward(self, x: SparseTensor, plan: Topology) -> SparseTensor:
        for i in range(self.reps):
            x = getattr(self, f"enc{i}")(x, plan)
        if not self.deep:
            return x
        y = self.down_conv(self.down_bn(x, plan), plan)
        y = self.inner(y, plan)
        y = self.up_conv(self.up_bn(y, plan), plan)
        x = concat_features(x, y)
        for i in range(self.reps):
            x = getattr(self, f"dec{i}")(x, plan)
        return x
