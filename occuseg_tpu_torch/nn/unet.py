"""Network builders (counterpart of `occuseg_tpu/nn/unet.py`).

`UNet`, per level: `reps` encoder blocks, then [identity | BN-ReLU ->
strided conv -> UNet(deeper) -> BN-ReLU -> deconv] joined by channel
concat, then `reps` decoder blocks, the first consuming twice the
channels. `FullyConvolutionalNet` concatenates every scale, brought back
by deconvolutions, at full resolution; `SparseVggNet` and `SparseResNet`
are the reference's VGG (with its multi-branch "Plus" specs, each branch
a `_PlusBranch`) and basic-block ResNet builders. Child names match the
flax modules one to one (UNet: enc0, down_bn, down_conv, inner, up_bn,
up_conv, dec0; in a block shortcut, bn1, conv1, bn2, conv2; VGG conv{i},
bn{i}, mp{i}, plus{i}b{b}; ResNet l{li}r{rep}_bn0 ... _sc, final_bn), so
flax parameter paths map directly onto the state_dict (`convert.py`).
Every builder's input width is explicit (UNet's and the FCN's is
n_planes[0]).
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
    BatchNormalization,
    BatchNormReLU,
    Convolution,
    Deconvolution,
    MaxPooling,
    NetworkInNetwork,
    SubmanifoldConvolution,
)


class _Block(nn.Module):
    """One VGG or pre-activated residual block (BN-(leaky)ReLU before each
    convolution)."""

    def __init__(self, in_features: int, out_features: int, residual: bool,
                 normal_guided: bool = False,
                 generator: Optional[torch.Generator] = None,
                 leakiness: float = 0.0):
        super().__init__()
        a, b = in_features, out_features
        ng = normal_guided
        self.residual = residual
        if residual and a != b:
            self.shortcut = NetworkInNetwork(a, b, generator=generator)
        self.bn1 = BatchNormalization(a, leakiness=leakiness)
        self.conv1 = SubmanifoldConvolution(a, b, normal_guided=ng,
                                            generator=generator)
        if residual:
            self.bn2 = BatchNormalization(b, leakiness=leakiness)
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
    plan's transitions must match). `leakiness` is every batch norm's
    activation (0: ReLU)."""

    def __init__(self, reps: int, n_planes: Sequence[int],
                 residual_blocks: bool = False, normal_guided: bool = False,
                 generator: Optional[torch.Generator] = None,
                 down_size: int = 2, down_stride: int = 2,
                 leakiness: float = 0.0):
        super().__init__()
        p = tuple(n_planes)
        ng, lk = normal_guided, leakiness
        self.reps = reps
        self.deep = len(p) > 1
        for i in range(reps):
            self.add_module(f"enc{i}", _Block(p[0], p[0], residual_blocks,
                                              ng, generator, lk))
        if not self.deep:
            return
        self.down_bn = BatchNormalization(p[0], leakiness=lk)
        ds = (down_size, down_stride)
        self.down_conv = Convolution(p[0], p[1], *ds, generator=generator)
        self.inner = UNet(reps, p[1:], residual_blocks, ng, generator, *ds,
                          leakiness=lk)
        self.up_bn = BatchNormalization(p[1], leakiness=lk)
        self.up_conv = Deconvolution(p[1], p[0], *ds, generator=generator)
        for i in range(reps):
            cin = p[0] * (2 if i == 0 else 1)
            self.add_module(f"dec{i}", _Block(cin, p[0], residual_blocks,
                                              ng, generator, lk))

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


class FullyConvolutionalNet(nn.Module):
    """Encoder pyramid whose every scale is brought back to full
    resolution by repeated deconvolutions and concatenated there: the
    output has sum(n_planes) channels. The input has n_planes[0]."""

    def __init__(self, reps: int, n_planes: Sequence[int],
                 residual_blocks: bool = False, down_size: int = 2,
                 down_stride: int = 2, leakiness: float = 0.0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        p = tuple(n_planes)
        self.reps = reps
        self.deep = len(p) > 1
        for i in range(reps):
            self.add_module(f"enc{i}", _Block(p[0], p[0], residual_blocks,
                                              generator=generator,
                                              leakiness=leakiness))
        if not self.deep:
            return
        ds = (down_size, down_stride)
        inner = sum(p[1:])
        self.down_bn = BatchNormalization(p[0], leakiness=leakiness)
        self.down_conv = Convolution(p[0], p[1], *ds, generator=generator)
        self.inner = FullyConvolutionalNet(reps, p[1:], residual_blocks,
                                           *ds, leakiness, generator)
        self.up_bn = BatchNormalization(inner, leakiness=leakiness)
        self.up_conv = Deconvolution(inner, inner, *ds, generator=generator)

    def forward(self, x: SparseTensor, plan: Topology) -> SparseTensor:
        for i in range(self.reps):
            x = getattr(self, f"enc{i}")(x, plan)
        if not self.deep:
            return x
        y = self.down_conv(self.down_bn(x, plan), plan)
        y = self.inner(y, plan)
        y = self.up_conv(self.up_bn(y, plan), plan)
        return concat_features(x, y)


class _PlusBranch(nn.Module):
    """One "Plus" side branch: `depth` times down (a size-3 stride-2
    convolution, BN-ReLU, submanifold convolution, BN-ReLU), then `depth`
    deconvolutions back with BN-ReLU, submanifold convolution, BN-ReLU
    between them."""

    def __init__(self, in_features: int, channels: int, depth: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        n, g = channels, generator
        self.depth = depth
        for j in range(depth):
            self.add_module(f"down{j}", Convolution(in_features if j == 0
                                                    else n, n, 3, 2,
                                                    generator=g))
            self.add_module(f"down{j}_bn", BatchNormReLU(n))
            self.add_module(f"down{j}_sub", SubmanifoldConvolution(
                n, n, generator=g))
            self.add_module(f"down{j}_sub_bn", BatchNormReLU(n))
        for j in range(depth):
            self.add_module(f"up{j}", Deconvolution(n, n, 3, 2, generator=g))
            if j < depth - 1:
                self.add_module(f"up{j}_bn", BatchNormReLU(n))
                self.add_module(f"up{j}_sub", SubmanifoldConvolution(
                    n, n, generator=g))
                self.add_module(f"up{j}_sub_bn", BatchNormReLU(n))

    def forward(self, x: SparseTensor, plan: Topology) -> SparseTensor:
        for j in range(self.depth):
            for name in ("", "_bn", "_sub", "_sub_bn"):
                x = getattr(self, f"down{j}{name}")(x, plan)
        for j in range(self.depth):
            x = getattr(self, f"up{j}")(x, plan)
            if j < self.depth - 1:
                for name in ("_bn", "_sub", "_sub_bn"):
                    x = getattr(self, f"up{j}{name}")(x, plan)
        return x


def _spec_is(spec, head: str, lengths) -> bool:
    return isinstance(spec, (tuple, list)) and spec[0] == head \
        and len(spec) in lengths


class SparseVggNet(nn.Module):
    """VGG-style builder over `layers`: "MP" (a size-3 stride-2 max pool),
    ("MP", size, stride), "C3/2" and ("C3/2", n) (a size-3 stride-2
    convolution and BN-ReLU), ("C", n) (a submanifold convolution and
    BN-ReLU), and the "Plus" specs ("C", n1, n2[, n3[, n4]]): a
    submanifold convolution to n1 joined (channel concat) with side
    branches of n2, n3, n4 channels that descend 1, 2, 3 levels and come
    back, then BN-ReLU. Strided convolutions need a plan built with
    down_size=3, down_stride=2 and enough levels for the deepest branch."""

    def __init__(self, in_features: int, layers,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g, c = generator, in_features
        self.layers = tuple(layers)
        for i, spec in enumerate(self.layers):
            if spec == "MP":
                self.add_module(f"mp{i}", MaxPooling(3, 2))
            elif _spec_is(spec, "MP", (3,)):
                self.add_module(f"mp{i}", MaxPooling(spec[1], spec[2]))
            elif spec == "C3/2" or _spec_is(spec, "C3/2", (2,)):
                n = c if spec == "C3/2" else spec[1]
                self.add_module(f"conv{i}", Convolution(c, n, 3, 2,
                                                        generator=g))
                self.add_module(f"bn{i}", BatchNormReLU(n))
                c = n
            elif _spec_is(spec, "C", (2,)):
                self.add_module(f"conv{i}", SubmanifoldConvolution(
                    c, spec[1], generator=g))
                self.add_module(f"bn{i}", BatchNormReLU(spec[1]))
                c = spec[1]
            elif _spec_is(spec, "C", (3, 4, 5)):
                self.add_module(f"conv{i}", SubmanifoldConvolution(
                    c, spec[1], generator=g))
                for b, n in enumerate(spec[2:]):
                    self.add_module(f"plus{i}b{b}", _PlusBranch(c, n, b + 1,
                                                                g))
                c = sum(spec[1:])
                self.add_module(f"bn{i}", BatchNormReLU(c))
            else:
                raise NotImplementedError(f"SparseVggNet spec {spec!r}")

    def forward(self, x: SparseTensor, plan: Topology) -> SparseTensor:
        for i, spec in enumerate(self.layers):
            if hasattr(self, f"mp{i}"):
                x = getattr(self, f"mp{i}")(x, plan)
                continue
            y = getattr(self, f"conv{i}")(x, plan)
            if _spec_is(spec, "C", (3, 4, 5)):
                for b in range(len(spec) - 2):
                    y = concat_features(y, getattr(self, f"plus{i}b{b}")(
                        x, plan))
            x = getattr(self, f"bn{i}")(y, plan)
        return x


class SparseResNet(nn.Module):
    """Pre-activated ResNet of basic blocks: `layers` is a sequence of
    (block_type, n, reps, stride); a block's first repetition at stride > 1
    downsamples with size-3 convolutions (on its main branch and its
    shortcut, so the plan needs down_size=3, down_stride=stride), and a
    width change at stride 1 takes a NetworkInNetwork shortcut. A final
    BN-ReLU ends the net."""

    def __init__(self, in_features: int, layers,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g, c = generator, in_features
        self.layers = tuple(tuple(spec) for spec in layers)
        for li, (block_type, n, reps, stride) in enumerate(self.layers):
            if not block_type.startswith("b"):
                raise NotImplementedError("only basic blocks are supported")
            for rep in range(reps):
                name = f"l{li}r{rep}"
                cin = c if rep == 0 else n
                self.add_module(f"{name}_bn0", BatchNormReLU(cin))
                if rep == 0 and stride > 1:
                    conv1 = Convolution(cin, n, 3, stride, generator=g)
                else:
                    conv1 = SubmanifoldConvolution(cin, n, generator=g)
                self.add_module(f"{name}_conv1", conv1)
                self.add_module(f"{name}_bn1", BatchNormReLU(n))
                self.add_module(f"{name}_conv2", SubmanifoldConvolution(
                    n, n, generator=g))
                if rep == 0 and stride > 1:
                    self.add_module(f"{name}_sc", Convolution(
                        cin, n, 3, stride, generator=g))
                elif rep == 0 and cin != n:
                    self.add_module(f"{name}_sc", NetworkInNetwork(
                        cin, n, generator=g))
            c = n
        self.final_bn = BatchNormReLU(c)

    def forward(self, x: SparseTensor, plan: Topology) -> SparseTensor:
        for li, (_, n, reps, stride) in enumerate(self.layers):
            for rep in range(reps):
                name = f"l{li}r{rep}"
                m = lambda part: getattr(self, f"{name}_{part}")  # noqa: E731
                if rep == 0:
                    x = m("bn0")(x, plan)
                    y = m("conv2")(m("bn1")(m("conv1")(x, plan), plan), plan)
                    sc = m("sc")(x, plan) if hasattr(self, f"{name}_sc") \
                        else x
                    x = add_features(y, sc)
                else:
                    y = m("conv1")(m("bn0")(x, plan), plan)
                    x = add_features(m("conv2")(m("bn1")(y, plan), plan), x)
        return self.final_bn(x, plan)
