"""sparseconvnet-compatible facade (counterpart of `occuseg_tpu/legacy.py`).

Code written against the reference's `import sparseconvnet as scn` builds
with the same calls: dimension first, explicit nIn / nOut, filter sizes
and strides, the bias flag, `Sequential().add(...)` chaining and the
container tables. Every constructor returns one of the port's modules
(`nn/modules.py`, `nn/unet.py`, `nn/extras.py`), whose forward takes
`(x, plan)`; the facade adds no arithmetic of its own, so the kernels it
reaches are the modules': the chunk kernels where a level or transition
has rulebooks, the gather convolution elsewhere, the segment sum in
`InputLayer`. `dimension` must be 3. Unlike the flax facade, which reads
input widths from the data, torch modules size their weights when they
are built, so nIn is used (a whole network's input width is nPlanes[0] or
nInputPlanes). The weighted constructors also take the port's
`generator` keyword for their initialisation.

Children are registered under flax's names (`layers_0`, `layers_1`, ...
in a Sequential, `branches_0`, ... in a ConcatTable), so
`convert.from_flax` maps the weights of a model built with the JAX facade
one to one.

    import occuseg_tpu_torch.legacy as scn
    m = scn.Sequential().add(
        scn.SubmanifoldConvolution(3, 3, 64, 3, False)).add(
        scn.UNet(3, 2, [64, 128, 192, 256], residual_blocks=True)).add(
        scn.BatchNormReLU(64))
    y = m(x, plan)   # x: SparseTensor at level 0 of a plan
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from occuseg_tpu_torch.core.sparse_tensor import (
    SparseTensor,
    add_features,
    concat_features,
)
from occuseg_tpu_torch.core.topology import Topology
from occuseg_tpu_torch.nn import extras as _x
from occuseg_tpu_torch.nn import modules as _m
from occuseg_tpu_torch.nn import unet as _u
from occuseg_tpu_torch.nn.extras import (  # noqa: F401
    ELU,
    SELU,
    BatchwiseDropout,
    Dropout,
    Identity,
    LeakyReLU,
    ReLU,
    Sigmoid,
    Tanh,
)

Generator = Optional[torch.Generator]

# IOLayersRules.h:18: 0 unique and 2 keep take the first point of a
# voxel, 1 overwrites with the last, 3 sums, 4 averages
_INPUT_MODES = {0: "first", 1: "last", 2: "first", 3: "sum", 4: "mean"}


def _check3(dimension: int) -> None:
    if dimension != 3:
        raise ValueError("occuseg_tpu_torch supports dimension=3")


def SubmanifoldConvolution(dimension, nIn, nOut, filter_size, bias=False,
                           dilated_rate=1, generator: Generator = None):
    """`dilated_rate` is the plan's (`PlanSpec.dilation`), not the
    module's, as in the JAX facade."""
    _check3(dimension)
    return _m.SubmanifoldConvolution(nIn, nOut, filter_size,
                                     generator=generator, use_bias=bias)


def ValidConvolution(dimension, nIn, nOut, filter_size, bias=False,
                     generator: Generator = None):
    return SubmanifoldConvolution(dimension, nIn, nOut, filter_size, bias,
                                  generator=generator)


def Convolution(dimension, nIn, nOut, filter_size, filter_stride, bias=False,
                generator: Generator = None):
    _check3(dimension)
    return _m.Convolution(nIn, nOut, filter_size, filter_stride,
                          generator=generator, use_bias=bias)


def Deconvolution(dimension, nIn, nOut, filter_size, filter_stride,
                  bias=False, generator: Generator = None):
    _check3(dimension)
    return _m.Deconvolution(nIn, nOut, filter_size, filter_stride,
                            generator=generator, use_bias=bias)


def FullConvolution(dimension, nIn, nOut, filter_size, filter_stride,
                    bias=False, generator: Generator = None):
    """The active-set-growing transposed convolution: its forward returns
    (tensor, fresh plan), and `Sequential` threads the fresh plan to the
    layers after it."""
    _check3(dimension)
    return _m.FullConvolution(nIn, nOut, filter_size, filter_stride,
                              generator=generator, use_bias=bias)


TransposeConvolution = FullConvolution


def RandomizedStrideConvolution(dimension, nIn, nOut, filter_size,
                                filter_stride, bias=False,
                                generator: Generator = None):
    """Jittered-window strided convolution: train on a
    `core.randomized.build_randomized_plan` topology."""
    _check3(dimension)
    return _m.RandomizedStrideConvolution(nIn, nOut, filter_size,
                                          filter_stride, generator=generator,
                                          use_bias=bias)


def RandomizedStrideMaxPooling(dimension, pool_size, pool_stride):
    _check3(dimension)
    return _m.RandomizedStrideMaxPooling(pool_size, pool_stride)


def NetworkInNetwork(nIn, nOut, bias=False, generator: Generator = None):
    return _m.NetworkInNetwork(nIn, nOut, use_bias=bias, generator=generator)


def BatchNormalization(nPlanes, eps=1e-4, momentum=0.9, leakiness=1.0):
    return _m.BatchNormalization(nPlanes, eps=eps, leakiness=leakiness,
                                 momentum=momentum)


def BatchNormReLU(nPlanes, eps=1e-4, momentum=0.9):
    return _m.BatchNormalization(nPlanes, eps=eps, leakiness=0.0,
                                 momentum=momentum)


def BatchNormLeakyReLU(nPlanes, eps=1e-4, momentum=0.9, leakiness=0.333):
    return _m.BatchNormalization(nPlanes, eps=eps, leakiness=leakiness,
                                 momentum=momentum)


def MaxPooling(dimension, pool_size, pool_stride):
    _check3(dimension)
    return _m.MaxPooling(pool_size, pool_stride)


def AveragePooling(dimension, pool_size, pool_stride):
    _check3(dimension)
    return _m.AveragePooling(pool_size, pool_stride)


def UnPooling(dimension, pool_size, pool_stride):
    _check3(dimension)
    return _m.UnPooling(pool_size, pool_stride)


def InputLayer(dimension, spatial_size, mode=4, normal_guide_scale=None):
    """The reference's integer `mode` (`_INPUT_MODES`; another value is the
    mean). The spatial size and the normal guide scale are the plan's."""
    _check3(dimension)
    return _m.InputLayer(mode=_INPUT_MODES.get(mode, "mean"))


def OutputLayer(dimension):
    return _m.OutputLayer()


def UNet(dimension, reps, nPlanes, residual_blocks=False, downsample=(2, 2),
         leakiness=0, generator: Generator = None):
    _check3(dimension)
    return _u.UNet(reps, tuple(nPlanes), residual_blocks,
                   generator=generator, down_size=downsample[0],
                   down_stride=downsample[1], leakiness=leakiness)


def FullyConvolutionalNet(dimension, reps, nPlanes, residual_blocks=False,
                          downsample=(2, 2), generator: Generator = None):
    _check3(dimension)
    return _u.FullyConvolutionalNet(reps, tuple(nPlanes), residual_blocks,
                                    down_size=downsample[0],
                                    down_stride=downsample[1],
                                    generator=generator)


def SparseVggNet(dimension, nInputPlanes, layers,
                 generator: Generator = None):
    _check3(dimension)
    return _u.SparseVggNet(nInputPlanes, tuple(
        tuple(l) if isinstance(l, (list, tuple)) else l for l in layers),
        generator=generator)


def SparseResNet(dimension, nInputPlanes, layers,
                 generator: Generator = None):
    _check3(dimension)
    return _u.SparseResNet(nInputPlanes, tuple(tuple(l) for l in layers),
                           generator=generator)


def ShapeContext(dimension, nIn, filter_size=3):
    _check3(dimension)
    return _x.ShapeContext()


def MultiscaleShapeContext(dimension, nIn, n_scales=3, **_):
    _check3(dimension)
    return _x.MultiscaleShapeContext(num_scales=n_scales)


def PermutohedralSubmanifoldConvolution(dimension, nIn, nOut, bias=False,
                                        generator: Generator = None):
    """The plan must be built with `PlanSpec(lattice="permutohedral")`."""
    _check3(dimension)
    return _x.PermutohedralSubmanifoldConvolution(nIn, nOut, generator,
                                                  use_bias=bias)


def Identity_():
    return Identity()


Dropout_ = Dropout


class Sequential(nn.Module):
    """`scn.Sequential().add(m1).add(m2)`: children `layers_0`, `layers_1`,
    ... applied in order. A layer that returns (tensor, plan) (a
    FullConvolution's grown topology) hands that plan to the layers after
    it; the caller gets the tensor."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def add(self, module: nn.Module) -> "Sequential":
        self.add_module(f"layers_{self.n}", module)
        self.n += 1
        return self

    def forward(self, x, plan: Topology):
        for i in range(self.n):
            x = getattr(self, f"layers_{i}")(x, plan)
            if isinstance(x, tuple) and len(x) == 2:
                x, plan = x
        return x


class ConcatTable(nn.Module):
    """Each branch (`branches_0`, ...) applied to the same input: a
    list."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def add(self, module: nn.Module) -> "ConcatTable":
        self.add_module(f"branches_{self.n}", module)
        self.n += 1
        return self

    def forward(self, x, plan: Topology):
        return [getattr(self, f"branches_{i}")(x, plan)
                for i in range(self.n)]


class JoinTable(nn.Module):
    """Channel concat of a list of tensors on one level."""

    def forward(self, xs, plan: Optional[Topology] = None) -> SparseTensor:
        out = xs[0]
        for other in xs[1:]:
            out = concat_features(out, other)
        return out


class AddTable(nn.Module):
    """Elementwise sum of a list of tensors on one level."""

    def forward(self, xs, plan: Optional[Topology] = None) -> SparseTensor:
        out = xs[0]
        for other in xs[1:]:
            out = add_features(out, other)
        return out


class SparseToDense(nn.Module):
    """A level's features as the dense [B, E, E, E, C] grid
    (`nn/extras.sparse_to_dense`)."""

    def __init__(self, dimension: int = 3, nPlanes: int = 0,
                 spatial_size: int = 64, batch_size: int = 1):
        super().__init__()
        _check3(dimension)
        self.spatial_size, self.batch_size = spatial_size, batch_size

    def forward(self, x: SparseTensor, plan: Topology) -> torch.Tensor:
        return _x.sparse_to_dense(x, plan, self.spatial_size,
                                  self.batch_size)


def DenseToSparse(dimension=3, cap: int = 65536):
    """dense_mask -> the padded coords of its True cells; plan them to go
    on sparse."""
    _check3(dimension)
    return lambda dense_mask: _x.dense_to_sparse_coords(dense_mask, cap)


def Sparsify(dimension=3, cap: int = 65536, threshold: float = 0.0):
    """(x, plan) -> the padded coords of the sites that survive; plan
    them anew to go on."""
    _check3(dimension)
    return lambda x, plan: _x.sparsify_coords(x, plan, cap, threshold)


def InputLayerInput(coords, features):
    """The reference's (coords, features) pair fed to InputLayer."""
    return (coords, features)


class InputBatch:
    """The reference's InputBatch: collects per-sample point clouds and
    gives the padded batch arrays and their host plan."""

    def __init__(self, dimension: int, spatial_size: int,
                 p_cap: Optional[int] = None):
        _check3(dimension)
        self.spatial_size = spatial_size
        self.p_cap = p_cap
        self._coords = []
        self._features = []

    def add_sample(self, coords, features) -> None:
        b = len(self._coords)
        c = np.asarray(coords)
        self._coords.append(
            np.concatenate([np.full((c.shape[0], 1), b, c.dtype), c], axis=1))
        self._features.append(np.asarray(features))

    def precompute_metadata(self, spec):
        """The host plan (`native.plan.build_plan_host`) of the batch."""
        from occuseg_tpu_torch.native.plan import build_plan_host
        coords, _ = self.arrays()
        return build_plan_host(coords, spec)

    def arrays(self) -> Tuple[np.ndarray, np.ndarray]:
        """(coords [cap, 4] int32 with -1 padding, features [cap, C] f32),
        cap = p_cap or the point count; points past it are dropped."""
        coords = np.concatenate(self._coords).astype(np.int32)
        feats = np.concatenate(self._features).astype(np.float32)
        cap = self.p_cap or coords.shape[0]
        out_c = np.full((cap, 4), -1, np.int32)
        out_f = np.zeros((cap,) + feats.shape[1:], np.float32)
        n = min(coords.shape[0], cap)
        out_c[:n] = coords[:n]
        out_f[:n] = feats[:n]
        return out_c, out_f


def _numpy(a):
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _host_levels(plan: Topology):
    """The plan's levels and transitions with the arrays the merge reads
    as NumPy (a plan built on a device holds tensors)."""
    levels = tuple(dataclasses.replace(
        l, keys=_numpy(l.keys), coords=_numpy(l.coords),
        num_active=int(l.num_active), nbr=_numpy(l.nbr),
        orient=_numpy(l.orient), chunks=None) for l in plan.levels)
    transitions = tuple(dataclasses.replace(
        t, child=_numpy(t.child), up=_numpy(t.up), child_chunks=None,
        up_chunks=None) for t in plan.transitions)
    return dataclasses.replace(plan, levels=levels, transitions=transitions,
                               p2v=_numpy(plan.p2v))


def append_tensors(entries: Sequence[Tuple[SparseTensor, Topology]]
                   ) -> Tuple[SparseTensor, Topology]:
    """Concatenate one-scene tensors batch-wise (the reference's
    `append_tensors` and `appendMetadata`): the later tensors' scenes
    become further batch entries.

    `entries`: (SparseTensor, Topology) pairs on one level, every plan at
    the same per-level caps, every tensor of one scene (an int
    `num_active`). Returns the features concatenated by rows with the
    per-scene counts as `num_active`, and the blocked merged host plan
    (`native/blocked.merge_scene_plans`: scene s owns rows [s*cap,
    s*cap + n_s) of every level), its batch columns renumbered 0..ns-1 and
    its p2v the scenes' points in order. Chunk rulebooks are not carried
    over, so its convolutions take the gather path."""
    from occuseg_tpu_torch.native.blocked import merge_scene_plans

    tensors = [t for t, _ in entries]
    plans = [_host_levels(p) for _, p in entries]
    lvl = tensors[0].level
    if any(t.level != lvl for t in tensors):
        raise ValueError("append_tensors needs tensors on one level")
    if any(np.ndim(t.num_active) for t in tensors):
        raise ValueError("append_tensors needs one-scene tensors")
    scaps = tuple(l.keys.shape[0] for l in plans[0].levels)
    for p in plans[1:]:
        pc = tuple(l.keys.shape[0] for l in p.levels)
        if pc != scaps:
            raise ValueError(f"per-level caps differ: {pc} vs {scaps}")
    merged = merge_scene_plans(plans, scaps)
    levels = []
    for li, mlvl in enumerate(merged.levels):
        coords = mlvl.coords.copy()
        for s in range(len(plans)):
            blk = coords[s * scaps[li]:(s + 1) * scaps[li]]
            blk[:, 0] = np.where(blk[:, 0] >= 0, s, blk[:, 0])
        levels.append(dataclasses.replace(mlvl, coords=coords))
    p2v = np.concatenate([np.where(p.p2v >= 0, p.p2v + s * scaps[0], -1)
                          .astype(np.int32) for s, p in enumerate(plans)])
    merged = dataclasses.replace(merged, levels=tuple(levels), p2v=p2v)
    feats = torch.cat([t.features for t in tensors], dim=0)
    counts = tuple(int(t.num_active) for t in tensors)
    return SparseTensor(features=feats, num_active=counts, level=lvl), merged
