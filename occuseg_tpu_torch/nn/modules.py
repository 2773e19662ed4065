"""Sparse NN modules (counterpart of `occuseg_tpu/nn/modules.py`).

Every module's forward is `(x: SparseTensor, plan: Topology)`; topology is
read from the plan and level changes only move the tensor's `level`.
Parameter shapes match the JAX package (conv weight [K, Cin, Cout], NIN
[Cin, Cout]) and the reference He init std (2 / (Cin * K))^0.5, drawn
from an explicit `torch.Generator`.

Every convolution takes the first of these routes that applies:
  * a normal-guided submanifold convolution at a level whose plan carries
    normals (`LevelTopology.guided`) runs `ops/normal_guide.
    normal_guided_conv`, the gather-conv kernel over the neighbour map
    permuted by each site's orientation class;
  * where the map has a chunk rulebook and the chunk kernels take the
    output width (a multiple of 16; Cin is zero-padded), the chunked
    kernels of `ops/kernels/chunk_conv.py` (a strided convolution and a
    deconvolution hand them the transition's other rulebook as the
    transpose plan);
  * else the gather convolution of `ops/conv.py` over the map itself,
    with its backward map (the JAX package's fallback, `_chunk_supported`;
    the TPU kernel's Cout >= 32 is a limit of its compiler, not of these
    kernels, and is not copied). It reads the maps in its kernel's
    orientation from the plan (`gather_map`), which uploads each once.
The routes compute the same function. At the levels past
`PlanSpec.guide_levels` every orientation class is 0, the identity. A
plan built on the device (`core/topology.build_plan`) has no chunk
rulebook, so all of its convolutions take the gather path, as do
`FullConvolution`'s, whose grown topology is planned in its forward.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn
import torch.nn.functional as F

from occuseg_tpu_torch.core.sparse_tensor import SparseTensor
from occuseg_tpu_torch.core.topology import ChunkPlan, Topology
from occuseg_tpu_torch.ops import conv as conv_ops
from occuseg_tpu_torch.ops import norm as norm_ops
from occuseg_tpu_torch.ops import normal_guide
from occuseg_tpu_torch.ops import pool as pool_ops
from occuseg_tpu_torch.ops.kernels.chunk_conv import (
    chunk_gather_conv,
    chunk_gather_conv_t,
)

# the chunk kernels' MMA depth: Cin is zero-padded to a multiple of it,
# and Cout must be one
_CIN_ALIGN = 16


def _he_weight(shape, volume: int, generator: Optional[torch.Generator]):
    std = (2.0 / (shape[-2] * volume)) ** 0.5
    return nn.Parameter(torch.randn(shape, generator=generator) * std)


def chunk_route(chunks: Optional[ChunkPlan], cout: int) -> bool:
    """Whether a convolution with `cout` output channels over a map with
    chunk rulebook `chunks` (None: none) runs the chunk kernels; where it
    does not, it runs the gather convolution."""
    return chunks is not None and cout % _CIN_ALIGN == 0


def _run_chunked(feats: torch.Tensor, w: torch.Tensor, chunks: ChunkPlan,
                 t_chunks: Optional[ChunkPlan] = None) -> torch.Tensor:
    """Chunked conv over `chunks`: submanifold when `t_chunks` is None,
    else a transition with `t_chunks` as its transpose plan. Small Cin
    (the first 3 -> m conv) is zero-padded to the kernels' MMA depth in
    both feats and W; padded columns meet zero weights, so the output is
    unchanged, and F.pad's backward drops their gradient rows."""
    pad = (-feats.shape[1]) % _CIN_ALIGN
    if pad:
        feats = F.pad(feats, (0, pad))
        w = F.pad(w, (0, 0, 0, pad))
    if t_chunks is None:
        return chunk_gather_conv(feats, chunks.in_idx, chunks.lidx, w)
    return chunk_gather_conv_t(feats, chunks.in_idx, chunks.lidx,
                               t_chunks.in_idx, t_chunks.lidx, w)


class SubmanifoldConvolution(nn.Module):
    """Same-topology K^3 convolution over the level's neighbor map;
    `normal_guided` rotates each site's filter by its orientation class
    (the plan's `orient`, from point normals)."""

    def __init__(self, in_features: int, out_features: int, kernel: int = 3,
                 normal_guided: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        K = kernel ** 3
        self.normal_guided = normal_guided
        self.weight = _he_weight((K, in_features, out_features), K,
                                 generator)

    def forward(self, x: SparseTensor, plan: Topology) -> SparseTensor:
        lvl = plan.levels[x.level]
        if lvl.nbr.shape[1] != self.weight.shape[0]:
            raise ValueError(f"plan kernel volume {lvl.nbr.shape[1]} != "
                             f"module's {self.weight.shape[0]}")
        f = x.features
        if self.normal_guided and lvl.guided:
            out = normal_guide.normal_guided_conv(f, lvl.nbr, lvl.orient,
                                                  self.weight)
        elif chunk_route(lvl.chunks, self.weight.shape[2]):
            out = _run_chunked(f, self.weight, lvl.chunks)
        else:
            nbr = lvl.gather_map("nbr", f.device)
            out = conv_ops.gather_conv_kn(f, nbr, self.weight, nbr, True)
        return x.with_features(out)


class _Transition(nn.Module):
    """A size^3 convolution between level l and l+1 with `size^3`
    weights (the reference's Convolution / Deconvolution)."""

    def __init__(self, in_features: int, out_features: int, size: int,
                 stride: int, generator: Optional[torch.Generator]):
        super().__init__()
        self.size, self.stride = size, stride
        K = size ** 3
        self.weight = _he_weight((K, in_features, out_features), K,
                                 generator)

    def _transition(self, plan: Topology, t: int):
        tr = plan.transitions[t]
        if (tr.size, tr.stride) != (self.size, self.stride):
            raise ValueError(f"transition {t} is size {tr.size} stride "
                             f"{tr.stride}; the module's {self.size} "
                             f"{self.stride}")
        return tr


class Convolution(_Transition):
    """Strided convolution to the next coarser level (rulebook = the
    transition's child map; backward map `up`)."""

    def __init__(self, in_features: int, out_features: int, size: int = 2,
                 stride: int = 2,
                 generator: Optional[torch.Generator] = None):
        super().__init__(in_features, out_features, size, stride, generator)

    def forward(self, x: SparseTensor, plan: Topology) -> SparseTensor:
        tr = self._transition(plan, x.level)
        f = x.features
        if chunk_route(tr.child_chunks, self.weight.shape[2]):
            out = _run_chunked(f, self.weight, tr.child_chunks,
                               t_chunks=tr.up_chunks)
        else:
            out = conv_ops.gather_conv_kn(
                f, tr.gather_map("child", f.device), self.weight,
                tr.gather_map("up", f.device), False)
        return SparseTensor(features=out,
                            num_active=plan.levels[x.level + 1].num_active,
                            level=x.level + 1)


class Deconvolution(_Transition):
    """Transposed strided convolution back to the finer level (rulebook =
    the transition's up map; backward map `child`)."""

    def __init__(self, in_features: int, out_features: int, size: int = 2,
                 stride: int = 2,
                 generator: Optional[torch.Generator] = None):
        super().__init__(in_features, out_features, size, stride, generator)

    def forward(self, x: SparseTensor, plan: Topology) -> SparseTensor:
        if x.level == 0:
            raise ValueError("Deconvolution needs a finer level")
        tr = self._transition(plan, x.level - 1)
        f = x.features
        if chunk_route(tr.up_chunks, self.weight.shape[2]):
            out = _run_chunked(f, self.weight, tr.up_chunks,
                               t_chunks=tr.child_chunks)
        else:
            out = conv_ops.gather_conv_kn(
                f, tr.gather_map("up", f.device), self.weight,
                tr.gather_map("child", f.device), False)
        return SparseTensor(features=out,
                            num_active=plan.levels[x.level - 1].num_active,
                            level=x.level - 1)


class FullConvolution(nn.Module):
    """Active-set-growing transposed convolution (the reference's
    FullConvolution): its output sites are every in * stride + [0, size)^3
    position, a new topology rather than a return to a finer level of the
    plan. The grown level and its transition are planned on the features'
    device (`core/topology.full_conv_plan`); the convolution is #9's
    gather convolution over the transition's `up` map, with its `child`
    map as the backward's.

    Returns (SparseTensor at level 0 of a new one-level Topology, that
    Topology). `cap_out` is the output-site budget (default cap_in *
    size^3, the exact bound); `build_nbr` also builds the grown level's
    submanifold neighbour map for convolutions that follow on it."""

    def __init__(self, in_features: int, out_features: int, size: int = 2,
                 stride: int = 2, cap_out: Optional[int] = None,
                 build_nbr: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.size, self.stride = size, stride
        self.cap_out, self.build_nbr = cap_out, build_nbr
        K = size ** 3
        self.weight = _he_weight((K, in_features, out_features), K,
                                 generator)

    def forward(self, x: SparseTensor, plan: Topology):
        from occuseg_tpu_torch.core.topology import full_conv_plan
        f = x.features
        lvl = plan.levels[x.level]
        cap_out = self.cap_out or lvl.cap * self.size ** 3
        out_lvl, tr = full_conv_plan(lvl, self.size, self.stride, cap_out,
                                     build_nbr=self.build_nbr,
                                     device=f.device)
        out = conv_ops.gather_conv_kn(f, tr.gather_map("up", f.device),
                                      self.weight,
                                      tr.gather_map("child", f.device), False)
        new_plan = Topology(levels=(out_lvl,), transitions=(),
                            p2v=torch.full((1,), -1, dtype=torch.int32,
                                           device=f.device), num_points=0)
        return (SparseTensor(features=out, num_active=out_lvl.num_active,
                             level=0), new_plan)


class TransposeConvolution(FullConvolution):
    """The reference's alias of FullConvolution."""


class NetworkInNetwork(nn.Module):
    """1x1 convolution = row matmul."""

    def __init__(self, in_features: int, out_features: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.weight = _he_weight((in_features, out_features), 1, generator)

    def forward(self, x: SparseTensor, plan: Topology) -> SparseTensor:
        return x.with_features(conv_ops.nin(x.features, self.weight))


class BatchNormalization(nn.Module):
    """Masked BN + fused leaky activation, reference semantics (eps 1e-4;
    momentum 0.9 as a decay; leakiness 0 = ReLU, 1 = none). Running
    statistics are buffers; in training mode the forward normalises with
    the batch statistics and updates them in place."""

    leakiness = 1.0
    momentum = 0.9

    def __init__(self, num_channels: int, eps: float = 1e-4):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_channels))
        self.bias = nn.Parameter(torch.zeros(num_channels))
        self.register_buffer("running_mean", torch.zeros(num_channels))
        self.register_buffer("running_var", torch.ones(num_channels))

    def forward(self, x: SparseTensor, plan: Topology) -> SparseTensor:
        if self.training:
            return x.with_features(norm_ops.batch_norm_train(
                x.features, x.num_active, self.weight, self.bias,
                self.running_mean, self.running_var, eps=self.eps,
                momentum=self.momentum, leakiness=self.leakiness))
        return x.with_features(norm_ops.batch_norm_eval(
            x.features, x.num_active, self.weight, self.bias,
            self.running_mean, self.running_var, eps=self.eps,
            leakiness=self.leakiness))


class BatchNormReLU(BatchNormalization):
    leakiness = 0.0


class InputLayer(nn.Module):
    """Point cloud -> level-0 sparse tensor (mean of each voxel's point
    features)."""

    def forward(self, point_features: torch.Tensor,
                plan: Topology) -> SparseTensor:
        lvl = plan.levels[0]
        vox = pool_ops.voxelize_features(point_features, plan.p2v, lvl.cap,
                                         plan.vox_seg, plan.vox_counts)
        return SparseTensor(features=vox, num_active=lvl.num_active, level=0)


class OutputLayer(nn.Module):
    """Level-0 sparse tensor -> per-point features."""

    def forward(self, x: SparseTensor, plan: Topology) -> torch.Tensor:
        if x.level != 0:
            raise ValueError("OutputLayer expects level-0 features")
        return pool_ops.devoxelize_features(x.features, plan.p2v,
                                            plan.vox_seg)
