"""Sparse NN modules (counterpart of `occuseg_tpu/nn/modules.py`).

Every module's forward is `(x: SparseTensor, plan: Topology)`; topology is
read from the plan and level changes only move the tensor's `level`.
Parameter shapes match the JAX package (conv weight [K, Cin, Cout], NIN
[Cin, Cout]) and the reference He init std (2 / (Cin * K))^0.5, drawn
from an explicit `torch.Generator`.

Every convolution runs the chunked kernels over the plan's chunk rulebook,
through the autograd entry points of `ops/kernels/chunk_conv.py` (the
strided convolution and the deconvolution hand them the transition's
other map as the transpose plan), except a normal-guided submanifold
convolution at a level whose plan carries normals (`LevelTopology.guided`):
that one runs `ops/normal_guide.normal_guided_conv`, the gather-conv
kernel over the neighbour map permuted by each site's orientation class.
At the levels past `PlanSpec.guide_levels` every class is 0, the
identity, and the chunk kernels compute the same function. A level or
transition without a chunk plan (U overflow or a misaligned cap) makes
the forward raise and name it; there is no gather fallback yet.
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

# the kernel's MMA depth: Cin is zero-padded to a multiple of it
_CIN_ALIGN = 16


def _he_weight(shape, volume: int, generator: Optional[torch.Generator]):
    std = (2.0 / (shape[-2] * volume)) ** 0.5
    return nn.Parameter(torch.randn(shape, generator=generator) * std)


def _run_chunked(feats: torch.Tensor, w: torch.Tensor,
                 chunks: Optional[ChunkPlan], what: str,
                 t_chunks: Optional[ChunkPlan] = None) -> torch.Tensor:
    """Chunked conv over `chunks`: submanifold when `t_chunks` is None,
    else a transition with `t_chunks` as its transpose plan. Small Cin
    (the first 3 -> m conv) is zero-padded to the kernels' MMA depth in
    both feats and W; padded columns meet zero weights, so the output is
    unchanged, and F.pad's backward drops their gradient rows."""
    if chunks is None:
        raise RuntimeError(f"{what} has no chunk plan (U overflow or a "
                           f"misaligned cap); the gather path is not ported")
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
        if self.normal_guided and lvl.guided:
            out = normal_guide.normal_guided_conv(x.features, lvl.nbr,
                                                  lvl.orient, self.weight)
        else:
            out = _run_chunked(x.features, self.weight, lvl.chunks,
                               f"level {x.level}")
        return x.with_features(out)


class Convolution(nn.Module):
    """Size-2 stride-2 convolution to the next coarser level (rulebook =
    the transition's child map)."""

    def __init__(self, in_features: int, out_features: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.weight = _he_weight((8, in_features, out_features), 8,
                                 generator)

    def forward(self, x: SparseTensor, plan: Topology) -> SparseTensor:
        tr = plan.transitions[x.level]
        out = _run_chunked(x.features, self.weight, tr.child_chunks,
                           f"transition {x.level} (child map)",
                           t_chunks=tr.up_chunks)
        return SparseTensor(features=out,
                            num_active=plan.levels[x.level + 1].num_active,
                            level=x.level + 1)


class Deconvolution(nn.Module):
    """Transposed size-2 stride-2 convolution back to the finer level
    (rulebook = the transition's up map)."""

    def __init__(self, in_features: int, out_features: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.weight = _he_weight((8, in_features, out_features), 8,
                                 generator)

    def forward(self, x: SparseTensor, plan: Topology) -> SparseTensor:
        if x.level == 0:
            raise ValueError("Deconvolution needs a finer level")
        tr = plan.transitions[x.level - 1]
        out = _run_chunked(x.features, self.weight, tr.up_chunks,
                           f"transition {x.level - 1} (up map)",
                           t_chunks=tr.child_chunks)
        return SparseTensor(features=out,
                            num_active=plan.levels[x.level - 1].num_active,
                            level=x.level - 1)


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
