"""Sparse NN modules (counterpart of `occuseg_tpu/nn/modules.py`).

Every module's forward is `(x: SparseTensor, plan: Topology)`; topology is
read from the plan and level changes only move the tensor's `level`.
Parameter shapes match the JAX package (conv weight [K, Cin, Cout], NIN
[Cin, Cout]) and the reference He init std (2 / (Cin * K))^0.5, drawn
from an explicit `torch.Generator`.

Every convolution takes the first of these routes that applies:
  * over a rank's slice of a spatially sharded plan (the map carries a
    `HaloExchange`), `_sharded_conv`: the features are extended over the
    plan's process group, then convolved over the extended rows by the
    chunk kernels (with the exchange's transpose plan) or the gather
    convolution; this route is checked first, so a normal-guided
    convolution runs its identity filter there, as in the JAX package
    (its sharded plan has no orientation classes);
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
`FullConvolution`'s, whose grown topology is planned in its forward, and
those over a randomized plan (`core/randomized.py`).

The pooling modules reduce over the transition's child map (`up` for
UnPooling) in plain PyTorch (`ops/pool.py`); the IO layers voxelize in
the reference's five modes.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn
import torch.nn.functional as F

from occuseg_tpu_torch.core.sparse_tensor import SparseTensor
from occuseg_tpu_torch.core.topology import ChunkPlan, HaloExchange, Topology
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


def _bias(out_features: int, use_bias: bool) -> Optional[nn.Parameter]:
    """A zero-initialised bias of every output row, or None."""
    return nn.Parameter(torch.zeros(out_features)) if use_bias else None


def _add_bias(out: torch.Tensor, bias: Optional[torch.Tensor]
              ) -> torch.Tensor:
    """out + bias on every row (padding rows too), as the JAX modules add
    it after their convolution."""
    return out if bias is None else out + bias.to(out.dtype)


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


def _sharded_conv(feats: torch.Tensor, nbr_kn: torch.Tensor,
                  ex: HaloExchange, w: torch.Tensor,
                  chunks: Optional[ChunkPlan], group) -> torch.Tensor:
    """A convolution over a spatially sharded map (`occuseg_tpu/nn/
    modules.py:34-69`): this rank's features extended over `group`
    (`parallel/comm.extend_features`), then the chunk kernels over the
    map's rulebook with the exchange's transpose plan where both are
    there and the width suits them, else the gather convolution over the
    map (`nbr_kn`, the kernel's orientation: S output rows over the
    extended rows) with its transpose `ex.nbr_t` as the backward map."""
    from occuseg_tpu_torch.parallel import comm
    ext = comm.extend_features(feats, ex.send_left, ex.send_right,
                               ex.publish, ex.halo, group, ex.sent)
    if ex.chunks_t is not None and chunk_route(chunks, w.shape[2]):
        return _run_chunked(ext, w, chunks, t_chunks=ex.chunks_t)
    return conv_ops.gather_conv_kn(ext, nbr_kn, w,
                                   ex.gather_map("nbr_t", ext.device), True)


class SubmanifoldConvolution(nn.Module):
    """Same-topology K^3 convolution over the level's neighbor map;
    `normal_guided` rotates each site's filter by its orientation class
    (the plan's `orient`, from point normals)."""

    def __init__(self, in_features: int, out_features: int, kernel: int = 3,
                 normal_guided: bool = False,
                 generator: Optional[torch.Generator] = None,
                 use_bias: bool = False):
        super().__init__()
        K = kernel ** 3
        self.normal_guided = normal_guided
        self.weight = _he_weight((K, in_features, out_features), K,
                                 generator)
        self.bias = _bias(out_features, use_bias)

    def forward(self, x: SparseTensor, plan: Topology) -> SparseTensor:
        lvl = plan.levels[x.level]
        if lvl.nbr.shape[1] != self.weight.shape[0]:
            raise ValueError(f"plan kernel volume {lvl.nbr.shape[1]} != "
                             f"module's {self.weight.shape[0]}")
        f = x.features
        if lvl.halo_ex is not None:
            out = _sharded_conv(f, lvl.gather_map("nbr", f.device),
                                lvl.halo_ex, self.weight, lvl.chunks,
                                plan.group)
        elif self.normal_guided and lvl.guided:
            out = normal_guide.normal_guided_conv(f, lvl.nbr, lvl.orient,
                                                  self.weight)
        elif chunk_route(lvl.chunks, self.weight.shape[2]):
            out = _run_chunked(f, self.weight, lvl.chunks)
        else:
            nbr = lvl.gather_map("nbr", f.device)
            out = conv_ops.gather_conv_kn(f, nbr, self.weight, nbr, True)
        return x.with_features(_add_bias(out, self.bias))


class _Transition(nn.Module):
    """A size^3 convolution between level l and l+1 with `size^3`
    weights (the reference's Convolution / Deconvolution)."""

    def __init__(self, in_features: int, out_features: int, size: int,
                 stride: int, generator: Optional[torch.Generator],
                 use_bias: bool = False):
        super().__init__()
        self.size, self.stride = size, stride
        K = size ** 3
        self.weight = _he_weight((K, in_features, out_features), K,
                                 generator)
        self.bias = _bias(out_features, use_bias)

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
                 generator: Optional[torch.Generator] = None,
                 use_bias: bool = False):
        super().__init__(in_features, out_features, size, stride, generator,
                         use_bias)

    def forward(self, x: SparseTensor, plan: Topology) -> SparseTensor:
        tr = self._transition(plan, x.level)
        f = x.features
        if tr.child_ex is not None:
            out = _sharded_conv(f, tr.gather_map("child", f.device),
                                tr.child_ex, self.weight, tr.child_chunks,
                                plan.group)
        elif chunk_route(tr.child_chunks, self.weight.shape[2]):
            out = _run_chunked(f, self.weight, tr.child_chunks,
                               t_chunks=tr.up_chunks)
        else:
            out = conv_ops.gather_conv_kn(
                f, tr.gather_map("child", f.device), self.weight,
                tr.gather_map("up", f.device), False)
        return SparseTensor(features=_add_bias(out, self.bias),
                            num_active=plan.levels[x.level + 1].num_active,
                            level=x.level + 1)


class Deconvolution(_Transition):
    """Transposed strided convolution back to the finer level (rulebook =
    the transition's up map; backward map `child`)."""

    def __init__(self, in_features: int, out_features: int, size: int = 2,
                 stride: int = 2,
                 generator: Optional[torch.Generator] = None,
                 use_bias: bool = False):
        super().__init__(in_features, out_features, size, stride, generator,
                         use_bias)

    def forward(self, x: SparseTensor, plan: Topology) -> SparseTensor:
        if x.level == 0:
            raise ValueError("Deconvolution needs a finer level")
        tr = self._transition(plan, x.level - 1)
        f = x.features
        if tr.up_ex is not None:
            out = _sharded_conv(f, tr.gather_map("up", f.device), tr.up_ex,
                                self.weight, tr.up_chunks, plan.group)
        elif chunk_route(tr.up_chunks, self.weight.shape[2]):
            out = _run_chunked(f, self.weight, tr.up_chunks,
                               t_chunks=tr.child_chunks)
        else:
            out = conv_ops.gather_conv_kn(
                f, tr.gather_map("up", f.device), self.weight,
                tr.gather_map("child", f.device), False)
        return SparseTensor(features=_add_bias(out, self.bias),
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
                 generator: Optional[torch.Generator] = None,
                 use_bias: bool = False):
        super().__init__()
        self.size, self.stride = size, stride
        self.cap_out, self.build_nbr = cap_out, build_nbr
        K = size ** 3
        self.weight = _he_weight((K, in_features, out_features), K,
                                 generator)
        self.bias = _bias(out_features, use_bias)

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
        return (SparseTensor(features=_add_bias(out, self.bias),
                             num_active=out_lvl.num_active, level=0),
                new_plan)


class TransposeConvolution(FullConvolution):
    """The reference's alias of FullConvolution."""


class NetworkInNetwork(nn.Module):
    """1x1 convolution = row matmul (with `use_bias`, plus a bias)."""

    def __init__(self, in_features: int, out_features: int,
                 use_bias: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.weight = _he_weight((in_features, out_features), 1, generator)
        self.bias = _bias(out_features, use_bias)

    def forward(self, x: SparseTensor, plan: Topology) -> SparseTensor:
        return x.with_features(conv_ops.nin(x.features, self.weight,
                                            self.bias))


class BatchNormalization(nn.Module):
    """Masked BN + fused leaky activation, reference semantics (eps 1e-4;
    momentum 0.9 as a decay; leakiness 0 = ReLU, 1 = none; a subclass
    sets its default, an argument overrides it). Running statistics are
    buffers; in training mode the forward normalises with the batch
    statistics and updates them in place. Over a rank's slice of a
    spatially sharded plan the batch statistics are summed over the
    plan's process group (`plan.group`)."""

    leakiness = 1.0
    momentum = 0.9

    def __init__(self, num_channels: int, eps: float = 1e-4,
                 leakiness: Optional[float] = None,
                 momentum: Optional[float] = None):
        super().__init__()
        self.eps = eps
        if leakiness is not None:
            self.leakiness = leakiness
        if momentum is not None:
            self.momentum = momentum
        self.weight = nn.Parameter(torch.ones(num_channels))
        self.bias = nn.Parameter(torch.zeros(num_channels))
        self.register_buffer("running_mean", torch.zeros(num_channels))
        self.register_buffer("running_var", torch.ones(num_channels))

    def forward(self, x: SparseTensor, plan: Topology) -> SparseTensor:
        if self.training:
            return x.with_features(norm_ops.batch_norm_train(
                x.features, x.num_active, self.weight, self.bias,
                self.running_mean, self.running_var, eps=self.eps,
                momentum=self.momentum, leakiness=self.leakiness,
                group=getattr(plan, "group", None)))
        return x.with_features(norm_ops.batch_norm_eval(
            x.features, x.num_active, self.weight, self.bias,
            self.running_mean, self.running_var, eps=self.eps,
            leakiness=self.leakiness))


class BatchNormReLU(BatchNormalization):
    leakiness = 0.0


class BatchNormLeakyReLU(BatchNormalization):
    leakiness = 0.333


class MaxPooling(nn.Module):
    """Max over each coarse site's children in the transition from the
    tensor's level (`ops/pool.max_pool`). `size` and `stride` are the
    reference's arguments; as in the JAX package the plan's transition
    is taken as it is."""

    def __init__(self, size: int = 2, stride: int = 2):
        super().__init__()
        self.size, self.stride = size, stride

    def _pool(self, f, child):
        return pool_ops.max_pool(f, child)

    def forward(self, x: SparseTensor, plan: Topology) -> SparseTensor:
        tr = plan.transitions[x.level]
        f = x.features
        out = self._pool(f, tr.gather_map("child", f.device).t())
        return SparseTensor(features=out,
                            num_active=plan.levels[x.level + 1].num_active,
                            level=x.level + 1)


class AveragePooling(MaxPooling):
    """Mean over each coarse site's children (`ops/pool.avg_pool`)."""

    def _pool(self, f, child):
        return pool_ops.avg_pool(f, child)


class UnPooling(nn.Module):
    """Coarse features back onto the finer level through the transition's
    up map (`ops/pool.unpool`)."""

    def __init__(self, size: int = 2, stride: int = 2):
        super().__init__()
        self.size, self.stride = size, stride

    def forward(self, x: SparseTensor, plan: Topology) -> SparseTensor:
        if x.level == 0:
            raise ValueError("UnPooling needs a finer level")
        tr = plan.transitions[x.level - 1]
        f = x.features
        out = pool_ops.unpool(f, tr.gather_map("up", f.device).t())
        return SparseTensor(features=out,
                            num_active=plan.levels[x.level - 1].num_active,
                            level=x.level - 1)


class InputLayer(nn.Module):
    """Point cloud -> level-0 sparse tensor: each voxel's point features
    reduced in `mode` (`ops/pool.MODES`; the mean by default)."""

    def __init__(self, mode: str = "mean"):
        super().__init__()
        if mode not in pool_ops.MODES:
            raise ValueError(f"unknown voxelize mode: {mode}")
        self.mode = mode

    def forward(self, point_features: torch.Tensor,
                plan: Topology) -> SparseTensor:
        lvl = plan.levels[0]
        vox = pool_ops.voxelize_features(point_features, plan.p2v, lvl.cap,
                                         plan.vox_seg, plan.vox_counts,
                                         self.mode)
        return SparseTensor(features=vox, num_active=lvl.num_active, level=0)


class OutputLayer(nn.Module):
    """Level-0 sparse tensor -> per-point features."""

    def forward(self, x: SparseTensor, plan: Topology) -> torch.Tensor:
        if x.level != 0:
            raise ValueError("OutputLayer expects level-0 features")
        return pool_ops.devoxelize_features(x.features, plan.p2v,
                                            plan.vox_seg)


class BLInputLayer(InputLayer):
    """Batch x length point-cloud input: features [B, L, C] whose coords
    [B, L, 4] were flattened into the plan (rows with coords < 0 are
    padding) -> level-0 sparse tensor."""

    def forward(self, point_features: torch.Tensor,
                plan: Topology) -> SparseTensor:
        B, L, C = point_features.shape
        return super().forward(point_features.reshape(B * L, C), plan)


class BLOutputLayer(nn.Module):
    """Inverse of BLInputLayer: level-0 features -> [B, L, C]."""

    def __init__(self, batch_size: int = 1):
        super().__init__()
        self.batch_size = batch_size

    def forward(self, x: SparseTensor, plan: Topology) -> torch.Tensor:
        if x.level != 0:
            raise ValueError("BLOutputLayer expects level-0 features")
        flat = pool_ops.devoxelize_features(x.features, plan.p2v,
                                            plan.vox_seg)
        return flat.reshape(self.batch_size, -1, flat.shape[1])


class RandomizedStrideConvolution(Convolution):
    """Strided convolution whose training windows are jittered (the
    reference's RandomizedStrideConvolution). The jitter lives in the
    plan: train on a `core/randomized.build_randomized_plan` topology and
    evaluate on a regular one; the module is the strided convolution over
    whichever transition the plan carries (a randomized plan has no chunk
    rulebooks, so it takes the gather convolution)."""


class RandomizedStrideMaxPooling(MaxPooling):
    """Max pooling over jittered windows (the reference's
    RandomizedStrideMaxPooling); see RandomizedStrideConvolution."""
