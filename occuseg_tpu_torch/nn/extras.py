"""The rest of the op library (counterpart of `occuseg_tpu/nn/extras.py`).

Activations, dropouts, Identity, ActivePooling, SparseToDense /
DenseToSparse, AffineReluTrivialConvolution, MeanOnlyBNLeakyReLU,
ShapeContext and MultiscaleShapeContext, the cross-scale
`upsample_feature`, `add_coords`, `compare_sparse`, `sparsify_coords`,
SpatialDropOut, and the permutohedral-lattice submanifold convolution.
Everything but the lattice convolution (#9) is elementwise, gather and
segment work in plain PyTorch, as the JAX package leaves it to XLA.

Modules take `(x, plan)` and read training mode from `self.training`;
the dropouts draw from the `torch.Generator` they were built with (its
device's; none: the default generator of the features' device). A
host plan's keys and coords are copied to the features' device once per
plan object (`LevelTopology.device_array`). Where the JAX package pads a
`jnp.nonzero(size=cap)` with -1, the rows are found by a search of the
running count, with no host read.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn
import torch.nn.functional as F

from occuseg_tpu_torch.core import coords as C
from occuseg_tpu_torch.core.sparse_tensor import (
    SparseTensor,
    active_mask,
    total_active,
)
from occuseg_tpu_torch.core.topology import Topology
from occuseg_tpu_torch.nn.modules import _add_bias, _bias, _he_weight
from occuseg_tpu_torch.ops import acc
from occuseg_tpu_torch.ops import conv as conv_ops
from occuseg_tpu_torch.ops import pool as pool_ops
from occuseg_tpu_torch.ops.permutohedral import permutohedral_offsets


def _zero(t: torch.Tensor) -> torch.Tensor:
    return torch.zeros((), dtype=t.dtype, device=t.device)


class Identity(nn.Module):
    def forward(self, x, plan=None):
        return x


class _Activation(nn.Module):
    def forward(self, x: SparseTensor, plan=None) -> SparseTensor:
        return x.with_features(self.fn(x.features))


class ReLU(_Activation):
    """max(x, 0); at 0 the gradient is split, as `jnp.maximum`'s."""

    @staticmethod
    def fn(f):
        return torch.maximum(f, _zero(f))


class Tanh(_Activation):
    fn = staticmethod(torch.tanh)


class Sigmoid(_Activation):
    fn = staticmethod(torch.sigmoid)


class ELU(_Activation):
    fn = staticmethod(F.elu)


class SELU(_Activation):
    fn = staticmethod(F.selu)


def leaky_relu(f: torch.Tensor, leakiness: float) -> torch.Tensor:
    return torch.where(f > 0, f, leakiness * f)


class LeakyReLU(nn.Module):
    def __init__(self, leakiness: float = 0.01):
        super().__init__()
        self.leakiness = leakiness

    def forward(self, x: SparseTensor, plan=None) -> SparseTensor:
        return x.with_features(leaky_relu(x.features, self.leakiness))


class _Dropout(nn.Module):
    def __init__(self, p: float = 0.5,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.p, self.generator = p, generator

    def _keep(self, shape, like: torch.Tensor) -> torch.Tensor:
        """Bool keep mask of `shape` (probability 1 - p) on like's
        device."""
        g = self.generator
        dev = g.device if g is not None else like.device
        u = torch.rand(shape, generator=g, device=dev)
        return (u < 1 - self.p).to(like.device)


class Dropout(_Dropout):
    """Elementwise inverted dropout: kept entries scaled by 1 / (1 - p)."""

    def forward(self, x: SparseTensor, plan=None) -> SparseTensor:
        if not self.training or self.p == 0:
            return x
        f = x.features
        keep = self._keep(f.shape, f)
        return x.with_features(torch.where(keep, f / (1 - self.p), _zero(f)))


class BatchwiseDropout(_Dropout):
    """Per-channel inverted dropout (one mask for every row)."""

    def forward(self, x: SparseTensor, plan=None) -> SparseTensor:
        if not self.training or self.p == 0:
            return x
        f = x.features
        keep = self._keep((1, f.shape[1]), f)
        return x.with_features(torch.where(keep, f / (1 - self.p), _zero(f)))


class SpatialDropOut(_Dropout):
    """Channel dropout with the reference's non-inverted scaling: training
    multiplies by a per-channel Bernoulli mask with no 1 / (1 - p); eval
    multiplies every feature by 1 - p."""

    def forward(self, x: SparseTensor, plan=None) -> SparseTensor:
        f = x.features
        if not self.training:
            return x.with_features(f * (1 - self.p))
        keep = self._keep((1, f.shape[1]), f)
        return x.with_features(torch.where(keep, f, _zero(f)))


class AffineReluTrivialConvolution(nn.Module):
    """y = relu(x * a + b) @ W (the reference's fused module)."""

    def __init__(self, in_features: int, out_features: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.affine_weight = nn.Parameter(torch.ones(in_features))
        self.affine_bias = nn.Parameter(torch.zeros(in_features))
        self.weight = nn.Parameter(torch.randn(
            (in_features, out_features), generator=generator)
            / in_features ** 0.5)

    def forward(self, x: SparseTensor, plan=None) -> SparseTensor:
        f = x.features
        h = f * self.affine_weight.to(f.dtype) + self.affine_bias.to(f.dtype)
        return x.with_features(conv_ops.nin(torch.maximum(h, _zero(h)),
                                            self.weight))


class MeanOnlyBNLeakyReLU(nn.Module):
    """Mean-only batch norm + leaky ReLU: y = x - mean + bias over the
    active rows (the running mean in eval), then the leaky activation;
    padding rows stay 0."""

    def __init__(self, num_channels: int, momentum: float = 0.9,
                 leakiness: float = 0.0):
        super().__init__()
        self.momentum, self.leakiness = momentum, leakiness
        self.bias = nn.Parameter(torch.zeros(num_channels))
        self.register_buffer("running_mean", torch.zeros(num_channels))

    def forward(self, x: SparseTensor, plan=None) -> SparseTensor:
        f = acc(x.features)
        mask = active_mask(x.num_active, f.shape[0], f.device)[:, None]
        if self.training:
            n = float(max(total_active(x.num_active), 1))
            mean = torch.where(mask, f, _zero(f)).sum(0) / n
            with torch.no_grad():
                self.running_mean.mul_(self.momentum).add_(
                    (1 - self.momentum) * mean)
        else:
            mean = acc(self.running_mean)
        y = leaky_relu(f - mean + acc(self.bias), self.leakiness)
        y = torch.where(mask, y, _zero(y))
        return x.with_features(y.to(x.features.dtype))


def _segment_sum(x: torch.Tensor, seg: torch.Tensor, n: int) -> torch.Tensor:
    out = torch.zeros((n, x.shape[1]), dtype=x.dtype, device=x.device)
    return out.index_add(0, seg, x)


class ActivePooling(nn.Module):
    """Global pool over the active sites of each sample, segmented by the
    level's batch column: [num_samples, C] (mean, or "max" with 0 for an
    empty sample). `num_samples` is static."""

    def __init__(self, mode: str = "mean", num_samples: int = 32):
        super().__init__()
        self.mode, self.num_samples = mode, num_samples

    def forward(self, x: SparseTensor, plan: Topology) -> torch.Tensor:
        f = acc(x.features)
        b = plan.levels[x.level].device_array("coords", f.device)[:, 0]
        seg = torch.where(b >= 0, b, self.num_samples).long()
        n = self.num_samples + 1
        if self.mode == "mean":
            s = _segment_sum(f, seg, n)
            cnt = _segment_sum(torch.ones_like(f[:, :1]), seg, n)
            out = s[:-1] / torch.clamp(cnt[:-1], min=1)
        else:
            out = pool_ops.segment_max(f, seg, n)[:-1]
            out = torch.where(torch.isfinite(out), out, _zero(out))
        return out.to(x.features.dtype)


class ShapeContext(nn.Module):
    """Fixed identity-weight submanifold convolution: each site's K
    neighbours' features concatenated, C * K channels."""

    def forward(self, x: SparseTensor, plan: Topology) -> SparseTensor:
        f = x.features
        nbr_kn = plan.levels[x.level].gather_map("nbr", f.device)
        g = conv_ops.gather_rows(f, nbr_kn.t())          # [cap, K, C]
        return x.with_features(g.reshape(g.shape[0], -1))


class MultiscaleShapeContext(nn.Module):
    """ShapeContext at `num_scales` scales (average pooled down the plan's
    transitions), each brought back by nearest upsampling and
    concatenated."""

    def __init__(self, num_scales: int = 3):
        super().__init__()
        self.num_scales = num_scales
        for s in range(num_scales):
            self.add_module(f"sc{s}", ShapeContext())

    def forward(self, x: SparseTensor, plan: Topology) -> SparseTensor:
        if self.num_scales > len(plan.levels) - x.level:
            raise ValueError("MultiscaleShapeContext: the plan has too few "
                             "levels")
        parts = [self.sc0(x, plan)]
        cur = x
        for s in range(1, self.num_scales):
            f = cur.features
            child = plan.transitions[cur.level].gather_map("child", f.device)
            cur = SparseTensor(
                features=pool_ops.avg_pool(f, child.t()),
                num_active=plan.levels[cur.level + 1].num_active,
                level=cur.level + 1)
            up = getattr(self, f"sc{s}")(cur, plan)
            for back in range(cur.level, x.level, -1):
                up = upsample_feature(up, back - 1, plan, stride=2)
            parts.append(up)
        return x.with_features(torch.cat([p.features for p in parts], -1))


def sparse_to_dense(x: SparseTensor, plan: Topology, spatial_size: int,
                    batch_size: int) -> torch.Tensor:
    """The [B, E, E, E, C] dense grid of a level's features. Padding rows
    (and any index outside the grid) add into a dump row that is dropped,
    as the JAX package's `mode="drop"` scatter."""
    f = x.features
    c = plan.levels[x.level].device_array("coords", f.device).long()
    E = spatial_size
    flat = ((c[:, 0] * E + c[:, 1]) * E + c[:, 2]) * E + c[:, 3]
    n_cells = batch_size * E ** 3
    flat = torch.where((c[:, 0] >= 0) & (flat >= 0) & (flat <= n_cells),
                       flat, n_cells)
    dense = torch.zeros((n_cells + 1, f.shape[1]), dtype=f.dtype,
                        device=f.device).index_add(0, flat, f)
    return dense[:n_cells].reshape(batch_size, E, E, E, f.shape[1])


def _first_true(mask: torch.Tensor, cap: int) -> torch.Tensor:
    """The indices of the first `cap` True entries of a flat bool mask in
    order, -1 past the last (`jnp.nonzero(size=cap, fill_value=-1)`),
    found by searching the running count (no host read)."""
    csum = torch.cumsum(mask.to(torch.int64), 0)
    targets = torch.arange(1, cap + 1, dtype=torch.int64, device=mask.device)
    pos = torch.searchsorted(csum, targets)
    return torch.where(targets <= csum[-1], pos, -1)


def dense_to_sparse_coords(dense_mask: torch.Tensor, cap: int
                           ) -> torch.Tensor:
    """Coords [cap, 4] int32 (b, z, y, x) of the True cells of a bool
    [B, E, E, E] grid, in row-major order, padded with -1."""
    E = dense_mask.shape[1]
    idx = _first_true(dense_mask.reshape(-1), cap)
    r = idx % (E ** 3)
    out = torch.stack([idx // E ** 3, r // (E * E), (r // E) % E, r % E],
                      dim=1).to(torch.int32)
    return torch.where((idx >= 0)[:, None], out, -1)


def upsample_feature(lr: SparseTensor, hr_level: int, plan: Topology,
                     stride: int = 2, bilinear: bool = False
                     ) -> SparseTensor:
    """Cross-scale upsample of `lr` (one level coarser) onto the sites of
    level `hr_level`: nearest gathers the covering coarse site (looked up
    by key; padding rows and sites with none get 0); trilinear takes the
    8-tap weighted mean at (hr - (stride - 1) / 2) / stride."""
    if lr.level != hr_level + 1:
        raise ValueError("lr must be one level coarser than hr")
    f = lr.features
    dev = f.device
    hr_lvl, lr_lvl = plan.levels[hr_level], plan.levels[lr.level]
    hc = hr_lvl.device_array("coords", dev)
    keys = lr_lvl.device_array("keys", dev)
    live = hc[:, :1] >= 0
    if not bilinear:
        q = torch.cat([hc[:, :1], torch.div(hc[:, 1:], stride,
                                            rounding_mode="floor")], dim=-1)
        idx = C.lookup(keys, C.pack(torch.where(live, q, -1)))
        out = conv_ops.gather_rows(f, idx)
    else:
        cand = (hc[:, 1:].to(torch.float32) - (stride - 1) / 2) / stride
        lo, hi = torch.floor(cand), torch.ceil(cand)
        accum = torch.zeros((hc.shape[0], f.shape[1]), dtype=torch.float32,
                            device=dev)
        wtot = torch.zeros((hc.shape[0], 1), dtype=torch.float32, device=dev)
        for xx in range(2):
            for yy in range(2):
                for zz in range(2):
                    a = torch.stack([hi[:, 0] if zz == 0 else lo[:, 0],
                                     hi[:, 1] if yy == 0 else lo[:, 1],
                                     hi[:, 2] if xx == 0 else lo[:, 2]], 1)
                    w = torch.clamp(1 - (a - cand).abs(), min=0)
                    w = w[:, 0] * w[:, 1] * w[:, 2]
                    q = torch.cat([hc[:, :1], a.to(torch.int32)], dim=1)
                    idx = C.lookup(keys, C.pack(torch.where(live, q, -1)))
                    w = torch.where(idx >= 0, w, 0.0)[:, None]
                    g = conv_ops.gather_rows(f, idx).to(torch.float32)
                    accum = accum + g * w
                    wtot = wtot + w
        out = (accum / torch.clamp(wtot, min=1e-12)).to(f.dtype)
    return SparseTensor(features=out, num_active=hr_lvl.num_active,
                        level=hr_level)


def add_coords(x: SparseTensor, plan: Topology,
               scale: float = 1.0) -> SparseTensor:
    """Append the (z, y, x) coordinates times `scale` as 3 channels (0 on
    padding rows)."""
    f = x.features
    c = plan.levels[x.level].device_array("coords", f.device)[:, 1:]
    c = c.to(f.dtype)
    c = torch.where(c >= 0, c * scale, _zero(c))
    return x.with_features(torch.cat([f, c], dim=-1))


def compare_sparse(plan_a: Topology, a: SparseTensor, plan_b: Topology,
                   b: SparseTensor) -> torch.Tensor:
    """Normalised squared difference of two tensors on possibly different
    topologies: the sum over the union of sites of ||fa - fb||^2 (a
    missing side is 0) over max(sum ||fa||^2, sum ||fb||^2)."""
    fa, fb = a.features, b.features
    ka = plan_a.levels[a.level].device_array("keys", fa.device)
    kb = plan_b.levels[b.level].device_array("keys", fa.device)
    da = ((fa - conv_ops.gather_rows(fb, C.lookup(kb, ka))) ** 2).sum()
    only_b = (C.lookup(ka, kb) < 0) & (kb < C.KEY_PAD)
    db = torch.where(only_b[:, None], fb ** 2, _zero(fb)).sum()
    na, nb = (fa ** 2).sum(), (fb ** 2).sum()
    return (da + db) / torch.clamp(torch.maximum(na, nb), min=1e-12)


def sparsify_coords(x: SparseTensor, plan: Topology, cap: int,
                    threshold: float = 0.0) -> torch.Tensor:
    """Coords [cap, 4] of the active sites whose feature L1 norm exceeds
    `threshold`, in row order, padded with -1: plan them anew
    (`core/topology.build_plan`) to continue on the sparsified set."""
    f = x.features
    coords = plan.levels[x.level].device_array("coords", f.device)
    mag = acc(f).abs().sum(dim=-1)
    idx = _first_true((mag > threshold) & (coords[:, 0] >= 0), cap)
    out = coords[idx.clamp(min=0)]
    return torch.where((idx >= 0)[:, None], out, -1)


def _negation(offsets: np.ndarray) -> list:
    """neg[k]: the index of offset -offsets[k]."""
    index = {tuple(o): k for k, o in enumerate(offsets.tolist())}
    return [index[tuple(-o for o in off)] for off in offsets.tolist()]


class PermutohedralSubmanifoldConvolution(nn.Module):
    """Submanifold convolution over the permutohedral (A_3) lattice's 13
    nearest-neighbour offsets (the reference's
    permutohedralSubmanifoldConvolution). It needs a plan built with
    `PlanSpec(lattice="permutohedral")` from coordinates mapped by
    `ops/permutohedral.embed_points`; the convolution is #9's gather
    convolution with K = 13.

    The lattice's offset order (zero first, then lexicographic) does not
    put -offset(k) at K-1-k, as the cubic stencil's does, so the backward
    map is the neighbour map with its offsets negated: row k of it is row
    neg(k) of the map (nbr[r, k] = i iff nbr[i, neg(k)] = r), kept in the
    level's map cache. The JAX package's module pairs the map with itself
    reversed, as for the cubic stencil."""

    def __init__(self, in_features: int, out_features: int,
                 generator: Optional[torch.Generator] = None,
                 use_bias: bool = False):
        super().__init__()
        offsets = permutohedral_offsets(3)
        self.neg = _negation(offsets)
        K = offsets.shape[0]
        self.weight = _he_weight((K, in_features, out_features), K,
                                 generator)
        self.bias = _bias(out_features, use_bias)

    def _negated(self, lvl, nbr_kn: torch.Tensor) -> torch.Tensor:
        m = lvl.kn.get("nbr_neg")
        if m is None:
            m = lvl.kn["nbr_neg"] = torch.stack([nbr_kn[j] for j in self.neg])
        return m

    def forward(self, x: SparseTensor, plan: Topology) -> SparseTensor:
        lvl = plan.levels[x.level]
        if lvl.nbr.shape[1] != self.weight.shape[0]:
            raise ValueError(f"plan kernel volume {lvl.nbr.shape[1]} != "
                             f"the lattice's {self.weight.shape[0]}")
        f = x.features
        nbr = lvl.gather_map("nbr", f.device)
        out = conv_ops.gather_conv_kn(f, nbr, self.weight,
                                      self._negated(lvl, nbr), False)
        return x.with_features(_add_bias(out, self.bias))
