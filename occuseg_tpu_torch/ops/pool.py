"""Pooling, unpooling and the IO layers' reductions (counterpart of
`occuseg_tpu/ops/pool.py`).

`max_pool`, `avg_pool` and `unpool` reduce the rows a transition's map
gathers (`child` [M, K] for the pools, `up` for the unpool; -1 missing),
in plain PyTorch, as the JAX package leaves them to XLA. Max pooling takes
`torch.amax`, which splits the gradient evenly among tied children, as
JAX's `reduce_max` does (after a BN-ReLU most children tie at 0).

`voxelize_features` is the InputLayer forward, in the reference's modes:
"sum" and "mean" are a points -> voxels f32 segment sum (the mean divides
it by the per-voxel counts) whose backward is the point gather; "first"
and "last" take the lowest and highest point index of each voxel, in the
order the features are given; "max" is the per-voxel maximum (an empty
voxel gives 0). `devoxelize_features` is the OutputLayer forward, a row
gather, whose backward is the same segment sum of the cotangent. Under
the plan's sorted point layout the segment sum is the blocked kernel
(`ops/kernels/segsum.py`). Where the layout does not fit the caps (it
needs (cap0 / 192) * 248 point slots, and cap0 a multiple of 192) the plan
has none, and the sum is a deterministic scatter-sum in plain PyTorch,
as the JAX package then runs `jax.ops.segment_sum`.
"""

from __future__ import annotations

import torch

from occuseg_tpu_torch.ops import acc
from occuseg_tpu_torch.ops.conv import gather_rows
from occuseg_tpu_torch.ops.kernels.segsum import sorted_segment_sum

MODES = ("first", "last", "sum", "mean", "max")


class _Voxelize(torch.autograd.Function):
    """f32 points [P, C] -> voxel sums [num_out, C]; backward: gather."""

    @staticmethod
    def forward(ctx, x, p2v, vox_seg, num_out):
        ctx.save_for_backward(p2v)
        return sorted_segment_sum(x, p2v, vox_seg, num_out)

    @staticmethod
    def backward(ctx, ct):
        p2v, = ctx.saved_tensors
        return gather_rows(ct, p2v), None, None, None


class _Devoxelize(torch.autograd.Function):
    """voxels [N, C] -> points [P, C]; backward: the f32 segment sum of the
    cotangent, cast to the voxel dtype (the cast up is exact, and the JAX
    package sums in f32 too)."""

    @staticmethod
    def forward(ctx, vox, p2v, vox_seg):
        ctx.save_for_backward(p2v, vox_seg)
        ctx.num_out = vox.shape[0]
        return gather_rows(vox, p2v)

    @staticmethod
    def backward(ctx, ct):
        p2v, vox_seg = ctx.saved_tensors
        d_vox = sorted_segment_sum(acc(ct).contiguous(), p2v, vox_seg,
                                   ctx.num_out)
        return d_vox.to(ct.dtype), None, None


def max_pool(feats: torch.Tensor, child: torch.Tensor) -> torch.Tensor:
    """Max over each coarse site's children: feats [N, C], child [M, K]
    -> [M, C]. Missing children hold the dtype's lowest finite value; a
    site with no child gives 0."""
    g = gather_rows(feats, child, torch.finfo(feats.dtype).min)
    out = torch.amax(g, dim=1)
    any_child = (child >= 0).any(dim=1, keepdim=True)
    return torch.where(any_child, out, torch.zeros((), dtype=out.dtype,
                                                   device=out.device))


def _mean_of(feats: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    g = gather_rows(feats, idx)
    cnt = (idx >= 0).to(feats.dtype).sum(dim=1, keepdim=True)
    return g.sum(dim=1) / torch.clamp(cnt, min=1)


def avg_pool(feats: torch.Tensor, child: torch.Tensor) -> torch.Tensor:
    """Mean over each coarse site's valid children."""
    return _mean_of(feats, child)


def unpool(coarse_feats: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    """Coarse features back onto the fine sites: the mean over the
    (usually single) covering coarse rows of `up` [N_fine, K]."""
    return _mean_of(coarse_feats, up)


def segment_max(x: torch.Tensor, seg: torch.Tensor,
                 num_segments: int) -> torch.Tensor:
    """Per-segment maximum of the rows of x [P, C] (f32), -inf where a
    segment is empty; the gradient splits among tied rows."""
    out = torch.full((num_segments, x.shape[1]), float("-inf"),
                     dtype=x.dtype, device=x.device)
    return out.scatter_reduce(0, seg.long()[:, None].expand_as(x), x,
                              "amax", include_self=False)


def voxelize_features(point_feats: torch.Tensor, p2v: torch.Tensor,
                      num_voxels_cap: int, vox_seg: torch.Tensor,
                      vox_counts: torch.Tensor,
                      mode: str = "mean") -> torch.Tensor:
    """Points [P, C] -> voxels [cap, C] in the input dtype, in the
    reference's modes (`MODES`; "mean" is its mode 4). "sum" and "mean"
    cast the features to f32 before the sum, "mean" divides by max(count,
    1), and the result is cast back. `vox_seg` and `vox_counts` are the
    plan's sorted point layout, or None (`infer.augment_plan` gives a plan
    without the layout its counts; a None here counts p2v on the
    device)."""
    if mode in ("sum", "mean"):
        s = _Voxelize.apply(acc(point_feats), p2v, vox_seg, num_voxels_cap)
        if mode == "mean":
            if vox_counts is None:
                vox_counts = torch.bincount(p2v[p2v >= 0].long(),
                                            minlength=num_voxels_cap).float()
            s = s / torch.clamp(vox_counts[:, None], min=1)
        return s.to(point_feats.dtype)
    seg = torch.where(p2v >= 0, p2v, num_voxels_cap).long()
    if mode in ("first", "last"):
        P = point_feats.shape[0]
        idx = torch.arange(P, device=p2v.device)
        init, how = (P, "amin") if mode == "first" else (-1, "amax")
        sel = torch.full((num_voxels_cap + 1,), init, dtype=torch.long,
                         device=p2v.device).scatter_reduce(
            0, seg, idx, how)[:num_voxels_cap]
        return gather_rows(point_feats, torch.where(sel < P, sel, -1))
    if mode == "max":
        s = segment_max(acc(point_feats), seg,
                         num_voxels_cap + 1)[:num_voxels_cap]
        s = torch.where(torch.isfinite(s), s, torch.zeros((), dtype=s.dtype,
                                                           device=s.device))
        return s.to(point_feats.dtype)
    raise ValueError(f"unknown voxelize mode: {mode}")


def devoxelize_features(voxel_feats: torch.Tensor, p2v: torch.Tensor,
                        vox_seg: torch.Tensor) -> torch.Tensor:
    """Voxels -> points: out[i] = voxel_feats[p2v[i]], zero where p2v is
    -1 (pad slots and dropped points)."""
    return _Devoxelize.apply(voxel_feats, p2v, vox_seg)
