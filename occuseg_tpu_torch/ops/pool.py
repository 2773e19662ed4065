"""IO-layer pooling (counterpart of `occuseg_tpu/ops/pool.py`).

`voxelize_features` is the InputLayer forward: a points -> voxels f32
segment sum, then the mean by the per-voxel counts; its backward is the
point gather. `devoxelize_features` is the OutputLayer forward, a row
gather, whose backward is the same segment sum of the cotangent. Under the
plan's sorted point layout the sum is the blocked kernel
(`ops/kernels/segsum.py`). Where the layout does not fit the caps (it
needs (cap0 / 192) * 248 point slots, and cap0 a multiple of 192) the plan
has none, and the sum is a deterministic scatter-sum in plain PyTorch,
as the JAX package then runs `jax.ops.segment_sum`.
"""

from __future__ import annotations

import torch

from occuseg_tpu_torch.ops.conv import gather_rows
from occuseg_tpu_torch.ops.kernels.segsum import sorted_segment_sum


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
        d_vox = sorted_segment_sum(ct.float().contiguous(), p2v, vox_seg,
                                   ctx.num_out)
        return d_vox.to(ct.dtype), None, None


def voxelize_features(point_feats: torch.Tensor, p2v: torch.Tensor,
                      num_voxels_cap: int, vox_seg: torch.Tensor,
                      vox_counts: torch.Tensor) -> torch.Tensor:
    """Points [P, C] -> voxel means [cap, C] in the input dtype (the
    reference's mode 4). The features are cast to f32 before the sum, the
    sum is divided by max(count, 1), and the result is cast back.
    `vox_seg` and `vox_counts` are the plan's sorted point layout, or None
    (`infer.augment_plan` gives a plan without the layout its counts; a
    None here counts p2v on the device)."""
    s = _Voxelize.apply(point_feats.float(), p2v, vox_seg, num_voxels_cap)
    if vox_counts is None:
        vox_counts = torch.bincount(p2v[p2v >= 0].long(),
                                    minlength=num_voxels_cap).float()
    return (s / torch.clamp(vox_counts[:, None], min=1)).to(point_feats.dtype)


def devoxelize_features(voxel_feats: torch.Tensor, p2v: torch.Tensor,
                        vox_seg: torch.Tensor) -> torch.Tensor:
    """Voxels -> points: out[i] = voxel_feats[p2v[i]], zero where p2v is
    -1 (pad slots and dropped points)."""
    return _Devoxelize.apply(voxel_feats, p2v, vox_seg)
