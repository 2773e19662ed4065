"""Blocked sorted segment sum (counterpart of
`occuseg_tpu/ops/pallas/segsum.py`): the points -> voxels sum of the
InputLayer under the sorted point layout (`core/point_layout.py`).

Block b of R point slots holds exactly the points of voxel block b (W
voxels); `vox_seg[b, 0, r]` is slot r's voxel id relative to the block's
first voxel (-1 = pad slot). Points that overflow a block's R slots live
in the array tail past B*R and go through `tail_segment_sum`.

The kernel (`csrc/segsum.cu`) stages each voxel block's slot ids and its
slab of x in shared memory and sums every voxel's run of slots in slot
order; `geometry` is the host's plan of its threads and column chunks.
"""

from __future__ import annotations

from typing import Tuple

import torch

from occuseg_tpu_torch.ops import acc, acc_dtype, kernels


# Floats of x a CTA stages: up to SMALL_SLAB with 128 threads, else with
# 256; a slab of more than BLOCK_SLAB (64 KiB) in chunks of columns
SMALL_SLAB = 2048
BLOCK_SLAB = 16384


def geometry(R: int, C: int) -> Tuple[int, int]:
    """The kernel's (threads, column chunk) for blocks of R slots and C
    channels: one CTA per voxel block, of 128 threads where its slab of
    R*C floats is small and 256 otherwise, staging all C columns where the
    slab fits BLOCK_SLAB, else the most that fit (a multiple of 4 where C
    is one, so chunks stay 16-byte aligned)."""
    threads = 128 if R * C <= SMALL_SLAB else 256
    if R * C <= BLOCK_SLAB:
        return threads, C
    cc = max(1, BLOCK_SLAB // R)
    if C % 4 == 0 and cc >= 4:
        cc -= cc % 4
    return threads, min(cc, C)


def _check_shapes(x: torch.Tensor, vox_seg: torch.Tensor, num_out: int):
    B, one, R = vox_seg.shape
    W = num_out // B
    if one != 1 or B * W != num_out:
        raise ValueError(f"blocked_segment_sum: vox_seg {tuple(vox_seg.shape)}"
                         f" does not tile {num_out} outputs")
    if x.dim() != 2 or x.shape[0] < B * R:
        raise ValueError(f"blocked_segment_sum: x {tuple(x.shape)} has fewer "
                         f"than B*R = {B * R} rows")
    return B, R, W


def blocked_segment_sum_plain(x: torch.Tensor, vox_seg: torch.Tensor,
                              num_out: int) -> torch.Tensor:
    """Plain PyTorch version: one index_add_ of the main region in f32."""
    B, R, W = _check_shapes(x, vox_seg, num_out)
    seg = vox_seg.reshape(-1).long()
    slot = torch.arange(B * R, device=x.device)
    valid = seg >= 0
    dst = (slot // R) * W + seg
    out = torch.zeros((num_out, x.shape[1]), dtype=acc_dtype(x),
                      device=x.device)
    return out.index_add_(0, dst[valid], acc(x[:B * R][valid]))


def blocked_segment_sum(x: torch.Tensor, vox_seg: torch.Tensor,
                        num_out: int) -> torch.Tensor:
    """[B*R (+tail), C] rows -> [num_out, C] f32 sums over each block's
    slots; rows past B*R are ignored. CUDA tensors launch
    `csrc/segsum.cu` (or raise); CPU tensors run the plain version."""
    if not x.is_cuda:
        return blocked_segment_sum_plain(x, vox_seg, num_out)
    B, R, W = _check_shapes(x, vox_seg, num_out)
    kernels.require_cuda_input(x, "x", torch.float32, 2)
    kernels.require_cuda_input(vox_seg, "vox_seg", torch.int32, 3)
    if x.device != vox_seg.device:
        raise ValueError("blocked_segment_sum: x and vox_seg on different "
                         "devices")
    C = x.shape[1]
    out = torch.empty((num_out, C), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        rc = kernels.load().occ_blocked_segment_sum(
            x.data_ptr(), C, vox_seg.data_ptr(), B, R, W, *geometry(R, C),
            out.data_ptr(), kernels.stream_ptr(x))
    kernels.check(rc, "blocked_segment_sum kernel launch")
    blocked_segment_sum.launches += 1
    return out


blocked_segment_sum.launches = 0  # kernel launches


def tail_segment_sum(x: torch.Tensor, p2v: torch.Tensor, main_rows: int,
                     num_out: int) -> torch.Tensor:
    """[num_out, C] f32 sums of the overflow rows past `main_rows`, routed
    by their absolute p2v entries (-1 rows are skipped). Accumulating
    `index_put_` sorts the ids on a card and sums in order, so the result
    is deterministic (an `index_add_` there adds with atomics, and the
    run-to-run rounding noise it puts into the InputLayer and the
    OutputLayer backward is amplified by the training step)."""
    seg = p2v[main_rows:].long()
    # boolean indexing makes the host wait for the card, but a spare row
    # for the -1 rows would collect every pad row of a plan without the
    # layout, and the accumulating index_put_ serialises on duplicates
    # (measured 166 ms per CLI step on an H100 80GB HBM3 at 700 W)
    valid = seg >= 0
    out = torch.zeros((num_out, x.shape[1]), dtype=acc_dtype(x),
                      device=x.device)
    return out.index_put_((seg[valid],), acc(x[main_rows:][valid]),
                          accumulate=True)


def sorted_segment_sum(x: torch.Tensor, p2v: torch.Tensor,
                       vox_seg, num_out: int) -> torch.Tensor:
    """Full points -> voxels f32 sum: under the sorted point layout the
    blocked main region plus the overflow tail; without it (`vox_seg`
    None: the layout did not fit the caps) the deterministic scatter-sum
    of every row, as the JAX package falls back to `jax.ops.segment_sum`
    there."""
    if vox_seg is None:
        return tail_segment_sum(x, p2v, 0, num_out)
    B, _, R = vox_seg.shape
    out = blocked_segment_sum(x, vox_seg, num_out)
    if x.shape[0] > B * R:
        out = out + tail_segment_sum(x, p2v, B * R, num_out)
    return out
