"""Gather convolution over a transposed map (counterpart of
`occuseg_tpu/ops/pallas/gather_conv.py`).

    out[m] = sum_k (nbr_kn[k, m] >= 0 ? feats[nbr_kn[k, m]] : 0) @ W[k]

for feats [N, Cin] and nbr_kn [K, M], in f32 with the output [M, Cout] in
the feature dtype. M = N for a submanifold map; a strided convolution's
child map has the coarse level's rows over the fine level's, a
deconvolution's up map the reverse. Two callers: the forward of the
normal-guided submanifold convolutions (`ops/normal_guide.py`), over the
orientation-permuted map, and the gather convolution of `ops/conv.py`
(the modules' route where a map has no chunk rulebook or the chunk
kernels do not take its widths), for its forward and its d_feats. CUDA
tensors launch `csrc/gather_conv.cu` (or raise); CPU tensors run
`gather_conv_plain`. Unlike the TPU kernel it takes any Cin and Cout that
are multiples of 8 and any numbers of rows. `geometry` is the bf16
kernel's launch plan: column tile and split count.
"""

from __future__ import annotations

import torch

from occuseg_tpu_torch.ops import acc, kernels
from occuseg_tpu_torch.ops.kernels import chunk_conv as cc

TILE = 128      # output rows per block of the bf16 kernel
CIN_TILE = 64   # Cin columns per step
MAX_SPLITS = 8  # blocks of one cluster


def geometry(M: int, cin: int, cout: int, K: int, sms: int):
    """(column tile, splits) of the bf16 kernel over M output rows: the
    chunk-conv forward's
    column tile, and where the row and column tiles leave SMs idle, the
    most ranges of a tile's (offset, Cin tile) steps (one cluster, at most
    MAX_SPLITS blocks, at most one a step) that keep the grid within one
    wave of two blocks per SM: a grid just past a wave takes two."""
    nt = cc.col_tile(cout, True)
    blocks = -(-M // TILE) * -(-cout // nt)
    splits = min(MAX_SPLITS, K * -(-cin // CIN_TILE), 2 * sms // blocks)
    return nt, max(1, splits)


def _check(feats: torch.Tensor, nbr_kn: torch.Tensor,
           weight: torch.Tensor) -> None:
    cin = feats.shape[1]
    K, Kw = nbr_kn.shape[0], weight.shape[0]
    if feats.dim() != 2 or nbr_kn.dim() != 2 or weight.dim() != 3 \
            or Kw != K or weight.shape[1] != cin:
        raise ValueError(f"gather_conv: inconsistent shapes feats "
                         f"{tuple(feats.shape)}, nbr_kn {tuple(nbr_kn.shape)},"
                         f" weight {tuple(weight.shape)}")
    if cin % 8 or weight.shape[2] % 8:
        raise ValueError(f"gather_conv: Cin={cin} and Cout="
                         f"{weight.shape[2]} must be multiples of 8")


def gather_conv_plain(feats: torch.Tensor, nbr_kn: torch.Tensor,
                      weight: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: per offset a clamped row gather with the -1
    rows zeroed, then one f32 einsum (f64 for f64 feats); [M, Cout] in
    feats.dtype."""
    _check(feats, nbr_kn, weight)
    g = acc(feats[nbr_kn.clamp(min=0).long()])               # [K, M, Cin]
    g = torch.where((nbr_kn >= 0)[..., None], g, torch.zeros((), dtype=g.dtype,
                                                             device=g.device))
    out = torch.einsum("kni,kio->no", g, weight.to(g.dtype))
    return out.to(feats.dtype)


def gather_conv(feats: torch.Tensor, nbr_kn: torch.Tensor,
                weight: torch.Tensor) -> torch.Tensor:
    """feats [N, Cin] (f32 or bf16), nbr_kn [K, M] int32 (ids in [0, N),
    -1 missing), weight [K, Cin, Cout] (cast to the feature dtype) ->
    [M, Cout] in feats.dtype. CUDA tensors launch the kernel (or raise);
    CPU tensors run the plain version."""
    w = weight.to(feats.dtype)
    if not feats.is_cuda:
        return gather_conv_plain(feats, nbr_kn, w)
    _check(feats, nbr_kn, w)
    dt = feats.dtype
    kernels.require_cuda_input(feats, "feats", (torch.float32,
                                                torch.bfloat16), 2)
    kernels.require_cuda_input(nbr_kn, "nbr_kn", torch.int32, 2)
    kernels.require_cuda_input(w, "weight", dt, 3)
    if len({feats.device, nbr_kn.device, w.device}) != 1:
        raise ValueError("gather_conv: tensors on several devices")
    N, cin = feats.shape
    (K, M), cout = nbr_kn.shape, w.shape[2]
    nt, splits = geometry(M, cin, cout, K,
                          cc._sm_count(feats.device.index or 0))
    out = torch.empty((M, cout), dtype=dt, device=feats.device)
    with torch.cuda.device(feats.device):
        rc = kernels.load().occ_gather_conv(
            feats.data_ptr(), N, cin, nbr_kn.data_ptr(), K, M, w.data_ptr(),
            cout, nt, splits, out.data_ptr(), int(dt == torch.bfloat16),
            kernels.stream_ptr(feats))
    kernels.check(rc, "gather_conv kernel launch")
    gather_conv.launches += 1
    return out


gather_conv.launches = 0  # kernel launches
