"""Convolution ops over neighbour maps (counterpart of
`occuseg_tpu/ops/conv.py`).

`nin` is the 1x1 convolution of the residual shortcuts (a row matmul, left
to the library as the JAX package leaves it to XLA). `gather_conv` is the
convolution over a neighbour map,

    out[r] = sum_k feats[nbr[r, k]] @ W[k]      (-1: a missing neighbour)

the modules' route wherever the chunk kernels do not serve a map (no chunk
rulebook, or widths they do not take): a submanifold convolution (`nbr`
the level's map), a strided one (the transition's child map, coarse rows
over fine) and a deconvolution (its up map, fine rows over coarse). The
modules call `gather_conv_kn` with the maps as the plan holds them for
the kernel; `gather_conv` takes them in the JAX package's form. On CUDA
tensors the forward and d_feats launch the gather-conv kernel
(`ops/kernels/gather_conv.py`, `csrc/gather_conv.cu`) or raise; on CPU
tensors they run its plain version. `conv_flops` counts the MulAdds of
`utils/profiling.py`; `gather_conv_fused` is the JAX package's
forward-only fused form, which its spatially sharded UNet convolves a
halo-extended block with (`parallel/spatial.sharded_gather_conv`).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from occuseg_tpu_torch.ops import acc, acc_dtype
from occuseg_tpu_torch.ops.kernels import gather_conv as gc

# the gather-conv kernel takes channel counts that are multiples of 8
_ALIGN = 8


def gather_rows(feats: torch.Tensor, idx: torch.Tensor,
                fill: float = 0.0) -> torch.Tensor:
    """feats[idx] [*idx.shape, *feats.shape[1:]] with the -1 (missing)
    rows set to `fill`; a bare feats[idx] would silently read the last
    row for -1. It goes through `index_select`, whose backward adds the
    cotangent rows with `index_add_` (atomics on a card: the order of a
    row's sum, and so its last bits, may change from run to run). A bare
    feats[idx]'s backward is an accumulating `index_put_` that sorts the
    ids and serialises their duplicates: in the 35 nearest-upsampling
    gathers of a DenseUNet_BN step it took 152 ms of 245 busy (NVIDIA
    H100 80GB HBM3, 700.00 W)."""
    g = feats.index_select(0, idx.reshape(-1).clamp(min=0).long())
    g = g.reshape(idx.shape + feats.shape[1:])
    valid = (idx >= 0).reshape(idx.shape + (1,) * (feats.dim() - 1))
    return torch.where(valid, g, torch.full((), fill, dtype=feats.dtype,
                                            device=feats.device))


def _kernel_conv(feats: torch.Tensor, nbr_kn: torch.Tensor,
                 weight: torch.Tensor) -> torch.Tensor:
    """out [M, Cout] = sum_k feats[nbr_kn[k]] @ weight[k] for nbr_kn
    [K, M] int32 through the gather-conv wrapper (the kernel on CUDA
    tensors, its plain version on CPU tensors). Cin and Cout are
    zero-padded to multiples of 8: padded columns of feats meet zero rows
    of W, and the padded output columns are sliced off."""
    cin, cout = weight.shape[1], weight.shape[2]
    pad_in, pad_out = (-cin) % _ALIGN, (-cout) % _ALIGN
    if pad_in:
        feats = F.pad(feats, (0, pad_in))
    if pad_in or pad_out:
        weight = F.pad(weight, (0, pad_out, 0, pad_in))
    out = gc.gather_conv(feats.contiguous(), nbr_kn, weight.contiguous())
    return out[:, :cout] if pad_out else out


class _GatherConv(torch.autograd.Function):
    """The gather convolution with the JAX package's scatter-free backward
    (`occuseg_tpu/ops/conv.py` `_gather_conv_core_bwd`). Only the inputs
    are kept for the backward, which gathers again: the K gathered blocks
    would be 27x the activations."""

    @staticmethod
    def forward(ctx, feats, nbr_kn, bwd_kn, weight, reverse):
        ctx.save_for_backward(feats, nbr_kn, bwd_kn, weight)
        ctx.reverse = reverse
        return _kernel_conv(feats, nbr_kn, weight)

    @staticmethod
    def backward(ctx, ct):
        """With j = K-1-k where `reverse`, else j = k: d_feats[i] =
        sum_k ct[bwd_kn[k, i]] @ W[j]^T, the same gather convolution over
        the backward map with the weights (reversed and) transposed, and
        dW, one gather and one f32 matmul per offset (all K at once would
        be [N, K, Cout]), gathering the narrower side: dW[j] = feats^T @
        ct[bwd_kn[k]] (N rows of Cout gathered), or, where the M output
        rows of Cin are fewer bytes (a thin input, as MinkUNet's 5^3 stem
        from 3 channels), dW[k] = feats[nbr_kn[k]]^T @ ct. No scatter, no
        atomics."""
        feats, nbr_kn, bwd_kn, weight = ctx.saved_tensors
        ctc = ct.to(feats.dtype)
        K, cin, cout = weight.shape
        order = range(K - 1, -1, -1) if ctx.reverse else range(K)
        d_feats = d_w = None
        if ctx.needs_input_grad[0]:
            w_t = weight.to(feats.dtype).transpose(1, 2)
            d_feats = _kernel_conv(ctc, bwd_kn,
                                   w_t.flip(0) if ctx.reverse else w_t)
        if ctx.needs_input_grad[3]:
            d_w = torch.empty(weight.shape, dtype=acc_dtype(feats),
                              device=feats.device)
            if nbr_kn.shape[1] * cin < bwd_kn.shape[1] * cout:
                c = acc(ctc)
                for k in range(K):
                    torch.matmul(acc(gather_rows(feats, nbr_kn[k])).t(), c,
                                 out=d_w[k])
            else:
                f = acc(feats).t()
                for k, j in enumerate(order):
                    torch.matmul(f, acc(gather_rows(ctc, bwd_kn[k])),
                                 out=d_w[j])
            d_w = d_w.to(weight.dtype)
        return d_feats, None, None, d_w, None


def gather_conv_kn(feats: torch.Tensor, nbr_kn: torch.Tensor,
                   weight: torch.Tensor, bwd_kn: torch.Tensor,
                   reverse: bool) -> torch.Tensor:
    """`gather_conv` over maps already in the kernel's orientation, as the
    plans hold them (`core/topology._GatherMaps`): nbr_kn [K, M] and the
    backward map bwd_kn [K, N] int32, on the features' device. bwd_kn[k,
    i] is the output row r with nbr_kn[j, r] == i, j = K-1-k where
    `reverse`, else j = k. A submanifold map is its own backward map with
    `reverse` (offset K-1-k is -offset(k)); a transition's child map and
    its up map are each other's without it."""
    return _GatherConv.apply(feats, nbr_kn, bwd_kn, weight, reverse)


def gather_conv(feats: torch.Tensor, nbr: torch.Tensor,
                weight: torch.Tensor,
                nbr_t: Optional[torch.Tensor] = None) -> torch.Tensor:
    """out[r] = sum_k feats[nbr[r, k]] @ weight[k], accumulated in f32,
    in feats.dtype: feats [N, Cin], nbr [M, K] int (-1 missing), weight
    [K, Cin, Cout] (cast to the feature dtype) -> [M, Cout].

    nbr_t [N, K] is the transpose map the backward gathers through:
    nbr_t[i, k] is the row r with nbr[r, K-1-k] == i. As the JAX package
    pairs them: a submanifold map is its own transpose (offset K-1-k is
    -offset(k)), so nbr_t = nbr (the default); a strided convolution over
    a transition's `child` takes `up.flip(1)`; a deconvolution over `up`
    takes `child.flip(1)`."""
    if nbr_t is None:
        if nbr.shape[0] != feats.shape[0]:
            raise ValueError("gather_conv: a map between two levels needs "
                             "its transpose map nbr_t")
        nbr_t = nbr

    def kn(m):
        return m.t().to(torch.int32).contiguous()
    return gather_conv_kn(feats, kn(nbr), weight, kn(nbr_t), True)


def gather_conv_fused(feats: torch.Tensor, nbr: torch.Tensor,
                      weight: torch.Tensor,
                      bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The same contraction as one [M, K*Cin] @ [K*Cin, Cout] matmul over
    the gathered block, in f32, output in feats.dtype (forward only; the
    JAX package's `gather_conv_fused`)."""
    K, cin, cout = weight.shape
    g = gather_rows(feats, nbr.reshape(-1)).reshape(nbr.shape[0], K * cin)
    out = acc(g) @ weight.reshape(K * cin, cout).to(acc_dtype(g))
    if bias is not None:
        out = out + bias.to(out.dtype)
    return out.to(feats.dtype)


def conv_flops(nbr, cin: int, cout: int) -> int:
    """MulAdds of a gather convolution: the map's real (non-missing)
    pairs times Cin times Cout, as the reference counts them."""
    return int((torch.as_tensor(nbr) >= 0).sum()) * cin * cout


def nin(feats: torch.Tensor, weight: torch.Tensor,
        bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """NetworkInNetwork: feats [N, Cin] @ weight [Cin, Cout] in the
    feature dtype; with a bias, the product and the bias are summed in
    f32 before the cast, as the JAX package's `nin` does."""
    if bias is None:
        return torch.matmul(feats, weight.to(feats.dtype))
    out = acc(feats) @ acc(weight.to(feats.dtype)) + acc(bias)
    return out.to(feats.dtype)
