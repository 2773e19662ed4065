"""Normal-guided (rotation-invariant) submanifold convolution
(counterpart of `occuseg_tpu/ops/normal_guide.py`).

The reference rotates each output site's 3^3 filter so that its principal
axis follows the site's dominant normal axis: `OrientedFilter` gives a
class in {0, 2, 4}, and the rulebook's offsets are remapped through a fixed
6 x 27 permutation table. As in the JAX package, the same effect is a
per-row permutation of the neighbour map's offset axis,

    nbr'[r, j] = nbr[r, ORIENT_PERM_INV[orient[r], j]]
    out[r]     = sum_j feats[nbr'[r, j]] @ W[j],

which is the gather convolution's contract: the forward runs
`ops/kernels/gather_conv.gather_conv` over the permuted map (the CUDA
kernel on the card, its plain version on the CPU). The backward is PyTorch
and keeps no [N, K, C] residual, and it adds no float atomics, so its bits
repeat:
  * dW[j] = sum_r feats[nbr'[r, j]]^T @ G[r]: a gather and a matmul per
    offset;
  * d_feats[i] = sum_k G[r] @ W[ORIENT_PERM[orient[r], k]]^T with
    r = nbr[i, K-1-k] (the submanifold map's symmetry: nbr[r, k] = i iff
    nbr[i, K-1-k] = r): per offset, each source row's product with its own
    class's weight (one matmul over the three classes' masked rows, whose
    other classes' terms are exact zeros), then a gather in a fixed order,
    accumulated in f32.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from occuseg_tpu_torch.ops.kernels.gather_conv import gather_conv

# [6, 27]: row o maps offset index k -> weight index under orientation o
# (the reference's table; rows 0/2/4 are the ones OrientedFilter returns)
ORIENT_PERM = np.array([
    [0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19,
     20, 21, 22, 23, 24, 25, 26],
    [24, 25, 26, 21, 22, 23, 18, 19, 20, 15, 16, 17, 12, 13, 14, 9, 10, 11,
     6, 7, 8, 3, 4, 5, 0, 1, 2],
    [6, 7, 8, 15, 16, 17, 24, 25, 26, 3, 4, 5, 12, 13, 14, 21, 22, 23, 0, 1,
     2, 9, 10, 11, 18, 19, 20],
    [18, 19, 20, 9, 10, 11, 0, 1, 2, 21, 22, 23, 12, 13, 14, 3, 4, 5, 24,
     25, 26, 15, 16, 17, 6, 7, 8],
    [2, 11, 20, 5, 14, 23, 8, 17, 26, 1, 10, 19, 4, 13, 22, 7, 16, 25, 0, 9,
     18, 3, 12, 21, 6, 15, 24],
    [18, 9, 0, 21, 12, 3, 24, 15, 6, 19, 10, 1, 22, 13, 4, 25, 16, 7, 20,
     11, 2, 23, 14, 5, 26, 17, 8],
], np.int32)

# inverse permutations: nbr'[r, j] = nbr[r, ORIENT_PERM_INV[o_r, j]]
ORIENT_PERM_INV = np.zeros_like(ORIENT_PERM)
for _o in range(6):
    ORIENT_PERM_INV[_o, ORIENT_PERM[_o]] = np.arange(27)

# the classes OrientedFilter returns
CLASSES = (0, 2, 4)


def oriented_filter(normals: torch.Tensor) -> torch.Tensor:
    """Per-site orientation class {0, 2, 4} (dominant axis x / y / z) of
    normals [N, 3] (x, y, z), int32."""
    a = normals.abs()
    x, y, z = a[:, 0], a[:, 1], a[:, 2]
    face = torch.where((x >= y) & (x >= z), 0,
                       torch.where((y >= x) & (y >= z), 2, 4))
    return face.to(torch.int32)


def permute_neighbor_map(nbr: torch.Tensor, orient: torch.Tensor
                         ) -> torch.Tensor:
    """nbr'[r, j] = nbr[r, ORIENT_PERM_INV[orient[r], j]] ([N, 27], the
    dtype of nbr)."""
    perm_inv = torch.as_tensor(ORIENT_PERM_INV, device=nbr.device)
    sel = perm_inv[orient.long()].long()
    return torch.gather(nbr, 1, sel)


class _NormalGuidedConv(torch.autograd.Function):
    """feats [N, Cin] (Cin a multiple of 8), nbr [N, 27] int32, orient [N]
    int32, weight [27, Cin, Cout] -> [N, Cout] in feats.dtype."""

    @staticmethod
    def forward(ctx, feats, nbr, orient, weight):
        nbr_kn = permute_neighbor_map(nbr, orient).t().contiguous()
        out = gather_conv(feats.contiguous(), nbr_kn.to(torch.int32), weight)
        ctx.save_for_backward(feats, nbr, orient, weight, nbr_kn)
        return out

    @staticmethod
    def backward(ctx, grad):
        feats, nbr, orient, weight, nbr_kn = ctx.saved_tensors
        K, cin, cout = weight.shape
        N = feats.shape[0]
        g = grad.float()

        def rows(src, idx):
            """[K, N] row ids into src [N, C] with a zero row appended: a
            missing neighbour (-1) reads the zero row."""
            return torch.where(idx >= 0, idx, N).long(), torch.cat(
                [src, src.new_zeros((1, src.shape[1]))])

        d_feats = d_w = None
        if ctx.needs_input_grad[3]:
            idx, src = rows(feats.float(), nbr_kn)
            d_w = torch.stack([src.index_select(0, idx[j]).t() @ g
                               for j in range(K)]).to(weight.dtype)
        if ctx.needs_input_grad[0]:
            # each row's gradient once per class, other classes' rows zero:
            # row r of g_cls @ w_cls(k) is g[r] @ W[ORIENT_PERM[orient[r],
            # k]]^T exactly
            g_cls = torch.cat([g * (orient == c)[:, None] for c in CLASSES],
                              dim=1)
            w = weight.float().transpose(1, 2)             # [K, Cout, Cin]
            idx, prod = rows(g.new_zeros((N, cin)), nbr.t())
            d_feats = torch.zeros((N, cin), dtype=torch.float32,
                                  device=g.device)
            for k in range(K):
                w_cls = torch.cat([w[int(ORIENT_PERM[c, k])] for c in CLASSES])
                torch.mm(g_cls, w_cls, out=prod[:N])
                d_feats += prod.index_select(0, idx[K - 1 - k])
            d_feats = d_feats.to(feats.dtype)
        return d_feats, None, None, d_w


def normal_guided_conv(feats: torch.Tensor, nbr: torch.Tensor,
                       orient: torch.Tensor, weight: torch.Tensor,
                       bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Submanifold convolution with each site's filter rotated by its
    orientation class: feats [N, Cin], nbr [N, 27] (a submanifold map over
    the same rows: nbr[r, k] = i iff nbr[i, 26 - k] = r), orient [N]
    classes {0, 2, 4}, weight [27, Cin, Cout] -> [N, Cout] in feats.dtype.
    The kernel takes channel counts that are multiples of 8: a Cin that is
    not (the first convolution's 3 or 6 channels) gets zero columns in
    feats and zero rows in W, which leave the output unchanged, and a Cout
    that is not gets zero columns in W, sliced off the output; the
    padding's gradients are dropped."""
    cout = weight.shape[2]
    pad_in, pad_out = (-feats.shape[1]) % 8, (-cout) % 8
    if pad_in:
        feats = torch.nn.functional.pad(feats, (0, pad_in))
    if pad_in or pad_out:
        weight = torch.nn.functional.pad(weight, (0, pad_out, 0, pad_in))
    out = _NormalGuidedConv.apply(feats, nbr, orient, weight)[:, :cout]
    if bias is not None:
        out = out + bias.to(out.dtype)
    return out
