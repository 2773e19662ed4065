"""The collectives of spatial sharding, each the exact adjoint of its
forward in autograd.

The JAX package gets these from `shard_map`: `ppermute` for the halos,
`all_gather` for the pool (`occuseg_tpu/parallel/spatial.py:81-113`),
`psum` and `pmax` for the batch-norm and loss statistics, and their
transposes for the backward. Here one process is one shard: a rank of a
`torch.distributed` process group.

  * `all_sum(x, group)`: an all-reduce SUM forward, and an all-reduce SUM
    of the cotangent backward. Its output is read by local rows on every
    rank (BN statistics, instance means), so its cotangent arrives in
    parts, one per rank, and the input's cotangent is their sum.
  * `all_max(x, group)`: no gradient. Its users (the BCE radius, the
    segment maxima of scene ids and classes) are all gradient-free.
  * `extend_features(...)`: local rows [S, C] -> the extended rows
    [S + 2H + D*P, C] a sharded map indexes (`parallel/spatial.py`): the
    local rows, the left halo, the right halo, the pool. Rows missing
    from a send or publish list (-1) arrive as zeros. Shard 0's left
    list and shard D-1's right list are all -1, as in JAX's cyclic
    `ppermute`. Its backward sends each halo row's cotangent back to the
    rank that sent the row, where it is ADDED into the sender's row, and
    sums each pool row's cotangent over every rank into the row its owner
    published.

The gradient rule that follows: every rank runs the backward of the same
replicated loss L, so with exact adjoints the joint graph's objective is
D * L. The parameter gradient is therefore the MEAN of the ranks'
gradients: one flattened all-reduce, `data_parallel.allreduce_step` at
weight 1. The BN running statistics and the loss parts come out equal on
every rank, and averaging them changes nothing. Mixing conventions (an
all-reduce whose backward is the identity beside these functions) would
give gradients off by a factor of D, or wrong BN gradients.

Transport. Gloo's table lists no send/recv, all_to_all or reduce_scatter
for CUDA tensors, and two ranks on one card cannot use NCCL; an
all-reduce works everywhere. So each exchange is ONE all-reduce SUM of a
zero [D, L, C] buffer in which every rank fills its own slot (the
forward: slot = the sending rank; the backward: slot = the receiving
rank). This moves D times the rows a point-to-point exchange would.
`L` is the rows actually sent: every send and publish list is filled
from its front, so an exchange carries the longest list's prefix over all
shards (`HaloExchange.sent`), not the budgets H and P. Features in bf16
travel as f32 (a sum with zeros, exact either way).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.distributed as dist

from occuseg_tpu_torch.ops.conv import gather_rows


def _wire(dtype: torch.dtype) -> torch.dtype:
    """The dtype a buffer of `dtype` rows travels in."""
    return dtype if dtype in (torch.float32, torch.float64) \
        else torch.float32


def _where_size(group):
    return dist.get_rank(group), dist.get_world_size(group)


class _AllSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def all_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of `x` over the group's ranks, on every rank; its backward
    is the sum of the ranks' cotangents."""
    return _AllSum.apply(x, group)


def all_max(x: torch.Tensor, group) -> torch.Tensor:
    """The elementwise maximum of `x` over the group's ranks (no
    gradient)."""
    with torch.no_grad():
        out = x.detach().contiguous().clone()
        dist.all_reduce(out, op=dist.ReduceOp.MAX, group=group)
    return out


def gather_slots(x: torch.Tensor, group) -> torch.Tensor:
    """[D, *x.shape]: every rank's `x` in its rank's slot, on every rank
    (one all-reduce; no gradient)."""
    rank, D = _where_size(group)
    with torch.no_grad():
        buf = torch.zeros((D,) + tuple(x.shape), dtype=_wire(x.dtype),
                          device=x.device)
        buf[rank] = x
        dist.all_reduce(buf, group=group)
    return buf.to(x.dtype)


class _Extend(torch.autograd.Function):
    """`extend_features` with its adjoint; `sent` = (rows of the left,
    right and publish lists any shard fills)."""

    @staticmethod
    def forward(ctx, feats, send_left, send_right, publish, halo, sent,
                group):
        rank, D = _where_size(group)
        nl, nr, npub = sent
        S, C = feats.shape
        P = publish.shape[0]
        ctx.save_for_backward(send_left, send_right, publish)
        ctx.meta = (rank, D, S, halo, P, sent, feats.dtype, group)
        wire = _wire(feats.dtype)
        buf = torch.zeros((D, nl + nr + npub, C), dtype=wire,
                          device=feats.device)
        mine = buf[rank]
        mine[:nl] = gather_rows(feats, send_left[:nl])
        mine[nl:nl + nr] = gather_rows(feats, send_right[:nr])
        mine[nl + nr:] = gather_rows(feats, publish[:npub])
        dist.all_reduce(buf, group=group)
        buf = buf.to(feats.dtype)
        ext = feats.new_zeros((S + 2 * halo + D * P, C))
        ext[:S] = feats
        # the left neighbour's right pack is my left halo, the right
        # neighbour's left pack my right halo (cyclic, as JAX's ppermute)
        ext[S:S + nr] = buf[(rank - 1) % D, nl:nl + nr]
        ext[S + halo:S + halo + nl] = buf[(rank + 1) % D, :nl]
        ext[S + 2 * halo:].view(D, P, C)[:, :npub] = buf[:, nl + nr:]
        return ext

    @staticmethod
    def backward(ctx, g):
        send_left, send_right, publish = ctx.saved_tensors
        rank, D, S, halo, P, sent, dtype, group = ctx.meta
        nl, nr, npub = sent
        C = g.shape[1]
        wire = _wire(dtype)
        g = g.to(wire)
        buf = torch.zeros((D, nl + nr + npub, C), dtype=wire,
                          device=g.device)
        # slot r holds the cotangents of rank r's packs
        buf[(rank - 1) % D, nl:nl + nr] += g[S:S + nr]
        buf[(rank + 1) % D, :nl] += g[S + halo:S + halo + nl]
        buf[:, nl + nr:] += g[S + 2 * halo:].view(D, P, C)[:, :npub]
        dist.all_reduce(buf, group=group)
        mine = buf[rank]
        d = g[:S].clone()
        for rows, part in ((send_left[:nl], mine[:nl]),
                           (send_right[:nr], mine[nl:nl + nr]),
                           (publish[:npub], mine[nl + nr:])):
            valid = (rows >= 0)[:, None]
            d.index_add_(0, rows.clamp(min=0).long(),
                         torch.where(valid, part, torch.zeros(
                             (), dtype=wire, device=g.device)))
        return d.to(dtype), None, None, None, None, None, None


def extend_features(feats: torch.Tensor, send_left: torch.Tensor,
                    send_right: torch.Tensor, publish: torch.Tensor,
                    halo: int, group,
                    sent: Optional[Sequence[int]] = None) -> torch.Tensor:
    """This rank's extended rows [S + 2H + D*P, C] (module docstring):
    feats [S, C] local rows; send_left / send_right [H] and publish [P]
    int32 this rank's lists on the features' device (-1 pad). `sent`:
    how many leading entries of the left, right and publish lists any
    shard fills (default: all of them, H, H and P)."""
    if sent is None:
        sent = (send_left.shape[0], send_right.shape[0], publish.shape[0])
    return _Extend.apply(feats, send_left, send_right, publish, int(halo),
                         tuple(int(s) for s in sent), group)


def halo_exchange(feats: torch.Tensor, send_left: torch.Tensor,
                  send_right: torch.Tensor, halo: int, group) -> torch.Tensor:
    """The halos alone: [S + 2H, C] (`extend_features` without a
    pool)."""
    return extend_features(feats, send_left, send_right, send_left[:0],
                           halo, group)
