"""Voxels, neighbour maps and stride-2 rulebooks of a point cloud, and the
convolution over them, in plain PyTorch.

A voxel is a distinct integer (b, z, y, x) of the points' coordinates;
level l + 1 holds the distinct coordinates // 2 of level l. Keys pack
(b, z, y, x) row-major, so a level's rows are in key order (the program's
rows are in another order; only per-point results are compared).

Filter offsets are z-major: a submanifold 3^3 filter's offset k is
(dz, dy, dx) in {-1, 0, 1}^3 with k = 9 (dz + 1) + 3 (dy + 1) + (dx + 1);
a stride-2 filter's offset is the fine site's position in its parent's
2^3 block, k = 4 (z % 2) + 2 (y % 2) + x % 2.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import torch

AXIS = 4096  # coordinates lie in [0, 4096)


def pack(c: torch.Tensor) -> torch.Tensor:
    """int64 keys of coordinates [..., 4] (b, z, y, x) in the domain."""
    c = c.to(torch.int64)
    return ((c[..., 0] * AXIS + c[..., 1]) * AXIS + c[..., 2]) * AXIS \
        + c[..., 3]


def unpack(k: torch.Tensor) -> torch.Tensor:
    x = k % AXIS
    y = (k // AXIS) % AXIS
    z = (k // AXIS ** 2) % AXIS
    b = k // AXIS ** 3
    return torch.stack([b, z, y, x], dim=-1)


def offsets3(device) -> torch.Tensor:
    r = torch.arange(-1, 2, device=device)
    g = torch.stack(torch.meshgrid(r, r, r, indexing="ij"), dim=-1)
    return g.reshape(-1, 3)


@dataclasses.dataclass
class Level:
    keys: torch.Tensor       # [N] sorted int64
    nbr: torch.Tensor        # [27, N] row of the neighbour at offset k, -1

    @property
    def n(self) -> int:
        return self.keys.shape[0]


@dataclasses.dataclass
class Geometry:
    """Every level of a point cloud and the stride-2 rulebooks between
    them: p2v [P] (each point's level-0 row, -1 for pad rows),
    parent[l] [N_l] (the level l + 1 row of each level-l site) and
    child_k[l] [N_l] (its offset in the parent's block)."""
    levels: List[Level]
    p2v: torch.Tensor
    parent: List[torch.Tensor]
    child_k: List[torch.Tensor]


def _lookup(keys: torch.Tensor, q: torch.Tensor, ok: torch.Tensor
            ) -> torch.Tensor:
    pos = torch.searchsorted(keys, q).clamp(max=keys.shape[0] - 1)
    return torch.where(ok & (keys[pos] == q), pos, -1)


def neighbours(keys: torch.Tensor) -> torch.Tensor:
    """[27, N] neighbour rows of a level's sorted keys."""
    c = unpack(keys)
    out = []
    for d in offsets3(keys.device):
        sp = c[:, 1:] + d
        ok = ((sp >= 0) & (sp < AXIS)).all(dim=1)
        q = pack(torch.cat([c[:, :1], sp.clamp(0, AXIS - 1)], dim=1))
        out.append(_lookup(keys, q, ok))
    return torch.stack(out)


def build(coords: torch.Tensor, num_levels: int) -> Geometry:
    """The geometry of point coords [P, 4] (b, z, y, x; rows with b < 0
    are padding) over `num_levels` levels."""
    valid = coords[:, 0] >= 0
    k = pack(coords.clamp(min=0))
    keys, inv = torch.unique(k[valid], sorted=True, return_inverse=True)
    p2v = torch.full((coords.shape[0],), -1, dtype=torch.int64,
                     device=coords.device)
    p2v[valid] = inv
    levels, parent, child_k = [], [], []
    for l in range(num_levels):
        levels.append(Level(keys, neighbours(keys)))
        if l == num_levels - 1:
            break
        c = unpack(keys)
        pk = pack(torch.cat([c[:, :1], c[:, 1:] // 2], dim=1))
        keys, inv = torch.unique(pk, sorted=True, return_inverse=True)
        parent.append(inv)
        r = c[:, 1:] % 2
        child_k.append(4 * r[:, 0] + 2 * r[:, 1] + r[:, 2])
    return Geometry(levels, p2v, parent, child_k)


Pairs = List[Tuple[torch.Tensor, torch.Tensor]]


def submanifold_pairs(level: Level) -> Pairs:
    """(input rows, output rows) of each of the 27 offsets."""
    out = []
    rows = torch.arange(level.n, device=level.keys.device)
    for k in range(level.nbr.shape[0]):
        ok = level.nbr[k] >= 0
        out.append((level.nbr[k][ok], rows[ok]))
    return out


def down_pairs(geo: Geometry, l: int) -> Pairs:
    """Strided convolution level l -> l + 1: fine rows in, parents out."""
    rows = torch.arange(geo.levels[l].n, device=geo.p2v.device)
    out = []
    for k in range(8):
        sel = geo.child_k[l] == k
        out.append((rows[sel], geo.parent[l][sel]))
    return out


def up_pairs(geo: Geometry, l: int) -> Pairs:
    """Deconvolution level l + 1 -> l: parents in, fine rows out."""
    return [(o, i) for i, o in down_pairs(geo, l)]


class PairConv(torch.autograd.Function):
    """out[o] += x[i] @ W[k] over every pair (i, o) of offset k; the
    backward gathers again instead of keeping the gathered rows."""

    @staticmethod
    def forward(ctx, x, w, n_out, pairs):
        ctx.save_for_backward(x, w)
        ctx.pairs = pairs
        out = x.new_zeros((n_out, w.shape[2]))
        for k, (i, o) in enumerate(pairs):
            if i.numel():
                out.index_add_(0, o, x.index_select(0, i) @ w[k])
        return out

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        dx = torch.zeros_like(x)
        dw = torch.zeros_like(w)
        for k, (i, o) in enumerate(ctx.pairs):
            if i.numel():
                go = g.index_select(0, o)
                dx.index_add_(0, i, go @ w[k].t())
                dw[k] = x.index_select(0, i).t() @ go
        return dx, dw, None, None


def conv(x: torch.Tensor, w: torch.Tensor, n_out: int, pairs: Pairs
         ) -> torch.Tensor:
    return PairConv.apply(x, w, n_out, pairs)
