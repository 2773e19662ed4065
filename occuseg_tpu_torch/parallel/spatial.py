"""Voxel-axis (spatial) sharding: the host shard planner and the sharded
gather convolution (counterpart of `occuseg_tpu/parallel/spatial.py`).

One scene's voxels, in Morton row order, are split into D contiguous
shards, one per rank of a process group. A convolution's neighbour rows
then fall in the local shard or, because Morton order keeps spatial
neighbours close in row order, in a bounded HALO of rows next to the shard
boundary; the few references that cross an octant plane and land farther
than one shard away go through a global POOL of rows that every shard
publishes. Plan time (host, NumPy, bit for bit the JAX package's arrays):
for each shard the halo rows on either side (at most H per side) and the
pool rows (at most P per shard), and the shard's map remapped into the
extended row space

    [0, S) local | [S, S+H) left halo | [S+H, S+2H) right halo |
    [S+2H, S+2H+D*P) pool

(`_shard_ref_map`). Step time: `parallel/comm.extend_features` builds the
extended rows over the group, then the ordinary convolution runs over
them.
"""

from __future__ import annotations

import dataclasses
import logging

import numpy as np
import torch

from occuseg_tpu_torch.parallel import comm

log = logging.getLogger("occuseg_tpu_torch")


@dataclasses.dataclass(frozen=True)
class ShardedLevel:
    """Per-shard arrays of one level, each with a leading shard axis D.

    nbr_local values index the extended rows (module docstring); -1
    missing. send_left / send_right list the local rows each shard ships
    to shard d-1 / d+1 (padded with -1; the receiver sees them as its
    right / left halo). publish lists the local rows each shard adds to
    the pool."""

    nbr_local: np.ndarray    # [D, S, K] int32
    send_left: np.ndarray    # [D, H] int32 rows sent to shard d-1
    send_right: np.ndarray   # [D, H] int32 rows sent to shard d+1
    publish: np.ndarray      # [D, P] int32 rows published to the pool
    shard_rows: np.ndarray   # [D, S] int32 global row of each local slot
    num_shards: int = 0
    halo: int = 0
    pool: int = 0


def shard_level(nbr: np.ndarray, num_active: int, num_shards: int,
                halo: int, pool: int = 0):
    """Shard one level's neighbour map: contiguous row chunks, +-1-shard
    halos, the pool for far references (`_shard_ref_map`). Returns
    (ShardedLevel, dropped reference count)."""
    cap, K = nbr.shape
    out, send_left, send_right, publish, dropped = _shard_ref_map(
        nbr, cap, cap, num_shards, halo, pool)
    S = cap // num_shards
    shard_rows = np.stack([np.arange(S) + d * S
                           for d in range(num_shards)]).astype(np.int32)
    if dropped:
        log.warning("spatial sharding dropped %d neighbor refs (halo=%d/"
                    "pool=%d too small): increase halo/pool or use fewer "
                    "shards", dropped, halo, pool)
    sh = ShardedLevel(nbr_local=out, send_left=send_left,
                      send_right=send_right, publish=publish,
                      shard_rows=shard_rows, num_shards=num_shards,
                      halo=halo, pool=pool)
    return sh, dropped


def sharded_gather_conv(feats: torch.Tensor, sharded, weight: torch.Tensor,
                        group) -> torch.Tensor:
    """A submanifold convolution over this rank's shard: `sharded` is
    (nbr_local [S, K], send_left [H], send_right [H], publish [P], halo),
    this rank's slices of a ShardedLevel as tensors on the features'
    device; the features are extended over `group`
    (`comm.extend_features`), then convolved by
    `ops/conv.gather_conv_fused`, as the JAX function does."""
    from occuseg_tpu_torch.ops.conv import gather_conv_fused

    nbr_local, send_left, send_right, publish, halo = sharded
    ext = comm.extend_features(feats, send_left, send_right, publish, halo,
                               group)
    return gather_conv_fused(ext, nbr_local, weight)


@dataclasses.dataclass(frozen=True)
class ShardedPlan:
    """The sharded topology of a whole UNet plan.

    Every level's rows are first laid out ACTIVE-BALANCED: its active rows
    (Morton-sorted, so spatially ordered) split into D equal-count
    chunks, chunk d packed at the front of shard d's cap/D slots. Equal
    count quantiles of one Morton order line up spatially across levels;
    equal cap fractions would not, since the actives are prefix-packed.
    `layouts[l] = (new_to_old, old_to_new)` move features into and out of
    the layout. Per level a ShardedLevel; per transition its child and up
    maps remapped the same way (values index the OTHER level's extended
    rows), with their send and publish lists."""

    levels: tuple          # of ShardedLevel
    transitions: tuple     # of dict(child=..., up=..., their send lists)
    layouts: tuple = ()    # per level (new_to_old [cap], old_to_new [cap])
    num_shards: int = 0
    halo: int = 0
    dropped: int = 0


def _active_balanced_layout(cap: int, n_active: int, num_shards: int):
    """Row permutation splitting `n_active` prefix-packed rows into D
    equal-count chunks, chunk d packed at slots [d*S, d*S+len) of
    S = cap/D. Returns (new_to_old [cap] gather order, old_to_new [cap]
    its inverse)."""
    S = cap // num_shards
    new_to_old = np.full(cap, -1, np.int32)
    for d, chunk in enumerate(np.array_split(np.arange(n_active),
                                             num_shards)):
        if chunk.size > S:
            raise ValueError("active rows overflow shard slots")
        new_to_old[d * S:d * S + chunk.size] = chunk
    holes = np.where(new_to_old < 0)[0]
    new_to_old[holes] = np.arange(n_active, cap, dtype=np.int32)
    old_to_new = np.empty(cap, np.int32)
    old_to_new[new_to_old] = np.arange(cap, dtype=np.int32)
    return new_to_old, old_to_new


def _relay_map(map_arr: np.ndarray, dst_layout, src_layout) -> np.ndarray:
    """A reference map's rows reordered into the dst level's balanced
    layout, its values remapped through the src level's old -> new
    permutation (-1 stays -1)."""
    lut = np.concatenate([src_layout[1], np.asarray([-1], np.int32)])
    rows = map_arr.take(dst_layout[0], axis=0)
    return lut.take(rows)


def _shard_ref_map(map_arr: np.ndarray, dst_cap: int, src_cap: int,
                   num_shards: int, halo: int, pool: int = 0):
    """Shard a reference map whose ROWS live on the dst level and whose
    VALUES are src-level rows.

    References into the +-1 adjacent shard ride the halo; those farther
    away, and any halo overflow (the rows farthest from the boundary
    spill), go through a pool of up to P rows per shard. Returns (local
    maps [D, Sdst, K] over the extended rows, send_left / send_right
    [D, H], publish [D, P], dropped)."""
    D = num_shards
    Sdst, Ssrc = dst_cap // D, src_cap // D
    K = map_arr.shape[1]
    # pass 1: per-shard halo needs and far (pool) needs
    left_needs, right_needs, far_needs = [], [], []
    for d in range(D):
        rows = map_arr[d * Sdst:(d + 1) * Sdst]
        lo, hi = d * Ssrc, (d + 1) * Ssrc
        ref = np.unique(rows[rows >= 0])
        left = ref[(ref >= lo - Ssrc) & (ref < lo)]
        right = ref[(ref >= hi) & (ref < hi + Ssrc)]
        far = ref[(ref < lo - Ssrc) | (ref >= hi + Ssrc)]
        if left.size > halo:  # keep the rows closest to the boundary
            far = np.union1d(far, left[:-halo])
            left = left[-halo:]
        if right.size > halo:
            far = np.union1d(far, right[halo:])
            right = right[:halo]
        left_needs.append(left)
        right_needs.append(right)
        far_needs.append(far)
    # pass 2: publish sets; owner o contributes every row any shard needs
    # through the pool, at positions that are the same on every shard
    publish = np.full((D, pool), -1, np.int32)
    pool_map = np.full(src_cap, -1, np.int32)
    dropped = 0
    all_far = (np.unique(np.concatenate(far_needs)) if far_needs
               else np.empty(0, np.int64))
    base_pool = Ssrc + 2 * halo
    for o in range(D):
        mine = all_far[(all_far >= o * Ssrc) & (all_far < (o + 1) * Ssrc)]
        mine = mine[:pool]  # overflow is counted as dropped in pass 3
        publish[o, :mine.size] = mine - o * Ssrc
        pool_map[mine] = base_pool + o * pool + np.arange(mine.size)
    # pass 3: remap each shard through one [src_cap] lookup array
    out = np.full((D, Sdst, K), -1, np.int32)
    send_left = np.full((D, halo), -1, np.int32)
    send_right = np.full((D, halo), -1, np.int32)
    for d in range(D):
        rows = map_arr[d * Sdst:(d + 1) * Sdst]
        lo, hi = d * Ssrc, (d + 1) * Ssrc
        left, right = left_needs[d], right_needs[d]
        if d > 0:
            send_right[d - 1, :left.size] = left - (lo - Ssrc)
        if d + 1 < D:
            send_left[d + 1, :right.size] = right - hi
        remap = np.concatenate([pool_map, np.asarray([-1], np.int32)])
        remap[lo:hi] = np.arange(Ssrc, dtype=np.int32)
        remap[left] = (Ssrc + np.arange(left.size)).astype(np.int32)
        remap[right] = (Ssrc + halo + np.arange(right.size)).astype(np.int32)
        blk = remap.take(rows)  # ref -1 hits the sentinel slot -> -1
        dropped += int(np.sum((rows >= 0) & (blk < 0)))
        out[d] = blk
    return out, send_left, send_right, publish, dropped


def transpose_ext_map(sh_map: np.ndarray, src_ext: int) -> np.ndarray:
    """The transpose [D, src_ext, K] of a sharded map [D, Sdst, K] for the
    scatter-free backward: extended rows gathering the output rows that
    read them, with the offset flip nbr_t[j, K-1-k] = i <=> sh_map[i, k]
    = j (`ops/conv.gather_conv`'s pairing: d_ext[j] = sum_k
    ct[nbr_t[j, k]] @ W[K-1-k]^T). Unique by construction: at one offset
    an input row feeds at most one output row."""
    D, Sdst, K = sh_map.shape
    out = np.full((D, src_ext, K), -1, np.int32)
    i_idx = np.broadcast_to(np.arange(Sdst, dtype=np.int32)[:, None],
                            (Sdst, K))
    kt_idx = np.broadcast_to(np.arange(K - 1, -1, -1, dtype=np.int32)[None],
                             (Sdst, K))
    for d in range(D):
        j = sh_map[d]
        valid = j >= 0
        out[d, j[valid], kt_idx[valid]] = i_idx[valid]
    return out


def shard_plan(plan, num_shards: int, halo: int,
               pool: int = 0) -> ShardedPlan:
    """Shard a host plan (`native/plan.build_plan_host`) for a whole
    sharded forward: every level relaid active-balanced (ShardedPlan), so
    the levels align shard for shard; references beyond +-1 shard go
    through the pool. References beyond both budgets are dropped and
    counted (raise halo / pool or use fewer shards when nonzero)."""
    layouts = []
    for lvl in plan.levels:
        cap = np.asarray(lvl.nbr).shape[0]
        layouts.append(_active_balanced_layout(cap, int(lvl.num_active),
                                               num_shards))
    levels = []
    dropped = 0
    for li, lvl in enumerate(plan.levels):
        nbr = _relay_map(np.asarray(lvl.nbr), layouts[li], layouts[li])
        sh, d = shard_level(nbr, int(lvl.num_active), num_shards, halo,
                            pool)
        levels.append(sh)
        dropped += d
    transitions = []
    for ti, tr in enumerate(plan.transitions):
        fine_cap = np.asarray(plan.levels[ti].nbr).shape[0]
        coarse_cap = np.asarray(plan.levels[ti + 1].nbr).shape[0]
        child = _relay_map(np.asarray(tr.child), layouts[ti + 1],
                           layouts[ti])
        up = _relay_map(np.asarray(tr.up), layouts[ti], layouts[ti + 1])
        child, c_sl, c_sr, c_pub, d1 = _shard_ref_map(
            child, coarse_cap, fine_cap, num_shards, halo, pool)
        up, u_sl, u_sr, u_pub, d2 = _shard_ref_map(
            up, fine_cap, coarse_cap, num_shards, halo, pool)
        dropped += d1 + d2
        transitions.append(dict(child=child, child_send_left=c_sl,
                                child_send_right=c_sr, child_publish=c_pub,
                                up=up, up_send_left=u_sl,
                                up_send_right=u_sr, up_publish=u_pub))
    if dropped:
        log.warning("shard_plan dropped %d refs (halo=%d, pool=%d, D=%d)",
                    dropped, halo, pool, num_shards)
    return ShardedPlan(levels=tuple(levels), transitions=tuple(transitions),
                       layouts=tuple(layouts), num_shards=num_shards,
                       halo=halo, dropped=dropped)
