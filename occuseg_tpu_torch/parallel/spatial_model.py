"""The spatially sharded model: forward, inference and the training step
over the ordinary modules (counterpart of
`occuseg_tpu/parallel/spatial_model.py`).

One scene is split over the ranks of a process group, one shard a rank:
its voxels in active-balanced Morton chunks (`spatial.shard_plan`), its
points to the shard that owns their voxel. So the whole model (the
InputLayer's voxelize, every convolution, BN, the OutputLayer and the
heads) and the 6-term loss run on each rank over its own rows. There is
no second model: `build_spatial_topology` makes each rank's slice of the
sharded plan an ordinary `core.topology.Topology` whose levels and
transitions carry `HaloExchange` specs and whose `group` is the process
group. The convolution modules see the specs and extend their features
over the group before they convolve (`nn/modules._sharded_conv`): with
the chunk kernels where the per-shard rulebooks are attached, else with
the gather convolution over the extended rows. BatchNorm sums its
statistics over the group (`ops/norm.py`), the loss every point-level
reduction (`losses/instance.py`).

The step: every rank runs the backward of the same replicated loss, so
its gradients are averaged over the group (`parallel/comm.py`), then
each rank takes the same optimizer step.

Where each rank is a process on the same card (one H100 here), the
ranks join over gloo: NCCL refuses two ranks on one device.

Not ported: `occuseg_tpu/core/coords.full_varying_like` (a `shard_map`
typing helper with no meaning in torch) and `occuseg_tpu/parallel/
multihost.py` (multi-host runs join torchrun's process group,
`train/cli.py`).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from occuseg_tpu_torch.core.topology import (
    ChunkPlan,
    HaloExchange,
    LevelTopology,
    LevelTransition,
    Topology,
    _DeviceArrays,
)
from occuseg_tpu_torch.parallel import comm
from occuseg_tpu_torch.parallel.spatial import shard_plan, transpose_ext_map

# the per-shard chunk rulebooks' fixed geometry (the JAX package's tiers,
# `occuseg_tpu/parallel/spatial_model.py:49-57`): rows per chunk, the U
# budget of each level's and transition's maps, and the margin the
# transpose maps get for their halo and pool rows. A map whose rulebook
# overflows on ANY shard gets none on every shard.
_CHUNK_M = 128
_SUB_U = (256, 320, 384, 384, 384, 320)
_CHILD_U = (416, 576, 704, 768, 768)
_UP_U = 160
_T_MARGIN = 160

# the per-point arrays a sharded step reads
_POINT_KEYS = ("features", "labels", "instance_id", "point_scene", "pose",
               "offsets", "displacements", "occupancy")


def _chunk_stack(maps: np.ndarray, U: int) -> Optional[List[ChunkPlan]]:
    """Each shard's chunk rulebook of a stacked [D, rows, K] map, or None
    where any shard overflows U (or the rows are not chunk-aligned)."""
    from occuseg_tpu_torch.ops.kernels.chunk_conv import build_chunk_arrays
    if maps.shape[1] % _CHUNK_M:
        return None
    out = []
    for m in maps:
        arrs = build_chunk_arrays(np.ascontiguousarray(m), _CHUNK_M, U)
        if arrs is None:
            return None
        out.append(ChunkPlan(in_idx=arrs[0], lidx=arrs[1]))
    return out


def _sent(*lists: np.ndarray) -> Tuple[int, ...]:
    """How many leading entries of each stacked [D, n] list any shard
    fills (the lists are filled from their front)."""
    return tuple(int((a >= 0).sum(1).max()) if a.size else 0 for a in lists)


def _pick(stack, d):
    return None if stack is None else stack[d]


def _exchange(send_left, send_right, publish, nbr_t, halo, chunks_t, d):
    return HaloExchange(send_left=send_left[d], send_right=send_right[d],
                        publish=publish[d], nbr_t=nbr_t[d], halo=halo,
                        chunks_t=_pick(chunks_t, d),
                        sent=_sent(send_left, send_right, publish))


def build_spatial_topology(plan, num_shards: int, halo: int = 512,
                           pool: int = 512, chunks: bool = True,
                           group=None):
    """Shard a host plan (`native/plan.build_plan_host`: one level-0 layout,
    no chunk rulebooks, no point layout) over `num_shards` ranks.

    Returns (topologies, perm [D, Pl], point_pos [P], slot_valid [D, Pl]):
    shard d's slice as a host Topology with `group` set (its levels'
    `num_active` the shard's active count, its maps over the extended
    rows with their `HaloExchange` specs, per-shard chunk rulebooks with
    `chunks` where every shard's fit), and the point partition: each
    point goes to the shard that owns its level-0 voxel, shard d's slots
    `perm[d]` (pad slots read the first pad row of the batch and are
    masked by `slot_valid`), `point_pos[p]` the flat slot d * Pl + i of
    point p (-1 for pad rows). Pl = ceil(P / D * 1.125 / 8) * 8 slots a
    shard; a shard with more points raises, and so does any dropped
    reference (raise halo or pool)."""
    D = num_shards
    sp = shard_plan(plan, D, halo, pool=pool)
    if sp.dropped:
        raise ValueError(f"shard_plan dropped {sp.dropped} refs: raise the "
                         f"halo ({halo}) or the pool ({pool})")

    levels = [[] for _ in range(D)]
    for li, (lvl, shl) in enumerate(zip(plan.levels, sp.levels)):
        S = shl.nbr_local.shape[1]
        ext = S + 2 * halo + D * shl.publish.shape[1]
        nbr_t = transpose_ext_map(shl.nbr_local, ext)     # [D, ext, K]
        n2o = sp.layouts[li][0]
        keys = np.asarray(lvl.keys)[n2o].reshape(D, S)
        coords = np.asarray(lvl.coords)[n2o].reshape(D, S, -1)
        counts = [len(c) for c in
                  np.array_split(np.arange(int(lvl.num_active)), D)]
        c_fwd = c_t = None
        if chunks:
            u = _SUB_U[min(li, len(_SUB_U) - 1)]
            c_fwd = _chunk_stack(shl.nbr_local, u)
            c_t = _chunk_stack(np.ascontiguousarray(nbr_t[:, :, ::-1]),
                               u + _T_MARGIN)
        both = c_fwd is not None and c_t is not None
        for d in range(D):
            levels[d].append(LevelTopology(
                keys=keys[d], coords=coords[d], num_active=counts[d],
                nbr=shl.nbr_local[d], orient=None,
                chunks=c_fwd[d] if both else None,
                halo_ex=_exchange(shl.send_left, shl.send_right,
                                  shl.publish, nbr_t, halo, c_t, d)))

    transitions = [[] for _ in range(D)]
    for ti, tr in enumerate(sp.transitions):
        src = plan.transitions[ti]
        ext_f = (sp.levels[ti].nbr_local.shape[1] + 2 * halo
                 + D * sp.levels[ti].publish.shape[1])
        ext_c = (sp.levels[ti + 1].nbr_local.shape[1] + 2 * halo
                 + D * sp.levels[ti + 1].publish.shape[1])
        child_t = transpose_ext_map(tr["child"], ext_f)
        up_t = transpose_ext_map(tr["up"], ext_c)
        cc = ct = uc = ut = None
        if chunks:
            uch = _CHILD_U[min(ti, len(_CHILD_U) - 1)]
            cc = _chunk_stack(tr["child"], uch)
            ct = _chunk_stack(np.ascontiguousarray(child_t[:, :, ::-1]),
                              _UP_U + _T_MARGIN)
            uc = _chunk_stack(tr["up"], _UP_U)
            ut = _chunk_stack(np.ascontiguousarray(up_t[:, :, ::-1]),
                              uch + _T_MARGIN)
        child_ok = cc is not None and ct is not None
        up_ok = uc is not None and ut is not None
        for d in range(D):
            transitions[d].append(LevelTransition(
                child=tr["child"][d], up=tr["up"][d], size=src.size,
                stride=src.stride,
                child_chunks=cc[d] if child_ok else None,
                up_chunks=uc[d] if up_ok else None,
                child_ex=_exchange(tr["child_send_left"],
                                   tr["child_send_right"],
                                   tr["child_publish"], child_t, halo, ct,
                                   d),
                up_ex=_exchange(tr["up_send_left"], tr["up_send_right"],
                                tr["up_publish"], up_t, halo, ut, d)))

    # the point partition: each point to the shard owning its voxel
    p2v_g = np.asarray(plan.p2v)
    P_cap = p2v_g.shape[0]
    S0 = sp.levels[0].nbr_local.shape[1]
    o2n = sp.layouts[0][1]
    valid = p2v_g >= 0
    new_row = np.where(valid, o2n[np.clip(p2v_g, 0, None)], -1)
    shard = np.where(valid, new_row // S0, -1)
    slot = np.where(valid, new_row % S0, -1)
    # 12.5% slack over the even split: the voxel-balanced layout balances
    # points only approximately
    Pl = int(np.ceil(P_cap / D * 1.125 / 8.0) * 8)
    pad_rows = np.where(~valid)[0]
    pad_idx = int(pad_rows[0]) if pad_rows.size else 0
    perm = np.full((D, Pl), pad_idx, np.int64)
    p2v_local = np.full((D, Pl), -1, np.int32)
    point_pos = np.full(P_cap, -1, np.int64)
    slot_valid = np.zeros((D, Pl), bool)
    topos = []
    for d in range(D):
        idx = np.where(shard == d)[0]
        if idx.size > Pl:
            raise ValueError(f"shard {d} holds {idx.size} points > {Pl} "
                             f"slots: raise point_cap or use fewer shards")
        perm[d, :idx.size] = idx
        p2v_local[d, :idx.size] = slot[idx]
        point_pos[idx] = d * Pl + np.arange(idx.size)
        slot_valid[d, :idx.size] = True
        topos.append(Topology(
            levels=tuple(levels[d]), transitions=tuple(transitions[d]),
            p2v=p2v_local[d], num_points=int(idx.size),
            vox_counts=np.bincount(slot[idx], minlength=S0).astype(
                np.float32),
            group=group))
    return tuple(topos), perm, point_pos, slot_valid


@dataclasses.dataclass(frozen=True)
class ShardArgs(_DeviceArrays):
    """What one rank's sharded forward and step read: its slice of the
    sharded plan (`plan`, with the group), its point slots (`perm`: the
    global point row of each slot, `slot_valid`), and `point_pos`, the
    flat slot of every global point (-1 pad) that brings the ranks'
    outputs back into the global order. `to(device)` moves the arrays."""

    plan: Topology
    perm: object         # int64 [Pl]
    slot_valid: object   # bool [Pl]
    point_pos: object    # int64 [P]

    def _map(self, fn) -> "ShardArgs":
        return dataclasses.replace(
            self, plan=self.plan._map(fn), perm=fn(self.perm),
            slot_valid=fn(self.slot_valid), point_pos=fn(self.point_pos))


def prepare_shard_args(plan, num_shards: int, halo: int = 512,
                       pool: int = 512, chunks: bool = True,
                       rank: Optional[int] = None, group=None) -> ShardArgs:
    """Host preparation of a sharded step or forward (a loader thread may
    run it): this rank's ShardArgs of the host plan (`rank`: this
    process's rank in `group` by default; `group`: the default group by
    default). Every rank builds the same sharded plan and keeps its own
    slice."""
    if group is None and dist.is_initialized():
        group = dist.group.WORLD
    if rank is None:
        rank = dist.get_rank(group)
    topos, perm, pos, sv = build_spatial_topology(plan, num_shards, halo,
                                                  pool, chunks, group)
    return ShardArgs(plan=topos[rank], perm=perm[rank],
                     slot_valid=sv[rank], point_pos=pos)


def shard_points(batch: Dict, shard_args: ShardArgs, device) -> Dict:
    """This rank's rows of a global batch's per-point arrays
    (`_POINT_KEYS` present in it), on `device`; pad slots get labels,
    instance_id and point_scene -1, so the group's sums count every real
    point once (`occuseg_tpu/parallel/spatial_model.py:347-350`)."""
    perm = torch.as_tensor(shard_args.perm)
    out = {}
    for k in _POINT_KEYS:
        if k in batch:
            a = torch.as_tensor(batch[k])
            out[k] = a.index_select(0, perm.to(a.device)).to(device)
    sv = torch.as_tensor(shard_args.slot_valid).to(device)
    for k in ("labels", "instance_id", "point_scene"):
        if k in out:
            out[k] = torch.where(sv, out[k], torch.full_like(out[k], -1))
    return out


def sharded_apply(model: torch.nn.Module, shard_args: ShardArgs,
                  features: torch.Tensor, group=None, train: bool = False):
    """The model's forward over this rank's shard (`shard_args` on the
    model's device; `features` the global [P, C] point features there):
    the rank's OccuSegOutputs over its slots. `group` defaults to the
    plan's; train=True runs the batch statistics (summed over the group)
    and updates the running ones in place."""
    plan = shard_args.plan
    if group is not None and group is not plan.group:
        plan = dataclasses.replace(plan, group=group)
    features = features.index_select(
        0, torch.as_tensor(shard_args.perm).to(features.device))
    model.train(train)
    return model(features, plan)


def _unshard_points(flat: torch.Tensor, point_pos: torch.Tensor
                    ) -> torch.Tensor:
    """[D * Pl, ...] rows of the ranks' slots -> the global [P, ...] order;
    pad rows get zeros."""
    out = flat.index_select(0, point_pos.clamp(min=0))
    mask = (point_pos >= 0).reshape((-1,) + (1,) * (out.dim() - 1))
    return torch.where(mask, out, torch.zeros((), dtype=out.dtype,
                                              device=out.device))


def gather_outputs(out, shard_args: ShardArgs, group):
    """Every rank's outputs in the global point order, on every rank: the
    fields are gathered over the group in one exchange
    (`comm.gather_slots`), then `_unshard_points`."""
    fields = [(k, v) for k, v in out._asdict().items() if v is not None]
    widths = [v.shape[1] if v.dim() > 1 else 0 for _, v in fields]
    flat = torch.cat([v.float().reshape(v.shape[0], -1) for _, v in fields],
                     dim=1)
    allr = comm.gather_slots(flat, group)                 # [D, Pl, W]
    allr = _unshard_points(allr.reshape(-1, flat.shape[1]),
                           torch.as_tensor(shard_args.point_pos).to(
                               flat.device))
    res, c = {}, 0
    for (k, v), w in zip(fields, widths):
        n = max(w, 1)
        col = allr[:, c:c + n].to(v.dtype)
        res[k] = col if w else col[:, 0]
        c += n
    return type(out)(**{k: res.get(k) for k in out._fields})


def sharded_infer(model: torch.nn.Module, plan, features, group,
                  halo: int = 512, pool: int = 512,
                  chunks: bool = True):
    """The serving entry (`sharded_occuseg_infer`): the eval-mode forward
    of the host plan `plan`'s scene split over `group`'s ranks, each rank
    running its shard on its model's device. Returns the global [P, ...]
    OccuSegOutputs on every rank (pad rows zero), the same function as
    the unsharded eval forward on every real point."""
    dev = next(model.parameters()).device
    rank, D = dist.get_rank(group), dist.get_world_size(group)
    sa = prepare_shard_args(plan, D, halo, pool, chunks, rank,
                            group).to(dev)
    pf = torch.as_tensor(features).to(dev)
    try:
        with torch.inference_mode():
            out = sharded_apply(model, sa, pf, group, train=False)
            return gather_outputs(out, sa, group)
    finally:
        model.train()


def sharded_train_forward(model: torch.nn.Module, shard_args: ShardArgs,
                          features: torch.Tensor, group=None):
    """The differentiable train-mode forward over this rank's shard
    (`sharded_apply(train=True)`): the rank's outputs over its slots; the
    BN running statistics are updated in place, equal on every rank."""
    return sharded_apply(model, shard_args, features, group, train=True)
