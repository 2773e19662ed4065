"""Data parallelism over ranks (counterpart of
`occuseg_tpu/parallel/data_parallel.py` and the data-parallel half of
`occuseg_tpu/train/state.py`'s step).

One process per rank, joined by `torch.distributed`: each rank plans and
runs the forward and backward of its own scenes, and one all-reduce per
step combines the ranks. The JAX step's semantics, not
DistributedDataParallel's: a rank of loss weight w contributes the
gradient of w * L, and the step takes

    sum_r w_r * g_r / max(sum_r w_r, 1e-8)

for the gradients, the loss parts and the BN running statistics alike
(`occuseg_tpu/train/state.py:120-148`; all weights 1 is the plain mean).
Each rank normalises with its own batch's statistics (no SyncBatchNorm,
as the JAX step's BN sees one device's batch), and the averaged running
statistics replace each rank's afterwards. The optimizer then runs on
every rank on the same gradients, so the parameters stay replicated.

The epoch's remainder group is padded with copies of its last batch at
weight 0 (`dp_groups`), so no scene is dropped and a weight-0 rank
changes nothing. Every rank draws the epoch's order and the batches'
seeds alike, and makes (loads, augments) only its own member.

The backend is NCCL for CUDA tensors and gloo for CPU tensors unless a
caller names one: two ranks on one card need gloo (NCCL refuses two
ranks on one device).
"""

from __future__ import annotations

import os
import pickle
import tempfile
from datetime import timedelta
from typing import Callable, Dict, Iterable, Iterator, List, Optional, Tuple

import torch
import torch.distributed as dist

# the weight sum below which a group counts as empty (the JAX step's floor)
_MIN_WEIGHT = 1e-8
_BN_STATS = ("running_mean", "running_var")
# how long a collective waits for its peers: rank 0 alone checkpoints and
# runs the semantic eval at each snapshot while the others wait at a
# barrier (NCCL's default, 10 minutes, is shorter than an eval of the
# ScanNet validation split may take)
TIMEOUT = timedelta(hours=2)


def num_devices(requested: Optional[int], device) -> int:
    """The ranks a launcher starts for --num_devices `requested` on
    `device`: on "cuda" the visible cards when not given, and never more
    than there are (`occuseg_tpu/train/loop.py:293-294`); on one named
    card ("cuda:N") one rank; on the CPU, where each rank is a process,
    the count requested, one when not given."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return max(int(requested or 1), 1)
    if dev.index is not None:
        return 1
    cards = torch.cuda.device_count()
    return max(min(int(requested or cards), cards), 1)


def world() -> Tuple[int, int]:
    """(rank, ranks) of this process in the joined default process group;
    (0, 1) when it has joined none."""
    if not dist.is_initialized():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def rank_device(device, rank: int) -> torch.device:
    """The rank's device: "cuda" without an index is the card of the
    rank's place on its host, torchrun's LOCAL_RANK where it is set (a
    global rank names no card once the ranks span hosts), else `rank`; a
    device with an index (or the CPU) is taken as it is, for every
    rank."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        local = int(os.environ.get("LOCAL_RANK", rank))
        return torch.device("cuda", local % max(torch.cuda.device_count(), 1))
    return dev


def default_backend(device) -> str:
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def shared_card_backend(device, ranks_per_host: int) -> Optional[str]:
    """"gloo" where `ranks_per_host` ranks on `device` would share a card
    (a named card, or more ranks than cards; NCCL refuses two ranks on
    one device), else None (the default backend)."""
    dev = torch.device(device)
    if dev.type == "cuda" and ranks_per_host > 1 and (
            dev.index is not None
            or ranks_per_host > torch.cuda.device_count()):
        return "gloo"
    return None


def init(rank: int, world_size: int, init_method: str, device,
         backend: Optional[str] = None,
         timeout: timedelta = TIMEOUT) -> None:
    """Join the process group (the default backend for `device`'s type
    unless `backend` is given), its collectives waiting up to
    `timeout`."""
    dev = rank_device(device, rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend or default_backend(dev),
                            init_method=init_method, rank=rank,
                            world_size=world_size, timeout=timeout)


def dp_groups(batches: Iterable, n: int
              ) -> Iterator[Tuple[List, List[float]]]:
    """Consecutive batches (or calls that make them) in groups of `n`,
    each with its loss weights: 1 for every batch, and the epoch's
    remainder group padded with copies of its last batch at weight 0
    (`occuseg_tpu/train/loop.py` `dp_plan_prefetcher`)."""
    group: List = []
    for b in batches:
        group.append(b)
        if len(group) == n:
            yield group, [1.0] * n
            group = []
    if group:
        pad = n - len(group)
        yield group + [group[-1]] * pad, [1.0] * len(group) + [0.0] * pad


def bn_statistics(model: torch.nn.Module) -> List[torch.Tensor]:
    """The model's BN running statistics (its `batch_stats`)."""
    return [b for n, b in model.named_buffers()
            if n.rsplit(".", 1)[-1] in _BN_STATS]


def allreduce_step(grads: List[Optional[torch.Tensor]],
                   parts: Dict[str, torch.Tensor],
                   stats: List[torch.Tensor], weight: float,
                   group=None) -> Tuple[List[Optional[torch.Tensor]],
                                        Dict[str, torch.Tensor]]:
    """One flattened all-reduce of a rank's step: `grads` (of w * L; None
    where a parameter got none, which is the same on every rank: the same
    model runs the same path), the loss `parts` and the BN statistics
    `stats` scaled by w, and w itself; returns the weighted means of the
    gradients and parts, and writes the statistics' means in place."""
    like = next(t for t in stats + list(parts.values()) + grads
                if t is not None)
    w = torch.tensor([float(weight)], dtype=torch.float32,
                     device=like.device)
    pieces = [(g if g is not None else torch.zeros(0, device=like.device))
              .reshape(-1).float() for g in grads]
    pieces += [p.reshape(-1).float() * w for p in parts.values()]
    pieces += [s.reshape(-1).float() * w for s in stats]
    flat = torch.cat(pieces + [w])
    dist.all_reduce(flat, group=group)
    denom = torch.clamp(flat[-1:], min=_MIN_WEIGHT)
    flat = flat[:-1] / denom
    out_grads, i = [], 0
    for g in grads:
        n = 0 if g is None else g.numel()
        out_grads.append(None if g is None
                         else flat[i:i + n].view_as(g).to(g.dtype))
        i += n
    out_parts = {}
    for k, p in parts.items():
        out_parts[k] = flat[i:i + p.numel()].view_as(p).to(p.dtype)
        i += p.numel()
    with torch.no_grad():
        for s in stats:
            s.copy_(flat[i:i + s.numel()].view_as(s))
            i += s.numel()
    return out_grads, out_parts


def _rank_main(rank: int, fn: Callable, world_size: int, init_method: str,
               device, backend: Optional[str], out_dir: str, args) -> None:
    init(rank, world_size, init_method, device, backend)
    try:
        value = fn(rank, world_size, *args)
    finally:
        dist.destroy_process_group()
    # by value, in a file: a tensor sent between processes as it is would
    # be shared through a descriptor that dies with this process
    with open(os.path.join(out_dir, f"rank_{rank}.pkl"), "wb") as f:
        pickle.dump(value, f)


def spawn(fn: Callable, world_size: int, device, *args,
          backend: Optional[str] = None) -> list:
    """Run `fn(rank, world_size, *args)` in `world_size` spawned
    processes joined in one process group (its store a file in a fresh
    temporary directory, so concurrent runs never share an address), on
    `device` (`rank_device`) and `backend`; returns each rank's return
    value, in rank order. A rank that raises stops the others, and the
    call raises with its traceback (`torch.multiprocessing.spawn`). `fn`
    and `args` must pickle."""
    import torch.multiprocessing as mp
    with tempfile.TemporaryDirectory(prefix="occ_dp_") as tmp:
        mp.spawn(_rank_main, nprocs=world_size, join=True, args=(
            fn, world_size, "file://" + os.path.join(tmp, "store"),
            str(device), backend, tmp, args))
        out = []
        for r in range(world_size):
            with open(os.path.join(tmp, f"rank_{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
    return out
