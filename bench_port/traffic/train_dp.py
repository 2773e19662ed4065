"""Closed-loop data-parallel training traffic: `ranks` processes joined in
one process group through the program's `parallel/data_parallel.py`
(NCCL, one card a rank; gloo where the ranks would share a card or run on
the CPU), each running `traffic/train.py`'s loop over its own batches:
its own `PlanPool.imap` into `Trainer.step(raw, plan, weight=1.0)`, as
`train.loop.train` steps a rank under `--num_devices`, one all-reduce a
step inside the step. This process is rank 0; it spawns the others.

Step i's `ranks` x batch_size rooms are the next ones of the run's
placement stream; rank r takes the r-th batch_size of them. Set-up makes
every rank's batches (each rank its own), builds each rank's trainer with
the same seeded weights and runs the checked steps, which warm every
shape. Rank 0 times the window: after each step it tells the others
whether to go on (a one-element broadcast), so every rank runs the same
steps. `train_voxels_per_s` counts the level-0 voxels of every rank's
batches of the window's steps over rank 0's window.

The ranks share the host's cores as the program shares them under
`--num_devices` (`data_parallel.share_cores`: each plan worker's OpenMP
team and the rank's own threads at cores / (ranks x workers)).

After the window every rank's parameters and BN statistics are compared
with rank 0's (`rank_gap`, the largest absolute difference: 0 when the
ranks stayed replicated), and rank 0's first steps with the plain
reference's mean over the ranks' batches (`reference/train_dp.py`), by
`traffic/train._numbers` (rank 0's loss parts, gradient and BN statistics
are the group's means).

Cell keys: kind "train_dp", ranks, and those of `traffic/train.py`;
limits also of rank_gap.
"""

from __future__ import annotations

import gc
import os
import pickle
import shutil
import tempfile
import threading
import time
from datetime import timedelta
from typing import Dict, List

import numpy as np
import torch

from bench_port.lib import compare, faults, scenes, work
from bench_port.reference import model as ref_model
from bench_port.reference import train_dp as ref_train_dp
from bench_port.traffic.train import STATS, _changes, _Feed, _numbers, \
    program_config

# how long a collective waits for the other ranks
TIMEOUT = timedelta(minutes=15)


class _RankFeed(_Feed):
    """`_Feed` over given placements (this rank's batches)."""

    def __init__(self, rooms, placed, scale, p_cap, i_cap):
        self.placed = placed
        self.batches: List[Dict] = []
        self.error = None
        self.ready = threading.Condition()

        def make():
            try:
                for ps in self.placed:
                    b = scenes.make_batch(rooms, ps, scale, p_cap, i_cap)
                    with self.ready:
                        self.batches.append(b)
                        self.ready.notify_all()
            except BaseException as e:  # handed to the caller
                with self.ready:
                    self.error = e
                    self.ready.notify_all()

        self.thread = threading.Thread(target=make, name="bench-feed",
                                       daemon=True)
        self.thread.start()


def placements(rooms, seed: int, count: int, ranks: int, ns: int
               ) -> List[List[List]]:
    """[step][rank] -> the rank's batch's placements, for `count` steps."""
    stream = scenes.placements(rooms, seed)
    return [[[next(stream) for _ in range(ns)] for _ in range(ranks)]
            for _ in range(count)]


class _NoSpans:
    def __call__(self, name):
        import contextlib
        return contextlib.nullcontext()


def _rank(rank: int, ranks: int, dev: torch.device, cell: Dict, conf: Dict,
          seed: int, seconds: float, fault, spans, window, t_start: float
          ) -> Dict:
    """One rank's run: set-up, the checked steps, the window (rank 0
    decides its end), the replication check; what rank 0 needs of it."""
    import torch.distributed as dist
    from occuseg_tpu_torch.native.pool import PlanPool
    from occuseg_tpu_torch.parallel.data_parallel import share_cores
    from occuseg_tpu_torch.train.loop import build_spec, build_trainer
    cfg, mcfg = program_config(conf), conf["model"]
    ns, scale = int(cfg["batch_size"]), float(cfg["scale"])
    p_cap, i_cap = int(cfg["point_cap"]), int(cfg["instance_cap"])
    marks = {"start": time.perf_counter() - t_start}
    rooms = scenes.RoomPool(cell["room_seed"], cell["pool_rooms"],
                            cell["room_points"])
    placed = placements(rooms, seed, int(cell["batches"]), ranks, ns)
    feed = _RankFeed(rooms, [p[rank] for p in placed], scale, p_cap, i_cap)
    weights = ref_model.make_weights(mcfg, seed, dev)
    trainer = build_trainer(cfg, dev, ns)
    trainer.model.load_state_dict(weights)
    marks["trainer"] = time.perf_counter() - t_start
    if fault:
        faults.plant_train(trainer, fault)
    blocked = ns if ns > 1 and cfg.get("blocked_batch", 1) else 1
    workers = max(int(cfg["plan_workers"]), 1)
    pool = PlanPool(build_spec(cfg), workers, ns=blocked,
                    pin=dev.type == "cuda", chunks=bool(cfg["chunk_conv"]),
                    threads=share_cores(workers, ranks))
    source = pool.imap(feed)

    def step() -> Dict[str, float]:
        with spans("train.wait"):
            raw, plan, _ = next(source)
        with spans("train.step"):
            parts = trainer.step(raw, plan, weight=1.0)
            return {k: float(v) for k, v in parts.items()}

    named = dict(trainer.model.named_parameters())
    beta1 = trainer.optimizer.param_groups[0]["betas"][0]
    checked = int(cell["checked_steps"])
    losses = [step()["total"]]
    state = trainer.optimizer.state
    grads = {n: float(state[p]["exp_avg"].double().norm() / (1 - beta1))
             if p in state else 0.0 for n, p in named.items()}
    change1 = _changes(trainer.model, weights, STATS)
    for _ in range(checked - 1):
        losses.append(step()["total"])
    change = _changes(trainer.model, weights)
    feed.wait()
    marks["feed"] = time.perf_counter() - t_start
    setup_s = time.perf_counter() - t_start
    dist.barrier()

    flag = torch.zeros(1, dtype=torch.int32, device=dev)
    steps = 0
    with window():
        t0 = time.perf_counter()
        while True:
            step()
            steps += 1
            if rank == 0:
                flag.fill_(int(time.perf_counter() - t0 < seconds))
            dist.broadcast(flag, 0)
            if not int(flag.item()):
                break
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        window_s = time.perf_counter() - t0
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)

    # every rank's parameters and statistics against rank 0's
    sd = trainer.model.state_dict()
    flat = torch.cat([sd[n].reshape(-1).float() for n in sorted(sd)])
    mine = flat.clone()
    dist.broadcast(flat, 0)
    gap = (mine - flat).abs().max().reshape(1)
    dist.all_reduce(gap, op=dist.ReduceOp.MAX)
    pool.close()
    del trainer, named, state, source, pool, sd, flat, mine
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return {"losses": losses, "grads": grads, "change": change,
            "change1": change1, "steps": steps, "window_s": window_s,
            "setup_s": setup_s, "peak": int(peak), "rank_gap": float(gap),
            "placed": placed, "first": feed.batches[:checked],
            "rooms": rooms, "marks": marks, "cfg": cfg}


def _child(rank: int, ranks: int, init_method: str, device: str, backend,
           cell: Dict, conf: Dict, seed: int, seconds: float, fault,
           out: str) -> None:
    """A spawned rank (1..ranks-1): joins the group, runs `_rank`."""
    import contextlib
    import torch.distributed as dist
    from occuseg_tpu_torch.parallel import data_parallel
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    data_parallel.init(rank, ranks, init_method, device, backend, TIMEOUT)
    try:
        dev = data_parallel.rank_device(device, rank)
        res = _rank(rank, ranks, dev, cell, conf, seed, seconds, fault,
                    _NoSpans(), contextlib.nullcontext, t_start)
    finally:
        dist.destroy_process_group()
    with open(out, "wb") as f:
        pickle.dump({"rank_gap": res["rank_gap"], "steps": res["steps"]}, f)


def _layout(dev: torch.device, ranks: int):
    """(the ranks' device name, backend): one card a rank over NCCL where
    there are enough cards, else every rank on `dev` over gloo."""
    from occuseg_tpu_torch.parallel import data_parallel
    if dev.type == "cuda" and torch.cuda.device_count() >= ranks:
        return "cuda", None
    name = str(dev) if dev.type != "cuda" or dev.index is not None \
        else "cuda:0"
    return name, ("gloo" if dev.type == "cuda"
                  else data_parallel.default_backend(dev))


def run(r) -> Dict:
    import multiprocessing as mp
    import torch.distributed as dist
    from occuseg_tpu_torch.parallel import data_parallel
    if not hasattr(data_parallel, "share_cores"):
        # before any rank starts, so that no rank waits for another
        raise RuntimeError("the program does not share the host's cores "
                           "among its ranks (data_parallel.share_cores): "
                           "it cannot run this cell as --num_devices runs")
    cfg0, mcfg = program_config(r.conf), r.conf["model"]
    ranks = int(r.cell["ranks"])
    device, backend = _layout(r.device, ranks)
    tmp = tempfile.mkdtemp(prefix="bench_dp_")
    init_method = "file://" + os.path.join(tmp, "store")
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_child, daemon=True, args=(
        rank, ranks, init_method, device, backend, r.cell, r.conf, r.seed,
        r.seconds, r.fault, os.path.join(tmp, f"rank_{rank}.pkl")))
        for rank in range(1, ranks)]
    for p in procs:
        p.start()
    try:
        data_parallel.init(0, ranks, init_method, device, backend, TIMEOUT)
        dev = data_parallel.rank_device(device, 0)
        try:
            res0 = _rank(0, ranks, dev, r.cell, r.conf, r.seed, r.seconds,
                         r.fault, r.spans, r.window, r.t0)
        finally:
            dist.destroy_process_group()
        for p in procs:
            p.join()
        bad = [p.exitcode for p in procs if p.exitcode != 0]
        if bad:
            raise RuntimeError(f"a data-parallel rank exited with {bad}")
        others = []
        for rank in range(1, ranks):
            with open(os.path.join(tmp, f"rank_{rank}.pkl"), "rb") as f:
                others.append(pickle.load(f))
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
        shutil.rmtree(tmp, ignore_errors=True)

    checked, steps = int(r.cell["checked_steps"]), res0["steps"]
    rooms, placed, scale = res0["rooms"], res0["placed"], \
        float(cfg0["scale"])
    count = len(placed)
    voxels, per_step = 0.0, []
    for i in range(steps):
        for k, ps in enumerate(placed[(checked + i) % count]):
            c = torch.as_tensor(scenes.batch_coords(rooms, ps, scale),
                                device=dev)
            voxels += float(work.voxels(c))
            if r.trace and k == 0:
                # rank 0's work, which its card (the traced one) ran
                counts = work.level_counts(c, len(mcfg["planes"]))
                per_step.append(work.step_work(mcfg, counts, True, r.peaks))
            del c

    # the reference over the checked steps: each step the ranks' batches
    firsts = [res0["first"]]
    ns, i_cap = int(cfg0["batch_size"]), int(cfg0["instance_cap"])
    ref_steps = [[scenes.make_batch(rooms, p[k], scale,
                                    int(cfg0["point_cap"]), i_cap)
                  if k else firsts[0][i] for k in range(ranks)]
                 for i, p in enumerate(placed[:checked])]
    lr = float(cfg0["lr"])

    def reference(**kw):
        return ref_train_dp.run(mcfg, r.seed, ref_steps, ns, i_cap, lr, dev,
                                **kw)

    want = reference(tf32=False)
    prog = {k: res0[k] for k in ("losses", "grads", "change", "change1")}
    numbers, leaves = _numbers(prog, want)
    numbers["rank_gap"] = max([res0["rank_gap"]]
                              + [o["rank_gap"] for o in others])
    ok, rows = compare.checks(numbers, r.cell["limits"])
    window_s = res0["window_s"]
    res = {"correct": ok, "attempted": steps, "failed": 0,
           "memory_peak_bytes": res0["peak"], "checks": rows,
           "end_to_end": {"setup_s": res0["setup_s"],
                          "train_voxels_per_s": voxels / window_s},
           "layer": {"spans": dict(r.spans.durations), "steps": steps,
                     "window_s": window_s, "work": per_step},
           "info": {"numbers": numbers, "worst_leaf": leaves,
                    "ranks": ranks, "backend": backend or "nccl",
                    "steps": steps, "window_s": window_s,
                    "voxels_per_step": voxels / max(steps, 1),
                    "losses": res0["losses"], "ref_losses": want["losses"],
                    "setup_marks_s": res0["marks"]}}
    if r.control:
        res["control"] = _numbers(reference(tf32=True), want)[0]
        for f in ("half", "answer"):
            res["control"]["fault_" + f] = _numbers(reference(fault=f),
                                                    want)[0]
    return res
