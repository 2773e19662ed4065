"""Closed-loop training traffic: batches of placed rooms through the
program's `native/pool.PlanPool.imap` into `train/state.Trainer.step`, as
`train/loop.train` drives them (one thread pulls and steps, the pool
plans ahead; each step's loss parts are read back, which waits for it),
with no evaluation or checkpoint. The batches are made in set-up, so the
window leaves out what `train.loop.train`'s own loader spends on its
thread making each batch.

Set-up builds the trainer from the configuration's flags
(`train.config.args_to_config`, `train.loop.build_spec`,
`train.loop.build_trainer`), loads the seeded weights, and drives it
through the first steps, which compile and warm every shape; the window
then steps the same trainer from the same feed. After the window the
reference follows the first steps from the same weights and batches.

Cell keys: kind "train", pool_rooms, room_points [lo, hi], room_seed,
batches (how many distinct batches set-up makes; the steps go through
them in order and start over after the last), checked_steps, limits (of
loss_gap, grad_gap, change_gap, bnstat_gap, `_numbers`; a number without
a limit is reported in `info`, not compared).
"""

from __future__ import annotations

import gc
import statistics
import threading
import time
from typing import Dict, List

import torch

from bench_port.lib import compare, faults, scenes, work
from bench_port.reference import model as ref_model
from bench_port.reference import train as ref_train


def program_config(conf: Dict) -> Dict:
    """The program's config dict of the configuration's flags."""
    from occuseg_tpu_torch.train.config import args_to_config, get_parser
    return args_to_config(get_parser().parse_args(conf["flags"]))


class _Feed:
    """The run's `count` batches, made in set-up by a thread of their own
    while the trainer is built and the checked steps run (the benchmark's
    data set: making them is not the program's work, and none is made in
    the window). Iterating hands them on the caller's thread to
    `PlanPool.imap` in order, starting over after the last; `placed`
    holds each batch's placements."""

    def __init__(self, rooms, seed, count, ns, scale, p_cap, i_cap):
        stream = scenes.placements(rooms, seed)
        self.placed = [[next(stream) for _ in range(ns)]
                       for _ in range(count)]
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

    def get(self, i: int) -> Dict:
        with self.ready:
            self.ready.wait_for(lambda: len(self.batches) > i
                                or self.error is not None)
            if len(self.batches) > i:
                return self.batches[i]
        raise RuntimeError("the batch feed failed") from self.error

    def __iter__(self):
        i = 0
        while True:
            yield self.get(i % len(self.placed))
            i += 1

    def wait(self) -> None:
        """Until every batch is made."""
        self.get(len(self.placed) - 1)
        self.thread.join()


STATS = ("running_mean", "running_var")


def _changes(model, init: Dict[str, torch.Tensor], ends=None
             ) -> Dict[str, float]:
    """The norm of each state entry's change from `init` (only the names
    ending in one of `ends`, if given)."""
    sd = model.state_dict()
    return {n: float((sd[n].float() - init[n]).double().norm())
            for n in init if ends is None or n.endswith(ends)}


def run(r) -> Dict:
    from occuseg_tpu_torch.native.pool import PlanPool
    from occuseg_tpu_torch.train.loop import build_spec, build_trainer
    cfg, mcfg, dev = program_config(r.conf), r.conf["model"], r.device
    assert list(cfg["unet_structure"]) == list(mcfg["planes"])
    ns, scale = int(cfg["batch_size"]), float(cfg["scale"])
    p_cap, i_cap = int(cfg["point_cap"]), int(cfg["instance_cap"])
    marks = {"start": time.perf_counter() - r.t0}
    rooms = scenes.RoomPool(r.cell["room_seed"], r.cell["pool_rooms"],
                            r.cell["room_points"])
    marks["rooms"] = time.perf_counter() - r.t0
    feed = _Feed(rooms, r.seed, int(r.cell["batches"]), ns, scale, p_cap,
                 i_cap)

    weights = ref_model.make_weights(mcfg, r.seed, dev)
    trainer = build_trainer(cfg, dev, ns)
    trainer.model.load_state_dict(weights)
    marks["trainer"] = time.perf_counter() - r.t0
    if r.fault:
        faults.plant_train(trainer, r.fault)
    blocked = ns if ns > 1 and cfg.get("blocked_batch", 1) else 1
    pool = PlanPool(build_spec(cfg), int(cfg["plan_workers"]), ns=blocked,
                    pin=dev.type == "cuda", chunks=bool(cfg["chunk_conv"]))
    source = pool.imap(feed)

    def step() -> Dict[str, float]:
        with r.spans("train.wait"):
            raw, plan, _ = next(source)
        with r.spans("train.step"):
            parts = trainer.step(raw, plan)
            return {k: float(v) for k, v in parts.items()}

    # set-up: the checked steps, which also compile and warm every shape
    named = dict(trainer.model.named_parameters())
    beta1 = trainer.optimizer.param_groups[0]["betas"][0]
    checked = int(r.cell["checked_steps"])
    losses = [step()["total"]]
    marks["step1"] = time.perf_counter() - r.t0
    state = trainer.optimizer.state
    grads = {n: float(state[p]["exp_avg"].double().norm() / (1 - beta1))
             if p in state else 0.0 for n, p in named.items()}
    change1 = _changes(trainer.model, weights, STATS)
    for _ in range(checked - 1):
        losses.append(step()["total"])
    change = _changes(trainer.model, weights)
    feed.wait()
    marks["feed"] = time.perf_counter() - r.t0
    setup_s = time.perf_counter() - r.t0

    steps = 0
    with r.window():
        t0 = time.perf_counter()
        while True:
            step()
            steps += 1
            if time.perf_counter() - t0 >= r.seconds:
                break
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        window_s = time.perf_counter() - t0
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    pool.close()
    del trainer, named, state, source, pool
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # the window's work, from the coordinates of its batches
    count = len(feed.placed)
    win = [feed.placed[(checked + i) % count] for i in range(steps)]
    per_step = []
    for ps in win:
        c = torch.as_tensor(scenes.batch_coords(rooms, ps, scale), device=dev)
        if r.trace:
            counts = work.level_counts(c, len(mcfg["planes"]))
            per_step.append(work.step_work(mcfg, counts, True, r.peaks))
        else:
            per_step.append({"voxels": float(work.voxels(c))})
        del c
    voxels = sum(w["voxels"] for w in per_step)

    # the reference over the checked steps
    first = feed.batches[:checked]
    lr = float(cfg["lr"])
    ref = ref_train.run(mcfg, r.seed, first, ns, i_cap, lr, dev, tf32=False)
    prog = {"losses": losses, "grads": grads, "change": change,
            "change1": change1}
    numbers, leaves = _numbers(prog, ref)
    ok, rows = compare.checks(numbers, r.cell["limits"])
    res = {"correct": ok, "attempted": steps, "failed": 0,
           "memory_peak_bytes": int(peak), "checks": rows,
           "end_to_end": {"setup_s": setup_s,
                          "train_voxels_per_s": voxels / window_s},
           "layer": {"spans": dict(r.spans.durations), "steps": steps,
                     "window_s": window_s, "work": per_step},
           "info": {"numbers": numbers, "worst_leaf": leaves,
                    "steps": steps, "window_s": window_s,
                    "voxels_per_step": voxels / max(steps, 1),
                    "losses": losses, "ref_losses": ref["losses"],
                    "setup_marks_s": marks}}
    if r.control:
        ctl = ref_train.run(mcfg, r.seed, first, ns, i_cap, lr, dev,
                            tf32=True)
        res["control"] = _numbers(ctl, ref)[0]
        for f in ("half", "answer"):
            planted = ref_train.run(mcfg, r.seed, first, ns, i_cap, lr, dev,
                                    fault=f)
            res["control"]["fault_" + f] = _numbers(planted, ref)[0]
    return res


def _numbers(prog: Dict, ref: Dict):
    """({name: number}, {name: its worst leaf}). loss_gap: the worst
    step's relative loss gap. grad_gap: the worst leaf's gap of the first
    gradient's norm. change_gap: the worst parameter's gap of the norm of
    its change over the checked steps, over the parameters whose
    reference gradient is at least a thousandth of the median leaf's (the
    others move under Adam by round-off alone). bnstat_gap: the worst BN
    running statistic's gap of the norm of its change in the first step
    (after three, `bnstat3_gap`, the noise of the later steps' round-off
    dominates; it is reported, not compared)."""
    g = ref["grads"]
    med = statistics.median(g.values())
    params = {n: ref["change"][n] for n in g if g[n] >= 1e-3 * med}
    stats3 = {n: v for n, v in ref["change"].items() if n.endswith(STATS)}
    gaps = {"grad_gap": compare.leaf_gap(prog["grads"], g),
            "change_gap": compare.leaf_gap(prog["change"], params),
            "bnstat_gap": compare.leaf_gap(prog["change1"], ref["change1"]),
            "bnstat3_gap": compare.leaf_gap(prog["change"], stats3)}
    numbers = {"loss_gap": max(compare.rel_gap(a, b) for a, b in
                               zip(prog["losses"], ref["losses"]))}
    numbers.update((k, v[0]) for k, v in gaps.items())
    return numbers, {k: v[1] for k, v in gaps.items()}
