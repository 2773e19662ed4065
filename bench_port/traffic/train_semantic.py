"""Closed-loop training traffic of a semantic-only model (MinkUNet34C):
batches of placed rooms through the program's `native/pool.PlanPool.imap`
into `train/state.Trainer.step`, as `train/loop.train` drives them, as
`traffic/train.py` does for OccuSeg, with the configuration's model built
by `--arch` (`train.config.args_to_config`, `train.loop.build_spec`,
`train.loop.build_trainer`) and trained with the plain cross-entropy and
SGD. The seeded weights are `reference/minkunet.py`'s; after the window
that reference follows the first steps from the same weights and
batches.

Cell keys: kind "train_semantic", pool_rooms, room_points [lo, hi],
room_seed, batches, checked_steps, limits (of `traffic/train._numbers`:
loss_gap, grad_gap, change_gap, bnstat_gap; a number without a limit is
reported in `info`). The first gradient is read from SGD's momentum
buffer after the first update, less the weight decay's share (the buffer
starts as the gradient plus weight_decay times the weights).
"""

from __future__ import annotations

import gc
import time
from typing import Dict

import torch

from bench_port.lib import compare, faults, scenes, work, work_minkunet
from bench_port.reference import minkunet as ref
from bench_port.traffic.train import STATS, _changes, _Feed, _numbers, \
    program_config


def run(r) -> Dict:
    # the program's flags first: one without --arch exits here, at once
    cfg, mcfg, dev = program_config(r.conf), r.conf["model"], r.device
    from occuseg_tpu_torch.native.pool import PlanPool
    from occuseg_tpu_torch.train.loop import build_spec, build_trainer
    ns, scale = int(cfg["batch_size"]), float(cfg["scale"])
    p_cap, i_cap = int(cfg["point_cap"]), int(cfg["instance_cap"])
    marks = {"start": time.perf_counter() - r.t0}
    rooms = scenes.RoomPool(r.cell["room_seed"], r.cell["pool_rooms"],
                            r.cell["room_points"])
    marks["rooms"] = time.perf_counter() - r.t0
    feed = _Feed(rooms, r.seed, int(r.cell["batches"]), ns, scale, p_cap,
                 i_cap)

    weights = ref.make_weights(mcfg, r.seed, dev)
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
    group = trainer.optimizer.param_groups[0]
    momentum, wd = float(group["momentum"]), float(group["weight_decay"])
    checked = int(r.cell["checked_steps"])
    losses = [step()["total"]]
    marks["step1"] = time.perf_counter() - r.t0
    state = trainer.optimizer.state
    grads = {n: float((state[p]["momentum_buffer"] - wd * weights[n])
                      .double().norm()) if p in state else 0.0
             for n, p in named.items()}
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
    memory = ({"reserved_peak_bytes": torch.cuda.max_memory_reserved(dev),
               "alloc_retries": torch.cuda.memory_stats(dev).get(
                   "num_alloc_retries", 0)} if dev.type == "cuda" else {})
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
            counts = work_minkunet.level_counts(c, mcfg)
            per_step.append(work_minkunet.step_work(mcfg, counts, True,
                                                    r.peaks))
        else:
            per_step.append({"voxels": float(work.voxels(c))})
        del c
    voxels = sum(w["voxels"] for w in per_step)

    # the reference over the checked steps
    first = feed.batches[:checked]
    lr = float(cfg["lr"])

    def reference(**kw):
        return ref.run(mcfg, r.seed, first, ns, lr, momentum, wd, dev, **kw)

    want = reference(tf32=False)
    prog = {"losses": losses, "grads": grads, "change": change,
            "change1": change1}
    numbers, leaves = _numbers(prog, want)
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
                    "losses": losses, "ref_losses": want["losses"],
                    "setup_marks_s": marks, "memory": memory,
                    "step_s": r.spans.durations.get("train.step", []),
                    "wait_s": r.spans.durations.get("train.wait", []),
                    "step_voxels": [w["voxels"] for w in per_step]}}
    if r.control:
        res["control"] = _numbers(reference(tf32=True), want)[0]
        for f in ("half", "answer"):
            res["control"]["fault_" + f] = _numbers(reference(fault=f),
                                                    want)[0]
    return res
