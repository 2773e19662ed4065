"""The port's spans and counters (`occuseg_tpu_torch/utils/profiling.py`)
on the CPU.

* With no profiler: totals and counters only, no `record_function`, an
  empty timeline.
* Under `torch.profiler`: the main thread's and a `PlanPool` worker's
  spans in the timeline with their parents, on the profiler's clock (an op
  the profiler records inside a span starts inside the span's interval,
  within 1 ms); no span of the program among the profiler's events.
* A tiny `Trainer.step` yields `step` and its five parts in order.
* A plan forced to escalate (small chunk budgets) counts its attempts and
  the raised tier; this test also reads the profiler's private flag, so a
  torch that moves it fails here.
* The totals under many threads, the training loop's log line, and the
  instance evaluation's laps as spans.
"""

import sys
import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from occuseg_tpu_torch import evaluate_instance
from occuseg_tpu_torch.core.topology import PlanSpec
from occuseg_tpu_torch.data.synthetic import SceneConfig, make_batch
from occuseg_tpu_torch.infer import plan_scene
from occuseg_tpu_torch.models import LearningBWDenseUNet
from occuseg_tpu_torch.native.pool import PlanPool
from occuseg_tpu_torch.ops.kernels import chunk_conv
from occuseg_tpu_torch.train import state
from occuseg_tpu_torch.train.loop import loader_report
from occuseg_tpu_torch.utils import profiling

torch.set_num_threads(2)

CAPS = (3072, 2048, 1024)
P_CAP = 4096
I = 8


@pytest.fixture(scope="module")
def batch():
    return make_batch(SceneConfig(num_points=3000, extent=96, num_objects=6),
                      num_scenes=1, p_cap=P_CAP, num_instances=I, seed=11)


def _cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def _delta(before, after, name):
    a = before["spans"].get(name, {"count": 0})["count"]
    return after["spans"].get(name, {"count": 0})["count"] - a


def test_spans_without_a_profiler_keep_totals_only(monkeypatch):
    def entered(name):
        raise AssertionError(f"record_function({name!r}) with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", entered)
    assert not profiling.profiler_enabled()
    before = profiling.snapshot()
    t0 = time.time_ns()
    with profiling.span("test.off") as s:
        with profiling.span("test.off.inner"):
            time.sleep(0.002)
    profiling.count("test.off.counter", 3)
    after = profiling.snapshot()
    assert profiling.timeline(t0, time.time_ns()) == []
    assert s.seconds >= 0.002
    assert _delta(before, after, "test.off") == 1
    assert _delta(before, after, "test.off.inner") == 1
    assert after["spans"]["test.off"]["seconds"] \
        - before["spans"].get("test.off", {"seconds": 0.0})["seconds"] \
        == pytest.approx(s.seconds)
    assert after["counters"]["test.off.counter"] \
        - before["counters"].get("test.off.counter", 0) == 3
    assert set(after["launches"]) >= {"chunk_conv", "gather_conv",
                                      "bce_fwd", "blocked_segment_sum"}


def test_spans_under_the_profiler_reach_timeline_and_trace(batch):
    spec = PlanSpec(caps=CAPS)
    with PlanPool(spec, 1) as pool, _cpu_profile() as prof:
        assert profiling.profiler_enabled()
        t0 = time.time_ns()
        with profiling.span("test.outer"):
            with profiling.span("test.inner"):
                time.sleep(0.001)
                torch.zeros(4).add_(1)
            items = list(pool.imap([batch]))
        t1 = time.time_ns()
    assert len(items) == 1
    tl = profiling.timeline(t0, t1)
    main = threading.get_native_id()
    parents = {(n, p) for n, p, tid, _, _ in tl if tid == main}
    assert {("test.outer", None), ("test.inner", "test.outer"),
            ("pool.wait", "test.outer")} <= parents
    workers = {tid for n, _, tid, _, _ in tl if n == "plan.batch"}
    assert len(workers) == 1 and main not in workers
    on_worker = {(n, p) for n, p, tid, _, _ in tl if tid in workers}
    assert {("plan.batch", None), ("plan.host", "plan.batch"),
            ("plan.chunks", "plan.batch"), ("plan.layout", "plan.batch"),
            ("plan.chunk_try", "plan.chunks")} <= on_worker
    # the timeline is on the profiler's clock, and the profiler records
    # nothing of the program's spans
    events = prof.profiler.kineto_results.events()
    assert not [e for e in events if e.name().startswith("occuseg.")]
    adds = [e.start_ns() for e in events if e.name() == "aten::add_"]
    (a, b), = [(a, b) for n, _, tid, a, b in tl if n == "test.inner"]
    assert len(adds) == 1 and a - 1_000_000 < adds[0] < b + 1_000_000


def test_trainer_step_spans_in_order(batch):
    laid, plan = state.prepare_batch(batch, PlanSpec(caps=CAPS))
    trainer = state.Trainer(LearningBWDenseUNet((16, 32, 48), num_classes=20),
                            "cpu", num_instances=I)
    before = profiling.snapshot()
    with _cpu_profile():
        t0 = time.time_ns()
        trainer.step(laid, plan)
        t1 = time.time_ns()
    main = threading.get_native_id()
    tl = [iv for iv in profiling.timeline(t0, t1) if iv[2] == main]
    assert [n for n, p, _, _, _ in tl if p is None] == ["step"]
    parts = sorted((a, n) for n, p, _, a, _ in tl if p == "step")
    assert [n for _, n in parts] == ["step.upload", "step.forward",
                                     "step.loss", "step.backward",
                                     "step.optimizer"]
    after = profiling.snapshot()
    for n in ("step", "step.upload", "step.forward", "step.loss",
              "step.backward", "step.optimizer"):
        assert _delta(before, after, n) == 1, n


def test_an_escalated_plan_counts_its_tries(batch):
    assert hasattr(torch.autograd.profiler, "_is_profiler_enabled"), \
        "torch moved the profiler flag the spans read"
    plan = plan_scene(batch["coords"], PlanSpec(caps=CAPS), chunks=False)
    before = profiling.snapshot()
    with _cpu_profile():
        assert torch.autograd.profiler._is_profiler_enabled
        t0 = time.time_ns()
        out = chunk_conv.augment_plan_with_chunks(plan, U=64)
        t1 = time.time_ns()
    after = profiling.snapshot()
    assert out.chunk_tier != 1.0
    tries = [iv for iv in profiling.timeline(t0, t1)
             if iv[0] == "plan.chunk_try"]
    assert len(tries) > 1
    assert _delta(before, after, "plan.chunk_try") == len(tries)
    assert after["counters"]["plan.tier_raised"] \
        - before["counters"].get("plan.tier_raised", 0) == 1
    gather = sum(l.chunks is None for l in out.levels) + 2 * sum(
        t.child_chunks is None for t in out.transitions)
    assert after["counters"].get("plan.gather_maps", 0) \
        - before["counters"].get("plan.gather_maps", 0) == gather


def test_totals_hold_under_many_threads():
    n_threads, n = 16, 500
    before = profiling.snapshot()
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(n):
                with profiling.span("test.stress"):
                    profiling.count("test.stress")
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(switch)
    after = profiling.snapshot()
    assert _delta(before, after, "test.stress") == n_threads * n
    assert after["counters"]["test.stress"] \
        - before["counters"].get("test.stress", 0) == n_threads * n


def test_the_loop_log_line_reads_the_snapshots():
    def snap(spans, counters):
        return {"spans": {k: {"count": c, "seconds": s}
                          for k, (c, s) in spans.items()},
                "counters": counters, "launches": {}}

    before = snap({"loop.wait": (1, 0.5), "plan.batch": (2, 3.0)},
                  {"pool.ready_at_take": 4})
    after = snap({"loop.wait": (5, 0.508), "loop.step": (4, 6.4),
                  "plan.batch": (6, 9.0), "plan.chunk_try": (5, 1.0)},
                 {"pool.ready_at_take": 14, "plan.tier_raised": 1,
                  "plan.gather_maps": 2})
    assert loader_report(before, after) == (
        "wait_ms=2.0 step_ms=1600.0 queue_depth=2.50 chunk_tries=1.25/batch "
        "tier_raised=1 gather_maps=2")


def test_eval_laps_are_spans():
    before = profiling.snapshot()
    trace = {}
    laps = evaluate_instance._Laps(torch.device("cpu"), trace)
    time.sleep(0.001)
    laps.lap("aggregate")
    laps.lap("cluster")
    after = profiling.snapshot()
    assert set(trace) == {"aggregate_ms", "cluster_ms"}
    assert trace["aggregate_ms"] >= 1.0
    assert _delta(before, after, "eval.aggregate") == 1
    assert _delta(before, after, "eval.cluster") == 1
    np.testing.assert_allclose(
        after["spans"]["eval.aggregate"]["seconds"]
        - before["spans"].get("eval.aggregate", {"seconds": 0.0})["seconds"],
        trace["aggregate_ms"] / 1e3, rtol=1e-9)
