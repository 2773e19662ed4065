"""The program's spans in a traced run (`lib/program.py`) on a hand-built
event list and timeline, beside the accepted reduction (`lib/trace.py`),
the readers of the program's spans, and a tiny traced run on the CPU that
reads the loader's metrics."""

import importlib.util
import os
import threading

import pytest
import torch

from bench_port.lib import program, trace
from tiny import run_tiny

CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
MS = 1_000_000
METRICS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "metrics")


class Ev:
    """What `Trace` reads of one of the profiler's events."""

    def __init__(self, name, start, dur, dev=CPU, tid=1, corr=0, linked=0,
                 seq=-1, fwd_tid=0):
        self._v = (name, start, dur, dev, tid, corr, linked, seq, fwd_tid)

    def name(self): return self._v[0]
    def start_ns(self): return self._v[1]
    def duration_ns(self): return self._v[2]
    def device_type(self): return self._v[3]
    def start_thread_id(self): return self._v[4]
    def correlation_id(self): return self._v[5]
    def linked_correlation_id(self): return self._v[6]
    def sequence_nr(self): return self._v[7]
    def fwd_thread_id(self): return self._v[8]


def _kernel(name, start, dur, corr):
    return Ev(name, start, dur, CUDA, corr=corr, linked=1)


def _launch(start, corr, tid=1):
    return Ev("cudaLaunchKernel", start, MS // 100, tid=tid, corr=corr,
              linked=1)


def _events():
    """A window of 100 ms: one step (10-90 ms) under the benchmark's span:
    a forward op and its kernel, a loss op and its kernel, their backward
    nodes on the autograd thread (2) and the gradient's accumulation; one
    kernel launched after the step, one that starts before the window."""
    ev = [Ev("bench.window", 0, 100 * MS),
          Ev("bench.window", MS, 99 * MS, CUDA),
          Ev("bench.train.step", 5 * MS, 90 * MS),
          # forward: aten::mul (seq 5) at 12 ms, its kernel at 13-20 ms
          Ev("aten::mul", 12 * MS, MS, seq=5, corr=7),
          _launch(12 * MS + 10, 100),
          _kernel("mul_kernel", 13 * MS, 7 * MS, 100),
          # loss: aten::exp (seq 6) at 32 ms, its kernel at 33-36 ms
          Ev("aten::exp", 32 * MS, MS, seq=6, corr=8),
          _launch(32 * MS + 10, 101),
          _kernel("exp_kernel", 33 * MS, 3 * MS, 101),
          # backward on thread 2: ExpBackward0, MulBackward0, then the
          # accumulation (no sequence number)
          Ev("autograd::engine::evaluate_function: ExpBackward0", 50 * MS,
             2 * MS, tid=2, seq=6, fwd_tid=1, corr=9),
          Ev("ExpBackward0", 50 * MS + 5, MS, tid=2, seq=6, fwd_tid=1,
             corr=10),
          _launch(50 * MS + 100, 102, tid=2),
          _kernel("mul_kernel", 51 * MS, 4 * MS, 102),
          Ev("autograd::engine::evaluate_function: MulBackward0", 55 * MS,
             2 * MS, tid=2, seq=5, fwd_tid=1, corr=11),
          _launch(55 * MS + 100, 103, tid=2),
          _kernel("mul_kernel", 56 * MS, 6 * MS, 103),
          Ev("torch::autograd::AccumulateGrad", 62 * MS, MS, tid=2,
             corr=12),
          _launch(62 * MS + 100, 104, tid=2),
          _kernel("add_kernel", 63 * MS, 2 * MS, 104),
          # after the step, inside the benchmark's span only
          _launch(92 * MS, 105),
          _kernel("copy_kernel", 92 * MS + MS // 20, 2 * MS, 105),
          # a kernel that starts before the window, with no launch seen
          _kernel("early_kernel", -2 * MS, 3 * MS, 106)]
    return ev


ME = threading.get_native_id()
TIMELINE = [("step", None, ME, 10 * MS, 90 * MS),
            ("step.forward", "step", ME, 11 * MS, 30 * MS),
            ("step.loss", "step", ME, 31 * MS, 40 * MS),
            ("step.backward", "step", ME, 41 * MS, 80 * MS),
            ("plan.batch", None, 21, -50 * MS, 60 * MS),
            ("plan.chunk_try", "plan.chunks", 21, 20 * MS, 25 * MS),
            ("plan.batch", None, 22, 40 * MS, 140 * MS),
            ("pool.wait", None, ME, 4 * MS, 5 * MS)]


def _timeline(spans):
    return lambda a, b: [(n, p, tid, max(s, a), min(e, b))
                         for n, p, tid, s, e in spans if e > a and s < b]


class _Prof:
    def __init__(self, events):
        self.profiler = self
        self.kineto_results = self
        self._events = events

    def events(self):
        return self._events


def _trace(events):
    t = trace.Trace.__new__(trace.Trace)
    t.prof = _Prof(events)
    return t


GROUPS = {"conv_mul": ["mul_kernel"]}


def test_the_program_names_the_accepted_idle_gaps():
    old = _trace(_events()).summary(GROUPS)
    new = program.reduce(_events(), _timeline(TIMELINE), ME)
    bare = program.reduce(_events(), _timeline([]), ME)
    assert old["busy_s"] == pytest.approx(0.025)
    total = sum(v for _, v in old["idle_gaps"])
    for r in (new, bare):
        assert sum(v for _, v in r["idle_gaps"]) == pytest.approx(
            total, abs=1e-12)
    # without the program's spans the gaps read as the summary's
    assert dict(bare["idle_gaps"]) == pytest.approx(dict(old["idle_gaps"]))
    # each gap is named by the innermost span around its middle
    assert dict(new["idle_gaps"]) == pytest.approx({
        "bench.train.step": 0.012,               # 1-13 ms
        "step.forward": 0.013,                   # 20-33 ms
        "step.backward": 0.015 + 0.002 + 0.02705,  # 36-51, 55-56,
        #                                            62-63, 65-92.05 ms
        "no benchmark span": 0.00595})           # 94.05-100 ms
    assert new["program"] == {
        "plan.batch": {"count": 2, "seconds": pytest.approx(0.12),
                       "threads": 2},
        "plan.chunk_try": {"count": 1, "seconds": pytest.approx(0.005), "threads": 1},
        "pool.wait": {"count": 1, "seconds": pytest.approx(0.001), "threads": 1},
        "step": {"count": 1, "seconds": pytest.approx(0.08), "threads": 1},
        "step.backward": {"count": 1, "seconds": pytest.approx(0.039), "threads": 1},
        "step.forward": {"count": 1, "seconds": pytest.approx(0.019), "threads": 1},
        "step.loss": {"count": 1, "seconds": pytest.approx(0.009), "threads": 1}}
    assert bare["program"] == {} and dict(bare["device_by_span"]) == {
        program.NO_SPAN: pytest.approx(0.025)}


def test_device_by_span_follows_launches_and_backward_links():
    old = _trace(_events()).summary(GROUPS)
    by = dict(program.reduce(_events(), _timeline(TIMELINE),
                             ME)["device_by_span"])
    assert by == {"step.forward": pytest.approx(0.007),
                  "step.loss": pytest.approx(0.003),
                  "step.loss.bwd": pytest.approx(0.004),
                  "step.forward.bwd": pytest.approx(0.006),
                  "step.backward": pytest.approx(0.002),
                  program.NO_SPAN: pytest.approx(0.003)}
    assert sum(by.values()) == pytest.approx(
        sum(v for _, v in old["device_ops"]))
    # the spans of another thread (a plan worker's) name no launch
    other = [(n, p, 99, a, b) for n, p, _, a, b in TIMELINE]
    assert dict(program.reduce(_events(), _timeline(other),
                               ME)["device_by_span"]) == {
        program.NO_SPAN: pytest.approx(0.025)}


def test_innermost_names_nested_spans():
    at = program.innermost([(0, 100, "a"), (10, 50, "b"), (20, 30, "c"),
                            (60, 70, "d")])
    assert [at(t) for t in (-1, 5, 15, 25, 30, 55, 65, 100)] == \
        [None, "a", "b", "c", "b", "a", "d", None]


def _reader(name):
    spec = importlib.util.spec_from_file_location(
        "m_" + name.replace(".", "_"), os.path.join(METRICS, name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


class _Run:
    """What a reader finds of the run that calls it: its `Trace`."""

    def __init__(self, events):
        self.tracer = _trace(events)
        self.workload, self.seed = "test-cell", 1


def _read_in_run(read, spans, monkeypatch):
    """read(ctx) as `run.main` calls it: with a run in a calling frame and
    the program's `spans` as its timeline."""
    run = _Run(_events())
    monkeypatch.setattr(program, "program_timeline", _timeline(spans))
    return read({"trace": run.tracer.summary(GROUPS)})


@pytest.mark.parametrize("name,want", [
    ("plan_busy_pct.train", 60.0),     # 120 ms on 2 threads over 100 ms
    ("pool_wait_ms.train", 1.0),
    ("chunk_tries.train", 0.5),
    ("step_launch_pct.train", 80.0),
    ("loss_device_pct.train", 28.0)])  # 3 + 4 ms of 25 ms busy
def test_each_reader_reads_its_spans(name, want, tmp_path, monkeypatch):
    read = _reader(name)
    monkeypatch.setattr(program, "CACHE", str(tmp_path))
    assert _read_in_run(read, TIMELINE, monkeypatch) == pytest.approx(want)
    assert os.path.exists(tmp_path / "traces" /
                          "test-cell.seed1.program.json.gz")
    # a program without spans, a reader called with no run, no trace
    assert _read_in_run(read, [], monkeypatch) is None
    summary = _trace(_events()).summary(GROUPS)
    assert read({"trace": summary}) is None
    assert read({"trace": None}) is None


def test_a_tiny_traced_run_reads_the_loader():
    rc, res, err = run_tiny("occuseg-m64.train-b5", "--trace", "1")
    assert rc == 0, err
    assert {"plan_busy_pct.train", "pool_wait_ms.train",
            "chunk_tries.train", "step_launch_pct.train"} \
        <= set(res["metrics"])
    assert 0 < res["metrics"]["plan_busy_pct.train"]["value"] <= 100
    assert res["metrics"]["chunk_tries.train"]["value"] >= 1
