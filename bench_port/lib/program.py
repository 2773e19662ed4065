"""The program's own spans in a traced run, for the readers of `metrics/`
that read them.

`lib/trace.py` reduces the profiler's trace of the measured window to the
device's busy time, its kernels and its idle gaps named by the
benchmark's spans. This module reads, for the same window, what the
program records of itself (`occuseg_tpu_torch/utils/profiling.py`, where
the program has it): the spans that every thread of the program ran while
the profiler recorded, on `time.time_ns()`, the clock of the profiler's
events. `of(ctx)` gives, once a run:

- `program`: for each span name, its count, host seconds and distinct
  threads inside the window (spans clipped to it);
- `device_by_span` (<= 10 rows): device seconds by the innermost program
  span of the stepping thread (the run's own, which enters the window)
  around each kernel's launch (the CUDA runtime call that the kernel's
  correlation id links to). A kernel launched by a backward node whose
  forward op the profiler links to it (the op's `sequence_nr` and
  `fwd_thread_id`) goes to that forward op's span with `.bwd` appended;
  other backward kernels stay under `step.backward`, and kernels outside
  any span go under "no program span". Every kernel counts, clipped to the
  window, as in the summary's `device_ops`;
- `idle_gaps` (<= 10 rows): the summary's idle gaps, with the same total,
  each named by the innermost of the benchmark's spans and the stepping
  thread's program spans around the gap's middle.

These are written to `.bench_cache/traces/<cell>.seed<n>.program.json.gz`
beside the summary's trace file. A reader is handed the context alone, so
the profiler's events are reached through the run that calls it: the
frame of `run.main` holds the run, and the run its `Trace`. Where there
is no such run (a reader called on its own), or the program records no
spans (a program without `utils/profiling.timeline`), `program` is empty,
the device time is under "no program span", and the readers of program
spans leave their metrics out.
"""

from __future__ import annotations

import gzip
import json
import os
import sys
import threading
import weakref
from bisect import bisect_right
from collections import defaultdict
from typing import Callable, Dict, Iterable, List, Optional, Tuple

import torch

from bench_port.lib.trace import WINDOW, Trace

NO_SPAN = "no program span"
NO_GAP_SPAN = "no benchmark span"      # as the summary names such gaps
CACHE = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), ".bench_cache")

_DONE = weakref.WeakKeyDictionary()      # Trace -> of()'s result


def program_timeline(since_ns: int, until_ns: int) -> List[Tuple]:
    """The program's spans (name, parent, native thread id, start ns, end
    ns) recorded while the profiler ran, clipped to the window; none where
    the program records none."""
    try:
        from occuseg_tpu_torch.utils.profiling import timeline
    except ImportError:
        return []
    return timeline(since_ns, until_ns)


def innermost(spans: Iterable[Tuple[int, int, object]]
              ) -> Callable[[int], Optional[object]]:
    """t -> the label of the innermost of `spans` ((start, end, label),
    nested) that holds t, or None."""
    starts: List[int] = []
    labels: List[object] = []
    open_: List[Tuple[int, object]] = []   # (end, label), innermost last

    def mark(t, label):
        starts.append(max(t, starts[-1]) if starts else t)
        labels.append(label)

    def close_until(t):
        while open_ and open_[-1][0] <= t:
            end = open_.pop()[0]
            mark(end, open_[-1][1] if open_ else None)

    for s, e, label in sorted(spans, key=lambda x: (x[0], -x[1])):
        close_until(s)
        open_.append((e, label))
        mark(s, label)
    close_until(float("inf"))

    def at(t: int):
        i = bisect_right(starts, t) - 1
        return labels[i] if i >= 0 else None
    return at


def _top(d: Dict[str, float]) -> List[List]:
    return sorted(([k, v] for k, v in d.items()), key=lambda kv: -kv[1])[:10]


def reduce(events, timeline: Callable[[int, int], List[Tuple]],
           thread: int) -> Dict:
    """`program`, `device_by_span` and `idle_gaps` (module docstring) of
    the profiler's `events`, with the program's `timeline` and the native
    id of the stepping `thread`."""
    cuda = torch.autograd.DeviceType.CUDA
    window = None
    bench: List[Tuple[int, int, str]] = []
    kernels: List[Tuple[int, int, int]] = []
    launches: Dict[int, Tuple[int, int]] = {}     # corr -> (start, thread)
    fwd: Dict[Tuple[int, int], int] = {}          # (thread, seq) -> start
    bwd: Dict[int, List] = defaultdict(list)      # thread -> nodes
    for e in events:
        name, s, d = e.name(), e.start_ns(), e.duration_ns()
        if e.device_type() == cuda:
            # the device intervals of `Trace._events`
            if not name.startswith("bench.") and d > 0:
                kernels.append((s, s + d, e.correlation_id()))
        elif name.startswith("bench."):
            if name == WINDOW:
                window = window or (s, s + d)
            else:
                bench.append((s, s + d, name))
        elif e.linked_correlation_id() > 0 or name.startswith("cu"):
            launches[e.correlation_id()] = (s, e.start_thread_id())
        elif e.sequence_nr() >= 0:
            if e.fwd_thread_id() > 0:
                bwd[e.start_thread_id()].append(
                    (s, s + d, (e.sequence_nr(), e.fwd_thread_id())))
            else:
                fwd.setdefault((e.start_thread_id(), e.sequence_nr()), s)
    if window is None:
        raise RuntimeError("the trace holds no window span")
    w0, w1 = window
    spans = timeline(w0, w1)
    steps = [(a, b, n) for n, _, tid, a, b in spans if tid == thread]
    in_step = innermost(steps)
    nodes = {t: innermost(v) for t, v in bwd.items()}

    by_span: Dict[str, float] = defaultdict(float)
    ivs = []
    for s, e, corr in kernels:
        if e <= w0 or s >= w1:
            continue
        s, e = max(s, w0), min(e, w1)
        ivs.append((s, e))
        t, tid = launches.get(corr, (s, None))
        label = None
        node = nodes[tid](t) if tid in nodes else None
        if node is not None and (node[1], node[0]) in fwd:
            f = in_step(fwd[(node[1], node[0])])
            label = f + ".bwd" if f else None
        by_span[label or in_step(t) or NO_SPAN] += (e - s) * 1e-9

    # the idle gaps of `Trace.summary`, named by the benchmark's spans and
    # the stepping thread's program spans
    gaps, prev = [], w0
    for s, e in sorted(ivs):
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    if w1 > prev:
        gaps.append((prev, w1))
    around = innermost([(a, b, n) for a, b, n in bench + steps])
    gap_by: Dict[str, float] = defaultdict(float)
    for a, b in gaps:
        gap_by[around((a + b) // 2) or NO_GAP_SPAN] += (b - a) * 1e-9

    acc: Dict[str, list] = {}
    for n, _, tid, a, b in spans:
        c = acc.setdefault(n, [0, 0, set()])
        c[0] += 1
        c[1] += b - a
        c[2].add(tid)
    return {"program": {n: {"count": c, "seconds": ns * 1e-9,
                            "threads": len(t)}
                        for n, (c, ns, t) in sorted(acc.items())},
            "device_by_span": _top(by_span),
            "idle_gaps": _top(gap_by)}


def _run_on_stack():
    """The run (with its `Trace`) or the `Trace` that a calling frame
    holds, or None."""
    f = sys._getframe(1)
    while f is not None:
        for v in list(f.f_locals.values()):
            if isinstance(v, Trace):
                return None, v
            if isinstance(getattr(v, "tracer", None), Trace):
                return v, v.tracer
        f = f.f_back
    return None


def of(ctx: Dict) -> Optional[Dict]:
    """`reduce` of the traced run that called the reader, once a run, and
    written beside its trace file; None without a trace."""
    if not ctx.get("trace"):
        return None
    found = _run_on_stack()
    if found is None:
        return None
    run, tracer = found
    if tracer not in _DONE:
        out = reduce(tracer.prof.profiler.kineto_results.events(),
                     program_timeline, threading.get_native_id())
        _DONE[tracer] = out
        if run is not None:
            path = os.path.join(CACHE, "traces", f"{run.workload}.seed"
                                f"{run.seed}.program.json.gz")
            os.makedirs(os.path.dirname(path), exist_ok=True)
            with gzip.open(path, "wt") as f:
                json.dump(out, f)
    return _DONE[tracer]
