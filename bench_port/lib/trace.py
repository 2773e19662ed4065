"""Spans of the benchmark's own calls into the program, and the reduction
of a `torch.profiler` trace of the measured window.

`Spans` keeps each span's host-clock duration by name; while a trace is
recorded it also marks the span in the trace (`record_function`), so an
idle gap of the device can be put down to what the host was doing. The
whole window is the span `bench.window`. `Trace.summary` reads the
profiler's events: the device's kernels, copies and fills as intervals,
the busy time as the length of their union inside the window, the device
time by kernel name, and the idle gaps by the innermost span around each
gap's middle.
"""

from __future__ import annotations

import contextlib
import gzip
import json
import os
import re
import time
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import torch

WINDOW = "bench.window"


class Spans:
    def __init__(self):
        self.durations: Dict[str, List[float]] = defaultdict(list)
        self.traced = False

    @contextlib.contextmanager
    def __call__(self, name: str):
        t = time.perf_counter()
        if self.traced:
            with torch.profiler.record_function("bench." + name):
                yield
        else:
            yield
        self.durations[name].append(time.perf_counter() - t)


def short_name(name: str) -> str:
    """A kernel's name without its template arguments and parameters."""
    n = re.sub(r"^void ", "", name).replace("(anonymous namespace)::", "")
    depth, out = 0, []
    for ch in n:
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth = max(depth - 1, 0)
        elif ch == "(" and depth == 0:
            break
        elif depth == 0:
            out.append(ch)
    return "".join(out).strip()[:96]


class Trace:
    """A profiler over the measured window (`start`, then `stop` after the
    device has finished the window's work)."""

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])

    def start(self):
        self.prof.__enter__()

    def stop(self):
        self.prof.__exit__(None, None, None)

    def _events(self) -> Tuple[List[Tuple[str, int, int]],
                               List[Tuple[str, int, int]]]:
        """(device intervals, benchmark spans) as (name, start ns, end
        ns)."""
        dev, host = [], []
        cuda = torch.autograd.DeviceType.CUDA
        for e in self.prof.profiler.kineto_results.events():
            name = e.name()
            s = e.start_ns()
            iv = (name, s, s + e.duration_ns())
            if name.startswith("bench."):
                if e.device_type() != cuda:
                    host.append(iv)
            elif e.device_type() == cuda and e.duration_ns() > 0:
                dev.append(iv)
        return dev, host

    def summary(self, groups: Dict[str, List[str]],
                out_path: Optional[str] = None) -> Dict:
        """busy_s and window_s, device seconds by kernel group, the top
        device operations and idle gaps (<= 10 each)."""
        dev, host = self._events()
        win = [h for h in host if h[0] == WINDOW]
        if not win:
            raise RuntimeError("the trace holds no window span")
        w0, w1 = win[0][1], win[0][2]
        ivs = sorted((max(s, w0), min(e, w1), n) for n, s, e in dev
                     if e > w0 and s < w1)
        merged: List[List[int]] = []
        for s, e, _ in ivs:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        busy = sum(e - s for s, e in merged)
        gaps, prev = [], w0
        for s, e in merged:
            if s > prev:
                gaps.append((prev, s))
            prev = max(prev, e)
        if w1 > prev:
            gaps.append((prev, w1))
        by_name: Dict[str, float] = defaultdict(float)
        by_group: Dict[str, float] = defaultdict(float)
        for s, e, n in ivs:
            by_name[short_name(n)] += (e - s) * 1e-9
            for g, pats in groups.items():
                if any(p in n for p in pats):
                    by_group[g] += (e - s) * 1e-9
        spans = [h for h in host if h[0] != WINDOW]
        gap_by: Dict[str, float] = defaultdict(float)
        for a, b in gaps:
            mid = (a + b) // 2
            around = [h for h in spans if h[1] <= mid <= h[2]]
            name = (min(around, key=lambda h: h[2] - h[1])[0]
                    if around else "no benchmark span")
            gap_by[name] += (b - a) * 1e-9
        out = {"busy_s": busy * 1e-9, "window_s": (w1 - w0) * 1e-9,
               "groups": dict(by_group),
               "device_ops": sorted(([k, v] for k, v in by_name.items()),
                                    key=lambda kv: -kv[1])[:10],
               "idle_gaps": sorted(([k, v] for k, v in gap_by.items()),
                                   key=lambda kv: -kv[1])[:10]}
        if out_path:
            os.makedirs(os.path.dirname(out_path), exist_ok=True)
            with gzip.open(out_path, "wt") as f:
                json.dump({"summary": out, "device": [
                    [short_name(n), s - w0, e - s] for s, e, n in ivs]}, f)
        return out
