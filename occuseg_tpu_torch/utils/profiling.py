"""The port's spans and counters, and its MulAdd and hidden-state counters.

Spans and counters (process-wide, thread-safe):

    with span("step.forward"):
        ...
    count("plan.tier_raised")
    snapshot()                     # totals, counters, kernel launches
    timeline(t0_ns, t1_ns)         # spans recorded while a profiler ran

A span always adds its count and host seconds to its name's totals. While
a `torch.profiler` records (`torch.autograd.profiler._is_profiler_enabled`)
it also appends (name, parent span, native thread id, start ns, end ns) to
an in-memory timeline on `time.time_ns()`, the clock of the profiler's
events, so a reader of the trace puts a launch or an idle gap inside a
span by its time. A span enters no `record_function`: the profiler would
record one only on the thread that started it, and would mark its range
on the device too, as a CUDA event beside the kernels. A span that
straddles the profiler's start or stop is kept whole; `timeline` clips it
to the window asked for. With no profiler a span costs a flag test, two
clock reads and a locked update, so spans mark the layers of a step or a
batch, not kernels or modules, which the profiler names itself.

MulAdd and hidden-state counters (counterpart of the counters of
`occuseg_tpu/utils/profiling.py`): exact counts from a host plan, where
only real rulebook pairs count, as the reference accumulates them per
operation, and their per-epoch sums.
"""

from __future__ import annotations

import collections
import dataclasses
import threading
import time
from typing import TYPE_CHECKING, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.autograd.profiler as _autograd_profiler

if TYPE_CHECKING:
    from occuseg_tpu_torch.core.topology import Topology

# (name, parent span or None, native thread id, start ns, end ns)
Interval = Tuple[str, Optional[str], int, int, int]


def profiler_enabled() -> bool:
    """Whether a `torch.profiler` is recording in this process."""
    return getattr(_autograd_profiler, "_is_profiler_enabled", False)


class _Recorder:
    """The totals, counters and timeline behind `span`, `record`, `count`,
    `snapshot` and `timeline`. The timeline keeps the newest `maxlen`
    intervals."""

    def __init__(self, maxlen: int = 1 << 20):
        self.lock = threading.Lock()
        self.totals: Dict[str, List] = {}      # name -> [count, seconds]
        self.counters: Dict[str, int] = collections.defaultdict(int)
        self.intervals: collections.deque = collections.deque(maxlen=maxlen)
        self.local = threading.local()

    def stack(self) -> List[str]:
        st = getattr(self.local, "stack", None)
        if st is None:
            st = self.local.stack = []
        return st

    def add(self, name: str, parent: Optional[str], t0: int, t1: int,
            traced: bool) -> float:
        sec = (t1 - t0) * 1e-9
        with self.lock:
            tot = self.totals.get(name)
            if tot is None:
                self.totals[name] = [1, sec]
            else:
                tot[0] += 1
                tot[1] += sec
            if traced:
                self.intervals.append((name, parent,
                                       threading.get_native_id(), t0, t1))
        return sec


_REC = _Recorder()


class span:
    """A span of the port's host work, as a context manager; `seconds`
    holds its duration after it exits."""

    __slots__ = ("name", "seconds", "_t0", "_traced")

    def __init__(self, name: str):
        self.name = name
        self.seconds = 0.0

    def __enter__(self) -> "span":
        _REC.stack().append(self.name)
        self._traced = profiler_enabled()
        self._t0 = time.time_ns()
        return self

    def __exit__(self, *exc) -> None:
        t1 = time.time_ns()
        stack = _REC.stack()
        stack.pop()
        self.seconds = _REC.add(self.name, stack[-1] if stack else None,
                                self._t0, t1,
                                self._traced or profiler_enabled())


def record(name: str, t0_ns: int, t1_ns: int) -> float:
    """A span that ran from t0_ns to t1_ns (`time.time_ns()`) on this
    thread, recorded after the fact; returns its seconds."""
    stack = _REC.stack()
    return _REC.add(name, stack[-1] if stack else None, t0_ns, t1_ns,
                    profiler_enabled())


def count(name: str, n: int = 1) -> None:
    """Add n to the always-on counter `name`."""
    with _REC.lock:
        _REC.counters[name] += n


# counts still on their way from a device: (name, host copy, event)
_PENDING: collections.deque = collections.deque()


def count_tensor(name: str, n) -> None:
    """Add the 0-d integer tensor `n` to counter `name` without making the
    host wait for its device: a device value is copied to the host behind
    the work already queued, and added once that copy has run (at a later
    `count_tensor`, or at `snapshot`, which waits for it)."""
    if not n.is_cuda:
        count(name, int(n))
        return
    host = torch.empty((), dtype=n.dtype, pin_memory=True)
    host.copy_(n, non_blocking=True)
    done = torch.cuda.Event()
    done.record()
    with _REC.lock:
        _PENDING.append((name, host, done))
    _fold_pending(wait=False)


def _fold_pending(wait: bool) -> None:
    """Add the pending device counts whose copies have run (all of them,
    waiting, with `wait`)."""
    while True:
        with _REC.lock:
            if not _PENDING:
                return
            name, host, done = _PENDING[0]
            if not wait and not done.query():
                return
            _PENDING.popleft()
        done.synchronize()
        count(name, int(host))


def launch_counters() -> Tuple[Tuple[str, object, str], ...]:
    """(name, wrapper, attribute) of every kernel wrapper's launch
    counter."""
    from occuseg_tpu_torch.ops.kernels import bce_loss
    from occuseg_tpu_torch.ops.kernels import chunk_conv as cc
    from occuseg_tpu_torch.ops.kernels import gather_conv as gc
    from occuseg_tpu_torch.ops.kernels import segsum
    return (("chunk_conv", cc.chunk_conv, "launches"),
            ("chunk_conv_bwd_fused", cc.chunk_conv_bwd_fused, "launches"),
            ("chunk_conv_bwd_fused_kgrouped", cc.chunk_conv_bwd_fused,
             "launches_kgrouped"),
            ("chunk_conv_dw", cc.chunk_conv_dw, "launches"),
            ("chunk_conv_f32_tc", cc.chunk_conv, "launches_f32_tc"),
            ("chunk_conv_f32_fma", cc.chunk_conv, "launches_f32_fma"),
            ("chunk_conv_dw_f32_tc", cc.chunk_conv_dw, "launches_f32_tc"),
            ("chunk_conv_dw_f32_fma", cc.chunk_conv_dw, "launches_f32_fma"),
            ("chunk_conv_bwd_fused_f32_tc", cc.chunk_conv_bwd_fused,
             "launches_f32_tc"),
            ("chunk_conv_bwd_fused_f32_fma", cc.chunk_conv_bwd_fused,
             "launches_f32_fma"),
            ("blocked_segment_sum", segsum.blocked_segment_sum, "launches"),
            ("bce_radius", bce_loss.radius_sq, "launches"),
            ("bce_fwd", bce_loss.bce_sums, "launches"),
            ("bce_bwd", bce_loss.bce_sums_bwd, "launches"),
            ("gather_conv", gc.gather_conv, "launches"))


def snapshot() -> Dict[str, Dict]:
    """{"spans": {name: {"count", "seconds"}}, "counters": {name: n},
    "launches": {kernel: the wrapper's own launch counter}}."""
    _fold_pending(wait=True)
    with _REC.lock:
        spans = {k: {"count": c, "seconds": s}
                 for k, (c, s) in _REC.totals.items()}
        counters = dict(_REC.counters)
    return {"spans": spans, "counters": counters,
            "launches": {name: getattr(fn, attr)
                         for name, fn, attr in launch_counters()}}


def timeline(since_ns: int, until_ns: int) -> List[Interval]:
    """The spans recorded while a profiler ran that overlap [since_ns,
    until_ns] (`time.time_ns()`), clipped to it, in the order they
    ended."""
    with _REC.lock:
        ivs = list(_REC.intervals)
    return [(n, p, tid, max(a, since_ns), min(b, until_ns))
            for n, p, tid, a, b in ivs if b > since_ns and a < until_ns]


def plan_muladd_count(plan: Topology, n_planes: Sequence[int],
                      block_reps: int = 1, residual: bool = True,
                      input_channels: int = 3) -> int:
    """MulAdds of one UNet forward on this plan: the input convolution,
    per level `block_reps` blocks of two (residual) or one submanifold
    convolutions, the strided convolution and deconvolution pairs, and the
    decoder blocks at twice the width for their first rep (with the NIN
    shortcut where widths differ)."""
    from occuseg_tpu_torch.ops.conv import conv_flops
    L = len(n_planes)

    def sub(level, cin, cout):
        return conv_flops(plan.levels[level].nbr, cin, cout)

    def nin_pairs(level, cin, cout):
        return int(np.sum(plan.levels[level].num_active)) * cin * cout

    total = sub(0, input_channels, n_planes[0])
    for l in range(L):
        a = n_planes[l]
        for _ in range(block_reps):
            total += (2 if residual else 1) * sub(l, a, a)
        if l < L - 1:
            tr = plan.transitions[l]
            total += conv_flops(tr.child, a, n_planes[l + 1])
            total += conv_flops(tr.up, n_planes[l + 1], a)
            for i in range(block_reps):
                cin = a * (2 if i == 0 else 1)
                if residual:
                    total += sub(l, cin, a) + sub(l, a, a)
                    if cin != a:
                        total += nin_pairs(l, cin, a)
                else:
                    total += sub(l, cin, a)
    return total


def plan_hidden_count(plan: Topology, n_planes: Sequence[int]) -> int:
    """Hidden states: active rows times width, summed over the levels."""
    return sum(int(np.sum(lvl.num_active))
               * n_planes[min(l, len(n_planes) - 1)]
               for l, lvl in enumerate(plan.levels))


@dataclasses.dataclass
class CounterState:
    muladd: float = 0.0
    hidden: float = 0.0
    scenes: int = 0

    def add(self, muladd: int, hidden: int, scenes: int = 1) -> None:
        self.muladd += muladd
        self.hidden += hidden
        self.scenes += scenes

    def report(self) -> str:
        s = max(self.scenes, 1)
        return (f"MegaMulAdd={self.muladd / s / 1e6:.1f}/scene "
                f"MegaHidden={self.hidden / s / 1e6:.1f}/scene")
