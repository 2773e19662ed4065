"""The stem convolution's forward least time over the window (per step,
max(operations / float32 peak, bytes / memory bandwidth) of the stem's
product with its real Cin, from `lib/work_minkunet.py`) over the device
time of the kernels launched inside the program's `model.stem` spans (its
child `plan.stem_map`, the map's build, excluded), in %. The device time
is `lib/program.py`'s `device_by_span` reduction over the stem's spans
alone, so that the row cannot fall out of the top ten."""

import threading

from bench_port.lib import program

SPANS = ("model.stem", "plan.stem_map")


def read(ctx):
    w = ctx.get("work") or []
    if not w or "stem_bound_s" not in w[0] or not ctx.get("trace"):
        return None
    found = program._run_on_stack()
    if found is None:
        return None
    events = found[1].prof.profiler.kineto_results.events()
    by_span = dict(program.reduce(
        events, lambda a, b: [s for s in program.program_timeline(a, b)
                              if s[0] in SPANS],
        threading.get_native_id())["device_by_span"])
    dev = by_span.get("model.stem", 0.0)
    if dev <= 0:
        return None
    return 100.0 * sum(s["stem_bound_s"] for s in w) / dev
