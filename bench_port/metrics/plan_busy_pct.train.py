"""Share of the plan workers' time spent preparing batches: the seconds of
the program's `plan.batch` spans in the traced window (clipped to it;
`lib/program.py`) over the window times the number of threads that ran
them, in %."""

from bench_port.lib import program


def read(ctx):
    t = ctx.get("trace") or {}
    p = ((program.of(ctx) or {}).get("program") or {}).get("plan.batch")
    if not p or t["window_s"] <= 0:
        return None
    return 100.0 * p["seconds"] / (t["window_s"] * p["threads"])
