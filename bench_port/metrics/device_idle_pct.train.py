"""Share of the traced training window in which no kernel, copy or fill
ran on the device (the union of the profiler's device intervals), in %."""


def read(ctx):
    t = ctx.get("trace")
    if not t or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
