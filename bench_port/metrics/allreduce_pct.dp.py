"""Share of rank 0's device busy time in the NCCL kernels of the
data-parallel all-reduce (the `kernels/nccl.json` group) in the traced
window, in %."""


def read(ctx):
    t = ctx.get("trace")
    if not t or t["busy_s"] <= 0:
        return None
    dev = t["groups"].get("nccl", 0.0)
    if dev <= 0:
        return None
    return 100.0 * dev / t["busy_s"]
