"""Share of the device's busy time spent on the loss
(`losses/instance.occuseg_total_loss`): the device seconds of kernels
launched under the program's span `step.loss` or by the backward of its
ops (`step.loss.bwd`; `lib/program.py`'s `device_by_span`) over
`busy_s`, in %."""

from bench_port.lib import program


def read(ctx):
    t = ctx.get("trace") or {}
    by_span = dict((program.of(ctx) or {}).get("device_by_span") or [])
    if "step.loss" not in by_span and "step.loss.bwd" not in by_span:
        return None
    if t["busy_s"] <= 0:
        return None
    return 100.0 * (by_span.get("step.loss", 0.0)
                    + by_span.get("step.loss.bwd", 0.0)) / t["busy_s"]
