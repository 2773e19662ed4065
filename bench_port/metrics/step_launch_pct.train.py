"""Share of the traced window the training thread spent inside
`Trainer.step` (the program's `step` spans, `lib/program.py`: the upload,
the launches of the forward, loss and backward, and Adam, with the waits
inside them), in %."""

from bench_port.lib import program


def read(ctx):
    t = ctx.get("trace") or {}
    p = ((program.of(ctx) or {}).get("program") or {}).get("step")
    if not p or t["window_s"] <= 0:
        return None
    return 100.0 * p["seconds"] / t["window_s"]
