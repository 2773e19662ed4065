"""The least time of the window's convolution work (per product,
max(operations / float32 peak, bytes / memory bandwidth), from
`lib/work.py`) over the device time of the kernels of the
`kernels/conv*.json` groups in the traced window, in %."""


def read(ctx):
    w, t = ctx.get("work") or [], ctx.get("trace")
    if not w or "conv_bound_s" not in w[0] or not t:
        return None
    dev = sum(v for g, v in t["groups"].items() if g.startswith("conv"))
    if dev <= 0:
        return None
    return 100.0 * sum(s["conv_bound_s"] for s in w) / dev
