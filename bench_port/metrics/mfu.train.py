"""The step's matrix work (the benchmark's own count from the window's
coordinates, `lib/work.py`: forward and backward products of every layer
and head) over the window's time and the card's float32 peak, in %."""


def read(ctx):
    w = ctx.get("work") or []
    if not w or "flops" not in w[0]:
        return None
    flops = sum(s["flops"] for s in w)
    return 100.0 * flops / (ctx["window_s"] * ctx["peaks"]["f32_flops"])
