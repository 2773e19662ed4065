"""Mean host time of building a batch's stem map: the program's
`plan.stem_map` spans in the traced window (`lib/program.py`) over their
count, in ms a batch. The map is built on the device at the stem's first
use in each step, so this is the time its launches hold the stepping
thread; their device time is `device_by_span`'s `plan.stem_map` row in
the program trace file."""

from bench_port.lib import program


def read(ctx):
    p = ((program.of(ctx) or {}).get("program") or {}).get("plan.stem_map")
    if not p or p["count"] <= 0:
        return None
    return 1e3 * p["seconds"] / p["count"]
