"""Mean time the training thread blocked on `PlanPool.imap`'s next batch,
as the program times it (its `pool.wait` spans in the traced window;
`lib/program.py`), in ms a step."""

from bench_port.lib import program


def read(ctx):
    p = ((program.of(ctx) or {}).get("program") or {}).get("pool.wait")
    if not p or p["count"] <= 0:
        return None
    return 1e3 * p["seconds"] / p["count"]
