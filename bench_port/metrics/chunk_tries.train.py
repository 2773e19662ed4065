"""Chunk-plan attempts a batch: the program's `plan.chunk_try` spans over
its `plan.batch` spans in the traced window (`lib/program.py`; 1 where
every plan fits its first chunk budgets; each retry rebuilds every
rulebook)."""

from bench_port.lib import program


def read(ctx):
    prog = (program.of(ctx) or {}).get("program") or {}
    tries, batches = prog.get("plan.chunk_try"), prog.get("plan.batch")
    if not tries or not batches:
        return None
    return tries["count"] / batches["count"]
