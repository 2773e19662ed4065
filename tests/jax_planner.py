"""The JAX package's host planner for the port's tests, loaded steadily.

`occuseg_tpu.native._load()` runs `make -s` in `csrc/` at its first use in
every pytest-xdist worker and keeps a failure for the life of the process.
When a checkout leaves `csrc/native.cpp` newer than the tracked
`csrc/libocc_native.so`, every worker rebuilds the library at once. GNU ld
unlinks its output and writes it anew over some 60 ms, and from its first
byte the file is newer than the source: another worker's `make` then calls
it up to date and loads a truncated library. That worker has no planner for
the rest of the run (`build_plan_host` returns None, and tests that need it
fail or skip).

`heal()` clears such a kept failure and loads again, under a file lock in
the temp directory, retrying while another worker may still be linking.
This module heals when it is imported: every port test module that reaches
the JAX planner imports it, and xdist collects every test module in every
worker before it runs any test, so each worker heals before its first test.
`host_plan` and `host_plan_blocked` heal again and raise where the planner
is still missing, so a None plan is never passed on.
"""

from __future__ import annotations

import fcntl
import os
import tempfile
import time

from occuseg_tpu import native as jax_native


def heal(tries: int = 6) -> None:
    """Load the JAX planner library, clearing a failure an earlier load in
    this process kept; no-op when it is loaded."""
    if jax_native._lib is not None:
        return
    lock = os.path.join(tempfile.gettempdir(), "occuseg_tpu_native.lock")
    with open(lock, "w") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            for i in range(tries):
                jax_native._tried = False
                if jax_native._load() is not None:
                    return
                time.sleep(0.25 * (i + 1))
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def _require(plan, what: str):
    if plan is None:
        raise RuntimeError(f"{what}: the JAX package's native planner is "
                           f"unavailable in this process")
    return plan


def host_plan(coords, spec, normals=None):
    """`occuseg_tpu.native.plan.build_plan_host`, never None."""
    from occuseg_tpu.native.plan import build_plan_host
    heal()
    return _require(build_plan_host(coords, spec, normals), "build_plan_host")


def host_plan_blocked(coords, spec, ns: int):
    """`occuseg_tpu.native.blocked.build_plan_host_blocked`, never None."""
    from occuseg_tpu.native.blocked import build_plan_host_blocked
    heal()
    return _require(build_plan_host_blocked(coords, spec, ns),
                    "build_plan_host_blocked")


heal()
