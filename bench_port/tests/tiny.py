"""Runs of the benchmark at a size a CPU test can hold: the cells' files
with small models, rooms and caps merged over them, each run in its own
process (`run.main` with the look for a chip skipped)."""

from __future__ import annotations

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
PLANES = [16, 32, 48, 64, 80, 96]
CAPS = ["--batch_size", "2", "--instance_cap", "16", "--voxel_cap", "24576",
        "--point_cap", "6144", "--plan_workers", "2"]
OVERRIDES = {
    "occuseg-m64.train-b5": {
        "config": {"flags": ["--m", "16", "--use_dense_model",
                             "--residual_blocks", "--block_reps", "1",
                             "--scale", "50"] + CAPS,
                   "model": {"planes": PLANES, "block_reps": 1,
                             "residual": True, "in_features": 3,
                             "classes": 20, "heads": "bw"}},
        # rooms of a few thousand points: the loss's sample radius and
        # its instance sizes are small, so rounding that moves a point
        # across a threshold weighs more than at the cell's size; the
        # loss and the change get limits of their own, the other two
        # numbers keep the cell's
        "cell": {"pool_rooms": 3, "room_points": [2000, 3000],
                 "batches": 6,
                 "limits": {"loss_gap": 2e-3, "grad_gap": 0.01,
                            "change_gap": 0.1, "bnstat_gap": 5e-6}}}
}


def run_tiny(workload: str, *args: str, device: str = "cpu",
             seed: int = 3000000007, seconds: float = 1.0,
             overrides=None):
    """(exit code, the result line as a dict or None, stderr)."""
    ov = OVERRIDES[workload] if overrides is None else overrides
    argv = ["--workload", workload, "--seed", str(seed), "--seconds",
            str(seconds), *args]
    code = (
        "import json, sys\n"
        f"sys.path.insert(0, {ROOT!r})\n"
        "from bench_port import run\n"
        f"sys.exit(run.main({argv!r}, "
        f"check_device=False, device={device!r}, "
        f"overrides=json.loads({json.dumps(ov)!r})))\n")
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=ROOT, timeout=900)
    lines = p.stdout.strip().splitlines()
    res = json.loads(lines[-1]) if p.returncode == 0 and lines else None
    return p.returncode, res, p.stderr
