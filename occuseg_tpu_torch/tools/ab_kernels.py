"""Time the kernels of several checkouts of this repository against each
other on one card, in one call.

    python -m occuseg_tpu_torch.tools.ab_kernels OUT_DIR DIR_A DIR_B [...]
    python -m occuseg_tpu_torch.tools.ab_kernels --smoke OUT_DIR DIR_A ...

Each run is `chip_smoke.py`'s build and `[kernels]` phase (every kernel at
the bench plan's shapes, against its plain version) in a process of its
own, from the checkout's root; with --smoke, the whole `chip_smoke.py`
(every phase, end to end). The checkouts run in the order given and then
in reverse (A, B, B, A for two), so that a drift of the card's clocks over
the call falls on all of them alike. Prints the card's name and power
limit and each run's summary lines (per-step kernel sums and the BCE
lines; with --smoke also the `[slice]` requests, the `[train]` and
`[loop]` medians and busy shares); the full output of
run i goes to OUT_DIR/ab_<i>.log (smoke_<i>.log). Needs a CUDA card and
nvcc.
"""

from __future__ import annotations

import os
import subprocess
import sys

RUN = ("import sys, torch; sys.path.insert(0, '.'); import chip_smoke as cs; "
       "torch.backends.cuda.matmul.allow_tf32 = False; cs.phase_build(); "
       "cs.phase_kernels(torch.device('cuda', 0))")
SUMMARY = ("[kernels] per step", "[kernels] bce")
SMOKE_SUMMARY = SUMMARY + ("[slice] request", "[train] 9 steps",
                           "[train] device busy", "[loop] cli.main",
                           "[loop] device busy", "all phases passed")


def main(out_dir: str, roots, smoke: bool = False) -> int:
    os.makedirs(out_dir, exist_ok=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    cmd = ["chip_smoke.py"] if smoke else ["-c", RUN]
    keep = SMOKE_SUMMARY if smoke else SUMMARY
    rc = 0
    for i, root in enumerate(list(roots) + list(roots)[::-1]):
        r = subprocess.run([sys.executable, *cmd], cwd=root,
                           capture_output=True, text=True)
        name = f"{'smoke' if smoke else 'ab'}_{i}.log"
        with open(os.path.join(out_dir, name), "w") as f:
            f.write(r.stdout + r.stderr)
        print(f"run {i} ({root}) rc={r.returncode}", flush=True)
        for line in r.stdout.splitlines():
            if line.startswith(keep):
                print("  " + line[:160], flush=True)
        if r.returncode:
            print(r.stderr[-3000:])
            rc = 1
    return rc


if __name__ == "__main__":
    args = sys.argv[1:]
    smoke = args[:1] == ["--smoke"]
    args = args[1:] if smoke else args
    if len(args) < 2:
        raise SystemExit(__doc__)
    sys.exit(main(args[0], args[1:], smoke))
