"""The MinkUNet34C cell and the data-parallel cell at a size a CPU test can
hold: whole runs (sound runs read correct, every planted fault reads not
correct), the work count's pairs against a brute-force count, and what
the new files import. The MinkUNet runs keep the cell's architecture with
narrow stages: the run's process swaps the program's preset
(`models/minkunet.MINKUNET34C`) for `SMALL` before `run.main` reads it,
and the configuration's model block names the same widths."""

from __future__ import annotations

import copy
import itertools
import json
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from bench_port.lib import faults, work_minkunet
from test_bench_imports import FORBIDDEN, PRELUDE, REPORT, _loaded
from tiny import OVERRIDES, ROOT

SEMANTIC = "minkunet34c.train-b8"
DP = "occuseg-m64.train-dp4"
SMALL = {"init_dim": 8, "layers": [1, 1, 1, 1, 1, 1, 1, 1],
         "planes": [16, 16, 32, 32, 32, 16, 16, 16], "stem_kernel": 5}
MINK = {
    "config": {"flags": ["--arch", "minkunet34c", "--scale", "10",
                         "--use_feature", "c", "--optim", "SGD", "--lr",
                         "0.1", "--batch_size", "2", "--voxel_cap", "6144",
                         "--point_cap", "6144", "--plan_workers", "2"],
               "model": dict(SMALL, in_features=3, classes=20)},
    "cell": {"pool_rooms": 3, "room_points": [2000, 3000], "batches": 6,
             "limits": {"loss_gap": 2e-3, "grad_gap": 0.01,
                        "change_gap": 0.1, "bnstat_gap": 5e-6}}}
DP_OV = copy.deepcopy(OVERRIDES["occuseg-m64.train-b5"])
DP_OV["cell"]["limits"]["rank_gap"] = 0.0


def run_small(workload, *args, overrides, seed=3000000019, seconds=1.0,
              before=""):
    """(exit code, the result line or None, stderr) of a run on the CPU in
    its own process, with the MinkUNet preset narrowed to SMALL (and the
    statements `before` run first)."""
    argv = ["--workload", workload, "--seed", str(seed), "--seconds",
            str(seconds), *args]
    code = (
        "import json, sys\n"
        f"sys.path.insert(0, {ROOT!r})\n"
        "from occuseg_tpu_torch.models import minkunet\n"
        f"minkunet.MINKUNET34C.update(json.loads({json.dumps(SMALL)!r}))\n"
        + before +
        "from bench_port import run\n"
        f"sys.exit(run.main({argv!r}, check_device=False, device='cpu', "
        f"overrides=json.loads({json.dumps(overrides)!r})))\n")
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=ROOT, timeout=900)
    lines = p.stdout.strip().splitlines()
    res = json.loads(lines[-1]) if p.returncode == 0 and lines else None
    return p.returncode, res, p.stderr


@pytest.mark.parametrize("workload,ov", [(SEMANTIC, MINK), (DP, DP_OV)])
def test_a_sound_run_is_correct(workload, ov):
    rc, res, err = run_small(workload, overrides=ov)
    assert rc == 0, err
    assert res["correct"], res["checks"]
    assert {"setup_s", "train_voxels_per_s"} <= set(res["metrics"])
    assert res["attempted"] >= 1


@pytest.mark.parametrize("workload,ov,fault", [
    (w, ov, f) for (w, ov), f in itertools.product(
        [(SEMANTIC, MINK), (DP, DP_OV)], faults.TRAIN)])
def test_a_fault_reads_not_correct(workload, ov, fault):
    rc, res, err = run_small(workload, "--fault", fault, overrides=ov)
    assert rc == 0, err
    assert res["correct"] is False, res["checks"]


def test_a_traced_minkunet_run_reads_its_layers():
    rc, res, err = run_small(SEMANTIC, "--trace", "1", overrides=MINK)
    assert rc == 0, err
    # on the CPU the profiler records no device kernels: the readers of
    # device time leave their metrics out
    assert {"stem_plan_ms.train", "mfu.train", "step_launch_pct.train",
            "plan_busy_pct.train", "chunk_tries.train", "plan_wait_ms.train",
            "pool_wait_ms.train"} <= set(res["metrics"])
    assert res["metrics"]["stem_plan_ms.train"]["value"] > 0


def test_a_traced_dp_run_reads_its_layers():
    rc, res, err = run_small(DP, "--trace", "1", overrides=DP_OV)
    assert rc == 0, err
    # rank 0's loader, step and work, in the traced process
    assert {"step_launch_pct.train", "mfu.train", "plan_wait_ms.train",
            "plan_busy_pct.train", "pool_wait_ms.train",
            "chunk_tries.train"} <= set(res["metrics"])
    assert res["info"]["ranks"] == 4 and res["info"]["backend"] == "gloo"


def test_a_program_without_the_core_share_fails_at_once():
    """A program that does not share the host's cores among its ranks
    (`data_parallel.share_cores`; the parent of this cell) stops before
    any rank starts, so no rank waits for another."""
    t0 = time.perf_counter()
    rc, res, err = run_small(DP, overrides=DP_OV, before=(
        "from occuseg_tpu_torch.parallel import data_parallel\n"
        "del data_parallel.share_cores\n"))
    assert rc != 0 and res is None
    assert "share_cores" in err
    assert time.perf_counter() - t0 < 60   # a whole tiny run takes minutes


def test_a_program_without_the_arch_fails_at_once():
    """A program whose CLI has no --arch (the parent of this cell) exits
    at its flags, before any set-up."""
    ov = copy.deepcopy(MINK)
    ov["config"]["flags"] = ["--no_such_flag"] + ov["config"]["flags"]
    rc, res, err = run_small(SEMANTIC, overrides=ov)
    assert rc == 2 and res is None
    assert "unrecognized arguments" in err


def _brute(coords: np.ndarray, levels: int, kernel: int):
    sites = {tuple(c) for c in coords.tolist() if c[0] >= 0}
    h = kernel // 2
    stem = sum((b, z + dz, y + dy, x + dx) in sites
               for b, z, y, x in sites
               for dz, dy, dx in itertools.product(range(-h, h + 1),
                                                   repeat=3))
    counts, pairs = [], []
    for _ in range(levels):
        counts.append(len(sites))
        pairs.append(sum((b, z + dz, y + dy, x + dx) in sites
                         for b, z, y, x in sites
                         for dz, dy, dx in itertools.product((-1, 0, 1),
                                                             repeat=3)))
        sites = {(b, z // 2, y // 2, x // 2) for b, z, y, x in sites}
    return counts, pairs, stem


def test_pairs_match_a_brute_force_count():
    rng = np.random.default_rng(1)
    c = np.concatenate([rng.integers(0, 2, (500, 1)),
                        rng.integers(0, 14, (500, 3))], axis=1)
    c = np.concatenate([c, np.full((4, 4), -1)]).astype(np.int32)
    cfg = dict(SMALL, in_features=3, classes=20)
    got = work_minkunet.level_counts(torch.as_tensor(c), cfg)
    sites, pairs, stem = _brute(c, 5, 5)
    assert got["sites"] == sites and got["pairs"] == pairs
    assert got["stem_pairs"] == stem


def test_a_step_counts_every_layer():
    """MinkUNet34C's forward MulAdds a voxel with every neighbour present
    and each level a quarter of the one above, as a surface's (about 1.8M,
    1.1M of them at level 0), and the training step's passes: three a
    product, two for the stem."""
    cfg = {"in_features": 3, "classes": 20, "init_dim": 32,
           "layers": [2, 3, 4, 6, 2, 2, 2, 2],
           "planes": [32, 64, 128, 256, 256, 128, 96, 96], "stem_kernel": 5}
    n = [4 ** (6 - l) for l in range(5)]
    counts = {"sites": n, "pairs": [27 * x for x in n],
              "stem_pairs": 125 * n[0], "points": n[0]}
    prods = work_minkunet.products(cfg, counts)
    muladds = sum(p["pairs"] * p["cin"] * p["cout"] for p in prods)
    level0 = sum(p["pairs"] * p["cin"] * p["cout"] for p in prods
                 if p["rows_out"] == n[0] and p["rows_in"] == n[0])
    assert 1.8e6 < muladds / n[0] < 1.9e6
    assert 1.0e6 < level0 / n[0] < 1.2e6
    peaks = {"f32_flops": 67e12, "hbm_bytes_per_s": 3.35e12}
    fwd = work_minkunet.step_work(cfg, counts, False, peaks)
    trn = work_minkunet.step_work(cfg, counts, True, peaks)
    stem = 2.0 * 125 * n[0] * 3 * 32
    assert trn["flops"] == pytest.approx(3 * fwd["flops"] - stem)
    assert 0 < trn["stem_bound_s"] == fwd["stem_bound_s"]


def test_the_new_files_import_no_jax():
    code = PRELUDE + (
        "import glob, importlib.util\n"
        "import bench_port.traffic.train_semantic, bench_port.traffic.train_dp\n"
        "import bench_port.lib.work_minkunet\n"
        "import occuseg_tpu_torch.models.minkunet\n"
        "for n in ('stem_plan_ms.train', 'stem_roofline.train',\n"
        "          'allreduce_pct.dp'):\n"
        f"    f = {ROOT!r} + '/bench_port/metrics/' + n + '.py'\n"
        "    s = importlib.util.spec_from_file_location('m', f)\n"
        "    s.loader.exec_module(importlib.util.module_from_spec(s))\n"
    ) + REPORT
    loaded = _loaded(code)
    assert "occuseg_tpu_torch" in loaded
    assert not loaded & FORBIDDEN


def test_the_new_references_import_nothing_of_the_program():
    code = PRELUDE + (
        "import bench_port.reference.minkunet\n"
        "import bench_port.reference.train_dp\n"
    ) + REPORT
    loaded = _loaded(code)
    assert not loaded & (FORBIDDEN | {"occuseg_tpu_torch"})
