"""The work count against a brute-force count and the program's own
counter on the same scene."""

import itertools

import numpy as np
import pytest
import torch

from bench_port.lib import scenes, work

CFG = {"planes": [16, 32, 48], "block_reps": 2, "residual": True,
       "in_features": 3, "classes": 20, "heads": "bw"}


def _brute_pairs(coords: np.ndarray, levels: int):
    sites = {tuple(c) for c in coords.tolist() if c[0] >= 0}
    pairs, counts = [], []
    for _ in range(levels):
        counts.append(len(sites))
        pairs.append(sum((b, z + dz, y + dy, x + dx) in sites
                         for b, z, y, x in sites
                         for dz, dy, dx in itertools.product((-1, 0, 1),
                                                             repeat=3)))
        sites = {(b, z // 2, y // 2, x // 2) for b, z, y, x in sites}
    return counts, pairs


def test_pairs_match_a_brute_force_count():
    rng = np.random.default_rng(0)
    c = np.concatenate([rng.integers(0, 2, (400, 1)),
                        rng.integers(0, 12, (400, 3))], axis=1)
    c = np.concatenate([c, np.full((5, 4), -1)]).astype(np.int32)
    got = work.level_counts(torch.as_tensor(c), 3)
    sites, pairs = _brute_pairs(c, 3)
    assert got["sites"] == sites
    assert got["pairs"] == pairs
    assert work.voxels(torch.as_tensor(c)) == sites[0]


def test_forward_muladds_match_the_programs_counter():
    from occuseg_tpu_torch.core.topology import PlanSpec
    from occuseg_tpu_torch.infer import plan_scene
    from occuseg_tpu_torch.utils.profiling import plan_muladd_count
    pool = scenes.RoomPool(3, 2, (3000, 4000))
    ps = list(zip(scenes.placements(pool, 3), range(2)))
    coords = scenes.batch_coords(pool, [p for p, _ in ps], 50.0)
    plan = plan_scene(coords, PlanSpec(caps=(8192, 8192, 8192)), ns=1,
                      chunks=False)
    want = plan_muladd_count(plan, CFG["planes"], CFG["block_reps"],
                             CFG["residual"], CFG["in_features"])
    counts = work.level_counts(torch.as_tensor(coords), 3)
    got = sum(p["pairs"] * p["cin"] * p["cout"]
              for p in work.products(CFG, counts) if p["kind"] != "linear")
    assert got == want


def test_a_training_step_counts_three_passes():
    counts = {"sites": [100, 40, 10], "pairs": [900, 300, 50],
              "points": 150}
    peaks = {"f32_flops": 67e12, "hbm_bytes_per_s": 3.35e12}
    fwd = work.step_work(CFG, counts, False, peaks)
    trn = work.step_work(CFG, counts, True, peaks)
    first = 2 * 900 * 3 * 16
    assert trn["flops"] == pytest.approx(3 * fwd["flops"] - first)
    assert trn["conv_bound_s"] > 2.9 * fwd["conv_bound_s"]
