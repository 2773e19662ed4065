"""The port's clustering (`occuseg_tpu_torch.cluster`) against the JAX
package's (`occuseg_tpu.cluster`) and the NumPy oracle of the reference
cascade (`tests/cluster_oracle.py`), on the CPU, on the same inputs made
from a seed with numpy.

Tolerances:
- `aggregate_regions`: the gaussian-weighted means (embedding, pose
  embedding, bandwidth) within rtol 1e-5 / atol 1e-6 (f32 sums and exps in
  another order); counts, offsets, semantics, occupancy, centres and
  validity exact. Ids at or above r_cap are dropped from every reduction
  and clamped in gathers, as `jax.ops.segment_*` and JAX indexing do.
- `region_semantic_probability`: rtol 1e-5 / atol 1e-6.
- `meanshift_cluster` and `joint_refine`: label ids (and refined
  semantics) exactly equal to JAX's, not only the partition; the
  partitions exactly equal to the oracle's.
- `occupancy_merge`, the evaluator functions and the submission writer:
  exact (NumPy in both packages).
"""

import filecmp
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from occuseg_tpu.cluster import evaluator as jax_evaluator
from occuseg_tpu.cluster import meanshift as jax_meanshift
from occuseg_tpu.cluster import merge as jax_merge
from occuseg_tpu.cluster import refine as jax_refine
from occuseg_tpu.cluster import submission as jax_submission
from occuseg_tpu.cluster import supervoxel as jax_supervoxel

import chip_smoke
from cluster_oracle import meanshift_oracle, merge_oracle
from test_cluster import NUM_INST, P as SCENE_P, R_CAP as SCENE_R_CAP
from test_cluster import _scene
from test_cluster_parity import (
    _canon,
    _features,
    _make_merge_case,
    _make_regions,
)

from occuseg_tpu_torch.cluster import evaluator, merge, refine, submission
from occuseg_tpu_torch.cluster import meanshift, supervoxel
from occuseg_tpu_torch.cluster.supervoxel import RegionFeatures

torch.set_num_threads(2)

R_CAP = 256


def _torch_features(f):
    return RegionFeatures(*(torch.as_tensor(np.array(x)) for x in f))


def _point_inputs(seed, P=3000, E=8, case="plain"):
    rng = np.random.default_rng(seed)
    # the last 40 regions empty but one singleton and one of 3 points
    region = rng.integers(0, R_CAP - 40, P).astype(np.int32)
    region[10:13] = R_CAP - 2
    region[13] = R_CAP - 5
    if case in ("pad", "over"):
        region[rng.random(P) < 0.2] = -1
    if case == "over":
        # ids at r_cap (the padding bucket) and beyond it
        over = rng.random(P) < 0.2
        region[over] = rng.integers(R_CAP, R_CAP + 40, over.sum())
        region[:5] = R_CAP + 1000
    return dict(
        embedding=rng.standard_normal((P, E)).astype(np.float32),
        displacement=0.1 * rng.standard_normal((P, 3)).astype(np.float32),
        xyz=rng.uniform(0, 5, (P, 3)).astype(np.float32),
        bw=rng.uniform(0.5, 2, (P, 2)).astype(np.float32),
        offset=rng.uniform(0, 1, P).astype(np.float32),
        semantic_pred=rng.integers(-1, 22, P).astype(np.int32),
        occupancy=rng.standard_normal(P).astype(np.float32),
        region=region)


def _aggregate_both(inputs):
    want = jax_supervoxel.aggregate_regions(
        **{k: jnp.asarray(v) for k, v in inputs.items()}, r_cap=R_CAP)
    got = supervoxel.aggregate_regions(
        **{k: torch.as_tensor(v) for k, v in inputs.items()}, r_cap=R_CAP)
    return want, got


GW_FIELDS = ("embedding", "pose_embedding", "bw")


@pytest.mark.parametrize("case", ["plain", "pad", "over"])
def test_aggregate_regions_matches_jax(case):
    want, got = _aggregate_both(_point_inputs(3, case=case))
    for name, w, g in zip(want._fields, want, got):
        w, g = np.asarray(w), g.numpy()
        assert g.dtype == w.dtype and g.shape == w.shape, name
        if name in GW_FIELDS:
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6,
                                       err_msg=name)
        else:
            np.testing.assert_array_equal(g, w, err_msg=name)
    assert got.valid.any() and not got.valid.all()


def test_ids_past_r_cap_are_dropped_and_clamped():
    """Points with ids >= r_cap change no region (they are dropped from
    every sum and max), and `labels_to_points` gives them the last
    region's label (the gather clamps), in both packages."""
    over = _point_inputs(4, case="over")
    keep = over["region"] < R_CAP
    kept = {k: v[keep] for k, v in over.items()}
    _, with_over = _aggregate_both(over)
    _, without = _aggregate_both(kept)
    for name, a, b in zip(with_over._fields, with_over, without):
        if name in GW_FIELDS:
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                       atol=1e-6, err_msg=name)
        else:
            np.testing.assert_array_equal(a.numpy(), b.numpy(), name)
    labels = np.arange(R_CAP, dtype=np.int32) * 3
    want = np.asarray(jax_meanshift.labels_to_points(
        jnp.asarray(labels), jnp.asarray(over["region"])))
    got = meanshift.labels_to_points(torch.as_tensor(labels),
                                     torch.as_tensor(over["region"]))
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want[over["region"] >= R_CAP] == labels[-1]).all()
    assert (want[over["region"] < 0] == -1).all()


def test_region_semantic_probability_matches_jax():
    rng = np.random.default_rng(5)
    logits = rng.standard_normal((3000, 20)).astype(np.float32)
    region = _point_inputs(5, case="over")["region"]
    want = jax_refine.region_semantic_probability(
        jnp.asarray(logits), jnp.asarray(region), R_CAP)
    got = refine.region_semantic_probability(
        torch.as_tensor(logits), torch.as_tensor(region), R_CAP)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


def _meanshift_cases():
    cases = [(f"seed{s}", _make_regions(s)) for s in range(10)]
    tie = _make_regions(99, R=40, n_clusters=4)
    tie["offset"][:] = 0.25
    tie["offset"][7] = 0.5
    tie["offset"][23] = 0.5  # exact tie with region 7
    background = _make_regions(3)
    background["semantic"][:10] = 0  # wall/floor
    return cases + [("tie", tie), ("background", background)]


@pytest.mark.parametrize("name,d", _meanshift_cases(),
                         ids=[n for n, _ in _meanshift_cases()])
def test_meanshift_matches_jax_and_oracle(name, d):
    want, want_n = jax_meanshift.meanshift_cluster(_features(d),
                                                   max_instances=50)
    got, got_n = meanshift.meanshift_cluster(_torch_features(_features(d)),
                                             max_instances=50)
    assert got.dtype == torch.int32 and got_n == int(want_n)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    ref, _ = meanshift_oracle(d["offset"], d["emb"], d["pose"], d["bw"],
                              d["count"], d["semantic"], max_instances=50)
    np.testing.assert_array_equal(_canon(got.numpy()), _canon(ref))
    if name == "background":
        assert (got.numpy()[:10] == -1).all()


def test_meanshift_bandwidth_relax_and_cap_match_jax():
    d = _make_regions(7)
    for relax, cap in ((0.5, 300), (3.0, 300), (1.0, 4)):
        want, want_n = jax_meanshift.meanshift_cluster(
            _features(d), bw_relax_factor=relax, max_instances=cap)
        got, got_n = meanshift.meanshift_cluster(
            _torch_features(_features(d)), bw_relax_factor=relax,
            max_instances=cap)
        assert got_n == int(want_n)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got_n == 4


def _refine_scene_case():
    """test_cluster's noisy-semantics scene: 20% of the points' classes
    corrupted, regions of 8 points within one instance."""
    s = _scene(2)
    rng = np.random.default_rng(0)
    noisy = s["sem"].copy()
    corrupt = rng.random(SCENE_P) < 0.2
    noisy[corrupt] = rng.integers(0, 20, corrupt.sum())
    logits = np.full((SCENE_P, 20), -4.0, np.float32)
    logits[np.arange(SCENE_P), noisy] = 4.0
    inputs = dict(embedding=s["emb"], displacement=s["displacement"],
                  xyz=s["xyz"], bw=s["bw"], offset=s["offset"][:, 0],
                  semantic_pred=noisy, occupancy=s["occupancy"][:, 0],
                  region=s["region"])
    regions = jax_supervoxel.aggregate_regions(
        **{k: jnp.asarray(v) for k, v in inputs.items()}, r_cap=SCENE_R_CAP)
    prob = jax_refine.region_semantic_probability(
        jnp.asarray(logits), jnp.asarray(s["region"]), SCENE_R_CAP)
    return regions, prob, dict(max_instances=50)


def _refine_regions_case():
    """Parity regions with a random class probability per region and a
    minimum instance size that rejects small instances."""
    d = _make_regions(11)
    rng = np.random.default_rng(11)
    logits = rng.standard_normal((80, 20)).astype(np.float32) * 2
    prob = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
    return _features(d), prob, dict(max_instances=50, min_instance_size=3)


@pytest.mark.parametrize("case", ["scene", "regions"])
def test_joint_refine_matches_jax(case):
    regions, prob, kw = (_refine_scene_case() if case == "scene"
                         else _refine_regions_case())
    want_l, want_s, want_n = jax_refine.joint_refine(
        regions, jnp.asarray(prob), **kw)
    got_l, got_s, got_n = refine.joint_refine(
        _torch_features(regions), torch.as_tensor(np.array(prob)), **kw)
    assert got_n == int(want_n)
    assert got_l.dtype == got_s.dtype == torch.int32
    np.testing.assert_array_equal(got_l.numpy(), np.asarray(want_l))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    if case == "scene":  # the instances are recovered
        assert len(np.unique(got_l.numpy()[got_l.numpy() >= 0])) >= NUM_INST
    else:  # the size gate rejected some seeds
        assert (got_l.numpy() == -1).any()


def _merge_cases():
    cases = [(f"seed{s}", _make_merge_case(s)) for s in range(10)]
    E, R = 4, 6
    emb = np.zeros((R, E))
    emb[:2, 0], emb[4:, 0] = -1.0, 1.0
    pose = np.zeros((R, 3))
    pose[:2, 0], pose[4:, 0] = -1.0, 1.0
    near_tie = (np.array([0, 0, 1, 1, 2, 2]), emb, pose, np.full((R, 2), 0.7),
                np.full(R, 10.0), np.full(R, np.log(400.0)))
    return cases + [("near_tie", near_tie)]


@pytest.mark.parametrize("name,args", _merge_cases(),
                         ids=[n for n, _ in _merge_cases()])
def test_occupancy_merge_matches_jax(name, args):
    got = merge.occupancy_merge(*args)
    np.testing.assert_array_equal(got, jax_merge.occupancy_merge(*args))
    np.testing.assert_array_equal(got, merge_oracle(*args))


def _masks(rng, n, k):
    return [rng.random(n) < rng.uniform(0.05, 0.4) for _ in range(k)]


def _assert_same(a, b):
    """Nested lists, tuples and dicts of arrays and numbers, exactly
    (NaN equal to NaN)."""
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _assert_same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_same(x, y)
    else:
        np.testing.assert_array_equal(a, b)


def test_evaluator_matches_jax():
    rng = np.random.default_rng(8)
    n = 4000
    sem = rng.integers(-1, 21, n)
    inst = rng.integers(-1, 40, n)
    occ = np.log(rng.uniform(20, 400, n)).astype(np.float32)
    sizes = np.full(20, 40.0, np.float32)
    for kw in ({}, {"class_sizes": sizes},
               {"class_sizes": sizes, "occupancy_lo": 0.1,
                "occupancy_hi": 10.0}):
        want = jax_evaluator.filter_proposals(inst, sem, occ, **kw)
        _assert_same(evaluator.filter_proposals(inst, sem, occ, **kw), want)
    assert sum(map(len, want)) > 0
    _assert_same(evaluator.gt_instances(inst, sem),
                 jax_evaluator.gt_instances(inst, sem))
    np.testing.assert_array_equal(evaluator.DEFAULT_CLASS_SIZES,
                                  jax_evaluator.DEFAULT_CLASS_SIZES)

    # two scenes: proposals perturbed from the ground truth, duplicates,
    # junk, and ranked confidences
    props, gts, confs = [], [], []
    for s in range(2):
        g = [_masks(rng, 300, int(rng.integers(0, 3))) for _ in range(20)]
        p = [[m ^ (rng.random(300) < 0.05) for m in c] + _masks(rng, 300, 1)
             for c in g]
        p[0] = p[0] + p[0][:1]
        gts.append(g)
        props.append(p)
        confs.append([list(rng.random(len(c))) for c in p])
    for thr in (0.25, 0.5):
        _assert_same(
            evaluator.instance_precision_recall(props, gts, iou_threshold=thr),
            jax_evaluator.instance_precision_recall(props, gts,
                                                    iou_threshold=thr))
        for c in (None, confs):
            _assert_same(
                evaluator.instance_average_precision(props, gts, c,
                                                     iou_threshold=thr),
                jax_evaluator.instance_average_precision(props, gts, c,
                                                         iou_threshold=thr))
    sem_pred = rng.integers(0, 20, 300)
    for thr in (0.25, 0.5):
        _assert_same(
            evaluator.per_proposal_statistics(props[0], gts[0], sem_pred,
                                              iou_threshold=thr, width=8),
            jax_evaluator.per_proposal_statistics(props[0], gts[0], sem_pred,
                                                  iou_threshold=thr, width=8))


def test_submission_matches_jax(tmp_path):
    rng = np.random.default_rng(5)
    proposals = [[] for _ in range(20)]
    proposals[4] = _masks(rng, 300, 2)
    proposals[19] = _masks(rng, 300, 1)
    confidences = [[] for _ in range(20)]
    confidences[4] = [0.9, 0.25]
    for conf in (None, confidences):
        a = tmp_path / f"jax{conf is None}"
        b = tmp_path / f"port{conf is None}"
        jax_submission.write_scene_submission(str(a), "scene0000_00",
                                              proposals, conf)
        submission.write_scene_submission(str(b), "scene0000_00", proposals,
                                          conf)
        files = sorted(os.path.relpath(os.path.join(d, f), a)
                       for d, _, fs in os.walk(a) for f in fs)
        assert len(files) == 4
        match, mismatch, errors = filecmp.cmpfiles(a, b, files, shallow=False)
        assert match == files and not mismatch and not errors


def test_smoke_cases_are_the_parity_tests():
    """`chip_smoke.py` runs the parity cases on the card with its own
    copies of the case generators (the card's machine has no jax, and
    `test_cluster_parity.py` imports it): they must build the same
    inputs."""
    for seed in (0, 5, 99):
        for kw in ({}, {"R": 40, "n_clusters": 4}):
            _assert_same(chip_smoke.parity_regions(seed, **kw),
                         _make_regions(seed, **kw))
        _assert_same(chip_smoke.parity_merge_case(seed),
                     _make_merge_case(seed))
