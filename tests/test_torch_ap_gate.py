"""The port's instance-AP gate (`occuseg_tpu_torch/tools/ap_gate.py`)
against the JAX package's (`tests/test_accuracy_ap_gate.py`) on the CPU.

* The soak's batch (seeds 7, 8, 9) and its host plan are bit-identical to
  the JAX test's.
* `gt_regions` equals the JAX test's `_gt_regions`, and `contraction`
  its `_contraction` (rtol 1e-6: the same NumPy arithmetic), on the same
  batch and the same outputs.
* The scoring cascade (`aggregate_regions` -> mean-shift -> occupancy
  merge -> `filter_proposals` -> AP@0.5) gives the AP the JAX test's
  `_instance_ap` gives on the same outputs, exactly, in cases whose AP is
  neither 0 nor 1: outputs built from the ground truth with one or two
  instances given a class no ground-truth instance has.
* 10 soak steps from the JAX package's initial weights (`PRNGKey(0)`,
  through `convert.from_flax`) give the JAX soak's loss parts within 1e-4
  relative at every step (measured ~3e-7). The JAX soak takes the XLA
  gather convolution everywhere; the port takes the gather path at the
  8- and 24-wide convolutions and the chunk kernels' plain versions at
  the 16-wide ones.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests.test_accuracy_ap_gate as jax_gate
from occuseg_tpu.core.topology import PlanSpec as JaxPlanSpec
from occuseg_tpu.data.synthetic import make_batch as jax_make_batch
from occuseg_tpu.models.occuseg import OccuSegOutputs as JaxOutputs
from occuseg_tpu.train import state as jax_state
from tests.jax_planner import host_plan as jax_build_plan_host

from occuseg_tpu_torch.convert import from_flax
from occuseg_tpu_torch.models.occuseg import OccuSegOutputs
from occuseg_tpu_torch.native.plan import build_plan_host
from occuseg_tpu_torch.tools import ap_gate

torch.set_num_threads(2)


def _jax_batch(seed):
    return jax_make_batch(jax_gate.SceneConfig(num_points=2500, extent=40,
                                               num_objects=6),
                          num_scenes=1, p_cap=4096, num_instances=16,
                          seed=seed)


def _outputs(batch, wrong: int, squeeze: float, seed: int = 0):
    """Outputs built from the ground truth: an embedding of well separated
    per-instance centres, a displacement toward each instance's centroid
    scaled by (1 - squeeze), the log of each instance's size as its
    occupancy, unit bandwidths, and the labels as logits, except that the
    first `wrong` foreground instances take a class no ground-truth
    instance has."""
    rng = np.random.default_rng(seed)
    P = batch["labels"].shape[0]
    iid, lab = batch["instance_id"], batch["labels"]
    pose = batch["pose"].astype(np.float32)
    emb = rng.standard_normal((P, 8)).astype(np.float32) * 0.01
    disp = np.zeros((P, 3), np.float32)
    occ = np.zeros((P, 1), np.float32)
    sem = lab.copy()
    ids = [i for i in np.unique(iid) if i >= 0]
    for i in ids:
        m = iid == i
        emb[m] += rng.standard_normal(8).astype(np.float32) * 3
        disp[m] = (pose[m] - pose[m].mean(0)) * (1 - squeeze)
        occ[m] = np.log(m.sum())
    fg = [i for i in ids if lab[iid == i][0] >= 2]
    free = [c for c in range(2, 20) if c not in set(np.unique(lab))]
    for i, c in zip(fg[:wrong], free):
        sem[iid == i] = c
    return dict(semantics=np.eye(20, dtype=np.float32)[np.clip(sem, 0, 19)]
                * 10, features=np.zeros((P, 8), np.float32), embedding=emb,
                offset=rng.random((P, 1)).astype(np.float32),
                displacement=disp, bw=np.ones((P, 2), np.float32),
                occupancy=occ)


def _fake_eval(monkeypatch, outs):
    """The JAX test's eval step made to return `outs`."""
    fixed = JaxOutputs(**{k: jnp.asarray(v) for k, v in outs.items()})
    monkeypatch.setattr(jax_gate, "make_eval_step",
                        lambda model, spec: lambda state, batch, plan: fixed)


@pytest.mark.parametrize("seed", ap_gate.SEEDS)
def test_soak_batch_and_plan_match_jax(seed):
    a, b = _jax_batch(seed), ap_gate.soak_batch(seed)
    assert a.keys() == b.keys()
    for k in a:
        assert np.array_equal(a[k], b[k]), k
    jp = jax_build_plan_host(a["coords"], JaxPlanSpec(caps=ap_gate.SPEC.caps))
    tp = build_plan_host(b["coords"], ap_gate.SPEC)
    assert jax_gate.SPEC.caps == ap_gate.SPEC.caps
    for jl, tl in zip(jp.levels, tp.levels):
        for f in ("keys", "coords", "nbr"):
            assert np.array_equal(np.asarray(getattr(jl, f)),
                                  getattr(tl, f)), f
        assert int(jl.num_active) == tl.num_active
    for jt, tt in zip(jp.transitions, tp.transitions):
        assert np.array_equal(np.asarray(jt.child), tt.child)
        assert np.array_equal(np.asarray(jt.up), tt.up)
    assert np.array_equal(np.asarray(jp.p2v), tp.p2v)


@pytest.mark.parametrize("seed", ap_gate.SEEDS)
def test_regions_and_contraction_match_jax(monkeypatch, seed):
    batch = ap_gate.soak_batch(seed)
    valid = np.asarray(batch["labels"]) >= 0
    region = ap_gate.gt_regions(batch, valid)
    assert np.array_equal(region, jax_gate._gt_regions(batch, valid))
    assert region.max() < ap_gate.R_CAP
    outs = _outputs(batch, 0, squeeze=0.3 * seed / 9, seed=seed)
    _fake_eval(monkeypatch, outs)
    want = jax_gate._contraction(None, None, batch, None)
    got = ap_gate.contraction(outs["displacement"], batch)
    assert 0.0 < want < 1.0
    np.testing.assert_allclose(got, want, rtol=1e-6)


@pytest.mark.parametrize("wrong", [1, 2])
def test_scoring_matches_jax_cascade(monkeypatch, wrong):
    batch = ap_gate.soak_batch(7)
    valid = np.asarray(batch["labels"]) >= 0
    region = ap_gate.gt_regions(batch, valid)
    outs = _outputs(batch, wrong, squeeze=0.0)
    _fake_eval(monkeypatch, outs)
    want = jax_gate._instance_ap(None, None, batch, None, region, valid)
    got = ap_gate.instance_ap(
        OccuSegOutputs(**{k: torch.from_numpy(v) for k, v in outs.items()}),
        batch, region, valid)
    assert 0.0 < want < 1.0
    assert got == want


def test_soak_steps_match_jax_from_jax_weights():
    steps = 10
    batch = ap_gate.soak_batch(7)
    bj = {k: jnp.asarray(v) for k, v in batch.items()}
    spec = JaxPlanSpec(caps=ap_gate.SPEC.caps)
    model = jax_gate.LearningBWDenseUNet(n_planes=ap_gate.N_PLANES,
                                         num_classes=20, block_reps=1,
                                         residual_blocks=True)
    cfg = jax_state.TrainConfig(lr=1e-3)
    st = jax_state.create_train_state(model, jax.random.PRNGKey(0), bj,
                                      spec, cfg)
    init = from_flax(jax.tree.map(np.asarray, st.params),
                     jax.tree.map(np.asarray, st.batch_stats),
                     ap_gate.build_model())
    plan_j = jax.tree.map(jnp.asarray,
                          jax_build_plan_host(batch["coords"], spec))
    step = jax.jit(jax_state.make_train_step(
        model, spec, cfg, num_instances=ap_gate.NUM_INSTANCES))
    want = []
    for _ in range(steps):
        st, parts = step(st, bj, plan_j)
        want.append({k: float(v) for k, v in parts.items()})
    got = ap_gate.soak(7, "cpu", steps=steps, init=init)
    assert len(got.parts) == steps and len(got.step_ms) == steps
    for i, (w, g) in enumerate(zip(want, got.parts)):
        assert w.keys() == g.keys()
        for k in w:
            np.testing.assert_allclose(g[k], w[k], rtol=1e-4,
                                       err_msg=f"step {i} {k}")
