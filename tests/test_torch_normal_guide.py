"""The port's normal-guided convolutions against the JAX package on the CPU
(the counterpart of `tests/test_normal_guide.py`).

* the orientation classes and the reference's permutation tables, exactly;
* host plans built with point normals (`native/plan.py`, and the blocked
  layout at ns=2) bit-identical to the JAX host planner's, `orient`
  included, at guide_levels None, 1 and 2;
* `ops.normal_guide.normal_guided_conv` (the gather-conv kernel's plain
  version on the CPU over the permuted map, and its PyTorch backward)
  against `jax.grad` of the JAX function: forward and both gradients
  within 1e-5 of each tensor's largest magnitude (f32, sums over 27
  offsets in other orders); its backward against the plain autograd of
  the per-offset gathers within 1e-5, and two backwards give the same
  bits;
* the m=8 normal-guided model (widths 8, 16, 24, input colours and
  normals) with the JAX weights through `from_flax`: the 7 eval outputs
  within rtol 1e-5 / atol 1e-4 (as `test_torch_model.py`, chained layers);
* one `--use_normal --use_feature cn` training step against JAX's
  `make_train_step(..., use_normals=True)`: loss parts within 1e-4, and
  every gradient within 1e-4 of its tensor's largest magnitude (floor
  1e-6, as `test_torch_train.py`).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from occuseg_tpu.core import topology as JT
from occuseg_tpu.core.point_layout import (
    apply_point_layout as jax_apply_layout,
    augment_plan_with_point_layout as jax_augment_layout,
)
from occuseg_tpu.data.synthetic import SceneConfig, make_batch
from occuseg_tpu.losses.instance import (
    occuseg_total_loss as jax_total_loss,
)
from occuseg_tpu.models import LearningBWDenseUNet as JaxLearningBW
from occuseg_tpu.ops import normal_guide as jax_ng
from occuseg_tpu.train import state as jax_state
from tests.jax_planner import heal, host_plan as jax_host_plan

from occuseg_tpu_torch.convert import from_flax
from occuseg_tpu_torch.core.topology import PlanSpec
from occuseg_tpu_torch.models import LearningBWDenseUNet
from occuseg_tpu_torch.native.blocked import build_plan_host_blocked
from occuseg_tpu_torch.native.plan import build_plan_host
from occuseg_tpu_torch.ops import conv as conv_ops
from occuseg_tpu_torch.ops import normal_guide as ng
from occuseg_tpu_torch.train import state

torch.set_num_threads(2)

N_PLANES = (8, 16, 24)
CAPS = (3072, 2048, 1024)
P_CAP = 4096
I = 8
SCENE = SceneConfig(num_points=3000, extent=96, num_objects=6)
FIELDS = ("semantics", "features", "embedding", "offset", "displacement",
          "bw", "occupancy")
PARTS = ("semantic_loss", "embedding_loss", "regression_loss",
         "displacement_loss", "classification_loss", "occupancy_loss",
         "instance_iou", "total")


def _batch(seed=11, num_scenes=1):
    """A synthetic batch whose features are colours and normals (cn)."""
    b = make_batch(SCENE, num_scenes=num_scenes, p_cap=P_CAP,
                   num_instances=I, seed=seed)
    b["features"] = np.concatenate([b["features"], b["normals"]], axis=1)
    return b


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _level(seed=0, guide=None):
    """Level 0 of a plan with normals: (nbr, orient, N) as NumPy."""
    b = make_batch(SCENE, num_scenes=1, p_cap=P_CAP, num_instances=I,
                   seed=seed)
    plan = build_plan_host(b["coords"], PlanSpec(caps=CAPS,
                                                 guide_levels=guide),
                           b["normals"])
    lvl = plan.levels[0]
    return lvl.nbr, lvl.orient, lvl.cap


def test_oriented_filter_classes():
    normals = np.array([[1, 0, 0], [-2, 1, 0], [0, 3, 1], [0, -1, 0.5],
                        [0.1, 0.2, -5], [1, 1, 1], [0, 1, 1]], np.float32)
    got = ng.oriented_filter(torch.from_numpy(normals))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), [0, 0, 2, 2, 4, 0, 2])
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jax_ng.oriented_filter(jnp.asarray(normals))))


def test_tables_and_permuted_map_match_jax():
    np.testing.assert_array_equal(ng.ORIENT_PERM, jax_ng.ORIENT_PERM)
    np.testing.assert_array_equal(ng.ORIENT_PERM_INV, jax_ng.ORIENT_PERM_INV)
    for o in range(6):
        assert sorted(ng.ORIENT_PERM[o]) == list(range(27))
    nbr, orient, _ = _level(1)
    got = ng.permute_neighbor_map(torch.from_numpy(nbr),
                                  torch.from_numpy(orient))
    want = jax_ng.permute_neighbor_map(jnp.asarray(nbr), jnp.asarray(orient))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("guide", [None, 1, 2])
def test_host_plan_orient_matches_jax(guide):
    b = make_batch(SceneConfig(num_points=3000, extent=64, num_objects=6),
                   1, 4096, 8, seed=21)
    caps = (2048, 1024, 512)
    tp = build_plan_host(b["coords"], PlanSpec(caps=caps, guide_levels=guide),
                         b["normals"])
    jp = jax_host_plan(b["coords"], JT.PlanSpec(caps=caps,
                                                guide_levels=guide),
                       b["normals"])
    for li, (jl, tl) in enumerate(zip(jp.levels, tp.levels)):
        for f in ("keys", "coords", "nbr", "orient"):
            assert np.array_equal(np.asarray(getattr(jl, f)),
                                  getattr(tl, f)), (li, f)
        carries = guide is None or li < guide
        assert tl.guided == carries
        o = tl.orient[:tl.num_active]
        assert (o != 0).any() == carries, li
        assert set(np.unique(o)) <= {0, 2, 4}


def test_blocked_plan_orient_matches_jax():
    from occuseg_tpu.native.blocked import (
        build_plan_host_blocked as jax_blocked,
    )
    heal()
    b = make_batch(SceneConfig(num_points=2000, extent=64, num_objects=4),
                   2, 4096, 8, seed=5)
    for guide in (None, 1):
        spec = PlanSpec(caps=(4096, 2048, 1024), guide_levels=guide)
        tp = build_plan_host_blocked(b["coords"], spec, 2, b["normals"])
        jp = jax_blocked(b["coords"], JT.PlanSpec(caps=spec.caps,
                                                  guide_levels=guide), 2,
                         b["normals"])
        assert jp is not None
        for li, (jl, tl) in enumerate(zip(jp.levels, tp.levels)):
            for f in ("nbr", "orient", "num_active"):
                assert np.array_equal(np.asarray(getattr(jl, f)),
                                      np.asarray(getattr(tl, f))), (li, f)
            # each scene's block carries its own scene's orientation
            cap = tl.cap // 2
            for s in range(2):
                o = tl.orient[s * cap:s * cap + tl.num_active[s]]
                assert (o != 0).any() == (guide is None or li < guide)
        assert np.array_equal(jp.p2v, tp.p2v)


def test_orientation_zero_is_the_plain_gather_conv():
    nbr, _, N = _level(2)
    rng = np.random.default_rng(0)
    feats = torch.from_numpy(rng.standard_normal((N, 8), dtype=np.float32))
    w = torch.from_numpy(rng.standard_normal((27, 8, 5), dtype=np.float32))
    nbr_t = torch.from_numpy(nbr)
    out = ng.normal_guided_conv(feats, nbr_t, torch.zeros(N, dtype=torch.int32),
                                w)
    ref = conv_ops.gather_conv(feats, nbr_t, w)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=1e-5,
                               atol=1e-5)


def test_constant_orientation_equals_weight_permutation():
    nbr, _, N = _level(3)
    rng = np.random.default_rng(1)
    feats = torch.from_numpy(rng.standard_normal((N, 3), dtype=np.float32))
    w = torch.from_numpy(rng.standard_normal((27, 3, 5), dtype=np.float32))
    nbr_t = torch.from_numpy(nbr)
    for o in (2, 4):
        out = ng.normal_guided_conv(feats, nbr_t,
                                    torch.full((N,), o, dtype=torch.int32), w)
        ref = conv_ops.gather_conv(feats, nbr_t,
                                   w[torch.from_numpy(ng.ORIENT_PERM[o]).long()])
        np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=1e-5,
                                   atol=1e-5)


def _conv_inputs(cin, seed):
    nbr, orient, N = _level(seed, guide=1)
    rng = np.random.default_rng(seed)
    feats = rng.standard_normal((N, cin), dtype=np.float32)
    w = rng.standard_normal((27, cin, 12), dtype=np.float32) * 0.3
    r = rng.standard_normal((N, 12), dtype=np.float32)
    return nbr, orient, feats, w, r


def _close(got, want, tol, what):
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"{what}: {err} > {tol} x {scale}"


@pytest.mark.parametrize("cin", [6, 16])
def test_normal_guided_conv_matches_jax_grad(cin):
    nbr, orient, feats, w, r = _conv_inputs(cin, 4 + cin)

    def jloss(f, wt):
        out = jax_ng.normal_guided_conv(f, jnp.asarray(nbr),
                                        jnp.asarray(orient), wt)
        return jnp.sum(out * jnp.asarray(r)), out

    (_, j_out), (j_df, j_dw) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(jnp.asarray(feats),
                                             jnp.asarray(w))
    f = torch.from_numpy(feats).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    out = ng.normal_guided_conv(f, torch.from_numpy(nbr),
                                torch.from_numpy(orient), wt)
    (out * torch.from_numpy(r)).sum().backward()
    _close(out.detach().numpy(), np.asarray(j_out), 1e-5, "forward")
    _close(f.grad.numpy(), np.asarray(j_df), 1e-5, "d_feats")
    _close(wt.grad.numpy(), np.asarray(j_dw), 1e-5, "dW")


def test_backward_matches_plain_autograd_and_repeats():
    """The ordered d_feats (gathers of per-class products, no scatter) and
    dW against autograd of out = sum_j gather(feats, nbr'[:, j]) @ W[j]."""
    nbr, orient, feats, w, r = _conv_inputs(8, 7)
    nbr_t, orient_t = torch.from_numpy(nbr), torch.from_numpy(orient)
    rt = torch.from_numpy(r)

    def run():
        f = torch.from_numpy(feats).requires_grad_()
        wt = torch.from_numpy(w).requires_grad_()
        (ng.normal_guided_conv(f, nbr_t, orient_t, wt) * rt).sum().backward()
        return f.grad, wt.grad

    df, dw = run()
    f = torch.from_numpy(feats).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    perm = ng.permute_neighbor_map(nbr_t, orient_t)
    out = sum(conv_ops.gather_rows(f, perm[:, j]) @ wt[j] for j in range(27))
    (out * rt).sum().backward()
    _close(df.numpy(), f.grad.numpy(), 1e-5, "d_feats")
    _close(dw.numpy(), wt.grad.numpy(), 1e-5, "dW")
    df2, dw2 = run()
    assert torch.equal(df, df2) and torch.equal(dw, dw2)


def _jax_variables(batch, jplan):
    model = JaxLearningBW(n_planes=N_PLANES, num_classes=20,
                          normal_guided=True)
    variables = model.init(jax.random.PRNGKey(1),
                           jnp.asarray(batch["features"]),
                           jax.tree.map(jnp.asarray, jplan), False)
    rng = np.random.default_rng(2)

    def rand_stat(path, v):
        if path[-1].key == "running_mean":
            return rng.normal(0.0, 0.5, np.shape(v)).astype(np.float32)
        return rng.uniform(0.5, 2.0, np.shape(v)).astype(np.float32)

    return (model, _np_tree(variables["params"]),
            jax.tree_util.tree_map_with_path(rand_stat,
                                             variables["batch_stats"]))


def _port_model(params, stats):
    model = LearningBWDenseUNet(N_PLANES, num_classes=20, in_features=6,
                                normal_guided=True)
    model.load_state_dict(from_flax(params, stats, model))
    return model


@pytest.mark.parametrize("guide", [1, 2])
def test_model_forward_matches_jax(guide):
    batch = _batch()
    jp = jax_augment_layout(jax_host_plan(
        batch["coords"], JT.PlanSpec(caps=CAPS, guide_levels=guide),
        batch["normals"]))
    jb = jax_apply_layout(batch, jp, num_scenes=1)
    model, params, stats = _jax_variables(jb, jp)
    out_j = model.apply({"params": params, "batch_stats": stats},
                        jnp.asarray(jb["features"]),
                        jax.tree.map(jnp.asarray, jp), False)
    laid, plan = state.prepare_batch(batch, PlanSpec(caps=CAPS,
                                                     guide_levels=guide))
    assert np.array_equal(plan.point_perm, jp.point_perm)
    assert [l.guided for l in plan.levels] == [li < guide for li in range(3)]
    port = _port_model(params, stats)
    out_t = state.Trainer(port, "cpu", num_instances=I).evaluate(laid, plan)
    for name in FIELDS:
        np.testing.assert_allclose(getattr(out_t, name).numpy(),
                                   np.asarray(getattr(out_j, name)),
                                   rtol=1e-5, atol=1e-4, err_msg=name)


def test_train_step_matches_jax():
    batch = _batch(seed=13)
    jspec = JT.PlanSpec(caps=CAPS, guide_levels=1)
    jp = jax_augment_layout(jax_host_plan(batch["coords"], jspec,
                                          batch["normals"]))
    jb = {k: jnp.asarray(v) for k, v in
          jax_apply_layout(batch, jp, num_scenes=1).items()}
    plan_j = jax.tree.map(jnp.asarray, jp)
    model, params, stats = _jax_variables(jb, jp)

    # the loss parts of JAX's own step, and the gradients of its loss
    step = jax.jit(jax_state.make_train_step(model, jspec, num_scenes=1,
                                             num_instances=I,
                                             use_normals=True))
    ts = jax_state.TrainState(params=params, batch_stats=stats,
                              opt_state=jax_state.make_optimizer(
                                  jax_state.TrainConfig()).init(params),
                              step=jnp.zeros((), jnp.int32))
    _, j_parts = step(ts, jb, plan_j)

    def loss_fn(p):
        out, _ = model.apply({"params": p, "batch_stats": stats},
                             jb["features"], plan_j, True,
                             mutable=["batch_stats"])
        return jax_total_loss(out, jb, 1, I)[0]

    j_grads = _np_tree(jax.jit(jax.grad(loss_fn))(params))

    laid, plan = state.prepare_batch(batch, PlanSpec(caps=CAPS,
                                                     guide_levels=1))
    port = _port_model(params, stats)
    parts = state.Trainer(port, "cpu", num_instances=I).step(laid, plan)
    for k in PARTS:
        np.testing.assert_allclose(float(parts[k]), float(j_parts[k]),
                                   rtol=1e-4, atol=1e-5, err_msg=k)
    ref = from_flax(j_grads, _np_tree(stats), port)
    for name, p in port.named_parameters():
        want = ref[name].numpy()
        np.testing.assert_allclose(
            p.grad.numpy(), want, rtol=1e-4,
            atol=max(1e-4 * np.abs(want).max(), 1e-6), err_msg=name)
