"""The port's blocked multi-scene plans, vector active counts, forward and
training step against the JAX package on the CPU.

* Plans: `native/blocked.build_plan_host_blocked` bit-identical to the JAX
  package's at ns=2 and ns=4 over several seeds: every level and
  transition map, the vector `num_active`, p2v, then the chunk rulebooks
  (granule 1) and the sorted point layout. The JAX package keeps each
  chunk's `in_idx` scene-local and adds the scene's offset when it stages
  rows; the port stores the global rows, so its `in_idx` must equal the
  JAX one shifted by the chunk's scene offset; `lidx` is equal as is.
* `active_mask` / `total_active` with a vector of per-scene counts equal
  the JAX package's.
* One m=8 eval forward and one training step (two levels) on an ns=2
  plan from
  `from_flax` weights and random statistics. The JAX side runs its model
  on the unchunked blocked plan (XLA gathers; the Pallas kernels in
  interpret mode would take minutes), the port `prepare_batch(..., 2)`
  and `Trainer(num_scenes=2)`, i.e. the chunked plan and the custom
  backward. Tolerances of `test_torch_train.py`: f32, 1e-4 of each
  tensor's largest magnitude (chained convolutions summed in different
  orders), loss parts rtol 1e-4, and a 1e-6 floor for the gradients of
  the embedding heads' near-cancelling biases.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from occuseg_tpu.core import sparse_tensor as jax_st
from occuseg_tpu.core.point_layout import (
    apply_point_layout as jax_apply_layout,
    augment_plan_with_point_layout as jax_augment_layout,
)
from occuseg_tpu.core.topology import PlanSpec as JaxPlanSpec
from occuseg_tpu.data.synthetic import SceneConfig, make_batch
from occuseg_tpu.losses.instance import occuseg_total_loss as jax_total_loss
from occuseg_tpu.models import LearningBWDenseUNet as JaxLearningBW
from occuseg_tpu.ops.pallas import chunk_conv as jax_cc

from occuseg_tpu_torch.convert import from_flax
from occuseg_tpu_torch.core import sparse_tensor
from occuseg_tpu_torch.core.point_layout import augment_plan_with_point_layout
from occuseg_tpu_torch.core.topology import PlanSpec
from occuseg_tpu_torch.models import LearningBWDenseUNet
from occuseg_tpu_torch.native.blocked import (
    blocked_scene_caps,
    build_plan_host_blocked,
)
from occuseg_tpu_torch.ops.kernels.chunk_conv import augment_plan_with_chunks
from occuseg_tpu_torch.train import state
from tests.jax_planner import host_plan_blocked as jax_host_plan_blocked

torch.set_num_threads(2)

SCENE = SceneConfig(num_points=2500, extent=96, num_objects=6)
# per-scene caps (3072, 2304, 1152): multiples of 384 at both ns
CAPS = {2: (6144, 4096, 2048), 4: (12288, 8192, 4096)}
P_CAP = {2: 8192, 4: 16384}   # the layout needs (cap0 / 192) * 248 slots
N_PLANES = (8, 16)       # the forward and step: two levels keep it quick
STEP_CAPS = (6144, 4096)
I = 8
PARTS = ("semantic_loss", "embedding_loss", "regression_loss",
         "displacement_loss", "classification_loss", "occupancy_loss",
         "instance_iou", "total")


def _batch(ns, seed):
    return make_batch(SCENE, num_scenes=ns, p_cap=P_CAP[ns],
                      num_instances=I, seed=seed)


def _same_chunks(j, t, ns, val_scap, what):
    assert (j is None) == (t is None), what
    if j is None:
        return
    assert j.ns == ns, what
    C = j.in_idx.shape[0]
    scene = (np.arange(C) // (C // ns))[:, None]
    want = np.where(j.in_idx >= 0, j.in_idx + scene * val_scap, -1)
    assert np.array_equal(t.in_idx, want), what
    assert np.array_equal(t.lidx, j.lidx), what


@pytest.mark.parametrize("ns,seed", [(2, 0), (2, 5), (4, 1), (4, 7)])
def test_blocked_plan_bit_identical(ns, seed):
    batch = _batch(ns, seed)
    jp = jax_host_plan_blocked(batch["coords"], JaxPlanSpec(caps=CAPS[ns]),
                               ns)
    tp = build_plan_host_blocked(batch["coords"], PlanSpec(caps=CAPS[ns]), ns)
    scaps = blocked_scene_caps(CAPS[ns], ns)
    assert [l.cap for l in tp.levels] == [ns * c for c in scaps]
    for li, (lj, lt) in enumerate(zip(jp.levels, tp.levels)):
        for f in ("keys", "coords", "num_active", "nbr"):
            assert np.array_equal(np.asarray(getattr(lj, f)),
                                  getattr(lt, f)), (li, f)
        assert lt.num_active.shape == (ns,) and lt.num_active.min() > 0
    for tj, tt in zip(jp.transitions, tp.transitions):
        assert np.array_equal(np.asarray(tj.child), tt.child)
        assert np.array_equal(np.asarray(tj.up), tt.up)
    assert np.array_equal(np.asarray(jp.p2v), tp.p2v)
    assert int(jp.num_points) == tp.num_points

    jc = jax_cc.augment_plan_with_chunks(jp)
    tc = augment_plan_with_chunks(tp)
    assert jax_cc.LAST_TIER == tc.chunk_tier
    for li, (lj, lt) in enumerate(zip(jc.levels, tc.levels)):
        assert lt.chunks is not None
        _same_chunks(lj.chunks, lt.chunks, ns, scaps[li], f"level {li}")
    for ti, (tj, tt) in enumerate(zip(jc.transitions, tc.transitions)):
        _same_chunks(tj.child_chunks, tt.child_chunks, ns, scaps[ti],
                     f"child {ti}")
        _same_chunks(tj.up_chunks, tt.up_chunks, ns, scaps[ti + 1],
                     f"up {ti}")

    jl = jax_augment_layout(jc)
    tl = augment_plan_with_point_layout(tc)
    assert tl.vox_seg is not None
    for f in ("vox_seg", "vox_counts", "point_perm", "p2v"):
        assert np.array_equal(np.asarray(getattr(jl, f)), getattr(tl, f)), f


@pytest.mark.parametrize("counts,cap", [((5, 0, 7), 24), ((384, 17), 768),
                                        ((3,), 8), (11, 16)])
def test_active_mask_matches_jax(counts, cap):
    got = sparse_tensor.active_mask(counts, cap)
    want = np.asarray(jax_st.active_mask(jnp.asarray(counts, jnp.int32), cap))
    assert np.array_equal(got.numpy(), want)
    assert sparse_tensor.total_active(counts) == int(
        jax_st.total_active(jnp.asarray(counts, jnp.int32)))
    assert sparse_tensor.total_active(np.asarray(counts)) == \
        sparse_tensor.total_active(counts)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def blocked_step():
    """A 2-scene batch, the JAX eval outputs and one JAX training step's
    loss parts, gradients and new statistics, with the weights used."""
    ns = 2
    batch = _batch(ns, 3)
    jp = jax_augment_layout(jax_host_plan_blocked(
        batch["coords"], JaxPlanSpec(caps=STEP_CAPS), ns))
    assert jp.vox_seg is not None and jp.levels[0].chunks is None
    jb = {k: jnp.asarray(v) for k, v in
          jax_apply_layout(batch, jp, num_scenes=ns).items()}
    plan = jax.tree.map(jnp.asarray, jp)
    model = JaxLearningBW(n_planes=N_PLANES, num_classes=20)
    # jitted: an eager init of the blocked model dispatches op by op (~19 s)
    variables = jax.jit(lambda r, f, p: model.init(r, f, p, False))(
        jax.random.PRNGKey(4), jb["features"], plan)
    rng = np.random.default_rng(5)

    def rand_stat(path, v):
        if path[-1].key == "running_mean":
            return rng.normal(0.0, 0.5, np.shape(v)).astype(np.float32)
        return rng.uniform(0.5, 2.0, np.shape(v)).astype(np.float32)

    params = _np_tree(variables["params"])
    stats = jax.tree_util.tree_map_with_path(rand_stat,
                                             variables["batch_stats"])

    @jax.jit
    def run(p, s):
        out = model.apply({"params": p, "batch_stats": s}, jb["features"],
                          plan, False)

        def loss_fn(p):
            o, mutated = model.apply({"params": p, "batch_stats": s},
                                     jb["features"], plan, True,
                                     mutable=["batch_stats"])
            total, parts = jax_total_loss(o, jb, ns, I)
            return total, (parts, mutated["batch_stats"])
        return out, jax.value_and_grad(loss_fn, has_aux=True)(p)

    out, ((_, (parts, new_stats)), grads) = run(params, stats)
    return dict(batch=batch, params=params, stats=stats,
                out=_np_tree(out), parts=_np_tree(parts),
                grads=_np_tree(grads), new_stats=_np_tree(new_stats),
                point_perm=jp.point_perm)


def _model(blocked_step):
    model = LearningBWDenseUNet(N_PLANES, num_classes=20)
    model.load_state_dict(from_flax(blocked_step["params"],
                                    blocked_step["stats"], model))
    return model


def test_blocked_forward_matches_jax(blocked_step):
    laid, plan = state.prepare_batch(blocked_step["batch"],
                                     PlanSpec(caps=STEP_CAPS), 2)
    assert np.array_equal(plan.point_perm, blocked_step["point_perm"])
    trainer = state.Trainer(_model(blocked_step), "cpu", num_instances=I,
                            num_scenes=2)
    out = trainer.evaluate(laid, plan)
    assert trainer.model.training
    for f in ("semantics", "features", "embedding", "offset",
              "displacement", "bw", "occupancy"):
        want = getattr(blocked_step["out"], f)
        np.testing.assert_allclose(getattr(out, f).numpy(), want, rtol=1e-4,
                                   atol=1e-4 * np.abs(want).max(), err_msg=f)


def test_blocked_train_step_matches_jax(blocked_step):
    laid, plan = state.prepare_batch(blocked_step["batch"],
                                     PlanSpec(caps=STEP_CAPS), 2)
    model = _model(blocked_step)
    parts = state.Trainer(model, "cpu", num_instances=I,
                          num_scenes=2).step(laid, plan)
    for k in PARTS:
        np.testing.assert_allclose(float(parts[k]), blocked_step["parts"][k],
                                   rtol=1e-4, atol=1e-5, err_msg=k)
    ref = from_flax(blocked_step["grads"], blocked_step["new_stats"], model)
    for name, p in model.named_parameters():
        want = ref[name].numpy()
        np.testing.assert_allclose(
            p.grad.numpy(), want, rtol=1e-4,
            atol=max(1e-4 * np.abs(want).max(), 1e-6), err_msg=name)
    for name, b in model.named_buffers():
        np.testing.assert_allclose(b.numpy(), ref[name].numpy(), rtol=1e-4,
                                   atol=1e-5, err_msg=name)
