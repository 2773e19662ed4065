"""The PyTorch port's training step against the JAX package on the CPU.

* One full step of the small flagship model of `test_torch_model.py`
  (`N_PLANES=(32, 64, 96)`) from `from_flax` weights and random running
  statistics: the loss parts, every parameter's gradient and the new BN
  statistics. The JAX side runs its step's loss function
  (`model.apply(..., train=True, mutable=["batch_stats"])` and
  `occuseg_total_loss`) on the unchunked plan of the same scene, through
  the XLA gather convolution: the Pallas kernels in interpret mode would
  take minutes for a whole backward. The port runs `prepare_batch` and
  `Trainer.step`, i.e. the chunked plan and the custom backward of every
  convolution (the kernels' plain versions on the CPU). Tolerance: f32,
  1e-4 of the largest magnitude per tensor (15 chained convolutions and
  their transposes, summed in different orders; measured ~2e-6), with an
  absolute floor of 1e-6 for the gradients: those of the embedding heads'
  biases are near-cancellations (every embedding term but the 0.001
  regulariser is translation-invariant), ~4e-4 summed from O(1)
  per-point terms, so their f32 rounding (measured ~4e-7) is absolute.
* The optimizers on identical gradients across a staircase boundary
  against optax (`make_optimizer` of both packages), at ~1e-6.
* `prepare_batch` against the JAX package's host preparation."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from occuseg_tpu.core.point_layout import (
    apply_point_layout as jax_apply_layout,
    augment_plan_with_point_layout as jax_augment_layout,
)
from occuseg_tpu.core.topology import PlanSpec as JaxPlanSpec
from occuseg_tpu.data.synthetic import SceneConfig, make_batch
from occuseg_tpu.losses.instance import (
    occuseg_total_loss as jax_total_loss,
)
from occuseg_tpu.models import LearningBWDenseUNet as JaxLearningBW
from tests.jax_planner import host_plan as jax_build_plan_host
from occuseg_tpu.ops.pallas import chunk_conv as jax_cc
from occuseg_tpu.train import state as jax_state

from occuseg_tpu_torch.convert import from_flax
from occuseg_tpu_torch.core.topology import PlanSpec
from occuseg_tpu_torch.models import LearningBWDenseUNet
from occuseg_tpu_torch.train import state

torch.set_num_threads(2)

N_PLANES = (32, 64, 96)
CAPS = (3072, 2048, 1024)
P_CAP = 4096
I = 8
PARTS = ("semantic_loss", "embedding_loss", "regression_loss",
         "displacement_loss", "classification_loss", "occupancy_loss",
         "instance_iou", "total")


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def batch():
    return make_batch(SceneConfig(num_points=3000, extent=96, num_objects=6),
                      num_scenes=1, p_cap=P_CAP, num_instances=I, seed=11)


@pytest.fixture(scope="module")
def jax_step(batch):
    """Loss parts, gradients and new batch statistics of one JAX training
    step's loss function, with the parameters and statistics it used."""
    jp = jax_augment_layout(jax_build_plan_host(batch["coords"],
                                                JaxPlanSpec(caps=CAPS)))
    assert jp.vox_seg is not None and jp.levels[0].chunks is None
    jb = {k: jnp.asarray(v) for k, v in
          jax_apply_layout(batch, jp, num_scenes=1).items()}
    plan = jax.tree.map(jnp.asarray, jp)
    model = JaxLearningBW(n_planes=N_PLANES, num_classes=20)
    variables = model.init(jax.random.PRNGKey(1), jb["features"], plan,
                           False)
    rng = np.random.default_rng(2)

    def rand_stat(path, v):
        if path[-1].key == "running_mean":
            return rng.normal(0.0, 0.5, np.shape(v)).astype(np.float32)
        return rng.uniform(0.5, 2.0, np.shape(v)).astype(np.float32)

    params = _np_tree(variables["params"])
    stats = jax.tree_util.tree_map_with_path(rand_stat,
                                             variables["batch_stats"])

    @jax.jit
    def loss_and_grad(p, s):
        def loss_fn(p):
            out, mutated = model.apply({"params": p, "batch_stats": s},
                                       jb["features"], plan, True,
                                       mutable=["batch_stats"])
            total, parts = jax_total_loss(out, jb, 1, I)
            return total, (parts, mutated["batch_stats"])
        return jax.value_and_grad(loss_fn, has_aux=True)(p)

    (_, (parts, new_stats)), grads = loss_and_grad(params, stats)
    return dict(params=params, stats=stats, parts=_np_tree(parts),
                grads=_np_tree(grads), new_stats=_np_tree(new_stats),
                point_perm=jp.point_perm)


def test_train_step_matches_jax(batch, jax_step):
    laid, plan = state.prepare_batch(batch, PlanSpec(caps=CAPS))
    assert np.array_equal(plan.point_perm, jax_step["point_perm"])
    assert all(l.chunks is not None for l in plan.levels)
    model = LearningBWDenseUNet(N_PLANES, num_classes=20)
    model.load_state_dict(from_flax(jax_step["params"], jax_step["stats"],
                                    model))
    trainer = state.Trainer(model, "cpu", num_instances=I)
    parts = trainer.step(laid, plan)
    for k in PARTS:
        np.testing.assert_allclose(float(parts[k]), jax_step["parts"][k],
                                   rtol=1e-4, atol=1e-5, err_msg=k)
    # the gradients and new statistics, mapped onto the state_dict's names
    ref = from_flax(jax_step["grads"], jax_step["new_stats"], model)
    n_checked = 0
    for name, p in model.named_parameters():
        want = ref[name].numpy()
        np.testing.assert_allclose(
            p.grad.numpy(), want, rtol=1e-4,
            atol=max(1e-4 * np.abs(want).max(), 1e-6), err_msg=name)
        n_checked += 1
    assert n_checked == len(jax.tree.leaves(jax_step["grads"]))
    buffers = dict(model.named_buffers())
    assert len(buffers) == len(jax.tree.leaves(jax_step["new_stats"]))
    for name, b in buffers.items():
        np.testing.assert_allclose(b.numpy(), ref[name].numpy(), rtol=1e-4,
                                   atol=1e-5, err_msg=name)


@pytest.mark.parametrize("optimizer", ["adam", "sgd"])
def test_optimizer_matches_optax_across_decay(optimizer):
    """Three updates with the same gradients: lr 1e-3 for updates 0 and 1,
    lr * gamma for update 2 (lr_decay_steps=2)."""
    rng = np.random.default_rng(3)
    shapes = {"a": (27, 8, 16), "b": (16,), "c": (5, 3)}
    params = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in shapes.items()}
    grads = [{k: rng.standard_normal(s).astype(np.float32)
              for k, s in shapes.items()} for _ in range(3)]
    kw = dict(lr_decay_steps=2, lr_decay_gamma=0.25, optimizer=optimizer)

    tx = jax_state.make_optimizer(jax_state.TrainConfig(**kw))
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    opt_state = tx.init(jp)
    for g in grads:
        upd, opt_state = tx.update({k: jnp.asarray(v) for k, v in g.items()},
                                   opt_state, jp)
        jp = jax.tree.map(lambda a, b: a + b, jp, upd)

    tp = {k: torch.from_numpy(v.copy()).requires_grad_()
          for k, v in params.items()}
    opt, sched = state.make_optimizer(list(tp.values()),
                                      state.TrainConfig(**kw))
    lrs = []
    for g in grads:
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k])
        lrs.append(opt.param_groups[0]["lr"])
        opt.step()
        sched.step()
    assert lrs == pytest.approx([1e-3, 1e-3, 2.5e-4])
    for k in shapes:
        np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]),
                                   rtol=1e-6, atol=1e-6, err_msg=k)


def test_prepare_batch_matches_jax_host_preparation(batch):
    """Every per-point array in the layout the JAX package's benchmark
    preparation gives it (C++ planner, chunks, point layout)."""
    laid, plan = state.prepare_batch(batch, PlanSpec(caps=CAPS))
    jp = jax_augment_layout(jax_cc.augment_plan_with_chunks(
        jax_build_plan_host(batch["coords"], JaxPlanSpec(caps=CAPS))))
    ref = jax_apply_layout(batch, jp, num_scenes=1)
    assert set(laid) == set(ref)
    for k in ref:
        assert np.array_equal(laid[k], ref[k]), k
    assert np.array_equal(plan.vox_seg, jp.vox_seg)
