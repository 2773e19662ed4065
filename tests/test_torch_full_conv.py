"""The port's modules that need the device planner, and the training and
eval steps that plan on the device, against the JAX package on the CPU.

* `FullConvolution` (2/2 and 3/2, `build_nbr` both ways) and a
  submanifold convolution chained on its grown level: outputs, the grown
  plan and `torch.autograd` gradients against the JAX modules under
  `jax.vjp`, from the same weights (`convert.from_flax`). f32, rtol 1e-5
  with an absolute floor of 1e-5 of the reference's largest magnitude: the
  sums run over at most 27 offsets of a few channels in another order.
* `PermutohedralSubmanifoldConvolution`: the forward against the JAX
  module (same tolerance). Its gradients are held to autograd through
  the plain gather-matmul form (`ops/conv.gather_conv_fused`), at 1e-5 of
  the largest magnitude: the JAX module's backward pairs the lattice map
  with itself reversed, as for the cubic stencil, and the lattice's
  offset order does not allow that (its gradients are wrong; the port's
  module negates the offsets instead).
* `Trainer(spec).step(batch, plan=None)` for two steps of the m=8 model:
  the loss parts within 1e-4 relative (atol 1e-5) of the JAX
  `make_train_step(...)(state, batch)` with no plan (two Adam updates
  from the same initial weights; measured ~1e-6), and within 1e-5
  relative (atol 1e-6) of the port's host-planned step without chunks
  (the same route, the points in the sorted layout's order).
* `Trainer.evaluate(batch, plan=None)` against the JAX eval step with no
  plan: every output within 1e-4 (as `tests/test_torch_model.py`).
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from occuseg_tpu.core import topology as JT
from occuseg_tpu.core.sparse_tensor import SparseTensor as JaxSparse
from occuseg_tpu.data.synthetic import SceneConfig, make_batch
from occuseg_tpu.models import LearningBWDenseUNet as JaxLearningBW
from occuseg_tpu.nn import modules as jmod
from occuseg_tpu.nn.extras import (
    PermutohedralSubmanifoldConvolution as JaxPermConv,
)
from occuseg_tpu.train import state as jax_state
import tests.jax_planner  # noqa: F401  (heals the JAX planner's load)
from tests.utils import random_points

from occuseg_tpu_torch.convert import from_flax
from occuseg_tpu_torch.core import topology as T
from occuseg_tpu_torch.core.sparse_tensor import SparseTensor
from occuseg_tpu_torch.models import LearningBWDenseUNet
from occuseg_tpu_torch.nn import modules as tmod
from occuseg_tpu_torch.nn.extras import PermutohedralSubmanifoldConvolution
from occuseg_tpu_torch.ops import conv as conv_ops
from occuseg_tpu_torch.ops.permutohedral import embed_points
from occuseg_tpu_torch.train import state

torch.set_num_threads(2)

CAP = 512
N_PLANES = (8, 16, 24)
CAPS = (2048, 1024, 512)
I = 8
PARTS = ("semantic_loss", "embedding_loss", "regression_loss",
         "displacement_loss", "classification_loss", "occupancy_loss",
         "instance_iou", "total")


def _close(got, ref, rtol=1e-5, floor=1e-5, what=""):
    ref = np.asarray(ref)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    np.testing.assert_allclose(got, ref, rtol=rtol,
                               atol=floor * max(np.abs(ref).max(), 1e-30),
                               err_msg=what)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def cloud():
    """A one-level plan of 300 points (both packages', bit-identical) and
    active-row features."""
    rng = np.random.default_rng(8)
    pts = random_points(rng, 300, extent=10, batch_size=2, pad_to=CAP)
    jp = JT.build_plan(jnp.asarray(pts), JT.PlanSpec(caps=(CAP,)))
    tp = T.build_plan(torch.from_numpy(pts), T.PlanSpec(caps=(CAP,)))
    n = tp.levels[0].num_active
    feats = np.zeros((CAP, 8), np.float32)
    feats[:n] = rng.standard_normal((n, 8))
    return dict(jp=jp, tp=tp, n=n, feats=feats, rng=rng)


class _JaxChain(fnn.Module):
    size: int
    stride: int
    build_nbr: bool
    chain: bool

    @fnn.compact
    def __call__(self, x, plan):
        y, grown = jmod.FullConvolution(
            out_features=16, size=self.size, stride=self.stride,
            build_nbr=self.build_nbr, name="full")(x, plan)
        if self.chain:
            y = jmod.SubmanifoldConvolution(8, name="sub")(y, grown)
        return y.features, grown


class _Chain(torch.nn.Module):
    def __init__(self, size, stride, build_nbr, chain):
        super().__init__()
        self.full = tmod.FullConvolution(8, 16, size, stride,
                                         build_nbr=build_nbr)
        self.sub = tmod.SubmanifoldConvolution(16, 8) if chain else None

    def forward(self, x, plan):
        y, grown = self.full(x, plan)
        if self.sub is not None:
            y = self.sub(y, grown)
        return y.features, grown


@pytest.mark.parametrize("size,stride,build_nbr,chain", [
    (2, 2, True, False), (2, 2, False, False), (3, 2, True, False),
    (3, 2, False, False), (2, 2, True, True)],
    ids=["2-2-nbr", "2-2-no_nbr", "3-2-nbr", "3-2-no_nbr", "2-2-chain"])
def test_full_convolution_matches_jax(cloud, size, stride, build_nbr, chain):
    jmodel = _JaxChain(size, stride, build_nbr, chain)
    jx = JaxSparse(features=jnp.asarray(cloud["feats"]),
                   num_active=cloud["jp"].levels[0].num_active, level=0)
    params = jmodel.init(jax.random.PRNGKey(3), jx, cloud["jp"])["params"]

    @jax.jit
    def fwd_bwd(f, p, ct):
        def fwd(f, p):
            return jmodel.apply({"params": p}, jx.with_features(f),
                                cloud["jp"])
        out, vjp, grown = jax.vjp(fwd, f, p, has_aux=True)
        return out, grown, vjp(ct)

    cap_out = CAP * size ** 3
    ct = cloud["rng"].standard_normal(
        (cap_out, 8 if chain else 16)).astype(np.float32)
    jout, jgrown, (j_df, j_dp) = fwd_bwd(jx.features, params,
                                         jnp.asarray(ct))

    model = _Chain(size, stride, build_nbr, chain)
    model.load_state_dict(from_flax(_np_tree(params), {}, model))
    f = torch.from_numpy(cloud["feats"]).requires_grad_()
    x = SparseTensor(features=f, num_active=cloud["n"], level=0)
    out, grown = model(x, cloud["tp"])
    (out * torch.from_numpy(ct)).sum().backward()
    _close(out, jout, what="forward")
    assert grown.levels[0].num_active == int(jgrown.levels[0].num_active)
    assert grown.levels[0].num_active <= CAP * size ** 3
    for fld in ("keys", "coords", "nbr"):
        assert np.array_equal(T._np(getattr(grown.levels[0], fld)),
                              np.asarray(getattr(jgrown.levels[0], fld))), fld
    assert grown.transitions == () and int(grown.p2v[0]) == -1
    _close(f.grad, j_df, what="d_feats")
    _close(model.full.weight.grad, j_dp["full"]["weight"], what="dW full")
    if chain:
        _close(model.sub.weight.grad, j_dp["sub"]["weight"], what="dW sub")


def test_full_convolution_from_a_host_plan(cloud):
    """A host plan's level (NumPy keys) grows on the features' device: the
    same output as over the device plan."""
    model = tmod.FullConvolution(8, 16, generator=torch.Generator()
                                 .manual_seed(0))
    f = torch.from_numpy(cloud["feats"])
    x = SparseTensor(features=f, num_active=cloud["n"], level=0)
    hp = T.Topology(levels=(T.LevelTopology(
        keys=T._np(cloud["tp"].levels[0].keys),
        coords=T._np(cloud["tp"].levels[0].coords), num_active=cloud["n"],
        nbr=T._np(cloud["tp"].levels[0].nbr)),), transitions=(),
        p2v=T._np(cloud["tp"].p2v), num_points=cloud["tp"].num_points)
    a, ga = model(x, cloud["tp"])
    b, gb = model(x, hp)
    assert torch.equal(a.features, b.features)
    assert torch.equal(ga.levels[0].keys, gb.levels[0].keys)


def test_permutohedral_convolution(cloud):
    rng = np.random.default_rng(9)
    lat = embed_points(rng.standard_normal((260, 3)) * 4.0)
    pts = np.concatenate([rng.integers(0, 2, (260, 1)), lat - lat.min(0)],
                         axis=1).astype(np.int32)
    pts = np.concatenate([pts, -np.ones((CAP - 260, 4), np.int32)])
    jp = JT.build_plan(jnp.asarray(pts), JT.PlanSpec(
        caps=(CAP,), lattice="permutohedral"))
    tp = T.build_plan(torch.from_numpy(pts), T.PlanSpec(
        caps=(CAP,), lattice="permutohedral"))
    n = tp.levels[0].num_active
    feats = np.zeros((CAP, 12), np.float32)
    feats[:n] = rng.standard_normal((n, 12))
    jmodel = JaxPermConv(16)
    jx = JaxSparse(features=jnp.asarray(feats),
                   num_active=jp.levels[0].num_active, level=0)
    params = jmodel.init(jax.random.PRNGKey(4), jx, jp)["params"]
    jout = jmodel.apply({"params": params}, jx, jp).features

    model = PermutohedralSubmanifoldConvolution(12, 16)
    model.load_state_dict(from_flax(_np_tree(params), {}, model))
    f = torch.from_numpy(feats).requires_grad_()
    out = model(SparseTensor(features=f, num_active=n, level=0), tp).features
    _close(out, jout, what="forward")
    ct = torch.from_numpy(rng.standard_normal((CAP, 16)).astype(np.float32))
    (out * ct).sum().backward()
    # oracle: autograd through the plain gather-matmul form
    f2 = torch.from_numpy(feats).requires_grad_()
    w2 = model.weight.detach().clone().requires_grad_()
    ref = conv_ops.gather_conv_fused(f2, tp.levels[0].nbr, w2)
    _close(out, ref.detach(), what="forward vs oracle")
    (ref * ct).sum().backward()
    _close(f.grad, f2.grad.numpy(), what="d_feats")
    _close(model.weight.grad, w2.grad.numpy(), what="dW")


@pytest.fixture(scope="module")
def steps():
    """Two JAX train steps with no plan (the in-jit planner) from
    `create_train_state`, the eval step's outputs after them, and the
    initial weights."""
    batch = make_batch(SceneConfig(num_points=2000, extent=40,
                                   num_objects=5), num_scenes=1,
                       p_cap=4096, num_instances=I, seed=12)
    spec = JT.PlanSpec(caps=CAPS)
    model = JaxLearningBW(n_planes=N_PLANES, num_classes=20)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    st = jax_state.create_train_state(model, jax.random.PRNGKey(5), jb, spec)
    init = (_np_tree(st.params), _np_tree(st.batch_stats))
    step = jax.jit(jax_state.make_train_step(model, spec, num_instances=I))
    parts = []
    for _ in range(2):
        st, p = step(st, jb)
        parts.append(_np_tree(p))
    ev = jax.jit(jax_state.make_eval_step(model, spec))(st, jb)
    return dict(batch=batch, init=init, parts=parts, eval=_np_tree(ev))


def _trainer(steps):
    model = LearningBWDenseUNet(N_PLANES, num_classes=20)
    model.load_state_dict(from_flax(*steps["init"], model))
    return state.Trainer(model, "cpu", num_instances=I,
                         spec=T.PlanSpec(caps=CAPS))


def test_trainer_step_without_plan_matches_jax(steps):
    trainer, host = _trainer(steps), _trainer(steps)
    laid, plan = state.prepare_batch(steps["batch"], T.PlanSpec(caps=CAPS),
                                     chunks=False)
    assert all(l.chunks is None for l in plan.levels)
    for i in range(2):
        parts = trainer.step(steps["batch"])
        hparts = host.step(laid, plan)
        for k in PARTS:
            np.testing.assert_allclose(float(parts[k]), steps["parts"][i][k],
                                       rtol=1e-4, atol=1e-5,
                                       err_msg=f"step {i} {k}")
            np.testing.assert_allclose(float(parts[k]), float(hparts[k]),
                                       rtol=1e-5, atol=1e-6,
                                       err_msg=f"step {i} {k} host")
    assert trainer.steps == 2


def test_trainer_evaluate_without_plan_matches_jax(steps):
    trainer = _trainer(steps)
    for _ in range(2):
        trainer.step(steps["batch"])
    out = trainer.evaluate(steps["batch"])
    for fld in out._fields:
        ref = getattr(steps["eval"], fld)
        got = getattr(out, fld)
        assert got.shape == ref.shape, fld
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4, atol=1e-4,
                                   err_msg=fld)
    with pytest.raises(ValueError, match="spec"):
        state.Trainer(LearningBWDenseUNet(N_PLANES), "cpu").step(
            steps["batch"])


def test_trainer_plans_with_normals_and_from_flax_checks(steps):
    """Under `use_normals` the trainer's device plan carries the batch's
    normals (orientation classes bit for bit as the JAX planner's at the
    guided levels) and a normal-guided model steps on it; `from_flax`
    raises on the new modules' missing and left-over keys."""
    batch = steps["batch"]
    spec = T.PlanSpec(caps=CAPS, guide_levels=1)
    model = LearningBWDenseUNet(N_PLANES, num_classes=20, normal_guided=True,
                                generator=torch.Generator().manual_seed(3))
    trainer = state.Trainer(model, "cpu", num_instances=I, spec=spec,
                            use_normals=True)
    plan = trainer.plan(batch)
    jp = JT.build_plan(jnp.asarray(batch["coords"]), JT.PlanSpec(
        caps=CAPS, guide_levels=1), jnp.asarray(batch["normals"]))
    assert [l.guided for l in plan.levels] == [True, False, False]
    for jl, tl in zip(jp.levels, plan.levels):
        assert np.array_equal(np.asarray(jl.orient), tl.orient.numpy())
    parts = trainer.step(batch)
    assert all(np.isfinite(float(v)) for v in parts.values())

    chain = _Chain(2, 2, True, True)
    params = {k: {"weight": v.weight.detach().numpy()}
              for k, v in (("full", chain.full), ("sub", chain.sub))}
    assert set(from_flax(params, {}, chain)) == set(chain.state_dict())
    with pytest.raises(ValueError, match="missing"):
        from_flax({"full": params["full"]}, {}, chain)
    with pytest.raises(ValueError, match="left"):
        from_flax(dict(params, extra={"weight": np.zeros((8, 2, 2))}), {},
                  chain)
