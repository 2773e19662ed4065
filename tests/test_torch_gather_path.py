"""The port's gather-convolution path against the JAX package on the CPU.

* `ops/conv.gather_conv` forward and its `torch.autograd` gradients
  (d_feats, dW) against `occuseg_tpu.ops.conv.gather_conv` under
  `jax.vjp`, on the submanifold, child and up maps of a host plan (each
  with the transpose map the JAX docstring pairs it with), which have
  missing neighbours, at Cin 3 / 16 / 24 and Cout 8 / 24 / 64. f32;
  tolerance rtol 1e-5 with an absolute floor of 1e-5 of the tensor's
  largest magnitude (sums of up to 27 x 24 products in another order).
* `gather_conv_fused` and `conv_flops` against the JAX package's.
* The modules' route (`nn/modules.chunk_route`): the chunk kernels where
  the map has a rulebook and Cout is a multiple of 16, else the gather
  convolution, which reads the plan's maps in the kernel's orientation
  (a transition's backward map unflipped) and matches the JAX VJP; each
  map is copied to a device once per plan.
* The gather-conv kernel's work split replayed in NumPy
  (`tests/gather_replay.py`) at M != N: a strided convolution's child map
  (coarse rows over a fine source), a deconvolution's up map (the
  reverse) and the transpose map d_feats runs over, against the plain
  version (f32, 1e-4 of the largest magnitude).
* The m=16 model and one training step on a plan whose chunk rulebooks
  were dropped at a level and a transition (the mixed route), against the
  JAX model from the same weights (`convert.from_flax`) on the unchunked
  plan of the same scene, where JAX takes the XLA gather convolution
  everywhere. Tolerances as `tests/test_torch_train.py`.
* A `PlanSpec(down_size=3, down_stride=2)` plan and its chunk rulebooks
  bit-identical to the JAX package's (and its blocked two-scene layout),
  and a UNet forward over it (size-3 transitions with 27 weights each)
  against the JAX UNet (f32, 1e-4).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from occuseg_tpu.core.point_layout import (
    apply_point_layout as jax_apply_layout,
    augment_plan_with_point_layout as jax_augment_layout,
)
from occuseg_tpu.core.sparse_tensor import SparseTensor as JaxSparse
from occuseg_tpu.core.topology import PlanSpec as JaxPlanSpec
from occuseg_tpu.data.synthetic import SceneConfig, make_batch
from occuseg_tpu.losses.instance import (
    occuseg_total_loss as jax_total_loss,
)
from occuseg_tpu.models import LearningBWDenseUNet as JaxLearningBW
from occuseg_tpu.nn.unet import UNet as JaxUNet
from occuseg_tpu.ops import conv as jax_conv
from occuseg_tpu.ops.pallas import chunk_conv as jax_cc
from tests.gather_replay import replay, tile_ids
from tests.jax_planner import host_plan as jax_build_plan_host

from occuseg_tpu_torch.convert import from_flax
from occuseg_tpu_torch.core.sparse_tensor import SparseTensor
from occuseg_tpu_torch.core.topology import PlanSpec
from occuseg_tpu_torch.models import LearningBWDenseUNet
from occuseg_tpu_torch.native.plan import build_plan_host
from occuseg_tpu_torch.nn import modules
from occuseg_tpu_torch.nn.unet import UNet
from occuseg_tpu_torch.ops import conv as conv_ops
from occuseg_tpu_torch.ops.kernels import chunk_conv as cc
from occuseg_tpu_torch.ops.kernels import gather_conv as gc
from occuseg_tpu_torch.train import state

torch.set_num_threads(2)

CAPS = (1024, 512, 256)
SCENE = SceneConfig(num_points=1500, extent=40, num_objects=5)


def _close(got, want, rtol=1e-5, floor=1e-5, msg=""):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=floor * max(np.abs(want).max(), 1e-30),
                               err_msg=msg)


@pytest.fixture(scope="module")
def plan():
    batch = make_batch(SCENE, num_scenes=1, p_cap=2048, num_instances=8,
                       seed=3)
    return build_plan_host(batch["coords"], PlanSpec(caps=CAPS))


def _maps(plan, kind):
    """(nbr [M, K], nbr_t [N, K], N, M) as the JAX docstring pairs them."""
    if kind == "sub":
        nbr = plan.levels[0].nbr
        return nbr, nbr, nbr.shape[0], nbr.shape[0]
    tr = plan.transitions[0]
    if kind == "child":
        return tr.child, tr.up[:, ::-1], tr.up.shape[0], tr.child.shape[0]
    return tr.up, tr.child[:, ::-1], tr.child.shape[0], tr.up.shape[0]


@pytest.mark.parametrize("kind", ["sub", "child", "up"])
@pytest.mark.parametrize("cin,cout", [(3, 8), (16, 24), (24, 64)])
def test_gather_conv_and_grads_match_jax_vjp(plan, kind, cin, cout):
    nbr, nbr_t, N, M = _maps(plan, kind)
    assert (nbr < 0).any() and (nbr >= 0).any()   # missing neighbours
    K = nbr.shape[1]
    rng = np.random.default_rng(cin * 100 + cout)
    feats = rng.standard_normal((N, cin)).astype(np.float32)
    w = (rng.standard_normal((K, cin, cout)) / (cin * K) ** .5
         ).astype(np.float32)
    r = rng.standard_normal((M, cout)).astype(np.float32)

    def f(x, ww):
        return jax_conv.gather_conv(x, jnp.asarray(nbr), ww,
                                    nbr_t=jnp.asarray(np.ascontiguousarray(
                                        nbr_t)))
    want, vjp = jax.vjp(f, jnp.asarray(feats), jnp.asarray(w))
    want_df, want_dw = vjp(jnp.asarray(r))

    x = torch.from_numpy(feats).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    before = gc.gather_conv.launches
    out = conv_ops.gather_conv(x, torch.from_numpy(nbr), wt,
                               nbr_t=torch.from_numpy(
                                   np.ascontiguousarray(nbr_t)))
    (out * torch.from_numpy(r)).sum().backward()
    assert gc.gather_conv.launches == before   # CPU: the plain version
    assert out.shape == (M, cout) and x.grad.shape == (N, cin)
    _close(out.detach().numpy(), want, msg="out")
    _close(x.grad.numpy(), want_df, msg="d_feats")
    _close(wt.grad.numpy(), want_dw, msg="dW")


def test_gather_conv_fused_and_flops_match_jax(plan):
    for kind in ("sub", "child", "up"):
        nbr, _, N, _ = _maps(plan, kind)
        K = nbr.shape[1]
        rng = np.random.default_rng(K)
        feats = rng.standard_normal((N, 24)).astype(np.float32)
        w = (rng.standard_normal((K, 24, 40)) * 0.1).astype(np.float32)
        b = rng.standard_normal(40).astype(np.float32)
        want = jax_conv.gather_conv_fused(jnp.asarray(feats),
                                          jnp.asarray(nbr), jnp.asarray(w),
                                          jnp.asarray(b))
        got = conv_ops.gather_conv_fused(torch.from_numpy(feats),
                                         torch.from_numpy(nbr),
                                         torch.from_numpy(w),
                                         torch.from_numpy(b))
        _close(got.numpy(), want, msg=kind)
        assert conv_ops.conv_flops(nbr, 24, 40) == int(
            jax_conv.conv_flops(jnp.asarray(nbr), 24, 40))


@pytest.mark.parametrize("what,cout,chunked,route", [
    ("sub", 16, True, "chunk"), ("sub", 8, True, "gather"),
    ("sub", 16, False, "gather"), ("down", 32, True, "chunk"),
    ("down", 24, True, "gather"), ("up", 16, False, "gather")])
def test_module_route(plan, monkeypatch, what, cout, chunked, route):
    """A map without a chunk rulebook, or an output width that is not a
    multiple of 16, takes the gather convolution; the TPU kernel's
    Cout >= 32 is not a condition here (16 stays on the chunk kernels)."""
    cplan = cc.augment_plan_with_chunks(plan)
    if not chunked:
        cplan = dataclasses.replace(
            cplan, levels=tuple(dataclasses.replace(l, chunks=None)
                                for l in cplan.levels),
            transitions=tuple(dataclasses.replace(
                t, child_chunks=None, up_chunks=None)
                for t in cplan.transitions))
    calls = []
    for name in ("chunk_gather_conv", "chunk_gather_conv_t"):
        real = getattr(modules, name)
        monkeypatch.setattr(modules, name, lambda *a, real=real: (
            calls.append("chunk"), real(*a))[1])
    real_g = conv_ops.gather_conv_kn
    monkeypatch.setattr(conv_ops, "gather_conv_kn", lambda *a, **k: (
        calls.append("gather"), real_g(*a, **k))[1])
    dplan = cplan.to("cpu")
    g = torch.Generator().manual_seed(0)
    cin, level = 12, 1 if what == "up" else 0
    if what == "sub":
        mod = modules.SubmanifoldConvolution(cin, cout, generator=g)
    elif what == "down":
        mod = modules.Convolution(cin, cout, generator=g)
    else:
        mod = modules.Deconvolution(cin, cout, generator=g)
    x = SparseTensor(torch.randn(CAPS[level], cin, generator=g),
                     dplan.levels[level].num_active, level)
    y = mod(x, dplan)
    assert calls == [route]
    lvl = {"sub": 0, "down": 1, "up": 0}[what]
    assert y.features.shape == (CAPS[lvl], cout) and y.level == lvl
    assert modules.chunk_route(dplan.levels[0].chunks, cout) == (
        chunked and cout % 16 == 0)


@pytest.mark.parametrize("what", ["sub", "down", "up"])
def test_module_gather_path_matches_jax_vjp(plan, what):
    """A module's gather route (the plan's maps in the kernel's
    orientation; a transition's backward map unflipped, with the weights
    unreversed) against the JAX gather convolution under `jax.vjp` with
    the docstring's pairing: output, d_feats and dW, f32, rtol 1e-5."""
    kind = {"sub": "sub", "down": "child", "up": "up"}[what]
    nbr, nbr_t, N, M = _maps(plan, kind)
    K, cin, cout = nbr.shape[1], 24, 40
    rng = np.random.default_rng(K + len(what))
    feats = rng.standard_normal((N, cin)).astype(np.float32)
    w = (rng.standard_normal((K, cin, cout)) / (cin * K) ** .5
         ).astype(np.float32)
    r = rng.standard_normal((M, cout)).astype(np.float32)
    want, vjp = jax.vjp(lambda x, ww: jax_conv.gather_conv(
        x, jnp.asarray(nbr), ww, nbr_t=jnp.asarray(
            np.ascontiguousarray(nbr_t))), jnp.asarray(feats), jnp.asarray(w))
    want_df, want_dw = vjp(jnp.asarray(r))

    dplan = plan.to("cpu")   # no rulebooks: every map is the gather path's
    g = torch.Generator().manual_seed(0)
    mod = {"sub": modules.SubmanifoldConvolution,
           "down": modules.Convolution,
           "up": modules.Deconvolution}[what](cin, cout, generator=g)
    with torch.no_grad():
        mod.weight.copy_(torch.from_numpy(w))
    level = 1 if what == "up" else 0
    x = torch.from_numpy(feats).requires_grad_()
    y = mod(SparseTensor(x, dplan.levels[level].num_active, level), dplan)
    (y.features * torch.from_numpy(r)).sum().backward()
    _close(y.features.detach().numpy(), want, msg="out")
    _close(x.grad.numpy(), want_df, msg="d_feats")
    _close(mod.weight.grad.numpy(), want_dw, msg="dW")


def test_plan_uploads_each_gather_map_once(plan):
    """`to` (and `pinned`, through the same `_map`) carries the maps
    without a rulebook in the kernel's orientation ([K, rows] int32); a map that keeps one is uploaded on its
    first `gather_map` and then reused; a plan moved again keeps them."""
    dropped = _drop(cc.augment_plan_with_chunks(plan))
    dplan = dropped.to("cpu")
    assert [set(l.kn) for l in dplan.levels] == [set(), {"nbr"}, set()]
    assert [set(t.kn) for t in dplan.transitions] == [{"child", "up"},
                                                      set()]
    assert all(not t.kn for t in dropped.transitions)  # the host plan's
    for obj, name in ((dplan.levels[1], "nbr"), (dplan.transitions[0],
                                                 "child"),
                      (dplan.transitions[0], "up")):
        m = obj.gather_map(name, torch.device("cpu"))
        assert m.dtype == torch.int32 and m.is_contiguous()
        np.testing.assert_array_equal(m.numpy(),
                                      np.asarray(getattr(obj, name)).T)
        assert obj.gather_map(name, torch.device("cpu")) is m
    lvl0 = dplan.levels[0]
    first = lvl0.gather_map("nbr", torch.device("cpu"))   # keeps a rulebook
    assert lvl0.gather_map("nbr", torch.device("cpu")) is first
    np.testing.assert_array_equal(first.numpy(), lvl0.nbr.T)
    again = dplan.to("cpu")
    assert again.levels[0].kn["nbr"] is first
    assert again.transitions[0].kn["up"] is dplan.transitions[0].kn["up"]


@pytest.mark.parametrize("kind,sms", [("child", 132), ("up", 132),
                                      ("child_t", 1), ("up_t", 132)])
def test_replay_at_m_not_n(plan, kind, sms):
    """The bf16 kernel's work split with M output rows over N source rows:
    `child` (M coarse over N fine), `up` (the reverse), and the transpose
    maps the backward's d_feats runs over (child_t = up reversed: fine
    rows over the coarse cotangent; up_t = child reversed)."""
    tr = plan.transitions[0]
    nbr = {"child": tr.child, "up": tr.up, "child_t": tr.up[:, ::-1],
           "up_t": tr.child[:, ::-1]}[kind]
    n_src = {"child": tr.up.shape[0], "up": tr.child.shape[0],
             "child_t": tr.child.shape[0], "up_t": tr.up.shape[0]}[kind]
    M = nbr.shape[0]
    assert M != n_src
    rng = np.random.default_rng(M)
    feats = rng.standard_normal((n_src, 136)).astype(np.float32)
    w = (rng.standard_normal((8, 136, 72)) * 0.1).astype(np.float32)
    nbr_kn = np.ascontiguousarray(nbr.T)
    got, skipped, (nt, splits) = replay(feats, nbr_kn, w, sms)
    plain = gc.gather_conv_plain(torch.from_numpy(feats),
                                 torch.from_numpy(nbr_kn),
                                 torch.from_numpy(w)).numpy()
    assert got.shape == plain.shape == (M, 72)
    assert splits == gc.geometry(M, 136, 72, 8, sms)[1]
    assert skipped == sum(int((tile_ids(nbr_kn, t, n_src) < 0).all(1).sum())
                          for t in range(-(-M // gc.TILE)))
    _close(got, plain, rtol=1e-4, floor=1e-4)


# the mixed route's model: m=16, three levels
M16 = (16, 32, 48)
P_CAP, I = 2048, 8


def _drop(plan):
    """The plan's chunk rulebooks without those of level 1 and transition
    0: those convolutions take the gather path, the others the chunk
    kernels."""
    lv = list(plan.levels)
    lv[1] = dataclasses.replace(lv[1], chunks=None)
    tr = list(plan.transitions)
    tr[0] = dataclasses.replace(tr[0], child_chunks=None, up_chunks=None)
    return dataclasses.replace(plan, levels=tuple(lv), transitions=tuple(tr))


@pytest.fixture(scope="module")
def mixed():
    """A scene, its port batch and mixed-route plan, and the JAX model's
    loss, gradients and statistics of one step on the unchunked plan."""
    batch = make_batch(SCENE, num_scenes=1, p_cap=P_CAP, num_instances=I,
                       seed=5)
    jp = jax_augment_layout(jax_build_plan_host(batch["coords"],
                                                JaxPlanSpec(caps=CAPS)))
    jb = {k: jnp.asarray(v) for k, v in
          jax_apply_layout(batch, jp, num_scenes=1).items()}
    jplan = jax.tree.map(jnp.asarray, jp)
    model = JaxLearningBW(n_planes=M16, num_classes=20)
    variables = model.init(jax.random.PRNGKey(4), jb["features"], jplan,
                           False)
    params = jax.tree.map(np.asarray, variables["params"])
    stats = jax.tree.map(np.asarray, variables["batch_stats"])

    @jax.jit
    def loss_and_grad(p, s):
        def loss_fn(p):
            out, mut = model.apply({"params": p, "batch_stats": s},
                                   jb["features"], jplan, True,
                                   mutable=["batch_stats"])
            total, parts = jax_total_loss(out, jb, 1, I)
            return total, (parts, mut["batch_stats"])
        return jax.value_and_grad(loss_fn, has_aux=True)(p)

    (_, (parts, new_stats)), grads = loss_and_grad(params, stats)
    eval_out = jax.jit(lambda p, s: model.apply(
        {"params": p, "batch_stats": s}, jb["features"], jplan, False))(
            params, stats)
    laid, tplan = state.prepare_batch(batch, PlanSpec(caps=CAPS))
    return dict(params=params, stats=stats, laid=laid, plan=_drop(tplan),
                parts=jax.tree.map(np.asarray, parts),
                grads=jax.tree.map(np.asarray, grads),
                new_stats=jax.tree.map(np.asarray, new_stats),
                eval_out=jax.tree.map(np.asarray, eval_out))


def _model(mixed):
    m = LearningBWDenseUNet(M16, num_classes=20)
    m.load_state_dict(from_flax(mixed["params"], mixed["stats"], m))
    return m


def test_mixed_route_forward_matches_jax(mixed):
    plan = mixed["plan"]
    assert plan.levels[1].chunks is None and plan.levels[0].chunks is not None
    assert plan.transitions[0].child_chunks is None
    out = state.Predictor(_model(mixed), "cpu").forward(
        mixed["laid"]["features"], plan)
    want = mixed["eval_out"]
    for name in out._fields:
        _close(getattr(out, name).detach().numpy(), getattr(want, name),
               rtol=1e-4, floor=1e-4, msg=name)


def test_mixed_route_train_step_matches_jax(mixed):
    model = _model(mixed)
    trainer = state.Trainer(model, "cpu", num_instances=I)
    parts = trainer.step(mixed["laid"], mixed["plan"])
    for k, v in parts.items():
        np.testing.assert_allclose(float(v), mixed["parts"][k], rtol=1e-4,
                                   atol=1e-5, err_msg=k)
    ref = from_flax(mixed["grads"], mixed["new_stats"], model)
    for name, p in model.named_parameters():
        want = ref[name].numpy()
        np.testing.assert_allclose(
            p.grad.numpy(), want, rtol=1e-4,
            atol=max(1e-4 * np.abs(want).max(), 1e-6), err_msg=name)
    for name, b in model.named_buffers():
        np.testing.assert_allclose(b.numpy(), ref[name].numpy(), rtol=1e-4,
                                   atol=1e-5, err_msg=name)


SIZE3 = dict(down_size=3, down_stride=2)


@pytest.fixture(scope="module")
def size3():
    batch = make_batch(SCENE, num_scenes=1, p_cap=P_CAP, num_instances=I,
                       seed=6)
    jp = jax_build_plan_host(batch["coords"], JaxPlanSpec(caps=CAPS,
                                                          **SIZE3))
    tp = build_plan_host(batch["coords"], PlanSpec(caps=CAPS, **SIZE3))
    return jp, tp


def test_size3_plan_and_chunks_match_jax(size3):
    jp, tp = size3
    for jl, tl in zip(jp.levels, tp.levels):
        for f in ("keys", "coords", "nbr"):
            assert np.array_equal(np.asarray(getattr(jl, f)),
                                  getattr(tl, f)), f
        assert int(jl.num_active) == tl.num_active
    for jt, tt in zip(jp.transitions, tp.transitions):
        assert (jt.size, jt.stride) == (tt.size, tt.stride) == (3, 2)
        assert tt.child.shape[1] == tt.up.shape[1] == 27
        assert np.array_equal(np.asarray(jt.child), tt.child)
        assert np.array_equal(np.asarray(jt.up), tt.up)
    assert np.array_equal(np.asarray(jp.p2v), tp.p2v)
    jc, tc = jax_cc.augment_plan_with_chunks(jp), \
        cc.augment_plan_with_chunks(tp)
    assert tc.chunk_tier == jax_cc.LAST_TIER
    pairs = [(a.chunks, b.chunks) for a, b in zip(jc.levels, tc.levels)]
    for a, b in zip(jc.transitions, tc.transitions):
        pairs += [(a.child_chunks, b.child_chunks), (a.up_chunks,
                                                     b.up_chunks)]
    for a, b in pairs:
        assert (a is None) == (b is None)
        if a is not None:
            assert np.array_equal(np.asarray(a.in_idx), b.in_idx)
            assert np.array_equal(np.asarray(a.lidx), b.lidx)


def test_size3_blocked_plan_matches_jax():
    """The blocked two-scene layout (`native/blocked.py`) of a size-3
    plan: each scene planned alone, the maps (27 offsets) shifted by the
    scene's block, bit for bit against the JAX package's."""
    from occuseg_tpu_torch.native.blocked import build_plan_host_blocked
    from tests.jax_planner import host_plan_blocked
    batch = make_batch(SCENE, num_scenes=2, p_cap=2 * P_CAP,
                       num_instances=I, seed=9)
    jp = host_plan_blocked(batch["coords"], JaxPlanSpec(caps=CAPS, **SIZE3),
                           2)
    tp = build_plan_host_blocked(batch["coords"], PlanSpec(caps=CAPS,
                                                           **SIZE3), 2)
    for jl, tl in zip(jp.levels, tp.levels):
        assert np.array_equal(np.asarray(jl.nbr), tl.nbr)
        assert np.array_equal(np.asarray(jl.num_active), tl.num_active)
    for jt, tt in zip(jp.transitions, tp.transitions):
        assert (tt.size, tt.stride, tt.child.shape[1]) == (3, 2, 27)
        assert np.array_equal(np.asarray(jt.child), tt.child)
        assert np.array_equal(np.asarray(jt.up), tt.up)
    assert np.array_equal(np.asarray(jp.p2v), tp.p2v)


def test_size3_unet_forward_matches_jax(size3):
    jp, tp = size3
    tp = cc.augment_plan_with_chunks(tp)
    jplan = jax.tree.map(jnp.asarray, jp)
    n0 = tp.levels[0].num_active
    rng = np.random.default_rng(7)
    x = rng.standard_normal((CAPS[0], 16)).astype(np.float32)
    x[n0:] = 0
    jmod = JaxUNet(reps=1, n_planes=M16, residual_blocks=True, **SIZE3)
    jx = JaxSparse(features=jnp.asarray(x), num_active=jnp.int32(n0),
                   level=0)
    variables = jmod.init(jax.random.PRNGKey(8), jx, jplan, False)
    want = jmod.apply(variables, jx, jplan, False).features
    unet = UNet(1, M16, residual_blocks=True, **SIZE3)
    assert unet.down_conv.weight.shape == (27, 16, 32)
    unet.load_state_dict(from_flax(
        jax.tree.map(np.asarray, variables["params"]),
        jax.tree.map(np.asarray, variables["batch_stats"]), unet))
    unet.eval()
    with torch.no_grad():
        got = unet(SparseTensor(torch.from_numpy(x), n0, 0), tp.to("cpu"))
    _close(got.features.numpy(), want, rtol=1e-4, floor=1e-4)
