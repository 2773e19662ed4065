"""The port's op-library extras (`nn/extras.py`), SpectralDense and the new
leaves of `convert.from_flax` against the JAX package on the CPU.

Every module runs on the same seeded features and plan (the device
planners' plans, bit for bit alike) with the same weights
(`convert.from_flax`): outputs, gradients (of the features and the
parameters, against `jax.vjp`) and new statistics, f32, rtol 1e-5 with an
absolute floor of 1e-5 of the reference's largest magnitude, as
`tests/test_torch_full_conv.py`. The dropouts draw from other generators
than JAX's, so they are held by structure: eval mode exactly as the JAX
module, training mode each entry (or channel) either 0 or scaled as the
reference says, and not all of them kept. Coordinates (`dense_to_sparse_coords`,
`sparsify_coords`) are compared exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from occuseg_tpu.core import topology as JT
from occuseg_tpu.core.sparse_tensor import SparseTensor as JaxSparse
from occuseg_tpu.nn import extras as jx_extras
from occuseg_tpu.nn.spectral_norm import SpectralDense as JaxSpectralDense
from tests.utils import random_points

from occuseg_tpu_torch.convert import from_flax
from occuseg_tpu_torch.core import topology as T
from occuseg_tpu_torch.core.sparse_tensor import SparseTensor
from occuseg_tpu_torch.nn import extras
from occuseg_tpu_torch.nn.spectral_norm import SpectralDense

torch.set_num_threads(2)

CAPS = (512, 256, 128)
E = 12   # spatial extent
CIN = 4


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
def scene():
    rng = np.random.default_rng(21)
    pts = random_points(rng, 400, extent=E, batch_size=2, pad_to=CAPS[0])
    jp = JT.build_plan(jnp.asarray(pts), JT.PlanSpec(caps=CAPS))
    tp = T.build_plan(torch.from_numpy(pts), T.PlanSpec(caps=CAPS))
    n = tp.levels[0].num_active
    feats = np.zeros((CAPS[0], CIN), np.float32)
    feats[:n] = rng.standard_normal((n, CIN))
    return dict(jp=jp, tp=tp, n=n, feats=feats, rng=rng)


def _jx(scene, feats=None, level=0):
    f = scene["feats"] if feats is None else feats
    return JaxSparse(features=jnp.asarray(f),
                     num_active=scene["jp"].levels[level].num_active,
                     level=level)


def _tx(scene, feats=None, level=0):
    f = scene["feats"] if feats is None else feats
    return SparseTensor(features=torch.from_numpy(f).requires_grad_(),
                        num_active=scene["tp"].levels[level].num_active,
                        level=level)


def _vs_jax(scene, jmod, tmod, train=False, level=0, feats=None,
            out_of=lambda y: y.features):
    """Forward and gradients (features and parameters) of a flax module
    and the port's on the same inputs and weights; returns the port's
    module after its call and the JAX statistics after the call."""
    jx = _jx(scene, feats, level)
    variables = jmod.init(jax.random.PRNGKey(1), jx, scene["jp"], False)
    params = variables.get("params", {})
    stats = {k: v for k, v in variables.items() if k != "params"}
    tmod.load_state_dict(from_flax(_np_tree(params),
                                   _np_tree(stats.get("batch_stats", {})),
                                   tmod))

    def fwd(f, p):
        out = jmod.apply({"params": p, **stats}, jx.with_features(f),
                         scene["jp"], train,
                         mutable=list(stats) if train else False)
        out, new = out if train else (out, stats)
        return out_of(out), new
    jout, vjp, new_stats = jax.vjp(fwd, jx.features, params, has_aux=True)
    ct = scene["rng"].standard_normal(jout.shape).astype(np.float32)
    j_df, j_dp = vjp(jnp.asarray(ct))

    tx = _tx(scene, feats, level)
    tmod.train(train)
    out = out_of(tmod(tx, scene["tp"]))
    (out * torch.from_numpy(ct)).sum().backward()
    _close(out, jout, what="forward")
    _close(tx.features.grad, j_df, what="d_feats")
    for path, g in jax.tree_util.tree_flatten_with_path(j_dp)[0]:
        name = ".".join(str(k.key) for k in path)
        name = {"kernel": "weight"}.get(name, name)
        tg = dict(tmod.named_parameters())[name].grad
        _close(tg.t() if path[-1].key == "kernel" else tg, g,
               what=f"d {name}")
    return tmod, _np_tree(new_stats)


ACTS = ["Identity", "ReLU", "Tanh", "Sigmoid", "ELU", "SELU", "LeakyReLU"]


@pytest.mark.parametrize("name", ACTS)
def test_activation_matches_jax(scene, name):
    feats = scene["feats"].copy()
    feats[:20] = 0.0   # ties at 0, where ReLU splits its gradient
    _vs_jax(scene, getattr(jx_extras, name)(), getattr(extras, name)(),
            feats=feats)


@pytest.mark.parametrize("name,scaled,per_channel", [
    ("Dropout", True, False), ("BatchwiseDropout", True, True),
    ("SpatialDropOut", False, True)])
def test_dropout_structure(scene, name, scaled, per_channel):
    p = 0.4
    jmod = getattr(jx_extras, name)(p=p)
    jout = jmod.apply({}, _jx(scene), scene["jp"], False)
    mod = getattr(extras, name)(p=p, generator=torch.Generator()
                                .manual_seed(0))
    mod.eval()
    x = _tx(scene)
    _close(mod(x, scene["tp"]).features, jout.features, rtol=0, floor=0,
           what="eval")
    mod.train()
    f = x.features.detach().numpy()
    ys = [mod(x, scene["tp"]).features.detach().numpy() for _ in range(2)]
    assert not np.array_equal(ys[0], ys[1])   # the generator advances
    n = scene["n"]
    for y in ys:
        kept = y[:n] != 0
        if per_channel:   # one mask for every row
            assert (kept == kept[:1]).all()
        want = f[:n] / (1 - p) if scaled else f[:n]
        assert np.array_equal(y[:n][kept], want[kept])
        assert 0 < kept.mean() < 1
    if name == "Dropout":   # p = 0 is the identity in training too
        same = extras.Dropout(p=0.0).train()(x, scene["tp"])
        assert same.features is x.features


def test_affine_relu_trivial_convolution_matches_jax(scene):
    _vs_jax(scene, jx_extras.AffineReluTrivialConvolution(6),
            extras.AffineReluTrivialConvolution(CIN, 6))


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_mean_only_bn_leaky_relu_matches_jax(scene, train):
    jm = jx_extras.MeanOnlyBNLeakyReLU(leakiness=0.1)
    tm = extras.MeanOnlyBNLeakyReLU(CIN, leakiness=0.1)
    tm, new = _vs_jax(scene, jm, tm, train=train)
    ref = new["batch_stats"]["running_mean"] if train else np.zeros(CIN)
    _close(tm.running_mean, ref, what="running_mean")


@pytest.mark.parametrize("mode", ["mean", "max"])
def test_active_pooling_matches_jax(scene, mode):
    _vs_jax(scene, jx_extras.ActivePooling(mode=mode, num_samples=3),
            extras.ActivePooling(mode=mode, num_samples=3),
            out_of=lambda y: y)


def test_shape_contexts_match_jax(scene):
    _vs_jax(scene, jx_extras.ShapeContext(), extras.ShapeContext())
    _vs_jax(scene, jx_extras.MultiscaleShapeContext(num_scales=3),
            extras.MultiscaleShapeContext(num_scales=3))


def test_sparse_to_dense_and_back_match_jax(scene):
    jd = jx_extras.sparse_to_dense(_jx(scene), scene["jp"], E, 2)
    x = _tx(scene)
    d = extras.sparse_to_dense(x, scene["tp"], E, 2)
    _close(d, jd, rtol=0, floor=0, what="dense")
    ct = torch.randn(d.shape, generator=torch.Generator().manual_seed(2))
    (d * ct).sum().backward()
    _, vjp = jax.vjp(lambda f: jx_extras.sparse_to_dense(
        _jx(scene).with_features(f), scene["jp"], E, 2), _jx(scene).features)
    _close(x.features.grad, vjp(jnp.asarray(ct.numpy()))[0], what="grad")
    mask = np.abs(jd).sum(-1) > 0
    for cap in (CAPS[0], 100):   # the padded and the truncated result
        jc = jx_extras.dense_to_sparse_coords(jnp.asarray(mask), cap)
        tc = extras.dense_to_sparse_coords(torch.from_numpy(mask), cap)
        assert tc.dtype == torch.int32
        assert np.array_equal(tc.numpy(), np.asarray(jc))


@pytest.mark.parametrize("bilinear", [False, True],
                         ids=["nearest", "trilinear"])
def test_upsample_feature_matches_jax(scene, bilinear):
    rng = scene["rng"]
    m = scene["tp"].levels[1].num_active
    cf = np.zeros((CAPS[1], CIN), np.float32)
    cf[:m] = rng.standard_normal((m, CIN))

    def jfn(f):
        return jx_extras.upsample_feature(
            _jx(scene, cf, 1).with_features(f), 0, scene["jp"],
            bilinear=bilinear).features
    jout, vjp = jax.vjp(jfn, jnp.asarray(cf))
    ct = rng.standard_normal(jout.shape).astype(np.float32)
    lr = _tx(scene, cf, 1)
    up = extras.upsample_feature(lr, 0, scene["tp"], bilinear=bilinear)
    assert up.level == 0 and up.num_active == scene["n"]
    (up.features * torch.from_numpy(ct)).sum().backward()
    _close(up.features, jout, what="forward")
    _close(lr.features.grad, vjp(jnp.asarray(ct))[0], what="gradient")
    with pytest.raises(ValueError, match="coarser"):
        extras.upsample_feature(lr, 1, scene["tp"])


def test_add_coords_compare_and_sparsify_match_jax(scene):
    jx, tx = _jx(scene), _tx(scene)
    _close(extras.add_coords(tx, scene["tp"], 0.5).features,
           jx_extras.add_coords(jx, scene["jp"], 0.5).features,
           what="add_coords")
    # a second topology: the same points shifted by one voxel in x
    rng = np.random.default_rng(22)
    pts = random_points(rng, 400, extent=E, batch_size=2, pad_to=CAPS[0])
    jp2 = JT.build_plan(jnp.asarray(pts), JT.PlanSpec(caps=CAPS))
    tp2 = T.build_plan(torch.from_numpy(pts), T.PlanSpec(caps=CAPS))
    n2 = tp2.levels[0].num_active
    f2 = np.zeros((CAPS[0], CIN), np.float32)
    f2[:n2] = rng.standard_normal((n2, CIN))
    ref = jx_extras.compare_sparse(
        scene["jp"], jx, jp2, JaxSparse(features=jnp.asarray(f2),
                                        num_active=jp2.levels[0].num_active,
                                        level=0))
    got = extras.compare_sparse(scene["tp"], tx, tp2, SparseTensor(
        features=torch.from_numpy(f2), num_active=n2, level=0))
    _close(got, ref, what="compare_sparse")
    assert float(extras.compare_sparse(scene["tp"], tx, scene["tp"], tx)) \
        == 0.0
    for cap, thr in ((CAPS[0], 2.0), (50, 0.5)):
        jc = jx_extras.sparsify_coords(jx, scene["jp"], cap, thr)
        tc = extras.sparsify_coords(tx, scene["tp"], cap, thr)
        assert np.array_equal(tc.numpy(), np.asarray(jc)), (cap, thr)
        assert (tc[:, 0] >= 0).sum() > 0


def test_spectral_dense_matches_jax():
    rng = np.random.default_rng(23)
    x = rng.standard_normal((16, 8)).astype(np.float32)
    ct = rng.standard_normal((16, 5)).astype(np.float32)
    jm = JaxSpectralDense(5, n_power_iterations=2)
    v = jm.init(jax.random.PRNGKey(0), jnp.asarray(x), False)
    m = SpectralDense(8, 5, n_power_iterations=2)
    m.load_state_dict(from_flax(_np_tree(v["params"]), {}, m,
                                spectral=_np_tree(v["spectral"])))
    for train in (False, True):
        def fwd(xx, p):
            return jm.apply({"params": p, "spectral": v["spectral"]}, xx,
                            train, mutable=["spectral"])
        (jy, mut), vjp = jax.vjp(fwd, jnp.asarray(x), v["params"])
        j_dx, j_dp = vjp((jnp.asarray(ct), jax.tree.map(jnp.zeros_like,
                                                         mut)))
        m.load_state_dict(from_flax(_np_tree(v["params"]), {}, m,
                                    spectral=_np_tree(v["spectral"])))
        m.train(train)
        m.zero_grad()
        tx = torch.from_numpy(x).requires_grad_()
        y = m(tx)
        (y * torch.from_numpy(ct)).sum().backward()
        _close(y, jy, what=f"train={train} output")
        _close(tx.grad, j_dx, what="d_x")
        _close(m.weight.grad.t(), j_dp["kernel"], what="d_kernel")
        _close(m.bias.grad, j_dp["bias"], what="d_bias")
        u_want = mut["spectral"]["u"] if train else v["spectral"]["u"]
        _close(m.u, u_want, what="u")
        if train:
            assert not np.allclose(m.u.numpy(), np.asarray(v["spectral"]["u"]))


def test_from_flax_new_leaves_and_errors():
    """Each new leaf mapped by name and shape, and the errors kept."""
    affine = extras.AffineReluTrivialConvolution(4, 6)
    p = {"affine_weight": np.ones(4), "affine_bias": np.zeros(4),
         "weight": np.zeros((4, 6))}
    assert set(from_flax(p, {}, affine)) == set(affine.state_dict())
    mean_only = extras.MeanOnlyBNLeakyReLU(4)
    sd = from_flax({"bias": np.full(4, 2.0)},
                   {"running_mean": np.arange(4.0)}, mean_only)
    assert torch.equal(sd["running_mean"], torch.arange(4.0))
    from occuseg_tpu_torch.models.occuseg import _DenseBatchNorm
    bn = torch.nn.Module()
    bn.l1_bn = _DenseBatchNorm(3)
    sd = from_flax({"l1_bn": {"scale": np.full(3, 2.0), "bias": np.zeros(3)}},
                   {"l1_bn": {"mean": np.ones(3), "var": np.full(3, 4.0)}},
                   bn)
    assert torch.equal(sd["l1_bn.weight"], torch.full((3,), 2.0))
    assert torch.equal(sd["l1_bn.running_var"], torch.full((3,), 4.0))
    spec = SpectralDense(3, 2)
    sd = from_flax({"kernel": np.zeros((3, 2)), "bias": np.zeros(2)}, {},
                   spec, spectral={"u": np.ones(2)})
    assert sd["weight"].shape == (2, 3) and torch.equal(sd["u"],
                                                        torch.ones(2))
    with pytest.raises(ValueError, match="statistics"):   # BN, no stats
        from_flax({"l1_bn": {"scale": np.ones(3), "bias": np.zeros(3)}}, {})
    with pytest.raises(ValueError, match="statistics"):   # stats, no layer
        from_flax({}, {"x": {"running_mean": np.zeros(3)}})
    with pytest.raises(ValueError, match="statistics"):   # one stat short
        from_flax({"l1_bn": {"scale": np.ones(3), "bias": np.zeros(3)}},
                  {"l1_bn": {"mean": np.ones(3)}})
    with pytest.raises(ValueError, match="unknown"):
        from_flax({}, {}, spectral={"v": np.ones(2)})
    with pytest.raises(ValueError, match="unknown"):
        from_flax({"gamma": np.ones(2)}, {})
