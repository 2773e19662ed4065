"""The port's other model families, builders and the classification
harness against the JAX package on the CPU.

* FullyConvolutionalNet, SparseVggNet (simple, with "MP" and "C3/2", and
  with the "Plus" specs down to depth 3), SparseResNet (stride-2 basic
  blocks), ThreeVoxelKernel and DenseUNet_BN over the device planners'
  plans (bit for bit alike), in eval and training mode, from the same weights
  (`convert.from_flax` with the model, so every flax name must match):
  outputs within 1e-4 (as `tests/test_torch_model.py`), gradients of the
  input features and of every parameter within 1e-4 of each tensor's
  largest magnitude (against `jax.vjp`), and in training mode the new BN
  statistics within 1e-4.
* DenseUNet_BN with `output_feature_lvl` = 1: its level-0 output
  repeats the level-1 decoder output site by site.
* ClusterSegNet (flax's plain BatchNorm: every row, the biased running
  variance): output, gradients and running statistics after one
  training-mode call, then the eval-mode output from them.
* `classification_train_validate` for one epoch on the CPU against the
  JAX harness on the same batches from the JAX harness's initial weights:
  the history within 1e-4; and the default device raises without a card.
"""

import functools

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from occuseg_tpu.core import topology as JT
from occuseg_tpu.core.sparse_tensor import SparseTensor as JaxSparse
from occuseg_tpu.models import occuseg as jmodels
from occuseg_tpu.nn import extras as jx_extras
from occuseg_tpu.nn import modules as jmod
from occuseg_tpu.nn import unet as junet
from occuseg_tpu.train.classification import (
    classification_train_validate as jax_harness,
)
from tests.utils import random_points

from occuseg_tpu_torch import models, nn as tnn
from occuseg_tpu_torch.convert import from_flax
from occuseg_tpu_torch.core import topology as T
from occuseg_tpu_torch.core.sparse_tensor import SparseTensor
from occuseg_tpu_torch.nn import extras
from occuseg_tpu_torch.nn import modules as tmod
from occuseg_tpu_torch.train import classification

torch.set_num_threads(2)

TOL = 1e-4
CAPS2 = (512, 256, 128)            # 2/2 transitions
CAPS3 = (512, 1024, 512, 256)      # 3/2 transitions


def _close(got, ref, what="", scale=0.0):
    """Within TOL of the reference's largest magnitude, or of `scale` where
    that is larger."""
    ref = np.asarray(ref)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    np.testing.assert_allclose(
        got, ref, rtol=TOL, atol=TOL * max(np.abs(ref).max(), scale, 1e-30),
        err_msg=what)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _port_name(path):
    keys = [str(k.key) for k in path]
    leaf = {"kernel": "weight", "scale": "weight", "mean": "running_mean",
            "var": "running_var"}.get(keys[-1], keys[-1])
    return ".".join(keys[:-1] + [leaf]), keys[-1] == "kernel"


def _check_tree(tree, tensors, what, floor=0.0):
    """Each leaf within TOL of its largest magnitude; with `floor`, of at
    least `floor` of the tree's largest: a gradient that is zero in exact
    arithmetic (the bias just before a training-mode batch norm) holds
    rounding noise only, of either side's own summation order."""
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    top = max(float(np.abs(np.asarray(r)).max()) for _, r in leaves)
    for path, ref in leaves:
        name, transposed = _port_name(path)
        got = tensors[name]
        _close(got.t() if transposed else got, ref, what=f"{what} {name}",
               scale=floor * top)


@functools.lru_cache(maxsize=None)
def _plans(caps, down_size=2, n_points=300, extent=16, batch=2, p_cap=512):
    """The device planners' plans of one seeded cloud, bit for bit alike
    (built once per configuration)."""
    rng = np.random.default_rng(7)
    pts = random_points(rng, n_points, extent=extent, batch_size=batch,
                        pad_to=p_cap)
    jp = JT.build_plan(jnp.asarray(pts), JT.PlanSpec(
        caps=caps, down_size=down_size, down_stride=2))
    tp = T.build_plan(torch.from_numpy(pts), T.PlanSpec(
        caps=caps, down_size=down_size, down_stride=2))
    for tl, jl in zip(tp.levels, jp.levels):
        assert np.array_equal(tl.keys.numpy(), np.asarray(jl.keys))
        assert tl.num_active < tl.cap
    return pts, jp, tp


def _plan(seed, caps, down_size=2):
    pts, jp, tp = _plans(caps, down_size)
    return np.random.default_rng(seed), pts, jp, tp


def _seeded_variables(jm, *args):
    """Variables of the flax model's structure (traced, not compiled):
    weights and biases seeded normals at the He scale of their fan-in,
    BN scales near 1 and running statistics non-trivial."""
    *args, rng = args
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(2), *args,
                                            False))

    def leaf(path, sd):
        name = str(path[-1].key)
        if name in ("weight", "kernel") and len(sd.shape) > 1:
            fan = int(np.prod(sd.shape[:-1]))
            return rng.standard_normal(sd.shape) * (2.0 / fan) ** 0.5
        if name in ("running_var", "var"):
            return rng.uniform(0.5, 2.0, sd.shape)
        if name in ("weight", "scale"):
            return 1.0 + 0.2 * rng.standard_normal(sd.shape)
        return 0.1 * rng.standard_normal(sd.shape)
    return jax.tree_util.tree_map_with_path(
        lambda p, sd: jnp.asarray(leaf(p, sd), jnp.float32), shapes)


def _jax_ref(jm, jx, jp, out_of, rng):
    """The flax model's initial variables, and per mode (eval, train) its
    output, the gradients of the input features and the parameters
    against seeded cotangents, the cotangents and the new statistics; one
    jitted call each."""
    variables = _seeded_variables(jm, jx, jp, rng)
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    is_sparse = hasattr(jx, "features")
    f0 = jx.features if is_sparse else jx

    def fwd(f, p, train):
        out = jm.apply({"params": p, "batch_stats": stats},
                       jx.with_features(f) if is_sparse else f, jp, train,
                       mutable=["batch_stats"] if train else False)
        out, new = out if train else (out, {"batch_stats": stats})
        return out_of(out), new["batch_stats"]
    shapes = jax.eval_shape(lambda: fwd(f0, params, False)[0])
    cts = [jax.tree.map(lambda o: jnp.asarray(rng.standard_normal(o.shape)
                                              .astype(np.float32)), shapes)
           for _ in range(2)]

    @jax.jit
    def both(f, p, cts):
        res = []
        for train, ct in zip((False, True), cts):
            out, vjp, new = jax.vjp(lambda f, p: fwd(f, p, train), f, p,
                                    has_aux=True)
            res.append((out, vjp(ct), new))
        return res
    res = both(f0, params, cts)
    return _np_tree(variables), [
        (_np_tree(o), _np_tree(g), _np_tree(c), _np_tree(n))
        for (o, g, n), c in zip(res, cts)]


def _vs_jax(jm, tm, jx, jp, tx_of, tp, out_of, rng):
    """Forward and gradients of a flax model and the port's from the same
    weights, in eval and in training mode, and the new BN statistics."""
    variables, modes = _jax_ref(jm, jx, jp, out_of, rng)
    f0 = np.asarray(jx.features if hasattr(jx, "features") else jx)
    for train, (jout, (j_df, j_dp), cts, new_stats) in zip((False, True),
                                                          modes):
        tm.load_state_dict(from_flax(variables["params"],
                                     variables.get("batch_stats", {}), tm))
        tm.zero_grad(set_to_none=True)
        tm.train(train)
        f = torch.from_numpy(f0.copy()).requires_grad_()
        tout = out_of(tm(tx_of(f), tp))
        loss = sum((o * torch.from_numpy(c)).sum() for o, c in
                   zip(jax.tree.leaves(tout), jax.tree.leaves(cts)))
        loss.backward()
        for o, r in zip(jax.tree.leaves(tout), jax.tree.leaves(jout)):
            _close(o, r, what=f"train={train} forward")
        _close(f.grad, j_df, what=f"train={train} d_input")
        _check_tree(j_dp, {n: p.grad for n, p in tm.named_parameters()},
                    f"train={train} gradient", floor=1e-2)
        if train:
            _check_tree(new_stats, dict(tm.named_buffers()), "statistic")
    return tm


def _sparse_in(rng, jp, tp, cin):
    n = tp.levels[0].num_active
    feats = np.zeros((tp.levels[0].cap, cin), np.float32)
    feats[:n] = rng.standard_normal((n, cin))
    jx = JaxSparse(features=jnp.asarray(feats),
                   num_active=jp.levels[0].num_active, level=0)
    return jx, lambda f: SparseTensor(features=f, num_active=n, level=0)


def _builder(kind):
    """(flax model, port model, plan caps, down_size, input width)."""
    if kind == "fcn":
        return (junet.FullyConvolutionalNet(reps=1, n_planes=(8, 16, 24)),
                tnn.FullyConvolutionalNet(1, (8, 16, 24)), CAPS2, 2, 8)
    if kind == "vgg":
        layers = (("C", 8), ("C", 8), "MP", ("C", 16), "C3/2", ("C3/2", 24))
        return (junet.SparseVggNet(layers=layers),
                tnn.SparseVggNet(4, layers), CAPS3, 3, 4)
    if kind == "vgg_plus":
        layers = (("C", 8, 8), ("C", 4, 4, 4, 4))
        return (junet.SparseVggNet(layers=layers),
                tnn.SparseVggNet(4, layers), CAPS3, 3, 4)
    if kind == "resnet":
        layers = (("b", 8, 2, 1), ("b", 16, 2, 2), ("b", 24, 1, 2))
        return (junet.SparseResNet(layers=layers),
                tnn.SparseResNet(4, layers), CAPS3, 3, 4)
    if kind == "dense_unet":
        return (jmodels.DenseUNet_BN(n_planes=(8, 16, 24), leakiness=0.1),
                models.DenseUNet_BN((8, 16, 24), leakiness=0.1), CAPS2, 2, 8)
    return (jmodels.DenseUNet_BN(n_planes=(8, 16, 24), output_feature_lvl=1,
                                 block_reps=2),
            models.DenseUNet_BN((8, 16, 24), block_reps=2,
                                output_feature_lvl=1), CAPS2, 2, 8)


def test_dense_unet_output_level_is_brought_up():
    """`output_feature_lvl` = 1: the decoder stops at level 1 and its
    output reaches level 0 by nearest upsampling (each level-0 site takes
    its covering level-1 site's features; padding rows 0), with the JAX
    module's parameter names."""
    jm, tm, caps, ds, cin = _builder("dense_unet_lvl1")
    rng, _, jp, tp = _plan(12, caps, down_size=ds)
    jx, tx_of = _sparse_in(rng, jp, tp, cin)
    tm.load_state_dict(from_flax(*(lambda v: (v["params"], v["batch_stats"]))(
        _np_tree(_seeded_variables(jm, jx, jp, rng))), tm))
    names = {n.split(".")[0] for n, _ in tm.named_parameters()}
    assert "bn2_1" in names and "bn2_0" not in names
    x = tx_of(torch.from_numpy(np.asarray(jx.features)))
    with torch.no_grad():
        y = tm.eval()(x, tp)
    assert y.level == 0 and y.features.shape == (caps[0], 16)
    coarse = tp.levels[1]
    n = tp.levels[0].num_active
    parent = {tuple(c): r for r, c in enumerate(
        coarse.coords[:coarse.num_active].tolist())}
    c0 = tp.levels[0].coords[:n].tolist()
    rows = [parent[(c[0], c[1] // 2, c[2] // 2, c[3] // 2)] for c in c0]
    # level 0 repeats level 1: sites with one parent carry equal rows
    f = y.features[:n]
    for r in set(rows):
        same = [i for i, q in enumerate(rows) if q == r]
        assert torch.equal(f[same], f[same[:1]].expand(len(same), -1))
    assert bool((y.features[n:] == 0).all())


@pytest.mark.parametrize("kind", ["fcn", "vgg", "vgg_plus", "resnet",
                                  "dense_unet"])
def test_builder_matches_jax(kind):
    """Eval mode, then training mode (from the same initial weights)."""
    jm, tm, caps, ds, cin = _builder(kind)
    rng, _, jp, tp = _plan(7, caps, down_size=ds)
    jx, tx_of = _sparse_in(rng, jp, tp, cin)
    _vs_jax(jm, tm, jx, jp, tx_of, tp, lambda y: y.features, rng)


def test_builder_shapes_and_levels():
    """The builders' output widths and levels, as the JAX builders'."""
    for kind, width, level in (("fcn", 48, 0), ("vgg", 24, 3),
                               ("vgg_plus", 16, 0), ("resnet", 24, 2),
                               ("dense_unet", 8, 0)):
        _, tm, caps, ds, cin = _builder(kind)
        rng, _, _, tp = _plan(8, caps, down_size=ds)
        n = tp.levels[0].num_active
        x = SparseTensor(features=torch.randn(
            tp.levels[0].cap, cin, generator=torch.Generator()
            .manual_seed(0)), num_active=n, level=0)
        y = tm.eval()(x, tp)
        assert y.features.shape == (tp.levels[level].cap, width), kind
        assert y.level == level, kind
        assert bool(torch.isfinite(y.features).all())


def test_three_voxel_kernel_matches_jax():
    rng, pts, jp, tp = _plan(9, CAPS2)
    feats = rng.standard_normal((pts.shape[0], 3)).astype(np.float32)
    feats[pts[:, 0] < 0] = 0
    jm = jmodels.ThreeVoxelKernel(n_planes=(8, 16, 24), num_classes=5)
    tm = models.ThreeVoxelKernel((8, 16, 24), num_classes=5)

    def out_of(o):
        return (o.semantics, o.embedding, o.offset, o.features)
    _vs_jax(jm, tm, jnp.asarray(feats), jp, lambda f: f, tp, out_of, rng)
    tm.eval()
    with torch.no_grad():
        o = tm(torch.from_numpy(feats), tp)
    assert torch.equal(o.displacement, torch.zeros(pts.shape[0], 3))
    assert o.bw is None and o.occupancy is None


class _JaxCluster(fnn.Module):
    @fnn.compact
    def __call__(self, f, ci, train=False):
        return jmodels.ClusterSegNet(num_classes=5, num_clusters=32,
                                     name="net")(f, ci, train)


def test_cluster_seg_net_matches_jax():
    rng = np.random.default_rng(10)
    P = 300
    feats = rng.standard_normal((P, 16)).astype(np.float32)
    ci = rng.integers(-1, 30, P).astype(np.int32)   # clusters 30, 31 empty
    jm = _JaxCluster()
    v = _seeded_variables(jm, jnp.asarray(feats), jnp.asarray(ci), rng)
    tm = models.ClusterSegNet(16, num_classes=5, num_clusters=32)
    wrap = torch.nn.Module()
    wrap.net = tm
    wrap.load_state_dict(from_flax(_np_tree(v["params"]),
                                   _np_tree(v["batch_stats"]), wrap))
    ct = rng.standard_normal((32, 5)).astype(np.float32)

    def fwd(f, p):
        return jm.apply({"params": p, "batch_stats": v["batch_stats"]}, f,
                        jnp.asarray(ci), True, mutable=["batch_stats"])
    @jax.jit
    def fwd_bwd(f, p, ct):
        out, vjp, new = jax.vjp(fwd, f, p, has_aux=True)
        return out, vjp(ct), new
    jout, (j_df, j_dp), new = fwd_bwd(jnp.asarray(feats), v["params"],
                                      jnp.asarray(ct))
    tm.train()
    f = torch.from_numpy(feats).requires_grad_()
    out = tm(f, torch.from_numpy(ci))
    (out * torch.from_numpy(ct)).sum().backward()
    _close(out, jout, what="train output")
    _close(f.grad, j_df, what="d_features")
    _check_tree(j_dp, {n: p.grad for n, p in wrap.named_parameters()},
                "gradient", floor=1e-2)
    _check_tree(_np_tree(new["batch_stats"]), dict(wrap.named_buffers()),
                "statistic")
    # the biased variance enters the running statistics (BatchNorm1d's
    # update would take the unbiased one)
    assert not np.allclose(tm.l1_bn.running_var.numpy(), 0.9 + 0.1 * np.var(
        tm.mlp1(f).detach().numpy(), axis=0, ddof=1), rtol=1e-7, atol=0)
    tm.eval()
    jev = jm.apply({"params": v["params"], **new}, jnp.asarray(feats),
                   jnp.asarray(ci), False)
    with torch.no_grad():
        _close(tm(f, torch.from_numpy(ci)), jev, what="eval output")


class _JaxClassifier(fnn.Module):
    @fnn.compact
    def __call__(self, feats, plan, train=False):
        x = jmod.InputLayer(name="inp")(feats, plan, train)
        x = jmod.SubmanifoldConvolution(8, name="conv")(x, plan, train)
        x = jmod.BatchNormReLU(name="bn")(x, plan, train)
        pooled = jx_extras.ActivePooling(num_samples=2, name="pool")(
            x, plan, train)
        return fnn.Dense(3, name="head")(pooled)


class _Classifier(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.inp = tmod.InputLayer()
        self.conv = tmod.SubmanifoldConvolution(3, 8)
        self.bn = tmod.BatchNormReLU(8)
        self.pool = extras.ActivePooling(num_samples=2)
        self.head = torch.nn.Linear(8, 3)

    def forward(self, feats, plan):
        x = self.bn(self.conv(self.inp(feats, plan), plan), plan)
        return self.head(self.pool(x, plan))


def _batches(seed):
    def gen():
        rng = np.random.default_rng(seed)
        for _ in range(3):
            pts = random_points(rng, 200, extent=8, batch_size=2, pad_to=256)
            yield {"coords": pts,
                   "features": rng.standard_normal((256, 3))
                   .astype(np.float32),
                   "label": rng.integers(0, 3, 2).astype(np.int32)}
    return gen


def test_classification_harness_matches_jax(monkeypatch):
    jspec = JT.PlanSpec(caps=(256, 128))
    jm = _JaxClassifier()
    ref = jax_harness(jm, jspec, _batches(0), _batches(1), num_epochs=1,
                      lr=1e-2)
    # the JAX harness's initial weights: its init on the first batch
    b0 = next(iter(_batches(0)()))
    v = jm.init(jax.random.PRNGKey(0), jnp.asarray(b0["features"]),
                JT.build_plan(jnp.asarray(b0["coords"]), jspec), False)
    tm = _Classifier()
    tm.load_state_dict(from_flax(_np_tree(v["params"]),
                                 _np_tree(v["batch_stats"]), tm))
    res = classification.classification_train_validate(
        tm, T.PlanSpec(caps=(256, 128)), _batches(0), _batches(1),
        num_epochs=1, lr=1e-2, device="cpu")
    (h,), (jh,) = res["history"], ref["history"]
    assert set(h) == set(jh)
    for k in h:
        np.testing.assert_allclose(h[k], jh[k], rtol=TOL, atol=TOL,
                                   err_msg=k)
    _check_tree(_np_tree(ref["params"]), dict(res["model"]
                                              .named_parameters()), "param")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        classification.classification_train_validate(
            _Classifier(), T.PlanSpec(caps=(256, 128)), _batches(0),
            _batches(1), num_epochs=1)
