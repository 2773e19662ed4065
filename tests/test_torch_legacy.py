"""The port's sparseconvnet facade (`occuseg_tpu_torch/legacy.py`) against
the JAX package's (`occuseg_tpu/legacy.py`) on the CPU.

* One case per constructor: the two facades build a module with the same
  arguments; the JAX module's seeded variables move to the port's through
  `convert.from_flax` with the model (so every flax name, bias included,
  must match); outputs within 1e-5 of the reference's largest magnitude
  and, where the module has a backward, the gradients of the input and
  of every parameter within 1e-4 (against `jax.vjp`), in eval mode and,
  for a module with batch norms, in training mode (then the new BN
  statistics within 1e-4 too). The
  permutohedral convolution is held on its forward only: the JAX
  module's backward is wrong (ROADMAP C item 7) and
  `tests/test_torch_full_conv.py` holds the port's to autograd.
* The reference docstring model (`Sequential` of a submanifold
  convolution, a residual UNet and BN-ReLU), the two tables, a
  FullConvolution whose fresh plan `Sequential` threads, and
  `append_tensors` (the merged plan equal to the JAX one, array by array,
  and a convolution over it equal to the per-scene ones), as
  `tests/test_legacy.py`.
* `UNet(leakiness=0.333)` against JAX: the port's UNet took no leakiness
  before, so a leaky UNet could not be built.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import occuseg_tpu.legacy as jscn
from occuseg_tpu.core import topology as JT
from occuseg_tpu.core.sparse_tensor import SparseTensor as JaxSparse
from occuseg_tpu.data.synthetic import SceneConfig, make_batch as jmake_batch
from occuseg_tpu.native.plan import build_plan_host as jbuild_plan_host
from tests.test_torch_families import (
    CAPS2,
    CAPS3,
    _check_tree,
    _close,
    _np_tree,
    _plans,
    _seeded_variables,
)

import occuseg_tpu_torch.legacy as scn
from occuseg_tpu_torch.convert import from_flax
from occuseg_tpu_torch.core import topology as T
from occuseg_tpu_torch.core.sparse_tensor import SparseTensor
from occuseg_tpu_torch.data.synthetic import make_batch
from occuseg_tpu_torch.native.plan import build_plan_host
from occuseg_tpu_torch.ops.permutohedral import embed_points

torch.set_num_threads(2)

FWD_TOL = 1e-5


def _close_fwd(got, ref, what=""):
    """Within FWD_TOL of the reference's largest magnitude."""
    ref = np.asarray(ref)
    got = got.detach().numpy()
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    np.testing.assert_allclose(got, ref, rtol=FWD_TOL,
                               atol=FWD_TOL * max(np.abs(ref).max(), 1e-30),
                               err_msg=what)


def _vs_jax(jm, tm, jx, jp, tx_of, tp, out_of, seed, modes=(False, True),
            grads=True):
    """The flax module and the port's from the same seeded variables, per
    mode (False: eval, True: train): outputs, the gradients of the input
    and of every parameter against seeded cotangents, and in training
    mode the new BN statistics."""
    rng = np.random.default_rng(seed)
    has_vars = bool(jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jx, jp, False)))
    variables = (_seeded_variables(jm, jx, jp, rng) if has_vars else {})
    params = variables.get("params", {})
    stats = variables.get("batch_stats", {})
    is_sparse = hasattr(jx, "features")
    f0 = jx.features if is_sparse else jx

    def fwd(f, p, train):
        out = jm.apply({"params": p, "batch_stats": stats},
                       jx.with_features(f) if is_sparse else f, jp, train,
                       mutable=["batch_stats"] if train else False)
        out, new = out if train else (out, {"batch_stats": stats})
        return out_of(out), new.get("batch_stats", {})

    tm.load_state_dict(from_flax(_np_tree(params), _np_tree(stats), tm))
    if not stats:   # no batch norm: training mode computes the same
        modes = modes[:1]
    for train in modes:
        out, vjp, new = jax.vjp(lambda f, p: fwd(f, p, train), f0, params,
                                has_aux=True)
        ct = jnp.asarray(rng.standard_normal(out.shape).astype(np.float32))
        tm.load_state_dict(from_flax(_np_tree(params), _np_tree(stats), tm))
        tm.zero_grad(set_to_none=True)
        tm.train(train)
        f = torch.from_numpy(np.asarray(f0).copy()).requires_grad_(grads)
        tout = out_of(tm(tx_of(f), tp))
        _close_fwd(tout, out, what=f"train={train} forward")
        if grads:
            j_df, j_dp = vjp(ct)
            (tout * torch.from_numpy(np.array(ct))).sum().backward()
            _close(f.grad, np.asarray(j_df), what=f"train={train} d_input")
            if jax.tree.leaves(j_dp):
                _check_tree(_np_tree(j_dp),
                            {n: p.grad for n, p in tm.named_parameters()},
                            f"train={train} gradient", floor=1e-2)
        if train and jax.tree.leaves(new):
            _check_tree(_np_tree(new), dict(tm.named_buffers()), "statistic")
    return tm


def _sparse(caps, cin, level=0, down_size=2, seed=0):
    """(JAX input, port input of a leaf tensor, JAX plan, port plan): seeded
    features on the active rows of `level` of the device planners' plans
    (bit for bit alike)."""
    _, jp, tp = _plans(caps, down_size)
    rng = np.random.default_rng(seed)
    lvl = tp.levels[level]
    n = lvl.num_active
    feats = np.zeros((lvl.cap, cin), np.float32)
    feats[:n] = rng.standard_normal((n, cin))
    jx = JaxSparse(features=jnp.asarray(feats),
                   num_active=jp.levels[level].num_active, level=level)
    return jx, (lambda f: SparseTensor(features=f, num_active=n,
                                       level=level)), jp, tp


def _features(y):
    return y.features


def _lattice():
    rng = np.random.default_rng(9)
    lat = embed_points(rng.standard_normal((260, 3)) * 4.0)
    pts = np.concatenate([rng.integers(0, 2, (260, 1)), lat - lat.min(0)],
                         axis=1).astype(np.int32)
    pts = np.concatenate([pts, -np.ones((512 - 260, 4), np.int32)])
    jp = JT.build_plan(jnp.asarray(pts), JT.PlanSpec(
        caps=(512,), lattice="permutohedral"))
    tp = T.build_plan(torch.from_numpy(pts), T.PlanSpec(
        caps=(512,), lattice="permutohedral"))
    n = tp.levels[0].num_active
    feats = np.zeros((512, 4), np.float32)
    feats[:n] = rng.standard_normal((n, 4))
    jx = JaxSparse(features=jnp.asarray(feats),
                   num_active=jp.levels[0].num_active, level=0)
    return jx, (lambda f: SparseTensor(features=f, num_active=n)), jp, tp


# name -> (arguments of both facades' constructor, input: (caps, cin,
# level, down_size)); options beyond the defaults where a constructor
# forwards them
CONSTRUCTORS = {
    "SubmanifoldConvolution": ((3, 4, 8, 3, True), (CAPS2, 4, 0, 2)),
    "ValidConvolution": ((3, 4, 8, 3, False), (CAPS2, 4, 0, 2)),
    "Convolution": ((3, 4, 8, 2, 2, True), (CAPS2, 4, 0, 2)),
    "Deconvolution": ((3, 8, 4, 2, 2, True), (CAPS2, 8, 1, 2)),
    "FullConvolution": ((3, 4, 8, 2, 2, True), (CAPS2, 4, 1, 2)),
    "RandomizedStrideConvolution": ((3, 4, 8, 3, 2, True), (CAPS3, 4, 0, 3)),
    "RandomizedStrideMaxPooling": ((3, 3, 2), (CAPS3, 4, 0, 3)),
    "NetworkInNetwork": ((4, 8, True), (CAPS2, 4, 0, 2)),
    "BatchNormalization": ((4, 1e-3, 0.8, 0.2), (CAPS2, 4, 0, 2)),
    "BatchNormReLU": ((4,), (CAPS2, 4, 0, 2)),
    "BatchNormLeakyReLU": ((4, 1e-4, 0.9, 0.1), (CAPS2, 4, 0, 2)),
    "MaxPooling": ((3, 2, 2), (CAPS2, 4, 0, 2)),
    "AveragePooling": ((3, 2, 2), (CAPS2, 4, 0, 2)),
    "UnPooling": ((3, 2, 2), (CAPS2, 4, 1, 2)),
    "OutputLayer": ((3,), (CAPS2, 4, 0, 2)),
    "UNet": ((3, 1, [8, 16, 24], True), (CAPS2, 8, 0, 2)),
    "FullyConvolutionalNet": ((3, 1, [8, 16, 24], True), (CAPS2, 8, 0, 2)),
    "SparseVggNet": ((3, 4, [["C", 8], "MP", ["C", 8, 4], "C3/2"]),
                     (CAPS3, 4, 0, 3)),
    "SparseResNet": ((3, 4, [["b", 8, 1, 1], ["b", 16, 1, 2]]),
                     (CAPS3, 4, 0, 3)),
    "ShapeContext": ((3, 4), (CAPS2, 4, 0, 2)),
    "MultiscaleShapeContext": ((3, 4, 2), (CAPS2, 4, 0, 2)),
    "Identity_": ((), (CAPS2, 4, 0, 2)),
    "Dropout_": ((0.3,), (CAPS2, 4, 0, 2)),
    "BatchwiseDropout": ((0.3,), (CAPS2, 4, 0, 2)),
}


@pytest.mark.parametrize("name", sorted(CONSTRUCTORS))
def test_constructor_matches_jax(name):
    args, (caps, cin, level, ds) = CONSTRUCTORS[name]
    jm, tm = getattr(jscn, name)(*args), getattr(scn, name)(*args)
    jx, tx_of, jp, tp = _sparse(caps, cin, level, ds, seed=len(name))
    out_of = _features
    if name == "FullConvolution":
        def out_of(y):
            return y[0].features
    elif name == "OutputLayer":
        def out_of(y):
            return y
    # the dropouts draw their masks from different generators: eval mode
    modes = (False,) if "Dropout" in name else (False, True)
    _vs_jax(jm, tm, jx, jp, tx_of, tp, out_of, seed=3, modes=modes)


@pytest.mark.parametrize("mode", [0, 1, 2, 3, 4, 7])
def test_input_layer_modes_match_jax(mode):
    """The reference's integer modes (7: not in the table, the mean)."""
    pts, jp, tp = _plans(CAPS2)
    rng = np.random.default_rng(mode)
    feats = rng.standard_normal((pts.shape[0], 3)).astype(np.float32)
    feats[pts[:, 0] < 0] = 0
    _vs_jax(jscn.InputLayer(3, 16, mode), scn.InputLayer(3, 16, mode),
            jnp.asarray(feats), jp, lambda f: f, tp, _features, seed=mode)


def test_permutohedral_convolution_forward_matches_jax():
    jx, tx_of, jp, tp = _lattice()
    _vs_jax(jscn.PermutohedralSubmanifoldConvolution(3, 4, 8, True),
            scn.PermutohedralSubmanifoldConvolution(3, 4, 8, True),
            jx, jp, tx_of, tp, _features, seed=4, modes=(False,),
            grads=False)


def test_constructors_check_dimension():
    with pytest.raises(ValueError):
        scn.SubmanifoldConvolution(2, 4, 8, 3)
    with pytest.raises(ValueError):
        scn.UNet(2, 1, [8, 16])


def _docstring_model(facade):
    """The reference UNet docstring's model (`networkArchitectures.py:
    207-213`), built with scn-style calls."""
    return facade.Sequential().add(
        facade.SubmanifoldConvolution(3, 3, 8, 3, False)).add(
        facade.UNet(3, 1, [8, 16, 24], residual_blocks=True)).add(
        facade.BatchNormReLU(8))


def test_reference_docstring_model_matches_jax():
    jx, tx_of, jp, tp = _sparse(CAPS2, 3, seed=11)
    tm = _vs_jax(_docstring_model(jscn), _docstring_model(scn), jx, jp,
                 tx_of, tp, _features, seed=5)
    names = {n.split(".")[0] for n, _ in tm.named_parameters()}
    assert names == {"layers_0", "layers_1", "layers_2"}


def test_from_flax_checks_the_facade_tree():
    """A facade model's flax tree maps one to one: a leaf missing from it
    or left over raises."""
    jx, _, jp, _ = _sparse(CAPS2, 3, seed=15)
    jm, tm = _docstring_model(jscn), _docstring_model(scn)
    v = _np_tree(_seeded_variables(jm, jx, jp, np.random.default_rng(0)))
    params, stats = v["params"], v["batch_stats"]
    tm.load_state_dict(from_flax(params, stats, tm))
    missing = {**params, "layers_0": {}}
    with pytest.raises(ValueError, match="missing"):
        from_flax(missing, stats, tm)
    extra = {**params, "layers_3": {"weight": np.zeros((27, 8, 8))}}
    with pytest.raises(ValueError, match="left"):
        from_flax(extra, stats, tm)


def test_leaky_unet_matches_jax():
    """Every batch norm of the UNet (its blocks', down_bn's, up_bn's)
    takes the leakiness, forward and gradients."""
    jx, tx_of, jp, tp = _sparse(CAPS2, 8, seed=12)
    tm = _vs_jax(jscn.UNet(3, 1, [8, 16, 24], True, leakiness=0.333),
                 scn.UNet(3, 1, [8, 16, 24], True, leakiness=0.333),
                 jx, jp, tx_of, tp, _features, seed=6)
    bns = [m for n, m in tm.named_modules() if n.endswith("_bn")
           or n.endswith("bn1") or n.endswith("bn2")]
    assert len(bns) == 14 and all(m.leakiness == 0.333 for m in bns)


@pytest.mark.parametrize("join", ["add", "join"])
def test_tables_match_jax(join):
    def model(f):
        ct = f.ConcatTable().add(f.Identity()).add(
            f.NetworkInNetwork(4, 4, False))
        return f.Sequential().add(ct).add(
            f.AddTable() if join == "add" else f.JoinTable())
    jx, tx_of, jp, tp = _sparse(CAPS2, 4, seed=13)
    tm = _vs_jax(model(jscn), model(scn), jx, jp, tx_of, tp, _features,
                 seed=7)
    assert [n for n, _ in tm.named_parameters()] == [
        "layers_0.branches_1.weight"]
    with torch.no_grad():
        y = tm(tx_of(torch.from_numpy(np.array(jx.features))), tp)
    assert y.features.shape == (CAPS2[0], 4 if join == "add" else 8)


def test_sequential_threads_full_convolution_plan():
    """The layer after a FullConvolution runs on its grown topology."""
    def model(f):
        return f.Sequential().add(f.FullConvolution(3, 4, 8, 2, 2)).add(
            f.SubmanifoldConvolution(3, 8, 8, 3))
    jx, tx_of, jp, tp = _sparse(CAPS2, 4, level=1, seed=14)
    tm = _vs_jax(model(jscn), model(scn), jx, jp, tx_of, tp, _features,
                 seed=8)
    with torch.no_grad():
        y = tm(tx_of(torch.from_numpy(np.array(jx.features))), tp)
    assert y.features.shape == (CAPS2[1] * 8, 8)


def test_append_tensors_matches_jax():
    """Two one-scene tensors become a blocked two-scene tensor: the merged
    plan equals the JAX facade's array by array, and a convolution over it
    equals each scene's own."""
    jspec, spec = JT.PlanSpec(caps=(512, 256)), T.PlanSpec(caps=(512, 256))
    rng = np.random.default_rng(0)
    jentries, entries, per_scene = [], [], []
    for seed in (1, 2):
        scene = SceneConfig(num_points=900, extent=40, num_objects=4)
        coords = jmake_batch(scene, 1, 2048, 8, seed=seed)["coords"]
        assert np.array_equal(coords, make_batch(
            scene, 1, 2048, 8, seed=seed)["coords"])
        jplan, plan = jbuild_plan_host(coords, jspec), build_plan_host(
            coords, spec)
        f = rng.standard_normal((512, 8)).astype(np.float32)
        n = int(plan.levels[0].num_active)
        jentries.append((JaxSparse(features=jnp.asarray(f),
                                   num_active=jnp.asarray(n)), jplan))
        entries.append((SparseTensor(features=torch.from_numpy(f),
                                     num_active=n), plan))
        per_scene.append((f, plan))
    jout, jmerged = jscn.append_tensors(jentries)
    out, merged = scn.append_tensors(entries)
    assert out.num_active == tuple(int(n) for n in np.asarray(
        jout.num_active))
    assert torch.equal(out.features, torch.from_numpy(np.array(
        jout.features)))
    for jl, tl in zip(jmerged.levels, merged.levels):
        for name in ("keys", "coords", "nbr", "orient", "num_active"):
            assert np.array_equal(np.asarray(getattr(jl, name)),
                                  np.asarray(getattr(tl, name))), name
    for jt, tt in zip(jmerged.transitions, merged.transitions):
        assert np.array_equal(np.asarray(jt.child), tt.child)
        assert np.array_equal(np.asarray(jt.up), tt.up)
    assert np.array_equal(np.asarray(jmerged.p2v), merged.p2v)

    conv = scn.SubmanifoldConvolution(3, 8, 8, 3,
                                      generator=torch.Generator()
                                      .manual_seed(0))
    with torch.no_grad():
        y = conv(out, merged).features
        for s, (f, plan) in enumerate(per_scene):
            ref = conv(SparseTensor(torch.from_numpy(f),
                                    int(plan.levels[0].num_active)),
                       plan).features
            _close(y[s * 512:(s + 1) * 512], ref.numpy(),
                   what=f"scene {s}")


def test_input_batch_matches_jax():
    """InputBatch's padded arrays and host plan, as the JAX facade's."""
    rng = np.random.default_rng(3)
    jb, tb = jscn.InputBatch(3, 32, p_cap=600), scn.InputBatch(3, 32,
                                                               p_cap=600)
    for n in (250, 300):
        c = rng.integers(0, 16, (n, 3)).astype(np.int32)
        f = rng.standard_normal((n, 3)).astype(np.float32)
        jb.add_sample(c, f)
        tb.add_sample(c, f)
    for a, b in zip(jb.arrays(), tb.arrays()):
        assert np.array_equal(a, b)
    jspec, spec = JT.PlanSpec(caps=(512, 256)), T.PlanSpec(caps=(512, 256))
    jp, tp = jb.precompute_metadata(jspec), tb.precompute_metadata(spec)
    assert np.array_equal(np.asarray(jp.levels[0].nbr), tp.levels[0].nbr)
    assert np.array_equal(np.asarray(jp.p2v), tp.p2v)
