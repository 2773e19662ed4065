"""The port's pooling ops and modules and the IO layers' modes against the
JAX package on the CPU.

* `max_pool`, `avg_pool` and `unpool` over the child / up maps of a
  2/2 and a 3/2 transition (the device planner's maps, bit for bit as the
  JAX planner's), forward and `torch.autograd` gradients against
  `jax.vjp`, on features with ties (rounded values after a ReLU: most
  children tie at 0, where both split the gradient evenly). f32, rtol
  1e-5 with an absolute floor of 1e-5 of the reference's largest
  magnitude, as `tests/test_torch_full_conv.py`.
* The pooling modules against the flax modules (the same tolerance; the
  level and count bookkeeping exactly).
* `voxelize_features` in its five modes, with and without the sorted
  point layout (the JAX package's sum and mean then run its blocked
  kernel in interpret mode), forward and gradients, on integer-valued
  point features (ties within a voxel for "max").
* BLInputLayer and BLOutputLayer against the flax modules.
* `ops/conv.gather_rows` (fill value, gradient) and the per-device copy
  of a host plan's keys and coords (`LevelTopology.device_array`).
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
from occuseg_tpu.nn import modules as jmod
from occuseg_tpu.ops import pool as jax_pool
from tests.utils import random_points

from occuseg_tpu_torch.core import topology as T
from occuseg_tpu_torch.core.point_layout import augment_plan_with_point_layout
from occuseg_tpu_torch.core.sparse_tensor import SparseTensor
from occuseg_tpu_torch.native.plan import build_plan_host
from occuseg_tpu_torch.nn import modules as tmod
from occuseg_tpu_torch.ops import pool as pool_ops

torch.set_num_threads(2)

CAPS = (512, 512)
C = 6


def _close(got, ref, rtol=1e-5, floor=1e-5, what=""):
    ref = np.asarray(ref)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    np.testing.assert_allclose(got, ref, rtol=rtol,
                               atol=floor * max(np.abs(ref).max(), 1e-30),
                               err_msg=what)


def _tied(rng, shape):
    """Rounded ReLU'd normals: most entries 0, the rest small integers."""
    return np.maximum(np.round(rng.standard_normal(shape) * 1.5),
                      0).astype(np.float32)


@pytest.fixture(scope="module", params=[(2, 2), (3, 2)], ids=["2-2", "3-2"])
def plans(request):
    size, stride = request.param
    rng = np.random.default_rng(11 + size)
    pts = random_points(rng, 350, extent=12, batch_size=2, pad_to=CAPS[0])
    jp = JT.build_plan(jnp.asarray(pts), JT.PlanSpec(
        caps=CAPS, down_size=size, down_stride=stride))
    tp = T.build_plan(torch.from_numpy(pts), T.PlanSpec(
        caps=CAPS, down_size=size, down_stride=stride))
    for f in ("child", "up"):
        assert np.array_equal(T._np(getattr(tp.transitions[0], f)),
                              np.asarray(getattr(jp.transitions[0], f)))
    n0, n1 = (l.num_active for l in tp.levels)
    fine = np.zeros((CAPS[0], C), np.float32)
    fine[:n0] = _tied(rng, (n0, C))
    coarse = np.zeros((CAPS[1], C), np.float32)
    coarse[:n1] = _tied(rng, (n1, C))
    return dict(jp=jp, tp=tp, fine=fine, coarse=coarse, rng=rng)


OPS = {"max_pool": ("child", "fine"), "avg_pool": ("child", "fine"),
       "unpool": ("up", "coarse")}


@pytest.mark.parametrize("op", sorted(OPS))
def test_pool_op_matches_jax(plans, op):
    mp, src = OPS[op]
    idx = T._np(getattr(plans["tp"].transitions[0], mp))
    x = plans[src]
    ct = plans["rng"].standard_normal(
        (idx.shape[0], C)).astype(np.float32)
    jout, vjp = jax.vjp(lambda f: getattr(jax_pool, op)(f, jnp.asarray(idx)),
                        jnp.asarray(x))
    (jgrad,) = vjp(jnp.asarray(ct))
    f = torch.from_numpy(x).requires_grad_()
    out = getattr(pool_ops, op)(f, torch.from_numpy(idx))
    (out * torch.from_numpy(ct)).sum().backward()
    _close(out, jout, what=f"{op} forward")
    _close(f.grad, jgrad, what=f"{op} gradient")
    if op == "max_pool":
        # ties are the rule here: of the sites with several children,
        # most hold several maximal ones in some channel
        g = x[np.clip(idx, 0, None)]
        g[idx < 0] = -np.inf
        ties = (g == g.max(axis=1, keepdims=True)).sum(axis=1)
        several = (idx >= 0).sum(axis=1) > 1
        assert (ties[several] > 1).any(axis=1).mean() > 0.5


class _JaxPool(fnn.Module):
    kind: str

    @fnn.compact
    def __call__(self, x, plan):
        cls = {"max": jmod.MaxPooling, "avg": jmod.AveragePooling,
               "unpool": jmod.UnPooling}[self.kind]
        y = cls(name="pool")(x, plan)
        return y.features, y.level


@pytest.mark.parametrize("kind", ["max", "avg", "unpool"])
def test_pool_module_matches_jax(plans, kind):
    level = 1 if kind == "unpool" else 0
    x = plans["coarse" if level else "fine"]
    jl = plans["jp"].levels[level]
    jx = JaxSparse(features=jnp.asarray(x), num_active=jl.num_active,
                   level=level)
    jm = _JaxPool(kind)
    jout, jlevel = jm.apply({}, jx, plans["jp"])
    cls = {"max": tmod.MaxPooling, "avg": tmod.AveragePooling,
           "unpool": tmod.UnPooling}[kind]
    tp = plans["tp"]
    y = cls()(SparseTensor(features=torch.from_numpy(x),
                           num_active=tp.levels[level].num_active,
                           level=level), tp)
    assert y.level == jlevel == 1 - level
    assert y.num_active == tp.levels[1 - level].num_active
    _close(y.features, jout, what=kind)


@pytest.fixture(scope="module")
def io_plans():
    """A scene whose level 0 (cap 1920 = 10 blocks of 192 voxels) takes
    the sorted point layout, and the same plan without it."""
    batch = make_batch(SceneConfig(num_points=1500, extent=128, num_objects=4),
                       num_scenes=1, p_cap=2560, num_instances=8, seed=4)
    plain = build_plan_host(batch["coords"], T.PlanSpec(caps=(1920, 1024)))
    laid = augment_plan_with_point_layout(plain)
    assert laid.vox_seg is not None and plain.vox_seg is None
    rng = np.random.default_rng(5)
    feats = rng.integers(-3, 4, (2560, 3)).astype(np.float32)
    ct = rng.standard_normal((1920, 3)).astype(np.float32)
    return dict(plain=plain, laid=laid, feats=feats, ct=ct)


@pytest.mark.parametrize("layout", [False, True], ids=["scatter", "layout"])
@pytest.mark.parametrize("mode", ["first", "last", "sum", "mean", "max"])
def test_voxelize_mode_matches_jax(io_plans, mode, layout):
    plan = io_plans["laid" if layout else "plain"]
    p2v = np.asarray(plan.p2v)
    cap = plan.levels[0].cap
    feats, ct = io_plans["feats"], io_plans["ct"]
    seg = None if plan.vox_seg is None else np.asarray(plan.vox_seg)
    counts = None if plan.vox_counts is None else np.asarray(plan.vox_counts)

    def jfn(f):
        return jax_pool.voxelize_features(
            f, jnp.asarray(p2v), cap, mode=mode,
            vox_seg=None if seg is None else jnp.asarray(seg),
            vox_counts=None if counts is None else jnp.asarray(counts))
    jout, vjp = jax.vjp(jfn, jnp.asarray(feats))
    (jgrad,) = vjp(jnp.asarray(ct))
    f = torch.from_numpy(feats).requires_grad_()
    out = pool_ops.voxelize_features(
        f, torch.from_numpy(p2v), cap,
        None if seg is None else torch.from_numpy(seg),
        None if counts is None else torch.from_numpy(counts), mode)
    (out * torch.from_numpy(ct)).sum().backward()
    _close(out, jout, what=f"{mode} forward")
    _close(f.grad, jgrad, what=f"{mode} gradient")
    if mode == "max":
        assert np.asarray(jgrad)[np.asarray(jgrad) != 0].size > 0
    with pytest.raises(ValueError, match="mode"):
        tmod.InputLayer(mode="median")


class _JaxBL(fnn.Module):
    mode: str

    @fnn.compact
    def __call__(self, f, plan):
        x = jmod.BLInputLayer(mode=self.mode, name="inp")(f, plan)
        return x.features, jmod.BLOutputLayer(batch_size=f.shape[0],
                                              name="out")(x, plan)


@pytest.mark.parametrize("mode", ["mean", "max"])
def test_bl_layers_match_jax(mode):
    """A [B, L] batch of point clouds: BLInputLayer over the flattened
    plan, BLOutputLayer back to [B, L, C]; forward and the gradient of a
    round trip."""
    rng = np.random.default_rng(6)
    B, L = 3, 96
    coords = np.concatenate([np.repeat(np.arange(B), L)[:, None],
                             rng.integers(0, 6, (B * L, 3))], 1)
    coords[rng.random(B * L) < 0.1] = -1        # padding rows
    coords = coords.astype(np.int32)
    feats = rng.standard_normal((B, L, 4)).astype(np.float32)
    ct = rng.standard_normal((B, L, 4)).astype(np.float32)
    jp = JT.build_plan(jnp.asarray(coords), JT.PlanSpec(caps=(256,)))
    tp = T.build_plan(torch.from_numpy(coords), T.PlanSpec(caps=(256,)))
    jm = _JaxBL(mode)
    (jvox, jback), vjp = jax.vjp(lambda f: jm.apply({}, f, jp),
                                 jnp.asarray(feats))
    (jgrad,) = vjp((jnp.zeros_like(jvox), jnp.asarray(ct)))
    f = torch.from_numpy(feats).requires_grad_()
    x = tmod.BLInputLayer(mode=mode)(f, tp)
    back = tmod.BLOutputLayer(batch_size=B)(x, tp)
    (back * torch.from_numpy(ct)).sum().backward()
    _close(x.features, jvox, what="BLInputLayer")
    _close(back, jback, what="BLOutputLayer")
    _close(f.grad, jgrad, what="round-trip gradient")
    assert back.shape == (B, L, 4)


@pytest.mark.parametrize("fill", [0.0, -3.5])
def test_gather_rows_fill_and_gradient(fill):
    """`ops/conv.gather_rows`, through which the pools, the voxelize modes
    and the extras gather: feats[idx] with the -1 rows set to `fill`, for
    [M] and [M, K] ids; its gradient adds each row's cotangents (nothing
    for a -1 id), as `np.add.at`."""
    from occuseg_tpu_torch.ops.conv import gather_rows
    rng = np.random.default_rng(31)
    feats = rng.standard_normal((9, 4)).astype(np.float32)
    for shape in ((7,), (5, 3)):
        idx = rng.integers(-1, 9, shape)
        ct = rng.standard_normal(shape + (4,)).astype(np.float32)
        f = torch.from_numpy(feats).requires_grad_()
        out = gather_rows(f, torch.from_numpy(idx).to(torch.int32), fill)
        (out * torch.from_numpy(ct)).sum().backward()
        want = np.where((idx >= 0)[..., None], feats[np.maximum(idx, 0)],
                        np.float32(fill))
        assert np.array_equal(out.detach().numpy(), want)
        d_want = np.zeros_like(feats)
        live = idx >= 0
        np.add.at(d_want, idx[live], ct[live])
        _close(f.grad, d_want, what=f"gradient {shape}")


def test_device_array_copies_once_per_device(io_plans):
    """A host plan's keys and coords reach a device once per plan object
    and device (`LevelTopology.device_array`); the copy is its own cache,
    which `to` does not carry and the gather maps' does not hold."""
    lvl = io_plans["plain"].levels[0]
    a = lvl.device_array("coords", "cpu")
    assert isinstance(a, torch.Tensor)
    assert np.array_equal(a.numpy(), np.asarray(lvl.coords))
    assert lvl.device_array("coords", torch.device("cpu")) is a
    assert np.array_equal(lvl.device_array("keys", "cpu").numpy(),
                          np.asarray(lvl.keys))
    assert not any(isinstance(k, tuple) for k in lvl.kn)
    moved = lvl.to("cpu")
    assert moved.arrays == {}
    # a plan whose arrays are tensors on the device hands them out as
    # they are
    dev = T.LevelTopology(keys=a[:, 0].long(), coords=a, num_active=1,
                          nbr=torch.from_numpy(np.asarray(lvl.nbr)))
    assert dev.device_array("coords", "cpu") is a
    assert dev.arrays == {}
