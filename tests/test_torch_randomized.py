"""The port's randomized-stride planner and modules against the JAX
package on the CPU.

* `randomized_ticks` and `_axis_tables`: the same arrays from the same
  `numpy.random.Generator` seed.
* `build_randomized_transition` (size 3; size 2 through the plan) and
  `build_randomized_plan` (2/2, three levels): the coarse levels (keys, coords,
  counts, neighbour maps), the child and up maps, p2v and the point count
  bit for bit against `occuseg_tpu.core.randomized` from the same seed,
  and the generator left in the same state.
* A SubmanifoldConvolution -> RandomizedStrideConvolution ->
  RandomizedStrideMaxPooling net over a randomized plan: forward and
  gradients against the flax net under `jax.vjp` (the same weights,
  `convert.from_flax`), f32, rtol 1e-5 with an absolute floor of 1e-5 of
  the reference's largest magnitude; and against autograd of the plain
  gather-matmul form (`ops/conv.gather_conv_fused`) with the max over the
  child map, at the same tolerance.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from occuseg_tpu.core import randomized as JR
from occuseg_tpu.core import topology as JT
from occuseg_tpu.core.sparse_tensor import SparseTensor as JaxSparse
from occuseg_tpu.nn import modules as jmod
from tests.utils import random_points

from occuseg_tpu_torch.convert import from_flax
from occuseg_tpu_torch.core import randomized as R
from occuseg_tpu_torch.core import topology as T
from occuseg_tpu_torch.core.sparse_tensor import SparseTensor
from occuseg_tpu_torch.nn import modules as tmod
from occuseg_tpu_torch.ops import conv as conv_ops
from occuseg_tpu_torch.ops import pool as pool_ops

torch.set_num_threads(2)

EXTENT = 16
CAP = 512


def _close(got, ref, rtol=1e-5, floor=1e-5, what=""):
    ref = np.asarray(ref)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    np.testing.assert_allclose(got, ref, rtol=rtol,
                               atol=floor * max(np.abs(ref).max(), 1e-30),
                               err_msg=what)


def _same_level(tl, jl, what):
    for f in ("keys", "coords", "nbr"):
        assert np.array_equal(T._np(getattr(tl, f)),
                              np.asarray(getattr(jl, f))), f"{what} {f}"
    assert tl.num_active == int(jl.num_active), f"{what} count"


def _same_transition(tt, jt, what):
    for f in ("child", "up"):
        assert np.array_equal(T._np(getattr(tt, f)),
                              np.asarray(getattr(jt, f))), f"{what} {f}"
        # the gather path's copy is the same map, transposed
        assert np.array_equal(T._np(tt.kn[f]).T, T._np(getattr(tt, f)))
    assert (tt.size, tt.stride) == (jt.size, jt.stride)


@pytest.mark.parametrize("in_size,size,stride", [
    (16, 2, 2), (16, 3, 2), (37, 3, 2), (512, 2, 2)])
def test_ticks_and_tables_match_jax(in_size, size, stride):
    a, b = np.random.default_rng(3), np.random.default_rng(3)
    for _ in range(3):
        tt = R.randomized_ticks(a, in_size, size, stride)
        jt = JR.randomized_ticks(b, in_size, size, stride)
        assert tt.dtype == jt.dtype and np.array_equal(tt, jt)
        for x, y in zip(R._axis_tables(tt, size, in_size),
                        JR._axis_tables(jt, size, in_size)):
            assert np.array_equal(x, y)
    assert a.random() == b.random()   # the generators drew alike


@pytest.fixture(scope="module")
def fine():
    rng = np.random.default_rng(1)
    pts = random_points(rng, 300, extent=EXTENT, batch_size=2, pad_to=CAP)
    jkeys, _ = JT.voxelize_coords(jnp.asarray(pts), CAP)
    tkeys, _ = T.voxelize_coords(torch.from_numpy(pts), CAP)
    assert np.array_equal(tkeys.numpy(), np.asarray(jkeys))
    return JT.build_level(jkeys, kernel=3), T.build_level(tkeys, kernel=3)


@pytest.mark.parametrize("size", [3])
def test_randomized_transition_matches_jax(fine, size):
    jf, tf = fine
    jc, jtr = JR.build_randomized_transition(
        jf, np.random.default_rng(7), size=size, stride=2, cap=2 * CAP,
        extent=EXTENT)
    tc, ttr = R.build_randomized_transition(
        tf, np.random.default_rng(7), size=size, stride=2, cap=2 * CAP,
        extent=EXTENT)
    _same_level(tc, jc, "coarse")
    _same_transition(ttr, jtr, "transition")
    assert ttr.child.shape[1] == size ** 3
    assert 0 < tc.num_active < 2 * CAP
    if size == 3:   # windows wider than the largest step cover every site
        child = T._np(ttr.child)
        assert set(child[child >= 0].tolist()) == set(range(tf.num_active))


@pytest.fixture(scope="module")
def rplans():
    """A two-sample cloud's randomized plans (2/2, three levels) from both
    packages, built from generators of one seed, and the generators."""
    rng = np.random.default_rng(2)
    pts = random_points(rng, 400, extent=24, batch_size=2, pad_to=CAP)
    caps = (CAP, 2 * CAP, CAP)
    jg, g = np.random.default_rng(5), np.random.default_rng(5)
    jp = JR.build_randomized_plan(jnp.asarray(pts), JT.PlanSpec(caps=caps),
                                  jg, 24)
    tp = R.build_randomized_plan(torch.from_numpy(pts),
                                 T.PlanSpec(caps=caps), g, 24)
    return dict(pts=pts, caps=caps, jp=jp, tp=tp, jg=jg, g=g)


def test_randomized_plan_matches_jax(rplans):
    pts, caps, jp, tp = (rplans[k] for k in ("pts", "caps", "jp", "tp"))
    g, jg = rplans["g"], rplans["jg"]
    assert len(tp.levels) == len(caps)
    for li, (tl, jl) in enumerate(zip(tp.levels, jp.levels)):
        _same_level(tl, jl, f"level {li}")
        assert tl.num_active < tl.cap
    for ti, (tt, jt) in enumerate(zip(tp.transitions, jp.transitions)):
        _same_transition(tt, jt, f"transition {ti}")
    assert np.array_equal(tp.p2v.numpy(), np.asarray(jp.p2v))
    assert tp.num_points == int(jp.num_points)
    assert g.random() == jg.random()   # the ticks drew alike
    p2v = tp.p2v.numpy()
    assert np.array_equal(tp.vox_counts.numpy(), np.bincount(
        p2v[p2v >= 0], minlength=CAP).astype(np.float32))
    assert all(l.chunks is None for l in tp.levels)
    # a regular plan differs: the windows are jittered
    reg = T.build_plan(torch.from_numpy(pts), T.PlanSpec(caps=caps))
    assert not np.array_equal(reg.levels[1].keys.numpy(),
                              tp.levels[1].keys.numpy())


class _JaxNet(fnn.Module):
    @fnn.compact
    def __call__(self, x, plan):
        x = jmod.SubmanifoldConvolution(8, name="sub")(x, plan)
        x = jmod.RandomizedStrideConvolution(16, name="rconv")(x, plan)
        x = jmod.RandomizedStrideMaxPooling(name="rpool")(x, plan)
        return x.features


class _Net(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.sub = tmod.SubmanifoldConvolution(4, 8)
        self.rconv = tmod.RandomizedStrideConvolution(8, 16)
        self.rpool = tmod.RandomizedStrideMaxPooling()

    def forward(self, x, plan):
        return self.rpool(self.rconv(self.sub(x, plan), plan), plan)


def test_randomized_stride_net_matches_jax_and_plain_form(rplans):
    rng = np.random.default_rng(3)
    jp, tp = rplans["jp"], rplans["tp"]
    n = tp.levels[0].num_active
    feats = np.zeros((CAP, 4), np.float32)
    feats[:n] = rng.standard_normal((n, 4))
    jx = JaxSparse(features=jnp.asarray(feats),
                   num_active=jp.levels[0].num_active, level=0)
    jnet = _JaxNet()
    params = jnet.init(jax.random.PRNGKey(0), jx, jp)["params"]
    ct = rng.standard_normal((CAP, 16)).astype(np.float32)
    jout, vjp = jax.vjp(lambda f, p: jnet.apply(
        {"params": p}, jx.with_features(f), jp), jx.features, params)
    j_df, j_dp = vjp(jnp.asarray(ct))

    net = _Net()
    net.load_state_dict(from_flax(jax.tree.map(np.asarray, params), {}, net))
    f = torch.from_numpy(feats).requires_grad_()
    y = net(SparseTensor(features=f, num_active=n, level=0), tp)
    assert y.level == 2 and y.num_active == tp.levels[2].num_active
    (y.features * torch.from_numpy(ct)).sum().backward()
    _close(y.features, jout, what="forward")
    _close(f.grad, j_df, what="d_feats")
    for name in ("sub", "rconv"):
        _close(getattr(net, name).weight.grad, j_dp[name]["weight"],
               what=f"dW {name}")

    # the plain form: autograd through gather + one matmul per convolution
    f2 = torch.from_numpy(feats).requires_grad_()
    w1 = net.sub.weight.detach().clone().requires_grad_()
    w2 = net.rconv.weight.detach().clone().requires_grad_()
    h = conv_ops.gather_conv_fused(f2, tp.levels[0].nbr, w1)
    h = conv_ops.gather_conv_fused(h, tp.transitions[0].child, w2)
    ref = pool_ops.max_pool(h, tp.transitions[1].child)
    (ref * torch.from_numpy(ct)).sum().backward()
    _close(y.features, ref.detach().numpy(), what="forward vs plain")
    _close(f.grad, f2.grad.numpy(), what="d_feats vs plain")
    _close(net.sub.weight.grad, w1.grad.numpy(), what="dW sub vs plain")
    _close(net.rconv.weight.grad, w2.grad.numpy(), what="dW rconv vs plain")
