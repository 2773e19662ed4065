"""Gradients of the PyTorch port's ops against the JAX package on the CPU.

Same inputs (NumPy, seeded) through both. The JAX side runs as its own
tests run it: the chunk-conv VJPs through the Pallas kernels in interpret
mode (`jax.vjp` of `chunk_gather_conv` / `chunk_gather_conv_t`), the
devoxelize and voxelize VJPs through the interpret-mode segment sum. On
CPU tensors the port's kernel wrappers take their plain versions, so these
tests pin the backward's contract (offset reversal, transpose pairing, the
two routes) that the CUDA kernels are held to on the card. Weights are
random and asymmetric, so a missing reversal or a wrong pairing fails.

Tolerance: f32, rtol=1e-5 with atol=1e-5 (the conv gradients: 1e-5 of the
largest magnitude, since a weight gradient sums hundreds of O(1) products
and its f32 rounding grows with it); only summation order differs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from occuseg_tpu.core.point_layout import (
    augment_plan_with_point_layout as jax_augment_layout,
)
from occuseg_tpu.core.topology import PlanSpec as JaxPlanSpec
from occuseg_tpu.data.synthetic import SceneConfig, make_batch
from tests.jax_planner import host_plan as jax_build_plan_host
from occuseg_tpu.ops import norm as jax_norm
from occuseg_tpu.ops import pool as jax_pool
from occuseg_tpu.ops.pallas import chunk_conv as jax_cc

from occuseg_tpu_torch.core.point_layout import augment_plan_with_point_layout
from occuseg_tpu_torch.core.topology import PlanSpec
from occuseg_tpu_torch.native.plan import build_plan_host
from occuseg_tpu_torch.ops import norm as norm_ops
from occuseg_tpu_torch.ops import pool as pool_ops
from occuseg_tpu_torch.ops.kernels import chunk_conv as cc

torch.set_num_threads(2)

TOL = dict(rtol=1e-5, atol=1e-5)
M = 64


@pytest.fixture(scope="module")
def small_plan():
    """The JAX chunk-conv tests' scene: caps (512, 256), M=64 chunks."""
    batch = make_batch(SceneConfig(num_points=1200, extent=48,
                                   num_objects=5),
                       num_scenes=1, p_cap=2048, num_instances=8, seed=3)
    return build_plan_host(batch["coords"], PlanSpec(caps=(512, 256)))


@pytest.fixture(scope="module")
def layout_plans():
    caps = (12_288, 8_192, 4_096, 2_048, 1_024, 512)
    batch = make_batch(SceneConfig(num_points=12_000, extent=128,
                                   num_objects=8),
                       num_scenes=1, p_cap=24_576, num_instances=16, seed=3)
    jp = jax_augment_layout(jax_build_plan_host(batch["coords"],
                                                JaxPlanSpec(caps=caps)))
    tp = augment_plan_with_point_layout(build_plan_host(batch["coords"],
                                                        PlanSpec(caps=caps)))
    return jp, tp


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _conv_case(plan, kind, seed):
    """Chunk plans and f32 inputs of one convolution: (forward plan,
    transpose plan, feats, weight, cotangent) as NumPy arrays. `sub` is
    the level-0 submanifold conv (its own transpose); `child` the strided
    conv (transpose = up map); `up` the deconvolution (the reverse)."""
    tr = plan.transitions[0]
    if kind == "sub":
        f = t = cc.build_chunk_arrays(plan.levels[0].nbr, M, 160)
        n_in, n_out, K, cin, cout = 512, 512, 27, 16, 32
    elif kind == "child":
        f = cc.build_chunk_arrays(tr.child, M, 256)
        t = cc.build_chunk_arrays(tr.up, M, 128)
        n_in, n_out, K, cin, cout = 512, 256, 8, 32, 48
    else:
        f = cc.build_chunk_arrays(tr.up, M, 128)
        t = cc.build_chunk_arrays(tr.child, M, 256)
        n_in, n_out, K, cin, cout = 256, 512, 8, 48, 32
    rng = np.random.default_rng(seed)
    feats = rng.standard_normal((n_in, cin)).astype(np.float32)
    w = (rng.standard_normal((K, cin, cout)) * 0.2).astype(np.float32)
    ct = rng.standard_normal((n_out, cout)).astype(np.float32)
    return f, t, feats, w, ct


def _close(got, ref):
    ref = np.asarray(ref)
    np.testing.assert_allclose(got, ref, rtol=1e-5,
                               atol=1e-5 * np.abs(ref).max())


def _jax_vjp(kind, f, t, feats, w, ct):
    fi, fl = (jnp.asarray(a) for a in f)
    ti, tl = (jnp.asarray(a) for a in t)
    if kind == "sub":
        fn = lambda x, ww: jax_cc.chunk_gather_conv(x, fi, fl, ww)  # noqa
    else:
        fn = lambda x, ww: jax_cc.chunk_gather_conv_t(  # noqa: E731
            x, fi, fl, ti, tl, ww)
    out, vjp = jax.vjp(fn, jnp.asarray(feats), jnp.asarray(w))
    d_f, d_w = vjp(jnp.asarray(ct))
    return np.asarray(out), np.asarray(d_f), np.asarray(d_w)


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("kind", ["sub", "child", "up"])
def test_conv_backward_routes_match_jax(small_plan, kind, fused):
    """Each backward route of the port (fused kernel; dW kernel plus the
    forward kernel on the transpose plan), forced, against jax.vjp."""
    f, t, feats, w, ct = _conv_case(small_plan, kind, seed=len(kind) + 7)
    _, ref_f, ref_w = _jax_vjp(kind, f, t, feats, w, ct)
    before = (cc.chunk_conv_bwd_fused.launches, cc.chunk_conv_dw.launches,
              cc.chunk_conv.launches)
    args = (_t(ct), _t(feats), _t(f[0]), _t(f[1]))
    if kind == "sub":
        d_f, d_w = cc.sub_conv_backward(*args, _t(w), fused)
    else:
        d_f, d_w = cc.t_conv_backward(*args, _t(t[0]), _t(t[1]), _t(w),
                                      fused)
    # CPU tensors: the plain versions, no kernel launch
    assert (cc.chunk_conv_bwd_fused.launches, cc.chunk_conv_dw.launches,
            cc.chunk_conv.launches) == before
    assert d_f.shape == feats.shape and d_w.shape == w.shape
    _close(d_f.numpy(), ref_f)
    _close(d_w.numpy(), ref_w)


@pytest.mark.parametrize("kind", ["sub", "child", "up"])
def test_autograd_entry_points_match_jax(small_plan, kind):
    """chunk_gather_conv / chunk_gather_conv_t under torch autograd (the
    route their backward picks) against the JAX forward and VJP."""
    f, t, feats, w, ct = _conv_case(small_plan, kind, seed=len(kind))
    ref_out, ref_f, ref_w = _jax_vjp(kind, f, t, feats, w, ct)
    x = _t(feats).requires_grad_()
    ww = _t(w).requires_grad_()
    if kind == "sub":
        out = cc.chunk_gather_conv(x, _t(f[0]), _t(f[1]), ww)
    else:
        out = cc.chunk_gather_conv_t(x, _t(f[0]), _t(f[1]), _t(t[0]),
                                     _t(t[1]), ww)
    out.backward(_t(ct))
    _close(out.detach().numpy(), ref_out)
    _close(x.grad.numpy(), ref_f)
    _close(ww.grad.numpy(), ref_w)


def test_backward_route_matches_jax_rules():
    """The route is a pure function of static shapes and reproduces the
    JAX package's eligibility rules, including the bench scene's
    22 / 7 / 4 split (bf16, M=128, tier-1.0 U tables)."""
    for K, Mc, ct, cin, U, es in [(27, 128, 64, 64, 256, 2),
                                  (27, 128, 192, 384, 384, 2),
                                  (27, 128, 320, 320, 384, 2),
                                  (27, 128, 320, 640, 384, 2),
                                  (8, 128, 384, 320, 160, 2),
                                  (27, 64, 32, 16, 160, 4)]:
        v1 = jax_cc._bwd_fused_eligible(K, Mc, ct, cin, ct, es)
        v2 = jax_cc._bwd_fused_v2_grouping(K, Mc, ct, cin, U, es)
        assert cc.fused_grouping(K, Mc, ct, cin, U, es) == (K if v1 else v2)
    n_planes = (64, 128, 192, 256, 320, 384)
    u_lvl, u_child, u_up = (256, 320, 384, 384, 384, 320), \
        (416, 576, 704, 768, 768), 160
    routes = []

    def route(K, cin, cout, U):
        routes.append(cc.fused_grouping(K, 128, cout, cin, U, 2))

    route(27, 16, 64, u_lvl[0])  # the first conv (Cin 3 padded to 16)

    def level(li):
        p = n_planes[li]
        route(27, p, p, u_lvl[li])
        route(27, p, p, u_lvl[li])
        if li + 1 == len(n_planes):
            return
        route(8, p, n_planes[li + 1], u_up)      # strided: transpose = up
        level(li + 1)
        route(8, n_planes[li + 1], p, u_child[li])  # deconv: child
        route(27, 2 * p, p, u_lvl[li])
        route(27, p, p, u_lvl[li])

    level(0)
    assert len(routes) == 33
    assert sum(g == 27 or g == 8 for g in routes) == 22
    assert sum(0 < g < 27 and g != 8 for g in routes) == 7
    assert routes.count(0) == 4
    # the guard: a transpose plan that does not tile the input rows
    assert cc.backward_grouping(1000, 16, 32, np.zeros((8, 160)),
                                np.zeros((8, 27, 128)), 4) == 0


def test_devoxelize_backward_matches_jax(layout_plans):
    """OutputLayer backward: the blocked segment sum of the cotangent."""
    jp, tp = layout_plans
    cap0 = tp.levels[0].cap
    rng = np.random.default_rng(11)
    v = rng.standard_normal((cap0, 8)).astype(np.float32)
    ct = rng.standard_normal((tp.p2v.shape[0], 8)).astype(np.float32)
    _, vjp = jax.vjp(lambda a: jax_pool.devoxelize_features(
        a, jnp.asarray(jp.p2v), vox_seg=jnp.asarray(jp.vox_seg)),
        jnp.asarray(v))
    ref, = vjp(jnp.asarray(ct))
    x = _t(v).requires_grad_()
    pool_ops.devoxelize_features(x, _t(tp.p2v), _t(tp.vox_seg)).backward(
        _t(ct))
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(ref), **TOL)


def test_voxelize_backward_matches_jax(layout_plans):
    """InputLayer backward: the point gather of the cotangent."""
    jp, tp = layout_plans
    cap0 = tp.levels[0].cap
    rng = np.random.default_rng(12)
    pts = rng.standard_normal((tp.p2v.shape[0], 3)).astype(np.float32)
    ct = rng.standard_normal((cap0, 3)).astype(np.float32)
    _, vjp = jax.vjp(lambda a: jax_pool.voxelize_features(
        a, jnp.asarray(jp.p2v), cap0, mode="mean",
        vox_seg=jnp.asarray(jp.vox_seg),
        vox_counts=jnp.asarray(jp.vox_counts)), jnp.asarray(pts))
    ref, = vjp(jnp.asarray(ct))
    x = _t(pts).requires_grad_()
    pool_ops.voxelize_features(x, _t(tp.p2v), cap0, _t(tp.vox_seg),
                               _t(tp.vox_counts)).backward(_t(ct))
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("leakiness", [0.0, 0.333, 1.0])
def test_train_batch_norm_matches_jax(leakiness):
    """Train-mode BN: outputs, gradients in feats / scale / bias, and the
    new running statistics (decay momentum, unbiased variance)."""
    rng = np.random.default_rng(13)
    cap, c, n = 300, 24, 217
    f = rng.standard_normal((cap, c)).astype(np.float32) * 2 + 0.5
    scale = rng.uniform(0.5, 1.5, c).astype(np.float32)
    bias = rng.standard_normal(c).astype(np.float32)
    mean = rng.standard_normal(c).astype(np.float32)
    var = rng.uniform(0.2, 3.0, c).astype(np.float32)
    ct = rng.standard_normal((cap, c)).astype(np.float32)

    def fn(ff, s, b):
        return jax_norm.batch_norm(
            ff, jnp.asarray(n, jnp.int32), s, b,
            jax_norm.BNState(jnp.asarray(mean), jnp.asarray(var)),
            leakiness=leakiness, training=True)

    (ref, new_state), vjp = jax.vjp(fn, jnp.asarray(f), jnp.asarray(scale),
                                    jnp.asarray(bias))
    zeros = jax.tree.map(jnp.zeros_like, new_state)
    ref_f, ref_s, ref_b = vjp((jnp.asarray(ct), zeros))

    x, s, b = (_t(a).requires_grad_() for a in (f, scale, bias))
    rm, rv = _t(mean.copy()), _t(var.copy())
    out = norm_ops.batch_norm_train(x, n, s, b, rm, rv, leakiness=leakiness)
    out.backward(_t(ct))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), **TOL)
    assert torch.all(out[n:] == 0)
    for got, want in ((x.grad, ref_f), (s.grad, ref_s), (b.grad, ref_b)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(rm.numpy(),
                               np.asarray(new_state.running_mean), **TOL)
    np.testing.assert_allclose(rv.numpy(),
                               np.asarray(new_state.running_var), **TOL)
