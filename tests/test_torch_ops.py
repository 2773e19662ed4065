"""Ops of the PyTorch port against their JAX counterparts on the CPU.

Same inputs (NumPy, seeded) through both; f32 at rtol=atol=1e-5 (only
summation order differs). Pallas kernels run in interpret mode, as the
JAX package's own tests run them. On CPU tensors the port's kernel
wrappers take their plain PyTorch versions, so these tests pin the
contract the CUDA kernels are then held to on the card."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from occuseg_tpu.core.point_layout import (
    augment_plan_with_point_layout as jax_augment_layout,
)
from occuseg_tpu.core.topology import PlanSpec as JaxPlanSpec
from occuseg_tpu.data.synthetic import SceneConfig, make_batch
from tests.jax_planner import host_plan as jax_build_plan_host
from occuseg_tpu.ops import conv as jax_conv
from occuseg_tpu.ops import norm as jax_norm
from occuseg_tpu.ops import pool as jax_pool
from occuseg_tpu.ops.pallas import chunk_conv as jax_cc
from occuseg_tpu.ops.pallas.segsum import (
    blocked_segment_sum as jax_blocked_segment_sum,
    sorted_segment_sum as jax_sorted_segment_sum,
)

from occuseg_tpu_torch.core.point_layout import augment_plan_with_point_layout
from occuseg_tpu_torch.core.topology import PlanSpec
from occuseg_tpu_torch.native.plan import build_plan_host
from occuseg_tpu_torch.ops import conv as conv_ops
from occuseg_tpu_torch.ops import norm as norm_ops
from occuseg_tpu_torch.ops import pool as pool_ops
from occuseg_tpu_torch.ops.kernels import chunk_conv as cc
from occuseg_tpu_torch.ops.kernels import segsum

torch.set_num_threads(2)

TOL = dict(rtol=1e-5, atol=1e-5)
M, U = 64, 160


@pytest.fixture(scope="module")
def small_plan():
    """The JAX chunk-conv tests' scene: caps (512, 256), M=64 chunks."""
    batch = make_batch(SceneConfig(num_points=1200, extent=48,
                                   num_objects=5),
                       num_scenes=1, p_cap=2048, num_instances=8, seed=3)
    return build_plan_host(batch["coords"], PlanSpec(caps=(512, 256)))


@pytest.fixture(scope="module")
def layout_plans():
    """The JAX point-layout tests' scene, with the default W=192, R=248."""
    caps = (12_288, 8_192, 4_096, 2_048, 1_024, 512)
    batch = make_batch(SceneConfig(num_points=12_000, extent=128,
                                   num_objects=8),
                       num_scenes=1, p_cap=24_576, num_instances=16, seed=3)
    jp = jax_augment_layout(jax_build_plan_host(batch["coords"],
                                                JaxPlanSpec(caps=caps)))
    tp = augment_plan_with_point_layout(build_plan_host(batch["coords"],
                                                        PlanSpec(caps=caps)))
    assert tp.vox_seg is not None
    return jp, tp


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def test_chunk_conv_plain_matches_pallas(small_plan):
    nbr = small_plan.levels[0].nbr
    in_idx, lidx = cc.build_chunk_arrays(nbr, M, U)
    rng = np.random.default_rng(0)
    feats = rng.standard_normal((512, 16)).astype(np.float32)
    feats[small_plan.levels[0].num_active:] = 0  # pad rows, as in the model
    w = (rng.standard_normal((27, 16, 32)) * 0.1).astype(np.float32)
    ref = jax_cc.chunk_gather_conv(jnp.asarray(feats), jnp.asarray(in_idx),
                                   jnp.asarray(lidx), jnp.asarray(w))
    before = cc.chunk_conv.launches
    out = cc.chunk_conv(_t(feats), _t(in_idx), _t(lidx), _t(w))
    assert cc.chunk_conv.launches == before  # CPU: plain version, no launch
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    # the chunked plain version is the neighbor-map convolution
    gref = jax_conv.gather_conv(jnp.asarray(feats), jnp.asarray(nbr),
                                jnp.asarray(w))
    np.testing.assert_allclose(
        conv_ops.gather_conv(_t(feats), _t(nbr), _t(w)).numpy(),
        np.asarray(gref), **TOL)
    np.testing.assert_allclose(out.numpy(), np.asarray(gref), **TOL)


@pytest.mark.parametrize("kind", ["child", "up"])
def test_transition_chunk_conv_matches_pallas(small_plan, kind):
    """Strided conv (child map, fine -> coarse) and deconv (up map, coarse
    -> fine) through chunk_gather_conv_t."""
    tr = small_plan.transitions[0]
    fwd, tmap = (tr.child, tr.up) if kind == "child" else (tr.up, tr.child)
    uf, ut = (256, 128) if kind == "child" else (128, 256)
    fi, fl = cc.build_chunk_arrays(fwd, M, uf)
    ti, tl = cc.build_chunk_arrays(tmap, M, ut)
    n_in = tr.up.shape[0] if kind == "child" else tr.child.shape[0]
    rng = np.random.default_rng(9)
    feats = rng.standard_normal((n_in, 32)).astype(np.float32)
    w = (rng.standard_normal((8, 32, 48)) * 0.1).astype(np.float32)
    ref = jax_cc.chunk_gather_conv_t(
        jnp.asarray(feats), jnp.asarray(fi), jnp.asarray(fl),
        jnp.asarray(ti), jnp.asarray(tl), jnp.asarray(w))
    out = cc.chunk_conv(_t(feats), _t(fi), _t(fl), _t(w))
    assert out.shape == (fwd.shape[0], 48)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_chunk_conv_all_pad_chunks_are_zero(small_plan):
    """Chunks past num_active and missing neighbors contribute exact 0."""
    in_idx, lidx = cc.build_chunk_arrays(small_plan.levels[0].nbr, M, U)
    n = small_plan.levels[0].num_active
    rng = np.random.default_rng(2)
    feats = _t(rng.standard_normal((512, 16)).astype(np.float32))
    w = _t(rng.standard_normal((27, 16, 32)).astype(np.float32))
    out = cc.chunk_conv(feats, _t(in_idx), _t(lidx), w)
    assert torch.all(out[n:] == 0)
    assert torch.all(out[:n].abs().sum(1) > 0)


def test_segment_sum_matches_pallas(layout_plans):
    jp, tp = layout_plans
    rng = np.random.default_rng(4)
    x = rng.standard_normal((tp.p2v.shape[0], 3)).astype(np.float32)
    cap0 = tp.levels[0].cap
    ref_b = jax_blocked_segment_sum(jnp.asarray(x), jnp.asarray(jp.vox_seg),
                                    cap0)
    before = segsum.blocked_segment_sum.launches
    out_b = segsum.blocked_segment_sum(_t(x), _t(tp.vox_seg), cap0)
    assert segsum.blocked_segment_sum.launches == before
    np.testing.assert_allclose(out_b.numpy(), np.asarray(ref_b), **TOL)
    ref = jax_sorted_segment_sum(jnp.asarray(x), jnp.asarray(jp.p2v),
                                 jnp.asarray(jp.vox_seg), cap0)
    out = segsum.sorted_segment_sum(_t(x), _t(tp.p2v), _t(tp.vox_seg), cap0)
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_tail_segment_sum_routes_overflow_rows():
    """Rows past the main region go by their absolute p2v (-1 skipped)."""
    x = torch.arange(12, dtype=torch.float32).reshape(6, 2)
    p2v = torch.tensor([0, 0, 1, 2, -1, 2], dtype=torch.int32)
    out = segsum.tail_segment_sum(x, p2v, 3, 4)
    ref = np.zeros((4, 2), np.float32)
    ref[2] = x[3].numpy() + x[5].numpy()
    np.testing.assert_array_equal(out.numpy(), ref)


def test_voxelize_mean_and_devoxelize_match_jax(layout_plans):
    jp, tp = layout_plans
    rng = np.random.default_rng(5)
    pts = rng.standard_normal((tp.p2v.shape[0], 3)).astype(np.float32)
    cap0 = tp.levels[0].cap
    ref = jax_pool.voxelize_features(
        jnp.asarray(pts), jnp.asarray(jp.p2v), cap0, mode="mean",
        vox_seg=jnp.asarray(jp.vox_seg), vox_counts=jnp.asarray(jp.vox_counts))
    vox = pool_ops.voxelize_features(_t(pts), _t(tp.p2v), cap0,
                                     _t(tp.vox_seg), _t(tp.vox_counts))
    np.testing.assert_allclose(vox.numpy(), np.asarray(ref), **TOL)

    v = rng.standard_normal((cap0, 8)).astype(np.float32)
    dref = jax_pool.devoxelize_features(jnp.asarray(v), jnp.asarray(jp.p2v),
                                        vox_seg=jnp.asarray(jp.vox_seg))
    dev = pool_ops.devoxelize_features(_t(v), _t(tp.p2v), _t(tp.vox_seg))
    np.testing.assert_array_equal(dev.numpy(), np.asarray(dref))
    assert torch.all(dev[_t(tp.p2v) < 0] == 0)  # -1 rows are zero, not v[-1]


def test_voxelize_needs_point_layout(small_plan):
    """Without the sorted point layout (caps it does not fit) the port
    takes the JAX package's fallback, a segment sum over p2v: the voxel
    means and the gradient of the point gather match `jax.ops.
    segment_sum`'s path, in f32 to 1e-5."""
    x = np.random.default_rng(8).standard_normal((2048, 3)).astype(
        np.float32)
    p2v = small_plan.p2v
    want = jax_pool.voxelize_features(jnp.asarray(x), jnp.asarray(p2v), 512)
    got = pool_ops.voxelize_features(_t(x), _t(p2v), 512, None, None)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    vox = torch.from_numpy(np.asarray(want)).requires_grad_()
    ct = np.random.default_rng(9).standard_normal((2048, 3)).astype(
        np.float32)
    (pool_ops.devoxelize_features(vox, _t(p2v), None) * _t(ct)).sum() \
        .backward()
    g = jax.grad(lambda v: jnp.sum(jax_pool.devoxelize_features(
        v, jnp.asarray(p2v)) * ct))(jnp.asarray(want))
    np.testing.assert_allclose(vox.grad.numpy(), np.asarray(g), **TOL)


@pytest.mark.parametrize("leakiness", [0.0, 0.333, 1.0])
def test_eval_batch_norm_matches_jax(leakiness):
    rng = np.random.default_rng(6)
    cap, c, n = 300, 24, 217
    f = rng.standard_normal((cap, c)).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, c).astype(np.float32)
    bias = rng.standard_normal(c).astype(np.float32)
    mean = rng.standard_normal(c).astype(np.float32)
    var = rng.uniform(0.2, 3.0, c).astype(np.float32)
    ref, _ = jax_norm.batch_norm(
        jnp.asarray(f), jnp.asarray(n, jnp.int32), jnp.asarray(scale),
        jnp.asarray(bias), jax_norm.BNState(jnp.asarray(mean),
                                            jnp.asarray(var)),
        leakiness=leakiness, training=False)
    out = norm_ops.batch_norm_eval(_t(f), n, _t(scale), _t(bias), _t(mean),
                                   _t(var), leakiness=leakiness)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    assert torch.all(out[n:] == 0)


def test_nin_matches_jax():
    rng = np.random.default_rng(7)
    f = rng.standard_normal((100, 48)).astype(np.float32)
    w = rng.standard_normal((48, 32)).astype(np.float32)
    ref = jax_conv.nin(jnp.asarray(f), jnp.asarray(w))
    np.testing.assert_allclose(conv_ops.nin(_t(f), _t(w)).numpy(),
                               np.asarray(ref), **TOL)
