"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Marked `cuda` and skipped where `torch.cuda.is_available()` is false (the
decision is made in a fixture, never at import). This file imports no
jax, so on a machine with a card and no jax it runs without the repo's
conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py

It covers what the main path does not reach: chunks of M=64, channel
counts that are not multiples of the kernels' 64-column tiles, the dW
kernel's split into chunk ranges, both backward routes through autograd,
and the wrappers' input checks.
"""

import numpy as np
import pytest
import torch

from occuseg_tpu_torch.core.point_layout import augment_plan_with_point_layout
from occuseg_tpu_torch.core.topology import PlanSpec
from occuseg_tpu_torch.data.synthetic import SceneConfig, make_batch
from occuseg_tpu_torch.native.plan import build_plan_host
from occuseg_tpu_torch.ops.kernels import chunk_conv as cc
from occuseg_tpu_torch.ops.kernels import segsum

pytestmark = pytest.mark.cuda

# bf16: same bf16 inputs, f32 sums in another order, one final rounding:
# a few bf16 ulps (2^-8 relative each) of the largest output
TOL = {torch.bfloat16: 1e-2, torch.float32: 1e-5}
# dW is f32 for both input types: exact products, sums of up to ~12k terms
# in another order (atomics in the fused kernel)
DW_TOL = 1e-4


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def plan():
    batch = make_batch(SceneConfig(num_points=12_000, extent=128,
                                   num_objects=8),
                       num_scenes=1, p_cap=24_576, num_instances=16, seed=3)
    caps = (12_288, 8_192, 4_096, 2_048, 1_024, 512)
    return augment_plan_with_point_layout(
        build_plan_host(batch["coords"], PlanSpec(caps=caps)))


def _check(out, ref, tol):
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= tol * ref.float().abs().max().item(), err


def _maps(plan, kind):
    """(forward table, transpose table, forward input rows, output rows,
    U of the forward plan, U of the transpose plan) of a conv kind."""
    tr = plan.transitions[0]
    n0, n1 = plan.levels[0].cap, plan.levels[1].cap
    return {"nbr": (plan.levels[0].nbr, plan.levels[0].nbr, n0, n0, 512,
                    512),
            "child": (tr.child, tr.up, n0, n1, 1024, 256),
            "up": (tr.up, tr.child, n1, n0, 256, 1024)}[kind]


def _chunks(table, M, U, dev):
    arrs = cc.build_chunk_arrays(table, M, U)
    assert arrs is not None
    return tuple(torch.from_numpy(a).to(dev) for a in arrs)


@pytest.mark.parametrize("dt", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("M,kind,cin,cout", [
    (64, "nbr", 16, 32),
    (64, "nbr", 48, 96),
    (128, "nbr", 32, 48),
    (64, "child", 32, 80),
    (128, "up", 64, 112),
])
def test_chunk_conv_matches_plain(dev, plan, dt, M, kind, cin, cout):
    tr = plan.transitions[0]
    table, n_in, U = {"nbr": (plan.levels[0].nbr, plan.levels[0].cap, 512),
                      "child": (tr.child, plan.levels[0].cap, 1024),
                      "up": (tr.up, plan.levels[1].cap, 256)}[kind]
    arrs = cc.build_chunk_arrays(table, M, U)
    assert arrs is not None
    in_idx, lidx = (torch.from_numpy(a).to(dev) for a in arrs)
    g = torch.Generator().manual_seed(cin * cout + M)
    K = lidx.shape[1]
    x = torch.randn(n_in, cin, generator=g).to(dev, dt)
    w = (torch.randn(K, cin, cout, generator=g) / (cin * K) ** 0.5).to(dev,
                                                                       dt)
    before = cc.chunk_conv.launches
    with torch.no_grad():
        out = cc.chunk_conv(x, in_idx, lidx, w)
        ref = cc.chunk_conv_plain(x, in_idx, lidx, w)
    torch.cuda.synchronize()
    assert cc.chunk_conv.launches == before + 1
    assert out.shape == (table.shape[0], cout) and out.dtype == dt
    _check(out, ref, TOL[dt])


@pytest.mark.parametrize("dt", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("M,kind,cin,ct", [
    (64, "nbr", 16, 32),
    (128, "nbr", 48, 96),
    (64, "child", 32, 80),
    (128, "up", 112, 64),
])
def test_bwd_fused_matches_plain(dev, plan, dt, M, kind, cin, ct):
    """d_feats and dWt of the fused kernel over a transpose plan."""
    _, tmap, n_in, n_out, _, ut = _maps(plan, kind)
    t_in_idx, t_lidx = _chunks(tmap, M, ut, dev)
    g = torch.Generator().manual_seed(cin * ct + M)
    K = t_lidx.shape[1]
    cot = torch.randn(n_out, ct, generator=g).to(dev, dt)
    feats = torch.randn(n_in, cin, generator=g).to(dev, dt)
    w_t = (torch.randn(K, ct, cin, generator=g) / (ct * K) ** 0.5).to(dev, dt)
    before = cc.chunk_conv_bwd_fused.launches
    d_feats, dwt = cc.chunk_conv_bwd_fused(cot, t_in_idx, t_lidx, w_t, feats)
    ref_f, ref_w = cc.chunk_conv_bwd_fused_plain(cot, t_in_idx, t_lidx, w_t,
                                                 feats)
    torch.cuda.synchronize()
    assert cc.chunk_conv_bwd_fused.launches == before + 1
    assert d_feats.shape == (n_in, cin) and d_feats.dtype == dt
    assert dwt.shape == (K, cin, ct) and dwt.dtype == torch.float32
    _check(d_feats, ref_f, TOL[dt])
    _check(dwt, ref_w, DW_TOL)


@pytest.mark.parametrize("dt", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("M,kind,cin,cout", [
    (64, "nbr", 16, 48),     # small: several chunk ranges, then the sum
    (128, "nbr", 128, 80),
    (64, "child", 32, 96),
    (128, "up", 64, 64),
])
def test_dw_matches_plain(dev, plan, dt, M, kind, cin, cout):
    fmap, _, n_in, n_out, uf, _ = _maps(plan, kind)
    in_idx, lidx = _chunks(fmap, M, uf, dev)
    g = torch.Generator().manual_seed(cin * cout + M + 1)
    feats = torch.randn(n_in, cin, generator=g).to(dev, dt)
    cot = torch.randn(n_out, cout, generator=g).to(dev, dt)
    before = cc.chunk_conv_dw.launches
    dw = cc.chunk_conv_dw(feats, in_idx, lidx, cot)
    ref = cc.chunk_conv_dw_plain(feats, in_idx, lidx, cot)
    torch.cuda.synchronize()
    assert cc.chunk_conv_dw.launches == before + 1
    assert dw.shape == (lidx.shape[1], cin, cout)
    _check(dw, ref, DW_TOL)


@pytest.mark.parametrize("kind", ["nbr", "child", "up"])
@pytest.mark.parametrize("fused", [True, False])
def test_conv_backward_on_card_matches_cpu(dev, plan, kind, fused):
    """Both backward routes on the card (kernels) against the same route
    on the CPU (plain versions), f32, with the launches each route
    makes."""
    fmap, tmap, n_in, n_out, uf, ut = _maps(plan, kind)
    M, cin, cout = 128, 32, 48
    cpu = torch.device("cpu")
    fi, fl = _chunks(fmap, M, uf, cpu)
    ti, tl = _chunks(tmap, M, ut, cpu)
    g = torch.Generator().manual_seed(5)
    K = fl.shape[1]
    feats = torch.randn(n_in, cin, generator=g)
    cot = torch.randn(n_out, cout, generator=g)
    w = torch.randn(K, cin, cout, generator=g) / (cin * K) ** 0.5

    def run(d):
        args = [t.to(d) for t in (cot, feats, fi, fl)]
        if kind == "nbr":
            return cc.sub_conv_backward(*args, w.to(d), fused)
        return cc.t_conv_backward(*args, ti.to(d), tl.to(d), w.to(d), fused)

    counts = (cc.chunk_conv_bwd_fused.launches, cc.chunk_conv_dw.launches,
              cc.chunk_conv.launches)
    d_feats, d_w = run(dev)
    torch.cuda.synchronize()
    after = (cc.chunk_conv_bwd_fused.launches, cc.chunk_conv_dw.launches,
             cc.chunk_conv.launches)
    assert [a - b for a, b in zip(after, counts)] == \
        ([1, 0, 0] if fused else [0, 1, 1])
    ref_f, ref_w = run(cpu)
    _check(d_feats.cpu(), ref_f, 1e-5)
    _check(d_w.cpu(), ref_w, DW_TOL)


def test_chunk_conv_rejects_what_it_cannot_take(dev, plan):
    in_idx, lidx = (torch.from_numpy(a).to(dev) for a in
                    cc.build_chunk_arrays(plan.levels[0].nbr, 128, 512))
    n = plan.levels[0].cap
    w = torch.randn(27, 16, 32, device=dev, requires_grad=True)
    with pytest.raises(RuntimeError, match="not differentiable"):
        cc.chunk_conv(torch.randn(n, 16, device=dev), in_idx, lidx, w)
    with torch.no_grad():
        with pytest.raises(ValueError, match="multiples of 16"):
            cc.chunk_conv(torch.randn(n, 8, device=dev), in_idx, lidx,
                          torch.randn(27, 8, 32, device=dev))
        with pytest.raises(TypeError):
            cc.chunk_conv(torch.randn(n, 16, device=dev), in_idx.long(),
                          lidx, torch.randn(27, 16, 32, device=dev))


def test_segment_sum_matches_plain(dev, plan):
    vox_seg = torch.from_numpy(plan.vox_seg).to(dev)
    p2v = torch.from_numpy(plan.p2v).to(dev)
    cap0 = plan.levels[0].cap
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (plan.p2v.shape[0], 64)).astype(np.float32)).to(dev)
    before = segsum.blocked_segment_sum.launches
    out = segsum.sorted_segment_sum(x, p2v, vox_seg, cap0)
    assert segsum.blocked_segment_sum.launches == before + 1
    ref = segsum.blocked_segment_sum_plain(x, vox_seg, cap0) \
        + segsum.tail_segment_sum(x, p2v, vox_seg.shape[0] * vox_seg.shape[2],
                                  cap0)
    torch.cuda.synchronize()
    _check(out, ref, TOL[torch.float32])
