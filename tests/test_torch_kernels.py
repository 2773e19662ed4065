"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Marked `cuda` and skipped where `torch.cuda.is_available()` is false (the
decision is made in a fixture, never at import). This file imports no
jax, so on a machine with a card and no jax it runs without the repo's
conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py

It covers what the main path does not reach: chunks of M=64, channel
counts that are not multiples of the kernels' 64-column tiles, the dW
kernel's split into chunk ranges, both backward routes through autograd,
and the wrappers' input checks; and, small, what the training CLI's path
gives the kernels: the chunk plans of a blocked two-scene plan, and a plan
uploaded from page-locked memory.
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


@pytest.fixture(scope="module")
def blocked_plan():
    """The host plan of a blocked two-scene batch, chunked as the training
    loop's (`train.state.prepare_batch`): scene-pure chunks, global
    in_idx rows, per-scene active counts."""
    from occuseg_tpu_torch.train.state import prepare_batch
    batch = make_batch(SceneConfig(num_points=5_000, extent=96,
                                   num_objects=6),
                       num_scenes=2, p_cap=16_384, num_instances=16, seed=4)
    _, plan = prepare_batch(batch, PlanSpec(caps=(12_288, 8_192, 4_096)),
                            ns=2)
    assert np.ndim(plan.levels[0].num_active) == 1
    return plan


@pytest.mark.parametrize("kind", ["nbr", "child", "up"])
@pytest.mark.parametrize("fused", [True, False])
def test_blocked_plan_conv_on_card_matches_cpu(dev, blocked_plan, kind,
                                               fused):
    """The forward and one backward route on the blocked plan's own chunk
    plans, on the card (kernels) against the CPU (plain versions), f32,
    with the pad rows of both scenes zero as in the model."""
    from occuseg_tpu_torch.core.sparse_tensor import active_mask
    p = blocked_plan
    tr = p.transitions[0]
    l0, l1 = p.levels[0], p.levels[1]
    fwd, tp, n_in, n_out = {
        "nbr": (l0.chunks, l0.chunks, l0, l0),
        "child": (tr.child_chunks, tr.up_chunks, l0, l1),
        "up": (tr.up_chunks, tr.child_chunks, l1, l0)}[kind]
    cin, cout = 32, 48
    g = torch.Generator().manual_seed(6)
    K = fwd.lidx.shape[1]
    feats = torch.randn(n_in.cap, cin, generator=g)
    feats[~active_mask(n_in.num_active, n_in.cap)] = 0
    cot = torch.randn(n_out.cap, cout, generator=g)
    cot[~active_mask(n_out.num_active, n_out.cap)] = 0
    w = torch.randn(K, cin, cout, generator=g) / (cin * K) ** 0.5
    cpu = torch.device("cpu")

    def run(d):
        fi, fl, ti, tl = (torch.from_numpy(a).to(d) for a in (
            fwd.in_idx, fwd.lidx, tp.in_idx, tp.lidx))
        with torch.no_grad():
            out = cc.chunk_conv(feats.to(d), fi, fl, w.to(d))
        args = [t.to(d) for t in (cot, feats)] + [fi, fl]
        if kind == "nbr":
            return (out, *cc.sub_conv_backward(*args, w.to(d), fused))
        return (out, *cc.t_conv_backward(*args, ti, tl, w.to(d), fused))

    on_card = run(dev)
    torch.cuda.synchronize()
    ref = run(cpu)
    for a, b, tol in zip(on_card, ref, (1e-5, 1e-5, DW_TOL)):
        _check(a.cpu(), b, tol)


def test_pinned_plan_uploads_the_same(dev, blocked_plan):
    """`pinned()` holds what `to()` uploads as page-locked CPU tensors
    (the upload's own source, so the host allocator tracks the copy); both
    uploads give the same device arrays."""
    from occuseg_tpu_torch.train.state import pinned
    pp = blocked_plan.pinned()
    for a in (pp.p2v, pp.vox_seg, pp.levels[1].chunks.lidx,
              pp.transitions[0].up_chunks.in_idx):
        assert isinstance(a, torch.Tensor) and a.is_pinned()
    assert pp.levels[0].nbr is blocked_plan.levels[0].nbr
    a, b = blocked_plan.to(dev), pp.to(dev)
    torch.cuda.synchronize()
    for x, y in ((a.p2v, b.p2v), (a.vox_counts, b.vox_counts),
                 (a.levels[2].chunks.lidx, b.levels[2].chunks.lidx),
                 (a.transitions[1].child_chunks.in_idx,
                  b.transitions[1].child_chunks.in_idx)):
        assert x.is_cuda and torch.equal(x, y)
    batch, _ = pinned({"features": np.ones((4, 3), np.float32),
                       "coords": np.zeros((4, 4), np.int32)}, blocked_plan)
    assert batch["features"].is_pinned()
    assert isinstance(batch["coords"], np.ndarray)


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


# The BCE kernels (TPU rows #6-#8) on `bce_loss.exact_inputs`: every pair
# decision is exact in f32, so the counts must match exactly; the bce and
# gradient sums differ by f32 summation order over up to P terms and by
# the card's exp/log (1e-5 of the largest sum for the forward; 1e-4 for the
# backward, whose dmu = 2 (mu * sum g0 - sum g0 e) cancels).
@pytest.mark.parametrize("P,I,E", [(1000, 8, 16), (4096, 128, 64),
                                   (2000, 40, 136)])
def test_bce_kernels_match_plain(dev, P, I, E):
    from occuseg_tpu_torch.ops.kernels import bce_loss
    e, rx4, x4, seg, scene, mu, mp4, cons, g = bce_loss.exact_inputs(
        P, I, E, seed=P + I, device=dev)
    before = (bce_loss.radius_sq.launches, bce_loss.bce_sums.launches,
              bce_loss.bce_sums_bwd.launches)
    r = bce_loss.radius_sq(x4, seg, mp4, cons[bce_loss.MP_SQ])
    r_ref = bce_loss.radius_sq_plain(x4, seg, mp4, cons[bce_loss.MP_SQ])
    assert torch.equal(r, r_ref)
    cons = bce_loss.with_radius(x4, seg, mp4, cons)
    out = bce_loss.bce_sums(e, rx4, x4, seg, scene, mu, mp4, cons)
    ref = bce_loss.bce_sums_plain(e, rx4, x4, seg, scene, mu, mp4, cons)
    assert torch.equal(out[1:], ref[1:])            # counts: exact
    assert ref[1].sum() > 0 and ref[4].sum() > 0
    _check(out[0], ref[0], 1e-5)
    got = bce_loss.bce_sums_bwd(e, rx4, x4, seg, scene, mu, mp4, cons, g)
    want = bce_loss.bce_sums_bwd_plain(e, rx4, x4, seg, scene, mu, mp4,
                                       cons, g)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert a.shape == b.shape
        _check(a, b, 1e-4)
    # radius_sq ran twice: above, and inside with_radius
    assert (bce_loss.radius_sq.launches, bce_loss.bce_sums.launches,
            bce_loss.bce_sums_bwd.launches) == \
        tuple(n + k for n, k in zip(before, (2, 1, 1)))


def test_bce_membership_sums_gradients_match_plain(dev):
    """The autograd entry point on the card against the same function on
    the CPU (plain versions), through torch.autograd."""
    from occuseg_tpu_torch.ops.kernels import bce_loss
    rng = np.random.default_rng(7)
    P, I, E = 1024, 16, 32
    iid = rng.integers(0, I, P)
    iid[rng.random(P) < 0.2] = -1
    pose = rng.normal(0, 4.0, (I, 3))[np.clip(iid, 0, I - 1)] \
        + rng.normal(0, 0.7, (P, 3))
    data = dict(e=rng.normal(0, 1, (P, E)), rx=pose + rng.normal(0, .3, (P, 3)),
                sig=rng.normal(0.5, 0.2, (I, 2)), mu=rng.normal(0, 1, (I, E)),
                mean_pose=rng.normal(0, 4, (I, 3)), x=pose)
    ids = dict(instance_id=iid, point_scene=np.arange(P) * 2 // P,
               scene_i=rng.integers(0, 2, I), use=rng.random(I) < 0.9)

    def run(device):
        t = {k: torch.tensor(v, dtype=torch.float32, device=device,
                             requires_grad=k in ("e", "rx", "sig", "mu"))
             for k, v in data.items()}
        t.update({k: torch.tensor(v, device=device) for k, v in ids.items()})
        out = bce_loss.bce_membership_sums(**t)
        (out[0] * torch.linspace(0.5, 1.5, I, device=device)).sum().backward()
        return ([o.detach().cpu() for o in out],
                [t[k].grad.cpu() for k in ("e", "rx", "sig", "mu")])

    (o_card, g_card), (o_cpu, g_cpu) = run(dev), run("cpu")
    torch.cuda.synchronize()
    _check(o_card[0], o_cpu[0], 1e-4)
    for a, b in zip(g_card, g_cpu):
        _check(a, b, 1e-3)


@pytest.mark.parametrize("dt", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("level,cin,cout", [(0, 8, 24), (0, 64, 64),
                                            (3, 136, 72), (4, 256, 320)])
def test_gather_conv_matches_plain(dev, plan, dt, level, cin, cout):
    """TPU row #9 against its plain version; Cin and Cout multiples of 8
    but not of the kernel's tiles, and levels whose rows are not a
    multiple of the 64-row block."""
    from occuseg_tpu_torch.ops.kernels import gather_conv as gc
    nbr = plan.levels[level].nbr
    N = nbr.shape[0] - 40                  # rows past the block grid
    nbr_kn = np.where(nbr[:N] < N, nbr[:N], -1).T.copy()
    rng = np.random.default_rng(level)
    feats = torch.tensor(rng.standard_normal((N, cin)), dtype=dt, device=dev)
    w = torch.tensor(rng.standard_normal((27, cin, cout)) / cin ** 0.5,
                     dtype=dt, device=dev)
    nk = torch.from_numpy(nbr_kn).to(dev)
    before = gc.gather_conv.launches
    out = gc.gather_conv(feats, nk, w)
    ref = gc.gather_conv_plain(feats, nk, w)
    torch.cuda.synchronize()
    assert gc.gather_conv.launches == before + 1
    assert out.dtype == dt and out.shape == (N, cout)
    _check(out, ref, TOL[dt])
    with pytest.raises(ValueError, match="multiples of 8"):
        gc.gather_conv(feats[:, :4].contiguous(), nk, w[:, :4].contiguous())
