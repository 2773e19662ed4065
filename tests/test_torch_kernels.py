"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Marked `cuda` and skipped where `torch.cuda.is_available()` is false (the
decision is made in a fixture, never at import). This file imports no
jax, so on a machine with a card and no jax it runs without the repo's
conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py

It covers what the main path does not reach: chunks of M=32 and 64,
channel counts that are not multiples of the kernels' column tiles, Cin=16,
all-pad chunks and offsets whose 16-row fragments miss entirely, the widest
U (a tier-1.7 transpose plan), a coarse level of a few chunks (the
forward's split steps), the weight-gradient kernel's runs on both routes
(one chunk, all-pad chunks, Cin 640, U=1312 for dW; both results
bitwise repeatable; the f32 tile each route takes, the tensor-core tile
against the FMA tile and float64 at the bench plan's shapes and its count
of k8 steps), the f32 forward's row order (a plan with its rows
permuted gives the same bits; its count of skipped warp-steps against
the plain count on the bench plan's maps and on a split coarse level),
both backward routes through autograd, the segment
sum at both block sizes bit for bit against its slot-order replay
(`tests/segsum_replay.py`), the BCE kernels from I=1 to 128 (a P that is
not a multiple of their tiles, all points invalid, a forward and a
backward whose tiles overflow the pair list, both repeated bit for bit,
their shared-memory plan against the device's) and the wrappers' input
checks; and, small, what the training
CLI's path gives the kernels: the chunk plans of a blocked two-scene
plan, and a plan uploaded from page-locked memory.
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
# in another order (per run of chunks, then over the runs)
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
    """d_feats and dWt of the fused kernel over a transpose plan (f32:
    dWt on the route rule's tile)."""
    _, tmap, n_in, n_out, _, ut = _maps(plan, kind)
    t_in_idx, t_lidx = _chunks(tmap, M, ut, dev)
    g = torch.Generator().manual_seed(cin * ct + M)
    K = t_lidx.shape[1]
    cot = torch.randn(n_out, ct, generator=g).to(dev, dt)
    feats = torch.randn(n_in, cin, generator=g).to(dev, dt)
    w_t = (torch.randn(K, ct, cin, generator=g) / (ct * K) ** 0.5).to(dev, dt)
    before = cc.chunk_conv_bwd_fused.launches
    tiles = _dw_tiles(cc.chunk_conv_bwd_fused)
    d_feats, dwt = cc.chunk_conv_bwd_fused(cot, t_in_idx, t_lidx, w_t, feats)
    ref_f, ref_w = cc.chunk_conv_bwd_fused_plain(cot, t_in_idx, t_lidx, w_t,
                                                 feats)
    torch.cuda.synchronize()
    assert cc.chunk_conv_bwd_fused.launches == before + 1
    _check_tile(cc.chunk_conv_bwd_fused, tiles, dt, cc.dw_route(
        ct, cin, K, t_in_idx.shape[1], _smem(dev)))
    assert d_feats.shape == (n_in, cin) and d_feats.dtype == dt
    assert dwt.shape == (K, cin, ct) and dwt.dtype == torch.float32
    _check(d_feats, ref_f, TOL[dt])
    _check(dwt, ref_w, DW_TOL)


def _dw_tiles(fn):
    """The f32 launches of the weight-gradient kernel by tile counted on
    a wrapper (`chunk_conv_dw`, or `chunk_conv_bwd_fused` for its dWt)."""
    return fn.launches_f32_tc, fn.launches_f32_fma


def _check_tile(fn, before, dt, route):
    """One f32 launch on `route`'s tile since `before` (none for bf16)."""
    got = [a - b for a, b in zip(_dw_tiles(fn), before)]
    want = [0, 0] if dt == torch.bfloat16 else \
        [int(route == "tc"), int(route == "fma")]
    assert got == want, (got, route)


@pytest.mark.parametrize("dt", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("M,kind,cin,cout", [
    (64, "nbr", 16, 48),     # small: several chunk ranges, then the sum
    (128, "nbr", 128, 80),
    (128, "nbr", 96, 256),
    (128, "nbr", 256, 96),
    (64, "child", 32, 96),
    (128, "up", 64, 64),
])
def test_dw_matches_plain(dev, plan, dt, M, kind, cin, cout):
    """dW over a forward plan on the tile the route rule takes (f32: the
    tensor-core tile, Cin 16 included)."""
    fmap, _, n_in, n_out, uf, _ = _maps(plan, kind)
    in_idx, lidx = _chunks(fmap, M, uf, dev)
    g = torch.Generator().manual_seed(cin * cout + M + 1)
    feats = torch.randn(n_in, cin, generator=g).to(dev, dt)
    cot = torch.randn(n_out, cout, generator=g).to(dev, dt)
    before = cc.chunk_conv_dw.launches
    tiles = _dw_tiles(cc.chunk_conv_dw)
    dw = cc.chunk_conv_dw(feats, in_idx, lidx, cot)
    ref = cc.chunk_conv_dw_plain(feats, in_idx, lidx, cot)
    torch.cuda.synchronize()
    assert cc.chunk_conv_dw.launches == before + 1
    route = cc.dw_route(cin, cout, lidx.shape[1], uf, _smem(dev))
    assert route == "tc"
    _check_tile(cc.chunk_conv_dw, tiles, dt, route)
    assert dw.shape == (lidx.shape[1], cin, cout)
    _check(dw, ref, DW_TOL)


def _dw_case(plan, case):
    """(forward table, input rows, U, M, cin, cout) of a dW edge case:
    one chunk; a plan whose last two chunks are all pad (each its own run:
    all-pad runs); the widest bench width (dec0.conv1 at L4: 640 -> 320);
    the widest U tier (a child plan at tier 1.7, U=1312)."""
    nbr = np.asarray(plan.levels[0].nbr)
    n0 = plan.levels[0].cap
    if case == "one_chunk":
        return nbr[:128], n0, 512, 128, 64, 48
    if case == "all_pad":
        pad = np.full((256, nbr.shape[1]), -1, nbr.dtype)
        return np.concatenate([nbr[:1024], pad]), n0, 512, 128, 32, 64
    if case == "wide":
        return nbr[:2048], n0, 512, 128, 640, 320
    return np.asarray(plan.transitions[0].child), n0, 1312, 128, 64, 64


@pytest.mark.parametrize("dt", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("case", ["one_chunk", "all_pad", "wide",
                                  "widest_u"])
def test_dw_edge_cases_match_plain(dev, plan, dt, case):
    table, n_in, U, M, cin, cout = _dw_case(plan, case)
    in_idx, lidx = _chunks(table, M, U, dev)
    if case == "all_pad":
        assert (in_idx[-2:, 0] < 0).all()
    g = torch.Generator().manual_seed(cin + cout + U)
    feats = torch.randn(n_in, cin, generator=g).to(dev, dt)
    cot = torch.randn(table.shape[0], cout, generator=g).to(dev, dt)
    tiles = _dw_tiles(cc.chunk_conv_dw)
    dw = cc.chunk_conv_dw(feats, in_idx, lidx, cot)
    ref = cc.chunk_conv_dw_plain(feats, in_idx, lidx, cot)
    torch.cuda.synchronize()
    route = cc.dw_route(cin, cout, lidx.shape[1], U, _smem(dev))
    assert route == "tc"
    _check_tile(cc.chunk_conv_dw, tiles, dt, route)
    assert dw.shape == (lidx.shape[1], cin, cout)
    _check(dw, ref, DW_TOL)


@pytest.mark.parametrize("dt", [torch.bfloat16, torch.float32])
def test_dw_is_deterministic(dev, plan, dt):
    """dW is summed per run of chunks and then over the runs in order: two
    launches give the same bits."""
    in_idx, lidx = _chunks(plan.levels[0].nbr, 128, 512, dev)
    n = plan.levels[0].cap
    g = torch.Generator().manual_seed(16)
    x = torch.randn(n, 64, generator=g).to(dev, dt)
    cot = torch.randn(n, 128, generator=g).to(dev, dt)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    assert cc.dwt_runs(in_idx.shape[0], 27, 128, 64, sms) > 1
    tiles = _dw_tiles(cc.chunk_conv_dw)
    a = cc.chunk_conv_dw(x, in_idx, lidx, cot)
    b = cc.chunk_conv_dw(x, in_idx, lidx, cot)
    torch.cuda.synchronize()
    assert torch.equal(a, b)
    if dt == torch.float32:  # the tensor-core tile, twice
        assert [u - v for u, v in zip(_dw_tiles(cc.chunk_conv_dw),
                                      tiles)] == [2, 0]


def _fwd_and_fused(dev, in_idx, lidx, t_in_idx, t_lidx, n_in, n_out, cin,
                   cout, dt, seed):
    """The forward over (in_idx, lidx) and the fused backward over the
    transpose plan, each against its plain version."""
    g = torch.Generator().manual_seed(seed)
    K = lidx.shape[1]
    x = torch.randn(n_in, cin, generator=g).to(dev, dt)
    w = (torch.randn(K, cin, cout, generator=g) / (cin * K) ** 0.5).to(dev,
                                                                       dt)
    cot = torch.randn(n_out, cout, generator=g).to(dev, dt)
    w_t = w.transpose(1, 2).contiguous()
    with torch.no_grad():
        out = cc.chunk_conv(x, in_idx, lidx, w)
        ref = cc.chunk_conv_plain(x, in_idx, lidx, w)
        d_f, dwt = cc.chunk_conv_bwd_fused(cot, t_in_idx, t_lidx, w_t, x)
        r_f, r_w = cc.chunk_conv_bwd_fused_plain(cot, t_in_idx, t_lidx, w_t,
                                                 x)
    torch.cuda.synchronize()
    assert out.shape == (lidx.shape[0] * lidx.shape[2], cout)
    _check(out, ref, TOL[dt])
    _check(d_f, r_f, TOL[dt])
    _check(dwt, r_w, DW_TOL)
    return out, d_f, dwt


@pytest.mark.parametrize("dt", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("M,cin,cout", [
    (32, 16, 80),
    (32, 64, 112),
    (64, 16, 320),
    (128, 80, 320),
    (128, 16, 112),
])
def test_column_tiles_and_small_chunks(dev, plan, dt, M, cin, cout):
    """M=32/64, Cin=16, Cout not a multiple of any column tile (80, 112,
    320), through the forward and the fused backward (a submanifold plan
    is its own transpose)."""
    in_idx, lidx = _chunks(plan.levels[0].nbr, M, 512, dev)
    n = plan.levels[0].cap
    _fwd_and_fused(dev, in_idx, lidx, in_idx, lidx, n, n, cin, cout, dt,
                   M + cin + cout)


@pytest.mark.parametrize("dt", [torch.bfloat16, torch.float32])
def test_pad_chunks_and_empty_fragments(dev, plan, dt):
    """All-pad chunks write zeros; offsets whose 16-row fragments have no
    valid reference (some rows missing everywhere) are skipped without
    changing the result."""
    arrs = cc.build_chunk_arrays(plan.levels[0].nbr, 128, 512)
    in_idx, lidx = (a.copy() for a in arrs)
    C, K, M = lidx.shape
    lidx[1, :, 16:48] = -1            # two fragments of every offset
    lidx[2, 5:20, :] = -1             # whole offsets of a chunk
    lidx[3, :, :] = -1                # a chunk that references nothing...
    in_idx[3, :] = -1                 # ...is an all-pad chunk
    in_idx = np.concatenate([in_idx, np.full((3, in_idx.shape[1]), -1,
                                             np.int32)])
    lidx = np.concatenate([lidx, np.full((3, K, M), -1, np.int32)])
    fi, fl = (torch.from_numpy(a).to(dev) for a in (in_idx, lidx))
    n = plan.levels[0].cap
    out, d_f, _ = _fwd_and_fused(dev, fi, fl, fi, fl, n + 3 * M, n + 3 * M,
                                 32, 64, dt, 11)
    for t in (out, d_f):
        assert not t[3 * M:4 * M].any() and not t[C * M:].any()


@pytest.mark.parametrize("dt", [torch.bfloat16, torch.float32])
def test_widest_transpose_plan(dev, plan, dt):
    """The deconvolution backward's transpose plan (child chunks) at U =
    1312, tier 1.7's budget: the widest staging the kernels take. dWt
    takes the tensor-core tile there (it stages only the rows a group of
    offsets references); the FMA tile, asked for, gives dWt too."""
    tr = plan.transitions[0]
    n0, n1 = plan.levels[0].cap, plan.levels[1].cap
    up_i, up_l = _chunks(tr.up, 128, 256, dev)      # forward: L1 -> L0
    ch_i, ch_l = _chunks(tr.child, 128, 1312, dev)  # its transpose
    assert ch_i.shape[1] == 1312
    assert cc.dw_route(96, 64, 8, 1312, _smem(dev)) == "tc"
    tiles = _dw_tiles(cc.chunk_conv_bwd_fused)
    _, _, dwt = _fwd_and_fused(dev, up_i, up_l, ch_i, ch_l, n1, n0, 64, 96,
                               dt, 12)
    _check_tile(cc.chunk_conv_bwd_fused, tiles, dt, "tc")
    if dt == torch.float32:
        g = torch.Generator().manual_seed(13)
        cot = torch.randn(n0, 96, generator=g).to(dev)
        x = torch.randn(n1, 64, generator=g).to(dev)
        fma = cc._run_dw("test", cc.chunk_conv_bwd_fused, cot, ch_i, ch_l,
                         x, False, route="fma")
        tc = cc._run_dw("test", cc.chunk_conv_bwd_fused, cot, ch_i, ch_l,
                        x, False, route="tc")
        ref = cc.chunk_conv_dw_plain(cot, ch_i, ch_l, x).transpose(1, 2)
        _check(fma, ref, DW_TOL)
        _check(tc, ref, DW_TOL)


@pytest.mark.parametrize("dt", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("K_kind", ["nbr", "child"])
def test_coarse_level_split(dev, plan, dt, K_kind):
    """A coarse level of at most 8 chunks at Cout=384: too few blocks for
    the card, so the forward splits its (Cin tile, offset) steps and sums
    the partials in order; the same shape through the fused backward."""
    if K_kind == "nbr":  # the level's first 8 chunks, closed under nbr
        nbr = plan.levels[3].nbr[:1024]
        table = np.where(nbr < 1024, nbr, -1).astype(np.int32)
    else:
        table = plan.transitions[3].child
    in_idx, lidx = _chunks(table, 128, 1024, dev)
    C = lidx.shape[0]
    assert C <= 8
    cin, cout = 320, 384
    nt = cc.col_tile(cout, dt == torch.bfloat16)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    assert cc.conv_splits(C, -(-cout // nt), lidx.shape[1] * 5, sms) > 1
    if K_kind == "nbr":
        _fwd_and_fused(dev, in_idx, lidx, in_idx, lidx, C * 128, C * 128,
                       cin, cout, dt, 13)
    else:
        n_in = plan.levels[3].cap
        g = torch.Generator().manual_seed(14)
        x = torch.randn(n_in, cin, generator=g).to(dev, dt)
        w = (torch.randn(8, cin, cout, generator=g) / (cin * 8) ** 0.5).to(
            dev, dt)
        with torch.no_grad():
            _check(cc.chunk_conv(x, in_idx, lidx, w),
                   cc.chunk_conv_plain(x, in_idx, lidx, w), TOL[dt])


def _permute_rows(lidx, seed):
    """lidx with each chunk's rows in a random order, and that order
    ([C, M]: row j of the new chunk is row perm[c, j] of the old)."""
    C, K, M = lidx.shape
    g = torch.Generator().manual_seed(seed)
    perm = torch.stack([torch.randperm(M, generator=g) for _ in range(C)])
    perm = perm.to(lidx.device)
    return torch.gather(lidx, 2, perm[:, None].expand(C, K, M)), perm


@pytest.mark.parametrize("kind,cin,cout", [("nbr", 64, 64),
                                           ("child", 64, 128),
                                           ("up", 128, 64)])
def test_f32_forward_is_independent_of_row_order(dev, plan, kind, cin, cout):
    """The f32 forward orders each chunk's rows by neighbour mask and
    skips an offset where none of a warp's rows has a reference: every
    output keeps its sum's order, so a plan whose chunks list their rows
    in another order gives the same bits, row for row."""
    table, _, n_in, _, U, _ = _maps(plan, kind)
    in_idx, lidx = _chunks(table, 128, U, dev)
    lidx_p, perm = _permute_rows(lidx, 16)
    g = torch.Generator().manual_seed(17)
    K, (C, M) = lidx.shape[1], perm.shape
    x = torch.randn(n_in, cin, generator=g).to(dev)
    w = (torch.randn(K, cin, cout, generator=g) / (cin * K) ** 0.5).to(dev)
    with torch.no_grad():
        out = cc.chunk_conv(x, in_idx, lidx, w)
        out_p = cc.chunk_conv(x, in_idx, lidx_p, w)
    torch.cuda.synchronize()
    back = torch.empty_like(out_p).reshape(C, M, cout)
    back.scatter_(1, perm[..., None].expand(C, M, cout),
                  out_p.reshape(C, M, cout))
    assert torch.equal(out.reshape(C, M, cout), back)
    _check(out, cc.chunk_conv_plain(x, in_idx, lidx, w), TOL[torch.float32])


@pytest.fixture(scope="module")
def bench_plan(dev):
    """The bench scene's plan (`chip_smoke.py`), on the card."""
    import chip_smoke as cs
    from occuseg_tpu_torch.infer import prepare_scene
    b = cs.bench_scene(0)
    return prepare_scene(b["coords"], b["features"],
                         PlanSpec(caps=cs.BENCH_CAPS)).plan.to(dev)


def _bench_map(plan, kind):
    """(chunks, input rows, Cin, Cout) of a bench-plan map at the model's
    widths (64, 128, 192, ...)."""
    tr = plan.transitions[0]
    return {"L0": (plan.levels[0].chunks, plan.levels[0].cap, 64, 64),
            "L2": (plan.levels[2].chunks, plan.levels[2].cap, 192, 192),
            "child": (tr.child_chunks, plan.levels[0].cap, 64, 128),
            "up": (tr.up_chunks, plan.levels[1].cap, 128, 64)}[kind]


def _counted_f32(dev, in_idx, lidx, n_in, cin, cout, seed, route=None):
    """(output, plain output, counts) of one f32 forward, on the tile the
    wrapper picks or on `route`'s."""
    g = torch.Generator().manual_seed(seed)
    K = lidx.shape[1]
    x = torch.randn(n_in, cin, generator=g).to(dev)
    w = (torch.randn(K, cin, cout, generator=g) / (cin * K) ** 0.5).to(dev)
    cc.fwd_counts(dev, reset=True)
    with torch.no_grad():
        out = cc._run_chunk_conv("test", x, in_idx, lidx, w, route=route)
        ref = cc.chunk_conv_plain(x, in_idx, lidx, w)
    return out, ref, cc.fwd_counts(dev, reset=True)


def _smem(dev):
    return torch.cuda.get_device_properties(dev).shared_memory_per_block_optin


def _tc_tiles(cin, cout, K, U, dev):
    """(Cin tile, column tile) pairs of a tensor-core call."""
    return -(-cin // 32) * -(-cout // cc.tc_col_tile(cout, K, U, _smem(dev)))


@pytest.mark.parametrize("kind", ["L0", "L2", "child", "up"])
def test_f32_forward_counts_its_skipped_steps(dev, bench_plan, kind):
    """Each f32 tile's count of steps run and skipped equals its plain
    count on the bench plan's maps, exactly: the tensor-core tile's (Cin
    tile, offset, 64-row group) steps (`fwd_group_steps`) and the FMA
    tile's (Cin tile, offset, warp) steps (`fwd_warp_steps`); the blocks
    count the row order's cycles."""
    chunks, n_in, cin, cout = _bench_map(bench_plan, kind)
    in_idx, lidx = chunks.in_idx, chunks.lidx
    (C, U), K = in_idx.shape, lidx.shape[1]
    out, ref, n = _counted_f32(dev, in_idx, lidx, n_in, cin, cout, 18,
                               route="tc")
    _check(out, ref, TOL[torch.float32])
    assert (n.group_ran, n.group_skipped) == cc.fwd_group_steps(
        lidx.cpu(), _tc_tiles(cin, cout, K, U, dev))
    assert (n.ran, n.skipped) == (0, 0)
    assert n.group_skipped > 0 and 0 < n.order_cycles < n.block_cycles
    out, ref, n = _counted_f32(dev, in_idx, lidx, n_in, cin, cout, 18,
                               route="fma")
    _check(out, ref, TOL[torch.float32])
    tiles = (cin // cc.fwd_cin_tile(cin, U, K)
             * -(-cout // cc.col_tile(cout, False)))
    assert (n.ran, n.skipped) == cc.fwd_warp_steps(lidx.cpu(), tiles)
    assert (n.group_ran, n.group_skipped) == (0, 0)
    assert n.skipped > 0 and 0 < n.order_cycles < n.block_cycles


def test_f32_forward_split_counts_and_matches_plain(dev, plan):
    """The coarse-level split in f32 (8 chunks of L3 at Cin 320, Cout
    384: the (Cin tile, offset) steps cut into ranges, one block each,
    the partials summed in order) against the plain version, and its
    count against the plain count, on both tiles (the wrapper's route
    there is the tensor cores')."""
    nbr = plan.levels[3].nbr[:1024]
    table = np.where(nbr < 1024, nbr, -1).astype(np.int32)
    in_idx, lidx = _chunks(table, 128, 1024, dev)
    C, K, _ = lidx.shape
    cin, cout = 320, 384
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    assert cc.conv_splits(C, -(-cout // 64), K * 5, sms) > 1
    assert cc.f32_route(cin, cout, 128, K, 1024, _smem(dev)) == "tc"
    out, ref, n = _counted_f32(dev, in_idx, lidx, 1024, cin, cout, 19)
    _check(out, ref, TOL[torch.float32])
    assert (n.group_ran, n.group_skipped) == cc.fwd_group_steps(
        lidx.cpu(), _tc_tiles(cin, cout, K, 1024, dev))
    out, ref, n = _counted_f32(dev, in_idx, lidx, 1024, cin, cout, 19,
                               route="fma")
    _check(out, ref, TOL[torch.float32])
    tiles = (cin // cc.fwd_cin_tile(cin, in_idx.shape[1], K)
             * -(-cout // 64))
    assert (n.ran, n.skipped) == cc.fwd_warp_steps(lidx.cpu(), tiles)


def _bench_pair(plan, kind):
    """(forward chunks, transpose chunks, input rows, output rows) of a
    bench-plan map."""
    tr = plan.transitions[0]
    l0, l1 = plan.levels[0], plan.levels[1]
    l3 = plan.levels[3]
    return {"L0": (l0.chunks, l0.chunks, l0.cap, l0.cap),
            "L3": (l3.chunks, l3.chunks, l3.cap, l3.cap),
            "child": (tr.child_chunks, tr.up_chunks, l0.cap, l1.cap),
            "up": (tr.up_chunks, tr.child_chunks, l1.cap, l0.cap)}[kind]


# the tensor-core tile's card shapes: bench L0 (27 offsets) 64 -> 64, a
# strided map (K = 8) 64 -> 128, an up map 128 -> 64, minkunet34c's
# level-0 128 -> 96 and 96 -> 96, occuseg-m64's input conv (Cin 3 padded
# to 16); each forward and over its transpose plan (d_feats)
TC_SHAPES = [("L0", 64, 64), ("child", 64, 128), ("up", 128, 64),
             ("L0", 128, 96), ("L0", 96, 96), ("L0", 16, 64)]


def _f32_errors(out, ref64):
    d = (out.double() - ref64).abs()
    scale = ref64.abs().max().item()
    return d.mean().item() / scale, d.max().item() / scale


@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("kind,cin,cout", TC_SHAPES)
def test_tc_tile_against_plain_fma_and_float64(dev, bench_plan, kind, cin,
                                               cout, transpose):
    """The f32 forward on the tensor-core tile (3xTF32): within F32_TOL
    of the plain version, within twice the FMA tile's error against the
    float64 product of the same gathered rows (mean and max), and the same
    bits when launched again; the wrapper takes the route rule's tile
    there and counts its launch on that route (the FMA tile at the input
    conv's Cin 16 and on the up plan at 64 output columns)."""
    fwd, tp, n_in, n_out = _bench_pair(bench_plan, kind)
    ch, rows, ci, co = (tp, n_out, cout, cin) if transpose else \
        (fwd, n_in, cin, cout)
    in_idx, lidx = ch.in_idx, ch.lidx
    (_, U), (_, K, M) = in_idx.shape, lidx.shape
    route = cc.f32_route(ci, co, M, K, U, _smem(dev))
    assert route == ("fma" if ci == 16 or (kind, transpose) in (
        ("up", False), ("child", True)) else "tc")
    g = torch.Generator().manual_seed(ci * co + K + transpose)
    x = torch.randn(rows, ci, generator=g).to(dev)
    w = (torch.randn(K, ci, co, generator=g) / (ci * K) ** 0.5).to(dev)
    before = (cc.chunk_conv.launches_f32_tc, cc.chunk_conv.launches_f32_fma)
    with torch.no_grad():
        routed = cc.chunk_conv(x, in_idx, lidx, w)
        out = cc._run_chunk_conv("test", x, in_idx, lidx, w, route="tc")
        again = cc._run_chunk_conv("test", x, in_idx, lidx, w, route="tc")
        fma = cc._run_chunk_conv("test", x, in_idx, lidx, w, route="fma")
        ref = cc.chunk_conv_plain(x, in_idx, lidx, w)
        ref64 = cc.chunk_conv_plain(x, in_idx, lidx, w, torch.float64)
    torch.cuda.synchronize()
    assert (cc.chunk_conv.launches_f32_tc - before[0],
            cc.chunk_conv.launches_f32_fma - before[1]) == \
        ((3, 1) if route == "tc" else (2, 2))
    assert torch.equal(routed, out if route == "tc" else fma)
    _check(out, ref, TOL[torch.float32])
    assert torch.equal(out, again)
    tc_err, fma_err = _f32_errors(out, ref64), _f32_errors(fma, ref64)
    assert tc_err[0] <= 2 * fma_err[0] and tc_err[1] <= 2 * fma_err[1], \
        (tc_err, fma_err)


def test_tc_tile_writes_zeros_for_pad_chunks(dev, plan):
    """A plan of all-pad chunks (and a chunk whose rows reference
    nothing) on the tensor-core tile: zeros, every group-step skipped."""
    in_idx, lidx = (a.copy() for a in cc.build_chunk_arrays(
        plan.levels[0].nbr, 128, 512))
    C, K, M = lidx.shape
    in_idx[:] = -1
    lidx[:] = -1
    fi, fl = (torch.from_numpy(a[:4]).to(dev) for a in (in_idx, lidx))
    out, _, n = _counted_f32(dev, fi, fl, plan.levels[0].cap, 64, 64, 20,
                             route="tc")
    torch.cuda.synchronize()
    assert not out.any() and out.shape == (4 * M, 64)
    assert (n.group_ran, n.group_skipped) == (0, 2 * 4 * K * 2)


def test_tc_weight_split_matches_plain(dev):
    """The wrapper's weight for the tensor-core tile, split on the card,
    is `split_weight_tf32_plain`'s bit for bit (Cin 16 padded, Cout not a
    multiple of 64)."""
    lib = cc.kernels.load()
    g = torch.Generator().manual_seed(21)
    for K, cin, cout in ((27, 16, 64), (8, 96, 80), (27, 128, 96)):
        w = (torch.randn(K, cin, cout, generator=g) * 3).to(dev)
        wt = torch.empty((2, K, cout, -(-cin // 32) * 32), device=dev)
        cc.kernels.check(lib.occ_chunk_conv_tf32_split_w(
            w.data_ptr(), K, cin, cout, wt.data_ptr(),
            cc.kernels.stream_ptr(w)), "split")
        torch.cuda.synchronize()
        assert torch.equal(wt.cpu(), cc.split_weight_tf32_plain(w.cpu()))


@pytest.mark.parametrize("U,K,nt", [(256, 27, 64), (435, 27, 96),
                                    (653, 27, 128), (1024, 8, 64)])
def test_tc_smem_matches_the_kernel(dev, U, K, nt):
    """The route rule's shared memory of a tensor-core block is what the
    kernel asks for."""
    lib = cc.kernels.load()
    assert lib.occ_chunk_conv_fwd_tf32_smem(U, K, nt) == \
        cc.tc_smem_bytes(U, K, nt)


def test_route_is_the_fma_tile_at_the_widest_plan(dev, plan):
    """At U = 1312 (a child plan at tier 1.7) no tensor-core block fits:
    the wrapper takes the FMA tile, and counts it there."""
    in_idx, lidx = _chunks(plan.transitions[0].child, 128, 1312, dev)
    assert cc.f32_route(64, 96, 128, 8, 1312, _smem(dev)) == "fma"
    before = cc.chunk_conv.launches_f32_fma
    out, ref, n = _counted_f32(dev, in_idx, lidx, plan.levels[0].cap, 64,
                               96, 22)
    _check(out, ref, TOL[torch.float32])
    assert cc.chunk_conv.launches_f32_fma == before + 1
    assert n.ran > 0 and n.group_ran == 0


# the weight-gradient kernel's card shapes on the bench plan: (map, Cin,
# Cout) of a convolution (occuseg-m64's L0 and both transitions at 64/128,
# minkunet34c's level-0 128 -> 96 and 96 -> 96, a 256-wide level)
DW_SHAPES = [("L0", 64, 64), ("child", 64, 128), ("up", 128, 64),
             ("L0", 128, 96), ("L0", 96, 96), ("L3", 256, 256)]


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("kind,cin,cout", DW_SHAPES)
def test_dw_tc_tile_against_plain_fma_and_float64(dev, bench_plan, kind,
                                                  cin, cout, fused):
    """f32 dW over the forward plan (the dW route) and dWt over the
    transpose plan (the fused route) on both tiles: each within DW_TOL of
    the plain version; the tensor-core tile's largest error against the
    float64 sum at most 1.1x the FMA tile's, the same bits when launched
    again, its count of (offset, k8 step) pairs run and skipped equal to
    `dw_k_steps`' exactly; the wrapper takes the route rule's tile and
    counts the launch there."""
    fwd, tp, n_in, n_out = _bench_pair(bench_plan, kind)
    ch, rows_x, cx, rows_d, cd, fn = (
        (tp, n_out, cout, n_in, cin, cc.chunk_conv_bwd_fused) if fused else
        (fwd, n_in, cin, n_out, cout, cc.chunk_conv_dw))
    in_idx, lidx = ch.in_idx, ch.lidx
    (_, U), (_, K, M) = in_idx.shape, lidx.shape
    route = cc.dw_route(cx, cd, K, U, _smem(dev))
    assert route == "tc"
    g = torch.Generator().manual_seed(cx * cd + K + fused)
    x = torch.randn(rows_x, cx, generator=g).to(dev)
    d = torch.randn(rows_d, cd, generator=g).to(dev)

    def run(r=None):
        return cc._run_dw("test", fn, x, in_idx, lidx, d, not fused, route=r)
    tiles = _dw_tiles(fn)
    routed = run()
    _check_tile(fn, tiles, torch.float32, route)
    ref64 = cc.chunk_conv_dw_plain(x, in_idx, lidx, d, torch.float64)
    ref = ref64.float()
    if fused:
        ref, ref64 = ref.transpose(1, 2), ref64.transpose(1, 2)
    fma = run("fma")
    _check(fma, ref, DW_TOL)
    cc.dw_counts(dev, reset=True)
    out = run("tc")
    n = cc.dw_counts(dev, reset=True)
    again = run("tc")
    torch.cuda.synchronize()
    assert torch.equal(routed, out) and torch.equal(out, again)
    _check(out, ref, DW_TOL)
    tc_err, fma_err = _f32_errors(out, ref64), _f32_errors(fma, ref64)
    assert tc_err[1] <= 1.1 * fma_err[1], (tc_err, fma_err)
    assert (n.ran, n.skipped) == cc.dw_k_steps(
        lidx.cpu(), -(-cx // 64) * -(-cd // 64))
    assert n.skipped > 0 and 0 < n.stage_cycles < n.block_cycles


def test_dw_tc_smem_matches_the_kernel(dev):
    """The route rule's shared memory of a tensor-core dW block is what
    the kernel asks for, and fits the card's."""
    assert cc.kernels.load().occ_chunk_conv_dw_tc_smem() == \
        cc.dw_tc_smem_bytes() <= _smem(dev)


@pytest.mark.parametrize("dt", [torch.bfloat16, torch.float32])
def test_fused_backward_is_deterministic(dev, plan, dt):
    """dWt is summed per run of chunks and then over the runs in order:
    two launches give the same bits (so does d_feats)."""
    in_idx, lidx = _chunks(plan.levels[0].nbr, 128, 512, dev)
    n = plan.levels[0].cap
    g = torch.Generator().manual_seed(15)
    x = torch.randn(n, 64, generator=g).to(dev, dt)
    cot = torch.randn(n, 64, generator=g).to(dev, dt)
    w_t = (torch.randn(27, 64, 64, generator=g) / 40).to(dev, dt)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    assert cc.dwt_runs(in_idx.shape[0], 27, 64, 64, sms) > 1
    tiles = _dw_tiles(cc.chunk_conv_bwd_fused)
    a = cc.chunk_conv_bwd_fused(cot, in_idx, lidx, w_t, x)
    b = cc.chunk_conv_bwd_fused(cot, in_idx, lidx, w_t, x)
    torch.cuda.synchronize()
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    if dt == torch.float32:  # dWt on the tensor-core tile, twice
        assert [u - v for u, v in zip(_dw_tiles(cc.chunk_conv_bwd_fused),
                                      tiles)] == [2, 0]


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


def _replay(name):
    """`tests/<name>.py` (a NumPy replay), loaded from its path (a card's
    machine may have another package named `tests` on its path)."""
    import importlib.util
    import os
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(os.path.dirname(__file__), name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("C", [1, 3, 4, 64, 65, 67, 68])
def test_segment_sum_replays_slot_order(dev, plan, C):
    """The kernel (128 threads a voxel block for C <= 8, else 256; C=67
    and 68 staged in two column chunks, by 4- and 16-byte copies) equals
    the NumPy replay of its slot-order sums bit for bit, on layouts with a
    run of 70 points, a block of pads only, ids >= W and a tail that must
    not be read (R=248, and R=250, whose blocks are not 16-byte aligned),
    and on the scene's own layout (W=192, R=248); two launches give the
    same bits."""
    replay_mod = _replay("segsum_replay")
    layout, replay = replay_mod.layout, replay_mod.replay
    rng = np.random.default_rng(C)
    cases = [(layout(B, R, W, seed=C + R)[0], B * W)
             for B, R, W in ((6, 248, 192), (5, 250, 190))]
    for vox_seg, num_out in cases + [(plan.vox_seg, plan.levels[0].cap)]:
        rows = vox_seg.shape[0] * vox_seg.shape[2]
        x = rng.standard_normal((rows + 40, C)).astype(np.float32)
        x[rows:] = 1e6
        want, _ = replay(x, vox_seg, num_out)
        xd = torch.from_numpy(x).to(dev)
        vd = torch.from_numpy(vox_seg).to(dev)
        before = segsum.blocked_segment_sum.launches
        out = segsum.blocked_segment_sum(xd, vd, num_out)
        again = segsum.blocked_segment_sum(xd, vd, num_out)
        torch.cuda.synchronize()
        assert segsum.blocked_segment_sum.launches == before + 2
        assert torch.equal(out.cpu(), torch.from_numpy(want))
        assert torch.equal(out, again)


# The BCE kernels (TPU rows #6-#8) on `bce_loss.exact_inputs`: every pair
# decision is exact in f32, so the counts must match exactly; the bce and
# gradient sums differ by f32 summation order over up to P terms and by
# the card's exp/log (1e-5 of the largest sum for the forward; 1e-4 for the
# backward, whose dmu = 2 (mu * sum g0 - sum g0 e) cancels).
@pytest.mark.parametrize("P,I,E", [(1000, 8, 16), (4096, 128, 64),
                                   (2000, 40, 136), (1000, 1, 16),
                                   (4100, 128, 64), (3001, 100, 128),
                                   (2050, 128, 16), (1500, 100, 64)])
def test_bce_kernels_match_plain(dev, P, I, E):
    from occuseg_tpu_torch.ops.kernels import bce_loss
    e, rx4, x4, seg, scene, mu, mp4, cons, g = bce_loss.exact_inputs(
        P, I, E, seed=P + I, device=dev)
    before = (bce_loss.radius_sq.launches, bce_loss.bce_sums.launches,
              bce_loss.bce_sums_bwd.launches)
    mp_sq = cons[bce_loss.MP_SQ].clone()  # a row of cons: unaligned at I=1
    r = bce_loss.radius_sq(x4, seg, mp4, mp_sq)
    r_ref = bce_loss.radius_sq_plain(x4, seg, mp4, mp_sq)
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


@pytest.mark.parametrize("P,I,E", [(4100, 128, 64), (3001, 100, 128)])
def test_bce_backward_is_deterministic(dev, P, I, E):
    """The backward's pair lists have a fixed order and its block partials
    are summed in block order: two launches give the same bits."""
    from occuseg_tpu_torch.ops.kernels import bce_loss
    e, rx4, x4, seg, scene, mu, mp4, cons, g = bce_loss.exact_inputs(
        P, I, E, seed=P, device=dev)
    cons = bce_loss.with_radius(x4, seg, mp4, cons)
    args = (e, rx4, x4, seg, scene, mu, mp4, cons, g)
    a = bce_loss.bce_sums_bwd(*args)
    b = bce_loss.bce_sums_bwd(*args)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_bce_backward_dense_tiles_match_plain(dev):
    """Every pair sampled (radii larger than the scene): the pair list of
    a tile overflows its capacity and is walked in several windows."""
    from occuseg_tpu_torch.ops.kernels import bce_loss
    P, I, E = 2000, 100, 64
    e, rx4, x4, seg, scene, mu, mp4, cons, g = bce_loss.exact_inputs(
        P, I, E, seed=5, device=dev)
    cons = cons.clone()
    cons[bce_loss.R16] = 4096.0
    cons[bce_loss.SCENE] = 0.0
    cons[bce_loss.USE] = 1.0
    scene = torch.zeros_like(scene)
    args = (e, rx4, x4, seg, scene, mu, mp4, cons)
    _, _, pt, lcap = bce_loss.bwd_geometry(P, I, E, 132)
    assert pt * I > lcap
    got = bce_loss.bce_sums_bwd(*args, g)
    want = bce_loss.bce_sums_bwd_plain(*args, g)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        _check(a, b, 1e-4)


@pytest.mark.parametrize("P,I,E", [(4100, 128, 64), (3001, 100, 128),
                                   (1000, 1, 16)])
def test_bce_forward_is_deterministic(dev, P, I, E):
    """The forward's sums have a fixed order (lanes, a fixed tree, block
    order): two launches give the same bits."""
    from occuseg_tpu_torch.ops.kernels import bce_loss
    e, rx4, x4, seg, scene, mu, mp4, cons, _ = bce_loss.exact_inputs(
        P, I, E, seed=P + 1, device=dev)
    cons = bce_loss.with_radius(x4, seg, mp4, cons)
    args = (e, rx4, x4, seg, scene, mu, mp4, cons)
    a = bce_loss.bce_sums(*args)
    b = bce_loss.bce_sums(*args)
    torch.cuda.synchronize()
    assert torch.equal(a, b)
    assert torch.equal(a[1:], bce_loss.bce_sums_plain(*args)[1:])


def test_bce_forward_dense_tiles_match_plain(dev):
    """Every pair sampled: the forward's pair list overflows its capacity
    and is walked in several windows; the counts stay exact."""
    from occuseg_tpu_torch.ops.kernels import bce_loss
    P, I, E = 2000, 100, 64
    e, rx4, x4, seg, scene, mu, mp4, cons, _ = bce_loss.exact_inputs(
        P, I, E, seed=6, device=dev)
    cons = cons.clone()
    cons[bce_loss.R16] = 4096.0
    cons[bce_loss.SCENE] = 0.0
    cons[bce_loss.USE] = 1.0
    scene = torch.zeros_like(scene)
    args = (e, rx4, x4, seg, scene, mu, mp4, cons)
    _, _, pt, lcap = bce_loss.fwd_geometry(P, I, E, 132)
    assert pt * I > lcap
    out = bce_loss.bce_sums(*args)
    ref = bce_loss.bce_sums_plain(*args)
    torch.cuda.synchronize()
    assert ref[1].sum() == P * I
    assert torch.equal(out[1:], ref[1:])
    _check(out[0], ref[0], 1e-5)


def test_bce_forward_all_points_invalid(dev):
    """No point belongs to an instance: every radius is 0, no pair is
    sampled, and every sum is exactly 0."""
    from occuseg_tpu_torch.ops.kernels import bce_loss
    P, I, E = 1500, 64, 64
    e, rx4, x4, seg, scene, mu, mp4, cons, _ = bce_loss.exact_inputs(
        P, I, E, seed=8, device=dev)
    seg = torch.full_like(seg, -1)
    cons = bce_loss.with_radius(x4, seg, mp4, cons)
    args = (e, rx4, x4, seg, scene, mu, mp4, cons)
    out = bce_loss.bce_sums(*args)
    torch.cuda.synchronize()
    assert torch.equal(out, bce_loss.bce_sums_plain(*args))
    assert not out.any()


@pytest.mark.parametrize("I,E", [(1, 16), (40, 136), (128, 64), (128, 128)])
def test_bce_list_smem_matches_device(dev, I, E):
    """The host's plan of the pair-list kernels' shared memory
    (`bce_loss.list_smem_bytes`) equals the device code's `ListSmem`, for
    the forward and the backward at each tile."""
    from occuseg_tpu_torch.ops import kernels
    from occuseg_tpu_torch.ops.kernels import bce_loss
    lib = kernels.load()
    for pt in bce_loss.LIST_TILES:
        for bwd in (False, True):
            assert lib.occ_bce_list_smem(I, E, pt, 16 * pt, int(bwd)) == \
                bce_loss.list_smem_bytes(pt, I, E, 16 * pt, bwd)


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


@pytest.mark.parametrize("layout", ["random", "runs", "cli", "none",
                                    "empty", "small"])
@pytest.mark.parametrize("I", [1, 64, 128])
def test_radius_matches_replay(dev, layout, I):
    """TPU row #6 bit for bit against its NumPy replay (`tests/radius_replay.py`) and
    the plain version, on `exact_inputs` values with ids at random, in
    runs (synthetic and the CLI's), none, an instance with no point, and
    P below one block's share; P % 4 != 0; launched twice."""
    from occuseg_tpu_torch.ops.kernels import bce_loss
    rep = _replay("radius_replay")
    P = {"small": 103, "cli": 8193}.get(layout, 40_001)
    seg = {"runs": lambda: rep.run_seg(P, I, seed=1),
           "cli": lambda: bce_loss.cli_seg(P, I, seed=3),
           "none": lambda: np.full(P, -1, np.int32),
           "small": lambda: rep.run_seg(P, I, seed=2)}.get(layout)
    seg = seg() if seg else None
    if layout == "empty":
        seg = np.random.default_rng(5).integers(0, I, P).astype(np.int32)
        seg[seg == I // 2] = -1
    _, _, x4, sg, _, _, mp4, cons, _ = bce_loss.exact_inputs(
        P, I, 4, seed=P + I, device=dev, seg=seg)
    mp_sq = cons[bce_loss.MP_SQ].clone()  # a row of cons: unaligned at I=1
    before = bce_loss.radius_sq.launches
    r = bce_loss.radius_sq(x4, sg, mp4, mp_sq)
    again = bce_loss.radius_sq(x4, sg, mp4, mp_sq)
    torch.cuda.synchronize()
    assert bce_loss.radius_sq.launches == before + 2
    want, _, _ = rep.replay(
        x4.cpu().numpy(), sg.cpu().numpy(), mp4.cpu().numpy(),
        mp_sq.cpu().numpy(), bce_loss.radius_blocks(
            P, torch.cuda.get_device_properties(dev).multi_processor_count))
    assert torch.equal(r.cpu(), torch.from_numpy(want))
    assert torch.equal(r, again)
    assert torch.equal(r, bce_loss.radius_sq_plain(x4, sg, mp4, mp_sq))


@pytest.mark.parametrize("cin,cout,N", [(256, 256, 200), (320, 320, 1000),
                                        (384, 384, 3000), (136, 72, 300),
                                        (256, 256, 12000)])
def test_gather_conv_matches_replay(dev, plan, cin, cout, N):
    """TPU row #9's bf16 kernel against its f32 NumPy replay
    (`tests/gather_replay.py`) on the same bf16 values: the L3-L5 widths,
    a Cin tail and a Cout tile with a tail, split levels (the small N)
    and an unsplit one; a bf16 tolerance (the kernel rounds its output to
    bf16); launched twice, the same bits."""
    from occuseg_tpu_torch.ops.kernels import gather_conv as gc
    rep = _replay("gather_replay")
    nbr = plan.levels[0].nbr[:N]
    nbr_kn = np.where(nbr < N, nbr, -1).T.copy()
    rng = np.random.default_rng(N)
    feats = torch.tensor(rng.standard_normal((N, cin)),
                         dtype=torch.bfloat16)
    w = torch.tensor(rng.standard_normal((27, cin, cout)) / cin ** 0.5,
                     dtype=torch.bfloat16)
    fd, wd = feats.to(dev), w.to(dev)
    nk = torch.from_numpy(nbr_kn).to(dev)
    out = gc.gather_conv(fd, nk, wd)
    again = gc.gather_conv(fd, nk, wd)
    torch.cuda.synchronize()
    want, _, _ = rep.replay(feats.float().numpy(), nbr_kn,
                            w.float().numpy(),
                            torch.cuda.get_device_properties(dev)
                            .multi_processor_count)
    _check(out, torch.from_numpy(want).to(dev), TOL[torch.bfloat16])
    assert torch.equal(out, again)


def _gather_map(plan, kind, t):
    """(map [M, K], source rows N) of TPU row #9's roles on the gather
    path at transition t: a strided convolution's child map, a
    deconvolution's up map, and the transpose maps their d_feats run
    over (up and child reversed along K)."""
    tr = plan.transitions[t]
    n_f, n_c = tr.up.shape[0], tr.child.shape[0]
    return {"child": (tr.child, n_f), "up": (tr.up, n_c),
            "child_t": (tr.up[:, ::-1], n_c),
            "up_t": (tr.child[:, ::-1], n_f)}[kind]


@pytest.mark.parametrize("kind", ["child", "up", "child_t", "up_t"])
@pytest.mark.parametrize("t,cin,cout", [(0, 64, 128), (3, 136, 72)])
def test_gather_conv_m_not_n(dev, plan, kind, t, cin, cout):
    """TPU row #9 with M output rows over N source rows (M != N): bf16
    against the NumPy replay of its work split (`tests/gather_replay.py`)
    on the same bf16 values, f32 against the plain version; launched
    twice, the same bits."""
    from occuseg_tpu_torch.ops.kernels import gather_conv as gc
    rep = _replay("gather_replay")
    nbr, n_src = _gather_map(plan, kind, t)
    nbr_kn = np.ascontiguousarray(nbr.T)
    M = nbr_kn.shape[1]
    assert M != n_src
    rng = np.random.default_rng(M + cin)
    feats = torch.tensor(rng.standard_normal((n_src, cin)))
    w = torch.tensor(rng.standard_normal((8, cin, cout)) / cin ** 0.5)
    nk = torch.from_numpy(nbr_kn).to(dev)
    for dt in (torch.bfloat16, torch.float32):
        fd, wd = feats.to(dev, dt), w.to(dev, dt)
        out = gc.gather_conv(fd, nk, wd)
        again = gc.gather_conv(fd, nk, wd)
        torch.cuda.synchronize()
        assert out.shape == (M, cout) and out.dtype == dt
        assert torch.equal(out, again)
        if dt == torch.bfloat16:
            want, _, _ = rep.replay(fd.float().cpu().numpy(), nbr_kn,
                                    wd.float().cpu().numpy(),
                                    torch.cuda.get_device_properties(dev)
                                    .multi_processor_count)
            _check(out, torch.from_numpy(want).to(dev), TOL[dt])
        else:
            _check(out, gc.gather_conv_plain(fd, nk, wd), TOL[dt])


@pytest.mark.parametrize("kind", ["sub", "child", "up"])
def test_gather_path_autograd_matches_cpu(dev, plan, kind):
    """`ops/conv.gather_conv` on the card (#9 for the forward and d_feats,
    PyTorch for dW) against the CPU (the plain versions), f32, with
    Cin 3 and Cout 24 zero-padded to the kernel's multiple of 8: the
    launches, the output and both gradients."""
    from occuseg_tpu_torch.ops import conv as conv_ops
    from occuseg_tpu_torch.ops.kernels import gather_conv as gc
    tr = plan.transitions[1]
    nbr, nbr_t = {"sub": (plan.levels[1].nbr, plan.levels[1].nbr),
                  "child": (tr.child, tr.up[:, ::-1]),
                  "up": (tr.up, tr.child[:, ::-1])}[kind]
    rng = np.random.default_rng(len(kind))
    K = nbr.shape[1]
    feats = torch.tensor(rng.standard_normal((nbr_t.shape[0], 3)),
                         dtype=torch.float32)
    w = torch.tensor(rng.standard_normal((K, 3, 24)), dtype=torch.float32)
    r = torch.tensor(rng.standard_normal((nbr.shape[0], 24)),
                     dtype=torch.float32)
    res = {}
    for d in ("cpu", dev):
        x = feats.to(d, copy=True).requires_grad_()
        wd = w.to(d, copy=True).requires_grad_()
        before = gc.gather_conv.launches
        out = conv_ops.gather_conv(
            x, torch.from_numpy(nbr).to(d), wd,
            nbr_t=torch.from_numpy(np.ascontiguousarray(nbr_t)).to(d))
        (out * r.to(d)).sum().backward()
        res[str(d)] = (out.detach().cpu(), x.grad.cpu(), wd.grad.cpu(),
                       gc.gather_conv.launches - before)
    (o, df, dw, n_cpu), (o2, df2, dw2, n_card) = res["cpu"], res[str(dev)]
    assert (n_cpu, n_card) == (0, 2)
    _check(o2, o, TOL[torch.float32])
    _check(df2, df, TOL[torch.float32])
    _check(dw2, dw, DW_TOL)


# --- the device planner and #9's roles on its path ----------------------

PLANNER_CAPS = (12_288, 8_192, 4_096, 2_048)


@pytest.fixture(scope="module")
def raw_scene():
    return make_batch(SceneConfig(num_points=12_000, extent=128,
                                  num_objects=8),
                      num_scenes=1, p_cap=24_576, num_instances=16, seed=3)


def _lattice_coords(coords):
    from occuseg_tpu_torch.ops.permutohedral import embed_points
    valid = coords[:, 0] >= 0
    lat = embed_points(coords[valid, 1:].astype(np.float64))
    out = coords.copy()
    out[valid, 1:] = lat - lat.min(0)
    return out


def _same_tensors(a, b):
    from occuseg_tpu_torch.core.topology import _np
    return np.array_equal(_np(a), _np(b))


@pytest.mark.parametrize("case", ["cubic", "normals", "size3", "nn_search",
                                  "permutohedral"])
def test_device_plan_matches_cpu(dev, raw_scene, case):
    """`core/topology.build_plan` on the card equals the same build on the
    CPU (which the CPU tests hold to the JAX planner) bit for bit:
    keys, coords, counts, maps, p2v; orientation classes except where a
    site's two largest normal components are within 1e-6 relative."""
    from occuseg_tpu_torch.core.topology import build_plan
    coords, normals = raw_scene["coords"], None
    kw = {}
    if case == "normals":
        normals, kw = raw_scene["normals"], dict(guide_levels=2)
    elif case == "size3":
        kw = dict(down_size=3, down_stride=2)
    elif case == "nn_search":
        kw = dict(dilation=2, nn_search=True)
    elif case == "permutohedral":
        coords, kw = _lattice_coords(coords), dict(lattice="permutohedral")
    spec = PlanSpec(caps=PLANNER_CAPS, **kw)

    def plan_on(d):
        return build_plan(torch.from_numpy(coords).to(d), spec,
                          None if normals is None
                          else torch.from_numpy(normals).to(d))
    cp, gp = plan_on("cpu"), plan_on(dev)
    assert gp.levels[0].keys.is_cuda and gp.levels[0].kn["nbr"].is_cuda
    for c, g in zip(cp.levels, gp.levels):
        for f in ("keys", "coords", "nbr"):
            assert _same_tensors(getattr(c, f), getattr(g, f)), f
        assert c.num_active == g.num_active and c.guided == g.guided
        # the classes: on the card the sums run in the same order, so no
        # site is expected to differ; a near tie would be allowed to
        assert (c.orient.numpy() != g.orient.cpu().numpy()).sum() == 0
    for c, g in zip(cp.transitions, gp.transitions):
        assert _same_tensors(c.child, g.child)
        assert _same_tensors(c.up, g.up)
    assert _same_tensors(cp.p2v, gp.p2v)
    assert _same_tensors(cp.vox_counts, gp.vox_counts)
    assert cp.num_points == gp.num_points


def _role_maps(raw_scene, role):
    """(nbr_kn [K, M] int32 on the CPU, source rows N) of #9's roles on the
    device planner's path."""
    from occuseg_tpu_torch.core.topology import build_plan, full_conv_plan
    coords = raw_scene["coords"]
    if role.startswith("k13"):
        p = build_plan(torch.from_numpy(_lattice_coords(coords)),
                       PlanSpec(caps=PLANNER_CAPS[:1],
                                lattice="permutohedral"))
        return p.levels[0].kn["nbr"], p.levels[0].cap
    if role == "dilated":
        p = build_plan(torch.from_numpy(coords), PlanSpec(
            caps=PLANNER_CAPS[:1], dilation=2, nn_search=True))
        return p.levels[0].kn["nbr"], p.levels[0].cap
    p = build_plan(torch.from_numpy(coords), PlanSpec(caps=PLANNER_CAPS))
    lvl = p.levels[1]
    out, tr = full_conv_plan(lvl, 2, 2, lvl.cap * 8)
    if role == "grown_up":
        return tr.kn["up"], lvl.cap
    return tr.kn["child"], out.cap


@pytest.mark.parametrize("role,cin,cout", [
    ("k13", 64, 64), ("k13_tail", 24, 40), ("dilated", 64, 64),
    ("grown_up", 64, 32), ("grown_child", 32, 64)])
def test_gather_conv_planner_roles(dev, raw_scene, role, cin, cout):
    """TPU row #9 in the device planner's roles: K = 13 (the lattice; a
    Cin tail), a dilated nearest-neighbour map, a FullConvolution's grown
    `up` map (M = 8 x N) and its `child` map (the backward): bf16 against
    the NumPy replay of its work split on the same bf16 values, f32
    against the plain version; launched twice, the same bits."""
    from occuseg_tpu_torch.ops.kernels import gather_conv as gc
    rep = _replay("gather_replay")
    nbr_kn, n_src = _role_maps(raw_scene, role)
    K, M = nbr_kn.shape
    rng = np.random.default_rng(M + cin)
    feats = torch.tensor(rng.standard_normal((n_src, cin)))
    w = torch.tensor(rng.standard_normal((K, cin, cout)) / cin ** 0.5)
    nk = nbr_kn.to(dev)
    for dt in (torch.bfloat16, torch.float32):
        fd, wd = feats.to(dev, dt), w.to(dev, dt)
        out = gc.gather_conv(fd, nk, wd)
        again = gc.gather_conv(fd, nk, wd)
        torch.cuda.synchronize()
        assert out.shape == (M, cout) and out.dtype == dt
        assert torch.equal(out, again)
        if dt == torch.bfloat16:
            want, _, _ = rep.replay(fd.float().cpu().numpy(),
                                    nbr_kn.numpy(),
                                    wd.float().cpu().numpy(),
                                    torch.cuda.get_device_properties(dev)
                                    .multi_processor_count)
            _check(out, torch.from_numpy(want).to(dev), TOL[dt])
        else:
            _check(out, gc.gather_conv_plain(fd, nk, wd), TOL[dt])


@pytest.mark.parametrize("kind", ["full_conv", "permutohedral"])
def test_planner_modules_autograd_match_cpu(dev, raw_scene, kind):
    """`FullConvolution` (64 -> 32) chained with a submanifold convolution
    on its grown level, and `PermutohedralSubmanifoldConvolution` (64 ->
    64), on a plan built on the card against the same on the CPU, f32:
    outputs and both gradients, #9 launched for each forward and d_feats."""
    import copy
    from occuseg_tpu_torch.core.sparse_tensor import SparseTensor
    from occuseg_tpu_torch.core.topology import build_plan
    from occuseg_tpu_torch.nn.extras import (
        PermutohedralSubmanifoldConvolution,
    )
    from occuseg_tpu_torch.nn.modules import (
        FullConvolution, SubmanifoldConvolution,
    )
    from occuseg_tpu_torch.ops.kernels import gather_conv as gc
    gen = torch.Generator().manual_seed(5)
    coords = raw_scene["coords"]
    if kind == "full_conv":
        spec = PlanSpec(caps=PLANNER_CAPS[:2])
        mods = torch.nn.ModuleList([
            FullConvolution(64, 32, generator=gen),
            SubmanifoldConvolution(32, 32, generator=gen)])
    else:
        coords = _lattice_coords(coords)
        spec = PlanSpec(caps=PLANNER_CAPS[:1], lattice="permutohedral")
        mods = torch.nn.ModuleList([PermutohedralSubmanifoldConvolution(
            64, 64, generator=gen)])
    res = {}
    for d in ("cpu", dev):
        plan = build_plan(torch.from_numpy(coords).to(d), spec)
        lvl = plan.levels[0]
        x0 = torch.randn(lvl.cap, 64, generator=torch.Generator()
                         .manual_seed(6))
        x0[lvl.num_active:] = 0
        x = x0.to(d).requires_grad_()
        m = copy.deepcopy(mods).to(d)
        before = gc.gather_conv.launches
        y = SparseTensor(features=x, num_active=lvl.num_active, level=0)
        if kind == "full_conv":
            y, grown = m[0](y, plan)
            y = m[1](y, grown)
        else:
            y = m[0](y, plan)
        r = torch.randn(y.features.shape, generator=torch.Generator()
                        .manual_seed(7)).to(d)
        (y.features * r).sum().backward()
        res[str(d)] = (y.features.detach().cpu(), x.grad.cpu(),
                       [p.grad.cpu() for p in m.parameters()],
                       gc.gather_conv.launches - before)
    (o, df, dw, n_cpu), (o2, df2, dw2, n_card) = res["cpu"], res[str(dev)]
    assert n_cpu == 0 and n_card == 2 * len(mods)
    _check(o2, o, TOL[torch.float32])
    _check(df2, df, TOL[torch.float32])
    for a, b in zip(dw2, dw):
        _check(a, b, DW_TOL)


def test_stem_map_and_routes_at_k125(dev):
    """MinkUNet's 5^3 stem (K = 125, Cin 3 -> 32, f32) on a blocked
    two-scene plan: the map built on the card (`stencil_map_kn`) is the
    host planner's probe map; #9, the stem's route through
    `gather_conv_kn`, gives the plain forward and, through autograd, the
    plain d_weight; and #1 over the map's rulebooks gives the plain
    forward too (its neighbour mask holds offsets below 32: the rest are
    never skipped)."""
    from occuseg_tpu_torch import native
    from occuseg_tpu_torch.core.topology import _offsets, stencil_map_kn
    from occuseg_tpu_torch.native.blocked import build_plan_host_blocked
    from occuseg_tpu_torch.ops import conv as conv_ops
    from occuseg_tpu_torch.ops.kernels import gather_conv as gc
    b = make_batch(SceneConfig(num_points=9_000, extent=128, num_objects=8),
                   num_scenes=2, p_cap=24_576, num_instances=16, seed=5)
    plan = build_plan_host_blocked(b["coords"], PlanSpec(caps=(24_576,
                                                               12_288)), 2)
    lvl = plan.levels[0]
    sc = lvl.cap // 2
    host = np.full((lvl.cap, 125), -1, np.int32)
    for s, n in enumerate(lvl.num_active):
        rows = slice(s * sc, (s + 1) * sc)
        m = native.plan_neighbor_map(lvl.keys[rows], lvl.coords[rows],
                                     int(n), _offsets(5))
        host[rows] = np.where(m >= 0, m + s * sc, -1)
    nbr = stencil_map_kn(torch.as_tensor(lvl.keys, device=dev), 5, 2)
    assert torch.equal(nbr.t().cpu(), torch.from_numpy(host))
    assert (host[:, 32:] >= 0).sum() > (host[:, :32] >= 0).sum()

    g = torch.Generator(device=dev).manual_seed(1)
    feats = torch.randn((lvl.cap, 3), generator=g, device=dev)
    feats[torch.from_numpy(host[:, 62] < 0).to(dev)] = 0
    w = torch.randn((125, 3, 32), generator=g, device=dev) * 0.1
    ref_w = w.clone().requires_grad_(True)
    pad = torch.nn.functional.pad
    ref = gc.gather_conv_plain(pad(feats, (0, 5)), nbr,
                               pad(ref_w, (0, 0, 0, 5)))
    ct = torch.randn(ref.shape, generator=g, device=dev)
    (ref * ct).sum().backward()
    w9 = w.clone().requires_grad_(True)
    out9 = conv_ops.gather_conv_kn(feats, nbr, w9, nbr, True)
    (out9 * ct).sum().backward()
    _check(out9, ref, TOL[torch.float32])
    _check(w9.grad, ref_w.grad, DW_TOL)
    # the smallest U that holds the map's rulebooks (the f32 forward's
    # shared memory takes U rows of a Cin tile beside K x M ids)
    U = next(u for u in (256, 512, 768, 1024)
             if cc.build_chunk_arrays(host, 128, u) is not None)
    in_idx, lidx = _chunks(host, 128, U, dev)
    out1 = cc.chunk_conv(pad(feats, (0, 13)), in_idx, lidx,
                         pad(w, (0, 0, 0, 13)))
    _check(out1, ref, TOL[torch.float32])
