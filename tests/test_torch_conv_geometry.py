"""The chunk-conv kernels' launch geometry, chosen on the host, against
NumPy: the forward's column tile and split steps, the fused backward's
runs of chunks, and the sums each decomposition implies.

The kernels themselves run on a card (tests/test_torch_kernels.py); here
the decompositions they implement are replayed in NumPy (f64 sums of the
same partial products, in the kernels' order) against the plain versions.
"""

import numpy as np
import pytest
import torch

from occuseg_tpu_torch.core.topology import PlanSpec
from occuseg_tpu_torch.data.synthetic import SceneConfig, make_batch
from occuseg_tpu_torch.native.plan import build_plan_host
from occuseg_tpu_torch.ops.kernels import chunk_conv as cc

SMS = 132  # H100 SXM


def _ranges(n: int, parts: int) -> np.ndarray:
    """[parts, 2] bounds of the kernels' split: part s covers
    [n*s/parts, n*(s+1)/parts)."""
    s = np.arange(parts + 1, dtype=np.int64)
    b = n * s // parts
    return np.stack([b[:-1], b[1:]], 1)


@pytest.mark.parametrize("bf16", [True, False])
def test_col_tile_minimises_its_cost(bf16):
    cands = np.array((128, 96, 64) if bf16 else (64,))
    for cout in range(16, 656, 16):
        nt = cc.col_tile(cout, bf16)
        cost = -(-cout // cands) * (cands + 64)
        assert nt in cands
        assert cost[cands == nt][0] == cost.min()
        assert nt == cands[cost == cost.min()].max()


@pytest.mark.parametrize("C,tiles,steps", [(1536, 1, 27), (136, 2, 108),
                                           (32, 3, 135), (8, 3, 162),
                                           (8, 3, 40), (1, 1, 8),
                                           (3, 6, 2)])
def test_conv_splits_partition_the_steps(C, tiles, steps):
    S = cc.conv_splits(C, tiles, steps, SMS)
    blocks = C * tiles
    assert 1 <= S <= steps
    if blocks >= 2 * SMS:
        assert S == 1
    else:
        assert S * blocks >= 2 * SMS or S == steps
    r = _ranges(steps, S)
    assert r[0, 0] == 0 and r[-1, 1] == steps
    assert (r[1:, 0] == r[:-1, 1]).all() and (r[:, 1] > r[:, 0]).all()


@pytest.mark.parametrize("C,K,cin,ct", [(1536, 27, 64, 64), (1088, 27, 128,
                                                            128),
                                        (496, 8, 128, 192), (32, 27, 320,
                                                             320),
                                        (8, 8, 320, 384), (3, 27, 16, 32)])
def test_dwt_runs_partition_the_chunks(C, K, cin, ct):
    R = cc.dwt_runs(C, K, cin, ct, SMS)
    r = _ranges(C, R)
    assert 1 <= R <= C
    assert (r[:, 1] - r[:, 0] <= 64).all() and (r[:, 1] > r[:, 0]).all()
    tiles = -(-cin // 64) * -(-ct // 64) * -(-K // 4)
    assert R * tiles >= 3 * SMS or R == C
    want = (R if R > 1 else 0) * K * cin * ct + K * cin * ct
    assert cc.dwt_values(C, K, cin, ct, SMS) == want


@pytest.fixture(scope="module")
def small_plan():
    batch = make_batch(SceneConfig(num_points=3_000, extent=64,
                                   num_objects=4),
                       num_scenes=1, p_cap=4_096, num_instances=8, seed=5)
    return build_plan_host(batch["coords"],
                           PlanSpec(caps=(4_096, 2_048, 1_024)))


def _gather(x, in_idx, lidx):
    """[C, K, M, X] f64: row m of offset k of chunk c, 0 where missing."""
    g = x[np.maximum(in_idx, 0)][np.arange(lidx.shape[0])[:, None, None],
                                 np.maximum(lidx, 0)]
    return np.where((lidx >= 0)[..., None], g, 0.0)


@pytest.mark.parametrize("splits", [1, 3, 7])
def test_split_steps_sum_to_the_forward(small_plan, splits):
    """The forward's split: partials over ranges of (64-column Cin tile,
    offset) steps, summed in split order, give the plain forward."""
    in_idx, lidx = cc.build_chunk_arrays(small_plan.levels[0].nbr, 128, 512)
    rng = np.random.default_rng(splits)
    C, K, M = lidx.shape
    cin, cout = 128, 48
    x = rng.standard_normal((small_plan.levels[0].cap, cin))
    w = rng.standard_normal((K, cin, cout)) / np.sqrt(K * cin)
    g = _gather(x, in_idx, lidx)                      # [C, K, M, cin]
    steps = [(ci, k) for ci in range(0, cin, 64) for k in range(K)]
    out = np.zeros((C, M, cout))
    for s0, s1 in _ranges(len(steps), splits):
        part = np.zeros((C, M, cout))
        for ci, k in steps[s0:s1]:
            part += g[:, k, :, ci:ci + 64] @ w[k, ci:ci + 64]
        out += part
    np.testing.assert_allclose(out, np.einsum("ckmi,kio->cmo", g, w),
                               rtol=1e-12, atol=1e-12)
    # the plain version computes in f32
    ref = cc.chunk_conv_plain(torch.from_numpy(x), torch.from_numpy(in_idx),
                              torch.from_numpy(lidx), torch.from_numpy(w))
    err = np.abs(out.reshape(C * M, cout) - ref.numpy()).max()
    assert err <= 1e-5 * np.abs(out).max()


@pytest.mark.parametrize("runs", [1, 2, 5])
def test_runs_sum_to_the_fused_dw(small_plan, runs):
    """The fused backward's dWt: per run of consecutive chunks, groups of 4
    offsets, then the runs in order, give the plain dWt."""
    in_idx, lidx = cc.build_chunk_arrays(small_plan.levels[0].nbr, 128, 512)
    rng = np.random.default_rng(runs)
    C, K, M = lidx.shape
    cin, ct = 32, 80
    feats = rng.standard_normal((C * M, cin))
    cot = rng.standard_normal((small_plan.levels[0].cap, ct))
    g = _gather(cot, in_idx, lidx)                    # [C, K, M, ct]
    f = feats.reshape(C, M, cin)
    dwt = np.zeros((K, cin, ct))
    for c0, c1 in _ranges(C, runs):
        part = np.zeros((K, cin, ct))
        for k0 in range(0, K, 4):
            for c in range(c0, c1):
                if in_idx[c, 0] < 0:
                    continue
                for k in range(k0, min(k0 + 4, K)):
                    part[k] += f[c].T @ g[c, k]
        dwt += part
    np.testing.assert_allclose(dwt, np.einsum("cmi,ckmt->kit", f, g),
                               rtol=1e-12, atol=1e-12)
    # the plain version computes in f32
    w_t = torch.zeros((K, ct, cin), dtype=torch.float64)
    _, ref = cc.chunk_conv_bwd_fused_plain(
        torch.from_numpy(cot), torch.from_numpy(in_idx),
        torch.from_numpy(lidx), w_t, torch.from_numpy(feats))
    assert np.abs(dwt - ref.numpy()).max() <= 1e-5 * np.abs(dwt).max()


@pytest.fixture(scope="module")
def bench_plan():
    import chip_smoke as cs
    from occuseg_tpu_torch.infer import prepare_scene
    b = cs.bench_scene(0)
    return prepare_scene(b["coords"], b["features"],
                         PlanSpec(caps=cs.BENCH_CAPS)).plan


def test_bench_dw_values_fall_eightfold(bench_plan):
    """On the bench plan, the f32 dW values the fused route writes per
    step (runs' partials and dWt) against what the first fused kernel
    added with atomics: one value per (live chunk, offset, Cin row, Ct
    column)."""
    import chip_smoke as cs
    new = atomics = 0
    for cv in cs.conv_calls(bench_plan, cs.N_PLANES):
        if cs.route_of(cv, 2) == "#5":
            continue
        ti, tl = cv.t_chunks.in_idx, cv.t_chunks.lidx
        K = tl.shape[1]
        new += cc.dwt_values(tl.shape[0], K, cv.cin, cv.cout, SMS)
        atomics += int((ti[:, 0] >= 0).sum()) * K * cv.cin * cv.cout
    assert atomics == 7_052_072_960
    assert new * 8 <= atomics and new <= 0.9e9


# The convolutions that take the dW route (TPU kernel #5): at the bench
# plan in bf16 (C = cap / 128 chunks of its level) and at the training
# CLI's blocked 4-scene plan in f32 (caps 79872, 49152 and 32256 at
# L3-L5); U is the level's tier-1.0 budget, Cin of dec0.conv1 the concat.
DW_ROUTE = {
    "bench enc0.conv{1,2} L5": (8, 27, 384, 384, 320, 2),
    "bench dec0.conv1 L4": (32, 27, 640, 320, 384, 2),
    "bench dec0.conv1 L3": (136, 27, 512, 256, 384, 2),
    "cli enc0.conv{1,2} L5": (252, 27, 384, 384, 320, 4),
    "cli enc0.conv{1,2} L4, dec0.conv2 L4": (384, 27, 320, 320, 384, 4),
    "cli dec0.conv1 L4": (384, 27, 640, 320, 384, 4),
    "cli dec0.conv1 L3": (624, 27, 512, 256, 384, 4),
}


@pytest.mark.parametrize("shape", list(DW_ROUTE.values()),
                         ids=list(DW_ROUTE))
def test_dw_runs_partition_the_chunks(shape):
    """The dW kernel's runs of chunks (the dWt rule over 64 Cout x 64 Cin
    x 4 offsets tiles): a partition of the C chunks into runs of at most
    64, enough for three blocks per SM, at the shapes that take it."""
    C, K, cin, cout, U, esize = shape
    assert cc.fused_grouping(K, 128, cout, cin, U, esize) == 0
    R = cc.dwt_runs(C, K, cout, cin, SMS)
    r = _ranges(C, R)
    assert 1 <= R <= C
    assert r[0, 0] == 0 and r[-1, 1] == C and (r[1:, 0] == r[:-1, 1]).all()
    assert (r[:, 1] - r[:, 0] <= 64).all() and (r[:, 1] > r[:, 0]).all()
    tiles = -(-cout // 64) * -(-cin // 64) * -(-K // 4)
    assert R * tiles >= 3 * SMS or R == C
    assert cc.dwt_runs(C, K, cout, cin, SMS) == cc.dwt_runs(C, K, cin, cout,
                                                            SMS)
    want = (R if R > 1 else 0) * K * cin * cout + K * cin * cout
    assert cc.dwt_values(C, K, cout, cin, SMS) == want


@pytest.mark.parametrize("runs", [1, 2, 5])
def test_runs_sum_to_the_dw(small_plan, runs):
    """The dW kernel over the forward plan: per run of consecutive chunks,
    groups of 4 offsets, G_k^T @ ct_c per live chunk, then the runs in
    order, give the plain dW."""
    in_idx, lidx = cc.build_chunk_arrays(small_plan.levels[0].nbr, 128, 512)
    rng = np.random.default_rng(runs + 10)
    C, K, M = lidx.shape
    cin, cout = 48, 32
    feats = rng.standard_normal((small_plan.levels[0].cap, cin))
    cot = rng.standard_normal((C * M, cout))
    g = _gather(feats, in_idx, lidx)                  # [C, K, M, cin]
    c_t = cot.reshape(C, M, cout)
    dw = np.zeros((K, cin, cout))
    for c0, c1 in _ranges(C, runs):
        part = np.zeros((K, cin, cout))
        for k0 in range(0, K, 4):
            for c in range(c0, c1):
                if in_idx[c, 0] < 0:
                    continue
                for k in range(k0, min(k0 + 4, K)):
                    part[k] += g[c, k].T @ c_t[c]
        dw += part
    np.testing.assert_allclose(dw, np.einsum("ckmi,cmo->kio", g, c_t),
                               rtol=1e-12, atol=1e-12)
    ref = cc.chunk_conv_dw_plain(torch.from_numpy(feats),
                                 torch.from_numpy(in_idx),
                                 torch.from_numpy(lidx),
                                 torch.from_numpy(cot))
    assert np.abs(dw - ref.numpy()).max() <= 1e-5 * np.abs(dw).max()


@pytest.mark.parametrize("kind", ["nbr", "child", "up"])
def test_dw_is_the_dwt_contract_with_roles_swapped(small_plan, kind):
    """What lets one kernel serve both routes: dW over a forward plan
    (feats gathered, ct dense) is the transpose of the dWt contract with
    feats and ct exchanged and the plan bound as the transpose plan, on a
    submanifold, a child (strided) and an up (deconvolution) plan."""
    tr = small_plan.transitions[0]
    table, n_in, U = {"nbr": (small_plan.levels[0].nbr,
                              small_plan.levels[0].cap, 512),
                      "child": (tr.child, small_plan.levels[0].cap, 1024),
                      "up": (tr.up, small_plan.levels[1].cap, 256)}[kind]
    in_idx, lidx = (torch.from_numpy(a)
                    for a in cc.build_chunk_arrays(np.asarray(table), 128, U))
    C, K, M = lidx.shape
    cin, cout = 32, 48
    gen = torch.Generator().manual_seed(K + C)
    feats = torch.randn(n_in, cin, generator=gen)
    cot = torch.randn(C * M, cout, generator=gen)
    dw = cc.chunk_conv_dw_plain(feats, in_idx, lidx, cot)
    _, dwt = cc.chunk_conv_bwd_fused_plain(
        feats, in_idx, lidx, torch.zeros(K, cin, cout), cot)
    assert dwt.shape == (K, cout, cin)
    assert float(dw.abs().max()) > 0
    torch.testing.assert_close(dwt.transpose(1, 2), dw, rtol=1e-6,
                               atol=1e-6 * float(dw.abs().max()))


def test_bench_dw_route_values(bench_plan):
    """On the bench plan in bf16: the four convolutions that take the dW
    route are DW_ROUTE's bench shapes, and the f32 values the dW kernel
    writes per step (its runs' partials, then dW) are what its run rule
    gives them."""
    import chip_smoke as cs
    got = []
    values = 0
    for cv in cs.conv_calls(bench_plan, cs.N_PLANES):
        if cs.route_of(cv, 2) != "#5":
            continue
        C, K, _ = cv.chunks.lidx.shape
        got.append((cv.label, (C, K, cv.cin, cv.cout)))
        values += cc.dwt_values(C, K, cv.cout, cv.cin, SMS)
    assert [s for _, s in got] == [(8, 27, 384, 384), (8, 27, 384, 384),
                                   (32, 27, 640, 320), (136, 27, 512, 256)]
    assert [lb for lb, _ in got] == ["enc0.conv1 L5", "enc0.conv2 L5",
                                     "dec0.conv1 L4", "dec0.conv1 L3"]
    want = sum((r if r > 1 else 0) * K * cin * cout + K * cin * cout
               for C, K, cin, cout in [s for _, s in got]
               for r in [cc.dwt_runs(C, K, cout, cin, SMS)])
    assert values == want == 3 * 2 * 27 * 384 * 384 + 3 * 27 * 640 * 320 \
        + 4 * 27 * 512 * 256


# ---- the f32 forward's row order and skipped warp-steps -------------------

def _up_like(offsets, M=128, K=8):
    """lidx [1, K, M] of an `up`-like chunk: row m references one
    neighbour, at offset offsets[m]."""
    lidx = np.full((1, K, M), -1, np.int32)
    lidx[0, offsets, np.arange(M)] = np.arange(M) % 37
    return torch.from_numpy(lidx)


def _warp_steps_by_loops(lidx, tiles=1):
    """`fwd_warp_steps` written out: rows sorted by (mask, row), 16 to a
    warp, a warp live at an offset where one of its rows references it."""
    lidx = lidx.numpy()
    C, K, M = lidx.shape
    ran = 0
    for c in range(C):
        masks = [sum(1 << k for k in range(min(K, 32)) if lidx[c, k, m] >= 0)
                 for m in range(M)]
        order = sorted(range(M), key=lambda m: (masks[m], m))
        for w in range(8):
            rows = order[16 * w:16 * w + 16]
            ran += sum(any(lidx[c, k, m] >= 0 for m in rows)
                       for k in range(K))
    return tiles * ran, tiles * (C * K * 8 - ran)


def test_row_order_of_an_up_chunk():
    """Row m at offset m % 8: the order puts the 16 rows of each offset
    together, so each warp runs one offset of 8 and skips seven."""
    lidx = _up_like(np.arange(128) % 8)
    order = cc.fwd_row_order(lidx)[0]
    assert order.tolist() == [m for k in range(8) for m in range(k, 128, 8)]
    assert cc.fwd_warp_steps(lidx) == (8, 56)
    assert cc.fwd_warp_steps(lidx, tiles=6) == (48, 336)


@pytest.mark.parametrize("seed", [0, 1])
def test_warp_steps_of_random_up_chunks(seed):
    """One live offset a row, drawn at random: the count as the loops
    give it, and at least one offset run per warp."""
    rng = np.random.default_rng(seed)
    lidx = torch.cat([_up_like(rng.integers(0, 8, 128)) for _ in range(3)])
    ran, skipped = cc.fwd_warp_steps(lidx, tiles=2)
    assert (ran, skipped) == _warp_steps_by_loops(lidx, tiles=2)
    assert 2 * 3 * 8 <= ran < 2 * 3 * 8 * 3


def test_warp_steps_of_an_all_pad_chunk():
    """A chunk of cap padding references nothing: every step skipped,
    also at offsets past the masks' 32."""
    for K in (27, 40):
        lidx = torch.full((2, K, 128), -1, dtype=torch.int32)
        assert cc.fwd_warp_steps(lidx, tiles=3) == (0, 3 * 2 * K * 8)


@pytest.mark.parametrize("M", [128, 64])
def test_warp_steps_of_a_dense_chunk(M):
    """Every row referenced at every offset: nothing skipped where the
    warps hold rows (at M=64 the last four warps hold none)."""
    lidx = torch.zeros((1, 27, M), dtype=torch.int32)
    assert cc.fwd_warp_steps(lidx) == (27 * M // 16, 27 * (8 - M // 16))
    assert cc.fwd_row_order(lidx)[0].tolist() == list(range(M))


@pytest.mark.parametrize("M", [128, 64])
def test_row_order_and_count_under_a_row_permutation(small_plan, M):
    """Each chunk's rows in another order: the order lists the same
    masks in the same sequence, ties by row, and the count does not
    change (a warp's rows have the same masks)."""
    _, lidx = cc.build_chunk_arrays(small_plan.levels[0].nbr, M, 512)
    lidx = torch.from_numpy(lidx)
    C, K, _ = lidx.shape
    g = torch.Generator().manual_seed(M)
    perm = torch.stack([torch.randperm(M, generator=g) for _ in range(C)])
    lidx_p = torch.gather(lidx, 2, perm[:, None].expand(C, K, M))
    masks, masks_p = cc.row_masks(lidx), cc.row_masks(lidx_p)
    order, order_p = cc.fwd_row_order(lidx), cc.fwd_row_order(lidx_p)
    seq = torch.gather(masks, 1, order)
    assert torch.equal(seq, torch.gather(masks_p, 1, order_p))
    assert (seq[:, 1:] >= seq[:, :-1]).all()
    assert ((seq[:, 1:] > seq[:, :-1]) | (order[:, 1:] > order[:, :-1])).all()
    assert cc.fwd_warp_steps(lidx) == cc.fwd_warp_steps(lidx_p) \
        == _warp_steps_by_loops(lidx)
    ran, skipped = cc.fwd_warp_steps(lidx)
    assert ran > 0 and skipped > 0


def test_row_order_replays_the_kernels_rank():
    """The kernel places row m at its rank: the number of rows j with
    (mask_j, j) < (mask_m, m), counted by two threads over alternate rows;
    that is the plain version's stable sort."""
    rng = np.random.default_rng(3)
    lidx = torch.from_numpy(np.where(rng.random((4, 27, 128)) < 0.2, 0, -1)
                            .astype(np.int32))
    lidx[:, :, 100:] = -1  # rows with no reference at all
    masks = cc.row_masks(lidx).numpy()
    for c in range(4):
        pos = np.full(128, -1)
        for m in range(128):
            halves = [sum(masks[c, j] < masks[c, m]
                          or (masks[c, j] == masks[c, m] and j < m)
                          for j in range(h, 128, 2)) for h in (0, 1)]
            pos[m] = sum(halves)
        order = np.empty(128, np.int64)
        order[pos] = np.arange(128)
        assert order.tolist() == cc.fwd_row_order(lidx)[c].tolist()


def test_skipped_steps_multiply_only_missing_neighbours(small_plan):
    """The f32 forward replayed in float64 step by step, each warp over
    its 16 rows of the order and only the offsets it runs, four ci at a
    time: the plain forward. Every product a skipped step leaves out is a
    zero."""
    in_idx, lidx = cc.build_chunk_arrays(small_plan.levels[0].nbr, 128, 512)
    rng = np.random.default_rng(4)
    C, K, M = lidx.shape
    cin, cout = 16, 24
    x = rng.standard_normal((small_plan.levels[0].cap, cin))
    w = rng.standard_normal((K, cin, cout))
    g = _gather(x, in_idx, lidx)                      # [C, K, M, cin]
    order = cc.fwd_row_order(torch.from_numpy(lidx)).numpy()
    out = np.zeros((C, M, cout))
    steps = 0
    for c in range(C):
        for wp in range(8):
            rows = order[c, 16 * wp:16 * wp + 16]
            for k in range(K):
                if (lidx[c, k, rows] >= 0).any():
                    for ci in range(0, cin, 4):
                        out[c, rows] += g[c, k, rows, ci:ci + 4] \
                            @ w[k, ci:ci + 4]
                    steps += 1
    assert steps == cc.fwd_warp_steps(torch.from_numpy(lidx))[0]
    np.testing.assert_allclose(out, np.einsum("ckmi,kio->cmo", g, w),
                               rtol=1e-12, atol=1e-12)


def test_bench_plan_skips_a_third_of_the_f32_products(bench_plan):
    """Over the bench plan's 33 convolutions, forward and transpose plans,
    weighted by their channel products: the warps run about 0.70 of the
    rows x offsets that skipping dead 64-row groups ran (0.66 on the
    child maps, 0.24 on the up maps), and never fewer than the real
    products (0.36)."""
    import chip_smoke as cs
    run = old = real = 0
    for cv in cs.conv_calls(bench_plan, cs.N_PLANES):
        for ch in (cv.chunks, cv.t_chunks):
            lidx = torch.from_numpy(np.asarray(ch.lidx))
            C, K, M = lidx.shape
            live = lidx >= 0
            groups = live.reshape(C, K, M // 64, 64).any(3).sum()
            ran, _ = cc.fwd_warp_steps(lidx)
            wgt = cv.cin * cv.cout
            run += 16 * ran * wgt
            old += 64 * int(groups) * wgt
            real += int(live.sum()) * wgt
    assert 0.3 * old < real < run < 0.75 * old
