"""The f32 forward's tensor-core tile (3xTF32, `TcTile` in
csrc/chunk_conv.cu) replayed on the CPU: the split of an f32 value into
two TF32 terms, the three-term product against float64, the kernel's
order of accumulation against an f32 FMA sum, the weight layout the
wrapper hands the kernel, the column order its A fragments take, the
route rule by shape, and the count of (Cin tile, offset, 64-row group)
steps the tile runs over the neighbour-mask row order; and the weight
gradient's tensor-core tile (`DwTcTile` in csrc/chunk_conv_bwd.cu): its
route rule and shared memory, its Gray-code row order and count of k8
steps, and why it sums in partials.

The kernel itself runs on a card (tests/test_torch_kernels.py).
"""

import numpy as np
import pytest
import torch

from occuseg_tpu_torch.ops.kernels import chunk_conv as cc


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int32)


@pytest.mark.parametrize("scale", [1e-3, 1.0, 3e4])
def test_split_reproduces_f32_to_2_22(scale):
    """hi and lo are TF32 values (13 low bits clear), hi is x to TF32's
    11 significant bits, and hi + lo is x to within 2^-22 of |x|."""
    g = torch.Generator().manual_seed(int(scale * 7) + 1)
    x = torch.randn(100_000, generator=g) * scale
    x[:6] = torch.tensor([0.0, 1.0, -2.0, 1 / 3, -1e-20, 65504.0])
    hi, lo = cc.tf32_split(x)
    assert not (_bits(hi) & 0x1FFF).any() and not (_bits(lo) & 0x1FFF).any()
    xd = x.double()
    assert ((lo.double()).abs() <= 2.0 ** -11 * xd.abs()).all()
    err = (hi.double() + lo.double() - xd).abs()
    assert (err <= 2.0 ** -22 * xd.abs()).all()
    assert err[:3].max() == 0  # exact TF32 values split exactly


@pytest.mark.parametrize("k", [8, 64, 1728])
def test_three_term_product_against_float64(k):
    """a_lo b_hi + a_hi b_lo + a_hi b_hi is each product to ~2^-22 of its
    size, so a sum of them is within 2^-21 of the sum of |products| from
    the float64 one, and about three orders of magnitude closer than one
    TF32 product (what plain TF32 gives)."""
    g = torch.Generator().manual_seed(k)
    a = torch.randn(256, k, generator=g)
    b = torch.randn(k, 64, generator=g) / k ** 0.5
    exact = a.double() @ b.double()
    emu = cc.tf32x3_matmul(a, b)
    bound = 2.0 ** -21 * (a.double().abs() @ b.double().abs())
    assert ((emu - exact).abs() <= bound).all()
    tf32 = cc.tf32_split(a)[0].double() @ cc.tf32_split(b)[0].double()
    assert (emu - exact).abs().max() * 300 < (tf32 - exact).abs().max()


def _in_kernel_order(a, b, small_first=True):
    """The tile's sum in f32 as it issues it: per k8 step, the 8-term
    products a_lo b_hi, a_hi b_lo, then a_hi b_hi (the small terms first;
    each 8-term product exact, then rounded into the f32 accumulator)."""
    (ah, al), (bh, bl) = cc.tf32_split(a), cc.tf32_split(b)
    acc = torch.zeros(a.shape[0], b.shape[1])
    for j in range(0, a.shape[1], 8):
        s = slice(j, j + 8)
        terms = [al[:, s].double() @ bh[s].double(),
                 ah[:, s].double() @ bl[s].double(),
                 ah[:, s].double() @ bh[s].double()]
        for t in (terms if small_first else terms[::-1]):
            acc = (acc.double() + t.float().double()).float()
    return acc


def _fma_sum(a, b):
    """The FMA tile's sum: one fused multiply-add per term, in ci order."""
    acc = torch.zeros(a.shape[0], b.shape[1])
    for i in range(a.shape[1]):
        acc = (acc.double() + a[:, i:i + 1].double()
               * b[i:i + 1].double()).float()
    return acc


@pytest.mark.parametrize("k", [64, 27 * 64])
def test_small_terms_first_within_twice_the_fma_sum(k):
    """The 3xTF32 sum in the kernel's order (the two small terms of each
    k8 step issued first) stays within twice the FMA tile's f32 error
    against float64, in mean and in max over the outputs: the bound the
    card tests hold the kernel to."""
    g = torch.Generator().manual_seed(k + 1)
    a = torch.randn(256, k, generator=g)
    b = torch.randn(k, 64, generator=g) / k ** 0.5
    exact = a.double() @ b.double()
    scale = exact.abs().max()

    def err(o):
        d = (o.double() - exact).abs() / scale
        return d.mean().item(), d.max().item()
    fma, tc = err(_fma_sum(a, b)), err(_in_kernel_order(a, b))
    assert tc[0] <= 2 * fma[0] and tc[1] <= 2 * fma[1]
    assert max(err(_in_kernel_order(a, b, small_first=False))) < 1e-5


def test_fragment_columns_are_a_permutation_fed_in_order():
    """TC_COLS permutes each 32 columns, and a thread (lane & 3 = t) that
    loads staged columns 8t..8t+8 as two float4 feeds fragment column t
    of k8 step j from component j of the first, column t + 4 from
    component j of the second: B position 8j + t holds column 8t + j, and
    8j + t + 4 holds 8t + 4 + j."""
    assert sorted(cc.TC_COLS) == list(range(32))
    for t in range(4):
        for j in range(4):
            assert cc.TC_COLS[8 * j + t] == 8 * t + j
            assert cc.TC_COLS[8 * j + t + 4] == 8 * t + 4 + j


@pytest.mark.parametrize("cin,cout", [(16, 64), (64, 64), (96, 128),
                                      (128, 96)])
def test_weight_layout_against_the_weight(cin, cout):
    """The wrapper's weight [2, K, Cout, Cin_p]: hi then lo, K-major, each
    32 columns in TC_COLS order, zero past Cin; hi + lo is the weight to
    2^-22, and the A side's gathered columns against it give the
    three-term product."""
    K = 27
    g = torch.Generator().manual_seed(cin + cout)
    w = torch.randn(K, cin, cout, generator=g) / (K * cin) ** 0.5
    wt = cc.split_weight_tf32_plain(w)
    cin_p = -(-cin // 32) * 32
    assert wt.shape == (2, K, cout, cin_p) and wt.dtype == torch.float32
    cols = (torch.arange(cin_p) // 32 * 32
            + torch.tensor(cc.TC_COLS).repeat(cin_p // 32))
    back = torch.zeros(2, K, cout, cin_p)
    back[..., cols] = wt                          # position q -> column
    assert not back[..., cin:].any()
    sum_ = (back[0].double() + back[1].double()).transpose(1, 2)[:, :cin]
    assert ((sum_ - w.double()).abs()
            <= 2.0 ** -22 * w.double().abs()).all()
    hi, lo = cc.tf32_split(w)
    assert torch.equal(back[0].transpose(1, 2)[:, :cin], hi)
    assert torch.equal(back[1].transpose(1, 2)[:, :cin], lo)
    x = torch.randn(40, cin, generator=g)
    xp = torch.zeros(40, cin_p)
    xp[:, :cin] = x
    xh, xl = (t.double() for t in cc.tf32_split(xp[:, cols]))
    for k in (0, 13):
        bh, bl = wt[0, k].t().double(), wt[1, k].t().double()
        got = xl @ bh + xh @ bl + xh @ bh
        assert torch.allclose(got, cc.tf32x3_matmul(x, w[k]), rtol=1e-12,
                              atol=1e-12)


# shapes the two configurations run (Cin padded, Cout, M, K, U), the
# column tile of the tensor-core tile at an H100's shared memory (0: none
# fits), and the tile the rule takes
ROUTES = [
    ((16, 64, 128, 27, 256), 64, "fma"),    # occuseg-m64's input conv
    ((64, 16, 128, 27, 256), 64, "tc"),     # its d_feats into the input
    ((64, 64, 128, 27, 435), 64, "tc"),     # L0 at tier 1.7
    ((128, 96, 128, 27, 256), 96, "tc"),    # minkunet34c level 0, decoder
    ((96, 96, 128, 27, 333), 96, "tc"),
    ((384, 384, 128, 27, 653), 128, "tc"),  # occuseg-m64's coarsest level
    ((128, 64, 128, 8, 160), 64, "fma"),    # L1 -> L0 on the up plan
    ((128, 64, 128, 8, 272), 64, "fma"),    # the same at tier 1.7
    ((96, 96, 128, 8, 160), 96, "tc"),      # minkunet34c's last deconv
    ((192, 128, 128, 8, 160), 128, "tc"),   # L2 -> L1 on the up plan
    ((64, 128, 128, 8, 416), 128, "tc"),    # L0 -> L1 on the child plan
    ((320, 384, 128, 8, 768), 128, "tc"),   # a deconv's d_feats (child)
    ((320, 384, 128, 8, 1024), 64, "tc"),   # the same at tier 1.3
    ((64, 128, 128, 8, 1312), 0, "fma"),    # a child plan at tier 1.7
]


@pytest.mark.parametrize("shape,nt,route", ROUTES)
def test_route_rule_by_shape(shape, nt, route):
    """The tensor-core tile at its column tile where that block fits the
    shared memory, else at 64 columns where that fits, else the FMA tile;
    the FMA tile also below 32 input columns and on an up plan (K = 8,
    U < 3M) at 64 output columns or fewer. Only shapes decide."""
    cin, cout, M, K, U = shape
    assert cc.tc_col_tile(cout, K, U) == nt
    assert cc.f32_route(cin, cout, M, K, U) == route
    for t in (cc.col_tile(cout, True), 64):
        fits = cc.tc_smem_bytes(U, K, t) <= cc.H100_SMEM
        assert fits == (nt == t) or (nt == cc.col_tile(cout, True) and fits)


def test_tc_smem_bytes_adds_up():
    """The tile's shared memory: 3 W stages of a hi and a lo box
    (nt x 128 bytes each), then 128-byte aligned pieces, 1 KiB to align;
    one more staged row or lidx offset costs its bytes."""
    base = cc.tc_smem_bytes(256, 27, 64)
    assert base == (3 * 2 * 64 * 128 + 128 + 1024 + 27 * 512 + 768
                    + 290 * 128 + 1024)         # 257 rows of 144 bytes
    assert cc.tc_smem_bytes(256, 27, 128) - base == 3 * 2 * 64 * 128
    assert cc.tc_smem_bytes(288, 27, 64) - base == 32 * 4 + 32 * 144


def _group_steps_by_loops(lidx, tiles=1):
    """`fwd_group_steps` written out: rows sorted by (mask, row), 64 to a
    group, a group live at an offset where one of its rows references it
    (every offset from 32 on, unless the chunk has no reference)."""
    lidx = lidx.numpy()
    C, K, M = lidx.shape
    ran = 0
    for c in range(C):
        masks = [sum(1 << k for k in range(min(K, 32)) if lidx[c, k, m] >= 0)
                 for m in range(M)]
        order = sorted(range(M), key=lambda m: (masks[m], m))
        any_ref = (lidx[c] >= 0).any()
        for grp in range(2):
            rows = order[64 * grp:64 * grp + 64]
            ran += sum((k >= 32 and any_ref)
                       or any(lidx[c, k, m] >= 0 for m in rows)
                       for k in range(K))
    return tiles * ran, tiles * (C * K * 2 - ran)


@pytest.mark.parametrize("M,K,p", [(128, 27, 0.3), (128, 8, 0.12),
                                   (64, 27, 0.3), (128, 40, 0.05)])
def test_group_steps_against_brute_force(M, K, p):
    """The tensor-core tile's count of (Cin tile, offset, 64-row group)
    steps run and skipped, against the loops, on random chunks (with
    rows that reference nothing, an all-pad chunk, M = 64 whose second
    group holds no row, offsets past the masks' 32)."""
    rng = np.random.default_rng(M + K)
    lidx = np.where(rng.random((5, K, M)) < p, 0, -1).astype(np.int32)
    lidx[1, :, M // 2:] = -1
    lidx[4] = -1
    lidx = torch.from_numpy(lidx)
    assert cc.fwd_group_steps(lidx, tiles=3) == _group_steps_by_loops(lidx, 3)
    ran, skipped = cc.fwd_group_steps(lidx)
    assert ran > 0 and skipped >= (K if K <= 32 else 32) * 2


def test_counts_default_to_no_group_steps():
    """An FMA-tile count has no group-steps; the shares read 0 where
    nothing ran."""
    n = cc.FwdCounts(3, 1, 10, 100)
    assert (n.group_ran, n.group_skipped, n.group_skipped_share) == (0, 0, 0)
    assert cc.FwdCounts(0, 0, 0, 0, 6, 2).group_skipped_share == 0.25


# The weight-gradient kernel's tensor-core tile (`DwTcTile` in
# csrc/chunk_conv_bwd.cu): (gathered columns, dense columns, K, U) of the
# two configurations' calls, from the input convolution to the widest U
DW_SHAPES = [
    (64, 16, 27, 256),     # occuseg-m64's input conv, dWt (Cin 3 padded)
    (16, 64, 27, 256),     # the same on the dW route: 16 gathered columns
    (64, 64, 27, 256),     # occuseg-m64 L0, either route
    (128, 96, 27, 256),    # minkunet34c level 0, decoder
    (64, 64, 27, 435),     # L0 at tier 1.7
    (384, 384, 27, 653),   # occuseg-m64's coarsest level, tier 1.7
    (128, 64, 8, 160),     # a deconv's dWt on the child's up plan
    (64, 96, 8, 1312),     # a child plan at tier 1.7
]


@pytest.mark.parametrize("shape", DW_SHAPES)
def test_dw_route_by_shape(shape):
    """The tensor-core dW tile wherever its block fits the shared memory,
    which it does on an H100 at every shape (it stages the rows a group of
    offsets references, at most 4 x 128); the FMA tile on a device with
    less (99 KiB a block)."""
    cx, cd, K, U = shape
    assert cc.dw_route(cx, cd, K, U) == "tc"
    assert cc.dw_route(cx, cd, K, U, smem=101_376) == "fma"


def test_dw_tc_smem_bytes_adds_up():
    """The tile's shared memory: the D tile's hi and lo halves (2 x 32
    KiB), two buffers of a chunk's record (the references and the list of
    rows, 4 x 128 int32 each, the order and the length: 33 x 128 + 16
    bytes), 513 staged rows of 72 f32, 1 KiB to align: within the H100's
    227 KiB a block."""
    assert cc.dw_order_record_bytes(128) == 4240
    assert cc.dw_order_record_bytes(32) % 16 == 0
    assert cc.dw_tc_smem_bytes() == (65536 + 2 * 4352 + 147840 + 1024)
    assert cc.dw_tc_smem_bytes() <= cc.H100_SMEM


def _gray_position(mask):
    seq = [p ^ (p >> 1) for p in range(16)]
    return seq.index(mask)


def _dw_steps_by_loops(lidx, tiles=1):
    """`dw_k_steps` written out: per chunk and group of 4 offsets, the
    rows sorted by (position of their 4-bit mask in the Gray code, row),
    8 positions a step, a step run at an offset where one of its rows
    has a reference there."""
    lidx = lidx.numpy()
    C, K, M = lidx.shape
    ran = 0
    for c in range(C):
        for k0 in range(0, K, 4):
            ks = range(k0, min(K, k0 + 4))
            masks = [sum(1 << (k - k0) for k in ks if lidx[c, k, m] >= 0)
                     for m in range(M)]
            order = sorted(range(M), key=lambda m: (_gray_position(masks[m]),
                                                    m))
            for k in ks:
                for s in range(M // 8):
                    ran += any(lidx[c, k, m] >= 0
                               for m in order[8 * s:8 * s + 8])
    return tiles * ran, tiles * (C * K * (M // 8) - ran)


@pytest.mark.parametrize("M,K,p", [(128, 27, 0.3), (128, 8, 0.12),
                                   (64, 27, 0.5), (32, 6, 0.2)])
def test_dw_k_steps_against_brute_force(M, K, p):
    """The tensor-core dW tile's count of (offset, k8 step) pairs run and
    skipped, against the loops, on random chunks (rows that reference
    nothing, an all-pad chunk, K not a multiple of 4, M below 128); the
    row order puts each offset's references into fewer steps than the
    rows' own order."""
    rng = np.random.default_rng(M + K)
    lidx = np.where(rng.random((5, K, M)) < p, 0, -1).astype(np.int32)
    lidx[1, :, M // 2:] = -1
    lidx[4] = -1
    lidx = torch.from_numpy(lidx)
    assert cc.dw_k_steps(lidx, tiles=3) == _dw_steps_by_loops(lidx, 3)
    ran, skipped = cc.dw_k_steps(lidx)
    natural = int((lidx >= 0).reshape(5, K, M // 8, 8).any(3).sum())
    assert skipped >= K * (M // 8) and ran < natural


def test_dw_row_order_puts_high_offsets_in_one_range():
    """In the Gray-code order the rows with a reference at a group's
    offset 3 form one range, and so do those at offset 2; the order is
    a permutation, ties by row."""
    rng = np.random.default_rng(7)
    lidx = torch.from_numpy(np.where(rng.random((3, 8, 128)) < 0.4, 0,
                                     -1).astype(np.int32))
    order = cc.dw_row_order(lidx)
    assert order.shape == (3, 2, 128)
    for c in range(3):
        for g in range(2):
            assert sorted(order[c, g].tolist()) == list(range(128))
            for j in (2, 3):
                has = (lidx[c, 4 * g + j, order[c, g]] >= 0).int()
                assert int((has[1:] != has[:-1]).sum()) <= 2


def _round_toward_zero(x64: torch.Tensor) -> torch.Tensor:
    """float64 -> f32 rounded toward zero."""
    x32 = x64.float()
    over = x32.double().abs() > x64.abs()
    return torch.where(over, torch.nextafter(x32, torch.zeros_like(x32)),
                       x32)


def _tc_dw_sum(a, b, rows_per_partial):
    """sum_m a[m]^T b[m] as the tensor-core dW tile forms it, with the
    tensor cores' f32 accumulator modelled as rounding toward zero after
    each k8 step's 8-term product (exact): per k8 step a_lo b_hi, a_hi
    b_lo, then a_hi b_hi into a partial that restarts every
    `rows_per_partial` rows, each partial then added into the total with
    an f32 add (round to nearest)."""
    (ah, al), (bh, bl) = cc.tf32_split(a), cc.tf32_split(b)
    ah, al, bh, bl = (t.double() for t in (ah, al, bh, bl))
    total = torch.zeros(a.shape[1], b.shape[1])
    part = None
    for m in range(0, a.shape[0], 8):
        s = slice(m, m + 8)
        if m % rows_per_partial == 0:
            part = torch.zeros_like(total)
        for x, y in ((al, bh), (ah, bl), (ah, bh)):
            part = _round_toward_zero(part.double() + x[s].t() @ y[s])
        if (m + 8) % rows_per_partial == 0:
            total = (total.double() + part.double()).float()
    return total


def test_8192_row_accumulation_needs_partial_sums():
    """One run of the weight-gradient kernel sums up to 64 chunks (8192
    rows) before the ordered sum of runs. Emulated in 3xTF32 with the
    tensor cores' accumulator modelled as truncating, on features after
    a ReLU against gradients of mean 0.5: with a fresh partial every 32
    rows (a batch of 4 k8 steps) the sum is within DW_TOL (1e-4 of the
    largest output) of float64 and within 1.1x an f32 FMA sum's error,
    the bound the card tests hold the tile to; in one accumulator over
    the 8192 rows its error is more than ten times the FMA sum's."""
    g = torch.Generator().manual_seed(23)
    a = torch.randn(8192, 16, generator=g).abs()
    b = torch.randn(8192, 16, generator=g) + 0.5
    exact = a.double().t() @ b.double()
    scale = exact.abs().max().item()

    def err(o):
        return (o.double() - exact).abs().max().item() / scale
    fma = torch.zeros(16, 16)
    for m in range(8192):
        fma = (fma.double() + a[m, :, None].double()
               * b[m, None].double()).float()
    batched, whole = _tc_dw_sum(a, b, 32), _tc_dw_sum(a, b, 8192)
    assert err(batched) <= 1e-4 and err(batched) <= 1.1 * err(fma)
    assert err(whole) > 10 * err(fma)
