"""Chunk convolution: host rulebooks, the CUDA forward and backward, and
the autograd entry points (counterpart of
`occuseg_tpu/ops/pallas/chunk_conv.py`).

Host half (NumPy, runs in the loader): `build_chunk_arrays` cuts a map
[cap, K] into chunks of M consecutive output rows, each with the sorted
list of distinct input rows it references (`in_idx [C, U]`) and the
position of every (offset, row) reference in that list (`lidx [C, K, M]`,
-1 missing). `augment_plan_with_chunks` attaches one `ChunkPlan` to every
level (nbr map) and transition (child and up maps), with the JAX package's
per-level U tables and escalation tiers, so the plans are bit-identical.

Device half: `chunk_conv` computes

    out[c*M+m] = sum_k (lidx[c,k,m] >= 0 ? feats[in_idx[c, lidx[c,k,m]]] : 0)
                       @ W[k]

in f32 with the output in the feature dtype. The same call serves
submanifold layers (level chunks), strided convolutions (child chunks,
output = coarse cap) and deconvolutions (up chunks, output = fine cap).
The backward has two routes: `chunk_conv_bwd_fused` computes d_feats (the
forward kernel over the TRANSPOSE plan) and dWt (the weight-gradient
kernel of `csrc/chunk_conv_bwd.cu`, also over the transpose plan, summed
per run of chunks); the dW route runs `chunk_conv_dw` (the same kernel
with its operands' roles swapped, over the forward plan) and the forward
kernel over the transpose plan. The launch geometry (column tile,
split steps at the coarse levels, runs of chunks) is chosen here from
static shapes (`col_tile`, `conv_splits`, `dwt_runs`). In f32 the
forward kernel runs one of two tiles, chosen from shapes (`f32_route`):
the product split into three TF32 products on the tensor cores
(`tf32_split`, the weight laid out by `split_weight_tf32_plain`'s rule)
or exact FMA products; the weight-gradient kernel likewise runs its
3xTF32 tensor-core tile (rows in a Gray-code order of their neighbour
masks, `dw_row_order`) or its FMA tile, chosen from shapes (`dw_route`).
`fused_grouping` picks the route from static shapes with the JAX
package's rule. `chunk_gather_conv` (submanifold: the plan is its own
transpose under offset reversal) and `chunk_gather_conv_t` (a transition
with its explicit transpose plan) are the autograd entry points. On CUDA
tensors every wrapper launches its kernel (or raises); on CPU tensors it
runs its plain version.
"""

from __future__ import annotations

import dataclasses
import functools
import logging
from typing import Optional, Tuple

import numpy as np
import torch

from occuseg_tpu_torch import native
from occuseg_tpu_torch.core.topology import ChunkPlan
from occuseg_tpu_torch.ops import kernels
from occuseg_tpu_torch.utils.profiling import count, span

DEFAULT_M = 128

logger = logging.getLogger("occuseg_tpu_torch")


# ---------------------------------------------------------------------------
# Host-side chunk planning
# ---------------------------------------------------------------------------

def build_chunk_arrays(nbr: np.ndarray, M: int, U: int
                       ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """(in_idx [C, U] int32, lidx [C, K, M] int32) for a map [cap, K], or
    None when cap is not a multiple of M or some chunk references more
    than U distinct rows (C++ planner, `csrc/native.cpp::plan_chunks`)."""
    if nbr.shape[0] % M != 0:
        return None
    in_idx, lidx = native.plan_chunks(nbr, M, U)
    return None if in_idx is None else (in_idx, lidx)


def _chunk_or_none(table: np.ndarray, M: int, u: int) -> Optional[ChunkPlan]:
    arrs = build_chunk_arrays(np.asarray(table), M, u)
    return None if arrs is None else ChunkPlan(in_idx=arrs[0], lidx=arrs[1])


def augment_plan_with_chunks(plan, M: int = DEFAULT_M, U=None, U_child=None,
                             U_up: int = None, tiers=(1.0, 1.3, 1.7),
                             per_map: bool = False):
    """Attach ChunkPlans to every level and transition of a host plan.

    U budgets are static tables (an int or one per level). Escalation
    follows the JAX package: first a submanifold level that overflows
    retries with its own U scaled by 1.3; if a transition overflows or
    1.3 is not enough, the whole plan is scaled by each later tier in
    turn. Under the last tier, maps that still overflow keep
    `chunks=None`, and the convolutions over them take the gather path
    (`nn/modules.py`, `ops/conv.py`). The plan returned records the tier
    in `chunk_tier`.

    A blocked multi-scene plan (`native/blocked.py`, vector
    `num_active`) is planned as it stands: its per-scene caps are
    multiples of M, so no chunk straddles two scenes, and each chunk's
    input list is the JAX package's scene-local list shifted to global
    rows.

    With `per_map` (`PlanSpec.chunk_escalation == "map"`), each map
    instead takes the first of the tiers whose budget holds it, alone: a
    map that overflows is rebuilt at the next tier, the others keep tier
    1.0, so a batch's rulebooks are built once and the maps' budgets do
    not all jump with its worst map (the whole-plan rule's tiers 1.3 and
    1.7 make a step's kernels stage up to 1.7x the rows).

    Each attempt is the span `plan.chunk_try` (`utils/profiling.py`;
    under `per_map` the first pass over every map is one, and each map's
    rebuild at a later tier another); a plan returned above tier 1.0
    counts `plan.tier_raised`, and its maps left with `chunks=None` count
    `plan.gather_maps`."""
    if per_map:
        out, lbl = _augment_per_map(plan, M, U, U_child, U_up, tiers)
        return _counted(out, lbl or 1.0)

    def attempt(f, warn):
        with span("plan.chunk_try"):
            return _augment_once(plan, M, U, U_child, U_up, f, warn=warn)

    n_lvl = len(plan.levels)
    factors = [1.0] * n_lvl
    for _ in range(n_lvl + 1):
        out, over_l, over_t = attempt((tuple(factors), 1.0, 1.0), False)
        if out is not None:
            lbl = ",".join(f"L{li}x{f:.2f}" for li, f in enumerate(factors)
                           if f != 1.0)
            return _counted(out, lbl or 1.0)
        fresh = [li for li in over_l if factors[li] == 1.0]
        if over_t or not fresh:
            break  # a transition overflowed, or 1.3 was not enough
        for li in fresh:
            factors[li] = 1.3

    for f in tiers[1:-1]:
        out, _, _ = attempt(f, False)
        if out is not None:
            return _counted(out, float(f))
    out, _, _ = attempt(tiers[-1], True)
    return _counted(out, float(tiers[-1]))


def _counted(plan, tier):
    """The plan at `tier`, counted in `plan.tier_raised` (above 1.0) and
    `plan.gather_maps` (its maps without chunks: a level's, a
    transition's child and up)."""
    if tier != 1.0:
        count("plan.tier_raised")
    count("plan.gather_maps",
          sum(lvl.chunks is None for lvl in plan.levels)
          + 2 * sum(tr.child_chunks is None for tr in plan.transitions))
    return dataclasses.replace(plan, chunk_tier=tier)


def _tier3(f):
    """Normalize a tier spec (float, or (f_lvl, f_child, f_up))."""
    return (f, f, f) if isinstance(f, (int, float)) else tuple(f)


def _scale1(u: int, f: float) -> int:
    return u if f == 1.0 else -(-int(u * f) // 32) * 32


def _scale_u(u, f):
    if isinstance(u, int):
        return _scale1(u, f)
    return tuple(_scale1(x, f) for x in u)


def _budgets(M, U, U_child, U_up):
    """The default U tables of chunk size M (`_augment_once`'s)."""
    if U is None:
        # measured per-level maxima at M=128: 231/287/321/325/317/260
        U = ((256, 320, 384, 384, 384, 320) if M == 128
             else (512, 512, 640, 640, 640, 640))
    if U_child is None:
        # measured child maxima at M=128: 346/489/617/672/662
        U_child = ((416, 576, 704, 768, 768) if M == 128
                   else (768, 1152, 1408, 1536, 1408))
    if U_up is None:
        # measured up maxima at M=128: 122/90/55/41/36
        U_up = 160 if M == 128 else 384
    return U, U_child, U_up


def _pick(u, i):
    return u if isinstance(u, int) else u[min(i, len(u) - 1)]


def _augment_per_map(plan, M, U, U_child, U_up, tiers):
    """(plan, tier label) of `augment_plan_with_chunks(per_map=True)`:
    each map's chunks at the first tier whose scaled budget holds it
    (None past the last, a gather-path map); a transition's two maps
    both or neither. The label names the maps above 1.0 (L<level>,
    T<transition>), as the whole-plan rule's per-level labels. The first
    pass over every map at tier 1.0 is one `plan.chunk_try` span, each
    later rebuild of one map another."""
    U, U_child, U_up = _budgets(M, U, U_child, U_up)
    maps = [(f"L{li}", lvl.nbr, _pick(U, li))
            for li, lvl in enumerate(plan.levels)]
    for ti, tr in enumerate(plan.transitions):
        maps += [(f"T{ti}c", tr.child, _pick(U_child, ti)),
                 (f"T{ti}u", tr.up, _pick(U_up, ti))]
    with span("plan.chunk_try"):
        got = {name: _chunk_or_none(np.asarray(table), M, u)
               for name, table, u in maps}
    raised = []
    for name, table, u in maps:
        # a misaligned cap is not an overflow
        if got[name] is not None or np.shape(table)[0] % M:
            continue
        for f in tiers[1:]:
            with span("plan.chunk_try"):
                got[name] = _chunk_or_none(np.asarray(table), M,
                                           _scale1(u, f))
            if got[name] is not None:
                raised.append(f"{name}x{f:.2f}")
                break
        else:
            logger.warning("chunk plan overflow at %s (U=%d, tiers %s)",
                           name, u, tiers)

    levels = tuple(dataclasses.replace(lvl, chunks=got[f"L{li}"])
                   for li, lvl in enumerate(plan.levels))
    transitions = []
    for ti, tr in enumerate(plan.transitions):
        child, up = got[f"T{ti}c"], got[f"T{ti}u"]
        if child is None or up is None:
            child = up = None
        transitions.append(dataclasses.replace(tr, child_chunks=child,
                                               up_chunks=up))
    return dataclasses.replace(plan, levels=levels,
                               transitions=tuple(transitions)), \
        ",".join(raised)


def _augment_once(plan, M, U, U_child, U_up, tier_f, warn):
    """One escalation attempt: (plan or None, overflowed levels,
    overflowed transitions). With warn=False an overflow returns no plan;
    with warn=True overflowing maps keep chunks=None."""
    U, U_child, U_up = _budgets(M, U, U_child, U_up)
    f_lvl, f_child, f_up = _tier3(tier_f)
    U_child, U_up = _scale_u(U_child, f_child), _scale_u(U_up, f_up)
    over_l, over_t = [], []
    new_levels = []
    for li, lvl in enumerate(plan.levels):
        u = U if isinstance(U, int) else U[min(li, len(U) - 1)]
        fl = f_lvl if isinstance(f_lvl, (int, float)) \
            else f_lvl[min(li, len(f_lvl) - 1)]
        u = _scale1(u, fl)
        nbr = np.asarray(lvl.nbr)
        chunks = _chunk_or_none(nbr, M, u)
        # a misaligned cap is not an overflow and must not escalate
        if chunks is None and nbr.shape[0] % M == 0:
            over_l.append(li)
            if warn:
                logger.warning("chunk plan overflow at level %d (U=%d, "
                               "tier %s)", li, u, tier_f)
        new_levels.append(dataclasses.replace(lvl, chunks=chunks))
    new_transitions = []
    for ti, tr in enumerate(plan.transitions):
        uc = U_child if isinstance(U_child, int) \
            else U_child[min(ti, len(U_child) - 1)]
        child_chunks = _chunk_or_none(tr.child, M, uc)
        up_chunks = _chunk_or_none(tr.up, M, U_up)
        # both directions or neither, as in the JAX package (its VJP needs
        # the transpose plan)
        if child_chunks is None or up_chunks is None:
            if ((child_chunks is None and np.shape(tr.child)[0] % M == 0)
                    or (up_chunks is None and np.shape(tr.up)[0] % M == 0)):
                over_t.append(ti)
            child_chunks = up_chunks = None
        new_transitions.append(dataclasses.replace(
            tr, child_chunks=child_chunks, up_chunks=up_chunks))
    if (over_l or over_t) and not warn:
        return None, over_l, over_t
    return dataclasses.replace(plan, levels=tuple(new_levels),
                               transitions=tuple(new_transitions)), \
        over_l, over_t


# ---------------------------------------------------------------------------
# Device half: plain versions (CPU tensors; the reference on the card)
# ---------------------------------------------------------------------------

def _gather_chunks(x: torch.Tensor, in_idx: torch.Tensor,
                   lidx: torch.Tensor) -> torch.Tensor:
    """[C, K, M, X]: row m of offset k of chunk c is x[in_idx[c, lidx[c,k,m]]],
    zero where lidx is -1. Pad slots of in_idx (-1) read row 0; no valid
    lidx points at one."""
    C = lidx.shape[0]
    gin = x[in_idx.clamp(min=0).long()]                       # [C, U, X]
    chunk = torch.arange(C, device=x.device)[:, None, None]
    g = gin[chunk, lidx.clamp(min=0).long()]                  # [C, K, M, X]
    return torch.where((lidx >= 0)[..., None], g,
                       torch.zeros((), dtype=g.dtype, device=g.device))


def chunk_conv_plain(feats: torch.Tensor, in_idx: torch.Tensor,
                     lidx: torch.Tensor, weight: torch.Tensor,
                     acc: torch.dtype = torch.float32) -> torch.Tensor:
    """Plain PyTorch chunk conv (the JAX `_dechunked_conv` math): gather
    each chunk's rows through lidx, zero the -1 references, then one
    einsum in `acc` (f32; float64 gives the f32 kernels' accuracy
    yardstick). feats [N, Cin], weight [K, Cin, Cout] -> [C*M, Cout] in
    feats.dtype (in `acc` where that is float64)."""
    C, K, M = lidx.shape
    g = _gather_chunks(feats, in_idx, lidx)
    out = torch.einsum("ckmi,kio->cmo", g.to(acc), weight.to(acc))
    out = out.reshape(C * M, weight.shape[2])
    return out if acc == torch.float64 else out.to(feats.dtype)


def chunk_conv_bwd_fused_plain(ct: torch.Tensor, t_in_idx: torch.Tensor,
                               t_lidx: torch.Tensor, w_t: torch.Tensor,
                               feats: torch.Tensor):
    """Plain version of `chunk_conv_bwd_fused`: (d_feats [C*M, Cin] in
    feats.dtype, dWt [K, Cin, Ct] f32), both from one f32 gather of ct."""
    C, K, M = t_lidx.shape
    cin = w_t.shape[2]
    g = _gather_chunks(ct, t_in_idx, t_lidx).float()          # [C, K, M, Ct]
    d_feats = torch.einsum("ckmt,kti->cmi", g, w_t.float())
    dwt = torch.einsum("cmi,ckmt->kit", feats.reshape(C, M, cin).float(), g)
    return d_feats.reshape(C * M, cin).to(feats.dtype), dwt


def chunk_conv_dw_plain(feats: torch.Tensor, in_idx: torch.Tensor,
                        lidx: torch.Tensor, ct: torch.Tensor,
                        acc: torch.dtype = torch.float32) -> torch.Tensor:
    """Plain version of `chunk_conv_dw`: dW [K, Cin, Cout] in `acc` (f32;
    float64 gives the f32 tiles' accuracy yardstick)."""
    C, K, M = lidx.shape
    g = _gather_chunks(feats, in_idx, lidx).to(acc)           # [C, K, M, Cin]
    return torch.einsum("ckmi,cmo->kio", g, ct.reshape(C, M, -1).to(acc))


# The f32 tiles of the forward kernel (csrc/chunk_conv.cu): `FmaTile`'s 8
# warps, each owning 16 consecutive positions of its chunk's row order;
# `TcTile`'s 2 warpgroups, each owning 64; a row's neighbour mask over the
# offsets below 32 (a warp or warpgroup runs every offset from 32 on).
F32_WARPS, F32_WARP_ROWS, MASK_OFFSETS = 8, 16, 32
TC_GROUPS, TC_GROUP_ROWS = 2, 64


def row_masks(lidx: torch.Tensor) -> torch.Tensor:
    """[C, M] int64: bit k of row m's mask is set where lidx[c, k, m] >= 0,
    for the offsets k < MASK_OFFSETS."""
    live = (lidx[:, :MASK_OFFSETS] >= 0).long()               # [C, K', M]
    bits = torch.ones((), dtype=torch.long) << torch.arange(live.shape[1])
    return (live * bits[:, None]).sum(1)


def fwd_row_order(lidx: torch.Tensor) -> torch.Tensor:
    """Plain version of the f32 forward kernel's row order: [C, M] int64,
    each chunk's rows sorted by their neighbour mask (`row_masks`, as an
    integer), ties by row. Position p of a chunk holds row order[c, p]."""
    return torch.sort(row_masks(lidx), dim=1, stable=True).indices


def _ordered_steps(lidx: torch.Tensor, units: int, rows_per_unit: int,
                   tiles: int) -> Tuple[int, int]:
    """(ran, skipped) (Cin tile, offset, unit) steps where unit u holds
    positions rows_per_unit * u.. of `fwd_row_order` (past M: no row)
    and runs an offset where any of its rows has a reference, and every
    offset from MASK_OFFSETS on; a chunk with no reference runs nothing.
    `tiles` (Cin tile, column tile) pairs repeat the same steps."""
    C, K, M = lidx.shape
    order = fwd_row_order(lidx)
    rows = torch.gather(lidx >= 0, 2, order[:, None, :].expand(C, K, M))
    rows = torch.cat([rows, rows.new_zeros(C, K, units * rows_per_unit - M)],
                     2)
    live = rows.reshape(C, K, units, rows_per_unit).any(3)
    live[:, MASK_OFFSETS:] = rows.flatten(1).any(1)[:, None, None]
    ran = int(live.sum())
    return tiles * ran, tiles * (C * K * units - ran)


def fwd_warp_steps(lidx: torch.Tensor, tiles: int = 1) -> Tuple[int, int]:
    """(ran, skipped): the (Cin tile, offset, warp) steps of the f32
    forward kernel's FMA tile over lidx [C, K, M] (`_ordered_steps` with
    F32_WARPS warps of F32_WARP_ROWS rows)."""
    return _ordered_steps(lidx, F32_WARPS, F32_WARP_ROWS, tiles)


def fwd_group_steps(lidx: torch.Tensor, tiles: int = 1) -> Tuple[int, int]:
    """(ran, skipped): the (Cin tile, offset, 64-row group) steps of the
    f32 forward kernel's tensor-core tile over lidx [C, K, M]
    (`_ordered_steps` with TC_GROUPS warpgroups of TC_GROUP_ROWS rows)."""
    return _ordered_steps(lidx, TC_GROUPS, TC_GROUP_ROWS, tiles)


# ---------------------------------------------------------------------------
# f32 on the tensor cores (3xTF32): the split, its weight layout, its route
# ---------------------------------------------------------------------------

def _tc_col(q: int) -> int:
    j, p = q >> 3, q & 7
    return 8 * p + j if p < 4 else 8 * (p - 4) + 4 + j


# Position q of each 32-column group of a K-major W row holds Cin column
# TC_COLS[q] of the group (`tc_col` in csrc/chunk_conv.cu): the order in
# which a thread's two 16-byte loads of a staged row feed the A fragments
# of the tile's four k8 steps.
TC_COLS = tuple(_tc_col(q) for q in range(32))


def tf32_split(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) of an f32 tensor as the kernel splits it (`tf32_split` in
    csrc/chunk_conv.cuh): hi = x rounded to TF32's 11 significant bits
    (Veltkamp's split by 2^13 + 1), lo = x - hi with its 13 low bits
    cleared (what the tensor core reads of it). hi + lo is x to within
    2^-23 of |x|."""
    x = x.float()
    c = x * 8193.0
    hi = c - (c - x)
    lo = ((x - hi).view(torch.int32) & -8192).view(torch.float32)
    return hi, lo


def tf32x3_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as the tensor-core path computes it, each product
    a_lo*b_hi + a_hi*b_lo + a_hi*b_hi (`tf32_split`), summed in float64
    (the kernel sums in f32 on the tensor cores): float64 [..., n]."""
    (ah, al), (bh, bl) = tf32_split(a), tf32_split(b)
    ah, al, bh, bl = (t.double() for t in (ah, al, bh, bl))
    return al @ bh + ah @ bl + ah @ bh


def split_weight_tf32_plain(w: torch.Tensor) -> torch.Tensor:
    """Plain version of the wrapper's weight for the tensor-core path
    (`occ_chunk_conv_tf32_split_w`): w [K, Cin, Cout] -> f32 [2, K, Cout,
    Cin_p], hi then lo (`tf32_split`), K-major, Cin padded with zeros to a
    multiple of 32 and each 32 columns in TC_COLS order."""
    K, cin, cout = w.shape
    cin_p = -(-cin // 32) * 32
    wp = torch.zeros((K, cin_p, cout), dtype=torch.float32, device=w.device)
    wp[:, :cin] = w
    cols = (torch.arange(cin_p) // 32 * 32
            + torch.tensor(TC_COLS).repeat(cin_p // 32)).to(w.device)
    wk = wp[:, cols].transpose(1, 2)                          # [K, Cout, Cin_p]
    return torch.stack(tf32_split(wk)).contiguous()


# The opt-in shared memory of one block on an H100 (227 KiB); the wrapper
# reads the device's own.
H100_SMEM = 232_448


def _align128(n: int) -> int:
    return -(-n // 128) * 128


def tc_smem_bytes(U: int, K: int, nt: int) -> int:
    """Shared memory of a tensor-core block (`FwdLayout<float, 32, nt,
    true>` in csrc/chunk_conv.cu): the W ring (3 stages of a hi and a lo
    box of nt rows x 128 bytes), its barriers, the chunk's in_idx and
    lidx, the row masks and order, the U + 1 staged rows of 32 + 4 f32,
    and 1 KiB to align the base."""
    off = 3 * 2 * nt * 128
    off += _align128(2 * 3 * 8)
    off += _align128(U * 4)
    off += _align128(K * 128 * 4)
    off += _align128(128 * 4 + F32_WARPS * 4 + 128)
    off += _align128((U + 1) * 36 * 4)
    return off + 1024


def tc_col_tile(cout: int, K: int, U: int, smem: int = H100_SMEM) -> int:
    """The tensor-core tile's output columns per block: `col_tile(cout,
    True)` where that block fits in `smem` bytes of shared memory, else 64
    where that fits (a smaller W ring beside the wide transpose plans'
    staged rows), else 0: the FMA tile."""
    for nt in dict.fromkeys((col_tile(cout, True), 64)):
        if tc_smem_bytes(U, K, nt) <= smem:
            return nt
    return 0


def f32_route(cin: int, cout: int, M: int, K: int, U: int,
              smem: int = H100_SMEM) -> str:
    """Which f32 tile the forward kernel runs at these shapes: "tc" (the
    3xTF32 tensor-core tile) where a block of it fits in `smem` bytes of
    shared memory (`tc_col_tile`), else "fma" (the FMA tile, whose Cin
    tile can shrink to 16). Only shapes decide: Cin (padded), Cout, M, K
    and the plan's U. Two shapes where the FMA tile measured faster on
    the H100 keep it (`PERF.md` §6): Cin below the tensor-core tile's
    32 columns (the input conv's 16: half of each step's products are
    padding), and an `up` plan (K = 8 and U < 3M: each output row has one
    reference, so a 64-row group runs about four of the eight offsets a
    16-row warp's single one) at 64 output columns or fewer."""
    if cin < 32 or (K == 8 and U < 3 * M and cout <= 64):
        return "fma"
    return "tc" if tc_col_tile(cout, K, U, smem) else "fma"


# The weight-gradient kernel's tensor-core tile: a block takes DW_OFFSETS
# offsets; a k8 step is DW_STEP_ROWS positions of its chunk's row order.
DW_OFFSETS, DW_STEP_ROWS = 4, 8


def dw_order_record_bytes(M: int) -> int:
    """Bytes of the tensor-core dW tile's record of one chunk and group of
    DW_OFFSETS offsets (`dw_kernel_row_order` in csrc/chunk_conv_bwd.cu):
    the group's references as positions in its list of rows (DW_OFFSETS
    x M int32, in the chunk's row order), that list of rows (up to
    DW_OFFSETS x M int32), the row order (M bytes) and the list's length
    (16 bytes)."""
    return 33 * M + 16


def dw_tc_smem_bytes() -> int:
    """Shared memory of a block of the weight-gradient kernel's
    tensor-core tile (`DwLayout<float, 64, true>` in
    csrc/chunk_conv_bwd.cu), whatever U is: the D tile's hi and lo halves
    (128 rows x 64 columns of f32 each), two buffers of a chunk's record
    (`dw_order_record_bytes` at M = 128), the DW_OFFSETS x 128 rows a
    group of offsets can reference and a zero row, each 64 + 8 f32, and 1
    KiB to align the base."""
    off = 2 * 128 * 64 * 4
    off += 2 * _align128(dw_order_record_bytes(128))
    off += _align128((DW_OFFSETS * 128 + 1) * 72 * 4)
    return off + 1024


def dw_route(cx: int, cd: int, K: int, U: int,
             smem: int = H100_SMEM) -> str:
    """Which f32 tile the weight-gradient kernel runs for a gathered
    operand of cx columns, a dense one of cd, K offsets and U staged rows
    (the fused route's dWt: cx = Ct, cd = Cin over the transpose plan; the
    dW route: cx = Cin, cd = Cout over the forward plan): "tc" (the 3xTF32
    tensor-core tile) where its block fits in `smem` bytes of shared
    memory (`dw_tc_smem_bytes`, the same at every shape: it stages only
    the rows a group of offsets references), else "fma" (the FMA tile).
    On the H100 the tensor-core tile fits every shape and measured faster
    at every shape of the bench scene, the input convolution's 16
    gathered columns included (0.52 against 0.94 ms at level 0, `PERF.md`
    §6), so the FMA tile runs on a device with less shared memory, or
    when a test or timing tool asks for it."""
    return "tc" if dw_tc_smem_bytes() <= smem else "fma"


def _gray_rank(mask: torch.Tensor) -> torch.Tensor:
    """The position of each 4-bit mask in the reflected Gray code
    (`gray_rank` in csrc/chunk_conv_bwd.cu)."""
    return mask ^ (mask >> 1) ^ (mask >> 2) ^ (mask >> 3)


def dw_row_order(lidx: torch.Tensor) -> torch.Tensor:
    """Plain version of the tensor-core dW tile's row order: [C, G, M]
    int64, G = ceil(K / DW_OFFSETS) groups of offsets (one a block); each
    chunk's rows sorted by the Gray-code rank of their mask over the
    group's offsets (bit j: a reference at offset 4g + j), ties by row.
    Position p of (c, g) holds row order[c, g, p]."""
    C, K, M = lidx.shape
    G = -(-K // DW_OFFSETS)
    pad = lidx.new_full((C, G * DW_OFFSETS - K, M), -1)
    live = (torch.cat([lidx, pad], 1) >= 0).long().reshape(
        C, G, DW_OFFSETS, M)
    bits = torch.ones((), dtype=torch.long) << torch.arange(DW_OFFSETS)
    mask = (live * bits[:, None]).sum(2)                       # [C, G, M]
    return torch.sort(_gray_rank(mask), dim=2, stable=True).indices


def dw_k_steps(lidx: torch.Tensor, tiles: int = 1) -> Tuple[int, int]:
    """(ran, skipped): the (offset, k8 step) pairs the weight-gradient
    kernel's tensor-core tile runs and skips over lidx [C, K, M], each
    chunk's M / DW_STEP_ROWS steps over its rows in `dw_row_order`; a step
    runs where one of its rows has a reference at the offset. `tiles`
    (D tile, X tile) pairs repeat the same steps."""
    C, K, M = lidx.shape
    G = -(-K // DW_OFFSETS)
    order = dw_row_order(lidx)                                 # [C, G, M]
    pad = lidx.new_full((C, G * DW_OFFSETS - K, M), -1)
    rows = (torch.cat([lidx, pad], 1) >= 0).reshape(C, G, DW_OFFSETS, M)
    rows = torch.gather(rows, 3, order[:, :, None].expand_as(rows))
    ran = int(rows.reshape(C, G, DW_OFFSETS, M // DW_STEP_ROWS,
                           DW_STEP_ROWS).any(4).sum())
    return tiles * ran, tiles * (C * K * (M // DW_STEP_ROWS) - ran)


# ---------------------------------------------------------------------------
# Device half: kernel wrappers (CUDA tensors launch the kernel or raise)
# ---------------------------------------------------------------------------

def _check_launch(what: str, M: int, channels, tensors) -> None:
    if M % 32 or M > 128:
        raise ValueError(f"{what}: chunk size M={M} must be a multiple of 32 "
                         f"and at most 128")
    if any(c % 16 for c in channels):
        raise ValueError(f"{what}: channel counts {tuple(channels)} must be "
                         f"multiples of 16 (pad Cin with zero columns)")
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"{what}: tensors on several devices {devs}")


def _shape_error(what: str, **tensors) -> ValueError:
    return ValueError(f"{what}: inconsistent shapes " + ", ".join(
        f"{k} {tuple(v.shape)}" for k, v in tensors.items()))


def col_tile(cout: int, bf16: bool) -> int:
    """Output columns per block of the forward kernel. f32's FMA tile: 64.
    bf16 and f32's tensor-core tile (`f32_route`): the tile of 64, 96 or
    128 columns that covers cout with the least work, each tile counted as
    its columns plus 64 for staging the chunk's rows once more; ties go to
    the wider tile."""
    if not bf16:
        return 64
    return min((128, 96, 64), key=lambda nt: (-(-cout // nt) * (nt + 64),
                                              -nt))


def conv_splits(C: int, n_tiles: int, n_steps: int, sms: int) -> int:
    """Ranges of the forward's (Cin tile, offset) steps per (chunk, column
    tile): 1 where the C * n_tiles blocks give every SM two, else enough
    for two per SM, at most one per step. n_steps is the count at 64-column
    Cin tiles, a lower bound of the kernel's own."""
    blocks = C * n_tiles
    if blocks >= 2 * sms:
        return 1
    return max(1, min(n_steps, -(-2 * sms // blocks)))


def dwt_runs(C: int, K: int, cin: int, Ct: int, sms: int) -> int:
    """Runs of consecutive chunks of the weight-gradient kernel
    (`csrc/chunk_conv_bwd.cu`): enough for three blocks per SM over its
    (64 dense columns x 64 gathered columns x 4 offsets) tiles, and at most
    64 chunks (8192 rows) per run, so that no f32 accumulator sums more
    products before the runs are summed in order (a longer running sum
    loses accuracy: 46k rows measured 5e-5 of max|dW| on the H100). The
    fused route's dWt passes (C, K, cin, Ct) of its transpose plan, the dW
    route (C, K, cout, cin) of its forward plan; the rule is symmetric in
    the two widths."""
    tiles = -(-cin // 64) * -(-Ct // 64) * -(-K // 4)
    return max(1, min(C, max(-(-C // 64), -(-3 * sms // tiles))))


def dwt_values(C: int, K: int, cin: int, Ct: int, sms: int) -> int:
    """f32 values the weight-gradient kernel writes into device memory for
    one call of `dwt_runs`' arguments: each run's partial once (when there
    are several), then the result."""
    runs = dwt_runs(C, K, cin, Ct, sms)
    return (runs if runs > 1 else 0) * K * cin * Ct + K * cin * Ct


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def chunk_conv(feats: torch.Tensor, in_idx: torch.Tensor, lidx: torch.Tensor,
               weight: torch.Tensor) -> torch.Tensor:
    """Chunk convolution forward (no autograd: see `chunk_gather_conv`).
    The weight is cast to the feature dtype first (bf16 features -> bf16
    operands, f32 accumulation). CUDA tensors launch `csrc/chunk_conv.cu`
    (or raise); CPU tensors run `chunk_conv_plain`."""
    w = weight.to(feats.dtype)
    if not feats.is_cuda:
        return chunk_conv_plain(feats, in_idx, lidx, w)
    out = _run_chunk_conv("chunk_conv", feats, in_idx, lidx, w)
    chunk_conv.launches += 1
    return out


chunk_conv.launches = 0  # wrapper calls that launched the kernel
# f32 launches of the forward kernel by tile (`f32_route`), from every
# caller: the forward, and d_feats on both backward routes
chunk_conv.launches_f32_tc = 0
chunk_conv.launches_f32_fma = 0


def _run_chunk_conv(what, feats, in_idx, lidx, w,
                    route=None) -> torch.Tensor:
    """Launch the forward kernel (and, with split steps, its sum of
    partials) on CUDA tensors; the caller counts the launch, this counts
    an f32 one by tile. f32 takes the tile `f32_route` picks from the
    shapes; `route` ("tc" or "fma") is for tests and timing tools."""
    dt = feats.dtype
    kernels.require_cuda_input(feats, "feats", (torch.float32,
                                                torch.bfloat16), 2)
    kernels.require_cuda_input(in_idx, "in_idx", torch.int32, 2)
    kernels.require_cuda_input(lidx, "lidx", torch.int32, 3)
    kernels.require_cuda_input(w, "weight", dt, 3)
    N, cin = feats.shape
    C, U = in_idx.shape
    Cl, K, M = lidx.shape
    Kw, cin_w, cout = w.shape
    if Cl != C or Kw != K or cin_w != cin:
        raise _shape_error(what, feats=feats, in_idx=in_idx, lidx=lidx,
                           weight=w)
    _check_launch(what, M, (cin, cout), (feats, in_idx, lidx, w))
    bf = dt == torch.bfloat16
    if not bf:
        route = route or f32_route(cin, cout, M, K, U,
                                   _smem_optin(feats.device.index or 0))
        if route == "tc":
            out = _run_tc(what, feats, in_idx, lidx, w, tc_col_tile(
                cout, K, U, _smem_optin(feats.device.index or 0)))
            chunk_conv.launches_f32_tc += 1
            return out
        chunk_conv.launches_f32_fma += 1
    nt = col_tile(cout, bf)
    splits = conv_splits(C, -(-cout // nt), K * -(-cin // 64),
                         _sm_count(feats.device.index or 0))
    out = torch.empty((C * M, cout), dtype=dt, device=feats.device)
    part = (torch.empty((splits, C * M, cout), dtype=torch.float32,
                        device=feats.device) if splits > 1 else None)
    counts = None if bf else _counts_buffer(feats.device)
    with torch.cuda.device(feats.device):
        rc = kernels.load().occ_chunk_conv_fwd(
            feats.data_ptr(), N, cin, in_idx.data_ptr(), C, U,
            lidx.data_ptr(), K, M, w.data_ptr(), cout, nt, splits,
            None if part is None else part.data_ptr(), out.data_ptr(),
            int(bf), None if counts is None else counts.data_ptr(),
            kernels.stream_ptr(feats))
    if rc == -2:
        raise ValueError(f"{what}: no Cin tile of U={U}, Cin={cin}, K={K} "
                         f"({dt}) fits in shared memory")
    if rc == -4:
        raise RuntimeError(f"{what}: the tensor-map encoder "
                           f"(cuTensorMapEncodeTiled) is missing or refused "
                           f"the weight")
    kernels.check(rc, f"{what} kernel launch")
    return out


def _run_tc(what, feats, in_idx, lidx, w, nt) -> torch.Tensor:
    """The tensor-core f32 tile: W split once (`split_weight_tf32_plain`'s
    layout, on the device), then the kernel, over checked inputs."""
    N, cin = feats.shape
    C, U = in_idx.shape
    _, K, M = lidx.shape
    cout = w.shape[2]
    dev = feats.device
    wt = torch.empty((2, K, cout, -(-cin // 32) * 32), dtype=torch.float32,
                     device=dev)
    splits = conv_splits(C, -(-cout // nt), K * -(-cin // 64),
                         _sm_count(dev.index or 0))
    out = torch.empty((C * M, cout), dtype=torch.float32, device=dev)
    part = (torch.empty((splits, C * M, cout), dtype=torch.float32,
                        device=dev) if splits > 1 else None)
    counts = _counts_buffer(dev)
    lib = kernels.load()
    with torch.cuda.device(dev):
        stream = kernels.stream_ptr(feats)
        kernels.check(lib.occ_chunk_conv_tf32_split_w(
            w.data_ptr(), K, cin, cout, wt.data_ptr(), stream),
            f"{what} weight split")
        rc = lib.occ_chunk_conv_fwd_tf32(
            feats.data_ptr(), N, cin, in_idx.data_ptr(), C, U,
            lidx.data_ptr(), K, M, wt.data_ptr(), cout, nt, splits,
            None if part is None else part.data_ptr(), out.data_ptr(),
            None if counts is None else counts.data_ptr(), stream)
    if rc == -2:
        raise ValueError(f"{what}: the tensor-core tile of U={U}, K={K}, "
                         f"nt={nt} does not fit in shared memory")
    if rc == -4:
        raise RuntimeError(f"{what}: the tensor-map encoder "
                           f"(cuTensorMapEncodeTiled) is missing or refused "
                           f"the split weight")
    kernels.check(rc, f"{what} tensor-core kernel launch")
    return out


@functools.lru_cache(maxsize=None)
def _smem_optin(index: int) -> int:
    return torch.cuda.get_device_properties(index) \
        .shared_memory_per_block_optin


_COUNTS = {}  # device index -> the f32 forward's int64 [6] counters


def _counts_buffer(device: torch.device) -> Optional[torch.Tensor]:
    """The f32 forward's counters on a device, made at its first launch
    there (none while a CUDA graph is being captured: the buffer must
    outlive any graph)."""
    buf = _COUNTS.get(device.index)
    if buf is None and not torch.cuda.is_current_stream_capturing():
        buf = _COUNTS[device.index] = torch.zeros(6, dtype=torch.int64,
                                                  device=device)
    return buf


@dataclasses.dataclass(frozen=True)
class FwdCounts:
    """What the f32 forward kernel's blocks counted: the FMA tile's (Cin
    tile, offset, warp) steps run and skipped (`fwd_warp_steps` per call),
    thread 0's clock cycles building the row order and in the whole block
    (both tiles), and the tensor-core tile's (Cin tile, offset, 64-row
    group) steps run and skipped (`fwd_group_steps` per call)."""
    ran: int
    skipped: int
    order_cycles: int
    block_cycles: int
    group_ran: int = 0
    group_skipped: int = 0

    @property
    def skipped_share(self) -> float:
        total = self.ran + self.skipped
        return self.skipped / total if total else 0.0

    @property
    def group_skipped_share(self) -> float:
        total = self.group_ran + self.group_skipped
        return self.group_skipped / total if total else 0.0

    @property
    def order_share(self) -> float:
        """The row order's share of the blocks' cycles."""
        return (self.order_cycles / self.block_cycles if self.block_cycles
                else 0.0)


def fwd_counts(device, reset: bool = False) -> FwdCounts:
    """The f32 forward's counts on a CUDA device since its last reset (all
    zero before its first f32 launch), then zeroed with `reset`. Reads the
    device's counters, so it synchronises: not for a timed path."""
    device = torch.device(device)
    if device.index is None:
        device = torch.device(device.type, torch.cuda.current_device())
    buf = _counts_buffer(device)
    if buf is None:
        return FwdCounts(0, 0, 0, 0, 0, 0)
    got = FwdCounts(*buf.tolist())
    if reset:
        buf.zero_()
    return got


def fwd_cin_tile(cin: int, U: int, K: int) -> int:
    """The Cin tile the f32 forward kernel takes at these shapes on the
    current CUDA device (64, 32 or 16); ValueError where none fits."""
    tile = kernels.load().occ_chunk_conv_fwd_cin_tile(cin, U, K)
    if tile < 0:
        raise ValueError(f"no Cin tile of U={U}, Cin={cin}, K={K} (f32) "
                         f"fits in shared memory")
    return tile


def chunk_conv_bwd_fused(ct: torch.Tensor, t_in_idx: torch.Tensor,
                         t_lidx: torch.Tensor, w_t: torch.Tensor,
                         feats: torch.Tensor):
    """Fused chunk-conv backward over a transpose chunk plan:

        G_k[m]      = ct[t_in_idx[c, t_lidx[c,k,m]]]  (0 where t_lidx is -1)
        d_feats_c   = sum_k G_k @ w_t[k]        -> [C*M, Cin], feats.dtype
        dWt[k]      = sum_c feats_c^T @ G_k     -> [K, Cin, Ct], f32

    ct [N_ct, Ct], w_t [K, Ct, Cin] and feats [C*M, Cin] share the feature
    dtype. CUDA tensors launch the forward kernel of `csrc/chunk_conv.cu`
    over the transpose plan for d_feats and the dWt kernel of
    `csrc/chunk_conv_bwd.cu` (or raise); CPU tensors run
    `chunk_conv_bwd_fused_plain`. Both results are deterministic on the
    card: dWt is summed per run of chunks, then over the runs in order."""
    if not feats.is_cuda:
        return chunk_conv_bwd_fused_plain(ct, t_in_idx, t_lidx, w_t, feats)
    return _launch_bwd_fused(ct, t_in_idx, t_lidx, w_t, feats)


# wrapper calls that launched the kernels; `launches_kgrouped` counts those
# at shapes where the JAX package splits K into groups (TPU kernel #4
# rather than #3)
chunk_conv_bwd_fused.launches = 0
chunk_conv_bwd_fused.launches_kgrouped = 0


def _launch_bwd_fused(ct, t_in_idx, t_lidx, w_t, feats):
    dt = feats.dtype
    kernels.require_cuda_input(feats, "feats", (torch.float32,
                                                torch.bfloat16), 2)
    kernels.require_cuda_input(ct, "ct", dt, 2)
    n_ct, Ct = ct.shape
    C, U = t_in_idx.shape
    Cl, K, M = t_lidx.shape
    Kw, Ct_w, cin = w_t.shape
    if (Cl != C or Kw != K or Ct_w != Ct
            or tuple(feats.shape) != (C * M, cin)):
        raise _shape_error("chunk_conv_bwd_fused", ct=ct, t_in_idx=t_in_idx,
                           t_lidx=t_lidx, w_t=w_t, feats=feats)
    d_feats = _run_chunk_conv("chunk_conv_bwd_fused", ct, t_in_idx, t_lidx,
                              w_t)
    dwt = _run_dw("chunk_conv_bwd_fused", chunk_conv_bwd_fused, ct, t_in_idx,
                  t_lidx, feats, rows_gathered=False)
    chunk_conv_bwd_fused.launches += 1
    if 0 < fused_grouping(K, M, Ct, cin, U, feats.element_size()) < K:
        chunk_conv_bwd_fused.launches_kgrouped += 1
    return d_feats, dwt


def _run_dw(what, counted, x, in_idx, lidx, d, rows_gathered: bool,
            route=None) -> torch.Tensor:
    """Launch the weight-gradient kernel over checked inputs: P[k] =
    sum_c GX_k^T @ D_c with x [N_x, Cx] gathered through the plan and d
    [C*M, Cd] dense, written [K, Cx, Cd] (`rows_gathered`, the dW route)
    or [K, Cd, Cx] (the fused route's dWt), summed per run of chunks
    (`dwt_runs`) and then over the runs in order. f32 takes the tile
    `dw_route` picks from the shapes and counts the launch by tile on
    `counted` (`launches_f32_tc` / `_fma`); `route` ("tc" or "fma") is
    for tests and timing tools."""
    dt = x.dtype
    n_x, cx = x.shape
    C, U = in_idx.shape
    _, K, M = lidx.shape
    cd = d.shape[1]
    dev = x.device
    tc = False
    if dt == torch.float32:
        route = route or dw_route(cx, cd, K, U, _smem_optin(dev.index or 0))
        tc = route == "tc"
        if tc:
            counted.launches_f32_tc += 1
        else:
            counted.launches_f32_fma += 1
    # the rule is symmetric in the two widths
    runs = dwt_runs(C, K, cd, cx, _sm_count(dev.index or 0))
    shape = (K, cx, cd) if rows_gathered else (K, cd, cx)
    out = torch.empty(shape, dtype=torch.float32, device=dev)
    partial = (torch.empty((runs, *shape), dtype=torch.float32, device=dev)
               if runs > 1 else None)
    counts = _dw_counts_buffer(dev) if tc else None
    order = (torch.empty(C * -(-K // DW_OFFSETS) * dw_order_record_bytes(M),
                         dtype=torch.uint8, device=dev) if tc else None)
    entry = (kernels.load().occ_chunk_conv_dw if rows_gathered
             else kernels.load().occ_chunk_conv_dwt)
    with torch.cuda.device(dev):
        rc = entry(x.data_ptr(), n_x, cx, in_idx.data_ptr(), C, U,
                   lidx.data_ptr(), K, M, d.data_ptr(), cd, runs,
                   None if partial is None else partial.data_ptr(),
                   out.data_ptr(), int(dt == torch.bfloat16), int(tc),
                   None if order is None else order.data_ptr(),
                   None if counts is None else counts.data_ptr(),
                   kernels.stream_ptr(x))
    if rc == -2:
        raise ValueError(f"{what}: no {'tensor-core block' if tc else 'tile'}"
                         f" of U={U}, {cx} gathered columns ({dt}) fits in "
                         f"shared memory")
    kernels.check(rc, f"{what} weight-gradient kernel launch")
    return out


def chunk_conv_dw(feats: torch.Tensor, in_idx: torch.Tensor,
                  lidx: torch.Tensor, ct: torch.Tensor) -> torch.Tensor:
    """Weight gradient over the FORWARD chunk plan:

        dW[k] = sum_c G_k^T @ ct_c,  G_k[m] = feats[in_idx[c, lidx[c,k,m]]]

    feats [N, Cin] and ct [C*M, Cout] in one dtype -> [K, Cin, Cout] f32.
    CUDA tensors launch the weight-gradient kernel of
    `csrc/chunk_conv_bwd.cu` with feats as its gathered operand and ct as
    its dense one (the dWt kernel's roles swapped), summed per run of
    chunks (`dwt_runs`) and then over the runs in order, so dW is
    deterministic (or raise); CPU tensors run `chunk_conv_dw_plain`."""
    if not feats.is_cuda:
        return chunk_conv_dw_plain(feats, in_idx, lidx, ct)
    return _launch_dw(feats, in_idx, lidx, ct)


chunk_conv_dw.launches = 0  # kernel launches
# f32 launches of the weight-gradient kernel by tile (`dw_route`): the dW
# route's here, the fused route's dWt on `chunk_conv_bwd_fused`
chunk_conv_dw.launches_f32_tc = 0
chunk_conv_dw.launches_f32_fma = 0
chunk_conv_bwd_fused.launches_f32_tc = 0
chunk_conv_bwd_fused.launches_f32_fma = 0


def _launch_dw(feats, in_idx, lidx, ct) -> torch.Tensor:
    dt = feats.dtype
    kernels.require_cuda_input(feats, "feats", (torch.float32,
                                                torch.bfloat16), 2)
    kernels.require_cuda_input(in_idx, "in_idx", torch.int32, 2)
    kernels.require_cuda_input(lidx, "lidx", torch.int32, 3)
    kernels.require_cuda_input(ct, "ct", dt, 2)
    N, cin = feats.shape
    C, U = in_idx.shape
    Cl, K, M = lidx.shape
    cout = ct.shape[1]
    if Cl != C or ct.shape[0] != C * M:
        raise _shape_error("chunk_conv_dw", feats=feats, in_idx=in_idx,
                           lidx=lidx, ct=ct)
    _check_launch("chunk_conv_dw", M, (cin, cout), (feats, in_idx, lidx, ct))
    dw = _run_dw("chunk_conv_dw", chunk_conv_dw, feats, in_idx, lidx, ct,
                 rows_gathered=True)
    chunk_conv_dw.launches += 1
    return dw


_DW_COUNTS = {}  # device index -> the tensor-core dW tile's int64 [4]


def _dw_counts_buffer(device: torch.device) -> Optional[torch.Tensor]:
    """The tensor-core dW tile's counters on a device, made at its first
    launch there (none while a CUDA graph is being captured); a normal
    tensor even when that launch runs under `torch.inference_mode`, so
    that `dw_counts` can reset it outside."""
    buf = _DW_COUNTS.get(device.index)
    if buf is None and not torch.cuda.is_current_stream_capturing():
        with torch.inference_mode(False):
            buf = _DW_COUNTS[device.index] = torch.zeros(
                4, dtype=torch.int64, device=device)
    return buf


@dataclasses.dataclass(frozen=True)
class DwCounts:
    """What the weight-gradient kernel's tensor-core blocks counted: the
    (offset, k8 step) pairs run and skipped (`dw_k_steps` per call), and
    thread 0's clock cycles staging the chunks (the X rows in, the D rows
    split; from each chunk's first barrier to its second) and in the
    whole block."""
    ran: int
    skipped: int
    stage_cycles: int
    block_cycles: int

    @property
    def skipped_share(self) -> float:
        total = self.ran + self.skipped
        return self.skipped / total if total else 0.0

    @property
    def stage_share(self) -> float:
        """Staging's share of the blocks' cycles."""
        return (self.stage_cycles / self.block_cycles if self.block_cycles
                else 0.0)


def dw_counts(device, reset: bool = False) -> DwCounts:
    """The tensor-core dW tile's counts on a CUDA device since its last
    reset (all zero before its first launch), then zeroed with `reset`.
    Reads the device's counters, so it synchronises: not for a timed
    path."""
    device = torch.device(device)
    if device.index is None:
        device = torch.device(device.type, torch.cuda.current_device())
    buf = _dw_counts_buffer(device)
    if buf is None:
        return DwCounts(0, 0, 0, 0)
    got = DwCounts(*buf.tolist())
    if reset:
        buf.zero_()
    return got


# ---------------------------------------------------------------------------
# Backward route and the autograd entry points
# ---------------------------------------------------------------------------

# The JAX package's budget rules for its backward (`_bwd_fused_eligible`,
# `_bwd_fused_v2_grouping`), kept with their numbers so that the port takes
# the same route per convolution as the reference. The 13 MB is the TPU's
# scoped VMEM budget (16 MB less headroom), not a property of the H100:
# chip_smoke.py times both routes at every bench shape so that a later
# change can retune the rule from the card's numbers.
_TPU_VMEM_BUDGET = 13 * 1024 * 1024


def fused_grouping(K: int, M: int, Ct: int, cin: int, U: int,
                   esize: int) -> int:
    """Route of the backward of a conv whose transpose plan stages U rows
    of Ct cotangent channels per chunk of M rows, into d_feats of cin
    channels, in elements of esize bytes: K where the TPU's fused kernel
    holds the whole working set (`_pallas_bwd_fused`, TPU kernel #3); a
    divisor G < K where it fits in K/G offset groups
    (`_pallas_bwd_fused_v2`, #4); 0 where neither fits and the backward
    takes the dW route (`_pallas_dw` plus the forward kernel on the
    transpose plan, #5). The port's fused kernel needs no grouping: G only
    names the route."""
    scratch = M * K * Ct * esize
    wt = 2 * K * Ct * cin * esize
    dw = cin * K * Ct * 4
    if scratch + wt + dw + M * cin * esize * 3 <= _TPU_VMEM_BUDGET:
        return K
    for d in range(K, 0, -1):
        if K % d:
            continue
        cell = (dw
                + M * d * Ct * esize        # staged Gct
                + 2 * d * Ct * cin * esize  # weight block, double-buffered
                + 2 * U * Ct * esize        # gct block
                + 3 * M * cin * esize       # feats + d_feats blocks
                + M * cin * 4)              # d_feats accumulator
        if cell <= _TPU_VMEM_BUDGET:
            return d
    return 0


def backward_grouping(n_in: int, cin: int, cout: int, t_in_idx, t_lidx,
                      esize: int) -> int:
    """`fused_grouping` of a convolution with n_in input rows of cin
    channels, cout output channels and transpose plan (t_in_idx, t_lidx),
    or 0 where the transpose plan's chunks do not tile the input rows (the
    fused kernel writes d_feats chunk by chunk). Only shapes are read."""
    Ct_chunks, K, Mt = t_lidx.shape
    if Ct_chunks * Mt != n_in:
        return 0
    return fused_grouping(K, Mt, cout, cin, t_in_idx.shape[1], esize)


def sub_conv_backward(ct: torch.Tensor, feats: torch.Tensor,
                      in_idx: torch.Tensor, lidx: torch.Tensor,
                      weight: torch.Tensor, fused: bool):
    """(d_feats, dW) of `chunk_gather_conv` (the JAX `_make_sub_conv`
    backward). A submanifold map is self-transpose under offset reversal
    (nbr[r,k] = i <=> nbr[i,K-1-k] = r), so the transpose plan is the
    forward plan with W_rev_t[k] = W[K-1-k]^T, and the dW that offset k of
    the fused kernel produces belongs to W[K-1-k]. `fused` picks the fused
    kernel, else the dW kernel plus the forward kernel on the plan."""
    dt = feats.dtype
    ctc = ct.to(dt).contiguous()
    w_rev_t = weight.flip(0).transpose(1, 2).to(dt).contiguous()
    if fused:
        d_feats, dwt = chunk_conv_bwd_fused(ctc, in_idx, lidx, w_rev_t, feats)
        d_w = dwt.flip(0)
    else:
        d_w = chunk_conv_dw(feats, in_idx, lidx, ctc)
        d_feats = chunk_conv(ctc, in_idx, lidx, w_rev_t)
    return d_feats, d_w.to(weight.dtype)


def t_conv_backward(ct: torch.Tensor, feats: torch.Tensor,
                    in_idx: torch.Tensor, lidx: torch.Tensor,
                    t_in_idx: torch.Tensor, t_lidx: torch.Tensor,
                    weight: torch.Tensor, fused: bool):
    """(d_feats, dW) of `chunk_gather_conv_t` (the JAX `_make_t_conv`
    backward). The pairing is same-k: fwd_table[r,k] = i <=>
    t_table[i,k] = r, so d_feats = sum_k Gct_k @ W[k]^T over the transpose
    plan with no reversal, and offset k's dW belongs to W[k]."""
    dt = feats.dtype
    ctc = ct.to(dt).contiguous()
    w_t = weight.transpose(1, 2).to(dt).contiguous()
    if fused:
        d_feats, d_w = chunk_conv_bwd_fused(ctc, t_in_idx, t_lidx, w_t, feats)
    else:
        d_w = chunk_conv_dw(feats, in_idx, lidx, ctc)
        d_feats = chunk_conv(ctc, t_in_idx, t_lidx, w_t)
    return d_feats, d_w.to(weight.dtype)


def _fused(feats, weight, t_in_idx, t_lidx) -> bool:
    _, cin, cout = weight.shape
    return backward_grouping(feats.shape[0], cin, cout, t_in_idx, t_lidx,
                             feats.element_size()) > 0


class _SubConv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, feats, in_idx, lidx, weight):
        ctx.save_for_backward(feats, in_idx, lidx, weight)
        return chunk_conv(feats, in_idx, lidx, weight)

    @staticmethod
    def backward(ctx, ct):
        feats, in_idx, lidx, weight = ctx.saved_tensors
        d_feats, d_w = sub_conv_backward(
            ct, feats, in_idx, lidx, weight,
            _fused(feats, weight, in_idx, lidx))
        return d_feats, None, None, d_w


class _TConv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, feats, in_idx, lidx, t_in_idx, t_lidx, weight):
        ctx.save_for_backward(feats, in_idx, lidx, t_in_idx, t_lidx, weight)
        return chunk_conv(feats, in_idx, lidx, weight)

    @staticmethod
    def backward(ctx, ct):
        feats, in_idx, lidx, t_in_idx, t_lidx, weight = ctx.saved_tensors
        d_feats, d_w = t_conv_backward(
            ct, feats, in_idx, lidx, t_in_idx, t_lidx, weight,
            _fused(feats, weight, t_in_idx, t_lidx))
        return d_feats, None, None, None, None, d_w


def chunk_gather_conv(feats: torch.Tensor, in_idx: torch.Tensor,
                      lidx: torch.Tensor, weight: torch.Tensor
                      ) -> torch.Tensor:
    """out[r] = sum_k feats[nbr[r,k]] @ weight[k] over the chunk plan of a
    SUBMANIFOLD map (self-transpose under offset reversal), differentiable
    in feats and weight (`sub_conv_backward`). feats [C*M, Cin], weight
    [K, Cin, Cout] (any float dtype; cast to the feature dtype, its
    gradient comes back in its own dtype)."""
    return _SubConv.apply(feats, in_idx, lidx, weight)


def chunk_gather_conv_t(feats: torch.Tensor, in_idx: torch.Tensor,
                        lidx: torch.Tensor, t_in_idx: torch.Tensor,
                        t_lidx: torch.Tensor, weight: torch.Tensor
                        ) -> torch.Tensor:
    """Chunked conv with an EXPLICIT transpose chunk plan: the strided
    convolution (forward plan = child chunks, transpose = up chunks) and
    the deconvolution (the reverse), where input and output rows differ.
    Differentiable in feats and weight (`t_conv_backward`)."""
    return _TConv.apply(feats, in_idx, lidx, t_in_idx, t_lidx, weight)
