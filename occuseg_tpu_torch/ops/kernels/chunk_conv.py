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
The backward has two routes, each over kernels of `csrc/chunk_conv_bwd.cu`:
`chunk_conv_bwd_fused` computes d_feats and dW from one staging of the
cotangent over the TRANSPOSE plan; the dW route runs `chunk_conv_dw` over
the forward plan and the forward kernel over the transpose plan.
`fused_grouping` picks the route from static shapes with the JAX
package's rule. `chunk_gather_conv` (submanifold: the plan is its own
transpose under offset reversal) and `chunk_gather_conv_t` (a transition
with its explicit transpose plan) are the autograd entry points. On CUDA
tensors every wrapper launches its kernel (or raises); on CPU tensors it
runs its plain version.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Optional, Tuple

import numpy as np
import torch

from occuseg_tpu_torch import native
from occuseg_tpu_torch.core.topology import ChunkPlan
from occuseg_tpu_torch.ops import kernels

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
                             U_up: int = None, tiers=(1.0, 1.3, 1.7)):
    """Attach ChunkPlans to every level and transition of a host plan.

    U budgets are static tables (an int or one per level). Escalation
    follows the JAX package: first a submanifold level that overflows
    retries with its own U scaled by 1.3; if a transition overflows or
    1.3 is not enough, the whole plan is scaled by each later tier in
    turn. Under the last tier, maps that still overflow keep
    `chunks=None`, and a forward over them raises. The plan returned
    records the tier in `chunk_tier`.

    A blocked multi-scene plan (`native/blocked.py`, vector
    `num_active`) is planned as it stands: its per-scene caps are
    multiples of M, so no chunk straddles two scenes, and each chunk's
    input list is the JAX package's scene-local list shifted to global
    rows."""
    n_lvl = len(plan.levels)
    factors = [1.0] * n_lvl
    for _ in range(n_lvl + 1):
        out, over_l, over_t = _augment_once(plan, M, U, U_child, U_up,
                                            (tuple(factors), 1.0, 1.0),
                                            warn=False)
        if out is not None:
            lbl = ",".join(f"L{li}x{f:.2f}" for li, f in enumerate(factors)
                           if f != 1.0)
            return dataclasses.replace(out, chunk_tier=lbl or 1.0)
        fresh = [li for li in over_l if factors[li] == 1.0]
        if over_t or not fresh:
            break  # a transition overflowed, or 1.3 was not enough
        for li in fresh:
            factors[li] = 1.3

    for f in tiers[1:-1]:
        out, _, _ = _augment_once(plan, M, U, U_child, U_up, f, warn=False)
        if out is not None:
            return dataclasses.replace(out, chunk_tier=float(f))
    out, _, _ = _augment_once(plan, M, U, U_child, U_up, tiers[-1],
                              warn=True)
    return dataclasses.replace(out, chunk_tier=float(tiers[-1]))


def _tier3(f):
    """Normalize a tier spec (float, or (f_lvl, f_child, f_up))."""
    return (f, f, f) if isinstance(f, (int, float)) else tuple(f)


def _scale1(u: int, f: float) -> int:
    return u if f == 1.0 else -(-int(u * f) // 32) * 32


def _scale_u(u, f):
    if isinstance(u, int):
        return _scale1(u, f)
    return tuple(_scale1(x, f) for x in u)


def _augment_once(plan, M, U, U_child, U_up, tier_f, warn):
    """One escalation attempt: (plan or None, overflowed levels,
    overflowed transitions). With warn=False an overflow returns no plan;
    with warn=True overflowing maps keep chunks=None."""
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
                     lidx: torch.Tensor, weight: torch.Tensor
                     ) -> torch.Tensor:
    """Plain PyTorch chunk conv (the JAX `_dechunked_conv` math): gather
    each chunk's rows through lidx, zero the -1 references, then one f32
    einsum. feats [N, Cin], weight [K, Cin, Cout] -> [C*M, Cout] in
    feats.dtype."""
    C, K, M = lidx.shape
    g = _gather_chunks(feats, in_idx, lidx)
    out = torch.einsum("ckmi,kio->cmo", g.float(), weight.float())
    return out.reshape(C * M, weight.shape[2]).to(feats.dtype)


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
                        lidx: torch.Tensor, ct: torch.Tensor) -> torch.Tensor:
    """Plain version of `chunk_conv_dw`: dW [K, Cin, Cout] f32."""
    C, K, M = lidx.shape
    g = _gather_chunks(feats, in_idx, lidx).float()           # [C, K, M, Cin]
    return torch.einsum("ckmi,cmo->kio", g, ct.reshape(C, M, -1).float())


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


def chunk_conv(feats: torch.Tensor, in_idx: torch.Tensor, lidx: torch.Tensor,
               weight: torch.Tensor) -> torch.Tensor:
    """Chunk convolution forward (no autograd: see `chunk_gather_conv`).
    The weight is cast to the feature dtype first (bf16 features -> bf16
    operands, f32 accumulation). CUDA tensors launch `csrc/chunk_conv.cu`
    (or raise); CPU tensors run `chunk_conv_plain`."""
    w = weight.to(feats.dtype)
    if not feats.is_cuda:
        return chunk_conv_plain(feats, in_idx, lidx, w)
    return _launch_chunk_conv(feats, in_idx, lidx, w)


chunk_conv.launches = 0  # kernel launches (see _launch_chunk_conv)


def _launch_chunk_conv(feats, in_idx, lidx, w) -> torch.Tensor:
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
        raise _shape_error("chunk_conv", feats=feats, in_idx=in_idx,
                           lidx=lidx, weight=w)
    _check_launch("chunk_conv", M, (cin, cout), (feats, in_idx, lidx, w))
    out = torch.empty((C * M, cout), dtype=dt, device=feats.device)
    with torch.cuda.device(feats.device):
        rc = kernels.load().occ_chunk_conv_fwd(
            feats.data_ptr(), N, cin, in_idx.data_ptr(), C, U,
            lidx.data_ptr(), K, M, w.data_ptr(), cout, out.data_ptr(),
            int(dt == torch.bfloat16), kernels.stream_ptr(feats))
    if rc == -2:
        raise ValueError(f"chunk_conv: no Cin tile of U={U}, Cin={cin}, "
                         f"K={K} ({dt}) fits in shared memory")
    kernels.check(rc, "chunk_conv kernel launch")
    chunk_conv.launches += 1
    return out


def chunk_conv_bwd_fused(ct: torch.Tensor, t_in_idx: torch.Tensor,
                         t_lidx: torch.Tensor, w_t: torch.Tensor,
                         feats: torch.Tensor):
    """Fused chunk-conv backward over a transpose chunk plan:

        G_k[m]      = ct[t_in_idx[c, t_lidx[c,k,m]]]  (0 where t_lidx is -1)
        d_feats_c   = sum_k G_k @ w_t[k]        -> [C*M, Cin], feats.dtype
        dWt[k]      = sum_c feats_c^T @ G_k     -> [K, Cin, Ct], f32

    ct [N_ct, Ct], w_t [K, Ct, Cin] and feats [C*M, Cin] share the feature
    dtype. CUDA tensors launch `csrc/chunk_conv_bwd.cu` (or raise); CPU
    tensors run `chunk_conv_bwd_fused_plain`. On the card dWt is summed
    with f32 atomics, so it is not bitwise deterministic."""
    if not feats.is_cuda:
        return chunk_conv_bwd_fused_plain(ct, t_in_idx, t_lidx, w_t, feats)
    return _launch_bwd_fused(ct, t_in_idx, t_lidx, w_t, feats)


# kernel launches; `launches_kgrouped` counts those at shapes where the
# JAX package splits K into groups (TPU kernel #4 rather than #3)
chunk_conv_bwd_fused.launches = 0
chunk_conv_bwd_fused.launches_kgrouped = 0


def _launch_bwd_fused(ct, t_in_idx, t_lidx, w_t, feats):
    dt = feats.dtype
    kernels.require_cuda_input(feats, "feats", (torch.float32,
                                                torch.bfloat16), 2)
    kernels.require_cuda_input(ct, "ct", dt, 2)
    kernels.require_cuda_input(t_in_idx, "t_in_idx", torch.int32, 2)
    kernels.require_cuda_input(t_lidx, "t_lidx", torch.int32, 3)
    kernels.require_cuda_input(w_t, "w_t", dt, 3)
    n_ct, Ct = ct.shape
    C, U = t_in_idx.shape
    Cl, K, M = t_lidx.shape
    Kw, Ct_w, cin = w_t.shape
    if (Cl != C or Kw != K or Ct_w != Ct
            or tuple(feats.shape) != (C * M, cin)):
        raise _shape_error("chunk_conv_bwd_fused", ct=ct, t_in_idx=t_in_idx,
                           t_lidx=t_lidx, w_t=w_t, feats=feats)
    _check_launch("chunk_conv_bwd_fused", M, (cin, Ct),
                  (ct, t_in_idx, t_lidx, w_t, feats))
    d_feats = torch.empty((C * M, cin), dtype=dt, device=feats.device)
    dwt = torch.zeros((K, cin, Ct), dtype=torch.float32, device=feats.device)
    with torch.cuda.device(feats.device):
        rc = kernels.load().occ_chunk_conv_bwd_fused(
            ct.data_ptr(), n_ct, Ct, t_in_idx.data_ptr(), C, U,
            t_lidx.data_ptr(), K, M, w_t.data_ptr(), feats.data_ptr(), cin,
            d_feats.data_ptr(), dwt.data_ptr(), int(dt == torch.bfloat16),
            kernels.stream_ptr(feats))
    if rc == -2:
        raise ValueError(f"chunk_conv_bwd_fused: no Ct tile of U={U}, "
                         f"Ct={Ct}, K={K} ({dt}) fits in shared memory")
    kernels.check(rc, "chunk_conv_bwd_fused kernel launch")
    chunk_conv_bwd_fused.launches += 1
    if 0 < fused_grouping(K, M, Ct, cin, U, feats.element_size()) < K:
        chunk_conv_bwd_fused.launches_kgrouped += 1
    return d_feats, dwt


def chunk_conv_dw(feats: torch.Tensor, in_idx: torch.Tensor,
                  lidx: torch.Tensor, ct: torch.Tensor) -> torch.Tensor:
    """Weight gradient over the FORWARD chunk plan:

        dW[k] = sum_c G_k^T @ ct_c,  G_k[m] = feats[in_idx[c, lidx[c,k,m]]]

    feats [N, Cin] and ct [C*M, Cout] in one dtype -> [K, Cin, Cout] f32.
    CUDA tensors launch `csrc/chunk_conv_bwd.cu` (or raise; deterministic);
    CPU tensors run `chunk_conv_dw_plain`."""
    if not feats.is_cuda:
        return chunk_conv_dw_plain(feats, in_idx, lidx, ct)
    return _launch_dw(feats, in_idx, lidx, ct)


chunk_conv_dw.launches = 0  # kernel launches


def _dw_ranges(C: int, K: int, cin: int, cout: int, device) -> int:
    """Chunk ranges per dW tile: enough for four blocks per SM, and at
    most 64 chunks (8192 rows) per range, so that no f32 accumulator sums
    more products than that before the partials are summed in order (a
    longer running sum loses accuracy: 46k rows measured 5e-5 of max|dW|
    on the H100)."""
    tiles = -(-cin // 64) * -(-cout // 64) * K
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return max(1, min(C, max(-(-C // 64), -(-4 * sms // tiles))))


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
    ranges = _dw_ranges(C, K, cin, cout, feats.device)
    dw = torch.empty((K, cin, cout), dtype=torch.float32, device=feats.device)
    partial = (torch.empty((ranges, K, cin, cout), dtype=torch.float32,
                           device=feats.device) if ranges > 1 else None)
    with torch.cuda.device(feats.device):
        rc = kernels.load().occ_chunk_conv_dw(
            feats.data_ptr(), N, cin, in_idx.data_ptr(), C, U,
            lidx.data_ptr(), K, M, ct.data_ptr(), cout, ranges,
            None if partial is None else partial.data_ptr(), dw.data_ptr(),
            int(dt == torch.bfloat16), kernels.stream_ptr(feats))
    kernels.check(rc, "chunk_conv_dw kernel launch")
    chunk_conv_dw.launches += 1
    return dw


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
