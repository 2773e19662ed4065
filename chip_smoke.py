#!/usr/bin/env python3
"""Smoke run of the PyTorch port (occuseg_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout; needs one CUDA card, `nvcc` and `g++`,
and no network. Phases (any failure exits non-zero):

0. build: the CUDA kernels (nvcc, sm_90a, one process per source) and the
   C++ host planner are compiled from the checkout's sources.
1. kernels: on the benchmark scene's host plan (200k points, extent 512,
   seed 0), every kernel against its plain PyTorch version on the card
   with random inputs (max error, CUDA-event times, the bound from this
   run's inputs): the chunk-conv forward at all 33 convolutions of the
   m=64 LearningBWDenseUNet in bf16 (and a subset in f32); at the same 33
   convolutions both backward routes, the fused backward (d_feats + dW
   over the transpose plan) and the dW route (dW kernel over the forward
   plan plus the forward kernel on the transpose plan), each checked and
   timed, the route the step takes marked; the segment sum at the
   InputLayer shape [262144, 3] and the OutputLayer backward's
   [262144, 64]; the gather conv at levels L3-L5 beside the chunk conv
   (both also timed inside a CUDA graph); the BCE radius at P=262144,
   I=128 and 64, on random ids and on the CLI's runs of one instance
   (back to back and in a CUDA graph); the BCE sums and backward at the
   training CLI's shape (P=262144, I=128, E=64) and the bench scene's
   (I=64), beside the port's chain of calls for the same loss. The dW
   kernel, the segment sum, the BCE radius, sums and backward and the
   gather conv are launched again and must give the same bits; the
   segment sum and its `index_add` are also timed inside a CUDA graph
   (no host cost per launch).
2. parity: a mid-size scene (20k points) through the full-width model in
   f32 on the card (kernels) and on the CPU (plain versions): the 7
   outputs of an eval forward, then one training step's loss parts,
   gradients and new BN statistics; then, on the card, the classification
   loss and its gradients with the BCE kernels against the chain.
3. slice: three requests (benchmark scenes, seeds 0-2) through
   prepare_scene + Predictor, bf16 compute, f32 params, seeded non-trivial
   BN statistics: plan ms, forward ms, voxels/s; every level and
   transition chunked, outputs finite and in the original point order,
   and the kernels launched 33 + 1 times per request.
4. train: prepare_batch + Trainer.step on the benchmark scenes (seeds
   0-2), full width, bf16 compute, f32 params, Adam: host plan ms, step
   ms, voxels/s, finite loss parts, every parameter moved, the launches
   per step that the backward route predicts from the plan's shapes
   (37 / 29 / 4 / 2 at tier 1.0), peak device memory, and one profiled
   step's device time by kernel.
5. loop: the training CLI (`occuseg_tpu_torch.train.cli.main`) at m=64
   with OCC_PALLAS_BCE=1 on blocked 4-scene batches from 4 plan threads:
   first the 33 f32 convolutions of one such plan against their plain
   versions (forward and both backward routes, dW repeated bitwise),
   then one epoch with its
   launch counts, checkpoint and semantic eval, the plan upload pageable
   against pinned, a profiled step, and a resume from the checkpoint.

The last line is {"ok": true, "device": {...}}; the line before it is the
per-kernel JSON summary.
"""

from __future__ import annotations

import collections
import copy
import json
import os
import subprocess
import sys
import tempfile
import time

import torch

N_PLANES = (64, 128, 192, 256, 320, 384)
BENCH_CAPS = (196_608, 139_264, 63_488, 17_408, 4_096, 1_024)
BENCH_P_CAP = 262_144
BENCH_INSTANCES = 64
MID_CAPS = (16_128, 8_448, 2_688, 768, 256, 128)
MID_P_CAP = 24_576

# bf16 tolerance: both sides take the same bf16 inputs and accumulate in
# f32, so they differ only by f32 summation order before the final
# rounding to bf16; that can move a result by one bf16 ulp (2^-8 of its
# magnitude, 3.9e-3). 1e-2 x max|out| allows ~2.5 ulps at the largest
# output and fails on any indexing or masking error, which is O(max|out|).
BF16_TOL = 1e-2
# f32: exact products, sums in another order over K*Cin <= 17280 terms
F32_TOL = 1e-5
# dW is f32 for bf16 and f32 inputs alike: exact products, sums over up to
# ~200k rows in another order (per run of at most 64 chunks, then over the
# runs), against max|dW|
DW_TOL = 1e-4
# card (kernels, f32) vs CPU (plain versions, f32) through the whole model:
# ~30 chained layers, each adding summation-order error of ~1e-6 relative
PARITY_TOL = 1e-3
# a training step's gradients, card vs CPU. The step's gradients are
# ill-conditioned: on the CPU alone, a 1e-6 relative perturbation of the
# input features moves single gradient tensors by up to 9.3e-3 of their
# max and the whole gradient by 2.3e-4 of its norm: BN-ReLU units near 0
# flip, and the classification loss's [P, I] distances |a|^2 + |b|^2 - 2ab
# cancel near a centre, where the square root's derivative amplifies
# rounding. The card's step is deterministic (every kernel sums in a fixed
# order), and it differs from the CPU's by forward rounding at ~1e-6:
# measured on the H100 (with the first chunk-conv kernels) at 6.9e-4 of a
# tensor's max and 6.1e-6 of the norm, identical in repeated runs. The
# bounds are five times the CPU's own sensitivity: 5e-2 of each tensor's
# max (plus a floor for the embedding heads' near-cancelling
# bias gradients) and 1e-3 of the norm. An indexing or pairing error is
# O(1); the kernel phase holds each kernel tightly.
GRAD_GLOBAL_TOL = 1e-3
GRAD_TOL = 5e-2
GRAD_FLOOR = 1e-5

# H100 SXM peaks (NVIDIA data sheet, dense, 700 W): bf16 tensor cores,
# f32 outside them, HBM3
PEAK_BF16 = 989e12
PEAK_F32 = 67e12
PEAK_BYTES = 3.35e12

Conv = collections.namedtuple(
    "Conv", "label chunks t_chunks n_in n_act cin cout n_out n_out_act")


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def cuda_ms(fn, reps: int) -> float:
    """Mean ms per call over `reps` calls after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(flops: float, nbytes: float, peak_flops: float = PEAK_BF16):
    """(least ms, "operations" or "bytes"): the larger of the operations
    over the card's peak rate and the bytes over its memory rate."""
    t_op, t_by = flops / peak_flops, nbytes / PEAK_BYTES
    return 1e3 * max(t_op, t_by), ("operations" if t_op >= t_by else "bytes")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def conv_calls(plan, n_planes, in_features=3):
    """The chunk convolutions of one m=64 UNet forward, in order, each with
    its forward and transpose chunk plans, input and output rows (cap and
    active) and channels. Cin is as the kernel sees it (the first conv's
    3 padded to 16)."""
    caps = [l.cap for l in plan.levels]
    act = [l.num_active for l in plan.levels]
    lv = plan.levels
    calls = [Conv("sub L0", lv[0].chunks, lv[0].chunks, caps[0], act[0],
                  in_features + (-in_features) % 16, n_planes[0], caps[0],
                  act[0])]

    def sub(label, l, cin, cout):
        calls.append(Conv(label, lv[l].chunks, lv[l].chunks, caps[l], act[l],
                          cin, cout, caps[l], act[l]))

    def level(l):
        p = n_planes[l]
        for name in ("enc0.conv1", "enc0.conv2"):
            sub(f"{name} L{l}", l, p, p)
        if l + 1 == len(n_planes):
            return
        tr = plan.transitions[l]
        calls.append(Conv(f"down_conv L{l}->L{l + 1}", tr.child_chunks,
                          tr.up_chunks, caps[l], act[l], p, n_planes[l + 1],
                          caps[l + 1], act[l + 1]))
        level(l + 1)
        calls.append(Conv(f"up_conv L{l + 1}->L{l}", tr.up_chunks,
                          tr.child_chunks, caps[l + 1], act[l + 1],
                          n_planes[l + 1], p, caps[l], act[l]))
        sub(f"dec0.conv1 L{l}", l, 2 * p, p)
        sub(f"dec0.conv2 L{l}", l, p, p)

    level(0)
    return calls


def route_of(conv, esize: int) -> str:
    """The backward route the port takes for a convolution, named after
    the TPU kernel it stands in for: "#3" fused, "#4" fused where the JAX
    package splits K, "#5" the dW route."""
    from occuseg_tpu_torch.ops.kernels import chunk_conv as cc
    K = conv.t_chunks.lidx.shape[1]
    g = cc.backward_grouping(conv.n_in, conv.cin, conv.cout,
                             conv.t_chunks.in_idx, conv.t_chunks.lidx, esize)
    return "#3" if g == K else ("#4" if g else "#5")


def predicted_launches(plan, esize: int = 2, bce: bool = False) -> dict:
    """Kernel launches of one training step on `plan` with activations of
    `esize` bytes, from the backward route of each convolution; the
    segment sum runs twice where the plan has the sorted point layout, the
    BCE kernels once each with `bce`."""
    routes = collections.Counter(route_of(c, esize)
                                 for c in conv_calls(plan, N_PLANES))
    seg = 2 if plan.vox_seg is not None else 0
    return {"chunk_conv": 33 + routes["#5"],
            "chunk_conv_bwd_fused": routes["#3"] + routes["#4"],
            "chunk_conv_bwd_fused_kgrouped": routes["#4"],
            "chunk_conv_dw": routes["#5"], "blocked_segment_sum": seg,
            "bce_radius": int(bce), "bce_fwd": int(bce),
            "bce_bwd": int(bce), "gather_conv": 0}


def _counters():
    """(name, wrapper, attribute) of every kernel launch counter."""
    from occuseg_tpu_torch.ops.kernels import bce_loss
    from occuseg_tpu_torch.ops.kernels import chunk_conv as cc
    from occuseg_tpu_torch.ops.kernels import gather_conv as gc
    from occuseg_tpu_torch.ops.kernels import segsum
    return (("chunk_conv", cc.chunk_conv, "launches"),
            ("chunk_conv_bwd_fused", cc.chunk_conv_bwd_fused, "launches"),
            ("chunk_conv_bwd_fused_kgrouped", cc.chunk_conv_bwd_fused,
             "launches_kgrouped"),
            ("chunk_conv_dw", cc.chunk_conv_dw, "launches"),
            ("blocked_segment_sum", segsum.blocked_segment_sum, "launches"),
            ("bce_radius", bce_loss.radius_sq, "launches"),
            ("bce_fwd", bce_loss.bce_sums, "launches"),
            ("bce_bwd", bce_loss.bce_sums_bwd, "launches"),
            ("gather_conv", gc.gather_conv, "launches"))


def read_launches() -> dict:
    return {name: getattr(fn, attr) for name, fn, attr in _counters()}


def zero_launches() -> None:
    for _, fn, attr in _counters():
        setattr(fn, attr, 0)


def randomize_bn_stats(model, gen: torch.Generator) -> None:
    """Seeded non-trivial running statistics for every BN layer (init
    stats make eval BN nearly the identity)."""
    from occuseg_tpu_torch.nn.modules import BatchNormalization
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, BatchNormalization):
                c = m.running_mean.shape[0]
                m.running_mean.copy_(torch.randn(c, generator=gen) * 0.2)
                m.running_var.copy_(torch.rand(c, generator=gen) * 1.5 + 0.5)


def bench_scene(seed: int):
    from occuseg_tpu_torch.data.synthetic import SceneConfig, make_batch
    return make_batch(SceneConfig(num_points=200_000, extent=512,
                                  num_objects=24), num_scenes=1,
                      p_cap=BENCH_P_CAP, num_instances=BENCH_INSTANCES,
                      seed=seed)


def phase_build():
    from occuseg_tpu_torch import native
    from occuseg_tpu_torch.ops import kernels
    t0 = time.perf_counter()
    path = kernels.library_path()
    t1 = time.perf_counter()
    native.load()
    t2 = time.perf_counter()
    print(f"[build] CUDA kernels {t1 - t0:.1f} s, planner {t2 - t1:.1f} s")
    with open(path + ".log") as f:
        for line in f:
            if "registers" in line or "spill" in line:
                print("[build] " + line.strip())


class Totals:
    """Per-kernel sums over the main path's bf16 calls."""

    def __init__(self):
        self.rows = collections.defaultdict(lambda: dict(
            ms=0.0, plain_ms=0.0, bound_ms=0.0, err=0.0, library_ms=None,
            flops=0.0, bytes=0.0, dense_ms=0.0))

    def add(self, key, ms, plain_ms, err, flops, nbytes_, peak=PEAK_BF16,
            library_ms=None, dense_flops=0.0):
        """dense_flops: the tensor-core work over every offset of every
        live chunk's M rows (dense K), whose time at peak is the floor of a
        kernel that does not skip missing references."""
        r = self.rows[key]
        r["ms"] += ms
        r["dense_ms"] += 1e3 * dense_flops / peak
        r["plain_ms"] += plain_ms
        r["err"] = max(r["err"], err)
        r["bound_ms"] += bound_ms(flops, nbytes_, peak)[0]
        r["flops"] += flops / peak
        r["bytes"] += nbytes_ / PEAK_BYTES
        if library_ms is not None:
            r["library_ms"] = (r["library_ms"] or 0.0) + library_ms

    def bound_by(self, key):
        r = self.rows[key]
        return "operations" if r["flops"] >= r["bytes"] else "bytes"


def _err(out, ref):
    return ((out.float() - ref.float()).abs().max().item(),
            ref.float().abs().max().item())


def check_close(label, out, ref, tol):
    err, scale = _err(out, ref)
    check(err <= tol * scale, f"{label}: error {err} > {tol} x {scale}")
    return err, scale


def phase_kernels(dev):
    from occuseg_tpu_torch.core.topology import PlanSpec
    from occuseg_tpu_torch.infer import prepare_scene
    from occuseg_tpu_torch.ops.kernels import chunk_conv as cc
    from occuseg_tpu_torch.ops.kernels import segsum
    from occuseg_tpu_torch.tools.ab_kernels import graph_ms

    batch = bench_scene(0)
    scene = prepare_scene(batch["coords"], batch["features"],
                          PlanSpec(caps=BENCH_CAPS))
    plan = scene.plan.to(dev)
    calls = conv_calls(plan, N_PLANES)
    check(len(calls) == 33, f"expected 33 convolutions, got {len(calls)}")
    gen = torch.Generator().manual_seed(1)
    f32_subset = {"sub L0", "enc0.conv1 L0", "down_conv L0->L1",
                  "up_conv L1->L0", "dec0.conv1 L1", "dec0.conv1 L4",
                  "enc0.conv1 L5"}
    tot = Totals()
    n_route = collections.Counter()
    dw_values = collections.Counter()
    with torch.inference_mode():
        for cv in calls:
            check(cv.chunks is not None and cv.t_chunks is not None,
                  f"{cv.label}: no chunk plan")
            fi, fl = cv.chunks.in_idx, cv.chunks.lidx
            ti, tl = cv.t_chunks.in_idx, cv.t_chunks.lidx
            K = fl.shape[1]
            x = torch.randn(cv.n_in, cv.cin, generator=gen)
            x[cv.n_act:] = 0  # pad rows, as in the model
            w = torch.randn(K, cv.cin, cv.cout, generator=gen) \
                * (2 / (cv.cin * K)) ** .5
            ct = torch.randn(cv.n_out, cv.cout, generator=gen)
            ct[cv.n_out_act:] = 0  # BN zeroes pad rows and their gradient
            sub = cv.label.startswith(("sub", "enc", "dec"))
            wt = (w.flip(0) if sub else w).transpose(1, 2).contiguous()
            route = route_of(cv, 2)
            nnz_f = int((fl >= 0).sum())
            nnz_t = int((tl >= 0).sum())
            M = fl.shape[2]
            # dense K over the live chunks: what a kernel that skips no
            # missing reference multiplies
            dense_f = 2.0 * int((fi[:, 0] >= 0).sum()) * M * K * cv.cin \
                * cv.cout
            dense_t = 2.0 * int((ti[:, 0] >= 0).sum()) * M * K * cv.cin \
                * cv.cout
            for dt in (torch.bfloat16, torch.float32):
                if dt == torch.float32 and cv.label not in f32_subset:
                    continue
                bf = dt == torch.bfloat16
                tol = BF16_TOL if bf else F32_TOL
                xd, wd, ctd, wtd = (a.to(dev, dt) for a in (x, w, ct, wt))
                name = f"{cv.label:<22} {str(dt)[6:]:<8}"
                reps = (5, 3) if bf else (2, 1)

                # forward
                out = cc.chunk_conv(xd, fi, fl, wd)
                ref = cc.chunk_conv_plain(xd, fi, fl, wd)
                err, scale = check_close(f"chunk_conv {name}", out, ref, tol)
                ms = cuda_ms(lambda: cc.chunk_conv(xd, fi, fl, wd), reps[0])
                pms = cuda_ms(lambda: cc.chunk_conv_plain(xd, fi, fl, wd),
                              reps[1])
                print(f"[kernels] chunk_conv {name} K={K:<2} "
                      f"U={fi.shape[1]:<4} Cin={cv.cin:<3} Cout={cv.cout:<3}"
                      f" max_abs_err={err:.3e} max|out|={scale:.3e} "
                      f"kernel={ms:.4f} ms plain={pms:.4f} ms")
                if bf:
                    tot.add("chunk_conv", ms, pms, err, 2.0 * nnz_f * cv.cin
                            * cv.cout, nbytes(xd, fi, fl, wd, out),
                            dense_flops=dense_f)

                # backward, fused route over the transpose plan
                d_f, dwt = cc.chunk_conv_bwd_fused(ctd, ti, tl, wtd, xd)
                r_f, r_w = cc.chunk_conv_bwd_fused_plain(ctd, ti, tl, wtd, xd)
                e_f, s_f = check_close(f"bwd_fused d_feats {name}", d_f, r_f,
                                       tol)
                e_w, s_w = check_close(f"bwd_fused dW {name}", dwt, r_w,
                                       DW_TOL)
                f_ms = cuda_ms(lambda: cc.chunk_conv_bwd_fused(
                    ctd, ti, tl, wtd, xd), reps[0])
                f_pms = cuda_ms(lambda: cc.chunk_conv_bwd_fused_plain(
                    ctd, ti, tl, wtd, xd), reps[1])
                del d_f, dwt, r_f, r_w

                # backward, dW route: dW kernel + forward kernel on the
                # transpose plan
                dw = cc.chunk_conv_dw(xd, fi, fl, ctd)
                r_dw = cc.chunk_conv_dw_plain(xd, fi, fl, ctd)
                e_dw, s_dw = check_close(f"dw {name}", dw, r_dw, DW_TOL)
                check(torch.equal(dw, cc.chunk_conv_dw(xd, fi, fl, ctd)),
                      f"dw {name}: a second launch gave other bits")
                d_t = cc.chunk_conv(ctd, ti, tl, wtd)
                r_t = cc.chunk_conv_plain(ctd, ti, tl, wtd)
                e_t, _ = check_close(f"chunk_conv (transpose) {name}", d_t,
                                     r_t, tol)
                dw_ms = cuda_ms(lambda: cc.chunk_conv_dw(xd, fi, fl, ctd),
                                reps[0])
                t_ms = cuda_ms(lambda: cc.chunk_conv(ctd, ti, tl, wtd),
                               reps[0])
                dw_pms = cuda_ms(lambda: cc.chunk_conv_dw_plain(
                    xd, fi, fl, ctd), reps[1])
                t_pms = cuda_ms(lambda: cc.chunk_conv_plain(
                    ctd, ti, tl, wtd), reps[1])
                del dw, r_dw, r_t
                print(f"[kernels] backward   {name} route={route} "
                      f"U_t={ti.shape[1]:<4} fused={f_ms:.4f} ms "
                      f"(plain {f_pms:.4f}) d_feats_err={e_f:.3e}/"
                      f"{s_f:.3e} dW_err={e_w:.3e}/{s_w:.3e} | dW route="
                      f"{dw_ms + t_ms:.4f} ms (dw {dw_ms:.4f} + fwd "
                      f"{t_ms:.4f}; plain {dw_pms + t_pms:.4f}) dW_err="
                      f"{e_dw:.3e}/{s_dw:.3e}")
                if not bf:
                    continue
                if route == "#5":
                    tot.add("chunk_conv_dw", dw_ms, dw_pms, e_dw,
                            2.0 * nnz_f * cv.cin * cv.cout,
                            nbytes(xd, fi, fl, ctd)
                            + K * cv.cin * cv.cout * 4)
                    tot.add("chunk_conv", t_ms, t_pms, e_t,
                            2.0 * nnz_t * cv.cin * cv.cout,
                            nbytes(ctd, ti, tl, wtd, d_t),
                            dense_flops=dense_t)
                    dw_values["#5"] += cc.dwt_values(
                        fl.shape[0], K, cv.cout, cv.cin,
                        cc._sm_count(dev.index))
                else:  # feats in, d_feats out (same shape), dWt out in f32
                    tot.add(route, f_ms, f_pms, max(e_f, e_w),
                            4.0 * nnz_t * cv.cin * cv.cout,
                            nbytes(ctd, ti, tl, wtd, xd, xd)
                            + K * cv.cin * cv.cout * 4,
                            dense_flops=2.0 * dense_t)
                    dw_values["fused"] += cc.dwt_values(
                        tl.shape[0], K, cv.cin, cv.cout,
                        cc._sm_count(dev.index))
                    # the first fused kernel: one f32 atomic per (live chunk,
                    # offset, Cin row, Ct column)
                    dw_values["atomics"] += int((ti[:, 0] >= 0).sum()) * K \
                        * cv.cin * cv.cout
                n_route[route] += 1
                del d_t

        # the segment sum: InputLayer forward and OutputLayer backward
        cap0 = plan.levels[0].cap
        vox_seg = plan.vox_seg
        B, _, R = vox_seg.shape
        seg = vox_seg.reshape(-1).long()
        valid = seg >= 0
        dst = ((torch.arange(B * R, device=dev) // R) * (cap0 // B)
               + seg)[valid]
        tot.segsum_shapes = []
        for C in (3, 64):
            xp = torch.randn(scene.num_points, C, generator=gen).to(dev)
            out = segsum.blocked_segment_sum(xp, vox_seg, cap0)
            ref = segsum.blocked_segment_sum_plain(xp, vox_seg, cap0)
            err, scale = check_close(f"blocked_segment_sum C={C}", out, ref,
                                     F32_TOL)
            check(torch.equal(out, segsum.blocked_segment_sum(
                xp, vox_seg, cap0)), f"blocked_segment_sum C={C}: a second "
                  f"launch gave other bits")

            def kernel():
                segsum.blocked_segment_sum(xp, vox_seg, cap0)
            ms = cuda_ms(kernel, 20)
            pms = cuda_ms(lambda: segsum.blocked_segment_sum_plain(
                xp, vox_seg, cap0), 20)
            xv = xp[:B * R][valid]
            zeros = torch.zeros((cap0, C), device=dev)

            def library():
                zeros.index_add(0, dst, xv)
            lms = cuda_ms(library, 20)
            # the same calls with the host's launch cost taken out
            gms, glms = graph_ms(kernel, 20), graph_ms(library, 20)
            g_txt = ("not measured (no capture)" if None in (gms, glms) else
                     f"kernel={gms:.4f} ms index_add={glms:.4f} ms")
            bnd = bound_ms(float(int(valid.sum()) * C),
                           nbytes(xp[:B * R], vox_seg, out), PEAK_F32)[0]
            print(f"[kernels] blocked_segment_sum x={tuple(xp.shape)} "
                  f"vox_seg={tuple(vox_seg.shape)} (threads, columns) "
                  f"{segsum.geometry(R, C)} "
                  f"max_abs_err={err:.3e} max|out|={scale:.3e} "
                  f"kernel={ms:.4f} ms plain={pms:.4f} ms index_add="
                  f"{lms:.4f} ms; in a CUDA graph {g_txt}; bound {bnd:.4f} "
                  f"ms; bitwise repeat ok")
            tot.add("blocked_segment_sum", ms, pms, err,
                    float(int(valid.sum()) * C),
                    nbytes(xp[:B * R], vox_seg, out), PEAK_F32, lms)
            tot.segsum_shapes.append(dict(
                C=C, ms=ms, graph_ms=gms, plain_ms=pms, library_ms=lms,
                library_graph_ms=glms, bound_ms=bnd, max_abs_err=err))
    phase_kernels_gather(dev, tot, plan)
    phase_kernels_radius(dev, tot)
    tot.chain_ms = phase_kernels_bce(dev, tot)
    r = tot.rows
    print(f"[kernels] routes at the bench shapes: {n_route['#3']} fused "
          f"(#3), {n_route['#4']} fused at K-grouped shapes (#4), "
          f"{n_route['#5']} dW (#5)")
    for k in ("chunk_conv", "#3", "#4", "chunk_conv_dw",
              "blocked_segment_sum", "bce_radius", "bce_fwd", "bce_bwd",
              "gather_conv"):
        dense = (f", dense-K floor {r[k]['dense_ms']:.4f} ms"
                 if r[k]["dense_ms"] else "")
        print(f"[kernels] per step, {k}: kernel {r[k]['ms']:.3f} ms, plain "
              f"{r[k]['plain_ms']:.3f} ms, bound {r[k]['bound_ms']:.4f} ms "
              f"({tot.bound_by(k)}){dense}")
    print(f"[kernels] per step, f32 dW values written or added into device "
          f"memory (launch geometry): fused route (#3, #4) "
          f"{dw_values['fused']:.4g} (one atomic add per live chunk, offset, Cin row and Ct column: "
          f"{dw_values['atomics']:.4g}); dW route (#5) {dw_values['#5']:.4g}")
    tot.dw_values = dw_values["fused"]
    return tot


CLI_P, CLI_I, EMB = 262_144, 128, 64   # the training CLI's defaults, m=64


def bce_flops(n_pairs: int, n_sampled: int, n_grad: int, E: int,
              backward: bool) -> float:
    """f32 operations the BCE function needs on this run's data: the
    sample-ball test on every (point, instance) pair (a 3-d distance, ~8),
    on each sampled pair the e.mu and rx.mp dots and the s-space terms
    (2E + 20); the backward adds, on each pair with a gradient, the three
    products into de, drx and dmu (4E + 8)."""
    f = 8.0 * n_pairs + (2.0 * E + 20.0) * n_sampled
    return f + (4.0 * E + 8.0) * n_grad if backward else f


def phase_kernels_radius(dev, tot):
    """TPU row #6 at the CLI's shape (P=262144) at I=128 and the bench
    scene's I=64, on `exact_inputs` (every distance exact in f32, so the
    kernel must equal its plain version bit for bit) with two seg layouts:
    every point's id drawn at random, and the CLI's runs of one instance
    (`bce_loss.cli_seg`). Timed back to back (the host's launch cost
    included) and inside a CUDA graph (without it); launched twice."""
    from occuseg_tpu_torch.ops.kernels import bce_loss as bl
    from occuseg_tpu_torch.tools.ab_kernels import graph_ms
    tot.radius_cases = []
    for I in (CLI_I, BENCH_INSTANCES):
        for layout in ("random", "runs"):
            seg_np = bl.cli_seg(CLI_P, I, seed=I) if layout == "runs" \
                else None
            _, _, x4, seg, _, _, mp4, cons, _ = bl.exact_inputs(
                CLI_P, I, 4, seed=I, device=dev, seg=seg_np)
            mp_sq = cons[bl.MP_SQ].clone()
            lens, n_none = bl.run_lengths(seg.cpu().numpy())
            with torch.no_grad():
                r = bl.radius_sq(x4, seg, mp4, mp_sq)
                check(torch.equal(r, bl.radius_sq_plain(x4, seg, mp4,
                                                        mp_sq)),
                      f"bce radius I={I} {layout}: differs from the plain "
                      f"version")
                check(torch.equal(r, bl.radius_sq(x4, seg, mp4, mp_sq)),
                      f"bce radius I={I} {layout}: a second launch gave "
                      f"other bits")

                def kernel():
                    bl.radius_sq(x4, seg, mp4, mp_sq)
                ms, gms = cuda_ms(kernel, 20), graph_ms(kernel, 20)
                pms = cuda_ms(lambda: bl.radius_sq_plain(x4, seg, mp4,
                                                         mp_sq), 3)
            by = nbytes(x4, seg, mp4, mp_sq, r)
            bnd = bound_ms(8.0 * CLI_P, by, PEAK_F32)[0]
            g_txt = "not measured" if gms is None else f"{gms:.4f}"
            print(f"[kernels] bce radius P={CLI_P} I={I} seg {layout}: "
                  f"{len(lens)} runs of one instance (length mean "
                  f"{lens.mean() if len(lens) else 0:.1f}, max "
                  f"{lens.max(initial=0)}), {n_none} points without one; "
                  f"equal to the plain version and repeated bit for bit; "
                  f"kernel {ms:.4f} ms, in a CUDA graph {g_txt} ms, plain "
                  f"{pms:.4f} ms, bound {bnd:.4f} ms")
            tot.radius_cases.append(dict(I=I, seg=layout, ms=ms,
                                         graph_ms=gms, plain_ms=pms,
                                         bound_ms=bnd,
                                         mean_run=float(lens.mean())
                                         if len(lens) else 0.0))
            if I == CLI_I and layout == "runs":  # the CLI's path
                tot.add("bce_radius", ms, pms, 0.0, 8.0 * CLI_P, by,
                        PEAK_F32)
            del x4, seg, mp4, cons, r


def phase_kernels_bce(dev, tot):
    """TPU rows #7-#8 at the CLI's shape (I=128) and the bench scene's
    (I=64) on `exact_inputs` (every pair decision exact in f32, so the
    counts must match exactly), against their plain versions; beside them
    the port's chain (`classification_loss` with the switch off) forward
    and forward + backward on loss inputs of the same shape. Returns the
    chain's ms at the CLI shape."""
    from occuseg_tpu_torch.losses.instance import classification_loss
    from occuseg_tpu_torch.ops.kernels import bce_loss as bl
    chain = {}
    for I in (CLI_I, BENCH_INSTANCES):
        P, E = CLI_P, EMB
        e, rx4, x4, seg, scene, mu, mp4, cons, g = bl.exact_inputs(
            P, I, E, seed=I, device=dev)
        with torch.no_grad():
            cons = bl.with_radius(x4, seg, mp4, cons)
            args = (e, rx4, x4, seg, scene, mu, mp4, cons)
            out = bl.bce_sums(*args)
            ref = bl.bce_sums_plain(*args)
            check(torch.equal(out[1:], ref[1:]),
                  f"bce forward I={I}: counts differ from the plain version")
            e7, _ = check_close(f"bce forward I={I} bce_sum", out[0], ref[0],
                                F32_TOL)
            check(torch.equal(out, bl.bce_sums(*args)),
                  f"bce forward I={I}: a second launch gave other bits")
            got = bl.bce_sums_bwd(*args, g)
            want = bl.bce_sums_bwd_plain(*args, g)
            errs8 = {n: check_close(f"bce backward I={I} {n}", a, b, DW_TOL)
                     for n, a, b in zip(("de", "drx", "dmu", "dsig2"), got,
                                        want)}
            e8_of = max(errs8, key=lambda n: errs8[n][0])
            e8 = errs8[e8_of][0]
            check(all(torch.equal(a, b) for a, b in
                      zip(got, bl.bce_sums_bwd(*args, g))),
                  f"bce backward I={I}: a second launch gave other bits")
            each = ", ".join(f"{n} {a:.3e}/{s:.3e}"
                             for n, (a, s) in errs8.items())
            print(f"[kernels] bce I={I}: forward counts equal the plain "
                  f"version's, bce_sum max_abs_err {e7:.3e}, two launches "
                  f"the same bits; backward max_abs_err/max|ref| {each}, "
                  f"two launches the same bits")
            del got, want
            reps = 10
            ms7 = cuda_ms(lambda: bl.bce_sums(*args), reps)
            pms7 = cuda_ms(lambda: bl.bce_sums_plain(*args), 3)
            ms8 = cuda_ms(lambda: bl.bce_sums_bwd(*args, g), reps)
            pms8 = cuda_ms(lambda: bl.bce_sums_bwd_plain(*args, g), 3)
            # pairs the data needs: sampled, and sampled with a gradient
            member, sample, s_raw, _, _ = bl._pair_terms(*args)
            n_samp = int(sample.sum())
            n_grad = int((sample & (s_raw > bl.S_LO)
                          & (s_raw < bl.S_HI)).sum())
            del member, sample, s_raw

        # the chain on loss inputs of the same shape
        rng = torch.Generator(device="cpu").manual_seed(I)
        bw = (torch.rand(P, 2, generator=rng) + 0.25).to(dev)
        labels = torch.randint(0, 20, (P,), generator=rng).to(dev)
        leaves = [t.clone().requires_grad_() for t in (e, bw, rx4[:, :3])]
        os.environ["OCC_PALLAS_BCE"] = "0"

        def chain_fwd():
            with torch.no_grad():
                classification_loss(*leaves, x4[:, :3], seg, scene, labels, 2,
                                    I)

        def chain_fwd_bwd():
            loss, _ = classification_loss(*leaves, x4[:, :3], seg, scene,
                                          labels, 2, I)
            loss.backward()

        cf = cuda_ms(chain_fwd, 3)
        cfb = cuda_ms(chain_fwd_bwd, 3)
        chain[I] = (cf, cfb)
        bf = nbytes(*args, out)
        bb = nbytes(*args, g) + nbytes(e, rx4) + I * E * 4 + I * 8
        f7 = bce_flops(P * I, n_samp, 0, E, False)
        f8 = bce_flops(P * I, n_samp, n_grad, E, True)
        print(f"[kernels] bce P={P} I={I} E={E}: {n_samp} sampled pairs, "
              f"{n_grad} with a gradient; forward {ms7:.4f} ms (plain "
              f"{pms7:.4f}, "
              f"max_abs_err {e7:.3e}), backward {ms8:.4f} ms (plain "
              f"{pms8:.4f}, max_abs_err {e8:.3e} of {e8_of}); chain forward "
              f"{cf:.4f} ms, forward+backward {cfb:.4f} ms; bounds "
              f"{bound_ms(f7, bf, PEAK_F32)[0]:.4f} / "
              f"{bound_ms(f8, bb, PEAK_F32)[0]:.4f} ms")
        if I == CLI_I:  # the CLI's path: once each per step
            tot.add("bce_fwd", ms7, pms7, e7, f7, bf, PEAK_F32)
            tot.add("bce_bwd", ms8, pms8, e8, f8, bb, PEAK_F32)
            tot.bce_bwd_err_of = e8_of
        del args, out, e, rx4, x4, seg, scene, mu, mp4, cons, g, leaves
        torch.cuda.empty_cache()
    return chain[CLI_I]


def phase_kernels_gather(dev, tot, plan):
    """TPU row #9 at levels L3-L5 of the bench plan at their widths,
    against its plain version and the chunk-conv forward (#1) of the same
    level, width and weights, both timed back to back and inside a CUDA
    graph; launched twice. The level's pad rows (past num_active) must
    have no neighbour: the kernel skips every (128-row tile, offset) whose
    ids are all -1, counted here from the plan."""
    import numpy as np
    from occuseg_tpu_torch.ops.kernels import chunk_conv as cc
    from occuseg_tpu_torch.ops.kernels import gather_conv as gc
    from occuseg_tpu_torch.tools.ab_kernels import graph_ms
    gen = torch.Generator().manual_seed(9)
    tot.gather_levels = []
    with torch.inference_mode():
        for lv in (3, 4, 5):
            level = plan.levels[lv]
            C = N_PLANES[lv]
            nbr = np.asarray(level.nbr)
            N, K = nbr.shape
            na = int(level.num_active)
            check(bool((nbr[na:] < 0).all()),
                  f"gather_conv L{lv}: pad rows past {na} have neighbours")
            tiles = -(-N // gc.TILE)
            ids = np.full((tiles * gc.TILE, K), -1)
            ids[:N] = nbr
            live = (ids.reshape(tiles, gc.TILE, K) >= 0).any(1)
            nt, splits = gc.geometry(N, C, C, K,
                                     cc._sm_count(dev.index or 0))
            nbr_kn = torch.from_numpy(nbr.T.copy()).to(dev)
            x = torch.randn(N, C, generator=gen)
            x[na:] = 0
            xd = x.to(dev, torch.bfloat16)
            w = (torch.randn(27, C, C, generator=gen) * (2 / (27 * C)) ** .5
                 ).to(dev, torch.bfloat16)
            fi, fl = level.chunks.in_idx, level.chunks.lidx
            out = gc.gather_conv(xd, nbr_kn, w)
            ref = gc.gather_conv_plain(xd, nbr_kn, w)
            err, scale = check_close(f"gather_conv L{lv}", out, ref, BF16_TOL)
            check_close(f"gather_conv L{lv} vs chunk_conv", out,
                        cc.chunk_conv(xd, fi, fl, w), BF16_TOL)
            check(torch.equal(out, gc.gather_conv(xd, nbr_kn, w)),
                  f"gather_conv L{lv}: a second launch gave other bits")

            def kernel():
                gc.gather_conv(xd, nbr_kn, w)

            def chunk():
                cc.chunk_conv(xd, fi, fl, w)
            ms, gms = cuda_ms(kernel, 20), graph_ms(kernel, 20)
            cms, cgms = cuda_ms(chunk, 20), graph_ms(chunk, 20)
            pms = cuda_ms(lambda: gc.gather_conv_plain(xd, nbr_kn, w), 3)
            nnz = int((nbr_kn >= 0).sum())
            flops = 2.0 * nnz * C * C
            nb = nbytes(xd, nbr_kn, w, out)
            bnd = bound_ms(flops, nb)[0]
            fmt = (lambda v: "not measured" if v is None else f"{v:.4f}")
            print(f"[kernels] gather_conv L{lv} N={N} ({na} active) C={C} "
                  f"tile {nt} columns, {splits} split(s): {int(live.sum())} "
                  f"of {live.size} (tile, offset) pairs live, "
                  f"{live.size - int(live.sum())} skipped; max_abs_err "
                  f"{err:.3e} (max|out| {scale:.3e}), two launches the "
                  f"same bits; kernel {ms:.4f} ms (graph {fmt(gms)}), "
                  f"chunk_conv (#1) {cms:.4f} ms (graph {fmt(cgms)}), plain "
                  f"{pms:.4f} ms, bound {bnd:.4f} ms")
            tot.add("gather_conv", ms, pms, err, flops, nb)
            tot.gather_levels.append(dict(
                level=lv, N=N, C=C, ms=ms, graph_ms=gms, chunk_conv_ms=cms,
                chunk_conv_graph_ms=cgms, bound_ms=bnd,
                skipped=live.size - int(live.sum()), pairs=live.size))


def _mid_scene():
    from occuseg_tpu_torch.data.synthetic import SceneConfig, make_batch
    return make_batch(SceneConfig(num_points=20_000, extent=128,
                                  num_objects=8), num_scenes=1,
                      p_cap=MID_P_CAP, num_instances=16, seed=0)


def phase_parity(dev):
    from occuseg_tpu_torch.core.topology import PlanSpec
    from occuseg_tpu_torch.infer import Predictor, prepare_scene
    from occuseg_tpu_torch.models import LearningBWDenseUNet

    batch = _mid_scene()
    scene = prepare_scene(batch["coords"], batch["features"],
                          PlanSpec(caps=MID_CAPS))
    model = LearningBWDenseUNet(N_PLANES,
                                generator=torch.Generator().manual_seed(2))
    randomize_bn_stats(model, torch.Generator().manual_seed(3))
    cpu_out = Predictor(model, "cpu")(scene)
    gpu_out = Predictor(model, dev)(scene)  # moves the model to the card
    torch.cuda.synchronize()
    for name in gpu_out._fields:
        g, c = getattr(gpu_out, name).cpu(), getattr(cpu_out, name)
        check(g.shape == c.shape, f"parity {name}: shapes differ")
        err = (g - c).abs().max().item()
        scale = c.abs().max().item()
        print(f"[parity] {name:<12} {tuple(c.shape)} max_abs_err={err:.3e} "
              f"max|cpu|={scale:.3e}")
        check(bool(torch.isfinite(g).all()), f"parity {name}: not finite")
        check(err <= PARITY_TOL * max(scale, 1.0),
              f"parity {name}: error {err} > {PARITY_TOL} x {scale}")


def phase_parity_train(dev):
    """One f32 training step on the mid scene, on the card and on the CPU
    from the same weights."""
    from occuseg_tpu_torch.core.topology import PlanSpec
    from occuseg_tpu_torch.models import LearningBWDenseUNet
    from occuseg_tpu_torch.train.state import Trainer, prepare_batch

    laid, plan = prepare_batch(_mid_scene(), PlanSpec(caps=MID_CAPS))
    model = LearningBWDenseUNet(N_PLANES,
                                generator=torch.Generator().manual_seed(7))
    randomize_bn_stats(model, torch.Generator().manual_seed(8))
    cpu = Trainer(copy.deepcopy(model), "cpu", num_instances=16)
    cpu_p = Trainer(copy.deepcopy(model), "cpu", num_instances=16)
    gpu2 = Trainer(copy.deepcopy(model), dev, num_instances=16)
    gpu = Trainer(model, dev, num_instances=16)
    t0 = time.perf_counter()
    cpu_parts = cpu.step(laid, plan)
    t1 = time.perf_counter()
    gpu_parts = gpu.step(laid, plan)
    gpu2.step(laid, plan)
    torch.cuda.synchronize()
    feats = torch.from_numpy(laid["features"])
    noise = torch.randn(feats.shape, generator=torch.Generator()
                        .manual_seed(9))
    cpu_p.step(dict(laid, features=(feats * (1 + 1e-6 * noise)).numpy()),
               plan)
    print(f"[parity] f32 train step: CPU {t1 - t0:.1f} s")
    for k, c in cpu_parts.items():
        g = float(gpu_parts[k])
        c = float(c)
        print(f"[parity] step {k:<20} card={g:.6f} cpu={c:.6f}")
        check(g == g and abs(g) != float("inf"), f"parity step {k}: {g}")
        tol = 1e-2 if k == "instance_iou" else PARITY_TOL * abs(c) + 1e-6
        check(abs(g - c) <= tol, f"parity step {k}: {g} vs {c}")

    def grads(trainer):
        return [p.grad.detach().cpu() for p in trainer.model.parameters()]

    names = [n for n, _ in cpu.model.named_parameters()]
    ref, card, card2, pert = (grads(t) for t in (cpu, gpu, gpu2, cpu_p))

    def rel(a, b):
        return (a - b).abs().max().item() / max(b.abs().max().item(), 1e-30)

    def glob(a_list, b_list):
        num = sum(float(((a - b) ** 2).sum()) for a, b in zip(a_list, b_list))
        den = sum(float((b ** 2).sum()) for b in b_list)
        return (num / den) ** 0.5

    rows = sorted(((rel(c, r), rel(c, c2), rel(q, r), n)
                   for c, c2, q, r, n in zip(card, card2, pert, ref, names)),
                  reverse=True)
    for e_c, e_g, e_p, n in rows[:5]:
        print(f"[parity] step grad {n}: card vs CPU {e_c:.3e}; card vs card "
              f"{e_g:.3e}; CPU vs CPU with 1e-6 input noise {e_p:.3e}")
    g_c, g_g, g_p = glob(card, ref), glob(card2, card), glob(pert, ref)
    print(f"[parity] step gradients, relative to each tensor's max: card vs "
          f"CPU max {rows[0][0]:.3e} median {rows[len(rows) // 2][0]:.3e} "
          f"over {len(rows)} tensors (CPU vs CPU with 1e-6 input noise: "
          f"max {max(r[2] for r in rows):.3e}); of the whole gradient's "
          f"norm: card vs CPU {g_c:.3e}, card vs card {g_g:.3e}, CPU "
          f"with noise {g_p:.3e}")
    check(g_c <= GRAD_GLOBAL_TOL, f"parity gradients: {g_c} of the norm")
    for c, r, n in zip(card, ref, names):
        err = (c - r).abs().max().item()
        check(err <= GRAD_TOL * r.abs().max().item() + GRAD_FLOOR,
              f"parity grad {n}: error {err} > {GRAD_TOL} x max")
    for (n, bc), (_, bg) in zip(cpu.model.named_buffers(),
                                gpu.model.named_buffers()):
        err = (bg.cpu() - bc).abs().max().item()
        check(err <= PARITY_TOL * bc.abs().max().item() + 1e-6,
              f"parity BN statistic {n}: error {err}")
    print("[parity] step: new BN statistics agree")


# the classification loss with the BCE kernels against the port's chain at
# full size. The two decide the sample ball in different formulations
# (sq < 16 max sq against sqrt(sq + 1e-12) < 4 max sqrt(sq + 1e-12)); the
# pairs that fall on different sides are counted below (none at the bench
# scene on the H100). The gradients differ more than at P=512: each row is
# a difference of nearly equal sums (de = 2 (sum_i g0 e - sum_i g0 mu_i)),
# taken in another order and formulation (the chain differentiates its
# clamp and square root), and with the random model's small embeddings
# single small elements differed by up to 6.5e-4 of their tensor's max and
# the tensors by 3-5e-5 of their norm (H100 80GB HBM3, 700 W). The tolerance of
# tests/test_bce_loss.py (atol 3e-5 x max + rtol 2e-4) holds at its P=512
# (tests/test_torch_bce.py); here the loss is held to rtol 2e-5 and the
# gradients to 1e-4 of each tensor's norm and 5e-3 of its largest element.
BCE_GRAD_NORM_TOL = 1e-4
BCE_GRAD_MAX_TOL = 5e-3


def phase_parity_bce(dev):
    """The classification loss and its gradients to e, bw and rx on the
    card, with the BCE kernels (OCC_PALLAS_BCE=1) against the port's chain
    (=0), at the bench scene's model outputs (random bf16 model, train
    mode)."""
    from occuseg_tpu_torch.core.topology import PlanSpec
    from occuseg_tpu_torch.losses.instance import (
        _sanitize_seg, _seg_mean, _sqdist, classification_loss,
    )
    from occuseg_tpu_torch.models import LearningBWDenseUNet
    from occuseg_tpu_torch.ops.kernels import bce_loss
    from occuseg_tpu_torch.train.state import prepare_batch

    laid, plan = prepare_batch(bench_scene(0), PlanSpec(caps=BENCH_CAPS))
    model = LearningBWDenseUNet(N_PLANES, compute_dtype=torch.bfloat16,
                                generator=torch.Generator().manual_seed(10))
    model.to(dev).train()
    b = {k: torch.as_tensor(laid[k]).to(dev)
         for k in ("features", "pose", "instance_id", "point_scene",
                   "labels")}
    with torch.no_grad():
        out = model(b["features"], plan.to(dev))
    e, bw = out.embedding.float(), out.bw.float()
    rx = b["pose"] - out.displacement.float()
    del out
    res = {}
    for flag in ("1", "0"):
        os.environ["OCC_PALLAS_BCE"] = flag
        leaves = [t.clone().requires_grad_() for t in (e, bw, rx)]
        before = read_launches()["bce_fwd"]
        loss, miou = classification_loss(*leaves, b["pose"],
                                         b["instance_id"], b["point_scene"],
                                         b["labels"], 1, BENCH_INSTANCES)
        loss.backward()
        torch.cuda.synchronize()
        ran = read_launches()["bce_fwd"] - before
        check(ran == (1 if flag == "1" else 0),
              f"bce parity: switch {flag} launched the kernel {ran} times")
        res[flag] = (float(loss.detach()), float(miou.detach()),
                     [t.grad for t in leaves])
    os.environ.pop("OCC_PALLAS_BCE")

    # pairs whose sample decision differs between the two formulations
    with torch.no_grad():
        I = BENCH_INSTANCES
        iid = b["instance_id"]
        seg = _sanitize_seg(iid, I)
        mp, _ = _seg_mean(torch.where((iid >= 0)[:, None], b["pose"], 0.0),
                          seg, I + 1)
        sq = _sqdist(b["pose"], mp[:I])
        member = (seg[:, None] == torch.arange(I, device=dev)) \
            & (iid >= 0)[:, None]
        zero = torch.zeros((), device=dev)
        in_k = sq < 16.0 * torch.where(member, sq, zero).amax(0)
        d = torch.sqrt(sq + 1e-12)
        in_c = d < 4.0 * torch.where(member, d, zero).amax(0)
        flips = int((in_k != in_c).sum())
        del sq, member, in_k, d, in_c

    (lk, mk, gk), (lc, mc, gc) = res["1"], res["0"]
    print(f"[parity] classification loss: kernels {lk:.7f} chain {lc:.7f}; "
          f"instance IoU kernels {mk:.7f} chain {mc:.7f}; {flips} of "
          f"{e.shape[0] * BENCH_INSTANCES} (point, instance) pairs at the "
          f"ball's edge decide differently")
    check(abs(lk - lc) <= 2e-5 * abs(lc), f"bce parity loss {lk} vs {lc}")
    check(abs(mk - mc) <= 2e-5 * abs(mc) + 1e-7,
          f"bce parity IoU {mk} vs {mc}")
    for name, a, r in zip(("e", "bw", "rx"), gk, gc):
        check(bool(torch.isfinite(a).all()), f"bce parity d{name} not finite")
        err = (a - r).abs()
        scale = r.abs().max().item()
        rel_norm = ((a - r).norm() / r.norm()).item()
        over = int((err > 3e-5 * scale + 2e-4 * r.abs()).sum())
        print(f"[parity] classification d{name}: max_abs_err "
              f"{err.max().item():.3e} (max {scale:.3e}), {rel_norm:.3e} of "
              f"the norm; {over} of {r.numel()} elements beyond atol 3e-5 x "
              f"max + rtol 2e-4")
        check(rel_norm <= BCE_GRAD_NORM_TOL,
              f"bce parity d{name}: {rel_norm} of the norm")
        check(err.max().item() <= BCE_GRAD_MAX_TOL * scale,
              f"bce parity d{name}: {err.max().item()} > "
              f"{BCE_GRAD_MAX_TOL} x {scale}")
    check(not bce_loss.enabled(), "the switch is off again")


def phase_slice(dev):
    from occuseg_tpu_torch import native
    from occuseg_tpu_torch.core.topology import PlanSpec
    from occuseg_tpu_torch.infer import Predictor, prepare_scene
    from occuseg_tpu_torch.models import LearningBWDenseUNet

    model = LearningBWDenseUNet(N_PLANES, compute_dtype=torch.bfloat16,
                                generator=torch.Generator().manual_seed(4))
    randomize_bn_stats(model, torch.Generator().manual_seed(5))
    predictor = Predictor(model, dev)
    spec = PlanSpec(caps=BENCH_CAPS)
    requests = [bench_scene(seed) for seed in (0, 1, 2)]
    predictor(prepare_scene(requests[0]["coords"], requests[0]["features"],
                            spec))  # warm-up request (allocator, libraries)
    torch.cuda.synchronize()

    zero_launches()
    torch.cuda.reset_peak_memory_stats()
    for seed, batch in zip((0, 1, 2), requests):
        before = read_launches()
        t0 = time.perf_counter()
        scene = prepare_scene(batch["coords"], batch["features"], spec)
        t1 = time.perf_counter()
        out = predictor(scene)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        after = read_launches()
        plan = scene.plan
        check(all(l.chunks is not None for l in plan.levels)
              and all(t.child_chunks is not None and t.up_chunks is not None
                      for t in plan.transitions),
              f"seed {seed}: a level or transition is not chunked")
        check(after["chunk_conv"] - before["chunk_conv"] == 33,
              f"seed {seed}: {after['chunk_conv'] - before['chunk_conv']} "
              f"chunk_conv launches, expected 33")
        check(after["blocked_segment_sum"] - before["blocked_segment_sum"]
              == 1, f"seed {seed}: segment sum not launched once")
        P = batch["coords"].shape[0]
        for name in out._fields:
            t = getattr(out, name)
            check(t.shape[0] == P and t.dtype == torch.float32,
                  f"seed {seed}: {name} shape {tuple(t.shape)}")
            check(bool(torch.isfinite(t).all()), f"seed {seed}: {name} "
                  f"not finite")
        # original order: every point of a voxel (p2v from the planner on
        # the request's own point order) carries that voxel's features
        _, _, p2v, _ = native.plan_voxelize(batch["coords"], BENCH_CAPS[0])
        p2v = torch.from_numpy(p2v).long().to(dev)
        f = out.features
        valid = p2v >= 0
        rep = torch.full((BENCH_CAPS[0],), -1, dtype=torch.long, device=dev)
        rep[p2v[valid]] = torch.nonzero(valid)[:, 0]
        spread = (f[valid] - f[rep[p2v[valid]]]).abs().max().item()
        check(spread == 0.0, f"seed {seed}: points of one voxel differ "
              f"({spread}): outputs are not in the original point order")
        check(bool((f[~valid] == 0).all()), f"seed {seed}: pad rows not 0")
        check(f[valid].std(0).max().item() > 0,
              f"seed {seed}: features constant across points")
        fwd_s = t2 - t1
        print(f"[slice] request seed {seed}: {scene.num_voxels} voxels, "
              f"plan {1e3 * (t1 - t0):.1f} ms (tier {plan.chunk_tier}), "
              f"forward {1e3 * fwd_s:.2f} ms, "
              f"{scene.num_voxels / fwd_s:,.0f} voxels/s")
    print(f"[slice] peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    launches = read_launches()
    check(launches["chunk_conv"] == 99
          and launches["blocked_segment_sum"] == 3
          and launches["chunk_conv_bwd_fused"] == 0
          and launches["chunk_conv_dw"] == 0,
          f"inference-path launches {launches}")
    print(f"[slice] launches {launches}")


def profile_step(step, phase: str = "train") -> float:
    """Run `step` once under torch.profiler, print the device time by
    kernel (top rows), and return the device's busy ms."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    wall = 1e3 * (time.perf_counter() - t0)
    rows = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    rows.sort(key=lambda e: -e.self_device_time_total)
    busy = sum(e.self_device_time_total for e in rows) / 1e3
    print(f"[{phase}] profiled step: wall {wall:.1f} ms (under the "
          f"profiler), device busy {busy:.2f} ms in {len(rows)} kinds of "
          f"device activity")
    for e in rows[:25]:
        print(f"[{phase}] profile {e.self_device_time_total / 1e3:9.3f} ms "
              f"{e.count:5d} x  {e.key[:90]}")
    host = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CPU]
    host.sort(key=lambda e: -e.self_cpu_time_total)
    for e in host[:12]:
        print(f"[{phase}] host {e.self_cpu_time_total / 1e3:9.3f} ms "
              f"{e.count:5d} x  {e.key[:90]}")
    return busy


def phase_train(dev):
    from occuseg_tpu_torch.core.topology import PlanSpec
    from occuseg_tpu_torch.models import LearningBWDenseUNet
    from occuseg_tpu_torch.train.state import Trainer, prepare_batch

    model = LearningBWDenseUNet(N_PLANES, compute_dtype=torch.bfloat16,
                                generator=torch.Generator().manual_seed(6))
    trainer = Trainer(model, dev, num_instances=BENCH_INSTANCES)
    spec = PlanSpec(caps=BENCH_CAPS)
    scenes = [bench_scene(seed) for seed in (0, 1, 2)]
    n_warm, n_timed = 2, 3

    prepared = []
    for seed, batch in zip((0, 1, 2), scenes):
        t0 = time.perf_counter()
        laid, plan = prepare_batch(batch, spec)
        t_plan = time.perf_counter() - t0
        check(all(l.chunks is not None for l in plan.levels)
              and all(t.child_chunks is not None and t.up_chunks is not None
                      for t in plan.transitions),
              f"seed {seed}: a level or transition is not chunked")
        pred = predicted_launches(plan)
        print(f"[train] seed {seed}: {plan.levels[0].num_active} voxels, "
              f"host plan {1e3 * t_plan:.1f} ms (tier {plan.chunk_tier}), "
              f"predicted launches per step {pred}")
        prepared.append((seed, laid, plan, pred))
    for _ in range(n_warm):  # allocator, libraries
        trainer.step(prepared[0][1], prepared[0][2])
    torch.cuda.synchronize()

    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    zero_launches()
    torch.cuda.reset_peak_memory_stats()
    expected = collections.Counter()
    step_ms = []
    for seed, laid, plan, pred in prepared:
        for i in range(n_timed):
            t0 = time.perf_counter()
            parts = trainer.step(laid, plan)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            step_ms.append(1e3 * dt)
            vals = {k: float(v) for k, v in parts.items()}
            check(all(v == v and abs(v) != float("inf")
                      for v in vals.values()),
                  f"seed {seed}: loss parts not finite {vals}")
            nv = plan.levels[0].num_active
            print(f"[train] seed {seed} step {i}: {1e3 * dt:.2f} ms, "
                  f"{nv / dt:,.0f} voxels/s, total {vals['total']:.4f} "
                  f"(" + ", ".join(f"{k} {v:.4f}" for k, v in vals.items()
                                   if k != "total") + ")")
        expected.update(collections.Counter(
            {k: n_timed * v for k, v in pred.items()}))
    torch.cuda.synchronize()
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated() / 2**30
    moved = sum(bool((p.detach() != before[n]).any())
                for n, p in model.named_parameters())
    n_params = len(before)
    med = sorted(step_ms)[len(step_ms) // 2]
    print(f"[train] {len(step_ms)} steps: median {med:.2f} ms "
          f"(min {min(step_ms):.2f}, max {max(step_ms):.2f}); peak device "
          f"memory {peak:.2f} GiB; {moved} of {n_params} parameter tensors "
          f"moved")
    print(f"[train] launches {launches}, expected {dict(expected)}")
    check(moved == n_params, f"only {moved} of {n_params} parameters moved")
    check(launches == dict(expected), f"train-path launches {launches}, "
          f"expected {dict(expected)}")
    for k in ("chunk_conv", "chunk_conv_bwd_fused", "chunk_conv_dw",
              "blocked_segment_sum"):
        check(launches[k] > 0, f"{k} was not launched on the train path")

    busy = profile_step(lambda: trainer.step(prepared[0][1],
                                             prepared[0][2]))
    print(f"[train] device busy {busy:.2f} ms of the median step "
          f"{med:.2f} ms ({100 * busy / med:.1f}%)")
    return launches


LOOP_FLAGS = ("--m", "64", "--use_dense_model", "--residual_blocks",
              "--batch_size", "4", "--plan_workers", "4", "--max_epoch", "1")


def _tensors(obj):
    """Every tensor in a plan's (nested) dataclasses."""
    if isinstance(obj, torch.Tensor):
        yield obj
    elif hasattr(obj, "__dataclass_fields__"):
        for f in obj.__dataclass_fields__:
            yield from _tensors(getattr(obj, f))
    elif isinstance(obj, (tuple, list)):
        for o in obj:
            yield from _tensors(o)


def check_blocked_convs(dev, host_plan):
    """The loop's f32 chunk convolutions on one of its blocked 4-scene
    plans (scene-pure chunks, global in_idx rows, the pad rows of every
    scene zero): each conv's forward and both backward routes against the
    plain versions on the card, as `phase_kernels` holds the bench
    shapes. These launches compare and are not counted."""
    from occuseg_tpu_torch.core.sparse_tensor import active_mask
    from occuseg_tpu_torch.ops.kernels import chunk_conv as cc
    plan = host_plan.to(dev)
    calls = conv_calls(plan, N_PLANES)
    check(len(calls) == 33, f"expected 33 convolutions, got {len(calls)}")
    gen = torch.Generator().manual_seed(11)
    worst = collections.defaultdict(float)
    routes = collections.Counter()
    with torch.inference_mode():
        for cv in calls:
            check(cv.chunks is not None and cv.t_chunks is not None,
                  f"[loop] {cv.label}: no chunk plan")
            fi, fl = cv.chunks.in_idx, cv.chunks.lidx
            ti, tl = cv.t_chunks.in_idx, cv.t_chunks.lidx
            K = fl.shape[1]
            x = torch.randn(cv.n_in, cv.cin, generator=gen)
            x[~active_mask(cv.n_act, cv.n_in)] = 0
            w = torch.randn(K, cv.cin, cv.cout, generator=gen) \
                * (2 / (cv.cin * K)) ** .5
            ct = torch.randn(cv.n_out, cv.cout, generator=gen)
            ct[~active_mask(cv.n_out_act, cv.n_out)] = 0
            sub = cv.label.startswith(("sub", "enc", "dec"))
            wt = (w.flip(0) if sub else w).transpose(1, 2).contiguous()
            xd, wd, ctd, wtd = (a.to(dev) for a in (x, w, ct, wt))
            route = route_of(cv, 4)
            routes[route] += 1
            errs = {}
            for key, out, ref, tol in (
                    ("forward", cc.chunk_conv(xd, fi, fl, wd),
                     cc.chunk_conv_plain(xd, fi, fl, wd), F32_TOL),
                    *zip(("fused d_feats", "fused dW"),
                         cc.chunk_conv_bwd_fused(ctd, ti, tl, wtd, xd),
                         cc.chunk_conv_bwd_fused_plain(ctd, ti, tl, wtd, xd),
                         (F32_TOL, DW_TOL)),
                    ("dW", cc.chunk_conv_dw(xd, fi, fl, ctd),
                     cc.chunk_conv_dw_plain(xd, fi, fl, ctd), DW_TOL),
                    ("transpose", cc.chunk_conv(ctd, ti, tl, wtd),
                     cc.chunk_conv_plain(ctd, ti, tl, wtd), F32_TOL)):
                err, scale = check_close(f"[loop] {key} {cv.label} f32",
                                         out, ref, tol)
                errs[key] = err / max(scale, 1e-30)
                worst[key] = max(worst[key], errs[key])
                del out, ref
            check(torch.equal(cc.chunk_conv_dw(xd, fi, fl, ctd),
                              cc.chunk_conv_dw(xd, fi, fl, ctd)),
                  f"[loop] dW {cv.label} f32: two launches gave other bits")
            print(f"[loop] blocked conv {cv.label:<22} f32 rows {cv.n_in}->"
                  f"{cv.n_out} U={fi.shape[1]}/{ti.shape[1]} route={route} "
                  f"error/max: " + ", ".join(f"{k} {v:.1e}"
                                             for k, v in errs.items()))
    print(f"[loop] blocked convs: 33 forwards and both backward routes of "
          f"each agree with the plain versions (f32; routes {dict(routes)};"
          f" worst error/max " + ", ".join(f"{k} {v:.1e}"
                                           for k, v in worst.items()) + ")")
    torch.cuda.empty_cache()


def phase_loop(dev, tmp):
    """The training CLI (`occuseg_tpu_torch.train.cli.main`) at full width
    with OCC_PALLAS_BCE=1: first the f32 convolutions of the first batch's
    blocked plan against their plain versions (`check_blocked_convs`); then
    one synthetic epoch of blocked 4-scene batches
    (8 steps, f32 as the JAX CLI trains) from a pool of 4 plan threads, a
    checkpoint, the semantic evals; then a resume from the checkpoint for
    one more step. Checks the launches the routes predict, finite losses,
    the eval, and that the resumed state equals the saved one."""
    import numpy as np
    from occuseg_tpu_torch.infer import plan_scene
    from occuseg_tpu_torch.train import checkpoint as ckpt
    from occuseg_tpu_torch.train import cli, loop
    from occuseg_tpu_torch.train.config import args_to_config, get_parser
    from occuseg_tpu_torch.train.state import pinned, prepare_batch

    os.environ["OCC_PALLAS_BCE"] = "1"
    argv = [*LOOP_FLAGS, "--data_dir", os.path.join(tmp, "no_scenes"),
            "--checkpoints_dir", os.path.join(tmp, "ckpts")]
    config = args_to_config(get_parser().parse_args(argv))
    spec = loop.build_spec(config)
    ds = loop._synthetic_dataset(config)

    # the epoch's batches again (the loop's seed), planned on one thread:
    # host plan ms per batch, and the launches each step's routes predict
    ns = config["batch_size"]
    rng = np.random.default_rng(100)
    expected = collections.Counter()
    plan_ms, plans = [], []
    for batch in ds.train_batches(rng, config["point_cap"],
                                  config["instance_cap"], ns):
        t0 = time.perf_counter()
        laid, plan = prepare_batch(batch, spec, ns)
        plan_ms.append(1e3 * (time.perf_counter() - t0))
        plans.append((laid, plan))
        expected.update(predicted_launches(plan, esize=4, bce=True))
    n_eval = 2 * len(ds.val)  # the snapshot eval and the CLI's own
    for raw in ds.val_batches(config["point_cap"], config["instance_cap"],
                              1):
        vplan = plan_scene(raw["coords"], spec)
        expected.update({"chunk_conv": 2 * 33, "blocked_segment_sum":
                         2 * int(vplan.vox_seg is not None)})
    check_blocked_convs(dev, plans[0][1])
    na = plans[0][1].levels[0].num_active
    print(f"[loop] {len(plans)} batches of {ns} scenes, blocked caps "
          f"{[l.cap for l in plans[0][1].levels]}, level-0 voxels per scene "
          f"{list(na)}; sorted point layout: "
          f"{plans[0][1].vox_seg is not None}; host plan per batch (one "
          f"thread) {', '.join(f'{t:.0f}' for t in plan_ms)} ms")

    torch.cuda.synchronize()
    zero_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    result = cli.main(argv, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated() / 2**30
    tm = result["timings"]
    steps = result["steps"]
    period = [w + s for w, s in zip(tm["wait_ms"], tm["step_ms"])]
    med = sorted(tm["step_ms"])[steps // 2]
    print(f"[loop] cli.main: {steps} steps + {n_eval} eval forwards in "
          f"{wall:.1f} s; step ms {', '.join(f'{t:.1f}' for t in tm['step_ms'])}"
          f" (median {med:.1f}); waits for a prepared batch "
          f"{', '.join(f'{t:.1f}' for t in tm['wait_ms'])} ms; step period "
          f"median {sorted(period)[steps // 2]:.1f} ms")
    print(f"[loop] losses (epoch mean) {result['losses']}")
    print(f"[loop] val mean IoU {result['metrics']['mean_iou']:.4f}; peak "
          f"device memory {peak:.2f} GiB")
    print(f"[loop] launches {launches}, expected {dict(expected)}")
    check(steps == len(plans), f"{steps} steps, expected {len(plans)}")
    check(all(v == v and abs(v) != float("inf")
              for v in result["losses"].values()), "loop losses not finite")
    check(0.0 <= result["metrics"]["mean_iou"] <= 1.0, "eval mean IoU")
    check(launches == dict(expected), f"loop launches {launches}, expected "
          f"{dict(expected)}")
    for k in ("bce_radius", "bce_fwd", "bce_bwd", "chunk_conv",
              "chunk_conv_bwd_fused"):
        check(launches[k] > 0, f"{k} was not launched on the loop path")

    # the upload of one batch's plan (the arrays the device reads) from
    # pageable memory, against the loop's (pinned by the loader threads),
    # in turns
    laid0, plan0 = plans[0]
    pinned_batch = pinned(laid0, plan0)
    for name, up in (("pageable", lambda: plan0.to(dev)),
                     ("pinned", lambda: pinned_batch[1].to(dev))) * 2:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        on_dev = up()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        mb = sum(nbytes(t) for t in _tensors(on_dev)) / 2**20
        print(f"[loop] plan upload, {name}: {mb:.1f} MiB, host "
              f"{1e3 * (t1 - t0):.1f} ms, done after {1e3 * (t2 - t0):.1f} "
              f"ms")
        del on_dev

    from occuseg_tpu_torch.utils.profiling import plan_muladd_count
    t0 = time.perf_counter()
    plan_muladd_count(plan0, N_PLANES)
    print(f"[loop] MulAdd counter of one plan (host, per step): "
          f"{1e3 * (time.perf_counter() - t0):.1f} ms")

    # device time of one such step (profiled), against the step period
    trainer = result["trainer"]
    busy = profile_step(lambda: trainer.step(*pinned_batch), "loop")
    print(f"[loop] device busy {busy:.2f} ms of the median step "
          f"{med:.2f} ms ({100 * busy / med:.1f}%)")

    # resume: the saved state, restored before the first resumed step
    path = ckpt.latest_checkpoint(result["ckpt_dir"])
    check(path is not None and path.endswith("step_1.pth"),
          f"checkpoint {path}")
    saved = ckpt.restore_checkpoint(path, map_location="cpu")
    restored = {}
    resume = dict(config, load=result["ckpt_dir"], checkpoint=1,
                  max_epoch=2)
    zero_launches()
    r2 = loop.train(resume, max_steps=1, device=dev, on_start=lambda t:
                    restored.update(copy.deepcopy(t.state_dict())))
    torch.cuda.synchronize()
    after = read_launches()

    def same(a, b):
        if isinstance(a, dict):
            return a.keys() == b.keys() and all(same(a[k], b[k]) for k in a)
        if isinstance(a, (list, tuple)):
            return len(a) == len(b) and all(same(x, y) for x, y in zip(a, b))
        if isinstance(a, torch.Tensor):
            return torch.equal(a.cpu(), b.cpu())
        return a == b

    check(restored["steps"] == saved["steps"] == steps,
          f"resumed step counter {restored['steps']} vs saved "
          f"{saved['steps']}")
    check(same(restored["model"], saved["model"]), "resumed parameters "
          "differ from the saved ones")
    check(same(restored["optimizer"], saved["optimizer"]),
          "resumed optimizer state differs from the saved one")
    check(r2["steps"] == 1 and r2["trainer"].steps == steps + 1,
          f"resumed run: {r2['steps']} steps, counter {r2['trainer'].steps}")
    check(after["bce_fwd"] == 1 and after["bce_bwd"] == 1
          and after["bce_radius"] == 1, f"resumed step launches {after}")
    print(f"[loop] resumed from {os.path.basename(path)}: step counter "
          f"{restored['steps']}, parameters and optimizer state equal the "
          f"saved ones; one more step ran (counter {r2['trainer'].steps}, "
          f"launches {after})")
    os.environ.pop("OCC_PALLAS_BCE")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    print(smi[0])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    print(f"torch {torch.__version__} (CUDA {torch.version.cuda}), "
          f"{torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    phase_build()
    tot = phase_kernels(dev)
    phase_parity(dev)
    phase_parity_train(dev)
    phase_parity_bce(dev)
    phase_slice(dev)
    launches = phase_train(dev)
    with tempfile.TemporaryDirectory(prefix=".chip_smoke_",
                                     dir=os.path.dirname(
                                         os.path.abspath(__file__))) as tmp:
        loop_launches = phase_loop(dev, tmp)
    print(f"all phases passed in {time.perf_counter() - t0:.1f} s")

    src = "occuseg_tpu_torch/csrc/"
    pallas = "occuseg_tpu/ops/pallas/"

    def entry(name, key, source, replaces, n, **extra):
        r = tot.rows[key]
        return {"name": name, "route": "cuda", "source": src + source,
                "replaces": pallas + replaces, "launches": n,
                "max_abs_err": r["err"], "ms": r["ms"],
                "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                "bound_by": tot.bound_by(key),
                "library_ms": r["library_ms"], **extra}

    fused = launches["chunk_conv_bwd_fused"]
    grouped = launches["chunk_conv_bwd_fused_kgrouped"]
    print(json.dumps({"kernels": [
        entry("chunk_conv_fwd", "chunk_conv", "chunk_conv.cu",
              "chunk_conv.py:671", launches["chunk_conv"]),
        entry("blocked_segment_sum", "blocked_segment_sum", "segsum.cu",
              "segsum.py:67", launches["blocked_segment_sum"],
              shapes=tot.segsum_shapes),
        entry("chunk_conv_bwd_fused (#3 shapes)", "#3", "chunk_conv_bwd.cu",
              "chunk_conv.py:442", fused - grouped),
        entry("chunk_conv_bwd_fused (#4 shapes)", "#4", "chunk_conv_bwd.cu",
              "chunk_conv.py:568", grouped),
        entry("chunk_conv_dw", "chunk_conv_dw", "chunk_conv_bwd.cu",
              "chunk_conv.py:720", launches["chunk_conv_dw"]),
        # the training CLI's path: once each per step; beside them the
        # port's [P, I] chain, forward and backward (not a library call)
        entry("bce_radius", "bce_radius", "bce_loss.cu", "bce_loss.py:227",
              loop_launches["bce_radius"], cases=tot.radius_cases),
        entry("bce_fwd", "bce_fwd", "bce_loss.cu", "bce_loss.py:258",
              loop_launches["bce_fwd"], chain_ms=tot.chain_ms[0]),
        entry("bce_bwd", "bce_bwd", "bce_loss.cu", "bce_loss.py:289",
              loop_launches["bce_bwd"], max_abs_err_of=tot.bce_bwd_err_of,
              chain_ms=tot.chain_ms[1] - tot.chain_ms[0]),
        # no caller in either package: L3-L5 of the bench plan, summed
        entry("gather_conv", "gather_conv", "gather_conv.cu",
              "gather_conv.py:112", loop_launches["gather_conv"],
              levels=tot.gather_levels),
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
