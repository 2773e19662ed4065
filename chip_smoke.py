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
6. instance: the instance path (`occuseg_tpu_torch.cluster`,
   `occuseg_tpu_torch.evaluate_instance`), in [loop]'s directory: (a) the
   mean-shift parity cases of `tests/test_cluster_parity.py` on the card
   against the CPU (the same label ids) and the NumPy oracle of the
   reference cascade (`tests/cluster_oracle.py`: the same partitions), the
   merge cases against the oracle, and `aggregate_regions` at 200k points
   twice (the same bits) and against the CPU; (b) the evaluation CLI at
   m=64 with --use_merge, restored from [loop]'s checkpoint, over the 4
   synthetic val scenes: inline (33 + 1 launches a scene), --dump and
   --from_dump on the card (--from_dump's proposals and statistics equal
   the inline ones exactly), --from_dump on the CPU and its agreement with
   the card, and AP (printed, not gated); (c) the user's request on the
   bench scenes (seeds 0-2) with [slice]'s model at --region_cap 16384:
   ms of the plan, the forward (33 + 1 launches), the outputs to the host,
   `aggregate_regions`, the mean-shift (its instances and host reads,
   counted by torch's sync debug mode), the merge, the filtering and the
   statistics; then once more with --use_joint_refine.
7. data: the real-data training path, in its own temporary directory:
   (a) 5 synthetic scans with the bench scene's geometry (200k points,
   2 cm) in ScanNet's raw layout through `data.prepare.prepare_split`, 4
   to train/ and 1 to val/, with the ms of normals, supervoxels and whole
   scenes; (b) the gather conv (#9) over the orientation-permuted map at
   level 0 of the val scene's plan (guide_levels 1), at the normal-guided
   convolutions' widths, f32 and bf16, against its plain version and
   beside the chunk conv (#1) on the unpermuted map, and the PyTorch
   backward on the card against the CPU, repeated bit for bit; (c) the
   full-width --use_normal --use_feature cn model in f32 on the card and
   the CPU (eval outputs, one training step) with [parity]'s tolerances;
   (d) the training CLI with --use_normal --use_feature cn --use_elastic
   and OCC_PALLAS_BCE=1 for one epoch on the prepared directory: launches
   against the prediction (#9 at the guided level), finite losses, every
   parameter moved, checkpoint and semantic eval; the step timed on the
   epoch's batch with and without --use_normal, and profiled; (e) the
   import of a reference-layout .pth through --checkpoint_file for one
   step, the restored state equal to the tensors as mapped; (f)
   `evaluate_instance.main` on the prepared val scene from (d)'s
   checkpoint with --use_merge (AP printed, not gated).
8. gather: the gather-convolution path (`ops/conv.gather_conv`, the
   modules' route where a map has no chunk rulebook or the chunk kernels
   do not take its widths): (a) the gather conv (#9) with M output rows
   over N source rows at every transition of the benchmark plan, in the
   four roles of a strided convolution and a deconvolution (forward over
   the child / up map, d_feats over the other map reversed), bf16 and
   f32, against its plain version, launched twice (the same bits), with
   times and bounds; (b) the 33 f32 convolutions of one [loop] blocked
   plan through the gather path against the chunk path on the card
   (forward, d_feats, dW, all within the f32 tolerance); (c) the
   full-width model with the rulebooks of levels 1 and 3 and transition 2
   dropped, card against CPU with [parity]'s tolerances (outputs and the
   forward's launches, then a training step); (e) size-3 stride-2
   transitions (27 offsets): the plan's 33 f32 convolutions through the
   gather path against the chunk path on the card, then the full-width
   model with every chunk rulebook and with none, card against CPU in
   the same way (the step's gradients with the sensitivity rule of
   [data], over six input perturbations), the launches of the forward
   and of the training steps as the plan predicts; (d) the training CLI with --chunk_conv 0 at [loop]'s flags
   for one epoch: no chunk kernel, #9's launches as predicted (printed
   first), every parameter moved, the step beside [loop]'s, one step
   profiled.
9. ap_gate: the instance-AP gate (`occuseg_tpu_torch/tools/ap_gate.py`,
   the port of tests/test_accuracy_ap_gate.py) on the card: seeds 7, 8
   and 9, 450 steps each of the (8, 16, 24) model from the port's seeded
   weights, scored through the clustering cascade; per seed AP, final
   loss parts, median step ms and one step's launches (#9 at the 8- and
   24-wide convolutions, #1 at the 16-wide ones) against the prediction;
   the contraction; fails unless mean AP@0.5 > 0.6, each seed > 0.35 and
   the contraction < 1.5; then one step of a short soak, profiled (device
   busy against the median step).
10. planner (runs before ap_gate): the device planner
   (`core/topology.build_plan` on the card), the modules that need it and
   the step that plans on the card: (a) the device plan against the host
   planner without chunks, bit for bit (orientation classes except at
   near ties), `validate_plan` clean, on the bench scenes, the mid scene
   at size-3 transitions and one [data] scan with normals and
   guide_levels, its CUDA-event ms beside the host plan's and its host
   reads counted; (b) the plans only the device builds (dilation 2 with
   the nearest-neighbour search, the permutohedral lattice) against the
   same build on the CPU; (c) #9 in its new roles (K = 13, the dilated
   map, a FullConvolution's grown `up` map at L0 and L3 and its `child`
   backward), bf16 and f32, against its plain version, repeated bit for
   bit, timed beside the bound; (d) `Trainer(spec).step(batch,
   plan=None)` at full width in bf16 on the bench scenes: #9's launches
   as predicted, the step beside [train]'s and the plan's share of it,
   one step profiled; the f32 step over the device plan against the
   host plan without chunks (card against card), and card against CPU on
   the mid scene; (e) FullConvolution and a submanifold convolution on
   its grown level after the m=64 UNet's L0 output, and a permutohedral
   convolution, card against CPU.
   In [gather] (e), the step with every rulebook dropped also runs in
   float64 on the CPU: the card's and the CPU's f32 gradients are each
   measured against it.

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
import warnings

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

# `maps`: ("level", l) for a submanifold convolution at level l, ("child",
# t) / ("up", t) for the strided convolution / deconvolution of transition t
Conv = collections.namedtuple(
    "Conv", "label chunks t_chunks n_in n_act cin cout n_out n_out_act maps")


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
                  act[0], ("level", 0))]

    def sub(label, l, cin, cout):
        calls.append(Conv(label, lv[l].chunks, lv[l].chunks, caps[l], act[l],
                          cin, cout, caps[l], act[l], ("level", l)))

    def level(l):
        p = n_planes[l]
        for name in ("enc0.conv1", "enc0.conv2"):
            sub(f"{name} L{l}", l, p, p)
        if l + 1 == len(n_planes):
            return
        tr = plan.transitions[l]
        calls.append(Conv(f"down_conv L{l}->L{l + 1}", tr.child_chunks,
                          tr.up_chunks, caps[l], act[l], p, n_planes[l + 1],
                          caps[l + 1], act[l + 1], ("child", l)))
        level(l + 1)
        calls.append(Conv(f"up_conv L{l + 1}->L{l}", tr.up_chunks,
                          tr.child_chunks, caps[l + 1], act[l + 1],
                          n_planes[l + 1], p, caps[l], act[l], ("up", l)))
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


def guided(conv, plan) -> bool:
    """A submanifold convolution of a normal-guided model at a level whose
    plan carries orientation classes: it runs the gather conv (#9) over
    the permuted map, not the chunk kernels."""
    level = int(conv.label.rsplit("L", 1)[1])
    return conv.label.startswith(("sub", "enc", "dec")) \
        and plan.levels[level].guided


def chunked(conv) -> bool:
    """The convolution runs the chunk kernels (`nn/modules.chunk_route`);
    else the gather convolution (#9)."""
    from occuseg_tpu_torch.nn.modules import chunk_route
    return chunk_route(conv.chunks, conv.cout)


def gather_maps(plan, conv, dev):
    """(map, transpose map) of a convolution on the gather path, as
    `nn/modules.py` pairs them, as int32 tensors on `dev`."""
    kind, i = conv.maps
    t = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    if kind == "level":
        nbr = t(plan.levels[i].nbr)
        return nbr, nbr
    tr = plan.transitions[i]
    if kind == "child":
        return t(tr.child), t(tr.up).flip(1)
    return t(tr.up), t(tr.child).flip(1)


def predicted_launches(plan, esize: int = 2, bce: bool = False,
                       in_features: int = 3, normal_guided: bool = False,
                       n_planes=N_PLANES) -> dict:
    """Kernel launches of one training step on `plan` with activations of
    `esize` bytes: a chunked convolution's from its backward route, a
    convolution on the gather path one #9 forward and one #9 d_feats (none
    for the first convolution, whose input is data); the segment sum runs
    twice where the plan has the sorted point layout, the BCE kernels once
    each with `bce`. With `normal_guided`, the convolutions at the plan's
    guided levels launch #9 once each (their backward is PyTorch)."""
    calls = conv_calls(plan, n_planes, in_features)
    ng = [normal_guided and guided(c, plan) for c in calls]
    ch = [not g and chunked(c) for c, g in zip(calls, ng)]
    routes = collections.Counter(route_of(c, esize)
                                 for c, k in zip(calls, ch) if k)
    gather = sum(1 + (i > 0) for i, (g, k) in enumerate(zip(ng, ch))
                 if not g and not k)
    seg = 2 if plan.vox_seg is not None else 0
    return {"chunk_conv": sum(ch) + routes["#5"],
            "chunk_conv_bwd_fused": routes["#3"] + routes["#4"],
            "chunk_conv_bwd_fused_kgrouped": routes["#4"],
            "chunk_conv_dw": routes["#5"], "blocked_segment_sum": seg,
            "bce_radius": int(bce), "bce_fwd": int(bce),
            "bce_bwd": int(bce), "gather_conv": sum(ng) + gather}


def forward_launches(plan, n_planes=N_PLANES) -> dict:
    """Kernel launches of one eval forward on `plan`."""
    calls = conv_calls(plan, n_planes)
    n = sum(chunked(c) for c in calls)
    return {"chunk_conv": n, "gather_conv": len(calls) - n,
            "blocked_segment_sum": int(plan.vox_seg is not None)}


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
    tot.bench_plan = scene.plan
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


def forward_parity(dev, scene, model, phase="parity"):
    """The 7 eval outputs of `model` on a prepared scene, on the card
    (kernels) against the CPU (plain versions), within PARITY_TOL."""
    from occuseg_tpu_torch.infer import Predictor
    cpu_out = Predictor(model, "cpu")(scene)
    gpu_out = Predictor(model, dev)(scene)  # moves the model to the card
    torch.cuda.synchronize()
    for name in gpu_out._fields:
        g, c = getattr(gpu_out, name).cpu(), getattr(cpu_out, name)
        check(g.shape == c.shape, f"{phase} {name}: shapes differ")
        err = (g - c).abs().max().item()
        scale = c.abs().max().item()
        print(f"[{phase}] {name:<12} {tuple(c.shape)} max_abs_err={err:.3e} "
              f"max|cpu|={scale:.3e}")
        check(bool(torch.isfinite(g).all()), f"{phase} {name}: not finite")
        check(err <= PARITY_TOL * max(scale, 1.0),
              f"{phase} {name}: error {err} > {PARITY_TOL} x {scale}")


def phase_parity(dev):
    from occuseg_tpu_torch.core.topology import PlanSpec
    from occuseg_tpu_torch.infer import prepare_scene
    from occuseg_tpu_torch.models import LearningBWDenseUNet

    batch = _mid_scene()
    scene = prepare_scene(batch["coords"], batch["features"],
                          PlanSpec(caps=MID_CAPS))
    model = LearningBWDenseUNet(N_PLANES,
                                generator=torch.Generator().manual_seed(2))
    randomize_bn_stats(model, torch.Generator().manual_seed(3))
    forward_parity(dev, scene, model)


def phase_parity_train(dev):
    """One f32 training step on the mid scene, on the card and on the CPU
    from the same weights."""
    from occuseg_tpu_torch.core.topology import PlanSpec
    from occuseg_tpu_torch.models import LearningBWDenseUNet
    from occuseg_tpu_torch.train.state import prepare_batch

    laid, plan = prepare_batch(_mid_scene(), PlanSpec(caps=MID_CAPS))
    model = LearningBWDenseUNet(N_PLANES,
                                generator=torch.Generator().manual_seed(7))
    randomize_bn_stats(model, torch.Generator().manual_seed(8))
    train_step_parity(dev, laid, plan, model, 16)


def train_step_parity(dev, laid, plan, model, num_instances,
                      phase="parity", own_sensitivity=False, noise_runs=1,
                      spec=None, float64=False):
    """One f32 training step of `model` on a prepared batch, on the card
    (twice) and on the CPU (`noise_runs` more times, each with its own
    1e-6 input noise: the step's own sensitivity is the largest movement
    among them): loss parts within PARITY_TOL, gradients within GRAD_TOL
    of each tensor's max and GRAD_GLOBAL_TOL of the norm, the new BN
    statistics within PARITY_TOL. With `own_sensitivity`, a tensor whose
    gradient moves by more than GRAD_TOL / 5 of its max under the input
    noise on the CPU alone is held to five times that movement instead
    (the rule GRAD_TOL was set by, measured on this batch). With `plan`
    None, a raw batch is planned on each device at `spec`. With
    `float64`, the same step also runs in float64 on the CPU, and the
    card's and the CPU's f32 gradients are each measured against it
    (`float64_reference`)."""
    from occuseg_tpu_torch.train.state import Trainer

    def trainer(d):
        return Trainer(copy.deepcopy(model), d, num_instances=num_instances,
                       spec=spec)
    cpu, gpu2, gpu = (trainer(d) for d in ("cpu", dev, dev))
    t0 = time.perf_counter()
    cpu_parts = cpu.step(laid, plan)
    t1 = time.perf_counter()
    gpu_parts = gpu.step(laid, plan)
    gpu2.step(laid, plan)
    torch.cuda.synchronize()
    feats = torch.from_numpy(laid["features"])
    perturbed = []
    for i in range(noise_runs):
        noise = torch.randn(feats.shape, generator=torch.Generator()
                            .manual_seed(9 + i))
        perturbed.append(trainer("cpu"))
        perturbed[-1].step(dict(laid, features=(
            feats * (1 + 1e-6 * noise)).numpy()), plan)
    print(f"[{phase}] f32 train step: CPU {t1 - t0:.1f} s")
    for k, c in cpu_parts.items():
        g = float(gpu_parts[k])
        c = float(c)
        print(f"[{phase}] step {k:<20} card={g:.6f} cpu={c:.6f}")
        check(g == g and abs(g) != float("inf"), f"{phase} step {k}: {g}")
        tol = 1e-2 if k == "instance_iou" else PARITY_TOL * abs(c) + 1e-6
        check(abs(g - c) <= tol, f"{phase} step {k}: {g} vs {c}")

    def grads(trainer):
        return [p.grad.detach().cpu() for p in trainer.model.parameters()]

    names = [n for n, _ in cpu.model.named_parameters()]
    ref, card, card2 = (grads(t) for t in (cpu, gpu, gpu2))
    perts = [grads(t) for t in perturbed]

    def rel(a, b):
        return (a - b).abs().max().item() / max(b.abs().max().item(), 1e-30)

    def glob(a_list, b_list):
        num = sum(float(((a - b) ** 2).sum()) for a, b in zip(a_list, b_list))
        den = sum(float((b ** 2).sum()) for b in b_list)
        return (num / den) ** 0.5

    # per tensor: the largest movement under the input noise
    sens = [max(rel(p[i], r) for p in perts) for i, r in enumerate(ref)]
    rows = sorted(((rel(c, r), rel(c, c2), q, n)
                   for c, c2, q, r, n in zip(card, card2, sens, ref, names)),
                  reverse=True)
    for e_c, e_g, e_p, n in rows[:5]:
        print(f"[{phase}] step grad {n}: card vs CPU {e_c:.3e}; card vs card "
              f"{e_g:.3e}; CPU vs CPU with 1e-6 input noise {e_p:.3e}")
    g_c, g_g = glob(card, ref), glob(card2, card)
    g_p = max(glob(p, ref) for p in perts)
    print(f"[{phase}] step gradients, relative to each tensor's max: card "
          f"vs CPU max {rows[0][0]:.3e} median {rows[len(rows) // 2][0]:.3e} "
          f"over {len(rows)} tensors (CPU vs CPU with 1e-6 input noise: "
          f"max {max(r[2] for r in rows):.3e}); of the whole gradient's "
          f"norm: card vs CPU {g_c:.3e}, card vs card {g_g:.3e}, CPU "
          f"with noise {g_p:.3e} (the most of {noise_runs} runs)")
    check(g_c <= GRAD_GLOBAL_TOL, f"{phase} gradients: {g_c} of the norm")
    for c, r, q, n in zip(card, ref, sens, names):
        err = (c - r).abs().max().item()
        tol = max(GRAD_TOL, 5 * q) if own_sensitivity else GRAD_TOL
        check(err <= tol * r.abs().max().item() + GRAD_FLOOR,
              f"{phase} grad {n}: error {err} > {tol} x max")
    for (n, bc), (_, bg) in zip(cpu.model.named_buffers(),
                                gpu.model.named_buffers()):
        err = (bg.cpu() - bc).abs().max().item()
        check(err <= PARITY_TOL * bc.abs().max().item() + 1e-6,
              f"{phase} BN statistic {n}: error {err}")
    print(f"[{phase}] step: new BN statistics agree")
    if float64:
        return float64_reference(laid, plan, model, num_instances, spec,
                                 names, card, ref, phase)
    return None


def float64_reference(laid, plan, model, num_instances, spec, names, card,
                      cpu, phase):
    """The step of `train_step_parity` in float64 on the CPU (the model,
    its statistics and the batch's float arrays in f64; every op then
    accumulates in f64): each f32 gradient's error against it, the card's
    and the CPU's, per tensor (the largest printed) and over the whole
    gradient's norm. Rounding leaves the card's error of the CPU's order;
    the card's global error must stay within five times the CPU's."""
    import numpy as np
    from occuseg_tpu_torch.train.state import Trainer
    m64 = copy.deepcopy(model).double()
    for mod in m64.modules():
        if hasattr(mod, "compute_dtype"):
            mod.compute_dtype = torch.float64
    t64 = Trainer(m64, "cpu", num_instances=num_instances, spec=spec)
    b64 = {k: v.astype(np.float64) if getattr(v, "dtype", None) == np.float32
           else v for k, v in laid.items()}
    t0 = time.perf_counter()
    t64.step(b64, plan)
    g64 = [p.grad.detach() for p in t64.model.parameters()]
    secs = time.perf_counter() - t0

    def rel(a, r):
        return (a.double() - r).abs().max().item() / max(
            r.abs().max().item(), 1e-300)

    def glob(a_list):
        num = sum(float(((a.double() - r) ** 2).sum())
                  for a, r in zip(a_list, g64))
        return (num / sum(float((r ** 2).sum()) for r in g64)) ** 0.5

    rows = sorted(((rel(c, r), rel(q, r), n) for c, q, r, n
                   in zip(card, cpu, g64, names)), reverse=True)
    by_cpu = sorted(rows, key=lambda r: -r[1])
    for who, top in (("card", rows[:6]), ("CPU", by_cpu[:4])):
        for e_card, e_cpu, n in top:
            print(f"[{phase}] float64 reference, the {who}'s worst: grad "
                  f"{n}: card f32 {e_card:.3e}, CPU f32 {e_cpu:.3e} of its "
                  f"max")
    g_card, g_cpu = glob(card), glob(cpu)
    print(f"[{phase}] float64 reference ({secs:.1f} s on the CPU): the "
          f"whole gradient's error, card f32 {g_card:.3e}, CPU f32 "
          f"{g_cpu:.3e} of its norm; the worst tensor, card {rows[0][0]:.3e}"
          f" ({rows[0][2]}), CPU {by_cpu[0][1]:.3e} ({by_cpu[0][2]})")
    check(g_card <= 5 * g_cpu, f"{phase} float64 reference: the card's "
          f"gradient error {g_card} is past five times the CPU's {g_cpu}")
    return dict(card_global=g_card, cpu_global=g_cpu,
                worst=[dict(name=n, card=a, cpu=b)
                       for a, b, n in rows[:6] + by_cpu[:4]])


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
          f"profiler), device busy {busy:.2f} ms in "
          f"{sum(e.count for e in rows)} device activities of {len(rows)} "
          f"kinds")
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
    return launches, med


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
    return launches, result["ckpt_dir"], med, plans[0][1]


def parity_regions(seed, R=80, E=6, n_clusters=8):
    """Region-level inputs of the mean-shift parity cases (a copy of
    `tests/test_cluster_parity.py`'s `_make_regions`, which imports jax;
    `tests/test_torch_cluster.py` holds the two equal)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    centers_e = rng.normal(0, 3.0, (n_clusters, E))
    centers_p = rng.uniform(0, 5.0, (n_clusters, 3))
    assign = rng.integers(0, n_clusters, R)
    emb = (centers_e[assign] + rng.normal(0, 0.15, (R, E))).astype(
        np.float32)
    pose = (centers_p[assign] + rng.normal(0, 0.08, (R, 3))).astype(
        np.float32)
    bw = rng.uniform(0.8, 2.0, (R, 2)).astype(np.float32)
    offset = rng.uniform(0.1, 1.0, R).astype(np.float32)
    count = rng.integers(5, 200, R).astype(np.float32)
    semantic = rng.integers(0, 20, R).astype(np.int32)
    occupancy = np.log(count * rng.uniform(0.8, 3.0, R)).astype(np.float32)
    return dict(emb=emb, pose=pose, bw=bw, offset=offset, count=count,
                semantic=semantic, occupancy=occupancy)


def parity_merge_case(seed, R=60, n_clusters=10, E=6):
    """Inputs of the merge parity cases (a copy of
    `tests/test_cluster_parity.py`'s `_make_merge_case`)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    n_objects = n_clusters // 2
    centers_e = rng.normal(0, 3.0, (n_objects, E))
    centers_p = rng.uniform(0, 5.0, (n_objects, 3))
    cluster_obj = rng.integers(0, n_objects, n_clusters)
    cluster_of_region = rng.integers(0, n_clusters, R)
    cluster_of_region[rng.uniform(size=R) < 0.15] = -1
    obj = cluster_obj[np.clip(cluster_of_region, 0, None)]
    emb = (centers_e[obj] + rng.normal(0, 0.2, (R, E)))
    pose = (centers_p[obj] + rng.normal(0, 0.1, (R, 3)))
    bw = rng.uniform(0.5, 1.5, (R, 2))
    count = rng.integers(5, 80, R).astype(np.float64)
    occupancy = np.log(rng.uniform(100, 800, R))
    return (cluster_of_region, emb, pose, bw, count, occupancy)


# One epoch from random weights leaves the occupancy head near 0 (a
# log-size of ~1 point), and the default window (0.3, 3) of size over
# predicted size would then filter out every instance, leaving the
# proposals to compare empty: the window is opened.
OPEN_OCCUPANCY = ("--occupancy_lo", "0", "--occupancy_hi", "1e9")
INSTANCE_FLAGS = ("--m", "64", "--use_dense_model", "--residual_blocks",
                  "--use_merge", *OPEN_OCCUPANCY)
# the user's request on the bench scenes: regions arange // 16 over the
# 262,144 point rows, ~12.5k of them at 200k points
REQUEST_REGION_CAP = 16384


def _load_helper(name):
    """A NumPy helper module of `tests/`, loaded from its path (the card's
    machine may have another package named `tests`)."""
    import importlib.util
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                        name + ".py")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def canonical(labels):
    """Instance ids renumbered by first occurrence (-1 kept), so two
    numberings of one partition compare equal."""
    import numpy as np
    labels = np.asarray(labels)
    out = np.full(labels.shape, -1, np.int64)
    ids = labels[labels >= 0]
    uniq, first = np.unique(ids, return_index=True)
    rank = np.empty(len(uniq), np.int64)
    rank[np.argsort(first)] = np.arange(len(uniq))
    out[labels >= 0] = rank[np.searchsorted(uniq, ids)]
    return out


def same_result(a, b) -> bool:
    """Nested dicts and lists of arrays, exactly (NaN equal to NaN)."""
    import numpy as np
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(same_result(a[k], b[k])
                                            for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(same_result(x, y)
                                        for x, y in zip(a, b))
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and np.array_equal(
        a, b, equal_nan=a.dtype.kind == "f")


def host_reads(fn):
    """(fn(), the synchronising CUDA calls it made), counted by torch's
    sync debug mode."""
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            out = fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    return out, sum("synchroniz" in str(w.message).lower() for w in caught)


def instance_cases(dev):
    """(a) The cases of tests/test_cluster_parity.py on the card, against
    the same functions on the CPU (the same label ids) and the NumPy oracle
    of the reference cascade (the same partitions); `aggregate_regions` on
    a bench-size input twice (the same bits) and against the CPU."""
    import numpy as np
    from occuseg_tpu_torch.cluster import aggregate_regions, occupancy_merge
    from occuseg_tpu_torch.cluster.meanshift import meanshift_cluster
    from occuseg_tpu_torch.cluster.supervoxel import RegionFeatures
    oracle = _load_helper("cluster_oracle")

    def features(d, device):
        R = d["offset"].shape[0]
        return RegionFeatures(*(torch.as_tensor(x).to(device) for x in (
            d["emb"], d["pose"], d["bw"], d["offset"], d["count"],
            d["semantic"], d["occupancy"], d["pose"], np.ones(R, bool))))

    cases = [(f"seed {s}", parity_regions(s)) for s in range(10)]
    tie = parity_regions(99, R=40, n_clusters=4)
    tie["offset"][:] = 0.25
    tie["offset"][7] = 0.5
    tie["offset"][23] = 0.5
    background = parity_regions(3)
    background["semantic"][:10] = 0
    cases += [("tie", tie), ("background", background)]
    n_inst = []
    for name, d in cases:
        card, n_card = meanshift_cluster(features(d, dev), max_instances=50)
        cpu, n_cpu = meanshift_cluster(features(d, "cpu"), max_instances=50)
        ref, _ = oracle.meanshift_oracle(d["offset"], d["emb"], d["pose"],
                                         d["bw"], d["count"], d["semantic"],
                                         max_instances=50)
        check(n_card == n_cpu and torch.equal(card.cpu(), cpu),
              f"mean-shift {name}: card and CPU label ids differ")
        check(np.array_equal(canonical(card.cpu().numpy()), canonical(ref)),
              f"mean-shift {name}: partition differs from the oracle")
        n_inst.append(n_card)
    check(bool((card.cpu().numpy()[:10] == -1).all()),
          "background classes were clustered")
    for s in range(10):
        args = parity_merge_case(s)
        check(np.array_equal(occupancy_merge(*args),
                             oracle.merge_oracle(*args)),
              f"merge seed {s}: differs from the oracle")
    print(f"[instance] (a) mean-shift on the card: the 12 parity cases "
          f"({n_inst} instances) give the CPU's label ids and the oracle's "
          f"partitions; the 10 merge cases the oracle's")

    g = torch.Generator().manual_seed(7)
    P = 200_000
    region = torch.arange(P, dtype=torch.int32) // 16
    region[torch.rand(P, generator=g) < 0.02] = -1
    region[:64] = REQUEST_REGION_CAP + 5  # past the cap: dropped
    inputs = (torch.randn(P, 64, generator=g), torch.randn(P, 3, generator=g),
              torch.rand(P, 3, generator=g) * 5,
              torch.rand(P, 2, generator=g) + 0.5, torch.rand(P, generator=g),
              torch.randint(0, 20, (P,), generator=g, dtype=torch.int32),
              torch.randn(P, generator=g), region)
    on_card = [t.to(dev) for t in inputs]
    runs = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        runs.append(aggregate_regions(*on_card, REQUEST_REGION_CAP))
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
    check(all(torch.equal(a, b) for a, b in zip(*runs)),
          "aggregate_regions: two runs on the card gave other bits")
    cpu = aggregate_regions(*inputs, REQUEST_REGION_CAP)
    errs = {}
    for name, a, b in zip(cpu._fields, runs[0], cpu):
        a = a.cpu()
        if a.dtype.is_floating_point:
            err = (a - b).abs().max().item()
            errs[name] = err
            check(err <= 1e-6 + 1e-5 * b.abs().max().item(),
                  f"aggregate_regions {name}: card vs CPU {err:.3e}")
        else:
            check(torch.equal(a, b), f"aggregate_regions {name}: card vs CPU")
    print(f"[instance] (a) aggregate_regions at P={P}, r_cap="
          f"{REQUEST_REGION_CAP}: two runs on the card the same bits "
          f"({ms:.2f} ms); card vs CPU max abs err "
          + ", ".join(f"{k} {v:.2e}" for k, v in errs.items()))


def instance_cli(dev, tmp, ckpt_dir):
    """(b) The evaluation CLI at m=64 restored from [loop]'s checkpoint
    over the 4 synthetic val scenes, with --use_merge: inline, --dump and
    --from_dump on the card (--from_dump's proposals and statistics equal
    the inline ones exactly), --from_dump on the CPU beside it; the
    forward's launches; AP, printed and not gated."""
    import numpy as np
    from occuseg_tpu_torch import evaluate_instance as ei
    from occuseg_tpu_torch.infer import plan_scene
    from occuseg_tpu_torch.train import loop
    from occuseg_tpu_torch.train.config import args_to_config

    argv = [*INSTANCE_FLAGS, "--data_dir", os.path.join(tmp, "no_scenes"),
            "--checkpoint_file", ckpt_dir]
    config = args_to_config(ei.get_parser().parse_args(argv))
    spec = loop.build_spec(config)
    ds = loop._synthetic_dataset(config)
    expected = collections.Counter()
    for raw in ds.val_batches(config["point_cap"], config["instance_cap"],
                              1):
        vplan = plan_scene(raw["coords"], spec)
        expected.update({"chunk_conv": 33, "blocked_segment_sum":
                         int(vplan.vox_seg is not None)})
    work = os.path.join(tmp, "instance")
    os.makedirs(work)
    cwd = os.getcwd()
    os.chdir(work)  # main writes instance_stat.mat to the working directory
    try:
        torch.cuda.synchronize()
        zero_launches()
        t0 = time.perf_counter()
        inline = ei.main(argv, device=dev)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        launches = read_launches()
        check(os.path.isfile("instance_stat.mat"), "no instance_stat.mat")
        check(ei.main([*argv, "--dump", "dumps"], device=dev) is None,
              "--dump returned statistics")
        t2 = time.perf_counter()
        files = sorted(os.listdir("dumps"))
        from_dump = ei.main([*argv, "--from_dump", "dumps"], device=dev)
        t3 = time.perf_counter()
        on_cpu = ei.main([*argv, "--from_dump", "dumps"], device="cpu")
        t4 = time.perf_counter()
        scenes = [dict(np.load(os.path.join("dumps", f))) for f in files]
    finally:
        os.chdir(cwd)
    print(f"[instance] (b) m=64 CLI model from [loop]'s "
          f"{os.path.basename(loop.checkpoint_path(ckpt_dir))}, {len(files)}"
          f" val scenes: inline {t1 - t0:.1f} s, --dump "
          f"{t2 - t1:.1f} s, --from_dump {t3 - t2:.1f} s on the card, "
          f"{t4 - t3:.1f} s on the CPU")
    print(f"[instance] (b) launches inline {launches}, expected "
          f"{dict(expected)}")
    check({k: launches[k] for k in expected} == dict(expected)
          and sum(launches.values()) == sum(expected.values()),
          f"inline launches {launches}, expected {dict(expected)}")
    check(len(files) == 4, f"{len(files)} dumped scenes")
    check(same_result(from_dump, inline), "--from_dump's proposals or "
          "statistics differ from the inline ones")
    n_props = [sum(map(len, p)) for p in inline["proposals"]]
    print(f"[instance] (b) --from_dump on the card reproduces the inline "
          f"proposals {n_props} and statistics exactly")

    args = ei.get_parser().parse_args(argv)
    for i, scene in enumerate(scenes):
        tr_card, tr_cpu = {}, {}
        p_card, _, _ = ei.cluster_and_score(scene, args, dev, tr_card)
        p_cpu, _, _ = ei.cluster_and_score(scene, args, "cpu", tr_cpu)
        check(same_result(p_card, inline["proposals"][i]),
              f"scene {i}: proposals differ from the inline run's")
        same = float(np.mean(canonical(tr_card["labels"])
                             == canonical(tr_cpu["labels"])))
        print(f"[instance] (b) scene {i}: card vs CPU: instances "
              f"{tr_card['instances']} / {tr_cpu['instances']}, proposals "
              f"{sum(map(len, p_card))} / {sum(map(len, p_cpu))} (equal: "
              f"{same_result(p_card, p_cpu)}), points with the same "
              f"canonical label {100 * same:.2f}%")
    print(f"[instance] (b) card vs CPU --from_dump statistics equal: "
          f"{same_result(on_cpu, from_dump)}")
    for thr in (25, 50):
        ap = inline[f"ap_{thr}"]
        ok = np.isfinite(ap)
        print(f"[instance] (b) AP@0.{thr}: "
              f"{float(ap[ok].mean()) if ok.any() else 0.0:.4f} over "
              f"{int(ok.sum())} classes with ground truth (random weights, "
              f"one epoch; not gated)")


def instance_requests(dev):
    """(c) The user's request on the bench scenes (seeds 0-2) with
    [slice]'s model: host plan, forward (33 + 1 launches), the outputs to
    the host, then `cluster_and_score` part by part at --region_cap 16384
    with --use_merge, and the per-proposal statistics; the mean-shift's
    host reads counted by torch's sync debug mode. Then once more with
    --use_joint_refine."""
    import numpy as np
    from occuseg_tpu_torch import evaluate_instance as ei
    from occuseg_tpu_torch.cluster.evaluator import per_proposal_statistics
    from occuseg_tpu_torch.cluster.meanshift import meanshift_cluster
    from occuseg_tpu_torch.core.topology import PlanSpec
    from occuseg_tpu_torch.infer import Predictor, prepare_scene
    from occuseg_tpu_torch.models import LearningBWDenseUNet

    model = LearningBWDenseUNet(N_PLANES, compute_dtype=torch.bfloat16,
                                generator=torch.Generator().manual_seed(4))
    randomize_bn_stats(model, torch.Generator().manual_seed(5))
    predictor = Predictor(model, dev)
    spec = PlanSpec(caps=BENCH_CAPS)
    requests = [bench_scene(seed) for seed in (0, 1, 2)]

    def request(batch, args):
        times = {}
        t0 = time.perf_counter()
        scene = prepare_scene(batch["coords"], batch["features"], spec)
        t1 = time.perf_counter()
        out = predictor(scene)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        dump = ei.dump_scene(batch, out, float(args.scale))
        t3 = time.perf_counter()
        trace = {}
        props, gts, sem = ei.cluster_and_score(dump, args, dev, trace)
        t4 = time.perf_counter()
        per_proposal_statistics(props, gts, sem)
        t5 = time.perf_counter()
        times.update(plan_ms=1e3 * (t1 - t0), forward_ms=1e3 * (t2 - t1),
                     outputs_ms=1e3 * (t3 - t2), stats_ms=1e3 * (t5 - t4),
                     total_ms=1e3 * (t5 - t0))
        times.update({k: v for k, v in trace.items() if k.endswith("_ms")})
        return times, trace, props, dump

    flags = ["--region_cap", str(REQUEST_REGION_CAP), "--use_merge",
             *OPEN_OCCUPANCY]
    merge = ei.get_parser().parse_args(flags)
    refine = ei.get_parser().parse_args([*flags, "--use_joint_refine"])
    request(requests[0], merge)  # warm-up (allocator, first launches)
    torch.cuda.synchronize()
    zero_launches()
    for args in (merge, refine):
        mode = "joint refine" if args.use_joint_refine else "mean-shift"
        for seed, batch in zip((0, 1, 2), requests):
            before = read_launches()
            times, trace, props, dump = request(batch, args)
            after = read_launches()
            fwd = {k: after[k] - before[k] for k in after
                   if after[k] != before[k]}
            check(fwd == {"chunk_conv": 33, "blocked_segment_sum": 1},
                  f"seed {seed}: forward launches {fwd}, expected 33 + 1")
            regions = trace["regions"]
            n_reg = int(regions.valid.sum())
            check(n_reg == int(np.unique(dump["regions"]).size),
                  f"seed {seed}: {n_reg} regions")
            check(all(bool(torch.isfinite(t).all()) for t in regions
                      if t.dtype.is_floating_point),
                  f"seed {seed}: region features not finite")
            labels = trace["labels"]
            check(labels.shape == (dump["regions"].shape[0],)
                  and labels.max() <= 300 and trace["instances"] > 0,
                  f"seed {seed}: labels")
            reads = ""
            if not args.use_joint_refine:
                # the mean-shift again, alone, with its host reads counted
                (_, n), syncs = host_reads(
                    lambda: meanshift_cluster(regions))
                check(n == trace["instances"], "mean-shift repeated: "
                      f"{n} instances, then {trace['instances']}")
                check(syncs == n + (n < 300), f"mean-shift: {syncs} host "
                      f"reads for {n} instances")
                reads = f", {syncs} host reads"
                if seed == 0:  # the device's share of the mean-shift
                    busy = profile_step(lambda: meanshift_cluster(regions),
                                        "instance")
                    print(f"[instance] (c) mean-shift: device busy "
                          f"{busy:.2f} ms of {times['cluster_ms']:.1f} ms "
                          f"({100 * busy / times['cluster_ms']:.1f}%)")
            print(f"[instance] (c) {mode} seed {seed}: forward launches "
                  f"{fwd.get('chunk_conv', 0)} + "
                  f"{fwd.get('blocked_segment_sum', 0)} "
                  f"(predicted 33 + 1), {n_reg} regions, "
                  f"{trace['instances']} instances{reads}, "
                  f"{sum(map(len, props))} proposals; ms: "
                  + ", ".join(f"{k[:-3]} {v:.1f}" for k, v in times.items()))
    launches = read_launches()
    print(f"[instance] (c) launches over the 6 requests {launches}")
    check(launches["chunk_conv"] == 6 * 33
          and launches["blocked_segment_sum"] == 6,
          f"request launches {launches}")


def phase_instance(dev, tmp, ckpt_dir):
    instance_cases(dev)
    instance_cli(dev, tmp, ckpt_dir)
    instance_requests(dev)


# [data]: the real-data training path. The slice's command line (2 cm
# voxels, as the scans are prepared at), on synthetic scans in ScanNet's
# raw layout with the bench scene's geometry
DATA_FLAGS = ("--m", "64", "--use_dense_model", "--residual_blocks",
              "--use_normal", "--use_feature", "cn", "--use_elastic",
              "--scale", "50")
DATA_SEEDS = {"train": (0, 1, 2, 3), "val": (4,)}
DATA_SCENE = dict(num_points=200_000, extent=512, num_objects=24)
# the normal-guided convolutions at level 0 per forward, by Cin: sub (cn,
# 6 padded to 8), enc0.conv1/2 and dec0.conv2 (64), dec0.conv1 (128)
DATA_L0_CONVS = {8: 1, 64: 3, 128: 1}


def data_config(root, *extra):
    from occuseg_tpu_torch.train.config import args_to_config, get_parser
    return args_to_config(get_parser().parse_args(
        [*DATA_FLAGS, "--data_dir", root, *extra]))


def data_prepare(tmp):
    """(a) 5 synthetic scans (the bench scene's geometry: 200k points,
    extent 512 voxels, in metres at 2 cm) in ScanNet's raw layout through
    `prepare_split`, 4 to train/ and 1 to val/; the ms of one scene's
    normals and supervoxels, and of each whole scene."""
    import numpy as np
    from occuseg_tpu_torch.data import prepare, supervoxel_gen
    from occuseg_tpu_torch.data.synthetic import (
        SceneConfig, write_scannet_scan,
    )
    cfg = SceneConfig(**DATA_SCENE)
    root = os.path.join(tmp, "scannet")
    for split, seeds in DATA_SEEDS.items():
        for s in seeds:
            write_scannet_scan(os.path.join(tmp, "scans_" + split),
                               f"scene{s:04d}_00", cfg, s)
    v = prepare.read_ply(os.path.join(
        tmp, "scans_train", "scene0000_00", "scene0000_00_vh_clean_2.ply"))
    xyz = np.stack([v["x"], v["y"], v["z"]], 1).astype(np.float32)
    rgb = (np.stack([v["red"], v["green"], v["blue"]], 1).astype(
        np.float32) / 255.0 - 0.5) * 2
    t0 = time.perf_counter()
    supervoxel_gen.estimate_normals(xyz)
    t1 = time.perf_counter()
    region = supervoxel_gen.segment_supervoxels(xyz, rgb)
    t2 = time.perf_counter()
    per_scene = []
    for split in DATA_SEEDS:
        t = time.perf_counter()
        out = prepare.prepare_split(os.path.join(tmp, "scans_" + split),
                                    os.path.join(root, split))
        per_scene.append(1e3 * (time.perf_counter() - t) / len(out))
        check(len(out) == len(DATA_SEEDS[split]), f"{split}: {len(out)}")
    z = np.load(os.path.join(root, "train", "scene0000_00_instance.npz"))
    check(np.array_equal(z["region"], region), "prepared regions differ "
          "from the segmenter's")
    check(bool(np.isfinite(z["normals"]).all()), "normals not finite")
    n_lab = len(np.unique(z["labels"][z["labels"] >= 0]))
    print(f"[data] (a) prepared {sum(map(len, DATA_SEEDS.values()))} scans "
          f"of {xyz.shape[0]} points: normals {1e3 * (t1 - t0):.0f} ms, "
          f"supervoxels {1e3 * (t2 - t1):.0f} ms ({int(region.max()) + 1} "
          f"regions), whole scene (prepare_split, one process) "
          f"{', '.join(f'{t:.0f}' for t in per_scene)} ms (train, val); "
          f"{n_lab} classes, "
          f"{len(np.unique(z['instance_id'][z['instance_id'] >= 0]))} "
          f"instances in scene 0")
    return root


def data_conv(dev, root, tot):
    """(b) #9 over the permuted map at level 0 of one prepared scene's
    plan (guide_levels 1), at the widths the normal-guided convolutions
    take there, f32 and bf16, against its plain version, timed beside #1
    over the unpermuted map; the PyTorch backward on the card against the
    CPU, timed, and repeated bit for bit. These launches compare and are
    not counted."""
    import numpy as np
    import torch.nn.functional as F
    from occuseg_tpu_torch.infer import plan_scene
    from occuseg_tpu_torch.ops import normal_guide as ng
    from occuseg_tpu_torch.ops.kernels import chunk_conv as cc
    from occuseg_tpu_torch.ops.kernels import gather_conv as gc
    from occuseg_tpu_torch.train import loop

    config = data_config(root)
    ds = loop.get_dataset(config)
    raw = next(ds.val_batches(config["point_cap"], config["instance_cap"], 1))
    plan = plan_scene(raw["coords"], loop.build_spec(config),
                      normals=raw["normals"])
    lvl = plan.levels[0]
    check(lvl.guided and not plan.levels[1].guided, "guided levels")
    N, na = lvl.cap, lvl.num_active
    nbr = torch.from_numpy(lvl.nbr).to(dev)
    orient = torch.from_numpy(lvl.orient).to(dev)
    nbr_kn = ng.permute_neighbor_map(nbr, orient).t().contiguous()
    fi, fl = (torch.from_numpy(a).to(dev) for a in (lvl.chunks.in_idx,
                                                     lvl.chunks.lidx))
    classes = np.bincount(lvl.orient[:na], minlength=5)[[0, 2, 4]].tolist()
    nnz = int((nbr_kn >= 0).sum())
    print(f"[data] (b) level 0 of the val scene: {N} rows, {na} active, "
          f"orientation classes 0/2/4: {classes}, {nnz} neighbour "
          f"pairs ({nnz / max(na, 1):.1f} a site)")
    gen = torch.Generator().manual_seed(13)
    fwd = {}
    for cin, uses in DATA_L0_CONVS.items():
        x = torch.randn(N, cin, generator=gen)
        x[na:] = 0
        w = torch.randn(27, cin, 64, generator=gen) * (2 / (27 * cin)) ** .5
        for dt, tol, peak in ((torch.float32, F32_TOL, PEAK_F32),
                              (torch.bfloat16, BF16_TOL, PEAK_BF16)):
            xd, wd = x.to(dev, dt), w.to(dev, dt)
            pad = (-cin) % 16       # the chunk kernels' MMA depth
            xc, wc = F.pad(xd, (0, pad)), F.pad(wd, (0, 0, 0, pad))
            with torch.inference_mode():
                out = gc.gather_conv(xd, nbr_kn, wd)
                err, scale = check_close(f"[data] gather_conv L0 Cin={cin} "
                                         f"{dt}", out,
                                         gc.gather_conv_plain(xd, nbr_kn, wd),
                                         tol)
                check(torch.equal(out, gc.gather_conv(xd, nbr_kn, wd)),
                      f"gather_conv L0 Cin={cin}: other bits")
                ms = cuda_ms(lambda: gc.gather_conv(xd, nbr_kn, wd), 10)
                pms = cuda_ms(lambda: gc.gather_conv_plain(xd, nbr_kn, wd),
                              2)
                cms = cuda_ms(lambda: cc.chunk_conv(xc, fi, fl, wc), 10)
            flops = 2.0 * nnz * cin * 64
            nb = nbytes(xd, nbr_kn, wd, out)
            bnd, by = bound_ms(flops, nb, peak)
            print(f"[data] (b) gather_conv (#9) L0 Cin={cin}->64 {dt}: "
                  f"max_abs_err {err:.3e} (max|out| {scale:.3e}), two "
                  f"launches the same bits; kernel {ms:.4f} ms, chunk_conv "
                  f"(#1, unpermuted map) {cms:.4f} ms, plain {pms:.4f} ms, "
                  f"bound {bnd:.4f} ms ({by}); {uses} a forward")
            if dt == torch.float32:
                tot.add("gather_conv_cli", uses * ms, uses * pms, err,
                        uses * flops, uses * nb, PEAK_F32)
                fwd[cin] = dict(Cin=cin, uses=uses, ms=ms, plain_ms=pms,
                                chunk_conv_ms=cms, bound_ms=bnd)
            else:
                fwd[cin].update(bf16_ms=ms, bf16_chunk_conv_ms=cms)
    tot.gather_cli = list(fwd.values())
    tot.data_scan = (raw["coords"], raw["normals"], loop.build_spec(config))

    # the backward (PyTorch, no atomics), f32
    def fwd_bwd(x, w, g, nbr_, orient_):
        x, w = x.clone().requires_grad_(), w.clone().requires_grad_()
        out = ng.normal_guided_conv(x, nbr_, orient_, w)
        return torch.autograd.grad(out, (x, w), g)

    bwd_ms = 0.0
    for cin, uses in DATA_L0_CONVS.items():
        cin_in = 6 if cin == 8 else cin     # the first conv's cn
        x = torch.randn(N, cin_in, generator=gen)
        x[na:] = 0
        w = torch.randn(27, cin_in, 64, generator=gen)
        g = torch.randn(N, 64, generator=gen)
        g[na:] = 0
        xd, wd, gd = x.to(dev), w.to(dev), g.to(dev)
        card = fwd_bwd(xd, wd, gd, nbr, orient)
        card2 = fwd_bwd(xd, wd, gd, nbr, orient)
        check(all(torch.equal(a, b) for a, b in zip(card, card2)),
              f"normal-guided backward Cin={cin_in}: other bits")
        both = cuda_ms(lambda: fwd_bwd(xd, wd, gd, nbr, orient), 3)
        with torch.no_grad():
            f_ms = cuda_ms(lambda: ng.normal_guided_conv(xd, nbr, orient, wd),
                           3)
        bwd_ms += uses * (both - f_ms)
        msg = ""
        if cin == 64:
            t0 = time.perf_counter()
            cpu = fwd_bwd(x, w, g, nbr.cpu(), orient.cpu())
            t_cpu = time.perf_counter() - t0
            errs = [check_close(f"[data] normal-guided backward {name}",
                                a.cpu(), b, tol)
                    for name, a, b, tol in zip(("d_feats", "dW"), card, cpu,
                                               (F32_TOL, DW_TOL))]
            msg = (f"; card vs CPU ({t_cpu:.1f} s): d_feats "
                   f"{errs[0][0]:.3e} (max {errs[0][1]:.3e}), dW "
                   f"{errs[1][0]:.3e} (max {errs[1][1]:.3e})")
        print(f"[data] (b) normal-guided conv L0 Cin={cin_in}->64 f32: "
              f"forward {f_ms:.3f} ms, forward + backward {both:.3f} ms, "
              f"two backwards the same bits{msg}")
    print(f"[data] (b) per step at level 0: #9 forwards "
          f"{tot.rows['gather_conv_cli']['ms']:.3f} ms (f32), the "
          f"normal-guided backwards {bwd_ms:.3f} ms")
    tot.ng_bwd_ms = bwd_ms
    torch.cuda.empty_cache()


def data_parity(dev, root):
    """(c) The full-width normal-guided model (m=64, cn) on the prepared
    val scene (32,768 of its points: the CPU's share of the phase) in f32
    on the card and on the CPU from the same weights: the 7 eval outputs,
    then one training step, with [parity]'s tolerances."""
    from occuseg_tpu_torch.infer import prepare_scene
    from occuseg_tpu_torch.train import loop
    from occuseg_tpu_torch.train.state import prepare_batch

    config = data_config(root, "--point_cap", "32768", "--voxel_cap",
                         "32768")
    spec = loop.build_spec(config)
    ds = loop.get_dataset(config)
    raw = next(ds.val_batches(config["point_cap"], config["instance_cap"], 1))
    scene = prepare_scene(raw["coords"], raw["features"], spec,
                          raw["normals"])
    check(scene.plan.levels[0].guided, "no orientation at level 0")
    model = loop.build_model(config, torch.Generator().manual_seed(12))
    randomize_bn_stats(model, torch.Generator().manual_seed(14))
    print(f"[data] (c) val scene, {scene.num_points} points, active "
          f"voxels per level {[l.num_active for l in scene.plan.levels]}, "
          f"caps {spec.caps}")
    forward_parity(dev, scene, model, "data")
    laid, plan = prepare_batch(raw, spec)
    # 32,768 of 200k points leave the coarse levels a few hundred sparse
    # voxels: BN over them makes single gradients there as sensitive to
    # rounding as to 1e-6 input noise (8.5e-2 of a tensor's max on the
    # CPU alone, H100 80GB HBM3 at 700 W), so each tensor is held to five
    # times its own measured sensitivity, and the whole to GRAD_GLOBAL_TOL
    train_step_parity(dev, laid, plan, model, config["instance_cap"], "data",
                      own_sensitivity=True)


def data_cli(dev, root, tmp):
    """(d) The training CLI on the prepared directory: one epoch, f32,
    OCC_PALLAS_BCE=1, 4 plan threads. The launches against those the
    model and the plans predict, finite losses, every parameter moved,
    the checkpoint and the semantic eval; then the step timed on the
    epoch's batch with and without --use_normal, in turns, and profiled."""
    import numpy as np
    from occuseg_tpu_torch.infer import plan_scene
    from occuseg_tpu_torch.train import cli, loop
    from occuseg_tpu_torch.train.state import Trainer, pinned, prepare_batch

    os.environ["OCC_PALLAS_BCE"] = "1"
    argv = [*DATA_FLAGS, "--plan_workers", "4", "--max_epoch", "1",
            "--data_dir", root, "--checkpoints_dir",
            os.path.join(tmp, "ckpts_data")]
    config = data_config(root, *argv[len(DATA_FLAGS):])
    spec = loop.build_spec(config)
    ds = loop.get_dataset(config)
    ns, fin = config["batch_size"], config["input_feature_number"]
    rng = np.random.default_rng(100)   # the loop's seed: the same batches
    expected = collections.Counter()
    batches = []
    for batch in ds.train_batches(rng, config["point_cap"],
                                  config["instance_cap"], ns):
        t0 = time.perf_counter()
        laid, plan = prepare_batch(batch, spec, ns)
        t_plan = 1e3 * (time.perf_counter() - t0)
        pred = predicted_launches(plan, esize=4, bce=True, in_features=fin,
                                  normal_guided=True)
        expected.update(pred)
        batches.append((batch, laid, plan))
        print(f"[data] (d) batch of {ns} scenes: level-0 voxels "
              f"{plan.levels[0].num_active.tolist()} (sub-cap "
              f"{plan.levels[0].cap // ns}), host plan {t_plan:.0f} ms; "
              f"predicted launches per step {pred}")
    for raw in ds.val_batches(config["point_cap"], config["instance_cap"],
                              1):
        vplan = plan_scene(raw["coords"], spec, normals=raw["normals"])
        n_ng = sum(guided(c, vplan) for c in conv_calls(vplan, N_PLANES,
                                                         fin))
        expected.update({k: 2 * v for k, v in {   # snapshot + CLI evals
            "chunk_conv": 33 - n_ng, "gather_conv": n_ng,
            "blocked_segment_sum": int(vplan.vox_seg is not None)}.items()})
    init = loop.build_model(config, torch.Generator().manual_seed(0))
    torch.cuda.synchronize()
    zero_launches()
    t0 = time.perf_counter()
    result = cli.main(argv, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    trainer = result["trainer"]
    moved = sum(not torch.equal(p.detach().cpu(), q)
                for p, q in zip(trainer.model.parameters(),
                                init.parameters()))
    n_params = len(list(init.parameters()))
    print(f"[data] (d) cli.main: {result['steps']} step(s) + 2 evals in "
          f"{wall:.1f} s; step ms {result['timings']['step_ms']}, waits "
          f"{result['timings']['wait_ms']} ms; losses {result['losses']}; "
          f"val mean IoU {result['metrics']['mean_iou']:.4f}; {moved} of "
          f"{n_params} parameter tensors moved")
    print(f"[data] (d) launches {launches}, expected {dict(expected)}")
    check(result["steps"] == len(batches), f"{result['steps']} steps")
    check(all(v == v and abs(v) != float("inf")
              for v in result["losses"].values()), "losses not finite")
    check(moved == n_params, f"only {moved} of {n_params} moved")
    check(launches == dict(expected), f"data launches {launches}, expected "
          f"{dict(expected)}")
    check(launches["gather_conv"] > 0, "#9 was not launched")
    check(os.path.isfile(os.path.join(result["ckpt_dir"], "step_1.pth")),
          "no checkpoint")
    check(0.0 <= result["metrics"]["mean_iou"] <= 1.0, "eval mean IoU")

    # the step on the epoch's batch, with and without --use_normal
    batch = batches[0][0]
    runs = {}
    for use_normal in (False, True):
        cfg = dict(config, use_normal=use_normal)
        laid, plan = prepare_batch(batch, loop.build_spec(cfg), ns)
        t = Trainer(loop.build_model(cfg, torch.Generator().manual_seed(0)),
                    dev, num_instances=config["instance_cap"],
                    num_scenes=ns)
        runs[use_normal] = (t, pinned(laid, plan), [])
        t.step(*runs[use_normal][1])   # warm-up
    for use_normal in (False, True, True, False):
        t, args, times = runs[use_normal]
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            parts = t.step(*args)
            float(parts["total"])
            times.append(1e3 * (time.perf_counter() - t0))
    med = {k: sorted(v[2])[len(v[2]) // 2] for k, v in runs.items()}
    print(f"[data] (d) step on the epoch's batch (f32, 6 steps each, in "
          f"turns): --use_normal {med[True]:.1f} ms "
          f"({', '.join(f'{x:.1f}' for x in runs[True][2])}), without "
          f"{med[False]:.1f} ms "
          f"({', '.join(f'{x:.1f}' for x in runs[False][2])})")
    busy = {k: profile_step(lambda: runs[k][0].step(*runs[k][1]),
                            "data") for k in (True, False)}
    for k in (True, False):
        print(f"[data] (d) {'with' if k else 'without'} --use_normal: "
              f"device busy {busy[k]:.2f} ms of the median step "
              f"{med[k]:.2f} ms ({100 * busy[k] / med[k]:.1f}%)")
    os.environ.pop("OCC_PALLAS_BCE")
    return launches, result["ckpt_dir"]


def data_import(dev, root, tmp):
    """(e) A synthetic state dict in the reference's layout (random
    tensors under the name map's keys, shaped like the port's tensors: a
    Linear weight [out, in] is the reference's layout too), saved with
    torch.save, loaded by the training CLI's --checkpoint_file for one
    step: the restored weights and BN statistics equal the tensors as
    mapped."""
    from occuseg_tpu_torch.train import loop
    from occuseg_tpu_torch.train.checkpoint import import_torch_state_dict
    from occuseg_tpu_torch.train.torch_import import learning_bw_name_map

    config = data_config(root, "--checkpoints_dir",
                         os.path.join(tmp, "ckpts_import"))
    model = loop.build_model(config)
    ref = model.state_dict()
    name_map = learning_bw_name_map(config["unet_structure"],
                                    config["block_reps"],
                                    config["residual_blocks"])
    gen = torch.Generator().manual_seed(15)
    sd = {}
    for tkey, fpath in name_map.items():
        p = fpath.split("/")
        key = ".".join(p[:-1] + ["weight" if p[-1] == "kernel" else p[-1]])
        t = torch.randn(ref[key].shape, generator=gen) * 0.1
        sd[tkey] = t.abs() + 0.5 if tkey.endswith("running_var") else t
    path = os.path.join(tmp, "baseline_m64.pth")
    torch.save(sd, path)
    restored = {}
    r = loop.train(dict(config, load=path), max_steps=1, device=dev,
                   on_start=lambda t: restored.update(
                       copy.deepcopy(t.state_dict())))
    torch.cuda.synchronize()
    mapped = import_torch_state_dict(sd, model, name_map)
    check(set(restored["model"]) == set(mapped), "imported keys")
    check(all(torch.equal(restored["model"][k].cpu(), v)
              for k, v in mapped.items()),
          "restored parameters differ from the tensors as mapped")
    check(restored["steps"] == 0 and not restored["optimizer"]["state"],
          "the import carried optimizer state")
    check(r["steps"] == 1 and all(v == v for v in r["losses"].values()),
          f"import step {r['steps']} {r['losses']}")
    print(f"[data] (e) imported {len(sd)} reference tensors from "
          f"{os.path.basename(path)}: the restored state equals them as "
          f"mapped; one step ran, losses {r['losses']}")


def data_evaluate(dev, root, tmp, ckpt_dir):
    """(f) `evaluate_instance.main` inline on the prepared val scene with
    (d)'s checkpoint and --use_merge; no normals, as the JAX script (see
    evaluate_instance.infer_scenes). AP printed, not gated."""
    import numpy as np
    from occuseg_tpu_torch import evaluate_instance as ei

    argv = [*DATA_FLAGS, "--data_dir", root, "--checkpoint_file", ckpt_dir,
            "--use_merge", *OPEN_OCCUPANCY]
    work = os.path.join(tmp, "data_eval")
    os.makedirs(work)
    cwd = os.getcwd()
    os.chdir(work)  # main writes instance_stat.mat to the working directory
    try:
        zero_launches()
        t0 = time.perf_counter()
        res = ei.main(argv, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        os.chdir(cwd)
    launches = read_launches()
    check(launches["gather_conv"] == 0 and launches["chunk_conv"] == 33,
          f"evaluation launches {launches}")
    aps = {}
    for thr in (25, 50):
        ap = res[f"ap_{thr}"]
        ok = np.isfinite(ap)
        aps[thr] = float(ap[ok].mean()) if ok.any() else 0.0
    props = [sum(map(len, p)) for p in res["proposals"]]
    print(f"[data] (f) evaluate_instance on the prepared val scene: "
          f"{wall:.1f} s, proposals {props}, launches {launches}; AP@0.25 "
          f"{aps[25]:.4f}, AP@0.5 {aps[50]:.4f} (random weights, one step; "
          f"not gated)")


def phase_data(dev, tmp, tot):
    """[data]: the real-data path, (a)-(f) above. Returns the launches of
    (d)'s CLI run."""
    root = data_prepare(tmp)
    data_conv(dev, root, tot)
    data_parity(dev, root)
    launches, ckpt_dir = data_cli(dev, root, tmp)
    data_import(dev, root, tmp)
    data_evaluate(dev, root, tmp, ckpt_dir)
    return launches


def gather_roles(dev, tot):
    """(a) #9 in the gather path's roles at every transition of the bench
    plan (its caps and widths): the strided convolution's forward over the
    child map (coarse rows over the fine level) and its d_feats over the
    up map reversed (fine rows over the coarse cotangent); the
    deconvolution's forward over the up map and its d_feats over the child
    map reversed. bf16 and f32, each against its plain version, launched
    twice (the same bits), CUDA-event times and bounds. These launches
    compare and are not counted."""
    from occuseg_tpu_torch.ops.kernels import gather_conv as gc
    plan = tot.bench_plan
    gen = torch.Generator().manual_seed(21)
    rows, sums = [], collections.defaultdict(float)
    with torch.inference_mode():
        for t, tr in enumerate(plan.transitions):
            p_f, p_c = N_PLANES[t], N_PLANES[t + 1]
            n_f, n_c = plan.levels[t].cap, plan.levels[t + 1].cap
            a_f = plan.levels[t].num_active
            a_c = plan.levels[t + 1].num_active
            for role, nbr, n_src, a_src, cin, cout in (
                    ("down fwd (child)", tr.child, n_f, a_f, p_f, p_c),
                    ("down d_feats (up reversed)", tr.up[:, ::-1], n_c, a_c,
                     p_c, p_f),
                    ("up fwd (up)", tr.up, n_c, a_c, p_c, p_f),
                    ("up d_feats (child reversed)", tr.child[:, ::-1], n_f,
                     a_f, p_f, p_c)):
                nbr_kn = torch.from_numpy(nbr.T.copy()).to(dev)
                M = nbr_kn.shape[1]
                nnz = int((nbr_kn >= 0).sum())
                x = torch.randn(n_src, cin, generator=gen)
                x[a_src:] = 0
                w = torch.randn(8, cin, cout, generator=gen) \
                    * (2 / (8 * cin)) ** .5
                row = dict(transition=t, role=role, M=M, N=n_src, Cin=cin,
                           Cout=cout, pairs=nnz)
                for dt, tol, peak, reps in (
                        (torch.bfloat16, BF16_TOL, PEAK_BF16, (10, 2)),
                        (torch.float32, F32_TOL, PEAK_F32, (5, 1))):
                    xd, wd = x.to(dev, dt), w.to(dev, dt)
                    name = f"L{t}->L{t + 1} {role} {str(dt)[6:]}"
                    out = gc.gather_conv(xd, nbr_kn, wd)
                    check(out.shape == (M, cout), f"[gather] {name} shape")
                    err, scale = check_close(
                        f"[gather] {name}", out,
                        gc.gather_conv_plain(xd, nbr_kn, wd), tol)
                    check(torch.equal(out, gc.gather_conv(xd, nbr_kn, wd)),
                          f"[gather] {name}: a second launch gave other bits")
                    ms = cuda_ms(lambda: gc.gather_conv(xd, nbr_kn, wd),
                                 reps[0])
                    pms = cuda_ms(lambda: gc.gather_conv_plain(
                        xd, nbr_kn, wd), reps[1])
                    flops = 2.0 * nnz * cin * cout
                    bnd, by = bound_ms(flops, nbytes(xd, nbr_kn, wd, out),
                                       peak)
                    key = str(dt)[6:]
                    row.update({f"{key}_ms": ms, f"{key}_plain_ms": pms,
                                f"{key}_bound_ms": bnd,
                                f"{key}_max_abs_err": err})
                    sums[f"{key}_ms"] += ms
                    sums[f"{key}_plain_ms"] += pms
                    sums[f"{key}_bound_ms"] += bnd
                    print(f"[gather] (a) #9 {name:<40} M={M:<6} N={n_src:<6}"
                          f" Cin={cin:<3} Cout={cout:<3} pairs={nnz:<7} "
                          f"max_abs_err={err:.3e} max|out|={scale:.3e} "
                          f"kernel={ms:.4f} ms plain={pms:.4f} ms bound="
                          f"{bnd:.4f} ms ({by}); two launches the same bits")
                rows.append(row)
    print(f"[gather] (a) the 20 maps of the 5 transitions, sums: "
          + ", ".join(f"{k} {v:.4f}" for k, v in sums.items()))
    tot.gather_roles = dict(maps=rows, **sums)
    torch.cuda.empty_cache()


def gather_vs_chunk(dev, host_plan, tag="(b)"):
    """The 33 f32 convolutions of a plan (in (b) one [loop] blocked plan)
    through `ops/conv.gather_conv` (#9 forward and d_feats, PyTorch dW)
    against the chunk path on the card (#1, #3-#5), which computes the
    same function: outputs, d_feats and dW within F32_TOL. Not
    counted."""
    from occuseg_tpu_torch.core.sparse_tensor import active_mask
    from occuseg_tpu_torch.ops import conv as conv_ops
    from occuseg_tpu_torch.ops.kernels import chunk_conv as cc
    plan = host_plan.to(dev)
    calls = conv_calls(plan, N_PLANES)
    gen = torch.Generator().manual_seed(22)
    worst = collections.defaultdict(float)
    for cv in calls:
        check(cv.chunks is not None, f"[gather] {tag} {cv.label}: no chunk "
              f"plan")
        K = cv.chunks.lidx.shape[1]
        x = torch.randn(cv.n_in, cv.cin, generator=gen)
        x[~active_mask(cv.n_act, cv.n_in)] = 0
        w = torch.randn(K, cv.cin, cv.cout, generator=gen) \
            * (2 / (cv.cin * K)) ** .5
        ct = torch.randn(cv.n_out, cv.cout, generator=gen)
        ct[~active_mask(cv.n_out_act, cv.n_out)] = 0
        nbr, nbr_t = gather_maps(plan, cv, dev)
        res = []
        for path in ("chunk", "gather"):
            xd = x.to(dev).requires_grad_()
            wd = w.to(dev).requires_grad_()
            if path == "gather":
                out = conv_ops.gather_conv(xd, nbr, wd, nbr_t=nbr_t)
            elif cv.maps[0] == "level":
                out = cc.chunk_gather_conv(xd, cv.chunks.in_idx,
                                           cv.chunks.lidx, wd)
            else:
                out = cc.chunk_gather_conv_t(
                    xd, cv.chunks.in_idx, cv.chunks.lidx,
                    cv.t_chunks.in_idx, cv.t_chunks.lidx, wd)
            out.backward(ct.to(dev))
            res.append((out.detach(), xd.grad, wd.grad))
        errs = {}
        for key, a, b, tol in zip(("forward", "d_feats", "dW"), res[1],
                                  res[0], (F32_TOL,) * 3):
            err, scale = check_close(f"[gather] {tag} {key} {cv.label}", a,
                                     b, tol)
            errs[key] = err / max(scale, 1e-30)
            worst[key] = max(worst[key], errs[key])
        print(f"[gather] {tag} {cv.label:<22} rows {cv.n_in}->{cv.n_out} "
              f"gather path vs chunk path, error/max: "
              + ", ".join(f"{k} {v:.1e}" for k, v in errs.items()))
        del res
    print(f"[gather] {tag} 33 convolutions: the gather path equals the chunk "
          f"path (f32; worst error/max "
          + ", ".join(f"{k} {v:.1e}" for k, v in worst.items()) + ")")
    torch.cuda.empty_cache()


def drop_chunks(plan, levels=(1, 3), transitions=(2,)):
    """The plan without the chunk rulebooks of `levels` and
    `transitions`: their convolutions take the gather path."""
    import dataclasses
    return dataclasses.replace(
        plan,
        levels=tuple(dataclasses.replace(l, chunks=None) if i in levels
                     else l for i, l in enumerate(plan.levels)),
        transitions=tuple(dataclasses.replace(t, child_chunks=None,
                                              up_chunks=None)
                          if i in transitions else t
                          for i, t in enumerate(plan.transitions)))


def gather_parity(dev):
    """(c) The full-width model on the mid scene with the chunk rulebooks
    of levels 1 and 3 and transition 2 dropped (the fallback, both routes
    in one forward): card vs CPU with [parity]'s tolerances, on the eval
    outputs (with the forward's launches), then one training step."""
    import dataclasses
    from occuseg_tpu_torch.core.topology import PlanSpec
    from occuseg_tpu_torch.infer import prepare_scene
    from occuseg_tpu_torch.models import LearningBWDenseUNet
    from occuseg_tpu_torch.train.state import prepare_batch

    batch = _mid_scene()
    scene = prepare_scene(batch["coords"], batch["features"],
                          PlanSpec(caps=MID_CAPS))
    scene = dataclasses.replace(scene, plan=drop_chunks(scene.plan))
    want = forward_launches(scene.plan)
    print(f"[gather] (c) the mid scene with the rulebooks of L1, L3 and "
          f"transition 2 dropped; predicted launches of a forward {want}")
    model = LearningBWDenseUNet(N_PLANES,
                                generator=torch.Generator().manual_seed(23))
    randomize_bn_stats(model, torch.Generator().manual_seed(24))
    zero_launches()
    forward_parity(dev, scene, model, phase="gather")
    got = {k: v for k, v in read_launches().items() if v}
    print(f"[gather] (c) forward launches {got}")
    check(got == {k: v for k, v in want.items() if v},
          f"[gather] (c) forward launches {got}, expected {want}")
    laid, plan = prepare_batch(_mid_scene(), PlanSpec(caps=MID_CAPS))
    model = LearningBWDenseUNet(N_PLANES,
                                generator=torch.Generator().manual_seed(25))
    randomize_bn_stats(model, torch.Generator().manual_seed(26))
    train_step_parity(dev, laid, drop_chunks(plan), model, 16,
                      phase="gather")
    torch.cuda.empty_cache()


# size-3 transitions on the mid scene: the caps hold every level's sites
# (a size-3 window reaches more coarse sites than a size-2 one)
SIZE3_CAPS = (16_128, 12_288, 4_096, 1_024, 256, 128)


def gather_size3(dev):
    """(e) Size-3 stride-2 transitions (27 offsets each,
    `PlanSpec(down_size=3, down_stride=2)`) on the mid scene: the plan's
    33 f32 convolutions through the gather path against the chunk path on
    the card, as (b); then the full-width model's eval forward and one
    training step, card against CPU with [parity]'s tolerances, once with
    every chunk rulebook (the 27-offset transitions on #1 and #3-#5 as
    transpose plans) and once with all of them dropped (every convolution
    on #9, M != N at K = 27 for the transitions). The forward's launches
    and the two card steps' are checked against the plan's prediction.

    The step's gradients are held as [data] holds its batch's
    (`own_sensitivity`), over six perturbations of the input: with every
    rulebook dropped the card's gradients of L3's and L4's dec0.conv1
    differ from the CPU's by 0.082 and 0.056 of their max (H100 80GB
    HBM3, 700 W), and one 1e-6 perturbation moves the CPU's own L4 tensor
    by 0.0098 but six move it by up to 0.057 (L3's by up to 0.083). The
    convolutions themselves are held to F32_TOL above."""
    import dataclasses
    from occuseg_tpu_torch.core.topology import PlanSpec
    from occuseg_tpu_torch.infer import prepare_scene
    from occuseg_tpu_torch.models import LearningBWDenseUNet
    from occuseg_tpu_torch.train.state import prepare_batch

    spec = PlanSpec(caps=SIZE3_CAPS, down_size=3, down_stride=2)
    batch = _mid_scene()
    scene = prepare_scene(batch["coords"], batch["features"], spec)
    laid, plan = prepare_batch(_mid_scene(), spec)
    L = len(SIZE3_CAPS)
    check(all(l.num_active < l.cap for l in plan.levels),
          f"[gather] (e) a level fills its cap "
          f"{[l.num_active for l in plan.levels]}")
    check(all(t.child.shape[1] == 27 and t.child_chunks is not None
              for t in plan.transitions), "[gather] (e) transitions")
    gather_vs_chunk(dev, plan, "(e)")
    out = {}
    for case, drop in (("chunked", False), ("dropped", True)):
        def cut(p):
            return drop_chunks(p, range(L), range(L - 1)) if drop else p
        sc = dataclasses.replace(scene, plan=cut(scene.plan))
        want_fwd = {k: v for k, v in forward_launches(sc.plan).items() if v}
        want_step = {k: 2 * v for k, v in predicted_launches(
            cut(plan), esize=4, bce=os.environ.get("OCC_PALLAS_BCE") == "1"
        ).items()}
        print(f"[gather] (e) size 3, stride 2, {case}: voxels per level "
              f"{[l.num_active for l in plan.levels]}; predicted launches "
              f"of a forward {want_fwd}, of two training steps {want_step}")
        model = LearningBWDenseUNet(
            N_PLANES, down_size=3, down_stride=2,
            generator=torch.Generator().manual_seed(27))
        randomize_bn_stats(model, torch.Generator().manual_seed(28))
        zero_launches()
        forward_parity(dev, sc, model, phase="gather")
        got = {k: v for k, v in read_launches().items() if v}
        check(got == want_fwd, f"[gather] (e) {case} forward launches "
              f"{got}, expected {want_fwd}")
        model = LearningBWDenseUNet(
            N_PLANES, down_size=3, down_stride=2,
            generator=torch.Generator().manual_seed(29))
        randomize_bn_stats(model, torch.Generator().manual_seed(30))
        zero_launches()
        f64 = train_step_parity(dev, laid, cut(plan), model, 16,
                                phase="gather", own_sensitivity=True,
                                noise_runs=6, float64=drop)
        step = read_launches()
        print(f"[gather] (e) {case}: forward launches {got}; two card steps "
              f"launched {step}")
        check(step == want_step, f"[gather] (e) {case} step launches "
              f"{step}, expected {want_step}")
        out[case] = dict(forward=got, two_steps=step)
        if f64:
            out[case]["float64_reference"] = f64
    torch.cuda.empty_cache()
    return out


def gather_cli(dev, tmp, loop_med):
    """(d) The training CLI with --chunk_conv 0 at [loop]'s flags (m=64,
    f32, blocked 4-scene batches, OCC_PALLAS_BCE=1) for one epoch: no
    chunk kernel, #9's launches as the plans predict (printed before the
    run), every parameter moved, finite losses; the step's median beside
    [loop]'s chunked one; one step profiled."""
    import numpy as np
    from occuseg_tpu_torch.infer import plan_scene
    from occuseg_tpu_torch.train import cli, loop
    from occuseg_tpu_torch.train.config import args_to_config, get_parser
    from occuseg_tpu_torch.train.state import pinned, prepare_batch

    os.environ["OCC_PALLAS_BCE"] = "1"
    argv = [*LOOP_FLAGS, "--chunk_conv", "0", "--data_dir",
            os.path.join(tmp, "no_scenes"), "--checkpoints_dir",
            os.path.join(tmp, "ckpts_gather")]
    config = args_to_config(get_parser().parse_args(argv))
    spec = loop.build_spec(config)
    ds = loop._synthetic_dataset(config)
    ns = config["batch_size"]
    rng = np.random.default_rng(100)
    expected = collections.Counter()
    plans = []
    for batch in ds.train_batches(rng, config["point_cap"],
                                  config["instance_cap"], ns):
        laid, plan = prepare_batch(batch, spec, ns, chunks=False)
        check(all(l.chunks is None for l in plan.levels), "chunk rulebooks")
        plans.append((laid, plan))
        expected.update(predicted_launches(plan, esize=4, bce=True))
    for raw in ds.val_batches(config["point_cap"], config["instance_cap"],
                              1):
        vplan = plan_scene(raw["coords"], spec, chunks=False)
        expected.update({k: 2 * v for k, v in
                         forward_launches(vplan).items()})
    per_step = predicted_launches(plans[0][1], esize=4, bce=True)
    print(f"[gather] (d) --chunk_conv 0: predicted launches per step "
          f"{per_step}, for the epoch and its evals {dict(expected)}")
    init = loop.build_model(config, torch.Generator().manual_seed(0))
    torch.cuda.synchronize()
    zero_launches()
    t0 = time.perf_counter()
    result = cli.main(argv, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    trainer = result["trainer"]
    moved = sum(not torch.equal(p.detach().cpu(), q)
                for p, q in zip(trainer.model.parameters(),
                                init.parameters()))
    n_params = len(list(init.parameters()))
    tm = result["timings"]
    med = sorted(tm["step_ms"])[len(tm["step_ms"]) // 2]
    print(f"[gather] (d) cli.main --chunk_conv 0: {result['steps']} steps "
          f"+ evals in {wall:.1f} s; step ms "
          f"{', '.join(f'{t:.1f}' for t in tm['step_ms'])} (median "
          f"{med:.1f}; [loop]'s chunked median {loop_med:.1f}); losses "
          f"{result['losses']}; val mean IoU "
          f"{result['metrics']['mean_iou']:.4f}; {moved} of {n_params} "
          f"parameter tensors moved")
    print(f"[gather] (d) launches {launches}, expected {dict(expected)}")
    check(result["steps"] == len(plans), f"{result['steps']} steps")
    check(all(v == v and abs(v) != float("inf")
              for v in result["losses"].values()), "losses not finite")
    check(moved == n_params, f"only {moved} of {n_params} moved")
    check(launches == dict(expected), f"--chunk_conv 0 launches {launches}"
          f", expected {dict(expected)}")
    check(all(launches[k] == 0 for k in ("chunk_conv", "chunk_conv_dw",
                                         "chunk_conv_bwd_fused")),
          "a chunk kernel ran under --chunk_conv 0")
    busy = profile_step(lambda: trainer.step(*pinned(*plans[0])), "gather")
    print(f"[gather] (d) device busy {busy:.2f} ms of the median step "
          f"{med:.2f} ms ({100 * busy / med:.1f}%)")
    os.environ.pop("OCC_PALLAS_BCE")
    return dict(launches=launches["gather_conv"], per_step=per_step,
                step_ms=med, chunked_step_ms=loop_med, busy_ms=busy)


def phase_gather(dev, tmp, tot, loop_med, loop_plan):
    """[gather]: the gather-convolution path, (a)-(e) above."""
    gather_roles(dev, tot)
    gather_vs_chunk(dev, loop_plan)
    gather_parity(dev)
    tot.gather_size3 = gather_size3(dev)
    tot.gather_cli_run = gather_cli(dev, tmp, loop_med)


# [planner]: the device planner (`core/topology.build_plan`), the modules
# that need it, and the training step that plans on the card


def _host_normals(hp, normals):
    """Per guided level, the host planner's voxel normals (the sums
    `native/plan.build_plan_host` takes, recomputed from its maps), for
    the near-tie rule."""
    import numpy as np
    from occuseg_tpu_torch.native.plan import _normalize
    p2v = hp.p2v
    acc = np.zeros((hp.levels[0].cap, 3), np.float32)
    valid = p2v >= 0
    np.add.at(acc, p2v[valid], np.asarray(normals, np.float32)[valid])
    out = [_normalize(acc)]
    for t, tr in enumerate(hp.transitions):
        if not hp.levels[t + 1].guided:
            break
        g = np.where((tr.child >= 0)[..., None],
                     out[-1][np.clip(tr.child, 0, None)], 0.0)
        out.append(_normalize(g.sum(axis=1)))
    return out


def same_plan(label, dp, hp, normals=None):
    """Check a device plan against a host plan (or another device plan)
    bit for bit: keys, coords, counts, nbr, child, up, p2v, the guided
    levels; the orientation classes equal except at near ties (sites whose
    two largest |normal components| are within 1e-6 relative, from the
    host's normals). Returns (near ties, class mismatches)."""
    import numpy as np
    from occuseg_tpu_torch.core.topology import _np
    check(len(dp.levels) == len(hp.levels), f"{label}: levels")
    hn = _host_normals(hp, normals) if normals is not None else []
    ties = bad = 0
    for li, (d, h) in enumerate(zip(dp.levels, hp.levels)):
        for f in ("keys", "coords", "nbr"):
            check(np.array_equal(_np(getattr(d, f)), _np(getattr(h, f))),
                  f"{label}: level {li} {f} differ")
        check(d.num_active == h.num_active and d.guided == h.guided,
              f"{label}: level {li} count or guided")
        diff = _np(d.orient) != _np(h.orient)
        if li < len(hn):
            a = np.sort(np.abs(hn[li]), axis=1)
            near = (a[:, 2] - a[:, 1]) <= 1e-6 * a[:, 2]
            ties += int(near[:d.num_active].sum())
            bad += int((diff & ~near).sum())
        else:
            bad += int(diff.sum())
    for ti, (d, h) in enumerate(zip(dp.transitions, hp.transitions)):
        for f in ("child", "up"):
            check(np.array_equal(_np(getattr(d, f)), _np(getattr(h, f))),
                  f"{label}: transition {ti} {f} differ")
    check(np.array_equal(_np(dp.p2v), _np(hp.p2v)), f"{label}: p2v differ")
    check(dp.num_points == hp.num_points, f"{label}: point count")
    check(bad == 0, f"{label}: {bad} orientation classes differ away from "
          f"a near tie")
    return ties, bad


def device_plan_ms(coords_d, spec, normals_d=None, reps=5):
    """(median CUDA-event ms of `build_plan` on the card over `reps` warm
    builds, host reads of one warm build, the plan)."""
    from occuseg_tpu_torch.core.topology import build_plan
    plan = build_plan(coords_d, spec, normals_d)   # warm: tables, allocator
    ms = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        plan = build_plan(coords_d, spec, normals_d)
        end.record()
        torch.cuda.synchronize()
        ms.append(start.elapsed_time(end))
    _, reads = host_reads(lambda: build_plan(coords_d, spec, normals_d))
    return sorted(ms)[len(ms) // 2], reads, plan


def planner_vs_host(dev, tot):
    """(a) `build_plan` on the card against the host planner without
    chunks (`native/plan.build_plan_host`, the C++ planner): the bench
    scenes (seeds 0-2), the mid scene at SIZE3_CAPS (size-3 transitions)
    and one [data] scan with normals and guide_levels; every plan
    validated (`validate_plan` all zeros); the device build's ms beside
    the host plan's (and beside the host plan with chunk rulebooks and
    point layout, as a request plans), host reads counted. Returns the
    rows and the device plan of bench seed 0."""
    import numpy as np
    from occuseg_tpu_torch.core.topology import PlanSpec, validate_plan
    from occuseg_tpu_torch.infer import plan_scene
    from occuseg_tpu_torch.native.plan import build_plan_host
    cases = [(f"bench seed {s}", bench_scene(s)["coords"], None,
              PlanSpec(caps=BENCH_CAPS)) for s in (0, 1, 2)]
    cases.append(("mid size 3", _mid_scene()["coords"], None,
                  PlanSpec(caps=SIZE3_CAPS, down_size=3, down_stride=2)))
    coords, normals, spec = tot.data_scan
    cases.append(("[data] scan, normals", coords, normals, spec))
    rows, bench = [], None
    for label, coords, normals, spec in cases:
        cd = torch.from_numpy(coords).to(dev)
        nd = None if normals is None else torch.from_numpy(normals).to(dev)
        ms, reads, dp = device_plan_ms(cd, spec, nd)
        t0 = time.perf_counter()
        hp = build_plan_host(coords, spec, normals)
        host_ms = 1e3 * (time.perf_counter() - t0)
        t0 = time.perf_counter()
        plan_scene(coords, spec, normals=normals)
        req_ms = 1e3 * (time.perf_counter() - t0)
        ties, _ = same_plan(f"[planner] (a) {label}", dp, hp, normals)
        report = validate_plan(dp)
        check(all(v == 0 for v in report.values()),
              f"[planner] (a) {label}: validate_plan {report}")
        print(f"[planner] (a) {label}: voxels per level "
              f"{[l.num_active for l in dp.levels]}; the device plan equals "
              f"the host plan bit for bit ({ties} near ties of the "
              f"orientation classes, 0 mismatches), validate_plan clean; "
              f"device build {ms:.3f} ms (CUDA events, warm, median of 5, "
              f"{reads} host read(s)), host plan {host_ms:.1f} ms, with "
              f"chunks and point layout {req_ms:.1f} ms")
        check(reads == 1, f"[planner] (a) {label}: {reads} host reads")
        rows.append(dict(case=label, device_ms=ms, host_reads=reads,
                         host_plan_ms=host_ms, host_request_plan_ms=req_ms,
                         near_ties=ties,
                         voxels=dp.levels[0].num_active))
        bench = dp if bench is None else bench
    return rows, bench


# the mid scene's sites in lattice coordinates: the lattice's stride-2
# levels hold more sites than the cubic grid's (10,233 at level 1 against
# MID_CAPS' 8,448)
LATTICE_CAPS = (16_128, 12_288, 6_144, 2_048, 512, 128)


def planner_device_only(dev):
    """(b) The plans only the device builds, of the mid scene: dilation 2
    with the nearest-neighbour search, and the permutohedral lattice (the
    scene's coordinates through `embed_points`), each equal bit for bit to
    the same `build_plan` on the CPU (the CPU tests hold that to the JAX
    planner); `validate_plan` clean where it applies (keys and
    transitions: neither map is its own reversed transpose)."""
    import numpy as np
    from occuseg_tpu_torch.core.topology import (
        PlanSpec, build_plan, validate_plan,
    )
    from occuseg_tpu_torch.ops.permutohedral import embed_points
    coords = _mid_scene()["coords"]
    valid = coords[:, 0] >= 0
    lat = embed_points(coords[valid, 1:].astype(np.float64))
    lattice = coords.copy()
    lattice[valid, 1:] = lat - lat.min(0)
    out = {}
    for label, c, spec in (
            ("nn_search", coords, PlanSpec(caps=MID_CAPS, dilation=2,
                                           nn_search=True)),
            ("permutohedral", lattice, PlanSpec(caps=LATTICE_CAPS,
                                                lattice="permutohedral"))):
        ms, reads, dp = device_plan_ms(torch.from_numpy(c).to(dev), spec)
        cp = build_plan(torch.from_numpy(c), spec)
        same_plan(f"[planner] (b) {label}", dp, cp)
        report = validate_plan(dp)
        check(report == validate_plan(cp), f"[planner] (b) {label} report")
        check(all(v == 0 for k, v in report.items()
                  if "asymmetric" not in k and "bad_center" not in k),
              f"[planner] (b) {label}: validate_plan {report}")
        print(f"[planner] (b) {label}: voxels per level "
              f"{[l.num_active for l in dp.levels]}, K = "
              f"{dp.levels[0].nbr.shape[1]}; equal to the CPU's build bit "
              f"for bit; keys and transitions valid; {ms:.3f} ms on the "
              f"card, {reads} host read(s)")
        out[label] = dict(plan=dp, device_ms=ms)
    return out


def planner_roles(dev, bench, plans):
    """(c) #9 in the roles the device planner gives it, bf16 and f32,
    against its plain version, launched twice (the same bits), timed with
    CUDA events beside its bound: K = 13 (the lattice, Cin 64 and a Cin
    tail of 24), the dilated nearest-neighbour map (Cin 64), and a
    FullConvolution's grown `up` map at L0 (64 -> 32) and L3 (256 -> 128)
    of the bench plan with its `child` map as the backward (d_feats: 32 ->
    64, 128 -> 256). These launches compare and are not counted."""
    from occuseg_tpu_torch.core.topology import full_conv_plan
    from occuseg_tpu_torch.ops.kernels import gather_conv as gc
    roles = []
    perm_l0 = plans["permutohedral"]["plan"].levels[0]
    nn_l0 = plans["nn_search"]["plan"].levels[0]
    roles.append(("K=13 lattice L0", perm_l0.kn["nbr"], perm_l0, 64, 64))
    roles.append(("K=13 lattice L0, Cin tail", perm_l0.kn["nbr"], perm_l0,
                  24, 64))
    roles.append(("dilated nn L0", nn_l0.kn["nbr"], nn_l0, 64, 64))
    for l, (cin, cout) in ((0, (64, 32)), (3, (256, 128))):
        lvl = bench.levels[l]
        grown, tr = full_conv_plan(lvl, 2, 2, lvl.cap * 8, device=dev)
        roles.append((f"grown up L{l}", tr.kn["up"], lvl, cin, cout))
        roles.append((f"grown child L{l} (backward)", tr.kn["child"], grown,
                      cout, cin))
    gen = torch.Generator().manual_seed(31)
    rows, sums = [], collections.defaultdict(float)
    with torch.inference_mode():
        for name, nbr_kn, src, cin, cout in roles:
            K, M = nbr_kn.shape
            N = src.cap
            nnz = int((nbr_kn >= 0).sum())
            x = torch.randn(N, cin, generator=gen)
            x[src.num_active:] = 0
            w = torch.randn(K, cin, cout, generator=gen) \
                * (2 / (K * cin)) ** .5
            row = dict(role=name, K=K, M=M, N=N, Cin=cin, Cout=cout,
                       pairs=nnz)
            for dt, tol, peak, reps in (
                    (torch.bfloat16, BF16_TOL, PEAK_BF16, (10, 2)),
                    (torch.float32, F32_TOL, PEAK_F32, (5, 1))):
                xd, wd = x.to(dev, dt), w.to(dev, dt)
                label = f"[planner] (c) #9 {name} {str(dt)[6:]}"
                out = gc.gather_conv(xd, nbr_kn, wd)
                check(out.shape == (M, cout), f"{label} shape")
                err, scale = check_close(label, out, gc.gather_conv_plain(
                    xd, nbr_kn, wd), tol)
                check(torch.equal(out, gc.gather_conv(xd, nbr_kn, wd)),
                      f"{label}: a second launch gave other bits")
                ms = cuda_ms(lambda: gc.gather_conv(xd, nbr_kn, wd), reps[0])
                pms = cuda_ms(lambda: gc.gather_conv_plain(xd, nbr_kn, wd),
                              reps[1])
                flops = 2.0 * nnz * cin * cout
                nb = nbytes(xd, nbr_kn, wd, out)
                bnd, by = bound_ms(flops, nb, peak)
                key = str(dt)[6:]
                row.update({f"{key}_ms": ms, f"{key}_plain_ms": pms,
                            f"{key}_bound_ms": bnd, f"{key}_bound_by": by,
                            f"{key}_max_abs_err": err})
                sums[f"{key}_ms"] += ms
                sums[f"{key}_bound_ms"] += bnd
                sums[f"{key}_plain_ms"] += pms
                print(f"{label:<58} K={K:<2} M={M:<7} N={N:<7} Cin={cin:<3} "
                      f"Cout={cout:<3} pairs={nnz:<8} max_abs_err={err:.3e} "
                      f"max|out|={scale:.3e} kernel={ms:.4f} ms plain="
                      f"{pms:.4f} ms bound={bnd:.4f} ms ({by}); two launches "
                      f"the same bits")
            rows.append(row)
    print(f"[planner] (c) {len(rows)} roles, sums: "
          + ", ".join(f"{k} {v:.4f}" for k, v in sums.items()))
    torch.cuda.empty_cache()
    return dict(roles=rows, **sums)


def planner_step(dev, train_med):
    """(d) `Trainer(spec).step(batch, plan=None)` at full width: the bench
    scenes (seeds 0-2) planned on the card in each step, bf16 compute and
    f32 parameters, as [train]: #9's launches against the prediction
    (printed first: every convolution on the gather path, 33 forwards and
    32 d_feats; no other kernel), the median step beside [train]'s and the
    planning share of it, one step profiled. Then the same step in f32 at
    the bench scene, card against card: over the device plan and over the
    host plan without chunks (the same route), with [parity]'s
    tolerances; then card against CPU on the mid scene (f32), with
    [parity]'s model and tolerances."""
    from occuseg_tpu_torch.core.topology import PlanSpec, build_plan
    from occuseg_tpu_torch.models import LearningBWDenseUNet
    from occuseg_tpu_torch.train.state import Trainer, prepare_batch
    spec = PlanSpec(caps=BENCH_CAPS)
    scenes = [bench_scene(s) for s in (0, 1, 2)]
    model = LearningBWDenseUNet(N_PLANES, compute_dtype=torch.bfloat16,
                                generator=torch.Generator().manual_seed(41))
    trainer = Trainer(model, dev, num_instances=BENCH_INSTANCES, spec=spec)
    pred = predicted_launches(trainer.plan(scenes[0]))
    print(f"[planner] (d) predicted launches of a device-planned step "
          f"{pred}")
    for _ in range(2):
        trainer.step(scenes[0])
    torch.cuda.synchronize()
    zero_launches()
    step_ms, plan_ms = [], []
    for batch in scenes:
        for _ in range(3):
            t0 = time.perf_counter()
            parts = trainer.step(batch)
            torch.cuda.synchronize()
            step_ms.append(1e3 * (time.perf_counter() - t0))
            vals = {k: float(v) for k, v in parts.items()}
            check(all(v == v and abs(v) != float("inf")
                      for v in vals.values()), f"[planner] (d) {vals}")
    launches = read_launches()
    want = {k: 9 * v for k, v in pred.items()}
    check(launches == want, f"[planner] (d) launches {launches}, expected "
          f"{want}")
    for batch in scenes:
        cd = torch.from_numpy(batch["coords"]).to(dev)
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            build_plan(cd, spec)
            plan_ms.append(1e3 * (time.perf_counter() - t0))
    med = sorted(step_ms)[len(step_ms) // 2]
    pmed = sorted(plan_ms)[len(plan_ms) // 2]
    print(f"[planner] (d) 9 device-planned bf16 steps: median {med:.2f} ms "
          f"(min {min(step_ms):.2f}, max {max(step_ms):.2f}); [train]'s "
          f"host-planned chunked median {train_med:.2f} ms; the plan on "
          f"the card {pmed:.2f} ms (host clock, median of 9), "
          f"{100 * pmed / med:.1f}% of the step; launches {launches} as "
          f"predicted")
    busy = profile_step(lambda: trainer.step(scenes[0]), "planner")
    print(f"[planner] (d) device busy {busy:.2f} ms of the median step "
          f"{med:.2f} ms ({100 * busy / med:.1f}%)")
    del trainer
    torch.cuda.empty_cache()

    # f32, card against card: the device plan against the host plan
    m32 = LearningBWDenseUNet(N_PLANES,
                              generator=torch.Generator().manual_seed(42))
    randomize_bn_stats(m32, torch.Generator().manual_seed(43))
    laid, hplan = prepare_batch(scenes[0], spec, chunks=False)
    res = []
    for batch, plan in ((scenes[0], None), (laid, hplan)):
        t = Trainer(copy.deepcopy(m32), dev, num_instances=BENCH_INSTANCES,
                    spec=spec)
        parts = t.step(batch, plan)
        res.append(({k: float(v) for k, v in parts.items()},
                    [p.grad.detach().clone() for p in t.model.parameters()]))
        del t
    (pd, gd), (ph, gh) = res
    for k in pd:
        tol = 1e-2 if k == "instance_iou" else PARITY_TOL * abs(ph[k]) + 1e-6
        check(abs(pd[k] - ph[k]) <= tol, f"[planner] (d) {k}: {pd[k]} vs "
              f"{ph[k]}")
    num = sum(float(((a - b) ** 2).sum()) for a, b in zip(gd, gh))
    den = sum(float((b ** 2).sum()) for b in gh)
    g_glob = (num / den) ** 0.5
    worst = max((a - b).abs().max().item() / max(b.abs().max().item(),
                                                  1e-30)
                for a, b in zip(gd, gh))
    check(g_glob <= GRAD_GLOBAL_TOL, f"[planner] (d) gradients {g_glob}")
    for a, b in zip(gd, gh):
        check((a - b).abs().max().item() <= GRAD_TOL * b.abs().max().item()
              + GRAD_FLOOR, "[planner] (d) a gradient differs")
    print(f"[planner] (d) f32 bench step, device plan against host plan "
          f"without chunks (card, the gather path both): loss parts within "
          f"{PARITY_TOL} ("
          + ", ".join(f"{k} {pd[k]:.6f}/{ph[k]:.6f}" for k in pd)
          + f"); gradients {g_glob:.3e} of the norm, worst tensor "
          f"{worst:.3e} of its max")
    del res, gd, gh
    torch.cuda.empty_cache()

    # card against CPU on the mid scene, both planned on their device, with
    # [parity]'s model and tolerances: the check differs from [parity]'s
    # by the plan alone. (Another random model, seeds 44/45, sat at a
    # bifurcation of the step: its L4 dec0.conv2 gradient differed card
    # against CPU by 0.146 of its max, and the CPU's own 1e-6-perturbed
    # runs fell on the card's side in three calls and on the CPU's in a
    # fourth, on another machine: no per-tensor bound holds such a step.)
    m = LearningBWDenseUNet(N_PLANES,
                            generator=torch.Generator().manual_seed(7))
    randomize_bn_stats(m, torch.Generator().manual_seed(8))
    train_step_parity(dev, _mid_scene(), None, m, 16, phase="planner",
                      spec=PlanSpec(caps=MID_CAPS))
    return dict(launches_per_step=pred, launches=launches["gather_conv"],
                step_ms=med, min_step_ms=min(step_ms),
                train_step_ms=train_med, plan_ms=pmed, busy_ms=busy,
                f32_vs_host_plan=dict(grad_global=g_glob, grad_worst=worst))


def planner_modules(dev):
    """(e) On the mid scene planned on the card and on the CPU: the m=64
    model's L0 output (InputLayer, the first convolution and the UNet, f32,
    no gradient), then FullConvolution(64 -> 32, size 2, stride 2,
    build_nbr=True) and a K = 27 submanifold convolution 32 -> 32 on the
    grown level; separately a PermutohedralSubmanifoldConvolution 64 -> 64
    on the lattice plan of (b). Forward and gradients (input and weights)
    card against CPU with [parity]'s tolerances."""
    import numpy as np
    from occuseg_tpu_torch.core.sparse_tensor import SparseTensor
    from occuseg_tpu_torch.core.topology import PlanSpec, build_plan
    from occuseg_tpu_torch.models import LearningBWDenseUNet
    from occuseg_tpu_torch.nn.extras import (
        PermutohedralSubmanifoldConvolution,
    )
    from occuseg_tpu_torch.nn.modules import (
        FullConvolution, SubmanifoldConvolution,
    )
    from occuseg_tpu_torch.ops.permutohedral import embed_points
    batch = _mid_scene()
    model = LearningBWDenseUNet(N_PLANES,
                                generator=torch.Generator().manual_seed(46))
    randomize_bn_stats(model, torch.Generator().manual_seed(47))
    gen = torch.Generator().manual_seed(48)
    chain = torch.nn.ModuleList([FullConvolution(N_PLANES[0], 32,
                                                 generator=gen),
                                 SubmanifoldConvolution(32, 32,
                                                        generator=gen)])
    perm = PermutohedralSubmanifoldConvolution(64, 64, generator=gen)
    coords = batch["coords"]
    valid = coords[:, 0] >= 0
    lat = embed_points(coords[valid, 1:].astype(np.float64))
    lattice = coords.copy()
    lattice[valid, 1:] = lat - lat.min(0)
    res = {}
    for d in ("cpu", dev):
        plan = build_plan(torch.from_numpy(coords).to(d),
                          PlanSpec(caps=MID_CAPS))
        bb = copy.deepcopy(model).to(d).eval().backbone.backbone
        with torch.no_grad():
            x = bb.input(torch.from_numpy(batch["features"]).to(d), plan)
            x = bb.unet(bb.sub(x, plan), plan)
        f = x.features.detach().requires_grad_()
        m = copy.deepcopy(chain).to(d)
        y, grown = m[0](x.with_features(f), plan)
        y = m[1](y, grown)
        r = torch.randn(y.features.shape, generator=torch.Generator()
                        .manual_seed(49)).to(d)
        (y.features * r).sum().backward()
        lp = build_plan(torch.from_numpy(lattice).to(d),
                        PlanSpec(caps=LATTICE_CAPS[:1],
                                 lattice="permutohedral"))
        n = lp.levels[0].num_active
        pf = torch.randn(lp.levels[0].cap, 64, generator=torch.Generator()
                         .manual_seed(50))
        pf[n:] = 0
        pf = pf.to(d).requires_grad_()
        pm = copy.deepcopy(perm).to(d)
        z = pm(SparseTensor(features=pf, num_active=n, level=0), lp).features
        rz = torch.randn(z.shape, generator=torch.Generator()
                         .manual_seed(51)).to(d)
        (z * rz).sum().backward()
        res[str(d)] = dict(
            grown=(grown.levels[0].num_active, int(grown.levels[0].cap)),
            chain_out=y.features.detach().cpu(), chain_dx=f.grad.cpu(),
            chain_dw=[p.grad.cpu() for p in m.parameters()],
            perm_out=z.detach().cpu(), perm_dx=pf.grad.cpu(),
            perm_dw=pm.weight.grad.cpu())
    c, g = res["cpu"], res[str(dev)]
    check(c["grown"] == g["grown"], f"[planner] (e) grown {g['grown']}")
    errs = {}
    for key in ("chain_out", "chain_dx", "perm_out", "perm_dx"):
        err, scale = _err(g[key], c[key])
        tol = PARITY_TOL if key.endswith("out") else GRAD_TOL
        check(err <= tol * max(scale, 1e-30),
              f"[planner] (e) {key}: {err} > {tol} x {scale}")
        errs[key] = err / max(scale, 1e-30)
    for key, a_list, b_list in (("chain_dw", g["chain_dw"], c["chain_dw"]),
                                ("perm_dw", [g["perm_dw"]], [c["perm_dw"]])):
        for i, (a, b) in enumerate(zip(a_list, b_list)):
            err, scale = _err(a, b)
            check(err <= GRAD_TOL * scale + GRAD_FLOOR,
                  f"[planner] (e) {key} {i}: {err} > {GRAD_TOL} x {scale}")
            errs[f"{key}{i}"] = err / max(scale, 1e-30)
    print(f"[planner] (e) FullConvolution {N_PLANES[0]}->32 (grown level "
          f"{g['grown'][0]} of {g['grown'][1]} rows) + submanifold 32->32, "
          f"and the permutohedral 64->64: card against CPU, error/max "
          + ", ".join(f"{k} {v:.2e}" for k, v in errs.items()))
    torch.cuda.empty_cache()
    return errs


def phase_planner(dev, tot, train_med):
    """[planner]: the device planner, (a)-(e) above; returns what #9's
    kernels-line entry reports under "planner"."""
    t0 = time.perf_counter()
    a, bench = planner_vs_host(dev, tot)
    b = planner_device_only(dev)
    c = planner_roles(dev, bench, b)
    d = planner_step(dev, train_med)
    e = planner_modules(dev)
    print(f"[planner] all parts passed in {time.perf_counter() - t0:.1f} s")
    return dict(plans=a, device_only={k: dict(device_ms=v["device_ms"])
                                      for k, v in b.items()},
                step=d, modules_err=e, **c)



def phase_ap_gate(dev):
    """[ap_gate]: `tools/ap_gate.run` on the card (seeds 7, 8, 9, 450
    steps each, the port's seeded initialisation): per seed its AP, final
    loss parts, median step and one step's launches (the mixed route: #9
    at the 8- and 24-wide convolutions, #1 at the 16-wide ones) against
    the plan's prediction; the contraction; fails on any threshold. Then
    one step of a short soak, profiled."""
    import numpy as np
    from occuseg_tpu_torch.tools import ap_gate
    from occuseg_tpu_torch.train.state import prepare_batch
    pred = predicted_launches(
        prepare_batch(ap_gate.soak_batch(ap_gate.SEEDS[0]), ap_gate.SPEC)[1],
        esize=4, n_planes=ap_gate.N_PLANES)
    print(f"[ap_gate] predicted launches per step {pred}")
    seen = {}

    def on_step(seed, i, parts):
        if i in (0, 1):
            seen[seed, i] = read_launches()

    zero_launches()
    t0 = time.perf_counter()
    rep = ap_gate.run(dev, on_step=on_step)
    wall = time.perf_counter() - t0
    per_step = {}
    for seed, r in rep["seeds"].items():
        step = {k: seen[seed, 1][k] - seen[seed, 0][k]
                for k in seen[seed, 1]}
        per_step[seed] = step
        print(f"[ap_gate] seed {seed}: AP@0.5 {r['ap']:.4f}; final loss "
              f"parts " + ", ".join(f"{k} {v:.4f}"
                                    for k, v in r["parts"].items())
              + f"; median step {r['step_ms']:.2f} ms; one step launched "
              f"#9 {step['gather_conv']} and #1 {step['chunk_conv']} times "
              f"({step})")
        check(step == pred, f"[ap_gate] seed {seed} launches {step}, "
              f"expected {pred}")
    aps = [r["ap"] for r in rep["seeds"].values()]
    print(f"[ap_gate] mean AP@0.5 {rep['mean_ap']:.4f} (> "
          f"{ap_gate.MEAN_AP_FLOOR}), min {min(aps):.4f} (> "
          f"{ap_gate.SEED_AP_FLOOR}), contraction {rep['contraction']:.4f}"
          f" (< {ap_gate.CONTRACTION_CEIL}); {wall:.1f} s")
    check(rep["passed"], f"[ap_gate] a threshold failed: {rep}")
    s = ap_gate.soak(ap_gate.SEEDS[0], dev, steps=3)
    busy = profile_step(lambda: s.trainer.step(s.laid, s.plan), "ap_gate")
    med = float(np.median([r["step_ms"] for r in rep["seeds"].values()]))
    print(f"[ap_gate] device busy {busy:.2f} ms of the median step "
          f"{med:.2f} ms ({100 * busy / med:.1f}%)")
    return dict(report=rep, launches_per_step=pred, busy_ms=busy)


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
    launches, train_med = phase_train(dev)
    with tempfile.TemporaryDirectory(prefix=".chip_smoke_",
                                     dir=os.path.dirname(
                                         os.path.abspath(__file__))) as tmp:
        loop_launches, ckpt_dir, loop_med, loop_plan = phase_loop(dev, tmp)
        phase_instance(dev, tmp, ckpt_dir)
        data_launches = phase_data(dev, tmp, tot)
        phase_gather(dev, tmp, tot, loop_med, loop_plan)
    planner = phase_planner(dev, tot, train_med)
    gate = phase_ap_gate(dev)
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
        # the normal-guided convolutions of the CLI at level 0, per step
        # (f32); beside them L3-L5 of the bench plan in bf16
        entry("gather_conv", "gather_conv_cli", "gather_conv.cu",
              "gather_conv.py:112", data_launches["gather_conv"],
              cli_level0=tot.gather_cli, ng_backward_ms=tot.ng_bwd_ms,
              levels=tot.gather_levels,
              # the gather path: its roles at the bench plan's transitions,
              # the --chunk_conv 0 CLI's launches and step, the AP gate's
              gather_path=dict(tot.gather_roles, cli=tot.gather_cli_run,
                               size3=tot.gather_size3,
                               ap_gate_launches_per_step=gate[
                                   "launches_per_step"]),
              # the device planner's path: #9's roles there, the launches
              # of a device-planned step and its times
              planner=planner),
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
