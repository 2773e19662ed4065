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
   the contraction; the accuracy floor of tests/test_accuracy_floor.py on
   seed 7's first 50 steps; fails unless mean AP@0.5 > 0.6, each seed >
   0.35, the contraction < 1.5 and the floor holds; then one step of a
   short soak, profiled (device busy against the median step).
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
11. families (after planner, before ap_gate): pooling, the IO modes,
   randomized strides, the op-library extras and the other model
   families: (a) max_pool, avg_pool and unpool at the bench plan's 5
   transitions, bf16 and f32, forward and gradients card against CPU,
   timed beside the byte bound, and the five voxelize modes at 200k points
   (C = 3 and 64); (b) the main path: InputLayer -> SubmanifoldConvolution
   -> DenseUNet_BN(N_PLANES) -> OutputLayer -> Linear(64, 20) with the
   semantic cross-entropy, bf16 training steps on the 3 bench scenes'
   chunked host plans, #1, #3-#5 and #2's launches per step predicted
   and checked, the step timed and profiled, then f32 card against CPU on
   the mid scene; (c) ThreeVoxelKernel through Predictor (33 + 1
   launches) and card against CPU; (d) FullyConvolutionalNet, SparseVggNet
   (MP, a Plus spec of depth 3) and SparseResNet on the mid scene's device
   plans with size-3 transitions, card against CPU, #9's launches
   counted; (e) the randomized plan of the bench scene on the card, bit
   for bit as the CPU's from the same seed, timed, its host reads
   counted; a randomized-stride net card against CPU; #9 on the jittered
   child and up maps against its plain version; (f)
   `classification_train_validate` with a SparseResNet and ActivePooling
   over 64 synthetic shapes, 2 epochs on the card, the first step's loss
   against the CPU's, #9's launches counted; (g) ClusterSegNet at P =
   262,144 and the extras (upsample_feature, ShapeContext,
   MultiscaleShapeContext, sparse_to_dense, sparsify_coords,
   compare_sparse) card against CPU.
12. legacy (after families): the sparseconvnet facade
   (`occuseg_tpu_torch/legacy.py`): (a) the reference UNet docstring's
   model at m=64 (a submanifold convolution, a residual UNet of 2 blocks
   a level and side, BN-ReLU) between the facade's InputLayer and
   OutputLayer, bf16 forward and backward on the bench scene's chunked
   host plan: bit for bit the same modules composed directly, the
   launches of #1, #3-#5 and #2 as the plan predicts, both timed in
   turns; then f32 on the mid scene, card against CPU with the card's
   BN-ReLU branches imposed on the CPU; (b) UNet(leakiness=0.333) card
   against CPU alike; (c) ConcatTable / AddTable / JoinTable card against
   CPU, and append_tensors of two scenes on the card (#9 over the merged
   plan against each scene's own and the CPU).
13. gates: (a) the checkpoint-parity gate
   (`occuseg_tpu_torch/scripts/checkpoint_parity.py`) on an m=64 `.pth`
   made by tests/torch_oracle.py: exit 0 with every head within its TOL,
   non-zero with a key removed, 1 with the imported model perturbed by
   1e-2 in one weight; (b) train_semantic at m=64 for 2 f32 steps, its
   checkpoint and eval; (c) test_semantic from that checkpoint over the
   synthetic val scenes and fake_judge on its files, against a confusion
   rebuilt from them.
14. dp: two spawned ranks on the one card over gloo (NCCL refuses two
   ranks on one device), [loop]'s model and scenes, 4 scenes a rank, 3
   steps with OCC_PALLAS_BCE=1: step 1 against the two ranks' batches
   stepped in one process, their gradients, statistics and loss parts
   averaged, then Adam (the parameters held to Adam of the reduced
   gradients); the remainder group (rank 1 a weight-0 copy) against rank
   0's single-process step; the DP step beside [loop]'s.
15. spatial (after dp): spatial sharding, two spawned ranks on the one
   card over gloo, each a shard: (a) serving bench scene 0 through `sharded_infer`'s path at
   m=64, bf16, halo and pool 4096, per-shard rulebooks: the launches of
   #1 and #9 against each rank's shard plan, forward ms and peak memory
   beside the unsharded forward's, the rows each exchange carries, every
   head against the unsharded forward of the same weights (jax's bf16
   tolerance; in f32 [parity]'s), each per-shard role (submanifold over
   the extended rows, strided, deconvolution, #9 and its transpose)
   against its plain version; (c) with OCC_PALLAS_BCE=1 the radius
   maximised over the shards equal to the scene's bit for bit and the
   five sums to the scene's; (b) `loop.train` with --spatial_shards 2 at
   [loop]'s flags for 3 steps, each rank's launches of #1, #3-#9 against
   the prediction, step 1 against the single-process step on the same
   batch (loss parts, gradient, statistics, parameters after Adam), the
   step beside [loop]'s.

The last line is {"ok": true, "device": {...}}; the line before it is the
per-kernel JSON summary.
"""

from __future__ import annotations

import collections
import contextlib
import copy
import json
import math
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
# a gradient that is zero in exact arithmetic, against the largest entry
# of its step's gradient: ClusterSegNet's f32 residue is ~6e-7 of it, the
# float64 step's ~1e-15
ZERO_TOL = 1e-5

# H100 SXM peaks (NVIDIA data sheet, dense, 700 W): bf16 tensor cores,
# f32 outside them, HBM3
PEAK_BF16 = 989e12
PEAK_TF32 = 495e12
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


def conv_calls(plan, n_planes, in_features=3, reps=1):
    """The chunk convolutions of one m=64 UNet forward (`reps` blocks a
    level and side), in order, each with its forward and transpose chunk
    plans, input and output rows (cap and active) and channels. Cin is as
    the kernel sees it (the first conv's 3 padded to 16)."""
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
        for i in range(reps):
            for name in (f"enc{i}.conv1", f"enc{i}.conv2"):
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
        for i in range(reps):
            sub(f"dec{i}.conv1 L{l}", l, 2 * p if i == 0 else p, p)
            sub(f"dec{i}.conv2 L{l}", l, p, p)

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


def f32_dw_operands(conv, x, ct):
    """(gathered operand, its chunk plan, dense operand) of the f32 weight
    gradient the step takes for a convolution with input x and output
    cotangent ct: dWt over the transpose plan (the fused route, #3 and #4:
    ct gathered, x dense) or dW over the forward plan (#5: x gathered, ct
    dense). `chunk_conv_dw` over them runs the kernel's blocks of that
    route (dWt comes out transposed)."""
    if route_of(conv, 4) == "#5":
        return x, conv.chunks, ct
    return ct, conv.t_chunks, x


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
                       n_planes=N_PLANES, calls=None) -> dict:
    """Kernel launches of one training step on `plan` with activations of
    `esize` bytes: a chunked convolution's from its backward route, a
    convolution on the gather path one #9 forward and one #9 d_feats (none
    for the first convolution, whose input is data); the segment sum runs
    twice where the plan has the sorted point layout, the BCE kernels once
    each with `bce`. With `normal_guided`, the convolutions at the plan's
    guided levels launch #9 once each (their backward is PyTorch).
    `calls` replaces the UNet's convolutions (`conv_calls`) with another
    model's, the first taking the data."""
    if calls is None:
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


# the f32 launches by tile of the forward kernel (`chunk_conv.f32_route`)
# and of the weight-gradient kernel on both routes (`chunk_conv.dw_route`),
# which the launch predictions leave out (`read_routes`)
ROUTE_KEYS = ("chunk_conv_f32_tc", "chunk_conv_f32_fma",
              "chunk_conv_dw_f32_tc", "chunk_conv_dw_f32_fma",
              "chunk_conv_bwd_fused_f32_tc", "chunk_conv_bwd_fused_f32_fma")


def read_launches() -> dict:
    from occuseg_tpu_torch.utils.profiling import snapshot
    return {k: v for k, v in snapshot()["launches"].items()
            if k not in ROUTE_KEYS}


def read_routes() -> dict:
    """{kernel and tile: f32 launches} since the last `zero_launches`:
    the forward kernel's ("f32_tc", "f32_fma") and the weight-gradient
    kernel's on the dW route ("dw_f32_...") and on the fused route
    ("bwd_fused_f32_...")."""
    from occuseg_tpu_torch.utils.profiling import snapshot
    got = snapshot()["launches"]
    return {k[len("chunk_conv_"):]: got[k] for k in ROUTE_KEYS}


def zero_launches() -> None:
    from occuseg_tpu_torch.utils.profiling import launch_counters
    for _, fn, attr in launch_counters():
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
    return ((out.float().to(ref.device) - ref.float()).abs().max().item(),
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
    tot.f32_maps = []
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
                if not bf:
                    f32_fwd_skips(dev, tot, f"{cv.label} forward",
                                  (xd, fi, fl, wd), ms, dense_f,
                                  2.0 * nnz_f * cv.cin * cv.cout)
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
                if not bf:
                    f32_fwd_skips(dev, tot, f"{cv.label} transpose",
                                  (ctd, ti, tl, wtd), t_ms, dense_t,
                                  2.0 * nnz_t * cv.cin * cv.cout)
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
    with torch.inference_mode():
        f32_dw_tiles(dev, tot, calls)
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
    dense = max(tot.f32_maps, key=lambda r: r["real_ms"] / r["dense_ms"])
    f32 = tot.f32_maps
    print(f"[kernels] f32 #1 on the densest map of the f32 subset "
          f"({dense['label']}, real products {dense['real_ms'] / dense['dense_ms']:.1%} "
          f"of the dense-K work): the row order took "
          f"{dense['order']:.2%} of the blocks' cycles; over the subset "
          f"{sum(r['ms'] for r in f32):.3f} ms (the FMA tile "
          f"{sum(r['fma_ms'] for r in f32):.3f} ms), dense-K floor "
          f"{sum(r['dense_ms'] for r in f32):.3f} ms, real-product "
          f"floor {sum(r['real_ms'] for r in f32):.3f} ms at the f32 peak, "
          f"{sum(r['tc_floor_ms'] for r in f32):.3f} ms at a third of the "
          f"TF32 peak; float64 error of the tensor-core tile over the FMA "
          f"tile's at most {max(r['tc_over_fma'] for r in f32):.2f}x")
    d = tot.f32_dw
    print(f"[kernels] per step, f32 dW (#3/#4 dWt, #5 dW) over the 33 "
          f"convolutions: as routed {d['ms']:.3f} ms (tensor-core tile "
          f"{d['tc_ms']:.3f} ms, FMA tile {d['fma_ms']:.3f} ms on the "
          f"{d['tc_maps']} maps the tensor-core tile fits; FMA alone "
          f"{d['fma_ms'] + d['fma_only_ms']:.3f} ms), real-product floor "
          f"{d['real_ms']:.3f} ms at the f32 peak, {d['tc_floor_ms']:.3f} ms"
          f" at a third of the TF32 peak; the tensor-core tile ran "
          f"{d['run'] / max(d['real'], 1):.2f}x the real products, skipped "
          f"{d['skipped'] / max(d['ran'] + d['skipped'], 1):.1%} of its k8 "
          f"steps, staging {d['stage']:.1%} of its blocks' cycles; float64 "
          f"error over the FMA tile's at most {d['worst']:.2f}x (max)")
    return tot


def f32_dw_tiles(dev, tot, calls):
    """The f32 weight gradient each of the bench plan's convolutions takes
    (`f32_dw_operands`), on the tile the wrapper takes
    (`chunk_conv.dw_route`) and on each tile (the tensor-core one where
    its block fits): times, the real-product floors at the f32 peak and
    at a third of the TF32 peak, the tensor-core tile's (offset, k8 step)
    pairs run and skipped and staging's share of its blocks' cycles, and
    each tile's largest error against the float64 sum, the
    tensor-core tile held to 1.1x the FMA tile's. Into tot.f32_dw."""
    from occuseg_tpu_torch.ops.kernels import chunk_conv as cc
    gen = torch.Generator().manual_seed(2)
    smem = cc._smem_optin(dev.index)
    d = tot.f32_dw = collections.defaultdict(float)
    d["tc_maps"] = 0
    for cv in calls:
        K = cv.chunks.lidx.shape[1]
        x = torch.randn(cv.n_in, cv.cin, generator=gen)
        x[cv.n_act:] = 0
        ct = torch.randn(cv.n_out, cv.cout, generator=gen)
        ct[cv.n_out_act:] = 0
        xg, ch, dd = f32_dw_operands(cv, x.to(dev), ct.to(dev))
        in_idx, lidx = ch.in_idx, ch.lidx
        U, cx, cd = in_idx.shape[1], xg.shape[1], dd.shape[1]
        route = cc.dw_route(cx, cd, K, U, smem)
        real = 2.0 * int((lidx >= 0).sum()) * cx * cd

        def call(r=None):
            return cc._run_dw("[kernels] f32 dW", cc.chunk_conv_dw, xg,
                              in_idx, lidx, dd, True, route=r)
        ref64 = cc.chunk_conv_dw_plain(xg, in_idx, lidx, dd, torch.float64)
        scale = ref64.abs().max().item()
        ms, err = {}, {}
        fits = cc.dw_tc_smem_bytes() <= smem
        for r in ("tc", "fma") if fits else ("fma",):
            cc.dw_counts(dev, reset=True)
            out = call(r)
            n = cc.dw_counts(dev, reset=True)
            check_close(f"f32 dW {cv.label} ({r})", out,
                        ref64.float(), DW_TOL)
            check(torch.equal(out, call(r)), f"f32 dW {cv.label} ({r}): a "
                  f"second launch gave other bits")
            err[r] = (out.double() - ref64).abs().max().item() / scale
            ms[r] = cuda_ms(lambda r=r: call(r), 2)
            if r == "tc":
                d["ran"] += n.ran
                d["skipped"] += n.skipped
                d["run"] += 2.0 * n.ran * 8 * 64 * 64
                d["real"] += real
                d["stage_cycles"] += n.stage_cycles
                d["block_cycles"] += n.block_cycles
        del ref64, out
        d["ms"] += ms[route]
        d["real_ms"] += 1e3 * real / PEAK_F32
        d["tc_floor_ms"] += 1e3 * 3 * real / PEAK_TF32
        if fits:
            d["tc_maps"] += 1
            d["tc_ms"] += ms["tc"]
            d["fma_ms"] += ms["fma"]
            over = err["tc"] / max(err["fma"], 1e-30)
            d["worst"] = max(d["worst"], over)
            check(over <= 1.1, f"f32 dW {cv.label}: the tensor-core tile's "
                  f"float64 error {err['tc']:.3e} is past 1.1x the FMA "
                  f"tile's {err['fma']:.3e}")
        else:
            d["fma_only_ms"] += ms["fma"]
        print(f"[kernels] f32 dW {cv.label:<22} {route_of(cv, 4)} cx={cx:<3}"
              f" cd={cd:<3} K={K:<2} U={U:<4} route {route}: "
              + ", ".join(f"{r} {ms[r]:.4f} ms (float64 error "
                          f"{err[r]:.2e})" for r in ms)
              + f"; real-product floor {1e3 * real / PEAK_F32:.4f} ms")
    d["stage"] = d["stage_cycles"] / max(d["block_cycles"], 1)


def f32_errors(out, ref64):
    """(mean, max) |out - ref64| over max |ref64|."""
    d = (out.double() - ref64).abs()
    scale = ref64.abs().max().item()
    return d.mean().item() / scale, d.max().item() / scale


def f32_fwd_skips(dev, tot, label, args, ms, dense_flops, real_flops):
    """#1 in f32 on one map (`args`: feats, in_idx, lidx, weight): the
    time of the tile the wrapper takes (`chunk_conv.f32_route`) beside
    each tile's (the tensor-core one where it fits) and the floors of the
    dense-K work (every offset of every
    live chunk's rows) and the real products at the f32 peak, and of the
    real products at a third of the TF32 peak (3xTF32); each tile's
    counters over one more launch (the FMA tile's (Cin tile, offset, warp)
    steps skipped, the tensor-core tile's (Cin tile, offset, 64-row group)
    steps run and skipped, the row order's share of the blocks' cycles);
    and each tile's error against the float64 product of the same
    gathered rows (mean and max over the largest output), the
    tensor-core tile held to twice the FMA tile's."""
    from occuseg_tpu_torch.ops.kernels import chunk_conv as cc
    feats, in_idx, lidx, w = args
    _, K, M = lidx.shape
    route = cc.f32_route(feats.shape[1], w.shape[2], M, K, in_idx.shape[1],
                         cc._smem_optin(dev.index))
    ref64 = cc.chunk_conv_plain(feats, in_idx, lidx, w, torch.float64)
    nt = cc.tc_col_tile(w.shape[2], K, in_idx.shape[1],
                        cc._smem_optin(dev.index))
    n, err = {"tc": cc.FwdCounts(0, 0, 0, 0)}, {"tc": (0.0, 0.0)}
    tile_ms = {"tc": 0.0}
    for r in ("tc", "fma") if nt else ("fma",):
        def call(r=r):
            return cc._run_chunk_conv(label, feats, in_idx, lidx, w, route=r)
        cc.fwd_counts(dev, reset=True)
        out = call()
        n[r] = cc.fwd_counts(dev, reset=True)
        err[r] = f32_errors(out, ref64)
        tile_ms[r] = cuda_ms(call, 1)
    del ref64, out
    fma_ms = tile_ms["fma"]
    over = max(err["tc"][i] / max(err["fma"][i], 1e-30) for i in (0, 1))
    row = dict(label=label, ms=ms, fma_ms=fma_ms, route=route,
               dense_ms=1e3 * dense_flops / PEAK_F32,
               real_ms=1e3 * real_flops / PEAK_F32,
               tc_floor_ms=1e3 * 3 * real_flops / PEAK_TF32,
               tc_products=n["tc"].group_ran * cc.TC_GROUP_ROWS * 32 * nt,
               skipped=n["fma"].skipped_share, order=n["fma"].order_share,
               group_skipped=n["tc"].group_skipped_share, err=err,
               tc_over_fma=over)
    tot.f32_maps.append(row)
    check(over <= 2.0, f"f32 #1 {label}: the tensor-core tile's float64 "
          f"error {err['tc']} is past twice the FMA tile's {err['fma']}")
    print(f"[kernels] f32 #1 {label:<32} route {route}: kernel {ms:.4f} ms "
          f"(tensor-core tile {tile_ms['tc']:.4f} ms, FMA tile "
          f"{fma_ms:.4f} ms), dense-K floor "
          f"{row['dense_ms']:.4f} ms, real-product floor "
          f"{row['real_ms']:.4f} ms (3xTF32 {row['tc_floor_ms']:.4f} ms); "
          f"tensor-core tile ran {n['tc'].group_ran} and skipped "
          f"{n['tc'].group_skipped} group-steps ({row['group_skipped']:.1%},"
          f" {row['tc_products'] / max(real_flops / 2, 1):.2f}x the real "
          f"products); FMA tile skipped {n['fma'].skipped_share:.1%} of "
          f"{n['fma'].ran + n['fma'].skipped} warp-steps, row order "
          f"{n['fma'].order_share:.2%} of its blocks' cycles; float64 error "
          f"mean/max tensor-core {err['tc'][0]:.3e}/{err['tc'][1]:.3e}, FMA "
          f"{err['fma'][0]:.3e}/{err['fma'][1]:.3e}")


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
        if getattr(cpu_out, name) is None:   # a head the model lacks
            check(getattr(gpu_out, name) is None, f"{phase} {name}")
            continue
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
    routes = read_routes()
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
    print(f"[loop] launches {launches}, expected {dict(expected)}; f32 "
          f"launches by tile {routes}")
    check(steps == len(plans), f"{steps} steps, expected {len(plans)}")
    check(all(v == v and abs(v) != float("inf")
              for v in result["losses"].values()), "loop losses not finite")
    check(0.0 <= result["metrics"]["mean_iou"] <= 1.0, "eval mean IoU")
    check(launches == dict(expected), f"loop launches {launches}, expected "
          f"{dict(expected)}")
    for k in ("bce_radius", "bce_fwd", "bce_bwd", "chunk_conv",
              "chunk_conv_bwd_fused"):
        check(launches[k] > 0, f"{k} was not launched on the loop path")
    check(routes["f32_tc"] > 0 and routes["bwd_fused_f32_tc"] > 0,
          f"the tensor-core tiles were not launched on the loop path: "
          f"{routes}")

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
    return time_gather_roles(dev, roles, "[planner] (c)", 31)


def time_gather_roles(dev, roles, tag, seed):
    """#9 over each (name, map [K, M], source level, Cin, Cout) of `roles`
    on random inputs (the source's pad rows 0), bf16 and f32, against its
    plain version, launched twice (the same bits), timed with CUDA events
    beside its bound. These launches compare and are not counted."""
    from occuseg_tpu_torch.ops.kernels import gather_conv as gc
    gen = torch.Generator().manual_seed(seed)
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
                label = f"{tag} #9 {name} {str(dt)[6:]}"
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
    print(f"{tag} {len(rows)} roles, sums: "
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



# [families]: pooling, the IO modes, randomized strides, the op-library
# extras and the other model families (DenseUNet_BN, ThreeVoxelKernel,
# ClusterSegNet, the builders) with the classification harness


def _bf16_exact(t):
    """t rounded to bf16 and back to f32: the same values in both
    dtypes, so one f32 reference on the CPU holds both."""
    return t.to(torch.bfloat16).float()


def _glob(a_list, b_list):
    """||a - b|| / ||b|| over a list of tensors (in float64)."""
    num = sum(float(((a.double() - b.double()) ** 2).sum())
              for a, b in zip(a_list, b_list))
    den = sum(float((b.double() ** 2).sum()) for b in b_list)
    return (num / max(den, 1e-30)) ** 0.5


def _rel(a, b):
    return (a.double() - b.double()).abs().max().item() / max(
        b.double().abs().max().item(), 1e-30)


def _grad_check(label, card, cpu, names, zero=()):
    """Gradients card against CPU: each tensor within GRAD_TOL of its max
    (plus GRAD_FLOOR), the whole within GRAD_GLOBAL_TOL of its norm;
    returns (norm share, worst tensor share). The tensors named in
    `zero` have a gradient of exactly zero (a bias whose shift a later
    batch norm removes: the float64 step's is ~1e-15 of the largest
    entry), so what each side computes is rounding residue: each is held
    within ZERO_TOL of the largest gradient entry instead."""
    g_glob = _glob(card, cpu)
    top = max(b.abs().max().item() for b in cpu)
    worst = max(_rel(a, b) for a, b, n in zip(card, cpu, names)
                if n not in zero)
    for a, b, n in zip(card, cpu, names):
        if n in zero:
            res = max(a.abs().max().item(), b.abs().max().item())
            check(res <= ZERO_TOL * top, f"{label} gradient {n}: {res} is "
                  f"not zero to {ZERO_TOL} of the largest entry {top}")
            continue
        err = (a - b).abs().max().item()
        scale = b.abs().max().item()
        check(err <= GRAD_TOL * scale + GRAD_FLOOR,
              f"{label} gradient {n}: {err} > {GRAD_TOL} x {scale}")
    check(g_glob <= GRAD_GLOBAL_TOL,
          f"{label} gradients {g_glob} of the norm > {GRAD_GLOBAL_TOL}")
    return g_glob, worst


def families_pool(dev):
    """(a) max_pool, avg_pool and unpool at the bench plan's 5 transitions
    (child maps for the pools, up maps for the unpool), at N_PLANES'
    widths, on ReLU'd inputs (ties at 0), bf16 and f32: forward and the
    input gradient on the card against the CPU (one f32 reference from
    bf16-exact inputs), the forward timed beside its byte bound; then the
    five voxelize modes at the bench scene's 200k points (its sorted point
    layout: sum and mean on #2), C = 3 and 64, f32, forward and gradient
    card against CPU, timed. These launches compare and are not counted."""
    import numpy as np
    from occuseg_tpu_torch.core.topology import PlanSpec
    from occuseg_tpu_torch.infer import plan_scene
    from occuseg_tpu_torch.ops import pool as pool_ops
    batch = bench_scene(0)
    plan = plan_scene(batch["coords"], PlanSpec(caps=BENCH_CAPS))
    check(plan.vox_seg is not None, "[families] (a) no point layout")
    gen = torch.Generator().manual_seed(61)
    rows, sums = [], collections.defaultdict(float)
    for t, tr in enumerate(plan.transitions):
        for op in ("max_pool", "avg_pool", "unpool"):
            up = op == "unpool"
            src = plan.levels[t + 1] if up else plan.levels[t]
            c = N_PLANES[t + 1] if up else N_PLANES[t]
            idx = torch.from_numpy(np.ascontiguousarray(tr.up if up
                                                        else tr.child))
            M, K = idx.shape
            x = torch.relu(_bf16_exact(torch.randn(src.cap, c,
                                                   generator=gen)))
            x[src.num_active:] = 0
            ct = _bf16_exact(torch.randn(M, c, generator=gen))
            fn = getattr(pool_ops, op)
            xc = x.detach().clone().requires_grad_()
            ref = fn(xc, idx)
            (ref * ct).sum().backward()
            idx_d = idx.to(dev)
            row = dict(op=op, transition=t, M=M, N=src.cap, C=c, K=K)
            for dt, tol in ((torch.bfloat16, BF16_TOL),
                            (torch.float32, F32_TOL)):
                key = str(dt)[6:]
                label = f"[families] (a) {op} T{t} {key}"
                xd = x.to(dev, dt).detach().requires_grad_()
                out = fn(xd, idx_d)
                (out * ct.to(dev, dt)).sum().backward()
                err, scale = check_close(label, out, ref.detach(), tol)
                gerr, _ = check_close(f"{label} gradient", xd.grad, xc.grad,
                                      tol)
                xn = xd.detach()
                with torch.no_grad():
                    ms = cuda_ms(lambda: fn(xn, idx_d), 5)
                nb = nbytes(xn, idx_d) + M * c * xn.element_size()
                bnd, _ = bound_ms(0.0, nb)
                row.update({f"{key}_ms": ms, f"{key}_bound_ms": bnd,
                            f"{key}_max_abs_err": err,
                            f"{key}_grad_err": gerr})
                sums[f"{op}_{key}_ms"] += ms
                sums[f"{op}_{key}_bound_ms"] += bnd
                print(f"{label:<36} M={M:<7} N={src.cap:<7} K={K} C={c:<3} "
                      f"max_abs_err={err:.3e} (max|out| {scale:.3e}) grad "
                      f"err={gerr:.3e} forward {ms:.4f} ms, byte bound "
                      f"{bnd:.4f} ms")
            rows.append(row)
    P = batch["coords"].shape[0]
    p2v = torch.from_numpy(np.asarray(plan.p2v))
    seg = torch.from_numpy(np.asarray(plan.vox_seg))
    counts = torch.from_numpy(np.asarray(plan.vox_counts))
    cap0 = plan.levels[0].cap
    vox = []
    for C in (3, 64):
        x = torch.randint(-3, 4, (P, C), generator=gen).float()
        ct = torch.randn(cap0, C, generator=gen)
        for mode in pool_ops.MODES:
            label = f"[families] (a) voxelize {mode} C={C}"
            xc = x.detach().clone().requires_grad_()
            ref = pool_ops.voxelize_features(xc, p2v, cap0, seg, counts, mode)
            (ref * ct).sum().backward()
            args = [a.to(dev) for a in (p2v, seg, counts)]
            xd = x.to(dev).detach().requires_grad_()
            out = pool_ops.voxelize_features(xd, args[0], cap0, args[1],
                                             args[2], mode)
            (out * ct.to(dev)).sum().backward()
            err, _ = check_close(label, out, ref.detach(), F32_TOL)
            gerr, _ = check_close(f"{label} gradient", xd.grad, xc.grad,
                                  F32_TOL)
            xn = xd.detach()
            with torch.no_grad():
                ms = cuda_ms(lambda: pool_ops.voxelize_features(
                    xn, args[0], cap0, args[1], args[2], mode), 5)
            bnd, _ = bound_ms(0.0, nbytes(xn, args[0]) + cap0 * C * 4)
            vox.append(dict(mode=mode, C=C, ms=ms, bound_ms=bnd,
                            max_abs_err=err, grad_err=gerr))
            print(f"{label:<40} P={P} voxels={plan.levels[0].num_active} "
                  f"max_abs_err={err:.3e} grad err={gerr:.3e} forward "
                  f"{ms:.4f} ms, byte bound {bnd:.4f} ms")
    torch.cuda.empty_cache()
    return dict(pool=rows, pool_sums=dict(sums), voxelize=vox)


def dense_conv_calls(plan, n_planes=N_PLANES, in_features=3):
    """The 33 chunk convolutions of one forward of `dense_semantic_model`
    on `plan` (the first conv, DenseUNet_BN's encoder residual blocks and
    strided convolutions, its decoder's deconvolutions and residual
    blocks), as `conv_calls` lists the UNet's."""
    caps = [l.cap for l in plan.levels]
    act = [l.num_active for l in plan.levels]
    lv = plan.levels
    L = len(n_planes)
    calls = [Conv("sub L0", lv[0].chunks, lv[0].chunks, caps[0], act[0],
                  in_features + (-in_features) % 16, n_planes[0], caps[0],
                  act[0], ("level", 0))]

    def sub(label, l):
        p = n_planes[l]
        calls.append(Conv(f"{label} L{l}", lv[l].chunks, lv[l].chunks,
                          caps[l], act[l], p, p, caps[l], act[l],
                          ("level", l)))
    for l in range(L):
        sub("res.conv1", l)
        sub("res.conv2", l)
        if l + 1 < L:
            tr = plan.transitions[l]
            calls.append(Conv(f"conv L{l}->L{l + 1}", tr.child_chunks,
                              tr.up_chunks, caps[l], act[l], n_planes[l],
                              n_planes[l + 1], caps[l + 1], act[l + 1],
                              ("child", l)))
    for l in range(L - 2, -1, -1):
        tr = plan.transitions[l]
        calls.append(Conv(f"deconv L{l + 1}->L{l}", tr.up_chunks,
                          tr.child_chunks, caps[l + 1], act[l + 1],
                          n_planes[l + 1], n_planes[l], caps[l], act[l],
                          ("up", l)))
        sub("res2.conv1", l)
        sub("res2.conv2", l)
    return calls


def dense_semantic_model(compute_dtype, seed):
    """InputLayer -> SubmanifoldConvolution(3, 64) -> DenseUNet_BN(N_PLANES,
    block_reps=1) -> OutputLayer -> Linear(64, 20): the dense-skip UNet as
    a semantic model (activations in `compute_dtype`, parameters f32,
    per-point features to f32 before the head)."""
    from occuseg_tpu_torch.models import DenseUNet_BN
    from occuseg_tpu_torch.models.occuseg import _linear
    from occuseg_tpu_torch.nn.modules import (
        InputLayer, OutputLayer, SubmanifoldConvolution,
    )
    from occuseg_tpu_torch.ops import acc

    class DenseSemantic(torch.nn.Module):
        def __init__(self):
            super().__init__()
            gen = torch.Generator().manual_seed(seed)
            self.input = InputLayer()
            self.sub = SubmanifoldConvolution(3, N_PLANES[0], generator=gen)
            self.dense = DenseUNet_BN(N_PLANES, block_reps=1, generator=gen)
            self.output = OutputLayer()
            self.linear = _linear(N_PLANES[0], 20, gen)

        def forward(self, feats, plan):
            x = self.input(feats.to(compute_dtype), plan)
            x = self.dense(self.sub(x, plan), plan)
            return self.linear(acc(self.output(x, plan)))
    return DenseSemantic()


def families_dense_unet(dev, train_med):
    """(b) The slice's main path: `dense_semantic_model` in bf16 (f32
    parameters, Adam) on the 3 bench scenes' host plans with chunk
    rulebooks and the sorted point layout, as [train]: the semantic
    cross-entropy, forward, backward and update; #1, #3-#5 and #2's
    launches per step predicted from the plan (printed first) and checked
    step by step and over the 9 timed steps; the median step beside
    [train]'s, the peak memory, one step profiled. Then one f32 step on
    the mid scene, card against CPU: loss, logits, gradients and new BN
    statistics."""
    from occuseg_tpu_torch.core.topology import PlanSpec
    from occuseg_tpu_torch.losses.instance import semantic_cross_entropy
    from occuseg_tpu_torch.train.state import prepare_batch
    spec = PlanSpec(caps=BENCH_CAPS)
    prepared = []
    for seed in (0, 1, 2):
        laid, plan = prepare_batch(bench_scene(seed), spec)
        check(all(l.chunks is not None for l in plan.levels),
              f"[families] (b) seed {seed}: a level is not chunked")
        calls = dense_conv_calls(plan)
        check(len(calls) == 33, f"[families] (b) {len(calls)} convolutions")
        pred = predicted_launches(plan, calls=calls)
        print(f"[families] (b) seed {seed}: {plan.levels[0].num_active} "
              f"voxels; predicted launches per DenseUNet_BN step {pred}")
        prepared.append((laid, plan, pred))
    model = dense_semantic_model(torch.bfloat16, 71).to(dev).train()
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)

    def step(laid, plan):
        dplan = plan.to(dev)
        feats = torch.as_tensor(laid["features"]).to(dev)
        labels = torch.as_tensor(laid["labels"]).to(dev)
        opt.zero_grad(set_to_none=True)
        loss = semantic_cross_entropy(model(feats, dplan), labels)
        loss.backward()
        opt.step()
        return loss.detach()
    for _ in range(2):
        step(*prepared[0][:2])
    torch.cuda.synchronize()
    before = [p.detach().clone() for p in model.parameters()]
    zero_launches()
    torch.cuda.reset_peak_memory_stats()
    expected = collections.Counter()
    step_ms, losses, per_seed = [], [], []
    for laid, plan, pred in prepared:
        seen = []
        for _ in range(3):
            t0 = time.perf_counter()
            was = read_launches()
            loss = step(laid, plan)
            seen.append({k: v - was[k] for k, v in read_launches().items()})
            torch.cuda.synchronize()
            step_ms.append(1e3 * (time.perf_counter() - t0))
            losses.append(float(loss))
        expected.update({k: 3 * v for k, v in pred.items()})
        per_seed.append(seen)
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated() / 2**30
    moved = sum(not torch.equal(p.detach(), q)
                for p, q in zip(model.parameters(), before))
    med = sorted(step_ms)[len(step_ms) // 2]
    print(f"[families] (b) DenseUNet_BN bf16 steps: median {med:.2f} ms (min "
          f"{min(step_ms):.2f}, max {max(step_ms):.2f}; [train]'s "
          f"LearningBWDenseUNet median {train_med:.2f} ms); peak device "
          f"memory {peak:.2f} GiB; losses "
          + ", ".join(f"{v:.4f}" for v in losses)
          + f"; {moved} of {len(before)} parameter tensors moved")
    print(f"[families] (b) launches {launches}, expected {dict(expected)}")
    check(all(v == v and abs(v) != float("inf") for v in losses),
          "[families] (b) loss not finite")
    check(moved == len(before), f"[families] (b) {moved} moved")
    check(launches == dict(expected), f"[families] (b) launches {launches}, "
          f"expected {dict(expected)}")
    for (_, _, pred), seen in zip(prepared, per_seed):
        check(all(s == pred for s in seen), f"[families] (b) one step's "
              f"launches {seen}, predicted {pred}")
    busy = profile_step(lambda: step(*prepared[0][:2]), "families")
    print(f"[families] (b) device busy {busy:.2f} ms of the median step "
          f"{med:.2f} ms ({100 * busy / med:.1f}%)")
    per_step = per_seed[0][0]   # seed 0's first timed step, as counted
    del model, opt, prepared
    torch.cuda.empty_cache()

    # f32, card against CPU on the mid scene
    laid, plan = prepare_batch(_mid_scene(), PlanSpec(caps=MID_CAPS))
    m32 = dense_semantic_model(torch.float32, 72)
    randomize_bn_stats(m32, torch.Generator().manual_seed(73))
    res = {}
    for d in ("cpu", dev):
        m = copy.deepcopy(m32).to(d).train()
        dplan = plan.to(d)
        feats = torch.as_tensor(laid["features"]).to(d)
        labels = torch.as_tensor(laid["labels"]).to(d)
        logits = m(feats, dplan)
        loss = semantic_cross_entropy(logits, labels)
        loss.backward()
        res[str(d)] = (float(loss), logits.detach().cpu(),
                       [p.grad.detach().cpu() for p in m.parameters()],
                       [b.detach().cpu() for b in m.buffers()])
    (lc, oc, gc_, bc), (lg, og, gg, bg) = res["cpu"], res[str(dev)]
    check(abs(lg - lc) <= PARITY_TOL * abs(lc) + 1e-6,
          f"[families] (b) f32 loss {lg} vs {lc}")
    err, scale = check_close("[families] (b) f32 logits", og, oc, PARITY_TOL)
    names = [n for n, _ in m32.named_parameters()]
    g_glob, worst = _grad_check("[families] (b) f32", gg, gc_, names)
    for a, b in zip(bg, bc):
        check((a - b).abs().max().item() <= PARITY_TOL * b.abs().max().item()
              + 1e-6, "[families] (b) f32 BN statistic")
    print(f"[families] (b) f32 mid scene, card against CPU: loss {lg:.6f} / "
          f"{lc:.6f}; logits error {err:.3e} of max {scale:.3e}; gradients "
          f"{g_glob:.3e} of the norm, worst tensor {worst:.3e} of its max; "
          f"new BN statistics agree")
    torch.cuda.empty_cache()
    return dict(launches_per_step=per_step, step_ms=med,
                min_step_ms=min(step_ms), train_step_ms=train_med,
                peak_gib=peak, busy_ms=busy,
                f32_vs_cpu=dict(grad_global=g_glob, grad_worst=worst))


def families_three_voxel(dev):
    """(c) ThreeVoxelKernel at N_PLANES: a bench-scene request through
    `Predictor` in bf16 (33 chunk forwards + 1 segment sum, outputs finite
    and in the request's point order), then the f32 model card against
    CPU on the mid scene with [parity]'s tolerances."""
    from occuseg_tpu_torch.core.topology import PlanSpec
    from occuseg_tpu_torch.infer import Predictor, prepare_scene
    from occuseg_tpu_torch.models import ThreeVoxelKernel
    model = ThreeVoxelKernel(N_PLANES, compute_dtype=torch.bfloat16,
                             generator=torch.Generator().manual_seed(74))
    randomize_bn_stats(model, torch.Generator().manual_seed(75))
    batch = bench_scene(0)
    scene = prepare_scene(batch["coords"], batch["features"],
                          PlanSpec(caps=BENCH_CAPS))
    predictor = Predictor(model, dev)
    predictor(scene)
    torch.cuda.synchronize()
    zero_launches()
    t0 = time.perf_counter()
    out = predictor(scene)
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0)
    launches = {k: v for k, v in read_launches().items() if v}
    check(launches == {"chunk_conv": 33, "blocked_segment_sum": 1},
          f"[families] (c) launches {launches}")
    P = batch["coords"].shape[0]
    for name in ("semantics", "features", "embedding", "offset"):
        t = getattr(out, name)
        check(t.shape[0] == P and bool(torch.isfinite(t).all()),
              f"[families] (c) {name}")
    check(bool((out.displacement == 0).all()) and out.bw is None,
          "[families] (c) displacement / heads")
    print(f"[families] (c) ThreeVoxelKernel bench request: forward {ms:.2f} "
          f"ms, launches {launches}")
    mid = _mid_scene()
    m32 = ThreeVoxelKernel(N_PLANES, generator=torch.Generator()
                           .manual_seed(76))
    randomize_bn_stats(m32, torch.Generator().manual_seed(77))
    forward_parity(dev, prepare_scene(mid["coords"], mid["features"],
                                      PlanSpec(caps=MID_CAPS)), m32,
                   phase="families")
    torch.cuda.empty_cache()
    return dict(forward_ms=ms, launches=launches)


def _convs(model):
    from occuseg_tpu_torch.nn.modules import (
        Convolution, Deconvolution, SubmanifoldConvolution,
    )
    return sum(isinstance(m, (Convolution, Deconvolution,
                              SubmanifoldConvolution))
               for m in model.modules())


def _builders(dev):
    """(d)'s three nets, its input per net, and the mid scene's device
    plans at SIZE3_CAPS on the CPU and the card."""
    from occuseg_tpu_torch.core.topology import PlanSpec, build_plan
    from occuseg_tpu_torch.nn.unet import (
        FullyConvolutionalNet, SparseResNet, SparseVggNet,
    )
    spec = PlanSpec(caps=SIZE3_CAPS, down_size=3, down_stride=2)
    coords = _mid_scene()["coords"]
    plans = {str(d): build_plan(torch.from_numpy(coords).to(d), spec)
             for d in ("cpu", dev)}
    g = torch.Generator().manual_seed(78)
    nets = (("FullyConvolutionalNet", FullyConvolutionalNet(
                1, (32, 64, 96), down_size=3, generator=g), 32),
            ("SparseVggNet", SparseVggNet(3, (("C", 32), "MP", ("C", 64),
                                              ("C", 32, 32, 32, 32)), g), 3),
            ("SparseResNet", SparseResNet(3, (("b", 32, 1, 1),
                                              ("b", 64, 2, 2),
                                              ("b", 96, 1, 2)), g), 3))
    lvl0 = plans["cpu"].levels[0]
    out = []
    for name, net, cin in nets:
        randomize_bn_stats(net, torch.Generator().manual_seed(79))
        x = torch.randn(lvl0.cap, cin, generator=g)
        x[lvl0.num_active:] = 0
        out.append((name, net, x))
    return out, plans


def _builder_step(net, x, plan, d, dtype=torch.float32, masks=None,
                  replay=False):
    """One training-mode forward and backward of a copy of `net` on `d`
    in `dtype` against a seeded cotangent: (output, level, input
    gradient, parameter gradients, new buffers, ReLU masks), on the CPU.
    The BN-ReLU branches are recorded, or imposed from `masks` with
    `replay` (`choices`)."""
    from occuseg_tpu_torch.core.sparse_tensor import SparseTensor
    from occuseg_tpu_torch.ops import norm as norm_ops
    m = copy.deepcopy(net).to(device=d, dtype=dtype).train()
    f = x.to(d, dtype).detach().requires_grad_()
    with choices([] if masks is None else masks, replay,
                 (norm_ops, "_affine", bn_branches)) as masks:
        y = m(SparseTensor(features=f, num_active=plan.levels[0]
                           .num_active, level=0), plan)
        ct = torch.randn(y.features.shape, generator=torch.Generator()
                         .manual_seed(80)).to(d, dtype)
        (y.features * ct).sum().backward()
    return (y.features.detach().cpu(), y.level, f.grad.cpu(),
            [p.grad.cpu() for p in m.parameters()],
            [b.cpu() for b in m.buffers()], masks)


def _flips(a, b):
    """Elements whose ReLU branch differs between two mask lists."""
    return sum(int((p != q).sum()) for p, q in zip(a, b))


def _float64_errors(label, runs, g64, names):
    """Each run's gradients ([input] + parameters) against the float64
    ones: the share of the norm, printed with the three worst tensors
    (share of each tensor's max); returns {run: norm share}."""
    out = {}
    for who, grads in runs.items():
        out[who] = _glob(grads, g64)
        worst = sorted(((_rel(a, r), n) for a, r, n
                        in zip(grads, g64, names)), reverse=True)[:3]
        print(f"{label} float64 reference: {who} {out[who]:.3e} of the norm"
              f"; worst " + ", ".join(f"{n} {e:.2e}" for e, n in worst))
    return out


@contextlib.contextmanager
def choices(masks, replay, *sites):
    """Record into `masks` (or, with `replay`, impose from it, in the same
    order) the discrete choices a step makes at `sites`: (module, name,
    wrap), where wrap(f, choose, replay) replaces module.name. Recording,
    it computes f as it is and passes each choice's mask to choose;
    replaying, choose(t) returns the next recorded mask on t's device,
    and the wrapper takes the branches it names. Imposed on another
    device's step (or a float64 one), the card's choices leave the two
    apart by rounding alone, where rounding would otherwise flip the few
    near a tie."""
    n = [0]

    def choose(mask):
        if replay:
            mask = masks[n[0]].to(mask.device)
            n[0] += 1
        else:
            masks.append(mask.cpu())
        return mask
    saved = [(m, name, getattr(m, name)) for m, name, _ in sites]
    for m, name, wrap in sites:
        setattr(m, name, wrap(getattr(m, name), choose, replay))
    try:
        yield masks
    finally:
        for m, name, f in saved:
            setattr(m, name, f)


def bn_branches(affine, choose, replay):
    """The sparse BN-(leaky)ReLU's branch: which rows x channels are
    positive (`ops/norm._affine`; its output is positive where its input
    is, for every leakiness)."""
    def wrapped(feats, num_active, mean, inv_std, scale, bias, leakiness):
        if leakiness == 1.0 or not replay:
            y = affine(feats, num_active, mean, inv_std, scale, bias,
                       leakiness)
            if leakiness != 1.0:
                choose(y > 0)
            return y
        y = affine(feats, num_active, mean, inv_std, scale, bias, 1.0)
        return torch.where(choose(y > 0), y, leakiness * y)
    return wrapped


def leaky_branches(leaky, choose, replay):
    """ClusterSegNet's leaky ReLU's branch (`models/occuseg._leaky`)."""
    def wrapped(h, slope=0.01):
        if not replay:
            choose(h >= 0)
            return leaky(h, slope)
        return torch.where(choose(h >= 0), h, slope * h)
    return wrapped


def max_winners(segment_max, choose, replay):
    """The rows that hold each segment's maximum, per channel
    (`models/occuseg.segment_max`). Imposed, each segment and channel
    takes the mean of its recorded rows, so its gradient splits evenly
    among them, as the maximum splits it among tied rows (the card can
    tie where the CPU does not)."""
    def wrapped(x, seg, num_segments):
        seg = seg.long()
        if not replay:
            out = segment_max(x, seg, num_segments)
            choose(x.detach() == out.detach()[seg])
            return out
        win = choose(x.detach() > 0)
        z = torch.zeros((num_segments, x.shape[1]), dtype=x.dtype,
                        device=x.device)
        cnt = z.index_add(0, seg, win.to(x.dtype))
        tot = z.index_add(0, seg, torch.where(win, x, 0.0))
        return torch.where(cnt > 0, tot / cnt.clamp(min=1), float("-inf"))
    return wrapped


def builders_float64_sources(dev, which=("FullyConvolutionalNet",
                                         "SparseResNet")):
    """Where (d)'s card gradients part from float64: each net's f32 step
    on the card with #9 as it is and with its plain version run on the
    card, each with the BN statistics in f32 (as the port computes them)
    and in f64, and the CPU's f32 step, each against the float64 step on
    the CPU with that run's own ReLU branches imposed, and, for the
    card's first run and the CPU's, against the free float64 step;
    printed with the elements whose branch differs from the free float64
    step's, and returned as {net: {run: norm share}}, with the free
    float64 step's own movement under 1e-7 and 1e-6 relative input
    noise (smooth: in proportion; across a kink: a jump). A diagnosis,
    not run by `main`; with dev the CPU, every "card" run is the CPU's."""
    from occuseg_tpu_torch.ops import norm as norm_ops
    from occuseg_tpu_torch.ops.kernels import gather_conv as gc
    nets, plans = _builders(dev)
    kernel, acc = gc.gather_conv, norm_ops.acc
    out = {}
    for name, net, x in nets:
        if name not in which:
            continue
        label = f"[families] (d) {name}"
        names = ["input"] + [n for n, _ in net.named_parameters()]
        free = _builder_step(net, x, plans["cpu"], "cpu", torch.float64)
        runs = {"CPU f32": _builder_step(net, x, plans["cpu"], "cpu")}
        for plain in (False, True):
            for bn64 in (False, True):
                gc.gather_conv = gc.gather_conv_plain if plain else kernel
                norm_ops.acc = (lambda t: t.double()) if bn64 else acc
                try:
                    runs[("card, #9 plain" if plain else "card, #9")
                         + (", BN statistics in f64" if bn64 else "")] = _builder_step(
                        net, x, plans[str(dev)], dev)
                finally:
                    gc.gather_conv, norm_ops.acc = kernel, acc
        errs = {}
        for who, r in runs.items():
            ref = _builder_step(net, x, plans["cpu"], "cpu", torch.float64,
                                r[5], replay=True)
            print(f"{label} {who}: {_flips(r[5], free[5])} ReLU branches "
                  f"differ from the free float64 step's")
            errs[who] = _float64_errors(
                label, {who + " (its branches)": [r[2]] + r[3]},
                [ref[2]] + ref[3], names)[who + " (its branches)"]
        errs.update(_float64_errors(
            label, {f"{who} (free float64)": [runs[who][2]] + runs[who][3]
                    for who in ("CPU f32", "card, #9")},
            [free[2]] + free[3], names))
        for eps in (1e-7, 1e-6):
            xn = x.double() * (1 + eps * torch.randn(
                x.shape, dtype=torch.float64,
                generator=torch.Generator().manual_seed(1)))
            r = _builder_step(net, xn, plans["cpu"], "cpu", torch.float64)
            key = f"float64 under {eps:g} noise"
            errs[key] = _glob([r[2]] + r[3], [free[2]] + free[3])
            print(f"{label} the free float64 step under {eps:g} input "
                  f"noise moves {errs[key]:.3e} of the norm")
        out[name] = errs
    torch.cuda.empty_cache()
    return out


def f32_step_float64_gap(dev):
    """ROADMAP C8's yardstick on #1 and the weight-gradient kernel: a
    residual UNet (64-128-192-256, one block a level) on the mid scene's
    chunked host plan, one training-mode forward and backward against a
    seeded cotangent (`_builder_step`), on the card with every f32 tile
    the wrappers take (`chunk_conv.f32_route`, `chunk_conv.dw_route`: the
    tensor cores where a block fits), on the card with the dW kernel on
    its FMA tile, with #1 and the dW kernel both on their FMA tiles (the
    route rules replaced for the run), and on the CPU; each run's
    gradients against the float64 step on the CPU with that run's own
    ReLU branches imposed (`choices`), as a share of the norm, and each
    card run's share over the CPU's. The float64 step runs on the plan
    without rulebooks (the gather path sums in float64; the chunk path's
    plain version in f32). Returns {run: share}. A diagnosis, not run by
    `main`."""
    from occuseg_tpu_torch.core.topology import PlanSpec
    from occuseg_tpu_torch.infer import prepare_scene
    from occuseg_tpu_torch.nn.unet import UNet
    from occuseg_tpu_torch.ops.kernels import chunk_conv as cc
    b = _mid_scene()
    plan = prepare_scene(b["coords"], b["features"],
                         PlanSpec(caps=MID_CAPS)).plan
    plans = {"cpu": plan.to(torch.device("cpu")), "card": plan.to(dev)}
    g = torch.Generator().manual_seed(81)
    net = UNet(1, (64, 128, 192, 256), residual_blocks=True, generator=g)
    randomize_bn_stats(net, torch.Generator().manual_seed(82))
    lvl0 = plan.levels[0]
    x = torch.randn(lvl0.cap, 64, generator=g)
    x[lvl0.num_active:] = 0
    names = ["input"] + [n for n, _ in net.named_parameters()]
    runs = {"CPU f32": _builder_step(net, x, plans["cpu"], "cpu")}
    routes = {}
    rules = (cc.f32_route, cc.dw_route)
    for who, fma in (("card as routed", ()),
                     ("card, dW on the FMA tile", ("dw_route",)),
                     ("card, #1 and dW on the FMA tiles",
                      ("f32_route", "dw_route"))):
        for rule in fma:
            setattr(cc, rule, lambda *args, **kw: "fma")
        try:
            zero_launches()
            runs[who] = _builder_step(net, x, plans["card"], dev)
            routes[who] = read_routes()
        finally:
            cc.f32_route, cc.dw_route = rules
    out = {}
    L = len(plan.levels)
    plan64 = drop_chunks(plans["cpu"], range(L), range(L - 1))
    for who, r in runs.items():
        ref = _builder_step(net, x, plan64, "cpu", torch.float64, r[5],
                            replay=True)
        out[who] = _float64_errors("[c8]", {who: [r[2]] + r[3]},
                                   [ref[2]] + ref[3], names)[who]
    print(f"[c8] f32 step against float64 with each run's ReLU branches: "
          f"CPU {out['CPU f32']:.3e}; " + "; ".join(
              f"{who} (f32 launches by tile {routes[who]}) {out[who]:.3e} = "
              f"{out[who] / out['CPU f32']:.2f}x the CPU's"
              for who in routes))
    torch.cuda.empty_cache()
    return out


def families_builders(dev):
    """(d) FullyConvolutionalNet, SparseVggNet ("MP" and a Plus spec of
    depth 3) and SparseResNet (stride-2 basic blocks) on the mid scene's
    device plans at SIZE3_CAPS (size-3 stride-2 transitions), training
    mode. A step's gradients jump where a pre-activation crosses 0, and
    f32 rounding moves the few within ~1e-7 of it: the CPU's f32
    ResNet step takes one branch other than the float64 step's and lands
    3.4e-4 of the norm from it, 6.5e-7 with that branch imposed. So the
    card's step records its ReLU branches (`choices`), and with them
    imposed the CPU's f32 step holds its output, input and parameter
    gradients and new BN statistics to [parity]'s tolerances; the card's
    gradients against the float64 step with the card's branches stay
    within five times the CPU's free f32 step against the float64 one
    with the CPU's (the rule of `float64_reference`). #9 launched twice
    per convolution (forward and d_feats: every convolution's input
    needs its gradient), against the count."""
    nets, plans = _builders(dev)
    cpu = plans["cpu"]
    out = {}
    for name, net, x in nets:
        label = f"[families] (d) {name}"
        zero_launches()
        og, lg, dg, gg, bg, mg = _builder_step(net, x, plans[str(dev)], dev)
        torch.cuda.synchronize()
        launches = {k: v for k, v in read_launches().items() if v}
        free = _builder_step(net, x, cpu, "cpu")
        oc, lc, dc, gc_, bc, _ = _builder_step(net, x, cpu, "cpu", masks=mg,
                                               replay=True)
        want = {"gather_conv": 2 * _convs(net)}
        check(lg == lc, f"{label} level")
        err, scale = check_close(f"{label} output", og, oc, PARITY_TOL)
        names = ["input"] + [n for n, _ in net.named_parameters()]
        g_glob, worst = _grad_check(label, [dg] + gg, [dc] + gc_, names)
        for a, b in zip(bg, bc):
            check((a - b).abs().max().item() <= PARITY_TOL
                  * b.abs().max().item() + 1e-6, f"{label} BN statistic")
        check(launches == want, f"{label} launches {launches}, expected "
              f"{want}")
        r64 = {who: _builder_step(net, x, cpu, "cpu", torch.float64, m,
                                  replay=True)
               for who, m in (("card", mg), ("CPU", free[5]))}
        e_card = _glob([dg] + gg, [r64["card"][2]] + r64["card"][3])
        e_cpu = _glob([free[2]] + free[3], [r64["CPU"][2]] + r64["CPU"][3])
        flips = _flips(mg, free[5])
        g_free = _glob([dg] + gg, [free[2]] + free[3])
        print(f"{label}: output {tuple(og.shape)} at level {lg}, error "
              f"{err:.3e} of max {scale:.3e}; with the card's ReLU "
              f"branches gradients {g_glob:.3e} of the norm, worst "
              f"{worst:.3e}; {flips} branches differ from the CPU's own, "
              f"which alone is {g_free:.3e} from the card; against float64 "
              f"with each one's branches: card {e_card:.3e}, CPU f32 "
              f"{e_cpu:.3e} of the norm; launches {launches} as predicted")
        check(e_card <= 5 * e_cpu, f"{label} float64 reference: the card's "
              f"gradient error {e_card} is past five times the CPU's {e_cpu}")
        out[name] = dict(launches=launches.get("gather_conv", 0),
                         grad_global=g_glob, branch_flips=flips,
                         grad_global_free=g_free, float64_card=e_card,
                         float64_cpu=e_cpu)
    torch.cuda.empty_cache()
    return out


# the bench scene's randomized levels: jittered windows hold more coarse
# sites than regular ones (142,521 at level 1 from seed 17 against the
# regular plan's 130,259)
RANDOMIZED_CAPS = (196_608, 196_608, 98_304)


def families_randomized(dev):
    """(e) `build_randomized_plan` of the bench scene (3 levels at
    RANDOMIZED_CAPS, extent 512) on the card, equal bit for bit to
    the CPU's build from the same numpy seed; its CUDA-event ms (warm,
    median of 3) and host reads; a SubmanifoldConvolution(3, 64) ->
    RandomizedStrideConvolution(64, 128) -> RandomizedStrideMaxPooling
    net over it, card against CPU (output, gradients; #9 launched 3
    times: the two forwards and the strided one's d_feats); #9 on the
    jittered child and up maps against its plain version."""
    import numpy as np
    from occuseg_tpu_torch.core.randomized import build_randomized_plan
    from occuseg_tpu_torch.core.sparse_tensor import SparseTensor
    from occuseg_tpu_torch.core.topology import PlanSpec
    from occuseg_tpu_torch.nn.modules import (
        RandomizedStrideConvolution, RandomizedStrideMaxPooling,
        SubmanifoldConvolution,
    )
    spec = PlanSpec(caps=RANDOMIZED_CAPS)
    coords = bench_scene(0)["coords"]
    cd = torch.from_numpy(coords).to(dev)

    def build(c):
        return build_randomized_plan(c, spec, np.random.default_rng(17), 512)
    build(cd)
    ms = []
    for _ in range(3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        dp = build(cd)
        end.record()
        torch.cuda.synchronize()
        ms.append((start.elapsed_time(end), 1e3 * (time.perf_counter() - t0)))
    _, reads = host_reads(lambda: build(cd))
    t0 = time.perf_counter()
    cp = build(torch.from_numpy(coords))
    cpu_ms = 1e3 * (time.perf_counter() - t0)
    same_plan("[families] (e) randomized plan", dp, cp)
    check(all(l.num_active < l.cap for l in dp.levels),
          f"[families] (e) a level fills its cap")
    dev_ms, host_ms = sorted(ms)[1]
    print(f"[families] (e) randomized plan: voxels per level "
          f"{[l.num_active for l in dp.levels]}; equal to the CPU's build bit "
          f"for bit; {dev_ms:.3f} ms on the card (CUDA events; host clock "
          f"{host_ms:.3f} ms; warm, median of 3), {reads} host read(s); the "
          f"CPU's build {cpu_ms:.1f} ms")
    g = torch.Generator().manual_seed(81)
    net = torch.nn.ModuleList([SubmanifoldConvolution(3, 64, generator=g),
                               RandomizedStrideConvolution(64, 128,
                                                           generator=g),
                               RandomizedStrideMaxPooling()])
    lvl0 = cp.levels[0]
    x = torch.randn(lvl0.cap, 3, generator=g)
    x[lvl0.num_active:] = 0
    res = {}
    for d, plan in (("cpu", cp), (dev, dp)):
        m = copy.deepcopy(net).to(d)
        zero_launches()
        y = SparseTensor(features=x.to(d), num_active=lvl0.num_active,
                         level=0)
        for mod in m:
            y = mod(y, plan)
        ct = torch.randn(y.features.shape, generator=torch.Generator()
                         .manual_seed(82)).to(d)
        (y.features * ct).sum().backward()
        if d != "cpu":
            torch.cuda.synchronize()
            launches = {k: v for k, v in read_launches().items() if v}
        res[str(d)] = (y.features.detach().cpu(), y.level,
                       [p.grad.cpu() for p in m.parameters()])
    (oc, lc, gc_), (og, lg, gg) = res["cpu"], res[str(dev)]
    check(lg == lc == 2, "[families] (e) level")
    err, scale = check_close("[families] (e) net output", og, oc, PARITY_TOL)
    g_glob, worst = _grad_check("[families] (e) net", gg, gc_,
                                ["sub", "rconv"])
    check(launches == {"gather_conv": 3}, f"[families] (e) net launches "
          f"{launches}")
    print(f"[families] (e) randomized-stride net 3 -> 64 -> 128: error "
          f"{err:.3e} of max {scale:.3e}, gradients {g_glob:.3e} of the "
          f"norm; launches {launches}")
    t0, t1 = dp.transitions
    l0, l1, l2 = dp.levels
    roles = [("randomized child T0", t0.kn["child"], l0, 64, 128),
             ("randomized up T0 (d_feats)", t0.kn["up"], l1, 128, 64),
             ("randomized child T1", t1.kn["child"], l1, 128, 192),
             ("randomized up T1 (d_feats)", t1.kn["up"], l2, 192, 128)]
    timed = time_gather_roles(dev, roles, "[families] (e)", 83)
    torch.cuda.empty_cache()
    return dict(plan_device_ms=dev_ms, plan_host_clock_ms=host_ms,
                host_reads=reads, plan_cpu_ms=cpu_ms,
                voxels=[l.num_active for l in dp.levels],
                net_launches=launches.get("gather_conv", 0), **timed)


SHAPE_CAPS = (12_288, 16_384, 6_144, 2_048)


def shape_batches(seed, n_batches, batch_size=8, points=1500, p_cap=12_288):
    """Batches of synthetic shapes in two classes that the shape decides:
    a sphere shell (class 0) or a cube's surface (class 1) of random size
    in a 48^3 grid, one per sample; features 1 at every point."""
    import numpy as np

    def gen():
        rng = np.random.default_rng(seed)
        for _ in range(n_batches):
            pts, labels = [], []
            for b in range(batch_size):
                cls = int(rng.integers(0, 2))
                d = rng.standard_normal((points, 3))
                d /= np.linalg.norm(d, axis=1, keepdims=True)
                if cls == 0:
                    p = d * rng.uniform(10, 18)
                else:
                    p = d / np.abs(d).max(1, keepdims=True) \
                        * rng.uniform(8, 14)
                p = np.clip(np.round(p + 24), 0, 47)
                pts.append(np.concatenate([np.full((points, 1), b), p], 1))
                labels.append(cls)
            c = np.concatenate(pts).astype(np.int32)
            c = np.concatenate([c, -np.ones((p_cap - len(c), 4), np.int32)])
            f = (c[:, :1] >= 0).repeat(3, 1).astype(np.float32)
            yield {"coords": c, "features": f,
                   "label": np.asarray(labels, np.int32)}
    return gen


def shape_classifier(seed):
    """InputLayer -> SubmanifoldConvolution(3, 32) -> SparseResNet (basic
    blocks at 32, 64, 96, 128, strides 1, 2, 2, 2) -> ActivePooling(8) ->
    Linear(128, 2)."""
    from occuseg_tpu_torch.models.occuseg import _linear
    from occuseg_tpu_torch.nn.extras import ActivePooling
    from occuseg_tpu_torch.nn.modules import (
        InputLayer, SubmanifoldConvolution,
    )
    from occuseg_tpu_torch.nn.unet import SparseResNet

    class ShapeNet(torch.nn.Module):
        def __init__(self):
            super().__init__()
            g = torch.Generator().manual_seed(seed)
            self.input = InputLayer()
            self.sub = SubmanifoldConvolution(3, 32, generator=g)
            self.resnet = SparseResNet(32, (("b", 32, 1, 1), ("b", 64, 1, 2),
                                            ("b", 96, 1, 2), ("b", 128, 1, 2)),
                                       g)
            self.pool = ActivePooling(num_samples=8)
            self.head = _linear(128, 2, g)

        def forward(self, feats, plan):
            x = self.resnet(self.sub(self.input(feats, plan), plan), plan)
            return self.head(self.pool(x, plan))
    return ShapeNet()


def families_classification(dev):
    """(f) `classification_train_validate` on the card: `shape_classifier`
    over 64 shapes (8 batches of 8), 2 epochs at lr 1e-3, validated on 16
    more, every batch planned on the card (SHAPE_CAPS, size-3 stride-2
    transitions); the first step's loss against the CPU's from the same
    weights; the history finite; #9's launches against the count (per
    step every convolution's forward and, but for the first, its d_feats;
    per validation batch the forwards); seconds per epoch and the
    validation accuracy printed, not gated."""
    import math
    from occuseg_tpu_torch.core.topology import PlanSpec
    from occuseg_tpu_torch.train.classification import (
        classification_train_validate,
    )
    spec = PlanSpec(caps=SHAPE_CAPS, down_size=3, down_stride=2)
    model = shape_classifier(84)
    first = shape_batches(85, 1)
    none = lambda: iter(())  # noqa: E731
    one = {str(d): classification_train_validate(
        copy.deepcopy(model), spec, first, none, 1, 1e-3,
        device=d)["history"][0]["loss"] for d in ("cpu", dev)}
    check(abs(one[str(dev)] - one["cpu"]) <= PARITY_TOL * abs(one["cpu"]),
          f"[families] (f) first step loss {one}")
    n_conv = _convs(model)
    steps, vals, epochs = 8, 2, 2
    want = {"gather_conv": epochs * (steps * (2 * n_conv - 1)
                                     + vals * n_conv)}
    zero_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = classification_train_validate(
        copy.deepcopy(model), spec, shape_batches(86, steps),
        shape_batches(87, vals), epochs, 1e-3, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: v for k, v in read_launches().items() if v}
    hist = res["history"]
    check(all(math.isfinite(h[k]) for h in hist for k in h),
          f"[families] (f) history {hist}")
    check(launches == want, f"[families] (f) launches {launches}, expected "
          f"{want}")
    print(f"[families] (f) classification harness: first step loss card "
          f"{one[str(dev)]:.6f}, CPU {one['cpu']:.6f}; {epochs} epochs of "
          f"{steps} steps in {wall:.2f} s ({wall / epochs:.2f} s per epoch, "
          f"validation included); history {hist}; launches {launches} as "
          f"predicted")
    return dict(first_loss=one, seconds_per_epoch=wall / epochs,
                history=hist, launches=launches.get("gather_conv", 0))


def families_extras(dev):
    """(g) ClusterSegNet at P = 262,144, 64-wide features and 1024
    clusters, training mode: logits, input and parameter gradients and
    running statistics, card against the CPU with the card's choices
    imposed (`choices`: the per-cluster max sends a channel's gradient to
    one point, and near ties among a cluster's ~256 points flip with
    rounding, as do leaky ReLU branches near 0); then on the mid scene
    planned on each device: `upsample_feature` (nearest and trilinear,
    level 1 to 0), ShapeContext, MultiscaleShapeContext, `sparse_to_dense` (forward
    and gradients), `sparsify_coords` and `compare_sparse`, card against
    CPU (coordinates exactly, the rest within F32_TOL)."""
    from occuseg_tpu_torch.core.sparse_tensor import SparseTensor
    from occuseg_tpu_torch.core.topology import PlanSpec, build_plan
    from occuseg_tpu_torch.models import ClusterSegNet
    from occuseg_tpu_torch.nn import extras
    from occuseg_tpu_torch.models import occuseg as occ_models
    g = torch.Generator().manual_seed(88)
    P = BENCH_P_CAP
    net = ClusterSegNet(64, num_classes=20, num_clusters=1024, generator=g)
    feats = torch.randn(P, 64, generator=g)
    ci = torch.randint(-1, 1024, (P,), generator=g)
    ct = torch.randn(1024, 20, generator=g)
    sites = ((occ_models, "_leaky", leaky_branches),
             (occ_models, "segment_max", max_winners))
    res = {}
    for d, masks in ((dev, None), ("cpu", None), ("cpu", "card")):
        m = copy.deepcopy(net).to(d).train()
        f = feats.to(d).detach().requires_grad_()
        t0 = time.perf_counter()
        with choices([] if masks is None else res[str(dev)][5],
                     masks is not None, *sites) as made:
            y = m(f, ci.to(d))
            (y * ct.to(d)).sum().backward()
        if d != "cpu":
            torch.cuda.synchronize()
        res[str(d) if masks is None else masks] = (
            y.detach().cpu(), f.grad.cpu(), [p.grad.cpu()
                                            for p in m.parameters()],
            [b.cpu() for b in m.buffers()], 1e3 * (time.perf_counter() - t0),
            made)
    (oc, dc, gc_, bc, _, _), (og, dg, gg, bg, g_ms, mg) = (res["card"],
                                                           res[str(dev)])
    free = res["cpu"]
    c_ms = free[4]
    err, scale = check_close("[families] (g) ClusterSegNet logits", og, oc,
                             PARITY_TOL)
    g_glob, worst = _grad_check("[families] (g) ClusterSegNet", [dg] + gg,
                                [dc] + gc_, ["input"] + [
                                    n for n, _ in net.named_parameters()],
                                zero=("mlp1.bias", "mlp2.bias", "l2_bn.bias",
                                      "mlp3.bias"))
    for a, b in zip(bg, bc):
        check((a - b).abs().max().item() <= PARITY_TOL * b.abs().max().item()
              + 1e-6, "[families] (g) ClusterSegNet running statistic")
    flips = _flips(mg, free[5])
    g_free = _glob([dg] + gg, [free[1]] + free[2])
    print(f"[families] (g) ClusterSegNet P={P}: logits error {err:.3e} of "
          f"max {scale:.3e}; with the card's choices (leaky ReLU branches, "
          f"cluster-max rows) gradients {g_glob:.3e} of the norm (worst "
          f"{worst:.3e}), running statistics agree; {flips} choices differ "
          f"from the CPU's own, which alone is {g_free:.3e} from the card; "
          f"a training call {g_ms:.1f} ms on the card (first call), "
          f"{c_ms:.1f} ms on the CPU")

    from occuseg_tpu_torch.data.synthetic import SceneConfig, make_batch
    batch = _mid_scene()
    other = make_batch(SceneConfig(num_points=20_000, extent=128,
                                   num_objects=8), num_scenes=1,
                       p_cap=MID_P_CAP, num_instances=16, seed=1)
    spec = PlanSpec(caps=MID_CAPS)
    C = 16
    out = {}
    for d in ("cpu", dev):
        plan = build_plan(torch.from_numpy(batch["coords"]).to(d), spec)
        plan_b = build_plan(torch.from_numpy(other["coords"]).to(d), spec)
        l0, l1 = plan.levels[0], plan.levels[1]
        gg_ = torch.Generator().manual_seed(89)
        x0 = torch.randn(l0.cap, C, generator=gg_)
        x0[l0.num_active:] = 0
        x1 = torch.randn(l1.cap, C, generator=gg_)
        x1[l1.num_active:] = 0
        xb = torch.randn(plan_b.levels[0].cap, C, generator=gg_)
        xb[plan_b.levels[0].num_active:] = 0
        r = {}

        def run(name, fn, x, level):
            f = x.to(d).detach().requires_grad_()
            y = fn(SparseTensor(features=f, num_active=plan.levels[level]
                                .num_active, level=level))
            y = y.features if hasattr(y, "features") else y
            ctv = torch.randn(y.shape, generator=torch.Generator()
                              .manual_seed(90)).to(d)
            (y * ctv).sum().backward()
            r[name] = (y.detach().cpu(), f.grad.cpu())
        run("upsample nearest",
            lambda t: extras.upsample_feature(t, 0, plan), x1, 1)
        run("upsample trilinear",
            lambda t: extras.upsample_feature(t, 0, plan, bilinear=True),
            x1, 1)
        run("ShapeContext", lambda t: extras.ShapeContext()(t, plan), x0, 0)
        run("MultiscaleShapeContext",
            lambda t: extras.MultiscaleShapeContext(3)(t, plan), x0, 0)
        run("sparse_to_dense",
            lambda t: extras.sparse_to_dense(t, plan, 128, 1), x0, 0)
        t0 = SparseTensor(features=x0.to(d), num_active=l0.num_active,
                          level=0)
        r["sparsify_coords"] = extras.sparsify_coords(t0, plan, l0.cap,
                                                      8.0).cpu()
        r["compare_sparse"] = extras.compare_sparse(
            plan, t0, plan_b, SparseTensor(
                features=xb.to(d), num_active=plan_b.levels[0].num_active,
                level=0)).cpu()
        out[str(d)] = r
    c, gd = out["cpu"], out[str(dev)]
    errs = {}
    for name in ("upsample nearest", "upsample trilinear", "ShapeContext",
                 "MultiscaleShapeContext", "sparse_to_dense"):
        e, _ = check_close(f"[families] (g) {name}", gd[name][0], c[name][0],
                           F32_TOL)
        ge, _ = check_close(f"[families] (g) {name} gradient", gd[name][1],
                            c[name][1], F32_TOL)
        errs[name] = (e, ge)
    check(torch.equal(gd["sparsify_coords"], c["sparsify_coords"]),
          "[families] (g) sparsify_coords differ")
    check(int((c["sparsify_coords"][:, 0] >= 0).sum()) > 0,
          "[families] (g) sparsify_coords kept nothing")
    err_cs, _ = check_close("[families] (g) compare_sparse",
                            gd["compare_sparse"], c["compare_sparse"],
                            F32_TOL)
    print("[families] (g) extras on the mid scene, card against CPU "
          "(forward error, gradient error): "
          + ", ".join(f"{k} {a:.2e} {b:.2e}" for k, (a, b) in errs.items())
          + f"; sparsify_coords equal ({int((c['sparsify_coords'][:, 0] >= 0).sum())}"
          f" kept); compare_sparse {float(gd['compare_sparse']):.6f}")
    torch.cuda.empty_cache()
    return dict(cluster_seg_net=dict(grad_global=g_glob, card_ms=g_ms,
                                     choice_flips=flips,
                                     grad_global_free=g_free),
                extras_err={k: v[0] for k, v in errs.items()})


def phase_families(dev, train_med):
    """[families]: (a)-(g) above; returns what the kernels line reports
    under "families"."""
    t0 = time.perf_counter()
    out = dict(pool=families_pool(dev))
    out["dense_unet_bn"] = families_dense_unet(dev, train_med)
    out["three_voxel_kernel"] = families_three_voxel(dev)
    out["builders"] = families_builders(dev)
    out["randomized"] = families_randomized(dev)
    out["classification"] = families_classification(dev)
    out["extras"] = families_extras(dev)
    out["seconds"] = time.perf_counter() - t0
    print(f"[families] all parts passed in {out['seconds']:.1f} s")
    return out


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
    fl = rep["floor"]
    print(f"[ap_gate] accuracy floor (tests/test_accuracy_floor.py), seed "
          f"{ap_gate.SEEDS[0]} after {ap_gate.FLOOR_STEPS} steps: total "
          f"{fl['first']['total']:.4f} -> {fl['last']['total']:.4f}, "
          f"regression {fl['first']['regression_loss']:.4f} -> "
          f"{fl['last']['regression_loss']:.4f}, instance IoU "
          f"{fl['first']['instance_iou']:.4f} -> "
          f"{fl['last']['instance_iou']:.4f}; {fl['checks']}")
    check(fl["passed"], f"[ap_gate] the accuracy floor failed: {fl}")
    check(rep["passed"], f"[ap_gate] a threshold failed: {rep}")
    s = ap_gate.soak(ap_gate.SEEDS[0], dev, steps=3)
    busy = profile_step(lambda: s.trainer.step(s.laid, s.plan), "ap_gate")
    med = float(np.median([r["step_ms"] for r in rep["seeds"].values()]))
    print(f"[ap_gate] device busy {busy:.2f} ms of the median step "
          f"{med:.2f} ms ({100 * busy / med:.1f}%)")
    return dict(report=rep, launches_per_step=pred, busy_ms=busy)


def legacy_docstring_model(scn, seed):
    """The reference UNet docstring's model at m=64
    (`networkArchitectures.py:207-213`), built with the facade's calls,
    between the facade's InputLayer (mode 4, the mean) and OutputLayer."""
    g, m = torch.Generator().manual_seed(seed), N_PLANES[0]
    model = scn.Sequential().add(
        scn.SubmanifoldConvolution(3, 3, m, 3, False, generator=g)).add(
        scn.UNet(3, 2, list(N_PLANES), residual_blocks=True,
                 generator=g)).add(
        scn.BatchNormReLU(m))
    return scn.Sequential().add(scn.InputLayer(3, 4096, mode=4)).add(
        model).add(scn.OutputLayer(3))


def legacy_direct_model(facade):
    """The same modules composed directly (no facade), with `facade`'s
    weights."""
    from occuseg_tpu_torch.nn.modules import (
        BatchNormReLU, InputLayer, OutputLayer, SubmanifoldConvolution,
    )
    from occuseg_tpu_torch.nn.unet import UNet

    class Direct(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.input = InputLayer()
            self.sub = SubmanifoldConvolution(3, N_PLANES[0])
            self.unet = UNet(2, N_PLANES, residual_blocks=True)
            self.bn = BatchNormReLU(N_PLANES[0])
            self.output = OutputLayer()

        def forward(self, feats, plan):
            x = self.sub(self.input(feats, plan), plan)
            return self.output(self.bn(self.unet(x, plan), plan), plan)
    direct = Direct()
    src, dst = facade.state_dict(), direct.state_dict()
    check([k.rsplit(".", 1)[-1] for k in src] ==
          [k.rsplit(".", 1)[-1] for k in dst]
          and all(src[a].shape == dst[b].shape for a, b in zip(src, dst)),
          "[legacy] the facade's and the direct model's parameters differ")
    direct.load_state_dict(dict(zip(dst, src.values())))
    return direct


def _fwd_bwd(model, feats, plan, ct):
    """A training-mode forward and backward against cotangent `ct`: the
    output and every parameter's gradient."""
    model.zero_grad(set_to_none=True)
    out = model.train()(feats, plan)
    (out.float() * ct).sum().backward()
    return out.detach(), [p.grad.detach().clone()
                          for p in model.parameters()]


class _Features(torch.nn.Module):
    """A sparse network on a level-0 tensor of `num_active` rows, taking
    and returning the features alone."""

    def __init__(self, net, num_active):
        super().__init__()
        self.net, self.num_active = net, num_active

    def forward(self, feats, plan):
        from occuseg_tpu_torch.core.sparse_tensor import SparseTensor
        return self.net(SparseTensor(features=feats,
                                     num_active=self.num_active), plan).features


def _card_vs_cpu(label, model, feats, plan, ct, dev):
    """An f32 training-mode forward and backward of copies of `model` on
    the card and on the CPU, the CPU taking the card's BN-(leaky)ReLU
    branches (`choices`: rounding flips the few near 0, and one flip
    moves a gradient tensor past GRAD_TOL; C item 8): the output within
    PARITY_TOL, the gradients within [parity]'s gradient tolerances and
    the new BN statistics within PARITY_TOL. Returns the errors."""
    from occuseg_tpu_torch.ops import norm as norm_ops
    res, masks = {}, []
    for d, replay in ((dev, False), ("cpu", True)):
        m = copy.deepcopy(model).to(d)
        with choices(masks, replay, (norm_ops, "_affine", bn_branches)):
            out, grads = _fwd_bwd(m, feats.to(d), plan.to(d), ct.to(d))
        res[str(d)] = (out.cpu(), [g.cpu() for g in grads],
                       [b.detach().cpu() for b in m.buffers()])
    (oc, gc_, bc), (og, gg, bg) = res["cpu"], res[str(dev)]
    err, scale = check_close(f"{label} output", og, oc, PARITY_TOL)
    names = [n for n, _ in model.named_parameters()]
    g_glob, worst = _grad_check(label, gg, gc_, names)
    for a, b in zip(bg, bc):
        check((a - b).abs().max().item() <= PARITY_TOL * b.abs().max().item()
              + 1e-6, f"{label} BN statistic")
    print(f"{label}, card against CPU with the card's {len(masks)} "
          f"BN-ReLU branch masks imposed: output {err:.3e} of max "
          f"{scale:.3e}; gradients {g_glob:.3e} of the norm, worst tensor "
          f"{worst:.3e} of its max; new BN statistics agree")
    return dict(out=err / scale, grad_global=g_glob, grad_worst=worst)


def legacy_docstring(dev):
    """[legacy] (a): the docstring model in bf16 (as [families]) on bench
    scene 0's chunked host plan, forward and backward: bit for bit the
    directly composed modules' with the same weights, its launches as the
    plan predicts (#1, #3-#5 from the 57 convolutions' routes, #2 twice),
    timed beside them; then in f32 on the mid scene, card against CPU with
    [parity]'s tolerances."""
    import occuseg_tpu_torch.legacy as scn
    from occuseg_tpu_torch.core.topology import PlanSpec
    from occuseg_tpu_torch.train.state import prepare_batch

    laid, plan = prepare_batch(bench_scene(0), PlanSpec(caps=BENCH_CAPS))
    calls = conv_calls(plan, N_PLANES, reps=2)
    pred = predicted_launches(plan, esize=2, calls=calls)
    print(f"[legacy] (a) {len(calls)} convolutions; predicted launches of "
          f"one bf16 forward and backward {pred}")
    facade = legacy_docstring_model(scn, 81)
    direct = legacy_direct_model(facade)
    dplan = plan.to(dev)
    feats = torch.as_tensor(laid["features"]).to(dev, torch.bfloat16)
    ct = torch.randn(feats.shape[0], N_PLANES[0],
                     generator=torch.Generator().manual_seed(82)).to(dev)
    facade.to(dev)
    direct.to(dev)
    _fwd_bwd(facade, feats, dplan, ct)        # warm-up
    torch.cuda.synchronize()
    zero_launches()
    out_f, g_f = _fwd_bwd(facade, feats, dplan, ct)
    torch.cuda.synchronize()
    launches = read_launches()
    out_d, g_d = _fwd_bwd(direct, feats, dplan, ct)
    same = torch.equal(out_f, out_d) and all(
        torch.equal(a, b) for a, b in zip(g_f, g_d))
    print(f"[legacy] (a) launches {launches}; facade and direct bit for "
          f"bit: {same}; output finite: "
          f"{bool(torch.isfinite(out_f.float()).all())}")
    check(launches == pred, f"[legacy] (a) launches {launches}, predicted "
          f"{pred}")
    check(same, "[legacy] (a) the facade's output or gradients differ from "
          "the directly composed modules'")
    ms = {}
    for name, m in (("facade", facade), ("direct", direct)) * 2:
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _fwd_bwd(m, feats, dplan, ct)
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t0))
        ms.setdefault(name, []).extend(times)
    med = {k: sorted(v)[len(v) // 2] for k, v in ms.items()}
    print(f"[legacy] (a) bf16 forward+backward, bench scene 0 "
          f"({plan.levels[0].num_active} voxels): facade median "
          f"{med['facade']:.2f} ms, direct {med['direct']:.2f} ms (6 each, "
          f"in turns)")
    del facade, direct, dplan
    torch.cuda.empty_cache()

    laid, plan = prepare_batch(_mid_scene(), PlanSpec(caps=MID_CAPS))
    m32 = legacy_docstring_model(scn, 83)
    randomize_bn_stats(m32, torch.Generator().manual_seed(84))
    ct = torch.randn(laid["features"].shape[0], N_PLANES[0],
                     generator=torch.Generator().manual_seed(85))
    f32 = _card_vs_cpu("[legacy] (a) f32 mid scene", m32,
                       torch.as_tensor(laid["features"]), plan, ct, dev)
    return dict(launches=launches, ms=med, f32_vs_cpu=f32)


def _mid_sparse(dev, cin, seed):
    """Seeded features of width `cin` on the active rows of the mid
    scene's level 0 (host plan without chunks, on `dev`): (plan, tensor
    factory of a feature tensor)."""
    from occuseg_tpu_torch.core.sparse_tensor import SparseTensor
    from occuseg_tpu_torch.core.topology import PlanSpec
    from occuseg_tpu_torch.native.plan import build_plan_host
    plan = build_plan_host(_mid_scene()["coords"], PlanSpec(caps=MID_CAPS))
    n = plan.levels[0].num_active
    f = torch.zeros(plan.levels[0].cap, cin)
    f[:n] = torch.randn(n, cin, generator=torch.Generator().manual_seed(seed))
    return plan, f, lambda feats: SparseTensor(features=feats, num_active=n)


def legacy_leaky_and_tables(dev):
    """[legacy] (b) a leaky UNet (leakiness 0.333) at N_PLANES, f32,
    training mode, forward and backward card against CPU on the mid scene
    ([parity]'s tolerances); (c) ConcatTable / AddTable / JoinTable card
    against CPU, and `append_tensors` of two scenes on the card: a
    convolution over the merged plan (#9, no rulebooks) against each
    scene's own, and against the CPU."""
    import occuseg_tpu_torch.legacy as scn
    from occuseg_tpu_torch.core.sparse_tensor import SparseTensor
    from occuseg_tpu_torch.core.topology import PlanSpec
    from occuseg_tpu_torch.native.plan import build_plan_host
    out, m = {}, N_PLANES[0]
    plan, f, sparse = _mid_sparse(dev, m, 91)
    unet = scn.UNet(3, 1, list(N_PLANES), True, leakiness=0.333,
                    generator=torch.Generator().manual_seed(92))
    randomize_bn_stats(unet, torch.Generator().manual_seed(93))
    ct = torch.randn(f.shape[0], m, generator=torch.Generator()
                     .manual_seed(94))
    out["leaky"] = _card_vs_cpu(
        "[legacy] (b) UNet(leakiness=0.333) f32",
        _Features(unet, plan.levels[0].num_active), f, plan, ct, dev)

    gen = torch.Generator().manual_seed(95)
    nin = scn.NetworkInNetwork(m, m, True, generator=gen)
    for join in (scn.AddTable, scn.JoinTable):
        model = scn.Sequential().add(scn.ConcatTable().add(
            scn.Identity()).add(nin)).add(join())
        y = {str(d): model.to(d)(sparse(f.to(d)), plan.to(d)).features
             .detach().cpu() for d in ("cpu", dev)}
        err, scale = check_close(f"[legacy] (c) {join.__name__}",
                                 y[str(dev)], y["cpu"], F32_TOL)
        print(f"[legacy] (c) ConcatTable(Identity, NIN) + {join.__name__}: "
              f"{tuple(y['cpu'].shape)}, card against CPU {err:.3e} of "
              f"max {scale:.3e}")

    from occuseg_tpu_torch.data.synthetic import SceneConfig, make_batch
    conv = scn.SubmanifoldConvolution(3, m, m, 3,
                                      generator=torch.Generator()
                                      .manual_seed(96))
    entries, per_scene = [], []
    for seed in (1, 2):
        coords = make_batch(SceneConfig(num_points=20_000, extent=128,
                                        num_objects=8), 1, MID_P_CAP, 16,
                            seed=seed)["coords"]
        p = build_plan_host(coords, PlanSpec(caps=MID_CAPS))
        n = p.levels[0].num_active
        x = torch.zeros(p.levels[0].cap, m)
        x[:n] = torch.randn(n, m, generator=torch.Generator()
                            .manual_seed(97 + seed))
        entries.append((SparseTensor(features=x.to(dev), num_active=n), p))
        per_scene.append((x, p))
    merged_x, merged = scn.append_tensors(entries)
    conv.to(dev)
    zero_launches()
    with torch.no_grad():
        y = conv(merged_x, merged).features
        torch.cuda.synchronize()
        launches = read_launches()
        check(launches["gather_conv"] == 1, f"[legacy] (c) launches "
              f"{launches}")
        cap = MID_CAPS[0]
        bitwise = True
        for s, (x, p) in enumerate(per_scene):
            ref = conv(SparseTensor(x.to(dev), p.levels[0].num_active),
                       p).features
            bitwise &= torch.equal(y[s * cap:(s + 1) * cap], ref)
            check_close(f"[legacy] (c) append_tensors scene {s}",
                        y[s * cap:(s + 1) * cap], ref, F32_TOL)
        # a plan object keeps the maps it uploaded for one device: the
        # CPU's run merges the scenes anew
        cpu_x, cpu_merged = scn.append_tensors(
            [(SparseTensor(x, p.levels[0].num_active), p)
             for x, p in per_scene])
        y_cpu = copy.deepcopy(conv).cpu()(cpu_x, cpu_merged).features
        err, scale = check_close("[legacy] (c) append_tensors card vs CPU",
                                 y, y_cpu, F32_TOL)
    print(f"[legacy] (c) append_tensors: 2 scenes of {MID_CAPS[0]} rows, "
          f"counts {merged_x.num_active}; the convolution over the merged "
          f"plan (#9 launched {launches['gather_conv']} time) equals each "
          f"scene's own (bit for bit: {bitwise}), card against CPU "
          f"{err:.3e} of max {scale:.3e}")
    out["append_launches"] = launches
    return out


def phase_legacy(dev):
    """[legacy]: the sparseconvnet facade (`occuseg_tpu_torch/legacy.py`)
    at full width: (a) `legacy_docstring`, (b) and (c)
    `legacy_leaky_and_tables`."""
    t0 = time.perf_counter()
    out = dict(docstring=legacy_docstring(dev))
    out.update(legacy_leaky_and_tables(dev))
    out["seconds"] = time.perf_counter() - t0
    print(f"[legacy] all parts passed in {out['seconds']:.1f} s")
    torch.cuda.empty_cache()
    return out


def gates_checkpoint(dev, tmp):
    """[gates] (a): the checkpoint-parity gate (`scripts/
    checkpoint_parity.py`) on a reference-format m=64 `.pth` made by the
    torch oracle with seeded weights: exit 0 with all seven heads under its
    TOL (the port's model on the card: 33 chunk forwards and one segment
    sum); not 0 with one key removed from the file; 1 when the imported
    model differs from the file by 1e-2 in one weight (the semantic head's
    first bias)."""
    from occuseg_tpu_torch.core.topology import PlanSpec
    from occuseg_tpu_torch.data.synthetic import SceneConfig, make_batch
    from occuseg_tpu_torch.native.plan import build_plan_host
    from occuseg_tpu_torch.infer import plan_scene
    from occuseg_tpu_torch.scripts import checkpoint_parity as gate
    probe = make_batch(SceneConfig(num_points=6000, extent=96,
                                   num_objects=8), 1, gate.P_CAP, 16, seed=11)
    plan = build_plan_host(probe["coords"], PlanSpec(caps=gate.PROBE_CAPS))
    m = N_PLANES[0]
    torch.manual_seed(0)
    oracle = gate.load_oracle()(tuple(m * i for i in range(1, 7)), 20, plan,
                                in_ch=3, reps=1)
    pth = os.path.join(tmp, f"oracle_m{m}.pth")
    torch.save(oracle.state_dict(), pth)
    argv = ["--m", str(m), "--residual_blocks", "--use_dense_model",
            "--skip_eval"]
    seen = {}
    real_diff, real_load = gate.activation_diff, gate.load_baseline_checkpoint

    def recorded(*a):
        seen.update(real_diff(*a))
        return seen

    def perturbed(path, model, *a):
        out = real_load(path, model, *a)
        with torch.no_grad():
            model.backbone.linear.bias[0] += 1e-2
        return out
    gate.activation_diff = recorded
    try:
        zero_launches()
        t0 = time.perf_counter()
        code = gate.main(["--checkpoint_file", pth, *argv], device=dev)
        seconds = time.perf_counter() - t0
        launches = read_launches()
        print(f"[gates] (a) oracle m={m} .pth: exit {code} in {seconds:.1f} "
              f"s; max|diff| per head " + ", ".join(
                  f"{k} {v:.2e}" for k, v in seen.items())
              + f" (TOL {gate.TOL}); launches {launches}")
        check(code == 0 and len(seen) == 7
              and max(seen.values()) < gate.TOL, f"[gates] (a) exit {code}, "
              f"differences {seen}")
        layout = plan_scene(probe["coords"], PlanSpec(
            caps=gate.PROBE_CAPS)).vox_seg is not None
        check(launches["chunk_conv"] == 33
              and launches["blocked_segment_sum"] == int(layout),
              f"[gates] (a) launches {launches}")
        sd = torch.load(pth)
        del sd["backbone.sub.weight"]
        missing = os.path.join(tmp, "missing.pth")
        torch.save(sd, missing)
        code_missing = gate.main(["--checkpoint_file", missing, *argv],
                                 device=dev)
        gate.load_baseline_checkpoint = perturbed
        seen.clear()
        code_perturbed = gate.main(["--checkpoint_file", pth, *argv],
                                   device=dev)
    finally:
        gate.activation_diff = real_diff
        gate.load_baseline_checkpoint = real_load
    print(f"[gates] (a) one key removed: exit {code_missing}; one weight "
          f"perturbed by 1e-2: exit {code_perturbed} (semantics max|diff| "
          f"{seen.get('semantics', float('nan')):.2e})")
    check(code_missing != 0, "[gates] (a) a missing key passed the gate")
    check(code_perturbed == 1, f"[gates] (a) a perturbed weight: exit "
          f"{code_perturbed}")
    return dict(seconds=seconds, max_diff=seen and max(seen.values()),
                launches=launches)


SEMANTIC_FLAGS = ("--m", "64", "--residual_blocks", "--batch_size", "4",
                  "--plan_workers", "4", "--max_epoch", "1")


def gates_semantic(dev, tmp):
    """[gates] (b) `train_semantic` at m=64, f32, 2 steps of 4 synthetic
    scenes, checkpoint and eval; (c) `test_semantic` from its checkpoint
    writes one file of NYU40 ids per synthetic val scene, and
    `fake_judge` scores them against the scenes' labels: its confusion
    equal to one rebuilt here from the same files."""
    import numpy as np
    from occuseg_tpu_torch.scripts import fake_judge, test_semantic
    from occuseg_tpu_torch.scripts import train_semantic
    from occuseg_tpu_torch.train import loop
    from occuseg_tpu_torch.train.config import args_to_config, get_parser
    argv = [*SEMANTIC_FLAGS, "--data_dir", os.path.join(tmp, "no_scenes"),
            "--checkpoints_dir", os.path.join(tmp, "sem_ckpts"),
            "--taskname", "sem"]
    zero_launches()
    t0 = time.perf_counter()
    result = train_semantic.main(argv, device=dev, max_steps=2)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches = read_launches()
    tm = result["timings"]
    print(f"[gates] (b) train_semantic: {result['steps']} steps (ms "
          f"{', '.join(f'{t:.1f}' for t in tm['step_ms'])}) and the eval in "
          f"{train_s:.1f} s; losses {result['losses']}; val mean IoU "
          f"{result['metrics']['mean_iou']:.4f}; launches {launches}")
    check(result["steps"] == 2 and all(
        v == v and abs(v) != float("inf") for v in result["losses"].values()),
        f"[gates] (b) {result['steps']} steps, losses {result['losses']}")
    check(type(result["model"]).__name__ == "InstanceDenseUNet",
          "[gates] (b) not the InstanceDenseUNet")
    # (the synthetic 4-scene batches' plans have no sorted point layout,
    # as [loop]'s: the InputLayer scatters, no #2)
    check(launches["chunk_conv"] > 0 and launches["chunk_conv_bwd_fused"] > 0,
          f"[gates] (b) launches {launches}")

    out_dir = os.path.join(tmp, "submission")
    t0 = time.perf_counter()
    files = test_semantic.main([*argv, "--checkpoint_file",
                                result["ckpt_dir"], "--out_dir", out_dir,
                                "--val_reps", "1"], device=dev)
    test_s = time.perf_counter() - t0
    config = args_to_config(get_parser().parse_args(argv))
    gt_dir = os.path.join(tmp, "gt")
    os.makedirs(gt_dir)
    rebuilt = np.zeros((20, 20), np.int64)
    vals = loop._synthetic_dataset(config).val_batches(
        config["point_cap"], config["instance_cap"], 1)
    for fn, raw in zip(files, vals):
        valid = raw["coords"][:, 0] >= 0
        gt = raw["labels"][valid].astype(np.int64)
        np.savetxt(os.path.join(gt_dir, os.path.basename(fn)), gt, fmt="%d")
        pred = np.loadtxt(fn, dtype=np.int64)
        check(pred.shape == gt.shape and set(np.unique(pred)) <= set(
            test_semantic.SELECTED_LABEL_IDS), f"[gates] (c) {fn}")
        keep = (gt >= 0) & (gt < 20)
        rebuilt += np.bincount(gt[keep] * 20 + np.clip(pred[keep], 0, 19),
                               minlength=400).reshape(20, 20)
    judged = fake_judge.main(["--pred_dir", out_dir, "--gt_dir", gt_dir])
    print(f"[gates] (c) test_semantic wrote {len(files)} files in "
          f"{test_s:.1f} s; fake_judge mean IoU {judged['mean_iou']:.4f} "
          f"over {int(judged['confusion'].sum())} points (NYU40 ids scored "
          f"as class indices, as the JAX scripts do: ROADMAP C item 4)")
    check(len(files) == len(loop._synthetic_dataset(config).val),
          f"[gates] (c) {len(files)} files")
    check(np.array_equal(judged["confusion"], rebuilt),
          "[gates] (c) fake_judge's confusion differs from the rebuilt one")
    return dict(train_s=train_s, step_ms=tm["step_ms"], test_s=test_s,
                launches=launches)


def phase_gates(dev, tmp):
    """[gates]: (a) `gates_checkpoint`, (b) and (c) `gates_semantic`; (d),
    the accuracy floor, runs inside [ap_gate]."""
    t0 = time.perf_counter()
    out = dict(checkpoint=gates_checkpoint(dev, tmp),
               semantic=gates_semantic(dev, tmp))
    out["seconds"] = time.perf_counter() - t0
    print(f"[gates] all parts passed in {out['seconds']:.1f} s")
    torch.cuda.empty_cache()
    return out


DP_FLAGS = ("--m", "64", "--use_dense_model", "--residual_blocks",
            "--batch_size", "8", "--num_devices", "2", "--plan_workers", "2")
DP_STEPS = 3


def _dp_setup(tmp, flags, n_groups):
    """(config, spec, the first `n_groups` groups of [loop]'s synthetic
    epoch at 4 scenes a rank) for the command line `flags`, checkpoints
    under `tmp`."""
    import itertools

    import numpy as np
    from occuseg_tpu_torch.parallel.data_parallel import dp_groups
    from occuseg_tpu_torch.train import loop
    from occuseg_tpu_torch.train.config import args_to_config, get_parser
    config = args_to_config(get_parser().parse_args(
        [*flags, "--data_dir", os.path.join(tmp, "no_scenes"),
         "--checkpoints_dir", os.path.join(tmp, "dp_ckpts")]))
    ds = loop._synthetic_dataset(config)
    batches = ds.train_batches(np.random.default_rng(100),
                               config["point_cap"], config["instance_cap"],
                               config["batch_size"] // 2)
    groups = [g for g, _ in itertools.islice(dp_groups(batches, 2),
                                             n_groups)]
    return config, loop.build_spec(config), groups


def _host_copy(t):
    """A copy on the host, never a view (as `.cpu()` of a CPU tensor)."""
    return t.detach().to("cpu", copy=True)


def _snapshot(trainer, parts):
    m = trainer.model
    return dict(parts={k: float(v) for k, v in parts.items()},
                params=[_host_copy(p) for p in m.parameters()],
                grads=[_host_copy(p.grad) for p in m.parameters()],
                stats=[_host_copy(b) for b in m.buffers()])


def _dp_rank(rank, world, tmp, flags, dev):
    """One [dp] rank on `dev` (spawned): the training loop itself,
    `loop.train`, for DP_STEPS steps of the rank's member of each group
    (its pinned plan from the loop's PlanPool, its loss weight passed
    beside it), rank 0 checkpointing at the end; the state after the
    first step saved through `on_start`'s hook on `Trainer.step`. Then,
    from the initial weights, the remainder group (rank 1 a weight-0 copy
    of rank 0's batch) through `Trainer.step`. Returns rank 0's step ms,
    launches and losses."""
    from occuseg_tpu_torch.train import loop
    from occuseg_tpu_torch.train.state import prepare_batch
    config, spec, groups = _dp_setup(tmp, flags, 1)
    ns = config["batch_size"] // 2
    first = {}

    def on_start(trainer):
        step = trainer.step

        def step_and_keep_the_first(raw, plan, weight=None, group=None):
            parts = step(raw, plan, weight=weight, group=group)
            if not first:
                first.update(_snapshot(trainer, parts), weight=weight)
            return parts
        trainer.step = step_and_keep_the_first
        zero_launches()
    result = loop.train(config, max_steps=DP_STEPS, device=dev,
                        on_start=on_start)
    launches = read_launches()
    check(result["steps"] == DP_STEPS and first["weight"] == 1.0,
          f"[dp] rank {rank}: {result['steps']} steps, the first at weight "
          f"{first.get('weight')}")
    trainer = loop.build_trainer(config, dev, ns)
    laid, plan = prepare_batch(groups[0][0], spec, ns)
    parts = trainer.step(laid, plan, weight=1.0 if rank == 0 else 0.0)
    if rank != 0:
        return None
    torch.save(first, os.path.join(tmp, "dp_step1.pt"))
    torch.save(_snapshot(trainer, parts),
               os.path.join(tmp, "dp_remainder.pt"))
    return dict(step_ms=result["timings"]["step_ms"], launches=launches,
                losses=result["losses"],
                ckpt=os.path.exists(os.path.join(result["ckpt_dir"],
                                                 "step_1.pth")))


def _adam_from(trainer, init, grads, config):
    """The parameters one Adam update of the loop's optimizer makes from
    the state dict `init` with `grads`, on the trainer's device."""
    from occuseg_tpu_torch.train.state import TrainConfig, make_optimizer
    model = trainer.model
    model.load_state_dict(init)
    params = list(model.parameters())
    for p, g in zip(params, grads):
        p.grad = g.to(p.device)
    opt, _ = make_optimizer(params, TrainConfig(lr=config["lr"]))
    opt.step()
    return [_host_copy(p) for p in params]


def _close_states(label, got, ref, names, adam):
    """A data-parallel step's loss parts and BN statistics within
    PARITY_TOL of `ref`'s, its gradients within [parity]'s gradient
    tolerances of them, and its parameters within PARITY_TOL of `adam`,
    Adam's update from its own gradients: Adam's first update, lr * g /
    (|g| + 1e-8), turns a gradient's rounding near 0 into a step of up to
    lr, so the parameters are held to the update of the gradient and the
    gradient to the reference. Returns the gradients' norm share and
    worst tensor, whether every tensor equals `ref`'s bit for bit, and
    how many parameter entries differ from `ref`'s by more than
    PARITY_TOL of their tensor's max."""
    for k, c in ref["parts"].items():
        g = got["parts"][k]
        tol = 1e-2 if k == "instance_iou" else PARITY_TOL * abs(c) + 1e-6
        check(abs(g - c) <= tol, f"{label} {k}: {g} vs {c}")
    g_glob, worst = _grad_check(label, got["grads"], ref["grads"], names)
    for key, want in (("stats", ref["stats"]), ("params", adam)):
        for a, b in zip(got[key], want):
            check((a - b).abs().max().item()
                  <= PARITY_TOL * b.abs().max().item() + 1e-6,
                  f"{label} {key}")
    apart = sum(int(((a - b).abs() > PARITY_TOL * b.abs().max()).sum())
                for a, b in zip(got["params"], ref["params"]))
    bitwise = got["parts"] == ref["parts"] and all(
        torch.equal(a, b) for k in ("params", "grads", "stats")
        for a, b in zip(got[k], ref[k]))
    return g_glob, worst, bitwise, apart


def phase_dp(dev, tmp, loop_med):
    """[dp]: data parallelism on one card: two spawned ranks on cuda:0
    joined over gloo (NCCL refuses two ranks on one device), each running
    the training loop (`loop.train`) on its 4 synthetic 20k-point scenes
    of [loop]'s epoch (m=64, f32, OCC_PALLAS_BCE=1) for DP_STEPS steps.
    Held against one process on the same card: after step 1, the two
    ranks' single-process gradients' mean (and the BN statistics' and
    loss parts' means), then Adam; the remainder group (rank 1 a weight-0
    copy) against rank 0's single-process step, with the single-process
    step against itself beside it. The DP step's median beside
    [loop]'s."""
    from occuseg_tpu_torch.losses.instance import occuseg_total_loss
    from occuseg_tpu_torch.parallel import data_parallel
    from occuseg_tpu_torch.train import loop
    from occuseg_tpu_torch.train.state import (
        _BATCH_KEYS, TrainConfig, make_optimizer, prepare_batch,
    )
    os.environ["OCC_PALLAS_BCE"] = "1"
    t0 = time.perf_counter()
    rank0 = data_parallel.spawn(_dp_rank, 2, dev, tmp, DP_FLAGS, dev,
                                backend="gloo")[0]
    spawn_s = time.perf_counter() - t0
    config, spec, groups = _dp_setup(tmp, DP_FLAGS, 1)
    ns = config["batch_size"] // 2

    # the reference: each rank's batch stepped alone from the initial
    # weights, gradients, statistics and parts averaged, then Adam
    trainer = loop.build_trainer(config, dev, ns)
    model = trainer.model
    init = copy.deepcopy(model.state_dict())
    params = list(model.parameters())
    sums = None
    for member in groups[0]:
        model.load_state_dict(init)
        laid, plan = prepare_batch(member, spec, ns)
        b = {k: torch.as_tensor(laid[k]).to(dev) for k in _BATCH_KEYS}
        out = model.train()(b["features"], plan.to(dev))
        total, parts = occuseg_total_loss(out, b, ns,
                                          config["instance_cap"],
                                          trainer.loss_cfg)
        grads = torch.autograd.grad(total, params)
        this = ([g.detach() for g in grads],
                [s.detach().clone() for s in model.buffers()],
                {k: float(v.detach()) for k, v in parts.items()})
        sums = this if sums is None else (
            [a + c for a, c in zip(sums[0], this[0])],
            [a + c for a, c in zip(sums[1], this[1])],
            {k: sums[2][k] + v for k, v in this[2].items()})
    model.load_state_dict(init)
    with torch.no_grad():
        for s, m in zip(model.buffers(), sums[1]):
            s.copy_(m / 2)
    for p, g in zip(params, sums[0]):
        p.grad = g / 2
    opt, _ = make_optimizer(params, TrainConfig(lr=config["lr"]))
    opt.step()
    ref = dict(parts={k: v / 2 for k, v in sums[2].items()},
               params=[_host_copy(p) for p in params],
               grads=[_host_copy(p.grad) for p in params],
               stats=[_host_copy(b) for b in model.buffers()])
    names = [n for n, _ in model.named_parameters()]
    n_entries = sum(p.numel() for p in params)
    got = torch.load(os.path.join(tmp, "dp_step1.pt"))
    g_glob, worst, bitwise, apart = _close_states(
        "[dp] step 1", got, ref, names,
        _adam_from(trainer, init, got["grads"], config))
    print(f"[dp] 2 ranks on {dev} over gloo, loop.train for {DP_STEPS} "
          f"steps of {ns} scenes each ({spawn_s:.1f} s with the spawn; "
          f"rank 0's losses {rank0['losses']}, its checkpoint written: "
          f"{rank0['ckpt']}); after step 1 "
          f"against the one-process mean then Adam: loss parts "
          f"{got['parts']} vs {ref['parts']}; gradients {g_glob:.3e} of "
          f"the norm, worst tensor {worst:.3e}; statistics within "
          f"{PARITY_TOL}, parameters within it of Adam on the reduced "
          f"gradients ({apart} of {n_entries} entries past it from the "
          f"reference's Adam, a gradient within rounding of 0); bit for "
          f"bit: {bitwise}")

    laid, plan = prepare_batch(groups[0][0], spec, ns)
    singles = []
    for _ in range(3):   # the step's own run-to-run spread
        single = loop.build_trainer(config, dev, ns)
        singles.append(_snapshot(single, single.step(laid, plan)))
    rem = torch.load(os.path.join(tmp, "dp_remainder.pt"))
    r_glob, r_worst, r_bitwise, r_apart = _close_states(
        "[dp] remainder", rem, singles[0], names,
        _adam_from(trainer, init, rem["grads"], config))
    s_globs = [_glob(other["grads"], singles[0]["grads"])
               for other in singles[1:]]
    s_bitwise = all(torch.equal(a, b) for other in singles[1:]
                    for k in ("params", "grads", "stats")
                    for a, b in zip(singles[0][k], other[k]))
    print(f"[dp] remainder group (rank 1 at weight 0) against rank 0's "
          f"single-process step: gradients {r_glob:.3e} of the norm, "
          f"{r_apart} parameter entries apart; bit for bit: {r_bitwise} "
          f"(the single-process step run again against its first run: "
          f"gradients {', '.join(f'{g:.3e}' for g in s_globs)} of the "
          f"norm, bit for bit: {s_bitwise})")
    ms = rank0["step_ms"]
    med = sorted(ms)[len(ms) // 2]
    print(f"[dp] rank 0's step ms {', '.join(f'{t:.1f}' for t in ms)} "
          f"(median {med:.1f}, the first a warm-up) beside [loop]'s median "
          f"{loop_med:.1f} (one process); rank 0's launches {rank0['launches']}")
    launches = rank0["launches"]
    for k in ("chunk_conv", "chunk_conv_bwd_fused", "bce_radius", "bce_fwd",
              "bce_bwd"):
        check(launches[k] > 0, f"[dp] {k} was not launched on a rank")
    check(rank0["ckpt"] and all(math.isfinite(v)
                                for v in rank0["losses"].values()),
          "[dp] rank 0's checkpoint or losses")
    os.environ.pop("OCC_PALLAS_BCE")
    torch.cuda.empty_cache()
    return dict(step_ms=ms, median_ms=med, loop_ms=loop_med,
                launches=launches, grad_global=g_glob, bitwise=bitwise,
                params_apart=apart, remainder_global=r_glob,
                remainder_bitwise=r_bitwise, single_globals=s_globs,
                single_bitwise=s_bitwise, seconds=spawn_s)


SPATIAL_HALO = SPATIAL_POOL = 4096
SPATIAL_STEPS = 3
SPATIAL_FLAGS = (*LOOP_FLAGS, "--spatial_shards", "2")
# jax's bf16 tolerance for a sharded forward against the unsharded one
# (tests/test_spatial_model.py:211-214): rtol 5e-2, atol 5% of the max
SPATIAL_BF16_RTOL = 5e-2
SPATIAL_BF16_ATOL = 5e-2


def spatial_calls(plan, n_planes=N_PLANES, in_features=3):
    """`conv_calls` of a rank's slice of a sharded plan: each convolution
    reads the extended rows of its map's exchange (n_in), its transpose
    plan is the exchange's `chunks_t`, and it takes the chunk kernels only
    where both rulebooks are there (`nn/modules._sharded_conv`)."""
    out = []
    for c in conv_calls(plan, n_planes, in_features):
        kind, i = c.maps
        ex = (plan.levels[i].halo_ex if kind == "level"
              else getattr(plan.transitions[i], f"{kind}_ex"))
        both = c.chunks is not None and ex.chunks_t is not None
        out.append(c._replace(chunks=c.chunks if both else None,
                              t_chunks=ex.chunks_t,
                              n_in=ex.nbr_t.shape[0]))
    return out


def spatial_forward_launches(plan) -> dict:
    calls = spatial_calls(plan)
    n = sum(chunked(c) for c in calls)
    return {"chunk_conv": n, "gather_conv": len(calls) - n}


def spatial_exchanges(plan):
    """{map: (rows of the left, right and publish lists any shard fills)}
    of a rank's slice: what each exchange carries."""
    out = {f"L{i}": lv.halo_ex.sent for i, lv in enumerate(plan.levels)}
    for i, tr in enumerate(plan.transitions):
        out[f"child{i}"] = tr.child_ex.sent
        out[f"up{i}"] = tr.up_ex.sent
    return out


def _spatial_model(dev, dtype):
    from occuseg_tpu_torch.models import LearningBWDenseUNet
    model = LearningBWDenseUNet(N_PLANES, compute_dtype=dtype,
                                generator=torch.Generator().manual_seed(4))
    randomize_bn_stats(model, torch.Generator().manual_seed(5))
    return model.to(dev).eval()


def spatial_roles(dev, plan):
    """Each per-shard role once against its plain version on the card:
    the chunk kernels over the first submanifold map, strided map and
    deconvolution map with per-shard rulebooks (S rows over the extended
    rows; forward #1, both backward routes, #3/#4 and #5), and #9 over
    that level's map with its transpose over the extended rows (forward
    and d_ext), at the model's widths there. bf16, random inputs."""
    from occuseg_tpu_torch.ops.kernels import chunk_conv as cc
    from occuseg_tpu_torch.ops.kernels import gather_conv as gc
    gen = torch.Generator(device=dev).manual_seed(6)

    def first(items, what):
        hit = [i for i, (ch, ex) in enumerate(items)
               if ch is not None and ex.chunks_t is not None]
        check(bool(hit), f"[spatial] no {what} has per-shard rulebooks")
        return hit[0]
    li = first([(lv.chunks, lv.halo_ex) for lv in plan.levels], "level")
    ci = first([(t.child_chunks, t.child_ex) for t in plan.transitions],
               "strided map")
    ui = first([(t.up_chunks, t.up_ex) for t in plan.transitions],
               "deconvolution map")
    lv = plan.levels[li]
    ctr, utr = plan.transitions[ci], plan.transitions[ui]
    roles = ((f"sub L{li}", lv.chunks, lv.halo_ex, N_PLANES[li],
              N_PLANES[li]),
             (f"child {ci}", ctr.child_chunks, ctr.child_ex, N_PLANES[ci],
              N_PLANES[ci + 1]),
             (f"up {ui}", utr.up_chunks, utr.up_ex, N_PLANES[ui + 1],
              N_PLANES[ui]))
    errs = {}
    for label, ch, ex, cin, cout in roles:
        n_in, K = ex.nbr_t.shape[0], ch.lidx.shape[1]
        x = torch.randn(n_in, cin, device=dev, generator=gen).bfloat16()
        w = (torch.randn(K, cin, cout, device=dev, generator=gen)
             * 0.05).bfloat16()
        ct = torch.randn(ch.lidx.shape[0] * ch.lidx.shape[2], cout,
                         device=dev, generator=gen).bfloat16()
        out = cc.chunk_conv(x, ch.in_idx, ch.lidx, w)
        e_f, _ = check_close(f"[spatial] {label} #1", out,
                             cc.chunk_conv_plain(x, ch.in_idx, ch.lidx, w),
                             BF16_TOL)
        t = ex.chunks_t
        w_t = w.transpose(1, 2).contiguous()
        ref_d, ref_dw = cc.chunk_conv_bwd_fused_plain(ct, t.in_idx, t.lidx,
                                                      w_t, x)
        ref_w = cc.chunk_conv_dw_plain(x, ch.in_idx, ch.lidx, ct)
        worst = [e_f]
        for fused in (True, False):   # dW in f32 (the weight's dtype)
            d, dw = cc.t_conv_backward(ct, x, ch.in_idx, ch.lidx, t.in_idx,
                                       t.lidx, w.float(), fused)
            worst.append(check_close(f"[spatial] {label} d_ext fused={fused}",
                                     d, ref_d, BF16_TOL)[0])
            worst.append(check_close(f"[spatial] {label} dW fused={fused}",
                                     dw, ref_w, DW_TOL)[0])
        check_close(f"[spatial] {label} dWt", ref_dw, ref_w, DW_TOL)
        errs[label] = max(worst)
    ex = lv.halo_ex
    c = N_PLANES[li]
    x = torch.randn(ex.nbr_t.shape[0], c, device=dev,
                    generator=gen).bfloat16()
    w = (torch.randn(27, c, c, device=dev, generator=gen) * 0.05).bfloat16()
    nbr_kn, t_kn = lv.gather_map("nbr", dev), ex.gather_map("nbr_t", dev)
    e1, _ = check_close(f"[spatial] #9 over the L{li} map", gc.gather_conv(
        x, nbr_kn, w), gc.gather_conv_plain(x, nbr_kn, w), BF16_TOL)
    ct = torch.randn(nbr_kn.shape[1], c, device=dev,
                     generator=gen).bfloat16()
    w_r = w.flip(0).transpose(1, 2).contiguous()
    e2, _ = check_close("[spatial] #9 d_ext over its transpose",
                        gc.gather_conv(ct, t_kn, w_r),
                        gc.gather_conv_plain(ct, t_kn, w_r), BF16_TOL)
    errs[f"#9 L{li}"] = max(e1, e2)
    return errs


def spatial_serve(dev, group, rank):
    """(a) `sharded_infer`'s path, this rank's shard of bench scene 0:
    launches against the shard plan's prediction, the forward ms (the
    exchanges and the gathering of the outputs included), peak memory,
    each exchange's rows; on rank 0 the unsharded forward of the same
    model (bf16, then f32) against the sharded outputs, and the per-shard
    roles against their plain versions."""
    import numpy as np
    from occuseg_tpu_torch.core.topology import PlanSpec
    from occuseg_tpu_torch.infer import Predictor, prepare_scene
    from occuseg_tpu_torch.native.plan import build_plan_host
    from occuseg_tpu_torch.parallel import spatial_model as sm
    batch = bench_scene(0)
    spec = PlanSpec(caps=BENCH_CAPS)
    model = _spatial_model(dev, torch.bfloat16)
    t0 = time.perf_counter()
    plan = build_plan_host(batch["coords"], spec)
    t1 = time.perf_counter()
    sa = sm.prepare_shard_args(plan, 2, SPATIAL_HALO, SPATIAL_POOL,
                               rank=rank, group=group)
    t2 = time.perf_counter()
    sa_d = sa.to(dev)
    feats = torch.from_numpy(batch["features"]).to(dev)

    def forward(m):
        with torch.inference_mode():
            out = sm.sharded_apply(m, sa_d, feats, group, train=False)
            return sm.gather_outputs(out, sa_d, group)
    forward(model)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    out = forward(model)
    torch.cuda.synchronize()
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    want = spatial_forward_launches(sa.plan)
    check(launches["chunk_conv"] == want["chunk_conv"]
          and launches["gather_conv"] == want["gather_conv"],
          f"[spatial] rank {rank} forward launches {launches}, predicted "
          f"{want}")
    ms = cuda_ms(lambda: forward(model), 3)
    res = dict(launches=launches, predicted=want, ms=ms, peak=peak,
               host_plan_ms=1e3 * (t1 - t0), shard_ms=1e3 * (t2 - t1),
               exchanges=spatial_exchanges(sa.plan),
               active=[lv.num_active for lv in sa.plan.levels],
               points=sa.plan.num_points)
    if rank != 0:
        forward(_spatial_model(dev, torch.float32))   # rank 0's f32 below
        return res, sa, plan
    valid = torch.from_numpy(np.asarray(plan.p2v) >= 0).to(dev)
    scene = prepare_scene(batch["coords"], batch["features"], spec)
    pred = Predictor(model, dev)
    ref = pred(scene)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    plan_d = scene.plan.to(dev)
    f_laid = torch.from_numpy(scene.features).to(dev)

    def unsharded():
        with torch.inference_mode():
            return model(f_laid, plan_d)
    res["unsharded_ms"] = cuda_ms(unsharded, 3)
    res["unsharded_peak"] = torch.cuda.max_memory_allocated()
    errs = {}
    for name in out._fields:
        a, r = getattr(out, name)[valid], getattr(ref, name)[valid]
        err = (a - r).abs()
        top = r.abs().max().item()
        errs[name] = (err.max().item(), top)
        check(bool(torch.isfinite(a).all()), f"[spatial] {name} not finite")
        check(bool((err <= SPATIAL_BF16_RTOL * r.abs()
                    + SPATIAL_BF16_ATOL * top).all()),
              f"[spatial] bf16 {name}: {err.max().item()} (max {top})")
    res["bf16_errors"] = errs
    m32 = _spatial_model(dev, torch.float32)
    m32.load_state_dict(model.state_dict())
    out32 = forward(m32)
    ref32 = Predictor(m32, dev)(scene)
    errs32 = {}
    for name in out32._fields:
        a, r = getattr(out32, name)[valid], getattr(ref32, name)[valid]
        err, top = (a - r).abs().max().item(), r.abs().max().item()
        errs32[name] = (err, top)
        check(err <= PARITY_TOL * max(top, 1.0),
              f"[spatial] f32 {name}: {err} > {PARITY_TOL} x {top}")
    res["f32_errors"] = errs32
    res["roles"] = spatial_roles(dev, sa_d.plan)
    return res, sa, plan


def spatial_radius(dev, group, rank, sa, plan):
    """(c) With OCC_PALLAS_BCE=1, the BCE path of this rank's shard of
    bench scene 0 (random embeddings, the scene's instances): the radius
    maximised over the ranks equals the whole scene's bit for bit, and
    the five sums equal the whole scene's (the counts exactly); the
    instances whose radius this shard alone would have taken smaller."""
    import numpy as np
    import torch.nn.functional as F
    from occuseg_tpu_torch.ops.kernels import bce_loss
    from occuseg_tpu_torch.parallel.comm import all_max
    batch = bench_scene(0)
    I = BENCH_INSTANCES
    rng = np.random.default_rng(7)
    P = batch["pose"].shape[0]
    e = rng.standard_normal((P, 64)).astype(np.float32) * 0.5
    bw = rng.uniform(0.5, 1.5, (P, 2)).astype(np.float32)
    rx = batch["pose"] + rng.standard_normal((P, 3)).astype(np.float32) * .05
    # the instance statistics, on the host: the same bits on every rank
    iid = torch.from_numpy(batch["instance_id"]).long()
    valid = iid >= 0
    idx = iid.clamp(min=0)
    cnt = torch.zeros(I).index_add_(0, idx, valid.float())

    def mean(v):
        v = torch.from_numpy(np.ascontiguousarray(v))
        s = torch.zeros(I, v.shape[1]).index_add_(
            0, idx, torch.where(valid[:, None], v, 0.0))
        return s / cnt.clamp(min=1)[:, None]
    mu, mp, sig = mean(e), mean(batch["pose"]), mean(bw)
    scene_i = torch.full((I,), -1, dtype=torch.long).scatter_reduce(
        0, idx[valid], torch.from_numpy(batch["point_scene"]).long()[valid],
        "amax")
    use = cnt >= 30
    stats = [t.to(dev) for t in (sig, mu, mp, scene_i, use)]

    def rows(a, keep=None):
        t = torch.from_numpy(np.ascontiguousarray(a))
        if keep is not None:
            t = t[keep]
        return t.to(dev)
    mine = torch.from_numpy(sa.perm)
    sv = torch.from_numpy(sa.slot_valid)
    loc = {k: rows(v, mine) for k, v in dict(
        e=e, rx=rx, x=batch["pose"], iid=batch["instance_id"],
        scene=batch["point_scene"]).items()}
    for k in ("iid", "scene"):
        loc[k] = torch.where(sv.to(dev), loc[k], -1)
    os.environ["OCC_PALLAS_BCE"] = "1"
    check(bce_loss.supported(loc["e"].shape[0], I, 64),
          "[spatial] the BCE kernels do not take the shard's shape")
    mp4 = F.pad(stats[2].float(), (0, 1))
    mp_sq = (mp4 * mp4).sum(1)
    seg_l = loc["iid"].int().contiguous()
    r_local = bce_loss.radius_sq(F.pad(loc["x"].float(), (0, 1)).contiguous(),
                                 seg_l, mp4, mp_sq)
    r_sharded = all_max(r_local, group)
    sig_d, mu_d, mp_d, scene_d, use_d = stats
    sums = torch.stack(bce_loss.bce_membership_sums(
        loc["e"], loc["rx"], sig_d, mu_d, mp_d, loc["x"], loc["iid"],
        loc["scene"], scene_d, use_d, group))
    res = dict(smaller=int((r_local < r_sharded).sum()))
    if rank == 0:
        whole = {k: rows(v) for k, v in dict(
            e=e, rx=rx, x=batch["pose"], iid=batch["instance_id"],
            scene=batch["point_scene"]).items()}
        r_whole = bce_loss.radius_sq(
            F.pad(whole["x"].float(), (0, 1)).contiguous(),
            whole["iid"].int().contiguous(), mp4, mp_sq)
        ref = torch.stack(bce_loss.bce_membership_sums(
            whole["e"], whole["rx"], sig_d, mu_d, mp_d, whole["x"],
            whole["iid"], whole["scene"], scene_d, use_d))
        check(torch.equal(r_sharded, r_whole),
              "[spatial] the sharded radius is not the scene's")
        check(torch.equal(sums[1:], ref[1:]),
              f"[spatial] sharded sample / tp / fp / tot counts differ: "
              f"{(sums[1:] - ref[1:]).abs().max().item()}")
        err = (sums[0] - ref[0]).abs().max().item()
        top = ref[0].abs().max().item()
        check(err <= 1e-5 * top, f"[spatial] sharded bce sums {err} > "
              f"1e-5 x {top}")
        res.update(bce_sum_err=err, bce_sum_max=top,
                   samples=int(ref[1].sum().item()))
    os.environ.pop("OCC_PALLAS_BCE")
    return res


def spatial_train(dev, tmp, rank):
    """(b) `loop.train` with --spatial_shards 2 at [loop]'s flags for
    SPATIAL_STEPS steps: this rank's launches against the prediction
    from each step's shard plan, its step ms and peak memory; rank 0
    saves the state after step 1."""
    from occuseg_tpu_torch.train import loop
    from occuseg_tpu_torch.train.config import args_to_config, get_parser
    os.environ["OCC_PALLAS_BCE"] = "1"
    config = args_to_config(get_parser().parse_args(
        [*SPATIAL_FLAGS, "--data_dir", os.path.join(tmp, "no_scenes"),
         "--checkpoints_dir", os.path.join(tmp, "spatial_ckpts")]))
    first, predicted = {}, collections.Counter()

    def on_start(trainer):
        step = trainer.step

        def step_and_keep_the_first(raw, plan=None, weight=None, group=None,
                                    shard_args=None):
            predicted.update(predicted_launches(
                shard_args.plan, esize=4, bce=True,
                calls=spatial_calls(shard_args.plan)))
            parts = step(raw, plan, weight=weight, group=group,
                         shard_args=shard_args)
            if not first:
                first.update(_snapshot(trainer, parts))
            return parts
        trainer.step = step_and_keep_the_first
        zero_launches()
        torch.cuda.reset_peak_memory_stats()
    result = loop.train(config, max_steps=SPATIAL_STEPS, device=dev,
                        on_start=on_start)
    torch.cuda.synchronize()
    launches = read_launches()
    os.environ.pop("OCC_PALLAS_BCE")
    check(result["steps"] == SPATIAL_STEPS,
          f"[spatial] rank {rank}: {result['steps']} steps")
    for k in ("chunk_conv", "chunk_conv_bwd_fused", "chunk_conv_dw",
              "bce_radius", "bce_fwd", "bce_bwd", "gather_conv"):
        check(launches[k] == predicted[k], f"[spatial] rank {rank} {k}: "
              f"{launches[k]} launches, predicted {predicted[k]}")
    if rank == 0:
        torch.save(first, os.path.join(tmp, "spatial_step1.pt"))
    return dict(step_ms=result["timings"]["step_ms"], launches=launches,
                predicted=dict(predicted),
                peak=torch.cuda.max_memory_allocated(),
                losses=result["losses"])


def _spatial_rank(rank, world, tmp, dev):
    """One [spatial] rank (spawned): (a) serving, (c) the radius, (b)
    training."""
    import torch.distributed as dist
    group = dist.group.WORLD
    serve, sa, plan = spatial_serve(dev, group, rank)
    radius = spatial_radius(dev, group, rank, sa, plan)
    torch.cuda.empty_cache()
    train = spatial_train(dev, tmp, rank)
    return dict(serve=serve, radius=radius, train=train)


def phase_spatial(dev, tmp, loop_med):
    """[spatial]: spatial sharding at full width, two spawned ranks on the
    one card over gloo (NCCL refuses two ranks on one device), each a
    shard: (a) serving bench scene 0 (`sharded_infer`'s path, bf16, halo
    and pool 4096, per-shard rulebooks) against the unsharded forward of
    the same model on the card (jax's bf16 tolerance; in f32 [parity]'s),
    each per-shard role against its plain version, the launches of #1
    and #9 against the shard plan; (b) `loop.train` with --spatial_shards
    2 at [loop]'s flags, f32, OCC_PALLAS_BCE=1, for 3 steps, step 1
    against the single-process `Trainer.step` on the same batch and plan
    (loss parts, gradient, statistics, parameters after Adam), the
    launches of #1, #3-#9 against the prediction; (c) the BCE radius
    maximised over the shards and the five sums against the whole
    scene's. (`tools/collectives_probe.py` says which gloo collectives
    take CUDA tensors; the exchanges use all-reduces alone.)"""
    import numpy as np
    from occuseg_tpu_torch.core.point_layout import apply_point_layout
    from occuseg_tpu_torch.infer import augment_plan
    from occuseg_tpu_torch.native.plan import build_plan_host
    from occuseg_tpu_torch.parallel import data_parallel
    from occuseg_tpu_torch.train import loop
    from occuseg_tpu_torch.train.config import args_to_config, get_parser
    t0 = time.perf_counter()
    ranks = data_parallel.spawn(_spatial_rank, 2, dev, tmp, dev,
                                backend="gloo")
    spawn_s = time.perf_counter() - t0
    for r, res in enumerate(ranks):
        s = res["serve"]
        print(f"[spatial] (a) rank {r}: {s['points']} points, active "
              f"{s['active']}; host plan {s['host_plan_ms']:.1f} ms, shard "
              f"{s['shard_ms']:.1f} ms; forward {s['ms']:.1f} ms (bf16, "
              f"exchanges and output gather included), peak "
              f"{s['peak'] / 2**30:.2f} GiB; launches {s['launches']}")
        print(f"[spatial] (a) rank {r} rows exchanged (left, right, pool) "
              f"{s['exchanges']}")
    s0 = ranks[0]["serve"]
    print(f"[spatial] (a) unsharded forward {s0['unsharded_ms']:.1f} ms, "
          f"peak {s0['unsharded_peak'] / 2**30:.2f} GiB; sharded against "
          f"it, bf16 {s0['bf16_errors']}; f32 {s0['f32_errors']}")
    print(f"[spatial] (a) per-shard roles against their plain versions, "
          f"max abs err {s0['roles']}")
    rad = ranks[0]["radius"]
    print(f"[spatial] (c) radius over the shards equal to the scene's; "
          f"instances a shard alone would sample smaller: "
          f"{[r['radius']['smaller'] for r in ranks]}; bce_sum error "
          f"{rad['bce_sum_err']:.3e} (max {rad['bce_sum_max']:.3e}), "
          f"{rad['samples']} sampled pairs, counts equal")
    check(any(r["radius"]["smaller"] > 0 for r in ranks),
          "[spatial] (c) no shard's own radius differs: the check is blind")

    config = args_to_config(get_parser().parse_args(
        [*SPATIAL_FLAGS, "--data_dir", os.path.join(tmp, "no_scenes"),
         "--checkpoints_dir", os.path.join(tmp, "spatial_ckpts")]))
    os.environ["OCC_PALLAS_BCE"] = "1"
    batch = next(loop._synthetic_dataset(config).train_batches(
        np.random.default_rng(100), config["point_cap"],
        config["instance_cap"], config["batch_size"]))
    spec = loop.build_spec(config)
    plan = augment_plan(build_plan_host(batch["coords"], spec), spec)
    laid = apply_point_layout(batch, plan, num_scenes=config["batch_size"])
    trainer = loop.build_trainer(config, dev, config["batch_size"])
    init = copy.deepcopy(trainer.model.state_dict())
    ref = _snapshot(trainer, trainer.step(laid, plan))
    os.environ.pop("OCC_PALLAS_BCE")
    names = [n for n, _ in trainer.model.named_parameters()]
    got = torch.load(os.path.join(tmp, "spatial_step1.pt"))
    g_glob, worst, bitwise, apart = _close_states(
        "[spatial] step 1", got, ref, names,
        _adam_from(trainer, init, got["grads"], config))
    print(f"[spatial] (b) step 1 against the single-process step: loss "
          f"parts {got['parts']} vs {ref['parts']}; gradients {g_glob:.3e} "
          f"of the norm, worst tensor {worst:.3e}; statistics within "
          f"{PARITY_TOL}, parameters within it of Adam on the sharded "
          f"gradients ({apart} entries past it from the reference's Adam)")
    for r, res in enumerate(ranks):
        t = res["train"]
        ms = t["step_ms"]
        med = sorted(ms)[len(ms) // 2]
        print(f"[spatial] (b) rank {r}: step ms "
              f"{', '.join(f'{x:.1f}' for x in ms)} (median {med:.1f}, the "
              f"first a warm-up) beside [loop]'s median {loop_med:.1f}; peak "
              f"{t['peak'] / 2**30:.2f} GiB; launches {t['launches']} "
              f"(predicted {t['predicted']}); losses {t['losses']}")
        check(all(math.isfinite(v) for v in t["losses"].values()),
              f"[spatial] rank {r} losses")
    print(f"[spatial] {spawn_s:.1f} s with the spawn")
    torch.cuda.empty_cache()
    return dict(serve=ranks[0]["serve"]["launches"],
                train=ranks[0]["train"]["launches"], seconds=spawn_s,
                grad_global=g_glob)


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
    families = phase_families(dev, train_med)
    legacy = phase_legacy(dev)
    with tempfile.TemporaryDirectory(prefix=".chip_smoke_",
                                     dir=os.path.dirname(
                                         os.path.abspath(__file__))) as tmp:
        gates = phase_gates(dev, tmp)
        dp = phase_dp(dev, tmp, loop_med)
        spatial = phase_spatial(dev, tmp, loop_med)
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
    # this slice's paths, each counted from 0 around its own run: the
    # facade's bf16 step, the checkpoint gate's forward, two
    # train_semantic steps and its eval, a [dp] rank's 3 steps
    slice_runs = dict(legacy=legacy["docstring"]["launches"],
                      checkpoint_gate=gates["checkpoint"]["launches"],
                      train_semantic=gates["semantic"]["launches"],
                      dp_rank0=dp["launches"])

    def paths(name, less=None):
        return {k: v[name] - (v[less] if less else 0)
                for k, v in slice_runs.items()}
    def spatial_path(name, less=None):
        # [spatial]: rank 0's serving forward and its training run, each
        # counted from 0 around its own run
        return {k: spatial[k][name] - (spatial[k][less] if less else 0)
                for k in ("serve", "train")}

    # the DenseUNet_BN step of [families] (b): the launches counted in
    # its first timed step (seed 0)
    dense = dict(dense_unet_bn_launches_per_step=families["dense_unet_bn"][
        "launches_per_step"])
    print(json.dumps({"kernels": [
        entry("chunk_conv_fwd", "chunk_conv", "chunk_conv.cu",
              "chunk_conv.py:671", launches["chunk_conv"], families=dense,
              legacy_gates_dp=paths("chunk_conv"),
              spatial=spatial_path("chunk_conv")),
        entry("blocked_segment_sum", "blocked_segment_sum", "segsum.cu",
              "segsum.py:67", launches["blocked_segment_sum"],
              shapes=tot.segsum_shapes, families=dense,
              legacy_gates_dp=paths("blocked_segment_sum"),
              spatial=spatial_path("blocked_segment_sum")),
        entry("chunk_conv_bwd_fused (#3 shapes)", "#3", "chunk_conv_bwd.cu",
              "chunk_conv.py:442", fused - grouped, families=dense,
              legacy_gates_dp=paths("chunk_conv_bwd_fused",
                                    "chunk_conv_bwd_fused_kgrouped"),
              spatial=spatial_path("chunk_conv_bwd_fused",
                                   "chunk_conv_bwd_fused_kgrouped")),
        entry("chunk_conv_bwd_fused (#4 shapes)", "#4", "chunk_conv_bwd.cu",
              "chunk_conv.py:568", grouped, families=dense,
              legacy_gates_dp=paths("chunk_conv_bwd_fused_kgrouped"),
              spatial=spatial_path("chunk_conv_bwd_fused_kgrouped")),
        entry("chunk_conv_dw", "chunk_conv_dw", "chunk_conv_bwd.cu",
              "chunk_conv.py:720", launches["chunk_conv_dw"],
              families=dense, legacy_gates_dp=paths("chunk_conv_dw"),
              spatial=spatial_path("chunk_conv_dw")),
        # the training CLI's path: once each per step; beside them the
        # port's [P, I] chain, forward and backward (not a library call)
        entry("bce_radius", "bce_radius", "bce_loss.cu", "bce_loss.py:227",
              loop_launches["bce_radius"], cases=tot.radius_cases,
              legacy_gates_dp=paths("bce_radius"),
              spatial=spatial_path("bce_radius")),
        entry("bce_fwd", "bce_fwd", "bce_loss.cu", "bce_loss.py:258",
              loop_launches["bce_fwd"], chain_ms=tot.chain_ms[0],
              legacy_gates_dp=paths("bce_fwd"),
              spatial=spatial_path("bce_fwd")),
        entry("bce_bwd", "bce_bwd", "bce_loss.cu", "bce_loss.py:289",
              loop_launches["bce_bwd"], max_abs_err_of=tot.bce_bwd_err_of,
              chain_ms=tot.chain_ms[1] - tot.chain_ms[0],
              legacy_gates_dp=paths("bce_bwd"),
              spatial=spatial_path("bce_bwd")),
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
              planner=planner,
              legacy_gates_dp=dict(paths("gather_conv"), append_tensors=legacy[
                  "append_launches"]["gather_conv"]),
              spatial=spatial_path("gather_conv"),
              # [families]: #9 on a randomized plan's jittered maps, and
              # its launches in the builders, the randomized-stride net
              # and the classification harness
              families=dict(
                  randomized={k: v for k, v in families["randomized"].items()
                              if k != "net_launches"},
                  launches=dict(
                      builders={k: v["launches"] for k, v in
                                families["builders"].items()},
                      randomized_net=families["randomized"]["net_launches"],
                      classification=families["classification"]["launches"]),
                  step_ms=families["dense_unet_bn"]["step_ms"],
                  seconds=families["seconds"])),
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
