"""Time this checkout's kernels in variants, each with one part of their
work taken out or one choice changed, in `chip_smoke.py`'s `[kernels]`
phase (the 33 convolutions of the bench plan, the segment sum, the BCE
kernels at the CLI's shape), to see what sets their pace.

    python -m occuseg_tpu_torch.tools.conv_variants OUT_DIR [NAME ...]

Each variant is a copy of the checkout (chip_smoke.py, the package, the
planner's csrc/) with one edit in the kernel sources. The variants compute
wrong values on purpose, so their copies of chip_smoke.py print failed
checks instead of raising. `tools.ab_kernels` then times the unchanged
copy and the variants (all, or the NAMEs given) in one process each, in
order and in reverse. Needs a CUDA card and nvcc.

- `no_restage`: the forward stages the chunk's rows for its first Cin
  tile only (later tiles compute on stale rows);
- `no_mma`: the forward issues no wgmma (gathers, barriers and the W ring
  stay);
- `no_gather`: the forward reads each row's A fragment from its own
  staged row m, not through lidx;
- `no_refill_wait`: thread 0 refills a W stage without waiting for the
  warps to release it;
- `dwt_no_stage`: the weight-gradient kernel (dWt of the fused route,
  dW of the dW route) stages the rows of its run's first chunk only;
- `dwt_no_mma`: the weight-gradient kernel issues no wgmma;
- `dw_f32_ct64`: the f32 weight-gradient kernel takes 64 X columns
  wherever they fit, also where only one block then fits on an SM (the
  rule before it preferred two blocks per SM);
- `bce_no_dot`: the BCE forward and backward skip the e.mu dot of their
  pairs;
- `bce_no_walk`: the BCE backward skips its walks over the pair list (de,
  drx, dmu, d(sig^2));
- `bce_256`: the BCE forward and backward in blocks of 256 threads (8
  warps) instead of 512;
- `bce_no_de`: the BCE backward skips its per-point walk (de, drx);
- `bce_no_dmu`: the BCE backward skips its per-instance walk (dmu,
  d(sig^2));
- `bce_one_block`: the BCE backward compiled for one block per SM (128
  registers a thread, no spills) instead of two (64 registers);
- `bce_fwd_no_walk`: the BCE forward skips its per-instance walk (the
  sums);
- `bce_fwd_no_terms`: the BCE forward computes no entry's terms (dot, s,
  bce);
- `bce_fwd_no_list`: the BCE forward builds each tile's candidate masks
  and list slots but never writes or walks the list;
- `bce_no_test`: the BCE forward and backward stage each tile and list
  its candidates but test no pair (every list is empty);
- `segsum_128`, `segsum_256`: the segment sum in CTAs of 128 (resp. 256)
  threads at every C;
- `radius_match_any`: the BCE radius groups a warp's lanes by id with
  `__match_any_sync` (one atomic per group) instead of a segmented max
  over runs of consecutive lanes;
- `radius_no_chain`: the BCE radius's blocks take their maxima straight
  into the output, with no count and no last block (timing only);
- `gather_no_mma`: the gather conv issues no wgmma (gathers, W loads,
  barriers and the split's reduction stay);
- `gather_no_steps`: the gather conv's blocks take no step (ids,
  liveness, the split's reduction and the store stay);
- `gather_splits_4`: the gather conv splits a tile's steps into at most
  4 ranges (a cluster of 4) instead of 8.
"""

from __future__ import annotations

import os
import shutil
import sys
import tempfile

from occuseg_tpu_torch.tools import ab_kernels

FWD = "occuseg_tpu_torch/csrc/chunk_conv.cu"
BWD = "occuseg_tpu_torch/csrc/chunk_conv_bwd.cu"
BCE = "occuseg_tpu_torch/csrc/bce_loss.cu"
SEG = "occuseg_tpu_torch/ops/kernels/segsum.py"
GATHER = "occuseg_tpu_torch/csrc/gather_conv.cu"
GATHER_PY = "occuseg_tpu_torch/ops/kernels/gather_conv.py"
VARIANTS = {
    "no_restage": [(FWD, "    if (cit != staged) {",
                    "    if (staged < 0) {")],
    "no_mma": [(FWD, "      wgmma_bf16<NT>(acc, af[kk],",
                "      if (M < 0) wgmma_bf16<NT>(acc, af[kk],")],
    "no_gather": [(FWD, "    const int l = m < M ? row_of(lk[m], U) : U;",
                   "    const int l = m < M ? m % U : U;")],
    "no_refill_wait": [(FWD, "      mbar_wait(empty + stage, (i / kStages) & 1);\n",
                        "")],
    "dwt_no_stage": [(BWD, "    if (live) {\n      // D rows",
                      "    if (live && c == c_begin) {\n      // D rows")],
    "dwt_no_mma": [(BWD, "          wgmma_bf16<64>(acc[o], af[sl],",
                    "          if (M < 0) wgmma_bf16<64>(acc[o], af[sl],")],
    "dw_f32_ct64": [(BWD, "if (s64 > kTwoPerSm && s32 <= kTwoPerSm)",
                     "if (s64 < 0)")],
    "bce_no_dot": [(BCE, "  for (int k = 0; k < E / 4; ++k) {",
                    "  for (int k = 0; k < 0; ++k) {")],
    "bce_no_walk": [(BCE, "      // 4a. de and drx: one warp per point",
                     "      if (E > 0) goto walked;\n"
                     "      // 4a. de and drx: one warp per point"),
                    (BCE, "          scal[2] += t2;\n        }\n      }\n"
                     "      __syncthreads();  // the next window or",
                     "          scal[2] += t2;\n        }\n      }\n"
                     "    walked:\n"
                     "      __syncthreads();  // the next window or")],
    "bce_256": [(BCE, "constexpr int kListThreads = 512;",
                 "constexpr int kListThreads = 256;")],
    "bce_one_block": [(BCE, "__launch_bounds__(kListThreads, 2)\n"
                       "bce_bwd_kernel",
                       "__launch_bounds__(kListThreads, 1)\n"
                       "bce_bwd_kernel")],
    "bce_no_de": [(BCE, "      for (int r = r0 + warp; r < r1; r += kListWarps) {\n"
                   "        float G0",
                   "      for (int r = r1; r < r1; r += kListWarps) {\n"
                   "        float G0")],
    "bce_no_dmu": [(BCE, "        const int i = warp + kListWarps * s;\n"
                    "        if (i >= I) break;\n        float a[2]",
                    "        const int i = warp + kListWarps * s;\n"
                    "        if (i >= 0) break;\n        float a[2]")],
    "bce_fwd_no_walk": [(BCE, "        const int j = T.cpos[i];",
                         "        const int j = -1;")],
    "bce_fwd_no_terms": [(BCE, "      // 3. the entries' terms\n"
                          "      for (int q = t; q < nw;",
                          "      // 3. the entries' terms\n"
                          "      for (int q = nw; q < nw;")],
    "bce_fwd_no_list": [(BCE, "    for (int r0 = 0; r0 < n;) {\n"
                         "      const int r1 = window_end(T.rstart, r0, n, "
                         "lcap);\n      const int base = T.rstart[r0], nw = "
                         "T.rstart[r1] - base;\n      list_window(",
                         "    for (int r0 = n; r0 < n;) {\n"
                         "      const int r1 = window_end(T.rstart, r0, n, "
                         "lcap);\n      const int base = T.rstart[r0], nw = "
                         "T.rstart[r1] - base;\n      list_window(")],
    "bce_no_test": [(BCE, "  const int nc = T.cand[kMaxI];\n"
                     "  // the sample test",
                     "  const int nc = T.cand[kMaxI];\n  if (I > 0) {\n"
                     "    for (int r = t; r <= n; r += kListThreads) "
                     "T.rstart[r] = 0;\n    __syncthreads();\n"
                     "    return nc;\n  }\n  // the sample test")],
    "segsum_128": [(SEG, "    threads = 128 if R * C <= SMALL_SLAB else 256",
                    "    threads = 128")],
    "segsum_256": [(SEG, "    threads = 128 if R * C <= SMALL_SLAB else 256",
                    "    threads = 256")],
    "radius_match_any": [(BCE, "  if (!__any_sync(kFull, id >= 0)) return;"
                          "  // uniform over the warp\n",
                          "  if (!__any_sync(kFull, id >= 0)) return;\n"
                          "  const unsigned peers = __match_any_sync(kFull, "
                          "id);\n  const unsigned mm = __reduce_max_sync("
                          "peers, bits);\n  if (id >= 0 && lane == __ffs("
                          "peers) - 1) atomicMax(r_s + id, mm);\n"
                          "  if (id > -2) return;\n")],
    "radius_no_chain": [(BCE, "    if (r_s[i]) atomicMax(scratch + i, r_s[i]);\n"
                         "  __threadfence();",
                         "    if (r_s[i]) atomicMax(r_bits + i, r_s[i]);\n"
                         "  if (I > 0) return;\n  __threadfence();")],
    "gather_no_mma": [(GATHER, "        wgmma_bf16<NT>(acc, af[kk],",
                       "        if (N < 0) wgmma_bf16<NT>(acc, af[kk],")],
    "gather_no_steps": [(GATHER, "  const int n_steps = *n_live_s * n_cit;",
                         "  const int n_steps = 0 * *n_live_s * n_cit;")],
    "gather_splits_4": [(GATHER_PY, "MAX_SPLITS = 8  ", "MAX_SPLITS = 4  ")],
}
CHECK = ("    if not cond:\n        raise SmokeFailure(what)",
         "    if not cond:\n        print(\"variant, not checked: \" + what[:60])")


def _copy(src: str, dst: str) -> None:
    ignore = shutil.ignore_patterns("build", "__pycache__", "*.so", "*.o")
    shutil.copy(os.path.join(src, "chip_smoke.py"), dst)
    for d in ("occuseg_tpu_torch", "csrc"):
        shutil.copytree(os.path.join(src, d), os.path.join(dst, d),
                        ignore=ignore)


def _edit(path: str, old: str, new: str) -> None:
    with open(path) as f:
        text = f.read()
    if text.count(old) != 1:
        raise SystemExit(f"{path}: the variant's anchor is not unique")
    with open(path, "w") as f:
        f.write(text.replace(old, new))


def main(out_dir: str, names=()) -> int:
    root = os.getcwd()
    chosen = [(n, VARIANTS[n]) for n in (names or VARIANTS)]
    with tempfile.TemporaryDirectory(dir=root, prefix=".chip_smoke_") as tmp:
        roots = []
        for name, edits in [("base", [])] + chosen:
            dst = os.path.join(tmp, name)
            os.makedirs(dst)
            _copy(root, dst)
            for rel, old, new in edits:
                _edit(os.path.join(dst, rel), old, new)
            if edits:
                _edit(os.path.join(dst, "chip_smoke.py"), *CHECK)
            roots.append(dst)
        return ab_kernels.main(out_dir, roots)


if __name__ == "__main__":
    if len(sys.argv) < 2:
        raise SystemExit(__doc__)
    sys.exit(main(sys.argv[1], sys.argv[2:]))
