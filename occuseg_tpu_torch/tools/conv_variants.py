"""Time this checkout's chunk-conv kernels in variants, each with one part
of their work taken out, at the 33 convolutions of the bench plan (bf16),
to see what sets their pace.

    python -m occuseg_tpu_torch.tools.conv_variants OUT_DIR

Each variant is a copy of the checkout (chip_smoke.py, the package, the
planner's csrc/) with one edit in the kernel sources. The variants compute
wrong values on purpose, so their copies of chip_smoke.py print failed
checks instead of raising. `tools.ab_kernels` then times the unchanged
copy and the variants in one process each, in order and in reverse.
Needs a CUDA card and nvcc.

- `no_restage`: the forward stages the chunk's rows for its first Cin
  tile only (later tiles compute on stale rows);
- `no_mma`: the forward issues no wgmma (gathers, barriers and the W ring
  stay);
- `no_gather`: the forward reads each row's A fragment from its own
  staged row m, not through lidx;
- `no_refill_wait`: thread 0 refills a W stage without waiting for the
  warps to release it;
- `dwt_no_stage`: the dWt kernel stages the rows of its run's first
  chunk only;
- `dwt_no_mma`: the dWt kernel issues no wgmma.
"""

from __future__ import annotations

import os
import shutil
import sys
import tempfile

from occuseg_tpu_torch.tools import ab_kernels

FWD = "occuseg_tpu_torch/csrc/chunk_conv.cu"
BWD = "occuseg_tpu_torch/csrc/chunk_conv_bwd.cu"
VARIANTS = {
    "no_restage": [(FWD, "    if (cit != staged) {",
                    "    if (staged < 0) {")],
    "no_mma": [(FWD, "      wgmma_bf16<NT>(acc, af[kk],",
                "      if (M < 0) wgmma_bf16<NT>(acc, af[kk],")],
    "no_gather": [(FWD, "    const int l = m < M ? row_of(lk[m], U) : U;",
                   "    const int l = m < M ? m % U : U;")],
    "no_refill_wait": [(FWD, "      mbar_wait(empty + stage, (i / kStages) & 1);\n",
                        "")],
    "dwt_no_stage": [(BWD, "    if (live) {\n      // feats rows",
                      "    if (live && c == c_begin) {\n      // feats rows")],
    "dwt_no_mma": [(BWD, "          wgmma_bf16<64>(acc[o], af[sl],",
                    "          if (M < 0) wgmma_bf16<64>(acc[o], af[sl],")],
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


def main(out_dir: str) -> int:
    root = os.getcwd()
    with tempfile.TemporaryDirectory(dir=root, prefix=".chip_smoke_") as tmp:
        roots = []
        for name, edits in [("base", [])] + list(VARIANTS.items()):
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
    if len(sys.argv) != 2:
        raise SystemExit(__doc__)
    sys.exit(main(sys.argv[1]))
