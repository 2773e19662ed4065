"""Time the first-version chunk-conv kernels in variants, at the 33
convolutions of the bench plan (bf16), to see what sets their pace.

    python -m occuseg_tpu_torch.tools.kernel_variants OLD_CHECKOUT

OLD_CHECKOUT is a checkout of the repository at commit eeac140 (for
example `git archive eeac140 | tar -x -C DIR`), whose
`occuseg_tpu_torch/csrc/chunk_conv.cu` and `chunk_conv_bwd.cu` hold the
WMMA kernels: one block per (chunk, 64 columns), a per-offset A-tile copy
in shared memory, synchronous W loads, and f32 atomics for the fused
backward's dW. The variants, each compiled from those sources with one
macro inserted here:

- `base`: as they were;
- `no_atomics`: the fused backward without its dW atomics (the products
  stay, the adds into device memory go);
- `no_acopy`: the forward reading A from the staged rows in place of the
  gathered copy (no copy, wrong values: timing only);
- `w_hoist`: the forward loading W only for its first two offsets (timing
  only).

Needs a CUDA card and nvcc; the plan and the wrappers are this checkout's.
Prints one line per convolution and the per-step totals.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import tempfile

import torch

PATCHES = {
    "chunk_conv.cu": [
        ("      gather_a_tile<T, CI_T>(a_b, gin_s, lidx_s + k * M, M);\n"
         "      load_w_tile<T, CI_T>(w_b, w, k, cin, cout, ci0, co0);",
         "#ifndef NO_ACOPY\n"
         "      gather_a_tile<T, CI_T>(a_b, gin_s, lidx_s + k * M, M);\n"
         "#endif\n#ifdef W_HOIST\n      if (k < 2)\n#endif\n"
         "      load_w_tile<T, CI_T>(w_b, w, k, cin, cout, ci0, co0);"),
        ("            wmma::load_matrix_sync(fa[i], a_b + (row0 + i * 16) * "
         "L::kLdg + kk,",
         "#ifdef NO_ACOPY\n            wmma::load_matrix_sync(fa[i], gin_s "
         "+ (row0 + i * 16) * L::kLdg + kk,\n#else\n"
         "            wmma::load_matrix_sync(fa[i], a_b + (row0 + i * 16) * "
         "L::kLdg + kk,\n#endif"),
    ],
    "chunk_conv_bwd.cu": [
        ("        for (int i = lane; i < 16 * vpr; i += 32) {\n"
         "          const int r = i / vpr, q = i % vpr;\n"
         "          red_add4(",
         "#ifdef NO_ATOMICS\n        if (vpr < 0)\n#endif\n"
         "        for (int i = lane; i < 16 * vpr; i += 32) {\n"
         "          const int r = i / vpr, q = i % vpr;\n"
         "          red_add4("),
    ],
}
VARIANTS = {"base": [], "no_atomics": ["-DNO_ATOMICS"],
            "no_acopy": ["-DNO_ACOPY"], "w_hoist": ["-DW_HOIST"]}
ARGTYPES = {
    "occ_chunk_conv_fwd": [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                           ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                           ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                           ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                           ctypes.c_int, ctypes.c_void_p],
    "occ_chunk_conv_bwd_fused": [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                                 ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                                 ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                                 ctypes.c_void_p, ctypes.c_void_p,
                                 ctypes.c_int, ctypes.c_void_p,
                                 ctypes.c_void_p, ctypes.c_int,
                                 ctypes.c_void_p],
}


def build(old: str, tmp: str) -> dict:
    """Patch the old sources into tmp and build one library per variant."""
    src = os.path.join(old, "occuseg_tpu_torch", "csrc")
    for name, edits in PATCHES.items():
        with open(os.path.join(src, name)) as f:
            text = f.read()
        for a, b in edits:
            if text.count(a) != 1:
                raise SystemExit(f"{name}: not the first-version kernel")
            text = text.replace(a, b)
        with open(os.path.join(tmp, name), "w") as f:
            f.write(text)
    with open(os.path.join(src, "chunk_conv.cuh")) as f:
        header = f.read()
    with open(os.path.join(tmp, "chunk_conv.cuh"), "w") as f:
        f.write(header)
    nvcc = "/usr/local/cuda/bin/nvcc"
    flags = ["-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
             "-Xcompiler", "-fPIC", "-shared"]
    procs = {}
    for name, defs in VARIANTS.items():
        out = os.path.join(tmp, f"lib_{name}.so")
        procs[name] = (out, subprocess.Popen(
            [nvcc, *flags, *defs, "-o", out,
             *(os.path.join(tmp, n) for n in PATCHES)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (out, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(log)
        lib = ctypes.CDLL(out)
        for fn, args in ARGTYPES.items():
            getattr(lib, fn).restype = ctypes.c_int
            getattr(lib, fn).argtypes = args
        libs[name] = lib
    return libs


def main(old: str) -> None:
    import chip_smoke as cs
    from occuseg_tpu_torch.core.topology import PlanSpec
    from occuseg_tpu_torch.infer import prepare_scene

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    with tempfile.TemporaryDirectory() as tmp:
        libs = build(old, tmp)
        dev = torch.device("cuda", 0)
        stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
        b = cs.bench_scene(0)
        plan = prepare_scene(b["coords"], b["features"],
                             PlanSpec(caps=cs.BENCH_CAPS)).plan.to(dev)
        gen = torch.Generator().manual_seed(1)
        tot = {}
        with torch.inference_mode():
            for cv in cs.conv_calls(plan, cs.N_PLANES):
                fi, fl = cv.chunks.in_idx, cv.chunks.lidx
                ti, tl = cv.t_chunks.in_idx, cv.t_chunks.lidx
                (C, U), (Ct, Ut) = fi.shape, ti.shape
                K, M = fl.shape[1:]
                dt = torch.bfloat16
                x = torch.randn(cv.n_in, cv.cin, generator=gen).to(dev, dt)
                w = (torch.randn(K, cv.cin, cv.cout, generator=gen)
                     * (2 / (cv.cin * K)) ** .5).to(dev, dt)
                ct = torch.randn(cv.n_out, cv.cout, generator=gen).to(dev, dt)
                wt = w.transpose(1, 2).contiguous()
                out = torch.empty(C * M, cv.cout, dtype=dt, device=dev)
                d_f = torch.empty(Ct * M, cv.cin, dtype=dt, device=dev)
                dwt = torch.zeros(K, cv.cin, cv.cout, device=dev)
                route = cs.route_of(cv, 2)
                row = []

                def fwd(lib):
                    lib.occ_chunk_conv_fwd(
                        x.data_ptr(), cv.n_in, cv.cin, fi.data_ptr(), C, U,
                        fl.data_ptr(), K, M, w.data_ptr(), cv.cout,
                        out.data_ptr(), 1, stream())

                def fused(lib):
                    lib.occ_chunk_conv_bwd_fused(
                        ct.data_ptr(), cv.n_out, cv.cout, ti.data_ptr(), Ct,
                        Ut, tl.data_ptr(), K, M, wt.data_ptr(), x.data_ptr(),
                        cv.cin, d_f.data_ptr(), dwt.data_ptr(), 1, stream())

                jobs = [("fwd", n, fwd) for n in ("base", "no_acopy",
                                                  "w_hoist")]
                if route != "#5":
                    jobs += [("bwd", n, fused) for n in ("base",
                                                         "no_atomics")]
                for kind, name, fn in jobs:
                    ms = cs.cuda_ms(lambda: fn(libs[name]), 5)
                    tot[kind, name] = tot.get((kind, name), 0.0) + ms
                    row.append(f"{kind}[{name}]={ms:.4f}")
                print(f"{cv.label:<22} route={route} " + " ".join(row),
                      flush=True)
        for (kind, name), ms in tot.items():
            print(f"per step {kind} {name}: {ms:.3f} ms")


if __name__ == "__main__":
    if len(sys.argv) != 2:
        raise SystemExit(__doc__)
    main(sys.argv[1])
