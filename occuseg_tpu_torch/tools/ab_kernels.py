"""Time the kernels of several checkouts of this repository against each
other on one card, in one call.

    python -m occuseg_tpu_torch.tools.ab_kernels OUT_DIR DIR_A DIR_B [...]
    python -m occuseg_tpu_torch.tools.ab_kernels --smoke OUT_DIR DIR_A ...
    python -m occuseg_tpu_torch.tools.ab_kernels --focus OUT_DIR DIR_A ...
    python -m occuseg_tpu_torch.tools.ab_kernels --f32conv OUT_DIR DIR_A ...

Each run is `chip_smoke.py`'s build and `[kernels]` phase (every kernel at
the bench plan's shapes, against its plain version) in a process of its
own, from the checkout's root; with --smoke, the whole `chip_smoke.py`
(every phase, end to end); with --focus, this module's `focus` on the
checkout's package: the segment sum (#2) at the bench plan's two shapes,
the BCE radius (#6) at the CLI's shape (P=262144) at I=128 and 64 with
random ids and with the CLI's runs of one instance, the BCE forward (#7)
and backward (#8) at the CLI's shape and the bench's, and the gather
conv (#9) at L3-L5 of the bench plan beside the chunk-conv forward (#1)
of the same level, width and weights, each timed as `chip_smoke.cuda_ms`
does (CUDA events around back to back calls, the host's launch cost
included) and inside a CUDA graph (without it), with the segment sum's
`index_add` beside it, digests of the outputs saved to
OUT_DIR/focus_<i>.pt, and the first checkout's outputs compared bit for
bit with each other's; with --f32conv, this module's `f32conv`: the f32
forward kernel (#1) over the forward plan and the transpose plan (the
d_feats pass of both backward routes) of each of the bench plan's 33
convolutions, timed as `chip_smoke.cuda_ms` does, with what the f32
forward counted (skipped warp-steps, the row order's share of the blocks'
cycles) where the checkout's wrapper has `fwd_counts`, and, where it has
the tensor-core tile (`f32_route`), that tile's group-steps run and
skipped, the FMA tile's time beside it and each tile's error against the
float64 product of the same gathered rows; then the f32 weight gradient
each convolution's backward takes (`f32_dw_operands`: dWt over the
transpose plan on the fused route, dW over the forward plan on the dW
route), timed on the wrapper's tile and, where the checkout has the
tensor-core dW tile (`dw_route`), on each tile, with that tile's k8 steps
run and skipped and each tile's error against the float64 sum; the
outputs are compared bit for bit across the checkouts (a zero's sign
aside). The
checkouts run in the order given and
then in reverse (A, B, B, A for two), so that a drift of the card's clocks
over the call falls on all of them alike. Prints the card's name and
power limit and each run's summary lines; the full output of run i goes
to OUT_DIR/ab_<i>.log (smoke_<i>.log, focus_<i>.log). Needs a CUDA card
and nvcc.
"""

from __future__ import annotations

import os
import re
import subprocess
import sys

RUN = ("import sys, torch; sys.path.insert(0, '.'); import chip_smoke as cs; "
       "torch.backends.cuda.matmul.allow_tf32 = False; cs.phase_build(); "
       "cs.phase_kernels(torch.device('cuda', 0))")
SUMMARY = ("[kernels] per step", "[kernels] bce", "[kernels] blocked_segment")
SMOKE_SUMMARY = SUMMARY + ("[slice] request", "[train] 9 steps",
                           "[train] device busy", "[loop] cli.main",
                           "[loop] device busy", "all phases passed")
FOCUS_SUMMARY = ("[focus]",)
F32CONV_SUMMARY = ("[f32conv] per step", "[f32conv] ptxas")


def event_ms(fn, reps: int) -> float:
    """Mean ms per call over `reps` back to back calls after one warm-up
    call, between CUDA events: the host's cost of each launch included
    where it exceeds the device's (as `chip_smoke.cuda_ms`)."""
    import torch
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


def graph_ms(fn, reps: int):
    """Device ms per call without the host's cost of each launch: `reps`
    calls captured in one CUDA graph, the graph replayed three times
    between CUDA events. None (and a printed reason) where the capture
    fails."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # warm-up off the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.graph(graph):
            for _ in range(reps):
                fn()
    except RuntimeError as exc:
        print(f"CUDA graph capture failed: {exc}")
        return None
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(3):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (3 * reps)


def _both(fn, reps: int) -> str:
    g = graph_ms(fn, reps)
    return (f"{event_ms(fn, reps):.4f} ms (graph "
            f"{'not measured' if g is None else f'{g:.4f}'})")


def _ptxas(path: str, names=("segsum", "bce", "radius", "gather"),
           tag: str = "focus"):
    """The nvcc log's register and spill lines of the named kernels."""
    fn = ""
    for line in open(path + ".log"):
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?(\w+)", line)
        if m:
            fn = m.group(1)
        elif any(n in fn for n in names) and ("Used" in line
                                              or "spill" in line):
            print(f"[{tag}] ptxas {fn[:60]}: {line.split(':')[-1].strip()}")


def _radius_inputs(P: int, I: int, seed: int, runs: bool, dev):
    """(x4, seg, mp4, mp_sq) as `bce_loss.exact_inputs` makes them (every
    coordinate a multiple of 1/8: each distance exact in f32), with the
    ids drawn at random or in the training CLI's layout (a batch of 4
    synthetic scenes of 20k points, each object's points one run). Built
    here so that a checkout without that layout takes the same inputs."""
    import numpy as np
    import torch
    from occuseg_tpu_torch.data.synthetic import SceneConfig, make_batch
    rng = np.random.default_rng(seed)
    if runs:
        seg = make_batch(SceneConfig(num_points=20_000, extent=256), 4, P,
                         I, seed=seed)["instance_id"]
    else:
        seg = rng.integers(0, I, P)
        seg[rng.random(P) < 0.2] = -1
    centers = rng.integers(-16, 17, (I, 3)) / 2.0
    x = centers[np.clip(seg, 0, I - 1)] + rng.integers(-8, 9, (P, 3)) / 8.0

    def t(a, dt=torch.float32):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dt,
                               device=dev)
    return (t(np.hstack([x, np.zeros((P, 1))])), t(seg, torch.int32),
            t(np.hstack([centers, np.zeros((I, 1))])),
            t((centers * centers).sum(1)))


def focus(out_path: str) -> None:
    """Time #2, #6-#9 (and #1 beside #9) of the package under the working
    directory."""
    sys.path.insert(0, os.getcwd())
    import torch
    from occuseg_tpu_torch.core.topology import PlanSpec
    from occuseg_tpu_torch.data.synthetic import SceneConfig, make_batch
    from occuseg_tpu_torch.infer import prepare_scene
    from occuseg_tpu_torch.ops import kernels
    from occuseg_tpu_torch.ops.kernels import bce_loss as bl
    from occuseg_tpu_torch.ops.kernels import chunk_conv as cc
    from occuseg_tpu_torch.ops.kernels import gather_conv as gc
    from occuseg_tpu_torch.ops.kernels import segsum
    _ptxas(kernels.library_path())
    dev = torch.device("cuda", 0)
    batch = make_batch(SceneConfig(num_points=200_000, extent=512,
                                   num_objects=24), num_scenes=1,
                       p_cap=262_144, num_instances=64, seed=0)
    plan = prepare_scene(batch["coords"], batch["features"], PlanSpec(
        caps=(196_608, 139_264, 63_488, 17_408, 4_096, 1_024))).plan.to(dev)
    cap0, vox_seg = plan.levels[0].cap, plan.vox_seg
    B, _, R = vox_seg.shape
    seg = vox_seg.reshape(-1).long()
    valid = seg >= 0
    dst = ((torch.arange(B * R, device=dev) // R) * (cap0 // B) + seg)[valid]
    gen = torch.Generator().manual_seed(1)
    saved = {}
    with torch.inference_mode():
        for C in (3, 64):
            x = torch.randn(262_144, C, generator=gen).to(dev)
            xv = x[:B * R][valid]
            zeros = torch.zeros((cap0, C), device=dev)

            def kernel():
                return segsum.blocked_segment_sum(x, vox_seg, cap0)

            def library():
                return zeros.index_add(0, dst, xv)
            saved[f"segsum_{C}"] = _digest(kernel())
            print(f"[focus] segsum C={C}: kernel {_both(kernel, 20)}, "
                  f"index_add {_both(library, 20)}", flush=True)
        for I in (128, 64):
            e, rx4, x4, sg, sc, mu, mp4, cons, g = bl.exact_inputs(
                262_144, I, 64, seed=I, device=dev)
            cons = bl.with_radius(x4, sg, mp4, cons)
            args = (e, rx4, x4, sg, sc, mu, mp4, cons)
            saved[f"fwd_{I}"] = _digest(bl.bce_sums(*args), keep=True)
            saved[f"bwd_{I}"] = _digest(*bl.bce_sums_bwd(*args, g))
            fwd = lambda: bl.bce_sums(*args)  # noqa: E731
            bwd = lambda: bl.bce_sums_bwd(*args, g)  # noqa: E731
            print(f"[focus] bce I={I}: forward {_both(fwd, 10)}, backward "
                  f"{_both(bwd, 10)}", flush=True)
            del e, rx4, x4, sg, sc, mu, mp4, cons, g, args
            for layout in ("random", "runs"):
                rx, rs, rm, rq = _radius_inputs(262_144, I, I,
                                                layout == "runs", dev)
                rad = lambda: bl.radius_sq(rx, rs, rm, rq)  # noqa: E731
                saved[f"radius_{I}_{layout}"] = _digest(rad(), keep=True)
                print(f"[focus] radius I={I} seg {layout}: "
                      f"{_both(rad, 20)}", flush=True)
        gen = torch.Generator().manual_seed(9)
        for lv, C in ((3, 256), (4, 320), (5, 384)):
            level = plan.levels[lv]
            nbr_kn = torch.from_numpy(level.nbr.T.copy()).to(dev)
            xg = torch.randn(level.nbr.shape[0], C, generator=gen)
            xg[int(level.num_active):] = 0
            xg = xg.to(dev, torch.bfloat16)
            wg = (torch.randn(27, C, C, generator=gen)
                  * (2 / (27 * C)) ** .5).to(dev, torch.bfloat16)
            fi, fl = level.chunks.in_idx, level.chunks.lidx
            gat = lambda: gc.gather_conv(xg, nbr_kn, wg)  # noqa: E731
            chk = lambda: cc.chunk_conv(xg, fi, fl, wg)  # noqa: E731
            saved[f"gather_L{lv}"] = _digest(gat(), keep=True)
            print(f"[focus] gather_conv L{lv} C={C}: kernel "
                  f"{_both(gat, 20)}, chunk_conv (#1) {_both(chk, 20)}",
                  flush=True)
    torch.save(saved, out_path)


def f32conv(out_path: str) -> None:
    """Time the f32 forward kernel (#1) of the package under the working
    directory over the 33 convolutions of the bench plan, forward and
    transpose plans."""
    sys.path.insert(0, os.getcwd())
    import torch
    import chip_smoke as cs
    from occuseg_tpu_torch.core.topology import PlanSpec
    from occuseg_tpu_torch.infer import prepare_scene
    from occuseg_tpu_torch.ops import kernels
    from occuseg_tpu_torch.ops.kernels import chunk_conv as cc
    torch.backends.cuda.matmul.allow_tf32 = False
    _ptxas(kernels.library_path(), names=("chunk_conv_kernelIf",
                                          "dw_kernelIf"),
           tag="f32conv")
    dev = torch.device("cuda", 0)
    b = cs.bench_scene(0)
    plan = prepare_scene(b["coords"], b["features"],
                         PlanSpec(caps=cs.BENCH_CAPS)).plan.to(dev)
    counted = hasattr(cc, "fwd_counts")
    tc = hasattr(cc, "f32_route")
    dw_tc = hasattr(cc, "dw_route")
    gen = torch.Generator().manual_seed(1)
    saved, tot = {}, {"fwd": 0.0, "t": 0.0, "fma": 0.0, "tc": 0.0,
                      "run": 0.0, "real": 0.0, "worst": 0.0}
    dw_tot = dict.fromkeys(("dw", "fma", "tc", "tc_maps", "run", "real",
                            "worst", "ran", "skipped"), 0.0)
    with torch.inference_mode():
        for cv in cs.conv_calls(plan, cs.N_PLANES):
            K = cv.chunks.lidx.shape[1]
            x = torch.randn(cv.n_in, cv.cin, generator=gen)
            x[cv.n_act:] = 0
            w = torch.randn(K, cv.cin, cv.cout, generator=gen) \
                * (2 / (cv.cin * K)) ** .5
            ct = torch.randn(cv.n_out, cv.cout, generator=gen)
            ct[cv.n_out_act:] = 0
            sub = cv.label.startswith(("sub", "enc", "dec"))
            wt = (w.flip(0) if sub else w).transpose(1, 2).contiguous()
            x, w, ct, wt = (a.to(dev) for a in (x, w, ct, wt))
            row = []
            for kind, (f, ch, wk) in (("fwd", (x, cv.chunks, w)),
                                      ("t", (ct, cv.t_chunks, wt))):
                call = lambda: cc.chunk_conv(  # noqa: E731
                    f, ch.in_idx, ch.lidx, wk)
                if counted:
                    cc.fwd_counts(dev, reset=True)
                out = call()
                saved[f"{cv.label} {kind}"] = _digest(out + 0.0)
                txt = ""
                if counted:
                    n = cc.fwd_counts(dev)
                    txt = (f" (skipped {100 * n.skipped_share:.1f}%, order "
                           f"{100 * n.order_share:.2f}%)")
                if tc:
                    txt = _tc_row(cc, tot, f, ch, wk) or txt
                ms = event_ms(call, 3)
                tot[kind] += ms
                row.append(f"{kind} {ms:.4f} ms{txt}")
            xg, ch, dd = cs.f32_dw_operands(cv, x, ct) \
                if hasattr(cs, "f32_dw_operands") else \
                _dw_operands(cs, cv, x, ct)
            dw_call = lambda: cc.chunk_conv_dw(  # noqa: E731
                xg, ch.in_idx, ch.lidx, dd)
            saved[f"{cv.label} dw"] = _digest(dw_call())
            ms = event_ms(dw_call, 3)
            dw_tot["dw"] += ms
            txt = _dw_row(cc, dw_tot, xg, ch, dd) if dw_tc else ""
            row.append(f"dW {ms:.4f} ms{txt}")
            print(f"[f32conv] {cv.label:<22} " + " | ".join(row), flush=True)
    print(f"[f32conv] per step: forward {tot['fwd']:.3f} ms, transpose "
          f"(d_feats) {tot['t']:.3f} ms, both {tot['fwd'] + tot['t']:.3f} ms"
          f"; f32 dW on each convolution's route {dw_tot['dw']:.3f} ms")
    if dw_tc:
        print(f"[f32conv] per step, f32 dW by tile on the "
              f"{dw_tot['tc_maps']:.0f} maps the tensor-core tile fits: "
              f"FMA {dw_tot['fma']:.3f} ms, tensor cores "
              f"{dw_tot['tc']:.3f} ms; the tensor-core tile ran "
              f"{dw_tot['run'] / max(dw_tot['real'], 1):.3f}x the real "
              f"products, skipped "
              f"{dw_tot['skipped'] / max(dw_tot['ran'] + dw_tot['skipped'], 1):.1%}"
              f" of its k8 steps; its float64 error over the FMA tile's at "
              f"most {dw_tot['worst']:.2f}x (max)")
    if tc:
        print(f"[f32conv] per step, each tile on the maps the tensor-core "
              f"tile fits: FMA "
              f"{tot['fma']:.3f} ms, tensor cores {tot['tc']:.3f} ms; the "
              f"tensor-core tile ran "
              f"{tot['run'] / max(tot['real'], 1):.3f}x the real products; "
              f"its float64 error over the FMA tile's at most "
              f"{tot['worst']:.2f}x (mean or max)")
    torch.save(saved, out_path)


def _tc_row(cc, tot, f, ch, wk) -> str:
    """Where the tensor-core tile fits the map: each tile's time (the FMA
    tile's added to tot["fma"], the tensor-core tile's to tot["tc"]), the
    group-steps the tensor-core tile ran (its products into tot["run"],
    the real ones into tot["real"]) and both tiles' errors against the
    float64 product, the worst ratio into tot["worst"]; the route the
    wrapper takes; "" where the tile does not fit."""
    import torch
    _, K, M = ch.lidx.shape
    (_, U), cin, cout = ch.in_idx.shape, f.shape[1], wk.shape[2]
    smem = cc._smem_optin(f.device.index)
    nt = cc.tc_col_tile(cout, K, U, smem)
    if not nt:
        return ""
    calls = {r: (lambda r=r: cc._run_chunk_conv(
        "f32conv", f, ch.in_idx, ch.lidx, wk, route=r)) for r in ("tc", "fma")}
    ref = cc.chunk_conv_plain(f, ch.in_idx, ch.lidx, wk, torch.float64)
    scale = ref.abs().max().item()
    cc.fwd_counts(f.device, reset=True)
    outs = {r: c() for r, c in calls.items()}
    n = cc.fwd_counts(f.device, reset=True)
    errs = {r: ((o.double() - ref).abs().mean().item() / scale,
                (o.double() - ref).abs().max().item() / scale)
            for r, o in outs.items()}
    tot["worst"] = max(tot["worst"], *(
        errs["tc"][i] / max(errs["fma"][i], 1e-30) for i in (0, 1)))
    ms = {r: event_ms(c, 3) for r, c in calls.items()}
    tot["fma"] += ms["fma"]
    tot["tc"] += ms["tc"]
    tot["run"] += n.group_ran * cc.TC_GROUP_ROWS * 32 * nt
    tot["real"] += int((ch.lidx >= 0).sum()) * cin * cout
    return (f" (route {cc.f32_route(cin, cout, M, K, U, smem)}; tc "
            f"{ms['tc']:.4f} ms, FMA {ms['fma']:.4f} ms; tc ran "
            f"{n.group_ran}, skipped {n.group_skipped} group-steps; float64 "
            f"error mean/max tc {errs['tc'][0]:.2e}/{errs['tc'][1]:.2e}, FMA "
            f"{errs['fma'][0]:.2e}/{errs['fma'][1]:.2e})")


def _dw_operands(cs, cv, x, ct):
    """`chip_smoke.f32_dw_operands` for a checkout that lacks it."""
    if cs.route_of(cv, 4) == "#5":
        return x, cv.chunks, ct
    return ct, cv.t_chunks, x


def _dw_row(cc, tot, x, ch, d) -> str:
    """The weight-gradient kernel over (x gathered through ch, d dense)
    on each tile where the tensor-core one fits: each tile's time (into
    tot["fma"], tot["tc"]), the tensor-core tile's k8 steps run and
    skipped (its products into tot["run"], the real ones into
    tot["real"]) and both tiles' largest error against the float64 sum
    (the worst ratio into tot["worst"]); the route the wrapper takes."""
    import torch
    _, K, M = ch.lidx.shape
    (_, U), cx, cd = ch.in_idx.shape, x.shape[1], d.shape[1]
    smem = cc._smem_optin(x.device.index)
    route = cc.dw_route(cx, cd, K, U, smem)
    if cc.dw_tc_smem_bytes() > smem:
        return f" (route {route})"
    calls = {r: (lambda r=r: cc._run_dw(
        "f32conv", cc.chunk_conv_dw, x, ch.in_idx, ch.lidx, d, True,
        route=r)) for r in ("tc", "fma")}
    ref = cc.chunk_conv_dw_plain(x, ch.in_idx, ch.lidx, d, torch.float64)
    scale = ref.abs().max().item()
    cc.dw_counts(x.device, reset=True)
    outs = {r: c() for r, c in calls.items()}
    n = cc.dw_counts(x.device, reset=True)
    errs = {r: (o.double() - ref).abs().max().item() / scale
            for r, o in outs.items()}
    del ref, outs
    tot["worst"] = max(tot["worst"], errs["tc"] / max(errs["fma"], 1e-30))
    ms = {r: event_ms(c, 3) for r, c in calls.items()}
    tot["fma"] += ms["fma"]
    tot["tc"] += ms["tc"]
    tot["tc_maps"] += 1
    tot["ran"] += n.ran
    tot["skipped"] += n.skipped
    tot["run"] += n.ran * 8 * 64 * 64
    tot["real"] += int((ch.lidx >= 0).sum()) * cx * cd
    return (f" (route {route}; tc {ms['tc']:.4f} ms, FMA {ms['fma']:.4f} "
            f"ms; tc ran {n.ran}, skipped {n.skipped} k8 steps, staging "
            f"{n.stage_share:.1%} of its cycles; float64 error max tc "
            f"{errs['tc']:.2e}, FMA {errs['fma']:.2e})")


def _digest(*tensors, keep: bool = False):
    """(sha256 of the tensors' bytes, the tensors on the CPU if `keep`)."""
    import hashlib

    import torch
    h = hashlib.sha256()
    for t in tensors:
        t = t.detach().contiguous().cpu()
        h.update((t.view(torch.int16) if t.dtype == torch.bfloat16 else t)
                 .numpy().tobytes())
    return h.hexdigest(), ([t.cpu() for t in tensors] if keep else None)


def _diff(a, b) -> str:
    """"same bits", or how they differ."""
    if a[0] == b[0]:
        return "same bits"
    if a[1] is None:
        return "other bits"
    return "max |diff| " + ", ".join(
        f"{(x - y).abs().max().item():.3e}" for x, y in zip(a[1], b[1]))


def main(out_dir: str, roots, mode: str = "kernels") -> int:
    out_dir = os.path.abspath(out_dir)
    os.makedirs(out_dir, exist_ok=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    keep = {"kernels": SUMMARY, "smoke": SMOKE_SUMMARY,
            "focus": FOCUS_SUMMARY, "f32conv": F32CONV_SUMMARY}[mode]
    runs = list(roots) + list(roots)[::-1]
    rc = 0
    for i, root in enumerate(runs):
        if mode == "smoke":
            cmd = ["chip_smoke.py"]
        elif mode in ("focus", "f32conv"):
            cmd = [os.path.abspath(__file__), f"--run-{mode}",
                   os.path.join(out_dir, f"{mode}_{i}.pt")]
        else:
            cmd = ["-c", RUN]
        r = subprocess.run([sys.executable, *cmd], cwd=root,
                           capture_output=True, text=True)
        name = f"{'ab' if mode == 'kernels' else mode}_{i}.log"
        with open(os.path.join(out_dir, name), "w") as f:
            f.write(r.stdout + r.stderr)
        print(f"run {i} ({root}) rc={r.returncode}", flush=True)
        for line in r.stdout.splitlines():
            if line.startswith(keep):
                print("  " + line[:200], flush=True)
        if r.returncode:
            print(r.stderr[-3000:])
            rc = 1
    if mode in ("focus", "f32conv") and rc == 0:
        import torch
        outs = [torch.load(os.path.join(out_dir, f"{mode}_{i}.pt"))
                for i in range(len(runs))]
        for i, root in enumerate(runs[1:len(roots)], 1):
            diffs = [f"{k} {_diff(v, outs[i][k])}"
                     for k, v in outs[0].items()]
            if mode == "f32conv":
                same = sum(d.endswith("same bits") for d in diffs)
                diffs = [f"{same} of {len(diffs)} outputs the same bits"] \
                    + [d for d in diffs if not d.endswith("same bits")]
            print(f"[{mode}] {root} against {runs[0]}: " + "; ".join(diffs))
    return rc


if __name__ == "__main__":
    args = sys.argv[1:]
    if args[:1] == ["--run-focus"]:
        focus(args[1])
        sys.exit(0)
    if args[:1] == ["--run-f32conv"]:
        f32conv(args[1])
        sys.exit(0)
    mode = "kernels"
    if args[:1] in (["--smoke"], ["--focus"], ["--f32conv"]):
        mode, args = args[0][2:], args[1:]
    if len(args) < 2:
        raise SystemExit(__doc__)
    sys.exit(main(args[0], args[1:], mode))
