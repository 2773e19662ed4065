"""One run of one cell of the benchmark of `occuseg_tpu_torch`.

    python3 bench_port/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

The cell is looked up by name in `BENCHMARK.json`; its parameters are in
`bench_port/cells/<name>.json`, its configuration in
`bench_port/configs/<config>.json`, and the driver of its kind of traffic
in `bench_port/traffic/<kind>.py`. The run sets up (the seeded scenes and
weights, warm-up), measures for `--seconds`, then checks what the timed
path produced against the plain reference (`bench_port/reference/`), and
prints one JSON line last on standard output: `correct`, `attempted`,
`failed`, `metrics` (the cell's end-to-end metrics, or with `--trace 1`
its per-layer metrics, each read by `bench_port/metrics/<name>.py`),
`device`, with `--trace 1` `breakdown`, and last `checks`: each number
compared with its limit, which also end standard error.

`--control 1` adds the readings of the control (the reference computed in
TF32 in the program's place) and `--fault <name>` breaks the timed path
(`bench_port/lib/faults.py`); the benchmark's own runs use neither.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import dataclasses  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from typing import Dict, Optional, Sequence  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.join(ROOT, "bench_port")
CACHE = os.path.join(ROOT, ".bench_cache")
FORBIDDEN = ("jax", "jaxlib", "flax", "occuseg_tpu")


def _caches() -> None:
    """Every build and kernel cache at a fixed path inside the checkout
    (the program's own libraries build into occuseg_tpu_torch/build/)."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = os.path.join(CACHE, sub)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one of FORBIDDEN."""
    return sorted({m for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


def _load(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _read(path: str) -> Dict:
    with open(path) as f:
        return json.load(f)


def kernel_groups() -> Dict[str, list]:
    d = os.path.join(HERE, "kernels")
    return {f[:-5]: _read(os.path.join(d, f))["match"]
            for f in sorted(os.listdir(d)) if f.endswith(".json")}


def _sync(device) -> None:
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@dataclasses.dataclass
class Run:
    """What a traffic driver is handed: the cell, its configuration, the
    run's options, the spans, and the measured window."""
    workload: str
    cell: Dict
    conf: Dict
    seed: int
    seconds: float
    trace: bool
    device: object
    control: bool = False
    fault: Optional[str] = None
    t0: float = T_START

    def __post_init__(self):
        from bench_port.lib.trace import Spans, Trace
        self.spans = Spans()
        self.tracer = Trace() if self.trace else None
        self.summary = None
        self.peaks = _read(os.path.join(HERE, "peaks.json"))

    @contextlib.contextmanager
    def window(self):
        """The measured window: spans restart, and with --trace 1 the
        profiler records from its start to the end of the device's work."""
        import torch
        from bench_port.lib.trace import WINDOW
        _sync(self.device)
        self.spans.durations.clear()
        if self.tracer is not None:
            self.tracer.start()
            self.spans.traced = True
        try:
            with (torch.profiler.record_function(WINDOW) if self.trace
                  else contextlib.nullcontext()):
                yield
                _sync(self.device)
        finally:
            if self.tracer is not None:
                self.tracer.stop()
                self.spans.traced = False

    def trace_summary(self) -> Optional[Dict]:
        if self.tracer is None:
            return None
        if self.summary is None:
            path = os.path.join(CACHE, "traces",
                                f"{self.workload}.seed{self.seed}.json.gz")
            self.summary = self.tracer.summary(kernel_groups(), path)
        return self.summary


def _applies(metric: Dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def main(argv: Optional[Sequence[str]] = None, check_device: bool = True,
         device: Optional[str] = None, overrides: Optional[Dict] = None
         ) -> int:
    """One run; returns the exit code. Tests pass check_device=False, a
    device and `overrides` ({"cell": {...}, "config": {...}} merged over
    the files) to drive a run at a small size on the CPU."""
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", type=int, choices=(0, 1), default=0)
    p.add_argument("--fault", default=None)
    args = p.parse_args(argv)
    _caches()
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    bench = _read(os.path.join(ROOT, "BENCHMARK.json"))
    wl = [w for w in bench["workloads"] if w["name"] == args.workload]
    if not wl:
        print(f"no workload {args.workload!r} in BENCHMARK.json",
              file=sys.stderr)
        return 2
    wl = wl[0]
    cell = _read(os.path.join(HERE, "cells", f"{wl['name']}.json"))
    conf = _read(os.path.join(HERE, "configs", f"{wl['config']}.json"))
    for part, d in (("cell", cell), ("config", conf)):
        d.update((overrides or {}).get(part, {}))
    import torch
    if check_device and (not torch.cuda.is_available()
                         or torch.cuda.device_count() < wl["chips"]):
        print(f"{args.workload} needs {wl['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 3
    dev = torch.device(device or "cuda")
    # the configuration states float32: no TF32 anywhere on the timed path
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    run = Run(wl["name"], cell, conf, args.seed, args.seconds,
              bool(args.trace), dev, bool(args.control), args.fault)
    traffic = importlib.import_module(f"bench_port.traffic.{cell['kind']}")
    res = traffic.run(run)
    bad = forbidden_modules()
    if bad:
        print("loaded after the window: " + ", ".join(bad), file=sys.stderr)
        return 4
    metrics = {}
    if not args.trace:
        for m in bench["end_to_end"]:
            if _applies(m, wl["name"]):
                metrics[m["name"]] = {"value": res["end_to_end"][m["name"]],
                                      "unit": m["unit"]}
    else:
        ctx = dict(res["layer"], trace=run.trace_summary(), peaks=run.peaks)
        for m in bench["per_layer"]:
            if not _applies(m, wl["name"]):
                continue
            reader = _load(os.path.join(HERE, "metrics", f"{m['name']}.py"),
                           "bench_metric_" + m["name"].replace(".", "_"))
            v = reader.read(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": (torch.cuda.get_device_name(dev)
                            if dev.type == "cuda" else "cpu"),
                   "count": wl["chips"],
                   "memory_peak_bytes": res["memory_peak_bytes"]}
    out = {"correct": res["correct"], "attempted": res["attempted"],
           "failed": res["failed"], "metrics": metrics,
           "device": device_info}
    if args.trace:
        s = run.trace_summary()
        device_info.update(busy_s=s["busy_s"], window_s=s["window_s"])
        out["breakdown"] = {"device_ops": s["device_ops"],
                            "idle_gaps": s["idle_gaps"]}
    for k in ("control", "info"):
        if k in res:
            out[k] = res[k]
    out["checks"] = res["checks"]
    for name, v, limit in res["checks"]:
        print(f"check {name} {v!r} limit {limit!r}", file=sys.stderr)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
