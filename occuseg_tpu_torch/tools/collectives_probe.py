"""Which collectives a `torch.distributed` backend takes on a device's
tensors.

    python -m occuseg_tpu_torch.tools.collectives_probe \
        [--device cuda:0] [--backend gloo]

Each collective runs once in its own pair of spawned ranks on the device
(`parallel/data_parallel.spawn`): a backend that cannot move a tensor may
abort its process rather than raise (gloo's TCP transport does, writing
from a CUDA pointer), and a pair of its own keeps that from ending the
probe. Prints one JSON line, {collective: "ok" or what failed}. The
spatial exchanges (`parallel/comm.py`) use all-reduces alone, which every
backend takes on every device.
"""

from __future__ import annotations

import argparse
import json

import torch
import torch.distributed as dist

from occuseg_tpu_torch.parallel import data_parallel


def _run(name: str, rank: int, dev) -> None:
    x = torch.arange(4.0, device=dev) + rank
    if name == "all_reduce":
        dist.all_reduce(x)
    elif name == "all_reduce_max":
        dist.all_reduce(x, op=dist.ReduceOp.MAX)
    elif name == "broadcast":
        dist.broadcast(x, 0)
    elif name == "all_gather":
        dist.all_gather([torch.empty_like(x) for _ in range(2)], x)
    elif name == "all_gather_into_tensor":
        dist.all_gather_into_tensor(torch.empty(8, device=dev), x)
    elif name == "all_to_all_single":
        dist.all_to_all_single(torch.empty_like(x), x)
    elif name == "reduce_scatter_tensor":
        dist.reduce_scatter_tensor(torch.empty(2, device=dev), x)
    elif name == "send_recv":
        if rank == 0:
            dist.send(x, 1)
        else:
            dist.recv(torch.empty_like(x), 0)
    else:
        raise ValueError(name)
    if x.is_cuda:
        torch.cuda.synchronize(x.device)


def _rank(rank: int, world: int, name: str, device) -> str:
    _run(name, rank, data_parallel.rank_device(device, rank))
    return "ok"


COLLECTIVES = ("all_reduce", "all_reduce_max", "broadcast", "all_gather",
               "all_gather_into_tensor", "all_to_all_single",
               "reduce_scatter_tensor", "send_recv")


def probe(device="cuda:0", backend: str = "gloo") -> dict:
    """{collective: "ok" or the failure} over two ranks on `device`."""
    out = {}
    for name in COLLECTIVES:
        try:
            data_parallel.spawn(_rank, 2, device, name, device,
                                backend=backend)
            out[name] = "ok"
        except Exception as e:  # the failure is the finding
            lines = [ln for ln in str(e).strip().splitlines() if ln.strip()]
            out[name] = f"{type(e).__name__}: {lines[-1][:160] if lines else ''}"
    return out


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda:0")
    p.add_argument("--backend", default="gloo")
    args = p.parse_args(argv)
    print(json.dumps({"device": args.device, "backend": args.backend,
                      "collectives": probe(args.device, args.backend)}))


if __name__ == "__main__":
    main()
