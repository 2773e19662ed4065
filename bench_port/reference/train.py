"""The reference's training steps: the model of `model.py` from the seeded
weights, the loss of `loss.py`, and Adam (lr from the configuration,
betas 0.9 and 0.999, eps 1e-8), one update a step, over the real points
of each batch. Float32 with TF32 off, or with `tf32` on (the control)."""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

from bench_port.reference import loss as ref_loss
from bench_port.reference import model as ref_model
from bench_port.reference import sparse

KEYS = ("labels", "instance_id", "point_scene", "pose", "offsets",
        "displacements", "occupancy")


def _real(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    n = int((batch["coords"][:, 0] >= 0).sum())
    return {k: torch.as_tensor(np.ascontiguousarray(batch[k][:n])).to(device)
            for k in KEYS + ("coords", "features")}


def _leave_out_half(b: Dict[str, torch.Tensor], num_scenes: int) -> None:
    """The "half" fault: the second half of the scenes out of the loss."""
    drop = b["point_scene"] >= (num_scenes + 1) // 2
    for k in ("labels", "instance_id"):
        b[k] = torch.where(drop, -1, b[k])


def run(cfg: Dict, seed: int, batches: Sequence[Dict[str, np.ndarray]],
        num_scenes: int, num_instances: int, lr: float, device,
        tf32: bool = False, fault: str = None) -> Dict:
    """{losses: [total of each step], grads: {leaf: norm of its first
    gradient}, change: {leaf or BN statistic: norm of its change over the
    steps}, change1: {BN statistic: norm of its change in the first
    step}}. `fault` plants one of `lib/faults.py`'s training faults in
    the reference ("half", "answer": the first leaf's update twice)."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        init = ref_model.make_weights(cfg, seed, device)
        params = {n: t.clone() for n, t in init.items()}
        leaves = [n for n in params
                  if not n.endswith(("running_mean", "running_var"))]
        for n in leaves:
            params[n].requires_grad_(True)
        opt = torch.optim.Adam([params[n] for n in leaves], lr=lr,
                               betas=(0.9, 0.999), eps=1e-8, foreach=False)
        losses: List[float] = []
        grads: Dict[str, float] = {}
        for i, batch in enumerate(batches):
            b = _real(batch, device)
            if fault == "half":
                _leave_out_half(b, num_scenes)
            geo = sparse.build(b["coords"], len(cfg["planes"]))
            out = ref_model.Net(cfg, params, geo, train=True)(b["features"])
            total, _ = ref_loss.total_loss(out, b, num_scenes, num_instances)
            opt.zero_grad(set_to_none=True)
            total.backward()
            if i == 0:
                grads = {n: float(params[n].grad.double().norm())
                         for n in leaves}
                change1 = {n: float((params[n].detach() - init[n])
                                    .double().norm())
                           for n in params if n not in leaves}
            first = params[leaves[0]].detach().clone()
            opt.step()
            if fault == "answer":
                with torch.no_grad():
                    params[leaves[0]].add_(params[leaves[0]] - first)
            losses.append(float(total.detach()))
            del b, geo, out, total
        with torch.no_grad():
            change = {n: float((params[n].detach() - init[n]).double().norm())
                      for n in params}
        return {"losses": losses, "grads": grads, "change": change,
                "change1": change1}
    finally:
        torch.backends.cuda.matmul.allow_tf32, \
            torch.backends.cudnn.allow_tf32 = saved
