"""The reference's data-parallel training steps: a step of n ranks is the
model of `model.py` from the seeded weights over each rank's batch alone
(each with its own BN batch statistics, from the same running statistics
before the step), the loss of `loss.py` on each, the mean of the n
gradients, and one Adam update (lr from the configuration, betas 0.9 and
0.999, eps 1e-8); the running statistics after the step are the mean of
the n ranks' updated ones, and the step's loss the mean of theirs. Float32
with TF32 off, or on (`tf32`, the control)."""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

from bench_port.reference import loss as ref_loss
from bench_port.reference import model as ref_model
from bench_port.reference import sparse
from bench_port.reference.train import _leave_out_half, _real

STATS = ("running_mean", "running_var")


def run(cfg: Dict, seed: int, steps: Sequence[Sequence[Dict[str, np.ndarray]]],
        num_scenes: int, num_instances: int, lr: float, device,
        tf32: bool = False, fault: str = None) -> Dict:
    """{losses, grads, change, change1} as `train.run` gives them, over
    `steps`, each a sequence of the ranks' batches (rank order). `fault`
    plants "half" (each rank's batch) or "answer" (the first leaf's update
    twice)."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        init = ref_model.make_weights(cfg, seed, device)
        params = {n: t.clone() for n, t in init.items()}
        stats = [n for n in params if n.endswith(STATS)]
        leaves = [n for n in params if n not in stats]
        for n in leaves:
            params[n].requires_grad_(True)
        opt = torch.optim.Adam([params[n] for n in leaves], lr=lr,
                               betas=(0.9, 0.999), eps=1e-8, foreach=False)
        losses: List[float] = []
        grads: Dict[str, float] = {}
        change1: Dict[str, float] = {}
        for i, batches in enumerate(steps):
            opt.zero_grad(set_to_none=True)
            n_ranks = len(batches)
            after = {n: torch.zeros_like(params[n]) for n in stats}
            total_sum = 0.0
            for batch in batches:
                b = _real(batch, device)
                if fault == "half":
                    _leave_out_half(b, num_scenes)
                local = dict(params)
                for n in stats:
                    local[n] = params[n].clone()
                geo = sparse.build(b["coords"], len(cfg["planes"]))
                out = ref_model.Net(cfg, local, geo, train=True)(
                    b["features"])
                total, _ = ref_loss.total_loss(out, b, num_scenes,
                                               num_instances)
                (total / n_ranks).backward()
                total_sum += float(total.detach())
                for n in stats:
                    after[n] += local[n] / n_ranks
                del b, geo, out, total, local
            with torch.no_grad():
                for n in stats:
                    params[n].copy_(after[n])
            if i == 0:
                grads = {n: float(params[n].grad.double().norm())
                         for n in leaves}
                change1 = {n: float((params[n] - init[n]).double().norm())
                           for n in stats}
            first = params[leaves[0]].detach().clone()
            opt.step()
            if fault == "answer":
                with torch.no_grad():
                    params[leaves[0]].add_(params[leaves[0]] - first)
            losses.append(total_sum / n_ranks)
        with torch.no_grad():
            change = {n: float((params[n].detach() - init[n]).double().norm())
                      for n in params}
        return {"losses": losses, "grads": grads, "change": change,
                "change1": change1}
    finally:
        torch.backends.cuda.matmul.allow_tf32, \
            torch.backends.cudnn.allow_tf32 = saved
