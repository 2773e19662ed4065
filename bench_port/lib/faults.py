"""Faults planted under the timed path, to show that `correct` catches
them (the benchmark's tests, and `run.py --fault <name>` on the chip).

Training: "unchanged" (the optimizer leaves the parameters as they
were), "half" (the scenes of the second half of each batch are left out
of the loss, which is then the mean over the rest), "answer" (one
leaf's update is applied twice).
"""

from __future__ import annotations

import torch

TRAIN = ("unchanged", "half", "answer")


def plant_train(trainer, name: str) -> None:
    if name not in TRAIN:
        raise ValueError(f"unknown training fault {name!r}")
    if name == "unchanged":
        trainer.optimizer.step = lambda *a, **k: None
    elif name == "answer":
        opt_step = trainer.optimizer.step
        leaf = next(iter(trainer.model.parameters()))

        def twice(*a, **k):
            before = leaf.detach().clone()
            out = opt_step(*a, **k)
            with torch.no_grad():
                leaf.add_(leaf - before)
            return out
        trainer.optimizer.step = twice
    else:
        step = trainer.step

        def half(batch, plan=None, **k):
            b = dict(batch)
            ps = torch.as_tensor(b["point_scene"])
            drop = ps >= (trainer.num_scenes + 1) // 2
            for key in ("labels", "instance_id"):
                t = torch.as_tensor(b[key]).clone()
                t[drop] = -1
                b[key] = t
            return step(b, plan, **k)
        trainer.step = half
