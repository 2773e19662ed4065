"""Single-device training step (counterpart of `occuseg_tpu/train/state.py`).

    batch, plan = prepare_batch(make_batch(...), PlanSpec(caps))   # host
    trainer = Trainer(LearningBWDenseUNet(n_planes, compute_dtype=bf16))
    parts = trainer.step(batch, plan)   # dict of 0-d tensors on the card

`prepare_batch` builds the host plan (C++ planner, chunk rulebooks, sorted
point layout) and permutes every per-point array of the batch into the
layout, as the benchmark prepares a scene. `Trainer.step` moves both to the
device, runs the forward in train mode (batch statistics, running
statistics updated in place), the 6-term loss, the backward through the
chunk-conv kernels, and one optimizer update. The entry point runs on
"cuda" unless the caller passes another device.

Not ported yet: gradient accumulation (`accum_steps`), the data-parallel
loss weight `_w` and the `axis_name` reductions. `optax.flatten` needs no
counterpart: it only fuses the elementwise update on the TPU.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch

from occuseg_tpu_torch.core.point_layout import apply_point_layout
from occuseg_tpu_torch.core.topology import PlanSpec, Topology
from occuseg_tpu_torch.infer import plan_scene
from occuseg_tpu_torch.losses.instance import LossConfig, occuseg_total_loss

# the batch arrays the forward and the loss read
_BATCH_KEYS = ("features", "labels", "instance_id", "point_scene", "pose",
               "offsets", "displacements", "occupancy")


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Reference hyperparameters: Adam lr 1e-3, gamma 1e-2 every 200
    epochs."""

    lr: float = 1e-3
    lr_decay_gamma: float = 1e-2
    lr_decay_steps: int = 200 * 240  # 200 epochs * ~240 steps/epoch
    optimizer: str = "adam"
    momentum: float = 0.9
    weight_decay: float = 1e-4


def make_optimizer(params, cfg: TrainConfig = TrainConfig()):
    """(optimizer, scheduler) with the reference's staircase decay: update
    number `count` (0 for the first) uses lr * gamma ** (count //
    lr_decay_steps), as optax's `exponential_decay(staircase=True)` counts
    updates. Call `scheduler.step()` after each `optimizer.step()`.

    Adam uses optax's defaults (betas 0.9 / 0.999, eps 1e-8 outside the
    square root). SGD adds the decayed weights to the gradient before the
    momentum trace, as `optax.chain(add_decayed_weights, sgd)` does."""
    if cfg.optimizer == "adam":
        opt = torch.optim.Adam(params, lr=cfg.lr, betas=(0.9, 0.999),
                               eps=1e-8)
    elif cfg.optimizer == "sgd":
        opt = torch.optim.SGD(params, lr=cfg.lr, momentum=cfg.momentum,
                              weight_decay=cfg.weight_decay)
    else:
        raise ValueError(cfg.optimizer)
    gamma, steps = cfg.lr_decay_gamma, cfg.lr_decay_steps
    sched = torch.optim.lr_scheduler.LambdaLR(
        opt, lambda count: gamma ** (count // steps))
    return opt, sched


def prepare_batch(batch: Dict[str, np.ndarray], spec: PlanSpec
                  ) -> Tuple[Dict[str, np.ndarray], Topology]:
    """Host preparation of a one-scene training batch (`make_batch`
    schema): (the batch with every per-point array in the plan's point
    layout, the host plan)."""
    plan = plan_scene(batch["coords"], spec)
    return apply_point_layout(batch, plan, num_scenes=1), plan


class Trainer:
    """Trains an OccuSeg model (with bw and occupancy heads) on one
    device. The optimizer's gradients stay on the parameters after each
    step until the next one."""

    def __init__(self, model: torch.nn.Module, device="cuda",
                 cfg: TrainConfig = TrainConfig(),
                 loss_cfg: LossConfig = LossConfig(),
                 num_instances: int = 64):
        self.device = torch.device(device)
        self.model = model.to(self.device).train()
        self.optimizer, self.scheduler = make_optimizer(
            self.model.parameters(), cfg)
        self.loss_cfg = loss_cfg
        self.num_instances = num_instances

    def step(self, batch: Dict[str, np.ndarray], plan: Topology
             ) -> Dict[str, torch.Tensor]:
        """One update from a prepared batch and its host plan; returns the
        loss parts (and "total") as detached 0-d tensors on the device."""
        plan = plan.to(self.device)
        b = {k: torch.as_tensor(batch[k]).to(self.device)
             for k in _BATCH_KEYS}
        self.model.train()
        out = self.model(b["features"], plan)
        total, parts = occuseg_total_loss(out, b, 1, self.num_instances,
                                          self.loss_cfg)
        self.optimizer.zero_grad(set_to_none=True)
        total.backward()
        self.optimizer.step()
        self.scheduler.step()
        return {k: v.detach() for k, v in parts.items()}
