"""Single-device training step (counterpart of `occuseg_tpu/train/state.py`).

    batch, plan = prepare_batch(make_batch(...), PlanSpec(caps), ns)  # host
    trainer = Trainer(LearningBWDenseUNet(n_planes, compute_dtype=bf16),
                      num_scenes=ns)
    parts = trainer.step(batch, plan)   # dict of 0-d tensors on the card

`prepare_batch` builds the host plan (C++ planner, chunk rulebooks, sorted
point layout; the blocked layout of `native/blocked.py` for ns > 1 scenes)
and permutes every per-point array of the batch into the layout.
`Trainer.step` moves both to the device (or, given no plan, plans the raw
batch on the device, `Trainer(spec=...)`), runs the forward in train mode
(batch statistics, running statistics updated in place), the 6-term loss,
the backward through the convolution kernels, and one optimizer update, or,
with `accum_steps` = N > 1, `optax.MultiSteps`' semantics: the gradients
of N calls are averaged and the update is applied on the N-th (the BN
statistics update on every call). `Trainer.evaluate` is the eval step: the
eval-mode forward. The entry points run on "cuda" unless the caller passes
another device.

    trainer = Trainer(model, spec=PlanSpec(caps))
    parts = trainer.step(make_batch(...))   # plan=None: planned on the card

With no plan, as the JAX steps' in-graph fallback, `step` and `evaluate`
take a raw `make_batch` batch (original point order, no point layout) and
build its plan on the device (`core/topology.build_plan`, with the batch's
normals under `use_normals`): no chunk rulebook, so every convolution runs
the gather path.

A data-parallel rank (`parallel/data_parallel.py`) passes its loss
weight and process group to `step`: the gradients of weight * L, the loss
parts and the BN running statistics are then averaged over the group's
ranks with the weights (one all-reduce, the JAX step's `axis_name`
reductions) before the update. `optax.flatten` needs no counterpart: it
only fuses the elementwise update on the TPU.

A rank of a spatially sharded step (`parallel/spatial_model.py`, the JAX
package's `make_spatial_train_step`) passes its `shard_args` instead of a
plan: the step takes the rank's rows of the global batch, runs the
forward over its slice of the sharded plan and the loss over the plan's
process group, and averages the gradients over the group (each rank's
backward runs the same replicated loss: `parallel/comm.py`) before every
rank takes the same update.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from occuseg_tpu_torch.core.point_layout import apply_point_layout
from occuseg_tpu_torch.core.topology import PlanSpec, Topology, build_plan, pin
from occuseg_tpu_torch.infer import Predictor, plan_scene
from occuseg_tpu_torch.losses.instance import LossConfig, occuseg_total_loss
from occuseg_tpu_torch.models.occuseg import OccuSegOutputs
from occuseg_tpu_torch.parallel import data_parallel

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
    # gradient accumulation: average the gradients of N calls and update
    # on the N-th (optax.MultiSteps)
    accum_steps: int = 1


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


def prepare_batch(batch: Dict[str, np.ndarray], spec: PlanSpec,
                  ns: int = 1, chunks: bool = True
                  ) -> Tuple[Dict[str, np.ndarray], Topology]:
    """Host preparation of a training batch of `ns` scenes (`make_batch`
    schema): (the batch with every per-point array in the plan's point
    layout, pad slots of point_scene set to ns; the host plan, blocked for
    ns > 1, with orientation classes from batch["normals"] when the spec
    has `guide_levels`, and chunk rulebooks with `chunks`)."""
    normals = batch["normals"] if spec.guide_levels is not None else None
    plan = plan_scene(batch["coords"], spec, ns, normals, chunks)
    return apply_point_layout(batch, plan, num_scenes=ns), plan


def pinned(batch: Dict[str, np.ndarray], plan: Topology
           ) -> Tuple[Dict[str, object], Topology]:
    """A prepared batch with what `Trainer.step` uploads as CPU tensors in
    page-locked host memory (`core.topology.pin`; loader threads call it
    when training on a card)."""
    return ({k: pin(v) if k in _BATCH_KEYS else v for k, v in batch.items()},
            plan.pinned())


class Trainer:
    """Trains an OccuSeg model (with bw and occupancy heads) on one
    device. The optimizer's gradients stay on the parameters after each
    update until the next cycle starts. `spec` is the plan a call without
    one builds on the device, with the batch's "normals" under
    `use_normals`."""

    def __init__(self, model: torch.nn.Module, device="cuda",
                 cfg: TrainConfig = TrainConfig(),
                 loss_cfg: LossConfig = LossConfig(),
                 num_instances: int = 64, num_scenes: int = 1,
                 spec: Optional[PlanSpec] = None, use_normals: bool = False):
        self.spec, self.use_normals = spec, use_normals
        self.device = torch.device(device)
        self.model = model.to(self.device).train()
        self.optimizer, self.scheduler = make_optimizer(
            self.model.parameters(), cfg)
        self.loss_cfg = loss_cfg
        self.num_instances = num_instances
        self.num_scenes = num_scenes
        self.accum_steps = max(int(cfg.accum_steps), 1)
        self.steps = 0   # calls of `step`, as the JAX TrainState.step

    def _upload(self, a) -> torch.Tensor:
        return torch.as_tensor(a).to(self.device, non_blocking=True)

    def plan(self, batch: Dict[str, np.ndarray]) -> Topology:
        """The plan of a raw batch, built on the device from its coords
        (and its normals under `use_normals`) at `spec`."""
        if self.spec is None:
            raise ValueError("Trainer: a call without a plan needs "
                             "Trainer(spec=...)")
        normals = self._upload(batch["normals"]) if self.use_normals \
            else None
        return build_plan(self._upload(batch["coords"]), self.spec, normals)

    def _inputs(self, batch, plan):
        plan = self.plan(batch) if plan is None else plan.to(self.device)
        b = {k: self._upload(batch[k]) for k in _BATCH_KEYS}
        return b, plan

    def step(self, batch: Dict[str, np.ndarray],
             plan: Optional[Topology] = None, weight: Optional[float] = None,
             group=None, shard_args=None) -> Dict[str, torch.Tensor]:
        """One call from a prepared batch and its host plan, or from a raw
        batch planned on the device (plan None); returns the loss parts
        (and "total") as detached 0-d tensors on the device. With
        `weight`, a data-parallel rank's step over process group `group`
        (None: the default group): the returned parts are the group's
        weighted means. A rank of a group of several needs its weight.
        With `shard_args` (`parallel/spatial_model.prepare_shard_args` of
        the batch's host plan, this rank's), a rank's step of a spatially
        sharded batch (`batch` the whole batch; `plan` is not read)."""
        loss_group = None
        if shard_args is not None:
            from occuseg_tpu_torch.parallel.spatial_model import (
                shard_points,
            )
            b = shard_points(batch, shard_args, self.device)
            plan = shard_args.plan.to(self.device)
            weight, group = 1.0, plan.group
            loss_group = group
        elif weight is None and dist.is_initialized() \
                and dist.get_world_size(group) > 1:
            raise ValueError("Trainer.step: a data-parallel rank's step "
                             "needs its loss weight")
        else:
            b, plan = self._inputs(batch, plan)
        self.model.train()
        out = self.model(b["features"], plan)
        total, parts = occuseg_total_loss(out, b, self.num_scenes,
                                          self.num_instances, self.loss_cfg,
                                          group=loss_group)
        micro = self.steps % self.accum_steps
        if micro == 0:
            self.optimizer.zero_grad(set_to_none=True)
        if weight is None:
            total.backward()
        else:
            parts = self._reduced_backward(total, parts, weight, group)
        if micro == self.accum_steps - 1:
            if self.accum_steps > 1:
                for p in self.model.parameters():
                    if p.grad is not None:
                        p.grad.div_(self.accum_steps)
            self.optimizer.step()
            self.scheduler.step()
        self.steps += 1
        return {k: v.detach() for k, v in parts.items()}

    def _reduced_backward(self, total, parts, weight, group):
        """The gradients of weight * total, averaged with the loss parts
        and the BN statistics over the group's ranks, added to the
        parameters' gradients; returns the averaged parts."""
        params = list(self.model.parameters())
        grads = torch.autograd.grad(total * weight, params,
                                    allow_unused=True)
        grads, parts = data_parallel.allreduce_step(
            list(grads), {k: v.detach() for k, v in parts.items()},
            data_parallel.bn_statistics(self.model), weight, group)
        for p, g in zip(params, grads):
            if g is not None:
                p.grad = g if p.grad is None else p.grad + g
        return parts

    def evaluate(self, batch: Dict[str, np.ndarray],
                 plan: Optional[Topology] = None) -> OccuSegOutputs:
        """The eval step: `Predictor.forward` (running statistics), outputs
        in the plan's point-layout order (a raw batch planned on the
        device: its own order)."""
        if plan is None:
            plan = self.plan(batch)
        try:
            return Predictor(self.model, self.device).forward(
                batch["features"], plan)
        finally:
            self.model.train()

    def state_dict(self) -> Dict:
        """Model (parameters and BN statistics), optimizer, schedule and
        step counter."""
        return {"model": self.model.state_dict(),
                "optimizer": self.optimizer.state_dict(),
                "scheduler": self.scheduler.state_dict(),
                "steps": self.steps}

    def load_state_dict(self, state: Dict) -> None:
        self.model.load_state_dict(state["model"])
        self.optimizer.load_state_dict(state["optimizer"])
        self.scheduler.load_state_dict(state["scheduler"])
        self.steps = int(state["steps"])
