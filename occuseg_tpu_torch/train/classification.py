"""Generic whole-shape classification harness (counterpart of
`occuseg_tpu/train/classification.py`, the reference's
classificationTrainValidate): trains a model that maps (point features,
plan) to [B, classes] logits, e.g. one ending in `nn/extras.ActivePooling`
with a static `num_samples`, over batches of point clouds.

Every batch is planned on the device (`core/topology.build_plan`) before
its forward, with one host read; the loss is the mean NLL of the
log-softmax; Adam with optax's defaults (betas 0.9 / 0.999, eps 1e-8). The
history has the JAX harness's keys. It runs on the card unless the caller
asks for the CPU, and raises where there is no card.
"""

from __future__ import annotations

import logging
import time
from typing import Callable, Dict, Iterable

import torch
import torch.nn.functional as F

from occuseg_tpu_torch.core.topology import PlanSpec, build_plan

log = logging.getLogger("occuseg_tpu_torch")


def _device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("classification_train_validate: no CUDA device; "
                           "pass device='cpu' to run on the CPU")
    return dev


def classification_train_validate(model: torch.nn.Module, spec: PlanSpec,
                                  train_iter: Callable[[], Iterable],
                                  val_iter: Callable[[], Iterable],
                                  num_epochs: int = 10, lr: float = 1e-3,
                                  device="cuda") -> Dict:
    """Train `model` for `num_epochs` over `train_iter()` and validate over
    `val_iter()` after each epoch. Batches are dicts with "coords" [P, 4]
    int32, "features" [P, C] f32 and "label" [B] int. Returns {"model",
    "history"}, the history one dict per epoch with "loss" and
    "train_acc" (means over the epoch's steps) and "val_acc" (None without
    validation batches)."""
    dev = _device(device)
    model = model.to(dev)
    opt = torch.optim.Adam(model.parameters(), lr=lr, betas=(0.9, 0.999),
                           eps=1e-8)

    def inputs(b):
        coords = torch.as_tensor(b["coords"]).to(dev)
        feats = torch.as_tensor(b["features"]).to(dev)
        labels = torch.as_tensor(b["label"]).to(dev).long()
        return feats, build_plan(coords, spec), labels

    history = []
    for epoch in range(num_epochs):
        t0 = time.time()
        losses, accs = [], []
        model.train()
        for b in train_iter():
            feats, plan, labels = inputs(b)
            logits = model(feats, plan)
            logp = F.log_softmax(logits.float(), dim=-1)
            loss = -logp.gather(1, labels[:, None]).mean()
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()
            losses.append(loss.detach())
            accs.append((logits.argmax(-1) == labels).float().mean())
        model.eval()
        v_accs = []
        with torch.no_grad():
            for b in val_iter():
                feats, plan, labels = inputs(b)
                logits = model(feats, plan)
                v_accs.append((logits.argmax(-1) == labels).float().mean())
        loss_m, acc_m, val = (float(torch.stack(v).double().mean()) if v
                              else None for v in (losses, accs, v_accs))
        log.info("epoch %d: loss %s train acc %s val acc %s (%.1fs)",
                 epoch, loss_m, acc_m, val, time.time() - t0)
        history.append({"loss": loss_m, "train_acc": acc_m, "val_acc": val})
    return {"model": model, "history": history}
