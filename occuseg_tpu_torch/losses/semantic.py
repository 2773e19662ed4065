"""Alternative semantic losses: Lovasz-softmax, focal, weighted CE
(counterpart of `occuseg_tpu/losses/semantic.py`, selected by
`LossConfig.semantic_loss`), and the training loss of a semantic-only
model (`semantic_step_loss`). Points with a negative label are ignored.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from occuseg_tpu_torch.ops import acc

# Per-class CE weight tables for weighted_cross_entropy, by dataset.
SCANNET_CE_WEIGHTS = (
    0.3005, 0.2700, 0.0418, 0.0275, 0.0810, 0.0254, 0.0462, 0.0418,
    0.0297, 0.0277, 0.0061, 0.0065, 0.0194, 0.0150, 0.0060, 0.0036,
    0.0029, 0.0025, 0.0029, 0.0434)
STANFORD_CE_WEIGHTS = (
    0.1861, 0.1586, 0.2663, 0.0199, 0.0039, 0.0210, 0.0210, 0.0575,
    0.0332, 0.0458, 0.0052, 0.0495, 0.0123, 0.1164, 0.0032)


def lovasz_grad(gt_sorted: torch.Tensor) -> torch.Tensor:
    """Gradient of the Lovasz extension w.r.t. sorted errors."""
    gts = gt_sorted.sum()
    intersection = gts - torch.cumsum(gt_sorted, 0)
    union = gts + torch.cumsum(1.0 - gt_sorted, 0)
    jaccard = 1.0 - intersection / torch.clamp(union, min=1e-12)
    return torch.cat([jaccard[:1], jaccard[1:] - jaccard[:-1]])


def lovasz_softmax_flat(probas: torch.Tensor, labels: torch.Tensor,
                        valid: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """Multi-class Lovasz-softmax over flattened points; classes absent
    from the labels are weighted out (the shape stays static)."""
    P, C = probas.shape
    if valid is None:
        valid = labels >= 0
    labels_safe = torch.where(valid, labels, 0)
    n_valid = valid.sum()
    mask_sorted = torch.arange(P, device=probas.device) < n_valid
    losses, present = [], []
    for c in range(C):
        fg = ((labels_safe == c) & valid).float()
        errors = torch.where(valid, (fg - probas[:, c]).abs(),
                             torch.full_like(fg, -1.0))  # padding last
        order = torch.argsort(-errors, stable=True)
        grad = lovasz_grad(fg[order])
        losses.append(torch.where(mask_sorted,
                                  torch.clamp(errors[order], min=0) * grad,
                                  torch.zeros_like(grad)).sum())
        present.append((fg.sum() > 0).float())
    losses, present = torch.stack(losses), torch.stack(present)
    return (losses * present).sum() / torch.clamp(present.sum(), min=1)


def lovasz_softmax(logits: torch.Tensor, labels: torch.Tensor
                   ) -> torch.Tensor:
    return lovasz_softmax_flat(torch.softmax(logits, dim=-1), labels)


def _ce_per_point(logits: torch.Tensor, labels: torch.Tensor):
    valid = labels >= 0
    safe = torch.where(valid, labels, 0).long()
    logp = F.log_softmax(acc(logits), dim=-1)
    return -logp.gather(1, safe[:, None])[:, 0], valid, safe


def focal_loss(logits: torch.Tensor, labels: torch.Tensor,
               gamma: float = 2.0, alpha: float = 0.25) -> torch.Tensor:
    ce, valid, _ = _ce_per_point(logits, labels)
    pt = torch.exp(-ce)
    loss = torch.where(valid, alpha * (1 - pt) ** gamma * ce,
                       torch.zeros_like(ce))
    return loss.sum() / torch.clamp(valid.float().sum(), min=1)


def weighted_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                           weight: torch.Tensor) -> torch.Tensor:
    """Per-class weighted CE: sum(w_y * ce) / sum(w_y) over valid points."""
    ce, valid, safe = _ce_per_point(logits, labels)
    w = weight[safe] * valid.float()
    return (ce * w).sum() / torch.clamp(w.sum(), min=1e-12)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Plain CE, the mean over the points with a label >= 0."""
    ce, valid, _ = _ce_per_point(logits, labels)
    return (torch.where(valid, ce, torch.zeros((), dtype=ce.dtype,
                                               device=ce.device)).sum()
            / torch.clamp(valid.sum(), min=1))


def semantic_step_loss(outputs, batch: Dict[str, torch.Tensor]
                       ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(total, parts) of a semantic-only model's step (`Trainer.step` for
    a model with `semantic_only`, MinkUNet): the plain `cross_entropy` of
    the per-point logits `outputs.semantics` over batch["labels"]."""
    sem = cross_entropy(outputs.semantics, batch["labels"])
    return sem, {"semantic_loss": sem, "total": sem}
