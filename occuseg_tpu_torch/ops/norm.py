"""Masked batch normalization with fused (leaky) ReLU (counterpart of
`occuseg_tpu/ops/norm.py`).

Reference semantics: statistics over the active rows only, in f32 whatever
the feature dtype; eps 1e-4 inside the square root; the affine is applied
in the feature dtype; activation y > 0 ? y : leakiness * y (0 = ReLU,
1 = identity); rows that are not active (`core/sparse_tensor.active_mask`,
for one scene or the blocked multi-scene layout) come out exactly zero,
and the statistics run over the active rows of every scene. In
training mode the biased batch variance normalises and the unbiased one
enters the running variance, and momentum is a DECAY:
r = momentum * r + (1 - momentum) * batch, the opposite of
`torch.nn.BatchNorm`'s convention.
"""

from __future__ import annotations

import torch

from occuseg_tpu_torch.core.sparse_tensor import (
    NumActive,
    active_mask,
    total_active,
)
from occuseg_tpu_torch.ops import acc


def _affine(feats: torch.Tensor, num_active: NumActive, mean: torch.Tensor,
            inv_std: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
            leakiness: float) -> torch.Tensor:
    w = inv_std * acc(scale)
    b = acc(bias) - mean * w
    dt = feats.dtype
    y = feats * w.to(dt) + b.to(dt)
    if leakiness != 1.0:
        # a device fill, not a host scalar copied over (which would make
        # the host wait for the card)
        y = torch.where(y > 0, y,
                        torch.full((), leakiness, dtype=dt,
                                   device=y.device) * y)
    mask = active_mask(num_active, feats.shape[0], feats.device)[:, None]
    return torch.where(mask, y, torch.zeros((), dtype=dt, device=y.device))


def batch_norm_eval(feats: torch.Tensor, num_active: NumActive,
                    scale: torch.Tensor, bias: torch.Tensor,
                    running_mean: torch.Tensor, running_var: torch.Tensor,
                    *, eps: float = 1e-4, leakiness: float = 1.0
                    ) -> torch.Tensor:
    """Normalise with the running statistics."""
    return _affine(feats, num_active, acc(running_mean),
                   torch.rsqrt(acc(running_var) + eps), scale, bias,
                   leakiness)


def batch_norm_train(feats: torch.Tensor, num_active: NumActive,
                     scale: torch.Tensor, bias: torch.Tensor,
                     running_mean: torch.Tensor, running_var: torch.Tensor,
                     *, eps: float = 1e-4, momentum: float = 0.9,
                     leakiness: float = 1.0) -> torch.Tensor:
    """Normalise with the batch statistics of the active rows, and update
    `running_mean` / `running_var` IN PLACE under no_grad: the update is
    not part of the graph (the JAX package returns new statistics
    instead)."""
    f = acc(feats)
    mask = active_mask(num_active, feats.shape[0], feats.device)[:, None]
    n = float(max(total_active(num_active), 1))
    zero = torch.zeros((), dtype=f.dtype, device=feats.device)
    sum_f = torch.where(mask, f, zero).sum(0)
    sumsq = torch.where(mask, f * f, zero).sum(0)
    mean = sum_f / n
    var_b = sumsq / n - mean * mean                    # biased
    var_u = (sumsq - mean * mean * n) / max(n - 1.0, 1.0)
    with torch.no_grad():
        running_mean.mul_(momentum).add_((1 - momentum) * mean)
        running_var.mul_(momentum).add_((1 - momentum) * var_u)
    return _affine(feats, num_active, mean, torch.rsqrt(var_b + eps), scale,
                   bias, leakiness)
