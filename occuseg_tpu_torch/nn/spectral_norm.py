"""Spectral normalization (counterpart of `occuseg_tpu/nn/spectral_norm.py`):
a dense layer whose kernel is divided by its largest singular value,
estimated by power iteration from a vector `u` that persists between
calls."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn


class SpectralDense(nn.Module):
    """Dense layer with spectral normalization of its kernel. `weight` is
    [features, in_features] (the flax kernel transposed); the power
    iteration runs inside the graph, as the JAX module differentiates
    through it, and in training mode the new `u` replaces the buffer under
    no_grad (the JAX module's "spectral" collection)."""

    def __init__(self, in_features: int, features: int,
                 n_power_iterations: int = 1, eps: float = 1e-12,
                 use_bias: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.n_power_iterations, self.eps = n_power_iterations, eps
        self.weight = nn.Parameter(torch.randn(
            (features, in_features), generator=generator)
            / in_features ** 0.5)
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None
        self.register_buffer("u", torch.randn(features, generator=generator))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight.to(torch.float32).t()      # the flax kernel [in, out]
        u = self.u.clone()   # the update below writes the buffer in place
        for _ in range(self.n_power_iterations):
            v = w @ u
            v = v / torch.clamp(torch.linalg.norm(v), min=self.eps)
            u = w.t() @ v
            u = u / torch.clamp(torch.linalg.norm(u), min=self.eps)
        sigma = v @ (w @ u)
        if self.training:
            with torch.no_grad():
                self.u.copy_(u)
        y = x @ (w / torch.clamp(sigma, min=self.eps)).to(x.dtype)
        if self.bias is not None:
            y = y + self.bias.to(y.dtype)
        return y
