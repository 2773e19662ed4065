"""SparseTensor (counterpart of `occuseg_tpu/core/sparse_tensor.py`).

Features over the statically padded rows of one topology level. Rows that
are not active are padding and stay exactly zero through every
convolution and batch norm. `num_active` is an int, the count of the
active prefix [0, n) of a one-scene plan, or, under the blocked
multi-scene layout (`native/blocked.py`), a tuple of per-scene counts:
scene s owns rows [s*cap/ns, s*cap/ns + n_s).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Sequence, Tuple, Union

import numpy as np
import torch

NumActive = Union[int, Sequence[int]]


def active_mask(num_active: NumActive, cap: int, device=None) -> torch.Tensor:
    """Bool [cap]: True for the real rows of either layout."""
    if np.ndim(num_active) == 0:
        return torch.arange(cap, device=device) < int(num_active)
    return _blocked_mask(tuple(int(n) for n in num_active), cap,
                         torch.device(device or "cpu"))


@functools.lru_cache(maxsize=64)
def _blocked_mask(counts: Tuple[int, ...], cap: int,
                  device: torch.device) -> torch.Tensor:
    """The blocked layout's mask, built once per (counts, cap, device) (a
    step's batch norms on one level share it) from device ops alone: a
    copy of the counts from pageable host memory would make the host wait
    for the card."""
    ns = len(counts)
    if cap % ns:
        raise ValueError(f"blocked layout: cap {cap} is not a multiple of the "
                         f"scene count {ns}")
    # a normal tensor even when first built under inference_mode: the
    # cached mask is later saved for a training step's backward
    with torch.inference_mode(False):
        rows = torch.arange(cap // ns, device=device)
        return torch.cat([rows < n for n in counts])


def total_active(num_active: NumActive) -> int:
    """Count of real rows of either layout."""
    if np.ndim(num_active) == 0:
        return int(num_active)
    return sum(int(n) for n in num_active)


@dataclasses.dataclass(frozen=True)
class SparseTensor:
    """features [cap, C]; num_active real rows (an int, or a tuple of
    per-scene counts); `level` indexes the plan."""

    features: torch.Tensor
    num_active: NumActive
    level: int = 0

    @property
    def cap(self) -> int:
        return self.features.shape[0]

    def with_features(self, features: torch.Tensor) -> "SparseTensor":
        return dataclasses.replace(self, features=features)


def concat_features(a: SparseTensor, b: SparseTensor) -> SparseTensor:
    """Channel concat of two tensors on the same level (JoinTable)."""
    if a.level != b.level:
        raise ValueError("concat_features needs tensors on one level")
    return a.with_features(torch.cat([a.features, b.features], dim=-1))


def add_features(a: SparseTensor, b: SparseTensor) -> SparseTensor:
    """Elementwise add of two tensors on the same level (AddTable)."""
    if a.level != b.level:
        raise ValueError("add_features needs tensors on one level")
    return a.with_features(a.features + b.features)
