"""Extra sparse modules (counterpart of part of `occuseg_tpu/nn/extras.py`):
the permutohedral-lattice submanifold convolution.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from occuseg_tpu_torch.core.sparse_tensor import SparseTensor
from occuseg_tpu_torch.core.topology import Topology
from occuseg_tpu_torch.nn.modules import _he_weight
from occuseg_tpu_torch.ops import conv as conv_ops
from occuseg_tpu_torch.ops.permutohedral import permutohedral_offsets


def _negation(offsets: np.ndarray) -> list:
    """neg[k]: the index of offset -offsets[k]."""
    index = {tuple(o): k for k, o in enumerate(offsets.tolist())}
    return [index[tuple(-o for o in off)] for off in offsets.tolist()]


class PermutohedralSubmanifoldConvolution(nn.Module):
    """Submanifold convolution over the permutohedral (A_3) lattice's 13
    nearest-neighbour offsets (the reference's
    permutohedralSubmanifoldConvolution). It needs a plan built with
    `PlanSpec(lattice="permutohedral")` from coordinates mapped by
    `ops/permutohedral.embed_points`; the convolution is #9's gather
    convolution with K = 13.

    The lattice's offset order (zero first, then lexicographic) does not
    put -offset(k) at K-1-k, as the cubic stencil's does, so the backward
    map is the neighbour map with its offsets negated: row k of it is row
    neg(k) of the map (nbr[r, k] = i iff nbr[i, neg(k)] = r), kept in the
    level's map cache. The JAX package's module pairs the map with itself
    reversed, as for the cubic stencil."""

    def __init__(self, in_features: int, out_features: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        offsets = permutohedral_offsets(3)
        self.neg = _negation(offsets)
        K = offsets.shape[0]
        self.weight = _he_weight((K, in_features, out_features), K,
                                 generator)

    def _negated(self, lvl, nbr_kn: torch.Tensor) -> torch.Tensor:
        m = lvl.kn.get("nbr_neg")
        if m is None:
            m = lvl.kn["nbr_neg"] = torch.stack([nbr_kn[j] for j in self.neg])
        return m

    def forward(self, x: SparseTensor, plan: Topology) -> SparseTensor:
        lvl = plan.levels[x.level]
        if lvl.nbr.shape[1] != self.weight.shape[0]:
            raise ValueError(f"plan kernel volume {lvl.nbr.shape[1]} != "
                             f"the lattice's {self.weight.shape[0]}")
        f = x.features
        nbr = lvl.gather_map("nbr", f.device)
        out = conv_ops.gather_conv_kn(f, nbr, self.weight,
                                      self._negated(lvl, nbr), False)
        return x.with_features(out)
