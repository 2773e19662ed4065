"""MulAdd and hidden-state counters (counterpart of the counters of
`occuseg_tpu/utils/profiling.py`): exact counts from a host plan, where
only real rulebook pairs count, as the reference accumulates them per
operation, and their per-epoch sums."""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from occuseg_tpu_torch.core.topology import Topology
from occuseg_tpu_torch.ops.conv import conv_flops


def plan_muladd_count(plan: Topology, n_planes: Sequence[int],
                      block_reps: int = 1, residual: bool = True,
                      input_channels: int = 3) -> int:
    """MulAdds of one UNet forward on this plan: the input convolution,
    per level `block_reps` blocks of two (residual) or one submanifold
    convolutions, the strided convolution and deconvolution pairs, and the
    decoder blocks at twice the width for their first rep (with the NIN
    shortcut where widths differ)."""
    L = len(n_planes)

    def sub(level, cin, cout):
        return conv_flops(plan.levels[level].nbr, cin, cout)

    def nin_pairs(level, cin, cout):
        return int(np.sum(plan.levels[level].num_active)) * cin * cout

    total = sub(0, input_channels, n_planes[0])
    for l in range(L):
        a = n_planes[l]
        for _ in range(block_reps):
            total += (2 if residual else 1) * sub(l, a, a)
        if l < L - 1:
            tr = plan.transitions[l]
            total += conv_flops(tr.child, a, n_planes[l + 1])
            total += conv_flops(tr.up, n_planes[l + 1], a)
            for i in range(block_reps):
                cin = a * (2 if i == 0 else 1)
                if residual:
                    total += sub(l, cin, a) + sub(l, a, a)
                    if cin != a:
                        total += nin_pairs(l, cin, a)
                else:
                    total += sub(l, cin, a)
    return total


def plan_hidden_count(plan: Topology, n_planes: Sequence[int]) -> int:
    """Hidden states: active rows times width, summed over the levels."""
    return sum(int(np.sum(lvl.num_active))
               * n_planes[min(l, len(n_planes) - 1)]
               for l, lvl in enumerate(plan.levels))


@dataclasses.dataclass
class CounterState:
    muladd: float = 0.0
    hidden: float = 0.0
    scenes: int = 0

    def add(self, muladd: int, hidden: int, scenes: int = 1) -> None:
        self.muladd += muladd
        self.hidden += hidden
        self.scenes += scenes

    def report(self) -> str:
        s = max(self.scenes, 1)
        return (f"MegaMulAdd={self.muladd / s / 1e6:.1f}/scene "
                f"MegaHidden={self.hidden / s / 1e6:.1f}/scene")
