"""The numbers that decide `correct`, each a gap between the program and
the reference, and the check of each against its limit."""

from __future__ import annotations

import statistics
from typing import Dict, Iterable, List, Optional, Tuple


def leaf_gap(prog: Dict[str, float], ref: Dict[str, float],
             names: Optional[Iterable[str]] = None) -> Tuple[float, str]:
    """The worst leaf's |norm of the program - norm of the reference|
    over the larger of the reference leaf's norm and the median leaf's
    (a leaf the program lacks reads norm 0); (gap, leaf)."""
    names = list(ref if names is None else names)
    med = statistics.median(ref[n] for n in ref)
    worst, which = 0.0, ""
    for n in names:
        g = abs(prog.get(n, 0.0) - ref[n]) / max(ref[n], med, 1e-30)
        if g >= worst:
            worst, which = g, n
    return worst, which


def rel_gap(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-30)


def checks(numbers: Dict[str, float], limits: Dict[str, float]
           ) -> Tuple[bool, List[List]]:
    """(all within their limits, [[name, number, limit], ...]); a number
    that is not finite fails."""
    rows, ok = [], True
    for name, limit in limits.items():
        v = numbers.get(name, float("nan"))
        fine = v == v and abs(v) != float("inf") and v <= limit
        ok = ok and fine
        rows.append([name, v, limit])
    return ok, rows
