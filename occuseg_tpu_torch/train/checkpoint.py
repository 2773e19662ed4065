"""Checkpoints (counterpart of `occuseg_tpu/train/checkpoint.py`).

`<root>/step_<N>.pth`, one `torch.save` file per snapshot holding a
`Trainer.state_dict()`: the model's parameters and BN statistics, the
optimizer and schedule state and the step counter. Retention keeps the
newest snapshot, the powers of two and the multiples of 64, as the JAX
package does. Not ported: the importer of the reference's `.pth` weights
(its checkpoint is not in the repo; ROADMAP A8).
"""

from __future__ import annotations

import os
import re
from typing import Dict, List, Optional

import torch

_NAME = re.compile(r"step_(\d+)\.pth")


def _steps(root: str) -> List[int]:
    if not os.path.isdir(root):
        return []
    return sorted(int(m.group(1)) for d in os.listdir(root)
                  if (m := _NAME.fullmatch(d)))


def save_checkpoint(root: str, state: Dict, step: int) -> str:
    """Write `state` to <root>/step_<step>.pth (atomically: a temporary
    file renamed into place); return the path."""
    os.makedirs(root, exist_ok=True)
    path = os.path.join(os.path.abspath(root), f"step_{int(step)}.pth")
    tmp = path + ".tmp"
    torch.save(state, tmp)
    os.replace(tmp, path)
    return path


def restore_checkpoint(path: str, map_location=None) -> Dict:
    """The state saved at `path` (tensors on `map_location`)."""
    return torch.load(path, map_location=map_location, weights_only=True)


def is_checkpoint(path: str) -> bool:
    """True for a file this module wrote (step_<N>.pth)."""
    return os.path.isfile(path) and bool(_NAME.fullmatch(
        os.path.basename(path)))


def latest_checkpoint(root: str) -> Optional[str]:
    steps = _steps(root)
    return os.path.join(root, f"step_{steps[-1]}.pth") if steps else None


def gc_checkpoints(root: str) -> None:
    """Keep the newest step, the powers of two and the multiples of 64;
    delete the other snapshots."""
    steps = _steps(root)
    if not steps:
        return
    keep = {steps[-1]}
    keep.update(s for s in steps if s & (s - 1) == 0 or s % 64 == 0)
    for s in steps:
        if s not in keep:
            os.remove(os.path.join(root, f"step_{s}.pth"))
