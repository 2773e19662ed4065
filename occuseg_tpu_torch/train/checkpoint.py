"""Checkpoints (counterpart of `occuseg_tpu/train/checkpoint.py`).

`<root>/step_<N>.pth`, one `torch.save` file per snapshot holding a
`Trainer.state_dict()`: the model's parameters and BN statistics, the
optimizer and schedule state and the step counter. Retention keeps the
newest snapshot, the powers of two and the multiples of 64, as the JAX
package does. `import_torch_state_dict` maps the reference's own weights
(`train/torch_import.py` names them) onto the port's modules.
"""

from __future__ import annotations

import os
import re
from collections import OrderedDict
from typing import Dict, List, Mapping, Optional

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


def import_torch_state_dict(state_dict: Mapping[str, torch.Tensor],
                            model: torch.nn.Module,
                            name_map: Mapping[str, str]
                            ) -> "OrderedDict[str, torch.Tensor]":
    """The port's state dict for `model` from the reference's
    `state_dict`. `name_map`: reference key -> flax path ('/'-joined),
    whose module path is the port's with '/' -> '.' (a Dense `kernel` is a
    Linear `weight`). The layouts need no change: a convolution weight is
    [K, Cin, Cout] in both, a Linear weight [out, in] in both (the JAX
    importer transposes it to flax's [in, out]), BN parameters and running
    statistics are vectors. Raises on a reference key that is missing or
    left over, a model key the map does not reach, and a shape mismatch."""
    missing = sorted(set(name_map) - set(state_dict))
    extra = sorted(set(state_dict) - set(name_map))
    if missing or extra:
        raise KeyError(f"reference state dict: missing {missing}, left over "
                       f"{extra}")
    ref = model.state_dict()
    out = OrderedDict()
    for tkey, fpath in name_map.items():
        path = fpath.split("/")
        if path[-1] == "kernel":
            path[-1] = "weight"
        key = ".".join(path)
        if key not in ref:
            raise KeyError(f"{tkey} -> {key}: no such parameter or buffer")
        v = torch.as_tensor(state_dict[tkey]).detach().cpu()
        if tuple(v.shape) != tuple(ref[key].shape):
            raise ValueError(f"{tkey} -> {key}: shape {tuple(v.shape)} vs "
                             f"{tuple(ref[key].shape)}")
        out[key] = v.to(ref[key].dtype).clone()
    unmapped = sorted(set(ref) - set(out))
    if unmapped:
        raise KeyError(f"model keys the name map does not reach: {unmapped}")
    return out
