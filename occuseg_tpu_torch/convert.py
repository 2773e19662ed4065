"""Flax weights -> a state_dict of the port's modules.

The JAX package's `params` and `batch_stats` trees (nested dicts of NumPy
arrays, e.g. `jax.tree.map(np.asarray, variables["params"])`) map one to
one onto module paths: `backbone/backbone/unet/enc0/conv1/weight` becomes
`backbone.backbone.unet.enc0.conv1.weight`, and a model of the
sparseconvnet facade's `layers_0/branches_1/weight` becomes
`layers_0.branches_1.weight` (`legacy.py` names its children as flax
names a tuple's members). Convolution, NIN and BN
parameters keep their shapes; a Dense `kernel` [in, out] becomes a Linear
`weight` [out, in] (a SpectralDense's too).
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Mapping, Optional

import numpy as np
import torch

_PARAM_LEAVES = ("kernel", "bias", "weight", "scale", "affine_weight",
                 "affine_bias")
# flax nn.BatchNorm's statistics (and its "scale") under the port's names
_STAT_LEAVES = {"running_mean": "running_mean", "running_var": "running_var",
                "mean": "running_mean", "var": "running_var"}
_BN_STATS = {"running_mean", "running_var"}


def _flatten(tree: Mapping, prefix=()):
    for k, v in tree.items():
        path = prefix + (str(k),)
        if isinstance(v, Mapping):
            yield from _flatten(v, path)
        else:
            yield path, v


def _tensor(v) -> torch.Tensor:
    # a copy: flax leaves may be read-only
    return torch.from_numpy(np.ascontiguousarray(np.array(v, np.float32)))


def from_flax(params: Mapping, batch_stats: Mapping,
              model: Optional[torch.nn.Module] = None,
              spectral: Optional[Mapping] = None
              ) -> "OrderedDict[str, torch.Tensor]":
    """state_dict for the port from flax `params` and `batch_stats` (and
    the "spectral" collection of SpectralDense layers, whose `u` becomes
    the module's buffer).

    Besides the leaves above: a batch-norm layer of the port
    (BatchNormalization: a 1-D `weight`) and flax's plain BatchNorm
    (`scale`, mapped to `weight`, with statistics `mean` / `var` mapped to
    `running_mean` / `running_var`) need both statistics; a layer with
    only `running_mean` is MeanOnlyBNLeakyReLU, whose parameter is a
    `bias` alone; AffineReluTrivialConvolution's `affine_weight` and
    `affine_bias` keep their names.

    Raises ValueError on a leaf the mapping does not know, on a batch-norm
    layer whose statistics are missing or left over, and, when `model` is
    given, on any key of the model's state_dict that is missing or left
    over or whose shape differs."""
    out = OrderedDict()
    layer_params = {}
    for path, v in _flatten(params):
        name = path[-1]
        if name not in _PARAM_LEAVES:
            raise ValueError(f"unknown flax parameter {'/'.join(path)}")
        a = _tensor(v)
        if name == "kernel":  # Dense [in, out] -> Linear weight [out, in]
            a, name = a.t().contiguous(), "weight"
        elif name == "scale":
            name = "weight"
        layer_params.setdefault(path[:-1], {})[path[-1]] = a.dim()
        out[".".join(path[:-1] + (name,))] = a
    layer_stats = {}
    for path, v in _flatten(batch_stats):
        if path[-1] not in _STAT_LEAVES:
            raise ValueError(f"unknown flax statistic {'/'.join(path)}")
        name = _STAT_LEAVES[path[-1]]
        layer_stats.setdefault(path[:-1], set()).add(name)
        out[".".join(path[:-1] + (name,))] = _tensor(v)
    for path, v in _flatten(spectral or {}):
        if path[-1] != "u":
            raise ValueError(f"unknown flax spectral leaf {'/'.join(path)}")
        out[".".join(path)] = _tensor(v)

    def kind(layer):
        p = layer_params.get(layer, {})
        if "scale" in p or p.get("weight") == 1:
            return _BN_STATS
        if "bias" in p and "weight" not in p and "kernel" not in p:
            return {"running_mean"}
        return set()
    bad = sorted("/".join(layer) for layer in set(layer_params)
                 | set(layer_stats)
                 if kind(layer) != layer_stats.get(layer, set()))
    if bad:
        raise ValueError(
            "batch-norm layers and statistics disagree: layers without "
            f"their statistics or statistics without a layer at {bad}")
    if model is not None:
        ref = model.state_dict()
        missing = sorted(set(ref) - set(out))
        extra = sorted(set(out) - set(ref))
        if missing or extra:
            raise ValueError(f"state_dict mismatch: missing {missing}, left "
                             f"over {extra}")
        bad = [k for k in ref if tuple(ref[k].shape) != tuple(out[k].shape)]
        if bad:
            raise ValueError("shape mismatch: " + ", ".join(
                f"{k} {tuple(out[k].shape)} vs {tuple(ref[k].shape)}"
                for k in bad))
    return out
