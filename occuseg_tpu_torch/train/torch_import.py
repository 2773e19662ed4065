"""Name map between the reference's torch state dict and the port's
modules (counterpart of `occuseg_tpu/train/torch_import.py`).

The reference's `LearningBWDenseUNet` state dict (the published
`baseline_m64.pth`) has keys following its module tree (`model.py:657-717`):
`backbone.{input,sub,unet,bn,output,linear,fc_*,linear_*}` plus
`fc_bw/linear_bw/fc_occupancy/linear_occupancy`, where `unet` is the
`scn.Sequential` produced by the recursive UNet builder
(`networkArchitectures.py:202-306`) with integer child names:

  per level (residual, reps=R):
    [2i]   ConcatTable: .0 Identity|NIN(shortcut), .1 Sequential
           (.0 BN, .1 SubConv, .2 BN, .3 SubConv)        i < R  (encoder)
    [2i+1] AddTable
    [2R]   ConcatTable: .0 Identity, .1 Sequential
           (.0 BN, .1 Conv, .2 <inner UNet>, .3 BN, .4 Deconv)
    [2R+1] JoinTable
    [2R+2+2i] / [+1] decoder ConcatTable/AddTable blocks  i < R
  vgg blocks instead: [i] Sequential (.0 BN, .1 SubConv)

`learning_bw_name_map` gives each reference key the JAX package's flax path
('/'-joined), whose module path is the port's (`convert.py`: '/' -> '.',
a Dense `kernel` is a Linear `weight`). `load_baseline_checkpoint` loads
such a file's weights and BN running statistics into a port model
(`checkpoint.import_torch_state_dict`); it carries no optimizer state.
Normal-guided models (--use_normal) have the same keys.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, List, Sequence

import torch

from occuseg_tpu_torch.train.checkpoint import import_torch_state_dict


def _bn(torch_prefix: str, flax_prefix: str, out: Dict[str, str]) -> None:
    out[f"{torch_prefix}.weight"] = f"{flax_prefix}/weight"
    out[f"{torch_prefix}.bias"] = f"{flax_prefix}/bias"
    out[f"{torch_prefix}.running_mean"] = f"{flax_prefix}/running_mean"
    out[f"{torch_prefix}.running_var"] = f"{flax_prefix}/running_var"


def _conv(torch_prefix: str, flax_prefix: str, out: Dict[str, str]) -> None:
    out[f"{torch_prefix}.weight"] = f"{flax_prefix}/weight"


def _dense(torch_prefix: str, flax_prefix: str, out: Dict[str, str]) -> None:
    out[f"{torch_prefix}.weight"] = f"{flax_prefix}/kernel"
    out[f"{torch_prefix}.bias"] = f"{flax_prefix}/bias"


def _unet_map(torch_prefix: str, flax_prefix: str,
              n_planes: Sequence[int], reps: int, residual: bool,
              out: Dict[str, str]) -> None:
    p = list(n_planes)

    def block(tp: str, fp: str, a: int, b: int) -> None:
        if residual:
            if a != b:
                _conv(f"{tp}.0", f"{fp}/shortcut", out)
            _bn(f"{tp}.1.0", f"{fp}/bn1", out)
            _conv(f"{tp}.1.1", f"{fp}/conv1", out)
            _bn(f"{tp}.1.2", f"{fp}/bn2", out)
            _conv(f"{tp}.1.3", f"{fp}/conv2", out)
        else:
            _bn(f"{tp}.0", f"{fp}/bn1", out)
            _conv(f"{tp}.1", f"{fp}/conv1", out)

    idx = 0
    for i in range(reps):
        block(f"{torch_prefix}.{idx}", f"{flax_prefix}/enc{i}", p[0], p[0])
        idx += 2 if residual else 1
    if len(p) == 1:
        return
    ct = f"{torch_prefix}.{idx}.1"
    _bn(f"{ct}.0", f"{flax_prefix}/down_bn", out)
    _conv(f"{ct}.1", f"{flax_prefix}/down_conv", out)
    _unet_map(f"{ct}.2", f"{flax_prefix}/inner", p[1:], reps, residual, out)
    _bn(f"{ct}.3", f"{flax_prefix}/up_bn", out)
    _conv(f"{ct}.4", f"{flax_prefix}/up_conv", out)
    idx += 2  # ConcatTable + JoinTable
    for i in range(reps):
        a = p[0] * (2 if i == 0 else 1)
        block(f"{torch_prefix}.{idx}", f"{flax_prefix}/dec{i}", a, p[0])
        idx += 2 if residual else 1


def learning_bw_name_map(n_planes: Sequence[int], block_reps: int = 1,
                         residual_blocks: bool = True) -> Dict[str, str]:
    """torch key -> flax '/'-joined path for LearningBWDenseUNet.

    Flax tree: backbone/backbone/{sub,unet/...,bn} (LearningBW wraps
    InstanceDenseUNet named 'backbone', which holds a `_Backbone` also named
    'backbone') and heads at backbone/{linear,...} + top-level bw/occupancy.
    """
    out: Dict[str, str] = {}
    # torch: LearningBWDenseUNet.backbone = InstanceDenseUNet; its members
    # are direct attributes (model.py:662-680)
    t = "backbone"
    f_core = "backbone/backbone"   # flax _Backbone scope
    _conv(f"{t}.sub", f"{f_core}/sub", out)
    _unet_map(f"{t}.unet", f"{f_core}/unet", n_planes, block_reps,
              residual_blocks, out)
    _bn(f"{t}.bn", f"{f_core}/bn", out)
    f_heads = "backbone"
    _dense(f"{t}.linear", f"{f_heads}/linear", out)
    _dense(f"{t}.fc_regress", f"{f_heads}/fc_regress", out)
    _dense(f"{t}.linear_regress", f"{f_heads}/linear_regress", out)
    _dense(f"{t}.fc_embedding", f"{f_heads}/fc_embedding", out)
    _dense(f"{t}.linear_embedding", f"{f_heads}/linear_embedding", out)
    _dense(f"{t}.fc_displacement", f"{f_heads}/fc_displacement", out)
    _dense(f"{t}.linear_displacement", f"{f_heads}/linear_displacement", out)
    _dense("fc_bw", "fc_bw", out)
    _dense("linear_bw", "linear_bw", out)
    _dense("fc_occupancy", "fc_occupancy", out)
    _dense("linear_occupancy", "linear_occupancy", out)
    return out


def split_param_stat_paths(name_map: Dict[str, str]):
    params = {k: v for k, v in name_map.items()
              if not (k.endswith("running_mean") or k.endswith("running_var"))}
    stats = {k: v for k, v in name_map.items()
             if k.endswith("running_mean") or k.endswith("running_var")}
    return params, stats


def load_baseline_checkpoint(pth_path: str, model: torch.nn.Module,
                             n_planes: Sequence[int], block_reps: int = 1,
                             residual_blocks: bool = True
                             ) -> "OrderedDict[str, torch.Tensor]":
    """Load a reference `baseline_m64.pth`-style file (a state dict, or a
    module with `state_dict()`) into `model`: weights and BN running
    statistics. Returns the state dict that was loaded."""
    sd = torch.load(pth_path, map_location="cpu", weights_only=False)
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    name_map = learning_bw_name_map(n_planes, block_reps, residual_blocks)
    state = import_torch_state_dict(sd, model, name_map)
    model.load_state_dict(state)
    return state
