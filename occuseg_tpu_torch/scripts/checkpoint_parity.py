"""Checkpoint-parity gate (counterpart of `scripts/checkpoint_parity.py`):
validate a reference-format `.pth` in one command.

    python -m occuseg_tpu_torch.scripts.checkpoint_parity \
        --checkpoint_file ckpts/baseline_m64.pth --m 64 --residual_blocks \
        --use_dense_model [--skip_eval] [--data_dir data/scannet]

Stages, on a fixed probe scene (6000 synthetic points, extent 96, seed
11; features from `default_rng(5)`):
  1. import: the file's weights and BN statistics into the port's
     `LearningBWDenseUNet` (`train/torch_import.load_baseline_checkpoint`):
     a key that does not map, one left over or a shape that differs fails.
  2. activation diff: the torch oracle of the reference module tree
     (`tests/torch_oracle.py`, loaded from its path) with the file's own
     weights on the CPU, against the port's model on its device (the
     chunk kernels where a width takes them): the largest |difference| of
     each of the seven heads over the scene's points must stay under TOL.
  3. unless --skip_eval, the val split's instance AP
     (`evaluate_instance.infer_scenes` and `score_scenes`) with the
     imported weights.

Exits 0 only when stages 1 and 2 both ran and passed; an oracle that
cannot be loaded fails the gate (the JAX script logs a skip there and
still exits 0).
"""

from __future__ import annotations

import importlib.util
import logging
import os
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from occuseg_tpu_torch import evaluate_instance
from occuseg_tpu_torch.core.topology import PlanSpec
from occuseg_tpu_torch.data.synthetic import SceneConfig, make_batch
from occuseg_tpu_torch.infer import Predictor, prepare_scene
from occuseg_tpu_torch.models import LearningBWDenseUNet
from occuseg_tpu_torch.native.plan import build_plan_host
from occuseg_tpu_torch.train.config import args_to_config, get_parser
from occuseg_tpu_torch.train.loop import _device
from occuseg_tpu_torch.train.torch_import import load_baseline_checkpoint

log = logging.getLogger("occuseg_tpu_torch")

TOL = 1e-3
HEADS = ("semantics", "features", "embedding", "offset", "displacement",
         "bw", "occupancy")
# the oracle, by path: another package named `tests` may be importable
ORACLE = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "tests", "torch_oracle.py")
P_CAP = 8192
PROBE_CAPS = (4096, 2048, 1024, 1024, 1024, 1024)


def parser():
    p = get_parser()
    p.add_argument("--skip_eval", action="store_true", default=False,
                   help="stop after the activation diff (no val AP)")
    p.add_argument("--region_cap", type=int, default=4096)
    p.add_argument("--use_merge", action="store_true", default=True)
    p.add_argument("--use_joint_refine", action="store_true", default=False)
    p.add_argument("--bw_relax_factor", type=float, default=1.0)
    p.add_argument("--merge_threshold", type=float, default=0.5)
    p.add_argument("--occupancy_lo", type=float, default=0.3)
    p.add_argument("--occupancy_hi", type=float, default=3.0)
    return p


def load_oracle(path: Optional[str] = None):
    """`OracleLearningBWDenseUNet` of the oracle module at `path` (default
    `ORACLE`)."""
    path = path or ORACLE
    spec = importlib.util.spec_from_file_location("torch_oracle", path)
    if spec is None:
        raise ImportError(f"no module at {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.OracleLearningBWDenseUNet


def probe_scene(config: Dict):
    """(batch, spec, host plan, point features) of the fixed probe."""
    planes = config["unet_structure"]
    spec = PlanSpec(caps=PROBE_CAPS[:len(planes)])
    batch = make_batch(SceneConfig(num_points=6000, extent=96,
                                   num_objects=8),
                       num_scenes=1, p_cap=P_CAP, num_instances=16, seed=11)
    plan = build_plan_host(batch["coords"], spec)
    feats = np.random.default_rng(5).standard_normal(
        (P_CAP, config["input_feature_number"])).astype(np.float32)
    return batch, spec, plan, feats


def activation_diff(path: str, model: torch.nn.Module, config: Dict,
                    device, oracle_cls) -> Dict[str, float]:
    """Stage 2: per head, the largest |port - oracle| over the probe's
    points (the oracle, of class `oracle_cls`, on the CPU with the file's
    weights)."""
    batch, spec, plan, feats = probe_scene(config)
    planes = tuple(int(x) for x in config["unet_structure"])
    oracle = oracle_cls(planes, config["class_num"], plan,
                        in_ch=config["input_feature_number"],
                        reps=int(config.get("block_reps", 1)))
    sd = torch.load(path, map_location="cpu", weights_only=False)
    sd = sd.get("state_dict", sd) if isinstance(sd, dict) else sd
    oracle.load_state_dict({k[7:] if k.startswith("module.") else k: v
                            for k, v in sd.items()}, strict=True)
    with torch.no_grad():
        ref = oracle.eval()(torch.from_numpy(feats))
    out = Predictor(model, device)(prepare_scene(batch["coords"], feats,
                                                 spec))
    valid = torch.from_numpy(batch["coords"][:, 0] >= 0)
    return {name: float((getattr(out, name).float().cpu()[valid]
                         - t[valid]).abs().max())
            for name, t in zip(HEADS, ref)}


def main(argv: Optional[Sequence[str]] = None, device="cuda") -> int:
    """Run the gate on `argv` (default: the command line); returns the
    exit code: 0 when stages 1 and 2 passed, 1 otherwise."""
    logging.basicConfig(level=logging.INFO)
    args = parser().parse_args(argv)
    config = args_to_config(args)
    config["use_dense_model"] = True
    path = config.get("load")
    if not path or not os.path.exists(path):
        raise SystemExit(f"--checkpoint_file {path!r} not found")
    dev = _device(device)
    planes = tuple(int(x) for x in config["unet_structure"])
    reps = int(config.get("block_reps", 1))
    model = LearningBWDenseUNet(
        planes, num_classes=config["class_num"], block_reps=reps,
        residual_blocks=config["residual_blocks"],
        in_features=config["input_feature_number"],
        generator=torch.Generator().manual_seed(0))

    log.info("stage 1: importing %s", path)
    try:
        load_baseline_checkpoint(path, model, planes, reps,
                                 config["residual_blocks"])
    except (KeyError, ValueError) as e:
        log.error("stage 1 FAIL: %s", e)
        return 1
    log.info("stage 1 PASS: all keys mapped, all shapes match")

    try:
        oracle_cls = load_oracle()
    except (ImportError, OSError, AttributeError) as e:
        log.error("stage 2 FAIL: the torch oracle cannot be loaded: %r", e)
        return 1
    diffs = activation_diff(path, model, config, dev, oracle_cls)
    ok = True
    for name, d in diffs.items():
        ok &= d < TOL
        log.info("stage 2 %-12s max|diff| = %.2e %s", name, d,
                 "OK" if d < TOL else f"FAIL (tol {TOL})")
    log.info("stage 2 %s", "PASS" if ok else "FAIL")

    if not args.skip_eval:
        log.info("stage 3: val instance AP")
        evaluate_instance.score_scenes(evaluate_instance.infer_scenes(
            config, args, model=model, device=dev), args, dev)
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
