"""CLI flags and the config dict (counterpart of
`occuseg_tpu/train/config.py`): the JAX package's flags with the same names
and defaults (the reference's flags, plus the caps, device count, plan
workers, buckets and the blocked layout), and the same derived values (UNet
widths [m..6m], input channels from the `use_feature` string l/c/n/d/h,
class count, per-level caps), and the port's `--arch`. The port takes
every flag: --num_devices trains data-parallel, --spatial_shards splits
every batch's voxels over that many ranks (`train/cli.py`)."""

from __future__ import annotations

import argparse
from typing import Any, Dict, List

from occuseg_tpu_torch.models import ARCHS


def get_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("occuseg_tpu_torch")
    # --- reference flags (config.py:4-72), same names/defaults ---
    p.add_argument("--batch_size", type=int, default=4)
    p.add_argument("--optim", default="Adam")
    p.add_argument("--loss", default="cross_entropy")
    p.add_argument("--lr", type=float, default=0.001)
    p.add_argument("--regress_sigma", type=float, default=0.2)
    p.add_argument("--regress_weight", type=float, default=100)
    p.add_argument("--displacement_weight", type=float, default=100)
    p.add_argument("--backbone_network", default="LearnBWNet.pth")
    p.add_argument("--checkpoint_file", dest="load", default=False)
    p.add_argument("--checkpoint", type=int, default=0)
    p.add_argument("--dataset", default="scannet")
    p.add_argument("--gamma", type=float, default=0)
    p.add_argument("--step_size", type=int, default=60000)
    p.add_argument("--max_epoch", type=int, default=2000)
    p.add_argument("--checkpoints_dir", default="./ckpts/")
    p.add_argument("--snapshot", type=float, default=1)
    p.add_argument("--display", type=float, default=10)
    p.add_argument("--taskname", default="default_name")
    p.add_argument("--m", type=int, default=16)
    p.add_argument("--residual_blocks", action="store_true", default=False)
    p.add_argument("--block_reps", type=int, default=1)
    p.add_argument("--kernel_size", type=int, default=3)
    p.add_argument("--scale", type=int, default=20)
    p.add_argument("--val_reps", type=int, default=1)
    p.add_argument("--dimension", type=int, default=3)
    p.add_argument("--full_scale", type=int, default=4096)
    p.add_argument("--rotation_guide_level", type=int, default=0)
    p.add_argument("--evaluate", action="store_true", default=False)
    p.add_argument("--use_dense_model", action="store_true", default=False)
    p.add_argument("--use_rotation_noise", action="store_true", default=False)
    p.add_argument("--use_elastic", action="store_true", default=False)
    p.add_argument("--use_normal", action="store_true", default=False)
    p.add_argument("--use_full_normal", action="store_true", default=False)
    p.add_argument("--simple_train", action="store_true", default=False)
    p.add_argument("--all_to_train", action="store_true", default=False)
    p.add_argument("--test_path", default="")
    p.add_argument("--test_result_path", default="")
    p.add_argument("--use_feature", default="c")
    p.add_argument("--drift_weight", type=float, default=0.0,
                   help="DriftLoss coefficient (reference uses 50 when "
                        "enabled, train_instance.py:240; 0 = off, the "
                        "reference default)")
    # --- the port's architectures ---
    p.add_argument("--arch", default="occuseg",
                   choices=tuple(ARCHS),
                   help="occuseg: the OccuSeg models (--use_dense_model "
                        "picks LearningBWDenseUNet), trained with the "
                        "6-term loss; minkunet34c: MinkUNet34C (a 5^3 stem, "
                        "post-activation residual stages; --m, "
                        "--residual_blocks and --block_reps do not apply), "
                        "trained with the plain cross-entropy")
    # --- additions of the JAX package ---
    p.add_argument("--data_dir", default="data/scannet")
    p.add_argument("--point_cap", type=int, default=262144,
                   help="static per-device point budget")
    p.add_argument("--voxel_cap", type=int, default=262144,
                   help="static level-0 voxel budget")
    p.add_argument("--instance_cap", type=int, default=128,
                   help="static per-device instance budget")
    p.add_argument("--chunk_conv", type=int, default=1,
                   help="attach chunk rulebooks to host plans (the chunk "
                        "conv kernels); 0 = every convolution takes the "
                        "gather path (the gather-conv kernel)")
    p.add_argument("--num_devices", type=int, default=0,
                   help="cards to train on data-parallel, one rank a "
                        "card (train/cli.py); 0 = every visible card")
    p.add_argument("--accum_steps", type=int, default=1,
                   help="gradient accumulation: the mean gradient of N "
                        "steps per optimizer update")
    p.add_argument("--plan_workers", type=int, default=0,
                   help=">1 builds host plans in a thread pool (the C++ "
                        "planner releases the GIL); 0/1 = one prefetch "
                        "thread")
    p.add_argument("--blocked_batch", type=int, default=1,
                   help="multi-scene batches use the BLOCKED row layout "
                        "(per-scene sub-caps, native/blocked.py); 0 = one "
                        "plan over the concatenated scenes")
    p.add_argument("--num_buckets", type=int, default=1,
                   help=">1 picks each batch's caps from this many "
                        "buckets (cuts padding waste)")
    p.add_argument("--spatial_shards", type=int, default=0,
                   help=">1 splits each batch's voxels across this many "
                        "ranks (spatial sharding: halo/pool exchanges, BN "
                        "and loss summed over the shards)")
    p.add_argument("--spatial_halo", type=int, default=4096,
                   help="halo rows per shard side (spatial sharding)")
    p.add_argument("--spatial_pool", type=int, default=4096,
                   help="all-gather pool rows per shard (spatial sharding)")
    return p


def args_to_config(args: argparse.Namespace) -> Dict[str, Any]:
    """Mirror of `ArgsToConfig` (reference `config.py:76-130`)."""
    config: Dict[str, Any] = {}
    for k in ("m", "use_full_normal", "residual_blocks", "simple_train",
              "block_reps", "batch_size", "scale", "val_reps", "dimension",
              "full_scale", "kernel_size", "use_rotation_noise",
              "checkpoint", "checkpoints_dir", "max_epoch", "snapshot",
              "optim", "loss", "lr", "gamma", "step_size",
              "rotation_guide_level", "evaluate", "backbone_network",
              "use_normal", "use_elastic", "use_feature", "use_dense_model",
              "regress_sigma", "regress_weight", "displacement_weight",
              "dataset", "taskname", "data_dir", "point_cap", "voxel_cap",
              "instance_cap", "num_devices", "num_buckets", "accum_steps",
              "spatial_shards", "spatial_halo", "spatial_pool", "load",
              "chunk_conv", "drift_weight", "plan_workers",
              "blocked_batch", "arch"):
        config[k] = getattr(args, k)
    config["unet_structure"] = ARCHS[args.arch].widths(args.m)
    # 20 ScanNet classes / 14 Stanford3D (reference
    # `evaluate_instance.py:1332-1337`)
    config["class_num"] = 14 if args.dataset == "stanford3d" else 20
    # input channels from feature string (config.py:116-126)
    n = 0
    f = config["use_feature"]
    n += 3 * ("l" in f) + 3 * ("c" in f) + 3 * ("n" in f)
    n += 9 * ("d" in f) + 1 * ("h" in f)
    config["input_feature_number"] = n
    return config


# Measured active-site reduction per stride-2 level on ScanNet-like scenes:
# ~0.72, 0.44, 0.27, 0.24, 0.23 of the previous level (surfaces stay nearly
# dense for the first downsample). Caps use safer ratios than that.
CAP_RATIOS = (1.0, 0.85, 0.55, 0.30, 0.18, 0.12, 0.08)


def plan_caps(config: Dict[str, Any]) -> List[int]:
    """Per-level voxel caps from measured reduction ratios, floor 1024,
    rounded up to a multiple of 1024 for clean tiling."""
    n0 = config["voxel_cap"]
    caps = []
    for l in range(len(config["unet_structure"])):
        r = CAP_RATIOS[min(l, len(CAP_RATIOS) - 1)]
        c = max(int(n0 * r), 1024)
        caps.append((c + 1023) // 1024 * 1024)
    return caps
