"""Training and evaluation loop on one card (counterpart of
`occuseg_tpu/train/loop.py`).

    python -m occuseg_tpu_torch.train.cli --data_dir DIR --m 64 \
        --use_dense_model --residual_blocks --use_normal --use_feature cn \
        --use_elastic --plan_workers 4 [--checkpoint_file ref.pth]

Epoch loop over the dataset: the ScanNet scenes under `--data_dir`
(`data/scannet.py`: `train/` and `val/` hold `.npz` files from
`python -m occuseg_tpu_torch.data.prepare`, or the reference's `.pth`
files), or, when it holds none, the synthetic generator, as in the JAX
package. Every batch is prepared on the host (the blocked multi-scene plan
for batches of several scenes, with orientation classes under
--use_normal, chunk rulebooks unless --chunk_conv 0 (then every
convolution runs the gather path), sorted point layout; optionally at the
smallest cap bucket that fits) in a `PlanPool` of `--plan_workers` threads
(one for 0 or 1), as NumPy arrays (on a card, what the step uploads is
pinned there); only this thread pulls the batches from the dataset and
uploads them, inside `Trainer.step`. Per epoch: the mean loss parts,
MulAdd counters and wall time in one log line (and TensorBoard when it is
installed), a checkpoint every `snapshot` epochs with power-of-two
retention, and the semantic eval. `--checkpoint_file` (config "load")
resumes from a checkpoint of the port, or imports the weights and BN
statistics of the reference's `.pth`/`.pt` file (`train/torch_import.py`).

One card only: `--num_devices` > 1 and `--spatial_shards` > 1 raise
(ROADMAP A9). The entry points run on "cuda" and raise where there is no
card, unless the caller passes device="cpu". Unlike the JAX loop, a scene
file that cannot be read and a failing snapshot eval are not caught: they
stop the run.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Callable, Dict, Iterable, Iterator, Optional, Tuple

import numpy as np
import torch

from occuseg_tpu_torch.core.topology import PlanSpec
from occuseg_tpu_torch.data.scannet import ScanNetData
from occuseg_tpu_torch.data.synthetic import SceneConfig, make_batch
from occuseg_tpu_torch.infer import Predictor, prepare_scene
from occuseg_tpu_torch.native.pool import PlanPool
from occuseg_tpu_torch.losses.instance import LossConfig
from occuseg_tpu_torch.losses.semantic import (
    SCANNET_CE_WEIGHTS,
    STANFORD_CE_WEIGHTS,
)
from occuseg_tpu_torch.models import InstanceDenseUNet, LearningBWDenseUNet
from occuseg_tpu_torch.train import checkpoint as ckpt
from occuseg_tpu_torch.train.config import plan_caps
from occuseg_tpu_torch.train.state import TrainConfig, Trainer
from occuseg_tpu_torch.train.torch_import import load_baseline_checkpoint
from occuseg_tpu_torch.utils.metrics import (
    confusion_matrix,
    iou_from_confusion,
)
from occuseg_tpu_torch.utils.profiling import (
    CounterState,
    plan_hidden_count,
    plan_muladd_count,
)

log = logging.getLogger("occuseg_tpu_torch")

_NOT_PORTED = "not ported yet (ROADMAP {})"


def _device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; pass device='cpu' to run on the "
                           "CPU")
    return dev


def build_model(config: Dict, generator: Optional[torch.Generator] = None):
    """The config's model with f32 parameters and activations (the JAX
    package's default), initialised from `generator`: the
    `input_feature_number` input channels of the `use_feature` string, and
    normal-guided convolutions under `use_normal`."""
    planes = tuple(int(x) for x in config["unet_structure"])
    cls = (LearningBWDenseUNet if config.get("use_dense_model")
           else InstanceDenseUNet)
    return cls(planes, num_classes=config.get("class_num", 20),
               block_reps=config.get("block_reps", 1),
               residual_blocks=config.get("residual_blocks", True),
               in_features=int(config.get("input_feature_number", 3)),
               normal_guided=bool(config.get("use_normal", False)),
               generator=generator)


def build_spec(config: Dict) -> PlanSpec:
    """The plan spec; under --use_normal, orientation classes at levels
    0..rotation_guide_level (the reference's normal_guide_scale =
    (full_scale >> rotation_guide_level) + 1)."""
    guide = (int(config.get("rotation_guide_level", 0)) + 1
             if config.get("use_normal") else None)
    return PlanSpec(caps=tuple(plan_caps(config)),
                    kernel=config.get("kernel_size", 3), guide_levels=guide)


def _synthetic_dataset(config: Dict):
    """Stand-in dataset when --data_dir has no scenes: 32 training and 4
    validation scenes of 20k points, at most 4 scenes per batch."""
    class _Synth:
        def __init__(self):
            self.train = list(range(32))
            self.val = list(range(4))
            self.scene = SceneConfig(num_points=20000, extent=256,
                                     scale=config["scale"])

        def train_batches(self, rng, p_cap, i_cap, batch_size):
            for _ in range(0, len(self.train), batch_size):
                yield make_batch(self.scene, min(batch_size, 4), p_cap,
                                 i_cap, seed=int(rng.integers(1 << 30)))

        def val_batches(self, p_cap, i_cap, batch_size, val_rep=0):
            for s in range(0, len(self.val), batch_size):
                yield make_batch(self.scene, min(batch_size, 4), p_cap,
                                 i_cap, seed=1000 + s)

    return _Synth()


def get_dataset(config: Dict):
    """`ScanNetData` over the scenes under `--data_dir` (every scene loaded
    up front; one that cannot be read raises), or the synthetic generator
    when it holds no training scenes."""
    ds = ScanNetData(config)
    ds.load_data()
    if not ds.train:
        log.warning("no scenes under %s: using the synthetic generator",
                    config.get("data_dir"))
        return _synthetic_dataset(config)
    return ds


def plan_prefetcher(batches: Iterable[Dict], spec: PlanSpec,
                    bucket_specs_list=None, ns: int = 1, pin: bool = False
                    ) -> Iterator[Tuple[Dict, object, int]]:
    """Yield (laid-out batch, host plan, bucket index), each prepared ahead
    in one worker thread: a `PlanPool` of one worker (`PlanPool._build`
    says what the options do)."""
    with PlanPool(spec, 1, bucket_specs_list, ns=ns, pin=pin) as pool:
        yield from pool.imap(batches)


def checkpoint_path(path: str) -> str:
    """The port's checkpoint at `path`: the file itself, or the newest in
    the directory. Raises on anything else."""
    if os.path.isdir(path) and ckpt.latest_checkpoint(path):
        path = ckpt.latest_checkpoint(path)
    if not ckpt.is_checkpoint(path):
        raise ValueError(f"{path}: not a checkpoint of the port "
                         f"(step_<N>.pth, or a directory of them)")
    return path


def _restore(trainer: Trainer, path: str, config: Dict) -> str:
    """--checkpoint_file: a checkpoint of the port restores the whole
    training state; another `.pth`/`.pt` file is the reference's, whose
    weights and BN statistics are imported (the optimizer starts
    afresh)."""
    if not (os.path.isdir(path) or ckpt.is_checkpoint(path)) \
            and path.endswith((".pth", ".pt")):
        load_baseline_checkpoint(
            path, trainer.model,
            tuple(int(x) for x in config["unet_structure"]),
            config.get("block_reps", 1), config.get("residual_blocks", True))
        return path
    path = checkpoint_path(path)
    trainer.load_state_dict(ckpt.restore_checkpoint(path,
                                                    map_location="cpu"))
    return path


def train(config: Dict, max_steps: Optional[int] = None, device="cuda",
          on_start: Optional[Callable[[Trainer], None]] = None) -> Dict:
    """Train on one device. Returns dict(trainer, model, spec, steps,
    losses (the last epoch's mean loss parts), timings, ckpt_dir):
    timings["wait_ms"] is the time this thread waited for each
    prepared batch, timings["step_ms"] each step's time to its loss values
    on the host (the upload, the step and a synchronization).
    `on_start(trainer)` runs once, after any restore, before the first
    step."""
    if int(config.get("num_devices") or 1) > 1:
        raise NotImplementedError("--num_devices > 1: data parallelism is "
                                  + _NOT_PORTED.format("A9"))
    if int(config.get("spatial_shards", 0) or 0) > 1:
        raise NotImplementedError("--spatial_shards > 1: spatial sharding "
                                  "is " + _NOT_PORTED.format("A9"))
    dev = _device(device)
    rng = np.random.default_rng(100)  # the reference's seed
    model = build_model(config, torch.Generator().manual_seed(0))
    spec = build_spec(config)
    dataset = get_dataset(config)
    p_cap = config["point_cap"]
    i_cap = config["instance_cap"]
    batch_per_dev = max(int(config["batch_size"]), 1)
    # multi-scene batches take the blocked layout (native/blocked.py)
    blocked_ns = (batch_per_dev if batch_per_dev > 1
                  and config.get("blocked_batch", True) else 1)
    tcfg = TrainConfig(
        lr=config["lr"],
        lr_decay_gamma=config["gamma"] if config["gamma"] > 0 else 1e-2,
        lr_decay_steps=config.get("step_size", 60000),
        optimizer=config.get("optim", "Adam").lower(),
        accum_steps=int(config.get("accum_steps", 1)))
    lcfg = LossConfig(
        regress_weight=config.get("regress_weight", 100.0),
        num_classes=config.get("class_num", 20),
        semantic_loss=config.get("loss", "cross_entropy"),
        ce_weights=(STANFORD_CE_WEIGHTS
                    if config.get("dataset") == "stanford3d"
                    else SCANNET_CE_WEIGHTS),
        drift_weight=float(config.get("drift_weight", 0.0)))
    trainer = Trainer(model, dev, tcfg, lcfg, num_instances=i_cap,
                      num_scenes=batch_per_dev)

    start_epoch = int(config.get("checkpoint", 0) or 0)
    if config.get("load"):
        path = _restore(trainer, str(config["load"]), config)
        log.info("resumed from %s (start epoch %d)", path, start_epoch)

    buckets = None
    if int(config.get("num_buckets", 1)) > 1:
        from occuseg_tpu_torch.train.bucketing import bucket_specs
        buckets = bucket_specs(config["voxel_cap"],
                               len(config["unet_structure"]),
                               int(config["num_buckets"]),
                               kernel=config.get("kernel_size", 3),
                               guide_levels=spec.guide_levels)

    ckpt_dir = os.path.join(config["checkpoints_dir"],
                            config.get("taskname", "default"))
    writer = None
    try:
        from torch.utils.tensorboard import SummaryWriter
        writer = SummaryWriter(os.path.join(ckpt_dir, "tb"))
        writer.add_text("config", str(config))
    except Exception:  # TensorBoard is optional
        writer = None

    planes = tuple(int(x) for x in config["unet_structure"])
    timings: Dict[str, list] = {"wait_ms": [], "step_ms": []}
    if on_start is not None:
        on_start(trainer)
    step = 0
    losses: Dict[str, float] = {}
    # --plan_workers 0 or 1: one prefetch thread
    plan_pool = PlanPool(spec, int(config.get("plan_workers", 0) or 0),
                         bucket_specs_list=buckets, ns=blocked_ns,
                         pin=dev.type == "cuda",
                         chunks=bool(config.get("chunk_conv", 1)))
    try:
        for epoch in range(start_epoch, int(config.get("max_epoch", 1))):
            t0 = time.time()
            agg: Dict[str, float] = {}
            nb = 0
            counters = CounterState()
            batches = dataset.train_batches(rng, p_cap, i_cap, batch_per_dev)
            source = plan_pool.imap(batches)
            while True:
                tw = time.perf_counter()
                item = next(source, None)
                if item is None:
                    break
                raw, host_plan, _ = item
                ts = time.perf_counter()
                parts = trainer.step(raw, host_plan)
                # host work while the card runs the queued step
                counters.add(
                    plan_muladd_count(host_plan, planes,
                                      config.get("block_reps", 1),
                                      config.get("residual_blocks", True),
                                      config["input_feature_number"]),
                    plan_hidden_count(host_plan, planes),
                    scenes=batch_per_dev)
                for k, v in parts.items():
                    agg[k] = agg.get(k, 0.0) + float(v)
                timings["wait_ms"].append(1e3 * (ts - tw))
                timings["step_ms"].append(1e3 * (time.perf_counter() - ts))
                nb += 1
                step += 1
                if max_steps is not None and step >= max_steps:
                    break
            dt = time.time() - t0
            losses = {k: v / max(nb, 1) for k, v in agg.items()}
            msg = " ".join(f"{k}={v:.4f}" for k, v in sorted(losses.items()))
            log.info("epoch %d: %s (%.1fs, %d steps)", epoch, msg, dt, nb)
            log.info("epoch %d: %s", epoch, counters.report())
            if writer:
                for k, v in losses.items():
                    writer.add_scalar(f"train/{k}", v, epoch)
                writer.add_scalar("train/epoch_time", dt, epoch)
            if (epoch + 1) % max(int(config.get("snapshot", 1)), 1) == 0:
                ckpt.save_checkpoint(ckpt_dir, trainer.state_dict(),
                                     step=epoch + 1)
                ckpt.gc_checkpoints(ckpt_dir)
                # the reference evaluates at every snapshot
                if config.get("eval_on_snapshot", True) and max_steps is None:
                    metrics = evaluate_semantic(config, trainer, spec,
                                                dataset=dataset)
                    log.info("epoch %d val mean IoU: %.4f", epoch,
                             metrics["mean_iou"])
                    if writer:
                        writer.add_scalar("val/mean_iou",
                                          metrics["mean_iou"], epoch)
            if max_steps is not None and step >= max_steps:
                break
    except KeyboardInterrupt:
        ckpt.save_checkpoint(os.path.join(ckpt_dir, "INTERRUPTED"),
                             trainer.state_dict(), step=step)
        raise
    finally:
        plan_pool.close()
        if writer:
            writer.close()
    return {"trainer": trainer, "model": model, "spec": spec, "steps": step,
            "losses": losses, "timings": timings, "ckpt_dir": ckpt_dir}


def evaluate_semantic(config: Dict, trainer: Trainer, spec: PlanSpec,
                      dataset=None) -> Dict:
    """Semantic eval: mean IoU over the validation split, summing the
    logits of `val_reps` views per scene, each scene through
    `infer.prepare_scene` (with the scene's normals under --use_normal, as
    the JAX loop's eval step takes them) and the `Predictor` (eval-mode
    BN)."""
    if dataset is None:
        dataset = get_dataset(config)
    p_cap = config["point_cap"]
    i_cap = config["instance_cap"]
    reps = max(int(config.get("val_reps", 1)), 1)
    ncls = int(config.get("class_num", 20))
    use_normals = bool(config.get("use_normal"))
    chunks = bool(config.get("chunk_conv", 1))
    predictor = Predictor(trainer.model, trainer.device)
    conf = torch.zeros((ncls, ncls), dtype=torch.int64)
    try:
        per_rep = [dataset.val_batches(p_cap, i_cap, 1, val_rep=r)
                   for r in range(reps)]
        for raws in zip(*per_rep):
            store = None
            for raw in raws:
                scene = prepare_scene(raw["coords"], raw["features"], spec,
                                      raw["normals"] if use_normals else None,
                                      chunks)
                logits = predictor(scene).semantics.float()
                store = logits if store is None else store + logits
            gt = torch.as_tensor(raws[-1]["labels"], device=store.device)
            conf += confusion_matrix(store.argmax(-1), gt, ncls).cpu()
    finally:
        trainer.model.train()
    return iou_from_confusion(conf.numpy())
