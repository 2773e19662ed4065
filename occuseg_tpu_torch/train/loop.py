"""Training and evaluation loop (counterpart of
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
MulAdd counters and wall time in one log line, the loader and step
timings of `loader_report` in another (and TensorBoard when it is
installed), a checkpoint every `snapshot` epochs with power-of-two
retention, and the semantic eval. `--checkpoint_file` (config "load")
resumes from a checkpoint of the port, or imports the weights and BN
statistics of the reference's `.pth`/`.pt` file (`train/torch_import.py`).

Called in a process that has joined an n-rank process group
(`parallel/data_parallel.py`; `train.cli` spawns the ranks for
`--num_devices`, or joins torchrun's), `train` is one rank of it: the
epoch's batches of batch_size / n scenes go to the ranks in groups of n
(the remainder group padded at loss weight 0), each rank makes, plans and
steps only its own member, and one all-reduce a step averages the
gradients, loss parts and BN statistics; rank 0 alone logs, checkpoints
and evaluates, and the others wait for it at a barrier. Otherwise it
trains on one device.

With `--spatial_shards` D > 1 the process group's D ranks are the shards
of every batch instead (`parallel/spatial_model.py`): every rank draws
the same batches and builds the same host plan of the whole batch (no
blocked layout, no chunk rulebooks, no point layout, as the JAX loop,
`occuseg_tpu/train/loop.py:149-155`, `:300-304`), shards it
(`--spatial_halo` / `--spatial_pool` rows, per-shard chunk rulebooks
unless --chunk_conv 0) and keeps its own slice; each step averages the
gradients over the ranks. Rank 0 logs, checkpoints and evaluates (the
eval unsharded), as under data parallelism. Spatial shards and more than
one data-parallel device do not combine (the JAX package has no such
mesh), and the normal-guided convolutions run their identity filters
under sharding, as the JAX package's do (its sharded plan carries no
orientation classes). The entry
points run on "cuda" and raise where there is no card, unless the caller
passes device="cpu". Unlike the JAX loop, a scene file that cannot be
read and a failing snapshot eval are not caught: they stop the run.
"""

from __future__ import annotations

import functools
import logging
import os
import time
from collections import deque
from typing import Callable, Dict, Iterable, Iterator, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

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
from occuseg_tpu_torch.models import ARCHS
from occuseg_tpu_torch.parallel import data_parallel
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
    snapshot,
    span,
)

log = logging.getLogger("occuseg_tpu_torch")


def _device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; pass device='cpu' to run on the "
                           "CPU")
    return dev


def build_model(config: Dict, generator: Optional[torch.Generator] = None):
    """The model of the config's architecture (`models.ARCHS`, --arch),
    with f32 parameters and activations (the JAX package's default),
    initialised from `generator`."""
    return ARCHS[config.get("arch", "occuseg")].build(config, generator)


def build_spec(config: Dict) -> PlanSpec:
    """The plan spec; under --use_normal, orientation classes at levels
    0..rotation_guide_level (the reference's normal_guide_scale =
    (full_scale >> rotation_guide_level) + 1); and the fields the
    architecture needs (`models.ARCHS`)."""
    guide = (int(config.get("rotation_guide_level", 0)) + 1
             if config.get("use_normal") else None)
    return PlanSpec(caps=tuple(plan_caps(config)),
                    kernel=config.get("kernel_size", 3), guide_levels=guide,
                    **ARCHS[config.get("arch", "occuseg")].plan())


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
            for make in self.train_batch_makers(rng, p_cap, i_cap,
                                                batch_size):
                yield make()

        def train_batch_makers(self, rng, p_cap, i_cap, batch_size,
                               own_rng=False):
            # each batch is made from its seed alone
            for _ in range(0, len(self.train), batch_size):
                yield functools.partial(
                    make_batch, self.scene, min(batch_size, 4), p_cap, i_cap,
                    seed=int(rng.integers(1 << 30)))

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


def loader_report(before: Dict, after: Dict) -> str:
    """The loader's and the loop's numbers between two
    `utils.profiling.snapshot()`s: the mean wait for a planned batch and
    step time (ms, the spans `loop.wait` and `loop.step`), the mean queue
    depth when the loop took a batch (`pool.ready_at_take` over the
    batches planned, `plan.batch`), chunk-plan attempts a batch
    (`plan.chunk_try`), batches whose chunk budgets were raised
    (`plan.tier_raised`) and maps left on the gather path
    (`plan.gather_maps`)."""
    def spans(name):
        a = before["spans"].get(name, {"count": 0, "seconds": 0.0})
        b = after["spans"].get(name, {"count": 0, "seconds": 0.0})
        return b["count"] - a["count"], b["seconds"] - a["seconds"]

    def counter(name):
        return after["counters"].get(name, 0) - before["counters"].get(
            name, 0)

    (nw, wait), (ns, stepped) = spans("loop.wait"), spans("loop.step")
    batches = max(spans("plan.batch")[0], 1)
    return (f"wait_ms={1e3 * wait / max(nw, 1):.1f} "
            f"step_ms={1e3 * stepped / max(ns, 1):.1f} "
            f"queue_depth={counter('pool.ready_at_take') / batches:.2f} "
            f"chunk_tries={spans('plan.chunk_try')[0] / batches:.2f}/batch "
            f"tier_raised={counter('plan.tier_raised')} "
            f"gather_maps={counter('plan.gather_maps')}")


def plan_prefetcher(batches: Iterable[Dict], spec: PlanSpec,
                    bucket_specs_list=None, ns: int = 1, pin: bool = False
                    ) -> Iterator[Tuple[Dict, object, int]]:
    """Yield (laid-out batch, host plan, bucket index), each prepared ahead
    in one worker thread: a `PlanPool` of one worker (`PlanPool` says
    what the options do)."""
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


def _ranks(config: Dict) -> Tuple[int, int]:
    """(rank, ranks) of this process: its place in the process group it
    has joined, (0, 1) when none. An explicit --num_devices n > 1 must be
    that group's size (the launchers, `train.cli` and torchrun, start and
    join the ranks; `train` does not)."""
    rank, n = data_parallel.world()
    requested = int(config.get("num_devices") or 0)
    if requested > 1 and requested != n:
        raise ValueError(f"--num_devices {requested}: train() is one rank "
                         f"of a {requested}-rank process group, and this "
                         f"process is in one of {n}; run it through "
                         f"occuseg_tpu_torch.train.cli (which spawns the "
                         f"ranks) or torchrun")
    return rank, n


def build_trainer(config: Dict, dev, num_scenes: int) -> Trainer:
    """The config's model (`build_model`, seed 0), optimizer and loss for
    steps of `num_scenes` scenes on `dev`."""
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
    model = build_model(config, torch.Generator().manual_seed(0))
    return Trainer(model, dev, tcfg, lcfg,
                   num_instances=config["instance_cap"],
                   num_scenes=num_scenes)


def train(config: Dict, max_steps: Optional[int] = None, device="cuda",
          on_start: Optional[Callable[[Trainer], None]] = None) -> Dict:
    """Train on one device, or as one rank of the joined process group
    (`_ranks`). Returns dict(trainer, model, spec, steps, losses (the last
    epoch's mean loss parts, the ranks' weighted means), timings, ckpt_dir):
    timings["wait_ms"] is the time this thread waited for each prepared
    batch (the span `loop.wait`), timings["step_ms"] each step's time to
    its loss values on the host (the upload, the step, the all-reduce and
    a synchronization; the span `loop.step`).
    `on_start(trainer)` runs once, after any restore, before the first
    step."""
    rank, n_dev = _ranks(config)
    spatial = _spatial(config, rank, n_dev)
    dev = data_parallel.rank_device(_device(device), rank)
    rng = np.random.default_rng(100)  # the reference's seed
    spec = build_spec(config)
    dataset = get_dataset(config)
    p_cap = config["point_cap"]
    i_cap = config["instance_cap"]
    # the JAX loop's arithmetic (occuseg_tpu/train/loop.py:293-295): a
    # spatially sharded batch is divided by the data-parallel devices
    batch_per_dev = max(int(config["batch_size"]) // (
        n_dev if spatial is None else data_parallel.num_devices(
            config.get("num_devices"), device)), 1)
    # multi-scene batches take the blocked layout (native/blocked.py);
    # sharded batches keep one layout over the concatenated scenes
    blocked_ns = (batch_per_dev if batch_per_dev > 1 and spatial is None
                  and config.get("blocked_batch", True) else 1)
    dp = n_dev > 1 and spatial is None
    trainer = build_trainer(config, dev, batch_per_dev)
    model = trainer.model

    start_epoch = int(config.get("checkpoint", 0) or 0)
    if config.get("load"):
        path = _restore(trainer, str(config["load"]), config)
        log.info("resumed from %s (start epoch %d)", path, start_epoch)

    # each rank plans its own member at its own cap bucket: the JAX loop's
    # group-wide bucket (occuseg_tpu/train/loop.py:238-243) exists only
    # because it stacks the group's plans into one array
    buckets = None
    if int(config.get("num_buckets", 1)) > 1:
        from occuseg_tpu_torch.train.bucketing import bucket_specs
        buckets = bucket_specs(config["voxel_cap"],
                               len(config["unet_structure"]),
                               int(config["num_buckets"]), spec)

    ckpt_dir = os.path.join(config["checkpoints_dir"],
                            config.get("taskname", "default"))
    lead = rank == 0   # logs, checkpoints and evaluates
    writer = None
    try:
        if lead:
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
    workers = int(config.get("plan_workers", 0) or 0)
    plan_pool = PlanPool(spec, workers, bucket_specs_list=buckets,
                         ns=blocked_ns, pin=dev.type == "cuda",
                         chunks=bool(config.get("chunk_conv", 1)),
                         spatial=spatial,
                         threads=data_parallel.share_cores(max(workers, 1),
                                                           n_dev))
    try:
        for epoch in range(start_epoch, int(config.get("max_epoch", 1))):
            t0 = time.time()
            agg: Dict[str, float] = {}
            nb = 0
            counters = CounterState()
            at_start = snapshot()
            weights: deque = deque()   # each queued batch's loss weight
            if dp:
                # every rank draws the same groups, and makes only its
                # member of each, at the member's loss weight
                makers = dataset.train_batch_makers(
                    rng, p_cap, i_cap, batch_per_dev, own_rng=True)
                members = ((group[rank], ws[rank]) for group, ws in
                           data_parallel.dp_groups(makers, n_dev))
            else:
                members = ((make, None) for make in
                           dataset.train_batch_makers(rng, p_cap, i_cap,
                                                      batch_per_dev))

            def batches():
                for make, w in members:
                    weights.append(w)
                    yield make()
            source = plan_pool.imap(batches())
            while True:
                with span("loop.wait") as waited:
                    item = next(source, None)
                if item is None:
                    break
                raw, host_plan, _ = item
                with span("loop.step") as stepped:
                    weight = weights.popleft()
                    if spatial is not None:  # host_plan: this rank's
                        parts = trainer.step(raw, shard_args=host_plan)
                    else:
                        parts = trainer.step(raw, host_plan, weight=weight)
                    # host work while the card runs the queued step; a
                    # rank counts its own member, a padding copy not at
                    # all (and, as the JAX loop, a sharded step not at
                    # all)
                    if spatial is None and (weight is None or weight > 0):
                        counters.add(
                            _muladds(model, host_plan, planes, config),
                            plan_hidden_count(host_plan, planes),
                            scenes=batch_per_dev)
                    for k, v in parts.items():
                        agg[k] = agg.get(k, 0.0) + float(v)
                timings["wait_ms"].append(1e3 * waited.seconds)
                timings["step_ms"].append(1e3 * stepped.seconds)
                nb += 1
                step += 1
                if max_steps is not None and step >= max_steps:
                    break
            dt = time.time() - t0
            losses = {k: v / max(nb, 1) for k, v in agg.items()}
            if dp:
                counters = _all_ranks(counters, dev)
            msg = " ".join(f"{k}={v:.4f}" for k, v in sorted(losses.items()))
            if lead:
                log.info("epoch %d: %s (%.1fs, %d steps)", epoch, msg, dt,
                         nb)
                log.info("epoch %d: %s", epoch, counters.report())
                log.info("epoch %d: %s", epoch,
                         loader_report(at_start, snapshot()))
            if writer:
                for k, v in losses.items():
                    writer.add_scalar(f"train/{k}", v, epoch)
                writer.add_scalar("train/epoch_time", dt, epoch)
            if lead and (epoch + 1) % max(int(config.get("snapshot", 1)),
                                          1) == 0:
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
            if n_dev > 1:
                # the other ranks wait out rank 0's snapshot here, not in
                # the next step's all-reduce (data_parallel.TIMEOUT)
                dist.barrier()
            if max_steps is not None and step >= max_steps:
                break
    except KeyboardInterrupt:
        if lead:
            ckpt.save_checkpoint(os.path.join(ckpt_dir, "INTERRUPTED"),
                                 trainer.state_dict(), step=step)
        raise
    finally:
        plan_pool.close()
        if writer:
            writer.close()
    return {"trainer": trainer, "model": model, "spec": spec, "steps": step,
            "losses": losses, "timings": timings, "ckpt_dir": ckpt_dir}


def _muladds(model, plan, planes, config: Dict) -> int:
    """The forward's MulAdds on a host plan: the model's own count where
    it has one (`plan_muladds`), else the UNet's (`plan_muladd_count`)."""
    if hasattr(model, "plan_muladds"):
        return model.plan_muladds(plan)
    return plan_muladd_count(plan, planes, config.get("block_reps", 1),
                             config.get("residual_blocks", True),
                             config["input_feature_number"])


def _spatial(config: Dict, rank: int, n_dev: int) -> Optional[Dict]:
    """The PlanPool's `spatial` options of --spatial_shards D > 1 (None
    without): D must be the size of the process group this process has
    joined, and --num_devices at most 1."""
    D = int(config.get("spatial_shards", 0) or 0)
    if D <= 1:
        return None
    if int(config.get("num_devices") or 0) > 1:
        raise ValueError("--spatial_shards with --num_devices > 1: spatial "
                         "sharding and data parallelism do not combine (the "
                         "JAX package has no such mesh)")
    if n_dev != D:
        raise ValueError(f"--spatial_shards {D}: train() is one shard of a "
                         f"{D}-rank process group, and this process is in "
                         f"one of {n_dev}; run it through "
                         f"occuseg_tpu_torch.train.cli (which spawns the "
                         f"ranks) or torchrun")
    if config.get("use_normal"):
        log.warning("--use_normal with --spatial_shards: the sharded plan "
                    "has no orientation classes, so the normal-guided "
                    "convolutions run their identity filters (as in the "
                    "JAX package)")
    return dict(num_shards=D, halo=int(config.get("spatial_halo", 4096)),
                pool=int(config.get("spatial_pool", 4096)), rank=rank)


def _all_ranks(counters: CounterState, dev) -> CounterState:
    """The epoch's counters summed over the ranks."""
    t = torch.tensor([counters.muladd, counters.hidden, counters.scenes],
                     dtype=torch.float64, device=dev)
    dist.all_reduce(t)
    muladd, hidden, scenes = t.tolist()
    return CounterState(muladd, hidden, int(scenes))


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
