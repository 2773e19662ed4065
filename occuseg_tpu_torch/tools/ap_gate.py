"""The instance-AP gate (counterpart of `tests/test_accuracy_ap_gate.py`).

    python -m occuseg_tpu_torch.tools.ap_gate [--device cpu]

A deterministic overfit soak must reach an instance AP@0.5 floor through
the whole clustering cascade (`aggregate_regions` -> mean-shift ->
occupancy merge -> `filter_proposals` -> benchmark AP): one synthetic
scene (2500 points, extent 40, 6 objects, 16 instances), the
`LearningBWDenseUNet` at widths (8, 16, 24), Adam at lr 1e-3, 450 steps,
for each of the seeds 7, 8 and 9. The supervoxels are derived from the
ground truth (`gt_regions`), so the gate holds the model, the losses and
the cascade, not the supervoxel generator. The displacement head is held
directly: the per-instance spread of the regressed poses over that of
the raw poses (`contraction`) of the first seed.

The thresholds are the JAX test's and do not move: mean AP over the seeds
> 0.6, each seed > 0.35, contraction < 1.5.

Widths 8 and 24 are not multiples of 16, so those convolutions take the
gather path and the 16-wide ones the chunk kernels: one step runs both
(`nn/modules.chunk_route`). The model starts from the port's own seeded
initialisation unless `init` (a state_dict, e.g. the JAX package's initial
weights through `convert.from_flax`) is given. Every point array is scored
in the batch's original order, as the JAX test scores it.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from occuseg_tpu_torch.cluster import (
    aggregate_regions,
    filter_proposals,
    instance_average_precision,
    meanshift_cluster,
    occupancy_merge,
)
from occuseg_tpu_torch.cluster.evaluator import gt_instances
from occuseg_tpu_torch.cluster.meanshift import labels_to_points
from occuseg_tpu_torch.core.topology import PlanSpec
from occuseg_tpu_torch.data.synthetic import SceneConfig, make_batch
from occuseg_tpu_torch.infer import unpermute
from occuseg_tpu_torch.models import LearningBWDenseUNet
from occuseg_tpu_torch.models.occuseg import OccuSegOutputs
from occuseg_tpu_torch.train.state import TrainConfig, Trainer, prepare_batch

SPEC = PlanSpec(caps=(2048, 1024, 512))
SCENE = SceneConfig(num_points=2500, extent=40, num_objects=6)
P_CAP = 4096
NUM_INSTANCES = 16
N_PLANES = (8, 16, 24)
N_STEPS = 450
SEEDS = (7, 8, 9)
R_CAP = 256
# synthetic objects are ~260 points; the reference's class-size filter is
# scaled for real ScanNet rooms
CLASS_SIZES = np.full(20, 100.0, np.float32)
MEAN_AP_FLOOR = 0.6
SEED_AP_FLOOR = 0.35
CONTRACTION_CEIL = 1.5


def soak_batch(seed: int) -> Dict[str, np.ndarray]:
    return make_batch(SCENE, num_scenes=1, p_cap=P_CAP,
                      num_instances=NUM_INSTANCES, seed=seed)


def build_model(generator: Optional[torch.Generator] = None):
    return LearningBWDenseUNet(N_PLANES, num_classes=20, block_reps=1,
                               residual_blocks=True, generator=generator)


def gt_regions(batch: Dict[str, np.ndarray], valid: np.ndarray) -> np.ndarray:
    """Supervoxels from the ground truth: the 8-voxel cells of each
    instance, numbered in key order; -1 where not `valid`."""
    iid = np.asarray(batch["instance_id"])
    cell = (batch["coords"][:, 1:] // 8).astype(np.int64)
    key = (iid.astype(np.int64) + 1) * 1_000_000 + (
        cell[:, 0] * 10_000 + cell[:, 1] * 100 + cell[:, 2])
    _, region = np.unique(key, return_inverse=True)
    return np.where(valid, region.reshape(-1), -1).astype(np.int32)


def contraction(displacement: np.ndarray, batch: Dict[str, np.ndarray]
                ) -> float:
    """Mean per-instance spread of the regressed poses (pose -
    displacement) over that of the raw poses, summed over the foreground
    instances (class >= 2)."""
    pose = np.asarray(batch["pose"], np.float32)
    reg = pose - np.asarray(displacement, np.float32)
    iid = np.asarray(batch["instance_id"])
    fg = (iid >= 0) & (np.asarray(batch["labels"]) >= 2)
    num = den = 0.0
    for i in np.unique(iid[fg]):
        m = fg & (iid == i)
        num += float(np.linalg.norm(reg[m] - reg[m].mean(0), axis=1).mean())
        den += float(np.linalg.norm(pose[m] - pose[m].mean(0),
                                    axis=1).mean())
    return num / den


def instance_ap(out: OccuSegOutputs, batch: Dict[str, np.ndarray],
                region: np.ndarray, valid: np.ndarray) -> float:
    """AP@0.5 of the cascade on outputs in the batch's point order (torch
    tensors on one device)."""
    dev = out.semantics.device
    sem_pred = out.semantics.argmax(-1)
    region_t = torch.as_tensor(region, device=dev)
    regions = aggregate_regions(
        out.embedding.float(), out.displacement.float(),
        torch.as_tensor(batch["pose"], dtype=torch.float32, device=dev),
        out.bw.float(), out.offset.float().reshape(-1), sem_pred,
        out.occupancy.float().reshape(-1), region_t, R_CAP)
    labels, _ = meanshift_cluster(regions)
    labels_np = occupancy_merge(
        labels.cpu().numpy(), regions.embedding.cpu().numpy(),
        regions.pose_embedding.cpu().numpy(), regions.bw.cpu().numpy(),
        regions.count.cpu().numpy(), regions.occupancy.cpu().numpy())
    pts = labels_to_points(torch.from_numpy(labels_np).to(dev),
                           region_t).cpu().numpy()
    props = filter_proposals(
        pts[valid], sem_pred.cpu().numpy()[valid],
        out.occupancy.float().cpu().numpy().reshape(-1)[valid],
        class_sizes=CLASS_SIZES, occupancy_lo=0.1, occupancy_hi=10.0)
    gts = gt_instances(batch["instance_id"][valid].astype(np.int64),
                       batch["labels"][valid].astype(np.int64))
    return float(instance_average_precision([props], [gts],
                                            iou_threshold=0.5)["mAP"])


@dataclasses.dataclass
class Soak:
    trainer: Trainer
    batch: Dict[str, np.ndarray]   # original point order
    laid: Dict[str, np.ndarray]    # the plan's point layout
    plan: object                   # on the trainer's device
    parts: List[Dict[str, float]]  # loss parts of every step
    step_ms: List[float]           # host ms of every step, loss values read


def soak(seed: int, device="cuda", steps: int = N_STEPS,
         init: Optional[Dict[str, torch.Tensor]] = None,
         on_step: Optional[Callable[[int, Dict[str, float]], None]] = None
         ) -> Soak:
    """`steps` training steps on the seed's scene from the seeded
    initialisation (or `init`); `on_step(i, parts)` runs after each. The
    scene's plan goes to the device once, with the maps its gather-path
    convolutions read."""
    batch = soak_batch(seed)
    laid, plan = prepare_batch(batch, SPEC)
    model = build_model(torch.Generator().manual_seed(0))
    if init is not None:
        model.load_state_dict(init)
    trainer = Trainer(model, device, TrainConfig(lr=1e-3),
                      num_instances=NUM_INSTANCES)
    plan = plan.to(trainer.device)
    parts, step_ms = [], []
    for i in range(steps):
        t0 = time.perf_counter()
        vals = {k: float(v) for k, v in trainer.step(laid, plan).items()}
        step_ms.append(1e3 * (time.perf_counter() - t0))
        parts.append(vals)
        if on_step is not None:
            on_step(i, vals)
    if steps and not np.isfinite(parts[-1]["total"]):
        raise FloatingPointError(f"seed {seed}: loss {parts[-1]}")
    return Soak(trainer, batch, laid, plan, parts, step_ms)


def outputs(s: Soak) -> OccuSegOutputs:
    """The eval forward on the soak's scene, in the batch's original point
    order."""
    out = s.trainer.evaluate(s.laid, s.plan)
    if s.plan.point_perm is None:
        return out
    perm = torch.as_tensor(s.plan.point_perm, device=s.trainer.device)
    n = s.batch["labels"].shape[0]
    return OccuSegOutputs(*(None if t is None else unpermute(t, perm)[:n]
                            for t in out))


def run(device="cuda", steps: int = N_STEPS, init=None,
        on_step=None) -> Dict:
    """The gate: per seed its AP, final loss parts and median step ms; the
    contraction of the first seed; the mean AP and whether every
    threshold holds. `on_step(seed, i, parts)` runs after each step."""
    per_seed, contr = {}, None
    for seed in SEEDS:
        s = soak(seed, device, steps, init,
                 None if on_step is None
                 else (lambda i, p, seed=seed: on_step(seed, i, p)))
        out = outputs(s)
        valid = np.asarray(s.batch["labels"]) >= 0
        ap = instance_ap(out, s.batch, gt_regions(s.batch, valid), valid)
        if contr is None:
            contr = contraction(out.displacement.float().cpu().numpy(),
                                s.batch)
        per_seed[seed] = dict(ap=ap, parts=s.parts[-1] if s.parts else {},
                              step_ms=float(np.median(s.step_ms))
                              if s.step_ms else None)
    aps = [r["ap"] for r in per_seed.values()]
    mean_ap = float(np.mean(aps))
    return dict(seeds=per_seed, mean_ap=mean_ap, contraction=contr,
                passed=bool(mean_ap > MEAN_AP_FLOOR
                            and min(aps) > SEED_AP_FLOOR
                            and contr < CONTRACTION_CEIL))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda")
    report = run(p.parse_args(argv).device)
    print(json.dumps(report))
    return 0 if report["passed"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
