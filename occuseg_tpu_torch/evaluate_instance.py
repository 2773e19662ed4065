"""Instance-segmentation evaluation (counterpart of
`scripts/evaluate_instance.py`): run the model on the val split, extract
instances by supervoxel mean-shift (+ optional occupancy merge or joint
refinement), filter proposals, report precision/recall and AP at IoU 0.25
and 0.5, and write `instance_stat.mat` to the working directory.

    python -m occuseg_tpu_torch.evaluate_instance --m 64 --use_dense_model \
        --residual_blocks --checkpoint_file ckpts/default_name --use_merge

The flags are the training CLI's (`train/config.py`) and the JAX script's
eight. Three modes, as there:

  * default: inference, then clustering and scoring, scene by scene;
  * `--dump DIR`: inference only: one .npz per scene in the reference's
    offline schema (`dump_scene`);
  * `--from_dump DIR`: no model: clustering and scoring of the dumped
    scenes, so that the clustering's settings can be swept without the
    net. It reproduces the inline proposals exactly: both share
    `cluster_and_score`, whose reductions run in a fixed order.

Every entry point runs on "cuda" and raises where there is no card,
unless the caller passes device="cpu". `--checkpoint_file` takes the
port's checkpoints (`train/checkpoint.py`); the reference's weights raise.
"""

from __future__ import annotations

import glob
import logging
import os
import time
from typing import Dict, Iterable, Iterator, Optional, Sequence, Tuple

import numpy as np
import torch

from occuseg_tpu_torch.cluster import (
    aggregate_regions,
    filter_proposals,
    instance_average_precision,
    instance_precision_recall,
    joint_refine,
    meanshift_cluster,
    occupancy_merge,
)
from occuseg_tpu_torch.cluster.evaluator import (
    gt_instances,
    per_proposal_statistics,
)
from occuseg_tpu_torch.cluster.meanshift import labels_to_points
from occuseg_tpu_torch.cluster.refine import region_mean
from occuseg_tpu_torch.infer import Predictor, prepare_scene
from occuseg_tpu_torch.models.occuseg import OccuSegOutputs
from occuseg_tpu_torch.train import checkpoint as ckpt
from occuseg_tpu_torch.train import config as train_config
from occuseg_tpu_torch.train.loop import (
    _device,
    build_model,
    build_spec,
    checkpoint_path,
    get_dataset,
)
from occuseg_tpu_torch.utils.profiling import record

log = logging.getLogger("occuseg_tpu_torch")

# the stats of `score_scenes` that `instance_stat.mat` stores under the
# reference's names
_MAT_NAMES = {"per_proposal": "stats", "pts_per_class": "pts_per_class",
              "predict_pts_per_class": "predict_pts_per_class"}


def get_parser():
    parser = train_config.get_parser()
    parser.add_argument("--use_merge", action="store_true", default=False)
    parser.add_argument("--use_joint_refine", action="store_true",
                        default=False,
                        help="joint semantic-instance refinement "
                             "(evaluate_instance.py:809-964): single-shot "
                             "seeded membership + membership-weighted "
                             "semantic re-vote")
    parser.add_argument("--region_cap", type=int, default=4096)
    parser.add_argument("--dump", default="",
                        help="write per-scene prediction .npz to this dir "
                             "and exit (no clustering)")
    parser.add_argument("--from_dump", default="",
                        help="cluster + score .npz predictions from this "
                             "dir (no model)")
    parser.add_argument("--bw_relax_factor", type=float, default=1.0)
    parser.add_argument("--merge_threshold", type=float, default=0.5)
    parser.add_argument("--occupancy_lo", type=float, default=0.3)
    parser.add_argument("--occupancy_hi", type=float, default=3.0)
    return parser


class _Laps:
    """Part times into `trace` (a dict, or None for no timing): each lap
    ends with a device synchronisation, so a part owns its device work,
    and is the span `eval.<part>` (`utils/profiling.py`)."""

    def __init__(self, dev: torch.device, trace: Optional[Dict]):
        self.dev, self.trace = dev, trace
        self.t = time.time_ns()

    def lap(self, name: str) -> None:
        if self.trace is None:
            return
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)
        now = time.time_ns()
        self.trace[name + "_ms"] = 1e3 * record("eval." + name, self.t, now)
        self.t = now


def cluster_and_score(scene: Dict, args, device="cuda",
                      trace: Optional[Dict] = None) -> tuple:
    """One scene's clustering: dump-schema dict -> (proposals, gts,
    semantic prediction per point).

    `scene` uses the reference offline_data keys (train_instance.py:143-163)
    as numpy arrays over the scene's REAL points (no padding rows). With
    `trace` (a dict), the ms of each part are written into it
    (aggregate_ms, cluster_ms, merge_ms with `--use_merge`, filter_ms),
    with the instance count (instances), the point labels (labels) and the
    region features (regions).
    """
    dev = _device(device)
    laps = _Laps(dev, trace)

    def on_dev(a):
        return torch.as_tensor(np.asarray(a)).to(dev)

    num_classes = int(scene["pred_semantic_probability"].shape[1])
    pose = scene["xyz"].astype(np.float32) / float(scene["scale"])
    region = on_dev(scene["regions"].astype(np.int32))
    sem_pred = on_dev(scene["pred_semantic"].astype(np.int32))
    regions = aggregate_regions(
        on_dev(scene["pred_embedding"]), on_dev(scene["pred_displacements"]),
        on_dev(pose), on_dev(scene["pred_bw"]),
        on_dev(scene["pred_offsets"].reshape(-1)), sem_pred,
        on_dev(scene["occupancy"].reshape(-1)), region, args.region_cap,
        num_classes=num_classes)
    laps.lap("aggregate")
    if args.use_joint_refine:
        # per-region mean class probability from the dumped point probs
        sem_prob = region_mean(
            on_dev(scene["pred_semantic_probability"]).float(), region,
            args.region_cap)
        labels, sem_ref, count = joint_refine(regions, sem_prob)
        sem_pred = labels_to_points(sem_ref, region)
    else:
        labels, count = meanshift_cluster(
            regions, bw_relax_factor=args.bw_relax_factor)
    labels_np = labels.cpu().numpy()
    laps.lap("cluster")
    if args.use_merge:
        labels_np = occupancy_merge(
            labels_np, regions.embedding.cpu().numpy(),
            regions.pose_embedding.cpu().numpy(), regions.bw.cpu().numpy(),
            regions.count.cpu().numpy(), regions.occupancy.cpu().numpy(),
            bw_relax_factor=args.bw_relax_factor,
            similarity_threshold=args.merge_threshold)
        laps.lap("merge")
    pts = labels_to_points(torch.from_numpy(labels_np).to(dev),
                           region).cpu().numpy()
    sem_np = sem_pred.cpu().numpy()
    props = filter_proposals(pts, sem_np, np.asarray(scene["occupancy"]),
                             occupancy_lo=args.occupancy_lo,
                             occupancy_hi=args.occupancy_hi,
                             num_classes=num_classes)
    gts = gt_instances(scene["true_instance"].astype(np.int64),
                       scene["true_semantic"].astype(np.int64),
                       num_classes=num_classes)
    laps.lap("filter")
    if trace is not None:
        trace.update(instances=count, labels=pts, regions=regions)
    return props, gts, sem_np


def dump_scene(raw: Dict, out: OccuSegOutputs, scale: float
               ) -> Dict[str, np.ndarray]:
    """One scene in the reference's offline_data schema
    (train_instance.py:143-163), over its valid rows: `raw` is a one-scene
    batch of `p_cap` rows (-1 coords on padding rows) and `out` the
    predictor's outputs in the same row order."""
    valid = np.asarray(raw["coords"])[:, 0] >= 0
    region = np.asarray(raw.get(
        "region", np.arange(valid.shape[0], dtype=np.int32) // 16))

    def host(t):
        return t.cpu().numpy()[valid]

    probs = torch.softmax(out.semantics.float(), dim=-1)
    return {
        "xyz": np.asarray(raw["pose"], np.float32)[valid] * scale,
        "feature": np.asarray(raw["features"])[valid],
        "occupancy": host(out.occupancy)[:, 0],
        "true_occupancy": np.asarray(raw["occupancy"])[valid, 0],
        "pred_semantic": host(torch.argmax(out.semantics, dim=-1)),
        "pred_semantic_probability": host(probs),
        "pred_embedding": host(out.embedding),
        "regions": region[valid],
        "true_semantic": np.asarray(raw["labels"])[valid],
        "true_instance": np.asarray(raw["instance_id"])[valid],
        "pred_offsets": host(out.offset),
        "true_offsets": np.asarray(raw["offsets"])[valid],
        "pred_displacements": host(out.displacement),
        "true_displacements": np.asarray(raw["displacements"])[valid],
        "pred_bw": host(out.bw),
        "scale": scale,
    }


def infer_scenes(config: Dict, args, model: Optional[torch.nn.Module] = None,
                 dataset=None, device="cuda"
                 ) -> Iterator[Tuple[str, Dict[str, np.ndarray]]]:
    """Yield (scene_name, dump-schema dict) for each val scene: each
    through `infer.prepare_scene` and the `Predictor` (eval-mode BN).
    `model` defaults to the config's, seeded, with `--checkpoint_file`'s
    weights when given; `dataset` to the config's."""
    dev = _device(device)
    spec = build_spec(config)
    if dataset is None:
        dataset = get_dataset(config)
    if model is None:
        model = build_model(config, torch.Generator().manual_seed(0))
        if config.get("load"):
            path = checkpoint_path(str(config["load"]))
            model.load_state_dict(ckpt.restore_checkpoint(
                path, map_location="cpu")["model"])
            log.info("restored %s", path)
    predictor = Predictor(model, dev)
    scale = float(config.get("scale", 20))
    for i, raw in enumerate(dataset.val_batches(config["point_cap"],
                                                config["instance_cap"], 1)):
        # no normals, as the JAX script's eval step is built without
        # use_normals (scripts/evaluate_instance.py:125): under --use_normal
        # every orientation class is 0, the identity filter
        scene = prepare_scene(raw["coords"], raw["features"], spec,
                              chunks=bool(config.get("chunk_conv", 1)))
        yield f"scene{i:04d}", dump_scene(raw, predictor(scene), scale)


def score_scenes(scenes: Iterable[Tuple[str, Dict]], args,
                 device="cuda") -> Dict:
    """Cluster and score (name, dump-schema dict) pairs: the reference's
    statistics (per-proposal blocks, points per class, precision and
    recall) and the benchmark AP at IoU 0.25 and 0.5, with each scene's
    proposals under "proposals"."""
    all_props, all_gts, per_scene_stats = [], [], []
    gt_pts = None
    pred_pts = None
    for name, scene in scenes:
        props, gts, sem_pred = cluster_and_score(scene, args, device)
        all_props.append(props)
        all_gts.append(gts)
        # per-proposal statistics block (reference instance_stat.mat
        # schema, evaluate_instance.py:1548-1552)
        per_scene_stats.append(
            per_proposal_statistics(props, gts, sem_pred))
        c_num = len(props)
        if gt_pts is None:
            gt_pts = np.zeros(c_num)
            pred_pts = np.zeros(c_num)
        for c in range(c_num):
            gt_pts[c] += sum(int(v.sum()) for v in gts[c])
            pred_pts[c] += sum(int(u.sum()) for u in props[c])

    stats = {"per_proposal": np.stack(per_scene_stats)
             if per_scene_stats else np.zeros((0, 0, 5, 1000)),
             "pts_per_class": gt_pts,
             "predict_pts_per_class": pred_pts}
    for thr in (0.25, 0.5):
        # reference-parity metric (precision reported as "mAP",
        # evaluate_instance.py:1703-1741) ...
        res = instance_precision_recall(all_props, all_gts,
                                        iou_threshold=thr)
        log.info("ref-mAP@%.2f: %.4f  mRecall@%.2f: %.4f", thr,
                 res["mAP"], thr, res["mRecall"])
        stats[f"precision_{int(thr*100)}"] = res["precision_per_class"]
        stats[f"recall_{int(thr*100)}"] = res["recall_per_class"]
        # ... and the benchmark-grade AP (ranked PR curve, one-to-one
        # matching: the ScanNet protocol)
        ap = instance_average_precision(all_props, all_gts,
                                        iou_threshold=thr)
        log.info("AP@%.2f: %.4f (benchmark protocol)", thr, ap["mAP"])
        stats[f"ap_{int(thr*100)}"] = ap["ap_per_class"]
    stats["proposals"] = all_props
    return stats


def main(argv: Optional[Sequence[str]] = None, device="cuda"
         ) -> Optional[Dict]:
    """Parse `argv` (default: the command line) and evaluate; returns
    `score_scenes`' stats (None with `--dump`)."""
    logging.basicConfig(level=logging.INFO)
    args = get_parser().parse_args(argv)
    config = train_config.args_to_config(args)
    config["use_dense_model"] = True
    dev = _device(device)

    if args.from_dump:
        files = sorted(glob.glob(os.path.join(args.from_dump, "*.npz")))
        if not files:
            raise SystemExit(f"no .npz files under {args.from_dump}")
        log.info("offline clustering over %d dumped scenes", len(files))
        scenes = ((os.path.basename(f),
                   dict(np.load(f, allow_pickle=False))) for f in files)
        stats = score_scenes(scenes, args, dev)
    elif args.dump:
        os.makedirs(args.dump, exist_ok=True)
        for name, scene in infer_scenes(config, args, device=dev):
            fn = os.path.join(args.dump, f"{name}.npz")
            np.savez(fn, **scene)
            log.info("save: %s", fn)
        return None
    else:
        stats = score_scenes(infer_scenes(config, args, device=dev), args,
                             dev)

    # instance statistics export (reference instance_stat.mat,
    # evaluate_instance.py:1548-1552, :1699: 'stats' [files, class_num, 5,
    # 1000], 'pts_per_class', 'predict_pts_per_class'); the per-class
    # PR/AP aggregates ride along
    import scipy.io
    mat = {_MAT_NAMES.get(k, k): v for k, v in stats.items()
           if k != "proposals"}
    scipy.io.savemat("instance_stat.mat", mat)
    log.info("wrote instance_stat.mat")
    return stats


if __name__ == "__main__":
    main()
