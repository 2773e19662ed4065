"""Offline ScanNet-benchmark self-check (counterpart of
`scripts/fake_judge.py`): the benchmark's semantic IoU scorer over
submission `.txt` files, to check results before uploading.

    python -m occuseg_tpu_torch.scripts.fake_judge --pred_dir preds/ \
        --gt_dir gts/

Each file holds one label per line, aligned with the scene's vertices;
a prediction without its ground-truth file is skipped. Ground truth
outside [0, num_classes) is ignored and predictions are clipped into it,
as the JAX script does: it scores class indices, while `test_semantic`
writes NYU40 label ids (ROADMAP C item 4).
"""

from __future__ import annotations

import argparse
import glob
import os
from typing import Dict, Optional, Sequence

import numpy as np

from occuseg_tpu_torch.utils.metrics import iou_from_confusion


def confusion(pred_dir: str, gt_dir: str, num_classes: int) -> np.ndarray:
    """[num_classes, num_classes] counts (ground truth, prediction) over
    the prediction files that have ground truth."""
    conf = np.zeros((num_classes, num_classes), np.int64)
    for pf in sorted(glob.glob(os.path.join(pred_dir, "*.txt"))):
        gf = os.path.join(gt_dir, os.path.basename(pf))
        if not os.path.exists(gf):
            print(f"missing GT for {os.path.basename(pf)}; skipping")
            continue
        pred = np.loadtxt(pf, dtype=np.int64)
        gt = np.loadtxt(gf, dtype=np.int64)
        if pred.shape != gt.shape:
            raise ValueError(f"{pf}: {pred.shape[0]} labels, ground truth "
                             f"{gt.shape[0]}")
        valid = (gt >= 0) & (gt < num_classes)
        np.add.at(conf, (gt[valid], np.clip(pred[valid], 0,
                                            num_classes - 1)), 1)
    return conf


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    """Parse `argv` (default: the command line), score, print; returns
    `iou_from_confusion`'s metrics with the confusion under
    "confusion"."""
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--pred_dir", required=True)
    p.add_argument("--gt_dir", required=True)
    p.add_argument("--num_classes", type=int, default=20)
    args = p.parse_args(argv)
    conf = confusion(args.pred_dir, args.gt_dir, args.num_classes)
    res = iou_from_confusion(conf)
    print("per-class IoU:", np.round(res["iou_per_class"], 4))
    print("mean IoU: %.4f  accuracy: %.4f" % (res["mean_iou"],
                                              res["accuracy"]))
    return dict(res, confusion=conf)


if __name__ == "__main__":
    main()
