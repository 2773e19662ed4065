"""ScanNet benchmark submission writer (reference
`evaluate_instance.py:1223-1248` write_results): per scene a main .txt with
lines `predicted_masks/<scene>_<i>.txt <label_id> <confidence>` plus one
0/1 mask file per proposal, using the NYU40 label ids of the 20 classes.

A copy of `occuseg_tpu/cluster/submission.py`, which the port cannot import
(importing `occuseg_tpu` imports jax).
"""

from __future__ import annotations

import os
from typing import List, Sequence

import numpy as np

# class index -> NYU40 label id (reference prepare_data VALID_CLASS_IDS)
VALID_CLASS_IDS = np.array(
    [1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 14, 16, 24, 28, 33, 34, 36, 39])


def write_scene_submission(out_dir: str, scene_name: str,
                           proposals: Sequence[List[np.ndarray]],
                           confidences: Sequence[List[float]] = None) -> str:
    """proposals: per-class lists of boolean point masks."""
    mask_dir = os.path.join(out_dir, "predicted_masks")
    os.makedirs(mask_dir, exist_ok=True)
    main = os.path.join(out_dir, f"{scene_name}.txt")
    lines = []
    idx = 0
    for cls, masks in enumerate(proposals):
        for mi, mask in enumerate(masks):
            conf = 1.0
            if confidences is not None and confidences[cls]:
                conf = float(confidences[cls][mi])
            rel = f"predicted_masks/{scene_name}_{idx:03d}.txt"
            np.savetxt(os.path.join(out_dir, rel), mask.astype(np.int32),
                       fmt="%d")
            lines.append(f"{rel} {int(VALID_CLASS_IDS[cls])} {conf:.4f}")
            idx += 1
    with open(main, "w") as f:
        f.write("\n".join(lines) + ("\n" if lines else ""))
    return main
