"""S3DIS (Stanford 2D-3D-S) dataset support (counterpart of
`occuseg_tpu/data/s3dis.py`): the reference's transfer dataset
(`--dataset` branch in `train_instance.py` / `evaluate_instance.py`,
Stanford metrics at `examples/ScanNet/utils.py:322-380`).

Converts Area_*/room_*/Annotations/*.txt rooms into the same npz schema as
`data/prepare.py`, after which `ScanNetData` loads them unchanged.
"""

from __future__ import annotations

import glob
import os
from typing import Dict, List

import numpy as np

from occuseg_tpu_torch.data.supervoxel_gen import segment_supervoxels
from occuseg_tpu_torch.utils.metrics import STANFORD_CLASS_LABELS

LABEL_TO_ID = {name: i for i, name in enumerate(STANFORD_CLASS_LABELS)}


def prepare_room(room_dir: str, out_dir: str) -> str:
    """One room dir with Annotations/<class>_<k>.txt files (x y z r g b)."""
    coords_all: List[np.ndarray] = []
    colors_all: List[np.ndarray] = []
    labels_all: List[np.ndarray] = []
    inst_all: List[np.ndarray] = []
    inst_id = 0
    for f in sorted(glob.glob(os.path.join(room_dir, "Annotations",
                                           "*.txt"))):
        cls_name = os.path.basename(f).split("_")[0]
        cls = LABEL_TO_ID.get(cls_name, len(STANFORD_CLASS_LABELS) - 1)
        data = np.loadtxt(f, dtype=np.float32)
        if data.ndim == 1:
            data = data[None]
        n = data.shape[0]
        coords_all.append(data[:, :3])
        colors_all.append((data[:, 3:6] / 255.0 - 0.5) * 2
                          if data.shape[1] >= 6 else np.zeros((n, 3),
                                                              np.float32))
        labels_all.append(np.full(n, cls, np.int32))
        inst_all.append(np.full(n, inst_id, np.int32))
        inst_id += 1
    coords = np.concatenate(coords_all)
    coords = coords - coords.min(axis=0, keepdims=True)

    colors = np.concatenate(colors_all).astype(np.float32)
    region = segment_supervoxels(coords, colors)

    os.makedirs(out_dir, exist_ok=True)
    name = os.path.basename(os.path.normpath(room_dir)) + ".npz"
    out = os.path.join(out_dir, name)
    np.savez_compressed(
        out, coords=coords.astype(np.float32), colors=colors,
        labels=np.concatenate(labels_all),
        instance_id=np.concatenate(inst_all), region=region)
    return out


def prepare_area(area_dir: str, out_dir: str) -> List[str]:
    rooms = sorted(d for d in glob.glob(os.path.join(area_dir, "*"))
                   if os.path.isdir(os.path.join(d, "Annotations")))
    return [prepare_room(r, out_dir) for r in rooms]
