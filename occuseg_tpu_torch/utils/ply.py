"""PLY export of labeled point clouds (counterpart of
`occuseg_tpu/utils/ply.py`: the reference's visualize/export helpers,
`examples/ScanNet/utils.py:103-208`)."""

from __future__ import annotations

from typing import Optional

import numpy as np

# NYU40-style color palette for the 20 ScanNet classes (reference
# `examples/ScanNet/utils.py` create_color_palette usage).
CLASS_COLORS = np.array([
    (174, 199, 232), (152, 223, 138), (31, 119, 180), (255, 187, 120),
    (188, 189, 34), (140, 86, 75), (255, 152, 150), (214, 39, 40),
    (197, 176, 213), (148, 103, 189), (196, 156, 148), (23, 190, 207),
    (247, 182, 210), (219, 219, 141), (255, 127, 14), (158, 218, 229),
    (44, 160, 44), (112, 128, 144), (227, 119, 194), (82, 84, 163),
], np.uint8)


def write_labeled_ply(path: str, xyz: np.ndarray, labels: np.ndarray,
                      colors: Optional[np.ndarray] = None) -> None:
    """Binary PLY with per-vertex color from semantic labels (or given)."""
    n = xyz.shape[0]
    if colors is None:
        safe = np.clip(labels, 0, len(CLASS_COLORS) - 1)
        colors = CLASS_COLORS[safe]
        colors[labels < 0] = (128, 128, 128)
    rec = np.zeros(n, dtype=[("x", "<f4"), ("y", "<f4"), ("z", "<f4"),
                             ("red", "u1"), ("green", "u1"), ("blue", "u1")])
    rec["x"], rec["y"], rec["z"] = xyz.T.astype(np.float32)
    rec["red"], rec["green"], rec["blue"] = colors.T
    header = (
        "ply\nformat binary_little_endian 1.0\n"
        f"element vertex {n}\n"
        "property float x\nproperty float y\nproperty float z\n"
        "property uchar red\nproperty uchar green\nproperty uchar blue\n"
        "end_header\n")
    with open(path, "wb") as f:
        f.write(header.encode())
        f.write(rec.tobytes())


def write_instance_ply(path: str, xyz: np.ndarray,
                       instance_id: np.ndarray, seed: int = 0) -> None:
    """Random color per instance (reference instance visualization)."""
    rng = np.random.default_rng(seed)
    ids = np.unique(instance_id[instance_id >= 0])
    palette = {int(i): rng.integers(0, 255, 3).astype(np.uint8) for i in ids}
    colors = np.full((xyz.shape[0], 3), 128, np.uint8)
    for i, c in palette.items():
        colors[instance_id == i] = c
    write_labeled_ply(path, xyz, np.zeros(xyz.shape[0], np.int32), colors)
