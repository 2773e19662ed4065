"""ScanNet raw-data preparation: ply + json -> per-scene .npz tensors
(counterpart of `occuseg_tpu/data/prepare.py`, the same arrays).

    python -m occuseg_tpu_torch.data.prepare --scans <dir> --out <dir>

Reference: `examples/ScanNet/prepare_data.py` (open3d + plyfile based).
This version is dependency-light: a NumPy PLY reader (ascii /
binary_little_endian), the same NYU40->20-class mapping
(`prepare_data.py:17-38`), instance ids from `.aggregation.json` +
`.segs.json`, supervoxel regions from `.regions.json` (the external
Segmentator output) or, when it is absent, from the built-in segmenter
(`data/supervoxel_gen.py`, C++), and per-point normals.
"""

from __future__ import annotations

import glob
import json
import multiprocessing as mp
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from occuseg_tpu_torch.data.supervoxel_gen import (
    estimate_normals,
    segment_supervoxels,
)

CLASS_LABELS = ['wall', 'floor', 'chair', 'table', 'desk', 'bed',
                'bookshelf', 'sofa', 'sink', 'bathtub', 'toilet', 'curtain',
                'counter', 'door', 'window', 'shower curtain',
                'refrigerator', 'picture', 'cabinet', 'otherfurniture']
VALID_CLASS_IDS = [1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 14, 16, 24, 28,
                   33, 34, 36, 39]
LABEL_ID_TO_CLASS_ID = {lid: i for i, lid in enumerate(VALID_CLASS_IDS)}
UNKNOWN_ID = -100

_PLY_DTYPES = {
    "char": "i1", "uchar": "u1", "int8": "i1", "uint8": "u1",
    "short": "i2", "ushort": "u2", "int16": "i2", "uint16": "u2",
    "int": "i4", "uint": "u4", "int32": "i4", "uint32": "u4",
    "float": "f4", "float32": "f4", "double": "f8", "float64": "f8",
}


def read_ply(path: str) -> Dict[str, np.ndarray]:
    """Minimal PLY vertex reader (ascii / binary_little_endian), returning
    {property_name: column array} for the `vertex` element."""
    with open(path, "rb") as f:
        header: List[str] = []
        while True:
            line = f.readline().decode("ascii", "replace").strip()
            header.append(line)
            if line == "end_header":
                break
        fmt = next(l.split()[1] for l in header if l.startswith("format"))
        counts: List[Tuple[str, int]] = []
        props: Dict[str, List[Tuple[str, str]]] = {}
        cur = None
        for line in header:
            t = line.split()
            if not t:
                continue
            if t[0] == "element":
                cur = t[1]
                counts.append((cur, int(t[2])))
                props[cur] = []
            elif t[0] == "property" and cur is not None:
                if t[1] == "list":
                    props[cur].append(("__list__", " ".join(t[2:])))
                else:
                    props[cur].append((t[-1], t[1]))

        out: Dict[str, np.ndarray] = {}
        for elem, count in counts:
            plist = props[elem]
            if any(n == "__list__" for n, _ in plist):
                if fmt == "ascii":
                    for _ in range(count):
                        f.readline()
                else:
                    # list elements (faces): parse per row
                    sizes, vt = plist[0][1].split()[:2]
                    st = np.dtype(_PLY_DTYPES[sizes])
                    vtd = np.dtype(_PLY_DTYPES[vt])
                    for _ in range(count):
                        n = int(np.frombuffer(f.read(st.itemsize), st)[0])
                        f.read(n * vtd.itemsize)
                continue
            dtype = np.dtype([(n, "<" + _PLY_DTYPES[t]) for n, t in plist])
            if fmt == "ascii":
                rows = np.loadtxt(
                    [f.readline() for _ in range(count)], dtype=np.float64,
                    ndmin=2)
                if elem == "vertex":
                    for i, (n, _) in enumerate(plist):
                        out[n] = rows[:, i]
            else:
                data = np.frombuffer(f.read(count * dtype.itemsize), dtype)
                if elem == "vertex":
                    for n, _ in plist:
                        out[n] = np.ascontiguousarray(data[n])
    return out


def prepare_scene(ply_path: str, out_dir: str,
                  raw2class: Optional[Dict[str, int]] = None) -> str:
    """One `<scene>_vh_clean_2.ply` (+ sibling jsons) -> `<scene>.npz`."""
    v = read_ply(ply_path)
    coords = np.stack([v["x"], v["y"], v["z"]], axis=1).astype(np.float32)
    if "red" in v:
        colors = (np.stack([v["red"], v["green"], v["blue"]],
                           axis=1).astype(np.float32) / 255.0 - 0.5) * 2
    else:
        colors = np.zeros_like(coords)
    n = coords.shape[0]
    labels = np.full(n, UNKNOWN_ID, np.int32)
    instance = np.full(n, UNKNOWN_ID, np.int32)

    base = ply_path[:-len("_vh_clean_2.ply")] if ply_path.endswith(
        "_vh_clean_2.ply") else os.path.splitext(ply_path)[0]
    labels_ply = ply_path[:-3] + "labels.ply"
    agg_json = base + ".aggregation.json"
    segs_json = ply_path[:-3] + "0.010000.segs.json"
    if os.path.exists(labels_ply) and os.path.exists(agg_json) \
            and os.path.exists(segs_json):
        lbl = read_ply(labels_ply)["label"].astype(np.int64)
        class_label = np.array(
            [LABEL_ID_TO_CLASS_ID.get(int(l), UNKNOWN_ID) for l in lbl],
            np.int32)
        seg_indices = np.asarray(
            json.load(open(segs_json))["segIndices"])
        for obj in json.load(open(agg_json))["segGroups"]:
            for segment in obj["segments"]:
                idx = seg_indices == segment
                labels[idx] = class_label[idx]
                instance[idx] = obj["id"]

    regions_json = ply_path[:-3] + "regions.json"
    if os.path.exists(regions_json):
        region = np.asarray(json.load(open(regions_json))["segIndices"],
                            np.int32)
    else:
        region = segment_supervoxels(coords, colors)

    # per-point normals (PCA over voxel neighborhoods) for the 'n' feature
    # string and normal-guided filters
    normals = estimate_normals(coords)

    os.makedirs(out_dir, exist_ok=True)
    name = os.path.basename(base) + "_instance.npz"
    out = os.path.join(out_dir, name)
    np.savez_compressed(out, coords=coords, colors=colors, labels=labels,
                        instance_id=instance, region=region, normals=normals)
    return out


def prepare_split(scan_dir: str, out_dir: str, workers: int = 0) -> List[str]:
    files = sorted(glob.glob(os.path.join(scan_dir, "*", "*_vh_clean_2.ply")))
    if workers and workers > 1:
        with mp.Pool(workers) as pool:
            return pool.starmap(prepare_scene,
                                [(f, out_dir) for f in files])
    return [prepare_scene(f, out_dir) for f in files]


def main() -> None:
    """CLI mirroring the reference `prepare_data.py`:
    `python -m occuseg_tpu_torch.data.prepare --scans <dir> --out <dir>`."""
    import argparse

    p = argparse.ArgumentParser(
        description="ScanNet scans -> per-scene .npz training files")
    p.add_argument("--scans", required=True,
                   help="directory of scene dirs with *_vh_clean_2.ply")
    p.add_argument("--out", required=True, help="output directory")
    p.add_argument("--workers", type=int, default=0,
                   help="multiprocessing pool size (reference uses Pool)")
    args = p.parse_args()
    os.makedirs(args.out, exist_ok=True)
    written = prepare_split(args.scans, args.out, workers=args.workers)
    print(f"wrote {len(written)} scenes to {args.out}")


if __name__ == "__main__":
    main()
