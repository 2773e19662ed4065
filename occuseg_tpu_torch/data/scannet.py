"""ScanNet dataset: loading, augmentation, GT computation, padded collation
(counterpart of `occuseg_tpu/data/scannet.py`: the same `np.random.Generator`
draws in the same order, so one seed gives the same batches bit for bit).

Mirrors the reference `datasets/scannet.py`:
  * scene tensors {coords, colors, w=(label,instance), region} from .pth
    (reference prepare_data output) or .npz (our `data/prepare.py`);
  * trainMerge augmentation (`scannet.py:95-265`): random rotation about z,
    random x-flip, optional rotation noise (+0.1*randn(3,3)), scale to
    voxels, two-scale elastic distortion (:49-67), translate so min corner
    lands at ~10 voxels + rand jitter, crop to full_scale window;
  * GT per instance: centredness offset exp(-(||x-mu||/scale/sigma)^2),
    displacement (x-mu)/scale, log instance size (:186-198, :247);
  * color feature + 0.1*randn noise, clamp [-1,1] (:215-217); feature
    string l/c/n/d/h handling (:218-229);
  * valMerge (:267-424): rotation by rep index, no elastic/noise.

Output is the padded batch schema of `train.state` (static P_cap). A
scene file that cannot be read makes `load_data` raise and name it.
"""

from __future__ import annotations

import dataclasses
import functools
import glob
import math
import os
from typing import Dict, List, Optional, Sequence

import numpy as np
import scipy.interpolate
import scipy.ndimage
import torch


def load_scene(path: str) -> Dict[str, np.ndarray]:
    """Load one prepared scene. Supports reference .pth (coords, colors,
    w[label,instance], optional region) and our .npz."""
    if path.endswith(".npz"):
        z = np.load(path)
        return {k: z[k] for k in z.files}
    data = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(data, (list, tuple)):
        out = {"coords": np.asarray(data[0]), "colors": np.asarray(data[1])}
        if len(data) > 2:
            w = np.asarray(data[2])
            out["labels"] = w[:, 0] if w.ndim == 2 else w
            out["instance_id"] = w[:, 1] if w.ndim == 2 else np.full_like(w, -1)
        if len(data) > 3:
            out["region"] = np.asarray(data[3])
        return out
    return {k: np.asarray(v) for k, v in data.items()}


def _load(path: str) -> Dict[str, np.ndarray]:
    try:
        return load_scene(path)
    except Exception as e:
        raise RuntimeError(f"cannot load scene {path}: {e!r}") from e


def elastic(x: np.ndarray, gran: float, mag: float,
            rng: np.random.Generator) -> np.ndarray:
    """Two-pass blurred-noise elastic distortion (reference
    `scannet.py:49-67`): trilinear interpolation of 6x-box-blurred white
    noise on a `gran`-spaced lattice, added with magnitude `mag`."""
    blur0 = np.ones((3, 1, 1), np.float32) / 3
    blur1 = np.ones((1, 3, 1), np.float32) / 3
    blur2 = np.ones((1, 1, 3), np.float32) / 3
    bb = np.abs(x).max(0).astype(np.int32) // int(gran) + 3
    noise = [rng.standard_normal(tuple(bb)).astype(np.float32)
             for _ in range(3)]
    for blur in (blur0, blur1, blur2, blur0, blur1, blur2):
        noise = [scipy.ndimage.convolve(n, blur, mode="constant", cval=0)
                 for n in noise]
    ax = [np.linspace(-(b - 1) * gran, (b - 1) * gran, b) for b in bb]
    interp = [scipy.interpolate.RegularGridInterpolator(
        ax, n, bounds_error=False, fill_value=0) for n in noise]
    return x + np.stack([i(x) for i in interp], axis=1) * mag


@dataclasses.dataclass
class ScanNetData:
    """In-RAM dataset (the reference loads every .pth up front,
    `scannet.py:426-463`)."""

    config: Dict
    train_files: List[str] = dataclasses.field(default_factory=list)
    val_files: List[str] = dataclasses.field(default_factory=list)
    train: List[Dict[str, np.ndarray]] = dataclasses.field(
        default_factory=list)
    val: List[Dict[str, np.ndarray]] = dataclasses.field(default_factory=list)

    def load_data(self) -> None:
        root = self.config["data_dir"]
        sub = "simple" if self.config.get("simple_train") else ""
        tglob = os.path.join(root, sub, "train", "*")
        vglob = os.path.join(root, sub, "val", "*")
        self.train_files = sorted(
            f for f in glob.glob(tglob) if f.endswith((".pth", ".npz")))
        self.val_files = sorted(
            f for f in glob.glob(vglob) if f.endswith((".pth", ".npz")))
        if self.config.get("all_to_train"):
            self.train_files += self.val_files
        self.train = [_load(f) for f in self.train_files]
        self.val = [_load(f) for f in self.val_files]

    # ------------------------------------------------------------------
    def _augment_scene(self, scene: Dict[str, np.ndarray],
                       rng: np.random.Generator, training: bool,
                       val_rep: int = 0):
        cfg = self.config
        scale, full_scale = cfg["scale"], cfg["full_scale"]
        a = np.asarray(scene["coords"], np.float64).copy()
        m = np.eye(3)
        if training:
            if cfg.get("use_rotation_noise"):
                m = m + rng.standard_normal((3, 3)) * 0.1
            m[0][0] *= rng.integers(0, 2) * 2 - 1
            m *= scale
            theta = rng.random() * 2 * math.pi
        else:
            m *= scale
            theta = val_rep * 2 * math.pi / max(cfg.get("val_reps", 1), 1)
        rot = [[math.cos(theta), math.sin(theta), 0],
               [-math.sin(theta), math.cos(theta), 0], [0, 0, 1]]
        m = np.matmul(m, rot)
        a = a @ m
        if training and cfg.get("use_elastic"):
            a = elastic(a, 6 * scale // 50,
                        rng.random() * 40 * scale / 50, rng)
            a = elastic(a, 20 * scale // 50,
                        rng.random() * 160 * scale / 50, rng)
        offset = np.array([a[:, 0].min(), a[:, 1].min(), a[:, 2].min()]) \
            - 10 + rng.random(3)
        a = a - offset
        keep = (a.min(1) >= 0) & (a.max(1) < full_scale)
        return a, keep, m / scale  # unit-ish rotation for normals
                                   # (reference rotates normals by m/scale,
                                   # scannet.py:108)

    def _make_batch(self, scene_ids: Sequence[int], rng: np.random.Generator,
                    training: bool, p_cap: int, i_cap: int,
                    val_rep: int = 0) -> Dict[str, np.ndarray]:
        cfg = self.config
        scale = cfg["scale"]
        sigma = cfg.get("regress_sigma", 0.2)
        data = self.train if training else self.val
        rows: Dict[str, List[np.ndarray]] = {
            k: [] for k in ("coords", "features", "labels", "instance_id",
                            "point_scene", "pose", "offsets",
                            "displacements", "occupancy", "region",
                            "normals")}
        inst_base = 0
        per_scene_cap = i_cap // max(len(scene_ids), 1)
        region_base = 0
        for si, sid in enumerate(scene_ids):
            scene = data[sid]
            a, keep, rot = self._augment_scene(scene, rng, training, val_rep)
            a = a[keep]
            n = a.shape[0]
            colors = np.asarray(scene["colors"], np.float32)[keep]
            if training:
                colors = np.clip(
                    colors + rng.standard_normal(3).astype(np.float32) * 0.1,
                    -1, 1)
            labels = np.asarray(
                scene.get("labels", np.full(n, -1)), np.int64)[keep]
            inst = np.asarray(
                scene.get("instance_id", np.full(n, -1)), np.int64)[keep]
            region = np.asarray(
                scene.get("region", np.arange(keep.size)), np.int64)[keep]

            # remap instances to dense local ids over ALL values — the
            # reference's np.unique(...)[1] (scannet.py:176-181) gives
            # background/unlabeled (-100) its own dense id too, so the
            # discriminative loss pulls background into one cluster
            _, local = np.unique(inst, return_inverse=True)
            local = local.astype(np.int64)

            pose = a / scale
            offsets = np.zeros((n, 1), np.float32)
            displacements = np.zeros((n, 3), np.float32)
            occupancy = np.zeros((n, 1), np.float32)
            for k in range(int(local.max()) + 1 if n else 0):
                msk = local == k
                mu = a[msk].mean(axis=0)
                dist = np.linalg.norm(a[msk] - mu, axis=1)
                offsets[msk, 0] = np.exp(-(dist / scale / sigma) ** 2)
                displacements[msk] = (a[msk] - mu) / scale
                occupancy[msk, 0] = np.log(msk.sum())

            glob_inst = np.where(
                (local >= 0) & (local < per_scene_cap),
                local + inst_base, -1)
            inst_base += per_scene_cap

            runiq = np.unique(region)
            rmap = {int(u): i + region_base for i, u in enumerate(runiq)}
            region_l = np.array([rmap[int(v)] for v in region], np.int64)
            region_base += len(runiq)

            feats = self._features(a, colors, scene, keep, training, rot)
            rows["coords"].append(np.concatenate(
                [np.full((n, 1), si), np.floor(a[:, [2, 1, 0]])], axis=1
            ).astype(np.int32))  # (b, z, y, x): reference stores xyz; keys
            # are z-major so flip for packing
            rows["features"].append(feats)
            rows["labels"].append(labels.astype(np.int32))
            rows["instance_id"].append(glob_inst.astype(np.int32))
            rows["point_scene"].append(np.full(n, si, np.int32))
            rows["pose"].append(pose.astype(np.float32))
            rows["offsets"].append(offsets)
            rows["displacements"].append(displacements)
            rows["occupancy"].append(occupancy)
            rows["region"].append(region_l.astype(np.int32))
            # per-point normals for --use_normal plan orientation classes
            # (rotated with the scene like feature normals)
            nrm = np.asarray(scene.get("normals", np.zeros((keep.size, 3))),
                             np.float32)[keep]
            if rot is not None:
                nrm = (nrm @ rot).astype(np.float32)
            rows["normals"].append(nrm)

        cat = {k: np.concatenate(v) for k, v in rows.items()}
        n_total = cat["labels"].shape[0]
        if n_total > p_cap:
            keep = rng.permutation(n_total)[:p_cap]
            keep.sort()
            cat = {k: v[keep] for k, v in cat.items()}
            n_total = p_cap

        def pad(a, fill):
            out = np.full((p_cap,) + a.shape[1:], fill, a.dtype)
            out[:n_total] = a
            return out

        return {
            "coords": pad(cat["coords"], -1),
            "features": pad(cat["features"], 0),
            "labels": pad(cat["labels"], -1),
            "instance_id": pad(cat["instance_id"], -1),
            "point_scene": pad(cat["point_scene"], len(scene_ids)),
            "pose": pad(cat["pose"], 0),
            "offsets": pad(cat["offsets"], 0),
            "displacements": pad(cat["displacements"], 0),
            "occupancy": pad(cat["occupancy"], 0),
            "region": pad(cat["region"], -1),
            "normals": pad(cat["normals"], 0),
        }

    def _features(self, a, colors, scene, keep, training,
                  rot=None) -> np.ndarray:
        cfg = self.config
        f = cfg.get("use_feature", "c")
        feats = []
        if "l" in f:
            lf = a - a.mean(axis=0, keepdims=True)
            lf = lf / (np.linalg.norm(lf, axis=1, keepdims=True) + 1e-12)
            feats.append(lf.astype(np.float32))
        if "c" in f:
            feats.append(colors.astype(np.float32))
        if "n" in f:
            normals = np.asarray(
                scene.get("normals", np.zeros((keep.size, 3))),
                np.float32)[keep]
            if rot is not None:
                normals = (normals @ rot).astype(np.float32)
            feats.append(normals)
        if "h" in f:
            feats.append(a[:, 2:3].astype(np.float32))
        return np.concatenate(feats, axis=1)

    # ------------------------------------------------------------------
    def train_batches(self, rng: np.random.Generator, p_cap: int,
                      i_cap: int, batch_size: int):
        """Generator over one epoch of shuffled padded batches."""
        for make in self.train_batch_makers(rng, p_cap, i_cap, batch_size):
            yield make()

    def train_batch_makers(self, rng: np.random.Generator, p_cap: int,
                           i_cap: int, batch_size: int,
                           own_rng: bool = False):
        """One epoch's batches as calls that make them. Without `own_rng`
        each call augments from `rng` and must be made before the next
        is drawn (`train_batches`); with it, each draws from a generator
        of its own, seeded from `rng` as it is yielded, so a call never
        made (another data-parallel rank's batch) leaves `rng` as every
        rank has it, and a call made twice makes the same batch."""
        order = rng.permutation(len(self.train))
        for start in range(0, len(order), batch_size):
            seed = int(rng.integers(1 << 62)) if own_rng else None
            yield functools.partial(self._make_seeded,
                                    order[start:start + batch_size], rng,
                                    seed, p_cap, i_cap)

    def _make_seeded(self, ids, rng, seed, p_cap, i_cap):
        r = rng if seed is None else np.random.default_rng(seed)
        return self._make_batch(ids, r, True, p_cap, i_cap)

    def val_batches(self, p_cap: int, i_cap: int, batch_size: int,
                    val_rep: int = 0):
        rng = np.random.default_rng(100)
        for start in range(0, len(self.val), batch_size):
            ids = list(range(start, min(start + batch_size, len(self.val))))
            yield self._make_batch(ids, rng, False, p_cap, i_cap, val_rep)
