"""Procedural indoor-scene generator.

Produces training batches with the same schema as the ScanNet pipeline
(reference `datasets/scannet.py:69-265` trainMerge): padded point coords,
RGB features, semantic labels, instance ids, centredness offsets
exp(-(||x-mu||/scale/0.6)^2) (`scannet.py:186-198`), displacements
(x-mu)/scale, and log-instance-size occupancy GT (`scannet.py:247`). Used by
tests and the benchmark harness so the framework is exercised end-to-end
without the (license-gated) ScanNet download; statistics (points/scene,
instances/scene, surface-like geometry) mimic 2cm-voxelized ScanNet rooms.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np


@dataclasses.dataclass(frozen=True)
class SceneConfig:
    num_points: int = 40_000
    extent: int = 256          # voxel extent of the room (4096 domain max)
    num_objects: int = 12
    num_classes: int = 20
    scale: float = 50.0        # voxels per meter (2cm voxels)
    rng_seed: int = 0
    # > 0: replace the free-floating furniture with this many TOUCHING
    # TRIPLES — three same-class, same-size boxes sharing faces in a row.
    # Spatial clustering merges a triple into one proposal (IoU 1/3 per GT
    # instance, < 0.5), so instance separation must come from the learned
    # displacement field contracting each member toward its own center —
    # the scene family that makes the displacement head load-bearing for
    # the AP gate (tests/test_accuracy_ap_gate.py), mirroring the adjacent
    # same-class furniture the reference's drift term targets
    # (train_instance.py:217-236).
    touching_triples: int = 0


def generate_scene(cfg: SceneConfig, seed: int) -> Dict[str, np.ndarray]:
    """One synthetic room: floor + 2 walls + boxes/ellipsoid 'furniture'."""
    rng = np.random.default_rng(seed)
    E = cfg.extent
    n = cfg.num_points
    parts = []

    def surface_points(count, kind):
        if kind == "floor":
            p = np.stack([np.full(count, 1.0),
                          rng.uniform(0, E, count),
                          rng.uniform(0, E, count)], axis=1)
            return p[:, [0, 1, 2]]  # z ~ 0 plane
        if kind == "wall":
            p = np.stack([rng.uniform(0, E / 2, count),
                          np.full(count, 1.0),
                          rng.uniform(0, E, count)], axis=1)
            return p
        raise ValueError(kind)

    n_floor = n // 4
    n_wall = n // 8
    floor = surface_points(n_floor, "floor")
    wall = surface_points(n_wall, "wall")
    # surface normals in (x, y, z) order (the OrientedFilter convention,
    # ops/normal_guide.oriented_filter); coords rows are (z, y, x)
    floor_n = np.tile(np.array([0.0, 0.0, 1.0], np.float32), (n_floor, 1))
    wall_n = np.tile(np.array([0.0, 1.0, 0.0], np.float32), (n_wall, 1))
    parts.append((floor, 1, -1, floor_n))   # class 1 = floor, no instance
    parts.append((wall, 0, -1, wall_n))     # class 0 = wall

    n_obj_total = n - n_floor - n_wall
    if cfg.touching_triples > 0:
        # rows of three face-sharing boxes: same class, same size, same
        # appearance — only positions (and hence GT centers/displacements)
        # distinguish the members
        per_obj = n_obj_total // (3 * cfg.touching_triples)
        iid = 0
        for t in range(cfg.touching_triples):
            half = rng.uniform(E * 0.04, E * 0.08, 3)
            base = rng.uniform(E * 0.15, E * 0.7, 3)
            base[0] = rng.uniform(2 + half[0], E * 0.3)
            cls = int(rng.integers(2, cfg.num_classes))
            for m in range(3):
                center = base.copy()
                center[1] += m * 2 * half[1]  # share y faces
                face = rng.integers(0, 6, per_obj)
                u = rng.uniform(-1, 1, (per_obj, 3))
                ax = face % 3
                u[np.arange(per_obj), ax] = np.sign(face - 2.5)
                pts = center + u * half
                nrm = np.zeros((per_obj, 3), np.float32)
                nrm[np.arange(per_obj), 2 - ax] = np.sign(face - 2.5)
                parts.append((pts, cls, iid, nrm))
                iid += 1
        coords, labels, inst, normals = [], [], [], []
        for pts, cls, iid_, nrm in parts:
            coords.append(pts)
            labels.append(np.full(pts.shape[0], cls, np.int32))
            inst.append(np.full(pts.shape[0], iid_, np.int32))
            normals.append(nrm)
        return _finalize(cfg, rng, coords, labels, inst, normals)
    per_obj = n_obj_total // cfg.num_objects
    for k in range(cfg.num_objects):
        center = rng.uniform(E * 0.1, E * 0.9, 3)
        center[0] = rng.uniform(2, E * 0.3)  # objects near the floor
        half = rng.uniform(E * 0.02, E * 0.12, 3)
        kind = rng.integers(0, 2)
        if kind == 0:  # box surface
            face = rng.integers(0, 6, per_obj)
            u = rng.uniform(-1, 1, (per_obj, 3))
            ax = face % 3
            u[np.arange(per_obj), ax] = np.sign(face - 2.5)
            pts = center + u * half
            nrm = np.zeros((per_obj, 3), np.float32)
            # coords axis 0/1/2 = z/y/x -> normal (x,y,z) column 2/1/0
            nrm[np.arange(per_obj), 2 - ax] = np.sign(face - 2.5)
        else:  # ellipsoid surface
            v = rng.standard_normal((per_obj, 3))
            v /= np.linalg.norm(v, axis=1, keepdims=True) + 1e-9
            pts = center + v * half
            nrm = v[:, ::-1].astype(np.float32)  # (z,y,x) -> (x,y,z)
        cls = int(rng.integers(2, cfg.num_classes))
        parts.append((pts, cls, k, nrm))

    coords, labels, inst, normals = [], [], [], []
    for pts, cls, iid, nrm in parts:
        coords.append(pts)
        labels.append(np.full(pts.shape[0], cls, np.int32))
        inst.append(np.full(pts.shape[0], iid, np.int32))
        normals.append(nrm)
    return _finalize(cfg, rng, coords, labels, inst, normals)


def _finalize(cfg: SceneConfig, rng, coords, labels, inst, normals
              ) -> Dict[str, np.ndarray]:
    E = cfg.extent
    coords = np.clip(np.concatenate(coords), 0, E - 1)
    labels = np.concatenate(labels)
    inst = np.concatenate(inst)
    normals = np.concatenate(normals)
    # jitter points off the ideal surfaces (sensor noise)
    coords = coords + rng.normal(0, 0.4, coords.shape)
    coords = np.clip(coords, 0, E - 1)
    # class-correlated colors (+ noise): real scans' appearance carries
    # semantic signal; fully random colors made the semantic head
    # unlearnable on synthetic data (soak val IoU ~0.08)
    palette_rng = np.random.default_rng(12345)  # fixed across scenes
    palette = palette_rng.uniform(-0.8, 0.8, (cfg.num_classes, 3))
    colors = (palette[labels]
              + rng.normal(0, 0.25, (coords.shape[0], 3))).astype(np.float32)
    colors = np.clip(colors, -1, 1)
    return {"xyz": coords.astype(np.float32), "colors": colors,
            "labels": labels, "instance_id": inst,
            "normals": normals.astype(np.float32)}


def make_batch(cfg: SceneConfig, num_scenes: int, p_cap: int,
               num_instances: int, seed: int = 0) -> Dict[str, np.ndarray]:
    """Collate scenes into one padded batch (reference trainMerge analog).

    Returns the training-step schema: coords [P,4] int32 (-1 pad), features
    [P,3], labels [P] (-1 pad), instance_id [P] (-1 pad/background, globally
    numbered), point_scene [P], pose [P,3] (= coords/scale), offsets [P,1],
    displacements [P,3], occupancy [P,1].
    """
    per_scene_inst = num_instances // num_scenes
    all_rows = []
    for s in range(num_scenes):
        sc = generate_scene(cfg, seed * 1000 + s)
        n = sc["xyz"].shape[0]
        rows = {
            "coords": np.concatenate(
                [np.full((n, 1), s, np.int32),
                 np.floor(sc["xyz"]).astype(np.int32)], axis=1),
            "features": sc["colors"],
            "labels": sc["labels"],
            "point_scene": np.full(n, s, np.int32),
            "xyz": sc["xyz"],
            "normals": sc["normals"],
        }
        iid = sc["instance_id"].copy()
        iid = np.where((iid >= 0) & (iid < per_scene_inst),
                       iid + s * per_scene_inst, -1)
        rows["instance_id"] = iid.astype(np.int32)
        all_rows.append(rows)

    cat = {k: np.concatenate([r[k] for r in all_rows]) for k in all_rows[0]}
    n_total = cat["labels"].shape[0]
    if n_total > p_cap:
        keep = np.random.default_rng(seed).permutation(n_total)[:p_cap]
        keep.sort()
        cat = {k: v[keep] for k, v in cat.items()}
        n_total = p_cap

    pose = cat["xyz"] / cfg.scale
    iid = cat["instance_id"]
    # GT per instance: centroid, size
    offsets = np.zeros((n_total, 1), np.float32)
    displacements = np.zeros((n_total, 3), np.float32)
    occupancy = np.zeros((n_total, 1), np.float32)
    for k in np.unique(iid[iid >= 0]):
        m = iid == k
        mu = pose[m].mean(axis=0)
        d = pose[m] - mu
        displacements[m] = d
        # sigma=0.6m as in the reference GT (scannet.py:186-198)
        offsets[m, 0] = np.exp(-(np.linalg.norm(d, axis=1) / 0.6) ** 2)
        occupancy[m, 0] = np.log(m.sum())

    def pad(a, fill):
        out = np.full((p_cap,) + a.shape[1:], fill, a.dtype)
        out[:n_total] = a
        return out

    return {
        "coords": pad(cat["coords"], -1),
        "features": pad(cat["features"].astype(np.float32), 0),
        "labels": pad(cat["labels"].astype(np.int32), -1),
        "instance_id": pad(iid.astype(np.int32), -1),
        "point_scene": pad(cat["point_scene"].astype(np.int32), num_scenes),
        "pose": pad(pose.astype(np.float32), 0),
        "normals": pad(cat["normals"].astype(np.float32), 0),
        "offsets": pad(offsets, 0),
        "displacements": pad(displacements, 0),
        "occupancy": pad(occupancy, 0),
    }


# NYU40 ids of the 20 ScanNet classes (`data/prepare.VALID_CLASS_IDS`)
_NYU40_IDS = np.array([1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 14, 16, 24, 28,
                       33, 34, 36, 39])


def _ply_bytes(rec: np.ndarray, props, faces: np.ndarray, ascii: bool
               ) -> bytes:
    """A PLY file of the vertex records `rec` (fields `props`, (name, PLY
    type)) and the triangles `faces` [F, 3]."""
    head = [f"ply\nformat {'ascii' if ascii else 'binary_little_endian'} "
            f"1.0\nelement vertex {rec.shape[0]}\n"]
    head += [f"property {t} {n}\n" for n, t in props]
    head += [f"element face {faces.shape[0]}\n",
             "property list uchar int vertex_indices\nend_header\n"]
    if ascii:
        rows = [" ".join(str(v) for v in r) for r in rec.tolist()]
        rows += ["3 " + " ".join(map(str, f)) for f in faces.tolist()]
        return ("".join(head) + "\n".join(rows) + "\n").encode()
    tri = np.zeros(faces.shape[0], [("n", "u1"), ("v", "<i4", (3,))])
    tri["n"], tri["v"] = 3, faces
    return "".join(head).encode() + rec.tobytes() + tri.tobytes()


def write_scannet_scan(scan_dir: str, name: str, cfg: SceneConfig,
                       seed: int, annotations: bool = True,
                       regions: bool = False, ascii: bool = False) -> str:
    """One `generate_scene` room written in ScanNet's raw layout under
    `scan_dir/name/`, in metres (voxel coordinates / cfg.scale, x y z):
    `<name>_vh_clean_2.ply` (x, y, z, red, green, blue, and triangles) and,
    with `annotations`, `<name>_vh_clean_2.labels.ply` (NYU40 `label`; one
    segment in 7 carries id 40, which no class takes),
    `<name>_vh_clean_2.0.010000.segs.json` (segments of up to 8 per
    object: the room's objects, its wall and its floor) and
    `<name>.aggregation.json`; with `regions`, a
    `<name>_vh_clean_2.regions.json` of the segments. Returns the mesh
    path, the input of `data/prepare.prepare_scene`."""
    import json
    import os

    sc = generate_scene(cfg, seed)
    xyz = (sc["xyz"][:, ::-1] / cfg.scale).astype(np.float32)
    n = xyz.shape[0]
    rgb = np.clip(np.round((sc["colors"] + 1) * 127.5), 0, 255).astype(
        np.uint8)
    n_obj = int(sc["instance_id"].max()) + 1
    obj = np.where(sc["instance_id"] >= 0, sc["instance_id"],
                   n_obj + sc["labels"])          # wall, floor: objects too
    cell = np.floor(xyz[:, :2] / 0.5).astype(np.int64)
    seg = obj * 8 + (cell[:, 0] + 3 * cell[:, 1]) % 8
    faces = np.stack([np.arange(0, n - 2, 3), np.arange(1, n - 1, 3),
                      np.arange(2, n, 3)], axis=1)[:64]
    out = os.path.join(scan_dir, name)
    os.makedirs(out, exist_ok=True)
    base = os.path.join(out, name)
    props = [("x", "float"), ("y", "float"), ("z", "float"),
             ("red", "uchar"), ("green", "uchar"), ("blue", "uchar")]
    rec = np.zeros(n, [("x", "<f4"), ("y", "<f4"), ("z", "<f4"),
                       ("red", "u1"), ("green", "u1"), ("blue", "u1")])
    rec["x"], rec["y"], rec["z"] = xyz.T
    rec["red"], rec["green"], rec["blue"] = rgb.T
    with open(base + "_vh_clean_2.ply", "wb") as f:
        f.write(_ply_bytes(rec, props, faces, ascii))
    if annotations:
        lab = np.zeros(n, rec.dtype.descr + [("label", "<u2")])
        for k in rec.dtype.names:
            lab[k] = rec[k]
        lab["label"] = np.where(seg % 7 == 0, 40, _NYU40_IDS[sc["labels"]])
        with open(base + "_vh_clean_2.labels.ply", "wb") as f:
            f.write(_ply_bytes(lab, props + [("label", "ushort")], faces,
                               ascii))
        with open(base + "_vh_clean_2.0.010000.segs.json", "w") as f:
            json.dump({"segIndices": seg.tolist()}, f)
        groups = [{"id": int(o), "objectId": int(o),
                   "segments": np.unique(seg[obj == o]).tolist()}
                  for o in np.unique(obj)]
        with open(base + ".aggregation.json", "w") as f:
            json.dump({"sceneId": name, "segGroups": groups}, f)
    if regions:
        with open(base + "_vh_clean_2.regions.json", "w") as f:
            json.dump({"segIndices": seg.tolist()}, f)
    return base + "_vh_clean_2.ply"
