"""Scene traffic of the benchmark: a frozen copy of the port's procedural
room generator (`occuseg_tpu_torch/data/synthetic.py`, `generate_scene`
and `make_batch`'s ground truth), a pool of base rooms made from the run's
seed, and the stream of scans drawn from it, each base room under a fresh
rigid transform (a rotation about the vertical axis and a translation).

Coordinates are (z, y, x) with z vertical, in voxels of the 2 cm grid the
generator draws on; a configuration at another `scale` (voxels per metre)
multiplies them by scale / 50. Every seed gets the same base rooms (the
cell's `room_points` range, evenly spaced over the pool, drawn from the
cell's `room_seed`) and the same number of scans per step: a run's seed
draws the order in which the rooms come and each scan's rotation and
translation, so it changes the inputs and not the amount of work.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Sequence, Tuple

import numpy as np

GRID_SCALE = 50.0  # voxels per metre of the generator's grid (2 cm)
SIGMA_CENTRE = 0.6  # metres, the centredness ground truth's width


@dataclasses.dataclass(frozen=True)
class RoomSpec:
    num_points: int
    extent: int = 512
    num_objects: int = 24
    num_classes: int = 20


def generate_room(spec: RoomSpec, seed: int) -> Dict[str, np.ndarray]:
    """One room on the 2 cm grid: a floor, two walls and `num_objects`
    boxes or ellipsoids. The same draws as `generate_scene` of the port's
    generator (touching_triples 0): xyz [n, 3] f32 (z, y, x), colors
    [n, 3], labels [n], instance_id [n] (-1 for wall and floor)."""
    rng = np.random.default_rng(seed)
    E, n = spec.extent, spec.num_points
    n_floor, n_wall = n // 4, n // 8
    floor = np.stack([np.full(n_floor, 1.0), rng.uniform(0, E, n_floor),
                      rng.uniform(0, E, n_floor)], axis=1)
    wall = np.stack([rng.uniform(0, E / 2, n_wall), np.full(n_wall, 1.0),
                     rng.uniform(0, E, n_wall)], axis=1)
    parts = [(floor, 1, -1), (wall, 0, -1)]
    per_obj = (n - n_floor - n_wall) // spec.num_objects
    for k in range(spec.num_objects):
        center = rng.uniform(E * 0.1, E * 0.9, 3)
        center[0] = rng.uniform(2, E * 0.3)
        half = rng.uniform(E * 0.02, E * 0.12, 3)
        if rng.integers(0, 2) == 0:  # box surface
            face = rng.integers(0, 6, per_obj)
            u = rng.uniform(-1, 1, (per_obj, 3))
            u[np.arange(per_obj), face % 3] = np.sign(face - 2.5)
            pts = center + u * half
        else:  # ellipsoid surface
            v = rng.standard_normal((per_obj, 3))
            v /= np.linalg.norm(v, axis=1, keepdims=True) + 1e-9
            pts = center + v * half
        parts.append((pts, int(rng.integers(2, spec.num_classes)), k))
    coords = np.clip(np.concatenate([p for p, _, _ in parts]), 0, E - 1)
    labels = np.concatenate([np.full(p.shape[0], c, np.int32)
                             for p, c, _ in parts])
    inst = np.concatenate([np.full(p.shape[0], i, np.int32)
                           for p, _, i in parts])
    coords = np.clip(coords + rng.normal(0, 0.4, coords.shape), 0, E - 1)
    palette = np.random.default_rng(12345).uniform(-0.8, 0.8,
                                                   (spec.num_classes, 3))
    colors = np.clip(palette[labels] + rng.normal(0, 0.25, coords.shape),
                     -1, 1).astype(np.float32)
    return {"xyz": coords.astype(np.float32), "colors": colors,
            "labels": labels, "instance_id": inst}


class RoomPool:
    """`size` base rooms whose point counts are spaced evenly over
    [lo, hi], their geometry drawn from `room_seed`: the same rooms for
    every run, so that a run's seed changes the order and the placements
    of the scans, not the amount of work."""

    def __init__(self, room_seed: int, size: int, points: Sequence[int],
                 extent: int = 512, num_objects: int = 24):
        lo, hi = int(points[0]), int(points[1])
        counts = np.linspace(lo, hi, size).round().astype(int)
        rng = np.random.default_rng([room_seed & 0xFFFFFFFF,
                                     room_seed >> 32, 1])
        seeds = rng.integers(0, 2 ** 62, size)
        self.extent = extent
        self.rooms = [with_centres(generate_room(
            RoomSpec(int(c), extent, num_objects), int(s)))
            for c, s in zip(counts, seeds)]


def with_centres(room: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """The room with each point's offset from its instance's centre
    (`to_centre` [n, 3], metres, room frame; 0 off instances) and its
    instance's point count (`inst_count` [n]; 0 off instances). A rigid
    placement rotates the offsets and keeps the counts."""
    iid = room["instance_id"]
    valid = iid >= 0
    ids = np.where(valid, iid, iid.max() + 1)
    cnt = np.bincount(ids)
    pose = room["xyz"].astype(np.float64) / GRID_SCALE
    mu = np.stack([np.bincount(ids, weights=pose[:, d]) for d in range(3)],
                  axis=1) / np.maximum(cnt, 1)[:, None]
    room["to_centre"] = np.where(valid[:, None], pose - mu[ids],
                                 0).astype(np.float32)
    room["inst_count"] = np.where(valid, cnt[ids], 0)
    return room


@dataclasses.dataclass(frozen=True)
class Placement:
    room: int        # index into the pool
    angle: float     # radians about the vertical axis
    shift: Tuple[float, float]  # (y, x) translation on the 2 cm grid


def place(pool: RoomPool, p: Placement, scale: float
          ) -> Dict[str, np.ndarray]:
    """The base room under its placement, on the grid of `scale`: xyz
    [n, 3] f32 voxel coordinates (z, y, x), and the room's colours, labels
    and instance ids."""
    room = pool.rooms[p.room]
    c = np.float32(pool.extent / 2.0)
    xyz = room["xyz"]
    y, x = xyz[:, 1] - c, xyz[:, 2] - c
    ca, sa = np.float32(np.cos(p.angle)), np.float32(np.sin(p.angle))
    half = c * np.float32(np.sqrt(2.0))
    out = np.stack([xyz[:, 0],
                    ca * y - sa * x + (half + np.float32(p.shift[0])),
                    sa * y + ca * x + (half + np.float32(p.shift[1]))],
                   axis=1)
    out *= np.float32(scale / GRID_SCALE)
    return {"xyz": out, "colors": room["colors"],
            "labels": room["labels"], "instance_id": room["instance_id"]}


def placements(pool: RoomPool, seed: int) -> Iterator[Placement]:
    """The endless stream of placements of a run: every pass over the pool
    visits each room once, in an order drawn from the seed, each time
    under a fresh rotation and translation (up to 256 voxels of the 2 cm
    grid each way)."""
    rng = np.random.default_rng([seed & 0xFFFFFFFF, seed >> 32, 2])
    n = len(pool.rooms)
    while True:
        for r in rng.permutation(n):
            yield Placement(int(r), float(rng.uniform(0, 2 * np.pi)),
                            (float(rng.uniform(0, 256)),
                             float(rng.uniform(0, 256))))


def scan(pool: RoomPool, p: Placement, scale: float
         ) -> Dict[str, np.ndarray]:
    """One scan as an inference request: coords [P, 4] int32 (batch 0,
    z, y, x), features [P, 3] (RGB), labels [P]."""
    s = place(pool, p, scale)
    n = s["xyz"].shape[0]
    coords = np.concatenate([np.zeros((n, 1), np.int32),
                             np.floor(s["xyz"]).astype(np.int32)], axis=1)
    return {"coords": coords, "features": s["colors"], "labels": s["labels"]}


def batch_coords(pool: RoomPool, ps: Sequence[Placement], scale: float
                 ) -> np.ndarray:
    """The point coords [P, 4] (scene, z, y, x) of a batch's rooms."""
    return np.concatenate([
        np.concatenate([np.full((pool.rooms[p.room]["xyz"].shape[0], 1), s,
                                np.int32),
                        np.floor(place(pool, p, scale)["xyz"])
                        .astype(np.int32)], axis=1)
        for s, p in enumerate(ps)])


def make_batch(pool: RoomPool, ps: Sequence[Placement], scale: float,
               p_cap: int, num_instances: int) -> Dict[str, np.ndarray]:
    """A training batch of the placed rooms in `make_batch`'s schema
    (coords [p_cap, 4] with -1 pad rows, features, labels, instance_id
    renumbered per scene with num_instances // len(ps) slots a scene,
    point_scene, pose (metres), offsets, displacements, occupancy). The
    ground truth is `make_batch`'s: displacement = pose - the instance's
    mean pose, offset exp(-(|displacement| / 0.6)^2), occupancy log(the
    instance's point count), 0 off the kept instances; the displacement is
    worked out in the room's frame and rotated with it. Raises if the
    points do not fit `p_cap` (the port would drop some)."""
    ns = len(ps)
    per = num_instances // ns
    n = sum(pool.rooms[p.room]["xyz"].shape[0] for p in ps)
    if n > p_cap:
        raise ValueError(f"{n} points do not fit the point cap {p_cap}")
    out = {"coords": np.full((p_cap, 4), -1, np.int32),
           "features": np.zeros((p_cap, 3), np.float32),
           "labels": np.full(p_cap, -1, np.int32),
           "instance_id": np.full(p_cap, -1, np.int32),
           "point_scene": np.full(p_cap, ns, np.int32),
           "pose": np.zeros((p_cap, 3), np.float32),
           "offsets": np.zeros((p_cap, 1), np.float32),
           "displacements": np.zeros((p_cap, 3), np.float32),
           "occupancy": np.zeros((p_cap, 1), np.float32)}
    at = 0
    for s, p in enumerate(ps):
        room = pool.rooms[p.room]
        sc = place(pool, p, scale)
        k = sc["xyz"].shape[0]
        rows = slice(at, at + k)
        at += k
        out["coords"][rows, 0] = s
        out["coords"][rows, 1:] = np.floor(sc["xyz"])
        out["features"][rows] = sc["colors"]
        out["labels"][rows] = sc["labels"]
        iid = sc["instance_id"]
        keep = (iid >= 0) & (iid < per)
        out["instance_id"][rows] = np.where(keep, iid + s * per, -1)
        out["point_scene"][rows] = s
        out["pose"][rows] = sc["xyz"] / np.float32(scale)
        d = room["to_centre"]
        ca, sa = np.float32(np.cos(p.angle)), np.float32(np.sin(p.angle))
        disp = np.stack([d[:, 0], ca * d[:, 1] - sa * d[:, 2],
                         sa * d[:, 1] + ca * d[:, 2]], axis=1)
        disp[~keep] = 0
        out["displacements"][rows] = disp
        dist = np.sqrt((disp * disp).sum(1))
        out["offsets"][rows, 0] = np.where(
            keep, np.exp(-(dist / SIGMA_CENTRE) ** 2), 0)
        out["occupancy"][rows, 0] = np.where(
            keep, np.log(np.maximum(room["inst_count"], 1)), 0)
    return out
