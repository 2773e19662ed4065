"""Supervoxel generation (counterpart of
`occuseg_tpu/data/supervoxel_gen.py`): the in-process stand-in for the
external ScanNet `Segmentator` whose `.regions.json` the reference reads.

Felzenszwalb-Huttenlocher segmentation over a voxel-adjacency graph, with
edge weights from estimated point normals (PCA over voxel neighbourhoods)
and colour differences. `segment_supervoxels` runs the C++ segmenter of
`csrc/native.cpp` through the port's binding and raises if the library
cannot be built or loaded; `_segment_numpy` is the same algorithm in NumPy,
kept as the tests' oracle.
"""

from __future__ import annotations

import numpy as np

from occuseg_tpu_torch import native


def estimate_normals(points: np.ndarray, cell: float = 0.06) -> np.ndarray:
    """Cheap per-voxel PCA normals: smallest eigenvector of the covariance
    of each point's voxel neighborhood (sufficient for FH edge weights)."""
    vox = np.floor(points / cell).astype(np.int64)
    key = (vox[:, 0] << 42) + (vox[:, 1] << 21) + vox[:, 2]
    order = np.argsort(key)
    skey = key[order]
    boundaries = np.flatnonzero(np.diff(skey)) + 1
    groups = np.split(order, boundaries)
    normals = np.zeros_like(points, dtype=np.float32)
    for g in groups:
        if g.size < 3:
            normals[g] = (0, 0, 1)
            continue
        p = points[g]
        c = p - p.mean(0)
        cov = c.T @ c
        w, v = np.linalg.eigh(cov)
        normals[g] = v[:, 0]
    return normals


def _segment_numpy(points: np.ndarray, feat: np.ndarray, cell: float,
                   k_thresh: float, min_size: int) -> np.ndarray:
    """NumPy FH segmentation (the algorithm of csrc/native.cpp; its segment
    ids are numbered in root order, the C++ ones in first-seen order)."""
    n = points.shape[0]
    vox = np.floor(points / cell).astype(np.int64)
    key = ((vox[:, 0] + (1 << 20)) << 42) \
        + ((vox[:, 1] + (1 << 20)) << 21) + (vox[:, 2] + (1 << 20))
    first = {}
    intra = []
    prev_in_cell = {}
    for i in range(n):
        k = key[i]
        if k in prev_in_cell:
            intra.append((prev_in_cell[k], i))
        else:
            first[k] = i
        prev_in_cell[k] = i
    offs = np.array([[1, 0, 0], [0, 1, 0], [0, 0, 1], [1, 1, 0], [1, -1, 0],
                     [1, 0, 1], [1, 0, -1], [0, 1, 1], [0, 1, -1], [1, 1, 1],
                     [1, 1, -1], [1, -1, 1], [1, -1, -1]])
    ea, eb = [i for i, _ in intra], [j for _, j in intra]
    for o in offs:
        nk = ((vox[:, 0] + o[0] + (1 << 20)) << 42) \
            + ((vox[:, 1] + o[1] + (1 << 20)) << 21) \
            + (vox[:, 2] + o[2] + (1 << 20))
        for i in range(n):
            j = first.get(nk[i])
            if j is not None:
                ea.append(i)
                eb.append(j)
    ea = np.asarray(ea)
    eb = np.asarray(eb)
    w = np.linalg.norm(feat[ea] - feat[eb], axis=1)
    order = np.argsort(w)
    ea, eb, w = ea[order], eb[order], w[order]

    parent = np.arange(n)
    size = np.ones(n, np.int64)
    thr = np.full(n, k_thresh, np.float64)

    def find(x):
        root = x
        while parent[root] != root:
            root = parent[root]
        while parent[x] != root:
            parent[x], x = root, parent[x]
        return root

    for i in range(ea.size):
        a, b = find(ea[i]), find(eb[i])
        if a == b:
            continue
        if w[i] <= thr[a] and w[i] <= thr[b]:
            parent[b] = a
            size[a] += size[b]
            thr[a] = w[i] + k_thresh / size[a]
    for i in range(ea.size):
        a, b = find(ea[i]), find(eb[i])
        if a != b and (size[a] < min_size or size[b] < min_size):
            parent[b] = a
            size[a] += size[b]
    roots = np.array([find(i) for i in range(n)])
    _, labels = np.unique(roots, return_inverse=True)
    return labels.astype(np.int32)


def segment_supervoxels(points: np.ndarray,
                        colors: np.ndarray | None = None,
                        cell: float = 0.05, k_thresh: float = 0.3,
                        min_size: int = 20) -> np.ndarray:
    """[N] supervoxel id per point."""
    points = np.asarray(points, np.float32)
    normals = estimate_normals(points)
    feat = normals if colors is None else np.concatenate(
        [normals, 0.5 * np.asarray(colors, np.float32)], axis=1)
    return native.segment_supervoxels(points, feat, cell, k_thresh, min_size)
