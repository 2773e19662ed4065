"""Occupancy-guided greedy cluster merging (reference `merge`,
`evaluate_instance.py:162-233`).

Sequential agglomeration: repeatedly take the most-similar cluster pair
(cross-modal gaussian similarity of gaussian-weighted cluster centers,
divided by the pair's occupancy ratio) and merge while the merged size is
still *below* what the predicted occupancy says the object should have
(occupancy_ratio_x + occupancy_ratio_y < 2, i.e. the clusters together still
under-fill one object). NumPy: the loop is inherently sequential over a few
hundred clusters; the heavy per-point aggregation already happened on device
in `supervoxel.aggregate_regions` / `meanshift_cluster`.

A copy of `occuseg_tpu/cluster/merge.py`, which the port cannot import
(importing `occuseg_tpu` imports jax).
"""

from __future__ import annotations

import numpy as np


def _gaussian_weighted_mean(values: np.ndarray, bw: float,
                            counts: np.ndarray) -> np.ndarray:
    """(reference `gaussian_weighted_mean`, `evaluate_instance.py:135-142`)"""
    c = values.mean(axis=0, keepdims=True)
    d = np.linalg.norm(values - c, axis=1)
    b = max(bw * 2, 1e-8)
    w = np.exp(-0.5 * (d / b) ** 2) / (b * np.sqrt(2 * np.pi)) * counts
    w = w[:, None]
    return (values * w).sum(0) / np.maximum(w.sum(0), 1e-12)


def occupancy_merge(cluster_of_region: np.ndarray,
                    region_embedding: np.ndarray,
                    region_pose: np.ndarray,
                    region_bw: np.ndarray,
                    region_count: np.ndarray,
                    region_occupancy: np.ndarray,
                    bw_relax_factor: float = 1.0,
                    similarity_threshold: float = 0.5) -> np.ndarray:
    """Merge clusters of supervoxels; returns new cluster id per region.

    cluster_of_region: [R] int, -1 = background.
    """
    cids = [c for c in np.unique(cluster_of_region) if c >= 0]
    groups = {c: list(np.where(cluster_of_region == c)[0]) for c in cids}
    n = len(cids)
    if n <= 1:
        return cluster_of_region.copy()

    def cluster_stats(regs):
        regs = np.asarray(regs)
        cnt = region_count[regs].sum()
        occ = region_occupancy[regs].mean()
        bwm = region_bw[regs].mean(axis=0)
        ce = _gaussian_weighted_mean(region_embedding[regs], bwm[0],
                                     region_count[regs])
        cp = _gaussian_weighted_mean(region_pose[regs], bwm[1],
                                     region_count[regs])
        return dict(count=cnt, occ=occ, bw=bwm, ce=ce, cp=cp)

    stats = {c: cluster_stats(groups[c]) for c in cids}
    alive = {c: True for c in cids}

    def pair_similarity(a, b):
        sa, sb = stats[a], stats[b]
        tot = sa["count"] + sb["count"]
        bw1 = (sa["bw"][0] * sa["count"] + sb["bw"][0] * sb["count"]) / tot
        bw2 = (sa["bw"][1] * sa["count"] + sb["bw"][1] * sb["count"]) / tot
        d1 = np.linalg.norm(sa["ce"] - sb["ce"]) * bw1 * bw_relax_factor
        d2 = np.linalg.norm(sa["cp"] - sb["cp"]) * bw2 * bw_relax_factor
        prob = np.exp(-d1 * d1 - d2 * d2)
        occupancy_ratio = max(tot / np.exp(sb["occ"]), 0.5)
        return prob / occupancy_ratio

    sim = np.full((n, n), -1.0)
    idx = {c: i for i, c in enumerate(cids)}
    for i, a in enumerate(cids):
        for j, b in enumerate(cids):
            if i != j:
                sim[i, j] = pair_similarity(a, b)

    while True:
        flat = np.argmax(sim)
        i, j = divmod(flat, n)
        if sim[i, j] <= similarity_threshold:
            break
        a, b = cids[max(i, j)], cids[min(i, j)]
        ra = (stats[a]["count"] / np.exp(stats[a]["occ"]))
        rb = (stats[b]["count"] / np.exp(stats[b]["occ"]))
        if ra + rb < 2.0:  # together they still under-fill one object
            groups[b] = groups[b] + groups[a]
            alive[a] = False
            groups[a] = []
            sim[idx[a], :] = -1
            sim[:, idx[a]] = -1
            stats[b] = cluster_stats(groups[b])
            for c in cids:
                if alive[c] and c != b:
                    s = pair_similarity(b, c)
                    sim[idx[b], idx[c]] = s
                    sim[idx[c], idx[b]] = s
            sim[idx[b], idx[b]] = -1
        else:
            sim[i, j] = -1

    out = np.full_like(cluster_of_region, -1)
    for c in cids:
        if alive[c]:
            out[np.asarray(groups[c], dtype=int)] = c
    return out
