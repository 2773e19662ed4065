"""Permutohedral-lattice offsets (a copy of
`occuseg_tpu/ops/permutohedral.py`; NumPy, no device code).

The reference's permutohedral submanifold convolution
(`permutohedralSubmanifoldConvolution.py`) takes as its filter support the
d^2+d+1 nearest lattice neighbours of the A_d lattice instead of the 3^d
cube. Callers map coordinates into lattice space with `embed_points`
first; `core/topology.build_level(offsets=...)` then builds the neighbour
map with the same lookups as the cubic case (K = 13 at d = 3), and
`nn/extras.PermutohedralSubmanifoldConvolution` runs the gather
convolution over it.
"""

from __future__ import annotations

import functools

import numpy as np


@functools.lru_cache(maxsize=None)
def permutohedral_basis(dimension: int):
    """Lower-triangular basis `a` whose rows are unit vectors at 60
    degrees pairwise (<a_i, a_j> = 1/2 for j < i, |a_i| = 1), and its
    inverse. Map coordinates into lattice space with `x @ a_inverse`."""
    a = np.zeros((dimension, dimension))
    for i in range(dimension):
        for j in range(i):
            a[i, j] = (0.5 - a[i] @ a[j]) / a[j, j]
        a[i, i] = np.sqrt(1.0 - a[i] @ a[i])
    return a, np.linalg.inv(a)


@functools.lru_cache(maxsize=None)
def permutohedral_offsets(dimension: int) -> np.ndarray:
    """[d^2+d+1, d] int32 lattice offsets whose embedded length is <= 1:
    the zero offset first, then the nearest lattice neighbours in
    lexicographic order."""
    a, _ = permutohedral_basis(dimension)
    grid = np.stack(np.meshgrid(*([[-1, 0, 1]] * dimension),
                                indexing="ij"), axis=-1).reshape(-1, dimension)
    v = grid @ a
    keep = grid[(v * v).sum(axis=1) <= 1.0 + 0.01]
    order = np.lexsort(keep.T[::-1])
    keep = keep[order]
    zero = np.where((keep == 0).all(axis=1))[0][0]
    keep = np.concatenate([keep[zero:zero + 1], keep[:zero],
                           keep[zero + 1:]])
    assert keep.shape[0] == dimension ** 2 + dimension + 1
    return keep.astype(np.int32)


def embed_points(xyz: np.ndarray, scale: float = 1.0) -> np.ndarray:
    """Float positions [P, d] -> integer permutohedral-lattice coordinates
    (rounded, int32)."""
    d = xyz.shape[-1]
    _, ai = permutohedral_basis(d)
    return np.rint(np.asarray(xyz) * scale @ ai).astype(np.int32)
