"""The bf16 gather convolution kernel (`occuseg_tpu_torch/csrc/
gather_conv.cu`, TPU row #9) replayed in NumPy, in f32, for the CPU tests.

`replay` follows the kernel: `gather_conv.geometry`'s column tile and
split count over the M output rows of the map nbr_kn [K, M]; blocks of
128 output rows; each tile's neighbour ids (-1 for a missing neighbour,
an id outside the N source rows and a row past M); its live
offsets in ascending order, each with the 64-row halves that have a
neighbour there (an offset whose 128 ids are all -1 is skipped whole);
the steps (live offset, Cin tile of 64 columns) with k ascending, then
Cin ascending, cut into `splits` contiguous ranges; each range summed in
f32 one step at a time (columns past Cin read as zeros, a half with no
neighbour at the offset adds nothing); the ranges' partials summed in
rank order.
"""

from __future__ import annotations

import numpy as np

from occuseg_tpu_torch.ops.kernels import gather_conv as gc


def tile_ids(nbr_kn: np.ndarray, tile: int, n_src=None) -> np.ndarray:
    """[K, 128] ids of one tile's output rows into n_src source rows
    (default: as many as the map's rows), -1 where the kernel reads
    none."""
    K, M = nbr_kn.shape
    n_src = M if n_src is None else n_src
    ids = np.full((K, gc.TILE), -1, np.int64)
    rows = np.arange(tile * gc.TILE, min(M, (tile + 1) * gc.TILE))
    ids[:, :rows.size] = nbr_kn[:, rows]
    ids[(ids < 0) | (ids >= n_src)] = -1
    return ids


def tile_steps(ids: np.ndarray, cin: int):
    """The tile's steps in kernel order: (k, halves, ci0), halves the bit
    mask of the 64-row halves with a neighbour at k."""
    halves = ((ids[:, :64] >= 0).any(1).astype(int)
              | 2 * (ids[:, 64:] >= 0).any(1).astype(int))
    return [(k, int(halves[k]), ci0) for k in range(ids.shape[0])
            if halves[k] for ci0 in range(0, cin, gc.CIN_TILE)]


def replay(feats, nbr_kn, w, sms: int):
    """([M, Cout] f32, skipped (tile, offset) pairs, (column tile,
    splits)) for feats [N, Cin] and nbr_kn [K, M]."""
    feats = np.asarray(feats, np.float32)
    w = np.asarray(w, np.float32)
    nbr_kn = np.asarray(nbr_kn)
    N, cin = feats.shape
    (K, M), cout = nbr_kn.shape, w.shape[2]
    nt, splits = gc.geometry(M, cin, cout, K, sms)
    out = np.zeros((M, cout), np.float32)
    skipped = 0
    # zero rows past Cin: the kernel's zero-filled A columns and W rows
    feats_p = np.pad(feats, ((0, 1), (0, -cin % gc.CIN_TILE)))
    w_p = np.pad(w, ((0, 0), (0, -cin % gc.CIN_TILE), (0, 0)))
    for tile in range(-(-M // gc.TILE)):
        ids = tile_ids(nbr_kn, tile, N)
        steps = tile_steps(ids, cin)
        skipped += K - len({k for k, _, _ in steps})
        n = len(steps)
        r0 = tile * gc.TILE
        m = min(gc.TILE, M - r0)
        for co0 in range(0, cout, nt):
            co1 = min(cout, co0 + nt)
            total = None
            for rank in range(splits):
                acc = np.zeros((gc.TILE, co1 - co0), np.float32)
                for k, halves, ci0 in steps[n * rank // splits:
                                            n * (rank + 1) // splits]:
                    a = feats_p[ids[k], ci0:ci0 + gc.CIN_TILE]  # -1: zeros
                    b = w_p[k, ci0:ci0 + gc.CIN_TILE, co0:co1]
                    for g in range(2):
                        if halves >> g & 1:
                            rows = slice(64 * g, 64 * g + 64)
                            acc[rows] += a[rows] @ b
                total = acc if total is None else total + acc
            out[r0:r0 + m, co0:co1] = total[:m]
    return out, skipped, (nt, splits)
