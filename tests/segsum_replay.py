"""The blocked segment sum kernel (`occuseg_tpu_torch/csrc/segsum.cu`,
TPU row #2) replayed in NumPy, for the CPU tests and the card tests.

`replay` follows the kernel: the threads and column chunks of
`segsum.geometry`, each voxel block's slot ids and slab (rows past B*R are
never read), the runs' [start, end) from the ids (pad slots and ids >= W
skipped), and each run summed in slot order in f32 from 0. The kernel adds
the same f32 values in the same order, so on a card the two agree bit for
bit. `layout` makes sorted slot ids with the cases the tests need.
"""

from __future__ import annotations

import numpy as np

from occuseg_tpu_torch.ops.kernels import segsum


def chunks(R: int, C: int):
    """The kernel's (threads, column chunks) for blocks of R slots and C
    channels, with the host plan's invariants checked."""
    threads, cc = segsum.geometry(R, C)
    assert threads == (128 if R * C <= segsum.SMALL_SLAB else 256)
    assert 1 <= cc <= C and R * cc <= max(segsum.BLOCK_SLAB, R)
    if C % 4 == 0 and cc < C:
        assert cc % 4 == 0  # chunks stay 16-byte aligned
    return threads, [(c0, min(cc, C - c0)) for c0 in range(0, C, cc)]


def replay(x: np.ndarray, vox_seg: np.ndarray, num_out: int):
    """[num_out, C] f32 sums as the kernel computes them, and its CTA's
    thread count."""
    B, _, R = vox_seg.shape
    W = num_out // B
    C = x.shape[1]
    seg = vox_seg.reshape(B, R)
    slab = np.asarray(x[:B * R], np.float32).reshape(B, R, C)
    valid = (seg >= 0) & (seg < W)
    prev = np.concatenate([np.full((B, 1), -2), seg[:, :-1]], 1)
    nxt = np.concatenate([seg[:, 1:], np.full((B, 1), -2)], 1)
    start = np.zeros((B, W), np.int64)
    end = np.zeros((B, W), np.int64)
    b, r = np.nonzero(valid & (prev != seg))
    start[b, seg[b, r]] = r
    b, r = np.nonzero(valid & (nxt != seg))
    end[b, seg[b, r]] = r + 1
    lens = end - start
    threads, cols = chunks(R, C)
    out = np.zeros((B, W, C), np.float32)
    for c0, n in cols:
        for k in range(int(lens.max(initial=0))):  # slot order
            bb, ww = np.nonzero(lens > k)
            out[bb, ww, c0:c0 + n] += slab[bb, start[bb, ww] + k, c0:c0 + n]
    return out.reshape(B * W, C), threads


def layout(B: int, R: int, W: int, seed: int):
    """Sorted slot ids [B, 1, R], pads (-1) at the end of each block, and
    the same with the ids >= W masked to -1. Block 0 holds a run of 70
    points, block 1 only pads, block 2 every slot with three ids >= W at
    its end; the other blocks random runs (many voxels of a block empty)."""
    rng = np.random.default_rng(seed)
    seg = np.full((B, R), -1, np.int32)
    for b in range(B):
        if b == 1:
            continue
        n = R if b == 2 else int(rng.integers(R // 3, R))
        ids = np.sort(rng.integers(0, W, n))
        if b == 0:
            ids = np.sort(np.concatenate([ids[70:], np.full(70, 5)]))
        if b == 2:
            ids[-3:] = W + np.arange(3)
        seg[b, :n] = ids
    masked = np.where(seg < W, seg, -1).astype(np.int32)
    return seg.reshape(B, 1, R), masked.reshape(B, 1, R)
