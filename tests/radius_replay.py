"""The BCE radius kernel (`occuseg_tpu_torch/csrc/bce_loss.cu`, TPU row #6)
replayed in NumPy, for the CPU tests.

`replay` follows the kernel's work split: the P // 4 vectors of 4 points
(one int4 of ids and four float4 of x a thread) dealt to warps
grid-stride, 32 consecutive vectors a warp; inside a thread, equal
neighbouring ids folded into the run's last slot; one warp-wide round per
slot, in which each run of one valid id over consecutive lanes takes its
max and one shared atomicMax; the P % 4 last points in one more round of warp 0 of block 0;
then the max over the blocks' words (global atomics, and the last block
moves it to the output). A max is exact in any order, so the kernel and
the replay agree bit for bit; the replay also counts the shared atomics.
"""

from __future__ import annotations

import numpy as np

from occuseg_tpu_torch.ops.kernels import bce_loss

WARPS = bce_loss.RADIUS_THREADS // 32


def point_bits(x4, mp4, mp_sq, ids):
    """The per-point value |x|^2 + |mp_i|^2 - 2 x.mp_i clamped at 0, as
    f32 bits."""
    x = np.asarray(x4, np.float32)
    m = np.asarray(mp4, np.float32)[ids]
    v = ((x * x).sum(1, dtype=np.float32) + np.asarray(mp_sq, np.float32)[ids]
         - np.float32(2) * (x * m).sum(1, dtype=np.float32))
    return np.maximum(v, np.float32(0)).astype(np.float32).view(np.uint32)


def replay(x4, seg, mp4, mp_sq, n_blocks: int):
    """(r_sq [I] f32, shared atomics, the blocks' words [n_blocks, I])
    as the kernel computes them with n_blocks blocks."""
    seg = np.asarray(seg)
    P, I = seg.shape[0], np.asarray(mp4).shape[0]
    P4 = P // 4
    ids = np.where((seg >= 0) & (seg < I), seg, -1).astype(np.int64)
    bits = np.zeros(P, np.uint32)
    ok = ids >= 0
    bits[ok] = point_bits(np.asarray(x4)[ok], mp4, mp_sq, ids[ok])
    words = np.zeros((n_blocks, I), np.uint32)

    def rounds(block, key, val):
        """One round per warp chunk [n, 32] of one slot: each run of one
        valid id over consecutive lanes takes one shared atomicMax."""
        ok = key >= 0
        np.maximum.at(words, (np.broadcast_to(block[:, None], key.shape)[ok],
                              key[ok]), val[ok])
        start = np.ones_like(ok)
        start[:, 1:] = key[:, 1:] != key[:, :-1]
        return int((start & ok).sum())

    # vector v: warp chunk v // 32 (32 consecutive vectors, one per lane),
    # taken by global warp chunk % (n_blocks * WARPS) in turn; a chunk's
    # lanes past P // 4 hold no id
    P4r = -(-P4 // 32) * 32
    vid = np.full((P4r, 4), -1, np.int64)
    vbits = np.zeros((P4r, 4), np.uint32)
    vid[:P4] = ids[:4 * P4].reshape(P4, 4)
    vbits[:P4] = bits[:4 * P4].reshape(P4, 4)
    for j in range(1, 4):  # fold a run inside the thread into its last slot
        eq = vid[:, j] == vid[:, j - 1]
        vbits[:, j] = np.where(eq, np.maximum(vbits[:, j], vbits[:, j - 1]),
                               vbits[:, j])
        vid[:, j - 1] = np.where(eq, -1, vid[:, j - 1])
    chunk = np.arange(P4r // 32)
    block = (chunk % (n_blocks * WARPS)) // WARPS
    atomics = sum(rounds(block, vid[:, j].reshape(-1, 32),
                         vbits[:, j].reshape(-1, 32)) for j in range(4))
    tail = np.full(32, -1, np.int64)  # warp 0 of block 0, one round
    tail_bits = np.zeros(32, np.uint32)
    tail[:P - 4 * P4] = ids[4 * P4:]
    tail_bits[:P - 4 * P4] = bits[4 * P4:]
    atomics += rounds(np.zeros(1, np.int64), tail[None], tail_bits[None])
    return words.max(0).view(np.float32), atomics, words


def run_seg(P: int, I: int, seed: int) -> np.ndarray:
    """Ids [P] in runs of one instance, as the CLI's scenes lay them out:
    runs of -1 (floor, walls) between objects' runs of 5-400 points, and
    instance 0 at two places."""
    rng = np.random.default_rng(seed)
    out, i = [], 0
    while sum(map(len, out)) < P:
        out.append(np.full(int(rng.integers(5, 400)), -1))
        out.append(np.full(int(rng.integers(5, 400)), i % I))
        i += 1
    return np.concatenate(out)[:P].astype(np.int32)
