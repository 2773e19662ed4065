"""The blocked segment sum (TPU row #2) replayed in NumPy on the CPU.

`tests/segsum_replay.replay` follows `csrc/segsum.cu`: the host plan of
its threads and column chunks (`segsum.geometry`), each voxel block's slot
ids and slab, the runs from the ids, and every run summed in slot order in
f32. It is held against the port's plain version and the JAX package's
`blocked_segment_sum` (interpret mode) within 1e-5 of the largest output
(f32 sums in another order), on layouts with a run of 70 points, empty
voxels, a block of pads only, ids >= W and a tail of rows past B*R that
must not be read. The plain version does not skip ids >= W (the point
layout makes none), so it is given the same ids masked to -1, which is
what skipping them means. On a card `tests/test_torch_kernels.py` holds
the kernel to the same replay bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from occuseg_tpu.ops.pallas.segsum import (
    blocked_segment_sum as jax_blocked_segment_sum,
)
from tests import jax_planner  # noqa: F401  (heals the JAX planner)
from tests.segsum_replay import chunks, layout, replay

from occuseg_tpu_torch.ops.kernels import segsum

TAIL = 40  # rows past B*R


@pytest.mark.parametrize("R,W,C,threads", [(248, 192, 1, 128),
                                           (248, 192, 3, 128),
                                           (248, 192, 4, 128),
                                           (248, 192, 64, 256),
                                           (512, 64, 40, 256)])
def test_segment_sum_replay(R, W, C, threads):
    B = 5
    seg, masked = layout(B, R, W, seed=C)
    rng = np.random.default_rng(C)
    x = rng.standard_normal((B * R + TAIL, C)).astype(np.float32)
    x[B * R:] = 1e6  # the tail: read by no version
    got, took = replay(x, seg, B * W)
    assert took == threads
    assert got.shape == (B * W, C) and np.abs(got).max() < 1e3
    assert (got.reshape(B, W, C)[1] == 0).all()        # pads only
    lens = np.bincount(masked[0, 0][masked[0, 0] >= 0], minlength=W)
    assert lens.max() >= 70 and (lens == 0).any()      # long run, empties
    plain = segsum.blocked_segment_sum_plain(
        torch.from_numpy(x), torch.from_numpy(masked), B * W).numpy()
    ref_j = np.asarray(jax_blocked_segment_sum(
        jnp.asarray(x), jnp.asarray(seg), B * W, interpret=True))
    for want in (plain, ref_j):
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())


def test_geometry_chunks():
    """The host plan: 128 threads up to SMALL_SLAB floats a block, one
    chunk up to BLOCK_SLAB, then 16-byte aligned chunks where C allows."""
    assert chunks(248, 8) == (128, [(0, 8)])
    assert chunks(248, 9) == (256, [(0, 9)])
    assert chunks(248, 66) == (256, [(0, 66)])
    assert chunks(248, 68) == (256, [(0, 64), (64, 4)])
    assert chunks(248, 67) == (256, [(0, 66), (66, 1)])
    assert chunks(16384, 2) == (256, [(0, 1), (1, 1)])
