"""The BCE radius (TPU row #6) replayed in NumPy on the CPU.

`tests/radius_replay.replay` follows `csrc/bce_loss.cu`'s radius kernel:
the 4-point vectors dealt to warps, the fold of a run inside a thread,
each warp round (one shared atomic per run of one id over consecutive
lanes), the tail of P % 4 points, and the blocks' maxima combined, with
`bce_loss.radius_blocks` blocks of 256 threads, and with a grid of 2
whose warps take several vectors. On
`bce_loss.exact_inputs` every distance is exact in f32, so the replay
must equal the port's plain version and the JAX package's `radius_sq`
(interpret mode, on the points padded to a multiple of 128 with no
instance) bit for bit, on ids drawn at random, in runs of one instance
(the CLI's layout and a synthetic one), with no instance at all, with an
instance that has no point (-> 0), I = 1 and 128, P below one block's
share and P not divisible by 4. On runs the replay counts about one
shared atomic per run a warp meets, not one a point.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from occuseg_tpu.ops.pallas import bce_loss as jax_bce
from tests import jax_planner  # noqa: F401  (heals the JAX planner)
from tests.radius_replay import replay, run_seg

from occuseg_tpu_torch.ops.kernels import bce_loss

LAYOUTS = {  # name: (P, I, ids)
    "random": (4096, 128, None),
    "cli": (8192, 128, lambda P, I: bce_loss.cli_seg(P, I, seed=3)),
    "runs": (40_002, 64, lambda P, I: run_seg(P, I, seed=1)),
    "none": (2048, 16, lambda P, I: np.full(P, -1, np.int32)),
    "empty": (2050, 32, "empty"),
    "one": (1001, 1, None),
    "small": (103, 8, lambda P, I: run_seg(P, I, seed=2)),
}


@functools.lru_cache(maxsize=None)
def _case(name):
    """(x4, seg, mp4, mp_sq) as NumPy, the plain version's and the JAX
    package's r_sq."""
    P, I, make = LAYOUTS[name]
    if make == "empty":
        seg = np.random.default_rng(5).integers(0, I, P).astype(np.int32)
        seg[seg == 5] = 6
    else:
        seg = None if make is None else make(P, I)
    _, _, x4, seg_t, _, _, mp4, cons, _ = bce_loss.exact_inputs(
        P, I, 4, seed=P + I, seg=seg)
    mp_sq = cons[bce_loss.MP_SQ].contiguous()
    plain = bce_loss.radius_sq_plain(x4, seg_t, mp4, mp_sq).numpy()
    x4, seg, mp4, mp_sq = (t.numpy() for t in (x4, seg_t, mp4, mp_sq))
    pad = -P % 128  # JAX's blocks: points with no instance
    x8 = np.pad(x4, ((0, pad), (0, 4)))
    seg2 = np.pad(seg, (0, pad), constant_values=-1)[:, None]
    cons8 = np.zeros((8, I), np.float32)
    cons8[1] = mp_sq
    want = np.asarray(jax_bce.radius_sq(
        jnp.asarray(x8), jnp.asarray(seg2), jnp.asarray(np.pad(mp4, (
            (0, 0), (0, 4)))), jnp.asarray(cons8), interpret=True))[0]
    return (x4, seg, mp4, mp_sq), plain, want


@pytest.mark.parametrize("grid", ["sms132", "two"])
@pytest.mark.parametrize("name", list(LAYOUTS))
def test_radius_replay(name, grid):
    (x4, seg, mp4, mp_sq), plain, want = _case(name)
    P, I = seg.shape[0], mp4.shape[0]
    n_blocks = bce_loss.radius_blocks(P, 132) if grid == "sms132" else 2
    got, atomics, words = replay(x4, seg, mp4, mp_sq, n_blocks)
    np.testing.assert_array_equal(got, plain)
    np.testing.assert_array_equal(got, want)
    valid = int(((seg >= 0) & (seg < I)).sum())
    assert atomics <= valid
    if name == "none":
        assert atomics == 0 and not got.any()
    if name == "empty":
        assert got[5] == 0 and (got[np.arange(I) != 5] > 0).all()
    if name in ("cli", "runs"):  # most warps hold one run
        assert 0 < atomics * 16 <= valid
    if name == "small":  # one block's share, and three tail points
        assert P < 4 * bce_loss.RADIUS_THREADS and P % 4 == 3
        assert not words[1:].any()


def test_radius_blocks():
    """One 4-point vector a thread up to four blocks per SM; then warps
    take several (`grid2` above); at least one block."""
    assert bce_loss.radius_blocks(262_144, 132) == 256
    assert bce_loss.radius_blocks(10_000_000, 132) == 528
    assert bce_loss.radius_blocks(3, 132) == 1
    lens, n_none = bce_loss.run_lengths(np.array([-1, 2, 2, 2, -1, 0, 0, 3]))
    assert list(lens) == [3, 2, 1] and n_none == 2
