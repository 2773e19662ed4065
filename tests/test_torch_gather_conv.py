"""The port's gather convolution (TPU row #9) against the JAX package on
the CPU: its plain version and a NumPy replay of the bf16 kernel's work
split (`tests/gather_replay.py`) against `gather_conv_pallas(
interpret=True)` at `tests/test_pallas_kernel.py`'s shapes and at the
bench plan's L3-L5 widths, and, at channel counts the TPU kernel does not
take (multiples of 8 below 128), against the JAX package's XLA gather
convolution. Tolerance 1e-4: f32 sums over up to 27 x 384 products in
another order."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from occuseg_tpu.core import topology as T
from occuseg_tpu.ops.conv import gather_conv as jax_gather_conv
from occuseg_tpu.ops.pallas.gather_conv import gather_conv_pallas

from occuseg_tpu_torch.ops.kernels import gather_conv as gc
from tests.gather_replay import replay, tile_ids, tile_steps
from tests.utils import random_points


def _level(seed, N):
    rng = np.random.default_rng(seed)
    pts = random_points(rng, 180, extent=16, batch_size=1, pad_to=N)
    keys, _ = T.voxelize_coords(jnp.asarray(pts), N)
    return rng, np.asarray(T.build_level(keys, kernel=3).nbr)


def test_plain_matches_pallas_interpret():
    rng, nbr = _level(5, 256)
    feats = rng.standard_normal((256, 128)).astype(np.float32)
    w = (rng.standard_normal((27, 128, 128)) * 0.1).astype(np.float32)
    nbr_kn = np.ascontiguousarray(nbr.T)
    want = np.asarray(gather_conv_pallas(jnp.asarray(feats),
                                         jnp.asarray(nbr_kn),
                                         jnp.asarray(w), interpret=True))
    got = gc.gather_conv(torch.from_numpy(feats), torch.from_numpy(nbr_kn),
                         torch.from_numpy(w))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    assert gc.gather_conv.launches == 0  # CPU tensors: the plain version


@pytest.mark.parametrize("cin,cout", [(8, 24), (40, 16), (64, 136)])
def test_plain_matches_xla_gather_conv(cin, cout):
    rng, nbr = _level(cin + cout, 256)
    feats = rng.standard_normal((256, cin)).astype(np.float32)
    w = (rng.standard_normal((27, cin, cout)) * 0.1).astype(np.float32)
    want = np.asarray(jax_gather_conv(jnp.asarray(feats), jnp.asarray(nbr),
                                      jnp.asarray(w)))
    got = gc.gather_conv_plain(torch.from_numpy(feats),
                               torch.from_numpy(np.ascontiguousarray(nbr.T)),
                               torch.from_numpy(w))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


def test_rejects_channels_not_multiple_of_8():
    with pytest.raises(ValueError, match="multiples of 8"):
        gc.gather_conv(torch.zeros(16, 12), torch.zeros(27, 16,
                                                        dtype=torch.int32),
                       torch.zeros(27, 12, 16))


# The bf16 kernel's work split (`tests/gather_replay.py`), replayed in f32
# NumPy: 128-row tiles (N not a multiple of 128), column tiles, Cin tiles
# of 64 with a tail, the skip of offsets whose ids are all -1, the steps
# in k-then-Cin order and their split into a cluster's ranges (sms=132:
# 8 ranges at these sizes; sms=1: one). Tolerance 1e-4 as above.
@pytest.mark.parametrize("cin,cout,sms", [(256, 256, 132), (320, 320, 132),
                                          (384, 384, 1)])
def test_replay_matches_pallas_interpret(cin, cout, sms):
    rng, nbr = _level(cin, 200)
    feats = rng.standard_normal((200, cin)).astype(np.float32)
    w = (rng.standard_normal((27, cin, cout)) * 0.1).astype(np.float32)
    nbr_kn = np.ascontiguousarray(nbr.T)
    blk = 128 if cin % 128 == 0 else 64
    want = np.asarray(gather_conv_pallas(
        jnp.asarray(feats), jnp.asarray(nbr_kn), jnp.asarray(w),
        cin_block=blk, cout_block=blk, interpret=True))
    got, _, (nt, splits) = replay(feats, nbr_kn, w, sms)
    assert (nt, splits) == (128, 8 if sms > 1 else 1)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    plain = gc.gather_conv_plain(torch.from_numpy(feats),
                                 torch.from_numpy(nbr_kn),
                                 torch.from_numpy(w)).numpy()
    np.testing.assert_allclose(got, plain, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("cin,cout", [(8, 24), (40, 16), (64, 136)])
def test_replay_matches_xla_gather_conv(cin, cout):
    rng, nbr = _level(cin + cout, 256)
    feats = rng.standard_normal((256, cin)).astype(np.float32)
    w = (rng.standard_normal((27, cin, cout)) * 0.1).astype(np.float32)
    want = np.asarray(jax_gather_conv(jnp.asarray(feats), jnp.asarray(nbr),
                                      jnp.asarray(w)))
    got, _, (nt, _) = replay(feats, np.ascontiguousarray(nbr.T), w, 132)
    assert nt == {24: 64, 16: 64, 136: 96}[cout]  # Cout tiles with a tail
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_replay_skips_offsets_without_neighbours():
    """A level padded to 512 rows: its pad rows have no neighbour, so the
    two tiles past its active rows skip every offset and write zeros, and
    every other (tile, offset) with all ids -1 is skipped too."""
    rng, nbr = _level(11, 512)
    active = int((nbr >= 0).any(1).sum())
    assert active <= 256 and (nbr[active:] < 0).all()
    feats = rng.standard_normal((512, 32)).astype(np.float32)
    w = (rng.standard_normal((27, 32, 16)) * 0.1).astype(np.float32)
    nbr_kn = np.ascontiguousarray(nbr.T)
    got, skipped, _ = replay(feats, nbr_kn, w, 132)
    dead = sum(int((tile_ids(nbr_kn, t) < 0).all(1).sum()) for t in range(4))
    assert skipped == dead >= 2 * 27
    assert not got[256:].any()
    plain = gc.gather_conv_plain(torch.from_numpy(feats),
                                 torch.from_numpy(nbr_kn),
                                 torch.from_numpy(w)).numpy()
    np.testing.assert_allclose(got, plain, rtol=1e-4, atol=1e-4)


def test_replay_steps_in_k_then_cin_order():
    """Within a tile the steps run k ascending, then Cin ascending, over
    the live offsets only, each with its live 64-row halves; the cluster's
    ranges cut that list in order; split and unsplit sums agree up to f32
    order."""
    rng, nbr = _level(13, 200)
    nbr_kn = np.ascontiguousarray(nbr.T)
    ids = tile_ids(nbr_kn, 1)
    steps = tile_steps(ids, 136)
    assert steps == sorted(steps, key=lambda s: (s[0], s[2]))
    live = [k for k in range(27) if (ids[k] >= 0).any()]
    assert [k for k, _, c in steps if c == 0] == live
    assert {c for _, _, c in steps} == {0, 64, 128}
    assert all(h == 1 for _, h, _ in steps)  # rows 64-127 of tile 1: pad
    feats = rng.standard_normal((200, 136)).astype(np.float32)
    w = (rng.standard_normal((27, 136, 72)) * 0.1).astype(np.float32)
    one, _, (_, s1) = replay(feats, nbr_kn, w, 1)
    split, _, (_, s8) = replay(feats, nbr_kn, w, 132)
    assert (s1, s8) == (1, 8)
    np.testing.assert_allclose(split, one, rtol=1e-5, atol=1e-5)
