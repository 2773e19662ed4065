"""The port's gather convolution (TPU row #9) against the JAX package on
the CPU: its plain version against `gather_conv_pallas(interpret=True)`
at `tests/test_pallas_kernel.py`'s shapes, and, at channel counts the TPU
kernel does not take (multiples of 8 below 128), against the JAX
package's XLA gather convolution. Tolerance 1e-4: f32 sums over up to
27 x 128 products in another order."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from occuseg_tpu.core import topology as T
from occuseg_tpu.ops.conv import gather_conv as jax_gather_conv
from occuseg_tpu.ops.pallas.gather_conv import gather_conv_pallas

from occuseg_tpu_torch.ops.kernels import gather_conv as gc
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
