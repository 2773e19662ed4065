"""The port's BCE kernels' plain versions (TPU rows #6-#8) and the
classification loss's kernel dispatch against the JAX package on the CPU.

* `radius_sq_plain`, `bce_sums_plain` and `bce_sums_bwd_plain` against the
  JAX package's `radius_sq`, `_bce_sums` and its VJP run with
  interpret=True, on `tests/test_bce_loss.py`'s data (P=512, I=16, E=16):
  within 1e-5 (f32 sums in another order; both pad x, rx and the means
  with zero columns, 4 in the port, 8 in the JAX package).
* The port's `classification_loss` with OCC_PALLAS_BCE=1 (the kernels'
  path, their plain versions on the CPU) and =0 (the chain), held to each
  other at that file's tolerances (forward rtol 2e-5; gradients atol
  3e-5 x max, rtol 2e-4), and each to the JAX package's same path.
* The static gate equals the JAX package's; all-invalid points; a shape
  the gate refuses runs the chain.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from occuseg_tpu.losses.instance import (
    LossConfig as JaxLossConfig,
    classification_loss as jax_classification_loss,
)
from occuseg_tpu.ops.pallas import bce_loss as jax_bce

from occuseg_tpu_torch.losses.instance import LossConfig, classification_loss
from occuseg_tpu_torch.ops.kernels import bce_loss

P, I, E, S = 512, 16, 16, 2


def _data(seed=0, empty_instances=(3, 7), invalid_frac=0.2):
    """tests/test_bce_loss.py's data, as NumPy arrays."""
    rng = np.random.default_rng(seed)
    iid = rng.integers(0, I, P).astype(np.int32)
    for em in empty_instances:
        iid[iid == em] = (em + 1) % I
    iid[rng.random(P) < invalid_frac] = -1
    scene = (np.arange(P) // (P // S)).astype(np.int32)
    centers = rng.normal(0, 4.0, (I, 3))
    pose = (centers[np.clip(iid, 0, I - 1)]
            + rng.normal(0, 0.7, (P, 3))).astype(np.float32)
    labels = rng.integers(0, 20, P).astype(np.int32)
    e = rng.normal(0, 1.0, (P, E)).astype(np.float32)
    bw = rng.normal(0.5, 0.2, (P, 2)).astype(np.float32)
    disp = rng.normal(0, 0.3, (P, 3)).astype(np.float32)
    return e, bw, pose, disp, iid, scene, labels


def _kernel_inputs(seed):
    """The kernels' inputs as `bce_membership_sums` builds them, in NumPy:
    e, rx, x, mu, mean pose, sig, seg, scene, scene_i, use."""
    e, bw, pose, disp, iid, scene, _ = _data(seed)
    valid = iid >= 0
    seg = np.where(valid, iid, I)
    cnt = np.bincount(seg, minlength=I + 1)[:I]

    def mean(v):
        s = np.zeros((I + 1, v.shape[1]))
        np.add.at(s, seg, np.where(valid[:, None], v, 0))
        return (s[:I] / np.maximum(cnt, 1)[:, None]).astype(np.float32)

    scene_i = np.full(I, -1)
    np.maximum.at(scene_i, iid[valid], scene[valid])
    use = (cnt >= 3).astype(np.float32)
    return (e, pose - disp, pose, mean(e), mean(pose), mean(bw), iid, scene,
            scene_i.astype(np.float32), use)


def _pad(a, n):
    return np.pad(a, ((0, 0), (0, n - a.shape[1]))).astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1])
def test_plain_kernels_match_jax_interpret(seed):
    e, rx, x, mu, mp, sig, iid, scene, scene_i, use = _kernel_inputs(seed)
    mp_sq = (mp * mp).sum(1)
    zero = np.zeros(I, np.float32)
    cons_r = np.stack([zero, mp_sq] + [zero] * 6)
    r_jax = np.asarray(jax_bce.radius_sq(
        jnp.asarray(_pad(x, 8)), jnp.asarray(iid[:, None]),
        jnp.asarray(_pad(mp, 8)), jnp.asarray(cons_r), interpret=True))[0]
    t = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in dict(
        e=e, rx4=_pad(rx, 4), x4=_pad(x, 4), seg=iid, scene=scene, mu=mu,
        mp4=_pad(mp, 4)).items()}
    r = bce_loss.radius_sq_plain(t["x4"], t["seg"], t["mp4"],
                                 torch.from_numpy(mp_sq))
    np.testing.assert_allclose(r.numpy(), r_jax, rtol=1e-5,
                               atol=1e-5 * r_jax.max())

    sig_sq = (sig * sig).astype(np.float32)
    cons = np.stack([(mu * mu).sum(1), mp_sq, sig_sq[:, 0], sig_sq[:, 1],
                     16.0 * r_jax, scene_i, use, zero]).astype(np.float32)
    j_args = (jnp.asarray(_pad(x, 8)), jnp.asarray(iid[:, None]),
              jnp.asarray(scene.astype(np.float32)[:, None]),
              jnp.asarray(cons))

    def jax_sums(e_, rx8, sig_sq_, mu_):
        return jax_bce._bce_sums(e_, rx8, sig_sq_, mu_,
                                 jnp.asarray(_pad(mp, 8)), *j_args, True)

    out_j, vjp = jax.vjp(jax_sums, jnp.asarray(e), jnp.asarray(_pad(rx, 8)),
                         jnp.asarray(sig_sq), jnp.asarray(mu))
    cons_t = torch.from_numpy(cons)
    out = bce_loss.bce_sums_plain(t["e"], t["rx4"], t["x4"], t["seg"],
                                  t["scene"], t["mu"], t["mp4"], cons_t)
    out_j = np.asarray(out_j)
    assert out_j[1].sum() > 0 and out_j[4].sum() > 0
    np.testing.assert_allclose(out.numpy(), out_j[:5], rtol=1e-5,
                               atol=1e-5 * np.abs(out_j).max())

    g = np.random.default_rng(seed + 9).standard_normal((8, I)).astype(
        np.float32)
    de_j, drx_j, dsig_j, dmu_j = (np.asarray(a) for a in vjp(jnp.asarray(g)))
    de, drx, dmu, dsig = bce_loss.bce_sums_bwd_plain(
        t["e"], t["rx4"], t["x4"], t["seg"], t["scene"], t["mu"], t["mp4"],
        cons_t, torch.from_numpy(g[0]))
    for got, want, name in ((de, de_j, "de"), (drx, drx_j[:, :4], "drx"),
                            (dmu, dmu_j, "dmu"), (dsig, dsig_j, "dsig")):
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max(),
                                   err_msg=name)
    assert np.abs(drx_j[:, 4:]).max() == 0


@pytest.mark.parametrize("shape", [(512, 16, 16), (300, 16, 16), (512, 4, 16),
                                   (512, 136, 16), (512, 12, 16),
                                   (1024, 128, 256), (1024, 8, 264),
                                   (128, 8, 8)])
def test_gate_matches_jax(shape, monkeypatch):
    for flag in ("1", "0"):
        monkeypatch.setenv("OCC_PALLAS_BCE", flag)
        assert bce_loss.supported(*shape) == jax_bce.supported(*shape)
    monkeypatch.setenv("OCC_PALLAS_BCE", "1")
    assert bce_loss.supported(P, I, E)


def _port_loss(args, n=P, grads=False):
    e, bw, pose, disp, iid, scene, labels = (torch.from_numpy(a[:n].copy())
                                             for a in args)
    leaves = [t.requires_grad_() for t in (e, bw, disp)]
    loss, miou = classification_loss(e, bw, pose - disp, pose, iid, scene,
                                     labels, S, I,
                                     LossConfig(min_instance_points=3))
    if not grads:
        return float(loss.detach()), float(miou.detach())
    loss.backward()
    return [t.grad.numpy() for t in leaves]


def _jax_loss(args, grads=False):
    e, bw, pose, disp, iid, scene, labels = (jnp.asarray(a) for a in args)
    cfg = JaxLossConfig(min_instance_points=3)

    def f(e_, bw_, disp_):
        return jax_classification_loss(e_, bw_, pose - disp_, pose, iid,
                                       scene, labels, S, I, cfg)
    if not grads:
        loss, miou = f(e, bw, disp)
        return float(loss), float(miou)
    return [np.asarray(g) for g in
            jax.grad(lambda *a: f(*a)[0], argnums=(0, 1, 2))(e, bw, disp)]


def _close_grads(a, b):
    for x, y, name in zip(a, b, ("emb", "bw", "disp")):
        assert np.isfinite(x).all(), name
        np.testing.assert_allclose(x, y, atol=3e-5 * (np.abs(y).max() + 1e-12),
                                   rtol=2e-4, err_msg=name)


def test_classification_forward_kernels_vs_chain(monkeypatch):
    data = _data(1)
    res = {}
    for flag in ("1", "0"):
        monkeypatch.setenv("OCC_PALLAS_BCE", flag)
        res[flag] = (_port_loss(data), _jax_loss(data))
    (lk, mk), (ljk, mjk) = res["1"]
    (lc, mc), (ljc, mjc) = res["0"]
    assert lk > 0
    np.testing.assert_allclose(lk, lc, rtol=2e-5)
    np.testing.assert_allclose(mk, mc, rtol=2e-5)
    # each path against the JAX package's same path
    np.testing.assert_allclose((lk, mk), (ljk, mjk), rtol=2e-5)
    np.testing.assert_allclose((lc, mc), (ljc, mjc), rtol=2e-5)


def test_classification_gradients_kernels_vs_chain(monkeypatch):
    data = _data(2)
    monkeypatch.setenv("OCC_PALLAS_BCE", "1")
    gk, gjk = _port_loss(data, grads=True), _jax_loss(data, grads=True)
    monkeypatch.setenv("OCC_PALLAS_BCE", "0")
    gc, gjc = _port_loss(data, grads=True), _jax_loss(data, grads=True)
    assert np.abs(gk[0]).sum() > 0
    _close_grads(gk, gc)
    _close_grads(gk, gjk)
    _close_grads(gc, gjc)


def test_all_invalid_points(monkeypatch):
    data = list(_data(3))
    data[4] = np.full_like(data[4], -1)
    monkeypatch.setenv("OCC_PALLAS_BCE", "1")
    lk, _ = _port_loss(data)
    monkeypatch.setenv("OCC_PALLAS_BCE", "0")
    lc, _ = _port_loss(data)
    assert np.isfinite(lk) and np.isfinite(lc)
    np.testing.assert_allclose(lk, lc, rtol=1e-5)


def test_unsupported_shape_runs_the_chain(monkeypatch):
    """P = 300 (not a multiple of 128): the gate refuses, and the switch
    changes nothing, as in the JAX package."""
    data = _data(4)
    monkeypatch.setenv("OCC_PALLAS_BCE", "1")
    assert not bce_loss.supported(300, I, E)
    on = _port_loss(data, n=300)
    monkeypatch.setenv("OCC_PALLAS_BCE", "0")
    assert on == _port_loss(data, n=300)
    assert np.isfinite(on[0])
