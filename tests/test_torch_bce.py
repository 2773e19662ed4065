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
* The forward's and the backward's shared pair list (tiles, candidates,
  list order, windows) and their fixed-order sums, replayed in NumPy,
  against the plain versions and the JAX package's kernels (interpret
  mode), at 1, 2 and 4 scenes.
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

from tests import jax_planner  # noqa: F401  (heals the JAX planner)

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


# ---------------------------------------------------------------------------
# The backward kernel's pair list (TPU row #8), replayed in NumPy
# ---------------------------------------------------------------------------

SMS = 132  # H100 SXM


def _listed_inputs(P, I, E, scenes, seed, geometry=bce_loss.bwd_geometry,
                   dense=False):
    """Kernel inputs on which every squared distance and s_raw is exact in
    f32 (coordinates in 1/8, embeddings in 1/16, sig^2 powers of two or
    the clip bounds over a power of two), with `scenes` contiguous scenes.
    The points of the third tile of `geometry` (the backward's unless
    given) are far from every instance (no pair of that tile is sampled),
    and two members sit exactly on the clip bounds: s_raw == S_HI
    (instance 0) and s_raw == S_LO (instance 1). With `dense`, one member
    of every other instance lies 6 further out, so its sample ball covers
    every centre and a tile's points sample most instances of their
    scene. Returns NumPy arrays (e,
    rx4, x4, seg, scene, mu, mp4, cons, g) with cons' R16 row still
    zero."""
    rng = np.random.default_rng(seed)
    pt = geometry(P, I, E, SMS)[2]
    scene = (np.arange(P) * scenes // P).astype(np.int32)
    # instance i lives in scene i % scenes
    per = np.array([len(range(s, I, scenes)) for s in range(scenes)])
    seg = scene + scenes * (rng.integers(0, 1 << 30, P) % np.maximum(
        per[scene], 1))
    seg[(rng.random(P) < 0.2) | (per[scene] == 0)] = -1
    far = np.arange(2 * pt, min(P, 3 * pt))
    seg[far] = -1
    for inst in range(min(I, 2)):  # three members each, outside that tile
        pool = np.setdiff1d(np.flatnonzero(scene == inst % scenes), far)
        seg[rng.choice(pool, 3, replace=False)] = inst
    centers = rng.integers(-16, 17, (I, 3)) / 2.0
    # instance 1 (its sig0^2 is S_LO) apart: a sampled non-member would
    # put 1 - exp(-s) at s ~ 1e-6, where the plain versions' exp differ
    centers[1:2] = 100.0
    x = centers[np.clip(seg, 0, I - 1)] + rng.integers(-8, 9, (P, 3)) / 8.0
    x[far] = 1000.0 + rng.integers(-8, 9, (far.size, 3)) / 8.0
    if dense:
        for inst in range(2, I):
            mine = np.flatnonzero(seg == inst)
            if mine.size:
                x[mine[-1], 0] += 6.0
    rx = x + rng.integers(-4, 5, (P, 3)) / 8.0
    e = rng.integers(-8, 9, (P, E)) / 16.0
    mu = rng.integers(-8, 9, (I, E)) / 16.0
    sig_sq = 2.0 ** -rng.integers(2, 5, (I, 2)).astype(np.float64)
    scene_i = np.full(I, -1.0)
    np.maximum.at(scene_i, seg[seg >= 0], scene[seg >= 0])
    cnt = np.bincount(seg[seg >= 0], minlength=I)
    use = (cnt >= 2).astype(np.float64)
    # members on the clip bounds: |e - mu|^2 = 4 (resp. 1) exactly
    for inst, bound, sq in ((0, bce_loss.S_HI, 4.0), (1, bce_loss.S_LO, 1.0)):
        if inst >= I:
            continue
        mine = np.flatnonzero(seg == inst)
        x[mine[1], 0] = centers[inst, 0] + 0.5  # a radius > 0
        use[inst] = 1.0
        p = mine[0]
        e[p] = mu[inst]
        e[p, 0] += np.sqrt(sq)
        sig_sq[inst] = (np.float32(bound) / np.float32(sq), 0.0)
    cons = np.zeros((8, I))
    cons[bce_loss.MU_SQ] = (mu * mu).sum(1)
    cons[bce_loss.MP_SQ] = (centers * centers).sum(1)
    cons[bce_loss.SIG0], cons[bce_loss.SIG1] = sig_sq[:, 0], sig_sq[:, 1]
    cons[bce_loss.SCENE], cons[bce_loss.USE] = scene_i, use
    pad = np.zeros((P, 1))
    f = np.float32
    return (e.astype(f), np.hstack([rx, pad]).astype(f),
            np.hstack([x, pad]).astype(f), seg.astype(np.int32), scene,
            mu.astype(f), np.hstack([centers, np.zeros((I, 1))]).astype(f),
            cons.astype(f), rng.standard_normal(I).astype(f))


def _pair_terms_f32(e, rx4, x4, seg, scene, mu, mp4, cons):
    """[P, I] f32 pair terms in the kernels' formulation: (sampled, s_raw,
    sq_emb, sq_r, member)."""
    def sq(a, b, b_sq):
        a_sq = (a * a).sum(1, dtype=np.float32)
        return np.maximum(a_sq[:, None] + b_sq[None] - np.float32(2) * (a @ b.T),
                          np.float32(0))
    sq_x = sq(x4, mp4, cons[bce_loss.MP_SQ])
    sq_emb = sq(e, mu, cons[bce_loss.MU_SQ])
    sq_r = sq(rx4, mp4, cons[bce_loss.MP_SQ])
    sampled = ((sq_x < cons[bce_loss.R16][None])
               & (scene.astype(np.float32)[:, None] == cons[bce_loss.SCENE][None])
               & (cons[bce_loss.USE][None] > 0))
    eps = np.float32(1e-12)
    s_raw = ((sq_emb + eps) * cons[bce_loss.SIG0][None]
             + (sq_r + eps) * cons[bce_loss.SIG1][None])
    member = seg[:, None] == np.arange(mu.shape[0])[None]
    return sampled, s_raw, sq_emb, sq_r, member


def _replay_bwd(e, rx4, x4, seg, scene, mu, mp4, cons, g):
    """The backward kernel's walk in NumPy: its block ranges and point
    tiles, the candidate instances of each tile, the sampled pairs listed
    point-major with instances ascending in windows of at most `lcap`
    entries, g per entry, then de / drx summed over each point's entries
    in list order and dmu / d(sig^2) over each instance's points in order
    (per window, then added to the block's sums), block partials summed in
    block order (f64 sums of the f32 terms).
    Returns (de, drx, dmu, d_sig_sq) and what the walk met."""
    P, E = e.shape
    I = mu.shape[0]
    n_blocks, rng, pt, lcap = bce_loss.bwd_geometry(P, I, E, SMS)
    sampled, s_raw, sq_emb, sq_r, member = _pair_terms_f32(
        e, rx4, x4, seg, scene, mu, mp4, cons)
    sig0, sig1 = cons[bce_loss.SIG0], cons[bce_loss.SIG1]
    use, scene_i = cons[bce_loss.USE], cons[bce_loss.SCENE]
    de = np.zeros((P, E))
    drx = np.zeros((P, 4))
    gte = np.zeros((I, E))
    scal = np.zeros((3, I))
    met = dict(tiles=0, empty_tiles=0, one_scene=0, bounds=0)
    for b in range(n_blocks):
        acc = np.zeros((I, E))
        sc = np.zeros((3, I))
        for p0 in range(b * rng, min(P, (b + 1) * rng), pt):
            n = min(pt, min(P, (b + 1) * rng) - p0)
            rows = np.arange(p0, p0 + n)
            one = bool((scene[rows] == scene[p0]).all())
            cand = [i for i in range(I) if use[i] > 0
                    and (not one or scene_i[i] == np.float32(scene[p0]))]
            counts = sampled[np.ix_(rows, cand)].sum(1) if cand else \
                np.zeros(n, int)
            start = np.concatenate([[0], np.cumsum(counts)])
            met["tiles"] += 1
            met["one_scene"] += one
            n_grad = 0
            r0 = 0
            while r0 < n:
                r1 = r0 + 1
                while r1 < n and start[r1 + 1] - start[r0] <= lcap:
                    r1 += 1
                ent = [(r, i) for r in range(r0, r1) for i in cand
                       if sampled[p0 + r, i]]
                assert len(ent) <= lcap
                gs = []
                for r, i in ent:
                    s = s_raw[p0 + r, i]
                    gv = np.float32(0)
                    if bce_loss.S_LO < s < bce_loss.S_HI:
                        pr = np.exp(-s, dtype=np.float32)
                        d = np.float32(1) if member[p0 + r, i] else \
                            -pr / max(np.float32(1) - pr, np.float32(1e-16))
                        gv = g[i] * d
                    met["bounds"] += s in (np.float32(bce_loss.S_LO),
                                           np.float32(bce_loss.S_HI))
                    gs.append(np.float64(gv))
                n_grad += sum(x != 0 for x in gs)
                for r in range(r0, r1):  # one warp per point
                    G0 = G1 = 0.0
                    v = np.zeros(E)
                    w = np.zeros(4)
                    for (rr, i), gv in zip(ent, gs):
                        if rr != r or gv == 0:
                            continue
                        G0 += gv * sig0[i]
                        v += gv * sig0[i] * mu[i]
                        G1 += gv * sig1[i]
                        w += gv * sig1[i] * mp4[i]
                    de[p0 + r] = 2 * (G0 * e[p0 + r] - v)
                    drx[p0 + r] = 2 * (G1 * rx4[p0 + r] - w)
                for i in range(I):  # one warp per instance, per window
                    a = np.zeros(E)
                    t = np.zeros(3)
                    for (r, ii), gv in zip(ent, gs):
                        if ii != i or gv == 0:
                            continue
                        a += gv * sig0[i] * e[p0 + r]
                        t += (gv * sig0[i], gv * (sq_emb[p0 + r, i] + 1e-12),
                              gv * (sq_r[p0 + r, i] + 1e-12))
                    acc[i] += a
                    sc[:, i] += t
                r0 = r1
            met["empty_tiles"] += n_grad == 0
        gte += acc
        scal += sc
    dmu = 2 * (mu * scal[0][:, None] - gte)
    return (de, drx, dmu, scal[1:3].T), met


def _jax_bwd(e, rx4, x4, seg, scene, mu, mp4, cons, g):
    """The JAX package's VJP of `_bce_sums` (interpret mode), with P padded
    to its 128-row blocks by points that no instance samples."""
    P = e.shape[0]
    n = -(-P // 128) * 128 - P

    def pad(a, v):
        return np.concatenate([a, np.full((n,) + a.shape[1:], v, a.dtype)])
    args = (jnp.asarray(pad(e, 0)), jnp.asarray(_pad(pad(rx4, 0), 8)),
            jnp.asarray(_pad(mu, mu.shape[1])))
    sig_sq = np.stack([cons[bce_loss.SIG0], cons[bce_loss.SIG1]], 1)
    fixed = (jnp.asarray(_pad(mp4, 8)), jnp.asarray(_pad(pad(x4, 1e3), 8)),
             jnp.asarray(pad(seg, -1)[:, None]),
             jnp.asarray(pad(scene.astype(np.float32), -5.0)[:, None]),
             jnp.asarray(cons))

    def f(e_, rx8, sig_sq_, mu_):
        return jax_bce._bce_sums(e_, rx8, sig_sq_, mu_, *fixed, True)
    _, vjp = jax.vjp(f, args[0], args[1], jnp.asarray(sig_sq), args[2])
    gg = np.zeros((8, mu.shape[0]), np.float32)
    gg[0] = g
    de, drx, dsig, dmu = (np.asarray(a) for a in vjp(jnp.asarray(gg)))
    return de[:P], drx[:P, :4], dmu, dsig


@pytest.mark.parametrize("scenes", [1, 2, 4])
@pytest.mark.parametrize("shape", [(512, 16, 16), (300, 16, 16),
                                   (512, 4, 16), (512, 128, 64)])
def test_backward_pair_list_replay(shape, scenes):
    """The new backward's compaction replayed in NumPy equals the plain
    version and the JAX package's `_bce_sums_bwd` (interpret mode) within
    1e-5 of each output's max: only the sampled pairs with a gradient are
    walked, a tile with none and the pairs on the clip bounds included."""
    P, I, E = shape
    arrs = _listed_inputs(P, I, E, scenes, seed=P + I + scenes)
    e, rx4, x4, seg, scene, mu, mp4, cons, g = arrs
    t = [torch.from_numpy(np.ascontiguousarray(a)) for a in arrs]
    cons = cons.copy()
    cons[bce_loss.R16] = 16.0 * bce_loss.radius_sq_plain(
        t[2], t[3], t[6], t[7][bce_loss.MP_SQ]).numpy()
    t[7] = torch.from_numpy(cons)
    got, met = _replay_bwd(e, rx4, x4, seg, scene, mu, mp4, cons, g)
    assert met["empty_tiles"] >= 1
    assert met["bounds"] >= (2 if I > 1 else 1)
    assert met["one_scene"] >= 1
    plain = [a.numpy() for a in bce_loss.bce_sums_bwd_plain(*t)]
    ref_j = _jax_bwd(e, rx4, x4, seg, scene, mu, mp4, cons, g)
    for name, a, b, c in zip(("de", "drx", "dmu", "dsig"), got, plain,
                             ref_j):
        assert np.abs(b).max() > 0, name
        for want in (b, c):
            np.testing.assert_allclose(a, want, rtol=0,
                                       atol=1e-5 * np.abs(want).max(),
                                       err_msg=name)


# ---------------------------------------------------------------------------
# The forward kernel (TPU row #7) on the same pair list, replayed in NumPy
# ---------------------------------------------------------------------------

def _tree32(v):
    """Lane 0 of the kernel's xor-shuffle sum over a warp's 32 lanes (f32)."""
    v = v.astype(np.float32)
    lanes = np.arange(32)
    for o in (16, 8, 4, 2, 1):
        v = v + v[lanes ^ o]
    return v[0]


def _replay_fwd(e, rx4, x4, seg, scene, mu, mp4, cons):
    """The forward kernel's walk in NumPy, in f32: its block ranges and
    point tiles, the candidate instances and their slots, each point's
    candidate mask, the list in windows of at most `lcap` entries
    (point-major, instances ascending), each entry's bce term and
    prediction; then per window one warp per instance, lane l over the
    points l, l + 32, ... of the window, each lane finding its entry from
    the point's first slot and the mask bits below the instance's, adding
    the bce term to its running sum; at the end the lanes' sums by the
    kernel's xor tree, and the block partials summed in block order.
    Returns the [5, I] sums and what the walk met."""
    P, E = e.shape
    I = mu.shape[0]
    n_blocks, rng, pt, lcap = bce_loss.fwd_geometry(P, I, E, SMS)
    sampled, s_raw, _, _, member = _pair_terms_f32(e, rx4, x4, seg, scene,
                                                   mu, mp4, cons)
    f = np.float32
    s = np.clip(s_raw, f(bce_loss.S_LO), f(bce_loss.S_HI)).astype(f)
    not_mem = -np.log(np.maximum(f(1) - np.exp(-s), f(1e-16)))
    bce = np.where(member, s, not_mem).astype(f)
    pred = s < f(bce_loss.S_PRED)
    use, scene_i = cons[bce_loss.USE], cons[bce_loss.SCENE]
    out = np.zeros((5, I), f)
    met = dict(tiles=0, empty_tiles=0, windows=0, bounds=0)
    for b in range(n_blocks):
        lanes = np.zeros((I, 32), f)      # per-lane bce sums
        counts = np.zeros((4, I), np.int64)
        for p0 in range(b * rng, min(P, (b + 1) * rng), pt):
            n = min(pt, min(P, (b + 1) * rng) - p0)
            rows = np.arange(p0, p0 + n)
            one = bool((scene[rows] == scene[p0]).all())
            cand = [i for i in range(I) if use[i] > 0
                    and (not one or scene_i[i] == f(scene[p0]))]
            cpos = {i: j for j, i in enumerate(cand)}
            smp = sampled[np.ix_(rows, cand)] if cand else \
                np.zeros((n, 0), bool)
            start = np.concatenate([[0], np.cumsum(smp.sum(1))])
            met["tiles"] += 1
            met["empty_tiles"] += start[n] == 0
            r0 = 0
            while r0 < n:
                r1 = n
                if start[n] - start[r0] > lcap:
                    r1 = r0 + 1
                    while r1 < n and start[r1 + 1] - start[r0] <= lcap:
                        r1 += 1
                met["windows"] += 1
                base = start[r0]
                ent = [(r, i) for r in range(r0, r1) for i in cand
                       if sampled[p0 + r, i]]
                assert len(ent) == start[r1] - base <= lcap
                terms = [(bce[p0 + r, i], pred[p0 + r, i]) for r, i in ent]
                met["bounds"] += sum(
                    s_raw[p0 + r, i] in (f(bce_loss.S_LO), f(bce_loss.S_HI))
                    for r, i in ent)
                for i in cand:  # one warp per instance
                    j = cpos[i]
                    for wd in range(r0 // 32, -(-r1 // 32)):
                        bits = [0, 0, 0]   # sampled, predicted, member
                        for lane in range(32):
                            r = wd * 32 + lane
                            if not (r0 <= r < r1 and smp[r, j]):
                                continue
                            q = start[r] - base + int(smp[r, :j].sum())
                            assert ent[q] == (r, i)
                            lanes[i, lane] += terms[q][0]
                            bits[0] += 1
                            bits[1] += terms[q][1] and seg[p0 + r] == i
                            bits[2] += terms[q][1] and seg[p0 + r] != i
                            counts[3, i] += seg[p0 + r] == i
                        counts[:3, i] += bits
                r0 = r1
        part = np.stack([np.array([_tree32(lanes[i]) for i in range(I)], f),
                         *counts.astype(f)])
        out += part
    return out, met


def _jax_fwd(e, rx4, x4, seg, scene, mu, mp4, cons):
    """The JAX package's `_bce_sums` (interpret mode) [5, I], with P padded
    to its 128-row blocks by points that no instance samples."""
    P = e.shape[0]
    n = -(-P // 128) * 128 - P

    def pad(a, v):
        return np.concatenate([a, np.full((n,) + a.shape[1:], v, a.dtype)])
    sig_sq = np.stack([cons[bce_loss.SIG0], cons[bce_loss.SIG1]], 1)
    out = jax_bce._bce_sums(
        jnp.asarray(pad(e, 0)), jnp.asarray(_pad(pad(rx4, 0), 8)),
        jnp.asarray(sig_sq), jnp.asarray(mu), jnp.asarray(_pad(mp4, 8)),
        jnp.asarray(_pad(pad(x4, 1e3), 8)), jnp.asarray(pad(seg, -1)[:, None]),
        jnp.asarray(pad(scene.astype(np.float32), -5.0)[:, None]),
        jnp.asarray(cons), True)
    return np.asarray(out)[:5]


@pytest.mark.parametrize("scenes", [1, 2, 4])
@pytest.mark.parametrize("shape", [(512, 16, 16), (300, 16, 16),
                                   (512, 4, 16), (512, 128, 64)])
def test_forward_pair_list_replay(shape, scenes):
    """The new forward's list, windows and fixed-order per-instance sums
    replayed in NumPy equal the plain version and the JAX package's
    `_bce_sums` (interpret mode): the counts exactly, bce_sum within 1e-5
    of its max; a tile with no sampled pair, pairs on the clip bounds and,
    at I=128, tiles whose list needs several windows included."""
    P, I, E = shape
    arrs = _listed_inputs(P, I, E, scenes, seed=P + I + scenes + 1,
                          geometry=bce_loss.fwd_geometry, dense=I > 16)
    e, rx4, x4, seg, scene, mu, mp4, cons, _ = arrs
    t = [torch.from_numpy(np.ascontiguousarray(a)) for a in arrs[:8]]
    cons = cons.copy()
    cons[bce_loss.R16] = 16.0 * bce_loss.radius_sq_plain(
        t[2], t[3], t[6], t[7][bce_loss.MP_SQ]).numpy()
    t[7] = torch.from_numpy(cons)
    got, met = _replay_fwd(e, rx4, x4, seg, scene, mu, mp4, cons)
    assert met["empty_tiles"] >= 1
    assert met["bounds"] >= (2 if I > 1 else 1)
    if I > 16:  # 16 entries a point fit any tile of I <= 16
        assert met["windows"] > met["tiles"]
    plain = bce_loss.bce_sums_plain(*t).numpy()
    ref_j = _jax_fwd(e, rx4, x4, seg, scene, mu, mp4, cons)
    assert plain[1].sum() > 0 and plain[4].sum() > 0
    for want in (plain, ref_j):
        np.testing.assert_array_equal(got[1:], want[1:])
        np.testing.assert_allclose(got[0], want[0], rtol=0,
                                   atol=1e-5 * np.abs(want[0]).max())
