"""Fused soft-membership BCE of the classification loss (counterpart of
`occuseg_tpu/ops/pallas/bce_loss.py`).

`classification_loss` (`losses/instance.py`) takes this path when
`OCC_PALLAS_BCE=1`, the JAX package's switch, and `supported` passes: the
same static gate as the JAX package, so both packages take the kernels at
the same shapes. Otherwise it runs its [P, I] chain.

Three kernels of `csrc/bce_loss.cu`, each with a plain version here in the
kernel's own formulation (every squared distance |a|^2 + |b|^2 - 2 a.b,
clamped at 0; the sample ball |x - mp|^2 < 16 r^2):
  * `radius_sq`: [I] max squared distance of each instance's own points to
    its GT mean (TPU row #6);
  * `bce_sums`: [5, I] per-instance bce_sum, n_samp, tp, fp, tot over the
    sampled (point, instance) pairs (TPU row #7);
  * `bce_sums_bwd`: the VJP of bce_sum: de, drx, dmu and d(sig^2) (TPU row
    #8).
`bce_membership_sums` wraps them in one autograd function with the JAX
contract: gradients reach e, rx, sig and mu only, and every radius input
is detached. Each wrapper launches its kernel for CUDA tensors (or raises)
and runs its plain version for CPU tensors.

x, rx and the GT means are padded to 4 columns (the TPU kernels pad to 8);
the padding is zero and changes no value.
"""

from __future__ import annotations

import functools
import os
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from occuseg_tpu_torch.ops import kernels

S_LO = 1.0000001e-7            # prob = exp(-s) in [1e-7, 1 - 1e-7]
S_HI = 16.11809565095832
S_PRED = 0.6931471805599453    # prob > 0.5
MAX_INSTANCES = 128

# rows of the [8, I] constants block
MU_SQ, MP_SQ, SIG0, SIG1, R16, SCENE, USE = range(7)


def enabled() -> bool:
    """The JAX package's switch: OCC_PALLAS_BCE=1 (default off)."""
    return os.environ.get("OCC_PALLAS_BCE", "0") == "1"


def supported(P: int, I: int, E: int) -> bool:
    """The JAX package's static gate (`bce_loss.supported`): the switch,
    P % 128 == 0, 8 <= I <= 128 and 8 <= E <= 256, both multiples of 8."""
    return (enabled() and P % 128 == 0 and 8 <= I <= MAX_INSTANCES
            and I % 8 == 0 and 8 <= E <= 256 and E % 8 == 0)


def _pad4(x: torch.Tensor) -> torch.Tensor:
    """[N, 3] -> [N, 4] f32 with a zero column."""
    return F.pad(x.float(), (0, 4 - x.shape[1])).contiguous()


def _sq(a: torch.Tensor, a_sq: torch.Tensor, b: torch.Tensor,
        b_sq: torch.Tensor) -> torch.Tensor:
    return torch.clamp(a_sq[:, None] + b_sq[None, :] - 2.0 * (a @ b.T),
                       min=0.0)


# ---------------------------------------------------------------------------
# Plain versions (CPU tensors; the reference on the card)
# ---------------------------------------------------------------------------

def radius_sq_plain(x4: torch.Tensor, seg: torch.Tensor, mp4: torch.Tensor,
                    mp_sq: torch.Tensor) -> torch.Tensor:
    """[I] max over each instance's own points of |x - mp|^2 (0 for an
    instance with no point)."""
    I = mp4.shape[0]
    sq = _sq(x4, (x4 * x4).sum(1), mp4, mp_sq)
    member = seg[:, None].long() == torch.arange(I, device=seg.device)
    return torch.where(member, sq, torch.zeros((), device=sq.device)).amax(0)


def _pair_terms(e, rx4, x4, seg, scene, mu, mp4, cons):
    """[P, I] tiles: (member, sample, s_raw, sq_emb, sq_r)."""
    I = mu.shape[0]
    sq_emb = _sq(e, (e * e).sum(1), mu, cons[MU_SQ])
    sq_r = _sq(rx4, (rx4 * rx4).sum(1), mp4, cons[MP_SQ])
    sq_x = _sq(x4, (x4 * x4).sum(1), mp4, cons[MP_SQ])
    member = seg[:, None].long() == torch.arange(I, device=seg.device)
    sample = ((sq_x < cons[R16][None]) & (scene.float()[:, None]
                                           == cons[SCENE][None])
              & (cons[USE][None] > 0))
    s_raw = ((sq_emb + 1e-12) * cons[SIG0][None]
             + (sq_r + 1e-12) * cons[SIG1][None])
    return member, sample, s_raw, sq_emb, sq_r


def bce_sums_plain(e, rx4, x4, seg, scene, mu, mp4, cons) -> torch.Tensor:
    """[5, I]: bce_sum, n_samp, tp, fp, tot over the sampled pairs."""
    member, sample, s_raw, _, _ = _pair_terms(e, rx4, x4, seg, scene, mu,
                                              mp4, cons)
    s = torch.clamp(s_raw, S_LO, S_HI)
    not_mem = -torch.log(torch.clamp(1.0 - torch.exp(-s), min=1e-16))
    zero = torch.zeros((), device=s.device)
    bce = torch.where(sample, torch.where(member, s, not_mem), zero)
    pred = (s < S_PRED) & sample
    gt = member & sample
    return torch.stack([bce.sum(0), sample.float().sum(0),
                        (pred & gt).float().sum(0),
                        (pred & ~gt).float().sum(0), gt.float().sum(0)])


def bce_sums_bwd_plain(e, rx4, x4, seg, scene, mu, mp4, cons, gvec):
    """The VJP of bce_sum with cotangent gvec [I]: (de [P, E], drx [P, 4],
    dmu [I, E], d_sig_sq [I, 2])."""
    member, sample, s_raw, sq_emb, sq_r = _pair_terms(e, rx4, x4, seg, scene,
                                                      mu, mp4, cons)
    inside = (s_raw > S_LO) & (s_raw < S_HI)
    p_ = torch.exp(-torch.clamp(s_raw, S_LO, S_HI))
    dbce = torch.where(member, torch.ones((), device=p_.device),
                       -p_ / torch.clamp(1.0 - p_, min=1e-16))
    g = torch.where(sample & inside, gvec[None] * dbce,
                    torch.zeros((), device=p_.device))
    g0 = g * cons[SIG0][None]
    g1 = g * cons[SIG1][None]
    de = 2.0 * (g0.sum(1, keepdim=True) * e - g0 @ mu)
    drx = 2.0 * (g1.sum(1, keepdim=True) * rx4 - g1 @ mp4)
    dmu = 2.0 * (mu * g0.sum(0)[:, None] - g0.T @ e)
    d_sig_sq = torch.stack([(g * (sq_emb + 1e-12)).sum(0),
                            (g * (sq_r + 1e-12)).sum(0)], dim=1)
    return de, drx, dmu, d_sig_sq


# ---------------------------------------------------------------------------
# Kernel wrappers (CUDA tensors launch the kernel or raise)
# ---------------------------------------------------------------------------

def _ranges(P: int, sms: int, tile: int) -> Tuple[int, int]:
    """(blocks, points per block): two blocks per SM, ranges a multiple of
    the kernel's point tile. Fixed by P and the card, so one card always
    sums the partials in one order."""
    n = max(1, min(-(-P // tile), 2 * sms))
    rng = -(-max(1, -(-P // n)) // tile) * tile
    return max(1, -(-P // rng)), rng


@functools.lru_cache(maxsize=None)
def _sms(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


# Shared memory of one H100 block (the opt-in maximum) and of one block
# when two share an SM (228 KiB less 1 KiB reserved per block, halved)
SMEM_BLOCK = 232_448
SMEM_TWO_PER_SM = 115_712
LIST_TILES = (128, 64, 32)   # points per pair-list tile, widest first


def list_smem_bytes(pt: int, I: int, E: int, lcap: int, bwd: bool) -> int:
    """Shared memory of a pair-list kernel (`ListSmem` in
    `csrc/bce_loss.cu`) for tiles of pt points and a pair list of lcap
    entries: mu [I][E+4], the constants, the point rows (e padded to
    E + 4), the candidate list and each instance's slot in it, the
    per-point candidate masks and list slots, and the list (an int and two
    floats an entry). The backward adds its cotangent, the per-instance
    point masks, the (point, instance) -> entry map (int16) and two more
    floats an entry."""
    def up4(n):
        return -(-n // 4) * 4
    words = up4(I * (E + 4) + 4 * I + 8 * pt + 7 * I + (I if bwd else 0))
    words += pt * (E + 4) + 5 * pt
    words += (MAX_INSTANCES + 1) + MAX_INSTANCES + 4 * pt + (pt + 1)
    if bwd:
        words += MAX_INSTANCES * 4 + -(-pt * I // 2)
    return 4 * (up4(words) + (5 if bwd else 3) * lcap)


def bwd_smem_bytes(pt: int, I: int, E: int, lcap: int) -> int:
    """Shared memory of the backward kernel (`list_smem_bytes`)."""
    return list_smem_bytes(pt, I, E, lcap, True)


def fwd_smem_bytes(pt: int, I: int, E: int, lcap: int) -> int:
    """Shared memory of the forward kernel (`list_smem_bytes`)."""
    return list_smem_bytes(pt, I, E, lcap, False)


def _list_geometry(P: int, I: int, E: int, sms: int, smem_bytes, what: str):
    """(blocks, points per block, points per tile, list entries): the
    widest tile whose shared memory lets two blocks share an SM (else the
    widest that fits one block), a pair list of 16 entries per point of
    the tile (a denser tile is walked in several windows of whole points),
    and ranges as `_ranges`, in whole tiles."""
    fits = [pt for pt in LIST_TILES
            if smem_bytes(pt, I, E, 16 * pt) <= SMEM_TWO_PER_SM]
    fits = fits or [pt for pt in LIST_TILES
                    if smem_bytes(pt, I, E, 16 * pt) <= SMEM_BLOCK]
    if not fits:
        raise ValueError(f"bce {what}: no point tile of I={I}, E={E} fits "
                         f"in shared memory")
    pt = fits[0]
    n_blocks, rng = _ranges(P, sms, pt)
    return n_blocks, rng, pt, 16 * pt


def fwd_geometry(P: int, I: int, E: int, sms: int):
    """(blocks, points per block, points per tile, list entries) of the
    forward kernel (`_list_geometry`)."""
    return _list_geometry(P, I, E, sms, fwd_smem_bytes, "forward")


def bwd_geometry(P: int, I: int, E: int, sms: int):
    """(blocks, points per block, points per tile, list entries) of the
    backward kernel (`_list_geometry`)."""
    return _list_geometry(P, I, E, sms, bwd_smem_bytes, "backward")


def _check_inputs(e, rx4, x4, seg, scene, mu, mp4, cons):
    P, E = e.shape
    I = mu.shape[0]
    if (tuple(rx4.shape) != (P, 4) or tuple(x4.shape) != (P, 4)
            or tuple(seg.shape) != (P,) or tuple(scene.shape) != (P,)
            or tuple(mu.shape) != (I, E) or tuple(mp4.shape) != (I, 4)
            or tuple(cons.shape) != (8, I)):
        raise ValueError(
            "bce kernels: inconsistent shapes " + ", ".join(
                f"{n} {tuple(t.shape)}" for n, t in
                (("e", e), ("rx4", rx4), ("x4", x4), ("seg", seg),
                 ("scene", scene), ("mu", mu), ("mp4", mp4),
                 ("cons", cons))))
    if I > MAX_INSTANCES:
        raise ValueError(f"bce kernels: I={I} > {MAX_INSTANCES}")
    for name, t, dt, nd in (("e", e, torch.float32, 2),
                            ("rx4", rx4, torch.float32, 2),
                            ("x4", x4, torch.float32, 2),
                            ("seg", seg, torch.int32, 1),
                            ("scene", scene, torch.int32, 1),
                            ("mu", mu, torch.float32, 2),
                            ("mp4", mp4, torch.float32, 2),
                            ("cons", cons, torch.float32, 2)):
        kernels.require_cuda_input(t, name, dt, nd)
    if len({t.device for t in (e, rx4, x4, seg, scene, mu, mp4, cons)}) != 1:
        raise ValueError("bce kernels: tensors on several devices")
    return P, E, I


RADIUS_THREADS = 256  # threads per block of the radius kernel's grid


def radius_blocks(P: int, sms: int) -> int:
    """Blocks of the radius kernel's grid: one 4-point vector a thread,
    at most four blocks per SM (then more vectors a thread)."""
    return max(1, min(-(-(P // 4) // RADIUS_THREADS), 4 * sms))


@functools.lru_cache(maxsize=None)
def _radius_scratch(device: torch.device):
    """(block counter, per-instance maxima) of the radius kernel's grid on
    `device`, allocated and zeroed once. The kernel's last block moves the
    maxima into its output, zeroing them, and sets the counter back to 0,
    so both are 0 between launches. One pair per device is safe because
    the port launches on one stream per device: two radius launches never
    run at once. Launches on two streams of one device would share it."""
    return (torch.zeros(1, dtype=torch.int32, device=device),
            torch.zeros(MAX_INSTANCES, dtype=torch.int32, device=device))


def radius_sq(x4: torch.Tensor, seg: torch.Tensor, mp4: torch.Tensor,
              mp_sq: torch.Tensor) -> torch.Tensor:
    """[I] f32 per-instance max squared own-point distance (no gradient).
    x4 [P, 4], seg [P] int32 (-1 = no instance), mp4 [I, 4], mp_sq [I].
    One launch writes every word of the output: no memset."""
    if not x4.is_cuda:
        return radius_sq_plain(x4, seg, mp4, mp_sq)
    P, I = x4.shape[0], mp4.shape[0]
    if (tuple(seg.shape) != (P,) or tuple(mp_sq.shape) != (I,)
            or tuple(mp4.shape) != (I, 4) or tuple(x4.shape) != (P, 4)):
        raise ValueError("radius_sq: inconsistent shapes")
    if I > MAX_INSTANCES:
        raise ValueError(f"radius_sq: I={I} > {MAX_INSTANCES}")
    for name, t, dt in (("x4", x4, torch.float32), ("seg", seg, torch.int32),
                        ("mp4", mp4, torch.float32),
                        ("mp_sq", mp_sq, torch.float32)):
        kernels.require_cuda_input(t, name, dt, t.dim())
    dev = x4.device
    out = torch.empty(I, dtype=torch.float32, device=dev)
    counter, scratch = _radius_scratch(dev)
    with torch.cuda.device(dev):
        rc = kernels.load().occ_bce_radius(
            x4.data_ptr(), seg.data_ptr(), P, mp4.data_ptr(),
            mp_sq.data_ptr(), I, out.data_ptr(), scratch.data_ptr(),
            counter.data_ptr(), radius_blocks(P, _sms(dev)),
            kernels.stream_ptr(x4))
    kernels.check(rc, "bce radius kernel launch")
    radius_sq.launches += 1
    return out


radius_sq.launches = 0  # kernel launches


def bce_sums(e, rx4, x4, seg, scene, mu, mp4, cons) -> torch.Tensor:
    """[5, I] f32 per-instance sums (see `bce_sums_plain`). e [P, E],
    rx4 / x4 [P, 4], seg / scene [P] int32, mu [I, E], mp4 [I, 4], cons
    [8, I] (rows MU_SQ..USE)."""
    if not e.is_cuda:
        return bce_sums_plain(e, rx4, x4, seg, scene, mu, mp4, cons)
    P, E, I = _check_inputs(e, rx4, x4, seg, scene, mu, mp4, cons)
    if E % 4:
        raise ValueError(f"bce forward: E={E} is not a multiple of 4")
    n_blocks, rng, pt, lcap = fwd_geometry(P, I, E, _sms(e.device))
    part = torch.empty((n_blocks, 5, I), dtype=torch.float32,
                       device=e.device)
    out = torch.empty((5, I), dtype=torch.float32, device=e.device)
    with torch.cuda.device(e.device):
        rc = kernels.load().occ_bce_fwd(
            e.data_ptr(), P, E, rx4.data_ptr(), x4.data_ptr(),
            seg.data_ptr(), scene.data_ptr(), mu.data_ptr(), mp4.data_ptr(),
            cons.data_ptr(), I, rng, n_blocks, pt, lcap, part.data_ptr(),
            out.data_ptr(), kernels.stream_ptr(e))
    kernels.check(rc, "bce forward kernel launch")
    bce_sums.launches += 1
    return out


bce_sums.launches = 0  # kernel launches


def bce_sums_bwd(e, rx4, x4, seg, scene, mu, mp4, cons, gvec):
    """The VJP of bce_sum with cotangent gvec [I] (see
    `bce_sums_bwd_plain`): (de, drx, dmu, d_sig_sq)."""
    if not e.is_cuda:
        return bce_sums_bwd_plain(e, rx4, x4, seg, scene, mu, mp4, cons,
                                  gvec)
    P, E, I = _check_inputs(e, rx4, x4, seg, scene, mu, mp4, cons)
    kernels.require_cuda_input(gvec, "gvec", torch.float32, 1)
    if tuple(gvec.shape) != (I,) or gvec.device != e.device:
        raise ValueError(f"bce backward: gvec {tuple(gvec.shape)}")
    if E % 4:
        raise ValueError(f"bce backward: E={E} is not a multiple of 4")
    n_blocks, rng, pt, lcap = bwd_geometry(P, I, E, _sms(e.device))
    dev = e.device
    de = torch.empty((P, E), dtype=torch.float32, device=dev)
    drx = torch.empty((P, 4), dtype=torch.float32, device=dev)
    dmu_part = torch.empty((n_blocks, I, E), dtype=torch.float32, device=dev)
    scal_part = torch.empty((n_blocks, 3, I), dtype=torch.float32,
                            device=dev)
    gte = torch.empty((I, E), dtype=torch.float32, device=dev)
    scal = torch.empty((3, I), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        rc = kernels.load().occ_bce_bwd(
            e.data_ptr(), P, E, rx4.data_ptr(), x4.data_ptr(),
            seg.data_ptr(), scene.data_ptr(), mu.data_ptr(), mp4.data_ptr(),
            cons.data_ptr(), I, gvec.data_ptr(), rng, n_blocks, pt, lcap,
            de.data_ptr(), drx.data_ptr(), dmu_part.data_ptr(),
            scal_part.data_ptr(), gte.data_ptr(), scal.data_ptr(),
            kernels.stream_ptr(e))
    kernels.check(rc, "bce backward kernel launch")
    bce_sums_bwd.launches += 1
    dmu = 2.0 * (mu * scal[0][:, None] - gte)
    return de, drx, dmu, scal[1:3].T


bce_sums_bwd.launches = 0  # kernel launches


def exact_inputs(P: int, I: int, E: int, seed: int, device="cpu",
                 seg=None):
    """Kernel inputs (e, rx4, x4, seg, scene, mu, mp4, cons without the
    radius row, gvec) on whose pairs every squared distance and s_raw is
    exact in f32 whatever the summation order: coordinates are multiples
    of 1/8 and embeddings of 1/16 with few bits, sig^2 are powers of two.
    So a kernel and its plain version agree on every sample, member and
    prediction decision, and the counts must match exactly; only the
    transcendental terms and the f32 sums differ in rounding. Call
    `with_radius` to fill the R16 row. seg: the points' instance ids [P]
    (NumPy; -1 none), by default drawn at random for every point (20%
    none); `cli_seg` gives the training CLI's layout."""
    rng = np.random.default_rng(seed)
    if seg is None:
        seg = rng.integers(0, I, P)
        seg[rng.random(P) < 0.2] = -1
    else:
        seg = np.asarray(seg, np.int64)
    scene = (np.arange(P) * 2 // max(P, 1)).astype(np.int32)
    centers = rng.integers(-16, 17, (I, 3)) / 2.0
    x = centers[np.clip(seg, 0, I - 1)] + rng.integers(-8, 9, (P, 3)) / 8.0
    rx = x + rng.integers(-4, 5, (P, 3)) / 8.0
    e = rng.integers(-8, 9, (P, E)) / 16.0
    mu = rng.integers(-8, 9, (I, E)) / 16.0
    sig_sq = 2.0 ** -rng.integers(2, 5, (I, 2)).astype(np.float64)
    scene_i = rng.integers(0, 2, I).astype(np.float64)
    scene_i[rng.random(I) < 0.1] = -1
    use = (rng.random(I) < 0.85).astype(np.float64)
    cons = np.zeros((8, I))
    cons[MU_SQ] = (mu * mu).sum(1)
    cons[MP_SQ] = (centers * centers).sum(1)
    cons[SIG0], cons[SIG1] = sig_sq[:, 0], sig_sq[:, 1]
    cons[SCENE], cons[USE] = scene_i, use

    def t(a, dt=torch.float32):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dt,
                               device=device)

    pad = np.zeros((P, 1))
    return (t(e), t(np.hstack([rx, pad])), t(np.hstack([x, pad])),
            t(seg, torch.int32), t(scene, torch.int32), t(mu),
            t(np.hstack([centers, np.zeros((I, 1))])), t(cons),
            t(rng.standard_normal(I)))


def cli_seg(P: int, I: int, seed: int) -> np.ndarray:
    """Instance ids [P] int32 in the training CLI's layout: one blocked
    batch of 4 synthetic scenes of 20k points (`train.loop`'s stand-in
    dataset), padded to P. Each object's points are one run of its id,
    the floor's and walls' points runs of -1, and the pad past the scenes
    -1."""
    from occuseg_tpu_torch.data.synthetic import SceneConfig, make_batch
    return make_batch(SceneConfig(num_points=20_000, extent=256), 4, P, I,
                      seed=seed)["instance_id"]


def run_lengths(seg: np.ndarray):
    """(lengths of the runs of one instance id >= 0, number of -1
    points) of a seg layout."""
    seg = np.asarray(seg)
    cut = np.flatnonzero(np.diff(seg)) + 1
    starts = np.concatenate([[0], cut])
    lens = np.diff(np.concatenate([starts, [seg.size]]))
    return lens[seg[starts] >= 0], int((seg < 0).sum())


def with_radius(x4, seg, mp4, cons):
    """cons with its R16 row set to 16 x `radius_sq` of the inputs."""
    cons = cons.clone()
    cons[R16] = 16.0 * radius_sq(x4, seg, mp4, cons[MP_SQ].clone())
    return cons


# ---------------------------------------------------------------------------
# The autograd entry point
# ---------------------------------------------------------------------------

class _BceSums(torch.autograd.Function):
    """[5, I] sums; differentiable in e, rx4, sig_sq and mu (only
    bce_sum's cotangent flows: the counts are step functions)."""

    @staticmethod
    def forward(ctx, e, rx4, sig_sq, mu, mp4, x4, seg, scene, cons):
        cons = cons.clone()
        cons[SIG0] = sig_sq[:, 0]
        cons[SIG1] = sig_sq[:, 1]
        ctx.save_for_backward(e, rx4, mu, mp4, x4, seg, scene, cons)
        return bce_sums(e, rx4, x4, seg, scene, mu, mp4, cons)

    @staticmethod
    def backward(ctx, g):
        e, rx4, mu, mp4, x4, seg, scene, cons = ctx.saved_tensors
        de, drx, dmu, d_sig_sq = bce_sums_bwd(e, rx4, x4, seg, scene, mu,
                                              mp4, cons,
                                              g[0].float().contiguous())
        return de, drx, d_sig_sq, dmu, None, None, None, None, None


def bce_membership_sums(e, rx, sig, mu, mean_pose, x, instance_id,
                        point_scene, scene_i, use, group=None):
    """Drop-in for the [P, I] BCE chain of `classification_loss`: (bce_sum,
    n_samp, tp, fp, tot), each [I] f32. e [P, E], rx / x [P, 3], sig
    [I, 2], mu [I, E], mean_pose [I, 3], instance_id / point_scene [P],
    scene_i [I], use [I] bool. Gradients flow to e, rx, sig and mu only.

    With `group` (spatial sharding: this rank's point rows), the radius
    is the maximum over the group's ranks before the sums read it, and
    the five sums are summed over the ranks after (`occuseg_tpu/losses/
    instance.py:274-277`). The JAX package's TPU kernel path takes its
    radius over the local shard alone (`occuseg_tpu/ops/pallas/
    bce_loss.py:336-338`), which samples another ball on every shard;
    this follows the JAX chain (`instance.py:306-308`) instead."""
    I = mu.shape[0]
    dev = e.device
    e = e.float().contiguous()
    mu = mu.float().contiguous()
    rx4 = _pad4(rx)
    seg = instance_id.to(torch.int32).contiguous()
    scene = point_scene.to(torch.int32).contiguous()
    with torch.no_grad():  # every radius input and constant is detached
        x4 = _pad4(x.detach())
        mp4 = _pad4(mean_pose.detach())
        mp_sq = (mp4 * mp4).sum(1)
        r_sq = radius_sq(x4, seg, mp4, mp_sq)
        if group is not None:
            from occuseg_tpu_torch.parallel.comm import all_max
            r_sq = all_max(r_sq, group)
        zero = torch.zeros(I, dtype=torch.float32, device=dev)
        cons = torch.stack([(mu * mu).sum(1), mp_sq, zero, zero, 16.0 * r_sq,
                            scene_i.float(), use.float(), zero]).contiguous()
    sig_sq = sig.float() ** 2
    out = _BceSums.apply(e, rx4, sig_sq, mu, mp4, x4, seg, scene, cons)
    if group is not None:
        from occuseg_tpu_torch.parallel.comm import all_sum
        out = all_sum(out, group)
    return out[0], out[1], out[2], out[3], out[4]
