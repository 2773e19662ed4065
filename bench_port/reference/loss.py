"""OccuSeg's six-term training loss in plain PyTorch, over the real
points of a batch (pad rows dropped; they carry label and instance -1).

semantic: mean cross entropy over labelled points. embedding: the
discriminative loss (pull clamp(||e - mu_i|| - 0.2, 0)^2 averaged over a
scene's instance points, push clamp(3 - ||mu_i - mu_j||, 0)^2 over
same-scene pairs / n(n - 1), 0.001 mean ||mu_i||), summed over scenes and
divided by the scenes with instance points. regression: 100 x the mean L1
of the centredness over points of class > 1. displacement and occupancy:
per-instance mean errors (occupancy also its prediction's unbiased std)
over instances of class > 1, averaged per scene, summed, divided by the
scenes with instances. classification (models with the bw head): 10 x the
mean over instances of >= 30 points of the soft-membership BCE over the
points within 4 radii in its scene, membership exp(-(|e - mu| bw0)^2 -
(|x - d - p_i| bw1)^2); and the mean instance IoU of membership > 0.5.
Norms are sqrt(sum + 1e-12); [points, instances] distances expand
|a|^2 + |b|^2 - 2 a.b, clamped at 0.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

DELTA_V, DELTA_D, GAMMA = 0.2, 1.5, 0.001
REGRESS_WEIGHT, CLASS_WEIGHT, MIN_POINTS, FG = 100.0, 10.0, 30, 2


def _norm(x, dim=-1):
    return torch.sqrt((x * x).sum(dim) + 1e-12)


def _seg_sum(x, seg, num):
    out = x.new_zeros((num,) + x.shape[1:])
    return out.index_add(0, seg, x)


def _seg_max(x, seg, num, fill):
    out = torch.full((num,), fill, dtype=x.dtype, device=x.device)
    return out.scatter_reduce(0, seg, x, "amax", include_self=True)


def _sqdist(a, b):
    an = (a * a).sum(1, keepdim=True)
    bn = (b * b).sum(1, keepdim=True)
    return torch.clamp(an + bn.t() - 2.0 * (a @ b.t()), min=0.0)


def total_loss(out: Dict[str, torch.Tensor], b: Dict[str, torch.Tensor],
               S: int, I: int) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(total, parts) of per-point outputs `out` and batch `b` (labels,
    instance_id, point_scene, pose, offsets, displacements, occupancy),
    both over the real points only; S scenes, I instance slots."""
    lab, iid, ps = b["labels"].long(), b["instance_id"].long(), \
        b["point_scene"].long()
    valid = iid >= 0
    seg = torch.where(valid, iid, I)
    e = out["embedding"]
    f32 = e.dtype

    logp = F.log_softmax(out["semantics"], dim=-1)
    has = lab >= 0
    nll = -logp.gather(1, lab.clamp(min=0)[:, None])[:, 0]
    sem = torch.where(has, nll, 0.0).sum() / has.sum().clamp(min=1)

    cnt = _seg_sum(valid.to(f32), seg, I + 1)[:I]
    exists = cnt > 0
    mu = (_seg_sum(torch.where(valid[:, None], e, 0.0), seg, I + 1)[:I]
          / cnt.clamp(min=1)[:, None])
    iscene = _seg_max(torch.where(valid, ps, -1), seg, I + 1, -1)[:I]
    cls = _seg_max(torch.where(valid, lab, -10000), seg, I + 1, -10000)[:I]

    mu_pt = torch.cat([mu, mu.new_zeros((1, mu.shape[1]))])[seg]
    dev = torch.clamp(_norm(e - mu_pt, 1) - DELTA_V, min=0.0) ** 2
    pscene = torch.where(valid, ps, S)
    sc_sum = _seg_sum(torch.where(valid, dev, 0.0), pscene, S + 1)[:S]
    sc_cnt = _seg_sum(valid.to(f32), pscene, S + 1)[:S]
    l_v = (sc_sum / sc_cnt.clamp(min=1)).sum()
    d = _norm(mu[:, None, :] - mu[None, :, :], -1)
    eye = torch.eye(I, dtype=torch.bool, device=e.device)
    pair = ((iscene[:, None] == iscene[None, :]) & exists[:, None]
            & exists[None, :] & ~eye)
    hinge = torch.where(pair, torch.clamp(2 * DELTA_D - d, min=0.0) ** 2,
                        0.0)
    iseg = torch.where(exists & (iscene >= 0), iscene, S)
    n_s = _seg_sum(exists.to(f32), iseg, S + 1)[:S]
    pair_sum = _seg_sum(hinge.sum(1), iseg, S + 1)[:S]
    l_d = torch.where(n_s > 1, pair_sum / (n_s * (n_s - 1)).clamp(min=1),
                      0.0).sum()
    reg = _seg_sum(torch.where(exists, _norm(mu, 1), 0.0), iseg, S + 1)[:S]
    l_r = torch.where(n_s > 0, reg / n_s.clamp(min=1), 0.0).sum()
    emb = (l_v + l_d + GAMMA * l_r) / (sc_cnt > 0).sum().clamp(min=1)

    fg_pt = lab >= FG
    off_l1 = (out["offset"] - b["offsets"]).abs()[:, 0]
    regression = (torch.where(fg_pt, off_l1, 0.0).sum()
                  / fg_pt.sum().clamp(min=1) * REGRESS_WEIGHT)

    disp_err = _norm(out["displacement"] - b["displacements"], 1)
    occ = out.get("occupancy")
    occ_p = occ[:, 0] if occ is not None else torch.zeros_like(disp_err)
    occ_err = _norm((occ_p - b["occupancy"][:, 0])[:, None], 1)
    fg = exists & (cls >= FG)

    def inst_mean(v):
        return (_seg_sum(torch.where(valid, v, 0.0), seg, I + 1)[:I]
                / cnt.clamp(min=1))

    occ_mean = inst_mean(occ_p)
    occ_mean_pt = torch.cat([occ_mean, occ_mean.new_zeros(1)])[seg]
    sq = _seg_sum(torch.where(valid, (occ_p - occ_mean_pt) ** 2, 0.0), seg,
                  I + 1)[:I]
    occ_std = torch.sqrt(torch.clamp(sq / (cnt.clamp(min=1) - 1).clamp(min=1),
                                     min=0) + 1e-12)
    fseg = torch.where(fg, iscene, S)
    n_fg = _seg_sum(fg.to(f32), fseg, S + 1)[:S]

    def per_scene(v):
        s = _seg_sum(torch.where(fg, v, 0.0), fseg, S + 1)[:S]
        return torch.where(n_fg > 0, s / n_fg.clamp(min=1), 0.0).sum()

    n_sc = (n_s > 0).sum().clamp(min=1)
    displacement = per_scene(inst_mean(disp_err)) / n_sc
    occupancy = (per_scene(inst_mean(occ_err)) + per_scene(occ_std)) / n_sc
    zero = sem.new_zeros(())
    if occ is None:
        occupancy = zero

    classification, miou = zero, zero
    if "bw" in out:
        x = b["pose"]
        rx = x - out["displacement"]
        mean_pose = (_seg_sum(torch.where(valid[:, None], x, 0.0), seg,
                              I + 1)[:I] / cnt.clamp(min=1)[:, None])
        sig = (_seg_sum(torch.where(valid[:, None], out["bw"], 0.0), seg,
                        I + 1)[:I] / cnt.clamp(min=1)[:, None])
        use = exists & (cnt >= MIN_POINTS)
        n_inst = use.sum().clamp(min=1)
        d_emb = torch.sqrt(_sqdist(e, mu) + 1e-12)
        d_spat_r = torch.sqrt(_sqdist(rx, mean_pose) + 1e-12)
        d_spat = torch.sqrt(_sqdist(x, mean_pose) + 1e-12)
        member = ((seg[:, None] == torch.arange(I, device=seg.device)[None])
                  & valid[:, None])
        radius = torch.where(member, d_spat, 0.0).amax(0)
        sample = ((d_spat < 4.0 * radius[None]) & (ps[:, None] == iscene[None])
                  & use[None])
        d1 = d_emb * sig[None, :, 0]
        d2 = d_spat_r * sig[None, :, 1]
        s = torch.clamp(d1 * d1 + d2 * d2, 1.0000001e-7, 16.11809565095832)
        bce = torch.where(sample, torch.where(member, s,
                                              -torch.log(-torch.expm1(-s))),
                          0.0)
        per_inst = bce.sum(0) / sample.sum(0).clamp(min=1)
        classification = (torch.where(use, per_inst, 0.0).sum() / n_inst
                          * CLASS_WEIGHT)
        pred = (s < 0.6931471805599453) & sample
        gt = member & sample
        tp = (pred & gt).sum(0).to(f32)
        fp = (pred & ~gt).sum(0).to(f32)
        iou = tp / (gt.sum(0).to(f32) + fp).clamp(min=1.0)
        miou = torch.where(use, iou, 0.0).sum() / n_inst

    total = sem + regression + emb + displacement + classification + occupancy
    parts = {"semantic_loss": sem, "embedding_loss": emb,
             "regression_loss": regression, "displacement_loss": displacement,
             "classification_loss": classification,
             "occupancy_loss": occupancy, "instance_iou": miou,
             "total": total}
    return total, parts
