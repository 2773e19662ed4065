"""OccuSeg multi-task losses as segment reductions (counterpart of
`occuseg_tpu/losses/instance.py`).

The six terms: semantic cross entropy; the discriminative embedding loss
(pull clamp(||e - mu|| - dv, 0)^2, push clamp(2 dd - ||mu_a - mu_b||, 0)^2
over same-scene centroid pairs / n(n-1), regulariser gamma * mean ||mu||);
the offset L1 over foreground points (label > 1) * 100; the per-instance
displacement error and the per-instance occupancy error plus std (both
over GT class > 1, averaged over instances and then scenes); and the
soft-membership classification BCE * 10 with its instance IoU.

Instances are globally numbered segments [0, I) across the padded batch;
-1 (background, padding) is sanitised to I, and every per-instance
quantity is one segment reduction. The classification term is the JAX
package's default [P, I] chain or, with `OCC_PALLAS_BCE=1` at the shapes
the JAX package's gate takes, the fused kernels of
`ops/kernels/bce_loss.py`. `drift_loss` joins the total when
`drift_weight` is set (off by default). Not ported: the `axis_name`
reductions of spatial sharding.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from occuseg_tpu_torch.ops import acc, acc_dtype
from occuseg_tpu_torch.ops.kernels import bce_loss


@dataclasses.dataclass(frozen=True)
class LossConfig:
    delta_v: float = 0.2
    delta_d: float = 1.5
    gamma: float = 0.001
    regress_weight: float = 100.0
    classification_weight: float = 10.0
    min_instance_points: int = 30
    num_classes: int = 20
    foreground_class_threshold: int = 2  # label > 1, skip wall/floor
    # cross_entropy | lovasz | focal | weighted_cross_entropy
    semantic_loss: str = "cross_entropy"
    # per-class weights for weighted_cross_entropy; None = ScanNet table
    ce_weights: Tuple[float, ...] | None = None
    # DriftLoss coefficient (off by default)
    drift_weight: float = 0.0


def _safe_norm(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """||x||_2 with a bounded gradient at 0 (a singleton instance has
    e == mu exactly)."""
    return torch.sqrt((x * x).sum(dim) + 1e-12)


def _seg_sum(x: torch.Tensor, seg: torch.Tensor, num: int) -> torch.Tensor:
    """[num, ...] f32 sums of x's rows by segment id; ids outside [0, num)
    are dropped. Returned in x's dtype. For the small segment counts of
    the loss (instances, scenes: num <= 128) it is a one-hot [num, P] @
    [P, C] product, as in the JAX package: deterministic, and its backward
    is a product too, where an atomic index_add serialises on the P >> num
    duplicate ids."""
    if num <= 128:
        oh = (seg[None, :] == torch.arange(num, dtype=seg.dtype,
                                           device=seg.device)[:, None])
        xf = acc(x)
        out = oh.to(xf.dtype) @ (xf[:, None] if x.dim() == 1 else xf)
        out = out[:, 0] if x.dim() == 1 else out
    else:
        keep = (seg >= 0) & (seg < num)
        out = torch.zeros((num,) + x.shape[1:], dtype=acc_dtype(x),
                          device=x.device)
        out = out.index_add(0, seg[keep].long(), acc(x[keep]))
    return out.to(x.dtype)


def _seg_max(x: torch.Tensor, seg: torch.Tensor, num: int,
             fill) -> torch.Tensor:
    """[num] max of x by segment id, at least `fill` (the value of an
    empty segment); ids outside [0, num) are dropped (sent to a spare
    row: boolean indexing would make the host wait for the card)."""
    keep = (seg >= 0) & (seg < num)
    out = torch.full((num + 1,), fill, dtype=x.dtype, device=x.device)
    ids = torch.where(keep, seg, num).long()
    return out.scatter_reduce(0, ids, x, "amax", include_self=True)[:num]


def _seg_mean(x: torch.Tensor, seg: torch.Tensor, num: int):
    s = _seg_sum(x, seg, num)
    cnt = _seg_sum(torch.ones(x.shape[:1], dtype=x.dtype, device=x.device),
                   seg, num)
    den = torch.clamp(cnt[:, None] if x.dim() > 1 else cnt, min=1)
    return s / den, cnt


def _sanitize_seg(instance_id: torch.Tensor, num: int) -> torch.Tensor:
    """-1 (invalid) -> num, so reductions over num segments drop them."""
    return torch.where(instance_id >= 0, instance_id,
                       torch.full_like(instance_id, num))


def _seg_lookup(table: torch.Tensor, seg: torch.Tensor,
                num: int) -> torch.Tensor:
    """Per-point `table[seg]` in f32 as a one-hot [P, num] @ [num, C]
    product (as in the JAX package): its backward is a product, where a row
    gather's backward scatters into num rows from P >> num points and
    serialises on the duplicates (measured ~32 ms per [262144, 64] lookup
    on the H100). Rows with seg outside [0, num) read 0 (callers mask
    those points anyway)."""
    t = acc(table)
    oh = (seg[:, None] == torch.arange(num, dtype=seg.dtype,
                                       device=seg.device)[None, :]).to(t.dtype)
    out = oh @ (t[:, None] if t.dim() == 1 else t)
    return out[:, 0] if t.dim() == 1 else out


def _where0(cond: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return torch.where(cond, x, torch.zeros((), dtype=x.dtype,
                                            device=x.device))


def semantic_cross_entropy(logits: torch.Tensor,
                           labels: torch.Tensor) -> torch.Tensor:
    """Mean CE over points with label >= 0."""
    valid = labels >= 0
    logp = F.log_softmax(acc(logits), dim=-1)
    nll = -logp.gather(1, torch.where(valid, labels, 0).long()[:, None])[:, 0]
    return _where0(valid, nll).sum() / torch.clamp(valid.float().sum(),
                                                   min=1)


def _instance_stats(instance_id: torch.Tensor, point_scene: torch.Tensor,
                    labels: torch.Tensor, num_instances: int):
    """Per-instance scene id, point count, (largest) GT class, exists."""
    I = num_instances
    seg = _sanitize_seg(instance_id, I)
    valid = instance_id >= 0
    count = _seg_sum(valid.float(), seg, I + 1)[:I]
    scene = _seg_max(torch.where(valid, point_scene, -1), seg, I + 1, -1)[:I]
    cls = _seg_max(torch.where(valid, labels, -10000), seg, I + 1,
                   -10000)[:I]
    return scene, count, cls, count > 0


def discriminative_loss(embedding: torch.Tensor, instance_id: torch.Tensor,
                        point_scene: torch.Tensor, num_scenes: int,
                        num_instances: int,
                        cfg: LossConfig = LossConfig()) -> torch.Tensor:
    e = acc(embedding)
    I, S = num_instances, num_scenes
    seg = _sanitize_seg(instance_id, I)
    valid_pt = instance_id >= 0
    mu, cnt = _seg_mean(_where0(valid_pt[:, None], e), seg, I + 1)
    mu, cnt = mu[:I], cnt[:I]
    exists = cnt > 0

    # pull: per-scene mean over points, then summed over scenes
    dev = _safe_norm(e - _seg_lookup(mu, seg, I), dim=1)
    dev = torch.clamp(dev - cfg.delta_v, min=0.0) ** 2
    pscene = torch.where(valid_pt, point_scene, S)
    per_scene_sum = _seg_sum(_where0(valid_pt, dev), pscene, S + 1)
    per_scene_cnt = _seg_sum(valid_pt.float(), pscene, S + 1)
    scene_has = per_scene_cnt[:S] > 0
    l_v = (per_scene_sum[:S] / torch.clamp(per_scene_cnt[:S], min=1)).sum()

    # push: same-scene centroid pairs, normalised per scene by n(n-1)
    iscene = _seg_max(torch.where(valid_pt, point_scene, -1), seg, I + 1,
                      -1)[:I]
    d = _safe_norm(mu[:, None, :] - mu[None, :, :], dim=-1)
    eye = torch.eye(I, dtype=torch.bool, device=e.device)
    pair_ok = ((iscene[:, None] == iscene[None, :]) & exists[:, None]
               & exists[None, :] & ~eye)
    hinge = torch.clamp(2 * cfg.delta_d - d, min=0.0) ** 2
    n_per_scene = _seg_sum(exists.float(),
                           torch.where(iscene >= 0, iscene, S), S + 1)[:S]
    pair_scene = torch.where(pair_ok, iscene[:, None], S)
    pair_sum = _seg_sum(_where0(pair_ok, hinge).reshape(-1),
                        pair_scene.reshape(-1), S + 1)[:S]
    denom = torch.clamp(n_per_scene * (n_per_scene - 1), min=1.0)
    l_d = _where0(n_per_scene > 1, pair_sum / denom).sum()

    # regularisation: per-scene mean centroid norm
    mu_norm = _safe_norm(mu, dim=1)
    reg_sum = _seg_sum(_where0(exists, mu_norm),
                       torch.where((iscene >= 0) & exists, iscene, S),
                       S + 1)[:S]
    l_r = _where0(n_per_scene > 0,
                  reg_sum / torch.clamp(n_per_scene, min=1)).sum()

    n_scenes = torch.clamp(scene_has.float().sum(), min=1.0)
    return (l_v + l_d + cfg.gamma * l_r) / n_scenes


def _sqdist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[P, I] squared distances as |a|^2 + |b|^2 - 2 a.b, clamped at 0."""
    an = (a * a).sum(1, keepdim=True)
    bn = (b * b).sum(1, keepdim=True)
    return torch.clamp(an + bn.T - 2.0 * (a @ b.T), min=0.0)


def classification_loss(embedding: torch.Tensor, bw: torch.Tensor,
                        regressed_pose: torch.Tensor, pose: torch.Tensor,
                        instance_id: torch.Tensor, point_scene: torch.Tensor,
                        labels: torch.Tensor, num_scenes: int,
                        num_instances: int, cfg: LossConfig = LossConfig()
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Soft-membership BCE (weight applied) and the mean instance IoU,
    over instances with at least `min_instance_points` points."""
    I = num_instances
    e = acc(embedding)
    x = acc(pose)
    rx = acc(regressed_pose)
    seg = _sanitize_seg(instance_id, I)
    valid_pt = instance_id >= 0

    mu, _ = _seg_mean(_where0(valid_pt[:, None], e), seg, I + 1)
    mean_pose, _ = _seg_mean(_where0(valid_pt[:, None], x), seg, I + 1)
    sig, _ = _seg_mean(_where0(valid_pt[:, None], acc(bw)), seg, I + 1)
    mu, mean_pose, sig = mu[:I], mean_pose[:I], sig[:I]
    scene_i, count_i, _, exists = _instance_stats(instance_id, point_scene,
                                                  labels, I)
    use = exists & (count_i >= cfg.min_instance_points)
    n_inst = torch.clamp(use.float().sum(), min=1.0)

    # the fused kernels (OCC_PALLAS_BCE=1), at the JAX package's gate
    if bce_loss.supported(e.shape[0], I, e.shape[1]):
        bce_sum, n_samp, tp, fp, tot = bce_loss.bce_membership_sums(
            e, rx, sig, mu, mean_pose, x, instance_id, point_scene, scene_i,
            use)
        per_inst = bce_sum / torch.clamp(n_samp, min=1)
        loss = (_where0(use, per_inst).sum() / n_inst
                * cfg.classification_weight)
        iou = tp / torch.clamp(tot + fp, min=1.0)
        return loss, _where0(use, iou).sum() / n_inst

    d_emb = torch.sqrt(_sqdist(e, mu) + 1e-12)             # [P, I]
    d_spat_r = torch.sqrt(_sqdist(rx, mean_pose) + 1e-12)
    d_spat = torch.sqrt(_sqdist(x, mean_pose) + 1e-12)

    # instance radius: max distance of its own points to its centre
    member = ((seg[:, None] == torch.arange(I, device=seg.device)[None, :])
              & valid_pt[:, None])
    radius = _where0(member, d_spat).amax(0)
    same_scene = point_scene[:, None] == scene_i[None, :]
    sample = (d_spat < 4.0 * radius[None, :]) & same_scene & use[None, :]

    d1 = d_emb * sig[None, :, 0]
    d2 = d_spat_r * sig[None, :, 1]
    # prob = exp(-s), BCE in s-space: -log(prob) = s, -log1p(-prob) =
    # -log(-expm1(-s)); the clip keeps prob in [1e-7, 1 - 1e-7]
    s = torch.clamp(d1 * d1 + d2 * d2, 1.0000001e-7, 16.11809565095832)
    bce = torch.where(member, s, -torch.log(-torch.expm1(-s)))
    bce = _where0(sample, bce)
    n_samp = sample.sum(0)
    per_inst = bce.sum(0) / torch.clamp(n_samp, min=1)
    loss = (_where0(use, per_inst).sum() / n_inst
            * cfg.classification_weight)

    pred = (s < 0.6931471805599453) & sample  # prob > 0.5
    gt = member & sample
    tp = (pred & gt).sum(0).float()
    fp = (pred & ~gt).sum(0).float()
    tot = gt.sum(0).float()
    iou = tp / torch.clamp(tot + fp, min=1.0)
    miou = _where0(use, iou).sum() / n_inst
    return loss, miou


def _cluster_losses(disp_err: torch.Tensor, occ_err: torch.Tensor,
                    occ: torch.Tensor, instance_id: torch.Tensor,
                    point_scene: torch.Tensor, labels: torch.Tensor,
                    num_scenes: int, num_instances: int, cfg: LossConfig):
    """Displacement and occupancy terms: per-instance mean errors (and the
    occ prediction's unbiased std), over GT class > 1, averaged over the
    instances of a scene and then over scenes."""
    I, S = num_instances, num_scenes
    seg = _sanitize_seg(instance_id, I)
    valid_pt = instance_id >= 0
    scene_i, count_i, cls_i, exists = _instance_stats(instance_id,
                                                      point_scene, labels, I)
    fg = exists & (cls_i >= cfg.foreground_class_threshold)

    def inst_mean(v):
        m, _ = _seg_mean(_where0(valid_pt, v)[:, None], seg, I + 1)
        return m[:I, 0]

    disp_mean = inst_mean(disp_err)
    occ_err_mean = inst_mean(occ_err)
    occ_mean = inst_mean(occ[:, 0])
    # centred two-pass variance (E[x^2] - E[x]^2 cancels catastrophically)
    centered = occ[:, 0] - _seg_lookup(occ_mean, seg, I)
    sq_sum = _seg_sum(_where0(valid_pt, centered * centered), seg, I + 1)
    n = torch.clamp(count_i, min=1.0)
    occ_std = torch.sqrt(torch.clamp(sq_sum[:I] / torch.clamp(n - 1, min=1),
                                     min=0) + 1e-12)

    iscene_fg = torch.where(fg, scene_i, S)
    n_fg = _seg_sum(fg.float(), iscene_fg, S + 1)[:S]

    def per_scene(v):
        s = _seg_sum(_where0(fg, v), iscene_fg, S + 1)[:S]
        return _where0(n_fg > 0, s / torch.clamp(n_fg, min=1)).sum()

    scene_has = _seg_sum(exists.float(), torch.where(exists, scene_i, S),
                         S + 1)[:S] > 0
    n_scenes = torch.clamp(scene_has.float().sum(), min=1.0)
    displacement = per_scene(disp_mean) / n_scenes
    occupancy = (per_scene(occ_err_mean) + per_scene(occ_std)) / n_scenes
    return displacement, occupancy


def _semantic_term(logits: torch.Tensor, labels: torch.Tensor,
                   cfg: LossConfig) -> torch.Tensor:
    """Semantic loss by `cfg.semantic_loss`."""
    from occuseg_tpu_torch.losses import semantic
    kind = cfg.semantic_loss
    if kind in ("cross_entropy", "nll"):
        return semantic_cross_entropy(logits, labels)
    if kind == "lovasz":
        return semantic.lovasz_softmax(logits, labels)
    if kind == "focal":
        return semantic.focal_loss(logits, labels)
    if kind in ("weighted", "weighted_cross_entropy"):
        w = cfg.ce_weights or semantic.SCANNET_CE_WEIGHTS
        return semantic.weighted_cross_entropy(
            logits, labels, torch.tensor(w, dtype=torch.float32,
                                         device=logits.device)
            [:logits.shape[-1]])
    raise NotImplementedError(f"semantic loss {kind!r}")


def occuseg_total_loss(outputs, batch: Dict[str, torch.Tensor],
                       num_scenes: int, num_instances: int,
                       cfg: LossConfig = LossConfig()
                       ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The 6-term training loss: (total, parts). `outputs` is an
    OccuSegOutputs with bw and occupancy; batch holds, per point (padding
    rows label = instance = -1): labels, instance_id, point_scene, pose
    [P, 3], offsets [P, 1], displacements [P, 3], occupancy [P, 1]."""
    labels = batch["labels"]
    iid = batch["instance_id"]
    pscene = batch["point_scene"]
    fg_pt = labels >= cfg.foreground_class_threshold

    sem = _semantic_term(outputs.semantics, labels, cfg)
    emb = discriminative_loss(outputs.embedding, iid, pscene, num_scenes,
                              num_instances, cfg)

    # offset (centredness) regression: L1 over foreground points * 100
    n_fg = fg_pt.float().sum()
    off_l1 = (acc(outputs.offset) - batch["offsets"]).abs()
    off_sum = _where0(fg_pt[:, None], off_l1).sum()
    regression = (off_sum / torch.clamp(n_fg, min=1.0) / off_l1.shape[1]
                  * cfg.regress_weight)

    disp_err = _safe_norm(acc(outputs.displacement)
                          - batch["displacements"], dim=1)
    occ_err = _safe_norm(acc(outputs.occupancy) - batch["occupancy"],
                         dim=1)
    displacement, occupancy = _cluster_losses(
        disp_err, occ_err, acc(outputs.occupancy), iid, pscene, labels,
        num_scenes, num_instances, cfg)

    regressed_pose = batch["pose"] - acc(outputs.displacement)
    classification, miou = classification_loss(
        outputs.embedding, outputs.bw, regressed_pose, batch["pose"], iid,
        pscene, labels, num_scenes, num_instances, cfg)

    total = sem + regression + emb + displacement + classification + occupancy
    parts = {
        "semantic_loss": sem, "embedding_loss": emb,
        "regression_loss": regression, "displacement_loss": displacement,
        "classification_loss": classification, "occupancy_loss": occupancy,
        "instance_iou": miou,
    }
    if cfg.drift_weight:
        drift = drift_loss(outputs.embedding, regressed_pose, batch["pose"],
                           outputs.offset, iid, labels, pscene, num_scenes,
                           num_instances, cfg)
        total = total + cfg.drift_weight * drift
        parts["drift_loss"] = cfg.drift_weight * drift
    parts["total"] = total
    return total, parts


def drift_loss(embedding: torch.Tensor, regressed_pose: torch.Tensor,
               pose: torch.Tensor, offset_pred: torch.Tensor,
               instance_id: torch.Tensor, labels: torch.Tensor,
               point_scene: torch.Tensor, num_scenes: int,
               num_instances: int, cfg: LossConfig = LossConfig()
               ) -> torch.Tensor:
    """DriftLoss: for foreground instances, the L1 between offset-weighted
    embeddings / regressed poses and the offset-weighted instance means,
    over points with offset > 0.01, averaged per instance and then over
    the instances that have such points."""
    I = num_instances
    seg = _sanitize_seg(instance_id, I)
    valid_pt = instance_id >= 0
    valid = valid_pt & (offset_pred.reshape(-1) > 0.01)
    e = acc(embedding)
    rp = acc(regressed_pose)
    w = acc(offset_pred.reshape(-1, 1))
    mu_e, _ = _seg_mean(_where0(valid_pt[:, None], e), seg, I + 1)
    mu_p, _ = _seg_mean(_where0(valid_pt[:, None], acc(pose)), seg, I + 1)
    _, _, cls_i, exists = _instance_stats(instance_id, point_scene, labels, I)
    fg = exists & (cls_i >= cfg.foreground_class_threshold)
    err = ((e * w - _seg_lookup(mu_e[:I], seg, I) * w).abs().mean(1)
           + (rp * w - _seg_lookup(mu_p[:I], seg, I) * w).abs().mean(1))
    use = valid & fg[torch.clamp(seg, 0, I - 1).long()]
    per_inst = _seg_sum(_where0(use, err), seg, I + 1)[:I]
    per_cnt = _seg_sum(use.float(), seg, I + 1)[:I]
    per_inst = _where0(per_cnt > 0, per_inst / torch.clamp(per_cnt, min=1))
    n_fg = torch.clamp((fg & (per_cnt > 0)).float().sum(), min=1.0)
    return per_inst.sum() / n_fg
