"""MinkUNet34C (Choy, Gwak and Savarese, CVPR 2019; MinkowskiEngine's
`examples/minkunet.py`, `MinkUNetBase` with `MinkUNet34C`'s stages), its
cross-entropy and its training steps in plain PyTorch, over the geometry of
`sparse.py` with the 5^3 neighbour pairs of the stem worked out here, from
a dict of weights named as the program's state_dict. It imports nothing of
the program.

Model (a configuration's "model" block: in_features, classes, init_dim,
layers, planes, stem_kernel): point features are averaged into their
level-0 voxels; the stem is a stem_kernel^3 submanifold convolution to
init_dim, BN, ReLU (`out_p1`); encoder stage i is a 2^3 stride-2
convolution of the current width onto itself, BN, ReLU, then layers[i]
BasicBlocks at planes[i]; decoder stage i is a 2^3 stride-2 deconvolution
to planes[E + i], BN, ReLU, the concat with the encoder's output at that
level (`out_p1` at level 0), then layers[E + i] BasicBlocks; `final` is a
1x1 convolution with bias to the classes. A BasicBlock is conv 3^3, BN,
ReLU, conv 3^3, BN, plus the shortcut (1x1 convolution and BN where the
width changes), ReLU. Batch norm (eps 1e-5) in training mode normalises
with the biased variance of the active sites and moves its running
statistics 0.1 of the way to the mean and the unbiased variance
(momentum 0.1 in PyTorch's sense). The loss is the mean cross-entropy
over the labelled points (label < 0 ignored).

Where this departs from MinkowskiEngine: a voxel's features are the mean
of its points' (the program's InputLayer), not the one point that
`sparse_quantize` keeps; the logits and the loss are over the points,
each taking its voxel's logits (the program's OutputLayer), not over the
voxels; and rows are in key order (the program's rows are in another
order; only per-point results and per-leaf norms are compared).

Filter offsets are z-major as in `sparse.py`: the stem's offset k is
(dz, dy, dx) in {-2..2}^3 with k = 25 (dz + 2) + 5 (dy + 2) + (dx + 2).
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from bench_port.reference import sparse
from bench_port.reference.model import Spec, _bn_specs

EPS = 1e-5
MOMENTUM = 0.9       # the decay of the running statistics
KEYS = ("coords", "features", "labels", "point_scene")


def offsets(kernel: int, device) -> torch.Tensor:
    """The odd cubic stencil's offsets [kernel^3, 3], z-major."""
    h = kernel // 2
    r = torch.arange(-h, h + 1, device=device)
    g = torch.stack(torch.meshgrid(r, r, r, indexing="ij"), dim=-1)
    return g.reshape(-1, 3)


def neighbours(keys: torch.Tensor, kernel: int) -> torch.Tensor:
    """[kernel^3, N] neighbour rows of a level's sorted keys."""
    c = sparse.unpack(keys)
    out = []
    for d in offsets(kernel, keys.device):
        sp = c[:, 1:] + d
        ok = ((sp >= 0) & (sp < sparse.AXIS)).all(dim=1)
        q = sparse.pack(torch.cat([c[:, :1], sp.clamp(0, sparse.AXIS - 1)],
                                  dim=1))
        out.append(sparse._lookup(keys, q, ok))
    return torch.stack(out)


def stem_pairs(level: sparse.Level, kernel: int) -> sparse.Pairs:
    """(input rows, output rows) of each offset of the stem's stencil."""
    return sparse.submanifold_pairs(sparse.Level(level.keys,
                                                 neighbours(level.keys,
                                                            kernel)))


def _block_specs(p: str, a: int, b: int) -> List[Spec]:
    out = [(p + "conv1.weight", (27, a, b), "conv")] + _bn_specs(p + "bn1.", b)
    out += [(p + "conv2.weight", (27, b, b), "conv")] + _bn_specs(p + "bn2.",
                                                                   b)
    if a != b:
        out += [(p + "shortcut.weight", (a, b), "nin")]
        out += _bn_specs(p + "shortcut_bn.", b)
    return out


def stages(cfg: Dict) -> Tuple[List[Tuple[int, int, int]],
                               List[Tuple[int, int, int, int]]]:
    """([(width in, width out, reps)] of the encoder stages, [(width in,
    width out, skip width, reps)] of the decoder stages)."""
    planes, layers = cfg["planes"], cfg["layers"]
    E = len(planes) // 2
    enc, dec, c, skips = [], [], cfg["init_dim"], [cfg["init_dim"]]
    for i in range(E):
        enc.append((c, planes[i], layers[i]))
        c = planes[i]
        skips.append(c)
    for i in range(E):
        p = planes[E + i]
        dec.append((c, p, skips[E - 1 - i], layers[E + i]))
        c = p
    return enc, dec


def param_specs(cfg: Dict) -> List[Spec]:
    """(name, shape, init kind) of every parameter and BN statistic."""
    k3 = cfg["stem_kernel"] ** 3
    c0 = cfg["init_dim"]
    out = [("stem.weight", (k3, cfg["in_features"], c0), "conv")]
    out += _bn_specs("stem_bn.", c0)
    enc, dec = stages(cfg)
    for i, (a, b, reps) in enumerate(enc):
        out += [(f"down.{i}.conv.weight", (8, a, a), "conv")]
        out += _bn_specs(f"down.{i}.bn.", a)
        for j in range(reps):
            out += _block_specs(f"enc.{i}.{j}.", a if j == 0 else b, b)
    for i, (a, p, skip, reps) in enumerate(dec):
        out += [(f"up.{i}.conv.weight", (8, a, p), "conv")]
        out += _bn_specs(f"up.{i}.bn.", p)
        for j in range(reps):
            out += _block_specs(f"dec.{i}.{j}.", p + skip if j == 0 else p, p)
    c = dec[-1][1]
    out += [("final.weight", (c, cfg["classes"]), "nin"),
            ("final.bias", (cfg["classes"],), "zeros")]
    return out


def make_weights(cfg: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The seeded weights, made on `device` in one large draw: convolution
    weights He-normal (std sqrt(2 / (Cin * K))), 1x1 weights He-normal
    (std sqrt(2 / Cin)), biases 0, BN scale 1 and shift 0, running
    statistics 0 and 1."""
    specs = param_specs(cfg)
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 63))
    numel = [int(torch.Size(s).numel()) for _, s, _ in specs]
    normal = torch.randn(sum(numel), generator=g, device=device)
    out, at = {}, 0
    for (name, shape, kind), n in zip(specs, numel):
        z = normal[at:at + n].view(shape)
        at += n
        if kind == "conv":
            t = z * (2.0 / (shape[1] * shape[0])) ** 0.5
        elif kind == "nin":
            t = z * (2.0 / shape[0]) ** 0.5
        elif kind in ("ones", "bn_var"):
            t = torch.ones(shape, device=device)
        else:
            t = torch.zeros(shape, device=device)
        out[name] = t.contiguous()
    return out


class Net:
    """The forward over one geometry (`sparse.build` over the plan's
    levels, and the stem's pairs), in the dtype of the weights. `params`
    maps names to tensors; in training mode the BN running statistics in
    `params` are updated in place."""

    def __init__(self, cfg: Dict, params: Dict[str, torch.Tensor],
                 geo: sparse.Geometry, stem: sparse.Pairs, train: bool):
        self.cfg, self.p, self.geo, self.stem = cfg, params, geo, stem
        self.train = train
        self._pairs: Dict[int, sparse.Pairs] = {}

    def bn(self, x: torch.Tensor, p: str, relu: bool) -> torch.Tensor:
        w, b = self.p[p + "weight"], self.p[p + "bias"]
        rm, rv = self.p[p + "running_mean"], self.p[p + "running_var"]
        if self.train:
            n = x.shape[0]
            mean = x.mean(0)
            var = ((x - mean) ** 2).mean(0)
            with torch.no_grad():
                rm.mul_(MOMENTUM).add_((1 - MOMENTUM) * mean)
                rv.mul_(MOMENTUM).add_((1 - MOMENTUM) * var * n
                                       / max(n - 1, 1))
        else:
            mean, var = rm, rv
        y = (x - mean) * torch.rsqrt(var + EPS) * w + b
        return torch.relu(y) if relu else y

    def sub(self, x, name, level):
        lv = self.geo.levels[level]
        if level not in self._pairs:
            self._pairs[level] = sparse.submanifold_pairs(lv)
        return sparse.conv(x, self.p[name], lv.n, self._pairs[level])

    def block(self, x, p, level):
        y = self.bn(self.sub(x, p + "conv1.weight", level), p + "bn1.", True)
        y = self.bn(self.sub(y, p + "conv2.weight", level), p + "bn2.", False)
        if p + "shortcut.weight" in self.p:
            x = self.bn(x @ self.p[p + "shortcut.weight"], p + "shortcut_bn.",
                        False)
        return torch.relu(y + x)

    def __call__(self, point_feats: torch.Tensor) -> torch.Tensor:
        """Per-point logits [P, classes] (pad points' rows: the bias)."""
        g = self.geo
        valid = g.p2v >= 0
        n0 = g.levels[0].n
        idx = g.p2v[valid]
        w = self.p["stem.weight"]
        s = torch.zeros((n0, point_feats.shape[1]), dtype=w.dtype,
                        device=idx.device)
        s.index_add_(0, idx, point_feats[valid].to(w.dtype))
        cnt = torch.bincount(idx, minlength=n0).clamp(min=1)
        x = sparse.conv(s / cnt[:, None], self.p["stem.weight"], n0,
                        self.stem)
        x = self.bn(x, "stem_bn.", True)
        enc, dec = stages(self.cfg)
        skips = [x]
        for i, (_, _, reps) in enumerate(enc):
            x = sparse.conv(x, self.p[f"down.{i}.conv.weight"],
                            g.levels[i + 1].n, sparse.down_pairs(g, i))
            x = self.bn(x, f"down.{i}.bn.", True)
            for j in range(reps):
                x = self.block(x, f"enc.{i}.{j}.", i + 1)
            skips.append(x)
        skips.pop()
        E = len(enc)
        for i, (_, _, _, reps) in enumerate(dec):
            level = E - 1 - i
            x = sparse.conv(x, self.p[f"up.{i}.conv.weight"],
                            g.levels[level].n, sparse.up_pairs(g, level))
            x = torch.cat([self.bn(x, f"up.{i}.bn.", True), skips.pop()],
                          dim=1)
            for j in range(reps):
                x = self.block(x, f"dec.{i}.{j}.", level)
        x = x @ self.p["final.weight"] + self.p["final.bias"]
        return torch.where(valid[:, None], x[g.p2v.clamp(min=0)],
                           self.p["final.bias"])


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor
                  ) -> torch.Tensor:
    """Mean cross-entropy over the points with a label >= 0."""
    lab = labels.long()
    has = lab >= 0
    nll = -F.log_softmax(logits, dim=-1).gather(1, lab.clamp(min=0)[:, None])
    return torch.where(has, nll[:, 0], 0.0).sum() / has.sum().clamp(min=1)


def geometry(cfg: Dict, coords: torch.Tensor
             ) -> Tuple[sparse.Geometry, sparse.Pairs]:
    """The levels of point coords [P, 4] and the stem's pairs."""
    geo = sparse.build(coords, len(cfg["planes"]) // 2 + 1)
    return geo, stem_pairs(geo.levels[0], cfg["stem_kernel"])


def real(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """The real points of a batch (its first rows), as tensors."""
    n = int((batch["coords"][:, 0] >= 0).sum())
    return {k: torch.as_tensor(np.ascontiguousarray(batch[k][:n])).to(device)
            for k in KEYS}


def run(cfg: Dict, seed: int, batches: Sequence[Dict[str, np.ndarray]],
        num_scenes: int, lr: float, momentum: float, weight_decay: float,
        device, tf32: bool = False, fault: str = None) -> Dict:
    """The reference's training steps: the model from the seeded weights,
    the cross-entropy, and SGD (momentum, the weight decay added to the
    gradient), one update a step, over the real points of each batch.
    {losses: [each step's loss], grads: {leaf: norm of its first
    gradient}, change: {leaf or BN statistic: norm of its change over the
    steps}, change1: {BN statistic: norm of its change in the first
    step}}. Float32 with TF32 off, or on (`tf32`, the control); `fault`
    plants "half" or "answer" of `lib/faults.py`."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        init = make_weights(cfg, seed, device)
        params = {n: t.clone() for n, t in init.items()}
        leaves = [n for n in params
                  if not n.endswith(("running_mean", "running_var"))]
        for n in leaves:
            params[n].requires_grad_(True)
        opt = torch.optim.SGD([params[n] for n in leaves], lr=lr,
                              momentum=momentum, weight_decay=weight_decay,
                              foreach=False)
        losses: List[float] = []
        grads: Dict[str, float] = {}
        change1: Dict[str, float] = {}
        for i, batch in enumerate(batches):
            b = real(batch, device)
            if fault == "half":   # the second half of the scenes left out
                b["labels"] = torch.where(
                    b["point_scene"] >= (num_scenes + 1) // 2, -1,
                    b["labels"])
            geo, stem = geometry(cfg, b["coords"])
            logits = Net(cfg, params, geo, stem, train=True)(b["features"])
            loss = cross_entropy(logits, b["labels"])
            opt.zero_grad(set_to_none=True)
            loss.backward()
            if i == 0:
                grads = {n: float(params[n].grad.double().norm())
                         for n in leaves}
                change1 = {n: float((params[n].detach() - init[n])
                                    .double().norm())
                           for n in params if n not in leaves}
            first = params[leaves[0]].detach().clone()
            opt.step()
            if fault == "answer":
                with torch.no_grad():
                    params[leaves[0]].add_(params[leaves[0]] - first)
            losses.append(float(loss.detach()))
            del b, geo, stem, logits, loss
        with torch.no_grad():
            change = {n: float((params[n].detach() - init[n]).double().norm())
                      for n in params}
        return {"losses": losses, "grads": grads, "change": change,
                "change1": change1}
    finally:
        torch.backends.cuda.matmul.allow_tf32, \
            torch.backends.cudnn.allow_tf32 = saved
