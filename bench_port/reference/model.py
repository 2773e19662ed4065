"""The sparse UNet and its heads in plain PyTorch, over the geometry of
`sparse.py`, from a dict of weights named as the program's state_dict.

Model (a configuration's "model" block): point features are averaged
into their level-0 voxels, a 3^3 submanifold convolution takes them to
m channels, then the recursive UNet of SparseConvNet over widths
`planes` (per level: `block_reps` pre-activated blocks, BN-ReLU and a
2^3 stride-2 convolution down, the next level, BN-ReLU and a 2^3
deconvolution up, a channel concat, `block_reps` blocks, the first of
them taking twice the channels), a BN-ReLU, each voxel's features copied
to its points, and linear heads: semantic logits, embedding, offset
(sigmoid) and displacement (each fc -> linear), and for the "bw" head
kind also the bandwidth (2, softplus) and occupancy (1, softplus).
A residual block is BN-ReLU, conv, BN-ReLU, conv plus the input (through
a 1x1 convolution where the widths differ). Batch norm (eps 1e-4) in
training mode normalises with the biased variance of the active sites
and decays its running statistics by 0.9 toward the mean and the
unbiased variance.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from bench_port.reference import sparse

EPS = 1e-4
MOMENTUM = 0.9

Spec = Tuple[str, Tuple[int, ...], str]


def _bn_specs(p: str, c: int) -> List[Spec]:
    return [(p + "weight", (c,), "ones"), (p + "bias", (c,), "zeros"),
            (p + "running_mean", (c,), "bn_mean"),
            (p + "running_var", (c,), "bn_var")]


def _block_specs(p: str, a: int, b: int, residual: bool) -> List[Spec]:
    out = []
    if residual and a != b:
        out.append((p + "shortcut.weight", (a, b), "nin"))
    out += _bn_specs(p + "bn1.", a)
    out.append((p + "conv1.weight", (27, a, b), "conv"))
    if residual:
        out += _bn_specs(p + "bn2.", b)
        out.append((p + "conv2.weight", (27, b, b), "conv"))
    return out


def _unet_specs(p: str, planes, reps: int, residual: bool) -> List[Spec]:
    out = []
    for i in range(reps):
        out += _block_specs(f"{p}enc{i}.", planes[0], planes[0], residual)
    if len(planes) == 1:
        return out
    out += _bn_specs(p + "down_bn.", planes[0])
    out.append((p + "down_conv.weight", (8, planes[0], planes[1]), "conv"))
    out += _unet_specs(p + "inner.", planes[1:], reps, residual)
    out += _bn_specs(p + "up_bn.", planes[1])
    out.append((p + "up_conv.weight", (8, planes[1], planes[0]), "conv"))
    for i in range(reps):
        out += _block_specs(f"{p}dec{i}.", planes[0] * (2 if i == 0 else 1),
                            planes[0], residual)
    return out


def _lin(p: str, cin: int, cout: int) -> List[Spec]:
    return [(p + "weight", (cout, cin), "linear"), (p + "bias", (cout,),
                                                     "zeros")]


def _prefixes(cfg: Dict) -> Tuple[str, str]:
    """(backbone prefix, heads prefix) of the head kind."""
    return (("backbone.backbone.", "backbone.") if cfg["heads"] == "bw"
            else ("backbone.", ""))


def param_specs(cfg: Dict) -> List[Spec]:
    """(name, shape, init kind) of every parameter and BN statistic."""
    planes, m = cfg["planes"], cfg["planes"][0]
    bb, hp = _prefixes(cfg)
    out = [(bb + "sub.weight", (27, cfg["in_features"], m), "conv")]
    out += _unet_specs(bb + "unet.", planes, cfg["block_reps"],
                       cfg["residual"])
    out += _bn_specs(bb + "bn.", m)
    out += _lin(hp + "linear.", m, cfg["classes"])
    for name, cout in (("embedding", m), ("regress", 1),
                       ("displacement", 3)):
        out += _lin(f"{hp}fc_{name}.", m, m)
        out += _lin(f"{hp}linear_{name}.", m, cout)
    if cfg["heads"] == "bw":
        for name, cout in (("bw", 2), ("occupancy", 1)):
            out += _lin(f"fc_{name}.", m, m) + _lin(f"linear_{name}.", m,
                                                      cout)
    return out


def make_weights(cfg: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The seeded weights, made on `device` in one large draw: convolution
    and 1x1 weights He-normal (std sqrt(2 / (Cin * K))), linear weights
    normal with std 1 / sqrt(Cin), biases 0, BN scale 1 and shift 0,
    running statistics 0 and 1."""
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
        elif kind == "linear":
            t = z / shape[1] ** 0.5
        elif kind in ("ones", "bn_var"):
            t = torch.ones(shape, device=device)
        else:
            t = torch.zeros(shape, device=device)
        out[name] = t.contiguous()
    return out


class Net:
    """The forward over one geometry. `params` maps names to tensors (the
    trained leaves may require grad); in training mode the BN running
    statistics in `params` are updated in place."""

    def __init__(self, cfg: Dict, params: Dict[str, torch.Tensor],
                 geo: sparse.Geometry, train: bool):
        self.cfg, self.p, self.geo, self.train = cfg, params, geo, train

    def bn_relu(self, x: torch.Tensor, p: str) -> torch.Tensor:
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
        return torch.relu((x - mean) * torch.rsqrt(var + EPS) * w + b)

    def subconv(self, x, name, level):
        lv = self.geo.levels[level]
        return sparse.conv(x, self.p[name], lv.n,
                           sparse.submanifold_pairs(lv))

    def block(self, x, p, level):
        y = self.subconv(self.bn_relu(x, p + "bn1."), p + "conv1.weight",
                         level)
        if not self.cfg["residual"]:
            return y
        sc = x @ self.p[p + "shortcut.weight"] \
            if p + "shortcut.weight" in self.p else x
        y = self.subconv(self.bn_relu(y, p + "bn2."), p + "conv2.weight",
                         level)
        return sc + y

    def unet(self, x, p, level, depth):
        reps = self.cfg["block_reps"]
        for i in range(reps):
            x = self.block(x, f"{p}enc{i}.", level)
        if depth == 1:
            return x
        g = self.geo
        y = sparse.conv(self.bn_relu(x, p + "down_bn."),
                        self.p[p + "down_conv.weight"],
                        g.levels[level + 1].n, sparse.down_pairs(g, level))
        y = self.unet(y, p + "inner.", level + 1, depth - 1)
        y = sparse.conv(self.bn_relu(y, p + "up_bn."),
                        self.p[p + "up_conv.weight"], g.levels[level].n,
                        sparse.up_pairs(g, level))
        x = torch.cat([x, y], dim=1)
        for i in range(reps):
            x = self.block(x, f"{p}dec{i}.", level)
        return x

    def lin(self, x, p):
        return x @ self.p[p + "weight"].t() + self.p[p + "bias"]

    def __call__(self, point_feats: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Per-point outputs (rows of pad points are 0 before the heads)."""
        cfg, g = self.cfg, self.geo
        bb, hp = _prefixes(cfg)
        valid = g.p2v >= 0
        n0 = g.levels[0].n
        idx = g.p2v[valid]
        s = torch.zeros((n0, point_feats.shape[1]), device=idx.device)
        s.index_add_(0, idx, point_feats[valid].float())
        cnt = torch.bincount(idx, minlength=n0).clamp(min=1)
        x = s / cnt[:, None]
        x = self.subconv(x, bb + "sub.weight", 0)
        x = self.unet(x, bb + "unet.", 0, len(cfg["planes"]))
        x = self.bn_relu(x, bb + "bn.")
        f = torch.where(valid[:, None], x[g.p2v.clamp(min=0)],
                        x.new_zeros(()))
        out = {"semantics": self.lin(f, hp + "linear."), "features": f}
        for name in ("embedding", "regress", "displacement"):
            out[name] = self.lin(self.lin(f, f"{hp}fc_{name}."),
                                 f"{hp}linear_{name}.")
        out["offset"] = torch.sigmoid(out.pop("regress"))
        if cfg["heads"] == "bw":
            for name in ("bw", "occupancy"):
                out[name] = F.softplus(self.lin(self.lin(f, f"fc_{name}."),
                                                f"linear_{name}."))
        return out
