"""The matrix work of a MinkUNet step, counted from the scene's coordinates
with the benchmark's own voxelisation and neighbour search
(`reference/sparse.py`, the stem's stencil from `reference/minkunet.py`),
never from the program's plan; the counterpart of `lib/work.py` for a
configuration whose "model" block is MinkUNet's (init_dim, layers,
planes, stem_kernel).

The products of a forward: the stem (the stem_kernel^3 submanifold
convolution, its pairs the stencil's, Cin the real input width), each
stage's size-2 stride-2 convolution (one pair a fine site) and
deconvolution, every BasicBlock's two 3^3 convolutions and its 1x1
shortcut where the width changes, and `final` (a 1x1 convolution over the
level-0 voxels). A training step counts the forward once and each
backward product once, as `lib/work.py`: d_input (not for the stem, whose
input needs no gradient) and d_weight; the bytes of a product are its
input rows, its weight and its output rows in f32; `conv_bound_s` is the
least time, max(operations / peak, bytes / bandwidth) summed over the
passes of the convolutions (the stem, the 3^3 and the stride-2 ones: not
the shortcuts or `final`), and `stem_bound_s` that of the stem's forward
alone.
"""

from __future__ import annotations

from typing import Dict, List

import torch

from bench_port.lib.work import F32
from bench_port.reference import minkunet as ref
from bench_port.reference import sparse


def stem_pair_count(keys: torch.Tensor, kernel: int) -> int:
    """Pairs of the stencil over a level's sorted keys, the centre
    included (one offset at a time)."""
    c = sparse.unpack(keys)
    n = 0
    for d in ref.offsets(kernel, keys.device):
        sp = c[:, 1:] + d
        ok = ((sp >= 0) & (sp < sparse.AXIS)).all(dim=1)
        q = sparse.pack(torch.cat([c[:, :1], sp.clamp(0, sparse.AXIS - 1)],
                                  dim=1))
        n += int((sparse._lookup(keys, q, ok) >= 0).sum())
    return n


def level_counts(coords: torch.Tensor, cfg: Dict) -> Dict[str, List]:
    """Active sites a level (`sites`), 3^3 submanifold pairs a level
    (`pairs`, the centre included) and the stem's pairs at level 0
    (`stem_pairs`) of point coords [P, 4]."""
    geo = sparse.build(coords, len(cfg["planes"]) // 2 + 1)
    return {"sites": [lv.n for lv in geo.levels],
            "pairs": [int((lv.nbr >= 0).sum()) for lv in geo.levels],
            "stem_pairs": stem_pair_count(geo.levels[0].keys,
                                          cfg["stem_kernel"]),
            "points": int((coords[:, 0] >= 0).sum())}


def products(cfg: Dict, counts: Dict[str, List]) -> List[Dict]:
    """The forward's products over `counts`: each a dict of pairs, cin,
    cout, rows_in, rows_out, k (weight offsets) and kind ("input" for the
    stem, "conv", or "nin" for the shortcuts and `final`)."""
    S, N = counts["pairs"], counts["sites"]
    out = []

    def add(kind, pairs, cin, cout, rin, rout, k):
        out.append(dict(kind=kind, pairs=pairs, cin=cin, cout=cout,
                        rows_in=rin, rows_out=rout, k=k))

    def blocks(level, cin, cout, reps):
        for j in range(reps):
            a = cin if j == 0 else cout
            add("conv", S[level], a, cout, N[level], N[level], 27)
            add("conv", S[level], cout, cout, N[level], N[level], 27)
            if a != cout:
                add("nin", N[level], a, cout, N[level], N[level], 1)

    k3 = cfg["stem_kernel"] ** 3
    add("input", counts["stem_pairs"], cfg["in_features"], cfg["init_dim"],
        N[0], N[0], k3)
    enc, dec = ref.stages(cfg)
    for i, (a, b, reps) in enumerate(enc):
        add("conv", N[i], a, a, N[i], N[i + 1], 8)
        blocks(i + 1, a, b, reps)
    E = len(enc)
    for i, (a, p, skip, reps) in enumerate(dec):
        level = E - 1 - i
        add("conv", N[level], a, p, N[level + 1], N[level], 8)
        blocks(level, p + skip, p, reps)
    add("nin", N[0], dec[-1][1], cfg["classes"], N[0], N[0], 1)
    return out


def _passes(p: Dict, train: bool):
    f = 2.0 * p["pairs"] * p["cin"] * p["cout"]
    w = p["k"] * p["cin"] * p["cout"] * F32
    xin, xout = p["rows_in"] * p["cin"] * F32, p["rows_out"] * p["cout"] * F32
    out = [(f, xin + w + xout)]
    if train:
        if p["kind"] != "input":
            out.append((f, xout + w + xin))   # d_input
        out.append((f, xin + xout + w))       # d_weight
    return out


def step_work(cfg: Dict, counts: Dict[str, List], train: bool,
              peaks: Dict[str, float]) -> Dict[str, float]:
    """{flops, conv_flops, conv_bound_s, stem_bound_s, voxels} of one step
    over `counts` (a forward, or with `train` the forward and
    backward)."""
    flops = conv_flops = bound = stem = 0.0

    def least(fl, by):
        return max(fl / peaks["f32_flops"], by / peaks["hbm_bytes_per_s"])

    for p in products(cfg, counts):
        for i, (fl, by) in enumerate(_passes(p, train)):
            flops += fl
            if p["kind"] in ("conv", "input"):
                conv_flops += fl
                bound += least(fl, by)
            if p["kind"] == "input" and i == 0:
                stem = least(fl, by)
    return {"flops": flops, "conv_flops": conv_flops, "conv_bound_s": bound,
            "stem_bound_s": stem, "voxels": float(counts["sites"][0])}
