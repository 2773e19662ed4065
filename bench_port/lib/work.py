"""The matrix work of a model step, counted from the scene's coordinates
with the benchmark's own voxelisation and neighbour search
(`reference/sparse.py`), never from the program's plan.

A product of n_pairs (input row, output row) pairs with Cin and Cout
channels is 2 n_pairs Cin Cout operations: every submanifold, strided and
deconvolution layer of the architecture, the input convolution, the 1x1
shortcuts and the linear heads (over the real points). A training step
counts the forward once and each backward product once: d_input (not for
the input convolution, whose input needs no gradient) and d_weight. The
bytes of a product are its input rows, its weight and its output rows,
each once, in f32. `conv_bound_s` is the least time of the convolution
layers (those the convolution kernels run: not the shortcuts or heads),
the sum over their products of max(operations / peak, bytes / bandwidth).
"""

from __future__ import annotations

from typing import Dict, List

import torch

from bench_port.reference import sparse

F32 = 4


def level_counts(coords: torch.Tensor, num_levels: int) -> Dict[str, List]:
    """Active sites a level (`sites`) and submanifold pairs a level
    (`pairs`, the centre included) of point coords [P, 4]."""
    geo = sparse.build(coords, num_levels)
    return {"sites": [lv.n for lv in geo.levels],
            "pairs": [int((lv.nbr >= 0).sum()) for lv in geo.levels],
            "points": int((coords[:, 0] >= 0).sum())}


def voxels(coords: torch.Tensor) -> int:
    """Active level-0 sites of point coords [P, 4] (-1 rows padding)."""
    c = coords[coords[:, 0] >= 0]
    return int(torch.unique(sparse.pack(c)).numel())


def products(cfg: Dict, counts: Dict[str, List]) -> List[Dict]:
    """The forward's products of a model config ("planes", "block_reps",
    "residual", "in_features", "classes", "heads") over `counts`: each a
    dict of pairs, cin, cout, rows_in, rows_out, k (weight offsets) and
    kind ("conv", "nin" or "linear")."""
    planes, reps, res = cfg["planes"], cfg["block_reps"], cfg["residual"]
    S, N = counts["pairs"], counts["sites"]
    out = []

    def add(kind, pairs, cin, cout, rin, rout, k):
        out.append(dict(kind=kind, pairs=pairs, cin=cin, cout=cout,
                        rows_in=rin, rows_out=rout, k=k))

    def sub(l, cin, cout):
        add("conv", S[l], cin, cout, N[l], N[l], 27)

    def block(l, cin, cout):
        sub(l, cin, cout)
        if res:
            sub(l, cout, cout)
            if cin != cout:
                add("nin", N[l], cin, cout, N[l], N[l], 1)

    m = planes[0]
    add("input", S[0], cfg["in_features"], m, N[0], N[0], 27)
    for l, a in enumerate(planes):
        for _ in range(reps):
            block(l, a, a)
        if l < len(planes) - 1:
            b = planes[l + 1]
            add("conv", N[l], a, b, N[l], N[l + 1], 8)
            add("conv", N[l], b, a, N[l + 1], N[l], 8)
            for i in range(reps):
                block(l, 2 * a if i == 0 else a, a)
    P = counts["points"]
    heads = [(m, cfg["classes"])] + [(m, m), (m, m), (m, m), (m, 1),
                                     (m, m), (m, 3)]
    if cfg["heads"] == "bw":
        heads += [(m, m), (m, 2), (m, m), (m, 1)]
    for cin, cout in heads:
        add("linear", P, cin, cout, P, P, 1)
    return out


def step_work(cfg: Dict, counts: Dict[str, List], train: bool,
              peaks: Dict[str, float]) -> Dict[str, float]:
    """{flops, conv_flops, conv_bound_s, voxels} of one step over
    `counts` (a forward, or with `train` the forward and backward)."""
    flops = conv_flops = bound = 0.0
    for p in products(cfg, counts):
        f = 2.0 * p["pairs"] * p["cin"] * p["cout"]
        w = p["k"] * p["cin"] * p["cout"] * F32
        xin, xout = p["rows_in"] * p["cin"] * F32, \
            p["rows_out"] * p["cout"] * F32
        passes = [(f, xin + w + xout)]
        if train:
            if p["kind"] != "input":
                passes.append((f, xout + w + xin))   # d_input
            passes.append((f, xin + xout + w))       # d_weight
        for fl, by in passes:
            flops += fl
            if p["kind"] in ("conv", "input"):
                conv_flops += fl
                bound += max(fl / peaks["f32_flops"],
                             by / peaks["hbm_bytes_per_s"])
    return {"flops": flops, "conv_flops": conv_flops, "conv_bound_s": bound,
            "voxels": float(counts["sites"][0])}
