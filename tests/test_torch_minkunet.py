"""MinkUNet (`models/minkunet.py`) against the benchmark's plain reference
(`bench_port/reference/minkunet.py`) at a small size in float64, the 5^3
stem map against a brute-force search, the plans of a spec with and
without the stem stencil, the preset's parameter count, and the training
CLI's path (`--arch minkunet34c`) on the CPU."""

import itertools

import numpy as np
import pytest
import torch

from bench_port.reference import minkunet as ref
from occuseg_tpu.core.topology import PlanSpec as JaxPlanSpec
from occuseg_tpu_torch.core.topology import (PlanSpec, build_plan,
                                             stencil_map_kn)
from occuseg_tpu_torch.data.synthetic import SceneConfig, make_batch
from occuseg_tpu_torch.infer import plan_scene, unpermute
from occuseg_tpu_torch.losses.semantic import semantic_step_loss
from occuseg_tpu_torch.models import minkunet
from occuseg_tpu_torch.models.minkunet import MinkUNet, MinkUNet34C
from occuseg_tpu_torch.train.state import (TrainConfig, make_optimizer,
                                           prepare_batch)
from occuseg_tpu_torch.utils.profiling import snapshot
from tests.jax_planner import host_plan_blocked as jax_plan_blocked

# two encoder stages, narrow, a rep or two: three levels
CFG = {"in_features": 3, "classes": 20, "init_dim": 8, "layers": [1, 2, 2, 1],
       "planes": [16, 24, 16, 8], "stem_kernel": 5}
CAPS = (6144, 6144, 3072)
SCENE = SceneConfig(num_points=1500, extent=64, num_objects=6)


def _batch(seed=2, ns=2):
    return make_batch(SCENE, num_scenes=ns, p_cap=8192, num_instances=16,
                      seed=seed)


def _model(dtype=torch.float64):
    m = MinkUNet(3, 20, init_dim=8, layers=CFG["layers"],
                 planes=CFG["planes"], stem_kernel=5)
    m.load_state_dict(ref.make_weights(CFG, 11, "cpu"))
    return m.to(dtype)


# (dtype, relative tolerance of the logits, the loss and the BN statistics
# and of each gradient to its largest entry) of each route: the gather
# path (--chunk_conv 0) accumulates in float64 for float64 data
# (`ops.acc`); the chunk kernels' plain versions sum in float32, so the
# main path's route is compared in float32: round-off of sums over up to
# 125 x Cin products, carried through five levels and their BN
ROUTES = {"gather": (torch.float64, 1e-9, 1e-9),
          "chunk": (torch.float32, 2e-4, 2e-3)}


@pytest.fixture(scope="module", params=sorted(ROUTES))
def both(request):
    """The port's and the reference's train-mode forward, loss and
    gradients on one two-scene batch, through one route."""
    dtype, tol, gtol = ROUTES[request.param]
    b = _batch()
    laid, plan = prepare_batch(b, PlanSpec(caps=CAPS, stem_kernel=5), 2,
                               chunks=request.param == "chunk")
    m = _model(dtype)
    m.train()
    out = m(torch.as_tensor(laid["features"]).to(dtype), plan.to("cpu"))
    loss, _ = semantic_step_loss(out, {"labels": torch.as_tensor(
        laid["labels"])})
    loss.backward()
    n = int((b["coords"][:, 0] >= 0).sum())
    assert plan.point_perm is not None     # the sorted point layout
    logits = unpermute(out.semantics.detach(),
                       torch.as_tensor(plan.point_perm))[:n]

    params = {k: v.to(dtype).clone() for k, v in
              ref.make_weights(CFG, 11, "cpu").items()}
    leaves = [k for k in params if not k.endswith(("running_mean",
                                                   "running_var"))]
    for k in leaves:
        params[k].requires_grad_(True)
    rb = ref.real(b, "cpu")
    geo, stem = ref.geometry(CFG, rb["coords"])
    rlogits = ref.Net(CFG, params, geo, stem, True)(rb["features"])
    rloss = ref.cross_entropy(rlogits, rb["labels"])
    rloss.backward()
    return dict(m=m, loss=loss, logits=logits, params=params, leaves=leaves,
                rloss=rloss, rlogits=rlogits.detach(), tol=tol, gtol=gtol,
                route=request.param)


def test_logits_and_loss_match_the_reference(both):
    tol = both["tol"]
    scale = float(both["rlogits"].abs().max())
    torch.testing.assert_close(both["logits"], both["rlogits"], rtol=tol,
                               atol=tol * scale)
    assert float(both["loss"].detach()) == pytest.approx(
        float(both["rloss"].detach()), rel=tol)


def test_every_gradient_matches_the_reference(both):
    named = dict(both["m"].named_parameters())
    assert set(named) == set(both["leaves"])
    for k in both["leaves"]:
        g, rg = named[k].grad, both["params"][k].grad
        scale = max(float(rg.abs().max()), 1e-12)
        assert float((g - rg).abs().max()) <= both["gtol"] * scale, k


def test_bn_statistics_and_an_sgd_step_match_the_reference(both):
    m, params, tol = both["m"], both["params"], both["tol"]
    sd = m.state_dict()
    for k in params:
        if k.endswith(("running_mean", "running_var")):
            torch.testing.assert_close(sd[k], params[k], rtol=tol,
                                       atol=tol * float(params[k].abs()
                                                        .max()))
    opt, _ = make_optimizer(m.parameters(),
                            TrainConfig(lr=0.1, optimizer="sgd"))
    opt.step()
    ropt = torch.optim.SGD([params[k] for k in both["leaves"]], lr=0.1,
                           momentum=0.9, weight_decay=1e-4)
    ropt.step()
    named = dict(m.named_parameters())
    for k in both["leaves"]:
        w, rw = named[k].detach(), params[k].detach()
        scale = max(float(rw.abs().max()), 1e-12)
        assert float((w - rw).abs().max()) <= both["gtol"] * scale, k


def _brute_map(coords: np.ndarray, rows: np.ndarray, kernel: int):
    """[cap, kernel^3] of a level's coords by a dictionary of its rows."""
    at = {tuple(coords[r]): r for r in rows}
    h = kernel // 2
    out = np.full((coords.shape[0], kernel ** 3), -1, np.int32)
    for r in rows:
        b, z, y, x = coords[r]
        for k, (dz, dy, dx) in enumerate(itertools.product(
                range(-h, h + 1), repeat=3)):
            out[r, k] = at.get((b, z + dz, y + dy, x + dx), -1)
    return out


@pytest.mark.parametrize("ns", [1, 2])
def test_stem_map_matches_a_brute_force_search(ns):
    b = _batch(seed=5, ns=ns)
    plan = plan_scene(b["coords"], PlanSpec(caps=CAPS, stem_kernel=5), ns,
                      chunks=False)
    lvl = plan.levels[0]
    assert lvl.stem_kernel == 5 and all(l.stem_kernel is None
                                        for l in plan.levels[1:])
    real = np.nonzero(lvl.coords[:, 0] >= 0)[0]
    want = _brute_map(lvl.coords, real, 5)
    got = stencil_map_kn(torch.as_tensor(lvl.keys), 5, ns).t().numpy()
    assert np.array_equal(got, want)
    # the level's map of volume 125, built once and kept; 27 is `nbr`
    m = lvl.stencil_map(125, "cpu")
    assert np.array_equal(m.t().numpy(), want)
    assert lvl.stencil_map(125, "cpu") is m
    with pytest.raises(ValueError, match="volume 343"):
        lvl.stencil_map(343, "cpu")
    with pytest.raises(ValueError, match="volume 125"):
        plan.levels[1].stencil_map(125, "cpu")


def test_stem_map_at_the_domains_edges():
    """Sites at coordinates 0-1 and 4094-4095 of every axis, in two
    scenes: no neighbour wraps across the domain or into another scene."""
    from occuseg_tpu_torch.core import coords as C
    rng = np.random.default_rng(0)
    edge = np.array([0, 1, 2, 4093, 4094, 4095])
    pts = np.stack([rng.integers(0, 2, 400), rng.choice(edge, 400),
                    rng.choice(edge, 400), rng.choice(edge, 400)], axis=1)
    pts = np.unique(pts, axis=0).astype(np.int32)
    keys = C.pack(torch.as_tensor(pts)).sort().values
    keys = torch.cat([keys, torch.full((512 - keys.shape[0],), C.KEY_PAD)])
    coords = C.unpack(keys).numpy()
    want = _brute_map(coords, np.nonzero(coords[:, 0] >= 0)[0], 5)
    assert (want >= 0).sum() > 2 * (coords[:, 0] >= 0).sum()
    assert np.array_equal(stencil_map_kn(keys, 5).t().numpy(), want)


def test_the_device_planner_carries_the_stem_stencil():
    b = _batch(seed=6, ns=1)
    dplan = build_plan(torch.as_tensor(b["coords"]),
                       PlanSpec(caps=CAPS, stem_kernel=5))
    lvl = dplan.levels[0]
    assert lvl.stem_kernel == 5
    real = np.nonzero(lvl.coords.numpy()[:, 0] >= 0)[0]
    want = _brute_map(lvl.coords.numpy(), real, 5)
    assert np.array_equal(lvl.stencil_map(125, "cpu").t().numpy(), want)


def test_the_stem_stencil_leaves_the_plan_as_it_was():
    """occuseg-m64's spec (3^3 maps, the derived fast path, the blocked
    layout, chunk rulebooks, point layout): the same plan with and without
    a stem stencil, and the JAX package's host plan."""
    b = _batch(seed=7, ns=2)
    caps = (6144, 6144, 3072, 3072, 3072, 3072)
    plain = plan_scene(b["coords"], PlanSpec(caps=caps), 2)
    two = plan_scene(b["coords"], PlanSpec(caps=caps, stem_kernel=5), 2)
    jp = jax_plan_blocked(b["coords"], JaxPlanSpec(caps=caps), 2)
    for lp, lt, lj in zip(plain.levels, two.levels, jp.levels):
        for f in ("keys", "coords", "nbr"):
            assert np.array_equal(getattr(lp, f), getattr(lt, f)), f
            assert np.array_equal(getattr(lp, f), np.asarray(getattr(lj, f)))
        assert np.array_equal(lp.num_active, lt.num_active)
        assert np.array_equal(lp.chunks.in_idx, lt.chunks.in_idx)
        assert np.array_equal(lp.chunks.lidx, lt.chunks.lidx)
    for tp, tt in zip(plain.transitions, two.transitions):
        for f in ("child", "up"):
            assert np.array_equal(getattr(tp, f), getattr(tt, f)), f
        assert np.array_equal(tp.child_chunks.lidx, tt.child_chunks.lidx)
        assert np.array_equal(tp.up_chunks.lidx, tt.up_chunks.lidx)
    for f in ("p2v", "vox_seg", "vox_counts", "point_perm"):
        assert np.array_equal(getattr(plain, f), getattr(two, f)), f
    assert plain.chunk_tier == two.chunk_tier


def test_per_map_escalation_grows_only_the_maps_that_overflow():
    """`PlanSpec(chunk_escalation="map")`: each map's rulebook is
    `build_chunk_arrays` at the first tier whose budget holds it, the
    others stay at 1.0; budgets small enough that some maps escalate."""
    from occuseg_tpu_torch.ops.kernels import chunk_conv as cc
    b = _batch(seed=9, ns=2)
    plan = plan_scene(b["coords"], PlanSpec(caps=CAPS), 2, chunks=False)
    # budgets under some maps' needs (at this batch L0-L2 need 177, 216,
    # 208 rows a chunk, the child maps 226 and 302, the up maps 111, 78)
    U, Uc, Uu, tiers = (192, 160, 160), (256, 192), 96, (1.0, 1.3, 1.7)
    before = snapshot()["spans"].get("plan.chunk_try", {"count": 0})
    got = cc.augment_plan_with_chunks(plan, U=U, U_child=Uc, U_up=Uu,
                                      per_map=True)
    tries = (snapshot()["spans"]["plan.chunk_try"]["count"]
             - before["count"])

    def want(table, u):
        for f in tiers:
            arrs = cc.build_chunk_arrays(np.asarray(table), 128,
                                         cc._scale1(u, f))
            if arrs is not None:
                return f, arrs
        return None, None

    def same(chunks, arrs):
        if arrs is None:     # past the last tier: the gather path
            return chunks is None
        return (np.array_equal(chunks.in_idx, arrs[0])
                and np.array_equal(chunks.lidx, arrs[1]))

    tiers_seen = []
    for li, lvl in enumerate(got.levels):
        f, arrs = want(plan.levels[li].nbr, U[li])
        tiers_seen.append(f)
        assert same(lvl.chunks, arrs), li
    for ti, tr in enumerate(got.transitions):
        (fc, c), (fu, u) = (want(plan.transitions[ti].child, Uc[ti]),
                            want(plan.transitions[ti].up, Uu))
        tiers_seen += [fc, fu]
        both = c is not None and u is not None
        assert same(tr.child_chunks, c if both else None), ti
        assert same(tr.up_chunks, u if both else None), ti
    assert sorted(set(tiers_seen)) == [1.0, 1.3, 1.7]
    assert got.chunk_tier == "L1x1.30,L2x1.30,T0ux1.30,T1cx1.70"
    # the first pass over every map, then one try a map rebuilt at a tier
    # (T1c at 1.3 and 1.7)
    assert tries == 1 + 5
    # the spec's rule reaches the plan through plan_scene
    via = plan_scene(b["coords"], PlanSpec(caps=CAPS,
                                           chunk_escalation="map"), 2)
    direct = cc.augment_plan_with_chunks(plan, per_map=True)
    assert via.chunk_tier == direct.chunk_tier
    for lv, ld in zip(via.levels, direct.levels):
        assert np.array_equal(lv.chunks.lidx, ld.chunks.lidx)


def test_minkunet34c_has_the_published_parameter_count():
    m = MinkUNet34C()
    assert sum(p.numel() for p in m.parameters()) == 37_856_052
    assert m.stem.weight.shape == (125, 3, 32)
    assert m.final.bias is not None
    assert sum(p.numel() for n, p in m.named_parameters()
               if n.endswith("bias") and "bn" not in n) == 20


def test_a_convolution_without_its_map_raises():
    b = _batch(seed=8, ns=1)
    laid, plan = prepare_batch(b, PlanSpec(caps=CAPS), 1)
    with pytest.raises(ValueError, match="kernel volume 125"):
        _model(torch.float32)(torch.as_tensor(laid["features"]),
                              plan.to("cpu"))


def test_the_cli_trains_and_evaluates_minkunet(tmp_path, monkeypatch):
    """`--arch minkunet34c` through `train.loop.train` (PlanPool, the
    semantic step, SGD, a checkpoint) and `evaluate_semantic`, with the
    preset narrowed to the test's stages."""
    from occuseg_tpu_torch.train.config import args_to_config, get_parser
    from occuseg_tpu_torch.train.loop import evaluate_semantic, train
    for k in ("init_dim", "layers", "planes"):
        monkeypatch.setitem(minkunet.MINKUNET34C, k, CFG[k])
    config = args_to_config(get_parser().parse_args([
        "--arch", "minkunet34c", "--scale", "20", "--batch_size", "2",
        "--optim", "SGD", "--lr", "0.1", "--voxel_cap", "24576",
        "--point_cap", "49152", "--plan_workers", "2", "--max_epoch", "1",
        "--data_dir", str(tmp_path / "none"),
        "--checkpoints_dir", str(tmp_path)]))
    assert config["unet_structure"] == [8, 16, 24]
    out = train(config, max_steps=2, device="cpu")
    assert isinstance(out["model"], MinkUNet)
    assert out["spec"].stem_kernel == 5
    assert set(out["losses"]) == {"semantic_loss", "total"}
    assert np.isfinite(out["losses"]["total"])
    assert out["trainer"].optimizer.__class__.__name__ == "SGD"
    metrics = evaluate_semantic(config, out["trainer"], out["spec"])
    assert 0.0 <= metrics["mean_iou"] <= 1.0
