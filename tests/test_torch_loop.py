"""The port's training CLI pieces against the JAX package on the CPU.

Each against its JAX counterpart, exact unless stated: the cap buckets and
their choices, each bucket the base spec at its caps; checkpoint
retention; the CLI's flags and defaults; each architecture's widths, plan
fields and model (`models.ARCHS`, the occuseg spec equal to JAX's);
`plan_muladd_count`, `confusion_matrix` and `iou_from_confusion`;
`drift_loss` and its gradient (f32, rtol 1e-5); `plan_prefetcher`'s
batches and blocked plans for the same rng. Then the port alone:
`accum_steps=2` makes one update equal to one step on the mean gradient
(f32, 1e-6); a checkpoint round trip; `PlanPool` yields what the
sequential preparation gives, in order, at one spec and over cap
buckets; `PlanPool(threads=)` sizes its
workers' OpenMP teams, and ranks sharing a host share its cores
(`data_parallel.share_cores`, which `train` hands its pool);
`train(config, max_steps=2)` at
m=8 on the CPU, and a resume from its checkpoint; the same two steps
with --chunk_conv 0 (no chunk rulebook, the gather path) against the
chunked run; and no module of the port imports jax or the JAX package.
"""

import ast
import copy
import dataclasses
import os
import pathlib
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from occuseg_tpu.core.topology import PlanSpec as JaxPlanSpec
from occuseg_tpu.data.synthetic import SceneConfig, make_batch
from occuseg_tpu.losses.instance import drift_loss as jax_drift_loss
from occuseg_tpu.train import bucketing as jax_bucketing
from occuseg_tpu.train import checkpoint as jax_ckpt
from occuseg_tpu.train import config as jax_config
from occuseg_tpu.train import loop as jax_loop
from occuseg_tpu.utils import metrics as jax_metrics
from occuseg_tpu.utils import profiling as jax_profiling

import occuseg_tpu_torch
from occuseg_tpu_torch.core.topology import PlanSpec
from occuseg_tpu_torch.losses.instance import drift_loss
from occuseg_tpu_torch.models import ARCHS, LearningBWDenseUNet, MinkUNet
from occuseg_tpu_torch.models import minkunet
from occuseg_tpu_torch.native.blocked import build_plan_host_blocked
from occuseg_tpu_torch.native.pool import PlanPool
from occuseg_tpu_torch.train import bucketing, checkpoint, config, loop, state
from occuseg_tpu_torch.utils import metrics, profiling
from tests.jax_planner import heal, host_plan

torch.set_num_threads(2)

SCENE = SceneConfig(num_points=2500, extent=96, num_objects=6)


def _flags(tmp_path, *extra):
    return ["--m", "8", "--batch_size", "2", "--scale", "50",
            "--residual_blocks", "--use_dense_model", "--max_epoch", "1",
            "--point_cap", "8192", "--voxel_cap", "6144",
            "--instance_cap", "16", "--checkpoints_dir", str(tmp_path),
            "--data_dir", str(tmp_path / "no_scenes"), *extra]


def _small_config(tmp_path, *extra):
    c = config.args_to_config(config.get_parser().parse_args(
        _flags(tmp_path, *extra)))
    c["unet_structure"] = [8, 16, 24]   # a small UNet for the CPU
    return c


# the port's own flags, which the JAX CLI lacks: the architecture
PORT_FLAGS = {"arch": (("--arch",), "occuseg", "_StoreAction")}


def test_flags_and_defaults_match_jax():
    def actions(parser):
        return {a.dest: (tuple(a.option_strings), a.default, type(a).__name__)
                for a in parser._actions if a.dest != "help"}
    port = actions(config.get_parser())
    assert {k: port.pop(k) for k in PORT_FLAGS} == PORT_FLAGS
    assert port == actions(jax_config.get_parser())
    argv = ["--m", "32", "--use_feature", "cd", "--dataset", "stanford3d"]
    cfg = config.args_to_config(config.get_parser().parse_args(argv))
    assert cfg.pop("arch") == "occuseg"
    assert cfg == \
        jax_config.args_to_config(jax_config.get_parser().parse_args(argv))
    for vc in (4096, 6144, 262144):
        cfg = {"voxel_cap": vc, "unet_structure": [1] * 6}
        assert config.plan_caps(cfg) == jax_config.plan_caps(cfg)


def test_bucket_choices_match_jax():
    jb = jax_bucketing.bucket_specs(16384, 3, 3)
    tb = bucketing.bucket_specs(16384, 3, 3)
    assert [s.caps for s in tb] == [s.caps for s in jb]
    heal()
    for seed, ns, pts in ((0, 1, 1500), (1, 1, 6000), (2, 2, 2500)):
        b = make_batch(SceneConfig(num_points=pts, extent=96, num_objects=6),
                       num_scenes=ns, p_cap=16384, num_instances=8,
                       seed=seed)
        assert bucketing.count_voxels(b["coords"]) == \
            jax_bucketing.count_voxels(b["coords"])
        assert bucketing.pick_bucket(tb, b["coords"]) == \
            jax_bucketing.pick_bucket(jb, b["coords"])
        ji, jp = jax_bucketing.plan_for_batch(jb, b["coords"], ns=ns)
        ti, tp = bucketing.plan_for_batch(tb, b["coords"], ns=ns)
        assert ti == ji and jp is not None
        for lj, lt in zip(jp.levels, tp.levels):
            assert np.array_equal(np.asarray(lj.nbr), lt.nbr)
            assert np.array_equal(np.asarray(lj.num_active), lt.num_active)


@pytest.mark.parametrize("arch", ["occuseg", "minkunet34c"])
def test_bucket_specs_carry_every_field_of_the_base_spec(arch):
    """`bucket_specs(..., spec)`: each bucket is the base spec at its own
    caps (JAX's caps), every other field kept: the architecture's plan
    fields, the stencil, the guide levels and a non-default dilation."""
    cfg = config.args_to_config(config.get_parser().parse_args(
        ["--arch", arch, "--voxel_cap", "16384"]))
    base = dataclasses.replace(loop.build_spec(cfg), kernel=5, dilation=2,
                               guide_levels=2)
    tb = bucketing.bucket_specs(16384, len(base.caps), 3, base)
    jb = jax_bucketing.bucket_specs(16384, len(base.caps), 3)
    assert [s.caps for s in tb] == [s.caps for s in jb]
    for s in tb:
        assert dataclasses.replace(s, caps=base.caps) == base
    assert (base.stem_kernel, base.chunk_escalation) == (
        (5, "map") if arch == "minkunet34c" else (None, "plan"))


# each architecture's flags, model class, widths and plan fields
ARCH_CASES = {
    "occuseg": (["--m", "8", "--use_dense_model"], LearningBWDenseUNet,
                [8, 16, 24, 32, 40, 48],
                dict(stem_kernel=None, chunk_escalation="plan")),
    "minkunet34c": ([], MinkUNet, [32, 32, 64, 128, 256],
                    dict(stem_kernel=5, chunk_escalation="map")),
}


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_architecture_table_entry(arch, monkeypatch):
    """`models.ARCHS[arch]` through `args_to_config`, `build_spec` and
    `build_model`: the widths, the plan's fields and the model class each
    architecture had; the entries read `MINKUNET34C` when called (a
    narrowed preset, as the benchmark's tests narrow it, gives its
    widths and a small model)."""
    flags, cls, widths, fields = ARCH_CASES[arch]

    def cfg():
        return config.args_to_config(config.get_parser().parse_args(
            ["--arch", arch, *flags]))
    assert cfg()["unet_structure"] == widths
    spec = loop.build_spec(cfg())
    assert spec.caps == tuple(config.plan_caps(cfg()))
    assert {k: getattr(spec, k) for k in fields} == fields
    monkeypatch.setitem(minkunet.MINKUNET34C, "init_dim", 8)
    monkeypatch.setitem(minkunet.MINKUNET34C, "layers", (1,) * 8)
    monkeypatch.setitem(minkunet.MINKUNET34C, "planes", (8, 16) * 4)
    if arch == "minkunet34c":
        widths = [8, 8, 16, 8, 16]
    assert cfg()["unet_structure"] == widths
    assert type(loop.build_model(cfg())) is cls


def test_gc_keeps_the_same_steps(tmp_path):
    steps = [1, 2, 3, 5, 6, 8, 12, 16, 63, 64, 65, 100, 128, 129, 130]
    jdir, tdir = tmp_path / "jax", tmp_path / "torch"
    for s in steps:
        os.makedirs(jdir / f"step_{s}")
        checkpoint.save_checkpoint(str(tdir), {"s": s}, step=s)
    jax_ckpt.gc_checkpoints(str(jdir))
    checkpoint.gc_checkpoints(str(tdir))
    kept = sorted(int(d[5:]) for d in os.listdir(jdir))
    assert sorted(int(f[5:-4]) for f in os.listdir(tdir)) == kept
    assert kept == [1, 2, 8, 16, 64, 128, 130]
    assert checkpoint.latest_checkpoint(str(tdir)).endswith("step_130.pth")
    assert checkpoint.latest_checkpoint(str(tmp_path / "none")) is None


def test_muladd_and_metrics_match_jax():
    b = make_batch(SCENE, num_scenes=2, p_cap=8192, num_instances=8, seed=3)
    jp = host_plan(b["coords"], JaxPlanSpec(caps=(6144, 4096, 2048)))
    tp = build_plan_host_blocked(b["coords"], PlanSpec(caps=(6144, 4096,
                                                             2048)), 1)
    for planes, reps, res in (((8, 16, 24), 1, True), ((16, 32, 48), 2,
                                                       False)):
        assert profiling.plan_muladd_count(tp, planes, reps, res) == \
            jax_profiling.plan_muladd_count(jp, planes, reps, res)
        assert profiling.plan_hidden_count(tp, planes) == \
            jax_profiling.plan_hidden_count(jp, planes)
    rng = np.random.default_rng(0)
    gt = rng.integers(-1, 22, 5000).astype(np.int32)
    pred = rng.integers(-2, 22, 5000).astype(np.int32)
    conf = metrics.confusion_matrix(torch.from_numpy(pred),
                                    torch.from_numpy(gt), 20)
    jconf = np.asarray(jax_metrics.confusion_matrix(
        jnp.asarray(pred), jnp.asarray(gt), num_classes=20))
    assert np.array_equal(conf.numpy(), jconf)
    got, want = (metrics.iou_from_confusion(conf.numpy()),
                 jax_metrics.iou_from_confusion(jconf))
    np.testing.assert_array_equal(got["iou_per_class"], want["iou_per_class"])
    assert got["mean_iou"] == want["mean_iou"]
    assert got["accuracy"] == want["accuracy"]
    assert metrics.print_iou_table(jconf) == jax_metrics.print_iou_table(jconf)


def test_drift_loss_matches_jax():
    rng = np.random.default_rng(4)
    P, I, S = 600, 12, 2
    iid = rng.integers(-1, I, P).astype(np.int32)
    args = dict(embedding=rng.normal(0, 1, (P, 16)),
                regressed_pose=rng.normal(0, 2, (P, 3)),
                pose=rng.normal(0, 2, (P, 3)),
                offset_pred=rng.uniform(0, 1, (P, 1)))
    ids = dict(instance_id=iid, labels=rng.integers(0, 20, P),
               point_scene=np.arange(P) * S // P)
    j = {k: jnp.asarray(v, jnp.float32) for k, v in args.items()}
    ji = {k: jnp.asarray(v, jnp.int32) for k, v in ids.items()}

    def f(e, rp):
        return jax_drift_loss(e, rp, j["pose"], j["offset_pred"],
                              ji["instance_id"], ji["labels"],
                              ji["point_scene"], S, I)
    want, (ge, grp) = jax.jit(jax.value_and_grad(f, argnums=(0, 1)))(
        j["embedding"], j["regressed_pose"])
    t = {k: torch.tensor(v, dtype=torch.float32) for k, v in args.items()}
    ti = {k: torch.tensor(v) for k, v in ids.items()}
    e = t["embedding"].requires_grad_()
    rp = t["regressed_pose"].requires_grad_()
    got = drift_loss(e, rp, t["pose"], t["offset_pred"], ti["instance_id"],
                     ti["labels"], ti["point_scene"], S, I)
    got.backward()
    assert float(want) > 0
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    for a, b in ((e.grad, ge), (rp.grad, grp)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-5 * np.abs(np.asarray(b)).max())


def test_plan_prefetcher_matches_jax(tmp_path):
    cfg = _small_config(tmp_path)
    spec_j = jax_loop.build_spec(cfg)
    spec_t = loop.build_spec(cfg)
    assert dataclasses.replace(spec_t, stem_kernel=None) == PlanSpec(
        **dataclasses.asdict(spec_j))
    assert spec_t.stem_kernel is None
    heal()
    n = 2

    def batches(synth):
        it = synth.train_batches(np.random.default_rng(100),
                                 cfg["point_cap"], cfg["instance_cap"], 2)
        return [next(it) for _ in range(n)]
    jb = batches(jax_loop._synthetic_dataset(cfg))
    tb = batches(loop._synthetic_dataset(cfg))
    got = list(loop.plan_prefetcher(tb, spec_t, ns=2))
    want = list(jax_loop.plan_prefetcher(jb, spec_j, chunks=True, ns=2))
    assert len(got) == len(want) == n
    for (bt, pt, it), (bj, pj, ij) in zip(got, want):
        assert it == ij == 0
        assert pt.vox_seg is not None and pj.vox_seg is not None
        assert np.array_equal(pt.point_perm, np.asarray(pj.point_perm))
        for li, (lj, lt) in enumerate(zip(pj.levels, pt.levels)):
            assert np.array_equal(np.asarray(lj.nbr), lt.nbr)
            assert np.array_equal(np.asarray(lj.num_active), lt.num_active)
            assert np.array_equal(np.asarray(lj.chunks.lidx), lt.chunks.lidx)
        pad = pt.point_perm < 0
        for k in bj:
            if k == "point_scene":  # pad slots: ns here, -1 in the JAX loop
                assert (bt[k][pad] == 2).all() and (bj[k][pad] == -1).all()
                assert np.array_equal(bt[k][~pad], bj[k][~pad])
            else:
                assert np.array_equal(bt[k], bj[k]), k


@pytest.mark.parametrize("num_buckets", [1, 3])
def test_plan_pool_yields_in_order(tmp_path, num_buckets):
    """`PlanPool` yields what the sequential preparation gives, batch for
    batch, at one spec and over a list of 3 cap buckets (each bucket
    picked once or more)."""
    cfg = _small_config(tmp_path)
    spec = loop.build_spec(cfg)
    buckets = None if num_buckets == 1 else bucketing.bucket_specs(
        cfg["voxel_cap"], len(spec.caps), num_buckets, spec)
    bs = [make_batch(SceneConfig(num_points=pts, extent=96, num_objects=6),
                     2, cfg["point_cap"], 16, seed=s)
          for s, pts in enumerate((300, 1200, 600, 1800))]
    with PlanPool(spec, 3, bucket_specs_list=buckets, ns=2) as pool:
        got = list(pool.imap(iter(bs)))
    assert len(got) == 4
    picked = set()
    for b, (laid, plan, bi) in zip(bs, got):
        if buckets is None:
            (want_b, want_p), want_i = state.prepare_batch(b, spec, 2), 0
        else:
            want_b, want_p, want_i = state.prepare_batch(b, buckets, 2)
        picked.add(bi)
        assert bi == want_i
        assert np.array_equal(plan.point_perm, want_p.point_perm)
        assert np.array_equal(plan.chunk_tier, want_p.chunk_tier)
        for lg, lw in zip(plan.levels, want_p.levels):
            assert np.array_equal(lg.nbr, lw.nbr)
            assert np.array_equal(lg.chunks.lidx, lw.chunks.lidx)
        for k in b:
            assert np.array_equal(laid[k], want_b[k]), k
    assert picked == set(range(num_buckets))


def test_plan_pool_threads_size_each_workers_openmp_team(tmp_path):
    """`PlanPool(threads=n)`: every worker thread's OpenMP loops start
    teams of n (`native.set_threads`), the plans are those of the default
    team, and a pool without `threads` leaves OpenMP's default."""
    from occuseg_tpu_torch import native
    cfg = _small_config(tmp_path)
    spec = loop.build_spec(cfg)
    bs = [make_batch(SCENE, 2, cfg["point_cap"], 16, seed=s)
          for s in range(3)]
    # a new thread's team (this thread's is set by torch.set_num_threads)
    fresh = []
    t = threading.Thread(target=lambda: fresh.append(native.threads()))
    t.start()
    t.join()
    default, mine = fresh[0], native.threads()
    with PlanPool(spec, 2, ns=2) as pool:
        assert {pool._pool.submit(native.threads).result()
                for _ in range(4)} == {default}
        want = list(pool.imap(iter(bs)))
    with PlanPool(spec, 2, ns=2, threads=1) as pool:
        assert pool.threads == 1
        assert {pool._pool.submit(native.threads).result()
                for _ in range(4)} == {1}
        got = list(pool.imap(iter(bs)))
    assert native.threads() == mine   # the caller's thread keeps its own
    for (lw, pw, _), (lg, pg, _) in zip(want, got):
        assert np.array_equal(lw["features"], lg["features"])
        for a, b in zip(pw.levels, pg.levels):
            assert np.array_equal(a.nbr, b.nbr)
            assert np.array_equal(a.chunks.lidx, b.chunks.lidx)


def test_share_cores_splits_the_host_among_its_ranks(monkeypatch):
    """`data_parallel.share_cores`: cores / (ranks on the host x
    workers), at least 1, also the rank's torch threads; the ranks on the
    host are torchrun's LOCAL_WORLD_SIZE where it is set; a lone rank
    keeps its threads (None)."""
    from occuseg_tpu_torch.parallel import data_parallel as dp
    set_to = []
    monkeypatch.setattr(dp.os, "sched_getaffinity", lambda pid: set(
        range(32)), raising=False)
    monkeypatch.setattr(dp.torch, "set_num_threads", set_to.append)
    monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    assert dp.share_cores(4, 1) is None and set_to == []
    assert dp.share_cores(4, 4) == 2 and set_to == [2]
    assert dp.share_cores(3, 2) == 5
    assert dp.share_cores(8, 8) == 1
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    assert dp.share_cores(4, 8) == 4
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "1")
    assert dp.share_cores(4, 8) is None
    assert set_to == [2, 5, 1, 4]


def test_train_gives_its_plan_pool_the_ranks_share(tmp_path, monkeypatch):
    """`train()` as one of 4 ranks builds its PlanPool with
    `share_cores(plan workers, 4)`'s team; alone, with none."""
    from occuseg_tpu_torch.parallel import data_parallel as dp
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    seen = []

    class Stop(Exception):
        pass

    def pool(*a, **k):
        seen.append(k["threads"])
        raise Stop
    monkeypatch.setattr(loop, "PlanPool", pool)
    monkeypatch.setattr(dp, "share_cores", lambda w, n: None if n == 1
                        else 100 * w + n)
    cfg = _small_config(tmp_path, "--plan_workers", "3")
    for ranks in (4, 1):
        monkeypatch.setattr(loop, "_ranks", lambda c, n=ranks: (0, n))
        with pytest.raises(Stop):
            loop.train(cfg, max_steps=1, device="cpu")
    assert seen == [304, None]


def _tiny_trainer(accum):
    model = LearningBWDenseUNet((8, 16), generator=torch.Generator()
                                .manual_seed(1))
    return state.Trainer(model, "cpu", state.TrainConfig(accum_steps=accum),
                         num_instances=8, num_scenes=1)


def test_accum_steps_is_one_update_on_the_mean_gradient():
    spec = PlanSpec(caps=(3072, 2048))
    prep = [state.prepare_batch(make_batch(SCENE, 1, 4096, 8, seed=s), spec)
            for s in (1, 2)]
    acc = _tiny_trainer(2)
    ref = _tiny_trainer(1)
    p0 = {n: p.detach().clone() for n, p in acc.model.named_parameters()}
    stats0 = [b.clone() for b in acc.model.buffers()]
    acc.step(*prep[0])
    for n, p in acc.model.named_parameters():   # no update yet
        assert torch.equal(p, p0[n]), n
    assert not all(torch.equal(a, b) for a, b in
                   zip(acc.model.buffers(), stats0))  # BN stats moved
    acc.step(*prep[1])
    assert acc.steps == 2 and acc.scheduler.last_epoch == 1

    grads = []
    for laid, plan in prep:     # the two gradients at the same weights
        m = copy.deepcopy(ref.model)
        t = state.Trainer(m, "cpu", num_instances=8)
        t.step(laid, plan)
        grads.append([p.grad for p in m.parameters()])
    for p, ga, gb in zip(ref.model.parameters(), *grads):
        p.grad = (ga + gb) / 2
    ref.optimizer.step()
    for (n, a), b in zip(acc.model.named_parameters(),
                         ref.model.parameters()):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   rtol=1e-6, atol=1e-6, err_msg=n)


def test_checkpoint_round_trip(tmp_path):
    spec = PlanSpec(caps=(3072, 2048))
    laid, plan = state.prepare_batch(make_batch(SCENE, 1, 4096, 8, seed=5),
                                     spec)
    t = _tiny_trainer(1)
    t.step(laid, plan)
    path = checkpoint.save_checkpoint(str(tmp_path), t.state_dict(), step=3)
    assert checkpoint.is_checkpoint(path)
    u = _tiny_trainer(1)
    u.load_state_dict(checkpoint.restore_checkpoint(path))
    assert u.steps == 1
    for a, b in zip(t.state_dict()["model"].values(),
                    u.state_dict()["model"].values()):
        assert torch.equal(a, b)
    t.step(laid, plan)
    u.step(laid, plan)
    for a, b in zip(t.model.parameters(), u.model.parameters()):
        assert torch.equal(a, b)


def test_train_two_steps_and_resume(tmp_path, monkeypatch):
    # TensorBoard is optional in the loop; here its import (which pulls in
    # TensorFlow where that is installed) would only cost time
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    cfg = _small_config(tmp_path, "--taskname", "t")
    result = loop.train(cfg, max_steps=2, device="cpu")
    assert result["steps"] == 2 and result["trainer"].steps == 2
    assert all(np.isfinite(v) for v in result["losses"].values())
    assert len(result["timings"]["step_ms"]) == 2
    path = checkpoint.latest_checkpoint(result["ckpt_dir"])
    assert path.endswith("step_1.pth")
    seen = {}
    r2 = loop.train(dict(cfg, load=result["ckpt_dir"], checkpoint=1,
                         max_epoch=2), max_steps=1, device="cpu",
                    on_start=lambda t: seen.update(
                        copy.deepcopy(t.state_dict())))
    saved = checkpoint.restore_checkpoint(path)
    assert seen["steps"] == saved["steps"] == 2
    for k, v in saved["model"].items():
        assert torch.equal(seen["model"][k], v), k
    assert r2["trainer"].steps == 3
    m = loop.evaluate_semantic(cfg, r2["trainer"], r2["spec"])
    assert 0.0 <= m["mean_iou"] <= 1.0


def test_train_with_chunk_conv_0_matches_chunked(tmp_path, monkeypatch):
    """--chunk_conv 0: two steps build no chunk rulebook (every
    convolution takes the gather path) and give the chunked run's loss
    parts within 1e-5 (f32; the same function summed in another order)."""
    from occuseg_tpu_torch.ops.kernels import chunk_conv as cc
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    built = []
    real = cc.augment_plan_with_chunks
    monkeypatch.setattr(cc, "augment_plan_with_chunks",
                        lambda plan, *a, **k: built.append(1) or real(
                            plan, *a, **k))
    runs = {}
    for flag in ("1", "0"):
        built.clear()
        cfg = _small_config(tmp_path, "--taskname", f"c{flag}",
                            "--chunk_conv", flag)
        runs[flag] = loop.train(cfg, max_steps=2, device="cpu")
        assert runs[flag]["steps"] == 2
        assert (len(built) > 0) == (flag == "1")
    a, b = runs["1"]["losses"], runs["0"]["losses"]
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_allclose(b[k], a[k], rtol=1e-5, atol=1e-7,
                                   err_msg=k)


def test_loop_refuses_what_is_not_ported(tmp_path):
    # data parallelism is ported: train() is then one rank of a process
    # group (tests/test_torch_dp.py), which it needs
    with pytest.raises(ValueError, match="2-rank process group"):
        loop.train(_small_config(tmp_path, "--num_devices", "2"),
                   device="cpu")
    # so is spatial sharding: train() is then one shard of a process
    # group of --spatial_shards ranks (tests/test_torch_spatial_model.py)
    with pytest.raises(ValueError, match="4-rank process group"):
        loop.train(_small_config(tmp_path, "--spatial_shards", "4"),
                   device="cpu")
    # scenes are loaded now (tests/test_torch_data.py), and one that
    # cannot be read stops the run instead of falling back to synthetic
    scenes = tmp_path / "data" / "train"
    scenes.mkdir(parents=True)
    (scenes / "scene0000_00.pth").write_bytes(b"")
    with pytest.raises(RuntimeError, match="scene0000_00.pth"):
        loop.get_dataset(_small_config(tmp_path, "--data_dir",
                                       str(tmp_path / "data")))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            loop.train(_small_config(tmp_path))


def test_port_imports_no_jax():
    root = pathlib.Path(occuseg_tpu_torch.__file__).parent
    files = sorted(root.rglob("*.py"))
    assert len(files) > 20
    for f in files:
        for node in ast.walk(ast.parse(f.read_text())):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom)
                     else [])
            for n in names:
                top = n.split(".")[0]
                assert top not in ("jax", "jaxlib", "flax", "optax",
                                   "occuseg_tpu"), f"{f}: imports {n}"
