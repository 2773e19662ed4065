"""The port's spatial shard planner (`occuseg_tpu_torch/parallel/spatial.py`,
`spatial_model.build_spatial_topology`) against the JAX package's, in one
process on the CPU, exact:

* `shard_plan` (the active-balanced layouts, every level's sharded map,
  send and publish lists, every transition's child and up maps and
  theirs), `transpose_ext_map` of every map and `build_spatial_topology`
  (each shard's keys, coords, active counts, maps, exchanges and their
  transposes, the per-shard chunk rulebooks, `in_idx` and `lidx`, the
  point partition `perm`, `point_pos`, `slot_valid`, the local `p2v` and
  point counts) on `tests/test_spatial_unet.py`'s scene (3000 points,
  extent 48) at D = 2, 4 and 8;
* `shard_level` (+-1-shard halos, no pool) on `tests/test_spatial.py`'s
  level at D = 2, 4 and 8;
* a small halo that spills into the pool, and budgets so small that
  references are dropped (the count equals JAX's; the port's
  `build_spatial_topology` raises where the JAX one asserts);
* `rank_device` follows torchrun's LOCAL_RANK, and ranks that share a card
  join over gloo;
* the sharded losses refuse the semantic losses JAX does not shard, and
  the loop's `--spatial_shards` options: the group's size, the refusal
  with `--num_devices` > 1, the warning under `--use_normal`.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from occuseg_tpu.core import topology as JT
from occuseg_tpu.core.topology import PlanSpec as JaxPlanSpec
from occuseg_tpu.data.synthetic import SceneConfig, make_batch
from occuseg_tpu.parallel import spatial as jax_spatial
from occuseg_tpu.parallel import spatial_model as jax_spatial_model
from tests.jax_planner import host_plan as jax_host_plan
from tests.utils import random_points

from occuseg_tpu_torch.core.topology import PlanSpec
from occuseg_tpu_torch.native.plan import build_plan_host
from occuseg_tpu_torch.parallel import data_parallel as dp
from occuseg_tpu_torch.parallel import spatial, spatial_model

CAPS = (4096, 4096, 2048)
HALO = POOL = 256


def _scene_plans():
    batch = make_batch(SceneConfig(num_points=3000, extent=48,
                                   num_objects=6), 1, 4096, 16, seed=0)
    jp = jax_host_plan(batch["coords"], JaxPlanSpec(caps=CAPS))
    tp = build_plan_host(batch["coords"], PlanSpec(caps=CAPS))
    return jp, tp


@pytest.fixture(scope="module")
def plans():
    return _scene_plans()


def _eq(got, want, what):
    want = np.asarray(want)
    got = np.asarray(got)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert np.array_equal(got, want), what


def _same_sharded_plan(a, b):
    assert (a.num_shards, a.halo, a.dropped) == (b.num_shards, b.halo,
                                                 b.dropped)
    for (n2o, o2n), (jn2o, jo2n) in zip(a.layouts, b.layouts):
        _eq(n2o, jn2o, "new_to_old")
        _eq(o2n, jo2n, "old_to_new")
    assert len(a.levels) == len(b.levels)
    for li, (x, y) in enumerate(zip(a.levels, b.levels)):
        for f in ("nbr_local", "send_left", "send_right", "publish",
                  "shard_rows"):
            _eq(getattr(x, f), getattr(y, f), f"level {li} {f}")
        assert (x.num_shards, x.halo, x.pool) == (y.num_shards, y.halo,
                                                  y.pool)
    assert len(a.transitions) == len(b.transitions)
    for ti, (x, y) in enumerate(zip(a.transitions, b.transitions)):
        assert x.keys() == y.keys()
        for k in x:
            _eq(x[k], y[k], f"transition {ti} {k}")


@pytest.mark.parametrize("D", [2, 4, 8])
def test_shard_plan_and_transposes_match_jax(plans, D):
    jp, tp = plans
    got = spatial.shard_plan(tp, D, HALO, pool=POOL)
    want = jax_spatial.shard_plan(jp, D, HALO, pool=POOL)
    _same_sharded_plan(got, want)
    assert got.dropped == 0
    for li, lvl in enumerate(got.levels):
        S = lvl.nbr_local.shape[1]
        ext = S + 2 * HALO + D * POOL
        _eq(spatial.transpose_ext_map(lvl.nbr_local, ext),
            jax_spatial.transpose_ext_map(want.levels[li].nbr_local, ext),
            f"level {li} transpose")
    for ti, tr in enumerate(got.transitions):
        for name, src in (("child", ti), ("up", ti + 1)):
            ext = got.levels[src].nbr_local.shape[1] + 2 * HALO + D * POOL
            _eq(spatial.transpose_ext_map(tr[name], ext),
                jax_spatial.transpose_ext_map(want.transitions[ti][name],
                                              ext),
                f"transition {ti} {name} transpose")


def _same_exchange(ex, jex, d, what):
    for f in ("send_left", "send_right", "publish", "nbr_t"):
        _eq(getattr(ex, f), getattr(jex, f)[d], f"{what} {f}")
    assert ex.halo == jex.halo
    _same_chunks(ex.chunks_t, jex.chunks_t, d, f"{what} chunks_t")
    # the rows an exchange carries: the longest filled prefix of each list
    for n, f in zip(ex.sent, ("send_left", "send_right", "publish")):
        a = np.asarray(getattr(jex, f))
        assert n == int((a >= 0).sum(1).max())
        assert (a[:, n:] < 0).all(), f"{what} {f} is not a prefix"


def _same_chunks(c, jc, d, what):
    assert (c is None) == (jc is None), what
    if c is not None:
        _eq(c.in_idx, jc.in_idx[d], f"{what} in_idx")
        _eq(c.lidx, jc.lidx[d], f"{what} lidx")


@pytest.mark.parametrize("D", [2, 4, 8])
def test_build_spatial_topology_matches_jax(plans, D):
    jp, tp = plans
    topos, perm, pos, sv = spatial_model.build_spatial_topology(
        tp, D, HALO, POOL)
    jt, jperm, jpos, jsv = jax_spatial_model.build_spatial_topology(
        jp, D, HALO, POOL)
    _eq(perm, jperm, "perm")
    _eq(pos, jpos, "point_pos")
    _eq(sv, jsv, "slot_valid")
    assert len(topos) == D
    n_rulebooks = 0
    for d, t in enumerate(topos):
        assert t.group is None
        _eq(t.p2v, jt.p2v[d], f"shard {d} p2v")
        assert t.num_points == int(jt.num_points[d])
        # the points per voxel the InputLayer's mean divides by
        p2v = np.asarray(t.p2v)
        _eq(t.vox_counts, np.bincount(p2v[p2v >= 0], minlength=t.levels[
            0].cap).astype(np.float32), f"shard {d} vox_counts")
        for li, (lv, jl) in enumerate(zip(t.levels, jt.levels)):
            what = f"shard {d} level {li}"
            _eq(lv.keys, jl.keys[d], f"{what} keys")
            _eq(lv.coords, jl.coords[d], f"{what} coords")
            _eq(lv.nbr, jl.nbr[d], f"{what} nbr")
            assert lv.num_active == int(jl.num_active[d]), what
            assert lv.orient is None and not lv.guided
            _same_chunks(lv.chunks, jl.chunks, d, f"{what} chunks")
            _same_exchange(lv.halo_ex, jl.halo_ex, d, what)
            n_rulebooks += lv.chunks is not None
        for ti, (tr, jtr) in enumerate(zip(t.transitions, jt.transitions)):
            what = f"shard {d} transition {ti}"
            _eq(tr.child, jtr.child[d], f"{what} child")
            _eq(tr.up, jtr.up[d], f"{what} up")
            _same_chunks(tr.child_chunks, jtr.child_chunks, d,
                         f"{what} child_chunks")
            _same_chunks(tr.up_chunks, jtr.up_chunks, d, f"{what} up_chunks")
            _same_exchange(tr.child_ex, jtr.child_ex, d, f"{what} child")
            _same_exchange(tr.up_ex, jtr.up_ex, d, f"{what} up")
            n_rulebooks += (tr.child_chunks is not None) \
                + (tr.up_chunks is not None)
    assert n_rulebooks > 0   # the rulebook route is exercised


def _spatial_level(seed=0, cap=1024):
    """`tests/test_spatial.py`'s level: 700 random points, extent 24."""
    rng = np.random.default_rng(seed)
    pts = random_points(rng, 700, extent=24, batch_size=1, pad_to=cap)
    keys, _ = JT.voxelize_coords(jnp.asarray(pts), cap)
    lvl = JT.build_level(keys, kernel=3)
    return np.asarray(lvl.nbr), int(lvl.num_active)


@pytest.mark.parametrize("D", [2, 4, 8])
def test_shard_level_matches_jax(D):
    nbr, n = _spatial_level()
    got, dropped = spatial.shard_level(nbr, n, D, HALO)
    want, jdropped = jax_spatial.shard_level(nbr, n, D, HALO)
    assert dropped == jdropped
    for f in ("nbr_local", "send_left", "send_right", "publish",
              "shard_rows"):
        _eq(getattr(got, f), getattr(want, f), f)


def test_small_halo_spills_into_the_pool(plans):
    jp, tp = plans
    got = spatial.shard_plan(tp, 4, 16, pool=1024)
    want = jax_spatial.shard_plan(jp, 4, 16, pool=1024)
    _same_sharded_plan(got, want)
    assert got.dropped == 0
    assert max(int((lv.publish >= 0).sum()) for lv in got.levels) > 0
    topos = spatial_model.build_spatial_topology(tp, 4, 16, 1024)[0]
    assert max(t.levels[0].halo_ex.sent[2] for t in topos) > 0


def test_dropped_references_are_counted_and_refused(plans):
    jp, tp = plans
    got = spatial.shard_plan(tp, 4, 4, pool=4)
    want = jax_spatial.shard_plan(jp, 4, 4, pool=4)
    _same_sharded_plan(got, want)
    assert got.dropped == want.dropped > 0
    with pytest.raises(ValueError, match=f"dropped {got.dropped} refs"):
        spatial_model.build_spatial_topology(tp, 4, 4, 4)
    with pytest.raises(AssertionError, match="dropped"):
        jax_spatial_model.build_spatial_topology(jp, 4, 4, 4)


def test_rank_device_follows_local_rank(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.delenv("LOCAL_RANK", raising=False)
    assert dp.rank_device("cuda", 3) == torch.device("cuda", 1)
    # under torchrun the global rank names no card once the ranks span
    # hosts: rank 5 of a host's ranks 4-5 is its local rank 1
    monkeypatch.setenv("LOCAL_RANK", "1")
    assert dp.rank_device("cuda", 4) == torch.device("cuda", 1)
    monkeypatch.setenv("LOCAL_RANK", "0")
    assert dp.rank_device("cuda", 5) == torch.device("cuda", 0)
    # a named card, or the CPU, as it is
    assert dp.rank_device("cuda:1", 0) == torch.device("cuda", 1)
    assert dp.rank_device("cpu", 1) == torch.device("cpu")
    # ranks sharing a card join over gloo (NCCL refuses two on one card)
    assert dp.shared_card_backend("cuda", 2) is None
    assert dp.shared_card_backend("cuda", 3) == "gloo"
    assert dp.shared_card_backend("cuda:0", 2) == "gloo"
    assert dp.shared_card_backend("cuda", 1) is None
    assert dp.shared_card_backend("cpu", 2) is None


def test_sharded_losses_refuse_what_is_not_sharded():
    """Only the cross entropy is a sharded semantic loss
    (`occuseg_tpu/losses/instance.py:473-477`): the others raise under a
    group before any collective."""
    from occuseg_tpu_torch.losses.instance import LossConfig, _semantic_term
    logits, labels = torch.zeros(8, 4), torch.zeros(8, dtype=torch.long)
    for kind in ("lovasz", "focal", "weighted_cross_entropy"):
        _semantic_term(logits, labels, LossConfig(semantic_loss=kind))
        with pytest.raises(NotImplementedError, match="spatial sharding"):
            _semantic_term(logits, labels, LossConfig(semantic_loss=kind),
                           group=object())


def test_spatial_loop_options(caplog):
    """`--spatial_shards` D: the PlanPool's options on a rank of a D-rank
    group; a group of another size raises, and so does --num_devices > 1;
    under --use_normal one warning says the filters stay the identity
    (the JAX package's sharded plan carries no orientation classes)."""
    from occuseg_tpu_torch.train import loop
    base = {"spatial_shards": 2, "spatial_halo": 64, "spatial_pool": 32}
    assert loop._spatial({"spatial_shards": 0}, 0, 1) is None
    assert loop._spatial(base, 1, 2) == dict(num_shards=2, halo=64, pool=32,
                                             rank=1)
    with pytest.raises(ValueError, match="2-rank process group"):
        loop._spatial(base, 0, 1)
    with pytest.raises(ValueError, match="do not combine"):
        loop._spatial(dict(base, num_devices=2), 0, 2)
    with caplog.at_level("WARNING", logger="occuseg_tpu_torch"):
        loop._spatial(dict(base, use_normal=True), 0, 2)
    assert "identity filters" in caplog.text
