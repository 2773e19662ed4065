"""Host plans of the PyTorch port (occuseg_tpu_torch) against the JAX
package: every plan array must be bit-identical (np.array_equal) — levels,
transitions, chunk rulebooks (incl. U escalation) and the sorted point
layout — plus the input checks of the port's planner binding."""

import numpy as np
import pytest
import torch

from occuseg_tpu.core.point_layout import (
    apply_point_layout as jax_apply_layout,
    augment_plan_with_point_layout as jax_augment_layout,
)
from occuseg_tpu.core.topology import PlanSpec as JaxPlanSpec
from occuseg_tpu.data.synthetic import SceneConfig, make_batch
from tests.jax_planner import host_plan as jax_build_plan_host
from occuseg_tpu.ops.pallas import chunk_conv as jax_cc

from occuseg_tpu_torch import native
from occuseg_tpu_torch.core.point_layout import (
    apply_point_layout, augment_plan_with_point_layout,
)
from occuseg_tpu_torch.core.topology import PlanSpec, _offsets
from occuseg_tpu_torch.data import synthetic as port_synthetic
from occuseg_tpu_torch.native.plan import build_plan_host
from occuseg_tpu_torch.ops.kernels import chunk_conv as cc

torch.set_num_threads(2)

CAPS = (12_288, 8_192, 4_096, 2_048, 1_024, 512)
P_CAP = 24_576
SCENE = SceneConfig(num_points=12_000, extent=128, num_objects=8)


def _batch(seed):
    return make_batch(SCENE, num_scenes=1, p_cap=P_CAP, num_instances=16,
                      seed=seed)


def _assert_plans_equal(jp, tp):
    assert len(jp.levels) == len(tp.levels)
    for jl, tl in zip(jp.levels, tp.levels):
        for f in ("keys", "coords", "nbr"):
            assert np.array_equal(np.asarray(getattr(jl, f)),
                                  getattr(tl, f)), f
        assert int(jl.num_active) == tl.num_active
    for jt, tt in zip(jp.transitions, tp.transitions):
        assert np.array_equal(np.asarray(jt.child), tt.child)
        assert np.array_equal(np.asarray(jt.up), tt.up)
    assert np.array_equal(np.asarray(jp.p2v), tp.p2v)
    assert int(jp.num_points) == tp.num_points


def _assert_chunks_equal(jp, tp):
    def same(jc, tc):
        if jc is None or tc is None:
            assert jc is None and tc is None
            return
        assert np.array_equal(np.asarray(jc.in_idx), tc.in_idx)
        assert np.array_equal(np.asarray(jc.lidx), tc.lidx)

    for jl, tl in zip(jp.levels, tp.levels):
        same(jl.chunks, tl.chunks)
    for jt, tt in zip(jp.transitions, tp.transitions):
        same(jt.child_chunks, tt.child_chunks)
        same(jt.up_chunks, tt.up_chunks)


def test_synthetic_scene_is_a_copy():
    a = _batch(4)
    b = port_synthetic.make_batch(port_synthetic.SceneConfig(
        num_points=12_000, extent=128, num_objects=8), num_scenes=1,
        p_cap=P_CAP, num_instances=16, seed=4)
    assert a.keys() == b.keys()
    for k in a:
        assert np.array_equal(a[k], b[k]), k


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_plan_chunks_and_layout_match_jax(seed):
    batch = _batch(seed)
    jp = jax_build_plan_host(batch["coords"], JaxPlanSpec(caps=CAPS))
    tp = build_plan_host(batch["coords"], PlanSpec(caps=CAPS))
    _assert_plans_equal(jp, tp)

    jp = jax_cc.augment_plan_with_chunks(jp)
    tp = cc.augment_plan_with_chunks(tp)
    _assert_chunks_equal(jp, tp)
    assert tp.chunk_tier == jax_cc.LAST_TIER
    assert all(l.chunks is not None for l in tp.levels)

    jp = jax_augment_layout(jp)
    tp = augment_plan_with_point_layout(tp)
    assert tp.vox_seg is not None
    for f in ("vox_seg", "vox_counts", "point_perm", "p2v"):
        assert np.array_equal(np.asarray(getattr(jp, f)), getattr(tp, f)), f
    jb = jax_apply_layout(batch, jp, num_scenes=1)
    tb = apply_point_layout(batch, tp, num_scenes=1)
    assert jb.keys() == tb.keys()
    for k in jb:
        assert np.array_equal(jb[k], tb[k]), k


def test_bench_scene_plan_matches_jax():
    """The benchmark's scene and caps (seed 0), end to end."""
    caps = (196_608, 139_264, 63_488, 17_408, 4_096, 1_024)
    batch = make_batch(SceneConfig(num_points=200_000, extent=512,
                                   num_objects=24), num_scenes=1,
                       p_cap=262_144, num_instances=64, seed=0)
    jp = jax_cc.augment_plan_with_chunks(
        jax_build_plan_host(batch["coords"], JaxPlanSpec(caps=caps)))
    tp = cc.augment_plan_with_chunks(
        build_plan_host(batch["coords"], PlanSpec(caps=caps)))
    _assert_plans_equal(jp, tp)
    _assert_chunks_equal(jp, tp)
    jp, tp = jax_augment_layout(jp), augment_plan_with_point_layout(tp)
    for f in ("vox_seg", "vox_counts", "point_perm", "p2v"):
        assert np.array_equal(np.asarray(getattr(jp, f)), getattr(tp, f)), f


def _small_plans():
    batch = make_batch(SceneConfig(num_points=1200, extent=48,
                                   num_objects=5),
                       num_scenes=1, p_cap=2048, num_instances=8, seed=3)
    return (jax_build_plan_host(batch["coords"], JaxPlanSpec(caps=(512, 256))),
            build_plan_host(batch["coords"], PlanSpec(caps=(512, 256))))


@pytest.mark.parametrize("U,tiers,tier", [
    ((96, 160), (1.0, 2.0), "L0x1.30"),  # per-level 1.3 at L0 only
    ((64, 96), (1.0, 2.0), 2.0),         # 1.3 too small: uniform tier 2.0
    ((64, 128), (1.0,), 1.0),            # exhausted: L0 keeps no chunks
])
def test_u_escalation_matches_jax(U, tiers, tier):
    jp, tp = _small_plans()
    kw = dict(M=64, U=U, U_child=256, U_up=128, tiers=tiers)
    ja = jax_cc.augment_plan_with_chunks(jp, **kw)
    ta = cc.augment_plan_with_chunks(tp, **kw)
    _assert_chunks_equal(ja, ta)
    assert ta.chunk_tier == jax_cc.LAST_TIER == tier
    if tiers == (1.0,):
        assert ta.levels[0].chunks is None
        assert ta.levels[1].chunks is not None


def test_plan_to_device_keeps_values():
    _, tp = _small_plans()
    tp = augment_plan_with_point_layout(cc.augment_plan_with_chunks(
        tp, M=64, U=(192, 192), U_child=256, U_up=128))
    dp = tp.to("cpu")
    # the device gets the chunk rulebooks and the point arrays; the maps,
    # keys and coords stay on the host (the model reads only their shapes)
    assert dp.levels[0].nbr is tp.levels[0].nbr
    assert dp.levels[0].keys is tp.levels[0].keys
    assert dp.transitions[0].child is tp.transitions[0].child
    assert dp.levels[0].cap == tp.levels[0].cap
    assert isinstance(dp.levels[1].chunks.in_idx, torch.Tensor)
    assert dp.levels[1].chunks.in_idx.dtype == torch.int32
    for name in ("p2v", "vox_seg", "vox_counts", "point_perm"):
        if getattr(tp, name) is None:   # no layout at this size
            assert getattr(dp, name) is None, name
            continue
        assert isinstance(getattr(dp, name), torch.Tensor), name
        assert np.array_equal(getattr(dp, name).numpy(), getattr(tp, name))
    assert dp.levels[1].num_active == tp.levels[1].num_active
    assert isinstance(dp.levels[1].num_active, int)
    assert np.array_equal(dp.transitions[0].up_chunks.lidx.numpy(),
                          tp.transitions[0].up_chunks.lidx)


def test_build_plan_host_rejects_other_transitions():
    """Only what the JAX package's host planner refuses (it returns None
    there and plans inside jit): nearest-neighbour search and the
    permutohedral lattice. The port's host planner (and its blocked form)
    returns None for both specs, as JAX's does, and the port's device
    planner builds them (`tests/test_torch_planner.py` holds them to the
    JAX in-jit plan). Other transition sizes and strides are planned
    (`tests/test_torch_gather_path.py` holds them to the JAX plan)."""
    from occuseg_tpu.native.plan import build_plan_host as jax_or_none
    from occuseg_tpu_torch.core.topology import build_plan
    from occuseg_tpu_torch.native.blocked import build_plan_host_blocked
    batch = _batch(0)
    jax_build_plan_host(batch["coords"], JaxPlanSpec(caps=CAPS))  # loaded
    for refused in (dict(dilation=2, nn_search=True),
                    dict(lattice="permutohedral")):
        assert jax_or_none(batch["coords"],
                           JaxPlanSpec(caps=CAPS, **refused)) is None
        spec = PlanSpec(caps=CAPS, **refused)
        assert build_plan_host(batch["coords"], spec) is None
        assert build_plan_host_blocked(batch["coords"], spec, 2) is None
        plan = build_plan(torch.from_numpy(batch["coords"]), spec)
        assert plan.levels[0].num_active > 0
        assert plan.levels[0].nbr.shape[1] == (
            13 if "lattice" in refused else 27)


def test_derived_neighbor_map_rejects_duplicate_offsets():
    batch = _batch(0)
    tp = build_plan_host(batch["coords"], PlanSpec(caps=CAPS))
    lvl, tr, coarse = tp.levels[0], tp.transitions[0], tp.levels[1]
    offs = _offsets(3)
    # the check passes the real offset list through (and derives the map
    # the probe path builds)
    nbr = native.plan_neighbor_map_derived(lvl.coords, lvl.num_active, offs,
                                           tr.up, tr.child, coarse.nbr)
    assert np.array_equal(nbr, lvl.nbr)
    dup = offs.copy()
    dup[5] = dup[4]  # 27 offsets, one cell of the 3x3x3 table never set
    with pytest.raises(ValueError, match="duplicate"):
        native.plan_neighbor_map_derived(lvl.coords, lvl.num_active, dup,
                                         tr.up, tr.child, coarse.nbr)


def test_gather_rows_checks_bounds():
    rng = np.random.default_rng(0)
    src = rng.standard_normal((10, 3)).astype(np.float32)
    perm = np.array([3, -1, 9, 0, -1], np.int64)
    out = native.gather_rows(src, perm, 7.0)
    ref = np.where((perm >= 0)[:, None], src[np.maximum(perm, 0)], 7.0)
    assert np.array_equal(out, ref)
    with pytest.raises(IndexError):
        native.gather_rows(src, np.array([0, 10], np.int64), 0)
