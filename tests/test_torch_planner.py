"""The port's device planner (`occuseg_tpu_torch/core/coords.py`,
`core/topology.build_plan` and its pieces, `ops/permutohedral.py`) against
the JAX package's in-jit planner on the CPU: every key, coordinate, count
and map bit for bit (np.array_equal) on the same NumPy inputs, and the
plans also against the port's host planner where both apply."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from occuseg_tpu.core import coords as JC
from occuseg_tpu.core import topology as JT
from occuseg_tpu.data.synthetic import SceneConfig, make_batch
from occuseg_tpu.ops import permutohedral as jperm
import tests.jax_planner  # noqa: F401  (heals the JAX planner's load)
from tests.utils import random_points

from occuseg_tpu_torch.core import coords as C
from occuseg_tpu_torch.core import topology as T
from occuseg_tpu_torch.native.plan import build_plan_host
from occuseg_tpu_torch.ops import permutohedral as perm

torch.set_num_threads(2)

CAPS = (4096, 2048, 1024, 512)
SIZE3_CAPS = (4096, 3072, 1536, 512)


def _t(a):
    return torch.from_numpy(np.array(a))


def _same(a, b, what=""):
    a, b = np.asarray(a), T._np(b)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    assert np.array_equal(a, b), (what, int((a != b).sum()))


def _same_level(jl, tl, orient=True):
    for f in ("keys", "coords", "nbr") + (("orient",) if orient else ()):
        _same(getattr(jl, f), getattr(tl, f), f)
    assert int(jl.num_active) == int(tl.num_active)


def _same_plan(jp, tp, orient=True):
    assert len(jp.levels) == len(tp.levels)
    for jl, tl in zip(jp.levels, tp.levels):
        _same_level(jl, tl, orient)
    assert len(jp.transitions) == len(tp.transitions)
    for jt, tt in zip(jp.transitions, tp.transitions):
        _same(jt.child, tt.child, "child")
        _same(jt.up, tt.up, "up")
        assert (jt.size, jt.stride) == (tt.size, tt.stride)
    _same(jp.p2v, tp.p2v, "p2v")
    assert int(jp.num_points) == tp.num_points


@pytest.fixture(scope="module")
def scene():
    return make_batch(SceneConfig(num_points=3000, extent=48, num_objects=5),
                      num_scenes=1, p_cap=4096, num_instances=8, seed=5)


@pytest.fixture(scope="module")
def level_keys():
    """Sorted unique keys of a small two-scene cloud (the JAX voxelizer's)."""
    rng = np.random.default_rng(3)
    pts = random_points(rng, 400, extent=12, batch_size=2, pad_to=512)
    keys, _ = JT.voxelize_coords(jnp.asarray(pts), 512)
    return np.asarray(keys)


def test_pack_unpack_borders_batches_and_pads():
    rng = np.random.default_rng(0)
    pts = random_points(rng, 300, extent=4096, batch_size=7, pad_to=400)
    pts[0] = (0, 0, 0, 0)
    pts[1] = (6, 4095, 4095, 4095)
    pts[2] = (3, 0, 4095, 0)
    pts[3] = (2, 4096, 5, 5)    # outside the window -> KEY_PAD
    pts[4] = (1, 5, -1, 5)      # negative -> KEY_PAD
    pts[5] = (-1, 5, 5, 5)      # pad batch -> KEY_PAD
    keys = C.pack(_t(pts))
    jkeys = JC.pack(jnp.asarray(pts))
    _same(jkeys, keys, "pack")
    assert int(keys[3]) == int(keys[4]) == int(keys[5]) == C.KEY_PAD
    _same(JC.unpack(jkeys), C.unpack(keys), "unpack")
    back = C.unpack(keys).numpy()
    ok = (np.asarray(jkeys) < int(JC.KEY_PAD))
    assert np.array_equal(back[ok], pts[ok])
    assert (back[~ok] == -1).all()
    # shifted keys never wrap across an axis field at the border
    delta = np.array([0, 0, 1], np.int32)
    _same(JC.neighbor_keys(jnp.asarray(pts), jnp.asarray(delta)),
          C.neighbor_keys(_t(pts), delta), "neighbor_keys")


def test_parent_keys_lookup_and_compaction(level_keys):
    rng = np.random.default_rng(1)
    skeys = np.sort(JC.pack(jnp.asarray(random_points(
        rng, 900, extent=20, batch_size=3, pad_to=1024))))
    skeys = np.asarray(skeys)
    _same(JC.parent_keys(jnp.asarray(skeys)), C.parent_keys(_t(skeys)),
          "parent_keys")
    for cap in (64, 2048):   # fewer slots than distinct keys, and more
        for a, b in zip(JC.compact_unique(jnp.asarray(skeys), cap),
                        C.compact_unique(_t(skeys), cap)):
            _same(a, b, f"compact_unique cap {cap}")
    for a, b in zip(JC.unique_consecutive(jnp.asarray(skeys)),
                    C.unique_consecutive(_t(skeys))):
        _same(a, b, "unique_consecutive")
    q = np.concatenate([level_keys[:50] + 1, level_keys[::7],
                        [int(JC.KEY_PAD), 0, level_keys.max() + 5]])
    q = q.astype(np.int64)
    _same(JC.lookup(jnp.asarray(level_keys), jnp.asarray(q)),
          C.lookup(_t(level_keys), _t(q)), "lookup")
    for a, b in zip(JC.sort_by_key(jnp.asarray(q[::-1].copy()),
                                   jnp.arange(q.size)),
                    C.sort_by_key(_t(q[::-1].copy()), torch.arange(q.size))):
        _same(a, b, "sort_by_key")


@pytest.mark.parametrize("case", ["dilation1", "dilation2", "dilation2_nn",
                                  "permutohedral"])
def test_build_level_matches_jax(level_keys, case):
    kw = dict(dilation1={}, dilation2=dict(dilation=2),
              dilation2_nn=dict(dilation=2, nn_search=True),
              permutohedral=dict(offsets=perm.permutohedral_offsets(3)))[case]
    jl = JT.build_level(jnp.asarray(level_keys), **kw)
    tl = T.build_level(_t(level_keys), **kw)
    _same_level(jl, tl)
    assert isinstance(tl.num_active, int)
    assert tl.kn["nbr"].is_contiguous() and tl.kn["nbr"].dtype == torch.int32
    if case == "dilation2_nn":   # the search found sites the exact map lacks
        exact = T.build_level(_t(level_keys), dilation=2)
        assert (T._np(tl.nbr) >= 0).sum() > (T._np(exact.nbr) >= 0).sum()


@pytest.mark.parametrize("cap", [512, 96])
def test_voxelize_coords(cap):
    """Unique keys and p2v, at a cap that holds every voxel of the 400
    points (and is above their count: pad points get row P, as in JAX) and
    at one that drops voxels (p2v -1 past the cap)."""
    rng = np.random.default_rng(2)
    pts = random_points(rng, 400, extent=8, batch_size=2, pad_to=448)
    for a, b in zip(JT.voxelize_coords(jnp.asarray(pts), cap),
                    T.voxelize_coords(_t(pts), cap)):
        _same(a, b, "voxelize")
    _, p2v = T.voxelize_coords(_t(pts), cap)
    if cap < 448:
        assert (p2v.numpy()[:400] == -1).any()


@pytest.mark.parametrize("size,stride", [(2, 2), (3, 2)])
def test_downsample_keys_and_transition(level_keys, size, stride):
    jf = JT.build_level(jnp.asarray(level_keys))
    tf = T.build_level(_t(level_keys))
    jk = JT.downsample_keys(jf, size, stride, 512)
    tk = T.downsample_keys(tf, size, stride, 512)
    _same(jk, tk, "downsample_keys")
    jc, tc = JT.build_level(jk), T.build_level(tk)
    jt = JT.build_transition(jf, jc, size, stride)
    tt = T.build_transition(tf, tc, size, stride)
    _same(jt.child, tt.child, "child")
    _same(jt.up, tt.up, "up")
    assert tt.kn["child"].shape == (size ** 3, 512)


@pytest.mark.parametrize("build_nbr", [True, False])
def test_grow_keys_and_full_conv_plan(level_keys, build_nbr):
    jl = JT.build_level(jnp.asarray(level_keys))
    tl = T.build_level(_t(level_keys))
    cap_out = 512 * 8
    _same(JT.grow_keys(jl, 2, 2, cap_out), T.grow_keys(tl, 2, 2, cap_out),
          "grow_keys")
    jo, jt = JT.full_conv_plan(jl, 2, 2, cap_out, build_nbr=build_nbr)
    to, tt = T.full_conv_plan(tl, 2, 2, cap_out, build_nbr=build_nbr)
    _same_level(jo, to)
    _same(jt.child, tt.child, "child")
    _same(jt.up, tt.up, "up")
    # a host level (NumPy keys) is planned on the CPU alike
    host = dataclasses.replace(tl, keys=level_keys,
                               coords=tl.coords.numpy())
    ho, ht = T.full_conv_plan(host, 2, 2, cap_out, build_nbr=build_nbr)
    _same(jo.keys, ho.keys, "host keys")
    _same(jt.up, ht.up, "host up")


@pytest.mark.parametrize("case", ["cubic", "normals_guide2", "size3"])
def test_build_plan_matches_jax_and_host(scene, case):
    caps, kw, normals = CAPS, {}, None
    if case == "normals_guide2":
        kw, normals = dict(guide_levels=2), scene["normals"]
    elif case == "size3":
        caps, kw = SIZE3_CAPS, dict(down_size=3, down_stride=2)
    jspec, tspec = JT.PlanSpec(caps=caps, **kw), T.PlanSpec(caps=caps, **kw)
    jp = JT.build_plan(jnp.asarray(scene["coords"]), jspec,
                       None if normals is None else jnp.asarray(normals))
    tp = T.build_plan(_t(scene["coords"]), tspec,
                      None if normals is None else _t(normals))
    _same_plan(jp, tp)
    assert [l.guided for l in tp.levels] == (
        [True, True, False, False] if normals is not None else [False] * 4)
    assert tp.vox_seg is None and tp.point_perm is None
    assert all(l.chunks is None for l in tp.levels)
    counts = np.bincount(tp.p2v.numpy()[tp.p2v.numpy() >= 0],
                         minlength=caps[0])
    assert np.array_equal(tp.vox_counts.numpy(), counts.astype(np.float32))
    hp = build_plan_host(scene["coords"], tspec, normals)
    _same_plan(tp, hp)   # orientation classes too: bits equal on the CPU
    assert [l.guided for l in hp.levels] == [l.guided for l in tp.levels]


@pytest.mark.parametrize("case", ["nn_search", "permutohedral"])
def test_build_plan_device_only_specs(scene, case):
    """The specs only the device planner builds: the JAX host planner and
    the port's both return None; the device plan equals JAX's in-jit
    one (the permutohedral plan from lattice coordinates)."""
    coords = scene["coords"]
    kw = dict(nn_search=dict(dilation=2, nn_search=True),
              permutohedral=dict(lattice="permutohedral"))[case]
    if case == "permutohedral":
        valid = coords[:, 0] >= 0
        lat = perm.embed_points(coords[valid, 1:].astype(np.float64) / 2.0)
        coords = coords.copy()
        coords[valid, 1:] = lat - lat.min(0)
    jspec, tspec = JT.PlanSpec(caps=CAPS, **kw), T.PlanSpec(caps=CAPS, **kw)
    jp = JT.build_plan(jnp.asarray(coords), jspec)
    tp = T.build_plan(_t(coords), tspec)
    _same_plan(jp, tp)
    assert tp.levels[0].nbr.shape[1] == (13 if case == "permutohedral"
                                         else 27)
    assert build_plan_host(coords, tspec) is None
    assert tp.levels[0].num_active > 100
    report = T.validate_plan(tp)
    assert report == JT.validate_plan(jp)
    # the keys and transitions hold; only the map's reversal symmetry
    # (and, on the lattice, its centre column) does not apply
    assert all(v == 0 for k, v in report.items()
               if "asymmetric" not in k and "bad_center" not in k), report


@pytest.mark.parametrize("corrupt", ["clean", "nbr", "up"])
def test_validate_plan_matches_jax(scene, corrupt):
    jspec, tspec = JT.PlanSpec(caps=CAPS), T.PlanSpec(caps=CAPS)
    jp = JT.build_plan(jnp.asarray(scene["coords"]), jspec)
    tp = T.build_plan(_t(scene["coords"]), tspec)
    if corrupt == "nbr":
        nbr = np.asarray(jp.levels[1].nbr).copy()
        nbr[3, 5] = 7
        nbr[10, 13] = -1
        jp = dataclasses.replace(jp, levels=(jp.levels[0], dataclasses.replace(
            jp.levels[1], nbr=jnp.asarray(nbr))) + jp.levels[2:])
        tp = dataclasses.replace(tp, levels=(tp.levels[0], dataclasses.replace(
            tp.levels[1], nbr=_t(nbr))) + tp.levels[2:])
    elif corrupt == "up":
        up = np.asarray(jp.transitions[0].up).copy()
        rows = np.nonzero((up >= 0).any(1))[0][:4]
        up[rows] = -1
        jp = dataclasses.replace(jp, transitions=(dataclasses.replace(
            jp.transitions[0], up=jnp.asarray(up)),) + jp.transitions[1:])
        tp = dataclasses.replace(tp, transitions=(dataclasses.replace(
            tp.transitions[0], up=up),) + tp.transitions[1:])
    report = T.validate_plan(tp)
    assert report == JT.validate_plan(jp)
    assert (sum(report.values()) == 0) == (corrupt == "clean"), report
    # the port's host plan validates alike
    if corrupt == "clean":
        assert T.validate_plan(build_plan_host(scene["coords"], tspec)) \
            == report


def test_permutohedral_tables():
    for d in (2, 3, 4):
        for a, b in zip(perm.permutohedral_basis(d),
                        jperm.permutohedral_basis(d)):
            assert np.array_equal(a, b)
        assert np.array_equal(perm.permutohedral_offsets(d),
                              jperm.permutohedral_offsets(d))
    xyz = np.random.default_rng(4).standard_normal((200, 3)) * 7
    for scale in (1.0, 2.5):
        assert np.array_equal(perm.embed_points(xyz, scale),
                              jperm.embed_points(xyz, scale))
    assert T.PlanSpec(caps=(8,), lattice="permutohedral").level_offsets() \
        .shape == (13, 3)
    assert T.PlanSpec(caps=(8,)).level_offsets() is None


def test_device_plan_moves_without_copies(scene):
    """A device-built plan's arrays are already tensors on its device,
    each map also in the gather convolution's orientation: `to` hands back
    the same tensors, and `gather_map` reads them without a copy."""
    tp = T.build_plan(_t(scene["coords"]), T.PlanSpec(caps=CAPS))
    dp = tp.to("cpu")
    for a, b in zip(tp.levels, dp.levels):
        assert b.kn["nbr"] is a.kn["nbr"]
        assert b.keys is a.keys and b.nbr is a.nbr
        assert b.gather_map("nbr", "cpu") is a.kn["nbr"]
        assert isinstance(b.num_active, int)
    for a, b in zip(tp.transitions, dp.transitions):
        assert b.kn["child"] is a.kn["child"] and b.kn["up"] is a.kn["up"]
        assert torch.equal(b.child, a.kn["child"].t())
    assert dp.p2v is tp.p2v and dp.vox_counts is tp.vox_counts
