"""The port's data path against the JAX package on the CPU, on synthetic
scans written in ScanNet's raw layout (`data.synthetic.write_scannet_scan`)
and S3DIS's: every comparison is exact (np.array_equal with equal dtypes,
or equal bytes).

* `read_ply` in ASCII and binary (with a face list to skip);
* `prepare_scene` with annotations and `.regions.json`, with annotations
  alone (supervoxels computed), and bare; `prepare_split` and the module's
  CLI;
* `estimate_normals`, and `segment_supervoxels` (the C++ segmenter of the
  port's own build) against the JAX package's, and its partition against
  the NumPy oracle `_segment_numpy`;
* `ScanNetData` batches against the JAX loader's for the same
  `np.random.Generator`: two epochs of training batches with elastic
  distortion and rotation noise for the feature strings c, cn and lch,
  two scenes a batch under a p_cap that subsamples them; validation
  batches over `val_reps`; `.pth` scenes (the reference's tuple and a
  dict) beside `.npz` ones;
* `s3dis.prepare_room`; the `utils/ply` writers' bytes.
"""

import os

import numpy as np
import pytest
import torch

from occuseg_tpu.data import prepare as jax_prepare
from occuseg_tpu.data import s3dis as jax_s3dis
from occuseg_tpu.data import scannet as jax_scannet
from occuseg_tpu.data import supervoxel_gen as jax_sv
from occuseg_tpu.utils import ply as jax_ply
from tests.jax_planner import heal

from occuseg_tpu_torch.data import prepare, s3dis, scannet, supervoxel_gen
from occuseg_tpu_torch.data.synthetic import SceneConfig, write_scannet_scan
from occuseg_tpu_torch.utils import ply

SMALL = SceneConfig(num_points=700, extent=96, num_objects=4)


def _same_arrays(a, b):
    assert set(a) == set(b)
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        assert np.array_equal(a[k], b[k]), k


@pytest.mark.parametrize("ascii", [False, True])
def test_read_ply_round_trip(tmp_path, ascii):
    path = write_scannet_scan(str(tmp_path), "scene0000_00", SMALL, 1,
                              ascii=ascii)
    v = prepare.read_ply(path)
    _same_arrays(v, jax_prepare.read_ply(path))
    lab = prepare.read_ply(path[:-3] + "labels.ply")
    assert set(np.unique(lab["label"])) <= set(prepare.VALID_CLASS_IDS) | {40}
    ref = write_scannet_scan(str(tmp_path / "b"), "scene0000_00", SMALL, 1)
    b = prepare.read_ply(ref)
    for k in ("x", "y", "z", "red", "green", "blue"):
        # ASCII keeps the float32 values' shortest repr: exact
        np.testing.assert_array_equal(v[k].astype(np.float64),
                                      b[k].astype(np.float64), err_msg=k)


@pytest.mark.parametrize("kind", ["annotated_regions", "annotated", "bare"])
def test_prepare_scene_matches_jax(tmp_path, kind):
    path = write_scannet_scan(str(tmp_path / "scans"), "scene0007_00", SMALL,
                              7, annotations=kind != "bare",
                              regions=kind == "annotated_regions")
    heal()
    got = np.load(prepare.prepare_scene(path, str(tmp_path / "port")))
    want = np.load(jax_prepare.prepare_scene(path, str(tmp_path / "jax")))
    _same_arrays(dict(got), dict(want))
    if kind == "bare":
        assert (got["labels"] == prepare.UNKNOWN_ID).all()
    else:
        assert (got["instance_id"] >= 0).any()
        assert (got["labels"] == prepare.UNKNOWN_ID).any()   # NYU40 id 40


def test_prepare_split_and_cli_match_jax(tmp_path, monkeypatch):
    scans = tmp_path / "scans"
    for i in range(2):
        write_scannet_scan(str(scans), f"scene000{i}_00", SMALL, 20 + i)
    heal()
    want = jax_prepare.prepare_split(str(scans), str(tmp_path / "jax"))
    monkeypatch.setattr("sys.argv", ["prepare", "--scans", str(scans),
                                     "--out", str(tmp_path / "port")])
    prepare.main()
    got = sorted(os.listdir(tmp_path / "port"))
    assert got == [os.path.basename(p) for p in want] \
        == ["scene0000_00_instance.npz", "scene0001_00_instance.npz"]
    for name, w in zip(got, want):
        _same_arrays(dict(np.load(tmp_path / "port" / name)),
                     dict(np.load(w)))


def _points(seed, n=400):
    rng = np.random.default_rng(seed)
    pts = np.concatenate([
        np.stack([rng.uniform(0, 2, n), rng.uniform(0, 2, n),
                  np.zeros(n)], 1),
        np.stack([rng.uniform(0, 2, n), np.zeros(n),
                  rng.uniform(0, 1, n)], 1)]).astype(np.float32)
    colors = rng.uniform(-1, 1, pts.shape).astype(np.float32)
    return pts, colors


def test_estimate_normals_and_supervoxels_match_jax():
    pts, colors = _points(3)
    np.testing.assert_array_equal(supervoxel_gen.estimate_normals(pts),
                                  jax_sv.estimate_normals(pts))
    heal()
    for c in (None, colors):
        got = supervoxel_gen.segment_supervoxels(pts, c)
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, jax_sv.segment_supervoxels(pts, c))


def _canonical(labels):
    """Segment ids renumbered in first-seen order (the partition)."""
    _, first, inv = np.unique(labels, return_index=True, return_inverse=True)
    rank = np.argsort(np.argsort(first))
    return rank[inv]


@pytest.mark.parametrize("seed", [4, 5])
def test_native_segmentation_matches_numpy_oracle(seed):
    pts, colors = _points(seed)
    feat = np.concatenate([supervoxel_gen.estimate_normals(pts),
                           0.5 * colors], axis=1)
    got = supervoxel_gen.segment_supervoxels(pts, colors)
    want = supervoxel_gen._segment_numpy(pts, feat, 0.05, 0.3, 20)
    assert len(np.unique(got)) > 1
    np.testing.assert_array_equal(_canonical(got), _canonical(want))


def _scene_dir(root, n_train=3, n_val=1, pth=False):
    """Prepared scenes under root/{train,val}; with `pth`, the first
    training scene also as the reference's .pth tuple and a second one as
    a dict."""
    for split, n, base in (("train", n_train, 30), ("val", n_val, 60)):
        for i in range(n):
            path = write_scannet_scan(str(root / "scans"), f"s{base + i}",
                                      SMALL, base + i, regions=True)
            prepare.prepare_scene(path, str(root / split))
    if pth:
        z = dict(np.load(root / "train" / "s30_instance.npz"))
        w = np.stack([z["labels"], z["instance_id"]], 1)
        torch.save((z["coords"], z["colors"], w, z["region"]),
                   root / "train" / "s29_ref.pth")
        torch.save({k: z[k] for k in ("coords", "colors", "labels",
                                      "instance_id", "normals")},
                   root / "train" / "s28_dict.pth")
    return str(root)


def _config(root, feature="c", **kw):
    return dict(data_dir=root, scale=50, full_scale=4096,
                use_feature=feature, val_reps=3, regress_sigma=0.2,
                use_rotation_noise=True, use_elastic=True, **kw)


def _datasets(config):
    heal()
    port, ref = scannet.ScanNetData(config), jax_scannet.ScanNetData(config)
    port.load_data()
    ref.load_data()
    assert port.train_files == ref.train_files
    return port, ref


@pytest.mark.parametrize("feature", ["c", "cn", "lch"])
def test_train_batches_match_jax_over_two_epochs(tmp_path, feature):
    port, ref = _datasets(_config(_scene_dir(tmp_path, pth=feature == "c"),
                                  feature))
    # two scenes a batch hold ~1400 points: p_cap 1024 subsamples them
    rng_p, rng_j = np.random.default_rng(100), np.random.default_rng(100)
    n = 0
    for _ in range(2):
        for bp, bj in zip(port.train_batches(rng_p, 1024, 16, 2),
                          ref.train_batches(rng_j, 1024, 16, 2)):
            _same_arrays(bp, bj)
            assert bp["features"].shape[1] == len(feature) * 3 - \
                2 * ("h" in feature)
            n += 1
    assert n == 2 * -(-len(port.train) // 2)
    assert rng_p.random() == rng_j.random()


def test_val_batches_match_jax(tmp_path):
    port, ref = _datasets(_config(_scene_dir(tmp_path, n_train=1, n_val=3),
                                  "cn"))
    for rep in range(3):
        got = list(port.val_batches(4096, 16, 2, val_rep=rep))
        want = list(ref.val_batches(4096, 16, 2, val_rep=rep))
        assert len(got) == len(want) == 2
        for bp, bj in zip(got, want):
            _same_arrays(bp, bj)


def test_load_scene_pth_and_npz_match_jax(tmp_path):
    root = _scene_dir(tmp_path, n_train=1, n_val=0, pth=True)
    for name in ("s30_instance.npz", "s29_ref.pth", "s28_dict.pth"):
        path = os.path.join(root, "train", name)
        _same_arrays(scannet.load_scene(path), jax_scannet.load_scene(path))
    bad = tmp_path / "bad" / "train"
    bad.mkdir(parents=True)
    (bad / "scene.pth").write_bytes(b"")
    with pytest.raises(RuntimeError, match="scene.pth"):
        scannet.ScanNetData(_config(str(tmp_path / "bad"))).load_data()


def test_s3dis_prepare_room_matches_jax(tmp_path):
    rng = np.random.default_rng(7)
    ann = tmp_path / "Area_1" / "office_1" / "Annotations"
    os.makedirs(ann)
    for name, n in [("chair_1", 120), ("table_1", 150), ("clutter_3", 80),
                    ("lamp_1", 40)]:
        data = np.concatenate([rng.uniform(0, 4, (n, 3)),
                               rng.integers(0, 255, (n, 3))], axis=1)
        np.savetxt(ann / f"{name}.txt", data, fmt="%.3f")
    heal()
    got = s3dis.prepare_area(str(tmp_path / "Area_1"), str(tmp_path / "p"))
    want = jax_s3dis.prepare_area(str(tmp_path / "Area_1"),
                                  str(tmp_path / "j"))
    assert [os.path.basename(p) for p in got] == ["office_1.npz"]
    _same_arrays(dict(np.load(got[0])), dict(np.load(want[0])))
    assert s3dis.LABEL_TO_ID == jax_s3dis.LABEL_TO_ID


def test_ply_writers_write_the_same_bytes(tmp_path):
    rng = np.random.default_rng(9)
    xyz = rng.uniform(0, 5, (300, 3)).astype(np.float32)
    labels = rng.integers(-1, 20, 300)
    inst = rng.integers(-1, 6, 300)
    for mod, d in ((ply, "p"), (jax_ply, "j")):
        os.makedirs(tmp_path / d)
        mod.write_labeled_ply(str(tmp_path / d / "sem.ply"), xyz, labels)
        mod.write_instance_ply(str(tmp_path / d / "inst.ply"), xyz, inst)
    for f in ("sem.ply", "inst.ply"):
        assert (tmp_path / "p" / f).read_bytes() == \
            (tmp_path / "j" / f).read_bytes()
    np.testing.assert_array_equal(ply.CLASS_COLORS, jax_ply.CLASS_COLORS)
