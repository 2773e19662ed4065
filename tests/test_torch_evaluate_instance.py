"""The port's instance-evaluation entry point
(`occuseg_tpu_torch.evaluate_instance`) against the JAX script
(`scripts/evaluate_instance.py`) on the CPU.

- `cluster_and_score` on `test_two_stage_eval.py`'s synthetic scenes, with
  the merge on and off and with joint refinement: the proposals, the
  ground-truth instances and the semantic prediction exactly equal to the
  JAX script's; the `bw_relax_factor` sweep changes the proposals as it
  does there.
- A dump round trip reproduces the inline proposals exactly, and
  `score_scenes`' arrays equal the JAX script's exactly (NaN equal to NaN).
- The slice as a whole at m=8 (a 3-level UNet, small caps) on a small
  synthetic split passed in as the dataset, with the JAX model's weights
  (and random BN statistics) carried over by `convert.from_flax`: every
  array `infer_scenes` dumps is within 1e-4 of the JAX script's, relative
  to the array's max (f32 forwards through ~15 chained convolutions summed
  in another order; the argmax class is exactly equal), and `main` inline
  writes the same `instance_stat.mat`, exactly; `--dump` then
  `--from_dump` reproduce the inline statistics exactly.
- The flags equal the JAX script's; `--checkpoint_file` restores the
  port's checkpoint and raises on any other; `main(device="cuda")` raises
  where there is no card.
"""

import dataclasses
import sys

import jax
import numpy as np
import pytest
import scipy.io
import torch

from occuseg_tpu.data.synthetic import SceneConfig, make_batch
from occuseg_tpu.train import loop as jax_loop
from occuseg_tpu.train import state as jax_state

from test_two_stage_eval import _Args, _load_script, _synthetic_scene

from occuseg_tpu_torch import evaluate_instance as ei
from occuseg_tpu_torch.convert import from_flax
from occuseg_tpu_torch.train import checkpoint as ckpt
from occuseg_tpu_torch.train import config as train_config
from occuseg_tpu_torch.train import loop

torch.set_num_threads(2)

FLAGS = ["--m", "8", "--scale", "50", "--residual_blocks",
         "--point_cap", "4096", "--voxel_cap", "3072", "--instance_cap",
         "16", "--data_dir", "/nonexistent", "--use_merge",
         "--occupancy_hi", "1e6"]
PLANES = [8, 16, 24]  # a 3-level UNet for the CPU


class _Split:
    """Two small synthetic validation scenes."""

    def val_batches(self, p_cap, i_cap, batch_size, val_rep=0):
        for s in range(2):
            yield make_batch(SceneConfig(num_points=2500, extent=96,
                                         num_objects=6, scale=50), 1,
                             p_cap, i_cap, seed=50 + s)


def _small(args_to_config):
    return lambda args: dict(args_to_config(args), unet_structure=PLANES)


def _assert_same(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _assert_same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_same(x, y)
    else:
        np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def script():
    return _load_script()


@pytest.fixture(scope="module")
def jax_run(script, tmp_path_factory):
    """The JAX script's `main` inline on `_Split` with random BN
    statistics: its weights, the scenes its `infer_scenes` yielded and its
    instance_stat.mat."""
    out = tmp_path_factory.mktemp("jax_main")
    rng = np.random.default_rng(0)
    captured, scenes = {}, []
    create = jax_state.create_train_state
    infer = script.infer_scenes

    def rand_stat(path, v):
        if path[-1].key == "running_mean":
            return rng.normal(0.0, 0.5, np.shape(v)).astype(np.float32)
        return rng.uniform(0.5, 2.0, np.shape(v)).astype(np.float32)

    def create_with_stats(*a, **k):
        st = create(*a, **k)
        st = dataclasses.replace(st, batch_stats=jax.tree_util.
                                 tree_map_with_path(rand_stat,
                                                    st.batch_stats))
        captured["state"] = st
        return st

    def tee(config, args):
        for name, scene in infer(config, args):
            scenes.append((name, scene))
            yield name, scene

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_state, "create_train_state", create_with_stats)
        mp.setattr(jax_loop, "get_dataset", lambda config: _Split())
        mp.setattr(script, "args_to_config", _small(script.args_to_config))
        mp.setattr(script, "infer_scenes", tee)
        mp.setattr(sys, "argv", ["evaluate_instance.py", *FLAGS])
        mp.chdir(out)
        script.main()
    st = captured["state"]
    return dict(params=jax.tree.map(np.asarray, st.params),
                stats=jax.tree.map(np.asarray, st.batch_stats),
                scenes=scenes,
                mat=scipy.io.loadmat(str(out / "instance_stat.mat")))


def _port_model(jax_run):
    config = {"unet_structure": PLANES, "use_dense_model": True}
    model = loop.build_model(config)
    model.load_state_dict(from_flax(jax_run["params"], jax_run["stats"],
                                    model))
    return model


def _port_config():
    args = ei.get_parser().parse_args(FLAGS)
    config = dict(train_config.args_to_config(args), unet_structure=PLANES,
                  use_dense_model=True)
    return config, args


def _args(**kw):
    a = _Args()
    for k, v in kw.items():
        setattr(a, k, v)
    return a


@pytest.mark.parametrize("variant", ["merge", "no_merge", "joint_refine"])
def test_cluster_and_score_matches_jax(script, variant):
    args = _args(use_merge=variant == "merge",
                 use_joint_refine=variant == "joint_refine")
    for seed in (0, 3):
        scene = _synthetic_scene(seed)
        trace = {}
        got = ei.cluster_and_score(scene, args, device="cpu", trace=trace)
        _assert_same(got, script.cluster_and_score(scene, args))
        assert sum(map(len, got[0])) > 0
        assert trace["instances"] > 0 and trace["labels"].shape == (3000,)
        assert all(trace[k + "_ms"] >= 0 for k in
                   ("aggregate", "cluster", "filter"))
        assert ("merge_ms" in trace) == args.use_merge


def test_dump_roundtrip_reproduces_inline(tmp_path):
    args = _args()
    scene = _synthetic_scene()
    inline = ei.cluster_and_score(scene, args, device="cpu")
    np.savez(tmp_path / "scene0000.npz", **scene)
    loaded = dict(np.load(tmp_path / "scene0000.npz", allow_pickle=False))
    _assert_same(ei.cluster_and_score(loaded, args, device="cpu"), inline)


def test_score_scenes_matches_jax(script, jax_run):
    """On two synthetic scenes and on the m=8 model's dumped scenes."""
    args = _args()
    for scenes in ([(f"s{i}", _synthetic_scene(i)) for i in range(2)],
                   jax_run["scenes"]):
        want = script.score_scenes(iter(scenes), args)
        got = ei.score_scenes(iter(scenes), args, device="cpu")
        assert len(got.pop("proposals")) == len(scenes)
        _assert_same(got, want)
    assert want["per_proposal"].shape == (2, 20, 5, 1000)


def test_bw_relax_factor_sweep_matches_jax(script):
    scene = _synthetic_scene(5)
    sizes = []
    for relax in (1.0, 25.0):  # 25: absurdly wide bandwidths
        args = _args(use_merge=False, bw_relax_factor=relax)
        got = ei.cluster_and_score(scene, args, device="cpu")
        _assert_same(got, script.cluster_and_score(scene, args))
        sizes.append(sum(len(c) for c in got[0]))
    assert sizes[0] != sizes[1]


def test_infer_scenes_matches_jax(jax_run):
    config, args = _port_config()
    got = list(ei.infer_scenes(config, args, model=_port_model(jax_run),
                               dataset=_Split(), device="cpu"))
    assert len(got) == len(jax_run["scenes"]) == 2
    for (gname, g), (wname, w) in zip(got, jax_run["scenes"]):
        assert gname == wname and g.keys() == w.keys()
        for k in w:
            a, b = np.asarray(g[k]), np.asarray(w[k])
            assert a.dtype == b.dtype and a.shape == b.shape, k
            if a.dtype.kind == "f":
                scale = max(float(np.abs(b).max()), 1e-30)
                assert np.abs(a - b).max() <= 1e-4 * scale, k
            else:
                np.testing.assert_array_equal(a, b, err_msg=k)


def test_main_matches_jax_and_dump_round_trip(jax_run, tmp_path,
                                              monkeypatch):
    """`main` inline writes the JAX script's instance_stat.mat; `--dump`
    then `--from_dump` give the inline statistics again."""
    model = _port_model(jax_run)
    monkeypatch.setattr(ei, "build_model", lambda config, gen: model)
    monkeypatch.setattr(ei, "get_dataset", lambda config: _Split())
    monkeypatch.setattr(train_config, "args_to_config",
                        _small(train_config.args_to_config))
    monkeypatch.chdir(tmp_path)
    inline = ei.main(FLAGS, device="cpu")
    got = scipy.io.loadmat(str(tmp_path / "instance_stat.mat"))
    want = jax_run["mat"]
    assert (want["stats"][:, :, 0, :] >= 0).any()  # some proposal
    assert {k for k in got if not k.startswith("__")} == \
        {k for k in want if not k.startswith("__")}
    for k in want:
        if not k.startswith("__"):
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)

    assert ei.main([*FLAGS, "--dump", "dumps"], device="cpu") is None
    again = ei.main([*FLAGS, "--from_dump", "dumps"], device="cpu")
    _assert_same(again, inline)
    with pytest.raises(SystemExit, match="no .npz"):
        ei.main([*FLAGS, "--from_dump", str(tmp_path / "none")],
                device="cpu")


def test_flags_match_jax(script, monkeypatch):
    """The JAX script builds its parser inside `main`: stop it there and
    compare every flag, its options and its default."""
    class Stop(Exception):
        pass

    def stop(parser):
        def parse_args(*a, **k):
            raise Stop(parser)
        parser.parse_args = parse_args
        return parser

    get = script.get_parser
    monkeypatch.setattr(script, "get_parser", lambda: stop(get()))
    with pytest.raises(Stop) as e:
        script.main()

    def actions(parser):
        return {a.dest: (tuple(a.option_strings), a.default,
                         type(a).__name__)
                for a in parser._actions if a.dest != "help"}
    assert actions(ei.get_parser()) == actions(e.value.args[0])


def test_load_restores_a_port_checkpoint(jax_run, tmp_path):
    model = _port_model(jax_run)
    ckpt.save_checkpoint(str(tmp_path / "ck"), {"model": model.state_dict()},
                         step=3)
    config, args = _port_config()
    config["load"] = str(tmp_path / "ck")
    got = list(ei.infer_scenes(config, args, dataset=_Split(),
                               device="cpu"))
    want = list(ei.infer_scenes(config, args, model=model, dataset=_Split(),
                                device="cpu"))
    _assert_same(got, want)
    # the JAX script restores its own checkpoints only; so does the port
    (tmp_path / "ref.pth").write_bytes(b"")
    config["load"] = str(tmp_path / "ref.pth")
    with pytest.raises(ValueError, match="not a checkpoint of the port"):
        next(ei.infer_scenes(config, args, dataset=_Split(), device="cpu"))


def test_main_needs_a_card_unless_told_otherwise():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ei.main([*FLAGS, "--from_dump", "."])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ei.cluster_and_score(_synthetic_scene(), _args())
