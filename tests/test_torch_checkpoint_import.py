"""The port's importer of the reference's checkpoints, and the training CLI
on prepared ScanNet-format scenes, on the CPU.

* `train.torch_import.learning_bw_name_map` reaches every parameter and BN
  buffer of the port's model and nothing else (residual and VGG blocks,
  one and two block repetitions, normal-guided or not);
* `checkpoint.import_torch_state_dict` of a synthetic state dict in the
  reference's layout (random tensors under the map's keys, shaped from the
  JAX model's flax tree, a Linear weight [out, in]) equals `from_flax` of
  the JAX importer's result bit for bit, and raises on a missing or
  left-over key and a wrong shape;
* `train.loop.train(config, max_steps=1, device="cpu")` at m=8 with
  `--load ref.pth` (the restored weights and BN statistics equal the
  tensors as mapped; the optimizer starts afresh), and with `--data_dir`
  on prepared `.npz` scenes under `--use_normal --use_feature cn
  --use_elastic` (finite losses; the normal-guided convolutions ran), with
  the semantic eval on the val scene.
"""

import copy
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from occuseg_tpu.core.topology import PlanSpec as JaxPlanSpec
from occuseg_tpu.core.topology import build_plan
from occuseg_tpu.models import LearningBWDenseUNet as JaxLearningBW
from occuseg_tpu.train.checkpoint import _flatten
from occuseg_tpu.train.checkpoint import (
    import_torch_state_dict as jax_import,
)
from occuseg_tpu.train.torch_import import (
    learning_bw_name_map as jax_name_map,
)
from tests.jax_planner import heal
from tests.utils import random_points

from occuseg_tpu_torch.convert import from_flax
from occuseg_tpu_torch.data.prepare import prepare_scene
from occuseg_tpu_torch.data.synthetic import SceneConfig, write_scannet_scan
from occuseg_tpu_torch.models import LearningBWDenseUNet
from occuseg_tpu_torch.ops import normal_guide
from occuseg_tpu_torch.train import checkpoint, config, loop, torch_import

torch.set_num_threads(2)

N_PLANES = (8, 16, 24)


def _jax_variables(block_reps=1, residual=True):
    rng = np.random.default_rng(0)
    pts = random_points(rng, 300, extent=16, batch_size=1, pad_to=512)
    plan = build_plan(jnp.asarray(pts), JaxPlanSpec(caps=(512, 256, 128)))
    feats = jnp.asarray(rng.standard_normal((512, 3)).astype(np.float32))
    model = JaxLearningBW(n_planes=N_PLANES, num_classes=20,
                          block_reps=block_reps, residual_blocks=residual)
    return model.init(jax.random.PRNGKey(0), feats, plan, False)


def _reference_state_dict(variables, name_map, seed=1):
    """Random tensors in the reference's layout under the map's keys."""
    flat_p = _flatten(variables["params"])
    flat_s = _flatten(variables["batch_stats"])
    rng = np.random.default_rng(seed)
    sd = {}
    for tkey, fpath in name_map.items():
        path = tuple(fpath.split("/"))
        shape = tuple((flat_s if path in flat_s else flat_p)[path].shape)
        if path[-1] == "kernel":
            shape = shape[::-1]            # torch Linear [out, in]
        sd[tkey] = torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32))
    return sd


@pytest.mark.parametrize("reps,residual,guided",
                         [(1, True, False), (1, False, False),
                          (2, True, True)])
def test_name_map_reaches_every_port_key(reps, residual, guided):
    name_map = torch_import.learning_bw_name_map(N_PLANES, reps, residual)
    assert name_map == jax_name_map(N_PLANES, reps, residual)
    model = LearningBWDenseUNet(N_PLANES, block_reps=reps,
                                residual_blocks=residual,
                                normal_guided=guided)
    ports = {".".join(p[:-1] + ["weight" if p[-1] == "kernel" else p[-1]])
             for p in (f.split("/") for f in name_map.values())}
    assert len(ports) == len(name_map)
    assert ports == set(model.state_dict())
    params, stats = torch_import.split_param_stat_paths(name_map)
    assert len(stats) == sum(1 for k in model.state_dict()
                             if k.endswith(("running_mean", "running_var")))
    assert len(params) + len(stats) == len(name_map)


def test_import_equals_from_flax_of_the_jax_import():
    variables = _jax_variables()
    name_map = torch_import.learning_bw_name_map(N_PLANES)
    sd = _reference_state_dict(variables, name_map)
    params, stats = jax_import({k: v.numpy() for k, v in sd.items()},
                               variables["params"], variables["batch_stats"],
                               name_map)
    model = LearningBWDenseUNet(N_PLANES)
    want = from_flax(jax.tree.map(np.asarray, params),
                     jax.tree.map(np.asarray, stats), model)
    got = checkpoint.import_torch_state_dict(sd, model, name_map)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k],
                                                             want[k]), k
    # a Linear weight keeps the reference's [out, in]
    assert torch.equal(got["linear_bw.weight"], sd["linear_bw.weight"])


def test_import_raises_on_missing_left_over_and_shape():
    variables = _jax_variables()
    name_map = torch_import.learning_bw_name_map(N_PLANES)
    sd = _reference_state_dict(variables, name_map)
    model = LearningBWDenseUNet(N_PLANES)
    with pytest.raises(KeyError, match="missing"):
        checkpoint.import_torch_state_dict(
            {k: v for k, v in sd.items() if k != "fc_bw.bias"}, model,
            name_map)
    with pytest.raises(KeyError, match="left over"):
        checkpoint.import_torch_state_dict(dict(sd, extra=torch.zeros(1)),
                                           model, name_map)
    with pytest.raises(ValueError, match="shape"):
        checkpoint.import_torch_state_dict(
            dict(sd, **{"linear_bw.weight": sd["linear_bw.weight"].t()}),
            model,
            name_map)
    with pytest.raises(KeyError, match="does not reach"):
        checkpoint.import_torch_state_dict(
            {k: v for k, v in sd.items() if k != "fc_bw.bias"}, model,
            {k: v for k, v in name_map.items() if k != "fc_bw.bias"})


def _flags(tmp_path, data_dir, *extra):
    argv = ["--m", "8", "--batch_size", "2", "--scale", "50",
            "--residual_blocks", "--use_dense_model", "--max_epoch", "1",
            "--point_cap", "4096", "--voxel_cap", "6144",
            "--instance_cap", "16", "--checkpoints_dir", str(tmp_path / "ck"),
            "--data_dir", str(data_dir), "--taskname", "t", *extra]
    c = config.args_to_config(config.get_parser().parse_args(argv))
    c["unet_structure"] = [8, 16, 24]   # a small UNet for the CPU
    return c


def test_train_loads_a_reference_pth(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    variables = _jax_variables()
    name_map = torch_import.learning_bw_name_map(N_PLANES)
    sd = _reference_state_dict(variables, name_map, seed=3)
    torch.save(sd, tmp_path / "ref.pth")
    cfg = _flags(tmp_path, tmp_path / "no_scenes", "--checkpoint_file",
                 str(tmp_path / "ref.pth"))
    seen = {}
    result = loop.train(cfg, max_steps=1, device="cpu",
                        on_start=lambda t: seen.update(
                            copy.deepcopy(t.state_dict())))
    assert result["steps"] == 1
    assert seen["steps"] == 0 and not seen["optimizer"]["state"]
    mapped = checkpoint.import_torch_state_dict(sd, result["model"],
                                                name_map)
    assert set(seen["model"]) == set(mapped)
    for k, v in mapped.items():
        assert torch.equal(seen["model"][k], v), k


def test_train_on_prepared_scenes_with_normals(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    scene = SceneConfig(num_points=1500, extent=96, num_objects=4)
    heal()
    for split, seeds in (("train", (1, 2, 3, 4)), ("val", (5,))):
        for s in seeds:
            path = write_scannet_scan(str(tmp_path / "scans"), f"scene{s}",
                                      scene, s)
            prepare_scene(path, str(tmp_path / "data" / split))
    cfg = _flags(tmp_path, tmp_path / "data", "--use_normal",
                 "--use_feature", "cn", "--use_elastic")
    assert cfg["input_feature_number"] == 6
    calls = []
    conv = normal_guide.normal_guided_conv

    def counted(*a, **kw):
        calls.append(a[0].shape)
        return conv(*a, **kw)

    monkeypatch.setattr(normal_guide, "normal_guided_conv", counted)
    result = loop.train(cfg, max_steps=1, device="cpu")
    assert result["steps"] == 1
    assert all(np.isfinite(v) for v in result["losses"].values())
    assert result["spec"].guide_levels == 1
    # level 0 only: sub, enc0.conv1/2, dec0.conv1/2; the first takes cn
    assert len(calls) == 5 and calls[0][1] == 6
    ds = loop.get_dataset(cfg)
    assert len(ds.train) == 4 and len(ds.val) == 1
    m = loop.evaluate_semantic(cfg, result["trainer"], result["spec"],
                               dataset=ds)
    assert len(calls) == 10 and 0.0 <= m["mean_iou"] <= 1.0
