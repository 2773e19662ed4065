"""The port's scripts (`occuseg_tpu_torch/scripts/`) and the accuracy floor
on the CPU.

* The checkpoint-parity gate on an oracle-made m=4 `.pth`
  (`tests/torch_oracle.py` with seeded weights, as
  `tests/test_checkpoint_parity_gate.py` makes it): exit 0; 1 when the
  imported model differs from the file by 1e-2 in one weight (the
  semantic head's first bias), which stage 2 must catch; not 0 with a key
  missing from the file; 1 when the oracle cannot be loaded (the JAX
  script skips stage 2 there and exits 0).
* `test_semantic`'s files against the JAX script's, exactly, from the
  same weights (the JAX script's initial ones, through
  `convert.from_flax` into a checkpoint of the port).
* `fake_judge` prints what the JAX script prints on the same files.
* `train_semantic` runs 2 steps at --m 8 and evaluates.
* The accuracy floor (`tests/test_accuracy_floor.py`'s thresholds) on
  `tools/ap_gate.soak`'s first 50 steps of seed 7.
"""

import importlib.util
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from occuseg_tpu.train import loop as jax_loop
from occuseg_tpu.train import state as jax_state
from occuseg_tpu.train.config import (
    args_to_config as jax_args_to_config,
    get_parser as jax_get_parser,
)

from occuseg_tpu_torch.convert import from_flax
from occuseg_tpu_torch.core.topology import PlanSpec
from occuseg_tpu_torch.data.synthetic import SceneConfig, make_batch
from occuseg_tpu_torch.native.plan import build_plan_host
from occuseg_tpu_torch.scripts import (
    checkpoint_parity,
    fake_judge,
    test_semantic,
    train_semantic,
)
from occuseg_tpu_torch.tools import ap_gate
from occuseg_tpu_torch.train import checkpoint, config, loop, state

torch.set_num_threads(2)

SCRIPTS = os.path.join(os.path.dirname(__file__), "..", "scripts")


def _jax_script(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", os.path.join(SCRIPTS, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def oracle_pth(tmp_path_factory):
    """A reference-format m=4 state dict of the oracle with seeded
    weights, built over the gate's probe plan."""
    m = 4
    planes = tuple(m * i for i in range(1, 7))
    plan = build_plan_host(make_batch(SceneConfig(num_points=6000,
                                                  extent=96, num_objects=8),
                                      1, 8192, 16, seed=11)["coords"],
                           PlanSpec(caps=checkpoint_parity.PROBE_CAPS))
    torch.manual_seed(0)
    oracle = checkpoint_parity.load_oracle()(planes, 20, plan, in_ch=3,
                                             reps=1)
    path = tmp_path_factory.mktemp("gate") / "oracle_m4.pth"
    torch.save(oracle.state_dict(), path)
    return path


def _gate(pth):
    return checkpoint_parity.main(
        ["--checkpoint_file", str(pth), "--m", "4", "--residual_blocks",
         "--use_dense_model", "--skip_eval"], device="cpu")


def test_parity_gate_passes_on_oracle_checkpoint(oracle_pth):
    assert _gate(oracle_pth) == 0


def test_parity_gate_fails_on_a_perturbed_weight(oracle_pth, monkeypatch):
    real = checkpoint_parity.load_baseline_checkpoint

    def perturbed(path, model, *args):
        out = real(path, model, *args)
        with torch.no_grad():
            model.backbone.linear.bias[0] += 1e-2
        return out
    monkeypatch.setattr(checkpoint_parity, "load_baseline_checkpoint",
                        perturbed)
    assert _gate(oracle_pth) == 1


def test_parity_gate_fails_on_a_missing_key(oracle_pth, tmp_path):
    sd = torch.load(oracle_pth)
    del sd["backbone.sub.weight"]
    torch.save(sd, tmp_path / "missing.pth")
    assert _gate(tmp_path / "missing.pth") != 0


def test_parity_gate_fails_without_its_oracle(oracle_pth, tmp_path,
                                              monkeypatch):
    monkeypatch.setattr(checkpoint_parity, "ORACLE",
                        str(tmp_path / "no_oracle.py"))
    assert _gate(oracle_pth) == 1


def _flags(tmp_path, *extra):
    return ["--m", "8", "--batch_size", "1", "--scale", "50",
            "--residual_blocks", "--point_cap", "8192", "--voxel_cap",
            "6144", "--instance_cap", "16", "--val_reps", "1",
            "--checkpoints_dir", str(tmp_path), "--data_dir",
            str(tmp_path / "no_scenes"), *extra]


def test_test_semantic_files_match_jax(tmp_path, monkeypatch):
    """The JAX script from its initial weights (PRNGKey(0) on the first
    val scene), the port's from the same weights in a checkpoint of its
    own: the same files, line for line."""
    flags = _flags(tmp_path)
    jcfg = jax_args_to_config(jax_get_parser().parse_args(flags))
    jmodel, jspec = jax_loop.build_model(jcfg), jax_loop.build_spec(jcfg)
    sample = next(iter(jax_loop.get_dataset(jcfg).val_batches(
        jcfg["point_cap"], jcfg["instance_cap"], 1)))
    st = jax_state.create_train_state(
        jmodel, jax.random.PRNGKey(0),
        {k: jnp.asarray(v) for k, v in sample.items() if k != "region"},
        jspec)
    cfg = config.args_to_config(config.get_parser().parse_args(flags))
    model = loop.build_model(cfg)
    model.load_state_dict(from_flax(jax.tree.map(np.asarray, st.params),
                                    jax.tree.map(np.asarray,
                                                 st.batch_stats), model))
    trainer = state.Trainer(model, "cpu")
    ckpt = checkpoint.save_checkpoint(tmp_path / "ckpt",
                                      trainer.state_dict(), step=1)

    monkeypatch.setattr(sys, "argv", ["test_semantic", *flags, "--out_dir",
                                      str(tmp_path / "jax")])
    _jax_script("test_semantic").main()
    files = test_semantic.main([*flags, "--out_dir", str(tmp_path / "port"),
                                "--checkpoint_file", ckpt], device="cpu")
    assert [os.path.basename(f) for f in files] == sorted(
        os.listdir(tmp_path / "jax"))
    for f in files:
        with open(f) as a, open(tmp_path / "jax" / os.path.basename(f)) as b:
            assert a.read() == b.read(), f
    ids = np.loadtxt(files[0], dtype=np.int64)
    assert set(ids.tolist()) <= set(test_semantic.SELECTED_LABEL_IDS)


def test_fake_judge_prints_what_jax_prints(tmp_path, monkeypatch, capsys):
    rng = np.random.default_rng(4)
    for d in ("pred", "gt"):
        (tmp_path / d).mkdir()
    for s, n in enumerate((300, 200, 150)):
        gt = rng.integers(-1, 22, n)
        pred = np.where(rng.random(n) < 0.6, gt, rng.integers(-2, 25, n))
        np.savetxt(tmp_path / "pred" / f"scene{s:04d}.txt", pred, fmt="%d")
        if s < 2:   # the third has no ground truth: skipped
            np.savetxt(tmp_path / "gt" / f"scene{s:04d}.txt", gt, fmt="%d")
    args = ["--pred_dir", str(tmp_path / "pred"), "--gt_dir",
            str(tmp_path / "gt")]
    monkeypatch.setattr(sys, "argv", ["fake_judge", *args])
    _jax_script("fake_judge").main()
    ref = capsys.readouterr().out
    res = fake_judge.main(args)
    assert capsys.readouterr().out == ref
    assert res["confusion"].sum() == sum(
        int(((g >= 0) & (g < 20)).sum()) for g in
        (np.loadtxt(tmp_path / "gt" / f"scene{s:04d}.txt") for s in (0, 1)))


def test_train_semantic_two_steps(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    result = train_semantic.main(_flags(tmp_path, "--taskname", "sem"),
                                 device="cpu", max_steps=2)
    assert result["steps"] == 2
    assert type(result["model"]).__name__ == "InstanceDenseUNet"
    assert all(np.isfinite(v) for v in result["losses"].values())
    assert 0.0 <= result["metrics"]["mean_iou"] <= 1.0


def test_accuracy_floor():
    """`tests/test_accuracy_floor.py`'s thresholds after 50 steps of seed
    7 (the AP gate's scene and model, from the port's seeded weights)."""
    parts = []
    ap_gate.soak(ap_gate.SEEDS[0], "cpu", steps=ap_gate.FLOOR_STEPS,
                 on_step=lambda i, p: parts.append(p))
    report = ap_gate.floor_report(parts)
    assert report["passed"], report
