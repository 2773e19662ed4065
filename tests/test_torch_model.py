"""The flagship model of the PyTorch port against the JAX package.

The JAX `LearningBWDenseUNet` is initialised, its batch statistics are
replaced with random ones (eval BN with init stats is near the identity
and would hide wiring errors), the weights are carried over with
`convert.from_flax`, and both models run eval-mode forwards on the same
chunked, laid-out plan of a small scene. All 7 outputs must agree at
rtol=atol=1e-4, the tolerance the JAX package's own chunked-model test
uses (f32, 15 chained convolutions summed in different orders)."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from occuseg_tpu.core.point_layout import (
    apply_point_layout as jax_apply_layout,
    augment_plan_with_point_layout as jax_augment_layout,
)
from occuseg_tpu.core.topology import PlanSpec as JaxPlanSpec
from occuseg_tpu.data.synthetic import SceneConfig, make_batch
from occuseg_tpu.models import LearningBWDenseUNet as JaxLearningBW
from tests.jax_planner import host_plan as jax_build_plan_host
from occuseg_tpu.ops.pallas import chunk_conv as jax_cc

from occuseg_tpu_torch.convert import from_flax
from occuseg_tpu_torch.core.point_layout import augment_plan_with_point_layout
from occuseg_tpu_torch.core.topology import PlanSpec
from occuseg_tpu_torch.infer import Predictor, prepare_scene
from occuseg_tpu_torch.models import LearningBWDenseUNet
from occuseg_tpu_torch.native.plan import build_plan_host
from occuseg_tpu_torch.ops.kernels import chunk_conv as cc

torch.set_num_threads(2)

N_PLANES = (32, 64, 96)
CAPS = (3072, 2048, 1024)  # multiples of 128 (chunks), cap0 of 192 (layout)
P_CAP = 4096
CHUNK_KW = dict(M=64, U=(192, 256, 256), U_child=320, U_up=128)
FIELDS = ("semantics", "features", "embedding", "offset", "displacement",
          "bw", "occupancy")


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def setup():
    batch = make_batch(SceneConfig(num_points=3000, extent=96,
                                   num_objects=6),
                       num_scenes=1, p_cap=P_CAP, num_instances=8, seed=11)
    raw = jax_build_plan_host(batch["coords"], JaxPlanSpec(caps=CAPS))
    jp = jax_augment_layout(jax_cc.augment_plan_with_chunks(raw, **CHUNK_KW))
    assert jp.vox_seg is not None
    assert all(l.chunks is not None for l in jp.levels)
    jb = jax_apply_layout(batch, jp)
    plan_j = jax.tree.map(jnp.asarray, jp)
    feats_j = jnp.asarray(jb["features"])

    model = JaxLearningBW(n_planes=N_PLANES, num_classes=20)
    # init only needs shapes: the unchunked plan keeps the Pallas kernels
    # (slow in interpret mode) out of it
    variables = model.init(jax.random.PRNGKey(0), feats_j,
                           jax.tree.map(jnp.asarray, raw), False)
    rng = np.random.default_rng(0)

    def rand_stat(path, v):
        name = path[-1].key
        shape = np.shape(v)
        if name == "running_mean":
            return rng.normal(0.0, 0.5, shape).astype(np.float32)
        return rng.uniform(0.5, 2.0, shape).astype(np.float32)

    params = _np_tree(variables["params"])
    stats = jax.tree_util.tree_map_with_path(rand_stat,
                                             variables["batch_stats"])
    out_j = model.apply({"params": params, "batch_stats": stats}, feats_j,
                        plan_j, False)
    return dict(batch=batch, jp=jp, feats=jb["features"], params=params,
                stats=stats, out_j=out_j)


def _port_model(setup):
    model = LearningBWDenseUNet(N_PLANES, num_classes=20)
    model.load_state_dict(from_flax(setup["params"], setup["stats"], model))
    return model.eval()


def test_from_flax_covers_every_parameter(setup):
    model = LearningBWDenseUNet(N_PLANES, num_classes=20)
    sd = from_flax(setup["params"], setup["stats"], model)
    assert set(sd) == set(model.state_dict())
    n_flax = len(jax.tree.leaves(setup["params"])) \
        + len(jax.tree.leaves(setup["stats"]))
    assert len(sd) == n_flax
    # a Dense kernel [in, out] lands transposed in a Linear weight
    k = setup["params"]["fc_bw"]["kernel"]
    assert np.array_equal(sd["fc_bw.weight"].numpy(), np.asarray(k).T)


def test_from_flax_raises_on_missing_and_left_over_keys(setup):
    model = LearningBWDenseUNet(N_PLANES, num_classes=20)
    params = dict(setup["params"])
    del params["fc_bw"]
    with pytest.raises(ValueError, match="missing"):
        from_flax(params, setup["stats"], model)
    params = dict(setup["params"], extra={"kernel": np.zeros((2, 2))})
    with pytest.raises(ValueError, match="left over"):
        from_flax(params, setup["stats"], model)
    stats = dict(setup["stats"])
    stats["backbone"] = dict(stats["backbone"])
    bb = dict(stats["backbone"]["backbone"])
    del bb["bn"]
    stats["backbone"]["backbone"] = bb
    with pytest.raises(ValueError, match="statistics"):
        from_flax(setup["params"], stats)


def test_forward_matches_jax(setup):
    tp = cc.augment_plan_with_chunks(
        build_plan_host(setup["batch"]["coords"], PlanSpec(caps=CAPS)),
        **CHUNK_KW)
    tp = augment_plan_with_point_layout(tp)
    model = _port_model(setup)
    with torch.inference_mode():
        out = model(torch.from_numpy(setup["feats"]), tp.to("cpu"))
    for f in FIELDS:
        ref = np.asarray(getattr(setup["out_j"], f))
        got = getattr(out, f)
        assert got.dtype == torch.float32 and got.shape == ref.shape, f
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4, atol=1e-4,
                                   err_msg=f)


def test_predictor_returns_original_point_order(setup):
    """prepare_scene + Predictor (default M=128 chunks) on the original
    batch give the JAX outputs un-permuted through plan.point_perm."""
    batch = setup["batch"]
    scene = prepare_scene(batch["coords"], batch["features"],
                          PlanSpec(caps=CAPS))
    assert np.array_equal(scene.plan.point_perm, setup["jp"].point_perm)
    out = Predictor(_port_model(setup), "cpu")(scene)
    perm = setup["jp"].point_perm
    for f in FIELDS:
        laid = np.asarray(getattr(setup["out_j"], f))
        ref = np.zeros_like(laid)
        ref[perm[perm >= 0]] = laid[perm >= 0]
        np.testing.assert_allclose(getattr(out, f).numpy(), ref, rtol=1e-4,
                                   atol=1e-4, err_msg=f)


def test_port_runs_without_jax():
    """A CPU forward through the port leaves jax, flax and occuseg_tpu
    out of sys.modules."""
    code = (
        "import sys, torch\n"
        "from occuseg_tpu_torch.core.topology import PlanSpec\n"
        "from occuseg_tpu_torch.data.synthetic import SceneConfig, "
        "make_batch\n"
        "from occuseg_tpu_torch.infer import Predictor, prepare_scene\n"
        "from occuseg_tpu_torch.models import LearningBWDenseUNet\n"
        "torch.set_num_threads(2)\n"
        "b = make_batch(SceneConfig(num_points=3000, extent=96, "
        "num_objects=6), 1, 4096, 8, seed=11)\n"
        "s = prepare_scene(b['coords'], b['features'], "
        "PlanSpec(caps=(3072, 2048, 1024)))\n"
        "m = LearningBWDenseUNet((32, 64, 96), generator="
        "torch.Generator().manual_seed(0))\n"
        "o = Predictor(m, 'cpu')(s)\n"
        "assert torch.isfinite(o.semantics).all()\n"
        "bad = [k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'occuseg_tpu')]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", code], cwd=repo,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")
