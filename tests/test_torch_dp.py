"""The port's data parallelism (`occuseg_tpu_torch/parallel/data_parallel.py`)
on the CPU.

* `dp_groups` against the JAX loop's `dp_plan_prefetcher`: the same
  groups and loss weights for 5 batches at n = 2 and 3 (exact).
* A 2-rank gloo step (two spawned processes) of the (8, 16, 24)
  `LearningBWDenseUNet` from the JAX package's weights, each rank on its
  own scene, against the JAX step's loss function run per scene on one
  device and combined by hand with the weights, then optax's Adam (the
  JAX data-parallel tests fail on the reference, ROADMAP C item 3):
  loss parts, the reduced gradients and the averaged BN statistics within
  1e-4 of each tensor's largest magnitude (the gradients with a floor of
  1e-2 of the largest gradient), and the parameters after the update
  within 1e-6 of optax's Adam on those gradients. Adam's first update,
  lr * g / (|g| + 1e-8), turns a gradient's rounding near 0 into a step
  of up to lr, so the parameters are held to the update of the reduced
  gradient and the gradient to JAX's.
* The weight-0 remainder: rank 1 a weight-0 copy of rank 0's scene gives
  rank 0's single-process step exactly.
* A step without its loss weight refused on a rank of two.
* Each rank makes only its own member of each group, and gets what one
  process making all of them gets (exact).
* `train.cli --num_devices 2` for one step on the CPU, its loss parts and
  BN statistics the means of the two scenes' forwards; `--num_devices`
  clamped to the visible cards, one rank on a named card, and `train`
  the only rank without a group (with an explicit --num_devices 2 it
  raises: `tests/test_torch_loop.py`).
"""

import copy
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from occuseg_tpu.core.point_layout import (
    apply_point_layout as jax_apply_layout,
    augment_plan_with_point_layout as jax_augment_layout,
)
from occuseg_tpu.core.topology import PlanSpec as JaxPlanSpec
from occuseg_tpu.data.synthetic import SceneConfig, make_batch
from occuseg_tpu.losses.instance import (
    occuseg_total_loss as jax_total_loss,
)
from occuseg_tpu.models import LearningBWDenseUNet as JaxLearningBW
from occuseg_tpu.train import loop as jax_loop
from occuseg_tpu.train import state as jax_state
from tests.jax_planner import host_plan as jax_build_plan_host
from tests.test_torch_data import _config as _data_config
from tests.test_torch_data import _same_arrays, _scene_dir
from tests.test_torch_families import _check_tree, _np_tree, _port_name

from occuseg_tpu_torch.convert import from_flax
from occuseg_tpu_torch.core.topology import PlanSpec
from occuseg_tpu_torch.models import LearningBWDenseUNet
from occuseg_tpu_torch.parallel import data_parallel as dp
from occuseg_tpu_torch.data import scannet
from occuseg_tpu_torch.losses.instance import occuseg_total_loss
from occuseg_tpu_torch.train import checkpoint as ckpt
from occuseg_tpu_torch.train import cli, loop, state
from occuseg_tpu_torch.train.config import args_to_config, get_parser

torch.set_num_threads(2)

N_PLANES = (8, 16, 24)
CAPS = (2048, 1024, 512)
P_CAP = 4096
I = 8
SEEDS = (21, 22)
LR = 1e-3


def _scene(seed):
    return make_batch(SceneConfig(num_points=2000, extent=40, num_objects=5),
                      num_scenes=1, p_cap=P_CAP, num_instances=I, seed=seed)


@pytest.fixture(scope="module")
def jax_ref():
    """The initial variables, and per scene the JAX step's loss parts,
    gradients and new BN statistics."""
    model = JaxLearningBW(n_planes=N_PLANES, num_classes=20)
    scenes = []
    for seed in SEEDS:
        batch = _scene(seed)
        jp = jax_augment_layout(jax_build_plan_host(batch["coords"],
                                                    JaxPlanSpec(caps=CAPS)))
        jb = {k: jnp.asarray(v) for k, v in
              jax_apply_layout(batch, jp, num_scenes=1).items()}
        scenes.append((jb, jax.tree.map(jnp.asarray, jp)))
    variables = model.init(jax.random.PRNGKey(3), scenes[0][0]["features"],
                           scenes[0][1], False)
    params, stats = variables["params"], variables["batch_stats"]

    @jax.jit
    def loss_and_grad(jb, plan):
        def loss_fn(p):
            out, mutated = model.apply({"params": p, "batch_stats": stats},
                                       jb["features"], plan, True,
                                       mutable=["batch_stats"])
            total, parts = jax_total_loss(out, jb, 1, I)
            return total, (parts, mutated["batch_stats"])
        (_, (parts, new_stats)), grads = jax.value_and_grad(
            loss_fn, has_aux=True)(params)
        return parts, grads, new_stats
    per_scene = [loss_and_grad(jb, plan) for jb, plan in scenes]
    return dict(params=params, stats=stats, per_scene=per_scene)


def _jax_combined(ref, weights):
    """The JAX step's reductions by hand (`occuseg_tpu/train/state.py:
    120-148`): sum_r w_r x_r / max(sum_r w_r, 1e-8) of the gradients (of
    w * L), loss parts and statistics."""
    den = max(sum(weights), 1e-8)

    def mean(trees):
        return jax.tree.map(lambda *xs: sum(w * x for w, x in
                                            zip(weights, xs)) / den, *trees)
    parts, grads, stats = (mean([s[i] for s in ref["per_scene"]])
                           for i in range(3))
    return {k: _np_tree(v) for k, v in dict(
        parts=parts, grads=grads, stats=stats).items()}


def _adam(params, grads):
    """optax's Adam (the JAX step's optimizer) on `grads`."""
    tx = jax_state.make_optimizer(jax_state.TrainConfig(lr=LR))
    updates, _ = tx.update(grads, tx.init(params), params)
    return _np_tree(optax.apply_updates(params, updates))


def _as_flax(tree, tensors):
    """The port's tensors (by name) in the flax tree's structure."""
    def leaf(path, _):
        name, transposed = _port_name(path)
        t = tensors[name]
        return jnp.asarray((t.t() if transposed else t).numpy())
    return jax.tree_util.tree_map_with_path(leaf, tree)


def _step(init, laid, plan, weight=None):
    model = LearningBWDenseUNet(N_PLANES, num_classes=20)
    model.load_state_dict(init)
    trainer = state.Trainer(model, "cpu", state.TrainConfig(lr=LR),
                            num_instances=I)
    parts = trainer.step(laid, plan, weight=weight)
    return dict(parts={k: float(v) for k, v in parts.items()},
                params={n: p.detach().clone()
                        for n, p in model.named_parameters()},
                grads={n: p.grad.clone() for n, p in model.named_parameters()},
                stats={n: b.clone() for n, b in model.named_buffers()})


def _dp_rank(rank, world, init, scenarios):
    """One rank: per scenario (members, weights) one step of its member;
    rank 0 returns the results, and whether a step without its weight was
    refused. Its thread count is this module's, as the single-process
    step's (the CPU's sums are split by thread)."""
    try:
        _step(init, *scenarios[0][0][rank])
        refused = False
    except ValueError as e:
        refused = "loss weight" in str(e)
    out = [_step(init, *members[rank], weight=weights[rank])
           for members, weights in scenarios]
    return (out, refused) if rank == 0 else None


@pytest.fixture(scope="module")
def dp_runs(jax_ref):
    """Two gloo ranks on the CPU, from the JAX weights: the full group
    (one scene each) and the remainder group (rank 1 a weight-0 copy of
    rank 0's scene); and rank 0's scene stepped in this process alone."""
    init = from_flax(_np_tree(jax_ref["params"]), _np_tree(jax_ref["stats"]),
                     LearningBWDenseUNet(N_PLANES, num_classes=20))
    prepared = [state.prepare_batch(_scene(s), PlanSpec(caps=CAPS))
                for s in SEEDS]
    scenarios = [(prepared, (1.0, 1.0)),
                 ((prepared[0], prepared[0]), (1.0, 0.0))]
    (full, remainder), refused = dp.spawn(_dp_rank, 2, "cpu", init,
                                          scenarios)[0]
    return dict(full=full, remainder=remainder, refused=refused,
                single=_step(init, *prepared[0]))


def test_dp_step_matches_jax(jax_ref, dp_runs):
    ref = _jax_combined(jax_ref, (1.0, 1.0))
    got = dp_runs["full"]
    for k, v in ref["parts"].items():
        np.testing.assert_allclose(got["parts"][k], v, rtol=1e-4,
                                   atol=1e-5, err_msg=k)
    _check_tree(ref["grads"], got["grads"], "reduced gradient", floor=1e-2)
    _check_tree(ref["stats"], got["stats"], "averaged statistic")
    adam = _adam(jax_ref["params"], _as_flax(jax_ref["params"],
                                             got["grads"]))
    for path, want in jax.tree_util.tree_flatten_with_path(adam)[0]:
        name, transposed = _port_name(path)
        p = got["params"][name]
        np.testing.assert_allclose((p.t() if transposed else p).numpy(),
                                   want, rtol=1e-6, atol=1e-6 * max(
                                       np.abs(want).max(), 1e-30),
                                   err_msg=name)


def test_dp_weight_zero_remainder_is_rank_0s_step(dp_runs):
    got, single = dp_runs["remainder"], dp_runs["single"]
    assert got["parts"] == single["parts"]
    for key in ("params", "grads", "stats"):
        for n, t in single[key].items():
            assert torch.equal(got[key][n], t), (key, n)


def test_dp_step_needs_its_weight(dp_runs):
    """In a group of two ranks, `Trainer.step` without a loss weight
    raises before it computes: a batch that lost its weight on the way
    would otherwise step without the all-reduce."""
    assert dp_runs["refused"]


@pytest.mark.parametrize("n", [2, 3])
def test_dp_groups_match_jax_prefetcher(n):
    batches = [dict(_scene(30 + i), index=np.int32(i)) for i in range(5)]
    ref = [(list(np.asarray(stacked["index"])),
            list(np.asarray(stacked["_w"])))
           for stacked, _, _ in jax_loop.dp_plan_prefetcher(
               batches, JaxPlanSpec(caps=CAPS), n)]
    got = [([int(b["index"]) for b in group], weights)
           for group, weights in dp.dp_groups(batches, n)]
    assert got == ref
    assert len(got) == -(-5 // n)


def test_num_devices_is_clamped_to_the_cards(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert dp.num_devices(0, "cuda") == 2
    assert dp.num_devices(4, "cuda") == 2
    assert dp.num_devices(1, "cuda") == 1
    # a named card is one rank
    assert dp.num_devices(0, "cuda:0") == 1
    assert dp.num_devices(2, "cuda:1") == 1
    assert dp.num_devices(0, "cpu") == 1
    assert dp.num_devices(3, "cpu") == 3
    assert dp.rank_device("cuda", 1) == torch.device("cuda", 1)
    assert dp.rank_device("cuda:0", 1) == torch.device("cuda", 0)
    assert dp.default_backend("cuda:0") == "nccl"
    assert dp.default_backend("cpu") == "gloo"
    # train() counts the ranks of the group it has joined, not the cards:
    # without one it is the only rank, whatever the host holds
    assert loop._ranks({"num_devices": 0}) == (0, 1)
    assert loop._ranks({"num_devices": 1}) == (0, 1)
    with pytest.raises(ValueError, match="2-rank process group"):
        loop._ranks({"num_devices": 2})


def test_dp_ranks_make_only_their_members(tmp_path):
    """Each rank makes only its member of each group (own seeded
    generators, `ScanNetData.train_batch_makers(own_rng=True)`), and gets
    exactly what one process making every member gets, over two epochs;
    the remainder group's weight-0 copy is its last batch again."""
    root = _scene_dir(tmp_path, n_train=5, n_val=0)
    ds = scannet.ScanNetData(_data_config(root, "cn"))
    ds.load_data()

    def epochs(member):
        rng, out = np.random.default_rng(100), []
        for _ in range(2):
            for group, weights in dp.dp_groups(ds.train_batch_makers(
                    rng, 1024, 16, 2, own_rng=True), 2):
                out.append(member(group, weights))
        return out
    every = epochs(lambda g, w: [(m(), x) for m, x in zip(g, w)])
    assert [[x for _, x in grp] for grp in every] == \
        [[1.0, 1.0], [1.0, 0.0]] * 2
    for rank in (0, 1):
        mine = epochs(lambda g, w: (g[rank](), w[rank]))
        for (got, w), grp in zip(mine, every):
            assert w == grp[rank][1]
            _same_arrays(got, grp[rank][0])
    for grp in every[1::2]:
        _same_arrays(grp[1][0], grp[0][0])


def _flags(tmp_path, *extra):
    return ["--m", "8", "--batch_size", "2", "--scale", "50",
            "--residual_blocks", "--use_dense_model", "--max_epoch", "1",
            "--point_cap", "8192", "--voxel_cap", "6144",
            "--instance_cap", "16", "--checkpoints_dir", str(tmp_path),
            "--data_dir", str(tmp_path / "no_scenes"), *extra]


def test_cli_two_ranks_one_step(tmp_path, monkeypatch):
    """`--num_devices 2` on the CPU: two spawned gloo ranks, one scene
    each, one step of the training loop; rank 0 checkpoints and
    evaluates. The step's loss parts and the checkpoint's BN statistics
    are the means of the loop's first two scenes' forwards from the
    initial weights in this process (so each rank stepped its own member
    at weight 1 and the all-reduce ran)."""
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    argv = _flags(tmp_path, "--num_devices", "2", "--taskname", "dp")
    result = cli.main(argv, device="cpu", max_steps=1)
    assert result["steps"] == 1
    assert 0.0 <= result["metrics"]["mean_iou"] <= 1.0
    saved = ckpt.restore_checkpoint(str(tmp_path / "dp" / "step_1.pth"),
                                    map_location="cpu")["model"]

    config = args_to_config(get_parser().parse_args(argv))
    spec = loop.build_spec(config)
    batches = loop._synthetic_dataset(config).train_batches(
        np.random.default_rng(100), config["point_cap"],
        config["instance_cap"], 1)
    trainer = loop.build_trainer(config, "cpu", 1)
    init = copy.deepcopy(trainer.model.state_dict())
    parts, stats = [], []
    for _ in range(2):
        laid, plan = state.prepare_batch(next(batches), spec, 1)
        trainer.model.load_state_dict(init)
        b = {k: torch.as_tensor(laid[k]) for k in state._BATCH_KEYS}
        out = trainer.model.train()(b["features"], plan.to("cpu"))
        parts.append({k: float(v.detach()) for k, v in occuseg_total_loss(
            out, b, 1, config["instance_cap"], trainer.loss_cfg)[1].items()})
        stats.append({n: t.clone() for n, t in
                      trainer.model.named_buffers()})
    for k, v in result["losses"].items():
        np.testing.assert_allclose(v, (parts[0][k] + parts[1][k]) / 2,
                                   rtol=1e-4, atol=1e-5, err_msg=k)
    for n, t in stats[0].items():
        if n.rsplit(".", 1)[-1] in ("running_mean", "running_var"):
            want = (t + stats[1][n]) / 2
            np.testing.assert_allclose(saved[n].numpy(), want.numpy(),
                                       rtol=1e-5, atol=1e-5 * float(
                                           want.abs().max()), err_msg=n)
