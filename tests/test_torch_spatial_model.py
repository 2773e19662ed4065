"""The port's spatially sharded model (`occuseg_tpu_torch/parallel/`:
`comm.py`, `spatial.sharded_gather_conv`, `spatial_model.py`, the
`--spatial_shards` step and CLI) on the CPU, two gloo ranks, against the
JAX package's UNSHARDED functions (JAX's own tests pin its sharded
functions to those; calling them again costs minutes, and the sharding
arithmetic itself is held to JAX's bit for bit by
`tests/test_torch_spatial.py`):

* `extend_features` (and `halo_exchange`, its halos alone) and
  `all_sum`: forward and autograd gradients against the same gather (and
  sum) done unsharded in one process;
* `sharded_gather_conv` against JAX's `gather_conv` on
  `tests/test_spatial.py`'s level;
* `sharded_infer` of the (8, 16, 24) `LearningBWDenseUNet` with perturbed
  BN statistics against JAX's eval `model.apply` (`tests/
  test_spatial_model.py`'s case: caps (2048, 1024, 512), 2500 points,
  halo = pool = 256), every head on every real point within 1e-5 of its
  largest magnitude, the same outputs on both ranks;
* the train-mode forward: its outputs (1e-5), the gradients of a loss of
  its features (1e-4 of each tensor's largest magnitude, with a floor of
  1e-2 of the largest gradient, as `tests/test_torch_dp.py`: a gradient
  that is 0 in exact arithmetic holds only rounding) and the running
  statistics (1e-4) against JAX's `model.apply(train=True)`;
* two spatial steps (`Trainer.step(batch, shard_args=...)`: 6-term loss
  over the group, gradients averaged, Adam on each rank) against two of
  JAX's `make_train_step`: every loss part within 1e-5 relative (1e-6 of
  the total absolute), the parameters after them within JAX's own
  sharded tolerance (rtol 5e-3, atol 5e-5; Adam turns the rounding of a
  gradient that is nearly 0 into a step);
* with OCC_PALLAS_BCE=1 (the plain versions of kernels #6-#8 on the CPU),
  the sharded classification loss and its gradient against the unsharded
  one; the two shards' own radii differ from the scene's, so a radius not
  maximised over the shards fails it;
* `train.cli --spatial_shards 2`: one step through two spawned ranks,
  its loss parts those of the single-process step on the same batch, and
  `--spatial_shards 2 --num_devices 2` refused.

The ranks run `_rank` below, which imports neither jax nor the JAX
package (this module imports them only inside its fixtures).
"""

import os
import sys

import numpy as np
import pytest
import torch

from occuseg_tpu_torch.convert import from_flax
from occuseg_tpu_torch.core.topology import PlanSpec
from occuseg_tpu_torch.models import LearningBWDenseUNet
from occuseg_tpu_torch.native.plan import build_plan_host
from occuseg_tpu_torch.parallel import data_parallel as dp

torch.set_num_threads(2)

D = 2
PLANES = (8, 16, 24)
CAPS = (2048, 1024, 512)
P_CAP = 4096
I = 16
HALO = POOL = 256
LR = 1e-3
HEADS = ("features", "semantics", "embedding", "offset", "displacement",
         "bw", "occupancy")
PARTS = ("semantic_loss", "embedding_loss", "regression_loss",
         "displacement_loss", "classification_loss", "occupancy_loss",
         "instance_iou", "total")


def _scene(seed):
    from occuseg_tpu_torch.data.synthetic import SceneConfig, make_batch
    return make_batch(SceneConfig(num_points=2500, extent=40, num_objects=6),
                      1, P_CAP, I, seed=seed)


def _plan(batch):
    return build_plan_host(batch["coords"], PlanSpec(caps=CAPS))


def _model(state):
    model = LearningBWDenseUNet(PLANES, num_classes=20)
    model.load_state_dict(state)
    return model


# --- the ranks (spawned; torch and the port only) -----------------------

def _exchange_case(rank):
    """This rank's features and lists for `extend_features`: S = 40 rows
    of 6 channels, H = 5, P = 3, the lists filled from their front."""
    rng = np.random.default_rng(10 + rank)
    feats = rng.standard_normal((40, 6))
    lists = []
    for n, size in ((0 if rank == 0 else 4, 5), (4 if rank == 0 else 0, 5),
                    (2 + rank, 3)):
        a = np.full(size, -1, np.int32)
        a[:n] = rng.choice(40, n, replace=False)
        lists.append(a)
    weight = rng.standard_normal((40 + 2 * 5 + D * 3, 6))
    return feats, lists, weight


def _rank_exchange(rank, group):
    from occuseg_tpu_torch.parallel import comm
    feats, lists, weight = _exchange_case(rank)
    f = torch.tensor(feats, requires_grad=True)
    ext = comm.extend_features(f, *(torch.from_numpy(a) for a in lists), 5,
                               group)
    (ext * torch.from_numpy(weight)).sum().backward()
    halos = comm.halo_exchange(f.detach(), torch.from_numpy(lists[0]),
                               torch.from_numpy(lists[1]), 5, group)
    x = torch.tensor(np.arange(4.0) + rank, requires_grad=True)
    (comm.all_sum(x, group) * (rank + 1.0)).sum().backward()
    return dict(ext=ext.detach().numpy(), d_feats=f.grad.numpy(),
                halos=halos.numpy(), sum_grad=x.grad.numpy())


def _rank_gather_conv(rank, group, case):
    from occuseg_tpu_torch.parallel.spatial import (
        shard_level,
        sharded_gather_conv,
    )
    nbr, n, feats, w = case
    sh, dropped = shard_level(nbr, n, D, HALO)
    S = nbr.shape[0] // D
    args = tuple(torch.from_numpy(np.ascontiguousarray(getattr(sh, f)[rank]))
                 for f in ("nbr_local", "send_left", "send_right",
                           "publish")) + (HALO,)
    out = sharded_gather_conv(torch.from_numpy(feats[rank * S:(rank + 1) * S]),
                              args, torch.from_numpy(w), group)
    return dict(out=out.numpy(), dropped=dropped)


def _rank_infer(rank, group, case):
    from occuseg_tpu_torch.parallel.spatial_model import sharded_infer
    state, seed = case
    batch = _scene(seed)
    out = sharded_infer(_model(state), _plan(batch), batch["features"],
                        group, halo=HALO, pool=POOL)
    return {k: v.numpy() for k, v in out._asdict().items()}


def _rank_train_forward(rank, group, case):
    from occuseg_tpu_torch.parallel import comm
    from occuseg_tpu_torch.parallel.spatial_model import (
        gather_outputs,
        prepare_shard_args,
        sharded_train_forward,
    )
    state, seed = case
    batch = _scene(seed)
    model = _model(state)
    sa = prepare_shard_args(_plan(batch), D, HALO, POOL, rank=rank,
                            group=group).to("cpu")
    out = sharded_train_forward(model, sa, torch.from_numpy(
        batch["features"]))
    sv = sa.slot_valid[:, None]
    loss = comm.all_sum((torch.where(sv, out.features, 0.0) ** 2).sum(),
                        group) * 1e-3
    params = dict(model.named_parameters())
    grads = torch.autograd.grad(loss, list(params.values()),
                                allow_unused=True)   # the heads: none
    grads, _ = dp.allreduce_step(list(grads), {}, dp.bn_statistics(model),
                                 1.0, group)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(params.values(), grads)]
    feats = gather_outputs(out._replace(**{k: v.detach() for k, v in
                                           out._asdict().items()}),
                           sa, group).features
    return dict(loss=float(loss), features=feats.numpy(),
                grads={n: g.numpy() for n, g in zip(params, grads)},
                stats={n: b.numpy() for n, b in model.named_buffers()})


def _rank_step(rank, group, case):
    from occuseg_tpu_torch.parallel.spatial_model import prepare_shard_args
    from occuseg_tpu_torch.train.state import TrainConfig, Trainer
    state, seed = case
    batch = _scene(seed)
    model = _model(state)
    trainer = Trainer(model, "cpu", TrainConfig(lr=LR), num_instances=I)
    sa = prepare_shard_args(_plan(batch), D, HALO, POOL, rank=rank,
                            group=group)
    parts = [{k: float(v) for k, v in trainer.step(batch,
                                                   shard_args=sa).items()}
             for _ in range(2)]
    return dict(parts=parts, params={n: p.detach().numpy() for n, p in
                                     model.named_parameters()})


def _bce_inputs(seed):
    """Global per-point inputs of the classification loss: the scene's
    instances, scenes, labels and pose, random embeddings, bandwidths
    and displacements."""
    batch = _scene(seed)
    rng = np.random.default_rng(seed)
    P = batch["pose"].shape[0]
    return dict(e=rng.standard_normal((P, 8)).astype(np.float32) * 0.5,
                bw=rng.uniform(0.5, 1.5, (P, 2)).astype(np.float32),
                rx=(batch["pose"] + rng.standard_normal((P, 3)).astype(
                    np.float32) * 0.05),
                pose=batch["pose"], instance_id=batch["instance_id"],
                point_scene=batch["point_scene"], labels=batch["labels"])


def _bce_loss(inp, group=None):
    """(loss, miou, d loss / d e) of the classification loss over `inp`
    (numpy arrays: the whole scene, or this rank's rows)."""
    from occuseg_tpu_torch.losses.instance import classification_loss
    t = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in inp.items()}
    e = t["e"].clone().requires_grad_(True)
    loss, miou = classification_loss(e, t["bw"], t["rx"], t["pose"],
                                     t["instance_id"], t["point_scene"],
                                     t["labels"], 1, I, group=group)
    (d_e,) = torch.autograd.grad(loss, e)
    return float(loss), float(miou), d_e.numpy()


def _rank_bce(rank, group, seed):
    from occuseg_tpu_torch.ops.kernels import bce_loss
    from occuseg_tpu_torch.parallel.spatial_model import prepare_shard_args
    sa = prepare_shard_args(_plan(_scene(seed)), D, HALO, POOL, rank=rank,
                            group=group)
    inp = _bce_inputs(seed)
    mine = {k: np.take(v, sa.perm, axis=0) for k, v in inp.items()}
    for k in ("instance_id", "point_scene", "labels"):
        mine[k] = np.where(sa.slot_valid, mine[k], -1)
    os.environ["OCC_PALLAS_BCE"] = "1"
    try:
        assert bce_loss.supported(mine["e"].shape[0], I, 8)
        loss, miou, d_e = _bce_loss(mine, group)
    finally:
        os.environ.pop("OCC_PALLAS_BCE")
    # this shard's own radii, which the loss must not use
    seg = torch.from_numpy(mine["instance_id"]).int()
    x = torch.from_numpy(mine["pose"])
    valid = (seg >= 0)[:, None]
    idx = seg.clamp(min=0).long()
    cnt = torch.zeros(I).index_add_(0, idx, valid[:, 0].float())
    cnt = comm_sum(cnt, group)
    mp = comm_sum(torch.zeros(I, 3).index_add_(
        0, idx, torch.where(valid, x, 0.0)), group) / cnt.clamp(min=1)[:, None]
    mp4 = torch.nn.functional.pad(mp, (0, 1))
    local = bce_loss.radius_sq(torch.nn.functional.pad(x, (0, 1)), seg, mp4,
                               (mp4 * mp4).sum(1))
    return dict(loss=loss, miou=miou, d_e=d_e, perm=sa.perm,
                slot_valid=sa.slot_valid, local_r_sq=local.numpy())


def comm_sum(x, group):
    from occuseg_tpu_torch.parallel.comm import all_sum
    return all_sum(x, group)


def _rank(rank, world, cases):
    import torch.distributed as dist
    torch.set_num_threads(2)
    group = dist.group.WORLD
    return dict(exchange=_rank_exchange(rank, group),
                gather_conv=_rank_gather_conv(rank, group,
                                              cases["gather_conv"]),
                infer=_rank_infer(rank, group, cases["infer"]),
                train_forward=_rank_train_forward(rank, group,
                                                  cases["train_forward"]),
                step=_rank_step(rank, group, cases["step"]),
                bce=_rank_bce(rank, group, cases["bce"]))


# --- the references (this process) --------------------------------------

def _np(tree):
    import jax
    return jax.tree.map(np.asarray, tree)


def _port_name(path):
    keys = [str(k.key) for k in path]
    leaf = {"kernel": "weight", "scale": "weight", "mean": "running_mean",
            "var": "running_var"}.get(keys[-1], keys[-1])
    return ".".join(keys[:-1] + [leaf]), keys[-1] == "kernel"


def _by_port_name(tree):
    """{port name: numpy array in the port's layout} of a flax tree."""
    import jax
    out = {}
    for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]:
        name, transposed = _port_name(path)
        v = np.asarray(v)
        out[name] = v.T if transposed else v
    return out


def _perturbed(stats, rng):
    """BN statistics perturbed as `tests/test_spatial_model.py` does, so
    the eval BN is a real affine map."""
    import jax.numpy as jnp
    out = {}
    for k, v in stats.items():
        if isinstance(v, dict):
            out[k] = _perturbed(v, rng)
        elif k == "running_mean":
            out[k] = jnp.asarray(
                rng.standard_normal(v.shape).astype(np.float32) * 0.3)
        else:
            out[k] = jnp.asarray(rng.uniform(0.5, 1.5, v.shape).astype(
                np.float32))
    return out


@pytest.fixture(scope="module")
def refs():
    """JAX's unsharded references and the initial weights (in the port's
    state-dict form) of each case."""
    import jax
    import jax.numpy as jnp
    from occuseg_tpu.core.topology import PlanSpec as JaxPlanSpec
    from occuseg_tpu.models import LearningBWDenseUNet as JaxLearningBW
    from occuseg_tpu.ops.conv import gather_conv as jax_gather_conv
    from occuseg_tpu.train import state as jax_state
    from tests.jax_planner import host_plan
    from tests.test_torch_spatial import _spatial_level

    def port_state(variables):
        return from_flax(_np(variables["params"]),
                         _np(variables["batch_stats"]),
                         LearningBWDenseUNet(PLANES, num_classes=20))

    model = JaxLearningBW(n_planes=PLANES, num_classes=20)
    out = {}

    nbr, n = _spatial_level()
    rng = np.random.default_rng(0)
    feats = np.zeros((nbr.shape[0], 8), np.float32)
    feats[:n] = rng.standard_normal((n, 8), dtype=np.float32)
    w = (rng.standard_normal((27, 8, 8)) * 0.2).astype(np.float32)
    out["gather_conv"] = ((nbr, n, feats, w), np.asarray(jax_gather_conv(
        jnp.asarray(feats), jnp.asarray(nbr), jnp.asarray(w))))

    def setup(seed, key):
        batch = _scene(seed)
        plan = jax.tree.map(jnp.asarray, host_plan(batch["coords"],
                                                   JaxPlanSpec(caps=CAPS)))
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        return batch, plan, jb, model.init(jax.random.PRNGKey(key),
                                           jb["features"], plan, False)

    # eval: tests/test_spatial_model.py's case
    batch, plan, jb, variables = setup(0, 0)
    variables = {"params": variables["params"], "batch_stats": _perturbed(
        variables["batch_stats"], np.random.default_rng(1))}
    ev = jax.jit(lambda v, f, p: model.apply(v, f, p, False))(
        variables, jb["features"], plan)
    out["infer"] = ((port_state(variables), 0),
                    {k: np.asarray(getattr(ev, k)) for k in HEADS},
                    np.asarray(plan.p2v) >= 0)

    # train-mode forward, the gradients of a loss of its features
    batch, plan, jb, variables = setup(1, 3)
    params, stats = variables["params"], variables["batch_stats"]
    valid = np.asarray(plan.p2v) >= 0

    def loss_ref(p):
        o, mut = model.apply({"params": p, "batch_stats": stats},
                             jb["features"], plan, True,
                             mutable=["batch_stats"])
        return (jnp.sum(jnp.where(jnp.asarray(valid)[:, None], o.features,
                                  0) ** 2) * 1e-3,
                (o.features, mut["batch_stats"]))
    (loss, (feats_ref, new_stats)), grads = jax.jit(jax.value_and_grad(
        loss_ref, has_aux=True))(params)
    out["train_forward"] = ((port_state(variables), 1),
                            dict(loss=float(loss),
                                 features=np.asarray(feats_ref),
                                 grads=_by_port_name(grads),
                                 stats=_by_port_name(new_stats)), valid)

    # two steps of make_train_step
    batch, plan, jb, variables = setup(2, 4)
    st = jax_state.TrainState(
        params=variables["params"], batch_stats=variables["batch_stats"],
        opt_state=jax_state.make_optimizer(jax_state.TrainConfig(
            lr=LR)).init(variables["params"]), step=jnp.zeros((), jnp.int32))
    step = jax.jit(jax_state.make_train_step(
        model, JaxPlanSpec(caps=CAPS), jax_state.TrainConfig(lr=LR),
        num_instances=I))
    parts = []
    for _ in range(2):
        st, p = step(st, jb, plan)
        parts.append({k: float(v) for k, v in p.items()})
    out["step"] = ((port_state(variables), 2),
                   dict(parts=parts, params=_by_port_name(st.params)))
    out["bce"] = 2
    return out


@pytest.fixture(scope="module")
def ranks(refs):
    cases = {k: (v[0] if isinstance(v, tuple) else v)
             for k, v in refs.items()}
    return dp.spawn(_rank, D, "cpu", cases)


def _close(got, want, frac, what, scale=0.0):
    want = np.asarray(want)
    got = np.asarray(got)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(
        got, want, rtol=0,
        atol=frac * max(np.abs(want).max(), scale, 1e-30), err_msg=what)


def test_extend_features_and_its_adjoint(ranks):
    """Each rank's extended rows are the unsharded gather of the ranks'
    rows, and the gradient of sum_r <ext_r, W_r> is the unsharded
    gather's transpose: the halo rows' cotangents added into the senders'
    rows, the pool rows' summed over the ranks."""
    cases = [_exchange_case(r) for r in range(D)]
    feats = [torch.tensor(c[0], requires_grad=True) for c in cases]
    S, H, P = 40, 5, 3
    total = 0
    for r in range(D):
        left = cases[(r - 1) % D][1][1]    # the left neighbour's right list
        right = cases[(r + 1) % D][1][0]   # the right neighbour's left list
        zero = torch.zeros(6, dtype=torch.float64)

        def gather(src, lst):
            return torch.stack([feats[src][i] if i >= 0 else zero
                                for i in lst])
        ext = torch.cat([feats[r], gather((r - 1) % D, left),
                         gather((r + 1) % D, right)]
                        + [gather(o, cases[o][1][2]) for o in range(D)])
        assert ext.shape == (S + 2 * H + D * P, 6)
        np.testing.assert_array_equal(ranks[r]["exchange"]["ext"],
                                      ext.detach().numpy())
        # the halos alone (no pool)
        np.testing.assert_array_equal(ranks[r]["exchange"]["halos"],
                                      ext[:S + 2 * H].detach().numpy())
        total = total + (ext * torch.from_numpy(cases[r][2])).sum()
    total.backward()
    for r in range(D):
        np.testing.assert_allclose(ranks[r]["exchange"]["d_feats"],
                                   feats[r].grad.numpy(), rtol=1e-12,
                                   atol=1e-12)


def test_all_sum_and_its_adjoint(ranks):
    """y = sum_r x_r on every rank; the gradient of sum_r <y, w_r> with
    w_r = r + 1 is sum_r w_r on every rank."""
    for r in range(D):
        np.testing.assert_array_equal(ranks[r]["exchange"]["sum_grad"],
                                      np.full(4, D * (D + 1) / 2))


def test_sharded_gather_conv_matches_jax(refs, ranks):
    (nbr, n, _, _), ref = refs["gather_conv"]
    got = np.concatenate([ranks[r]["gather_conv"]["out"] for r in range(D)])
    assert ranks[0]["gather_conv"]["dropped"] == 0
    _close(got, ref, 1e-5, "sharded_gather_conv")


@pytest.mark.parametrize("head", HEADS)
def test_sharded_infer_matches_jax(refs, ranks, head):
    _, ref, valid = refs["infer"]
    assert valid.sum() > 2000
    for r in range(D):
        got = ranks[r]["infer"][head]
        _close(got[valid], ref[head][valid], 1e-5, f"rank {r} {head}")
    # pad rows are zero, and both ranks return the same global outputs
    assert not ranks[0]["infer"][head][~valid].any()
    np.testing.assert_array_equal(ranks[0]["infer"][head],
                                  ranks[1]["infer"][head])


def test_train_forward_matches_jax(refs, ranks):
    _, ref, valid = refs["train_forward"]
    for r in range(D):
        got = ranks[r]["train_forward"]
        np.testing.assert_allclose(got["loss"], ref["loss"], rtol=1e-5)
        _close(got["features"][valid], ref["features"][valid], 1e-5,
               f"rank {r} features")


def test_train_forward_gradients_match_jax(refs, ranks):
    _, ref, _ = refs["train_forward"]
    top = max(np.abs(g).max() for g in ref["grads"].values())
    for r in range(D):
        got = ranks[r]["train_forward"]["grads"]
        assert got.keys() == ref["grads"].keys()
        for name, want in ref["grads"].items():
            _close(got[name], want, 1e-4, f"rank {r} {name}",
                   scale=1e-2 * top)


def test_train_forward_statistics_match_jax(refs, ranks):
    _, ref, _ = refs["train_forward"]
    for r in range(D):
        got = ranks[r]["train_forward"]["stats"]
        assert got.keys() == ref["stats"].keys()
        for name, want in ref["stats"].items():
            _close(got[name], want, 1e-4, f"rank {r} {name}")


@pytest.mark.parametrize("part", PARTS)
def test_spatial_steps_match_jax(refs, ranks, part):
    _, ref = refs["step"]
    for i in range(2):
        want = ref["parts"][i][part]
        for r in range(D):
            np.testing.assert_allclose(
                ranks[r]["step"]["parts"][i][part], want, rtol=1e-5,
                atol=1e-6 * abs(ref["parts"][i]["total"]),
                err_msg=f"step {i} rank {r} {part}")


def test_spatial_step_parameters_match_jax(refs, ranks):
    """JAX's own sharded-against-unsharded tolerance on the parameters
    (`tests/test_spatial_model.py`: rtol 5e-3, atol 5e-5): Adam divides
    each gradient by its running magnitude, so a gradient that is nearly
    0 in exact arithmetic (the embedding heads' biases: the embedding
    loss hardly moves under a shift) turns its rounding into up to lr of
    step. The loss parts of the second step, which read the first step's
    parameters, are held to 1e-5 above; the ranks' parameters are the
    same bit for bit."""
    _, ref = refs["step"]
    for name, want in ref["params"].items():
        for r in range(D):
            np.testing.assert_allclose(ranks[r]["step"]["params"][name],
                                       want, rtol=5e-3, atol=5e-5,
                                       err_msg=f"rank {r} {name}")
        np.testing.assert_array_equal(ranks[0]["step"]["params"][name],
                                      ranks[1]["step"]["params"][name])


def test_bce_kernel_path_sharded_equals_unsharded(ranks, monkeypatch):
    """OCC_PALLAS_BCE=1: the radius is maximised over the shards between
    #6 and #7, and the sums summed after #7, so the sharded loss is the
    scene's. Each shard alone would see a smaller radius for some
    instance (the check's power)."""
    from occuseg_tpu_torch.ops.kernels import bce_loss
    inp = _bce_inputs(2)
    monkeypatch.setenv("OCC_PALLAS_BCE", "1")
    assert bce_loss.supported(P_CAP, I, 8)
    loss, miou, d_e = _bce_loss(inp)
    x = torch.from_numpy(inp["pose"])
    seg = torch.from_numpy(inp["instance_id"]).int()
    valid = (seg >= 0)[:, None]
    idx = seg.clamp(min=0).long()
    cnt = torch.zeros(I).index_add_(0, idx, valid[:, 0].float())
    mp = torch.zeros(I, 3).index_add_(0, idx, torch.where(
        valid, x, 0.0)) / cnt.clamp(min=1)[:, None]
    mp4 = torch.nn.functional.pad(mp, (0, 1))
    whole = bce_loss.radius_sq(torch.nn.functional.pad(x, (0, 1)), seg, mp4,
                               (mp4 * mp4).sum(1)).numpy()
    assert any((ranks[r]["bce"]["local_r_sq"] < whole).any()
               for r in range(D))
    for r in range(D):
        got = ranks[r]["bce"]
        np.testing.assert_allclose(got["loss"], loss, rtol=1e-5)
        np.testing.assert_allclose(got["miou"], miou, rtol=1e-5)
        # each rank's backward runs the replicated loss, so the joint
        # objective is D * L: a point's gradient is D times the scene's
        rows = got["perm"][got["slot_valid"]]
        _close(got["d_e"][got["slot_valid"]] / D, d_e[rows], 1e-5,
               f"rank {r} d loss / d e")


def _cli_flags(tmp_path, *extra):
    return ["--m", "8", "--batch_size", "2", "--scale", "50",
            "--residual_blocks", "--use_dense_model", "--max_epoch", "1",
            "--point_cap", "8192", "--voxel_cap", "6144",
            "--instance_cap", "16", "--checkpoints_dir", str(tmp_path),
            "--data_dir", str(tmp_path / "no_scenes"), *extra]


def test_cli_spatial_shards_two_ranks_one_step(tmp_path, monkeypatch):
    """`--spatial_shards 2` on the CPU: two spawned gloo ranks shard one
    batch of two synthetic scenes; the step's loss parts are the
    single-process step's on the same batch."""
    from occuseg_tpu_torch.losses.instance import occuseg_total_loss
    from occuseg_tpu_torch.train import cli, loop, state
    from occuseg_tpu_torch.train.config import args_to_config, get_parser
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    # caps that hold the batch: points past a full cap drop out of a
    # sharded loss (they belong to no shard), as in the JAX package
    argv = _cli_flags(tmp_path, "--spatial_shards", "2", "--spatial_halo",
                      "2048", "--spatial_pool", "1024", "--voxel_cap",
                      "12288", "--taskname", "sp")
    result = cli.main(argv, device="cpu", max_steps=1)
    assert result["steps"] == 1
    assert 0.0 <= result["metrics"]["mean_iou"] <= 1.0
    assert os.path.exists(tmp_path / "sp" / "step_1.pth")

    config = args_to_config(get_parser().parse_args(argv))
    batch = next(loop._synthetic_dataset(config).train_batches(
        np.random.default_rng(100), config["point_cap"],
        config["instance_cap"], 2))
    # the whole batch's plan in one layout over the two scenes, as the
    # ranks shard it
    plan = build_plan_host(batch["coords"], loop.build_spec(config))
    assert all(lv.num_active < lv.cap for lv in plan.levels)
    trainer = loop.build_trainer(config, "cpu", 2)
    b = {k: torch.as_tensor(batch[k]) for k in state._BATCH_KEYS}
    out = trainer.model.train()(b["features"], plan.to("cpu"))
    _, parts = occuseg_total_loss(out, b, 2, config["instance_cap"],
                                  trainer.loss_cfg)
    for k, v in parts.items():
        np.testing.assert_allclose(result["losses"][k], float(v), rtol=1e-4,
                                   atol=1e-5, err_msg=k)


def test_cli_refuses_spatial_shards_with_data_parallelism(tmp_path):
    from occuseg_tpu_torch.train import cli, loop
    with pytest.raises(ValueError, match="do not combine"):
        cli.main(_cli_flags(tmp_path, "--spatial_shards", "2",
                            "--num_devices", "2"), device="cpu")
    from occuseg_tpu_torch.train.config import args_to_config, get_parser
    config = args_to_config(get_parser().parse_args(_cli_flags(
        tmp_path, "--spatial_shards", "2", "--num_devices", "2")))
    with pytest.raises(ValueError, match="do not combine"):
        loop._spatial(config, 0, 2)
