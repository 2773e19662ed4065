"""The PyTorch port's training losses against the JAX package on the CPU.

Random model outputs for two scenes of 8 instances (NumPy, seeded) go
through `occuseg_total_loss` of both packages: every loss part and the
gradients with respect to all 7 outputs. Tolerance: f32 sums in another
order; the parts at rtol=1e-5, the gradients at rtol=1e-4 with an atol of
1e-5 of the largest magnitude (the [P, I] classification chain takes
square roots of differences of sums)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from occuseg_tpu.losses import instance as jax_loss
from occuseg_tpu.models.occuseg import OccuSegOutputs as JaxOutputs

from occuseg_tpu_torch.losses import instance as loss
from occuseg_tpu_torch.models import OccuSegOutputs

torch.set_num_threads(2)

P, S, I, C, E = 1800, 2, 8, 20, 16
FIELDS = ("semantics", "features", "embedding", "offset", "displacement",
          "bw", "occupancy")


def _batch_and_outputs(seed):
    """Two scenes (rows [0, 800) and [800, 1600), the rest padding), 4
    instances each (some rows background), labels with foreground and
    wall/floor classes, and random outputs of a model with m=16."""
    rng = np.random.default_rng(seed)
    n = 1600
    scene = np.full(P, S, np.int32)
    scene[:800], scene[800:n] = 0, 1
    iid = np.full(P, -1, np.int32)
    iid[:n] = rng.integers(0, 4, n) + 4 * scene[:n]
    iid[:n][rng.random(n) < 0.15] = -1          # background
    labels = np.full(P, -1, np.int32)
    inst_cls = rng.integers(0, C, I)
    inst_cls[[1, 6]] = 0                        # two wall/floor instances
    labels[:n] = np.where(iid[:n] >= 0, inst_cls[np.maximum(iid[:n], 0)],
                          rng.integers(0, C, n))
    pose = np.zeros((P, 3), np.float32)
    pose[:n] = (rng.standard_normal((n, 3)) + 3 * iid[:n, None] % 5
                ).astype(np.float32)
    batch = {
        "labels": labels, "instance_id": iid, "point_scene": scene,
        "pose": pose,
        "offsets": rng.random((P, 1)).astype(np.float32),
        "displacements": (rng.standard_normal((P, 3)) * 0.5
                          ).astype(np.float32),
        "occupancy": (rng.random((P, 1)) * 4).astype(np.float32),
    }
    outs = {
        "semantics": rng.standard_normal((P, C)),
        "features": rng.standard_normal((P, E)),
        "embedding": rng.standard_normal((P, E)) * 0.5,
        "offset": rng.random((P, 1)),
        "displacement": rng.standard_normal((P, 3)) * 0.5,
        "bw": rng.random((P, 2)) + 0.2,
        "occupancy": rng.random((P, 1)) * 4,
    }
    return batch, {k: v.astype(np.float32) for k, v in outs.items()}


def _jax_loss(batch, outs, cfg_kw):
    cfg = jax_loss.LossConfig(**cfg_kw)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def fn(o):
        return jax_loss.occuseg_total_loss(JaxOutputs(**o), jb, S, I, cfg)

    (_, parts), grads = jax.value_and_grad(fn, has_aux=True)(
        {k: jnp.asarray(v) for k, v in outs.items()})
    return ({k: float(v) for k, v in parts.items()},
            {k: np.asarray(v) for k, v in grads.items()})


@pytest.mark.parametrize("semantic_loss", [
    "cross_entropy", "lovasz", "focal", "weighted_cross_entropy"])
def test_total_loss_parts_and_gradients_match_jax(semantic_loss):
    batch, outs = _batch_and_outputs(seed=len(semantic_loss))
    ref_parts, ref_grads = _jax_loss(batch, outs,
                                     dict(semantic_loss=semantic_loss))
    leaves = {k: torch.from_numpy(v).requires_grad_()
              for k, v in outs.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    total, parts = loss.occuseg_total_loss(
        OccuSegOutputs(**leaves), tb, S, I,
        loss.LossConfig(semantic_loss=semantic_loss))
    total.backward()
    assert set(parts) == set(ref_parts)
    for k, v in ref_parts.items():
        np.testing.assert_allclose(float(parts[k].detach()), v, rtol=1e-5,
                                   atol=1e-6,
                                   err_msg=k)
    assert ref_parts["classification_loss"] > 0
    assert ref_parts["displacement_loss"] > 0
    for k in FIELDS:
        ref = ref_grads[k]
        got = leaves[k].grad
        got = np.zeros_like(ref) if got is None else got.numpy()
        np.testing.assert_allclose(got, ref, rtol=1e-4,
                                   atol=1e-5 * max(np.abs(ref).max(), 1e-3),
                                   err_msg=k)


def test_segment_helpers_drop_out_of_range_ids():
    x = torch.tensor([1.0, 2.0, 3.0, 4.0])
    seg = torch.tensor([0, 2, 3, 2], dtype=torch.int32)
    np.testing.assert_array_equal(loss._seg_sum(x, seg, 3).numpy(),
                                  [1.0, 0.0, 6.0])
    np.testing.assert_array_equal(
        loss._seg_max(torch.tensor([5, 7, 9, 1]), seg, 3, -1).numpy(),
        [5, -1, 7])
    np.testing.assert_array_equal(
        loss._seg_lookup(torch.tensor([10.0, 20.0]),
                         torch.tensor([1, 2, 0]), 2).numpy(),
        [20.0, 0.0, 10.0])
