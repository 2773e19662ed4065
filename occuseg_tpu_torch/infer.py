"""Inference entry points: host preparation of one scene and the predictor.

    scene = prepare_scene(batch["coords"], batch["features"], PlanSpec(caps))
    outputs = Predictor(model, "cuda")(scene)   # OccuSegOutputs, [P, ...]

`prepare_scene` runs on the host (NumPy + the C++ planner): the plan, its
chunk rulebooks, and the sorted point layout with the features permuted
into it. `Predictor` moves the plan to the device, runs the model's
forward under `torch.inference_mode()`, and returns every output in the
request's original point order.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from occuseg_tpu_torch.core.point_layout import (
    apply_point_layout,
    augment_plan_with_point_layout,
)
from occuseg_tpu_torch.core.topology import PlanSpec, Topology
from occuseg_tpu_torch.models.occuseg import OccuSegOutputs
from occuseg_tpu_torch.native.plan import build_plan_host
from occuseg_tpu_torch.ops.kernels import chunk_conv


@dataclasses.dataclass(frozen=True)
class PreparedScene:
    plan: Topology          # host plan with chunks and point layout
    features: np.ndarray    # [P, C] f32 point features in the layout order
    num_voxels: int         # active level-0 voxels

    @property
    def num_points(self) -> int:
        return self.features.shape[0]


def plan_scene(coords: np.ndarray, spec: PlanSpec) -> Topology:
    """Host plan of one scene from coords [P, 4] int32 (b,z,y,x; -1 rows
    are padding), as the benchmark builds it: C++ planner, chunk
    rulebooks, sorted point layout."""
    plan = build_plan_host(coords, spec)
    plan = chunk_conv.augment_plan_with_chunks(plan)
    return augment_plan_with_point_layout(plan)


def prepare_scene(coords: np.ndarray, features: np.ndarray,
                  spec: PlanSpec) -> PreparedScene:
    """Host preparation of one scene: its plan (`plan_scene`) and the
    features [P, C] permuted into the plan's point layout."""
    plan = plan_scene(coords, spec)
    laid = apply_point_layout({"features": np.asarray(features, np.float32)},
                              plan)
    return PreparedScene(plan=plan, features=laid["features"],
                         num_voxels=int(plan.levels[0].num_active))


def unpermute(t: torch.Tensor, point_perm: torch.Tensor) -> torch.Tensor:
    """Rows in layout-slot order -> original point order (perm[slot] =
    original point, -1 pad slot). Points in no slot get zeros."""
    perm = point_perm.long()
    valid = perm >= 0
    out = torch.zeros_like(t)
    out[perm[valid]] = t[valid]
    return out


class Predictor:
    """Runs a model in eval mode on prepared scenes on one device."""

    def __init__(self, model: torch.nn.Module, device):
        self.device = torch.device(device)
        self.model = model.to(self.device).eval()

    def __call__(self, scene: PreparedScene) -> OccuSegOutputs:
        plan = scene.plan.to(self.device)
        feats = torch.from_numpy(scene.features).to(self.device)
        with torch.inference_mode():
            out = self.model(feats, plan)
            return OccuSegOutputs(*(None if t is None
                                    else unpermute(t, plan.point_perm)
                                    for t in out))
