"""Inference entry points: host preparation of one scene and the predictor.

    scene = prepare_scene(batch["coords"], batch["features"], PlanSpec(caps))
    outputs = Predictor(model, "cuda")(scene)   # OccuSegOutputs, [P, ...]

`prepare_scene` runs on the host (NumPy + the C++ planner): the plan, its
chunk rulebooks (unless `chunks=False`: then every convolution takes the
gather path), and the sorted point layout with the features permuted
into it (a plan whose caps the layout does not fit has none, and keeps the
original order). `Predictor` moves the plan to the device, runs the
model's forward under `torch.inference_mode()`, and returns every output
in the request's original point order.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from occuseg_tpu_torch.core.point_layout import (
    apply_point_layout,
    augment_plan_with_point_layout,
)
from occuseg_tpu_torch.core.topology import PlanSpec, Topology
from occuseg_tpu_torch.models.occuseg import OccuSegOutputs
from occuseg_tpu_torch.native.blocked import build_plan_host_blocked
from occuseg_tpu_torch.ops.kernels import chunk_conv
from occuseg_tpu_torch.utils.profiling import span


@dataclasses.dataclass(frozen=True)
class PreparedScene:
    plan: Topology          # host plan with chunks and point layout
    features: np.ndarray    # [P, C] f32 point features in the layout order
    num_voxels: int         # active level-0 voxels

    @property
    def num_points(self) -> int:
        return self.features.shape[0]


def host_plan(coords: np.ndarray, spec: PlanSpec, ns: int = 1,
              normals: Optional[np.ndarray] = None) -> Topology:
    """The C++ planner's plan of coords [P, 4] int32 (b,z,y,x; -1 rows are
    padding) at `spec`, as the span `plan.host`: the blocked multi-scene
    layout for ns > 1 scenes, orientation classes from the points'
    `normals` [P, 3] when given. A spec only the device planner builds
    raises ValueError: plan it with `core.topology.build_plan`
    (`Trainer.step(batch, plan=None)`)."""
    with span("plan.host"):
        plan = build_plan_host_blocked(coords, spec, ns, normals)
    if plan is None:
        raise ValueError(f"the host planner does not build {spec}; plan it "
                         f"on the device (core.topology.build_plan)")
    return plan


def plan_scene(coords: np.ndarray, spec: PlanSpec, ns: int = 1,
               normals: Optional[np.ndarray] = None,
               chunks: bool = True) -> Topology:
    """Host plan as the benchmark builds it: `host_plan`, then its chunk
    rulebooks (with `chunks`) and sorted point layout (`augment_plan`)."""
    return augment_plan(host_plan(coords, spec, ns, normals), spec, chunks)


def augment_plan(plan: Topology, spec: PlanSpec,
                 chunks: bool = True) -> Topology:
    """A host plan of `spec` with its chunk rulebooks (none without
    `chunks`, the training CLI's --chunk_conv 0; the budgets grown by the
    spec's rule, `PlanSpec`) and sorted point layout; where the
    layout does not fit the caps, with the points per voxel alone (host
    data the InputLayer's mean divides by)."""
    if chunks:
        with span("plan.chunks"):
            plan = chunk_conv.augment_plan_with_chunks(
                plan, per_map=spec.chunk_escalation == "map")
    with span("plan.layout"):
        plan = augment_plan_with_point_layout(plan)
        if plan.vox_counts is None:
            p2v = np.asarray(plan.p2v)
            plan = dataclasses.replace(plan, vox_counts=np.bincount(
                p2v[p2v >= 0],
                minlength=plan.levels[0].cap).astype(np.float32))
    return plan


def prepare_scene(coords: np.ndarray, features: np.ndarray,
                  spec: PlanSpec, normals: Optional[np.ndarray] = None,
                  chunks: bool = True) -> PreparedScene:
    """Host preparation of one scene: its plan (`plan_scene`, with the
    points' `normals` for a normal-guided model, chunk rulebooks with
    `chunks`) and the features [P, C] permuted into the plan's point
    layout."""
    plan = plan_scene(coords, spec, normals=normals, chunks=chunks)
    with span("plan.layout"):
        laid = apply_point_layout(
            {"features": np.asarray(features, np.float32)}, plan)
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

    def forward(self, features: np.ndarray, plan: Topology
                ) -> OccuSegOutputs:
        """The eval-mode forward on a host plan: outputs in the plan's
        point-layout order."""
        return self._run(features, plan.to(self.device))

    def _run(self, features: np.ndarray, plan: Topology) -> OccuSegOutputs:
        self.model.eval()
        feats = torch.as_tensor(features).to(self.device, non_blocking=True)
        with torch.inference_mode():
            return self.model(feats, plan)

    def __call__(self, scene: PreparedScene) -> OccuSegOutputs:
        plan = scene.plan.to(self.device)
        out = self._run(scene.features, plan)
        if plan.point_perm is None:  # no layout: original order
            return out
        with torch.inference_mode():
            return type(out)(*(None if t is None
                               else unpermute(t, plan.point_perm)
                               for t in out))
