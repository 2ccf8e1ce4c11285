"""Elastic scaling: rebuild the mesh after membership changes and reshard
training state from the latest checkpoint. The data axis shrinks/grows to
the surviving pod slice; global batch is preserved by raising per-replica
batch (or grad-accumulation microbatches) accordingly.

A copy of the JAX package's `runtime/elastic.py` over the port's
`MeshSpec`: the same decision for the same mesh and device count.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import Optional, Tuple

from repro_torch.config.base import MeshSpec, TrainConfig


@dataclass
class ElasticDecision:
    mesh: MeshSpec
    microbatches: int
    note: str


def replan_mesh(cfg: TrainConfig, devices_available: int) -> ElasticDecision:
    """Choose the largest valid (data, model) mesh <= devices_available that
    keeps the model axis intact (TP degree is a model-correctness choice;
    only the DP extent is elastic — matching DDL's design where workers are
    interchangeable data ranks)."""
    axes = dict(zip(cfg.mesh.axes, cfg.mesh.shape))
    model = axes.get("model", 1)
    pods = axes.get("pod", 1)
    if devices_available < model:
        raise RuntimeError(
            f"cannot keep TP={model} with {devices_available} devices")
    data = max(devices_available // (model * pods), 1)
    # keep global batch: scale grad-accum by the DP shrink factor
    old_data = axes.get("data", 1)
    micro = cfg.microbatches * max(1, math.ceil(old_data / data))
    if pods > 1:
        mesh = MeshSpec((pods, data, model), ("pod", "data", "model"))
    else:
        mesh = MeshSpec((data, model), ("data", "model"))
    return ElasticDecision(
        mesh, micro,
        f"data axis {old_data}->{data}, microbatches {cfg.microbatches}->{micro}")


def apply_decision(cfg: TrainConfig, dec: ElasticDecision) -> TrainConfig:
    return replace(cfg, mesh=dec.mesh, microbatches=dec.microbatches)
