"""Training loop: train steps from `build_train_step` over the
deterministic synthetic token stream, with the deferred metrics flush
(`log_every`), a `train.step` span per step and the `train.step_s`
histogram and `train.history` series on the trainer's own metrics
registry, as in the JAX package.

On a mesh of several ranks (`tcfg.mesh`, one process per device under
`torch.distributed`) every rank builds the same global batch from the
seed and trains on its own rows of it, in the JAX batch sharding's order;
the metrics are the means over the ranks, so every rank's history is the
same.

LMS (`tcfg.lms.enabled`, the default): the trainer plans the step's
memory with `core/lms/planner.plan`, as the JAX trainer does, from the
hardware model or a calibration `profile`; the train step executes the
plan and the state is placed as it says. On one device only: a plan on a
mesh of several ranks raises "not ported yet" (LMS + DDL).

Not ported yet: checkpoints and resume, heartbeats, the fault injector,
loss-spike telemetry, the Supervisor, and the VLM and audio batches. The
trainer does not checkpoint.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, Optional

import torch

from repro_torch.config.base import TrainConfig
from repro_torch.core.lms.planner import PlanRequest, plan as plan_lms
from repro_torch.data import DataLoader, SyntheticTokens, local_rows
from repro_torch.launch.mesh import local_device, make_mesh
from repro_torch.models.model import Model
from repro_torch.obs import Obs
from repro_torch.serve.engine import resolve_device
from repro_torch.train.steps import build_train_step, init_train_state


class Trainer:
    def __init__(self, tcfg: TrainConfig, *, attn_impl: str = "blockwise",
                 device=None, obs: Optional[Obs] = None, profile=None):
        self.tcfg = tcfg
        self.mesh = make_mesh(tcfg.mesh)
        self.device = resolve_device(local_device() if device is None else device)
        # a private registry over the shared span ring, as the JAX trainer's
        self.obs = obs if obs is not None else Obs()
        self.model = Model(tcfg.model, attn_impl=attn_impl)
        # profile: a Planner v2 calibration source (obs_report.json path,
        # loaded dict, or CostModel); None plans from the hardware model
        self.plan = (plan_lms(PlanRequest(
                        cfg=tcfg.model, shape=tcfg.shape, mesh=tcfg.mesh,
                        lms=tcfg.lms, optimizer=tcfg.optimizer,
                        zero1=(tcfg.ddl.mode == "zero1"),
                        microbatches=tcfg.microbatches), profile=profile)
                     if tcfg.lms.enabled else None)
        self.step_fn = build_train_step(self.model, tcfg, plan=self.plan,
                                        mesh=self.mesh)
        self.loader = DataLoader(
            SyntheticTokens(tcfg.model.vocab_size, seed=tcfg.seed),
            shard=0, num_shards=1, batch_per_shard=tcfg.shape.global_batch,
            seq_len=tcfg.shape.seq_len)

    # ---- state ---------------------------------------------------------
    def init_state(self):
        return init_train_state(self.model, self.tcfg, self.tcfg.seed,
                                self.device, plan=self.plan)

    def _make_batch(self) -> Dict[str, torch.Tensor]:
        if self.tcfg.model.family in ("vlm", "audio"):
            raise NotImplementedError(
                f"{self.tcfg.model.family} batches are not ported yet")
        raw = local_rows(next(self.loader), self.mesh.dp_index, self.mesh.dp_size)
        return {k: torch.from_numpy(v).to(self.device) for k, v in raw.items()}

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ---- loop ----------------------------------------------------------
    def train(self, steps: Optional[int] = None,
              on_step: Optional[Callable] = None):
        """-> (final state, history rows {step, loss, grad_norm, lr,
        time_s, ce, aux}). Metrics stay on the device until a flush step
        (every log_every steps and the last), which syncs inside its timed
        span; the other steps' time_s is the host's dispatch time."""
        state = self.init_state()
        steps = steps or self.tcfg.total_steps
        log_every = max(1, self.tcfg.log_every)
        series = self.obs.registry.series("train.history")
        step_hist = self.obs.registry.histogram("train.step_s")
        metrics_hist: list = []
        pending: list = []

        def _flush():
            for step, metrics, dt in pending:
                row = {"step": step, "loss": float(metrics["loss"]),
                       "grad_norm": float(metrics["grad_norm"]),
                       "lr": float(metrics["lr"]), "time_s": dt,
                       "ce": float(metrics["ce"]),
                       "aux": float(metrics["aux"])}
                metrics_hist.append(row)
                series.append(row)
                if on_step:
                    on_step(step, row)
            pending.clear()

        for i in range(steps):
            t0 = time.monotonic()
            flush_now = (i + 1) % log_every == 0 or i + 1 == steps
            with self.obs.span("train.step", step=i + 1):
                batch = self._make_batch()
                state, metrics = self.step_fn(state, batch)
                if flush_now:
                    self._sync()
            dt = time.monotonic() - t0
            step_hist.observe(dt)
            pending.append((i + 1, metrics, dt))
            if flush_now:
                _flush()
        return state, metrics_hist
