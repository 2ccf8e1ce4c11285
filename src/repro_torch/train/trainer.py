"""Training loop: train steps from `build_train_step` over the
deterministic synthetic token stream, with the deferred metrics flush
(`log_every`), a `train.step` span per step and the `train.step_s`
histogram and `train.history` series on the trainer's own metrics
registry, asynchronous checkpoints, heartbeats, loss-spike telemetry and
resume from the newest committed checkpoint (including the data stream's
position), as in the JAX package's `train/trainer.py`.

On a mesh of several ranks (`tcfg.mesh`, one process per device under
`torch.distributed`) every rank builds the same global batch from the
seed and trains on its own rows of it, in the JAX batch sharding's order;
the metrics are the means over the ranks, so every rank's history is the
same.

LMS (`tcfg.lms.enabled`, the default): the trainer plans the step's
memory with `core/lms/planner.plan` on `tcfg.mesh`, as the JAX trainer
does, from the hardware model or a calibration `profile`; the train step
executes the plan and the state is placed as it says. On a mesh of
several ranks (LMS + DDL) every rank plans the same step and places its
own state: its pinned arena is its process's own.

DDL's zero1 mode (`tcfg.ddl.mode == "zero1"`) trains with
`build_zero1_train_step` from `init_zero1_state`, as the JAX trainer does:
the AdamW state sharded over the data ranks, placed as the plan says.

Checkpoints (`checkpoint/checkpointer.py`), every `checkpoint_every` steps
and at the end, into `tcfg.checkpoint_dir`, in the JAX package's layout:
`step`, `params` and `opt` (zero1: `step`, `params`, `mu`, `nu`,
`master`); the grads' host sink is not part of one. The replicated leaves
are written by data rank 0 only, each rank's zero1 blocks by that rank.

Tensor parallelism (a `model` axis above 1, the dense stacks): every
`model` rank of a data-parallel group takes the same rows
(`Mesh.dp_index` leaves `model` out), and each holds its blocks of the
sharded leaves (`init_train_state(mesh=)`). A checkpoint keeps the global
layout in blocks (`checkpoint/checkpointer.py`): the data-0 rank of each
`model` index writes its blocks of the sharded leaves as its own shard,
`model` 0 the replicated leaves and the counters; a resume reads this
rank's blocks back, and a restore on a mesh without the `model` axis
joins them into the global leaves.
A save copies only the leaves on the card; leaves in host memory (the
pinned arena under a plan) are written by the writer thread where they
lie, and the next step's optimizer update waits for it
(`step_fn.before_update`), so its forward and backward overlap the write.
A restore reads each leaf into its slot of the plan's placement
(`restore_train_state`, `restore_zero1_state`). Where the port departs
from the JAX trainer: `checkpoint_dir=None` means no checkpoints at all
(no `Checkpointer`, no save, no resume). A run that measures steps at a
depth whose state is tens of GB would otherwise write it at the end, and
runs sharing the default directory would resume from one another.

A `FaultInjector` (`runtime/inject.py`) threads through the loop for the
crash-recovery drills: site ``trainer.step`` before each step dispatch,
``heartbeat`` at the per-step beat (kinds "dead" and "torn"), and the
checkpointer's ``ckpt.save`` and ``ckpt.commit``. All hooks are no-ops
without an injector.

Not ported yet: the VLM and audio batches.
"""
from __future__ import annotations

import os
import time
from typing import Callable, Dict, Optional

import torch
import torch.distributed as dist

from repro_torch.checkpoint import Checkpointer
from repro_torch.config.base import TrainConfig
from repro_torch.core.lms.planner import PlanRequest, plan as plan_lms
from repro_torch.data import DataLoader, SyntheticTokens, local_rows
from repro_torch.launch.mesh import local_device, make_mesh, mesh_axis_sizes
from repro_torch.models import sharding as shd
from repro_torch.models.model import Model
from repro_torch.obs import Obs, TelemetryLoop
from repro_torch.runtime import HeartbeatStore, StepTimer, inject
from repro_torch.serve.engine import resolve_device
from repro_torch.train.steps import (build_train_step, build_zero1_train_step,
                                     init_train_state, init_zero1_state,
                                     restore_train_state, restore_zero1_state)


class Trainer:
    def __init__(self, tcfg: TrainConfig, *, attn_impl: str = "blockwise",
                 device=None, process: Optional[int] = None,
                 heartbeat_dir: Optional[str] = None, injector=None,
                 obs: Optional[Obs] = None,
                 telemetry: Optional[TelemetryLoop] = None, profile=None):
        self.tcfg = tcfg
        self.mesh = make_mesh(tcfg.mesh)
        self.device = resolve_device(local_device() if device is None else device)
        # a private registry over the shared span ring, as the JAX trainer's;
        # a supplied telemetry loop records its alerts here
        self.obs = obs if obs is not None else Obs()
        self.telemetry = telemetry
        if telemetry is not None and telemetry.obs is None:
            telemetry.obs = self.obs
        # the heartbeat's process id: this rank unless given
        self.process = self.mesh.rank if process is None else process
        self._inj = injector
        self.model = Model(tcfg.model, attn_impl=attn_impl)
        # profile: a Planner v2 calibration source (obs_report.json path,
        # loaded dict, or CostModel); None plans from the hardware model
        self.plan = (plan_lms(PlanRequest(
                        cfg=tcfg.model, shape=tcfg.shape, mesh=tcfg.mesh,
                        lms=tcfg.lms, optimizer=tcfg.optimizer,
                        zero1=(tcfg.ddl.mode == "zero1"),
                        microbatches=tcfg.microbatches), profile=profile)
                     if tcfg.lms.enabled else None)
        self.ckpt = None
        if tcfg.checkpoint_dir is not None:
            # the commit's barriers, on a gloo group of their own: they run
            # on the writer thread beside the step's collectives
            group = (dist.new_group(backend="gloo") if self.mesh.spec.num_devices > 1
                     else None)
            self.ckpt = Checkpointer(tcfg.checkpoint_dir, async_save=tcfg.async_checkpoint,
                                     injector=injector, group=group, obs=self.obs)
        self.hb = HeartbeatStore(heartbeat_dir) if heartbeat_dir else None
        self.timer = StepTimer()
        self.zero1 = tcfg.ddl.mode == "zero1"
        build = build_zero1_train_step if self.zero1 else build_train_step
        self.step_fn = build(self.model, tcfg, plan=self.plan, mesh=self.mesh)
        if self.ckpt is not None:
            self.step_fn.before_update = _writer_wait(
                self.ckpt, self.obs.registry.histogram("ckpt.wait_s"))
        self.loader = DataLoader(
            SyntheticTokens(tcfg.model.vocab_size, seed=tcfg.seed),
            shard=0, num_shards=1, batch_per_shard=tcfg.shape.global_batch,
            seq_len=tcfg.shape.seq_len)

    # ---- state ---------------------------------------------------------
    def _data_size(self) -> int:
        return mesh_axis_sizes(self.mesh).get("data", 1)

    def init_state(self):
        if self.zero1:
            return init_zero1_state(self.model, self.tcfg, self.tcfg.seed, self.device,
                                    self._data_size(), plan=self.plan,
                                    data_index=self.mesh.index("data"))
        return init_train_state(self.model, self.tcfg, self.tcfg.seed,
                                self.device, plan=self.plan, mesh=self.mesh)

    def resume_or_init(self):
        """-> (state, the step it is after): the newest committed
        checkpoint's, placed as the plan says, and the data stream moved to
        its position; else a fresh state at step 0."""
        if self.ckpt is None or self.ckpt.latest_step() is None:
            return self.init_state(), 0
        process = self.mesh.index("data") if self.zero1 else self.mesh.index("model")
        with self.ckpt.open(process=process) as reader:
            if self.zero1:
                state = restore_zero1_state(reader, self.model, self.tcfg, self.device,
                                            self._data_size(), plan=self.plan,
                                            data_index=self.mesh.index("data"))
            else:
                state = restore_train_state(reader, self.model, self.tcfg, self.device,
                                            plan=self.plan, mesh=self.mesh)
            if reader.extra.get("data_state"):
                self.loader.restore(reader.extra["data_state"])
            return state, reader.step

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
        time_s, ce, aux}) of the steps this call ran, from the newest
        committed checkpoint on (`resume_or_init`). Metrics stay on the
        device until a flush step (every log_every steps and the last),
        which syncs inside its timed span; the other steps' time_s is the
        host's dispatch time. on_step and the telemetry loop see each row at
        its flush, in step order."""
        state, start = self.resume_or_init()
        steps = steps or self.tcfg.total_steps
        log_every = max(1, self.tcfg.log_every)
        every = self.tcfg.checkpoint_every
        series = self.obs.registry.series("train.history")
        step_hist = self.obs.registry.histogram("train.step_s")
        metrics_hist: list = []
        pending: list = []
        stop = False

        def _flush():
            nonlocal stop
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
                if self.telemetry is not None:
                    self.telemetry.observe(step, row)
                    stop = stop or self.telemetry.stop_requested
            pending.clear()

        for i in range(start, steps):
            self.timer.start()
            # the crash drill's kill point: before the step dispatch, so the
            # step that dies was never applied
            inject.maybe(self._inj, "trainer.step")
            flush_now = (i + 1) % log_every == 0 or i + 1 == steps
            with self.obs.span("train.step", step=i + 1):
                batch = self._make_batch()
                state, metrics = self.step_fn(state, batch)
                if flush_now:
                    self._sync()
            dt = self.timer.stop()
            step_hist.observe(dt)
            pending.append((i + 1, metrics, dt))
            if self.hb:
                self._beat(i + 1, dt)
            if flush_now:
                _flush()
            if self.ckpt is not None and ((i + 1) % every == 0 or i + 1 == steps):
                self.save(i + 1, state)
            if stop:
                # telemetry early stop: checkpoint what there is, end cleanly
                if self.ckpt is not None and (i + 1) % every and i + 1 != steps:
                    self.save(i + 1, state)
                break
        if self.ckpt is not None:
            self.ckpt.wait()
        return state, metrics_hist

    def _beat(self, step: int, dt: float):
        """Heartbeat with injectable failure modes: "dead" drops the beat
        entirely (the process looks gone to the FailureDetector after its
        timeout); "torn" writes an unparseable file in its place (a beat
        torn mid-write: read_all treats it as missing this round)."""
        ev = self._inj.poke("heartbeat") if self._inj is not None else None
        if ev is not None and ev.kind == "dead":
            return
        if ev is not None and ev.kind == "torn":
            with open(os.path.join(self.hb.dir, f"hb_{self.process}.json"), "w") as f:
                f.write('{"process": ')  # torn mid-write
            return
        self.hb.beat(self.process, step, dt)

    def save(self, step: int, state):
        """Checkpoint `state` as step `step`: this rank's leaves (all of
        them on data rank 0, and each rank's own zero1 blocks; under tensor
        parallelism each `model` rank's blocks of the sharded leaves, with
        the replicated ones on `model` 0), the data stream's position in
        the manifest. The device is synchronized first: the step's last
        copies into the pinned arena run on a side stream, and the writer
        reads the arena from the host."""
        self._sync()
        first = self.mesh.dp_index == 0
        if self.zero1:
            shard = ({"mu": state.mu, "nu": state.nu, "master": state.master}
                     if self.mesh.index("pod") == 0 else None)
            if first:
                shard = {"step": state.step, "params": state.params, **shard}
            where = dict(process=self.mesh.index("data"), num_processes=self._data_size())
        elif shd.tp(self.mesh) is not None:
            m = self.mesh.index("model")
            shard = None
            if first:
                keep = shd.sharded_tree(self.model.param_defs(), self.mesh)
                opt = dict(state.opt._asdict())
                shard = {"params": state.params, "opt": opt}
                if m == 0:
                    shard["step"] = state.step
                else:
                    # the replicated leaves and the counters are model 0's
                    shard = {"params": _only(state.params, keep),
                             "opt": {k: _only(v, keep) for k, v in opt.items()
                                     if k != "step"}}
            where = dict(process=m, num_processes=shd.model_size(self.mesh))
        else:
            shard = ({"step": state.step, "params": state.params,
                      "opt": dict(state.opt._asdict())} if first else None)
            where = dict(process=0, num_processes=1)
        self.ckpt.save(step, shard, extra={"data_state": self.loader.snapshot()}, **where)


def _only(tree, keep):
    """The leaves of `tree` where the tree of bools `keep` is True, with
    the subtrees left without a leaf dropped."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            sub = _only(v, keep[k])
            if sub:
                out[k] = sub
        elif keep[k]:
            out[k] = v
    return out


def _writer_wait(ckpt: Checkpointer, waits):
    """The step's `before_update`: wait for the checkpoint writer, which may
    still be reading the state where it lies, and observe the seconds
    waited in `waits` (the trainer's ``ckpt.wait_s`` histogram). A closure
    over the two, not a method: the step must not hold the trainer."""
    def wait() -> None:
        t0 = time.monotonic()
        ckpt.wait()
        waits.observe(time.monotonic() - t0)
    return wait
