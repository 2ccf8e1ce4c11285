"""Supervised training: the JAX package's `runtime/supervisor.py` for the
port, where a run is one process a rank and its state may lie in a pinned
host arena.

    supervise -> detect failure -> backoff -> restore last committed
    checkpoint -> reshard onto the surviving ranks -> resume

The Supervisor owns a TrainConfig and builds a `Trainer` from it for each
attempt. An attempt that dies on a caught fault (an `InjectedFault`, the
in-process stand-in for a lost peer) is restarted after the
RestartPolicy's delay, with one `Obs` across attempts and a merged
history in which replayed steps overwrite their first recording; when the
policy gives up, `RestartBudgetExhausted` chains the last fault.

Before it builds the next attempt, the Supervisor joins the dead
attempt's checkpoint writer (`trainer.ckpt.wait()`): an error of the caught
kinds there is part of the same failure (its step never committed) and is
recorded in the result's notes and as a ``sup.writer_error`` instant; any
other error propagates. Then it hands the dead attempt's pinned state back
(`core/lms/offload.release_arenas`): the next attempt's placement takes
the reserved arena again instead of pinning a second state beside the old
one, and no arena is zeroed while a writer still reads it. The process's
pinned arenas are the Supervisor's while it runs.

With devices lost (the fault's ``lost_devices`` payload), `replan_mesh`
shrinks the data axis and scales the microbatches so that the global
batch is kept. On a run of several processes the ranks whose index falls
outside the new mesh leave: their `run` returns a result with `left` set.
The survivors tear the process group down and form one of the new size on
a fresh rendezvous (`rendezvous(attempt)`: an init_method URL, a new one
each attempt), and restore the replicated checkpoint. zero1 cannot
reshard across a data-axis change (its flat layout depends on the data
extent): the Supervisor refuses, as the JAX package's does.
"""
from __future__ import annotations

import datetime
import time
import traceback
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

from repro_torch.config.base import TrainConfig
from repro_torch.obs import Obs, TelemetryLoop
from repro_torch.runtime.elastic import apply_decision, replan_mesh
from repro_torch.runtime.fault import FailureDetector, RestartPolicy
from repro_torch.runtime.inject import FaultInjector, InjectedFault


class RestartBudgetExhausted(RuntimeError):
    """The RestartPolicy ran out of budget — the crash loop is real."""


@dataclass
class SupervisedResult:
    state: object                      # final train state (None if `left`)
    hist: List[dict]                   # per-step metrics, replays collapsed
    attempts: int                      # Trainer builds (1 = no failure)
    restarts: int                      # recoveries performed
    notes: List[str] = field(default_factory=list)   # reshard decisions
    tcfg: Optional[TrainConfig] = None  # config after any resharding
    left: bool = False                 # this rank fell outside the new mesh


def _data_axis(cfg: TrainConfig) -> int:
    axes = dict(zip(cfg.mesh.axes, cfg.mesh.shape))
    return axes.get("data", 1) * axes.get("pod", 1)


class Supervisor:
    def __init__(self, tcfg: TrainConfig, *, attn_impl: str = "blockwise",
                 device=None, process: Optional[int] = None,
                 heartbeat_dir: Optional[str] = None,
                 policy: Optional[RestartPolicy] = None,
                 detector: Optional[FailureDetector] = None,
                 injector: Optional[FaultInjector] = None,
                 devices_available: Optional[int] = None,
                 catch: Tuple[type, ...] = (InjectedFault,),
                 sleep_fn: Callable[[float], None] = time.sleep,
                 obs: Optional[Obs] = None,
                 telemetry: Optional[TelemetryLoop] = None,
                 rendezvous: Optional[Callable[[int], str]] = None,
                 profile=None):
        self.tcfg = tcfg
        # one Obs across every attempt
        self.obs = obs if obs is not None else Obs()
        self.telemetry = telemetry
        self.attn_impl = attn_impl
        self.device = device
        self.process = process
        self.heartbeat_dir = heartbeat_dir
        self.policy = policy or RestartPolicy()
        # part of the supervision contract: out-of-band liveness checks feed
        # the same restart path (tests drive it against dead/torn beats)
        self.detector = detector or FailureDetector()
        self.injector = injector
        self._devices = devices_available
        self._catch = catch
        self._sleep = sleep_fn
        self.rendezvous = rendezvous
        self.profile = profile
        self.trainer = None            # current attempt's Trainer (tests peek)

    def _devices_now(self, cfg: TrainConfig) -> int:
        return self._devices if self._devices is not None else cfg.mesh.num_devices

    def run(self, steps: Optional[int] = None,
            on_step: Optional[Callable] = None) -> SupervisedResult:
        """Train to completion under supervision; raises
        RestartBudgetExhausted when the policy gives up (the last fault is
        chained as __cause__). Never returns a partially trained result,
        but for a rank that left the run (`left`)."""
        from repro_torch.train.trainer import Trainer   # trainer -> runtime
        cfg = self.tcfg
        devices = self._devices_now(cfg)
        hist_by_step: Dict[int, dict] = {}
        notes: List[str] = []
        attempts = 0
        restarts = 0

        def _on_step(step: int, m: dict) -> None:
            hist_by_step[step] = m
            self.policy.record_success()
            if on_step is not None:
                on_step(step, m)

        while True:
            attempts += 1
            self.trainer = Trainer(cfg, attn_impl=self.attn_impl, device=self.device,
                                   process=self.process,
                                   heartbeat_dir=self.heartbeat_dir,
                                   injector=self.injector, obs=self.obs,
                                   telemetry=self.telemetry, profile=self.profile)
            try:
                state, _ = self.trainer.train(steps=steps, on_step=_on_step)
            except self._catch as e:
                self._recover(e, attempts, notes)
                delay = self.policy.next_delay()
                if delay is None:
                    raise RestartBudgetExhausted(
                        f"restart budget ({self.policy.max_restarts}) "
                        f"exhausted after {attempts} attempts") from e
                restarts += 1
                self.obs.instant("sup.restart", attempt=attempts,
                                 error=str(e), delay_s=delay)
                self.obs.registry.counter("sup.restarts").inc()
                self._sleep(delay)
                lost = 0
                if isinstance(e, InjectedFault):
                    lost = int(e.event.payload.get("lost_devices", 0))
                if lost:
                    devices = max(devices - lost, 1)
                    self._devices = devices
                    dec = replan_mesh(cfg, devices)
                    new_cfg = apply_decision(cfg, dec)
                    if (cfg.ddl.mode == "zero1"
                            and _data_axis(new_cfg) != _data_axis(cfg)):
                        raise RuntimeError(
                            "zero1 optimizer shards are packed per data "
                            "rank (flat layout depends on the data-axis "
                            "size): cannot reshard "
                            f"{_data_axis(cfg)} -> {_data_axis(new_cfg)} "
                            "data ranks; restart with ddl mode allreduce "
                            "or restore at the original scale") from e
                    cfg = new_cfg
                    notes.append(dec.note)
                    self.obs.instant("sup.reshard", devices=devices,
                                     note=dec.note)
                    self.obs.registry.counter("sup.reshards").inc()
                    if self._regroup(cfg, attempts):
                        hist = [hist_by_step[k] for k in sorted(hist_by_step)]
                        return SupervisedResult(state=None, hist=hist, attempts=attempts,
                                                restarts=restarts, notes=notes, tcfg=cfg,
                                                left=True)
                continue
            hist = [hist_by_step[k] for k in sorted(hist_by_step)]
            return SupervisedResult(state=state, hist=hist,
                                    attempts=attempts, restarts=restarts,
                                    notes=notes, tcfg=cfg)

    def _recover(self, e: BaseException, attempt: int, notes: List[str]) -> None:
        """Join the dead attempt's writer, drop its state and hand its
        pinned arenas back."""
        from repro_torch.core.lms import offload
        trainer, self.trainer = self.trainer, None
        # the fault's traceback holds the dead attempt's frames, and with
        # them its state
        traceback.clear_frames(e.__traceback__)
        if trainer.ckpt is not None:
            try:
                trainer.ckpt.wait()
            except self._catch as w:
                notes.append(f"attempt {attempt}: checkpoint writer failed: {w}")
                self.obs.instant("sup.writer_error", attempt=attempt, error=str(w))
                traceback.clear_frames(w.__traceback__)
        del trainer
        offload.release_arenas()

    def _regroup(self, cfg: TrainConfig, attempt: int) -> bool:
        """After a reshard on a run of several processes: tear the process
        group down and, on a rank inside the new mesh, form one of its size
        on `rendezvous(attempt)`. -> True when this rank left the run."""
        import torch.distributed as dist
        if not dist.is_initialized():
            return False
        world = cfg.mesh.num_devices
        rank = dist.get_rank()
        backend = dist.get_backend()
        dist.destroy_process_group()
        if rank >= world:
            return True
        if world > 1:
            if self.rendezvous is None:
                raise ValueError("a reshard of several ranks needs a rendezvous "
                                 "(Supervisor(rendezvous=))")
            dist.init_process_group(backend, init_method=self.rendezvous(attempt),
                                    world_size=world, rank=rank,
                                    timeout=datetime.timedelta(minutes=10))
        return False
