"""Fault-tolerance runtime: heartbeats, failure detection, restart policy,
and straggler statistics. A copy of the JAX package's `runtime/fault.py`
(stdlib only), except that `StepTimer` reads `time.monotonic`, the clock
the trainer's step times have always come from. The heartbeat store is
file-based: the processes of a run share one machine's filesystem.
"""
from __future__ import annotations

import dataclasses
import json
import os
import time
from dataclasses import dataclass
from typing import Dict, List, Optional


@dataclass
class Heartbeat:
    process: int
    step: int
    # monotonic stamp (lint RL001): staleness is `now - t` and an NTP step
    # of the wall clock must not fake a dead (or resurrect a dead) process.
    # Monotonic clocks are host-local; this store is host-local too (the
    # detector and the beating processes share a machine / namespace).
    t: float
    step_time: float


class HeartbeatStore:
    """File-per-process heartbeat registry."""

    def __init__(self, directory: str):
        self.dir = directory
        os.makedirs(directory, exist_ok=True)

    def beat(self, process: int, step: int, step_time: float):
        hb = Heartbeat(process, step, time.monotonic(), step_time)
        tmp = os.path.join(self.dir, f".hb_{process}.tmp")
        with open(tmp, "w") as f:
            json.dump(dataclasses.asdict(hb), f)
        os.rename(tmp, os.path.join(self.dir, f"hb_{process}.json"))

    def read_all(self) -> Dict[int, Heartbeat]:
        out = {}
        for name in os.listdir(self.dir):
            if name.startswith("hb_"):
                try:
                    with open(os.path.join(self.dir, name)) as f:
                        d = json.load(f)
                    out[d["process"]] = Heartbeat(**d)
                except (json.JSONDecodeError, OSError):
                    continue  # torn write: treat as missing this round
        return out


@dataclass
class FailureDetector:
    """Declares a process dead after `timeout` without a heartbeat, and a
    straggler when its step time exceeds `straggler_factor` x the median."""
    timeout: float = 60.0
    straggler_factor: float = 2.0

    def check(self, beats: Dict[int, Heartbeat], expected: List[int],
              now: Optional[float] = None):
        now = now if now is not None else time.monotonic()
        dead = [p for p in expected
                if p not in beats or now - beats[p].t > self.timeout]
        alive = [p for p in expected if p not in dead]
        stragglers: List[int] = []
        times = sorted(beats[p].step_time for p in alive if p in beats)
        if len(times) >= 3:
            median = times[len(times) // 2]
            stragglers = [p for p in alive
                          if beats[p].step_time > self.straggler_factor * median]
        return dead, stragglers


@dataclass
class RestartPolicy:
    """Restart budget with decorrelated-jitter backoff.

    `next_delay` returns how long to sleep before the next restart, or None
    when the budget is exhausted. With `jitter` on (the default), delays
    follow the decorrelated-jitter rule — ``d = min(max_delay,
    U(base, 3 * prev_d))`` with a per-policy seeded rng — so a fleet of
    peers restarting off the same failure spreads out instead of
    thundering-herding the checkpoint store in lockstep; ``jitter=False``
    keeps the deterministic ``base ** restarts`` ladder.

    `record_success` must be called per healthy step: after `stable_steps`
    consecutive successes the restart budget resets, so a long-lived run
    that hits one rough patch per day never exhausts a budget meant to
    catch crash loops."""
    max_restarts: int = 10
    backoff_base: float = 2.0
    max_delay: float = 300.0
    jitter: bool = True
    stable_steps: int = 100
    seed: int = 0
    restarts: int = 0

    def __post_init__(self):
        import random
        self._rng = random.Random(self.seed)
        self._stable = 0
        self._prev = float(self.backoff_base)

    def next_delay(self) -> Optional[float]:
        if self.restarts >= self.max_restarts:
            return None
        base_delay = min(self.backoff_base ** self.restarts, self.max_delay)
        self.restarts += 1
        self._stable = 0
        if self.jitter:
            d = min(self.max_delay,
                    self._rng.uniform(self.backoff_base, 3.0 * self._prev))
        else:
            d = base_delay
        self._prev = d
        return d

    def record_success(self, steps: int = 1) -> None:
        """Count healthy steps; `stable_steps` in a row refunds the restart
        budget (and re-arms the jitter walk at its base)."""
        self._stable += steps
        if self._stable >= self.stable_steps and self.restarts:
            self.restarts = 0
            self._prev = float(self.backoff_base)


class StepTimer:
    """Rolling step-time stats; feeds straggler detection + throughput logs.
    The trainer synchronizes the device before `stop` on a flush step, so
    that step's time covers the work it queued."""

    def __init__(self, window: int = 50):
        self.window = window
        self.times: List[float] = []
        self._t0: Optional[float] = None

    def start(self):
        self._t0 = time.monotonic()

    def stop(self) -> float:
        dt = time.monotonic() - self._t0
        self.times.append(dt)
        if len(self.times) > self.window:
            self.times.pop(0)
        return dt

    @property
    def median(self) -> float:
        if not self.times:
            return 0.0
        s = sorted(self.times)
        return s[len(s) // 2]
