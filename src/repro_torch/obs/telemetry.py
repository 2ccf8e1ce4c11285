"""Training telemetry loop: rolling loss-median spike detection with
alert / early-stop callbacks (DESIGN.md §12; the ROADMAP's
"loss-median early-stop/spike detection" item, à la HomebrewNLP's
wandblog).

``SpikeDetector`` keeps a bounded window of recent losses and flags a step
whose loss exceeds ``median + max(factor * 1.4826 * MAD, min_delta)`` — the
MAD term scales the threshold to the trajectory's own noise floor (1.4826
makes MAD a consistent sigma estimate), while ``min_delta`` keeps a flat
plateau (MAD ~ 0) from alerting on harmless jitter. Nothing fires until
``min_steps`` observations have accumulated.

A copy of the JAX package's `obs/telemetry.py` (stdlib only): the same
loss series gives the same alerts in both packages.

``TelemetryLoop`` wires a detector into the trainer's flush path: every
logged step feeds ``observe``; on a spike it records a ``telemetry.alert``
instant event, bumps the alert counter, invokes the registered callbacks,
and — per ``action`` — keeps training ("record"), requests an early stop
("stop", the trainer checks ``stop_requested``), or raises a structured
``TelemetryAlert`` ("raise") for the Supervisor to log or act on.
"""
from __future__ import annotations

import collections
from typing import Callable, Deque, List, Optional

from repro_torch.obs.registry import _percentile
from repro_torch.obs.trace import Obs


class TelemetryAlert(RuntimeError):
    """A structured telemetry alert (loss spike / divergence)."""

    def __init__(self, kind: str, step: int, value: float, median: float,
                 threshold: float):
        self.kind = kind
        self.step = step
        self.value = value
        self.median = median
        self.threshold = threshold
        super().__init__(
            f"telemetry alert [{kind}] at step {step}: value {value:.6g} "
            f"exceeds threshold {threshold:.6g} (rolling median "
            f"{median:.6g})")

    def to_dict(self) -> dict:
        return {"kind": self.kind, "step": self.step, "value": self.value,
                "median": self.median, "threshold": self.threshold}


class SpikeDetector:
    """Rolling-median + MAD spike detector over a scalar series."""

    def __init__(self, window: int = 64, factor: float = 6.0,
                 min_delta: float = 0.1, min_steps: int = 8):
        assert min_steps >= 2, "need at least two observations for a median"
        self.window: Deque[float] = collections.deque(maxlen=window)
        self.factor = factor
        self.min_delta = min_delta
        self.min_steps = min_steps

    def _median(self, vals: List[float]) -> float:
        return _percentile(sorted(vals), 50)

    def observe(self, step: int, value: float) -> Optional[TelemetryAlert]:
        """Feed one observation; -> a TelemetryAlert (NOT raised) when the
        value spikes above the rolling threshold, else None. The spiking
        value still enters the window afterwards (the median is robust to
        it; a sustained divergence keeps alerting as the window climbs)."""
        value = float(value)
        alert = None
        if len(self.window) >= self.min_steps:
            vals = list(self.window)
            med = self._median(vals)
            mad = self._median([abs(v - med) for v in vals])
            threshold = med + max(self.factor * 1.4826 * mad, self.min_delta)
            if value > threshold:
                alert = TelemetryAlert("loss_spike", step, value, med,
                                       threshold)
        self.window.append(value)
        return alert


class TelemetryLoop:
    """Per-step telemetry driver the trainer's flush path calls.

    action: "record" (collect alerts and keep going), "stop" (set
    ``stop_requested`` so the trainer checkpoints and exits cleanly), or
    "raise" (raise the TelemetryAlert out of the trainer — the Supervisor
    can catch it like any other fault).
    """

    ACTIONS = ("record", "stop", "raise")

    def __init__(self, detector: Optional[SpikeDetector] = None,
                 key: str = "loss", action: str = "record",
                 on_alert: Optional[List[Callable]] = None,
                 obs: Optional[Obs] = None):
        assert action in self.ACTIONS, action
        self.detector = detector if detector is not None else SpikeDetector()
        self.key = key
        self.action = action
        self.on_alert = list(on_alert or [])
        self.obs = obs
        self.alerts: List[TelemetryAlert] = []
        self.stop_requested = False

    def observe(self, step: int, row: dict) -> Optional[TelemetryAlert]:
        value = row.get(self.key)
        if value is None:
            return None
        alert = self.detector.observe(step, value)
        if alert is None:
            return None
        self.alerts.append(alert)
        if self.obs is not None:
            self.obs.instant("telemetry.alert", **alert.to_dict())
            self.obs.registry.counter("telemetry.alerts").inc()
        for cb in self.on_alert:
            cb(alert)
        if self.action == "stop":
            self.stop_requested = True
        elif self.action == "raise":
            raise alert
        return alert
