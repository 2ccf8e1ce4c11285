"""Planner v2 cost model (DESIGN.md §13): measured swap bandwidth, overlap
and audited live-bytes, with `hw.HardwareSpec` constants as the fallback.
A copy of the JAX package's `core/lms/costmodel.py` (which imports no JAX),
over the port's hardware model: uncalibrated plans are priced for the H100.
The reports it reads keep the JAX package's formats.

The planner's v1 pricing assumed every host<->device byte moves at the
static `hw.host_bw` and overlaps perfectly with compute whenever the swap
is shorter than a layer. PRs 8-9 built the instruments that measure what
actually happens: ``obs_report.json`` (obs/report.py) carries per-residency
-class achieved ``bytes_per_s`` and the timeline's ``overlap_frac``;
``analysis_report.json`` (analysis/report.py) carries each audited step's
``plan_delta_bytes`` — how many live bytes the jaxpr held past the plan's
pricing. A `CostModel` folds those three signals into the quantities the
joint scheduler prices with:

* ``bw(cls)``      — achieved bytes/s for one residency class, falling
                     back to the profile's aggregate achieved bandwidth,
                     then to ``hw.host_bw``.
* ``hidden_frac``  — measured fraction of swap time that actually hid
                     under compute (v1 assumed 1.0).
* ``exposed_swap_s`` — the step-time cost of moving N bytes given the
                     compute available to hide behind; the same expression
                     the fig2b evaluator uses, so the planner's argmin and
                     the benchmark's measurement agree by construction.
* ``live_margin``  — the audited JXA005 underestimate per step kind,
                     charged back into the calibrated plan's peak/budget.
* ``tune_*``       — prefetch depth / DDL bucket / pool staging depth
                     derived from the calibrated ratios instead of
                     hand-priced constants.

Uncalibrated (`from_hardware`) the model reproduces the v1 constants
exactly, which is what keeps the legacy `plan_memory`/`plan_serve_memory`
wrappers byte-identical.
"""
from __future__ import annotations

import json
import math
from dataclasses import dataclass, field
from typing import Dict, Optional

from repro_torch import hw as hwlib

# obs_report.json schema version this loader understands (obs/report.py
# stamps it; bump BOTH sides together)
OBS_REPORT_SCHEMA = 1

# the dispatch tax on "hidden" swap time — the non-overlappable slice of an
# overlapped copy (descriptor setup, stream sync). Shared with the fig2b
# step-time model so planner pricing and bench evaluation cannot drift.
DISPATCH_TAX = 0.15


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"not a calibration profile: {msg}")


def validate_obs_report(report: dict) -> dict:
    """Schema gate for the calibration input: the keys Planner v2 prices
    from must exist with the meanings obs/report.py wrote them with."""
    _require(isinstance(report, dict), "expected a JSON object")
    _require(report.get("schema") == OBS_REPORT_SCHEMA,
             f"schema={report.get('schema')!r}, expected {OBS_REPORT_SCHEMA}")
    _require("overlap_frac" in report, "missing overlap_frac")
    _require(isinstance(report.get("classes"), dict), "missing classes rows")
    for cls, row in report["classes"].items():
        _require(isinstance(row, dict) and "bytes" in row,
                 f"class row {cls!r} has no byte accounting")
    return report


def validate_analysis_report(report: dict) -> dict:
    _require(isinstance(report, dict), "expected a JSON object")
    _require(isinstance(report.get("steps"), list),
             "missing steps audits (analysis_report.json)")
    return report


@dataclass(frozen=True)
class CostModel:
    """Calibrated (or fallback) pricing inputs for the joint scheduler."""
    hw: hwlib.HardwareSpec = hwlib.DEFAULT
    # measured achieved bytes/s per residency class (span-timed rows only)
    class_bw: Dict[str, float] = field(default_factory=dict)
    # aggregate achieved bytes/s across every span-timed class — the
    # fallback for classes that only have trace-event byte accounting
    default_bw: Optional[float] = None
    # measured fraction of swap span time inside compute spans
    overlap_frac: Optional[float] = None
    # mean compute-span duration (per_step rows) — sizes pool staging depth
    mean_step_s: Optional[float] = None
    # audited JXA005 plan_delta_bytes per step name (analysis_report.json)
    step_deltas: Dict[str, int] = field(default_factory=dict)
    source: str = "hardware"

    @property
    def calibrated(self) -> bool:
        return self.source != "hardware"

    # ---- constructors -----------------------------------------------------
    @classmethod
    def from_hardware(cls, hw: hwlib.HardwareSpec = hwlib.DEFAULT
                      ) -> "CostModel":
        """Uncalibrated fallback: prices exactly like the v1 planner."""
        return cls(hw=hw, source="hardware")

    @classmethod
    def from_reports(cls, obs_report: Optional[dict],
                     analysis_report: Optional[dict] = None,
                     hw: hwlib.HardwareSpec = hwlib.DEFAULT,
                     source: str = "profile") -> "CostModel":
        if obs_report is None:
            m = cls.from_hardware(hw)
            if analysis_report is None:
                return m
            obs_report = {"schema": OBS_REPORT_SCHEMA, "overlap_frac": 0.0,
                          "swap_s": 0.0, "classes": {}}
        validate_obs_report(obs_report)
        class_bw: Dict[str, float] = {}
        tot_bytes, tot_span = 0.0, 0.0
        for name, row in obs_report["classes"].items():
            bps = row.get("bytes_per_s")
            if bps:
                class_bw[name] = float(bps)
            span = float(row.get("span_s", 0.0) or 0.0)
            if span > 0:
                tot_bytes += float(row.get("bytes", 0))
                tot_span += span
        default_bw = tot_bytes / tot_span if tot_span > 0 else None
        # a report with no swap time carries no overlap signal at all
        overlap = (float(obs_report["overlap_frac"])
                   if float(obs_report.get("swap_s", 0.0) or 0.0) > 0
                   else None)
        durs = [float(r.get("dur_s", 0.0))
                for r in obs_report.get("per_step", []) if r.get("dur_s")]
        mean_step = sum(durs) / len(durs) if durs else None
        deltas: Dict[str, int] = {}
        if analysis_report is not None:
            validate_analysis_report(analysis_report)
            for s in analysis_report["steps"]:
                d = s.get("plan_delta_bytes")
                if d is not None and s.get("name"):
                    deltas[str(s["name"])] = int(d)
        return cls(hw=hw, class_bw=class_bw, default_bw=default_bw,
                   overlap_frac=overlap, mean_step_s=mean_step,
                   step_deltas=deltas, source=source)

    @classmethod
    def load(cls, profile_path: str,
             analysis_path: Optional[str] = None,
             hw: hwlib.HardwareSpec = hwlib.DEFAULT) -> "CostModel":
        with open(profile_path) as f:
            obs_report = validate_obs_report(json.load(f))
        analysis = None
        if analysis_path:
            with open(analysis_path) as f:
                analysis = validate_analysis_report(json.load(f))
        return cls.from_reports(obs_report, analysis, hw=hw,
                                source=str(profile_path))

    # ---- pricing ----------------------------------------------------------
    def bw(self, cls_name: str) -> float:
        """Achieved bytes/s for a residency class: measured row > profile
        aggregate > static host link."""
        v = self.class_bw.get(cls_name)
        if v:
            return v
        if self.default_bw:
            return self.default_bw
        return self.hw.host_bw

    def hidden_frac(self) -> float:
        """Fraction of overlappable swap time that actually hides; 1.0 (the
        v1 ideal-async assumption) when nothing was measured."""
        if self.overlap_frac is None:
            return 1.0
        return max(0.0, min(1.0, float(self.overlap_frac)))

    def exposed_swap_s(self, nbytes: float, cls_name: str,
                       compute_s: float) -> float:
        """Step-time cost of moving `nbytes` of class `cls_name` with
        `compute_s` of compute available to hide behind: the un-hidden
        remainder plus the dispatch tax on the hidden part. Reduces to the
        v1 model (full overlap up to compute, 15% tax) uncalibrated."""
        t = nbytes / self.bw(cls_name)
        hidden = min(t, max(compute_s, 0.0)) * self.hidden_frac()
        return (t - hidden) + DISPATCH_TAX * hidden

    def live_margin(self, kind: str) -> int:
        """Worst audited JXA005 underestimate (live bytes past the plan's
        pricing) across steps of this shape kind; 0 without audits. Matched
        by substring: "train" covers train/zero1_train, "decode" covers the
        static and slot ticks."""
        out = 0
        for name, delta in self.step_deltas.items():
            if kind in name:
                out = max(out, int(delta))
        return out

    # ---- knob tuning -------------------------------------------------------
    def tune_prefetch_depth(self, num_layers: int, per_layer_bytes: float,
                            layer_time: float, cls_name: str = "params"
                            ) -> int:
        """Layers in flight so the measured per-layer swap keeps up with
        compute: smallest divisor of L in [2, 8] covering the measured
        swap/compute ratio (+1 buffer), largest divisor when nothing does.
        Divisor-of-L because the executor's `_stream_depth` falls back to 1
        for a non-dividing depth — a tuned knob the scan cannot honor would
        be fiction."""
        cands = [d for d in range(2, min(8, num_layers) + 1)
                 if num_layers % d == 0]
        if not cands:
            return 2
        t = per_layer_bytes / self.bw(cls_name)
        needed = int(math.ceil(t / max(layer_time, 1e-12))) + 1
        for d in cands:
            if d >= needed:
                return d
        return cands[-1]

    def tune_bucket_mb(self, bwd_layer_time: float) -> int:
        """DDL gradient bucket sized so one bucket's fabric time hides
        behind one layer of backward compute: bytes = ici_link_bw *
        bwd_layer_time, snapped down to a power-of-two MiB in [8, 256]."""
        target = self.hw.ici_link_bw * max(bwd_layer_time, 0.0)
        mb = max(int(target // (1 << 20)), 1)
        p = 1 << (mb.bit_length() - 1)
        return max(8, min(256, p))

    def tune_staging_depth(self, slot_bytes: float) -> int:
        """Serve pool staging depth: how many released-slot returns to keep
        in flight so a slot's pages (at the measured kvcache bandwidth)
        arrive within one mean decode tick; [1, 4], 2 without a measured
        tick duration."""
        if not self.mean_step_s or self.mean_step_s <= 0:
            return 2
        t = slot_bytes / self.bw("kvcache")
        return max(1, min(4, int(math.ceil(t / self.mean_step_s))))

    def describe(self) -> str:
        bwtxt = ", ".join(f"{k}={v / 1e9:.2f}GB/s"
                          for k, v in sorted(self.class_bw.items()))
        agg = (f"{self.default_bw / 1e9:.2f}GB/s" if self.default_bw
               else f"{self.hw.host_bw / 1e9:.0f}GB/s static")
        ov = ("n/a" if self.overlap_frac is None
              else f"{self.hidden_frac():.2f}")
        return (f"cost model: {self.source} (agg bw {agg}"
                f"{', ' + bwtxt if bwtxt else ''}, overlap {ov})")
