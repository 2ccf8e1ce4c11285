"""Timeline analysis + exporters: the swap/compute overlap report
(``obs_report.json``, the Planner v2 calibration input that
`core/lms/costmodel.py` validates and `CostModel.from_reports` prices
from, the training launcher's ``--profile``) and the Chrome-trace
(`trace_event` format) exporter for chrome://tracing / Perfetto
(DESIGN.md §12). A copy of the JAX package's `obs/report.py` over the
port's span ring, in the same schema.

Overlap definition: ``overlap_frac`` is the fraction of total SWAP span
time that lies inside the union of COMPUTE span intervals. Only
``kind == "span"`` events (monotonic-clocked host regions) enter the
wall-clock math. (The port records no trace-time events: PyTorch runs
eagerly, and its swaps are counted in the registry's ``lms.swap_*``
counters, which the report's registry snapshot carries.)

Per-residency-class rows: every swap event may carry ``cls`` ("params",
"optimizer", "grads", "kvcache") and ``bytes`` attrs; the report aggregates
bytes per class, and — for classes with timed spans — dispatch-side
bytes/s.
"""
from __future__ import annotations

import json
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.obs.trace import Obs, SpanEvent, get_obs

# site -> timeline category (Perfetto track). Order matters: first match.
COMPUTE_SITES = ("engine.tick", "engine.prefill", "train.step")
SWAP_PREFIXES = ("lms.swap", "pool.")
COLLECTIVE_PREFIXES = ("ddl.",)

CATEGORIES = ("compute", "swap", "collective", "other")


def categorize(site: str) -> str:
    if site in COMPUTE_SITES:
        return "compute"
    if any(site.startswith(p) for p in SWAP_PREFIXES):
        return "swap"
    if any(site.startswith(p) for p in COLLECTIVE_PREFIXES):
        return "collective"
    return "other"


# ---------------------------------------------------------------------------
# interval math

def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """Merge possibly-overlapping [lo, hi) intervals into a sorted disjoint
    cover."""
    out: List[Tuple[float, float]] = []
    for lo, hi in sorted(i for i in intervals if i[1] > i[0]):
        if out and lo <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], hi))
        else:
            out.append((lo, hi))
    return out


def _intersect_len(lo: float, hi: float,
                   merged: List[Tuple[float, float]]) -> float:
    """Length of [lo, hi) ∩ (disjoint sorted cover)."""
    total = 0.0
    for mlo, mhi in merged:
        if mhi <= lo:
            continue
        if mlo >= hi:
            break
        total += min(hi, mhi) - max(lo, mlo)
    return total


# ---------------------------------------------------------------------------
# the overlap report

def overlap_report(events: Sequence[SpanEvent]) -> dict:
    """Swap/compute overlap + per-residency-class swap byte rows from a
    span set. Pure function of the events — directly testable on synthetic
    spans."""
    spans = [e for e in events if e.kind == "span"]
    compute = [e for e in spans if categorize(e.site) == "compute"]
    swap = [e for e in spans if categorize(e.site) == "swap"]
    merged = _union([(e.t0, e.t0 + e.dur) for e in compute])

    swap_s = sum(e.dur for e in swap)
    overlapped_s = sum(_intersect_len(e.t0, e.t0 + e.dur, merged)
                       for e in swap)
    compute_s = sum(hi - lo for lo, hi in merged)

    # per-step rows: one per compute span, in timeline order — how much
    # swap time hid inside THAT span
    swap_merged = _union([(e.t0, e.t0 + e.dur) for e in swap])
    per_step = []
    for i, e in enumerate(sorted(compute, key=lambda e: e.t0)):
        lo, hi = e.t0, e.t0 + e.dur
        hidden = _intersect_len(lo, hi, swap_merged)
        row = {"step": i, "site": e.site, "dur_s": e.dur,
               "swap_overlap_s": hidden,
               "overlap_frac": hidden / e.dur if e.dur > 0 else 0.0}
        step_attr = e.attrs.get("step")
        if step_attr is not None:
            row["step"] = step_attr
        per_step.append(row)

    # per-residency-class byte accounting: spans AND trace events count
    # bytes; only spans (timed) contribute bytes/s (dispatch-side)
    classes: Dict[str, dict] = {}
    for e in events:
        if categorize(e.site) != "swap":
            continue
        cls = e.attrs.get("cls")
        if cls is None:
            continue
        row = classes.setdefault(
            cls, {"bytes": 0, "events": 0, "span_s": 0.0, "trace_events": 0})
        nbytes = int(e.attrs.get("bytes", 0))
        row["bytes"] += nbytes
        row["events"] += 1
        if e.kind == "span":
            row["span_s"] += e.dur
        else:
            row["trace_events"] += 1
    for row in classes.values():
        row["bytes_per_s"] = (row["bytes"] / row["span_s"]
                              if row["span_s"] > 0 else None)

    return {
        "overlap_frac": overlapped_s / swap_s if swap_s > 0 else 0.0,
        "swap_s": swap_s,
        "overlapped_s": overlapped_s,
        "compute_s": compute_s,
        "swap_spans": len(swap),
        "compute_spans": len(compute),
        "per_step": per_step,
        "classes": classes,
    }


def build_obs_report(obs: Optional[Obs] = None,
                     meta: Optional[dict] = None) -> dict:
    """Full ``obs_report.json`` payload: the overlap report over the ring's
    timeline plus a registry snapshot (Planner v2 reads `classes` for
    measured per-class swap rows and `overlap_frac` against the plan's
    overlap assumption)."""
    obs = obs if obs is not None else get_obs()
    events = obs.ring.events()
    report = {
        "schema": 1,
        "events": len(events),
        "event_kinds": {
            k: sum(1 for e in events if e.kind == k)
            for k in ("span", "instant", "trace")},
        **overlap_report(events),
        "registry": obs.registry.snapshot(),
    }
    if meta:
        report["meta"] = meta
    return report


def write_obs_report(path: str, obs: Optional[Obs] = None,
                     meta: Optional[dict] = None) -> dict:
    report = build_obs_report(obs, meta)
    with open(path, "w") as f:
        json.dump(report, f, indent=1, default=str)
    return report


def load_obs_report(path: str) -> dict:
    """Read ``obs_report.json`` back as a calibration input, validating the
    schema version and the keys Planner v2 prices from (raises ValueError on
    a mismatched or truncated file — a stale/foreign report must not
    silently calibrate a plan). The validator lives with the CostModel so
    reader and writer share one schema constant."""
    from repro_torch.core.lms.costmodel import validate_obs_report
    with open(path) as f:
        return validate_obs_report(json.load(f))


# ---------------------------------------------------------------------------
# Chrome trace_event export

_TIDS = {c: i + 1 for i, c in enumerate(CATEGORIES)}


def export_chrome_trace(events: Sequence[SpanEvent], path: str) -> dict:
    """Write the event set as Chrome `trace_event` JSON. Spans become "X"
    (complete) events and instants "i" events, each on a per-category
    track (compute / swap / collective / other) via its tid; "M" metadata
    events name the tracks so Perfetto renders them distinctly.

    Timestamps are microseconds relative to the earliest event (monotonic
    origin is arbitrary; only deltas matter on a timeline)."""
    base = min((e.t0 for e in events), default=0.0)
    trace_events: List[dict] = [{
        "name": "process_name", "ph": "M", "pid": 0,
        "args": {"name": "repro_torch"}}]
    for cat, tid in _TIDS.items():
        trace_events.append({"name": "thread_name", "ph": "M", "pid": 0,
                             "tid": tid, "args": {"name": cat}})
    for e in events:
        cat = categorize(e.site)
        common = {"name": e.site, "cat": f"{cat},{e.kind}", "pid": 0,
                  "tid": _TIDS[cat], "ts": (e.t0 - base) * 1e6,
                  "args": dict(e.attrs, depth=e.depth)}
        if e.kind == "span":
            trace_events.append({**common, "ph": "X", "dur": e.dur * 1e6})
        else:
            trace_events.append({**common, "ph": "i", "s": "t"})
    doc = {"traceEvents": trace_events, "displayTimeUnit": "ms"}
    with open(path, "w") as f:
        json.dump(doc, f, default=str)
    return doc
