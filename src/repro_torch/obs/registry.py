"""Metrics registry: counters, gauges, histograms, and bounded series.

Dependency-free (stdlib only) so every layer — planner, LMS executor, DDL,
trainer, serve engine, supervisor, checkpointer — can record without
import-order hazards. All instruments are monotonic-clock friendly: nothing
in here reads a clock; callers pass durations measured with
``time.monotonic()`` (lint rule RL001 keeps wall-clock out of interval
math repo-wide).

Concurrency: instrument creation is lock-protected (the checkpointer's
async writer thread records from off-thread); individual increments are
plain attribute updates — fine under the GIL for the float/append
operations used here.
"""
from __future__ import annotations

import collections
import threading
from typing import Deque, Dict, Iterator, List, Optional

from repro_torch.obs.sites import check_site


class Counter:
    """Monotonically increasing float total."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        self.value += n


class Gauge:
    """Last-written value."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)


def _percentile(sorted_vals: List[float], p: float) -> float:
    """Linear-interpolated percentile (numpy's default method) over a
    pre-sorted list."""
    n = len(sorted_vals)
    if n == 1:
        return sorted_vals[0]
    rank = (p / 100.0) * (n - 1)
    lo = int(rank)
    hi = min(lo + 1, n - 1)
    frac = rank - lo
    return sorted_vals[lo] * (1.0 - frac) + sorted_vals[hi] * frac


class Histogram:
    """Bounded rolling window with cumulative count/total.

    Percentiles (p50/p95/p99 or any p) are computed over the WINDOW — the
    bounded recent past — so a long-lived process keeps flat memory and
    current stats; `count`/`total` are all-time cumulative.
    """

    __slots__ = ("name", "window", "count", "total")

    def __init__(self, name: str, window: int = 512):
        self.name = name
        self.window: Deque[float] = collections.deque(maxlen=window)
        self.count = 0
        self.total = 0.0

    def observe(self, v: float) -> None:
        v = float(v)
        self.window.append(v)
        self.count += 1
        self.total += v

    def percentile(self, p: float) -> Optional[float]:
        if not self.window:
            return None
        return _percentile(sorted(self.window), p)

    def mean(self) -> Optional[float]:
        if not self.window:
            return None
        return sum(self.window) / len(self.window)

    def summary(self) -> Dict[str, float]:
        out = {"count": float(self.count), "total": self.total}
        if self.window:
            out.update(mean=self.mean(), p50=self.percentile(50),
                       p95=self.percentile(95), p99=self.percentile(99))
        return out


class Series:
    """Bounded append-only sequence of dict rows (the trainer's history)."""

    __slots__ = ("name", "rows")

    def __init__(self, name: str, maxlen: int = 65536):
        self.name = name
        self.rows: Deque[dict] = collections.deque(maxlen=maxlen)

    def append(self, row: dict) -> None:
        self.rows.append(row)

    def last(self) -> Optional[dict]:
        return self.rows[-1] if self.rows else None

    def __len__(self) -> int:
        return len(self.rows)

    def __iter__(self) -> Iterator[dict]:
        return iter(self.rows)


class MetricsRegistry:
    """Named instruments, created on first use, site-validated.

    Asking for an existing name with a different instrument kind raises —
    a counter silently shadowing a histogram is exactly the typo class the
    site validation exists to catch.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._instruments: Dict[str, object] = {}

    def _get(self, name: str, cls, **kw):
        check_site(name)
        with self._lock:
            inst = self._instruments.get(name)
            if inst is None:
                inst = cls(name, **kw)
                self._instruments[name] = inst
            elif not isinstance(inst, cls):
                raise TypeError(
                    f"metric {name!r} already registered as "
                    f"{type(inst).__name__}, requested {cls.__name__}")
            return inst

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str, window: int = 512) -> Histogram:
        return self._get(name, Histogram, window=window)

    def series(self, name: str, maxlen: int = 65536) -> Series:
        return self._get(name, Series, maxlen=maxlen)

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._instruments)

    def snapshot(self) -> Dict[str, dict]:
        """JSON-ready view of every instrument (series report their length
        only: their rows are the caller's payload, not a metric)."""
        out = {"counters": {}, "gauges": {}, "histograms": {}, "series": {}}
        with self._lock:
            items = list(self._instruments.items())
        for name, inst in items:
            if isinstance(inst, Counter):
                out["counters"][name] = inst.value
            elif isinstance(inst, Gauge):
                out["gauges"][name] = inst.value
            elif isinstance(inst, Histogram):
                out["histograms"][name] = inst.summary()
            elif isinstance(inst, Series):
                out["series"][name] = len(inst)
        return out

    def summary_lines(self) -> List[str]:
        """Human-readable end-of-run summary (launch scripts print this)."""
        snap = self.snapshot()
        lines = []
        for name, v in sorted(snap["counters"].items()):
            lines.append(f"{name}: {v:g}")
        for name, v in sorted(snap["gauges"].items()):
            lines.append(f"{name}: {v:g}")
        for name, s in sorted(snap["histograms"].items()):
            if s.get("count"):
                lines.append(
                    f"{name}: n={s['count']:g} mean={s.get('mean', 0):.6g} "
                    f"p50={s.get('p50', 0):.6g} p95={s.get('p95', 0):.6g} "
                    f"p99={s.get('p99', 0):.6g}")
        for name, n in sorted(snap["series"].items()):
            lines.append(f"{name}: {n} rows")
        return lines
