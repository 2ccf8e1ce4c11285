"""Tracing spans + the bounded in-memory event ring (DESIGN.md §12).

``Obs.span(site, **attrs)`` is a context manager timing a host-side region
with ``time.monotonic()``; on exit it emits a structured event into a
bounded ring (and an optional JSONL sink). ``Obs.instant(site)`` emits a
zero-duration point event. (The JAX package's trace-time events have no
counterpart: PyTorch runs eagerly.)

An ``Obs`` bundles a ``MetricsRegistry`` with a ring. The module-level
default (``get_obs()``/``configure()``) is what free-standing helpers
record into; components that must not cross-contaminate (several engines in
one process, sequential trainer runs) construct ``Obs()`` — a PRIVATE
registry sharing the GLOBAL ring, so per-component metrics stay isolated
while every span still lands on one unified timeline.

Thread safety: the ring and sink are lock-protected (the checkpointer's
async writer emits from its thread); span nesting depth is tracked
per-thread.
"""
from __future__ import annotations

import contextlib
import json
import threading
import time
from dataclasses import dataclass, field
from typing import IO, Iterator, List, Optional

from repro_torch.obs.registry import MetricsRegistry
from repro_torch.obs.sites import check_site


@dataclass
class SpanEvent:
    """One timeline event. ``t0``/``dur`` are monotonic seconds; ``kind``
    is "span" (timed region), "instant" (point event), or "trace"
    (JIT-trace-time accounting, excluded from overlap math)."""
    site: str
    t0: float
    dur: float
    kind: str = "span"
    depth: int = 0
    tid: int = 0
    attrs: dict = field(default_factory=dict)

    def to_dict(self) -> dict:
        return {"site": self.site, "t0": self.t0, "dur": self.dur,
                "kind": self.kind, "depth": self.depth, "tid": self.tid,
                "attrs": self.attrs}


class TraceRing:
    """Bounded in-memory event ring + optional append-only JSONL sink."""

    def __init__(self, maxlen: int = 8192, jsonl_path: Optional[str] = None):
        self._lock = threading.Lock()
        self._maxlen = maxlen
        self._events: List[SpanEvent] = []
        self._file: Optional[IO[str]] = None
        self.jsonl_path: Optional[str] = None
        if jsonl_path:
            self.set_jsonl(jsonl_path)

    @property
    def maxlen(self) -> int:
        return self._maxlen

    def set_jsonl(self, path: Optional[str]) -> None:
        """(Re)point the JSONL sink; None closes it."""
        with self._lock:
            if self._file is not None:
                self._file.close()
                self._file = None
            self.jsonl_path = path
            if path:
                self._file = open(path, "a")

    def record(self, ev: SpanEvent) -> None:
        with self._lock:
            self._events.append(ev)
            if len(self._events) > self._maxlen:
                # drop the oldest half in one slice instead of popping per
                # event — appends stay O(1) amortized
                self._events = self._events[-self._maxlen:]
            if self._file is not None:
                self._file.write(json.dumps(ev.to_dict(), default=str) + "\n")
                self._file.flush()

    def events(self) -> List[SpanEvent]:
        with self._lock:
            return list(self._events)

    def clear(self) -> None:
        with self._lock:
            self._events = []

    def __len__(self) -> int:
        with self._lock:
            return len(self._events)


class Obs:
    """A metrics registry + an event ring, the unit every instrumented
    component holds. ``Obs()`` = private registry, shared global ring."""

    def __init__(self, registry: Optional[MetricsRegistry] = None,
                 ring: Optional[TraceRing] = None):
        self.registry = registry if registry is not None else MetricsRegistry()
        self.ring = ring if ring is not None else get_obs().ring
        self._local = threading.local()

    def _depth(self) -> int:
        return getattr(self._local, "depth", 0)

    @contextlib.contextmanager
    def span(self, site: str, **attrs) -> Iterator[SpanEvent]:
        """Time a host-side region; the event is recorded on exit (even on
        exception) with the nesting depth at entry."""
        check_site(site)
        depth = self._depth()
        self._local.depth = depth + 1
        t0 = time.monotonic()
        ev = SpanEvent(site, t0, 0.0, "span", depth,
                       threading.get_ident(), dict(attrs))
        try:
            yield ev
        finally:
            ev.dur = time.monotonic() - t0
            self._local.depth = depth
            self.ring.record(ev)

    def instant(self, site: str, **attrs) -> SpanEvent:
        check_site(site)
        ev = SpanEvent(site, time.monotonic(), 0.0, "instant", self._depth(),
                       threading.get_ident(), dict(attrs))
        self.ring.record(ev)
        return ev


# ---------------------------------------------------------------------------
# module-level default: one global ring (the unified timeline) + one global
# registry for free-standing helpers (offload/overlap/checkpointer)

_default: Optional[Obs] = None
_default_lock = threading.Lock()


def get_obs() -> Obs:
    global _default
    with _default_lock:
        if _default is None:
            obs = Obs.__new__(Obs)
            obs.registry = MetricsRegistry()
            obs.ring = TraceRing()
            obs._local = threading.local()
            _default = obs
        return _default


def configure(jsonl_path: Optional[str] = None,
              ring_size: Optional[int] = None) -> Obs:
    """Configure the global obs: point the JSONL sink, resize the ring."""
    obs = get_obs()
    if ring_size is not None:
        obs.ring._maxlen = ring_size
    if jsonl_path is not None:
        obs.ring.set_jsonl(jsonl_path or None)
    return obs
