"""Continuous-batching request scheduler: a FIFO admission queue over a
fixed set of decode slots, with request lifecycles and bounded bookkeeping.
A copy of the JAX package's scheduler: a preempted request re-queues just
behind the head (`requeue`), counted in "preempted".

Admission is two-phase, both gated by the page budget the pool enforces:

  1. *prefill admission* — a queued request may prefill early and have its
     pages SPILLED to the host arena whenever host pages are free, so
     prompt processing runs ahead of slot availability;
  2. *slot admission* — the head of the queue joins a free decode slot only
     when the pool can reserve its FULL page need (prompt + max_new tokens,
     rounded up to pages) against the device page budget. Reservation up
     front means an admitted request is never evicted by its own cache
     growth.

Request state machine:

    queued -> active -> ok | timeout | failed | cancelled
    queued -> rejected | timeout | cancelled | failed

Terminal requests land in `finished`, which the ENGINE drains at the end
of each `run()` (results returned, per-request latency samples folded into
bounded rolling windows, counters bumped) — a long-lived engine never
accumulates every request it ever served. The scheduler is pure
bookkeeping (queue/slots/lifecycle); byte-level admission checks live in
the pool, and the engine ties the two together."""
from __future__ import annotations

import collections
from dataclasses import dataclass, field
from typing import Deque, Dict, List, Optional

import numpy as np

from repro_torch.obs import MetricsRegistry

# terminal request statuses; "queued"/"active" are the live states
TERMINAL = ("ok", "rejected", "timeout", "cancelled", "failed")


@dataclass
class Request:
    rid: int
    prompt: np.ndarray                  # int32 [P] (empty for vlm)
    max_new: int
    temperature: Optional[float] = None  # None -> engine default; 0 = greedy
    top_k: Optional[int] = None
    extras: Dict = field(default_factory=dict)  # vlm embeds / audio enc_embeds
    # None = "not timed" (engine stamps trace start); 0.0 is a REAL arrival
    # for traces timed from zero, so the engine tests with `is None`
    arrival: Optional[float] = None
    # latency budget in seconds from arrival; None = no deadline. Blowing
    # it terminates the request as "timeout" (partial tokens kept); the
    # engine's deadline-aware admission may pre-reject a request whose
    # budget its latency percentiles say is already unmeetable.
    deadline_s: Optional[float] = None

    # engine-managed state
    status: str = "queued"
    error: Optional[str] = None              # reason for a non-ok terminal
    prefilled: bool = False
    tokens: List[int] = field(default_factory=list)   # generated so far
    ttft_s: Optional[float] = None
    first_tok_mono: Optional[float] = None   # monotonic stamp of token 0
    done_mono: Optional[float] = None        # monotonic stamp at completion
    joined_seq: int = -1                     # activation order (preemption
                                             # picks the YOUNGEST slot)
    preemptions: int = 0
    cancel_requested: bool = False

    def cancel(self) -> None:
        """Ask the engine to retire this request as "cancelled" at its next
        scheduling boundary (admission or post-tick)."""
        self.cancel_requested = True

    @property
    def terminal(self) -> bool:
        return self.status in TERMINAL


class Scheduler:
    def __init__(self, n_slots: int, *, max_queue: int = 0,
                 stats_window: int = 512,
                 registry: Optional[MetricsRegistry] = None):
        self.n_slots = n_slots
        # 0 = unbounded; >0 bounds the admission queue — submissions beyond
        # it are load-shed ("rejected") instead of growing latency unboundedly
        self.max_queue = max_queue
        self.queue: Deque[Request] = collections.deque()
        self.slots: List[Optional[Request]] = [None] * n_slots
        self.finished: List[Request] = []   # terminal, awaiting engine drain
        self._join_seq = 0
        # registry-backed stats survive the drain: bounded rolling histogram
        # windows + cumulative counters keep percentile stats available to a
        # long-lived engine without retaining the Request objects themselves.
        # The legacy surface (`ttft_window`, `counters`, `served_total`) is
        # preserved as properties over the instruments.
        self.registry = registry if registry is not None else MetricsRegistry()
        self._ttft = self.registry.histogram("engine.ttft_s",
                                             window=stats_window)
        self._tpot = self.registry.histogram("engine.tpot_s",
                                             window=stats_window)
        self._req_total = self.registry.counter("engine.requests")
        self._req = {k: self.registry.counter(f"engine.req.{k}")
                     for k in TERMINAL}
        self._req["preempted"] = self.registry.counter("engine.req.preempted")

    @property
    def ttft_window(self) -> Deque[float]:
        return self._ttft.window

    @property
    def tpot_window(self) -> Deque[float]:
        return self._tpot.window

    @property
    def counters(self) -> Dict[str, int]:
        return {k: int(c.value) for k, c in self._req.items()}

    @property
    def served_total(self) -> int:
        return int(self._req_total.value)

    def submit(self, req: Request) -> bool:
        """Queue a request; False = load-shed (queue at max_queue), in which
        case the CALLER retires it as rejected (the scheduler never decides
        terminal states on its own)."""
        if self.max_queue and len(self.queue) >= self.max_queue:
            return False
        req.status = "queued"
        self.queue.append(req)
        return True

    def free_slot(self) -> Optional[int]:
        for i, r in enumerate(self.slots):
            if r is None:
                return i
        return None

    @property
    def active(self) -> Dict[int, Request]:
        return {i: r for i, r in enumerate(self.slots) if r is not None}

    def activate(self, req: Request, slot: int) -> None:
        assert self.slots[slot] is None, f"slot {slot} occupied"
        req.status = "active"
        req.joined_seq = self._join_seq
        self._join_seq += 1
        self.slots[slot] = req

    def evict(self, slot: int) -> Request:
        """Clear a slot WITHOUT retiring the request (preemption / terminal
        handling decide its next state)."""
        req = self.slots[slot]
        assert req is not None, f"slot {slot} empty"
        self.slots[slot] = None
        return req

    def requeue(self, req: Request, *, behind: int = 1) -> None:
        """Put a preempted request back in the queue with its tokens.
        `behind=1` places it just behind the head: never in front of the
        deadline-risk request it yielded its pages to, ahead of everyone
        else."""
        req.status = "queued"
        req.preemptions += 1
        self._req["preempted"].inc()
        self.queue.insert(min(behind, len(self.queue)), req)

    def retire(self, req: Request, status: str,
               error: Optional[str] = None) -> None:
        """Move a request to its terminal state and the finished list."""
        assert status in TERMINAL, status
        req.status = status
        req.error = error
        self._req[status].inc()
        self._req_total.inc()
        self.finished.append(req)

    def finish(self, slot: int) -> Request:
        """Normal completion of an active request."""
        req = self.evict(slot)
        self.retire(req, "ok")
        return req

    def drain(self) -> List[Request]:
        """Hand the terminal requests to the engine and forget them,
        folding their latency samples into the rolling windows first."""
        done = self.finished
        self.finished = []
        for r in done:
            if r.ttft_s is not None:
                self._ttft.observe(r.ttft_s)
            if (r.first_tok_mono is not None and r.done_mono is not None
                    and len(r.tokens) > 1):
                self._tpot.observe(
                    (r.done_mono - r.first_tok_mono) / (len(r.tokens) - 1))
        return done

    def ttft_p95(self) -> Optional[float]:
        if not self.ttft_window:
            return None
        return float(np.percentile(list(self.ttft_window), 95))

    def tpot_p95(self) -> Optional[float]:
        if not self.tpot_window:
            return None
        return float(np.percentile(list(self.tpot_window), 95))

    def has_work(self) -> bool:
        return bool(self.queue) or any(r is not None for r in self.slots)
