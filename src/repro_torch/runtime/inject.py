"""Deterministic fault injection (DESIGN.md §10): a copy of the JAX
package's `runtime/inject.py` (stdlib only), so one seed samples the same
plan in both packages.

A `FaultPlan` is a seeded, fully explicit schedule of `FaultEvent`s, each
naming a *site* (a hook point threaded through the runtime), the 0-based
call index at which it fires, a fault *kind*, and how many consecutive
calls it covers. A `FaultInjector` carries the plan through the system and
counts every site invocation, so the same plan replays the same faults at
the same points on every run — chaos drills are reproducible bug reports,
not flakes.

Sites wired in this repo:

  ``trainer.step``   Trainer.train, before each step dispatch (kind
                     "raise": the step dies like a lost peer)
  ``engine.tick``    ServeEngine._tick, before the decode step (kinds
                     "raise": the active batch fails; "preempt": the
                     youngest slot spills and re-queues)
  ``pool.reserve``   PagedKVPool.can_reserve / can_spill (kind "exhaust":
  ``pool.spill``     the budget check reports full)
  ``ckpt.save``      Checkpointer.save entry (kind "raise": crash before
                     anything is written)
  ``ckpt.commit``    Checkpointer._write, between the shard write and the
                     manifest commit (kind "raise": the torn-checkpoint
                     crash — shards on disk, no manifest)
  ``heartbeat``      HeartbeatStore.beat via Trainer (kinds "dead": drop
                     the beat entirely; "torn": write a torn/invalid file)

Every hook is a no-op when no injector is installed (`injector=None`
everywhere), so production paths carry one `if` of overhead.
"""
from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

SITES = ("trainer.step", "engine.tick", "pool.reserve", "pool.spill",
         "ckpt.save", "ckpt.commit", "heartbeat")

KINDS = ("raise", "exhaust", "preempt", "dead", "torn")

# site -> kinds that make sense there (FaultPlan.sample draws from these;
# hand-built plans may use any combination, hooks ignore kinds they don't
# implement)
SITE_KINDS: Dict[str, Tuple[str, ...]] = {
    "trainer.step": ("raise",),
    "engine.tick": ("raise", "preempt"),
    "pool.reserve": ("exhaust",),
    "pool.spill": ("exhaust",),
    "ckpt.save": ("raise",),
    "ckpt.commit": ("raise",),
    "heartbeat": ("dead", "torn"),
}


class InjectedFault(RuntimeError):
    """The crash the plan asked for. Carries the event so supervisors can
    read its payload (e.g. how many devices the simulated failure took)."""

    def __init__(self, site: str, event: "FaultEvent", call: int):
        super().__init__(f"injected fault at {site} (call {call}): "
                         f"{event.kind} {event.payload or ''}".rstrip())
        self.site, self.event, self.call = site, event, call


@dataclass(frozen=True)
class FaultEvent:
    site: str
    at: int                          # fires on the at-th call to the site
    kind: str = "raise"
    times: int = 1                   # consecutive calls covered
    payload: dict = field(default_factory=dict)

    def __post_init__(self):
        if self.site not in SITES:
            raise ValueError(f"unknown fault site {self.site!r}; "
                             f"sites: {SITES}")
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"kinds: {KINDS}")
        if self.at < 0 or self.times < 1:
            raise ValueError("at must be >= 0 and times >= 1")

    def covers(self, call: int) -> bool:
        return self.at <= call < self.at + self.times


@dataclass
class FaultPlan:
    """An explicit fault schedule. `sample` draws one deterministically
    from a seed (the chaos-CI entry point: REPRO_FAULT_SEED)."""
    events: List[FaultEvent] = field(default_factory=list)
    seed: int = 0

    @classmethod
    def sample(cls, seed: int, *, sites: Sequence[str] = SITES,
               n: int = 3, horizon: int = 12) -> "FaultPlan":
        """Draw `n` events over the first `horizon` calls of the given
        sites. numpy-free and stdlib-`random`-free at module import; uses
        a local Random so sampling never perturbs global rng state."""
        import random
        rng = random.Random(seed)
        events = []
        for _ in range(n):
            site = sites[rng.randrange(len(sites))]
            kind = SITE_KINDS[site][rng.randrange(len(SITE_KINDS[site]))]
            events.append(FaultEvent(site, at=rng.randrange(horizon),
                                     kind=kind,
                                     times=1 + rng.randrange(2)))
        return cls(events=events, seed=seed)

    @classmethod
    def from_env(cls, default_seed: int = 0, **kw) -> "FaultPlan":
        """Seeded from REPRO_FAULT_SEED — the chaos CI stage's knob."""
        return cls.sample(int(os.environ.get("REPRO_FAULT_SEED",
                                             default_seed)), **kw)

    def for_site(self, site: str) -> List[FaultEvent]:
        return [e for e in self.events if e.site == site]


class FaultInjector:
    """Counts calls per site and fires the plan's events at their indices.

    One `poke` per logical operation: a site's hook must consult the
    injector exactly once per call or the schedule drifts (hooks below are
    written that way)."""

    def __init__(self, plan: Optional[FaultPlan] = None):
        self.plan = plan or FaultPlan()
        self.calls: Dict[str, int] = {}
        self.fired: List[Tuple[str, int, str]] = []   # (site, call, kind)
        self.last: Optional[FaultEvent] = None

    def poke(self, site: str) -> Optional[FaultEvent]:
        call = self.calls.get(site, 0)
        self.calls[site] = call + 1
        for ev in self.plan.for_site(site):
            if ev.covers(call):
                self.fired.append((site, call, ev.kind))
                self.last = ev
                return ev
        return None

    def check(self, site: str) -> Optional[FaultEvent]:
        """Poke and raise if the armed event is a crash kind; return the
        event (for non-raising kinds the caller implements) otherwise."""
        ev = self.poke(site)
        if ev is not None and ev.kind == "raise":
            raise InjectedFault(site, ev, self.calls[site] - 1)
        return ev

    def wants(self, site: str, kind: str) -> bool:
        """Poke and report whether the armed event matches `kind` — for
        hooks that degrade behavior (exhaust/dead/torn) instead of
        raising. A "raise" event at such a site still raises."""
        ev = self.poke(site)
        if ev is not None and ev.kind == "raise":
            raise InjectedFault(site, ev, self.calls[site] - 1)
        return ev is not None and ev.kind == kind


def maybe(injector: Optional[FaultInjector], site: str) -> Optional[FaultEvent]:
    """`check` through an optional injector: the one-line production hook."""
    return injector.check(site) if injector is not None else None


def wants(injector: Optional[FaultInjector], site: str, kind: str) -> bool:
    return injector.wants(site, kind) if injector is not None else False
