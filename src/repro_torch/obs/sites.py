"""Site naming for the observability layer (DESIGN.md §12).

Every span, instant event, and metric carries a *site*: a lowercase dotted
identifier (`lms.swap_in`, `engine.tick`, `pool.spill`, ...) whose first
segment must come from the registered prefix set below. Validation happens
at RUNTIME (`check_site` raises on a bad name, so a typo'd site fails the
first time it records instead of silently producing an empty metric) and
STATICALLY (lint rule RL007 checks every string-literal site passed to
span/instant/counter/gauge/histogram/series calls against the same rules).
"""
from __future__ import annotations

import re

# first dotted segment of every site; grow this set when a new subsystem
# starts emitting (RL007 reads it too, so lint and runtime always agree)
SITE_PREFIXES = frozenset({
    "lms",        # core/lms: swap streams (params/optimizer/grads residency)
    "ddl",        # core/ddl: bucketed gradient reductions
    "train",      # train/trainer.py: step spans + registry-backed history
    "engine",     # serve/engine.py: tick / prefill / request lifecycle
    "pool",       # serve/kvpool.py: spill / prefetch / attach / preempt
    "ckpt",       # checkpoint: save span + commit point
    "sup",        # runtime/supervisor.py: restart / reshard events
    "telemetry",  # obs/telemetry.py: loss-spike alerts
    "bench",      # benchmarks
    "data",       # data loading
    "obs",        # the obs subsystem itself (self-metrics, test fixtures)
    "test",       # test-only sites
})

SITE_RE = re.compile(r"^[a-z0-9_]+(\.[a-z0-9_]+)+$")


def check_site(site: str) -> str:
    """Validate a site name; returns it unchanged. Raises ValueError on a
    non-dotted / non-lowercase name or an unregistered prefix."""
    if not isinstance(site, str) or not SITE_RE.match(site):
        raise ValueError(
            f"bad obs site {site!r}: sites are lowercase dotted identifiers "
            "like 'lms.swap_in' (at least two segments)")
    prefix = site.split(".", 1)[0]
    if prefix not in SITE_PREFIXES:
        raise ValueError(
            f"bad obs site {site!r}: prefix {prefix!r} is not registered "
            f"(known: {sorted(SITE_PREFIXES)}); add it to "
            "repro_torch.obs.sites.SITE_PREFIXES if a new subsystem is emitting")
    return site
