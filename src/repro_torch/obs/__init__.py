"""Runtime observability: metrics registry, tracing spans over a bounded
ring with an optional JSONL sink. Stdlib only, as in the JAX package, whose
site names (`engine.tick`, `pool.spill`, ...) the port keeps."""
from repro_torch.obs.registry import (Counter, Gauge, Histogram,
                                      MetricsRegistry, Series)
from repro_torch.obs.sites import SITE_PREFIXES, SITE_RE, check_site
from repro_torch.obs.trace import (Obs, SpanEvent, TraceRing, configure,
                                   get_obs)

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "Series",
    "SITE_PREFIXES", "SITE_RE", "check_site",
    "Obs", "SpanEvent", "TraceRing", "configure", "get_obs",
]
