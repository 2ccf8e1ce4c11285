"""Runtime observability: metrics registry, tracing spans over a bounded
ring with an optional JSONL sink, the Chrome-trace and overlap-report
exporters, and the training telemetry loop. Stdlib only, as in the JAX
package, whose site names (`engine.tick`, `pool.spill`, ...) and report
schema the port keeps."""
from repro_torch.obs.registry import (Counter, Gauge, Histogram,
                                      MetricsRegistry, Series)
from repro_torch.obs.report import (build_obs_report, categorize,
                                    export_chrome_trace, load_obs_report,
                                    overlap_report, write_obs_report)
from repro_torch.obs.sites import SITE_PREFIXES, SITE_RE, check_site
from repro_torch.obs.telemetry import SpikeDetector, TelemetryAlert, TelemetryLoop
from repro_torch.obs.trace import (Obs, SpanEvent, TraceRing, configure,
                                   get_obs)

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "Series",
    "build_obs_report", "categorize", "export_chrome_trace",
    "load_obs_report", "overlap_report", "write_obs_report",
    "SITE_PREFIXES", "SITE_RE", "check_site",
    "SpikeDetector", "TelemetryAlert", "TelemetryLoop",
    "Obs", "SpanEvent", "TraceRing", "configure", "get_obs",
]
