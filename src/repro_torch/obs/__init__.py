"""Zero-dependency observability: metrics registry (Prometheus text
exposition + flat dict) and Chrome trace-event tracer, tied together by
the `Telemetry` handle threaded through the serving stack. Default is
the no-op `NOOP` singleton — zero overhead unless explicitly enabled.
"""
from repro_torch.obs.registry import (
    TIME_BUCKETS,
    CounterFamily,
    GaugeFamily,
    HistogramFamily,
    MetricsRegistry,
)
from repro_torch.obs.telemetry import BYTE_BUCKETS, NOOP, NullTelemetry, Telemetry
from repro_torch.obs.tracing import Tracer

__all__ = [
    "TIME_BUCKETS",
    "BYTE_BUCKETS",
    "CounterFamily",
    "GaugeFamily",
    "HistogramFamily",
    "MetricsRegistry",
    "NOOP",
    "NullTelemetry",
    "Telemetry",
    "Tracer",
]
