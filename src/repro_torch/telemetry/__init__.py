"""Host-side telemetry: ``metrics`` (counters, gauges, latency
histograms, a JSONL sink)."""
from repro_torch.telemetry.metrics import (SCHEMA, Counter, Gauge,
                                           LatencyHistogram, MetricsLogger)

__all__ = ["SCHEMA", "Counter", "Gauge", "LatencyHistogram",
           "MetricsLogger"]
