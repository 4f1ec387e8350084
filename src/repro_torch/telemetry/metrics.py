"""Counters, gauges, latency histograms and a JSONL sink
(``repro.telemetry.metrics`` without its ``StepRecorder``).

Plain host-side bookkeeping: nothing here touches a tensor.  Every JSONL
record carries ``{"schema": SCHEMA, "kind": <kind>}``, the reference's
schema, so one reader takes both packages' lines.  The serving engine and
the continuous batcher record into a ``MetricsLogger``: counters
(``sched/steps``, ``sched/completed``, ...), gauges
(``sched/queue_depth``, ...) and the ``serve/ttft`` / ``serve/tpot``
latency histograms whose p50/p99 ``LatencyHistogram.summary`` gives.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional

SCHEMA = 1


class Counter:
    def __init__(self, name: str) -> None:
        self.name, self.value = name, 0

    def inc(self, n: int = 1) -> None:
        self.value += n


class Gauge:
    def __init__(self, name: str) -> None:
        self.name, self.value = name, None

    def set(self, v: float) -> None:
        self.value = v


class LatencyHistogram:
    """Reservoir of observed latencies (seconds in, ms out) with
    percentile summaries — the serving p50/p99 primitive."""

    def __init__(self, name: str, max_samples: int = 65536) -> None:
        self.name = name
        self.max_samples = max_samples
        self.samples: List[float] = []
        self.count = 0

    def observe(self, seconds: float) -> None:
        self.count += 1
        if len(self.samples) < self.max_samples:
            self.samples.append(seconds)
        else:  # deterministic decimating reservoir: keep every other
            self.samples = self.samples[::2]
            self.samples.append(seconds)

    def percentile(self, q: float) -> Optional[float]:
        if not self.samples:
            return None
        s = sorted(self.samples)
        k = min(int(q / 100.0 * len(s)), len(s) - 1)
        return s[k]

    def summary(self) -> Dict[str, Any]:
        ms = 1e3
        return {
            "name": self.name, "count": self.count,
            "p50_ms": (self.percentile(50) or 0.0) * ms,
            "p99_ms": (self.percentile(99) or 0.0) * ms,
            "mean_ms": (sum(self.samples) / len(self.samples) * ms
                        if self.samples else 0.0),
        }


class MetricsLogger:
    """Named counters/gauges/histograms + an optional JSONL sink."""

    def __init__(self, path: Optional[str] = None) -> None:
        self.path = path
        if path:
            d = os.path.dirname(path)
            if d:
                os.makedirs(d, exist_ok=True)
        self._fh = open(path, "a") if path else None
        self.counters: Dict[str, Counter] = {}
        self.gauges: Dict[str, Gauge] = {}
        self.histograms: Dict[str, LatencyHistogram] = {}

    def counter(self, name: str) -> Counter:
        return self.counters.setdefault(name, Counter(name))

    def gauge(self, name: str) -> Gauge:
        return self.gauges.setdefault(name, Gauge(name))

    def histogram(self, name: str) -> LatencyHistogram:
        return self.histograms.setdefault(name, LatencyHistogram(name))

    def emit(self, kind: str, **fields) -> None:
        """Append one schema-stamped JSONL record (no-op without a
        sink path)."""
        if self._fh is None:
            return
        rec = {"schema": SCHEMA, "kind": kind}
        rec.update(fields)
        self._fh.write(json.dumps(rec) + "\n")
        self._fh.flush()

    def emit_summary(self) -> None:
        """One ``summary`` record: counter/gauge values + histogram
        percentiles."""
        self.emit(
            "summary",
            counters={k: c.value for k, c in self.counters.items()},
            gauges={k: g.value for k, g in self.gauges.items()},
            histograms={k: h.summary()
                        for k, h in self.histograms.items()})

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None
