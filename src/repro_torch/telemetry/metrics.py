"""Counters, gauges, latency histograms, a JSONL sink and the Trainer's
``StepRecorder`` (``repro.telemetry.metrics``).

Plain host-side bookkeeping.  Every JSONL
record carries ``{"schema": SCHEMA, "kind": <kind>}``, the reference's
schema, so one reader takes both packages' lines.  The serving engine and
the continuous batcher record into a ``MetricsLogger``: counters
(``sched/steps``, ``sched/completed``, ...), gauges
(``sched/queue_depth``, ...) and the ``serve/ttft`` / ``serve/tpot``
latency histograms whose p50/p99 ``LatencyHistogram.summary`` gives.

``StepRecorder`` is the Trainer integration: per-step loss / tok_s /
``step_ms`` split into ``data_ms`` (host batch fetch) vs ``compute_ms``,
plus overflow-skip counting.  Device values (the loss, the scaler's
overflow flag) are held as tensors until a flush boundary, so recording
adds no per-step wait for the device beyond what the Trainer's logging
already forces.
"""
from __future__ import annotations

import json
import os
import time
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


class StepRecorder:
    """Per-step Trainer instrumentation.

    Call order per step: ``step_start()`` -> ``data_loaded()`` (after the
    host batch fetch) -> ``step_end(metrics)``.  Device metrics are held
    as they are until ``flush()`` (the Trainer's log boundary) converts
    and writes them, so recording adds no extra wait for the device."""

    def __init__(self, logger: Optional[MetricsLogger] = None,
                 tokens_per_step: Optional[int] = None) -> None:
        self.logger = logger or MetricsLogger()
        self.tokens_per_step = tokens_per_step
        self.rows: List[Dict[str, Any]] = []
        self._pending: List[Dict[str, Any]] = []
        self._step = 0
        self._t0 = self._t_data = None

    # -- per-step marks -----------------------------------------------------
    def step_start(self) -> None:
        self._t0 = time.perf_counter()
        self._t_data = None

    def data_loaded(self) -> None:
        self._t_data = time.perf_counter()

    def step_end(self, metrics: Optional[Dict[str, Any]] = None) -> None:
        t1 = time.perf_counter()
        t_data = self._t_data if self._t_data is not None else self._t0
        row: Dict[str, Any] = {
            "step": self._step,
            "step_ms": (t1 - self._t0) * 1e3,
            "data_ms": (t_data - self._t0) * 1e3,
            "compute_ms": (t1 - t_data) * 1e3,
        }
        if self.tokens_per_step:
            row["tok_s"] = self.tokens_per_step / max(t1 - self._t0, 1e-9)
        self._pending.append({"row": row, "metrics": dict(metrics or {})})
        self._step += 1

    # -- flush boundary -----------------------------------------------------
    def flush(self) -> List[Dict[str, Any]]:
        """Convert pending device metrics to host floats, emit JSONL
        ``step`` records, and return the new rows."""
        out = []
        for p in self._pending:
            row, metrics = p["row"], p["metrics"]
            for k, v in metrics.items():
                try:
                    row[k] = float(v)
                except (TypeError, ValueError, RuntimeError):
                    continue
            if row.get("overflow"):
                self.logger.counter("overflow_skipped_steps").inc()
            self.logger.emit("step", **row)
            self.rows.append(row)
            out.append(row)
        self._pending.clear()
        return out

    def overflow_skipped(self) -> int:
        return self.logger.counter("overflow_skipped_steps").value

    def close(self) -> None:
        self.flush()
        self.logger.emit_summary()
        self.logger.close()
