"""Runtime observability for the exchange stack (``repro.telemetry``).

Modules (lazily imported: ``hooks`` is the only one the hot path
touches, and it is stdlib-only):

* ``hooks``   — process-global hook points (wire recorder, tracer,
  stage scopes).  Core modules import this directly.
* ``trace``   — StepTracer (CUDA-event taps on the card, host clock on
  the CPU), Chrome-trace/Perfetto export, ``measure_wire`` (one measured
  run billing every collective against the plan's accounting).
* ``metrics`` — counters / gauges / histograms, a JSONL sink, and the
  Trainer's ``StepRecorder``.
* ``report``  — trace summarization: per-stage exposed-vs-hidden comm
  and the predicted-vs-measured diff against ``tuning.cost``.
"""
from __future__ import annotations

from repro_torch.telemetry import hooks  # stdlib-only; safe to load eagerly

_LAZY = {
    "trace": "repro_torch.telemetry.trace",
    "metrics": "repro_torch.telemetry.metrics",
    "report": "repro_torch.telemetry.report",
    # convenience re-exports
    "StepTracer": "repro_torch.telemetry.trace",
    "measure_wire": "repro_torch.telemetry.trace",
    "chrome_trace": "repro_torch.telemetry.trace",
    "MetricsLogger": "repro_torch.telemetry.metrics",
    "StepRecorder": "repro_torch.telemetry.metrics",
    "LatencyHistogram": "repro_torch.telemetry.metrics",
    # the port's earlier eager exports, kept importable
    "SCHEMA": "repro_torch.telemetry.metrics",
    "Counter": "repro_torch.telemetry.metrics",
    "Gauge": "repro_torch.telemetry.metrics",
    "summarize_trace": "repro_torch.telemetry.report",
    "predicted_vs_measured": "repro_torch.telemetry.report",
    "render_table": "repro_torch.telemetry.report",
}

__all__ = ["hooks"] + sorted(_LAZY)


def __getattr__(name):
    target = _LAZY.get(name)
    if target is None:
        raise AttributeError(
            f"module 'repro_torch.telemetry' has no attribute {name!r}")
    import importlib
    mod = importlib.import_module(target)
    value = mod if name in ("trace", "metrics", "report") else getattr(mod, name)
    globals()[name] = value
    return value
