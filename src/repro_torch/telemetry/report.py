"""Trace summarization: exposed-vs-hidden comm, predicted-vs-measured
(``repro.telemetry.report``, whole).

Operates on the self-contained Chrome-trace dicts written by
``telemetry.trace`` (the port's and the reference's share one format):
stage names, the plan's wire accounting, the cost model's per-stage
prediction and the runtime-measured wire bytes all ride in
``otherData``, so summarizing a trace needs neither the model nor a
plan (the CLI is ``scripts/trace_report_torch.py``).

Definitions (per worker, then averaged):

* a stage's **collective interval** is its ``collective`` slice;
* **compute intervals** are every non-collective slice of the same
  worker (any stage) — accumulate/pack/unpack work the scheduler can
  overlap against;
* **exposed** comm is the part of a collective interval covered by no
  compute interval; **hidden** is the rest.  Hidden/total is the
  overlap win the staged/wait-free schedules exist to maximise.
"""
from __future__ import annotations

import json
from typing import Any, Dict, List, Optional, Sequence, Tuple


def load_trace(path: str) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


def _slices(trace: Dict[str, Any]) -> List[Dict[str, Any]]:
    return [e for e in trace.get("traceEvents", ())
            if e.get("ph") == "X" and e.get("cat") == "exchange"]


def _interval_subtract(lo: float, hi: float,
                       cover: Sequence[Tuple[float, float]]) -> float:
    """Length of [lo, hi] NOT covered by the union of ``cover``."""
    exposed = hi - lo
    merged: List[List[float]] = []
    for a, b in sorted(cover):
        a, b = max(a, lo), min(b, hi)
        if b <= a:
            continue
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    for a, b in merged:
        exposed -= b - a
    return max(exposed, 0.0)


def summarize_trace(trace: Dict[str, Any]) -> Dict[str, Any]:
    """Per-stage phase durations + exposed/hidden comm, averaged over
    workers; plus step wall time when step slices are present."""
    other = trace.get("otherData", {})
    names = list(other.get("stage_names", ()))
    slices = _slices(trace)
    workers = sorted({e["pid"] for e in slices})
    per_stage: Dict[str, Dict[str, Any]] = {
        n: {"phase_us": {}, "collective_us": 0.0, "exposed_us": 0.0,
            "hidden_us": 0.0} for n in names}
    for w in workers:
        mine = [e for e in slices if e["pid"] == w]
        compute = [(e["ts"], e["ts"] + e["dur"]) for e in mine
                   if e["name"] != "collective"]
        for e in mine:
            stage = e.get("args", {}).get("stage")
            if stage not in per_stage:
                continue
            row = per_stage[stage]
            row["phase_us"][e["name"]] = (
                row["phase_us"].get(e["name"], 0.0) + e["dur"])
            if e["name"] == "collective":
                lo, hi = e["ts"], e["ts"] + e["dur"]
                exp = _interval_subtract(lo, hi, compute)
                row["collective_us"] += e["dur"]
                row["exposed_us"] += exp
                row["hidden_us"] += e["dur"] - exp
    nw = max(len(workers), 1)
    for row in per_stage.values():
        row["phase_us"] = {k: v / nw for k, v in row["phase_us"].items()}
        for k in ("collective_us", "exposed_us", "hidden_us"):
            row[k] /= nw
    steps = [e for e in trace.get("traceEvents", ())
             if e.get("ph") == "X" and e.get("cat") == "step"]
    step_us = (sum(e["dur"] for e in steps) / max(len(steps), 1)
               if steps else None)
    return {"stages": per_stage, "n_workers_traced": len(workers),
            "step_us": step_us, "mode": other.get("mode"),
            "codec": other.get("codec"), "backend": other.get("backend")}


def predicted_vs_measured(trace: Dict[str, Any]) -> List[Dict[str, Any]]:
    """One row per schedule stage: the tuner's predicted µs, the
    measured collective µs (worker-averaged), exposed/hidden split,
    planned vs runtime-measured wire bytes, and the drift ratios that
    close the loop ``dryrun --audit-exchange`` only checks statically."""
    other = trace.get("otherData", {})
    names = list(other.get("stage_names", ()))
    summary = summarize_trace(trace)["stages"]
    predicted = other.get("predicted_us", {})
    planned_wire = other.get("planned_wire_bytes", {})
    measured_wire = other.get("measured_wire_bytes", {})
    rows = []
    for n in names:
        s = summary.get(n, {})
        meas_us = s.get("collective_us", 0.0)
        pred_us = predicted.get(n)
        pw = planned_wire.get(n)
        mw = measured_wire.get(n)
        rows.append({
            "stage": n,
            "predicted_us": pred_us,
            "measured_us": meas_us,
            "exposed_us": s.get("exposed_us", 0.0),
            "hidden_us": s.get("hidden_us", 0.0),
            "us_ratio": (meas_us / pred_us
                         if pred_us not in (None, 0) else None),
            "planned_wire_bytes": pw,
            "measured_wire_bytes": mw,
            "wire_ratio": (mw / pw if pw and mw is not None else
                           (1.0 if not pw and not mw else None)),
        })
    return rows


def wire_exact(rows: Sequence[Dict[str, Any]]) -> bool:
    """True when every stage's runtime wire counter equals the plan's
    accounting (the acceptance contract for exact backends/codecs)."""
    return all(r["wire_ratio"] is not None
               and abs(r["wire_ratio"] - 1.0) < 1e-9 for r in rows)


def render_table(rows: Sequence[Dict[str, Any]]) -> str:
    """Fixed-width predicted-vs-measured table."""
    hdr = (f"{'stage':<52} {'pred_us':>9} {'meas_us':>9} {'exp_us':>8} "
           f"{'hid_us':>8} {'wire_plan':>10} {'wire_meas':>10} {'ratio':>6}")
    lines = [hdr, "-" * len(hdr)]

    def fmt(v, spec):
        return format(v, spec) if v is not None else "-"

    for r in rows:
        mw = r["measured_wire_bytes"]
        mw = int(mw) if mw is not None else None
        lines.append(
            f"{r['stage']:<52} {fmt(r['predicted_us'], '9.1f')} "
            f"{fmt(r['measured_us'], '9.1f')} "
            f"{fmt(r['exposed_us'], '8.1f')} {fmt(r['hidden_us'], '8.1f')} "
            f"{fmt(r['planned_wire_bytes'], '10d')} "
            f"{fmt(mw, '10d')} "
            f"{fmt(r['wire_ratio'], '6.3f')}")
    return "\n".join(lines)


def summarize_metrics_jsonl(path: str) -> Dict[str, Any]:
    """Roll up a metrics JSONL file (``kind=step`` rows + the trailing
    ``summary``) into the numbers a report renders."""
    steps: List[Dict[str, Any]] = []
    summary: Optional[Dict[str, Any]] = None
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            rec = json.loads(line)
            if rec.get("kind") == "step":
                steps.append(rec)
            elif rec.get("kind") == "summary":
                summary = rec
    out: Dict[str, Any] = {"n_steps": len(steps)}
    if steps:
        last = steps[-1]
        out["final_loss"] = last.get("loss")
        for k in ("step_ms", "data_ms", "compute_ms", "tok_s"):
            vals = [s[k] for s in steps if k in s]
            if vals:
                out[f"mean_{k}"] = sum(vals) / len(vals)
    if summary:
        out["counters"] = summary.get("counters", {})
        out["histograms"] = summary.get("histograms", {})
    return out
