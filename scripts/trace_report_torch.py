#!/usr/bin/env python3
"""Summarize an exchange Chrome trace: predicted vs measured, per stage
(``scripts/trace_report.py`` on the PyTorch port's ``report``, which
imports neither JAX nor ``repro``).

    PYTHONPATH=src python scripts/trace_report_torch.py TRACE.json [--json]

The trace files written by ``repro_torch.launch.train --trace-dir``
(and the reference's, which share the format) are self-contained: stage
names, the plan's wire accounting, the cost model's predicted per-stage
time and the runtime-measured wire bytes all ride in ``otherData``, so
this needs no plan.  It renders:

* per stage: predicted µs vs measured collective µs, split into
  exposed vs hidden (overlapped-under-compute) time;
* per stage: planned wire bytes vs the bytes the runtime wire counters
  billed, and their ratio (1.000 = the plan's accounting is exact at
  run time);
* a machine-readable ``--json`` form (one row per schedule stage and
  ``wire_exact``).

Exit status: 0 when the trace parses and every stage has a row; 2 on a
malformed/empty trace.  Wire inexactness does NOT fail the exit code —
timing drift is the thing this report exists to surface, and lossy
backends may legitimately measure differently; CI asserts on the JSON.
"""
import argparse
import json
import sys

from repro_torch.telemetry import report as report_lib


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("trace", help="trace JSON written by telemetry.trace")
    ap.add_argument("--json", action="store_true",
                    help="emit the summary as JSON instead of a table")
    args = ap.parse_args(argv)

    trace = report_lib.load_trace(args.trace)
    names = trace.get("otherData", {}).get("stage_names", [])
    if not names:
        print("malformed trace: no otherData.stage_names", file=sys.stderr)
        return 2
    rows = report_lib.predicted_vs_measured(trace)
    summary = report_lib.summarize_trace(trace)
    if len(rows) != len(names):
        print(f"malformed trace: {len(rows)} rows for {len(names)} stages",
              file=sys.stderr)
        return 2

    if args.json:
        print(json.dumps({
            "n_stages": len(rows),
            "stage_names": names,
            "mode": summary["mode"],
            "codec": summary["codec"],
            "backend": summary["backend"],
            "n_workers_traced": summary["n_workers_traced"],
            "step_us": summary["step_us"],
            "wire_exact": report_lib.wire_exact(rows),
            "rows": rows,
        }, indent=2))
        return 0

    meta = trace.get("otherData", {})
    print(f"trace: {args.trace}")
    print(f"mode={summary['mode']} codec={summary['codec']} "
          f"backend={summary['backend']} "
          f"workers_traced={summary['n_workers_traced']} "
          f"profile={meta.get('profile')}")
    if summary["step_us"] is not None:
        print(f"step: {summary['step_us'] / 1e3:.2f} ms")
    print()
    print(report_lib.render_table(rows))
    exposed = sum(r["exposed_us"] for r in rows)
    hidden = sum(r["hidden_us"] for r in rows)
    total = exposed + hidden
    if total:
        print(f"\ncomm: {total / 1e3:.2f} ms total, "
              f"{hidden / total * 100:.0f}% hidden under compute")
    print(f"wire exact vs plan: {report_lib.wire_exact(rows)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
