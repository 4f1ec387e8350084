#!/usr/bin/env python3
"""Render the experiment artifacts into one human-readable report
(``scripts/report.py`` on the PyTorch port's ``telemetry.report``, which
imports neither JAX nor ``repro``).

    PYTHONPATH=src python scripts/report_torch.py [--pod 1pod|2pod]
        [--metrics metrics.jsonl] [--trace trace.json]

Aggregates experiments/dryrun/*.json (roofline terms), the hillclimb
JSONs, and the multi-pod coverage into a terminal report — the quick
answer to "where does each architecture sit and what binds it".

``--metrics`` / ``--trace`` additionally render a training run's
telemetry artifacts (the JSONL written by ``repro_torch.launch.train
--metrics-jsonl`` and the Chrome trace from ``--trace-dir``) next to the
static numbers, closing the predicted-vs-measured loop in one report.
The port writes no dry-run or hill-climb JSON: without any, the script
says so and exits 0 when it rendered telemetry, else 1.
"""
import argparse
import glob
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SWEEP = os.path.join(REPO, "experiments", "dryrun")
HILL = os.path.join(REPO, "experiments", "hillclimb")


def load(pattern):
    return [json.load(open(f)) for f in sorted(glob.glob(pattern))]


def render_metrics(path):
    from repro_torch.telemetry import report as report_lib

    s = report_lib.summarize_metrics_jsonl(path)
    print(f"=== training metrics ({path}) ===")
    print(f"  steps: {s['n_steps']}")
    if s.get("final_loss") is not None:
        print(f"  final loss: {s['final_loss']:.4f}")
    for k in ("step_ms", "data_ms", "compute_ms", "tok_s"):
        v = s.get(f"mean_{k}")
        if v is not None:
            print(f"  mean {k}: {v:.2f}")
    for name, val in s.get("counters", {}).items():
        print(f"  counter {name}: {val}")
    for name, h in s.get("histograms", {}).items():
        print(f"  hist {name}: p50={h['p50_ms']:.2f}ms "
              f"p99={h['p99_ms']:.2f}ms n={h['count']}")


def render_trace(path):
    from repro_torch.telemetry import report as report_lib

    trace = report_lib.load_trace(path)
    rows = report_lib.predicted_vs_measured(trace)
    print(f"=== exchange trace ({path}) ===")
    print(report_lib.render_table(rows))
    print(f"wire exact vs plan: {report_lib.wire_exact(rows)}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--pod", default="1pod", choices=["1pod", "2pod"])
    ap.add_argument("--metrics", default=None,
                    help="metrics JSONL from train.py --metrics-jsonl")
    ap.add_argument("--trace", default=None,
                    help="Chrome trace from train.py --trace-dir")
    args = ap.parse_args(argv)

    shown_telemetry = False
    if args.metrics:
        render_metrics(args.metrics)
        shown_telemetry = True
    if args.trace:
        if shown_telemetry:
            print()
        render_trace(args.trace)
        shown_telemetry = True
    if shown_telemetry:
        print()

    rows = load(os.path.join(SWEEP, f"*__{args.pod}.json"))
    if not rows:
        print("no dry-run artifacts; run scripts/run_dryruns.sh first")
        return 0 if shown_telemetry else 1

    print(f"=== roofline ({args.pod}, {len(rows)} combos) ===")
    print(f"{'arch':22s} {'shape':12s} {'bound':7.7s} "
          f"{'c(s)':>8s} {'m(s)':>8s} {'x(s)':>8s} {'useful':>7s}")
    rows.sort(key=lambda d: (d["shape"], -max(d["compute_s"],
                                              d["memory_s"],
                                              d["collective_s"])))
    for d in rows:
        r = d.get("useful_flops_ratio")
        print(f"{d['arch']:22s} {d['shape']:12s} "
              f"{d['dominant'].replace('_s',''):7s} "
              f"{d['compute_s']:8.4f} {d['memory_s']:8.4f} "
              f"{d['collective_s']:8.4f} "
              f"{(f'{r:7.3f}' if r else '      -')}")

    # headline bounds per shape
    print("\n=== step-time bound by shape (worst arch) ===")
    by_shape = {}
    for d in rows:
        bound = max(d["compute_s"], d["memory_s"], d["collective_s"])
        key = d["shape"]
        if key not in by_shape or bound > by_shape[key][0]:
            by_shape[key] = (bound, d["arch"], d["dominant"])
    for shape, (bound, arch, dom) in sorted(by_shape.items()):
        print(f"  {shape:12s} {bound:9.3f}s  ({arch}, {dom})")

    hc = load(os.path.join(HILL, "*.json"))
    if hc:
        print(f"\n=== hillclimb artifacts ({len(hc)} runs, see "
              f"EXPERIMENTS.md §Perf for the narrative) ===")
        for d in hc:
            bound = max(d["compute_s"], d["memory_s"], d["collective_s"])
            extras = [k for k in ("pure_dp", "moe_decode", "ssm_chunk")
                      if d.get(k) not in (None, False, "dropless")]
            print(f"  {d['arch']:22s} {d['shape']:12s} bound {bound:8.4f}s"
                  f"  {' '.join(f'{k}={d[k]}' for k in extras)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
