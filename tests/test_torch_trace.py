"""The port's Chrome trace and its report (``repro_torch.telemetry.trace``
and ``.report``) against the reference's, on the CPU:

  * ``chrome_trace`` of fixed events equal to the reference's dict;
  * ``plan_trace_meta`` equal to the reference's but for the version key
    (``torch_version`` for ``jax_version``) and the backend's name;
  * ``summarize_trace``, ``predicted_vs_measured``, ``wire_exact`` and
    ``render_table`` equal to the reference's on the same trace file;
  * the exposed/hidden split of tests/test_telemetry.py;
  * a trace the port writes from a traced local exchange, read unchanged
    by the reference's ``repro.telemetry.report``;
  * ``scripts/trace_report_torch.py`` round-trips a synthetic trace.
"""
import json
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from repro.telemetry import hooks as jhooks                    # noqa: E402
from repro.telemetry import report as jreport                  # noqa: E402
from repro.telemetry import trace as jtrace                    # noqa: E402
from repro_torch.core import DistributedOptimizer, exchange    # noqa: E402
from repro_torch.optim import adamw                            # noqa: E402
from repro_torch.telemetry import hooks, report, trace         # noqa: E402

import test_torch_stage_names as S                             # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAME = "exchange/s00/allreduce/bucket=dense0"
OTHER = "exchange/s01/allreduce/bucket=dense1"


def _events():
    """Two workers, two stages, every phase, one broadcast row and one
    unknown phase, out of time order."""
    ev = [{"stage": st, "phase": ph, "worker": w,
           "t": 0.001 * (k + 1) + 0.0003 * w + 0.01 * j}
          for w in (1, 0) for j, st in enumerate((OTHER, NAME))
          for k, ph in enumerate(trace.PHASES)]
    ev.append({"stage": "exchange/broadcast/bucket=dense0",
               "phase": "collective", "worker": 0, "t": 0.05})
    ev.append({"stage": NAME, "phase": "other", "worker": 1, "t": 0.004})
    return ev


META = {"planned_wire_bytes": {NAME: 100, OTHER: 0},
        "measured_wire_bytes": {NAME: 100},
        "predicted_us": {NAME: 123.0, OTHER: 4.5}, "mode": "fused",
        "codec": "int8", "backend": "flat"}
MARKS = [{"t_start": 0.0, "t_end": 0.06}]


def test_chrome_trace_equals_reference():
    for marks in (MARKS, (), [{"t_start": 0.0005, "t_end": 0.02},
                              {"t_start": 0.03, "t_end": 0.07}]):
        for meta in (META, None):
            got = trace.chrome_trace(_events(), [NAME, OTHER], marks, meta)
            want = jtrace.chrome_trace(_events(), [NAME, OTHER], marks,
                                       meta)
            assert got == want
    assert trace.PHASES == jtrace.PHASES
    assert trace.TRACE_SCHEMA == jtrace.TRACE_SCHEMA
    assert trace.chrome_trace([], [NAME]) == jtrace.chrome_trace([], [NAME])


def _recorders(stage_bytes):
    rec, jrec = hooks.WireRecorder(), jhooks.WireRecorder()
    for r in (rec, jrec):
        for stage, (kind, n) in stage_bytes.items():
            r.record(kind, n, stage)
    return rec, jrec


@pytest.mark.parametrize("name", sorted(S.CONFIGS))
def test_plan_trace_meta_equals_reference(name):
    plan, jplan = S.plans(name)
    names = plan.stage_names()
    rec, jrec = _recorders({names[0]: ("all-gather", 64),
                            names[-1]: ("all-reduce", 8)})
    for n in S.worker_levels(name):
        for prof in ("ethernet", "tpu"):
            for measured in ((rec, jrec), (None, None)):
                got = trace.plan_trace_meta(plan, n, profile=prof,
                                            measured=measured[0])
                want = jtrace.plan_trace_meta(jplan, n, profile=prof,
                                              measured=measured[1])
                assert got.pop("torch_version") == torch.__version__
                want.pop("jax_version")
                want["backend"] = {v: k for k, v in S.BACKENDS.items()}[
                    want["backend"]]
                assert got == want
    bad = trace.plan_trace_meta(plan, S.worker_levels(name)[0],
                                profile="nowhere")
    assert "predicted_us" not in bad and "predicted_us_error" in bad


def _trace_file(tmp_path):
    path = tmp_path / "t.json"
    trace.write_trace(trace.chrome_trace(_events(), [NAME, OTHER], MARKS,
                                         META), str(path))
    return str(path)


def test_report_equals_reference(tmp_path):
    path = _trace_file(tmp_path)
    got, want = report.load_trace(path), jreport.load_trace(path)
    assert got == want
    assert report.summarize_trace(got) == jreport.summarize_trace(want)
    rows = report.predicted_vs_measured(got)
    assert rows == jreport.predicted_vs_measured(want)
    assert report.wire_exact(rows) == jreport.wire_exact(rows) is True
    assert report.render_table(rows) == jreport.render_table(rows)
    assert [r["stage"] for r in rows] == [NAME, OTHER]
    assert rows[0]["us_ratio"] == rows[0]["measured_us"] / 123.0
    off = [dict(r, wire_ratio=0.5) for r in rows]
    assert report.wire_exact(off) is jreport.wire_exact(off) is False


def test_metrics_summary_equals_reference(tmp_path):
    path = tmp_path / "m.jsonl"
    lines = [{"schema": 1, "kind": "step", "step": k, "loss": 2.0 - k,
              "step_ms": 10.0 + k, "data_ms": 1.0, "compute_ms": 9.0 + k,
              "tok_s": 100.0} for k in range(3)]
    lines.append({"schema": 1, "kind": "history", "step": 3})
    lines.append({"schema": 1, "kind": "summary",
                  "counters": {"overflow_skipped_steps": 1},
                  "histograms": {}})
    path.write_text("\n".join(json.dumps(x) for x in lines) + "\n\n")
    got = report.summarize_metrics_jsonl(str(path))
    assert got == jreport.summarize_metrics_jsonl(str(path))
    assert got["n_steps"] == 3 and got["final_loss"] == 0.0


def test_exposed_hidden_split():
    """A collective fully covered by compute slices is hidden; an
    uncovered one is exposed (tests/test_telemetry.py's case)."""
    events = [
        {"stage": NAME, "phase": "collective", "worker": 0, "t": 0.003},
        {"stage": OTHER, "phase": "pack", "worker": 0, "t": 0.004},
    ]
    t = trace.chrome_trace(events, [NAME, OTHER],
                           [{"t_start": 0.0, "t_end": 0.005}])
    s = report.summarize_trace(t)["stages"][NAME]
    assert s["hidden_us"] == pytest.approx(s["collective_us"])
    assert s["exposed_us"] == pytest.approx(0.0)
    assert report.summarize_trace(t) == jreport.summarize_trace(t)

    events2 = [{"stage": NAME, "phase": "collective", "worker": 0,
                "t": 0.003}]
    t2 = trace.chrome_trace(events2, [NAME],
                            [{"t_start": 0.0, "t_end": 0.005}])
    s2 = report.summarize_trace(t2)["stages"][NAME]
    assert s2["exposed_us"] == pytest.approx(s2["collective_us"])


@pytest.mark.parametrize("name", ["int8+ef", "staged", "sparse_gather",
                                  "zero1"])
def test_port_trace_read_by_reference(name, tmp_path):
    """A traced local exchange (no process group): every stage gets all
    four phases, the outputs are bitwise the untraced exchange's, the
    caller's residuals are untouched, and the reference's report reads
    the written file to the same numbers as the port's."""
    kw = S.CONFIGS[name]
    opt = DistributedOptimizer(adamw(1e-3),
                               exchange=exchange.ExchangeConfig(**kw))
    g = S.port_grads()
    plan = opt.plan(g)
    state = opt.init_exchange_state(g)
    before = [s.clone() for s in state.bucket_states
              if isinstance(s, torch.Tensor)]
    if kw.get("zero1"):
        params = {k: (v[1] if isinstance(v, list) else v)
                  for k, v in g.items()}
        params = trace.copy_tensors(params)
        zs = opt.init_zero1_state(g, params)
        fn = lambda gg, pp, zz, ss: opt.zero1_step(gg, pp, zz,
                                                   exchange_state=ss)
        args = (g, params, zs, state)
    else:
        fn = lambda gg, ss: opt.exchange(gg, state=ss)
        args = (g, state)
    path = str(tmp_path / "trace.json")
    t = trace.capture_exchange_trace(plan, fn, args, 1, out_path=path,
                                     extra_meta={"arch": "tiny"})
    after = [s for s in state.bucket_states if isinstance(s, torch.Tensor)]
    assert all(torch.equal(a, b) for a, b in zip(before, after))
    assert hooks.tracer() is None and hooks.wire_recorder() is None

    plain = fn(*trace.copy_tensors(args))
    traced = trace.StepTracer().capture(fn, *args)
    flat = lambda out: [x for x in _tensors(out)]
    assert len(flat(plain)) == len(flat(traced)) > 0
    assert all(a.dtype == b.dtype and torch.equal(a, b)
               for a, b in zip(flat(plain), flat(traced)))

    names = list(plan.stage_names())
    slices = [e for e in t["traceEvents"] if e.get("cat") == "exchange"]
    assert {e["args"]["stage"] for e in slices} == set(names)
    for n in names:
        phases = {e["name"] for e in slices if e["args"]["stage"] == n}
        assert phases == set(trace.PHASES), (n, phases)
    assert all(e["dur"] >= 0 for e in t["traceEvents"] if e["ph"] == "X")
    assert t["otherData"]["arch"] == "tiny"

    jt = jreport.load_trace(path)
    assert jt == report.load_trace(path)
    rows = jreport.predicted_vs_measured(jt)
    assert rows == report.predicted_vs_measured(jt)
    assert [r["stage"] for r in rows] == names
    assert jreport.wire_exact(rows)
    js = jreport.summarize_trace(jt)
    assert js == report.summarize_trace(jt)
    assert js["n_workers_traced"] == 1 and js["step_us"] > 0
    assert jreport.render_table(rows) == report.render_table(rows)


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, dict):
        for k in sorted(x):
            yield from _tensors(x[k])
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensors(v)
    elif hasattr(x, "bucket_states"):
        yield from _tensors(x.bucket_states)
    elif hasattr(x, "_fields") or hasattr(x, "__dataclass_fields__"):
        for f in getattr(x, "_fields", None) or x.__dataclass_fields__:
            yield from _tensors(getattr(x, f))


def test_trace_report_cli(tmp_path):
    """scripts/trace_report_torch.py round-trips a synthetic trace, in
    both output forms, and refuses a malformed one."""
    events = [{"stage": NAME, "phase": ph, "worker": w,
               "t": 0.001 * (k + 1)}
              for w in (0, 1) for k, ph in enumerate(trace.PHASES)]
    t = trace.chrome_trace(events, [NAME],
                           [{"t_start": 0.0, "t_end": 0.01}],
                           meta={"planned_wire_bytes": {NAME: 100},
                                 "measured_wire_bytes": {NAME: 100},
                                 "predicted_us": {NAME: 123.0}})
    path = tmp_path / "t.json"
    trace.write_trace(t, str(path))
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    script = os.path.join(REPO, "scripts", "trace_report_torch.py")
    out = subprocess.run([sys.executable, script, str(path), "--json"],
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    d = json.loads(out.stdout)
    assert d["n_stages"] == 1 and d["wire_exact"] is True
    assert d["rows"][0]["predicted_us"] == 123.0
    assert d["rows"][0]["measured_us"] > 0
    assert d["n_workers_traced"] == 2
    table = subprocess.run([sys.executable, script, str(path)], env=env,
                           capture_output=True, text=True, timeout=120)
    assert table.returncode == 0, table.stderr[-2000:]
    assert NAME in table.stdout and "wire exact vs plan: True" in \
        table.stdout
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"traceEvents": [], "otherData": {}}))
    out = subprocess.run([sys.executable, script, str(bad)], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 2
