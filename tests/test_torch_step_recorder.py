"""The port's ``StepRecorder``, the Trainer's recorder and the launcher's
``--metrics-jsonl`` / ``--trace-dir`` / ``--profile``, on the CPU:

  * the JSONL schema and record kinds of tests/test_telemetry.py, the
    file read by both the port's and the reference's
    ``summarize_metrics_jsonl``;
  * device values deferred: ``step_end`` with tensor metrics converts
    nothing (no ``Tensor.item`` / ``__float__`` call, counted with a
    monkeypatch) until ``flush``;
  * a ``Trainer`` with a recorder on the reduced transformer-big (4 steps,
    ``log_every=2``): 4 step rows, and a history with ``data_ms`` and
    ``overflow_skipped``;
  * ``launch.train.main`` with ``--codec int8 --error-feedback
    --metrics-jsonl --trace-dir`` writes both files, which the
    reference's readers take; ``print_exchange_schedule`` logs the
    reference's ``describe()`` of the same plan.
"""
import json
import os

import pytest

torch = pytest.importorskip("torch")

import numpy as np                            # noqa: E402

from repro.telemetry import metrics as jmetrics                # noqa: E402
from repro.telemetry import report as jreport                  # noqa: E402
from repro_torch.configs import get_config                     # noqa: E402
from repro_torch.core import (DistributedOptimizer,             # noqa: E402
                              ExchangeConfig)
from repro_torch.data import make_pipeline                     # noqa: E402
from repro_torch.launch import train                           # noqa: E402
from repro_torch.models import build_model                     # noqa: E402
from repro_torch.optim import adamw                            # noqa: E402
from repro_torch.telemetry import metrics, report              # noqa: E402
from repro_torch.training import (Trainer, TrainerConfig,      # noqa: E402
                                  make_train_step)


def _lines(path):
    return [json.loads(x) for x in open(path).read().splitlines() if x]


def test_metrics_jsonl_schema(tmp_path):
    path = tmp_path / "m.jsonl"
    rec = metrics.StepRecorder(metrics.MetricsLogger(str(path)),
                               tokens_per_step=128)
    for i in range(3):
        rec.step_start()
        rec.data_loaded()
        rec.step_end({"loss": torch.tensor(1.0 - 0.1 * i),
                      "overflow": torch.tensor(i == 1),
                      "note": "not a number"})
    rows = rec.flush()
    assert len(rows) == 3 and rec.rows == rows
    assert rec.overflow_skipped() == 1
    rec.close()

    lines = _lines(path)
    assert metrics.SCHEMA == jmetrics.SCHEMA
    assert all(r["schema"] == metrics.SCHEMA for r in lines)
    kinds = [r["kind"] for r in lines]
    assert kinds.count("step") == 3 and kinds[-1] == "summary"
    step0 = next(r for r in lines if r["kind"] == "step")
    for k in ("step", "step_ms", "data_ms", "compute_ms", "tok_s",
              "loss"):
        assert k in step0, step0
    assert "note" not in step0
    assert [r["step"] for r in lines if r["kind"] == "step"] == [0, 1, 2]
    assert lines[-1]["counters"]["overflow_skipped_steps"] == 1

    for summarize in (report.summarize_metrics_jsonl,
                      jreport.summarize_metrics_jsonl):
        s = summarize(str(path))
        assert s["n_steps"] == 3
        assert s["final_loss"] == pytest.approx(0.8)
        assert s["counters"]["overflow_skipped_steps"] == 1
    assert report.summarize_metrics_jsonl(str(path)) == \
        jreport.summarize_metrics_jsonl(str(path))


def test_recorder_defers_device_values(monkeypatch):
    """``step_end`` must not wait for the device: tensors are held as they
    are (no ``item`` / ``__float__``) until ``flush``."""
    calls = {"item": 0, "float": 0}
    item, to_float = torch.Tensor.item, torch.Tensor.__float__

    def counted_item(self):
        calls["item"] += 1
        return item(self)

    def counted_float(self):
        calls["float"] += 1
        return to_float(self)

    monkeypatch.setattr(torch.Tensor, "item", counted_item)
    monkeypatch.setattr(torch.Tensor, "__float__", counted_float)
    rec = metrics.StepRecorder()
    for v in (2.5, 3.5):
        rec.step_start()
        rec.step_end({"loss": torch.tensor(v)})
    assert rec.rows == []
    assert calls == {"item": 0, "float": 0}
    rows = rec.flush()
    assert sum(calls.values()) >= 2
    assert [r["loss"] for r in rows] == [2.5, 3.5]
    assert rows[0]["data_ms"] == 0.0            # no data_loaded mark
    assert rec.flush() == []


def test_trainer_records_history_and_metrics(tmp_path):
    cfg = get_config("transformer-big").reduced()
    model = build_model(cfg)
    params = model.init(seed=0, device="cpu")
    opt = DistributedOptimizer(adamw(1e-3))
    step_fn = make_train_step(model, opt)
    pipe = make_pipeline(cfg, 2, 8)
    path = tmp_path / "m.jsonl"
    rec = metrics.StepRecorder(metrics.MetricsLogger(str(path)),
                               tokens_per_step=16)
    tr = Trainer(model, step_fn, pipe,
                 TrainerConfig(total_steps=4, log_every=2), device="cpu",
                 recorder=rec)
    res = tr.run(params, opt.init(params), opt.init_exchange_state(
        params, device="cpu"), log=lambda s: None)
    assert len(rec.rows) == 4            # flushed at each log boundary
    rec.close()
    assert len(res["history"]) == 2
    assert all("data_ms" in h and "overflow_skipped" in h
               for h in res["history"])
    lines = _lines(path)
    steps = [r for r in lines if r["kind"] == "step"]
    assert len(steps) == 4
    assert all("loss" in s and "compute_ms" in s and "tok_s" in s
               for s in steps)
    assert [s["loss"] for s in steps[1::2]] == pytest.approx(
        [h["loss"] for h in res["history"]])
    assert jreport.summarize_metrics_jsonl(str(path))["n_steps"] == 4


def test_launcher_writes_metrics_and_trace(tmp_path, capsys):
    jsonl = str(tmp_path / "run" / "m.jsonl")
    tdir = str(tmp_path / "tr")
    argv = ["--reduced", "--device", "cpu", "--codec", "int8",
            "--error-feedback", "--steps", "2", "--batch-per-worker", "2",
            "--seq-len", "8", "--metrics-jsonl", jsonl, "--trace-dir",
            tdir]
    assert train.main(argv) == 0
    out = capsys.readouterr().out
    assert "exchange: strategy=dense_reduce+codec:int8+ef" in out
    assert "profile=ethernet" in out
    assert f"metrics written: {jsonl}" in out
    assert "trace written:" in out

    lines = _lines(jsonl)
    kinds = [r["kind"] for r in lines]
    assert kinds.count("step") == 2 and kinds[-1] == "summary"
    assert kinds.count("history") == 1          # log_every 10: one window
    args = train.parse_args(argv)
    tokens = args.batch_per_worker * args.seq_len
    assert all(r["tok_s"] > 0 for r in lines if r["kind"] == "step")
    hist = next(r for r in lines if r["kind"] == "history")
    assert hist["tokens"] == 2 * tokens and hist["step"] == 2
    s = jreport.summarize_metrics_jsonl(jsonl)
    assert s == report.summarize_metrics_jsonl(jsonl)
    assert s["n_steps"] == 2 and np.isfinite(s["final_loss"])

    path = os.path.join(tdir, "trace.json")
    t = jreport.load_trace(path)
    names = t["otherData"]["stage_names"]
    assert len(names) == 16
    assert t["otherData"]["codec"] == "int8+ef"
    assert t["otherData"]["mode"] == "fused"
    assert t["otherData"]["arch"] == "transformer-big"
    rows = jreport.predicted_vs_measured(t)
    assert [r["stage"] for r in rows] == names
    assert jreport.wire_exact(rows)
    assert all(r["predicted_us"] > 0 for r in rows)
    summary = jreport.summarize_trace(t)
    assert summary == report.summarize_trace(t)
    assert summary["n_workers_traced"] == 1 and summary["step_us"] > 0
    for n in names:
        assert set(summary["stages"][n]["phase_us"]) == {
            "accumulate", "pack", "collective", "unpack"}
    assert jreport.render_table(rows) in out


def test_print_exchange_schedule_equals_reference():
    """The launcher's schedule printout is ``ExchangeStats.describe()``
    at the launcher's worker count, the reference's string for the same
    plan."""
    from repro.core import DistributedOptimizer as JDistOpt
    from repro.core import ExchangeConfig as JExchangeConfig
    from repro.optim import adamw as jadamw

    import test_torch_stage_names as S

    for argv, world, want_n in (
            (["--dist", "local"], 1, 1),
            (["--dist", "horovod", "--overlap", "staged"], 4, 4),
            (["--dist", "horovod", "--backend", "hierarchical"], 4,
             (2, 2))):
        args = train.parse_args(argv)
        opt = DistributedOptimizer(adamw(1e-3), exchange=ExchangeConfig(
            sparse_as_dense=True, backend=args.backend,
            overlap=args.overlap or False))
        assert train.exchange_workers(args, opt, world) == want_n
        got = []
        train.print_exchange_schedule(args, opt, S.port_grads(), world,
                                      got.append)
        jopt = JDistOpt(jadamw(1e-3), exchange=JExchangeConfig(
            sparse_as_dense=True, backend=S.BACKENDS[args.backend],
            overlap=args.overlap or False))
        assert got == [jopt.exchange_stats(S.ref_grads(), want_n,
                                           profile="ethernet").describe()]
    broken = []
    args.profile = "nowhere"
    train.print_exchange_schedule(args, opt, S.port_grads(), 4,
                                  broken.append)
    assert broken[0].startswith("(exchange schedule unavailable:")
