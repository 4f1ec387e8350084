"""``scripts/report_torch.py`` against the reference's ``scripts/report.py``:
the port's launcher trains the reduced transformer-big for 2 steps on the
CPU (int8 + error feedback, a world of 1) and writes its
``--metrics-jsonl`` and ``--trace-dir``; both scripts, each in a fresh
interpreter, then print the same standard output on those files and both
exit 0.  Without the files (and with no dry-run JSON in the repo) both
print the same line and exit 1.
"""
import os
import subprocess
import sys

import pytest

pytest.importorskip("torch")

from repro_torch.launch import train          # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _script(name, args):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, os.path.join(ROOT, "scripts",
                                                        name)] + args,
                          env=env, cwd=ROOT, capture_output=True,
                          text=True, timeout=240)


@pytest.fixture(scope="module")
def run_files(tmp_path_factory):
    out = tmp_path_factory.mktemp("report")
    jsonl, tdir = str(out / "metrics.jsonl"), str(out / "trace")
    res = train.run(["--reduced", "--dist", "horovod", "--grad-accum",
                     "dense_reduce", "--codec", "int8", "--error-feedback",
                     "--batch-per-worker", "2", "--seq-len", "8",
                     "--steps", "2", "--log-every", "1", "--device", "cpu",
                     "--metrics-jsonl", jsonl, "--trace-dir", tdir],
                    log=lambda s: None)
    assert len(res["history"]) == 2
    return jsonl, os.path.join(tdir, "trace.json")


def test_report_prints_what_the_reference_prints(run_files):
    jsonl, trace = run_files
    args = ["--metrics", jsonl, "--trace", trace]
    ours, theirs = _script("report_torch.py", args), _script("report.py",
                                                             args)
    assert ours.returncode == 0, ours.stderr
    assert theirs.returncode == 0, theirs.stderr
    assert ours.stdout == theirs.stdout
    assert "=== training metrics" in ours.stdout
    assert "  steps: 2" in ours.stdout
    assert "wire exact vs plan: True" in ours.stdout


def test_report_without_artifacts_exits_1_as_the_reference():
    ours, theirs = _script("report_torch.py", []), _script("report.py", [])
    assert ours.returncode == theirs.returncode == 1
    assert ours.stdout == theirs.stdout == (
        "no dry-run artifacts; run scripts/run_dryruns.sh first\n")
