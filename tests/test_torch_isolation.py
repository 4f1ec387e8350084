"""The port stands alone: no JAX and nothing of the ``repro`` package.

A fresh interpreter imports every module of ``repro_torch`` and must end
with no ``jax``, ``jaxlib`` or ``repro`` module loaded; a static scan of
the port's sources and ``chip_smoke.py`` finds no such import, nor does
one of the port's examples (``examples/*_torch.py``) and scripts (every
script but the reference's three).
"""
import ast
import json
import os
import pathlib
import subprocess
import sys

import pytest

pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro")
#: the scripts that belong to the reference package (they import it)
REFERENCE_SCRIPTS = ("ef_smoke.py", "report.py", "trace_report.py")
PORT_ENTRY_POINTS = sorted(
    [str(p.relative_to(ROOT)) for p in (ROOT / "examples").glob("*_torch.py")]
    + [str(p.relative_to(ROOT)) for p in (ROOT / "scripts").glob("*.py")
       if p.name not in REFERENCE_SCRIPTS])


def _modules():
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(ROOT / "src").with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        yield ".".join(parts)


def test_importing_every_module_loads_no_jax_or_reference():
    code = (
        "import importlib, json, sys\n"
        f"for m in {list(_modules())!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules\n"
        f"             if m.split('.')[0] in {FORBIDDEN!r})\n"
        "print(json.dumps(bad))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


@pytest.mark.parametrize("path", sorted(str(p.relative_to(ROOT)) for p in
                                        list(PORT.rglob("*.py"))
                                        + [ROOT / "chip_smoke.py"]))
def test_no_jax_or_reference_import_in_source(path):
    _assert_no_forbidden_import(path)


@pytest.mark.parametrize("path", PORT_ENTRY_POINTS)
def test_no_jax_or_reference_import_in_examples_and_scripts(path):
    _assert_no_forbidden_import(path)


def test_entry_point_scan_covers_the_examples_and_scripts():
    assert {"examples/quickstart_torch.py", "examples/train_nmt_torch.py",
            "examples/scaling_comparison_torch.py",
            "examples/serve_batch_torch.py",
            "examples/continuous_serving_torch.py",
            "scripts/trace_report_torch.py", "scripts/profile_torch_step.py",
            "scripts/profile_torch_serve.py", "scripts/ef_smoke_torch.py",
            "scripts/report_torch.py"} <= set(PORT_ENTRY_POINTS)


def _assert_no_forbidden_import(path):
    tree = ast.parse((ROOT / path).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, (path, name)
