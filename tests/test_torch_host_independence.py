"""The port's CPU results do not depend on the host's vector ISA.

ATen picks its CPU kernels by the host's ISA and XLA generates code for
it; ``scripts/host_sweep_torch.py`` runs the port's tests as smaller
CPUs would (its ``CONFIGS``).  Two results are held here in subprocesses
under those switches:

- the seeded init (``Model.init(seed, device="cpu")``, drawn by
  ``layers.normal_f32``) gives the same bytes under
  ``ATEN_CPU_CAPABILITY=default`` and ``avx2`` as in this process, on the
  reduced transformer-big and zamba2-7b;
- the hybrid forward's parity case with no chunk padding
  (``test_torch_hybrid.py::test_forward_matches_reference
  [models-64-chunked]``) passes under ``both_sse`` (XLA capped at SSE4.2,
  ATen at ``default``), where the reference itself moves by more than the
  old bound (``HOST_TOL`` there).
"""
import hashlib
import json
import os
import pathlib
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from _torch_host_noise import load_sweep            # noqa: E402
from repro_torch.configs import get_config          # noqa: E402
from repro_torch.models import build_model          # noqa: E402
from repro_torch.tree import tree_flatten           # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]


def init_digest(arch: str, seed: int = 0) -> str:
    """sha256 of every leaf's bytes of the reduced config's CPU init."""
    params = build_model(get_config(arch).reduced()).init(seed=seed,
                                                          device="cpu")
    h = hashlib.sha256()
    for t in tree_flatten(params)[0]:
        h.update(t.contiguous().view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def _run(argv, env, timeout=120):
    return subprocess.run(argv, env=env, cwd=ROOT, capture_output=True,
                          text=True, timeout=timeout)


@pytest.mark.parametrize("arch", ["transformer-big", "zamba2-7b"])
def test_cpu_init_bytes_do_not_follow_atens_isa(arch):
    code = ("import json, sys, torch\n"
            "sys.path.insert(0, 'tests')\n"
            "from test_torch_host_independence import init_digest\n"
            f"print(json.dumps([torch.backends.cpu.get_cpu_capability(), "
            f"init_digest({arch!r})]))\n")
    got = {}
    for cap in ("default", "avx2"):
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                   ATEN_CPU_CAPABILITY=cap)
        out = _run([sys.executable, "-c", code], env)
        assert out.returncode == 0, out.stderr[-2000:]
        seen, digest = json.loads(out.stdout.strip().splitlines()[-1])
        assert seen.lower() == cap
        got[cap] = digest
    assert got["default"] == got["avx2"] == init_digest(arch)


def test_hybrid_forward_parity_holds_under_both_sse():
    sweep = load_sweep()
    case = ("tests/test_torch_hybrid.py::"
            "test_forward_matches_reference[models-64-chunked]")
    out = _run(sweep.config_argv("both_sse", [
        sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider",
        "-p", "no:randomly", case]), sweep.config_env("both_sse"),
        timeout=300)
    assert out.returncode == 0 and "1 passed" in out.stdout, \
        out.stdout[-3000:]
