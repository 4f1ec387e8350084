#!/usr/bin/env python3
"""Run the port's tests as other x86-64 hosts would run them.

    python3 scripts/host_sweep_torch.py [--files tests/test_torch_a.py ...]
        [--configs native,aten_default,...] [--repeat 1] [--out FILE]

ATen picks its CPU kernels by the host's vector ISA, and XLA's CPU
backend generates code for it, so a floating-point result may depend on
the machine that runs the tests.  Each library has a switch that makes
it act as a smaller CPU: ``ATEN_CPU_CAPABILITY`` and
``XLA_FLAGS=--xla_cpu_max_isa``.  This script runs the given test files
(by default every ``tests/test_torch_*.py``) through pytest under each
configuration of ``CONFIGS``, one pytest process a configuration, with
``-n 6 --dist loadfile`` as the tier-1 command runs them, and reads
each run's junit XML.

Per configuration it prints the passed, failed, errored and skipped
counts and every test that did not pass.  A failure whose message holds
``Symbols not found`` or ``Failed to materialize symbols`` is the
reference failing to compile under an XLA cap (XLA's SSE4.2 code has no
f16 conversion: LLVM logs ``Symbols not found: [ __truncsfhf2 ]`` and
JAX raises the second); it is counted in a column of its own,
"ref_cannot_compile", and not against the port.

The script imports nothing of the two packages: it only starts pytest.
A whole sweep takes about 15 minutes a configuration on 8 CPUs, and
``one_cpu`` (every worker on CPU 0) several times that; ``--files`` picks
a shorter list.  ``--out`` writes the per-configuration results as JSON.
Exit code 0 when no configuration has a failed or errored test outside
that column.
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import subprocess
import sys
import tempfile
import time
import xml.etree.ElementTree as ET

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: name -> (extra environment, command prefix)
CONFIGS = {
    "native": ({}, []),
    "aten_avx2": ({"ATEN_CPU_CAPABILITY": "avx2"}, []),
    "aten_default": ({"ATEN_CPU_CAPABILITY": "default"}, []),
    "xla_avx2": ({"XLA_FLAGS": "--xla_cpu_max_isa=AVX2"}, []),
    "both_sse": ({"XLA_FLAGS": "--xla_cpu_max_isa=SSE4_2",
                  "ATEN_CPU_CAPABILITY": "default"}, []),
    "one_cpu": ({"XLA_FLAGS": "--xla_cpu_multi_thread_eigen=false"},
                ["taskset", "-c", "0"]),
}
REF_CANNOT_COMPILE = ("Symbols not found", "Failed to materialize symbols")
OUTCOMES = ("passed", "failed", "errored", "skipped", "ref_cannot_compile")
WORKERS = 6                        # the tier-1 command's pytest-xdist workers
TIMEOUT = 3 * 3600                 # seconds one pytest process may take


def config_env(name: str) -> dict:
    """The environment a test process of configuration ``name`` runs in:
    this one's with ``src`` on the path, JAX on the CPU and the
    configuration's variables."""
    env = dict(os.environ)
    src = os.path.join(ROOT, "src")
    env["PYTHONPATH"] = src + (os.pathsep + env["PYTHONPATH"]
                               if env.get("PYTHONPATH") else "")
    env["JAX_PLATFORMS"] = "cpu"
    env["ALLOW_MULTIPLE_LIBTPU_LOAD"] = "1"
    for key in ("ATEN_CPU_CAPABILITY", "XLA_FLAGS"):
        env.pop(key, None)
    env.update(CONFIGS[name][0])
    return env


def config_argv(name: str, argv) -> list:
    """``argv`` with the configuration's command prefix."""
    return list(CONFIGS[name][1]) + list(argv)


def read_junit(path: str) -> dict:
    """Outcome lists of one junit XML file: ``passed``, ``failed``,
    ``errored``, ``skipped`` and ``ref_cannot_compile`` (test ids as
    ``file::name``)."""
    out = {k: [] for k in OUTCOMES}
    for case in ET.parse(path).getroot().iter("testcase"):
        cls = case.get("classname", "")
        test_id = cls.replace(".", "/") + ".py::" + case.get("name", "")
        failure = case.find("failure")
        error = case.find("error")
        if failure is not None or error is not None:
            node = failure if failure is not None else error
            text = (node.get("message") or "") + (node.text or "")
            if any(m in text for m in REF_CANNOT_COMPILE):
                out["ref_cannot_compile"].append(test_id)
            elif failure is not None:
                out["failed"].append(test_id)
            else:
                out["errored"].append(test_id)
        elif case.find("skipped") is not None:
            out["skipped"].append(test_id)
        else:
            out["passed"].append(test_id)
    return out


def run_config(name: str, files) -> dict:
    """One pytest process over ``files`` under configuration ``name``."""
    with tempfile.TemporaryDirectory() as tmp:
        xml = os.path.join(tmp, "junit.xml")
        argv = [sys.executable, "-m", "pytest", "-q",
                "--continue-on-collection-errors", "-p", "no:cacheprovider",
                "-p", "no:randomly", f"--junitxml={xml}", "-p", "xdist",
                "-n", str(WORKERS), "--dist", "loadfile"]
        t0 = time.perf_counter()
        try:
            proc = subprocess.run(config_argv(name, argv + list(files)),
                                  env=config_env(name), cwd=ROOT,
                                  capture_output=True, text=True,
                                  timeout=TIMEOUT)
            rc, tail = proc.returncode, proc.stdout[-2000:]
        except subprocess.TimeoutExpired as e:
            rc = 124
            tail = (e.stdout or b"")[-2000:]
            tail = tail.decode() if isinstance(tail, bytes) else tail
        seconds = time.perf_counter() - t0
        have_xml = os.path.exists(xml)
        res = read_junit(xml) if have_xml else {k: [] for k in OUTCOMES}
    res.update(config=name, rc=rc, seconds=round(seconds, 1))
    if not have_xml or rc not in (0, 1):
        res["tail"] = tail
    return res


def summary_line(res: dict) -> str:
    return (f"{res['config']:<13} passed {len(res['passed']):>5}  failed "
            f"{len(res['failed']):>3}  errored {len(res['errored']):>3}  "
            f"skipped {len(res['skipped']):>3}  ref_cannot_compile "
            f"{len(res['ref_cannot_compile']):>3}  rc {res['rc']}  "
            f"{res['seconds']:.1f} s")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--files", nargs="+", default=None,
                    help="test files (default: every tests/test_torch_*.py)")
    ap.add_argument("--configs", default=",".join(CONFIGS),
                    help="comma-separated names from: " + ", ".join(CONFIGS))
    ap.add_argument("--repeat", type=int, default=1,
                    help="runs of the files under each configuration")
    ap.add_argument("--out", default=None, help="write the results as JSON")
    args = ap.parse_args(argv)
    files = args.files or sorted(
        os.path.relpath(p, ROOT)
        for p in glob.glob(os.path.join(ROOT, "tests", "test_torch_*.py")))
    names = [n for n in args.configs.split(",") if n]
    unknown = [n for n in names if n not in CONFIGS]
    if unknown:
        ap.error(f"unknown configurations {unknown}; known: {list(CONFIGS)}")
    results, bad = [], 0
    for name in names:
        for rep in range(args.repeat):
            res = run_config(name, files)
            res["repeat"] = rep
            results.append(res)
            print(summary_line(res), flush=True)
            for kind in ("failed", "errored", "ref_cannot_compile"):
                for test_id in res[kind]:
                    print(f"    {kind}: {test_id}", flush=True)
            if "tail" in res:
                print("    pytest did not finish cleanly:\n" + res["tail"],
                      flush=True)
            bad += len(res["failed"]) + len(res["errored"]) + (
                res["rc"] not in (0, 1))
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"files": files, "workers": WORKERS,
                       "results": [{k: v for k, v in r.items()
                                    if k != "passed"}
                                   | {"n_passed": len(r["passed"])}
                                   for r in results]}, f, indent=1)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
