#!/usr/bin/env python3
"""Where the time of the port's forward and serving path goes, on one card.

    python3 scripts/profile_torch_serve.py [--arch transformer-big]
        [--prefill-len 32768] [--requests 8] [--prefix 16]
        [--out profile_torch_serve.json]

Full-width ``--arch`` (transformer-big or zamba2-7b) in bf16, random
weights from seed 0; for transformer-big, 256 encoder states a sequence
from the data pipeline's stub, as ``chip_smoke.py`` drives it.  After a
warm-up, each of two steps runs once under ``torch.profiler``:

  * prefill — ``forward(attn_impl="kernel")`` and ``head`` on the last
    position over one sequence of ``--prefill-len`` tokens;
  * decode  — the ``decode_step(enc=..., attn_impl="kernel")`` for
    ``--requests`` sequences that follows a ``--prefix``-token prefill
    and one warm-up step (a cache of ``--prefix`` + 4 slots; zamba2-7b
    has no encoder states).

For each: the mean wall time of 5 runs without the profiler; one run
under the profiler with CPU and CUDA activity for the device time by
kernel; and one run with CUDA activity only (no host-side op records),
whose wall time and device busy time give the idle share.  Prints one
JSON object and writes it to ``--out``.  Needs a card.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch.configs import get_config                 # noqa: E402
from repro_torch.data import make_pipeline                 # noqa: E402
from repro_torch.models import build_model                 # noqa: E402


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def _one_profile(fn, cpu: bool):
    """Run ``fn`` once under the profiler: its wall time (ms) and the
    device rows (kernels, memsets, copies) as (name, ms, count)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if cpu else [])
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        w0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - w0)
    rows = sorted(((e.key, _device_us(e) / 1e3, e.count)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and _device_us(e) > 0),
                  key=lambda x: -x[1])
    return wall_ms, rows


def profiled(fn) -> dict:
    """Wall time without the profiler (mean of 5), the idle share from
    one CUDA-only profiled run (device busy and wall of that same run)
    and the kernel table from one CPU+CUDA profiled run."""
    walls = []
    for _ in range(5):
        torch.cuda.synchronize()
        w0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append(1e3 * (time.perf_counter() - w0))
    dev_wall, dev_rows = _one_profile(fn, cpu=False)
    busy_ms = sum(r[1] for r in dev_rows)
    full_wall, rows = _one_profile(fn, cpu=True)
    return {"wall_ms_unprofiled": sum(walls) / len(walls),
            "wall_ms_cuda_profiler": dev_wall,
            "device_busy_ms": busy_ms if busy_ms > 0 else "not measured",
            "idle_share": 1 - busy_ms / dev_wall if busy_ms > 0
            else "not measured",
            "device_activities": sum(r[2] for r in dev_rows),
            "wall_ms_cpu_cuda_profiler": full_wall,
            "device_busy_ms_cpu_cuda_profiler": sum(r[1] for r in rows),
            "top_kernels_ms": [list(r) for r in rows[:15]]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="transformer-big",
                    choices=("transformer-big", "zamba2-7b"))
    ap.add_argument("--prefill-len", type=int, default=32768)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prefix", type=int, default=16)
    ap.add_argument("--out", default="profile_torch_serve.json")
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_serve: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(a.arch)
    model = build_model(cfg)
    params = model.init(seed=0, device="cuda")
    out = {"arch": a.arch, "card": subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()}
    with torch.no_grad():
        batch = {k: torch.from_numpy(v).cuda() for k, v in
                 make_pipeline(cfg, 1, a.prefill_len).batch_at(0).items()}

        def prefill():
            h = model.forward(params, batch, attn_impl="kernel")
            return model.head(params, h[:, -1:])
        prefill()
        out["prefill"] = {"tokens": a.prefill_len, **profiled(prefill)}
        del batch

        b = make_pipeline(cfg, a.requests, a.prefix).batch_at(1)
        prefix = torch.from_numpy(b["tokens"]).cuda()
        enc = (torch.from_numpy(b["frontend"]).cuda() if "frontend" in b
               else None)
        cache_len = a.prefix + 4
        cache = model.init_cache(a.requests, cache_len, device="cuda")
        logits, cache = model.prefill(params, cache, prefix, enc=enc,
                                      attn_impl="kernel")
        tok = torch.argmax(logits, -1).to(torch.int32)[:, None]
        logits, cache = model.decode_step(params, cache, tok, enc=enc,
                                          attn_impl="kernel")  # warm-up
        tok = torch.argmax(logits, -1).to(torch.int32)[:, None]
        # the next step; decode_step returns a new cache, so every run
        # below repeats the same step on the same cache
        out["decode"] = {"requests": a.requests, "cache_len": cache_len,
                         "cache_length_before_step": int(cache["length"][0]),
                         **profiled(lambda: model.decode_step(
                             params, cache, tok, enc=enc,
                             attn_impl="kernel"))}
    os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
    with open(a.out, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
