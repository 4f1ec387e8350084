#!/usr/bin/env python3
"""Where the time of the port's training step goes, on one card.

    python3 scripts/profile_torch_step.py [--grad-accum dense_reduce]
        [--batch-per-worker 8] [--seq-len 256] [--steps 5]
        [--out profile_torch_step.json]

Builds the launcher's step for full-width transformer-big in bf16 (world
of 1 over NCCL, as ``chip_smoke.py`` drives it), warms up two steps, then:

  * phases — each of ``--steps`` steps split with ``synchronize()`` into
    host batch fetch, forward+backward (``grad_contributions``), exchange
    (accumulate, densify kernel, allreduce, unpack) and AdamW update, on
    the host clock;
  * kernels — one more step under ``torch.profiler``: device time by
    operator and the device's busy share of that step's wall time.

Prints one JSON object and writes it to ``--out``.  Needs a card.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch.configs import get_config                 # noqa: E402
from repro_torch.data import make_pipeline                 # noqa: E402
from repro_torch.launch import train                       # noqa: E402
from repro_torch.models import build_model                 # noqa: E402
from repro_torch.optim import apply_updates                # noqa: E402
from repro_torch.training import Trainer, TrainerConfig    # noqa: E402
from repro_torch.training.gradients import grad_contributions  # noqa: E402


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--grad-accum", default="dense_reduce",
                    choices=["dense_reduce", "sparse_gather"])
    ap.add_argument("--batch-per-worker", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--out", default="profile_torch_step.json")
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_step: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False

    args = train.parse_args(["--dist", "horovod", "--grad-accum",
                             a.grad_accum, "--device", "cuda"])
    device = train.resolve_device("cuda")
    cfg = get_config("transformer-big")
    model = build_model(cfg)
    _, _, created = train.init_distributed(device)
    try:
        opt = train.build_optimizer(args, cfg, torch.distributed.group.WORLD)
        pipe = make_pipeline(cfg, a.batch_per_worker, a.seq_len)
        feed = Trainer(model, None, pipe, TrainerConfig(), device=device)
        params = model.init(seed=0, device=device)
        state = opt.init(params)

        def step(k, timed):
            t = [time.perf_counter()]
            batch = feed.batch_at(k)

            def mark():
                if timed:
                    torch.cuda.synchronize()
                t.append(time.perf_counter())
            mark()
            grads, loss, _ = grad_contributions(model, p[0], batch,
                                                sparse_embedding=True)
            mark()
            dense = opt.exchange(grads)
            mark()
            updates, s = opt.base.update(dense, st[0], p[0])
            p[0], st[0] = apply_updates(p[0], updates), s
            mark()
            torch.cuda.synchronize()
            t.append(time.perf_counter())
            return [1e3 * (y - x) for x, y in zip(t, t[1:])], float(loss)

        p, st = [params], [state]
        for k in range(2):
            step(k, timed=False)
        names = ["data_ms", "fwd_bwd_ms", "exchange_ms", "update_ms"]
        rows = []
        for k in range(2, 2 + a.steps):
            ms, loss = step(k, timed=True)
            rows.append(dict(zip(names, ms[:4]), step_ms=sum(ms), loss=loss))
        phases = {n: statistics.median(r[n] for r in rows)
                  for n in names + ["step_ms"]}

        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            w0 = time.perf_counter()
            step(2 + a.steps, timed=False)
            wall_ms = 1e3 * (time.perf_counter() - w0)
        ops = sorted(((e.key, _device_us(e) / 1e3, e.count)
                      for e in prof.key_averages() if _device_us(e) > 0),
                     key=lambda x: -x[1])
        # device-side rows (kernels, memsets, copies) only: CPU-side ops
        # report the time of the kernels they launched as well
        kernel_rows = [(e.key, _device_us(e) / 1e3, e.count)
                       for e in prof.key_averages()
                       if e.device_type == DeviceType.CUDA
                       and _device_us(e) > 0]
        kernel_rows.sort(key=lambda x: -x[1])
        busy_ms = sum(o[1] for o in kernel_rows)
    finally:
        if created:
            torch.distributed.destroy_process_group()

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    out = {"card": smi, "grad_accum": a.grad_accum,
           "batch": [a.batch_per_worker, a.seq_len], "steps": rows,
           "median": phases,
           "profiled_step": {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
                             "idle_share": 1 - busy_ms / wall_ms},
           "top_kernels_ms": [[k, ms, n] for k, ms, n in kernel_rows[:25]],
           "top_ops_ms": [[k, ms, n] for k, ms, n in ops[:25]]}
    os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
    with open(a.out, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
