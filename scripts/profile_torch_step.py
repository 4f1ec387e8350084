#!/usr/bin/env python3
"""Where the time of the port's training step goes, on one card.

    python3 scripts/profile_torch_step.py [--grad-accum dense_reduce]
        [--codec identity] [--error-feedback]
        [--overlap {fused,staged,backward}] [--microbatches N]
        [--batch-per-worker 8] [--seq-len 256] [--steps 5]
        [--out profile_torch_step.json]

Builds the launcher's step for full-width transformer-big in bf16 (world
of 1 over NCCL, as ``chip_smoke.py`` drives it), warms up two steps, then:

  * phases — each of ``--steps`` steps split with ``synchronize()`` into
    host batch fetch, forward+backward (``grad_contributions``), exchange
    (accumulate, densify kernel, encode, collectives, decode, unpack) and
    AdamW update, on the host clock.  With ``--overlap backward`` the
    exchange runs inside the backward pass, and with ``--microbatches N``
    the step is ``make_scaled_train_step`` (dynamic loss scaling, N
    microbatches; N = 1 is the loss-scaled step without accumulation):
    then only the whole step is timed (data, step);
  * kernels — one more step under ``torch.profiler``: device time by
    operator, the device's busy share of that step's wall time, and the
    number of device activities (kernels, memsets, copies) it ran;
  * memory — the bytes of the training state (parameters, optimizer,
    loss-scaler and exchange state), what is allocated between steps
    (the state plus the libraries' workspaces; a step holds nothing
    once it returns), and the peak allocated during the timed steps.

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
from repro_torch.training import (LossScaler, Trainer,      # noqa: E402
                                  TrainerConfig, make_scaled_train_step,
                                  make_train_step)
from repro_torch.training.gradients import grad_contributions  # noqa: E402


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def _state_bytes(*trees) -> int:
    """Bytes of the distinct device storages under ``trees`` (dicts,
    tuples, lists and ``ExchangeState``)."""
    seen, stack = {}, list(trees)
    while stack:
        x = stack.pop()
        if isinstance(x, torch.Tensor):
            seen[x.untyped_storage().data_ptr()] = \
                x.untyped_storage().nbytes()
        elif isinstance(x, dict):
            stack.extend(x.values())
        elif isinstance(x, (list, tuple)):
            stack.extend(x)
        elif hasattr(x, "bucket_states"):
            stack.extend(x.bucket_states)
    return sum(seen.values())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--grad-accum", default="dense_reduce",
                    choices=["dense_reduce", "sparse_gather"])
    ap.add_argument("--codec", default="identity")
    ap.add_argument("--error-feedback", action="store_true")
    ap.add_argument("--overlap", default="fused",
                    choices=["fused", "staged", "backward"])
    ap.add_argument("--microbatches", type=int, default=0,
                    help="N >= 1: the loss-scaled step with N microbatches "
                         "(0, the default: the launcher's step)")
    ap.add_argument("--batch-per-worker", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--out", default="profile_torch_step.json")
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_step: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False

    args = train.parse_args(
        ["--dist", "horovod", "--grad-accum", a.grad_accum, "--codec",
         a.codec, "--batch-per-worker", str(a.batch_per_worker),
         "--seq-len", str(a.seq_len), "--device", "cuda"]
        + ["--error-feedback"] * a.error_feedback
        + (["--overlap", a.overlap] if a.overlap != "fused" else []))
    split = a.overlap != "backward" and a.microbatches == 0
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
        ex = [opt.init_exchange_state(
            train.meta_worker_grads(args, model, pipe, True), device=device)]
        if a.microbatches:
            scaler = LossScaler()
            sst = [scaler.init(device)]
            scaled = make_scaled_train_step(
                model, opt, scaler, n_microbatches=a.microbatches,
                sparse_embedding=True)
        else:
            whole = make_train_step(model, opt, sparse_embedding=True)

        def step(k, timed):
            if not split:
                return whole_step(k, timed)
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
            dense, ex[0] = opt.exchange(grads, state=ex[0])   # or staged
            mark()
            updates, s = opt.base.update(dense, st[0], p[0])
            p[0], st[0] = apply_updates(p[0], updates), s
            mark()
            torch.cuda.synchronize()
            t.append(time.perf_counter())
            return [1e3 * (y - x) for x, y in zip(t, t[1:])], float(loss)

        def whole_step(k, timed):
            t = [time.perf_counter()]
            batch = feed.batch_at(k)
            if timed:
                torch.cuda.synchronize()
            t.append(time.perf_counter())
            if a.microbatches:
                p[0], st[0], sst[0], ex[0], m = scaled(p[0], st[0], sst[0],
                                                       ex[0], batch)
            else:
                p[0], st[0], ex[0], m = whole(p[0], st[0], ex[0], batch)
            torch.cuda.synchronize()
            t.append(time.perf_counter())
            return [1e3 * (y - x) for x, y in zip(t, t[1:])], \
                float(m["loss"])

        p, st = [params], [state]
        del params, state
        for k in range(2):
            step(k, timed=False)
        names = (["data_ms", "fwd_bwd_ms", "exchange_ms", "update_ms"]
                 if split else ["data_ms", "train_step_ms"])
        torch.cuda.synchronize()
        state_bytes = _state_bytes(p[0], st[0], ex[0],
                                   sst[0] if a.microbatches else ())
        between_bytes = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        rows = []
        for k in range(2, 2 + a.steps):
            ms, loss = step(k, timed=True)
            rows.append(dict(zip(names, ms[:len(names)]), step_ms=sum(ms),
                             loss=loss))
        peak_bytes = torch.cuda.max_memory_allocated()
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
        activities = sum(o[2] for o in kernel_rows)
    finally:
        if created:
            torch.distributed.destroy_process_group()

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    out = {"card": smi, "grad_accum": a.grad_accum,
           "codec": opt.exchange_config.codec, "overlap": a.overlap,
           "microbatches": a.microbatches,
           "step": ("make_scaled_train_step" if a.microbatches
                    else "launcher step"),
           "state_bytes": state_bytes,
           "allocated_between_steps": between_bytes,
           "peak_during_timed_steps": peak_bytes,
           "peak_above_state_bytes": peak_bytes - state_bytes,
           "max_memory_allocated": torch.cuda.max_memory_allocated(),
           "batch": [a.batch_per_worker, a.seq_len], "steps": rows,
           "median": phases,
           "profiled_step": {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
                             "idle_share": 1 - busy_ms / wall_ms,
                             "device_activities": activities},
           "top_kernels_ms": [[k, ms, n] for k, ms, n in kernel_rows[:25]],
           "top_ops_ms": [[k, ms, n] for k, ms, n in ops[:25]]}
    os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
    with open(a.out, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
