#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA H100.

    python3 chip_smoke.py

Phases, each fatal on failure (non-zero exit, no result line):

  1. device  — the card's name and power limit (nvidia-smi);
  2. build   — compile every CUDA kernel from ``src/repro_torch/csrc``
               (one nvcc per source, started together);
  3. kernel  — hold each kernel (densify, quantize) to its plain
               PyTorch version on the card at the training step's shapes
               and edge cases (quantize bitwise; densify also bitwise
               across two launches, with its bitwise equality to the plain
               version on the CPU and the memory one call allocates
               reported), then time kernel, plain version and one library
               call where there is one with CUDA events against the least
               time the card could take;
     attn_kernel — the same for flash attention: the forward path's three
               shapes (causal 1 x 32768 x 16 x 64, cross 32768 x 256,
               decode cross 8 x 1 x 256), the cases of
               tests/test_kernels.py, causal Sq > Sk, a window, mixed
               dtypes, strided and misaligned inputs, the kernel's own
               q_offset and kv_len; f32 within 3e-5, bf16 within 3e-2
               and, outside the small cases of tests/test_kernels.py,
               also against the size of its reference output
               (relative L2 1e-2, worst query row 1.5e-2, max abs 2 bf16
               ulps of max|ref|); the kernel refuses Dv != D; timed with
               the L2 flushed, beside
               ``scaled_dot_product_attention`` as the library yardstick;
               and zamba2-7b's head dim 112: causal and window-8192
               (1 x 32768 x 32 x 112, bf16) and small f32 and bf16 cases;
               every case names the variant that ran, the prefill kernel
               ("sm90") must take the path's bf16 shapes and its own edge
               cases (Sq not a multiple of 128, kv_len < Sk, GQA 4, head
               dim 128, strided views of a packed q/k/v), and on the path's
               shapes it is timed beside flash_mma ("mma");
     ssd_kernel — the SSD scan kernels against ``ssd_plain`` on the
               card, every case naming the variant that ran: f32 inputs
               on "simt" (the cases of tests/test_kernels.py, a ragged S
               and an active clip at 2e-5), bf16 inputs on "sm90" at
               ``SSD_SCALED_TOL`` (a ragged S padded by ``ops.ssd``, an
               active clip, P = N = 16 and 32, chunks 64 and 128, batch
               2, b and c as views of one packed tensor, and the
               main-path shape x 1 x 32768 x 112 x 64, chunk 256);
               "sm90", "simt" and the plain version timed there, the
               three passes' device times under ``torch.profiler``, and
               the bound both ways (bytes, and f32 operations);
  4. path    — the launcher (``repro_torch.launch.train.run``) trains
               full-width transformer-big in bf16: 4 steps of
               ``--dist horovod --grad-accum dense_reduce`` and 1 step of
               ``--grad-accum sparse_gather`` on a world of 1 over NCCL,
               with the kernels' launch counters reset just before and
               read just after;
  5. codec   — the same launcher with the int8 gradient wire: 3 steps of
               ``dense_reduce --codec int8 --error-feedback`` and 1 step
               of ``sparse_gather --codec int8``, counters reset before
               each run and read after: one quantize launch per schedule
               stage, densify once a step, two allgathers per dense stage
               and three per gather stage, no allreduce;
  6. prefill — full-width transformer-big's prefill step on one
               32768-token sequence with 256 encoder states:
               ``forward(attn_impl="kernel")`` and ``head`` on the last
               position, 12 kernel launches a forward, all 12 on the
               prefill kernel (counts reset just before, read just after);
               logits held against the plain chunked path;
  7. translate — 8 requests: ``Model.prefill`` over a 16-token prefix and
               32 greedy ``decode_step``s cross-attending 256 f32 encoder
               states through the kernel, 6 launches a step; every step's
               logits held against the plain path teacher-forced on the
               same tokens;
  8. serve   — ``ServeEngine.generate`` on 8 prompts of 64 tokens, 32 new
               tokens (no encoder states, so no launch); shape and EOS
               masking;
  9. hybrid  — full-width zamba2-7b in bf16 (weights from seed 0, init
               time and memory): the prefill step on one 32768-token
               sequence, 81 SSD and 13 flash attention launches a forward
               (all 81 on the "sm90" SSD kernel, all 13 on the prefill
               attention kernel);
               8 requests of a 16-token prefix and 32 greedy decode steps,
               and ``ServeEngine.generate`` on 8 x 32-token prompts with
               16 new tokens (no launch in either); then the weights cast
               to f32 and the logits of the kernel path held against the
               plain path on 4096 tokens at ``PATH_TOL`` (in bf16 the
               difference is reported: 94 random residual blocks carry a
               last-bit difference to O(0.3) of the logits);
 10. small   — the reduced transformer-big and zamba2-7b in f32 train 2
               steps each on the card and on the CPU, with the identity
               wire and with ``--codec int8 --error-feedback``, and the
               losses must agree; then
               its prefill step and 4 translate steps on the card (the
               kernel's f32 path) and the CPU, logits within 3e-5; the
               reduced zamba2 the same (forward, 4-token prefix, 4 decode
               steps).

The last two lines of standard output are the ``kernels`` JSON line and
``{"ok": true, "device": {...}}``.  Needs one card, the CUDA toolkit and
nothing from the network.
"""
from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12          # H100 SXM HBM3, NVIDIA data sheet
F32_FLOPS = 67e12                  # H100 SXM f32 outside the tensor cores
F32_TOL = dict(rtol=1e-5, atol=1e-5)
# one bf16 ulp (2**-7 relative) on top of the f32 accumulation-order
# difference (set when the kernel's atomics summed duplicate rows in a
# run-dependent order; the kernel now sums them in index order, as the
# plain version does on the CPU, and the phase also reports bitwise
# equality)
BF16_TOL = dict(rtol=8e-3, atol=1e-5)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean device time of ``fn()`` over ``iters`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int, warmup: int = 3) -> float:
    """Device time of one ``fn()``: the time of the kernels (and memsets)
    it runs, summed by ``torch.profiler`` over ``iters`` calls; the gaps
    that host overhead leaves between launches are not counted."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total_us = sum(e.device_time_total for e in prof.key_averages())
    if total_us <= 0:
        fail("torch.profiler recorded no device time")
    return total_us / iters / 1e3


class PhaseClock:
    """Runs a phase and prints its wall time, so the run's budget shows."""

    def __init__(self):
        self.t0 = time.perf_counter()

    def __call__(self, name, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        torch.cuda.synchronize()
        print(json.dumps({"phase_done": name,
                          "s": time.perf_counter() - t,
                          "total_s": time.perf_counter() - self.t0}))
        return out


def phase_build(build) -> None:
    t0 = time.perf_counter()
    logs = build.build(build_sources())
    for name, (_, log) in sorted(logs.items()):
        regs = [ln.strip() for ln in log.splitlines() if "registers" in ln]
        print(f"build {name}: {'; '.join(regs)}")
    print(json.dumps({"phase": "build", "kernels": sorted(logs),
                      "build_s": time.perf_counter() - t0}))


def build_sources():
    csrc = os.path.join(ROOT, "src", "repro_torch", "csrc")
    return sorted(f[:-3] for f in os.listdir(csrc) if f.endswith(".cu"))


def phase_kernel(D, tokens) -> dict:
    """densify: every case against the plain version, then timings at
    the training step's shape (n = 8 x 256 tokens, bf16)."""
    vocab, d = 33708, 1024
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    tok = torch.from_numpy(tokens.reshape(-1)).to(dev)

    def vals(n, dt, width=d):
        # multiples of 2**-6 below 4 in magnitude: exact in bf16, and any
        # sum of up to 2**13 of them is exact in f32, so no order of the
        # sums can move the result and the comparison checks indexing and
        # arithmetic alone (randn_bf16 below has inexact sums)
        k = torch.randint(-255, 256, (n, width), device=dev, generator=gen)
        return (k.to(torch.float32) / 64).to(dt)

    cases = [
        ("main_bf16", tok, vals(tok.numel(), torch.bfloat16), vocab, d),
        ("main_f32", tok, vals(tok.numel(), torch.float32), vocab, d),
        ("sparse_gather_bf16",
         torch.cat([tok, torch.arange(vocab, dtype=torch.int32,
                                      device=dev)]),
         vals(tok.numel() + vocab, torch.bfloat16), vocab, d),
        ("n1_f32", torch.tensor([5], dtype=torch.int32, device=dev),
         vals(1, torch.float32), vocab, d),
        ("ragged_bf16",
         torch.randint(0, vocab, (1001,), dtype=torch.int32, device=dev,
                       generator=gen),
         vals(1001, torch.bfloat16, 1000), vocab, 1000),
        ("all_duplicate_f32", torch.full((2048,), 7, dtype=torch.int32,
                                         device=dev),
         vals(2048, torch.float32), vocab, d),
        ("out_of_range_bf16",
         torch.tensor([-1, 0, vocab, vocab + 5, 3, -7, vocab - 1, 0],
                      dtype=torch.int32, device=dev),
         vals(8, torch.bfloat16), vocab, d),
        ("randn_bf16", tok,
         torch.randn((tok.numel(), d), device=dev, generator=gen).to(
             torch.bfloat16), vocab, d),
        # values 4 bytes off 16-byte alignment: the element-by-element form
        ("misaligned_f32", tok,
         vals(1, torch.float32, tok.numel() * d + 1)[0, 1:].view(-1, d),
         vocab, d),
    ]
    max_err = 0.0
    for name, idx, v, vb, width in cases:
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = D.densify_kernel(idx, v, (vb, width))
        torch.cuda.synchronize()
        growth = torch.cuda.max_memory_allocated() - before
        again = D.densify_kernel(idx, v, (vb, width))
        torch.cuda.synchronize()
        ref = D.densify_plain(idx, v, (vb, width))
        if out.dtype != v.dtype or tuple(out.shape) != (vb, width):
            fail(f"densify {name}: got {out.dtype} {tuple(out.shape)}")
        if not torch.equal(out, again):
            fail(f"densify {name}: two launches on the same inputs differ")
        tol = F32_TOL if v.dtype == torch.float32 else BF16_TOL
        err = (out.float() - ref.float()).abs().max().item()
        if not torch.allclose(out.float(), ref.float(), **tol):
            fail(f"densify {name}: kernel disagrees with plain version "
                 f"(max abs err {err})")
        max_err = max(max_err, err)
        cpu = D.densify_plain(idx.cpu(), v.cpu(), (vb, width))
        print(json.dumps({"phase": "kernel", "kernel": "densify",
                          "case": name, "n": int(idx.numel()),
                          "vocab": vb, "d": width,
                          "dtype": str(v.dtype).split(".")[-1],
                          "max_abs_err": err, "tol": tol,
                          "bitwise_across_launches": True,
                          "bitwise_vs_plain_on_cpu": torch.equal(out.cpu(),
                                                                 cpu),
                          "memory_growth_bytes": growth,
                          "output_bytes": out.numel() * out.element_size()}))
        del out, again, ref, cpu

    _, idx, v, vb, width = cases[0]
    n = idx.numel()
    itemsize = v.element_size()
    nbytes = vb * width * itemsize + n * width * itemsize + 4 * n
    bound_ms = max(nbytes / HBM_BYTES_PER_S, n * width / F32_FLOPS) * 1e3
    idx64, v32 = idx.long(), v.float()
    # Two measures, kernel, plain, plain, kernel, best of two turns: the
    # device time of a call's kernels (the profiler's sum; ``ms`` in the
    # kernels line), and CUDA events around back-to-back calls, which
    # also count the gaps the host leaves (the Python, ctypes and
    # launches of a kernel call take about as long as its kernels).
    fns = {"kernel": lambda: D.densify_kernel(idx, v, (vb, width)),
           "plain": lambda: D.densify_plain(idx, v, (vb, width)),
           "library": lambda: torch.zeros(
               (vb, width), dtype=torch.float32, device=dev).index_add_(
                   0, idx64, v32)}
    dev_t, events_t = {}, {}
    for order in ("kernel", "plain", "library", "library", "plain",
                  "kernel"):
        t = device_ms(fns[order], 50)
        dev_t[order] = min(dev_t.get(order, t), t)
        t = cuda_ms(fns[order], 50)
        events_t[order] = min(events_t.get(order, t), t)
    ms, plain_ms, library_ms = dev_t["kernel"], dev_t["plain"], \
        dev_t["library"]
    timing = {"phase": "kernel_timing", "kernel": "densify",
              "shape": {"n": n, "vocab": vb, "d": width, "dtype": "bf16"},
              "kernel_ms": ms, "plain_ms": plain_ms,
              "library_ms": library_ms, "measure": "device time a call",
              "back_to_back_ms": events_t,
              "library_call": "torch.zeros(vocab, d, float32).index_add_",
              "bound_ms": bound_ms, "bound_by": "bytes",
              "bound_bytes": nbytes}
    print(json.dumps(timing))
    return {"max_abs_err": max_err, **timing}


FULL_WIDTH = ["--arch", "transformer-big", "--dist", "horovod",
              "--batch-per-worker", "8", "--seq-len", "256",
              "--log-every", "1", "--device", "cuda"]


def phase_path(train, D, comm) -> dict:
    """The launcher on full-width transformer-big, identity wire; returns
    the densify launches it made and the first-step losses."""
    common = FULL_WIDTH
    launches = 0
    first_loss, median_ms = {}, {}
    for accum, steps, collective in (
            ("dense_reduce", 4, comm.all_reduce_dense),
            ("sparse_gather", 1, comm.all_gather_dense)):
        torch.cuda.reset_peak_memory_stats()
        D.densify_kernel.launches = 0
        collective.calls = 0
        result = train.run(common + ["--grad-accum", accum,
                                     "--steps", str(steps)])
        torch.cuda.synchronize()
        got, calls = D.densify_kernel.launches, collective.calls
        hist = result["history"]
        losses = [h["loss"] for h in hist]
        if len(losses) != steps or not all(map(math.isfinite, losses)):
            fail(f"path {accum}: losses {losses}")
        if got != steps:
            fail(f"path {accum}: densify launched {got} times in "
                 f"{steps} steps (want one per step)")
        if calls == 0:
            fail(f"path {accum}: no {collective.__name__} through "
                 f"torch.distributed")
        first_loss[accum] = losses[0]
        steady = [h["step_ms"] for h in hist[1:]] or [hist[0]["step_ms"]]
        median_ms[accum] = statistics.median(steady)
        print(json.dumps({
            "phase": "path", "grad_accum": accum, "codec": "identity",
            "steps": steps,
            "losses": losses, "densify_launches": got,
            f"{collective.__name__}_calls": calls,
            "step_ms_first": hist[0]["step_ms"],
            "step_ms_median_after_first": statistics.median(steady),
            "tok_per_s": hist[-1]["tok_per_s"],
            "max_memory_allocated": torch.cuda.max_memory_allocated()}))
        launches += got
    # same params, same first batch: the loss precedes the exchange
    a, b = first_loss["dense_reduce"], first_loss["sparse_gather"]
    if abs(a - b) > 1e-3 * abs(a):
        fail(f"path: first-step loss differs between strategies {a} {b}")
    # initial loss of random tied-embedding weights is near ln(vocab)
    if abs(a - math.log(33708)) > 1.0:
        fail(f"path: first-step loss {a} far from ln(vocab)")
    return {"densify_launches": launches, "first_loss": first_loss,
            "step_ms_median": median_ms}


def phase_quantize_kernel(Q) -> dict:
    """quantize: every case bitwise against the plain version, then
    timings at the main path's largest bucket (34,516,992 f32, the tied
    embedding under dense_reduce)."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)

    def normal(n, dt=torch.float32, scale=3.7):
        return (torch.randn(n, device=dev, generator=gen) * scale).to(dt)

    main = normal(34516992)
    k = torch.arange(-126, 126, device=dev, dtype=torch.float32)
    ties = torch.cat([k + 0.5, torch.tensor([127.0, -127.0], device=dev)])

    def poisoned(dt, values):
        # a NaN or inf input: the scale must come out NaN or inf, as in
        # the reference, and the NaN products quantise to 0
        x = normal(4099).to(dt)
        x[[3, 2050]] = torch.tensor(values, device=dev).to(dt)
        return x
    cases = [
        ("main_f32", main),
        ("gather_values_bf16", normal(35756 * 1024, torch.bfloat16)),
        ("n1_f32", normal(1)),
        ("n0_f32", normal(0)),
        ("ragged_f32", normal(1001)),
        ("ragged_bf16", normal(1001, torch.bfloat16)),
        ("misaligned_f32", normal(4099)[1:]),
        ("misaligned_bf16", normal(4099, torch.bfloat16)[1:]),
        ("zeros_f32", torch.zeros(4096, device=dev)),
        ("ties_f32", ties),
        ("nan_f32", poisoned(torch.float32, [float("nan"), -math.inf])),
        ("nan_bf16", poisoned(torch.bfloat16, [float("nan"), 1.0])),
        ("inf_f32", poisoned(torch.float32, [math.inf, 1.0])),
        ("inf_bf16", poisoned(torch.bfloat16, [-math.inf, 1.0])),
    ]
    max_err = 0.0
    for name, x in cases:
        q, scale = Q.quantize_kernel(x)
        torch.cuda.synchronize()
        q0, scale0 = Q.quantize_plain(x)
        if q.dtype != torch.int8 or tuple(q.shape) != (x.numel(),) \
                or tuple(scale.shape) != (1,):
            fail(f"quantize {name}: got {q.dtype} {tuple(q.shape)} "
                 f"scale {tuple(scale.shape)}")
        q_err = ((q.int() - q0.int()).abs().max().item() if q.numel()
                 else 0)
        # bitwise, except that any NaN equals any NaN (the card's NaN
        # payloads are its own)
        same_scale = torch.equal(scale, scale0) or bool(
            scale.isnan().item() and scale0.isnan().item())
        s_err = 0.0 if same_scale else (scale - scale0).abs().item()
        if not (torch.equal(q, q0) and same_scale):
            fail(f"quantize {name}: kernel differs from the plain version "
                 f"(max |dq| {q_err}, |dscale| {s_err}, scale "
                 f"{scale.item()!r} vs {scale0.item()!r})")
        max_err = max(max_err, float(q_err), s_err)
        print(json.dumps({"phase": "kernel", "kernel": "quantize",
                          "case": name, "n": x.numel(),
                          "dtype": str(x.dtype).split(".")[-1],
                          "scale": scale.item(), "bitwise": True,
                          "tol": "bitwise"}))

    n = main.numel()
    nbytes = (main.element_size() + 1) * n + 4
    ops = 2 * n          # one max and one multiply per element, in f32
    bound_ms = max(nbytes / HBM_BYTES_PER_S, ops / F32_FLOPS) * 1e3
    ms = plain_ms = None
    for order in ("kernel", "plain", "plain", "kernel"):
        if order == "kernel":
            t = cuda_ms(lambda: Q.quantize_kernel(main), 50)
            ms = t if ms is None else min(ms, t)
        else:
            t = cuda_ms(lambda: Q.quantize_plain(main), 20)
            plain_ms = t if plain_ms is None else min(plain_ms, t)
    timing = {"phase": "kernel_timing", "kernel": "quantize",
              "shape": {"n": n, "dtype": "float32"},
              "kernel_ms": ms, "plain_ms": plain_ms, "library_ms": None,
              "library_call": "none: torch.quantize_per_tensor divides, "
                              "clamps to -128 and takes the scale from "
                              "the caller",
              "bound_ms": bound_ms, "bound_by": "bytes",
              "bound_bytes": nbytes,
              "kernel_moves_bytes": (2 * main.element_size() + 1) * n + 4}
    print(json.dumps(timing))
    return {"max_abs_err": max_err, **timing}


def exchange_plan(train, argv):
    """The launcher's ExchangePlan for one worker's gradient tree (built
    on meta tensors, as the launcher builds its codec state)."""
    from repro_torch.configs import get_config
    from repro_torch.data import make_pipeline
    from repro_torch.models import build_model
    args = train.parse_args(argv)
    cfg = get_config(args.arch)
    model = build_model(cfg)
    pipe = make_pipeline(cfg, args.batch_per_worker, args.seq_len,
                         seed=args.seed)
    grads = train.meta_worker_grads(args, model, pipe, True)
    return train.build_optimizer(args, cfg, None).plan(grads)


def phase_codec_path(train, D, Q, comm, path) -> dict:
    """The launcher on full-width transformer-big with the int8 wire;
    returns the quantize and densify launches it made."""
    quantize_launches = densify_launches = 0
    for accum, extra, steps in (
            ("dense_reduce", ["--codec", "int8", "--error-feedback"], 3),
            ("sparse_gather", ["--codec", "int8"], 1)):
        argv = FULL_WIDTH + ["--grad-accum", accum, "--steps", str(steps)] \
            + extra
        plan = exchange_plan(train, argv)
        ident = exchange_plan(train, FULL_WIDTH + ["--grad-accum", accum])
        stages = plan.schedule.stages
        n_gather = sum(s.kind == "gather" for s in stages)
        want_gathers = steps * (2 * (len(stages) - n_gather) + 3 * n_gather)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        Q.quantize_kernel.launches = 0
        D.densify_kernel.launches = 0
        comm.all_gather_dense.calls = 0
        comm.all_reduce_dense.calls = 0
        result = train.run(argv)
        torch.cuda.synchronize()
        got_q, got_d = Q.quantize_kernel.launches, D.densify_kernel.launches
        gathers = comm.all_gather_dense.calls
        reduces = comm.all_reduce_dense.calls
        hist = result["history"]
        losses = [h["loss"] for h in hist]
        tag = f"codec {accum} {plan.config.codec}"
        if len(losses) != steps or not all(map(math.isfinite, losses)):
            fail(f"{tag}: losses {losses}")
        if len(stages) != 16 or got_q != steps * len(stages):
            fail(f"{tag}: quantize launched {got_q} times in {steps} "
                 f"steps of {len(stages)} stages (want one per stage)")
        if got_d != steps:
            fail(f"{tag}: densify launched {got_d} times in {steps} steps")
        if gathers != want_gathers or reduces != 0:
            fail(f"{tag}: {gathers} allgathers (want {want_gathers}) and "
                 f"{reduces} allreduces (want 0)")
        ref = path["first_loss"][accum]
        if abs(losses[0] - ref) > 1e-5 * abs(ref):
            fail(f"{tag}: first-step loss {losses[0]} differs from the "
                 f"identity run's {ref}")
        residual_bytes = sum(
            s.numel() * s.element_size()
            for s in result["exchange_state"].bucket_states
            if not isinstance(s, tuple))
        if residual_bytes != plan.state_bytes():
            fail(f"{tag}: residuals hold {residual_bytes} B, plan says "
                 f"{plan.state_bytes()} B")
        steady = [h["step_ms"] for h in hist[1:]] or [hist[0]["step_ms"]]
        print(json.dumps({
            "phase": "codec_path", "grad_accum": accum,
            "codec": plan.config.codec, "steps": steps, "losses": losses,
            "first_loss_identity": ref,
            "first_loss_bitwise_equal": losses[0] == ref,
            "stages": len(stages), "quantize_launches": got_q,
            "densify_launches": got_d, "all_gather_dense_calls": gathers,
            "all_reduce_dense_calls": reduces,
            "n_collectives_per_step": plan.n_collectives,
            "state_bytes": plan.state_bytes(),
            "wire_bytes": {p: plan.wire_bytes(p) for p in (4, 8)},
            "wire_bytes_identity": {p: ident.wire_bytes(p) for p in (4, 8)},
            "step_ms_first": hist[0]["step_ms"],
            "step_ms_median_after_first": statistics.median(steady),
            "identity_step_ms_median_after_first":
                path["step_ms_median"][accum],
            "tok_per_s": hist[-1]["tok_per_s"],
            "max_memory_allocated": torch.cuda.max_memory_allocated()}))
        quantize_launches += got_q
        densify_launches += got_d
    return {"quantize_launches": quantize_launches,
            "densify_launches": densify_launches}


def phase_small_reference(train) -> None:
    """The reduced configs in f32 train the same on the card (kernels)
    and on the CPU (plain versions, held against the JAX package by the
    test suite): transformer-big and the hybrid zamba2-7b (its scan is
    the differentiable ``ssd_chunked`` on both devices, as in the
    reference; full width does not fit one card with f32 Adam state),
    each with the identity wire and with int8 + error feedback.
    Tolerance rel 1e-4: the two devices sum in other orders, so an int8
    rounding may flip in a few elements of the second step's wire."""
    base = ["--reduced", "--dist", "horovod", "--grad-accum",
            "dense_reduce", "--batch-per-worker", "4", "--seq-len", "32",
            "--steps", "2", "--log-every", "1"]
    quiet = lambda s: None
    for arch in ("transformer-big", "zamba2-7b"):
        for codec in (["--codec", "identity"],
                      ["--codec", "int8", "--error-feedback"]):
            args = base + ["--arch", arch] + codec
            card = train.run(args + ["--device", "cuda"],
                             log=quiet)["history"]
            cpu = train.run(args + ["--device", "cpu"], log=quiet)["history"]
            lc, lh = [h["loss"] for h in card], [h["loss"] for h in cpu]
            if len(lc) != 2 or not all(math.isclose(x, y, rel_tol=1e-4)
                                       for x, y in zip(lc, lh)):
                fail(f"small reference {arch} {codec}: card losses {lc} "
                     f"vs cpu {lh}")
            print(json.dumps({"phase": "small_reference", "arch": arch,
                              "codec": codec[1:], "card_losses": lc,
                              "cpu_losses": lh}))


# ---------------------------------------------------------------------------
# the forward and serving path (flash attention)
# ---------------------------------------------------------------------------

BF16_FLOPS = 989e12                # H100 SXM dense bf16 tensor cores
ATTN_TOL = {torch.float32: dict(rtol=3e-5, atol=3e-5),   # tests/test_kernels.py
            torch.bfloat16: dict(rtol=3e-2, atol=3e-2)}
# bf16 outputs outside the small cases of tests/test_kernels.py: there
# |out| falls as 1/sqrt(keys attended) (about 0.013 at the median row of
# the causal 32768 prefill), so 3e-2 absolute would pass a dropped or
# doubled key tile.  The error is held to the reference output's size
# instead.  Rounding alone (both outputs rounded to bf16, so at most one
# ulp, 2**-7 relative, apart; p rounded to bf16 before P.V, ~1e-3 rms
# relative) keeps a query row's relative L2 error under 2**-7; dropping
# one 64-key tile from a row of n keys moves it by about 8/sqrt(n),
# 4.4e-2 at n = 32768.  Read on an H100 80GB HBM3 at 700 W: relative L2
# at most 2.3e-3, worst row 5.0e-3, max abs at most one ulp of max|ref|;
# the limits leave a factor of 2 to 4 above that.
ATTN_SCALED_TOL = dict(rel_l2=1e-2, row_rel_l2=1.5e-2, max_abs_ulps=2)
# Logits of full-width transformer-big in bf16, kernel path against the
# plain chunked path: both round every activation to bf16 (2**-9
# relative) at ~30 points between an attention output and the logits,
# and the kernel also rounds its probabilities to bf16 before P.V; the
# logits are O(1) (tied embedding drawn at d**-0.5).  So a few bf16
# roundings of a unit-sized logit, well under 0.25, and an error that
# stays a small fraction of the logits as a whole (relative L2 2e-2).
# A wrong mask or a wrong head moves the logits by O(1) everywhere.
PATH_TOL = dict(max_abs=0.25, rel_l2=2e-2)
PREFILL_LEN, N_ENC = 32768, 256
TRANSLATE_B, TRANSLATE_PREFIX, TRANSLATE_NEW = 8, 16, 32
SERVE_B, SERVE_PROMPT, SERVE_NEW = 8, 64, 32


def attended_pairs(sq, sk, causal, window):
    """(query, key) pairs the masks leave, per batch entry and head
    (query i at position i + sk - sq)."""
    qpos = torch.arange(sq, dtype=torch.int64) + (sk - sq)
    hi = torch.clamp(qpos + 1, max=sk) if causal \
        else torch.full_like(qpos, sk)
    lo = torch.clamp(qpos - window + 1, min=0) if window is not None \
        else torch.zeros_like(qpos)
    return int(torch.clamp(hi - lo, min=0).sum())


def attn_bound(q, k, causal, window):
    """Least time (ms) and its kind for one attention call: 4·D flops
    per attended pair and head at the rate of the inputs' type (bf16
    tensor cores, else f32), against q, k, v read and o written once."""
    b, sq, h, d = q.shape
    pairs = attended_pairs(sq, k.shape[1], causal, window)
    flops = 4 * d * pairs * h * b
    rate = BF16_FLOPS if q.dtype == k.dtype == torch.bfloat16 else F32_FLOPS
    nbytes = 2 * q.numel() * q.element_size() \
        + 2 * k.numel() * k.element_size()
    t_ops, t_bytes = flops / rate, nbytes / HBM_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3, "operations" if t_ops > t_bytes
            else "bytes", flops, nbytes)


def cuda_ms_cold(fn, iters: int, warmup: int = 1) -> float:
    """Mean device time of ``fn()`` with the 50 MB L2 flushed before
    each call (as a layer's kernel finds it after the other layers'
    weights have streamed through), CUDA events around each call."""
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    total = 0.0
    for _ in range(iters):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / iters


def _randn(shape, dtype, gen):
    return torch.randn(shape, device="cuda", generator=gen).to(dtype)


def phase_attn_kernel(FA) -> dict:
    """flash attention: every case against the plain version on the card
    (f32 3e-5, bf16 3e-2), then kernel, plain version and the library
    yardstick timed at the path's three shapes against the bound."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    bf, f32 = torch.bfloat16, torch.float32
    # name, b, sq, sk, h, hkv, d, window, causal, q dtype, kv dtype
    path_cases = [
        ("prefill_self", 1, PREFILL_LEN, PREFILL_LEN, 16, 16, 64, None,
         True, bf, bf),
        ("prefill_cross", 1, PREFILL_LEN, N_ENC, 16, 16, 64, None, False,
         bf, bf),
        ("decode_cross", TRANSLATE_B, 1, N_ENC, 16, 16, 64, None, False,
         bf, f32),
        # zamba2-7b's shared attention block, head dim 112
        ("hybrid_self", 1, PREFILL_LEN, PREFILL_LEN, 32, 32, 112, None,
         True, bf, bf),
    ]
    ref_cases = [   # tests/test_kernels.py CASES, in f32 and bf16
        (2, 16, 16, 4, 2, 32, None, True), (1, 64, 64, 2, 2, 64, 16, True),
        (2, 8, 40, 4, 4, 32, None, True), (1, 32, 32, 4, 1, 16, 8, True),
        (2, 24, 24, 2, 2, 128, None, False), (1, 17, 23, 3, 3, 48, None, True)]
    cases = list(path_cases)
    small = set()      # checked at the reference's own tolerance
    cases.append(("decode_cross_bf16", TRANSLATE_B, 1, N_ENC, 16, 16, 64,
                  None, False, bf, bf))
    cases.append(("hybrid_window", 1, PREFILL_LEN, PREFILL_LEN, 32, 32, 112,
                  8192, True, bf, bf))
    for dt in (f32, bf):
        cases.append((f"d112_{str(dt)[6:]}", 2, 100, 100, 4, 2, 112, None,
                      True, dt, dt))
        cases.append((f"d112_window_{str(dt)[6:]}", 1, 90, 90, 2, 2, 112, 17,
                      True, dt, dt))
    for i, c in enumerate(ref_cases):
        for dt in (f32, bf):
            cases.append((f"case{i}_{str(dt)[6:]}",) + c + (dt, dt))
            small.add(cases[-1][0])
    # the prefill kernel's edges: Sq not a multiple of its 128-row tile,
    # GQA with H / Hkv = 4, head dim 128, a ragged non-causal cross
    cases += [("sm90_ragged_sq", 2, 1000, 1000, 4, 4, 64, None, True, bf, bf),
              ("sm90_gqa4_d112", 1, 2048, 2048, 32, 8, 112, None, True, bf,
               bf),
              ("sm90_d128", 2, 384, 384, 4, 2, 128, None, True, bf, bf),
              ("sm90_cross_ragged", 2, 700, 300, 4, 4, 112, None, False, bf,
               bf)]
    for dt in (f32, bf):
        cases += [(f"causal_sq_gt_sk_{str(dt)[6:]}", 2, 40, 24, 4, 2, 64,
                   None, True, dt, dt),
                  (f"window_{str(dt)[6:]}", 2, 1000, 1000, 4, 2, 64, 100,
                   True, dt, dt),
                  (f"mixed_{str(dt)[6:]}", 3, 70, 300, 8, 4, 128, None,
                   False, dt, f32)]
    max_err = 0.0
    tensors = {}
    want_sm90 = {"prefill_self", "prefill_cross", "hybrid_self",
                 "hybrid_window"}
    for name, b, sq, sk, h, hkv, d, window, causal, qdt, kvdt in cases:
        q = _randn((b, sq, h, d), qdt, gen)
        k = _randn((b, sk, hkv, d), kvdt, gen)
        v = _randn((b, sk, hkv, d), kvdt, gen)
        variant = attn_variant(FA, name, q, k, v,
                               name in want_sm90 or name.startswith("sm90"))
        out = FA.flash_attention_kernel(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        ref = FA.flash_attention_plain(q, k, v, causal=causal, window=window)
        errs = check_attn(name, out, ref, qdt, scaled=name not in small)
        max_err = max(max_err, errs["max_abs_err"])
        print(json.dumps({"phase": "attn_kernel", "case": name,
                          "variant": variant,
                          "shape": [b, sq, sk, h, hkv, d], "window": window,
                          "causal": causal, "q_dtype": str(qdt)[6:],
                          "kv_dtype": str(kvdt)[6:], **errs}))
        if name in {c[0] for c in path_cases}:
            tensors[name] = (q, k, v, causal, window)
        del q, k, v, out, ref
    # the kernel's own arguments, a strided q and a misaligned k, v
    q = _randn((2, 48, 4, 64), bf, gen)
    k = _randn((2, 56, 2, 64), bf, gen)
    v = _randn((2, 56, 2, 64), bf, gen)
    packed = _randn((2, 48, 3, 4, 64), bf, gen)
    flat = _randn((2 * 56 * 2 * 64 + 1,), bf, gen)
    odd = flat[1:].view(2, 56, 2, 64)
    # the prefill kernel: kv_len < Sk with a q_offset, and q, k, v as
    # strided views of one packed (B, S, 3, H, D) projection
    q2 = _randn((1, 1500, 8, 112), bf, gen)
    k2 = _randn((1, 2000, 8, 112), bf, gen)
    v2 = _randn((1, 2000, 8, 112), bf, gen)
    qkv = _randn((2, 1100, 3, 8, 64), bf, gen)
    extra = [
        ("q_offset_kv_len", (q, k, v), dict(causal=True, q_offset=3,
                                            kv_len=40, scale=0.2)),
        ("window_kv_len", (q, k, v), dict(causal=True, window=9,
                                          kv_len=50)),
        ("strided_q", (packed[:, :, 1], k, v), dict(causal=True)),
        ("misaligned_kv", (q, odd, odd), dict(causal=False)),
        ("sm90_kv_len", (q2, k2, v2), dict(causal=True, kv_len=1700,
                                           q_offset=300)),
        ("sm90_window_kv_len", (q2, k2, v2), dict(causal=True, window=333,
                                                  kv_len=1900)),
        ("sm90_packed_qkv", (qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]),
         dict(causal=True)),
    ]
    for name, args, kw in extra:
        variant = attn_variant(FA, name, *args, name.startswith("sm90"))
        out = FA.flash_attention_kernel(*args, **kw)
        torch.cuda.synchronize()
        errs = check_attn(name, out, FA.flash_attention_plain(*args, **kw),
                          bf, scaled=True)
        max_err = max(max_err, errs["max_abs_err"])
        print(json.dumps({"phase": "attn_kernel", "case": name,
                          "variant": variant, "args": kw, **errs}))
    # the kernel takes Dv == D only; the public wrapper does not reroute
    from repro_torch.kernels import ops
    try:
        ops.flash_attention(q, k, v[..., :32].contiguous(), impl="kernel")
    except ValueError:
        pass
    else:
        fail("flash attention: impl='kernel' took Dv != D on the card")
    result = {"max_abs_err": max_err}
    for name, (q, k, v, causal, window) in tensors.items():
        bound_ms, bound_by, flops, nbytes = attn_bound(q, k, causal, window)
        kw = dict(causal=causal, window=window)
        one_row = q.shape[1] == 1
        variant = FA._variant(q, k, v)
        # the variant the path runs, and on the prefill kernel's inputs
        # also flash_mma, its predecessor, in turns with the plain version
        runs = {"kernel": dict(kw), "plain": None}
        if variant == "sm90":
            runs["mma"] = dict(kw, _override="mma")
        times = {}
        for order in ("kernel", "mma", "plain", "plain", "mma", "kernel"):
            if order not in runs:
                continue
            if order == "plain":
                t = cuda_ms_cold(lambda: FA.flash_attention_plain(
                    q, k, v, **kw), 20 if one_row else 2)
            else:
                t = cuda_ms_cold(lambda: FA.flash_attention_kernel(
                    q, k, v, **runs[order]), 50 if one_row else 10)
            times[order] = min(times.get(order, t), t)
        ms, plain_ms = times["kernel"], times["plain"]
        library_ms = None
        if q.dtype == k.dtype:
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            library_ms = cuda_ms_cold(
                lambda: torch.nn.functional.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=causal), 10)
        timing_line = {
            "phase": "attn_timing", "shape": name, "variant": variant,
            "q": list(q.shape), "kv": list(k.shape),
            "q_dtype": str(q.dtype)[6:], "kv_dtype": str(k.dtype)[6:],
            "causal": causal, "kernel_ms": ms,
            "mma_ms": times.get("mma"), "plain_ms": plain_ms,
            "library_ms": library_ms,
            "library_call": ("torch.nn.functional.scaled_dot_product_attention"
                             if library_ms is not None else
                             "none: no single call takes bf16 q with f32 "
                             "k, v"),
            "bound_ms": bound_ms, "bound_by": bound_by, "flops": flops,
            "bytes": nbytes, "tflops": flops / ms / 1e9,
            "l2": "flushed before each call"}
        print(json.dumps(timing_line))
        result[name] = timing_line
    return result


def attn_variant(FA, name, q, k, v, want_sm90: bool) -> str:
    """The variant the wrapper picks for these inputs; fails where a case
    meant for the prefill kernel would not reach it."""
    variant = FA._variant(q, k, v)
    if want_sm90 and variant != "sm90":
        fail(f"flash attention {name}: the wrapper picks {variant!r}, not "
             f"the prefill kernel")
    return variant


def check_attn(name, out, ref, qdt, scaled: bool) -> dict:
    """Kernel output against the plain version's: every case at
    ``ATTN_TOL``; bf16 outputs outside the small cases (``scaled``) also
    at ``ATTN_SCALED_TOL``, relative to the reference output's size."""
    if out.dtype != qdt or out.shape != ref.shape:
        fail(f"flash attention {name}: got {out.dtype} {tuple(out.shape)}, "
             f"want {qdt} {tuple(ref.shape)}")
    o, r = out.float(), ref.float()
    diff = o - r
    err = diff.abs().max().item()
    ref_max = r.abs().max().item()
    res = {"max_abs_err": err, "max_abs_ref": ref_max,
           "rms_ref": r.square().mean().sqrt().item()}
    if not math.isfinite(err):
        fail(f"flash attention {name}: output not finite")
    res["tol"] = ATTN_TOL[qdt]
    if not torch.allclose(o, r, **ATTN_TOL[qdt]):
        fail(f"flash attention {name}: kernel disagrees with the plain "
             f"version (max abs err {err})")
    if not (scaled and qdt == torch.bfloat16):
        return res
    # rows that are fully masked are exactly 0 in both
    d_row = diff.flatten(0, -2).norm(dim=-1)
    r_row = r.flatten(0, -2).norm(dim=-1)
    zero = r_row == 0
    if bool((d_row[zero] != 0).any()):
        fail(f"flash attention {name}: a fully masked row is not 0")
    row_rel = (d_row[~zero] / r_row[~zero]).max().item() \
        if bool((~zero).any()) else 0.0
    rel_l2 = (diff.norm() / r.norm()).item() if ref_max > 0 else 0.0
    ulp = 2.0 ** (math.floor(math.log2(ref_max)) - 7) if ref_max > 0 \
        else 2.0 ** -133
    max_abs_tol = ATTN_SCALED_TOL["max_abs_ulps"] * ulp
    res.update(rel_l2=rel_l2, worst_row_rel_l2=row_rel,
               tol={**ATTN_TOL[qdt], "rel_l2": ATTN_SCALED_TOL["rel_l2"],
                    "row_rel_l2": ATTN_SCALED_TOL["row_rel_l2"],
                    "max_abs": max_abs_tol})
    if rel_l2 > ATTN_SCALED_TOL["rel_l2"] or err > max_abs_tol \
            or row_rel > ATTN_SCALED_TOL["row_rel_l2"]:
        fail(f"flash attention {name}: kernel disagrees with the plain "
             f"version: {res}")
    return res


# ---------------------------------------------------------------------------
# the SSD scan kernel and the hybrid (zamba2-7b) path
# ---------------------------------------------------------------------------

SSD_TOL = dict(rtol=2e-5, atol=2e-5)        # tests/test_kernels.py
# bf16 inputs on the "sm90" kernel, against ssd_plain: relative L2 and max
# abs of y and of the final state at most 1e-4 of the reference's.  Both
# compute in f32 from the same bf16 values; ssd_plain sums in another
# order (the cumulative decay reaches ~41 in the fastest heads, where a
# few-ulp difference in cum moves exp(+-cum) by ~1e-5 relative), and
# "sm90" splits the f32 operand of each product in two bf16 terms (~2^-17
# an element).  A dropped key tile, a lost chunk of state or a wrong head
# moves y by O(1) of its size.  Set before the f32 kernel's first run on
# the card (PERF.md), and kept for the tensor-core kernel.
SSD_SCALED_TOL = dict(rel_l2=1e-4, max_abs_frac=1e-4)
SSD_MAIN = (1, PREFILL_LEN, 112, 64, 64, 256)    # b, s, h, p, n, chunk
SSD_PASSES = ("ssd_chunk_state", "ssd_state_pass", "ssd_chunk_scan")
HYBRID_CHECK_LEN = 4096
HYBRID_B, HYBRID_PREFIX, HYBRID_NEW = 8, 16, 32
HSERVE_B, HSERVE_PROMPT, HSERVE_NEW = 8, 32, 16


def ssd_bound(b, s, h, p, n, chunk, in_bytes):
    """Least time (ms) and its kind for one SSD launch: x, dt, a, b, c
    read and y, state written once against the operations (the
    head-free masked C B^T once per (batch, chunk), and per head the
    lower-triangle scores x (dt x), C @ state and the state update; 2
    flops a multiply-add) at the bf16 tensor-core rate.  Also the same
    bound with the operations at the f32 CUDA-core rate (the "simt"
    design's), and the time of the operations doubled by the
    two-term split at the bf16 rate."""
    nc = -(-s // chunk)
    tri = chunk * (chunk + 1) // 2
    flops = b * nc * tri * 2 * n \
        + b * h * nc * (tri * 2 * p + 2 * (2 * chunk * n * p))
    nbytes = b * s * h * p * in_bytes + 4 * b * s * h + 4 * h \
        + 2 * b * s * n * in_bytes + 4 * b * s * h * p + 4 * b * h * n * p
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_bf16, t_f32 = flops / BF16_FLOPS, flops / F32_FLOPS
    return {"bound_ms": max(t_bf16, t_bytes) * 1e3,
            "bound_by": "operations" if t_bf16 > t_bytes else "bytes",
            "bound_f32_ms": max(t_f32, t_bytes) * 1e3,
            "bound_f32_by": "operations" if t_f32 > t_bytes else "bytes",
            "split_ops_bf16_ms": 2 * t_bf16 * 1e3,
            "flops": flops, "bytes": nbytes}


def ssd_inputs(gen, b, s, h, p, n, dtype=torch.float32, a=None,
               dt_shift=-4.0, packed=False):
    """x, b, c ~ N(0, 1) in ``dtype``; dt = softplus(N(0, 1) + dt_shift)
    and a = -exp(U(0, 2.5)) (tests/test_kernels.py) unless given, f32.
    ``packed``: b and c are the column halves of one (B, S, 2N) tensor,
    as the Mamba2 block's conv output gives them."""
    dev = "cuda"
    x = torch.randn((b, s, h, p), device=dev, generator=gen).to(dtype)
    dt = torch.nn.functional.softplus(
        torch.randn((b, s, h), device=dev, generator=gen) + dt_shift)
    if a is None:
        a = -torch.exp(torch.rand((h,), device=dev, generator=gen) * 2.5)
    if packed:
        bc = torch.randn((b, s, 2 * n), device=dev, generator=gen).to(dtype)
        bb, cc = bc[..., :n], bc[..., n:]
    else:
        bb = torch.randn((b, s, n), device=dev, generator=gen).to(dtype)
        cc = torch.randn((b, s, n), device=dev, generator=gen).to(dtype)
    return x, dt, a.to(dev, torch.float32), bb, cc


def _pad_rows(args, chunk):
    pad = (-args[0].shape[1]) % chunk
    if not pad:
        return args
    x, dt, a, b, c = args
    F = torch.nn.functional
    return (F.pad(x, (0, 0, 0, 0, 0, pad)), F.pad(dt, (0, 0, 0, pad)), a,
            F.pad(b, (0, 0, 0, pad)), F.pad(c, (0, 0, 0, pad)))


def ssd_pass_ms(K, main, chunk, iters=3) -> dict:
    """Device time of each of the "sm90" kernel's three passes a call,
    under ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile
    K.ssd_kernel(*main, chunk)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            K.ssd_kernel(*main, chunk)
        torch.cuda.synchronize()
    out = dict.fromkeys(SSD_PASSES, 0.0)
    for e in prof.key_averages():
        for name in SSD_PASSES:
            if name + "(" in e.key:
                out[name] += e.device_time_total / iters / 1e3
    if not all(out.values()):
        fail(f"ssd passes: the profiler saw {out}")
    return out


def phase_ssd_kernel(K, ops) -> dict:
    """SSD scan: each variant against ``ssd_plain`` on the card.  f32
    inputs run "simt" (the cases of tests/test_kernels.py, a ragged S and
    an active clip, at 2e-5); bf16 inputs run "sm90" at
    ``SSD_SCALED_TOL`` (a ragged S padded by ``ops.ssd``, an active clip,
    P = N = 16 and 32, chunks 64 and 128, batch 2, odd head counts, b and
    c as column views of one packed tensor, and the main-path shape).
    Every case line names the variant that ran.  Then "sm90", "simt"
    (``_override``) and the plain version timed at the main-path shape,
    the three passes' device times, and the bound both ways."""
    gen = torch.Generator(device="cuda").manual_seed(4)
    mamba_a = lambda h: -torch.linspace(1.0, 16.0, h)     # exp(log(.))
    bf16 = torch.bfloat16
    cases = [(f"case{i}", c, {}) for i, c in enumerate([
        (1, 16, 1, 4, 4, 8), (2, 64, 3, 8, 4, 16), (2, 50, 3, 8, 4, 16),
        (1, 128, 2, 16, 8, 32)])]
    cases += [
        ("model_path", (2, 64, 4, 8, 8, 16), dict(a=mamba_a(4))),
        ("ragged", (2, 1000, 3, 64, 64, 64), {}),
        ("clip_active", (1, 512, 4, 64, 64, 256),
         dict(a=-torch.linspace(8.0, 16.0, 4), dt_shift=3.0)),
        ("bf16_ragged", (2, 1000, 3, 64, 64, 64), dict(dtype=bf16)),
        ("bf16_clip_active", (1, 512, 4, 64, 64, 256),
         dict(a=-torch.linspace(8.0, 16.0, 4), dt_shift=3.0, dtype=bf16)),
        ("bf16_p16_n16", (1, 1024, 4, 16, 16, 256), dict(dtype=bf16)),
        ("bf16_p32_n32_b2", (2, 512, 3, 32, 32, 128), dict(dtype=bf16)),
        ("bf16_chunk64", (1, 512, 4, 64, 64, 64),
         dict(a=mamba_a(4), dt_shift=-4.6, dtype=bf16)),
        ("bf16_chunk128_b2", (2, 768, 5, 64, 64, 128), dict(dtype=bf16)),
        ("bf16_packed_bc", (2, 1024, 4, 64, 64, 256),
         dict(a=mamba_a(4), dt_shift=-4.6, dtype=bf16, packed=True)),
        ("main_bf16", SSD_MAIN, dict(a=mamba_a(SSD_MAIN[2]), dt_shift=-4.6,
                                     dtype=bf16, packed=True)),
    ]
    max_err = None
    main = None
    for name, (b, s, h, p, n, chunk), kw in cases:
        args = ssd_inputs(gen, b, s, h, p, n, **kw)
        padded = _pad_rows(args, chunk)
        want = "sm90" if args[0].dtype == bf16 else "simt"
        variant = K._variant(*padded, chunk)
        K.reset_launches()
        if name == "bf16_ragged":      # the wrapper pads
            with torch.no_grad():
                y, st = ops.ssd(*args, chunk=chunk, impl="kernel")
        else:
            y, st = K.ssd_kernel(*padded, chunk)
        torch.cuda.synchronize()
        ran = dict(K.ssd_kernel.launches_by_variant)
        if variant != want or ran != {**dict.fromkeys(K.VARIANTS, 0),
                                      want: 1}:
            fail(f"ssd {name}: variant {variant}, launches {ran} (want one "
                 f"on {want})")
        y_ref, st_ref = K.ssd_plain(*padded, chunk)
        y, y_ref = y[:, :s], y_ref[:, :s]
        if y.dtype != torch.float32 or tuple(y.shape) != (b, s, h, p) \
                or tuple(st.shape) != (b, h, n, p):
            fail(f"ssd {name}: got {y.dtype} {tuple(y.shape)} state "
                 f"{tuple(st.shape)}")
        if not (torch.isfinite(y).all() and torch.isfinite(st).all()):
            fail(f"ssd {name}: output not finite")
        err = (y - y_ref).abs().max().item()
        st_err = (st - st_ref).abs().max().item()
        ref_max = y_ref.abs().max().item()
        line = {"phase": "ssd_kernel", "case": name, "variant": variant,
                "shape": [b, s, h, p, n, chunk],
                "dtype": str(args[0].dtype)[6:],
                "packed_bc": bool(kw.get("packed")), "max_abs_err": err,
                "state_max_abs_err": st_err, "max_abs_ref": ref_max,
                "max_abs_state": st_ref.abs().max().item()}
        if "clip_active" in name:
            cum = torch.cumsum((args[1] * args[2]).reshape(
                b, -1, chunk, h), dim=2)
            line["max_abs_cum"] = cum.abs().max().item()
            if line["max_abs_cum"] <= 60.0:
                fail(f"ssd {name}: the clip is not active")
        if want == "sm90":
            rel = ((y - y_ref).norm() / y_ref.norm()).item()
            st_rel = ((st - st_ref).norm() / st_ref.norm()).item()
            st_frac = st_err / st_ref.abs().max().item()
            line.update(rel_l2=rel, max_abs_frac=err / ref_max,
                        state_rel_l2=st_rel, state_max_abs_frac=st_frac,
                        tol=SSD_SCALED_TOL)
            ok = max(rel, st_rel) <= SSD_SCALED_TOL["rel_l2"] and \
                max(err / ref_max, st_frac) <= SSD_SCALED_TOL["max_abs_frac"]
        elif name == "clip_active":
            scale = max(ref_max, 1e-30)
            line["tol"] = {**SSD_TOL, "relative_to": "max|ref|"}
            ok = torch.allclose(y / scale, y_ref / scale, **SSD_TOL) and \
                torch.allclose(st, st_ref, **SSD_TOL)
        else:
            line["tol"] = SSD_TOL
            ok = torch.allclose(y, y_ref, **SSD_TOL) and \
                torch.allclose(st, st_ref, **SSD_TOL)
        print(json.dumps(line))
        if not ok:
            fail(f"ssd {name}: kernel disagrees with ssd_plain: {line}")
        if name == "main_bf16":
            main, max_err = padded, max(err, st_err)
        del args, padded, y, st, y_ref, st_ref

    bound = ssd_bound(*SSD_MAIN, in_bytes=2)
    chunk = SSD_MAIN[-1]
    runs = {"sm90": (lambda: K.ssd_kernel(*main, chunk), 10),
            "simt": (lambda: K.ssd_kernel(*main, chunk, _override="simt"),
                     3),
            "plain": (lambda: K.ssd_plain(*main, chunk), 2)}
    best = {}
    for order in ("sm90", "simt", "plain", "plain", "simt", "sm90"):
        fn, iters = runs[order]
        t = cuda_ms(fn, iters, warmup=1)
        best[order] = min(best.get(order, t), t)
    passes = ssd_pass_ms(K, main, chunk)
    ms = best["sm90"]
    timing = {"phase": "ssd_timing", "shape": list(SSD_MAIN),
              "dtype": "bf16 x, b, c (views of one packed bc); f32 dt, a",
              "kernel_ms": ms, "simt_ms": best["simt"],
              "plain_ms": best["plain"], "pass_device_ms": passes,
              "library_ms": None,
              "library_call": "none: no PyTorch call computes the SSD scan",
              **bound, "achieved_tb_per_s": bound["bytes"] / ms / 1e9,
              "bound_share": bound["bound_ms"] / ms}
    print(json.dumps(timing))
    return {"max_abs_err": max_err, **timing}


def phase_hybrid_init(model):
    """Full-width zamba2-7b in bf16, weights from seed 0 drawn on the
    CPU generator layer by layer into the card; init time and memory."""
    from repro_torch.tree import tree_flatten
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init(seed=0, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n = sum(t.numel() for t in tree_flatten(params)[0])
    if n != 6_750_840_528:
        fail(f"hybrid init: {n} parameters (want 6750840528)")
    print(json.dumps({"phase": "hybrid_init", "init_s": init_s,
                      "parameters": n,
                      "memory_allocated": torch.cuda.memory_allocated(),
                      "max_memory_allocated":
                          torch.cuda.max_memory_allocated()}))
    return params


def phase_hybrid_prefill(model, params, K, FA) -> dict:
    """The prefill step (``forward(attn_impl="kernel")`` and ``head`` on
    the last position) over one 32768-token sequence: 81 SSD launches and
    13 flash attention launches a forward, all on the "sm90" kernels
    (counts reset just before each run, read just after).  On the first
    4096 tokens the logits are compared with the plain path's
    (``"chunked"``: ssd_chunked and chunked attention) and reported: in
    bf16, 94 residual blocks of random weights carry any last-bit
    difference to O(0.3) of the logits (either kernel alone does it,
    PERF.md), so the check at ``PATH_TOL`` is made in f32
    (``phase_hybrid_f32``)."""
    from repro_torch.data import make_pipeline
    cfg = model.cfg
    tokens = torch.from_numpy(make_pipeline(cfg, 1, PREFILL_LEN).batch_at(
        0)["tokens"]).cuda()
    want_ssd = cfg.n_layers
    want_fa = cfg.n_layers // cfg.attn_every

    def prefill_step(toks, impl):
        h = model.forward(params, {"tokens": toks}, attn_impl=impl)
        return model.head(params, h[:, -1:])[:, 0]

    with torch.no_grad():
        prefill_step(tokens, "kernel")                     # warm-up
        torch.cuda.reset_peak_memory_stats()
        runs = []
        for _ in range(3):
            K.reset_launches()
            FA.reset_launches()
            logits, ms = timed(lambda: prefill_step(tokens, "kernel"))
            ssd_n = K.ssd_kernel.launches
            fa_n = FA.flash_attention_kernel.launches
            by_variant = dict(FA.flash_attention_kernel.launches_by_variant)
            ssd_by_variant = dict(K.ssd_kernel.launches_by_variant)
            if ssd_n != want_ssd or fa_n != want_fa:
                fail(f"hybrid prefill: {ssd_n} SSD and {fa_n} flash "
                     f"attention launches in one forward (want {want_ssd} "
                     f"and {want_fa})")
            if by_variant != {"sm90": want_fa, "mma": 0, "simt": 0}:
                fail(f"hybrid prefill: flash attention launches by variant "
                     f"{by_variant} (want all {want_fa} on sm90)")
            if ssd_by_variant != {"sm90": want_ssd, "simt": 0}:
                fail(f"hybrid prefill: SSD launches by variant "
                     f"{ssd_by_variant} (want all {want_ssd} on sm90)")
            runs.append(ms)
        peak = torch.cuda.max_memory_allocated()
        if tuple(logits.shape) != (1, cfg.vocab) \
                or not torch.isfinite(logits).all():
            fail(f"hybrid prefill: logits {tuple(logits.shape)} or not "
                 f"finite")
        short = tokens[:, :HYBRID_CHECK_LEN]
        got, short_ms = timed(lambda: prefill_step(short, "kernel"))
        torch.cuda.empty_cache()
        plain, plain_ms = timed(lambda: prefill_step(short, "chunked"))
    diff = logits_diff(f"hybrid prefill {HYBRID_CHECK_LEN}", got, plain)
    ms = statistics.median(runs)
    line = {"phase": "hybrid_prefill", "tokens": PREFILL_LEN,
            "ssd_launches_per_forward": ssd_n,
            "ssd_launches_by_variant": ssd_by_variant,
            "flash_launches_per_forward": fa_n,
            "flash_launches_by_variant": by_variant, "ms_runs": runs,
            "ms_median": ms, "tok_per_s": PREFILL_LEN / ms * 1e3,
            "check_tokens": HYBRID_CHECK_LEN,
            "kernel_ms_check_len": short_ms,
            "plain_chunked_ms_check_len": plain_ms,
            "logits_vs_plain_bf16": diff, "max_memory_allocated": peak}
    print(json.dumps(line))
    return line


def phase_hybrid_f32(model, params, K, FA) -> dict:
    """Full width and full depth in f32 (the bf16 weights cast, 27 GB):
    the prefill step's logits on the first 4096 tokens, the kernel path
    (both kernels' f32 paths; 81 SSD launches, all on "simt", and 13
    flash attention launches)
    against the plain path, at ``PATH_TOL``."""
    from repro_torch.data import make_pipeline
    from repro_torch.models import build_model
    from repro_torch.tree import tree_map
    f32 = build_model(model.cfg.with_(dtype="float32"))
    params = tree_map(lambda t: t.float(), params)
    torch.cuda.empty_cache()
    tokens = torch.from_numpy(make_pipeline(model.cfg, 1, PREFILL_LEN)
                              .batch_at(0)["tokens"][:, :HYBRID_CHECK_LEN]
                              ).cuda()

    def prefill_step(impl):
        h = f32.forward(params, {"tokens": tokens}, attn_impl=impl)
        return f32.head(params, h[:, -1:])[:, 0]

    with torch.no_grad():
        K.reset_launches()
        FA.reset_launches()
        got, ms = timed(lambda: prefill_step("kernel"))
        launches = (K.ssd_kernel.launches, FA.flash_attention_kernel.launches)
        if launches != (model.cfg.n_layers,
                        model.cfg.n_layers // model.cfg.attn_every) \
                or K.ssd_kernel.launches_by_variant["simt"] != launches[0]:
            fail(f"hybrid f32: {launches} SSD and flash attention launches "
                 f"(SSD by variant {K.ssd_kernel.launches_by_variant})")
        plain, plain_ms = timed(lambda: prefill_step("chunked"))
    diff = check_logits(f"hybrid f32 prefill {HYBRID_CHECK_LEN}", got, plain)
    line = {"phase": "hybrid_f32", "tokens": HYBRID_CHECK_LEN,
            "ssd_launches": launches[0], "flash_launches": launches[1],
            "kernel_ms": ms, "plain_chunked_ms": plain_ms,
            "logits_vs_plain": diff, "tol": PATH_TOL,
            "max_abs_logit": plain.abs().max().item()}
    print(json.dumps(line))
    return line


def phase_hybrid_decode(model, params, K, FA) -> dict:
    """8 requests: ``Model.prefill`` over a 16-token prefix, then 32
    greedy ``decode_step``s (recurrent Mamba2 steps, cached shared
    attention: no kernel launch, as in the reference); shapes, lengths
    and finite logits asserted.  Not held against the forward: where a
    chunk's cumulative decay passes the clip, the reference's chunked
    scan drops near-diagonal terms that the recurrence keeps (ROADMAP
    Queue 3), so the two differ by design; small_hybrid holds decode on
    the card to the CPU."""
    from repro_torch.data import make_pipeline
    cfg = model.cfg
    prefix = torch.from_numpy(make_pipeline(
        cfg, HYBRID_B, HYBRID_PREFIX).batch_at(1)["tokens"]).cuda()
    with torch.no_grad():
        K.reset_launches()
        FA.reset_launches()
        cache = model.init_cache(HYBRID_B, HYBRID_PREFIX + HYBRID_NEW,
                                 device="cuda")
        (logits, cache), pre_ms = timed(
            lambda: model.prefill(params, cache, prefix))
        toks = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(HYBRID_NEW):
            tok = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
            toks.append(tok)
            logits, cache = model.decode_step(params, cache, tok)
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1e3 / HYBRID_NEW
        launches = K.ssd_kernel.launches + FA.flash_attention_kernel.launches
        if launches != 0:
            fail(f"hybrid decode: {launches} kernel launches (want 0)")
        if tuple(logits.shape) != (HYBRID_B, cfg.vocab) \
                or not torch.isfinite(logits).all() \
                or int(cache["length"][0]) != HYBRID_PREFIX + HYBRID_NEW:
            fail(f"hybrid decode: logits {tuple(logits.shape)}, length "
                 f"{cache['length'].tolist()}")
    line = {"phase": "hybrid_decode", "requests": HYBRID_B,
            "prefix": HYBRID_PREFIX, "new_tokens": HYBRID_NEW,
            "launches": launches, "prefill_ms": pre_ms,
            "decode_ms_per_step": step_ms,
            "tok_per_s": HYBRID_B / step_ms * 1e3,
            "first_row_tokens": torch.cat(toks, 1)[0].tolist()}
    print(json.dumps(line))
    return line


def phase_hybrid_serve(model, params, K, FA) -> dict:
    """``ServeEngine.generate`` on 8 prompts of 32 tokens, 16 new tokens,
    unchanged on the hybrid cache: no kernel launch; shape and EOS
    masking asserted."""
    import numpy as np
    from repro_torch.serving import ServeEngine
    prompts = np.random.default_rng(5).integers(
        3, model.cfg.vocab, (HSERVE_B, HSERVE_PROMPT)).astype(np.int32)
    cache_len = HSERVE_PROMPT + HSERVE_NEW + 1
    probe = ServeEngine(model, params, cache_len=cache_len, eos_id=-1)
    K.reset_launches()
    FA.reset_launches()
    out, ms = timed(lambda: probe.generate(prompts, max_new=HSERVE_NEW))
    launches = K.ssd_kernel.launches + FA.flash_attention_kernel.launches
    if out.shape != (HSERVE_B, HSERVE_NEW) or out.dtype != np.int32 \
            or not ((out >= 0) & (out < model.cfg.vocab)).all():
        fail(f"hybrid serve: output {out.shape} {out.dtype} out of range")
    if launches != 0:
        fail(f"hybrid serve: {launches} kernel launches (want 0)")
    _, pre_ms = timed(lambda: probe.generate(prompts, max_new=1))
    eos = int(out[0, 2])
    masked = ServeEngine(model, params, cache_len=cache_len, eos_id=eos
                         ).generate(prompts, max_new=HSERVE_NEW)
    if not (masked[0, 2:] == eos).all() or not (masked[0] == out[0])[:3].all():
        fail("hybrid serve: the first row did not stop at its third token")
    for row in masked:
        hits = np.flatnonzero(row == eos)
        if hits.size and not (row[hits[0]:] == eos).all():
            fail(f"hybrid serve: row continues after EOS {eos}")
    decode_ms = (ms - pre_ms) / (HSERVE_NEW - 1)
    line = {"phase": "hybrid_serve", "requests": HSERVE_B,
            "prompt": HSERVE_PROMPT, "new_tokens": HSERVE_NEW,
            "launches": launches, "generate_ms": ms,
            "generate_first_token_ms": pre_ms,
            "decode_ms_per_token_step": decode_ms,
            "tok_per_s": HSERVE_B * HSERVE_NEW / ms * 1e3}
    print(json.dumps(line))
    return line


def phase_small_hybrid(K) -> None:
    """The reduced zamba2 in f32: the prefill step's forward and a 4-token
    prefix plus 4 teacher-forced decode steps on the card (both kernels'
    f32 paths) and on the CPU (their plain versions), logits within
    3e-5."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.tree import tree_map
    model = build_model(get_config("zamba2-7b").reduced())
    cpu = model.init(seed=0, device="cpu")
    card = tree_map(lambda t: t.cuda(), cpu)
    toks = torch.from_numpy(np.random.default_rng(6).integers(
        0, model.cfg.vocab, (2, 40)).astype(np.int32))
    tol = ATTN_TOL[torch.float32]
    outs = []
    K.reset_launches()
    with torch.no_grad():
        for dev, params in (("cuda", card), ("cpu", cpu)):
            t = toks.to(dev)
            h = model.forward(params, {"tokens": t}, attn_impl="kernel")
            logits = [model.head(params, h[:, -1])]
            cache = model.init_cache(2, 8, device=dev)
            lg, cache = model.prefill(params, cache, t[:, :4])
            logits.append(lg)
            for i in range(4, 8):
                lg, cache = model.decode_step(params, cache, t[:, i:i + 1])
                logits.append(lg)
            outs.append([x.cpu() for x in logits])
    if K.ssd_kernel.launches != model.cfg.n_layers:
        fail(f"small hybrid: {K.ssd_kernel.launches} SSD launches on the "
             f"card (want {model.cfg.n_layers})")
    worst = 0.0
    for i, (a, c) in enumerate(zip(*outs)):
        err = (a - c).abs().max().item()
        worst = max(worst, err)
        if not torch.allclose(a, c, **tol):
            fail(f"small hybrid: logits {i} card vs cpu max abs err {err}")
    print(json.dumps({"phase": "small_hybrid", "steps": len(outs[0]),
                      "max_abs_err": worst, "tol": tol}))


def logits_diff(tag, got, want) -> dict:
    got, want = got.float(), want.float()
    if got.shape != want.shape or not torch.isfinite(got).all():
        fail(f"{tag}: logits {tuple(got.shape)} (want {tuple(want.shape)})"
             f" or not finite")
    return {"max_abs": (got - want).abs().max().item(),
            "rel_l2": ((got - want).norm() / want.norm()).item()}


def check_logits(tag, got, want) -> dict:
    diff = logits_diff(tag, got, want)
    max_abs, rel_l2 = diff["max_abs"], diff["rel_l2"]
    if max_abs > PATH_TOL["max_abs"] or rel_l2 > PATH_TOL["rel_l2"]:
        fail(f"{tag}: kernel path logits differ from the plain path: max "
             f"abs {max_abs}, rel l2 {rel_l2} (limits {PATH_TOL})")
    return diff


def timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def phase_prefill(model, params, FA) -> dict:
    """The prefill step (``forward(attn_impl="kernel")`` and ``head`` on
    the last position, as the reference's dry-run lowers it) on one
    32768-token sequence with 256 encoder states; 12 kernel launches per
    forward; logits held against the plain chunked path."""
    from repro_torch.data import make_pipeline
    batch = make_pipeline(model.cfg, 1, PREFILL_LEN).batch_at(0)
    batch = {k: torch.from_numpy(v).cuda() for k, v in batch.items()}

    def prefill_step(impl):
        h = model.forward(params, batch, attn_impl=impl)
        return model.head(params, h[:, -1:])[:, 0]
    want = 2 * model.cfg.n_layers        # self- and cross-attention
    with torch.no_grad():
        prefill_step("kernel")                     # warm-up
        runs = []
        for _ in range(3):
            FA.reset_launches()
            logits, ms = timed(lambda: prefill_step("kernel"))
            launches = FA.flash_attention_kernel.launches
            by_variant = dict(FA.flash_attention_kernel.launches_by_variant)
            if launches != want:
                fail(f"prefill: flash attention launched {launches} times "
                     f"in one forward (want {want})")
            if by_variant != {"sm90": want, "mma": 0, "simt": 0}:
                fail(f"prefill: flash attention launches by variant "
                     f"{by_variant} (want all {want} on sm90)")
            runs.append(ms)
        torch.cuda.empty_cache()
        plain, plain_ms = timed(lambda: prefill_step("chunked"))
    diff = check_logits("prefill", logits, plain)
    ms = statistics.median(runs)
    line = {"phase": "prefill", "tokens": PREFILL_LEN, "enc": N_ENC,
            "launches_per_forward": launches,
            "launches_by_variant": by_variant, "ms_runs": runs,
            "ms_median": ms, "tok_per_s": PREFILL_LEN / ms * 1e3,
            "plain_chunked_ms": plain_ms, "logits_vs_plain": diff,
            "tol": PATH_TOL,
            "max_memory_allocated": torch.cuda.max_memory_allocated()}
    print(json.dumps(line))
    return {"launches": launches, **line}


def translate(model, params, prefix, enc, impl, cache_len, n_new,
              stream=None):
    """``Model.prefill`` over the prefix, then ``n_new`` decode steps,
    all cross-attending ``enc``: greedy, or teacher-forced on ``stream``
    (B, n_new) when given.  Returns (logits per step, tokens, prefill
    ms, decode ms per step)."""
    cache = model.init_cache(prefix.shape[0], cache_len, device="cuda")
    (logits, cache), pre_ms = timed(lambda: model.prefill(
        params, cache, prefix, enc=enc, attn_impl=impl))
    steps, toks = [logits], []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(n_new):
        tok = (torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
               if stream is None else stream[:, i:i + 1])
        toks.append(tok)
        logits, cache = model.decode_step(params, cache, tok, enc=enc,
                                          attn_impl=impl)
        steps.append(logits)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / n_new
    return torch.stack(steps, 1), torch.cat(toks, 1), pre_ms, step_ms


def phase_translate(model, params, FA) -> dict:
    """8 requests of 256 f32 encoder states (the pipeline's stub): a
    16-token target prefix through ``Model.prefill``, then 32 greedy
    ``decode_step``s, every layer cross-attending through the kernel (6
    launches a step); every step's logits held against the plain path
    teacher-forced on the same tokens."""
    from repro_torch.data import make_pipeline
    batch = make_pipeline(model.cfg, TRANSLATE_B, TRANSLATE_PREFIX
                          ).batch_at(1)
    prefix = torch.from_numpy(batch["tokens"]).cuda()
    enc = torch.from_numpy(batch["frontend"]).cuda()
    cache_len = TRANSLATE_PREFIX + TRANSLATE_NEW
    with torch.no_grad():
        FA.reset_launches()
        logits, toks, pre_ms, step_ms = translate(
            model, params, prefix, enc, "kernel", cache_len, TRANSLATE_NEW)
        torch.cuda.synchronize()
        launches = FA.flash_attention_kernel.launches
        by_variant = dict(FA.flash_attention_kernel.launches_by_variant)
        want = model.cfg.n_layers * (TRANSLATE_PREFIX + TRANSLATE_NEW)
        if launches != want:
            fail(f"translate: flash attention launched {launches} times "
                 f"(want {want}: one per layer and step)")
        plain, _, plain_pre_ms, plain_step_ms = translate(
            model, params, prefix, enc, "chunked", cache_len, TRANSLATE_NEW,
            stream=toks)
    worst = {"max_abs": 0.0, "rel_l2": 0.0}
    for i in range(logits.shape[1]):
        d = check_logits(f"translate step {i}", logits[:, i], plain[:, i])
        worst = {k: max(worst[k], d[k]) for k in worst}
    line = {"phase": "translate", "requests": TRANSLATE_B,
            "enc": N_ENC, "enc_dtype": "float32",
            "prefix": TRANSLATE_PREFIX, "new_tokens": TRANSLATE_NEW,
            "launches": launches, "launches_by_variant": by_variant,
            "prefill_ms": pre_ms, "decode_ms_per_step": step_ms,
            "tok_per_s": TRANSLATE_B / step_ms * 1e3,
            "plain_prefill_ms": plain_pre_ms,
            "plain_decode_ms_per_step": plain_step_ms,
            "logits_vs_plain_worst": worst, "tol": PATH_TOL,
            "first_row_tokens": toks[0].tolist()}
    print(json.dumps(line))
    return {"launches": launches, **line}


def phase_serve(model, params, FA) -> dict:
    """``ServeEngine.generate`` on 8 prompts of 64 tokens, 32 new tokens:
    no encoder states, so no kernel launch (the reference's engine passes
    none); output shape and EOS masking asserted."""
    import numpy as np
    from repro_torch.serving import ServeEngine
    prompts = np.random.default_rng(3).integers(
        3, model.cfg.vocab, (SERVE_B, SERVE_PROMPT)).astype(np.int32)
    cache_len = SERVE_PROMPT + SERVE_NEW + 1
    probe = ServeEngine(model, params, cache_len=cache_len, eos_id=-1)
    probe.generate(prompts[:, :4], max_new=2)     # warm-up
    FA.reset_launches()
    out, ms = timed(lambda: probe.generate(prompts, max_new=SERVE_NEW))
    launches = FA.flash_attention_kernel.launches
    if out.shape != (SERVE_B, SERVE_NEW) or out.dtype != np.int32 \
            or not ((out >= 0) & (out < model.cfg.vocab)).all():
        fail(f"serve: output {out.shape} {out.dtype} out of range")
    if launches != 0:
        fail(f"serve: {launches} kernel launches without encoder states")
    # prefill and the first token alone: the rest of ``ms`` is decode
    _, pre_ms = timed(lambda: probe.generate(prompts, max_new=1))
    eos = int(out[0, 2])
    masked = ServeEngine(model, params, cache_len=cache_len, eos_id=eos
                         ).generate(prompts, max_new=SERVE_NEW)
    for row in masked:
        hits = np.flatnonzero(row == eos)
        if hits.size and not (row[hits[0]:] == eos).all():
            fail(f"serve: row continues after EOS {eos}: {row.tolist()}")
    if not (masked[0, 2:] == eos).all():
        fail("serve: the first row did not stop at its third token")
    decode_ms = (ms - pre_ms) / (SERVE_NEW - 1)
    line = {"phase": "serve", "requests": SERVE_B, "prompt": SERVE_PROMPT,
            "new_tokens": SERVE_NEW, "launches": launches,
            "generate_ms": ms, "generate_first_token_ms": pre_ms,
            "decode_ms_per_token_step": decode_ms,
            "tok_per_s": SERVE_B * SERVE_NEW / ms * 1e3,
            "decode_tok_per_s": SERVE_B / decode_ms * 1e3,
            "eos_masked_shape": list(masked.shape)}
    print(json.dumps(line))
    return line


def phase_small_forward() -> None:
    """The reduced config in f32: the prefill step and a 4-token prefix
    plus 4 teacher-forced translate steps on the card (the kernel's f32
    path) and on the CPU (its plain version), logits within 3e-5."""
    from repro_torch.configs import get_config
    from repro_torch.data import make_pipeline
    from repro_torch.models import build_model
    from repro_torch.tree import tree_map
    model = build_model(get_config("transformer-big").reduced())
    cpu = model.init(seed=0, device="cpu")
    card = tree_map(lambda t: t.cuda(), cpu)
    batch = make_pipeline(model.cfg, 2, 16).batch_at(0)
    tol = ATTN_TOL[torch.float32]
    errs = []
    with torch.no_grad():
        for dev, params in (("cuda", card), ("cpu", cpu)):
            b = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
            h = model.forward(params, b, attn_impl="kernel")
            logits = [model.head(params, h[:, -1])]
            cache = model.init_cache(2, 8, device=dev)
            lg, cache = model.prefill(params, cache, b["tokens"][:, :4],
                                      enc=b["frontend"], attn_impl="kernel")
            logits.append(lg)
            for i in range(4, 8):
                lg, cache = model.decode_step(
                    params, cache, b["tokens"][:, i:i + 1], enc=b["frontend"],
                    attn_impl="kernel")
                logits.append(lg)
            errs.append([x.cpu() for x in logits])
    worst = 0.0
    for i, (a, c) in enumerate(zip(*errs)):
        err = (a - c).abs().max().item()
        worst = max(worst, err)
        if not torch.allclose(a, c, **tol):
            fail(f"small forward: logits {i} card vs cpu max abs err {err}")
    print(json.dumps({"phase": "small_forward", "steps": len(errs[0]),
                      "max_abs_err": worst, "tol": tol}))


def main() -> int:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a card")
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.configs import get_config
    from repro_torch.core import comm
    from repro_torch.data import make_pipeline
    from repro_torch.kernels import build, densify as D, quantize as Q
    from repro_torch.kernels import flash_attention as FA, ops, ssd as K
    from repro_torch.launch import train
    from repro_torch.models import build_model

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi)
    clock = PhaseClock()
    clock("build", phase_build, build)
    tokens = make_pipeline(get_config("transformer-big"), 8, 256
                           ).batch_at(0)["tokens"]
    kern = clock("kernel", phase_kernel, D, tokens)
    qkern = clock("quantize_kernel", phase_quantize_kernel, Q)
    akern = clock("attn_kernel", phase_attn_kernel, FA)
    torch.cuda.empty_cache()
    skern = clock("ssd_kernel", phase_ssd_kernel, K, ops)
    torch.cuda.empty_cache()
    path = clock("path", phase_path, train, D, comm)
    codec = clock("codec", phase_codec_path, train, D, Q, comm, path)
    torch.cuda.empty_cache()
    model = build_model(get_config("transformer-big"))
    params = model.init(seed=0, device="cuda")
    prefill = clock("prefill", phase_prefill, model, params, FA)
    trans = clock("translate", phase_translate, model, params, FA)
    clock("serve", phase_serve, model, params, FA)
    del params
    torch.cuda.empty_cache()
    hybrid = build_model(get_config("zamba2-7b"))
    params = clock("hybrid_init", phase_hybrid_init, hybrid)
    hpre = clock("hybrid_prefill", phase_hybrid_prefill, hybrid, params, K,
                 FA)
    clock("hybrid_decode", phase_hybrid_decode, hybrid, params, K, FA)
    clock("hybrid_serve", phase_hybrid_serve, hybrid, params, K, FA)
    clock("hybrid_f32", phase_hybrid_f32, hybrid, params, K, FA)
    del params
    torch.cuda.empty_cache()
    clock("small", phase_small_reference, train)
    clock("small_forward", phase_small_forward)
    clock("small_hybrid", phase_small_hybrid, K)
    print(json.dumps({"kernels": [{
        "name": "densify", "route": "cuda",
        "source": "src/repro_torch/csrc/densify.cu",
        "replaces": "src/repro/kernels/densify.py:40",
        "launches": path["densify_launches"] + codec["densify_launches"],
        "max_abs_err": kern["max_abs_err"],
        "ms": kern["kernel_ms"], "plain_ms": kern["plain_ms"],
        "bound_ms": kern["bound_ms"], "bound_by": kern["bound_by"],
        "library_ms": kern["library_ms"]}, {
        "name": "quantize", "route": "cuda",
        "source": "src/repro_torch/csrc/quantize.cu",
        "replaces": "src/repro/kernels/quantize.py:29",
        "launches": codec["quantize_launches"],
        "max_abs_err": qkern["max_abs_err"],
        "ms": qkern["kernel_ms"], "plain_ms": qkern["plain_ms"],
        "bound_ms": qkern["bound_ms"], "bound_by": qkern["bound_by"],
        "library_ms": qkern["library_ms"]}, {
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention_sm90.cu",
        "replaces": "src/repro/kernels/flash_attention.py:33",
        "launches": prefill["launches"] + trans["launches"]
        + hpre["flash_launches_per_forward"],
        "sources": ["src/repro_torch/csrc/flash_attention_sm90.cu",
                    "src/repro_torch/csrc/flash_attention.cu"],
        "launches_by_variant": {
            k: prefill["launches_by_variant"][k]
            + trans["launches_by_variant"][k]
            + hpre["flash_launches_by_variant"][k]
            for k in prefill["launches_by_variant"]},
        "max_abs_err": akern["max_abs_err"],
        "ms": akern["prefill_self"]["kernel_ms"],
        "mma_ms": akern["prefill_self"]["mma_ms"],
        "plain_ms": akern["prefill_self"]["plain_ms"],
        "bound_ms": akern["prefill_self"]["bound_ms"],
        "bound_by": akern["prefill_self"]["bound_by"],
        "library_ms": akern["prefill_self"]["library_ms"],
        "d112": {k: akern["hybrid_self"][k] for k in (
            "kernel_ms", "mma_ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")},
        "cross": {k: akern["prefill_cross"][k] for k in (
            "kernel_ms", "mma_ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")}}, {
        "name": "ssd", "route": "cuda",
        "source": "src/repro_torch/csrc/ssd_sm90.cu",
        "replaces": "src/repro/kernels/ssd.py:32",
        "launches": hpre["ssd_launches_per_forward"],
        "sources": ["src/repro_torch/csrc/ssd_sm90.cu",
                    "src/repro_torch/csrc/ssd.cu"],
        "launches_by_variant": hpre["ssd_launches_by_variant"],
        "max_abs_err": skern["max_abs_err"],
        "ms": skern["kernel_ms"], "simt_ms": skern["simt_ms"],
        "pass_device_ms": skern["pass_device_ms"],
        "plain_ms": skern["plain_ms"],
        "bound_ms": skern["bound_ms"], "bound_by": skern["bound_by"],
        "bound_f32_ms": skern["bound_f32_ms"],
        "library_ms": skern["library_ms"]}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
