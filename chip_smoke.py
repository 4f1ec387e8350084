#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA H100.

    python3 chip_smoke.py

Phases, each fatal on failure (non-zero exit, no result line):

  1. device  — the card's name and power limit (nvidia-smi);
  2. build   — compile every CUDA kernel from ``src/repro_torch/csrc``
               (one nvcc per source, started together);
  3. kernel  — hold each kernel (densify, quantize) to its plain
               PyTorch version on the card at the training step's shapes
               and edge cases (quantize bitwise), then time kernel, plain
               version and one library call where there is one with CUDA
               events against the least time the card could take;
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
  6. small   — the reduced config in f32 trains 2 steps on the card and
               on the CPU, with the identity wire and with ``--codec
               int8 --error-feedback``, and the losses must agree.

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
# difference: the kernel's atomics sum duplicate rows in a run-dependent
# order, the plain version in index order
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
        # sum of up to 2**13 of them is exact in f32, so the atomics'
        # run-dependent order cannot move the result and the comparison
        # checks indexing and arithmetic alone
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
    ]
    max_err = 0.0
    for name, idx, v, vb, width in cases:
        out = D.densify_kernel(idx, v, (vb, width))
        torch.cuda.synchronize()
        ref = D.densify_plain(idx, v, (vb, width))
        if out.dtype != v.dtype or tuple(out.shape) != (vb, width):
            fail(f"densify {name}: got {out.dtype} {tuple(out.shape)}")
        tol = F32_TOL if v.dtype == torch.float32 else BF16_TOL
        err = (out.float() - ref.float()).abs().max().item()
        if not torch.allclose(out.float(), ref.float(), **tol):
            fail(f"densify {name}: kernel disagrees with plain version "
                 f"(max abs err {err})")
        max_err = max(max_err, err)
        print(json.dumps({"phase": "kernel", "kernel": "densify",
                          "case": name, "n": int(idx.numel()),
                          "vocab": vb, "d": width,
                          "dtype": str(v.dtype).split(".")[-1],
                          "max_abs_err": err, "tol": tol}))

    _, idx, v, vb, width = cases[0]
    n = idx.numel()
    itemsize = v.element_size()
    nbytes = vb * width * itemsize + n * width * itemsize + 4 * n
    bound_ms = max(nbytes / HBM_BYTES_PER_S, n * width / F32_FLOPS) * 1e3
    idx64, v32 = idx.long(), v.float()
    ms = plain_ms = library_ms = None
    for order in ("kernel", "plain", "plain", "kernel"):
        if order == "kernel":
            t = cuda_ms(lambda: D.densify_kernel(idx, v, (vb, width)), 50)
            ms = t if ms is None else min(ms, t)
        else:
            t = cuda_ms(lambda: D.densify_plain(idx, v, (vb, width)), 20)
            plain_ms = t if plain_ms is None else min(plain_ms, t)
    library_ms = cuda_ms(
        lambda: torch.zeros((vb, width), dtype=torch.float32,
                            device=dev).index_add_(0, idx64, v32), 50)
    timing = {"phase": "kernel_timing", "kernel": "densify",
              "shape": {"n": n, "vocab": vb, "d": width, "dtype": "bf16"},
              "kernel_ms": ms, "plain_ms": plain_ms,
              "library_ms": library_ms,
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
    """The reduced config in f32 trains the same on the card (kernels)
    and on the CPU (plain versions, held against the JAX package by the
    test suite), with the identity wire and with int8 + error feedback.
    Tolerance rel 1e-4: the two devices sum in other orders, so an int8
    rounding may flip in a few elements of the second step's wire."""
    base = ["--reduced", "--dist", "horovod", "--grad-accum",
            "dense_reduce", "--batch-per-worker", "4", "--seq-len", "32",
            "--steps", "2", "--log-every", "1"]
    quiet = lambda s: None
    for codec in (["--codec", "identity"],
                  ["--codec", "int8", "--error-feedback"]):
        args = base + codec
        card = train.run(args + ["--device", "cuda"], log=quiet)["history"]
        cpu = train.run(args + ["--device", "cpu"], log=quiet)["history"]
        lc, lh = [h["loss"] for h in card], [h["loss"] for h in cpu]
        if len(lc) != 2 or not all(math.isclose(x, y, rel_tol=1e-4)
                                   for x, y in zip(lc, lh)):
            fail(f"small reference {codec}: card losses {lc} vs cpu {lh}")
        print(json.dumps({"phase": "small_reference", "codec": codec[1:],
                          "card_losses": lc, "cpu_losses": lh}))


def main() -> int:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a card")
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.configs import get_config
    from repro_torch.core import comm
    from repro_torch.data import make_pipeline
    from repro_torch.kernels import build, densify as D, quantize as Q
    from repro_torch.launch import train

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi)
    phase_build(build)
    tokens = make_pipeline(get_config("transformer-big"), 8, 256
                           ).batch_at(0)["tokens"]
    kern = phase_kernel(D, tokens)
    qkern = phase_quantize_kernel(Q)
    path = phase_path(train, D, comm)
    codec = phase_codec_path(train, D, Q, comm, path)
    phase_small_reference(train)
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
        "library_ms": qkern["library_ms"]}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
