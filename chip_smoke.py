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
               time the card could take; densify also on the loss-scaled
               step's f32 values (four 512-row slices concatenated), held
               bitwise against the in-order plain version and timed;
               and at the dense, vlm and seamless configs' vocabularies,
               whose per-id counts spill from shared memory to the
               workspace (vocab > 51,199): each config's 8 x 256 pipeline
               tokens at (vocab, d_model), llama3.2-1b's also in f32, and
               vocab 51,199 against 51,200, each bitwise equal to the
               plain version and across two launches; the bf16 shapes of
               llama3.2-1b (128256 x 2048), seamless-m4t-large-v2
               (256206 x 1024) and llama4-scout-17b-a16e (2048 x 5120 ->
               202048 x 5120) timed with each kernel's own device time;
               also deepseek-v2-236b's (2048 x 5120 ->
               102400 x 5120, spilled) and xlstm-125m's 2 x 256 tokens
               (512 x 768 -> 50304 x 768, counts in shared memory),
               bitwise and timed the same way;
     int8_wire_kernel — the int8 wire's fused kernels: the error-feedback
               encode (bf16 leaf and f32 residual in, q, scale and the
               residual updated in place) bitwise against
               ``quantize_ef_plain`` at every distinct stage size of the
               int8+ef plan, each with a residual a previous step left,
               and on edge cases (n = 0 and 1, ragged, a misaligned leaf
               or residual, NaN, inf, f32 input, zeros), the same encode
               on f32 leaves (the loss-scaled step's) at every stage size
               of that step's plan, the stateless
               bf16 encode at the same sizes, and the decode-sum bitwise
               against its in-order plain version for P = 1, 2 and 8;
               both timed at every stage size as device time with the L2
               flushed by a read, beside their byte bounds, the bytes
               the design moves, the plain versions and the unfused
               sequences they replaced, with each encode pass's time;
     attn_kernel — the same for flash attention: the forward path's three
               shapes (causal 1 x 32768 x 16 x 64, cross 32768 x 256,
               decode cross 8 x 1 x 256), the cases of
               tests/test_kernels.py, causal Sq > Sk, a window, mixed
               dtypes, strided and misaligned inputs, the kernel's own
               q_offset and kv_len; f32 within 3e-5, bf16 within 3e-2
               and, outside the small cases of tests/test_kernels.py,
               also against the size of its reference output
               (relative L2 1e-2, worst query row 1.5e-2, max abs 2 bf16
               ulps of max|ref|); the kernel refuses Dv != D, and
               ``ops.flash_attention(impl="kernel")`` at Dv != D (D 64 /
               Dv 32 at GQA 2, and deepseek-v2's 192 / 128) is bitwise
               ``impl="chunked"`` with no flash launch, while a Dv == D
               call launches the kernel once; timed with
               the L2 flushed, beside
               ``scaled_dot_product_attention`` as the library yardstick;
               and zamba2-7b's head dim 112: causal and window-8192
               (1 x 32768 x 32 x 112, bf16) and small f32 and bf16 cases;
               chatglm3-6b's head dim 128 with 2 kv heads (causal 1 x
               32768 x 32 x 128, GQA 16), internvl2-1b's GQA 7 (causal
               1 x 33024 x 14 x 64, 256 patches + 32768 tokens) and
               llama4-scout-17b-a16e's GQA 5 (causal 1 x 32768 x 40 x
               128 on 8 kv heads), timed beside SDPA on kv expanded to
               the query heads;
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
               full-width transformer-big in bf16: 3 steps of
               ``--dist horovod --grad-accum dense_reduce`` and 1 step of
               ``--grad-accum sparse_gather`` on a world of 1 over NCCL,
               with the kernels' launch counters reset just before and
               read just after;
  5. codec   — the same launcher with the int8 gradient wire: 3 steps of
               ``dense_reduce --codec int8 --error-feedback`` and 1 step
               of ``sparse_gather --codec int8``, counters reset before
               each run and read after: one quantize launch per schedule
               stage (under error feedback every one the fused encode),
               one decode-sum per dense stage, densify once a step, two
               allgathers per dense stage and three per gather stage, no
               allreduce;
     overlap — the same launcher, 3 steps of dense_reduce with
               ``--overlap staged`` and ``--overlap backward``, identity
               and int8+ef wires: parameters, Adam state and residuals
               bitwise equal to the fused run's, and the launches (densify
               once a step, one fused encode and one decode-sum a dense
               stage, no stateless encode, the plan's collectives) counted
               with the counters reset before each run; then
               ``make_scaled_train_step`` (``LossScaler()``, scale 2**15)
               on the same 8 x 256 batch at M = 1 (fused, staged and
               backward bitwise equal) and M = 4 (staged and backward
               bitwise equal; fused, which sums all four microbatches
               before the exchange, within ``DEFERRED_MU_TOL``; loss
               within 1e-3 of M = 1's), wire dtypes as the reference's
               (f32, bf16 only for the wait-free M = 1 step), with peak
               memory; with int8+ef a NaN in the embedding must skip the
               step (state bitwise, residuals rolled back and halved with
               the scale) and ``growth_interval=2`` must double the scale
               and every residual exactly;
     backends — the collective backends at a world of 1 over NCCL: the
               fp8 codecs' encode against the reference's bytes (an edge
               table held to jnp on the CPU, and ``fp8_reference``, a
               plain numpy rounding, on 2.5M random values in f32 and
               bf16, e4m3fn past 464 and e5m2 past 61440, ±inf, NaN
               compared as NaN); the launcher, 2 steps each:
               ``--backend ringsim`` (dense_reduce and sparse_gather),
               ``--reduce-scatter`` (identity and bf16) and
               ``--wire-dtype bf16`` bitwise against their flat runs
               (parameters and Adam state; the ring issues no collective
               at P = 1), ``--codec f8e4m3`` (its first exchange bitwise
               the fp8 cast of the identity exchange); the comm layer's
               calls against ``plan.hlo_collectives``; the hierarchical
               per-hop int8 path with ``group=(WORLD, WORLD)``: the
               first int8+ef exchange's residuals bitwise the flat
               one's and its gradients within one requantize round trip,
               3 ``make_train_step`` steps of int8+ef and 1 of int8 with
               the launches counted from the plan (per dense stage hop
               0's encode, the stateless requantize, two decode-sums);
               the requantize (stateless encode of an f32 decode-sum of
               two workers' q) bitwise against ``quantize_plain`` at
               every stage size, timed with the L2 flushed beside its
               5 B an element bound;
     zero1   — ZeRO-1 at a world of 1 over NCCL, full width, 8 x 256
               tokens, 3 launcher steps a run: ``--zero1`` (dense_reduce
               and sparse_gather) bitwise against the replicated fused
               run of the same flags (parameters, losses, Adam moments
               through the bucket layout); ``--zero1 --codec int8
               --error-feedback`` and ``--zero1 --param-codec int8``,
               whose first step through the int8 kernels is bitwise the
               same step through their plain versions (every gradient
               shard, the new params, the Zero1State, the residuals); a
               run stopped after step 2 (``--checkpoint-every 2``) and
               resumed (``--resume``) bitwise the uninterrupted int8+ef
               run; ``adamw(state_dtype="bfloat16")`` through
               ``make_train_step``, zero1 bitwise replicated.  Every
               run: densify once a step, the int8 encodes and
               decode-sums the plan implies, ``plan.hlo_collectives(1)``
               collective calls a step, and the optimizer state's bytes
               on the card equal to ``optimizer_state_bytes(plan, 1,
               state_dtype)``; each prints its step ms, device busy ms
               of one more step (CUDA-only ``torch.profiler``), training
               state bytes and ``max_memory_allocated``;
  6. prefill — full-width transformer-big (weights drawn on the card,
               init time) and its prefill step on one
               32768-token sequence with 256 encoder states:
               ``forward(attn_impl="kernel")`` and ``head`` on the last
               position, 12 kernel launches a forward, all 12 on the
               prefill kernel (counts reset just before, read just after);
               logits held against the plain chunked path at
               ``PATH_TOL``; the top device kernels of one profiled run;
  7. translate — 8 requests: ``Model.prefill`` over a 16-token prefix and
               32 greedy ``decode_step``s cross-attending 256 f32 encoder
               states through the kernel, 6 launches a step; every step's
               logits held against the plain path teacher-forced on the
               same tokens;
  8. serve   — ``ServeEngine.generate`` on 8 prompts of 64 tokens, 32 new
               tokens (no encoder states, so no launch); shape and EOS
               masking;
  9. hybrid  — full-width zamba2-7b in bf16 (weights from seed 0 drawn
               on the card by the card's generator, as every full-width
               model here; init time and memory): the prefill step on
               one 32768-token
               sequence, 81 SSD and 13 flash attention launches a forward
               (all 81 on the "sm90" SSD kernel, all 13 on the prefill
               attention kernel);
               8 requests of a 16-token prefix and 16 greedy decode steps,
               and ``ServeEngine.generate`` on 8 x 16-token prompts with
               16 new tokens (no launch in either); then the weights cast
               to f32 and the logits of the kernel path held against the
               plain path on 4096 tokens at ``PATH_TOL`` (in bf16 the
               difference is reported: 94 random residual blocks carry a
               last-bit difference to O(0.3) of the logits);
     dense_path, seamless_path — the launcher trains full-width
               llama3.2-1b (3 steps of dense_reduce, 1 of sparse_gather)
               and seamless-m4t-large-v2 (2 steps of dense_reduce) at 8 x
               256 tokens, a world of 1 over NCCL: finite losses, the
               first within 1.0 of ln(vocab), densify once a step,
               collective calls, the strategies' first losses within 1e-3;
               step ms, tok/s, device busy ms of one step, peak memory,
               optimizer-state bytes;
     dense_prefill, dense_f32, dense_serve — full-width chatglm3-6b
               (6.24 B parameters): the prefill step as ``prefill`` on
               32768 tokens, 28 "sm90" launches a forward, the timed
               run's logits against the plain chunked path over all 32768
               tokens at ``PATH_TOL``, the top device kernels; the f32
               check as the hybrid's on the first 4096 tokens;
               ``ServeEngine.generate`` as serve on 16-token prompts
               (``SHORT_PROMPT``, as ``mla_serve`` and ``xlstm_serve``);
     vlm_prefill, vlm_f32, vlm_embeds — full-width internvl2-1b: the
               same prefill step and f32 check over 256 patch embeddings
               and 32768 tokens (24 "sm90" launches at 33024 rows), then
               ``prefill(embeds=, tokens=)`` on 2 requests of 256 patches
               and 16 tokens, its last logits against the forward's at
               ``PATH_TOL`` (in f32; the bf16 difference is reported beside
               the one between the forward's two bf16 paths);
     moe_init, moe_prefill, moe_decode, moe_serve, moe_f32 —
               llama4-scout-17b-a16e at full width (d 5120, 40/8 heads of
               128, 16 experts of 8192 top-1 and one shared, vocab 202048
               untied), depth cut to 2: 6,473,180,160 parameters drawn on
               the card; the prefill step on 32768 tokens (2 "sm90"
               launches, grouped capacity MoE), logits against the plain
               path at ``PATH_TOL`` with the share of tokens whose expert
               differs between the paths; 8 requests of a 16-token
               prefill and 16 greedy steps under ``moe_mode="dropless"``,
               the same steps under ``"capacity"`` (cap = t = 8: nothing
               drops) held to them at ``PATH_TOL``, ms a step and idle
               share; ``ServeEngine.generate`` as serve; the f32 check on
               4096 tokens;
     moe_path — the launcher trains the reduced scout (``--reduced``: 4
               experts, f32) on the card, 3 steps of dense_reduce and 1
               of sparse_gather: the path phase's checks, and the
               router's aux loss above 0 in every step;
 10. small   — the reduced transformer-big and zamba2-7b in f32 train 2
               steps each on the card and on the CPU, with the identity
               wire and with ``--codec int8 --error-feedback``, and the
               losses must agree; the reduced transformer-big takes one
               loss-scaled step of 4 microbatches with
               ``overlap="backward"`` on each device, losses within 1e-5;
               ``small_backends``: 2 steps card vs CPU with
               ``--backend ringsim``, ``--reduce-scatter`` and the
               hierarchical int8+ef path (``group=(WORLD, WORLD)``);
               ``small_zero1``: 2 steps card vs CPU with ``--zero1
               --codec int8 --error-feedback`` and ``--zero1
               --param-codec int8``;
               then its prefill step and 4 translate steps on the card (the
               kernel's f32 path) and the CPU, logits within 3e-5; the
               reduced zamba2 the same (forward, 4-token prefix, 4 decode
               steps); ``small_dense``: the reduced llama3.2-1b,
               chatglm3-6b (non-zero q/k/v biases) and internvl2-1b the
               same (its prefill through the 16 patches first);
               ``small_moe``: the reduced scout the same (forward and its
               aux loss, a 4-token prefill, two dropless and two
               capacity decode steps).  Every card run held against a
               CPU run starts from the CPU's draws copied to the card
               (``host_weights``, ``host_drawn_init``): the card's
               generator draws other numbers from the same seed.
 11. mla     — deepseek-v2-236b (d 5120, 128 heads with MLA: kv_lora 512,
               q·k head dim 128 + 64 = 192, v 128; 160 experts of 1536
               top-6 and two shared; vocab 102400 untied) at full width,
               depth cut to 2 (9,153,243,136 parameters) drawn on the
               card (``mla_init``); ``mla_prefill``: the prefill step on
               32768 tokens, where Dv != D takes the chunked route (no
               flash launch), timed with peak memory and the top device
               kernels, and "kernel" bitwise "chunked" on 4096 tokens;
               ``mla_decode``: 8 requests, the absorbed decode against
               the naive one (``naive_mla``), teacher-forced, at
               ``PATH_TOL`` on requests whose top-6 experts agree;
               ``mla_serve``; ``mla_wide_f32``: the reduced widths with
               the full MLA config, card against CPU in f32 (forward on 2
               x 256 tokens, 8 absorbed and 8 naive decode steps);
               ``mla_path``: the reduced config through the launcher (3
               steps of dense_reduce, 1 of sparse_gather; aux > 0);
               ``small_mla``: the reduced config card against CPU, its
               forward's flash attention at D = 32 on "simt";
 12. xlstm   — xlstm-125m (12 blocks, every 4th from the second sLSTM, d
               768, 4 heads; tied 50304-row embedding) at full width
               (220,493,664 parameters): ``xlstm_prefill`` on 2048 tokens
               in bf16 with its relative L2 against f32; ``xlstm_decode``
               (8 requests, 16 greedy steps; f32 decode against the f32
               forward at 2e-4); ``xlstm_serve``; ``xlstm_f32`` (card
               against CPU, 256 tokens); ``xlstm_path`` (the launcher at
               2 x 256 tokens a step, 2 steps of dense_reduce and 1 of
               sparse_gather, densify once a step at 50304 x 768); and
               ``small_xlstm`` (reduced, card against CPU, forward,
               decode and 2 launcher steps).
 13. serving — llama3.2-1b at full width in bf16 (1,235,814,400
               parameters drawn on the card) behind ``ContinuousBatcher``:
               8 slots of 1024 tokens on a pool of 96 blocks of 16 (the
               dense cache is 512), chunked prefill of 64, 24 requests of
               16-512 prompt tokens and 32 new at priorities 0 and 5, all
               submitted before the first step: every request completes,
               the pool runs dry and preempts, and after the 8th
               completion an int8 hot swap (seed 1's weights) streams one
               plan bucket a step, the live params untouched until one
               version flip within n_buckets + 2 steps, then bitwise the
               one-shot ``plan.broadcast``; the stateless quantize kernel
               launches once a bucket (counters reset at the swap's start
               and read at the flip), each launch bitwise
               ``quantize_plain`` on its input, none of them plain; the
               encodes of a swap timed as device time beside their byte
               bound; a swap back at ``fusion_threshold`` = 128 MiB (f32
               packs of several leaves) with the same launch checks;
               steps, utilisation, ttft and tpot, wall ms a step, device
               busy and idle share of one mixed step, ``gather_view`` and
               ``writeback`` against ``decode_step`` in device ms, peak
               memory; ``serving_f32``: the same model in f32, 8 prompts
               of 16 tokens through the batcher and through one
               ``ServeEngine.generate``, the emitted tokens' logits within
               ``SERVE_F32_TOL``; ``small_serving``: the reduced
               llama3.2-1b, deepseek-v2-236b, zamba2-7b and xlstm-125m
               batchers on the card against the CPU and against
               ``ServeEngine``, and a tiny pool that preempts.
 14. telemetry — the launcher on full-width transformer-big with
               ``--codec int8 --error-feedback --metrics-jsonl
               --trace-dir`` (3 steps, a world of 1 over NCCL, files under
               ``build/telemetry``): 3 ``step`` rows, the ``history``
               rows and a trailing ``summary`` in the JSONL; the trace's
               stages equal ``plan.stage_names()``, each with the four
               phase slices (``dur >= 0``), and ``wire_exact`` (0 bytes at
               a world of 1); densify, quantize and the collectives
               counted over the 3 steps and the capture's 3 (the
               ``measure_wire`` run, the warm-up and the timed step).
               Then, from one copied state, one untraced step and one
               ``StepTracer.capture`` step (no warm-up): parameters, Adam
               state and residuals bitwise equal, the same kernels name by
               name and count by count under ``torch.profiler`` (the
               stage names' ``record_function`` ranges set aside), densify
               1 and quantize 16 + 16 launches each; each stage's phase
               us, the trace's step us beside the untraced step's wall ms
               and device busy ms, and the traced minus untraced wall
               (medians of 5 steps each, in turns).

The last two lines of standard output are the ``kernels`` JSON line and
``{"ok": true, "device": {...}}``.  Needs one card, the CUDA toolkit and
nothing from the network.
"""
from __future__ import annotations

import contextlib
import json
import math
import os
import shutil
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


def device_ms_cold(fn, iters: int, warmup: int = 1) -> float:
    """Device time of one ``fn()`` (its kernels, memsets and copies, not
    the host's gaps between them) with the 50 MB L2 flushed before each
    call by a 64 MB read, which leaves no dirty line to write back; the
    flush's own device time, profiled alone, is taken off."""
    from torch.profiler import ProfilerActivity, profile
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")

    def per_call(g):
        for _ in range(warmup):
            g()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                g()
            torch.cuda.synchronize()
        return sum(e.device_time_total
                   for e in prof.key_averages()) / iters / 1e3
    alone = per_call(flush.max)
    return per_call(lambda: (flush.max(), fn())) - alone


def kernel_device_ms(fn, iters: int = 10) -> dict:
    """Device time a call of each kernel ``fn()`` runs, by kernel name,
    with the L2 flushed by a 64 MB read before each call (the flush's
    own kernel left out)."""
    from torch.profiler import ProfilerActivity, profile
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            flush.max()
            fn()
        torch.cuda.synchronize()
    return {e.key: e.device_time_total / iters / 1e3
            for e in prof.key_averages()
            if e.device_time_total > 0 and "reduce_kernel" not in e.key}


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
        # the loss-scaled step's input: four microbatches' 512-row slices
        # of f32 rows (bf16 cotangents promoted by the f32 loss scale,
        # 2**15 / 4), concatenated; inexact sums, so held bitwise against
        # the in-order plain version on the CPU
        ("loss_scaled_f32", tok,
         torch.cat([(torch.randn((512, d), device=dev, generator=gen)
                     * 1e-4).to(torch.bfloat16).float() * 2.0 ** 13
                    for _ in range(4)]), vocab, d),
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
        if name == "loss_scaled_f32" and not torch.equal(out.cpu(), cpu):
            fail(f"densify {name}: kernel differs from the in-order plain "
                 f"version on the CPU")
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

    timing = densify_timing(D, *cases[0][1:])
    f32 = densify_timing(D, *next(c for c in cases
                                  if c[0] == "loss_scaled_f32")[1:])
    timing["f32"] = {k: f32[k] for k in (
        "shape", "kernel_ms", "plain_ms", "library_ms", "back_to_back_ms",
        "bound_ms", "bound_by", "bound_bytes")}
    print(json.dumps(timing))
    vocabs = densify_vocab_cases(D, vals)
    return {"max_abs_err": max(max_err, vocabs.pop("max_abs_err")),
            **timing, "vocabs": vocabs}


# the configs whose training step densifies the tied or untied embedding
# at vocabularies whose per-id counts do not fit group_rows's shared
# memory (vocab + 1 ints over 200 KiB: vocab > 51,199), and whether the
# bf16 case is timed
VOCAB_CONFIGS = (("llama3.2-1b", True), ("seamless-m4t-large-v2", True),
                 ("chatglm3-6b", False), ("qwen2.5-32b", False),
                 ("deepseek-7b", False), ("internvl2-1b", False),
                 ("llama4-scout-17b-a16e", True), ("deepseek-v2-236b", True),
                 ("xlstm-125m", True))
# a worker's batch (x 256 tokens) where it is not 8: the one the config's
# launcher phase trains with (xlstm-125m's recurrence keeps a (B, 4, 384,
# 384) f32 state a step and layer for the backward)
VOCAB_BATCH = {"xlstm-125m": 2}
SMEM_VOCAB_LIMIT = 51199           # (51199 + 1) * 4 B = 200 KiB


def densify_vocab_cases(D, vals) -> dict:
    """densify at the new configs' vocabularies, each case bitwise equal
    to ``densify_plain`` on the card (exact values: every sum is exact,
    so any order gives the same bits) and across two launches: each
    config's (8 x 256 tokens of its pipeline, or ``VOCAB_BATCH``'s, x
    d_model) at its vocabulary, llama3.2-1b's also on f32 values, and
    vocab 51,199 (counts in shared memory) against 51,200 (spilled) at d
    1024.  The bf16 training shapes of llama3.2-1b, seamless-m4t-large-v2,
    llama4-scout-17b-a16e (2048 x 5120 -> 202048 x 5120), deepseek-v2-236b
    (2048 x 5120 -> 102400 x 5120, spilled) and xlstm-125m (512 x 768 ->
    50304 x 768, in shared memory) are timed as device time beside
    ``index_add_`` and the byte bound, with each of the three kernels'
    own device time."""
    from repro_torch.configs import get_config
    from repro_torch.data import make_pipeline
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(3)
    cases = []
    for arch, timed in VOCAB_CONFIGS:
        cfg = get_config(arch)
        tok = torch.from_numpy(make_pipeline(
            cfg, VOCAB_BATCH.get(arch, 8), 256).batch_at(0)[
            "tokens"].reshape(-1)).to(dev)
        cases.append((f"{arch}_bf16", tok, vals(tok.numel(), torch.bfloat16,
                                                cfg.d_model),
                      cfg.vocab, cfg.d_model, timed))
        if arch == "llama3.2-1b":
            cases.append((f"{arch}_f32", tok, vals(tok.numel(), torch.float32,
                                                   cfg.d_model),
                          cfg.vocab, cfg.d_model, False))
    for vocab in (SMEM_VOCAB_LIMIT, SMEM_VOCAB_LIMIT + 1):
        ids = torch.cat([torch.randint(0, vocab, (2047,), dtype=torch.int32,
                                       device=dev, generator=gen),
                         torch.tensor([vocab - 1], dtype=torch.int32,
                                      device=dev)])
        cases.append((f"vocab_{vocab}_bf16", ids,
                      vals(2048, torch.bfloat16, 1024), vocab, 1024, False))
    out = {"max_abs_err": 0.0}
    for name, idx, v, vb, width, timed in cases:
        got = D.densify_kernel(idx, v, (vb, width))
        again = D.densify_kernel(idx, v, (vb, width))
        torch.cuda.synchronize()
        ref = D.densify_plain(idx, v, (vb, width))
        if got.dtype != v.dtype or tuple(got.shape) != (vb, width):
            fail(f"densify {name}: got {got.dtype} {tuple(got.shape)}")
        if not torch.equal(got, again):
            fail(f"densify {name}: two launches on the same inputs differ")
        err = (got.float() - ref.float()).abs().max().item()
        if not torch.equal(got, ref):
            fail(f"densify {name}: kernel differs from the plain version "
                 f"(max abs err {err})")
        line = {"phase": "kernel", "kernel": "densify", "case": name,
                "n": int(idx.numel()), "vocab": vb, "d": width,
                "dtype": str(v.dtype).split(".")[-1],
                "counts": ("shared memory" if vb <= SMEM_VOCAB_LIMIT
                           else "spilled to the workspace"),
                "max_abs_err": err, "bitwise_vs_plain": True,
                "bitwise_across_launches": True}
        del got, again, ref
        if timed:
            t = densify_timing(D, idx, v, vb, width)
            t["kernels_device_ms_l2_flushed"] = kernel_device_ms(
                lambda: D.densify_kernel(idx, v, (vb, width)))
            group = [ms for k, ms in t["kernels_device_ms_l2_flushed"].items()
                     if "group_rows" in k]
            if len(group) != 1:
                fail(f"densify {name}: the profiler shows no one group_rows "
                     f"kernel: {t['kernels_device_ms_l2_flushed']}")
            t["group_rows_ms"] = group[0]
            line["timing"] = t
            out[name] = t
        print(json.dumps(line))
        torch.cuda.empty_cache()
    return out


def densify_timing(D, idx, v, vb, width) -> dict:
    """Device time of a densify call (kernel, plain version, the
    library's ``index_add_``) beside its byte bound."""
    dev = idx.device
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
    return {"phase": "kernel_timing", "kernel": "densify",
            "shape": {"n": n, "vocab": vb, "d": width,
                      "dtype": str(v.dtype).split(".")[-1]},
            "kernel_ms": ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "measure": "device time a call",
            "back_to_back_ms": events_t,
            "library_call": "torch.zeros(vocab, d, float32).index_add_",
            "bound_ms": bound_ms, "bound_by": "bytes",
            "bound_bytes": nbytes}


FULL_WIDTH = ["--arch", "transformer-big", "--dist", "horovod",
              "--batch-per-worker", "8", "--seq-len", "256",
              "--log-every", "1", "--device", "cuda"]


def full_width(arch):
    """``FULL_WIDTH``'s launcher flags (8 x 256 tokens a worker, a world
    of 1 over NCCL) with ``arch`` in place of transformer-big."""
    return [arch if a == "transformer-big" else a for a in FULL_WIDTH]


def phase_path(train, D, comm, arch, runs, tag, extra=(),
               profiled=True) -> dict:
    """The launcher trains full-width ``arch`` (or as ``extra`` flags
    say: ``--reduced``) for each (grad_accum, steps) of ``runs``
    (identity wire), the counts reset just before a run and read just
    after: finite losses, a first-step loss within 1.0 of ln(vocab)
    (random weights), the router's aux loss above 0 in every step where
    the config has experts, densify launched once a step,
    collective calls above 0 and, with both strategies, first-step
    losses within 1e-3 relative (same weights, same batch: the loss
    precedes the exchange).  Each run prints its step ms, tok/s, the
    device busy ms and top kernels of one more step under a CUDA-only
    ``torch.profiler`` (unless ``profiled`` is False: a step of eager
    recurrences is tens of thousands of kernels to record), peak
    memory (init included) and the optimizer
    state's bytes, held equal to ``optimizer_state_bytes`` of the
    launcher's plan.  Returns the densify launches, the first-step
    losses and the median step ms of each strategy."""
    import torch.distributed as dist
    from repro_torch.checkpoint.checkpoint import nbytes
    from repro_torch.configs import get_config
    from repro_torch.optim import zero1 as z1
    cfg = get_config(arch)
    if "--reduced" in extra:
        cfg = cfg.reduced()
    vocab = cfg.vocab
    created = _world_of_one(train)
    launches, first_loss, median_ms, lines = 0, {}, {}, {}
    try:
        for accum, steps in runs:
            argv = full_width(arch) + list(extra) + [
                "--grad-accum", accum, "--steps", str(steps)]
            plan, plan_args = exchange_plan(train, argv), \
                train.parse_args(argv)
            collective = ("all_reduce_dense" if accum == "dense_reduce"
                          else "all_gather_dense")
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            D.densify_kernel.launches = 0
            comm.reset_calls()
            t0 = time.perf_counter()
            result = train.run(argv, log=lambda s: None)
            torch.cuda.synchronize()
            run_s = time.perf_counter() - t0
            got, calls = D.densify_kernel.launches, comm.calls()
            peak = torch.cuda.max_memory_allocated()
            hist = result["history"]
            losses = [h["loss"] for h in hist]
            what = f"{tag} {arch} {accum}"
            if len(losses) != steps or not all(map(math.isfinite, losses)):
                fail(f"{what}: losses {losses}")
            if got != steps:
                fail(f"{what}: densify launched {got} times in {steps} steps "
                     f"(want one per step)")
            if calls[collective] == 0:
                fail(f"{what}: no {collective} through torch.distributed")
            if abs(losses[0] - math.log(vocab)) > 1.0:
                fail(f"{what}: first-step loss {losses[0]} far from "
                     f"ln({vocab}) = {math.log(vocab)}")
            aux = [h["aux"] for h in hist]
            if cfg.moe is not None and not all(a > 0 for a in aux):
                fail(f"{what}: router aux losses {aux} (want all > 0)")
            state_b = nbytes(result["opt_state"])
            if state_b != z1.optimizer_state_bytes(plan, 1):
                fail(f"{what}: the optimizer state holds {state_b} B, "
                     f"optimizer_state_bytes says "
                     f"{z1.optimizer_state_bytes(plan, 1)} B")
            first_loss[accum] = losses[0]
            launches += got
            steady = [h["step_ms"] for h in hist[1:]] or [hist[0]["step_ms"]]
            median_ms[accum] = statistics.median(steady)
            line = {"phase": tag, "arch": cfg.name,
                    "grad_accum": accum, "codec": "identity",
                    "steps": steps, "tokens_per_step":
                        plan_args.batch_per_worker * plan_args.seq_len,
                    "losses": losses, "aux": aux,
                    "ln_vocab": math.log(vocab),
                    "densify_launches": got, "collective_calls": calls,
                    "step_ms_first": hist[0]["step_ms"],
                    "step_ms_median_after_first": median_ms[accum],
                    "tok_per_s": hist[-1]["tok_per_s"],
                    "one_step_profiled": (step_profile(train, argv, result)
                                          if profiled else None),
                    "max_memory_allocated": peak,
                    "optimizer_state_bytes": state_b,
                    "training_state_bytes": nbytes(
                        (result["params"], result["opt_state"],
                         result["exchange_state"])),
                    "run_s_with_init": run_s}
            print(json.dumps(line))
            lines[accum] = line
            del result
            torch.cuda.empty_cache()
    finally:
        if created:
            dist.destroy_process_group()
    if len(first_loss) == 2:
        a, b = first_loss["dense_reduce"], first_loss["sparse_gather"]
        if abs(a - b) > 1e-3 * abs(a):
            fail(f"{tag} {arch}: first-step loss differs between strategies "
                 f"{a} {b}")
    return {"densify_launches": launches, "first_loss": first_loss,
            "step_ms_median": median_ms, "runs": lines}


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


def bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Bitwise equality of two f32 tensors, except that any NaN equals
    any NaN (the card's NaN payloads are its own)."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    same = (a.view(torch.int32) == b.view(torch.int32)) \
        | (a.isnan() & b.isnan())
    return bool(same.all().item())


def int8_ef_stage_sizes(train, scaled: bool = False) -> dict:
    """{elements: stages} of the int8+ef dense_reduce plan's dense
    stages, each a single-slot bucket of a bf16 leaf; with ``scaled``,
    the plan of the loss-scaled step's tree (the f32 loss scale promotes
    every contribution, so every leaf is f32)."""
    plan = exchange_plan(train, FULL_WIDTH + [
        "--grad-accum", "dense_reduce", "--codec", "int8",
        "--error-feedback"], scaled=scaled)
    want = "float32" if scaled else "bfloat16"
    sizes = {}
    for st in plan.schedule.stages:
        bucket = plan.dense_buckets[st.bucket_id]
        if st.kind != "dense" or len(bucket.slots) != 1 or plan.leaf_specs[
                plan.dense_leaf_ids[bucket.slots[0].leaf_idx]].dtype \
                != want:
            fail(f"int8+ef plan: stage {st} is not a single-slot bucket "
                 f"of a {want} leaf")
        sizes[bucket.n_elems] = sizes.get(bucket.n_elems, 0) + 1
    return dict(sorted(sizes.items(), reverse=True))


def phase_int8_wire_kernel(Q, train) -> dict:
    """The int8 wire's fused kernels: the error-feedback encode bitwise
    against ``quantize_ef_plain`` (q, scale and residual) at every
    distinct stage size of the int8+ef plan (bf16 leaves, a residual
    left by a previous step) and on edge cases; the decode-sum bitwise
    against its in-order plain version for P = 1, 2 and 8; then both
    timed at every stage size with the L2 flushed, beside their byte
    bounds, the bytes the design moves, the plain versions and the
    unfused sequence the encode replaced (cast, add, encode, decode,
    subtract)."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(2)
    f32, bf16 = torch.float32, torch.bfloat16

    def normal(n, dt=bf16, scale=1e-3):
        return (torch.randn(n, device=dev, generator=gen) * scale).to(dt)

    def scaled_leaf(n):
        return normal(n).float() * 2.0 ** 15

    def previous_residual(n, dt):
        # the residual one step of the plain version leaves behind
        r = torch.zeros(n, device=dev)
        Q.quantize_ef_plain(normal(n, dt), r)
        return r

    def clone_at(t):
        # a copy at the same offset from a 16-byte boundary
        off = (t.data_ptr() % 16) // t.element_size()
        c = torch.empty(t.numel() + off, dtype=t.dtype, device=dev)[off:]
        return c.copy_(t)

    def check_ef(name, x, r):
        rk, rp = clone_at(r), clone_at(r)
        q, s = Q.quantize_ef_kernel(x, rk)
        torch.cuda.synchronize()
        q0, s0 = Q.quantize_ef_plain(x, rp)
        if not (torch.equal(q, q0) and bits_equal(s, s0)
                and bits_equal(rk, rp)):
            dq = ((q.int() - q0.int()).abs().max().item() if q.numel()
                  else 0)
            fail(f"int8+ef encode {name}: kernel differs from the plain "
                 f"version (max |dq| {dq}, scale {s.item()!r} vs "
                 f"{s0.item()!r}, residual bitwise {bits_equal(rk, rp)})")
        print(json.dumps({"phase": "kernel", "kernel": "quantize_ef",
                          "case": name, "n": x.numel(),
                          "dtype": str(x.dtype).split(".")[-1],
                          "scale": s.item(), "bitwise": True,
                          "tol": "bitwise (q, scale, residual)"}))

    sizes = int8_ef_stage_sizes(train)
    for n in sizes:
        check_ef(f"stage_{n}", normal(n), previous_residual(n, bf16))
    # the loss-scaled step's leaves: f32 (bf16 cotangents times 2**15)
    scaled_sizes = int8_ef_stage_sizes(train, scaled=True)
    if scaled_sizes != sizes:
        fail(f"int8+ef: the loss-scaled plan's stages {scaled_sizes} are "
             f"not the plan's {sizes}")
    for n in scaled_sizes:
        check_ef(f"stage_{n}_f32", scaled_leaf(n), previous_residual(n, f32))

    def poisoned(dt, values):
        x = normal(4099, dt)
        x[[3, 2050]] = torch.tensor(values, device=dev).to(dt)
        return x
    edge = [
        ("n0", normal(0), torch.zeros(0, device=dev)),
        ("n1", normal(1), previous_residual(1, bf16)),
        ("ragged", normal(1001), previous_residual(1001, bf16)),
        ("misaligned_leaf", normal(4100)[1:], previous_residual(4099, bf16)),
        ("misaligned_residual", normal(4099),
         previous_residual(4100, bf16)[1:]),
        ("nan", poisoned(bf16, [float("nan"), 1.0]),
         previous_residual(4099, bf16)),
        ("inf", poisoned(bf16, [-math.inf, 1.0]),
         previous_residual(4099, bf16)),
        ("nan_f32", poisoned(f32, [float("nan"), -math.inf]),
         previous_residual(4099, f32)),
        ("f32_main", normal(34516992, f32),
         previous_residual(34516992, f32)),
        ("zeros", torch.zeros(4096, device=dev, dtype=bf16),
         torch.zeros(4096, device=dev)),
    ]
    for name, x, r in edge:
        check_ef(name, x, r)
    # the stateless bf16 encode (int8 without error feedback)
    for n in sizes:
        x = normal(n)
        q, s = Q.quantize_kernel(x)
        torch.cuda.synchronize()
        q0, s0 = Q.quantize_plain(x)
        if not (torch.equal(q, q0) and bits_equal(s, s0)):
            fail(f"int8 encode stateless_bf16_{n}: kernel differs from "
                 f"the plain version")
        print(json.dumps({"phase": "kernel", "kernel": "quantize",
                          "case": f"stateless_bf16_{n}", "n": n,
                          "dtype": "bfloat16", "bitwise": True,
                          "tol": "bitwise"}))

    main_n = max(sizes)
    gathered = {}
    for p, n in ((1, main_n), (2, main_n), (8, main_n), (3, 1001),
                 (2, 1)):
        g = torch.randint(-127, 128, (p * n,), device=dev,
                          dtype=torch.int8, generator=gen)
        sc = torch.rand(p, device=dev, generator=gen) * 1e-4
        out = Q.decode_sum_kernel(g, sc, p)
        torch.cuda.synchronize()
        want = Q.decode_sum_plain(g, sc, p)
        if not bits_equal(out, want):
            err = (out - want).abs().max().item()
            fail(f"int8 decode-sum P={p} n={n}: kernel differs from the "
                 f"in-order plain version (max abs {err})")
        if n == main_n:
            gathered[p] = (g, sc)
        print(json.dumps({"phase": "kernel", "kernel": "int8_decode_sum",
                          "case": f"P{p}_n{n}", "bitwise": True,
                          "tol": "bitwise against the in-order sum"}))

    def encode_bound(n):
        return (11 * n + 4) / HBM_BYTES_PER_S * 1e3

    per_stage = []
    for n, count in sizes.items():
        x, r = normal(n), previous_residual(n, bf16)
        iters = 10 if n > 1 << 20 else 50
        enc = device_ms_cold(lambda: Q.quantize_ef_kernel(x, r), iters)
        x32, r32 = scaled_leaf(n), previous_residual(n, f32)
        enc32 = device_ms_cold(lambda: Q.quantize_ef_kernel(x32, r32), iters)
        plain32 = device_ms_cold(lambda: Q.quantize_ef_plain(x32, r32),
                                 min(iters, 10))
        g = torch.randint(-127, 128, (n,), device=dev, dtype=torch.int8,
                          generator=gen)
        sc = torch.rand(1, device=dev, generator=gen)
        dec = device_ms_cold(lambda: Q.decode_sum_kernel(g, sc, 1), iters)
        per_stage.append({
            "n": n, "stages": count, "encode_ms": enc,
            "encode_bound_ms": encode_bound(n),
            "encode_bound_bytes": 11 * n + 4,
            "encode_moves_bytes": 17 * n + 4,
            # f32 leaf (the loss-scaled step): 4 B of x, 8 B of residual
            # read and written, 1 B of q
            "encode_f32_ms": enc32, "encode_f32_plain_ms": plain32,
            "encode_f32_bound_ms": (13 * n + 4) / HBM_BYTES_PER_S * 1e3,
            "encode_f32_bound_bytes": 13 * n + 4,
            "encode_f32_moves_bytes": 21 * n + 4,
            "decode_sum_ms": dec,
            "decode_sum_bound_ms": (5 * n + 4) / HBM_BYTES_PER_S * 1e3,
            "decode_sum_bound_bytes": 5 * n + 4})
    step = {
        "encode_ms": sum(s["stages"] * s["encode_ms"] for s in per_stage),
        "encode_bound_ms": sum(s["stages"] * s["encode_bound_ms"]
                               for s in per_stage),
        "encode_f32_ms": sum(s["stages"] * s["encode_f32_ms"]
                             for s in per_stage),
        "encode_f32_bound_ms": sum(s["stages"] * s["encode_f32_bound_ms"]
                                   for s in per_stage),
        "decode_sum_ms": sum(s["stages"] * s["decode_sum_ms"]
                             for s in per_stage),
        "decode_sum_bound_ms": sum(s["stages"] * s["decode_sum_bound_ms"]
                                   for s in per_stage),
        "elements": sum(n * c for n, c in sizes.items())}

    # the main stage: kernel, plain version and the unfused sequence
    x, r = normal(main_n), previous_residual(main_n, bf16)

    def unfused():
        c = r.add_(x.to(f32))
        q, s = Q.quantize_kernel(c)
        r.sub_(q.to(f32) * s)
    best = {}
    for order in ("kernel", "plain", "unfused", "unfused", "plain",
                  "kernel"):
        fn = {"kernel": lambda: Q.quantize_ef_kernel(x, r),
              "plain": lambda: Q.quantize_ef_plain(x, r),
              "unfused": unfused}[order]
        t = device_ms_cold(fn, 10)
        best[order] = min(best.get(order, t), t)
    passes = {next((k for k in ("absmax_kernel", "encode_kernel")
                    if k in name), name[:60]): ms for name, ms in
              kernel_device_ms(lambda: Q.quantize_ef_kernel(x, r)).items()}
    decode = {}
    for p, (g, sc) in gathered.items():
        nbytes = (p + 4) * main_n + 4 * p
        decode[p] = {
            "kernel_ms": device_ms_cold(
                lambda: Q.decode_sum_kernel(g, sc, p), 10),
            "plain_ms": device_ms_cold(
                lambda: Q.decode_sum_plain(g, sc, p), 5),
            # the eager decode and sum(dim=0) that the kernel replaced
            "unfused_ms": device_ms_cold(
                lambda: (g.reshape(p, -1).to(f32)
                         * sc.reshape(p, 1)).sum(dim=0), 5),
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
            "bound_by": "bytes", "bound_bytes": nbytes,
            "library_ms": None}
    timing = {"phase": "kernel_timing", "kernel": "quantize_ef",
              "shape": {"n": main_n, "dtype": "bfloat16",
                        "residual": "float32"},
              "kernel_ms": best["kernel"], "plain_ms": best["plain"],
              "unfused_ms": best["unfused"], "library_ms": None,
              "bound_ms": encode_bound(main_n), "bound_by": "bytes",
              "bound_bytes": 11 * main_n + 4,
              "kernel_moves_bytes": 17 * main_n + 4,
              "pass_device_ms": passes,
              "decode_sum": decode, "per_stage": per_stage,
              "per_step": step,
              "timing": "device time a call, L2 flushed by a read before "
                        "each call"}
    print(json.dumps(timing))
    return timing


def exchange_plan(train, argv, scaled: bool = False):
    """The launcher's ExchangePlan for one worker's gradient tree (built
    on meta tensors, as the launcher builds its codec state); with
    ``scaled``, for that tree times an f32 loss scale (the loss-scaled
    step's exchange)."""
    from repro_torch.configs import get_config
    from repro_torch.data import make_pipeline
    from repro_torch.models import build_model
    from repro_torch.training.microbatch import _scale_grad_tree
    args = train.parse_args(argv)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    model = build_model(cfg)
    pipe = make_pipeline(cfg, args.batch_per_worker, args.seq_len,
                         seed=args.seed)
    grads = train.meta_worker_grads(args, model, pipe, True)
    if scaled:
        grads = _scale_grad_tree(grads, torch.ones((), device="meta"))
    return train.build_optimizer(args, cfg, None).plan(grads)


def phase_codec_path(train, D, Q, comm, path) -> dict:
    """The launcher on full-width transformer-big with the int8 wire;
    returns the launches of the int8 wire's kernels and densify."""
    quantize_launches = densify_launches = 0
    ef_launches = decode_sum_launches = 0
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
        Q.reset_launches()
        D.densify_kernel.launches = 0
        comm.all_gather_dense.calls = 0
        comm.all_reduce_dense.calls = 0
        result = train.run(argv)
        torch.cuda.synchronize()
        got_q, got_d = Q.quantize_kernel.launches, D.densify_kernel.launches
        got_ef = Q.quantize_ef_kernel.launches
        got_ds = Q.decode_sum_kernel.launches
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
        n_dense = len(stages) - n_gather
        ef = "--error-feedback" in extra
        # error feedback: every dense stage takes the fused encode (no
        # stateless encode between an add and a subtraction)
        if got_ef != (steps * n_dense if ef else 0):
            fail(f"{tag}: fused error-feedback encode launched {got_ef} "
                 f"times in {steps} steps of {n_dense} dense stages")
        if got_ds != steps * n_dense:
            fail(f"{tag}: decode-sum launched {got_ds} times in {steps} "
                 f"steps of {n_dense} dense stages (want one per stage)")
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
            "quantize_ef_launches": got_ef, "decode_sum_launches": got_ds,
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
        ef_launches += got_ef
        decode_sum_launches += got_ds
    return {"quantize_launches": quantize_launches,
            "quantize_ef_launches": ef_launches,
            "decode_sum_launches": decode_sum_launches,
            "densify_launches": densify_launches}

OVERLAPS = ([], ["--overlap", "staged"], ["--overlap", "backward"])
WIRES = ([], ["--codec", "int8", "--error-feedback"])


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Bitwise equality of two tensors of any dtype, except that any NaN
    equals any NaN."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if not a.is_floating_point():
        return torch.equal(a, b)
    ints = {2: torch.int16, 4: torch.int32, 8: torch.int64}[a.element_size()]
    a, b = a.reshape(-1), b.reshape(-1)
    same = (a.view(ints) == b.view(ints)) | (a.isnan() & b.isnan())
    return bool(same.all().item())


def train_state(params, opt_state, ex_state) -> list:
    """Every tensor a step leaves behind: parameters, Adam moments and
    step, error-feedback residuals."""
    from repro_torch.tree import tree_flatten
    return (tree_flatten(params)[0] + tree_flatten(opt_state.mu)[0]
            + tree_flatten(opt_state.nu)[0] + [opt_state.step]
            + [r for r in ex_state.bucket_states
               if isinstance(r, torch.Tensor)])


def differing(a: list, b: list) -> list:
    if len(a) != len(b):
        return [f"{len(a)} tensors vs {len(b)}"]
    return [i for i, (x, y) in enumerate(zip(a, b)) if not same_bits(x, y)]


def reset_counts(D, Q, comm) -> None:
    Q.reset_launches()
    D.densify_kernel.launches = 0
    comm.all_gather_dense.calls = 0
    comm.all_reduce_dense.calls = 0


def read_counts(D, Q, comm) -> dict:
    torch.cuda.synchronize()
    return {"densify": D.densify_kernel.launches,
            "quantize": Q.quantize_kernel.launches,
            "quantize_ef": Q.quantize_ef_kernel.launches,
            "decode_sum": Q.decode_sum_kernel.launches,
            "all_reduce": comm.all_reduce_dense.calls,
            "all_gather": comm.all_gather_dense.calls}


def check_counts(tag, got, plan, steps) -> None:
    """Launches a run of ``steps`` steps must make, from the plan: one
    densify a step; under int8+ef one fused encode a dense stage and one
    decode-sum a dense stage, no stateless encode; the plan's
    collectives, allreduces for a linear wire and allgathers else."""
    stages = plan.schedule.stages
    n_dense = sum(st.kind == "dense" for st in stages)
    int8 = plan.config.codec.startswith("int8")
    want = {"densify": steps,
            "quantize": steps * len(stages) if int8 else 0,
            "quantize_ef": steps * n_dense if int8 else 0,
            "decode_sum": steps * n_dense if int8 else 0,
            "all_reduce": 0 if int8 else steps * plan.n_collectives,
            "all_gather": steps * plan.n_collectives if int8 else 0}
    if got != want:
        fail(f"{tag}: launches {got}, want {want} from the plan "
             f"({len(stages)} stages, {plan.n_collectives} collectives)")


def phase_overlap(train, D, Q, comm) -> dict:
    """The overlapped exchange on full-width transformer-big, world of 1
    over NCCL: the launcher's staged and wait-free steps bitwise against
    its fused one, then the loss-scaled step with 4 microbatches (fused,
    staged, backward; bitwise), its overflow rollback and its growth
    rescale.  Returns the kernel launches the phase's runs made."""
    quiet = lambda s: None
    launches = {"densify": 0, "quantize": 0, "quantize_ef": 0,
                "decode_sum": 0}

    def add(got):
        for k in launches:
            launches[k] += got[k]

    steps = 3
    for wire in WIRES:
        argv = FULL_WIDTH + ["--grad-accum", "dense_reduce", "--steps",
                             str(steps)] + wire
        fused = None
        for ov in OVERLAPS:
            tag = f"overlap launcher {ov[1:] or ['fused']} {wire[1:2]}"
            plan = exchange_plan(train, argv + ov)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_counts(D, Q, comm)
            result = train.run(argv + ov, log=quiet)
            got = read_counts(D, Q, comm)
            check_counts(tag, got, plan, steps)
            add(got)
            losses = [h["loss"] for h in result["history"]]
            if len(losses) != steps or not all(map(math.isfinite, losses)):
                fail(f"{tag}: losses {losses}")
            state = train_state(result["params"], result["opt_state"],
                                result["exchange_state"])
            hist = result["history"]
            steady = [h["step_ms"] for h in hist[1:]]
            line = {"phase": "overlap_launcher",
                    "overlap": ov[1] if ov else "fused",
                    "codec": plan.config.codec, "steps": steps,
                    "losses": losses, "launches": got,
                    "stages": plan.schedule.n_stages,
                    "n_collectives_per_step": plan.n_collectives,
                    "step_ms_median_after_first": statistics.median(steady),
                    "max_memory_allocated":
                        torch.cuda.max_memory_allocated()}
            if fused is None:
                fused = (state, losses)
            else:
                bad = differing(state, fused[0])
                if bad or losses != fused[1]:
                    fail(f"{tag}: differs from the fused run bitwise in "
                         f"tensors {bad[:10]} of {len(state)} (losses "
                         f"{losses} vs {fused[1]})")
                line["bitwise_vs_fused"] = True
            print(json.dumps(line))
            del result, state
        del fused
        torch.cuda.empty_cache()

    scaled = phase_overlap_scaled(train, D, Q, comm)
    add(scaled["launches"])
    return {**scaled, "launches": launches}


def phase_overlap_scaled(train, D, Q, comm) -> dict:
    """``make_scaled_train_step`` at full width on the 8 x 256 batch."""
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.data import make_pipeline
    from repro_torch.models import build_model
    from repro_torch.training import LossScaler, make_scaled_train_step
    from repro_torch.tree import tree_flatten

    device = train.resolve_device("cuda")
    _, _, created = train.init_distributed(device)
    launches = {"densify": 0, "quantize": 0, "quantize_ef": 0,
                "decode_sum": 0}
    out = {}
    try:
        cfg = get_config("transformer-big")
        model = build_model(cfg)
        pipe = make_pipeline(cfg, 8, 256, seed=0)
        batch = {k: torch.from_numpy(v).to(device)
                 for k, v in pipe.batch_at(0).items()}
        # the control: the last of four microbatches from another batch
        wrong = {k: torch.cat([v[:6], torch.from_numpy(
                     pipe.batch_at(1)[k][6:]).to(device)])
                 for k, v in batch.items()}
        params = model.init(seed=0, device=device)
        meta_args = train.parse_args(FULL_WIDTH)
        meta = train.meta_worker_grads(meta_args, model, pipe, True)

        def build(wire, ov, scaler, n):
            argv = FULL_WIDTH + ["--grad-accum", "dense_reduce"] + wire + ov
            opt = train.build_optimizer(train.parse_args(argv), cfg,
                                        dist.group.WORLD)
            step = make_scaled_train_step(model, opt, scaler,
                                          n_microbatches=n,
                                          sparse_embedding=True)
            return opt, step

        def run(wire, ov, n, scaler=LossScaler(), start=None, b=batch):
            """One step from ``start`` (params, opt state, scaler state,
            exchange state) or from the initial state; returns the step's
            outputs, its launches and its memory: allocated before it
            (the state and this phase's kept copies) and its peak."""
            opt, step = build(wire, ov, scaler, n)
            plans = []
            plan_of = opt.plan
            opt.plan = lambda g: plans.append(plan_of(g)) or plans[-1]
            if start is None:
                start = (params, opt.init(params), scaler.init(device),
                         opt.init_exchange_state(meta, device=device))
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            reset_counts(D, Q, comm)
            t0 = time.perf_counter()
            res = step(*start, b)
            got = read_counts(D, Q, comm)
            wall = time.perf_counter() - t0
            # the plan the step exchanged through (the last one compiled:
            # the exchange state's own plan came first)
            return res, got, plans[-1], {
                "allocated_before": base,
                "peak_above_allocated_before":
                    torch.cuda.max_memory_allocated() - base,
                "max_memory_allocated": torch.cuda.max_memory_allocated(),
                "step_s": wall}

        for wire in WIRES:
            codec = "int8+ef" if wire else "identity"
            runs = {}
            for n in (1, 4):
                for ov in OVERLAPS:
                    mode = ov[1] if ov else "fused"
                    tag = f"scaled M={n} {mode} {codec}"
                    res, got, plan, mem = run(wire, ov, n)
                    check_counts(tag, got, plan, 1)
                    for k in launches:
                        launches[k] += got[k]
                    m = res[4]
                    loss = float(m["loss"])
                    if bool(m["overflow"]) or not math.isfinite(loss):
                        fail(f"{tag}: overflow {bool(m['overflow'])}, "
                             f"loss {loss}")
                    wire_dtypes = sorted({b.wire_dtype
                                          for b in plan.dense_buckets})
                    # the f32 loss scale promotes every contribution but
                    # the wait-free M = 1 step's own cotangents
                    want = ("int8" if wire else str(params["embedding"].dtype)
                            .split(".")[-1] if (n, mode) == (1, "backward")
                            else "float32")
                    if wire_dtypes != [want]:
                        fail(f"{tag}: wire dtypes {wire_dtypes}, want "
                             f"{[want]} (the reference's)")
                    line = {"phase": "overlap_scaled", "overlap": mode,
                            "codec": codec, "microbatches": n,
                            "loss": loss, "launches": got,
                            "wire_dtypes": wire_dtypes,
                            "wire_bytes_p8": plan.wire_bytes(8),
                            "memory": mem}
                    # a copy: the overflow check below rolls this step's
                    # residuals back in place
                    runs[n, mode] = ([t.clone() for t in train_state(
                        res[0], res[1], res[3])], loss, line,
                        len(tree_flatten(res[0])[0]), plan)
                    if wire and n == 4:
                        overflow_and_growth(run, wire, ov, res, tag)
                    del res
                compare_scaled(runs, n, codec)
                if n == 4:
                    control_scaled(run, wire, runs, codec, wrong)
                for mode in ("fused", "staged", "backward"):
                    print(json.dumps(runs[n, mode][2]))
                    out[f"{codec}/M{n}/{mode}"] = runs[n, mode][2]
                if n == 1:
                    loss1 = runs[1, "fused"][1]
                    runs.clear()
            loss4 = runs[4, "fused"][1]
            if abs(loss4 - loss1) > 1e-3 * abs(loss1):
                fail(f"scaled {codec}: loss {loss4} at M = 4 vs {loss1} "
                     f"at M = 1")
            del runs
            torch.cuda.empty_cache()
    finally:
        if created:
            dist.destroy_process_group()
    return {"launches": launches, "scaled": out}

# Fused M = 4 sums the four microbatches' bf16 gradients before the
# exchange; staged and backward sum three and add the fourth inside it,
# after the f32 loss scale (so do the reference's paths: its own test
# holds them at rtol 1e-5 in f32, tests/test_microbatch.py).  One bf16
# rounding of the sum apart, at most 2**-9 of an element, so Adam's
# first moment (0.1 g) agrees within relative L2 2**-7 per leaf.  The
# same bounds hold the wait-free M = 1 step, which exchanges bf16 where
# the others exchange f32: its tied embedding sums in bf16, and on the
# int8 wire every decoded gradient is rounded to bf16 at unpack.  On the
# int8 wire that difference moves a quantised element by one step of its
# bucket's absmax / 127 wherever it straddles a rounding boundary; read
# on an H100 80GB HBM3 at 700 W, the worst leaf's distance was 0.01325
# (M = 1) and 0.02691 (M = 4), so 2**-4 there, 2.3x the larger reading.
# The control (``control_scaled``: one of the four microbatches taken
# from another batch) must land above both limits.  Staged and backward
# run the same deferred sum and are held to each other bitwise, as the
# reference holds them (tests/test_wait_free.py).
DEFERRED_MU_TOL = {"identity": 2.0 ** -7, "int8+ef": 2.0 ** -4}


def rounded_tensors(plan, n_p) -> set:
    """Indices in ``train_state`` that a plan exchanging the leaves in
    their own bf16 (the wait-free M = 1 step) may round differently from
    one exchanging f32: the leaves with several contributions (the tied
    embedding: densified rows cast once, plus the dense projection
    gradient, summed in bf16), their Adam moments and their stages'
    residuals; on a quantised wire also every leaf and its moments (the
    decoded f32 gradient is cast to the leaf's dtype at unpack)."""
    summed = {i for i, c in enumerate(plan.contrib_specs) if len(c) > 1}
    leaves = (set(range(n_p)) if not plan.config.codec_obj.linear
              else summed)
    out = {k * n_p + i for i in leaves for k in range(3)}
    dense = [st for st in plan.schedule.stages if st.kind == "dense"]
    out |= {3 * n_p + 1 + r for r, st in enumerate(dense)
            if summed & set(st.leaf_ids)}
    return out


def mu_rel_l2(got, want, n_p) -> float:
    """Worst relative L2 distance over the leaves of Adam's first
    moment (0.1 of the exchanged gradient after one step)."""
    worst = 0.0
    for i in range(n_p, 2 * n_p):
        a, b = got[i].float(), want[i].float()
        worst = max(worst, float((a - b).norm()
                                 / b.norm().clamp(min=1e-30)))
    return worst


def compare_scaled(runs, n, codec) -> None:
    """The loss-scaled step's three paths at one microbatch count.
    M = 1: staged bitwise fused; backward, which exchanges the leaves in
    bf16 (the reference's wire there), bitwise fused but for
    ``rounded_tensors``, held within ``DEFERRED_MU_TOL``.  M = 4: staged
    and backward bitwise; fused within ``DEFERRED_MU_TOL`` on Adam's
    first moment.  Losses bitwise throughout."""
    fused, staged, backward = (runs[n, m] for m in
                               ("fused", "staged", "backward"))
    n_p, tol = fused[3], DEFERRED_MU_TOL[codec]
    pairs = ([("staged", staged, fused, set()),
              ("backward", backward, fused,
               rounded_tensors(backward[4], n_p))]
             if n == 1 else [("backward", backward, staged, set())])
    for name, got, want, allowed in pairs:
        bad = differing(got[0], want[0])
        if set(bad) - allowed or got[1] != want[1]:
            fail(f"scaled M={n} {codec} {name}: differs bitwise in tensors "
                 f"{bad[:10]} of {len(got[0])} (allowed {sorted(allowed)})")
        got[2]["bitwise_vs"] = "fused" if n == 1 else "staged"
        if allowed:
            rel = mu_rel_l2(got[0], want[0], n_p)
            if rel > tol:
                fail(f"scaled M={n} {codec} {name}: Adam mu relative L2 "
                     f"{rel} vs fused (limit {tol})")
            got[2].update(bitwise_but=sorted(bad), mu_rel_l2_vs_fused=rel,
                          mu_tol=tol)
    if n == 1:
        return
    worst = mu_rel_l2(staged[0], fused[0], n_p)
    if worst > tol or staged[1] != fused[1]:
        fail(f"scaled M=4 {codec}: deferred vs fused Adam mu relative L2 "
             f"{worst} (limit {tol}), losses {staged[1]} vs {fused[1]}")
    differ = sum(int((staged[0][i] != fused[0][i]).sum())
                 for i in range(n_p))
    total = sum(staged[0][i].numel() for i in range(n_p))
    for got in (staged, backward):
        got[2].update(mu_rel_l2_vs_fused=worst, mu_tol=tol,
                      params_differing_from_fused=differ,
                      params_total=total)


def control_scaled(run, wire, runs, codec, wrong) -> None:
    """The fused M = 4 step with its last microbatch taken from another
    batch: a wrong step that ``DEFERRED_MU_TOL`` must refuse.  Its Adam
    first moment's distance from the right step's is recorded beside the
    readings the limit passes."""
    fused = runs[4, "fused"]
    ctl, _, _, _ = run(wire, [], 4, b=wrong)
    reading = mu_rel_l2(train_state(ctl[0], ctl[1], ctl[3]), fused[0],
                        fused[3])
    del ctl
    if reading <= DEFERRED_MU_TOL[codec]:
        fail(f"scaled M=4 {codec}: a wrong microbatch moves Adam mu by "
             f"relative L2 {reading}, within the limit "
             f"{DEFERRED_MU_TOL[codec]}: the limit would pass it")
    for mode in ("fused", "staged", "backward"):
        runs[4, mode][2]["control_wrong_microbatch_mu_rel_l2"] = reading


def overflow_and_growth(run, wire, ov, good, tag) -> None:
    """From a good int8+ef step's state: a NaN in the embedding must
    overflow, leave parameters and optimizer state bitwise as they were,
    roll every residual back to its value before the step (then times
    new / old scale = 0.5, as the reference rescales) and halve the
    scale; and with ``growth_interval=2`` a second good step must double
    the scale and every residual exactly against the same step without
    growth."""
    from repro_torch.training import LossScaler
    params, opt_state, ss, ex, _ = good

    def clone_ex(e):
        return type(e)([r.clone() if isinstance(r, torch.Tensor) else r
                        for r in e.bucket_states])

    # growth: step 1 was good (good_steps 1); step 2 with and without it
    grow, hold = LossScaler(growth_interval=2), LossScaler(
        growth_interval=1 << 30)
    (pg, sg, ssg, exg, mg), _, _, _ = run(
        wire, ov, 4, grow, (params, opt_state, ss, clone_ex(ex)))
    (ph, sh, ssh, exh, mh), _, _, _ = run(
        wire, ov, 4, hold, (params, opt_state, ss, clone_ex(ex)))
    if bool(mg["overflow"]) or float(ssg.scale) != 2 * float(ss.scale) \
            or float(ssh.scale) != float(ss.scale):
        fail(f"{tag} growth: scale {float(ss.scale)} -> "
             f"{float(ssg.scale)} (held {float(ssh.scale)})")
    rg = train_state(pg, sg, exg)
    rh = train_state(ph, sh, exh)
    n_res = sum(isinstance(r, torch.Tensor) for r in exg.bucket_states)
    bad = differing(rg[:-n_res], rh[:-n_res])
    if bad or differing(rg[-n_res:], [r * 2 for r in rh[-n_res:]]):
        fail(f"{tag} growth: state or residuals not exactly twice the "
             f"held step's ({bad[:10]})")
    del pg, sg, exg, ph, sh, exh, rg, rh

    bad_params = dict(params)
    bad_params["embedding"] = params["embedding"].clone()
    bad_params["embedding"][0, 0] = float("nan")
    before = [t.clone() for t in train_state(bad_params, opt_state, ex)]
    (p2, s2, ss2, ex2, m2), _, _, _ = run(
        wire, ov, 4, LossScaler(), (bad_params, opt_state, ss, ex))
    after = train_state(p2, s2, ex2)
    n_res = sum(isinstance(r, torch.Tensor) for r in ex2.bucket_states)
    if not bool(m2["overflow"]):
        fail(f"{tag} overflow: a NaN parameter did not overflow")
    bad = differing(after[:-n_res], before[:-n_res])
    bad_res = differing(after[-n_res:], [r * 0.5 for r in before[-n_res:]])
    if bad or bad_res or float(ss2.scale) != 0.5 * float(ss.scale):
        fail(f"{tag} overflow: state changed in tensors {bad[:10]}, "
             f"residuals {bad_res[:10]}, scale {float(ss2.scale)}")
    print(json.dumps({"phase": "overflow_growth", "case": tag,
                      "overflow_rollback_bitwise": True,
                      "residuals_after_overflow": "before x 0.5, bitwise",
                      "growth_scale": float(ssg.scale),
                      "growth_residuals": "held x 2, bitwise"}))


# ---------------------------------------------------------------------------
# backends: flat / hierarchical / ring simulation, reduce-scatter, fp8 wires
# ---------------------------------------------------------------------------

#: the launcher runs of the backends phase, 2 steps each: (tag, grad
#: accumulation, flags, the tag of the run it must equal bitwise)
BACKEND_RUNS = (
    ("flat", "dense_reduce", [], None),
    ("ringsim", "dense_reduce", ["--backend", "ringsim"], "flat"),
    ("reduce_scatter", "dense_reduce", ["--reduce-scatter"], "flat"),
    ("flat/sparse_gather", "sparse_gather", [], None),
    ("ringsim/sparse_gather", "sparse_gather", ["--backend", "ringsim"],
     "flat/sparse_gather"),
    ("flat/bf16", "dense_reduce", ["--codec", "bf16"], None),
    ("reduce_scatter/bf16", "dense_reduce",
     ["--reduce-scatter", "--codec", "bf16"], "flat/bf16"),
    ("wire_dtype/bf16", "dense_reduce", ["--wire-dtype", "bf16"],
     "flat/bf16"),
    ("flat/f8e4m3", "dense_reduce", ["--codec", "f8e4m3"], None),
)

#: float8 bytes of ``jnp.asarray(x, float32).astype(...)`` (e4m3fn, e5m2),
#: as the reference gives them on the CPU (tests/test_torch_backend.py
#: holds this table to jnp); NaN entries are compared as NaN
FP8_REFERENCE_BYTES = {
    0.0: (0x00, 0x00), 1.0: (0x38, 0x3C), -1.0: (0xB8, 0xBC),
    447.0: (0x7E, 0x5F), 448.0: (0x7E, 0x5F), 449.0: (0x7E, 0x5F),
    463.9: (0x7E, 0x5F), 464.0: (0x7E, 0x5F), 464.01: (0x7F, 0x5F),
    465.0: (0x7F, 0x5F), 480.0: (0x7F, 0x60), 500.0: (0x7F, 0x60),
    1e6: (0x7F, 0x7C), -464.0: (0xFE, 0xDF), -465.0: (0xFF, 0xDF),
    -1e6: (0xFF, 0xFC), math.inf: (0x7F, 0x7C), -math.inf: (0xFF, 0xFC),
    math.nan: (0x7F, 0x7E), 2.0 ** -9: (0x01, 0x18),
    2.0 ** -10: (0x00, 0x14), 2.0 ** -11: (0x00, 0x10),
    3 * 2.0 ** -11: (0x01, 0x16), 57344.0: (0x7F, 0x7B),
    61439.0: (0x7F, 0x7B), 61440.0: (0x7F, 0x7C), 61441.0: (0x7F, 0x7C),
    65536.0: (0x7F, 0x7C), -61440.0: (0xFF, 0xFC), 1e-8: (0x00, 0x00),
}


def fp8_table(name: str):
    """Every finite non-negative value of the float8 format ``name``
    decoded from its bits (bytes 0x00 up), and the value one step past
    the largest (the rounding limit's other end): the plain reference the
    card's encode is held to."""
    import numpy as np
    b = np.arange(128, dtype=np.int64)
    if name == "float8_e4m3fn":
        exp, man, bias, mbits = (b >> 3) & 0xF, b & 7, 7, 3
        finite = b < 0x7F                      # 0x7F is NaN
        beyond = 480.0
    else:
        exp, man, bias, mbits = (b >> 2) & 0x1F, b & 3, 15, 2
        finite = b < 0x7C                      # 0x7C inf, above NaN
        beyond = 65536.0
    val = np.where(exp == 0, man / 2 ** mbits * 2.0 ** (1 - bias),
                   (1 + man / 2 ** mbits) * 2.0 ** (exp - bias))
    return val[finite], beyond


def fp8_reference(x, name: str):
    """Bytes of the reference's round-to-nearest-even cast of f32 ``x``
    (numpy) to float8 ``name``, from its decoded value table: ties go to
    the even byte, and past the largest finite value's rounding limit
    NaN for e4m3fn and inf for e5m2 (``0x7F`` / ``0x7C``, sign kept)."""
    import numpy as np
    vals, beyond = fp8_table(name)
    over_byte, nan_byte = ((0x7F, 0x7F) if name == "float8_e4m3fn"
                           else (0x7C, 0x7E))
    table = np.append(vals, beyond)            # the virtual next value
    mag = np.abs(x.astype(np.float64))
    hi = np.clip(np.searchsorted(table, mag), 1, len(table) - 1)
    lo = hi - 1
    dlo, dhi = mag - table[lo], table[hi] - mag
    pick = np.where((dhi < dlo) | ((dhi == dlo) & (hi % 2 == 0)), hi, lo)
    pick = np.where(mag >= table[-1], len(table) - 1, pick)
    out = np.where(pick == len(table) - 1, over_byte, pick).astype(np.uint8)
    out = np.where(np.isnan(x), nan_byte, out).astype(np.uint8)
    return out | (np.signbit(x).astype(np.uint8) << 7)


def fp8_same(got, want, name: str) -> bool:
    """Bytes equal, NaN equal to any NaN (e4m3fn's NaN is 0x7F, e5m2's
    any magnitude above inf's 0x7C, sign aside)."""
    import numpy as np
    nan = (lambda b: (b & 0x7F) == 0x7F) if name == "float8_e4m3fn" \
        else (lambda b: (b & 0x7F) > 0x7C)
    gnan, wnan = nan(got), nan(want)
    return bool(np.array_equal(gnan, wnan)
                and np.array_equal(got[~gnan], want[~wnan]))


def phase_fp8_cast(comm) -> dict:
    """The fp8 codecs' encode on the card against the reference's bytes:
    the edge table (held to jnp on the CPU) and random values, e4m3fn
    past 464 and e5m2 past 61440 included, against ``fp8_reference``;
    PyTorch's own cast reported beside it."""
    import numpy as np
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(7)
    edges = torch.tensor(list(FP8_REFERENCE_BYTES), dtype=torch.float32)
    parts = [edges, -edges.abs()]
    for s in (1e-5, 1e-3, 1.0, 100.0, 3e4):
        parts.append(torch.randn(1 << 20, device=dev, generator=gen).cpu() * s)
    u = torch.rand(1 << 20, device=dev, generator=gen).cpu()
    parts.append((448.0 + u * (1e6 - 448.0)) * torch.where(u > 0.5, 1.0, -1.0))
    x = torch.cat(parts)
    out = {}
    for k, (name, dt) in enumerate((("float8_e4m3fn", torch.float8_e4m3fn),
                                    ("float8_e5m2", torch.float8_e5m2))):
        for src in (torch.float32, torch.bfloat16):
            xs = x.to(src)
            got = comm.fp8_encode(xs.to(dev), dt).view(torch.uint8).cpu(
                ).numpy()
            want = fp8_reference(xs.to(torch.float32).numpy(), name)
            if not fp8_same(got, want, name):
                bad = np.nonzero(got != want)[0][:8]
                fail(f"fp8 {name} from {src}: encode differs from the "
                     f"reference at {bad.tolist()} "
                     f"({xs[bad].tolist()}: {got[bad]} vs {want[bad]})")
        table = np.array([v[k] for v in FP8_REFERENCE_BYTES.values()],
                         np.uint8)
        got = comm.fp8_encode(edges.to(dev), dt).view(torch.uint8).cpu(
            ).numpy()
        if not fp8_same(got, table, name):
            fail(f"fp8 {name}: edge bytes {got.tolist()} vs the "
                 f"reference's {table.tolist()}")
        plain = edges.to(dev).to(dt).view(torch.uint8).cpu().numpy()
        out[name] = {"elements": int(x.numel()) * 2,
                     "bitwise_nan_as_nan": True,
                     "torch_cast_equals_reference": fp8_same(plain, table,
                                                             name),
                     "torch_cast_of_1e6": int(plain[list(
                         FP8_REFERENCE_BYTES).index(1e6)])}
    print(json.dumps({"phase": "backends_fp8_cast", **out}))
    return out


def phase_backends(train, D, Q, comm) -> dict:
    """The collective backends on full-width transformer-big, world of 1
    over NCCL: the launcher's ring-simulation, reduce-scatter, fp8 and
    ``--wire-dtype`` runs (2 steps each) held bitwise against their flat
    counterparts, the fp8 step's exchange against the reference's cast of
    the identity exchange, the hierarchical per-hop int8 path through
    ``DistributedOptimizer`` and ``make_train_step``, the requantize at
    every stage size, and the fp8 cast."""
    quiet = lambda s: None
    launches = {"densify": 0, "quantize": 0, "quantize_ef": 0,
                "decode_sum": 0}
    fp8 = phase_fp8_cast(comm)
    states, steps = {}, 2
    for tag, accum, flags, same_as in BACKEND_RUNS:
        argv = FULL_WIDTH + ["--grad-accum", accum, "--steps", str(steps)] \
            + flags
        plan = exchange_plan(train, argv)
        torch.cuda.synchronize()
        Q.reset_launches()
        D.densify_kernel.launches = 0
        comm.reset_calls()
        result = train.run(argv, log=quiet)
        torch.cuda.synchronize()
        calls = comm.calls()
        issued = sum(v for k, v in calls.items()
                     if k != "two_level_all_reduce")
        got = {"densify": D.densify_kernel.launches,
               "quantize": Q.quantize_kernel.launches}
        losses = [h["loss"] for h in result["history"]]
        if len(losses) != steps or not all(map(math.isfinite, losses)):
            fail(f"backends {tag}: losses {losses}")
        if got != {"densify": steps, "quantize": 0}:
            fail(f"backends {tag}: launches {got}")
        if issued != steps * plan.hlo_collectives(1):
            fail(f"backends {tag}: {calls} collective calls, the plan "
                 f"says {plan.hlo_collectives(1)} a step")
        if plan.config.backend == "ringsim" and issued:
            fail(f"backends {tag}: the ring issued {calls} at P = 1")
        launches["densify"] += got["densify"]
        state = train_state(result["params"], result["opt_state"],
                            result["exchange_state"])
        line = {"phase": "backends_launcher", "run": tag,
                "backend": plan.config.backend, "codec": plan.config.codec,
                "collective": plan.config.dense_collective,
                "grad_accum": accum, "losses": losses, "calls": calls,
                "plan_calls_per_step": plan.hlo_collectives(1),
                "wire_bytes": {p: plan.wire_bytes(p) for p in (4, 8)}}
        if same_as is not None:
            bad = differing(state, states[same_as][0])
            if bad or losses != states[same_as][1]:
                fail(f"backends {tag}: differs from {same_as} bitwise in "
                     f"tensors {bad[:10]} (losses {losses} vs "
                     f"{states[same_as][1]})")
            line["bitwise_vs"] = same_as
        else:
            states[tag] = (state, losses)
        print(json.dumps(line))
        del result, state
    del states
    torch.cuda.empty_cache()
    fp8["exchange"] = backends_fp8_exchange(train, comm)
    hier = backends_hierarchical(train, D, Q, comm)
    for k in launches:
        launches[k] += hier["launches"][k]
    requant = phase_requantize(Q, train)
    return {"launches": launches, "hierarchical": hier,
            "requantize": requant, "fp8": fp8}


def _world_of_one(train):
    """A world of 1 over NCCL (the launcher's), and whether this call
    started it."""
    return train.init_distributed(train.resolve_device("cuda"))[2]


def backends_fp8_exchange(train, comm) -> dict:
    """The first step's exchanged gradients of the fp8 wire equal the
    reference's fp8 cast (``comm.fp8_encode``, held to the reference's
    bytes by ``phase_fp8_cast``) of the identity exchange's, leaf by
    leaf, bitwise."""
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.data import make_pipeline
    from repro_torch.models import build_model
    from repro_torch.training.gradients import grad_contributions
    from repro_torch.tree import tree_flatten
    created = _world_of_one(train)
    try:
        cfg = get_config("transformer-big")
        model = build_model(cfg)
        params = model.init(seed=0, device="cuda")
        batch = {k: torch.from_numpy(v).cuda() for k, v in make_pipeline(
            cfg, 8, 256, seed=0).batch_at(0).items()}
        g = grad_contributions(model, params, batch,
                               sparse_embedding=True)[0]
        outs = {}
        for codec in ("identity", "f8e4m3"):
            opt = train.build_optimizer(train.parse_args(
                FULL_WIDTH + ["--codec", codec]), cfg, dist.group.WORLD)
            outs[codec] = tree_flatten(opt.exchange(g)[0])[0]
        n = 0
        for a, b in zip(outs["identity"], outs["f8e4m3"]):
            want = comm.fp8_encode(a, torch.float8_e4m3fn).to(a.dtype)
            if not same_bits(b, want):
                fail(f"backends fp8: a leaf of {tuple(a.shape)} differs "
                     f"from the fp8 cast of the identity exchange")
            n += a.numel()
        nan = sum(int(torch.isnan(b).sum()) for b in outs["f8e4m3"])
        line = {"phase": "backends_fp8_exchange", "elements": n,
                "bitwise_vs_fp8_cast_of_identity": True, "nan": nan}
        print(json.dumps(line))
        return line
    finally:
        if created:
            dist.destroy_process_group()


def backends_hierarchical(train, D, Q, comm) -> dict:
    """The hierarchical per-hop int8 path on the card: ``group=(WORLD,
    WORLD)`` (two levels of size 1; the launcher refuses an odd world, as
    the reference does).  The first exchange's residuals bitwise those of
    the flat int8+ef exchange (hop 0 is the same fused encode) and its
    gradients within one requantize round trip of the flat ones; then 3
    ``make_train_step`` steps with int8+ef and 1 with int8, launches
    counted against the plan: per dense stage hop 0's encode (fused under
    +ef), the stateless requantize encode, two decode-sums, and
    ``plan.hlo_collectives((1, 1))`` collectives."""
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.core import DistributedOptimizer, ExchangeConfig
    from repro_torch.data import make_pipeline
    from repro_torch.models import build_model
    from repro_torch.optim import adamw, noam_schedule
    from repro_torch.training import make_train_step
    from repro_torch.training.gradients import grad_contributions
    from repro_torch.tree import tree_flatten
    created = _world_of_one(train)
    launches = {"densify": 0, "quantize": 0, "quantize_ef": 0,
                "decode_sum": 0}
    out = {}
    try:
        world = dist.group.WORLD
        cfg = get_config("transformer-big")
        model = build_model(cfg)
        pipe = make_pipeline(cfg, 8, 256, seed=0)

        def batch_at(k):
            return {k2: torch.from_numpy(v).cuda()
                    for k2, v in pipe.batch_at(k).items()}

        def opt_for(backend, codec):
            return DistributedOptimizer(
                adamw(noam_schedule(cfg.d_model, warmup_steps=400)),
                exchange=ExchangeConfig(sparse_as_dense=True, codec=codec,
                                        backend=backend, use_kernel=True),
                group=(world, world) if backend == "hierarchical"
                else world)

        def counts():
            torch.cuda.synchronize()
            c = comm.calls()
            return {"densify": D.densify_kernel.launches,
                    "quantize": Q.quantize_kernel.launches,
                    "quantize_ef": Q.quantize_ef_kernel.launches,
                    "decode_sum": Q.decode_sum_kernel.launches,
                    "collectives": sum(v for k, v in c.items()
                                       if k != "two_level_all_reduce"),
                    "two_level_all_reduce": c["two_level_all_reduce"]}

        def reset():
            torch.cuda.synchronize()
            Q.reset_launches()
            D.densify_kernel.launches = 0
            comm.reset_calls()

        def want(plan, steps, ef):
            n_dense = sum(s.kind == "dense" for s in plan.schedule.stages)
            return {"densify": steps, "quantize": 2 * steps * n_dense,
                    "quantize_ef": steps * n_dense if ef else 0,
                    "decode_sum": 2 * steps * n_dense,
                    "collectives": steps * plan.hlo_collectives((1, 1)),
                    "two_level_all_reduce": 0}

        # -- the first exchange against the flat one ------------------------
        params = model.init(seed=0, device="cuda")
        g = grad_contributions(model, params, batch_at(0),
                               sparse_embedding=True)[0]
        flat, hier = opt_for("flat", "int8+ef"), opt_for("hierarchical",
                                                         "int8+ef")
        fs = flat.init_exchange_state(g)
        hs = hier.init_exchange_state(g)
        f_out, fs = flat.exchange(g, fs)
        reset()
        h_out, hs = hier.exchange(g, hs)
        got = counts()
        plan = hier.plan(g)
        exp = {k: v for k, v in want(plan, 1, True).items()
               if k != "densify"}
        exp["densify"] = 1
        if got != exp:
            fail(f"backends hierarchical exchange: launches {got}, want "
                 f"{exp}")
        for k in launches:
            launches[k] += got[k]
        rf = [r for r in fs.bucket_states if isinstance(r, torch.Tensor)]
        rh = [r for r in hs.bucket_states if isinstance(r, torch.Tensor)]
        bad = differing(rh, rf)
        if bad or not rf:
            fail(f"backends hierarchical: residuals {bad[:10]} differ from "
                 f"the flat int8+ef exchange's")
        worst = 0.0
        for a, b in zip(tree_flatten(f_out)[0], tree_flatten(h_out)[0]):
            a32, b32 = a.float(), b.float()
            # one requantize round trip (scale / 2, scale from the
            # partial sum's absmax) and the leaf dtype's rounding of each
            half = a32.abs().max() / 127 / 2 * (1 + 1e-3)
            ulp = torch.maximum(a32.abs(), b32.abs()) * (
                2.0 ** -8 if a.dtype == torch.bfloat16 else 2.0 ** -23)
            err = (a32 - b32).abs()
            if bool((err > half + 2 * ulp).any()):
                fail(f"backends hierarchical: a leaf of {tuple(a.shape)} "
                     f"is {float(err.max())} from the flat exchange, more "
                     f"than one requantize round trip {float(half)}")
            worst = max(worst, float((err / half.clamp_min(1e-30)).max()))
        out["first_exchange"] = {"residuals_bitwise_vs_flat": len(rf),
                                 "max_err_over_half_scale": worst,
                                 "launches": got}
        print(json.dumps({"phase": "backends_hierarchical_exchange",
                          **out["first_exchange"]}))
        del g, f_out, h_out, fs, hs, flat
        # -- make_train_step: 3 steps of int8+ef, 1 of int8 -----------------
        for codec, n_steps in (("int8+ef", 3), ("int8", 1)):
            opt = opt_for("hierarchical", codec)
            step = make_train_step(model, opt, sparse_embedding=True)
            params = model.init(seed=0, device="cuda")
            opt_state = opt.init(params)
            g0 = grad_contributions(model, params, batch_at(0),
                                    sparse_embedding=True)[0]
            ex = opt.init_exchange_state(g0)
            plan = opt.plan(g0)
            del g0
            reset()
            losses = []
            for k in range(n_steps):
                params, opt_state, ex, m = step(params, opt_state, ex,
                                                batch_at(k))
                losses.append(float(m["loss"]))
            got = counts()
            exp = want(plan, n_steps, codec.endswith("+ef"))
            if got != exp:
                fail(f"backends hierarchical {codec}: launches {got}, want "
                     f"{exp} from the plan")
            for k in launches:
                launches[k] += got[k]
            finite = all(bool(torch.isfinite(t).all())
                         for t in tree_flatten(params)[0])
            if not finite:
                fail(f"backends hierarchical {codec}: non-finite params")
            out[codec] = {"steps": n_steps, "losses": losses,
                          "launches": got,
                          "plan_calls_per_step": plan.hlo_collectives((1, 1)),
                          "hop_wire_bytes": {str(lv): plan.hop_wire_bytes(lv)
                                             for lv in ((2, 4), (4, 16))}}
            print(json.dumps({"phase": "backends_hierarchical_step",
                              "codec": codec, **out[codec]}))
            del params, opt_state, ex, step, opt
        torch.cuda.empty_cache()
    finally:
        if created:
            dist.destroy_process_group()
    out["launches"] = launches
    return out


def phase_requantize(Q, train) -> dict:
    """The hierarchical path's requantize: the stateless encode of an f32
    partial sum (the decode-sum of two workers' real q) at every distinct
    stage size of the int8+ef plan, bitwise against ``quantize_plain``
    (q and scale), timed as device time with the L2 flushed, beside its
    byte bound (4 B read and 1 B written an element); per step, the 16
    stages' sum."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(9)
    sizes = int8_ef_stage_sizes(train)
    rows, step_ms, step_bound, n_step = [], 0.0, 0.0, 0
    for n, count in sizes.items():
        parts = [Q.quantize_kernel((torch.randn(n, device=dev, generator=gen)
                                    * 1e-3).to(torch.bfloat16))
                 for _ in range(2)]
        partial = Q.decode_sum_kernel(torch.cat([q for q, _ in parts]),
                                      torch.cat([s for _, s in parts]), 2)
        q, s = Q.quantize_kernel(partial)
        qp, sp = Q.quantize_plain(partial)
        if not (torch.equal(q, qp) and bits_equal(s, sp)):
            fail(f"requantize at {n}: the kernel differs from "
                 f"quantize_plain")
        iters = 20 if n > 1 << 20 else 50
        ms = device_ms_cold(lambda: Q.quantize_kernel(partial), iters)
        plain = (device_ms_cold(lambda: Q.quantize_plain(partial), 5)
                 if n == max(sizes) else None)
        bound = n * 5 / HBM_BYTES_PER_S * 1e3
        rows.append({"elements": n, "stages": count, "kernel_ms": ms,
                     "plain_ms": plain, "bound_ms": bound,
                     "bitwise_vs_plain": True})
        step_ms += ms * count
        step_bound += bound * count
        n_step += n * count
        del parts, partial, q, s, qp, sp
    out = {"by_size": rows, "per_step_ms": step_ms,
           "per_step_bound_ms": step_bound, "per_step_elements": n_step,
           "bound_by": "bytes"}
    print(json.dumps({"phase": "backends_requantize", **out}))
    return out


# ---------------------------------------------------------------------------
# zero1: sharded AdamW state, the updated-param allgather, checkpoints
# ---------------------------------------------------------------------------

#: the zero1 phase's launcher runs, 3 steps each: (tag, grad
#: accumulation, flags, the tag of the replicated run it must equal
#: bitwise or None)
ZERO1_RUNS = (
    ("replicated", "dense_reduce", [], None),
    ("zero1", "dense_reduce", ["--zero1"], "replicated"),
    ("replicated/sparse_gather", "sparse_gather", [], None),
    ("zero1/sparse_gather", "sparse_gather", ["--zero1"],
     "replicated/sparse_gather"),
    ("zero1/int8+ef", "dense_reduce",
     ["--zero1", "--codec", "int8", "--error-feedback"], None),
    ("zero1/param_int8", "dense_reduce", ["--zero1", "--param-codec",
                                          "int8"], None),
)
ZERO1_STEPS = 3


def zero1_setup(train, argv):
    """The parsed launcher arguments, the config they name and their
    pipeline's batches ``0 .. n-1`` on the device, as the launcher makes
    them at a world of 1."""
    from repro_torch.configs import get_config
    from repro_torch.data import make_pipeline
    args = train.parse_args(argv)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    pipe = make_pipeline(cfg, args.batch_per_worker, args.seq_len,
                         seed=args.seed)

    def batch_at(k):
        return {key: torch.from_numpy(v).to(args.device)
                for key, v in pipe.batch_at(k).items()}
    return args, cfg, batch_at


def zero1_counts(D, Q, comm) -> dict:
    torch.cuda.synchronize()
    calls = comm.calls()
    return {"densify": D.densify_kernel.launches,
            "quantize": Q.quantize_kernel.launches,
            "quantize_ef": Q.quantize_ef_kernel.launches,
            "decode_sum": Q.decode_sum_kernel.launches,
            "collectives": sum(v for k, v in calls.items()
                               if k != "two_level_all_reduce")}


def zero1_want(plan, steps: int) -> dict:
    """The launches ``steps`` zero1 steps must make, from the plan: one
    densify a step; an int8 gradient wire encodes every stage (the fused
    encode on each dense stage under +ef) and decode-sums every dense
    stage; an int8 param wire adds one stateless encode of each dense
    stage's f32 shard (its decode is plain PyTorch: each worker's chunk
    against its own scale, no sum); ``plan.hlo_collectives(1)``
    collective calls a step."""
    stages = plan.schedule.stages
    n_dense = sum(st.kind == "dense" for st in stages)
    cfg = plan.config
    grad_int8 = cfg.codec.startswith("int8")
    param_int8 = cfg.param_codec == "int8"
    return {"densify": steps,
            "quantize": steps * ((len(stages) if grad_int8 else 0)
                                 + (n_dense if param_int8 else 0)),
            "quantize_ef": steps * n_dense if cfg.codec == "int8+ef" else 0,
            "decode_sum": steps * n_dense if grad_int8 else 0,
            "collectives": steps * plan.hlo_collectives(1)}


def zero1_reset(D, Q, comm) -> None:
    torch.cuda.synchronize()
    Q.reset_launches()
    D.densify_kernel.launches = 0
    comm.reset_calls()


def zero1_state(result) -> list:
    """Every tensor a launcher run leaves behind, in the checkpoint
    walker's order: parameters, optimizer state, residuals."""
    from repro_torch.checkpoint.checkpoint import flatten_with_paths
    return [t for _, t in flatten_with_paths(
        (result["params"], result["opt_state"], result["exchange_state"]))]


def zero1_busy_ms(train, argv, result, base=None) -> float:
    """Device busy ms of one more step from a run's final state (the
    residuals copied, so the run's own state is left as it was): the
    kernels, copies and memsets of the step under a CUDA-only
    ``torch.profiler``."""
    return step_profile(train, argv, result, base)["device_busy_ms"]


def step_profile(train, argv, result, base=None) -> dict:
    """``top_device_kernels`` of one more step from a run's final state,
    as ``zero1_busy_ms`` takes it."""
    import torch.distributed as dist
    from repro_torch.core.codecs import ExchangeState
    from repro_torch.models import build_model
    from repro_torch.training import make_train_step
    args, cfg, batch_at = zero1_setup(train, argv)
    opt = train.build_optimizer(args, cfg, dist.group.WORLD)
    if base is not None:
        opt = type(opt)(base, exchange=opt.exchange_config,
                        group=dist.group.WORLD)
    step = make_train_step(build_model(cfg), opt, sparse_embedding=True)
    batch = batch_at(args.steps)
    ex = ExchangeState([s.clone() if isinstance(s, torch.Tensor) else s
                        for s in result["exchange_state"].bucket_states])
    return top_device_kernels(
        lambda: step(result["params"], result["opt_state"], ex, batch))


def phase_zero1(train, D, Q, comm, ops) -> dict:
    """ZeRO-1 on full-width transformer-big, world of 1 over NCCL, 8 x
    256 tokens, 3 steps a run: the launcher's ``--zero1`` runs bitwise
    against the replicated fused runs of the same flags (dense_reduce and
    sparse_gather: parameters, losses, Adam moments through the bucket
    layout), ``--zero1 --codec int8 --error-feedback`` and ``--zero1
    --param-codec int8`` (their first step through the kernels bitwise
    the same step through the plain versions), a checkpoint after step 2
    resumed to step 3 bitwise the uninterrupted int8+ef run, and
    ``adamw(state_dtype="bfloat16")`` through ``make_train_step``
    (zero1 bitwise replicated).  Every run: launches and collective
    calls from the plan, the Zero1State's bytes equal to
    ``optimizer_state_bytes``."""
    import shutil
    import torch.distributed as dist
    from repro_torch.optim import zero1 as z1
    quiet = lambda s: None
    launches = {"densify": 0, "quantize": 0, "quantize_ef": 0,
                "decode_sum": 0}
    created = _world_of_one(train)
    runs, out = {}, {}
    ckdir = os.path.join(ROOT, "build", "zero1_checkpoints")
    try:
        for tag, accum, flags, same_as in ZERO1_RUNS:
            argv = FULL_WIDTH + ["--grad-accum", accum, "--steps",
                                 str(ZERO1_STEPS)] + flags
            result, line = zero1_launcher_run(train, D, Q, comm, argv, tag,
                                              launches)
            if same_as is not None:
                zero1_same_as_replicated(tag, result, runs[same_as],
                                         exchange_plan(train, argv))
                line["bitwise_vs"] = same_as
            line["device_busy_ms"] = zero1_busy_ms(train, argv, result)
            print(json.dumps(line))
            out[tag] = line
            if tag in ("replicated", "replicated/sparse_gather",
                       "zero1/int8+ef"):
                runs[tag] = result
            del result
        del runs["replicated"], runs["replicated/sparse_gather"]
        torch.cuda.empty_cache()
        # -- checkpoint after step 2, resumed to step 3 ---------------------
        shutil.rmtree(ckdir, ignore_errors=True)
        whole = runs.pop("zero1/int8+ef")
        flags = ["--zero1", "--codec", "int8", "--error-feedback",
                 "--grad-accum", "dense_reduce", "--checkpoint-dir", ckdir]
        t0 = time.perf_counter()
        _, line = zero1_launcher_run(
            train, D, Q, comm, FULL_WIDTH + flags + [
                "--steps", "2", "--checkpoint-every", "2"],
            "zero1/int8+ef/checkpoint", launches, steps=2)
        line["run_s"] = time.perf_counter() - t0
        print(json.dumps(line))
        ck_bytes = os.path.getsize(os.path.join(ckdir, "ckpt_00000002.npz"))
        t0 = time.perf_counter()
        resumed, line = zero1_launcher_run(
            train, D, Q, comm, FULL_WIDTH + flags + ["--steps", "3",
                                                     "--resume"],
            "zero1/int8+ef/resume", launches, steps=1)
        line["run_s"] = time.perf_counter() - t0
        bad = differing(zero1_state(resumed), zero1_state(whole))
        last = (resumed["history"][-1]["loss"], whole["history"][-1]["loss"])
        if bad or last[0] != last[1]:
            fail(f"zero1 resume: differs from the uninterrupted run in "
                 f"tensors {bad[:10]} (last loss {last})")
        line.update(bitwise_vs="zero1/int8+ef", checkpoint_bytes=ck_bytes)
        print(json.dumps(line))
        out["resume"] = line
        del resumed, whole
        shutil.rmtree(ckdir, ignore_errors=True)
        torch.cuda.empty_cache()
        # -- the first step through the kernels and the plain versions ------
        for tag, flags in (("int8+ef", ["--codec", "int8",
                                        "--error-feedback"]),
                           ("param_int8", ["--param-codec", "int8"])):
            out[f"first_step/{tag}"] = zero1_first_step(
                train, FULL_WIDTH + ["--zero1", "--grad-accum",
                                     "dense_reduce"] + flags, tag, ops)
        # -- adamw(state_dtype="bfloat16") through make_train_step ----------
        out["bf16_state"] = zero1_bf16_state(train, D, Q, comm, launches)
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)
        if created:
            dist.destroy_process_group()
    out["launches"] = launches
    return out


def zero1_launcher_run(train, D, Q, comm, argv, tag, launches,
                       steps=ZERO1_STEPS):
    """One launcher run with the counts reset before and read after;
    returns its result and its report line (step ms, training-state
    bytes, peak memory, launches), the checks applied."""
    from repro_torch.checkpoint.checkpoint import nbytes
    from repro_torch.optim import zero1 as z1
    plan = exchange_plan(train, argv)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    zero1_reset(D, Q, comm)
    result = train.run(argv, log=lambda s: None)
    got = zero1_counts(D, Q, comm)
    want = zero1_want(plan, steps)
    if got != want:
        fail(f"zero1 {tag}: launches {got}, want {want} from the plan")
    for k in launches:
        launches[k] += got[k]
    hist = result["history"]
    losses = [h["loss"] for h in hist]
    if len(losses) != steps or not all(map(math.isfinite, losses)):
        fail(f"zero1 {tag}: losses {losses}")
    opt_state = result["opt_state"]
    state_b = nbytes(opt_state)
    want_b = z1.optimizer_state_bytes(plan, 1)
    if state_b != want_b:
        fail(f"zero1 {tag}: the optimizer state holds {state_b} B, "
             f"optimizer_state_bytes says {want_b} B")
    steady = [h["step_ms"] for h in hist[1:]] or [hist[0]["step_ms"]]
    return result, {
        "phase": "zero1", "run": tag, "codec": plan.config.codec,
        "param_codec": plan.config.param_codec,
        "zero1": plan.config.zero1, "steps": steps, "losses": losses,
        "launches": got, "plan_calls_per_step": plan.hlo_collectives(1),
        "optimizer_state_bytes": state_b,
        "optimizer_state_bytes_replicated": z1.optimizer_state_bytes(
            plan, 1, zero1=False),
        "optimizer_state_bytes_zero1_p8": z1.optimizer_state_bytes(
            plan, 8, zero1=True),
        "training_state_bytes": nbytes(
            (result["params"], opt_state, result["exchange_state"])),
        "wire_bytes": {p: plan.wire_bytes(p) for p in (4, 8)},
        "step_ms_median_after_first": statistics.median(steady),
        "max_memory_allocated": torch.cuda.max_memory_allocated(),
        # what earlier runs' results kept allocated when this one began
        "memory_allocated_before": held}


def zero1_same_as_replicated(tag, result, rep, plan) -> None:
    """Parameters and losses bitwise the replicated run's, and the
    Zero1State's moments bitwise the replicated AdamState's laid out in
    the plan's buckets."""
    from repro_torch.optim import zero1 as z1
    from repro_torch.tree import tree_flatten
    a = tree_flatten(result["params"])[0]
    b = tree_flatten(rep["params"])[0]
    bad = differing(a, b)
    la = [h["loss"] for h in result["history"]]
    lb = [h["loss"] for h in rep["history"]]
    if bad or la != lb:
        fail(f"zero1 {tag}: params {bad[:10]} or losses {la} vs {lb} "
             f"differ from the replicated run")
    z, adam = result["opt_state"], rep["opt_state"]
    for slot, tree in ((0, adam.mu), (1, adam.nu)):
        want = z1.bucket_layout(plan, tree)
        got = [s[slot].to(torch.float32) for s in z.opt_slots]
        bad = differing(got, want)
        if bad:
            fail(f"zero1 {tag}: Adam slot {slot} differs from the "
                 f"replicated moments in stages {bad[:10]}")
    if int(z.step) != int(adam.step):
        fail(f"zero1 {tag}: step {int(z.step)} vs {int(adam.step)}")


def zero1_first_step(train, argv, tag, ops) -> dict:
    """One zero1 step from the launcher's initial state through the int8
    kernels and through their plain versions (the ops entry points
    pointed at ``quantize_plain``, ``quantize_ef_plain`` and
    ``decode_sum_plain`` for the second): every dense stage's gradient
    shard, the new params, the Zero1State and the residuals bitwise."""
    import torch.distributed as dist
    from repro_torch.checkpoint.checkpoint import flatten_with_paths
    from repro_torch.core.exchange import ExchangePlan
    from repro_torch.kernels import quantize as Q
    from repro_torch.models import build_model
    from repro_torch.training.gradients import grad_contributions
    args, cfg, batch_at = zero1_setup(train, argv)
    model = build_model(cfg)
    opt = train.build_optimizer(args, cfg, dist.group.WORLD)
    params = model.init(seed=args.seed, device=args.device)
    g = grad_contributions(model, params, batch_at(0),
                           sparse_embedding=True)[0]
    finish = ExchangePlan.zero1_finish_grad
    kernels = (ops.quantize_int8, ops.quantize_int8_ef, ops.int8_decode_sum)
    plain = (Q.quantize_plain, Q.quantize_ef_plain, Q.decode_sum_plain)
    outs = {}
    for route, fns in (("kernel", kernels), ("plain", plain)):
        shards = []

        def recording(self, *a, **k):
            shard = finish(self, *a, **k)
            shards.append(shard.clone())
            return shard
        ExchangePlan.zero1_finish_grad = recording
        ops.quantize_int8, ops.quantize_int8_ef, ops.int8_decode_sum = fns
        try:
            z = opt.init_zero1_state(g, params)
            ex = opt.init_exchange_state(g)
            step_out = opt.zero1_step(g, params, z, exchange_state=ex)
            torch.cuda.synchronize()
        finally:
            ExchangePlan.zero1_finish_grad = finish
            (ops.quantize_int8, ops.quantize_int8_ef,
             ops.int8_decode_sum) = kernels
        outs[route] = (shards, [t for _, t in flatten_with_paths(step_out)])
        del step_out, z, ex
    bad_shards = differing(outs["kernel"][0], outs["plain"][0])
    bad_state = differing(outs["kernel"][1], outs["plain"][1])
    if bad_shards or bad_state or not outs["kernel"][0]:
        fail(f"zero1 first step {tag}: kernels vs plain differ in shards "
             f"{bad_shards[:10]} and state tensors {bad_state[:10]}")
    line = {"phase": "zero1_first_step", "run": tag,
            "shards_bitwise": len(outs["kernel"][0]),
            "state_tensors_bitwise": len(outs["kernel"][1]),
            "shard_elements": sum(s.numel() for s in outs["kernel"][0])}
    print(json.dumps(line))
    return line


def zero1_bf16_state(train, D, Q, comm, launches) -> dict:
    """``adamw(noam, state_dtype="bfloat16")`` through
    ``make_train_step``: 3 steps replicated and 3 with zero1 on the
    launcher's batches; zero1 bitwise the replicated (params, losses,
    bf16 moments through the bucket layout), each state's bytes
    ``optimizer_state_bytes(plan, 1, "bfloat16")``, half the f32
    runs'."""
    import torch.distributed as dist
    from repro_torch.checkpoint.checkpoint import nbytes
    from repro_torch.core import DistributedOptimizer, ExchangeConfig
    from repro_torch.models import build_model
    from repro_torch.optim import adamw, noam_schedule
    from repro_torch.optim import zero1 as z1
    from repro_torch.training import make_train_step
    from repro_torch.training.gradients import grad_contributions
    argv = FULL_WIDTH + ["--grad-accum", "dense_reduce", "--steps",
                         str(ZERO1_STEPS)]
    args, cfg, batch_at = zero1_setup(train, argv)
    model = build_model(cfg)
    batches = [batch_at(s) for s in range(ZERO1_STEPS)]
    base = adamw(noam_schedule(cfg.d_model, warmup_steps=args.warmup),
                 state_dtype="bfloat16")
    res, out = {}, {}
    for zero1 in (False, True):
        tag = "bf16_state/" + ("zero1" if zero1 else "replicated")
        opt = DistributedOptimizer(base, exchange=ExchangeConfig(
            sparse_as_dense=True, zero1=zero1, use_kernel=True),
            group=dist.group.WORLD)
        step = make_train_step(model, opt, sparse_embedding=True)
        params = model.init(seed=args.seed, device=args.device)
        g = grad_contributions(model, params, batches[0],
                               sparse_embedding=True)[0]
        plan = opt.plan(g)
        state = (opt.init_zero1_state(g, params) if zero1
                 else opt.init(params))
        ex = opt.init_exchange_state(g)
        del g
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        zero1_reset(D, Q, comm)
        losses, times = [], []
        for b in batches:
            t0 = time.perf_counter()
            params, state, ex, m = step(params, state, ex, b)
            losses.append(float(m["loss"]))
            times.append((time.perf_counter() - t0) * 1e3)
        got = zero1_counts(D, Q, comm)
        want = zero1_want(plan, ZERO1_STEPS)
        if got != want:
            fail(f"zero1 {tag}: launches {got}, want {want}")
        for k in launches:
            launches[k] += got[k]
        held = nbytes(state)
        want_b = z1.optimizer_state_bytes(plan, 1, "bfloat16")
        if held != want_b or held * 2 - 4 != z1.optimizer_state_bytes(
                plan, 1, "float32"):
            fail(f"zero1 {tag}: state holds {held} B, want {want_b} B")
        if not all(map(math.isfinite, losses)):
            fail(f"zero1 {tag}: losses {losses}")
        result = {"params": params, "opt_state": state, "exchange_state": ex,
                  "history": [{"loss": x} for x in losses]}
        line = {"phase": "zero1", "run": tag, "losses": losses,
                "launches": got, "optimizer_state_bytes": held,
                "training_state_bytes": nbytes((params, state, ex)),
                "step_ms_median_after_first": statistics.median(times[1:]),
                "max_memory_allocated": torch.cuda.max_memory_allocated(),
                "memory_allocated_before": before}
        if zero1:
            zero1_same_as_replicated(tag, result, res[False], plan)
            line["bitwise_vs"] = "bf16_state/replicated"
        line["device_busy_ms"] = zero1_busy_ms(
            train, argv + (["--zero1"] if zero1 else []), result, base=base)
        print(json.dumps(line))
        out[tag] = line
        res[zero1] = result
        del params, state, ex, step
    del res
    torch.cuda.empty_cache()
    return out


def host_weights(model, seed: int, device):
    """``model.init(seed)`` drawn on the CPU and copied to ``device``:
    the card's generator draws other numbers from the same seed, so a
    card run held against a CPU run starts from these."""
    from repro_torch.tree import tree_map
    return tree_map(lambda t: t.to(device),
                    model.init(seed=seed, device="cpu"))


@contextlib.contextmanager
def host_drawn_init():
    """Within the block, ``Model.init`` on the card draws on the CPU and
    copies (``host_weights``), so the launcher's card runs start from the
    weights of its CPU runs."""
    from repro_torch.models.model import Model
    init = Model.init

    def via_host(self, seed=0, device="cuda"):
        if torch.device(device).type != "cuda":
            return init(self, seed=seed, device=device)
        return host_weights(self, seed, device)
    Model.init = via_host
    try:
        yield
    finally:
        Model.init = init


def phase_small_zero1(train) -> None:
    """The reduced transformer-big in f32 trains 2 steps on the card and
    on the CPU with ``--zero1 --codec int8 --error-feedback`` and
    ``--zero1 --param-codec int8``: losses within rel 1e-4, as the other
    small phases."""
    base = ["--reduced", "--dist", "horovod", "--grad-accum",
            "dense_reduce", "--batch-per-worker", "4", "--seq-len", "32",
            "--steps", "2", "--log-every", "1", "--zero1"]
    quiet = lambda s: None
    for flags in (["--codec", "int8", "--error-feedback"],
                  ["--param-codec", "int8"]):
        with host_drawn_init():
            card = train.run(base + flags + ["--device", "cuda"],
                             log=quiet)["history"]
        cpu = train.run(base + flags + ["--device", "cpu"],
                        log=quiet)["history"]
        lc, lh = [h["loss"] for h in card], [h["loss"] for h in cpu]
        if len(lc) != 2 or not all(math.isclose(x, y, rel_tol=1e-4)
                                   for x, y in zip(lc, lh)):
            fail(f"small zero1 {flags}: card {lc} vs cpu {lh}")
        print(json.dumps({"phase": "small_zero1", "flags": flags,
                          "card_losses": lc, "cpu_losses": lh}))


def phase_small_backends(train) -> None:
    """The reduced transformer-big in f32 trains 2 steps on the card and
    on the CPU with the hierarchical backend (``group=(WORLD, WORLD)``,
    int8+ef), the ring simulation and ``--reduce-scatter``: losses within
    rel 1e-4 (the two devices sum in other orders)."""
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.core import DistributedOptimizer, ExchangeConfig
    from repro_torch.data import make_pipeline
    from repro_torch.models import build_model
    from repro_torch.optim import adamw
    from repro_torch.training import make_train_step
    from repro_torch.training.gradients import grad_contributions
    base = ["--reduced", "--dist", "horovod", "--grad-accum",
            "dense_reduce", "--batch-per-worker", "4", "--seq-len", "32",
            "--steps", "2", "--log-every", "1"]
    quiet = lambda s: None
    for flags in (["--backend", "ringsim"], ["--reduce-scatter"]):
        with host_drawn_init():
            card = train.run(base + flags + ["--device", "cuda"],
                             log=quiet)["history"]
        cpu = train.run(base + flags + ["--device", "cpu"],
                        log=quiet)["history"]
        lc, lh = [h["loss"] for h in card], [h["loss"] for h in cpu]
        if len(lc) != 2 or not all(math.isclose(x, y, rel_tol=1e-4)
                                   for x, y in zip(lc, lh)):
            fail(f"small backends {flags}: card {lc} vs cpu {lh}")
        print(json.dumps({"phase": "small_backends", "flags": flags,
                          "card_losses": lc, "cpu_losses": lh}))

    def hierarchical(device):
        created = train.init_distributed(train.resolve_device(device))[2]
        try:
            cfg = get_config("transformer-big").reduced()
            model = build_model(cfg)
            world = dist.group.WORLD
            opt = DistributedOptimizer(adamw(1e-3), exchange=ExchangeConfig(
                sparse_as_dense=True, codec="int8+ef",
                backend="hierarchical", use_kernel=True),
                group=(world, world))
            step = make_train_step(model, opt, sparse_embedding=True)
            pipe = make_pipeline(cfg, 4, 32, seed=0)
            batches = [{k: torch.from_numpy(v).to(device)
                        for k, v in pipe.batch_at(s).items()}
                       for s in range(2)]
            params = host_weights(model, 0, device)
            ex = opt.init_exchange_state(grad_contributions(
                model, params, batches[0], sparse_embedding=True)[0])
            opt_state, losses = opt.init(params), []
            for b in batches:
                params, opt_state, ex, m = step(params, opt_state, ex, b)
                losses.append(float(m["loss"]))
            return losses
        finally:
            if created:
                dist.destroy_process_group()

    lc, lh = hierarchical("cuda"), hierarchical("cpu")
    if not all(math.isclose(x, y, rel_tol=1e-4) for x, y in zip(lc, lh)):
        fail(f"small backends hierarchical int8+ef: card {lc} vs cpu {lh}")
    print(json.dumps({"phase": "small_backends", "flags": [
        "hierarchical", "int8+ef"], "card_losses": lc, "cpu_losses": lh}))


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
            with host_drawn_init():
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
    small_scaled_backward()


def small_scaled_backward() -> None:
    """The reduced transformer-big in f32: two loss-scaled steps of 4
    microbatches with ``overlap="backward"`` on the card and on the CPU
    (the local exchange path, no process group), each wire.  The first
    loss (the forward alone) within relative 1e-5; Adam's first moment
    after step 1 (0.1 of the exchanged, unscaled gradient: the wait-free
    backward, the hooked exchange and the unscale) within
    ``SMALL_MU_TOL``; the second loss, which reads step 1's update,
    within relative 1e-4, the small phase's tolerance."""
    from repro_torch.configs import get_config
    from repro_torch.core import DistributedOptimizer, ExchangeConfig
    from repro_torch.data import make_pipeline
    from repro_torch.models import build_model
    from repro_torch.optim import adamw
    from repro_torch.training import LossScaler, make_scaled_train_step
    from repro_torch.training.gradients import grad_contributions
    from repro_torch.tree import tree_flatten
    model = build_model(get_config("transformer-big").reduced())
    np_batch = make_pipeline(model.cfg, 8, 32).batch_at(0)
    for codec in ("identity", "int8+ef"):
        losses, mu = {}, {}
        for dev in ("cuda", "cpu"):
            params = host_weights(model, 0, dev)
            batch = {k: torch.from_numpy(v).to(dev)
                     for k, v in np_batch.items()}
            opt = DistributedOptimizer(adamw(1e-3), exchange=ExchangeConfig(
                sparse_as_dense=True, codec=codec, overlap="backward",
                use_kernel=True))
            step = make_scaled_train_step(model, opt, LossScaler(),
                                          n_microbatches=4,
                                          sparse_embedding=True)
            g = grad_contributions(model, params, batch,
                                   sparse_embedding=True)[0]
            state = (params, opt.init(params), LossScaler().init(dev),
                     opt.init_exchange_state(g))
            losses[dev] = []
            for k in range(2):
                *state, m = step(*state, batch)
                if bool(m["overflow"]):
                    fail(f"small scaled backward {codec} {dev}: overflow")
                losses[dev].append(float(m["loss"]))
                if k == 0:
                    mu[dev] = [t.cpu() for t in tree_flatten(state[1].mu)[0]]
        (c1, c2), (h1, h2) = losses["cuda"], losses["cpu"]
        rel = [float((a - b).norm() / b.norm().clamp(min=1e-30))
               for a, b in zip(mu["cuda"], mu["cpu"])]
        whole = float(torch.cat([(a - b).reshape(-1) for a, b in
                                 zip(mu["cuda"], mu["cpu"])]).norm()
                      / torch.cat([b.reshape(-1)
                                   for b in mu["cpu"]]).norm())
        limit = SMALL_MU_TOL[codec]
        got = max(rel) if codec == "identity" else whole
        if not (math.isclose(c1, h1, rel_tol=1e-5)
                and math.isclose(c2, h2, rel_tol=1e-4) and got <= limit):
            fail(f"small scaled backward {codec}: card losses {c1}, {c2} "
                 f"vs cpu {h1}, {h2}; Adam mu relative L2 {got} "
                 f"(limit {limit})")
        print(json.dumps({"phase": "small_scaled_backward", "codec": codec,
                          "microbatches": 4, "card_losses": [c1, c2],
                          "cpu_losses": [h1, h2],
                          "mu_worst_leaf_rel_l2": max(rel),
                          "mu_tree_rel_l2": whole, "mu_tol": limit,
                          "tol": "loss 1: rel 1e-5, loss 2: rel 1e-4"}))


# Adam's first moment after one f32 step, card against CPU.  Identity:
# both devices compute the same f32 gradient in other summation orders
# (relative error ~1e-6), so the worst leaf within 1e-4, the small
# phase's tolerance.  int8+ef: where the two f32 sums straddle a rounding
# boundary an int8 element moves by one step (its bucket's absmax / 127,
# some 1e-6 of the elements), which in a small leaf alone is several
# 1e-3 of its norm; so the whole tree within 2**-7.  A step that is not
# unscaled is off by 2**15, one that loses a microbatch by ~0.8.
SMALL_MU_TOL = {"identity": 1e-4, "int8+ef": 2.0 ** -7}


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
VLM_PATCHES = 256                  # internvl2-1b's vision prefix
TRANSLATE_B, TRANSLATE_PREFIX, TRANSLATE_NEW = 8, 16, 32
SERVE_B, SERVE_PROMPT, SERVE_NEW = 8, 64, 32
SHORT_PROMPT = 16          # dense_serve, mla_serve, xlstm_serve


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
        # chatglm3-6b's prefill: head dim 128, 32 query heads on 2 kv
        # heads (GQA 16)
        ("dense_d128_self", 1, PREFILL_LEN, PREFILL_LEN, 32, 2, 128, None,
         True, bf, bf),
        # internvl2-1b's prefill: 256 patches + 32768 tokens, 14 query
        # heads on 2 kv heads (GQA 7)
        ("vlm_gqa7_self", 1, VLM_PATCHES + PREFILL_LEN,
         VLM_PATCHES + PREFILL_LEN, 14, 2, 64, None, True, bf, bf),
        # llama4-scout-17b-a16e's prefill: head dim 128, 40 query heads
        # on 8 kv heads (GQA 5)
        ("moe_gqa5_self", 1, PREFILL_LEN, PREFILL_LEN, 40, 8, 128, None,
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
                 "hybrid_window", "dense_d128_self", "vlm_gqa7_self",
                 "moe_gqa5_self"}
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
    result = {"max_abs_err": max_err,
              "mixed_head_dims": attn_mixed_head_dims(FA, q, k, v, gen)}
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
        library_ms, library_kv = None, None
        if q.dtype == k.dtype:
            # GQA: SDPA gets k and v expanded to the query heads (outside
            # the timed call), not enable_gqa=True, so it takes its fused
            # bf16 kernel and not the math path
            group = q.shape[2] // k.shape[2]
            library_kv = "expanded" if group > 1 else "as given"
            qt, kt, vt = (x.transpose(1, 2) for x in (
                q, k.repeat_interleave(group, dim=2),
                v.repeat_interleave(group, dim=2)))
            library_ms = cuda_ms_cold(
                lambda: torch.nn.functional.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=causal), 10)
            del qt, kt, vt
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
            "library_kv": library_kv, "library_enable_gqa": False,
            "bound_ms": bound_ms, "bound_by": bound_by, "flops": flops,
            "bytes": nbytes, "tflops": flops / ms / 1e9,
            "l2": "flushed before each call"}
        print(json.dumps(timing_line))
        result[name] = timing_line
    return result


def attn_mixed_head_dims(FA, q, k, v, gen) -> dict:
    """Mixed head dims (Dv != D, MLA) under ``impl="kernel"`` take the
    chunked route before any launch, as the reference's pallas impl
    takes ``xla_chunked``: bitwise ``impl="chunked"``, no flash launch,
    at a small GQA case (D 64, Dv 32) and at deepseek-v2-236b's head
    dims (D 192 = nope 128 + rope 64, Dv 128); the kernel itself
    refuses Dv != D, and a Dv == D call still launches it once."""
    from repro_torch.kernels import ops
    mla = (_randn((1, 300, 8, 192), torch.bfloat16, gen),
           _randn((1, 300, 8, 192), torch.bfloat16, gen),
           _randn((1, 300, 8, 128), torch.bfloat16, gen))
    cases = {"gqa2_d64_dv32": (q, k, v[..., :32].contiguous()),
             "mla_d192_dv128": mla}
    for name, args in cases.items():
        FA.reset_launches()
        got = ops.flash_attention(*args, impl="kernel")
        want = ops.flash_attention(*args, impl="chunked")
        torch.cuda.synchronize()
        if FA.flash_attention_kernel.launches != 0 \
                or not torch.equal(got, want):
            fail(f"flash attention {name}: impl='kernel' at Dv != D made "
                 f"{FA.flash_attention_kernel.launches} launches or differs "
                 f"from impl='chunked'")
        try:
            FA.flash_attention_kernel(*args)
        except ValueError:
            pass
        else:
            fail(f"flash attention {name}: the kernel took Dv != D")
    FA.reset_launches()
    ops.flash_attention(q, k, v, impl="kernel")
    torch.cuda.synchronize()
    if FA.flash_attention_kernel.launches != 1:
        fail(f"flash attention: a Dv == D call made "
             f"{FA.flash_attention_kernel.launches} launches (want 1)")
    FA.reset_launches()
    line = {"phase": "attn_kernel", "case": "mixed_head_dims",
            "cases": sorted(cases), "kernel_impl_bitwise_chunked": True,
            "flash_launches_at_dv_ne_d": 0, "kernel_refuses_dv_ne_d": True,
            "flash_launches_at_dv_eq_d": 1}
    print(json.dumps(line))
    return line


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
CHECK_LEN = 4096         # tokens of the f32 checks and the hybrid bf16 report
HYBRID_B, HYBRID_PREFIX, HYBRID_NEW = 8, 16, 16
HSERVE_B, HSERVE_PROMPT, HSERVE_NEW = 8, 16, 16


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
    (``phase_f32_prefill``)."""
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
        short = tokens[:, :CHECK_LEN]
        got, short_ms = timed(lambda: prefill_step(short, "kernel"))
        torch.cuda.empty_cache()
        plain, plain_ms = timed(lambda: prefill_step(short, "chunked"))
    diff = logits_diff(f"hybrid prefill {CHECK_LEN}", got, plain)
    ms = statistics.median(runs)
    line = {"phase": "hybrid_prefill", "tokens": PREFILL_LEN,
            "ssd_launches_per_forward": ssd_n,
            "ssd_launches_by_variant": ssd_by_variant,
            "flash_launches_per_forward": fa_n,
            "flash_launches_by_variant": by_variant, "ms_runs": runs,
            "ms_median": ms, "tok_per_s": PREFILL_LEN / ms * 1e3,
            "check_tokens": CHECK_LEN,
            "kernel_ms_check_len": short_ms,
            "plain_chunked_ms_check_len": plain_ms,
            "logits_vs_plain_bf16": diff, "max_memory_allocated": peak}
    print(json.dumps(line))
    return line


def phase_f32_prefill(model, params, K, FA, tag) -> dict:
    """Full width and full depth with the bf16 weights cast to f32 (27 GB
    for zamba2-7b): the prefill step's logits on the first 4096 tokens
    (after the whole vision prefix where the config has one), the kernel
    path (the kernels' f32 variants: every flash attention launch, and
    every SSD launch of the hybrid, on "simt") against the plain chunked
    path, at ``PATH_TOL``.  In bf16, 94 residual blocks of random weights
    carry any last-bit difference to O(0.3) of zamba2-7b's logits
    (PERF.md), so for the hybrid this is the check that holds the kernel
    path; for the dense and vlm families it stands beside the bf16 one."""
    from repro_torch.data import make_pipeline
    from repro_torch.models import build_model
    from repro_torch.tree import tree_map
    cfg = model.cfg
    f32 = build_model(cfg.with_(dtype="float32"))
    params = tree_map(lambda t: t.float(), params)
    torch.cuda.empty_cache()
    batch = make_pipeline(cfg, 1, PREFILL_LEN).batch_at(0)
    batch = {k: torch.from_numpy(v).cuda() for k, v in batch.items()
             if k != "labels"}
    batch["tokens"] = batch["tokens"][:, :CHECK_LEN]
    hybrid = cfg.family == "hybrid"
    cross = cfg.frontend is not None and cfg.frontend.cross_attention
    want = {"flash": cfg.n_layers // cfg.attn_every if hybrid
            else (2 if cross else 1) * cfg.n_layers,
            "ssd": cfg.n_layers if hybrid else 0}

    def prefill_step(impl):
        h = f32.forward(params, batch, attn_impl=impl)
        return f32.head(params, h[:, -1:])[:, 0]

    with torch.no_grad():
        K.reset_launches()
        FA.reset_launches()
        got, ms = timed(lambda: prefill_step("kernel"))
        launches = {
            "flash": dict(FA.flash_attention_kernel.launches_by_variant),
            "ssd": dict(K.ssd_kernel.launches_by_variant)}
        if launches != {"flash": {"sm90": 0, "mma": 0,
                                  "simt": want["flash"]},
                        "ssd": {"sm90": 0, "simt": want["ssd"]}}:
            fail(f"{tag}: launches by variant {launches} (want {want}, "
                 f"all on simt)")
        plain, plain_ms = timed(lambda: prefill_step("chunked"))
    diff = check_logits(f"{tag} prefill {CHECK_LEN}", got, plain)
    line = {"phase": tag, "arch": cfg.name, "tokens": CHECK_LEN,
            "launches_by_variant": launches, "kernel_ms": ms,
            "plain_chunked_ms": plain_ms, "logits_vs_plain": diff,
            "tol": PATH_TOL, "max_abs_logit": plain.abs().max().item()}
    print(json.dumps(line))
    return line


def phase_hybrid_decode(model, params, K, FA) -> dict:
    """8 requests: ``Model.prefill`` over a 16-token prefix, then 16
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
    """``ServeEngine.generate`` on 8 prompts of 16 tokens, 16 new tokens,
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


def phase_prefill(model, params, FA, tag="prefill") -> dict:
    """The prefill step (``forward(attn_impl="kernel")`` and ``head`` on
    the last position, as the reference's dry-run lowers it) on one
    32768-token sequence with the config's frontend: transformer-big's
    256 encoder states (cross-attended, so two launches a layer) or
    internvl2-1b's 256 patch embeddings (a prefix of the query rows, one
    launch a layer at 33024 rows, dropped after the final norm).  Every
    launch on "sm90" (counts reset just before each run, read just
    after); the timed run's logits held against the plain chunked path
    at ``PATH_TOL``; ms, tok/s, peak memory and the top device kernels of
    one profiled run.  With experts (llama4-scout-17b-a16e) the line also
    gives the share of tokens whose expert differs between the two paths
    in each layer (``recorded_routes``): a near-tied route flips under
    bf16 rounding and moves that token's hidden state by O(1).  So over
    ``PATH_TOL`` fails unless the checked (last) token's own expert
    differs between the paths in some layer; ``phase_f32_prefill`` then
    holds the paths at the same limit."""
    from repro_torch.data import make_pipeline
    cfg = model.cfg
    batch = make_pipeline(cfg, 1, PREFILL_LEN).batch_at(0)
    batch = {k: torch.from_numpy(v).cuda() for k, v in batch.items()
             if k != "labels"}
    fe = cfg.frontend
    cross = fe is not None and fe.cross_attention
    n_prefix = fe.n_embeds if fe is not None and not cross else 0
    want = (2 if cross else 1) * cfg.n_layers

    def prefill_step(impl):
        h = model.forward(params, batch, attn_impl=impl)
        if tuple(h.shape) != (1, PREFILL_LEN, cfg.d_model):
            fail(f"{tag}: hidden states {tuple(h.shape)} (the prefix is "
                 f"not dropped?)")
        return model.head(params, h[:, -1:])[:, 0]
    with torch.no_grad():
        with recorded_routes() as routes:
            prefill_step("kernel")                 # warm-up
        torch.cuda.reset_peak_memory_stats()
        runs = []
        for _ in range(3):
            FA.reset_launches()
            logits, ms = timed(lambda: prefill_step("kernel"))
            launches = FA.flash_attention_kernel.launches
            by_variant = dict(FA.flash_attention_kernel.launches_by_variant)
            if launches != want or by_variant != {"sm90": want, "mma": 0,
                                                  "simt": 0}:
                fail(f"{tag}: flash attention launches {launches}, by "
                     f"variant {by_variant} in one forward (want all "
                     f"{want} on sm90)")
            runs.append(ms)
        peak = torch.cuda.max_memory_allocated()
        profiled = top_device_kernels(lambda: prefill_step("kernel"))
        torch.cuda.empty_cache()
        with recorded_routes() as plain_routes:
            plain, plain_ms = timed(lambda: prefill_step("chunked"))
        torch.cuda.empty_cache()
    flips = route_flips(routes, plain_routes) if cfg.moe is not None \
        else None
    if flips is not None and flips["last_token_flipped"]:
        diff = logits_diff(tag, logits, plain)
    else:
        diff = check_logits(tag, logits, plain)
    ms = statistics.median(runs)
    line = {"phase": tag, "arch": cfg.name, "tokens": PREFILL_LEN,
            "frontend_embeddings": fe.n_embeds if fe is not None else 0,
            "cross_attention": cross,
            "query_rows_per_launch": n_prefix + PREFILL_LEN,
            "launches_per_forward": launches,
            "launches_by_variant": by_variant, "ms_runs": runs,
            "ms_median": ms, "tok_per_s": PREFILL_LEN / ms * 1e3,
            "plain_chunked_ms": plain_ms, "logits_vs_plain": diff,
            "tol": PATH_TOL, "max_memory_allocated": peak,
            "profiled": profiled}
    if flips is not None:
        line["routes_vs_plain"] = flips
    print(json.dumps(line))
    return {"launches": launches, **line}


@contextlib.contextmanager
def recorded_routes():
    """Within the block, every ``moe_ffn`` call appends the experts of
    each of its tokens to the yielded list, one tensor a call: top-1,
    the argmax of the f32 router logits (B*S,); top-k, the k expert ids
    sorted (B*S, k), the set ``moe_ffn`` routes to.  Calls ``moe_ffn``
    itself unchanged."""
    from repro_torch.models import layers as L
    inner, routes = L.moe_ffn, []

    def moe_ffn(p, cfg, x, *args, **kw):
        logits = x.reshape(-1, x.shape[-1]).float() @ p["router"]
        k = cfg.moe.top_k
        routes.append(torch.argmax(logits, dim=-1) if k == 1 else
                      torch.topk(logits, k, dim=-1).indices.sort(
                          dim=-1).values)
        return inner(p, cfg, x, *args, **kw)
    L.moe_ffn = moe_ffn
    try:
        yield routes
    finally:
        L.moe_ffn = inner


def route_flips(a: list, b: list) -> dict:
    """Share of tokens whose expert differs between two runs' recorded
    routes, per layer, and whether the last token's differs in any."""
    if len(a) != len(b) or not a:
        fail(f"routes: {len(a)} and {len(b)} moe_ffn calls recorded")
    return {"share_by_layer": [(x != y).reshape(x.shape[0], -1).any(-1)
                               .float().mean().item()
                               for x, y in zip(a, b)],
            "tokens": int(a[0].shape[0]),
            "last_token_flipped": any(bool((x[-1] != y[-1]).any())
                                      for x, y in zip(a, b))}


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


def phase_serve(model, params, FA, tag="serve",
                prompt=SERVE_PROMPT) -> dict:
    """``ServeEngine.generate`` on 8 prompts of ``prompt`` tokens (64, or
    ``SHORT_PROMPT`` where the sequential prefill of a large model would
    take the script's time), 32 new tokens: no encoder states, so no
    kernel launch (the reference's engine passes none); output shape and
    EOS masking asserted."""
    import numpy as np
    from repro_torch.serving import ServeEngine
    prompts = np.random.default_rng(3).integers(
        3, model.cfg.vocab, (SERVE_B, prompt)).astype(np.int32)
    cache_len = prompt + SERVE_NEW + 1
    probe = ServeEngine(model, params, cache_len=cache_len, eos_id=-1)
    probe.generate(prompts[:, :4], max_new=2)     # warm-up
    FA.reset_launches()
    out, ms = timed(lambda: probe.generate(prompts, max_new=SERVE_NEW))
    launches = FA.flash_attention_kernel.launches
    if out.shape != (SERVE_B, SERVE_NEW) or out.dtype != np.int32 \
            or not ((out >= 0) & (out < model.cfg.vocab)).all():
        fail(f"{tag}: output {out.shape} {out.dtype} out of range")
    if launches != 0:
        fail(f"{tag}: {launches} kernel launches without encoder states")
    # prefill and the first token alone: the rest of ``ms`` is decode
    _, pre_ms = timed(lambda: probe.generate(prompts, max_new=1))
    eos = int(out[0, 2])
    masked = ServeEngine(model, params, cache_len=cache_len, eos_id=eos
                         ).generate(prompts, max_new=SERVE_NEW)
    for row in masked:
        hits = np.flatnonzero(row == eos)
        if hits.size and not (row[hits[0]:] == eos).all():
            fail(f"{tag}: row continues after EOS {eos}: {row.tolist()}")
    if not (masked[0, 2:] == eos).all():
        fail(f"{tag}: the first row did not stop at its third token")
    decode_ms = (ms - pre_ms) / (SERVE_NEW - 1)
    line = {"phase": tag, "arch": model.cfg.name, "requests": SERVE_B,
            "prompt": prompt,
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


# ---------------------------------------------------------------------------
# the dense and vlm families, and seamless-m4t-large-v2's training step
# ---------------------------------------------------------------------------

# parameters of the configs that phase_init builds at full width
# (llama4-scout-17b-a16e at depth MOE_DEPTH, deepseek-v2-236b at
# MLA_DEPTH)
FULL_PARAMS = {"transformer-big": 160_365_568, "zamba2-7b": 6_750_840_528,
               "chatglm3-6b": 6_243_584_000, "internvl2-1b": 493_780_992,
               "llama4-scout-17b-a16e": 6_473_180_160,
               "deepseek-v2-236b": 9_153_243_136,
               "xlstm-125m": 220_493_664, "llama3.2-1b": 1_235_814_400}
VLM_B, VLM_PROMPT = 2, 16          # requests and tokens of prefill(embeds=)


def phase_init(model):
    """Full-width weights in bf16 from seed 0, drawn on the card's
    generator layer by layer into their slots; init time, parameter
    count and memory."""
    from repro_torch.tree import tree_flatten
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init(seed=0, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n = sum(t.numel() for t in tree_flatten(params)[0])
    want = FULL_PARAMS[model.cfg.name]
    if n != want:
        fail(f"{model.cfg.name} init: {n} parameters (want {want})")
    print(json.dumps({"phase": "init", "arch": model.cfg.name,
                      "init_s": init_s, "parameters": n,
                      "memory_allocated": torch.cuda.memory_allocated(),
                      "max_memory_allocated":
                          torch.cuda.max_memory_allocated()}))
    return params


def top_device_kernels(fn, n: int = 8) -> dict:
    """One profiled run of ``fn()`` under a CUDA-only ``torch.profiler``:
    its device busy ms and the ``n`` kernels (or copies) with the most
    device time."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if e.device_time_total > 0]
    events.sort(key=lambda e: -e.device_time_total)
    return {"device_busy_ms": sum(e.device_time_total for e in events) / 1e3,
            "top": [{"name": e.key[:90], "ms": e.device_time_total / 1e3,
                     "calls": e.count} for e in events[:n]]}


def phase_vlm_embeds(model, params, FA) -> dict:
    """``Model.prefill(embeds=, tokens=)`` on 2 requests of 256 patch
    embeddings and 16 tokens (the patches one position at a time through
    ``decode_step(input_embeds=)``, then the tokens): its last logits
    against the forward's last position (the kernel path, one "sm90"
    launch a layer at 272 rows) at ``PATH_TOL``, as the translate phase
    holds its logits; cache lengths asserted.  The forward's plain
    chunked path is compared too.  If bf16 rounding alone parts the
    sequential prefill from the forward, the line says so and the same
    comparison with the weights in f32 (the kernel's f32 variant) is
    what holds them, at the same ``PATH_TOL``, as in
    ``phase_f32_prefill``; the bf16 difference must then stay within
    twice the one between the forward's own two bf16 paths (kernel and
    chunked), the rounding's scale in this run, so that a bf16-only
    fault still fails."""
    from repro_torch.data import make_pipeline
    from repro_torch.models import build_model
    from repro_torch.tree import tree_map
    cfg = model.cfg
    batch = make_pipeline(cfg, VLM_B, VLM_PROMPT).batch_at(1)
    toks = torch.from_numpy(batch["tokens"]).cuda()
    fe = torch.from_numpy(batch["frontend"]).cuda()
    n = fe.shape[1] + VLM_PROMPT

    def both(m, p, impl):
        """(forward's last logits, prefill's last logits, its ms)."""
        h = m.forward(p, {"tokens": toks, "frontend": fe}, attn_impl=impl)
        cache = m.init_cache(VLM_B, n, device="cuda")
        (got, cache), ms = timed(lambda: m.prefill(
            p, cache, toks, embeds=fe, attn_impl="kernel"))
        if cache["length"].tolist() != [n] * VLM_B:
            fail(f"vlm prefill(embeds=): lengths {cache['length'].tolist()}")
        return m.head(p, h[:, -1]), got, ms
    with torch.no_grad():
        FA.reset_launches()
        want, got, ms = both(model, params, "kernel")
        fwd = dict(FA.flash_attention_kernel.launches_by_variant)
        if fwd != {"sm90": cfg.n_layers, "mma": 0, "simt": 0}:
            fail(f"vlm forward of {n} rows: launches {fwd}")
        chunked = model.head(params, model.forward(
            params, {"tokens": toks, "frontend": fe},
            attn_impl="chunked")[:, -1])
        f32 = build_model(cfg.with_(dtype="float32"))
        p32 = tree_map(lambda t: t.float(), params)
        FA.reset_launches()
        want32, got32, ms32 = both(f32, p32, "kernel")
        fwd32 = dict(FA.flash_attention_kernel.launches_by_variant)
        if fwd32 != {"sm90": 0, "mma": 0, "simt": cfg.n_layers}:
            fail(f"vlm f32 forward of {n} rows: launches {fwd32}")
        del p32
    bf16 = logits_diff("vlm prefill(embeds=) vs forward, bf16", got, want)
    bf16_within = bf16["max_abs"] <= PATH_TOL["max_abs"] \
        and bf16["rel_l2"] <= PATH_TOL["rel_l2"]
    rounding = logits_diff("vlm chunked forward", chunked, want)
    if not bf16_within and any(bf16[k] > 2 * rounding[k] for k in bf16):
        fail(f"vlm prefill(embeds=) vs forward, bf16: {bf16}, over "
             f"{PATH_TOL} and over twice the forward's own two paths' "
             f"difference {rounding}")
    f32_diff = check_logits("vlm prefill(embeds=) vs forward, f32", got32,
                            want32)
    line = {"phase": "vlm_embeds", "requests": VLM_B,
            "patches": fe.shape[1], "tokens": VLM_PROMPT,
            "forward_launches_by_variant": fwd, "prefill_ms": ms,
            "ms_per_position": ms / n, "logits_vs_forward_bf16": bf16,
            "bf16_within_path_tol": bf16_within,
            "chunked_forward_vs_kernel_forward_bf16": rounding,
            "prefill_vs_chunked_forward_bf16": logits_diff(
                "vlm prefill vs chunked", got, chunked),
            "f32": {"forward_launches_by_variant": fwd32,
                    "prefill_ms": ms32, "logits_vs_forward": f32_diff},
            "tol": PATH_TOL}
    print(json.dumps(line))
    return line


def phase_small_dense() -> None:
    """The reduced llama3.2-1b, chatglm3-6b (q/k/v biases drawn non-zero)
    and internvl2-1b in f32: the prefill step's forward, a 4-token
    prefill (after the 16 patches for internvl2) and 4 teacher-forced
    decode steps on the card (the kernel's f32 path) and on the CPU (its
    plain version), logits within 3e-5."""
    from repro_torch.configs import get_config
    from repro_torch.data import make_pipeline
    from repro_torch.models import build_model
    from repro_torch.tree import tree_map
    tol = ATTN_TOL[torch.float32]
    for arch in ("llama3.2-1b", "chatglm3-6b", "internvl2-1b"):
        model = build_model(get_config(arch).reduced())
        cpu = model.init(seed=0, device="cpu")
        gen = torch.Generator().manual_seed(4)
        attn = cpu["layers"]["attn"]
        for name in ("bq", "bk", "bv"):
            if name in attn:
                attn[name] = torch.randn(attn[name].shape, generator=gen)
        card = tree_map(lambda t: t.cuda(), cpu)
        batch = make_pipeline(model.cfg, 2, 16).batch_at(0)
        outs = []
        with torch.no_grad():
            for dev, params in (("cuda", card), ("cpu", cpu)):
                b = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
                fe = b.get("frontend")
                h = model.forward(params, b, attn_impl="kernel")
                logits = [model.head(params, h[:, -1])]
                n = (fe.shape[1] if fe is not None else 0) + 8
                cache = model.init_cache(2, n, device=dev)
                lg, cache = model.prefill(params, cache, b["tokens"][:, :4],
                                          embeds=fe, attn_impl="kernel")
                logits.append(lg)
                for i in range(4, 8):
                    lg, cache = model.decode_step(
                        params, cache, b["tokens"][:, i:i + 1],
                        attn_impl="kernel")
                    logits.append(lg)
                outs.append([x.cpu() for x in logits])
        worst = 0.0
        for i, (a, c) in enumerate(zip(*outs)):
            err = (a - c).abs().max().item()
            worst = max(worst, err)
            if not torch.allclose(a, c, **tol):
                fail(f"small dense {arch}: logits {i} card vs cpu max abs "
                     f"err {err}")
        print(json.dumps({"phase": "small_dense", "arch": arch,
                          "steps": len(outs[0]), "max_abs_err": worst,
                          "tol": tol}))


# ---------------------------------------------------------------------------
# the moe family: llama4-scout-17b-a16e at full width, depth cut to 2
# ---------------------------------------------------------------------------

MOE_ARCH, MOE_DEPTH = "llama4-scout-17b-a16e", 2
MOE_B, MOE_PREFIX, MOE_NEW = 8, 16, 16
MOE_DECODE_MODES = (("dropless", {"moe_mode": "dropless"}, None),
                    ("capacity", {"moe_mode": "capacity"}, None))


def phase_moe_decode(model, params, FA, tag="moe_decode",
                     modes=MOE_DECODE_MODES) -> dict:
    """8 requests: a 16-token sequential prefill (the default decode:
    dropless, absorbed), then 16 greedy ``decode_step``s in the first of
    ``modes`` and the same 16 steps teacher-forced on those tokens in
    the second; a mode is (name, ``decode_step`` keywords, a context
    manager or None).  Scout: ``moe_mode="dropless"`` against
    ``"capacity"`` (a step has t = 8 tokens, so cap = min(max(8,
    ceil(4 t k / E)), t) = 8 = t: nothing drops); deepseek-v2: the
    absorbed MLA decode against the naive one (``naive_mla``).  The two
    agree within bf16 rounding: every step's logits at ``PATH_TOL`` on
    the requests whose experts (the top-k set) were the same in both
    modes (``recorded_routes``: a near-tied route flips under a last-bit
    difference, and the request's logits then part by O(1)): in every
    layer at that step, and in the layers before the last (whose outputs
    the cache carries) at every earlier step; the flips are reported,
    and every request flipped before the last layer fails.  ms a step,
    device busy and idle share of one step; no kernel launch (cached
    attention is plain PyTorch)."""
    from repro_torch.data import make_pipeline
    cfg = model.cfg
    prefix = torch.from_numpy(make_pipeline(
        cfg, MOE_B, MOE_PREFIX).batch_at(1)["tokens"]).cuda()
    out, toks = {}, None
    with torch.no_grad():
        FA.reset_launches()
        cache = model.init_cache(MOE_B, MOE_PREFIX + MOE_NEW, device="cuda")
        (first, start), pre_ms = timed(lambda: model.prefill(params, cache,
                                                             prefix))

        def steps(kw, stream):
            logits, c, got, fed = first, start, [], []
            for i in range(MOE_NEW):
                tok = (torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
                       if stream is None else stream[:, i:i + 1])
                fed.append(tok)
                logits, c = model.decode_step(params, c, tok, **kw)
                got.append(logits)
            return torch.stack(got, 1), torch.cat(fed, 1), c

        for mode, kw, ctx in modes:
            with ctx() if ctx is not None else contextlib.nullcontext():
                (logits, fed, c), ms = timed(lambda: steps(kw, toks))
                toks = fed if toks is None else toks
                with recorded_routes() as routes:
                    steps(kw, toks)
                tok = toks[:, -1:]
                busy = top_device_kernels(lambda: model.decode_step(
                    params, c, tok, **kw))
                _, one_ms = timed(lambda: model.decode_step(params, c, tok,
                                                            **kw))
            if tuple(logits.shape) != (MOE_B, MOE_NEW, cfg.vocab) \
                    or not torch.isfinite(logits).all() \
                    or int(c["length"][0]) != MOE_PREFIX + MOE_NEW:
                fail(f"{tag} {mode}: logits {tuple(logits.shape)}, "
                     f"lengths {c['length'].tolist()}")
            out[mode] = {"logits": logits, "decode_ms_per_step": ms / MOE_NEW,
                         "routes": torch.stack(routes).view(
                             MOE_NEW, cfg.n_layers, MOE_B, -1),
                         "one_step_ms": one_ms,
                         "device_busy_ms": busy["device_busy_ms"],
                         "idle_share": 1 - busy["device_busy_ms"] / one_ms,
                         "top": busy["top"][:4]}
        launches = FA.flash_attention_kernel.launches
    if launches != 0:
        fail(f"{tag}: {launches} flash attention launches (want 0)")
    (a, _, _), (b, _, _) = modes
    flip = (out[a]["routes"] != out[b]["routes"]).any(dim=3)  # (steps, L, B)
    # a flip before the last layer parts the request's cache from that
    # step on; one in the last layer parts only that step's logits
    flipped = torch.cumsum(flip[:, :-1].any(dim=1).int(), dim=0) > 0
    if bool(flipped[-1].all()):
        fail(f"{tag}: every request's experts differ between {a} and {b}")
    excluded = flipped | flip[:, -1]                          # (steps, B)
    worst = {"max_abs": 0.0, "rel_l2": 0.0}
    for i in range(MOE_NEW):
        keep = ~excluded[i]
        d = check_logits(f"{tag} {b} vs {a}, step {i}",
                         out[b]["logits"][keep, i],
                         out[a]["logits"][keep, i])
        worst = {k: max(worst[k], d[k]) for k in worst}
    line = {"phase": tag, "arch": cfg.name, "depth": cfg.n_layers,
            "requests": MOE_B, "prefix": MOE_PREFIX, "new_tokens": MOE_NEW,
            "launches": launches, "prefill_ms": pre_ms,
            **{mode: {k: v for k, v in o.items()
                      if k not in ("logits", "routes")}
               for mode, o in out.items()},
            f"{b}_vs_{a}_worst": worst, "tol": PATH_TOL,
            "requests_with_a_flipped_route": int(flipped[-1].sum()),
            "last_layer_flips": int(flip[:, -1].sum()),
            "rows_compared": int((~excluded).sum()),
            "first_row_tokens": toks[0].tolist()}
    print(json.dumps(line))
    return line


SMALL_MOE_STEPS = (("dropless", {"moe_mode": "dropless"}, None),) * 2 + (
    ("capacity", {"moe_mode": "capacity"}, None),) * 2


def phase_small_moe(FA, arch=MOE_ARCH, tag="small_moe",
                    steps=SMALL_MOE_STEPS) -> dict:
    """The reduced ``arch`` in f32 (4 experts): the prefill step's
    forward (last logits and the aux loss; one flash launch a layer, on
    "simt"), a 4-token prefill and 4 teacher-forced decode steps, each in
    its mode of ``steps`` (scout: two dropless, two capacity;
    deepseek-v2: two absorbed, two naive MLA decodes), on the card (the
    kernel's f32 path) and on the CPU (its plain version), from the
    CPU's weights, within 3e-5.  Returns the card's flash launches."""
    from repro_torch.configs import get_config
    from repro_torch.data import make_pipeline
    from repro_torch.models import build_model
    model = build_model(get_config(arch).reduced())
    batch = make_pipeline(model.cfg, 2, 16).batch_at(0)
    tol = ATTN_TOL[torch.float32]
    outs = []
    with torch.no_grad():
        for dev in ("cuda", "cpu"):
            params = host_weights(model, 0, dev)
            t = torch.from_numpy(batch["tokens"]).to(dev)
            FA.reset_launches()
            h, aux = model.forward_aux(params, {"tokens": t},
                                       attn_impl="kernel")
            if dev == "cuda":
                launches = dict(FA.flash_attention_kernel.launches_by_variant)
                if launches != {"sm90": 0, "mma": 0,
                                "simt": model.cfg.n_layers}:
                    fail(f"{tag}: flash launches {launches} (want "
                         f"{model.cfg.n_layers} on simt)")
            logits = [model.head(params, h[:, -1]), aux[None]]
            cache = model.init_cache(2, 8, device=dev)
            lg, cache = model.prefill(params, cache, t[:, :4])
            logits.append(lg)
            for i, (_, kw, ctx) in zip(range(4, 8), steps):
                with ctx() if ctx is not None else contextlib.nullcontext():
                    lg, cache = model.decode_step(params, cache,
                                                  t[:, i:i + 1], **kw)
                logits.append(lg)
            outs.append([x.cpu() for x in logits])
    worst = 0.0
    for i, (a, c) in enumerate(zip(*outs)):
        err = (a - c).abs().max().item()
        worst = max(worst, err)
        if not torch.allclose(a, c, **tol):
            fail(f"{tag}: output {i} card vs cpu max abs err {err}")
    line = {"phase": tag, "arch": model.cfg.name, "outputs": len(outs[0]),
            "decode_modes": [m for m, _, _ in steps],
            "aux_card": outs[0][1].item(), "flash_launches_by_variant":
                launches, "max_abs_err": worst, "tol": tol}
    print(json.dumps(line))
    return line


# ---------------------------------------------------------------------------
# MLA: deepseek-v2-236b at full width, depth cut to 2
# ---------------------------------------------------------------------------

MLA_ARCH, MLA_DEPTH = "deepseek-v2-236b", 2


@contextlib.contextmanager
def naive_mla():
    """Within the block, ``layers.mla_attention`` decodes without
    absorption (``absorbed=False``: the compressed cache decompressed
    into per-head keys and values, then ``decode_attention``), a path
    ``decode_step`` takes no argument for, as the reference's takes
    none."""
    from repro_torch.models import layers as L
    inner = L.mla_attention

    def naive(*args, **kw):
        return inner(*args, **{**kw, "absorbed": False})
    L.mla_attention = naive
    try:
        yield
    finally:
        L.mla_attention = inner


MLA_DECODE_MODES = (("absorbed", {}, None), ("naive", {}, naive_mla))
SMALL_MLA_STEPS = (("absorbed", {}, None),) * 2 + (
    ("naive", {}, naive_mla),) * 2


def phase_mla_prefill(model, params, FA) -> dict:
    """deepseek-v2-236b's prefill step (``forward(attn_impl="kernel")``
    and ``head`` on the last position) on one 32768-token sequence.  Its
    q·k head dim (nope 128 + rope 64 = 192) is not its v head dim (128),
    so "kernel" takes the chunked route, as the reference's pallas impl
    takes xla_chunked: no flash launch (counts reset just before, read
    just after).  One timed run (its kernels ran in earlier phases),
    peak memory, the top device kernels of a profiled run; then the
    hidden states of "kernel" and "chunked" on the first 4096 tokens
    bitwise equal."""
    from repro_torch.data import make_pipeline
    cfg = model.cfg
    tokens = torch.from_numpy(make_pipeline(cfg, 1, PREFILL_LEN).batch_at(0)[
        "tokens"]).cuda()

    def hidden(impl, n=PREFILL_LEN):
        return model.forward(params, {"tokens": tokens[:, :n]},
                             attn_impl=impl)

    def prefill_step():
        return model.head(params, hidden("kernel")[:, -1:])[:, 0]

    with torch.no_grad():
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        FA.reset_launches()
        logits, ms = timed(prefill_step)
        launches = FA.flash_attention_kernel.launches
        peak = torch.cuda.max_memory_allocated()
        profiled = top_device_kernels(prefill_step)
        if launches != 0:
            fail(f"mla prefill: {launches} flash launches at Dv != D "
                 f"(want 0: the chunked route)")
        if tuple(logits.shape) != (1, cfg.vocab) \
                or not torch.isfinite(logits).all():
            fail(f"mla prefill: logits {tuple(logits.shape)} or not finite")
        torch.cuda.empty_cache()
        same = torch.equal(hidden("kernel", CHECK_LEN),
                           hidden("chunked", CHECK_LEN))
        torch.cuda.empty_cache()
    if not same:
        fail(f"mla prefill: attn_impl='kernel' differs from 'chunked' on "
             f"{CHECK_LEN} tokens at Dv != D")
    line = {"phase": "mla_prefill", "arch": cfg.name, "depth": cfg.n_layers,
            "tokens": PREFILL_LEN, "qk_head_dim":
                cfg.mla.nope_dim + cfg.mla.rope_dim,
            "v_head_dim": cfg.mla.v_dim, "flash_launches": launches,
            "ms": ms, "tok_per_s": PREFILL_LEN / ms * 1e3,
            "idle_share": 1 - profiled["device_busy_ms"] / ms,
            "max_memory_allocated": peak, "profiled": profiled,
            f"kernel_bitwise_chunked_{CHECK_LEN}": same}
    print(json.dumps(line))
    return line


def phase_mla_wide_f32(FA) -> dict:
    """The reduced deepseek-v2 (d 128, 4 heads, 4 experts, f32) with the
    full config's own MLA (kv_lora 512, q·k 128 + 64 = 192, v 128): the
    one place mixed head dims meet a CPU result.  From the CPU's
    weights, on the card and on the CPU: the forward over 2 x 256 tokens
    through "kernel" (the chunked route: no flash launch), every
    position's logits and the aux loss; then 8 teacher-forced decode
    steps from an empty cache, absorbed and naive.  Card against CPU
    within 3e-5; absorbed against naive and the last decode step
    against the forward within 2e-4, at capacity factor 4 (no token
    drops in the forward), as tests/test_decode.py."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.data import make_pipeline
    from repro_torch.models import build_model
    cfg = get_config(MLA_ARCH).reduced()
    model = build_model(cfg.with_(
        mla=get_config(MLA_ARCH).mla,
        moe=dataclasses.replace(cfg.moe, capacity_factor=4.0)))
    tokens = make_pipeline(model.cfg, 2, 256).batch_at(0)["tokens"]
    tol, self_tol = ATTN_TOL[torch.float32], dict(rtol=2e-4, atol=2e-4)
    outs = {}
    with torch.no_grad():
        for dev in ("cuda", "cpu"):
            params = host_weights(model, 0, dev)
            t = torch.from_numpy(tokens).to(dev)
            FA.reset_launches()
            h, aux = model.forward_aux(params, {"tokens": t},
                                       attn_impl="kernel")
            if dev == "cuda" and FA.flash_attention_kernel.launches:
                fail(f"mla wide f32: {FA.flash_attention_kernel.launches} "
                     f"flash launches at Dv != D (want 0)")
            got = {"forward": model.head(params, h), "aux": aux[None]}
            for mode, _, ctx in MLA_DECODE_MODES:
                cache = model.init_cache(2, 8, device=dev)
                steps = []
                with ctx() if ctx is not None else contextlib.nullcontext():
                    for i in range(8):
                        lg, cache = model.decode_step(params, cache,
                                                      t[:, i:i + 1])
                        steps.append(lg)
                got[mode] = torch.stack(steps, 1)
            outs[dev] = {k: v.cpu() for k, v in got.items()}
    errs = {}
    for k in outs["cuda"]:
        a, c = outs["cuda"][k], outs["cpu"][k]
        errs[k] = (a - c).abs().max().item()
        if not torch.allclose(a, c, **tol):
            fail(f"mla wide f32: {k} card vs cpu max abs err {errs[k]}")
    card = outs["cuda"]
    pairs = {"naive_vs_absorbed": (card["naive"], card["absorbed"]),
             "decode_vs_forward": (card["absorbed"][:, -1],
                                   card["forward"][:, 7])}
    self_errs = {}
    for k, (a, c) in pairs.items():
        self_errs[k] = (a - c).abs().max().item()
        if not torch.allclose(a, c, **self_tol):
            fail(f"mla wide f32: {k} max abs err {self_errs[k]}")
    line = {"phase": "mla_wide_f32", "arch": model.cfg.name,
            "mla": {"kv_lora": 512, "qk_head_dim": 192, "v_head_dim": 128},
            "tokens": list(tokens.shape), "decode_steps": 8,
            "card_vs_cpu_max_abs": errs, "tol": tol,
            "on_card_max_abs": self_errs, "self_tol": self_tol}
    print(json.dumps(line))
    return line


# ---------------------------------------------------------------------------
# the ssm family: xlstm-125m at full width
# ---------------------------------------------------------------------------

XLSTM_ARCH, XLSTM_PREFILL, XLSTM_PROFILED = "xlstm-125m", 2048, 64
XLSTM_F32_LEN = 256                # tokens of the card-vs-CPU check
# the depth of the tight f32 checks: block 0 (mLSTM) and block 1 (sLSTM)
# of the full-width weights.  At full depth the random 12-block model
# turns summation-order differences into O(1e-3) of its logits: an mLSTM
# step divides by max(|q.n|, exp(-m)), so a block can scale its input's
# perturbations by exp(i) (the reference's own decode and forward part
# there by more than 2e-4 too), so full depth is held at ``PATH_TOL``.
XLSTM_CHECK_DEPTH = 2
XLSTM_DECODE_TOL = dict(rtol=2e-4, atol=2e-4)      # tests/test_decode.py


def xlstm_depth(model, params, n):
    """The model cut to its first ``n`` blocks, over views of the same
    weights."""
    from repro_torch.models import build_model
    from repro_torch.tree import tree_map
    return build_model(model.cfg.with_(n_layers=n)), {
        k: tree_map(lambda t: t[:n], v) if k in ("mlstm", "slstm") else v
        for k, v in params.items()}


def phase_xlstm_prefill(model, params) -> dict:
    """xlstm-125m's prefill step (``forward`` and ``head`` on the last
    position; no attention, so no kernel) on one sequence of 2048
    tokens in bf16, timed, with peak memory; the relative L2 of its
    logits and of every position's hidden states against the same
    weights cast to f32 (reported: bf16 rounding, carried through 12
    random blocks); the device busy ms, idle share and top device
    kernels of a profiled 64-token forward (the recurrence runs one
    eager step at a time, ~12 launches a step and mLSTM block)."""
    from repro_torch.data import make_pipeline
    from repro_torch.models import build_model
    from repro_torch.tree import tree_map
    cfg = model.cfg
    tokens = torch.from_numpy(make_pipeline(cfg, 1, XLSTM_PREFILL).batch_at(
        0)["tokens"]).cuda()
    f32 = build_model(cfg.with_(dtype="float32"))
    params32 = tree_map(lambda t: t.float(), params)

    def step(m, p, n=XLSTM_PREFILL):
        h = m.forward(p, {"tokens": tokens[:, :n]})
        return h, m.head(p, h[:, -1:])[:, 0]

    with torch.no_grad():
        torch.cuda.reset_peak_memory_stats()
        (h, logits), ms = timed(lambda: step(model, params))
        peak = torch.cuda.max_memory_allocated()
        (h32, logits32), ms32 = timed(lambda: step(f32, params32))
        _, short_ms = timed(lambda: step(model, params, XLSTM_PROFILED))
        profiled = top_device_kernels(
            lambda: step(model, params, XLSTM_PROFILED))
    if tuple(logits.shape) != (1, cfg.vocab) \
            or not torch.isfinite(logits).all():
        fail(f"xlstm prefill: logits {tuple(logits.shape)} or not finite")
    line = {"phase": "xlstm_prefill", "arch": cfg.name,
            "tokens": XLSTM_PREFILL, "dtype": cfg.dtype, "ms": ms,
            "tok_per_s": XLSTM_PREFILL / ms * 1e3,
            "max_memory_allocated": peak, "f32_ms": ms32,
            "logits_vs_f32": logits_diff("xlstm prefill", logits, logits32),
            "hidden_vs_f32": logits_diff("xlstm prefill", h, h32),
            "profiled_tokens": XLSTM_PROFILED, "profiled_wall_ms": short_ms,
            "idle_share": 1 - profiled["device_busy_ms"] / short_ms,
            "profiled": profiled}
    print(json.dumps(line))
    return line


def xlstm_teacher_forced(model, params, stream, n_prefix):
    """``prefill`` over ``stream[:, :n_prefix]``, then a ``decode_step``
    for each later token but the last: (B, S - n_prefix, vocab) logits,
    row j at position n_prefix - 1 + j."""
    b, n = stream.shape
    got, c = model.prefill(params, model.init_cache(b, n, device="cuda"),
                           stream[:, :n_prefix])
    rows = [got]
    for i in range(n_prefix, n - 1):
        got, c = model.decode_step(params, c, stream[:, i:i + 1])
        rows.append(got)
    return torch.stack(rows, 1)


def phase_xlstm_decode(model, params) -> dict:
    """8 requests: ``Model.prefill`` over a 16-token prefix and 16 greedy
    ``decode_step``s in bf16 (ms a step, device busy and idle share of
    one step; no kernel); then, with the weights cast to f32, those 32
    tokens teacher-forced through prefill and decode, every step's
    logits against the f32 forward's at the same position: within 2e-4
    (tests/test_decode.py's tolerance) on the first ``XLSTM_CHECK_DEPTH``
    blocks (one mLSTM, one sLSTM), and at ``PATH_TOL`` at full depth."""
    from repro_torch.data import make_pipeline
    from repro_torch.models import build_model
    from repro_torch.tree import tree_map
    cfg = model.cfg
    prefix = torch.from_numpy(make_pipeline(
        cfg, MOE_B, MOE_PREFIX).batch_at(1)["tokens"]).cuda()
    n = MOE_PREFIX + MOE_NEW
    with torch.no_grad():
        cache = model.init_cache(MOE_B, n, device="cuda")
        (logits, cache), pre_ms = timed(lambda: model.prefill(params, cache,
                                                              prefix))
        toks = [prefix]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(MOE_NEW):
            tok = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
            toks.append(tok)
            logits, cache = model.decode_step(params, cache, tok)
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1e3 / MOE_NEW
        busy = top_device_kernels(lambda: model.decode_step(params, cache,
                                                            tok))
        _, one_ms = timed(lambda: model.decode_step(params, cache, tok))
        if int(cache["length"][0]) != n or not torch.isfinite(logits).all():
            fail(f"xlstm decode: length {cache['length'].tolist()} or "
                 f"logits not finite")
        stream = torch.cat(toks, 1)[:, :n]
        f32 = build_model(cfg.with_(dtype="float32"))
        p32 = tree_map(lambda t: t.float(), params)
        diffs = {}
        for depth in (XLSTM_CHECK_DEPTH, cfg.n_layers):
            m, p = xlstm_depth(f32, p32, depth)
            want = m.head(p, m.forward(p, {"tokens": stream}))[
                :, MOE_PREFIX - 1:n - 1]
            got = xlstm_teacher_forced(m, p, stream, MOE_PREFIX)
            diffs[depth] = logits_diff(f"xlstm decode depth {depth}", got,
                                       want)
            if depth == XLSTM_CHECK_DEPTH \
                    and not torch.allclose(got, want, **XLSTM_DECODE_TOL):
                fail(f"xlstm decode: f32 decode vs forward at depth {depth}: "
                     f"{diffs[depth]} (tol {XLSTM_DECODE_TOL})")
    full = check_logits("xlstm decode f32 vs forward, full depth",
                        got, want)
    line = {"phase": "xlstm_decode", "arch": cfg.name, "requests": MOE_B,
            "prefix": MOE_PREFIX, "new_tokens": MOE_NEW, "prefill_ms": pre_ms,
            "decode_ms_per_step": step_ms, "one_step_ms": one_ms,
            "device_busy_ms": busy["device_busy_ms"],
            "idle_share": 1 - busy["device_busy_ms"] / one_ms,
            "top": busy["top"][:4],
            "f32_decode_vs_forward": {
                f"depth_{XLSTM_CHECK_DEPTH}": diffs[XLSTM_CHECK_DEPTH],
                f"depth_{cfg.n_layers}": full},
            "tol": {f"depth_{XLSTM_CHECK_DEPTH}": XLSTM_DECODE_TOL,
                    f"depth_{cfg.n_layers}": PATH_TOL},
            "first_row_tokens": stream[0, MOE_PREFIX:].tolist()}
    print(json.dumps(line))
    return line


def phase_xlstm_f32() -> dict:
    """Full-width xlstm-125m in f32 from the CPU's draws, on the card and
    on the CPU: every position's logits of an ``XLSTM_F32_LEN``-token
    forward, within
    ``ATTN_TOL``'s f32 3e-5 on the first ``XLSTM_CHECK_DEPTH`` blocks
    and at ``PATH_TOL`` at full depth."""
    from repro_torch.configs import get_config
    from repro_torch.data import make_pipeline
    from repro_torch.models import build_model
    from repro_torch.tree import tree_map
    model = build_model(get_config(XLSTM_ARCH).with_(dtype="float32"))
    tokens = make_pipeline(model.cfg, 1, XLSTM_F32_LEN).batch_at(0)["tokens"]
    cpu = model.init(seed=0, device="cpu")
    weights = {"cuda": tree_map(lambda t: t.cuda(), cpu), "cpu": cpu}
    tol = ATTN_TOL[torch.float32]
    outs, ms = {}, {}
    with torch.no_grad():
        for dev, params in weights.items():
            t = torch.from_numpy(tokens).to(dev)
            for depth in (XLSTM_CHECK_DEPTH, model.cfg.n_layers):
                m, p = xlstm_depth(model, params, depth)
                t0 = time.perf_counter()
                outs[dev, depth] = m.head(p, m.forward(
                    p, {"tokens": t})).cpu()
                ms[f"{dev}_depth_{depth}"] = (time.perf_counter() - t0) * 1e3
    del weights, cpu
    short = (outs["cuda", XLSTM_CHECK_DEPTH], outs["cpu", XLSTM_CHECK_DEPTH])
    if not torch.allclose(*short, **tol):
        fail(f"xlstm f32 depth {XLSTM_CHECK_DEPTH}: card vs cpu "
             f"{logits_diff('xlstm f32', *short)} (tol {tol})")
    full = check_logits("xlstm f32 card vs cpu, full depth",
                        outs["cuda", model.cfg.n_layers],
                        outs["cpu", model.cfg.n_layers])
    line = {"phase": "xlstm_f32", "arch": model.cfg.name,
            "tokens": XLSTM_F32_LEN, "card_vs_cpu": {
                f"depth_{XLSTM_CHECK_DEPTH}": logits_diff("xlstm f32",
                                                          *short),
                f"depth_{model.cfg.n_layers}": full},
            "tol": {f"depth_{XLSTM_CHECK_DEPTH}": tol,
                    f"depth_{model.cfg.n_layers}": PATH_TOL}, "ms": ms,
            "max_abs_logit": outs["cpu", model.cfg.n_layers].abs().max(
                ).item()}
    print(json.dumps(line))
    return line


def phase_small_xlstm(train) -> dict:
    """The reduced xlstm-125m in f32 (2 layers: mLSTM, sLSTM) on the card
    and on the CPU from the CPU's weights: the forward's last logits, a
    4-token prefill and 4 teacher-forced decode steps within 3e-5; and
    2 launcher steps (dense_reduce, identity wire) with losses within
    rel 1e-4, as ``phase_small_reference``."""
    from repro_torch.configs import get_config
    from repro_torch.data import make_pipeline
    from repro_torch.models import build_model
    model = build_model(get_config(XLSTM_ARCH).reduced())
    batch = make_pipeline(model.cfg, 2, 16).batch_at(0)
    tol = ATTN_TOL[torch.float32]
    outs = []
    with torch.no_grad():
        for dev in ("cuda", "cpu"):
            params = host_weights(model, 0, dev)
            t = torch.from_numpy(batch["tokens"]).to(dev)
            logits = [model.head(params, model.forward(
                params, {"tokens": t})[:, -1])]
            cache = model.init_cache(2, 8, device=dev)
            lg, cache = model.prefill(params, cache, t[:, :4])
            logits.append(lg)
            for i in range(4, 8):
                lg, cache = model.decode_step(params, cache, t[:, i:i + 1])
                logits.append(lg)
            outs.append([x.cpu() for x in logits])
    worst = 0.0
    for i, (a, c) in enumerate(zip(*outs)):
        err = (a - c).abs().max().item()
        worst = max(worst, err)
        if not torch.allclose(a, c, **tol):
            fail(f"small xlstm: output {i} card vs cpu max abs err {err}")
    args = ["--arch", XLSTM_ARCH, "--reduced", "--dist", "horovod",
            "--grad-accum", "dense_reduce", "--batch-per-worker", "4",
            "--seq-len", "32", "--steps", "2", "--log-every", "1"]
    quiet = lambda s: None
    with host_drawn_init():
        card = train.run(args + ["--device", "cuda"], log=quiet)["history"]
    cpu = train.run(args + ["--device", "cpu"], log=quiet)["history"]
    lc, lh = [h["loss"] for h in card], [h["loss"] for h in cpu]
    if len(lc) != 2 or not all(math.isclose(x, y, rel_tol=1e-4)
                               for x, y in zip(lc, lh)):
        fail(f"small xlstm: card losses {lc} vs cpu {lh}")
    line = {"phase": "small_xlstm", "outputs": len(outs[0]),
            "max_abs_err": worst, "tol": tol, "card_losses": lc,
            "cpu_losses": lh}
    print(json.dumps(line))
    return line


# ---------------------------------------------------------------------------
# serving: the paged continuous batcher and the int8 hot swap
# ---------------------------------------------------------------------------

SERVING_ARCH = "llama3.2-1b"
# 8 slots of 1024 tokens in blocks of 16: the dense cache is 512 blocks
# (256 MiB in bf16); the pool has 96 (48 MiB), short of the 24 requests'
# load, so it runs dry and preempts; the longest request (512 + 32
# tokens, 34 blocks) fits alone
SERVING = dict(n_slots=8, cache_len=1024, block_size=16, n_blocks=96)
SERVING_CHUNK, SERVING_REQUESTS, SERVING_NEW = 64, 24, 32
SERVING_PROMPTS = (16, 512)        # prompt lengths drawn in this range
SERVING_SWAP_AFTER = 8             # completions before the swap starts
SERVING_FUSION = 128 << 20         # the paper's Horovod fusion buffer
# the bound of a swap's encodes: one read of each bf16 leaf, one write of
# its int8 values; the design reads each leaf twice (absmax, then q)
SWAP_BOUND_BYTES, SWAP_DESIGN_BYTES = 3, 5
# f32 exactness of the batcher against ServeEngine (the PR 25 rule, fixed
# before the first run): every compared step's emitted logits within
# these; a token may differ only where the engine's top-2 margin at that
# step is below 2 x max_abs, and that request's later steps are not
# compared (their inputs differ); such flips are counted
SERVE_F32_TOL = dict(max_abs=1e-3, rel_l2=1e-4)
SMALL_SERVE_TOL = dict(max_abs=1e-4, rel_l2=3e-5)
SMALL_SERVE_ARCHS = ("llama3.2-1b", "deepseek-v2-236b", "zamba2-7b",
                     "xlstm-125m")


@contextlib.contextmanager
def recorded_quantize(ops):
    """Within the block every stateless encode that ``ops.quantize_int8``
    launches is recorded as (input, q, scale), and every call of its
    plain version on a CUDA tensor is counted (there must be none)."""
    kernel, plain = ops.quantize_kernel, ops.quantize_plain
    rec = {"launches": [], "plain_on_cuda": 0}

    def launch(flat):
        q, scale = kernel(flat)
        rec["launches"].append((flat, q, scale))
        return q, scale

    def plain_version(flat):
        rec["plain_on_cuda"] += int(flat.is_cuda)
        return plain(flat)
    ops.quantize_kernel, ops.quantize_plain = launch, plain_version
    try:
        yield rec
    finally:
        ops.quantize_kernel, ops.quantize_plain = kernel, plain


def check_swap_launches(tag, Q, rec, plan) -> dict:
    """The swap's encodes: exactly one stateless launch a plan bucket,
    no fused encode, no decode-sum, no plain encode on the card, and
    every launch's (q, scale) bitwise ``quantize_plain`` on its input."""
    stateless = Q.quantize_kernel.launches - Q.quantize_ef_kernel.launches
    n = len(plan.dense_buckets)
    if (stateless, len(rec["launches"]), Q.quantize_ef_kernel.launches,
            Q.decode_sum_kernel.launches, rec["plain_on_cuda"]) \
            != (n, n, 0, 0, 0):
        fail(f"{tag}: {stateless} stateless encodes ({len(rec['launches'])}"
             f" recorded), {Q.quantize_ef_kernel.launches} fused, "
             f"{Q.decode_sum_kernel.launches} decode-sums, "
             f"{rec['plain_on_cuda']} plain encodes on the card for "
             f"{n} buckets")
    for i, (flat, q, scale) in enumerate(rec["launches"]):
        pq, ps = Q.quantize_plain(flat)
        if not (torch.equal(q, pq) and bits_equal(scale, ps)):
            fail(f"{tag}: bucket {i} ({flat.numel()} {flat.dtype}) differs "
                 f"from quantize_plain")
    return {"buckets": n, "launches": stateless,
            "bucket_elems": [int(f.numel()) for f, _, _ in rec["launches"]],
            "bucket_dtypes": sorted({str(f.dtype).split(".")[-1]
                                     for f, _, _ in rec["launches"]}),
            "bitwise_vs_plain": True}


def serving_requests(Request, vocab: int, n: int, lens, max_new: int,
                     seed: int = 0):
    """``n`` requests with prompt lengths in ``lens`` and priorities 0
    and 5, drawn with numpy from ``seed``; EOS is never emitted (id -1),
    so every request takes ``max_new`` tokens."""
    import numpy as np
    rng = np.random.default_rng(seed)
    out = []
    for uid in range(n):
        length = int(rng.integers(lens[0], lens[1] + 1))
        out.append(Request(uid=uid, prompt=rng.integers(
            3, vocab, (length,)).astype(np.int32), max_new=max_new,
            priority=int(rng.choice([0, 5])), eos_id=-1))
    return out


def serving_device_ms(fn, iters: int):
    """(ms, clock): the device time of one ``fn()`` as ``device_ms``
    takes it (the CUDA-only profiler, tried twice), or, where the
    profiler records no device time (as happened once late in a whole
    run), CUDA events around ``iters`` calls, which count the host's
    gaps between launches too: the parts of a host-bound step need the
    profiler's device time."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        us = sum(e.device_time_total for e in prof.key_averages())
        if us > 0:
            return us / iters / 1e3, "profiler"
    print(json.dumps({"note": "torch.profiler recorded no device time: "
                      "timed with CUDA events"}))
    return cuda_ms(fn, iters, warmup=1), "cuda events"


def swap_timing(Q, rec) -> dict:
    """Time of one swap's encodes (every recorded bucket input through
    the kernel, and through ``quantize_plain``), beside the bound and the
    bytes the design moves.  CUDA events around back-to-back swaps: the
    big buckets' launches queue behind each other (0.1-0.3 ms each), so
    the host leaves the card no gap, and the events need no profiler
    (on an H100, late in a whole run of this script, its records came
    up short: a swap's encodes read 1.34 ms, under the design's 1.84 ms
    byte bound, against 1.95-2.11 ms when the phase ran alone)."""
    flats = [f for f, _, _ in rec["launches"]]
    elems = sum(f.numel() for f in flats)
    kernel_ms = cuda_ms(lambda: [Q.quantize_kernel(f) for f in flats], 5,
                        warmup=1)
    plain_ms = cuda_ms(lambda: [Q.quantize_plain(f) for f in flats], 2,
                       warmup=1)
    return {"elements": elems, "ms": kernel_ms, "plain_ms": plain_ms,
            "clock": "cuda events",
            "bound_ms": elems * SWAP_BOUND_BYTES / HBM_BYTES_PER_S * 1e3,
            "bound_by": "bytes", "bound_bytes": elems * SWAP_BOUND_BYTES,
            "design_bytes": elems * SWAP_DESIGN_BYTES,
            "design_bound_ms":
                elems * SWAP_DESIGN_BYTES / HBM_BYTES_PER_S * 1e3,
            "library_ms": None}


def step_parts_ms(cb, toks, n_valid) -> dict:
    """Device ms of the batcher step's three parts on its current state,
    each alone: ``gather_view``, ``decode_step`` on the view, and the
    ``writeback`` of the (unchanged) view, which writes the pool rows it
    read, so the state is left as it was."""
    from repro_torch.serving.paged_cache import gather_view, writeback
    pc = cb.paged
    tables = pc.tables()
    view = gather_view(pc.state, tables, pc._paged)
    t = torch.as_tensor(toks, device="cuda")
    nv = torch.as_tensor(n_valid, device="cuda")
    slot_len = cb.slot_len.copy()
    parts = {
        "gather_view": lambda: gather_view(pc.state, tables, pc._paged),
        "decode_step": lambda: cb.model.decode_step(cb.params, view, t,
                                                    n_valid=nv),
        "writeback": lambda: writeback(
            pc.state, view, pc.block_tables, slot_len, n_valid,
            toks.shape[1], pc._paged, pc.block_size, pc.n_blocks)}
    out = {}
    with torch.no_grad():
        for name, fn in parts.items():
            out[name], out[f"{name}_clock"] = serving_device_ms(fn, 3)
    return out


def phase_serving(Q, ops) -> dict:
    """Full-width llama3.2-1b in bf16 behind ``ContinuousBatcher``: 8
    slots, 1024-token contexts, a pool of 96 blocks of 16, chunked
    prefill of 64; 24 requests (16-512 prompt tokens, 32 new, priorities
    0 and 5) submitted before the first step; after the 8th completion a
    hot swap on the int8 wire (new weights from seed 1) streams one
    bucket a step.  Checks: every request completes with 32 tokens,
    preemptions > 0, the pool below the dense cache, one version flip
    within n_buckets + 2 steps of the start with the live params
    untouched until it, the flipped params bitwise the one-shot
    ``plan.broadcast``, one stateless encode a bucket, each bitwise
    ``quantize_plain``.  Then a swap back at ``fusion_threshold`` = 128
    MiB (multi-slot f32 packs) with the same launch checks."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.serving import (ContinuousBatcher, Request, SLOConfig,
                                     dense_cache_bytes)
    from repro_torch.tree import tree_flatten
    model = build_model(get_config(SERVING_ARCH))
    params = phase_init(model)
    new = model.init(seed=1, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    cb = ContinuousBatcher(model, params, slo=SLOConfig(
        prefill_chunk=SERVING_CHUNK), **SERVING)
    reqs = serving_requests(Request, model.cfg.vocab, SERVING_REQUESTS,
                            SERVING_PROMPTS, SERVING_NEW)
    for r in reqs:
        cb.submit(r)
    step = cb.device_step
    seen = {"mixed": False, "parts": None, "want_parts": False}

    def device_step(toks, n_valid):
        seen["mixed"] = bool((n_valid > 1).any() and (n_valid == 1).any())
        if seen["want_parts"] and seen["mixed"]:
            seen["parts"] = step_parts_ms(cb, toks, n_valid)
            seen["want_parts"] = False
            seen["measured"] = True
        return step(toks, n_valid)
    cb.device_step = device_step
    done, walls, versions = [], [], []
    swap = rec = busy = None
    with contextlib.ExitStack() as stack:
        t_run = time.perf_counter()
        while True:
            if busy is None and seen["parts"] is not None and seen["mixed"]:
                res = {}
                busy = top_device_kernels(
                    lambda: res.setdefault("more", cb.step(done)))
                more = res["more"]
            else:
                more, ms = timed(lambda: cb.step(done))
                if not seen.pop("measured", False):
                    walls.append((ms, seen["mixed"]))
            if not more:
                break
            if swap is not None:
                versions.append(cb.params_version)
                if cb.params_version == 0 and cb.params is not params:
                    fail("serving: live params replaced before the flip")
            elif len(done) >= SERVING_SWAP_AFTER:
                Q.reset_launches()
                rec = stack.enter_context(recorded_quantize(ops))
                swap = cb.begin_hot_swap(new, codec="int8")
            if len(walls) == 4 and seen["parts"] is None:
                # the parts are measured once, on the next mixed step
                seen["want_parts"] = True
        run_s = time.perf_counter() - t_run
    # the run's peak: weights, the swap's new and staged trees, the
    # recorded q of its encodes (1.2 GB), the pool and the steps' views
    peak = torch.cuda.max_memory_allocated()
    if swap is None or busy is None or seen["parts"] is None:
        fail(f"serving: swap {swap is not None}, profiled step "
             f"{busy is not None}, parts {seen['parts'] is not None}")
    launches = check_swap_launches("serving swap", Q, rec, swap.plan)
    if swap.n_buckets != len(tree_flatten(params)[0]):
        fail(f"serving: {swap.n_buckets} buckets for "
             f"{len(tree_flatten(params)[0])} leaves")
    flips = sum(a != b for a, b in zip([0] + versions, versions))
    to_flip = versions.index(1) + 1 if 1 in versions else None
    if cb.params_version != 1 or flips != 1 or to_flip is None \
            or to_flip > swap.n_buckets + 2:
        fail(f"serving: version {cb.params_version}, {flips} flips, flip "
             f"{to_flip} steps after the start ({swap.n_buckets} buckets)")
    one_shot = swap.plan.broadcast(new, None)
    for a, b in zip(tree_flatten(cb.params)[0], tree_flatten(one_shot)[0]):
        if not torch.equal(a.view(torch.int16), b.view(torch.int16)):
            fail("serving: the streamed params differ from the one-shot "
                 "broadcast")
    del one_shot
    timing = swap_timing(Q, rec)
    rec = None
    _, swap_ms = timed(lambda: swap.plan.broadcast(new, None))
    uids = sorted(r.uid for r in done)
    if uids != list(range(SERVING_REQUESTS)) or any(
            len(r.output) != SERVING_NEW
            or not all(0 <= t < model.cfg.vocab for t in r.output)
            for r in done):
        fail(f"serving: completed {uids}, lengths "
             f"{[len(r.output) for r in done]}")
    m = cb.metrics
    preempted = m.counter("sched/preempted").value
    dense = dense_cache_bytes(model, SERVING["n_slots"],
                              SERVING["cache_len"])
    if preempted <= 0 or cb.paged.pool_bytes() >= dense:
        fail(f"serving: {preempted} preemptions, pool "
             f"{cb.paged.pool_bytes()} B against dense {dense} B")
    # the swap back at the fusion buffer's threshold: multi-slot buckets
    # take the f32 pack
    Q.reset_launches()
    with recorded_quantize(ops) as frec:
        fused = cb.begin_hot_swap(params, codec="int8",
                                  fusion_threshold=SERVING_FUSION)
        cb.run()
    fused_launches = check_swap_launches("serving fused swap", Q, frec,
                                         fused.plan)
    del frec
    if cb.params_version != 2:
        fail(f"serving: the fused swap left version {cb.params_version}")
    mixed = [ms for ms, mx in walls if mx]
    parts = seen["parts"]
    steps = m.counter("sched/steps").value
    line = {"phase": "serving", "arch": model.cfg.name,
            "requests": SERVING_REQUESTS, "completed": len(done),
            "prompt_lens": [len(r.prompt) for r in reqs],
            "new_tokens": SERVING_NEW, **SERVING,
            "prefill_chunk": SERVING_CHUNK, "view_len": cb.paged.view_len,
            "steps": steps, "tokens": m.counter("sched/tokens").value,
            "preempted": preempted, "utilisation": cb.utilisation,
            "ttft": m.histogram("serve/ttft").summary(),
            "tpot": m.histogram("serve/tpot").summary(),
            "run_s": run_s,
            "wall_ms_per_step": statistics.mean(ms for ms, _ in walls),
            "mixed_step_wall_ms": statistics.median(mixed) if mixed else None,
            "mixed_steps": len(mixed),
            # None: the profiler recorded no device time (not measured)
            "profiled_step_device_busy_ms": busy["device_busy_ms"] or None,
            "profiled_step_idle_share":
                1 - busy["device_busy_ms"] / statistics.median(mixed)
                if mixed and busy["device_busy_ms"] else None,
            "profiled_step_top": busy["top"][:5],
            "step_parts_device_ms": parts,
            "gather_writeback_share_of_decode_step":
                (parts["gather_view"] + parts["writeback"])
                / parts["decode_step"],
            "pool_bytes": cb.paged.pool_bytes(), "dense_cache_bytes": dense,
            "swap": {"codec": "int8", "buckets": swap.n_buckets,
                     "steps_to_flip": to_flip, "flips": flips,
                     "bitwise_one_shot": True, **launches,
                     "one_shot_wall_ms": swap_ms, "encodes": timing},
            "fused_swap": {"fusion_threshold": SERVING_FUSION,
                           **fused_launches},
            "max_memory_allocated": peak}
    print(json.dumps(line))
    return line


@contextlib.contextmanager
def emitted_logits(cb):
    """Within the block, the logits row behind every token ``cb`` emits,
    by request uid in emission order (a slot emits where it has no prompt
    left to feed: row ``n_valid - 1`` of its chunk)."""
    step = cb.device_step
    rows = {}

    def device_step(toks, n_valid):
        logits = step(toks, n_valid)
        for s, req in enumerate(cb.slot_req):
            if req is not None and n_valid[s] and not cb.slot_pending[s]:
                row = logits[s, n_valid[s] - 1] if logits.dim() == 3 \
                    else logits[s]
                rows.setdefault(req.uid, []).append(row.float())
        return logits
    cb.device_step = device_step
    try:
        yield rows
    finally:
        cb.device_step = step


@contextlib.contextmanager
def engine_logits(model):
    """Within the block, the logits of every ``model.decode_step`` call
    (``ServeEngine.generate``'s prefill and decode steps)."""
    calls = []
    step = model.decode_step

    def recorded(*a, **kw):
        logits, cache = step(*a, **kw)
        calls.append(logits.float())
        return logits, cache
    object.__setattr__(model, "decode_step", recorded)
    try:
        yield calls
    finally:
        object.__delattr__(model, "decode_step")


def compare_emissions(tag, got, want, tol) -> dict:
    """Tokens and their logits rows, request by request: every step up to
    a request's first differing token within ``tol``; a differing token
    only where ``want``'s top-2 margin there is below 2 x max_abs (then
    that request's later steps are not compared).  ``got`` and ``want``
    map uid -> (tokens, logits rows)."""
    worst = {"max_abs": 0.0, "rel_l2": 0.0}
    flips, steps = [], 0
    if sorted(got) != sorted(want):
        fail(f"{tag}: requests {sorted(got)} against {sorted(want)}")
    for uid in sorted(want):
        (gt, gl), (wt, wl) = got[uid], want[uid]
        if len(gt) != len(wt) or len(gl) != len(gt) or len(wl) != len(wt):
            fail(f"{tag}: request {uid}: {len(gt)} tokens, {len(gl)} rows "
                 f"against {len(wt)}, {len(wl)}")
        for i, (a, b) in enumerate(zip(gt, wt)):
            d = logits_diff(f"{tag} request {uid} step {i}", gl[i], wl[i])
            steps += 1
            for k in worst:
                worst[k] = max(worst[k], d[k])
            if d["max_abs"] > tol["max_abs"] or d["rel_l2"] > tol["rel_l2"]:
                fail(f"{tag}: request {uid} step {i} logits differ: {d} "
                     f"(limits {tol})")
            if a != b:
                top2 = torch.topk(wl[i], 2).values
                margin = (top2[0] - top2[1]).item()
                if margin >= 2 * tol["max_abs"]:
                    fail(f"{tag}: request {uid} step {i}: token {a} against"
                         f" {b} with a top-2 margin of {margin}")
                flips.append({"uid": uid, "step": i, "margin": margin})
                break
    return {"steps_compared": steps, "flips": flips, **worst, "tol": tol}


def batcher_run(model, params, prompts, max_new, prefill_chunk, **kw):
    """The prompts through a ``ContinuousBatcher``; returns (batcher,
    {uid: (tokens, emitted logits rows)})."""
    from repro_torch.serving import ContinuousBatcher, Request, SLOConfig
    cb = ContinuousBatcher(model, params, slo=SLOConfig(
        prefill_chunk=prefill_chunk), **kw)
    for uid, p in enumerate(prompts):
        cb.submit(Request(uid=uid, prompt=p, max_new=max_new))
    with emitted_logits(cb) as rows:
        done = cb.run()
    if len(done) != len(prompts):
        fail(f"batcher: {len(done)} of {len(prompts)} requests completed")
    return cb, {r.uid: (list(r.output), rows[r.uid]) for r in done}


def engine_run(model, params, prompts, max_new, cache_len) -> dict:
    """Each prompt alone through ``ServeEngine.generate`` at
    ``cache_len``: {uid: (tokens, emitted logits rows)}."""
    from repro_torch.serving import ServeEngine
    eng = ServeEngine(model, params, cache_len=cache_len)
    out = {}
    for uid, p in enumerate(prompts):
        with engine_logits(model) as calls:
            toks = eng.generate(p[None], max_new=max_new)[0].tolist()
        out[uid] = (toks, [c[0] for c in calls[len(p) - 1:
                                                len(p) - 1 + len(toks)]])
    return out


def phase_serving_f32() -> dict:
    """Full-width llama3.2-1b in f32 (seed 0's weights, widened): 8
    prompts of ``SHORT_PROMPT`` tokens, 32 new, through the batcher (8
    slots, chunked prefill of 8) and through one
    ``ServeEngine.generate`` of all 8 at the batcher's ``view_len``,
    held to each other by ``compare_emissions`` at ``SERVE_F32_TOL``."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.serving import ServeEngine
    from repro_torch.tree import tree_map
    model = build_model(get_config(SERVING_ARCH).with_(dtype="float32"))
    params = tree_map(lambda t: t.float(),
                      build_model(get_config(SERVING_ARCH)).init(
                          seed=0, device="cuda"))
    prompts = list(np.random.default_rng(6).integers(
        3, model.cfg.vocab, (SERVE_B, SHORT_PROMPT)).astype(np.int32))
    with torch.no_grad():
        (cb, got), batcher_ms = timed(lambda: batcher_run(
            model, params, prompts, SERVE_NEW, n_slots=SERVE_B,
            cache_len=SHORT_PROMPT + SERVE_NEW, block_size=16,
            prefill_chunk=8))
        eng = ServeEngine(model, params, cache_len=cb.paged.view_len)
        with engine_logits(model) as calls:
            toks, engine_ms = timed(lambda: eng.generate(
                np.stack(prompts), max_new=SERVE_NEW))
    rows = calls[SHORT_PROMPT - 1:SHORT_PROMPT - 1 + SERVE_NEW]
    want = {uid: (toks[uid].tolist(), [r[uid] for r in rows])
            for uid in range(SERVE_B)}
    cmp = compare_emissions("serving_f32", got, want, SERVE_F32_TOL)
    line = {"phase": "serving_f32", "arch": model.cfg.name,
            "requests": SERVE_B, "prompt": SHORT_PROMPT,
            "new_tokens": SERVE_NEW, "view_len": cb.paged.view_len,
            "batcher_steps": cb.metrics.counter("sched/steps").value,
            "batcher_ms": batcher_ms, "engine_ms": engine_ms, **cmp}
    print(json.dumps(line))
    return line


def phase_small_serving() -> dict:
    """The reduced llama3.2-1b, deepseek-v2-236b, zamba2-7b and
    xlstm-125m in f32 from the CPU's draws: the batcher (2 slots, chunked
    prefill of 4, five requests) on the card against the same run on the
    CPU and against ``ServeEngine`` on the card request by request; and
    llama3.2-1b on a pool of 10 blocks of 4 for 3 slots, which must
    preempt and still emit the engine's tokens; all by
    ``compare_emissions`` at ``SMALL_SERVE_TOL``."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    out = {}
    with torch.no_grad():
        for arch in SMALL_SERVE_ARCHS:
            model = build_model(get_config(arch).reduced())
            prompts = [np.random.default_rng(1).integers(
                4, model.cfg.vocab, (n,)).astype(np.int32)
                for n in (9, 3, 12, 5, 7)]
            kw = dict(n_slots=2, cache_len=32, prefill_chunk=4)
            runs = {}
            for dev in ("cpu", "cuda"):
                params = host_weights(model, 0, dev)
                runs[dev] = batcher_run(model, params, prompts, 6, **kw)
            cb, card = runs["cuda"]
            cpu = {u: (t, [r.cpu() for r in rows]) for u, (t, rows)
                   in card.items()}
            res = {"card_vs_cpu": compare_emissions(
                f"small_serving {arch} card vs cpu", cpu, runs["cpu"][1],
                SMALL_SERVE_TOL)}
            eng = engine_run(model, params, prompts, 6, cb.paged.view_len)
            res["batcher_vs_engine"] = compare_emissions(
                f"small_serving {arch} batcher vs engine", card, eng,
                SMALL_SERVE_TOL)
            if arch == SERVING_ARCH:
                tiny = [np.random.default_rng(2).integers(
                    4, model.cfg.vocab, (8,)).astype(np.int32)
                    for _ in range(5)]
                cb, got = batcher_run(model, params, tiny, 8, n_slots=3,
                                      cache_len=32, block_size=4,
                                      n_blocks=10, prefill_chunk=4)
                preempted = cb.metrics.counter("sched/preempted").value
                if preempted <= 0:
                    fail("small_serving: the tiny pool did not preempt")
                res["tiny_pool"] = {"preempted": preempted,
                                    **compare_emissions(
                    "small_serving tiny pool", got, engine_run(
                        model, params, tiny, 8, cb.paged.view_len),
                    SMALL_SERVE_TOL)}
            out[arch] = res
    line = {"phase": "small_serving", **out}
    print(json.dumps(line))
    return line


TELEMETRY_ARGV = FULL_WIDTH + ["--grad-accum", "dense_reduce", "--codec",
                               "int8", "--error-feedback", "--steps", "3"]
#: untraced and traced steps timed in turns: the host's jitter on one step
#: (96.8 to 141.1 ms untraced on an H100 80GB HBM3 host) is larger than
#: the taps' cost
TELEMETRY_PAIRS = 5


def kernel_counts(prof, skip) -> dict:
    """Device events of a ``torch.profiler`` run by name, with their
    counts, leaving out the names in ``skip`` (the traced step's
    ``record_function`` ranges, which the profiler lists on the device
    timeline beside the kernels)."""
    return {e.key: e.count for e in prof.key_averages()
            if e.device_time_total > 0 and e.key not in skip}


def phase_telemetry(train, D, Q, comm) -> dict:
    """The telemetry path on full-width transformer-big, int8+ef: the
    launcher's JSONL and trace, then a traced step against an untraced
    one from the same state.  Returns the kernels' launches in the
    launcher's run."""
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import build_model
    from repro_torch.telemetry import hooks, report
    from repro_torch.telemetry import trace as trace_lib
    from repro_torch.training import make_train_step
    out_dir = os.path.join(ROOT, "build", "telemetry")
    shutil.rmtree(out_dir, ignore_errors=True)
    jsonl = os.path.join(out_dir, "metrics.jsonl")
    tdir = os.path.join(out_dir, "trace")
    argv = TELEMETRY_ARGV + ["--metrics-jsonl", jsonl, "--trace-dir", tdir]
    plan = exchange_plan(train, argv)
    names = list(plan.stage_names())
    steps = 3
    reset_counts(D, Q, comm)
    result = train.run(argv, log=lambda s: None)
    got = read_counts(D, Q, comm)
    # the capture runs the step 3 more times: measure_wire, the warm-up
    # and the timed step
    check_counts("telemetry launcher", got, plan, steps + 3)

    lines = [json.loads(x) for x in open(jsonl).read().splitlines() if x]
    kinds = [r["kind"] for r in lines]
    if kinds != ["step"] * steps + ["history"] * steps + ["summary"]:
        fail(f"telemetry: JSONL record kinds {kinds}")
    rows_ok = all(math.isfinite(r["loss"]) and r["step_ms"] > 0
                  and r["data_ms"] >= 0 and r["compute_ms"] > 0
                  for r in lines if r["kind"] == "step")
    if not rows_ok:
        fail(f"telemetry: step rows {lines[:steps]}")
    t = report.load_trace(os.path.join(tdir, "trace.json"))
    slices = [e for e in t["traceEvents"] if e.get("cat") == "exchange"]
    if t["otherData"]["stage_names"] != names or \
            {e["args"]["stage"] for e in slices} != set(names):
        fail("telemetry: the trace's stages differ from plan.stage_names()")
    for n in names:
        mine = sorted(e["name"] for e in slices if e["args"]["stage"] == n)
        if mine != sorted(trace_lib.PHASES) or any(
                e["dur"] < 0 for e in slices if e["args"]["stage"] == n):
            fail(f"telemetry: stage {n} has slices {mine}")
    rows = report.predicted_vs_measured(t)
    if not report.wire_exact(rows) or any(
            r["planned_wire_bytes"] != 0 or r["measured_wire_bytes"] != 0
            for r in rows):
        fail(f"telemetry: wire not exact at a world of 1: {rows[:2]}")
    summary = report.summarize_trace(t)

    created = _world_of_one(train)
    try:
        args, cfg, batch_at = zero1_setup(train, TELEMETRY_ARGV)
        opt = train.build_optimizer(args, cfg, dist.group.WORLD)
        step = make_train_step(build_model(cfg), opt, sparse_embedding=True)
        state = (result["params"], result["opt_state"],
                 result["exchange_state"], batch_at(steps))
        del result
        # a first step of this step function, unprofiled: it pays the
        # one-time host-to-device copies and memsets the two profiled
        # steps must not differ by
        step(*trace_lib.copy_tensors(state))
        tracer = trace_lib.StepTracer()
        runs = {}
        for tag, fn in (("untraced", lambda: step(*trace_lib.copy_tensors(
                            state))),
                        ("traced", lambda: tracer.capture(step, *state,
                                                          warmup=False))):
            torch.cuda.synchronize()
            reset_counts(D, Q, comm)
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                out = fn()
                torch.cuda.synchronize()
            counts = read_counts(D, Q, comm)
            check_counts(f"telemetry {tag} step", counts, plan, 1)
            kernels = kernel_counts(prof, set(names))
            runs[tag] = {"state": train_state(*out[:3]), "counts": counts,
                         "kernels": kernels,
                         "busy_ms": sum(e.device_time_total for e in
                                        prof.key_averages() if e.key in
                                        kernels) / 1e3}
            del out
        if hooks.tracer() is not None or hooks.wire_recorder() is not None:
            fail("telemetry: a hook was left installed")
        bad = differing(runs["traced"]["state"], runs["untraced"]["state"])
        if bad:
            fail(f"telemetry: the traced step differs bitwise in tensors "
                 f"{bad[:10]}")
        ku, kt = runs["untraced"]["kernels"], runs["traced"]["kernels"]
        if ku != kt:
            diff = {k: (ku.get(k), kt.get(k)) for k in set(ku) | set(kt)
                    if ku.get(k) != kt.get(k)}
            fail(f"telemetry: the traced step launches other kernels: "
                 f"{diff}")
        traced_step_us = (tracer.step_marks[-1]["t_end"]
                          - tracer.step_marks[-1]["t_start"]) * 1e6

        # wall ms of each kind of step from a fresh copy (the copies made
        # before the clock starts), TELEMETRY_PAIRS each, interleaved
        walls = {"untraced": [], "traced": []}
        for _ in range(TELEMETRY_PAIRS):
            for tag in walls:
                args_ = trace_lib.copy_tensors(state)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                if tag == "traced":
                    trace_lib.StepTracer().run(step, *args_)
                else:
                    step(*args_)
                torch.cuda.synchronize()
                walls[tag].append((time.perf_counter() - t0) * 1e3)
                del args_
        del state
    finally:
        if created:
            dist.destroy_process_group()
    stage_us = {n: summary["stages"][n]["phase_us"] for n in names}
    wall_u = statistics.median(walls["untraced"])
    wall_t = statistics.median(walls["traced"])
    line = {"phase": "telemetry", "stages": len(names),
            "launcher_launches": got,
            "jsonl_kinds": {k: kinds.count(k) for k in sorted(set(kinds))},
            "jsonl_step_ms": [r["step_ms"] for r in lines[:steps]],
            "jsonl_data_ms": [r["data_ms"] for r in lines[:steps]],
            "jsonl_compute_ms": [r["compute_ms"] for r in lines[:steps]],
            "trace_step_us": summary["step_us"],
            "wire_exact": True, "bitwise_traced_vs_untraced": True,
            "same_kernels": True, "kernel_names": len(ku),
            "kernel_launches": sum(ku.values()),
            "step_counts": runs["traced"]["counts"],
            "capture_step_us": traced_step_us,
            "untraced_wall_ms": walls["untraced"],
            "traced_wall_ms": walls["traced"],
            "traced_minus_untraced_wall_ms_median": wall_t - wall_u,
            "untraced_device_busy_ms": runs["untraced"]["busy_ms"],
            "traced_device_busy_ms": runs["traced"]["busy_ms"]}
    print(json.dumps(line))
    for n in names:
        print(json.dumps({"phase": "telemetry_stage", "stage": n,
                          "phase_us": stage_us[n],
                          "predicted_us_ethernet":
                              t["otherData"]["predicted_us"][n]}))
    # the main path's run: the launcher (its 3 steps and the capture's 3)
    return {k: got[k] for k in ("densify", "quantize", "quantize_ef",
                                "decode_sum")}


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
    wire = clock("int8_wire_kernel", phase_int8_wire_kernel, Q, train)
    akern = clock("attn_kernel", phase_attn_kernel, FA)
    torch.cuda.empty_cache()
    skern = clock("ssd_kernel", phase_ssd_kernel, K, ops)
    torch.cuda.empty_cache()
    path = clock("path", phase_path, train, D, comm, "transformer-big",
                 (("dense_reduce", 3), ("sparse_gather", 1)), "path")
    codec = clock("codec", phase_codec_path, train, D, Q, comm, path)
    torch.cuda.empty_cache()
    overlap = clock("overlap", phase_overlap, train, D, Q, comm)
    torch.cuda.empty_cache()
    backends = clock("backends", phase_backends, train, D, Q, comm)
    torch.cuda.empty_cache()
    zero1 = clock("zero1", phase_zero1, train, D, Q, comm, ops)
    torch.cuda.empty_cache()
    model = build_model(get_config("transformer-big"))
    params = clock("init", phase_init, model)
    prefill = clock("prefill", phase_prefill, model, params, FA)
    trans = clock("translate", phase_translate, model, params, FA)
    clock("serve", phase_serve, model, params, FA)
    del params
    torch.cuda.empty_cache()
    hybrid = build_model(get_config("zamba2-7b"))
    params = clock("hybrid_init", phase_init, hybrid)
    hpre = clock("hybrid_prefill", phase_hybrid_prefill, hybrid, params, K,
                 FA)
    clock("hybrid_decode", phase_hybrid_decode, hybrid, params, K, FA)
    clock("hybrid_serve", phase_hybrid_serve, hybrid, params, K, FA)
    clock("hybrid_f32", phase_f32_prefill, hybrid, params, K, FA,
          "hybrid_f32")
    del params
    torch.cuda.empty_cache()
    dense_path = clock("dense_path", phase_path, train, D, comm,
                       "llama3.2-1b", (("dense_reduce", 3),
                                       ("sparse_gather", 1)), "dense_path")
    seamless_path = clock("seamless_path", phase_path, train, D, comm,
                          "seamless-m4t-large-v2", (("dense_reduce", 2),),
                          "seamless_path")
    torch.cuda.empty_cache()
    glm = build_model(get_config("chatglm3-6b"))
    params = clock("dense_init", phase_init, glm)
    dpre = clock("dense_prefill", phase_prefill, glm, params, FA,
                 "dense_prefill")
    clock("dense_f32", phase_f32_prefill, glm, params, K, FA, "dense_f32")
    clock("dense_serve", phase_serve, glm, params, FA, "dense_serve",
          SHORT_PROMPT)
    del params
    torch.cuda.empty_cache()
    vlm = build_model(get_config("internvl2-1b"))
    params = clock("vlm_init", phase_init, vlm)
    vpre = clock("vlm_prefill", phase_prefill, vlm, params, FA,
                 "vlm_prefill")
    clock("vlm_f32", phase_f32_prefill, vlm, params, K, FA, "vlm_f32")
    clock("vlm_embeds", phase_vlm_embeds, vlm, params, FA)
    del params
    torch.cuda.empty_cache()
    scout = build_model(get_config(MOE_ARCH).with_(n_layers=MOE_DEPTH))
    params = clock("moe_init", phase_init, scout)
    mpre = clock("moe_prefill", phase_prefill, scout, params, FA,
                 "moe_prefill")
    clock("moe_decode", phase_moe_decode, scout, params, FA)
    clock("moe_serve", phase_serve, scout, params, FA, "moe_serve")
    clock("moe_f32", phase_f32_prefill, scout, params, K, FA, "moe_f32")
    del params
    torch.cuda.empty_cache()
    moe_path = clock("moe_path", phase_path, train, D, comm, MOE_ARCH,
                     (("dense_reduce", 3), ("sparse_gather", 1)), "moe_path",
                     ("--reduced",))
    clock("small", phase_small_reference, train)
    clock("small_backends", phase_small_backends, train)
    clock("small_zero1", phase_small_zero1, train)
    clock("small_forward", phase_small_forward)
    clock("small_hybrid", phase_small_hybrid, K)
    clock("small_dense", phase_small_dense)
    clock("small_moe", phase_small_moe, FA)
    torch.cuda.empty_cache()
    dsv2 = build_model(get_config(MLA_ARCH).with_(n_layers=MLA_DEPTH))
    params = clock("mla_init", phase_init, dsv2)
    clock("mla_prefill", phase_mla_prefill, dsv2, params, FA)
    clock("mla_decode", phase_moe_decode, dsv2, params, FA, "mla_decode",
          MLA_DECODE_MODES)
    clock("mla_serve", phase_serve, dsv2, params, FA, "mla_serve",
          SHORT_PROMPT)
    del params
    torch.cuda.empty_cache()
    clock("mla_wide_f32", phase_mla_wide_f32, FA)
    mla_path = clock("mla_path", phase_path, train, D, comm, MLA_ARCH,
                     (("dense_reduce", 3), ("sparse_gather", 1)), "mla_path",
                     ("--reduced",))
    small_mla = clock("small_mla", phase_small_moe, FA, MLA_ARCH,
                      "small_mla", SMALL_MLA_STEPS)
    torch.cuda.empty_cache()
    xlstm = build_model(get_config(XLSTM_ARCH))
    params = clock("xlstm_init", phase_init, xlstm)
    clock("xlstm_prefill", phase_xlstm_prefill, xlstm, params)
    clock("xlstm_decode", phase_xlstm_decode, xlstm, params)
    clock("xlstm_serve", phase_serve, xlstm, params, FA, "xlstm_serve",
          SHORT_PROMPT)
    del params
    torch.cuda.empty_cache()
    clock("xlstm_f32", phase_xlstm_f32)
    xlstm_path = clock("xlstm_path", phase_path, train, D, comm, XLSTM_ARCH,
                       (("dense_reduce", 2), ("sparse_gather", 1)),
                       "xlstm_path", ("--batch-per-worker", "2"), False)
    clock("small_xlstm", phase_small_xlstm, train)
    torch.cuda.empty_cache()
    serving = clock("serving", phase_serving, Q, ops)
    torch.cuda.empty_cache()
    clock("serving_f32", phase_serving_f32)
    clock("small_serving", phase_small_serving)
    torch.cuda.empty_cache()
    tele = clock("telemetry", phase_telemetry, train, D, Q, comm)
    small_flash = small_mla["flash_launches_by_variant"]
    swap, fused_swap = serving["swap"], serving["fused_swap"]
    swap_launches = swap["launches"] + fused_swap["launches"]
    print(json.dumps({"kernels": [{
        "name": "densify", "route": "cuda",
        "source": "src/repro_torch/csrc/densify.cu",
        "replaces": "src/repro/kernels/densify.py:40",
        "launches": path["densify_launches"] + codec["densify_launches"]
        + overlap["launches"]["densify"] + backends["launches"]["densify"]
        + zero1["launches"]["densify"] + dense_path["densify_launches"]
        + seamless_path["densify_launches"] + moe_path["densify_launches"]
        + mla_path["densify_launches"] + xlstm_path["densify_launches"]
        + tele["densify"],
        "launches_by_phase": {"path": path["densify_launches"],
                              "codec": codec["densify_launches"],
                              "overlap": overlap["launches"]["densify"],
                              "backends": backends["launches"]["densify"],
                              "zero1": zero1["launches"]["densify"],
                              "dense_path": dense_path["densify_launches"],
                              "seamless_path":
                                  seamless_path["densify_launches"],
                              "moe_path": moe_path["densify_launches"],
                              "mla_path": mla_path["densify_launches"],
                              "xlstm_path": xlstm_path["densify_launches"],
                              "telemetry": tele["densify"]},
        "max_abs_err": kern["max_abs_err"],
        "ms": kern["kernel_ms"], "plain_ms": kern["plain_ms"],
        "bound_ms": kern["bound_ms"], "bound_by": kern["bound_by"],
        "library_ms": kern["library_ms"],
        "f32": {k: kern["f32"][k] for k in (
            "kernel_ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")},
        # the configs' training shapes: counts spilled to the workspace
        # (vocab > 51,199), but for xlstm-125m's 50304 (shared memory)
        **{f"vocab_{kern['vocabs'][c]['shape']['vocab']}": {
            k: kern["vocabs"][c][k] for k in (
                "kernel_ms", "group_rows_ms", "plain_ms", "bound_ms",
                "bound_by", "library_ms")}
           for c in ("llama3.2-1b_bf16", "seamless-m4t-large-v2_bf16",
                     "llama4-scout-17b-a16e_bf16", "deepseek-v2-236b_bf16",
                     "xlstm-125m_bf16")}}, {
        "name": "quantize", "route": "cuda",
        "source": "src/repro_torch/csrc/quantize.cu",
        "replaces": "src/repro/kernels/quantize.py:29",
        "entry_points": ["repro_quantize_int8_ef", "repro_quantize_int8",
                         "repro_int8_decode_sum"],
        "launches": codec["quantize_launches"]
        + overlap["launches"]["quantize"] + backends["launches"]["quantize"]
        + zero1["launches"]["quantize"] + swap_launches
        + tele["quantize"],
        "launches_by_entry": {
            "repro_quantize_int8_ef": codec["quantize_ef_launches"]
            + overlap["launches"]["quantize_ef"]
            + backends["launches"]["quantize_ef"]
            + zero1["launches"]["quantize_ef"] + tele["quantize_ef"],
            "repro_quantize_int8": codec["quantize_launches"]
            - codec["quantize_ef_launches"]
            + overlap["launches"]["quantize"]
            - overlap["launches"]["quantize_ef"]
            + backends["launches"]["quantize"]
            - backends["launches"]["quantize_ef"]
            + zero1["launches"]["quantize"]
            - zero1["launches"]["quantize_ef"] + swap_launches
            + tele["quantize"] - tele["quantize_ef"],
            "repro_int8_decode_sum": codec["decode_sum_launches"]
            + overlap["launches"]["decode_sum"]
            + backends["launches"]["decode_sum"]
            + zero1["launches"]["decode_sum"] + tele["decode_sum"]},
        "launches_by_phase": {"codec": codec["quantize_launches"],
                              "overlap": overlap["launches"]["quantize"],
                              "backends": backends["launches"]["quantize"],
                              "zero1": zero1["launches"]["quantize"],
                              "serving": swap_launches,
                              "telemetry": tele["quantize"]},
        # the int8 hot swap of full-width llama3.2-1b: one stateless
        # encode a bucket (a bf16 leaf each at the default threshold)
        "hot_swap": {
            **{k: swap["encodes"][k] for k in (
                "elements", "ms", "clock", "plain_ms", "bound_ms",
                "bound_by", "bound_bytes", "design_bytes",
                "design_bound_ms", "library_ms")},
            "launches": swap["launches"],
            "fused": {k: fused_swap[k] for k in ("fusion_threshold",
                                                  "buckets", "launches")}},
        "requantize": {
            "per_step_ms": backends["requantize"]["per_step_ms"],
            "per_step_bound_ms": backends["requantize"]["per_step_bound_ms"],
            "bound_by": "bytes",
            # hop 1 of every dense stage: half the phase's encodes
            "launches": backends["launches"]["quantize"] // 2},
        "max_abs_err": qkern["max_abs_err"],
        "ms": wire["kernel_ms"], "plain_ms": wire["plain_ms"],
        "unfused_ms": wire["unfused_ms"],
        "bound_ms": wire["bound_ms"], "bound_by": wire["bound_by"],
        "library_ms": wire["library_ms"],
        "stateless_f32": {k: qkern[k] for k in (
            "kernel_ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")},
        "decode_sum": {"launches": codec["decode_sum_launches"]
                       + overlap["launches"]["decode_sum"]
                       + backends["launches"]["decode_sum"]
                       + zero1["launches"]["decode_sum"]
                       + tele["decode_sum"],
                       **wire["decode_sum"][1]},
        "f32_leaf": {
            "per_step_ms": wire["per_step"]["encode_f32_ms"],
            "per_step_bound_ms": wire["per_step"]["encode_f32_bound_ms"],
            "bound_by": "bytes"},
        "per_step": wire["per_step"]}, {
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention_sm90.cu",
        "replaces": "src/repro/kernels/flash_attention.py:33",
        "launches": prefill["launches"] + trans["launches"]
        + hpre["flash_launches_per_forward"] + dpre["launches"]
        + vpre["launches"] + mpre["launches"] + sum(small_flash.values()),
        "sources": ["src/repro_torch/csrc/flash_attention_sm90.cu",
                    "src/repro_torch/csrc/flash_attention.cu"],
        "launches_by_variant": {
            k: prefill["launches_by_variant"][k]
            + trans["launches_by_variant"][k]
            + hpre["flash_launches_by_variant"][k]
            + dpre["launches_by_variant"][k]
            + vpre["launches_by_variant"][k]
            + mpre["launches_by_variant"][k] + small_flash[k]
            for k in prefill["launches_by_variant"]},
        "launches_by_phase": {
            "prefill": prefill["launches"], "translate": trans["launches"],
            "hybrid_prefill": hpre["flash_launches_per_forward"],
            "dense_prefill": dpre["launches"],
            "vlm_prefill": vpre["launches"],
            "moe_prefill": mpre["launches"],
            # Dv != D: the chunked route (0); the reduced MLA's D = 32
            # in f32 on "simt"
            "mla_prefill": 0, "small_mla": sum(small_flash.values())},
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
        "d128": {k: akern["dense_d128_self"][k] for k in (
            "kernel_ms", "mma_ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "library_kv")},
        "gqa7_d64": {k: akern["vlm_gqa7_self"][k] for k in (
            "kernel_ms", "mma_ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "library_kv")},
        "gqa5_d128": {k: akern["moe_gqa5_self"][k] for k in (
            "kernel_ms", "mma_ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "library_kv")},
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
