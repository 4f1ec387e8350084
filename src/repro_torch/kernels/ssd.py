"""Chunked Mamba2 SSD scan (state-space duality).

Replaces ``repro.kernels.ssd._ssd_kernel`` (the Pallas TPU kernel behind
``repro.kernels.ops.ssd(impl="pallas")``).  The function both versions
compute, chunk by chunk of L rows for each (batch, head), with the state
S (N, P) starting at zero:

  cum = cumsum(dt * a);  pos = exp(cum);  neg = exp(min(-cum, CLIP))
  y   = pos * (tril(C B^T) @ ((neg * dt) * x))
      + ((1 - pos * neg) * dt * rowsum(C * B)) * x      (exact diagonal)
      + pos * (C @ S)                                   (inter-chunk)
  S   = exp(cum[-1]) * S + (B * dt * exp(cum[-1] - cum))^T @ x

in f32.  Layout, the reference's at ``ops.ssd``: x (B, S, H, P), dt
(B, S, H), a (H,), b/c (B, S, N) shared by the heads of a batch entry;
S a multiple of ``chunk``.  Returns y (B, S, H, P) f32 and the final
state (B, H, N, P) f32.  B and C are read per batch entry, not repeated
per head as the reference's wrapper does.

  * ``ssd_kernel`` launches the hand-written Hopper kernel
    (``csrc/ssd.cu``) on CUDA tensors and counts its launches in
    ``ssd_kernel.launches``;
  * ``ssd_plain`` is the plain PyTorch version (the same per-chunk
    math, chunks batched, the state carried by a loop), which CPU
    tensors take.

What bounds it on the H100: f32 operations (at zamba2-7b's prefill,
1.21e11 flop a launch, 1.806 ms at 67 TFLOP/s, against 0.428 ms of
bytes).  The kernel's design (one block per (batch, head) looping over
the chunks with the state in shared memory, each chunk's B and x loaded
once, 64-row query and key tiles, f32 on the CUDA cores) is in the
source's header.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import build

CLIP = 60.0
MAX_WIDTH = 64          # N and P the kernel takes
MAX_CHUNK = 256
_DTYPES = (torch.float32, torch.bfloat16)


def ssd_plain(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
              b: torch.Tensor, c: torch.Tensor, chunk: int
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel's per-chunk math (the
    separable decay with ``exp(-cum)`` clipped at ``CLIP``, the exact
    diagonal, the inter-chunk term and the state update), in f32."""
    bb, s, h, p = x.shape
    n = b.shape[-1]
    if s % chunk:
        raise ValueError(f"ssd: sequence {s} is not a multiple of the "
                         f"chunk {chunk}")
    nc = s // chunk
    f32 = torch.float32
    xc = x.to(f32).reshape(bb, nc, chunk, h, p)
    dtc = dt.to(f32).reshape(bb, nc, chunk, h)
    bc = b.to(f32).reshape(bb, nc, chunk, n)
    cc = c.to(f32).reshape(bb, nc, chunk, n)
    cum = torch.cumsum(dtc * a.to(f32), dim=2)           # (B, nc, L, H)
    pos = torch.exp(cum)
    neg = torch.exp(torch.clamp(-cum, max=CLIP))
    tri = torch.ones((chunk, chunk), dtype=torch.bool,
                     device=x.device).tril()
    scores = torch.einsum("bcin,bcjn->bcij", cc, bc)
    masked = torch.where(tri, scores, 0.0)
    bj = (neg * dtc)[..., None] * xc
    y = pos[..., None] * torch.einsum("bcij,bcjhp->bcihp", masked, bj)
    diag = torch.sum(cc * bc, dim=-1)                    # (B, nc, L)
    y = y + ((1.0 - pos * neg) * dtc * diag[..., None])[..., None] * xc
    w = dtc * torch.exp(cum[:, :, -1:] - cum)            # (B, nc, L, H)
    upd = torch.einsum("bcjhn,bcjhp->bchnp", bc[:, :, :, None, :]
                       * w[..., None], xc)               # (B, nc, H, N, P)
    decay = torch.exp(cum[:, :, -1])                     # (B, nc, H)
    state = torch.zeros((bb, h, n, p), dtype=f32, device=x.device)
    prev = []
    for ci in range(nc):
        prev.append(state)
        state = decay[:, ci, :, None, None] * state + upd[:, ci]
    inter = torch.einsum("bcin,bchnp->bcihp", cc, torch.stack(prev, 1))
    y = y + pos[..., None] * inter
    return y.reshape(bb, s, h, p), state


def _check(x, dt, a, b, c, chunk) -> None:
    ts = (x, dt, a, b, c)
    if x.device.type != "cuda" or any(t.device != x.device for t in ts):
        raise ValueError(f"ssd kernel needs x, dt, a, b and c on one CUDA "
                         f"device, got {[str(t.device) for t in ts]}")
    if x.dim() != 4 or dt.dim() != 3 or a.dim() != 1 or b.dim() != 3 \
            or b.shape != c.shape or tuple(dt.shape) != tuple(x.shape[:3]) \
            or a.shape[0] != x.shape[2] or b.shape[:2] != x.shape[:2]:
        raise ValueError(f"ssd kernel needs x (B, S, H, P), dt (B, S, H), "
                         f"a (H,), b, c (B, S, N), got "
                         f"{[tuple(t.shape) for t in ts]}")
    bsz, s, h, p = x.shape
    n = b.shape[-1]
    if not (0 < p <= MAX_WIDTH and 0 < n <= MAX_WIDTH):
        raise ValueError(f"ssd kernel takes head dims and state dims up to "
                         f"{MAX_WIDTH}, got P={p}, N={n}")
    if not 0 < chunk <= MAX_CHUNK or s % chunk:
        raise ValueError(f"ssd kernel takes chunks up to {MAX_CHUNK} that "
                         f"divide the sequence, got chunk {chunk}, S {s}")
    if x.dtype not in _DTYPES or b.dtype != x.dtype or c.dtype != x.dtype \
            or dt.dtype != torch.float32 or a.dtype != torch.float32:
        raise ValueError(f"ssd kernel takes x, b, c in one of f32 or bf16 "
                         f"and dt, a in f32, got "
                         f"{[str(t.dtype) for t in ts]}")
    if any(t.stride(-1) != 1 for t in ts if t.numel()):
        raise ValueError("ssd kernel needs the last dim of every input "
                         "contiguous (stride 1)")


def _entry_point():
    """``repro_ssd`` from the built library, with its C signature:
    pointers and the stream as ``c_void_p``, sizes as ``int``, strides
    as ``int64_t``."""
    fn = build.load("ssd").repro_ssd
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 \
        + [ctypes.c_int64] * 10 + [ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def ssd_kernel(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
               b: torch.Tensor, c: torch.Tensor, chunk: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the Hopper kernel on the current stream (no synchronise).
    Same arguments and results as ``ssd_plain``; inputs are read through
    their strides (the last dim must be contiguous)."""
    _check(x, dt, a, b, c, chunk)
    bsz, s, h, p = x.shape
    n = b.shape[-1]
    y = torch.empty((bsz, s, h, p), dtype=torch.float32, device=x.device)
    state = torch.empty((bsz, h, n, p), dtype=torch.float32,
                        device=x.device)
    if bsz == 0 or h == 0:
        return y, state
    fn = _entry_point()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    a = a.contiguous()
    rc = fn(x.data_ptr(), dt.data_ptr(), a.data_ptr(), b.data_ptr(),
            c.data_ptr(), y.data_ptr(), state.data_ptr(),
            bsz, s, h, p, n, int(chunk),
            *x.stride()[:3], *dt.stride(), b.stride(0), b.stride(1),
            c.stride(0), c.stride(1), int(x.dtype == torch.bfloat16),
            stream)
    if rc != 0:
        raise RuntimeError(f"ssd kernel launch failed: cudaError {rc}")
    ssd_kernel.launches += 1
    return y, state


ssd_kernel.launches = 0
