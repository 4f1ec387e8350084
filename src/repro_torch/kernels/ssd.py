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

  * ``ssd_kernel`` launches one of two hand-written Hopper kernels on
    CUDA tensors, chosen by ``_variant`` from dtypes, P, N, the chunk,
    alignment and strides:

      "sm90"  bf16 x, b, c with P and N multiples of 16 up to 64, a chunk
              that is a multiple of 64 up to 256, 16-byte-aligned
              pointers and strides that are multiples of 16 bytes:
              ``csrc/ssd_sm90.cu`` (bf16 wgmma with the f32 operand of
              each product split in two bf16 terms, chunks in parallel
              in three passes) -- the prefill path of zamba2-7b;
      "simt"  everything else (f32 inputs, small chunks or widths):
              ``csrc/ssd.cu`` (one block per (batch, head) walking the
              chunks, f32 on the CUDA cores).

    The choice is by shape, not a fallback: a refused launch raises.  It
    counts every launch in ``ssd_kernel.launches`` and each variant's in
    ``ssd_kernel.launches_by_variant``;
  * ``ssd_plain`` is the plain PyTorch version (the same per-chunk
    math, chunks batched, the state carried by a loop), which CPU
    tensors take.

What bounds it on the H100 at zamba2-7b's prefill: bytes (x, dt, a, b,
c read and y, the state written once: 1.43e9 bytes, 0.428 ms at 3.35
TB/s); in f32 on the CUDA cores, as "simt" computes, the operations
(1.21e11 flop, 1.806 ms at 67 TFLOP/s).  The kernels' designs are in
the sources' headers.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build

CLIP = 60.0
MAX_WIDTH = 64          # N and P the kernel takes
MAX_CHUNK = 256
SM90_STEP = 16          # "sm90" takes N and P in multiples of this
SM90_CHUNK_STEP = 64    # and chunks in multiples of this
VARIANTS = ("sm90", "simt")
STATE_TILE = 64         # "sm90" keeps each chunk's state padded to 64 x 64
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


def _tma_ok(t: torch.Tensor) -> bool:
    """TMA's rule for a bf16 tensor: a 16-byte-aligned base and, for every
    dimension but the last (contiguous, ``_check``) that is longer than 1,
    a positive stride that is a multiple of 16 bytes."""
    if t.data_ptr() % 16:
        return False
    return all(n == 1 or (st > 0 and st * t.element_size() % 16 == 0)
               for n, st in zip(t.shape[:-1], t.stride()[:-1]))


def _variant(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
             b: torch.Tensor, c: torch.Tensor, chunk: int) -> str:
    """Which kernel takes these inputs (a pure function of dtypes, P, N,
    the chunk, alignment and strides; see the module docstring)."""
    bf16 = torch.bfloat16
    p, n = x.shape[-1], b.shape[-1]
    if x.dtype == b.dtype == c.dtype == bf16 \
            and all(0 < w <= MAX_WIDTH and w % SM90_STEP == 0
                    for w in (p, n)) \
            and 0 < chunk <= MAX_CHUNK and chunk % SM90_CHUNK_STEP == 0 \
            and all(_tma_ok(t) for t in (x, b, c)):
        return "sm90"
    return "simt"


def _resolve(x, dt, a, b, c, chunk, override: Optional[str]) -> str:
    """``_variant``'s choice, or ``override`` where it may stand in: only
    "simt" for "sm90" (the same bf16 inputs)."""
    chosen = _variant(x, dt, a, b, c, chunk)
    if override is None or override == chosen:
        return chosen
    if (chosen, override) != ("sm90", "simt"):
        raise ValueError(f"ssd kernel: variant {override!r} cannot take "
                         f"inputs that {chosen!r} takes")
    return override


def _entry_point():
    """``repro_ssd`` from the built library, with its C signature:
    pointers and the stream as ``c_void_p``, sizes as ``int``, strides
    as ``int64_t``."""
    fn = build.load("ssd").repro_ssd
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 \
        + [ctypes.c_int64] * 10 + [ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _entry_point_sm90():
    """``repro_ssd_sm90`` from its own library, with its C signature:
    ``repro_ssd``'s with two more pointers (the scratch of chunk states
    and decays) and without the dtype flag (the kernel takes bf16
    only)."""
    fn = build.load("ssd_sm90").repro_ssd_sm90
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6 \
        + [ctypes.c_int64] * 10 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def ssd_kernel(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
               b: torch.Tensor, c: torch.Tensor, chunk: int,
               _override: Optional[str] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch a Hopper kernel on the current stream (no synchronise).
    Same arguments and results as ``ssd_plain``; inputs are read through
    their strides (the last dim must be contiguous).  ``_override`` names
    the variant instead of ``_variant``; it exists so that a benchmark can
    time "simt" on inputs that "sm90" takes."""
    _check(x, dt, a, b, c, chunk)
    variant = _resolve(x, dt, a, b, c, chunk, _override)
    bsz, s, h, p = x.shape
    n = b.shape[-1]
    y = torch.empty((bsz, s, h, p), dtype=torch.float32, device=x.device)
    state = torch.empty((bsz, h, n, p), dtype=torch.float32,
                        device=x.device)
    if bsz == 0 or h == 0:
        return y, state
    stream = torch.cuda.current_stream(x.device).cuda_stream
    a = a.contiguous()
    strides = (*x.stride()[:3], *dt.stride(), b.stride(0), b.stride(1),
               c.stride(0), c.stride(1))
    if variant == "sm90":
        nc = s // chunk
        states = torch.empty((bsz, nc, h, STATE_TILE, STATE_TILE),
                             dtype=torch.float32, device=x.device)
        decay = torch.empty((bsz, nc, h), dtype=torch.float32,
                            device=x.device)
        rc = _entry_point_sm90()(
            x.data_ptr(), dt.data_ptr(), a.data_ptr(), b.data_ptr(),
            c.data_ptr(), y.data_ptr(), state.data_ptr(), states.data_ptr(),
            decay.data_ptr(), bsz, s, h, p, n, int(chunk), *strides, stream)
    else:
        rc = _entry_point()(
            x.data_ptr(), dt.data_ptr(), a.data_ptr(), b.data_ptr(),
            c.data_ptr(), y.data_ptr(), state.data_ptr(),
            bsz, s, h, p, n, int(chunk), *strides,
            int(x.dtype == torch.bfloat16), stream)
    if rc != 0:
        raise RuntimeError(f"ssd kernel ({variant}) launch failed: "
                           f"cudaError {rc}")
    ssd_kernel.launches += 1
    ssd_kernel.launches_by_variant[variant] += 1
    return y, state


def reset_launches() -> None:
    """Set the total and every variant's launch count to 0."""
    ssd_kernel.launches = 0
    ssd_kernel.launches_by_variant = dict.fromkeys(VARIANTS, 0)


reset_launches()
