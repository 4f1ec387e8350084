"""int8 wire quantisation: the int8 codec's encode hot loop.

One function, ``repro.kernels.ops.quantize_int8(impl="pallas")``'s
contract, bitwise:

    scale = max(absmax(x), 1e-30) * f32(1 / 127)      (f32, shape (1,))
    q     = int8(clip(round_half_even(x * (1 / scale)), -127, 127))

over a flat f32 or bf16 buffer (bf16 is read as f32).  The reference
writes ``/ 127``, but XLA's algebraic simplifier turns a division by a
constant into a multiplication by the constant's f32 reciprocal
(0.00787401572), so that product is what it computes, and what the port
computes.  ``1 / scale`` is a true division; it is taken once and
multiplied in, as the Pallas path does.  The reference's xla path
divides by the scale instead and may differ by one in rare elements.
A NaN in x makes the scale NaN and an inf makes it inf; a product
``x * inv`` that is NaN quantises to 0, as XLA converts NaN to an
integer.

Two versions:

  * ``quantize_kernel`` launches the hand-written Hopper kernel
    (``csrc/quantize.cu``) on CUDA tensors and counts its launches in
    ``quantize_kernel.launches``;
  * ``quantize_plain`` is the plain PyTorch version, which CPU tensors
    take.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import build

QMAX = 127.0
INV_QMAX = 1.0 / QMAX       # rounded to f32 where it meets an f32 tensor
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def quantize_plain(flat: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: f32 absmax, the scale and its reciprocal,
    then round, clip and cast.  Returns ``(q int8 (n,), scale f32
    (1,))``."""
    x = flat.reshape(-1).to(torch.float32)
    absmax = (x.abs().amax() if x.numel()
              else torch.zeros((), dtype=torch.float32, device=x.device))
    scale = torch.clamp_min(absmax, 1e-30) * INV_QMAX
    inv = 1.0 / scale
    r = torch.round(x * inv).clamp(-QMAX, QMAX)
    q = torch.where(torch.isnan(r), 0.0, r).to(torch.int8)
    return q, scale.reshape(1)


def _check(flat: torch.Tensor) -> None:
    if flat.device.type != "cuda":
        raise ValueError(f"quantize kernel needs a CUDA tensor, got "
                         f"{flat.device}")
    if flat.dtype not in _DTYPE_CODES:
        raise ValueError(f"quantize kernel takes float32 or bfloat16, "
                         f"got {flat.dtype}")
    if flat.dim() != 1 or (flat.numel() > 1 and flat.stride(0) != 1):
        raise ValueError(f"quantize kernel needs a contiguous 1-D "
                         f"tensor, got shape {tuple(flat.shape)} stride "
                         f"{tuple(flat.stride())}")


def _entry_point():
    """``repro_quantize_int8`` from the built library, with its C
    signature (pointers and the stream as ``c_void_p``, n as
    ``int64_t``)."""
    fn = build.load("quantize").repro_quantize_int8
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int64] \
        + [ctypes.c_void_p] * 4
    fn.restype = ctypes.c_int
    return fn


def quantize_kernel(flat: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the Hopper kernel on the current stream (no synchronise).
    Returns ``(q int8 (n,), scale f32 (1,))``."""
    _check(flat)
    fn = _entry_point()
    n = flat.numel()
    q = torch.empty(n, dtype=torch.int8, device=flat.device)
    scale = torch.empty(1, dtype=torch.float32, device=flat.device)
    absmax = torch.empty(1, dtype=torch.int32, device=flat.device)
    stream = torch.cuda.current_stream(flat.device).cuda_stream
    rc = fn(flat.data_ptr(), _DTYPE_CODES[flat.dtype], n, q.data_ptr(),
            scale.data_ptr(), absmax.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"quantize kernel launch failed: cudaError {rc}")
    quantize_kernel.launches += 1
    return q, scale


quantize_kernel.launches = 0
