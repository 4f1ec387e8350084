"""The int8 wire: the codec's encode (stateless and with error feedback)
and the decode-sum after the allgather.

The encode is ``repro.kernels.ops.quantize_int8(impl="pallas")``'s
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

The error-feedback encode takes the residual in as well, as the
reference's ``ErrorFeedbackCodec(Int8Codec).encode_stateful`` does:
``c = f32(x) + residual``, ``(q, scale)`` the encode of c, and the
residual becomes ``c - f32(q) * scale`` (updated in place).  The
decode-sum of P gathered chunks adds their decodes ``f32(q_p) * s_p`` in
worker order, starting from chunk 0's.

Each has two versions:

  * ``quantize_kernel``, ``quantize_ef_kernel`` and ``decode_sum_kernel``
    launch the hand-written Hopper kernels (``csrc/quantize.cu``) on
    CUDA tensors; both encodes count their launches in
    ``quantize_kernel.launches`` (the error-feedback one also in
    ``quantize_ef_kernel.launches``), the decode-sum in
    ``decode_sum_kernel.launches``;
  * ``quantize_plain``, ``quantize_ef_plain`` and ``decode_sum_plain``
    are the plain PyTorch versions, which CPU tensors take.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import build

QMAX = 127.0
INV_QMAX = 1.0 / QMAX       # rounded to f32 where it meets an f32 tensor
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
#: words of the absmax partials scratch (kMaxBlocks in csrc/quantize.cu)
_PARTIAL_WORDS = 132 * 8


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


def quantize_ef_plain(flat: torch.Tensor, residual: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the error-feedback encode, the eager
    sequence the kernel fuses: add, encode, subtract the decode.
    ``residual`` (f32, ``flat``'s size) is updated in place."""
    residual.add_(flat.reshape(-1))
    q, scale = quantize_plain(residual)
    residual.sub_(q.to(torch.float32) * scale)
    return q, scale


def decode_sum_plain(gathered_q: torch.Tensor, scales: torch.Tensor,
                     n_chunks: int) -> torch.Tensor:
    """Plain PyTorch version of the decode-sum: ``n_chunks`` int8
    chunks stacked in ``gathered_q``, decoded against their scales and
    added in chunk order from chunk 0's.  Returns f32 (n,)."""
    chunks = gathered_q.reshape(n_chunks, -1)
    s = scales.reshape(n_chunks).to(torch.float32)
    out = chunks[0].to(torch.float32) * s[0]
    for p in range(1, n_chunks):
        out = out + chunks[p].to(torch.float32) * s[p]
    return out


def _check(flat: torch.Tensor, what: str = "quantize kernel",
           dtypes=_DTYPE_CODES) -> None:
    if flat.device.type != "cuda":
        raise ValueError(f"{what} needs a CUDA tensor, got {flat.device}")
    if flat.dtype not in dtypes:
        raise ValueError(f"{what} takes {' or '.join(map(str, dtypes))}, "
                         f"got {flat.dtype}")
    if flat.dim() != 1 or (flat.numel() > 1 and flat.stride(0) != 1):
        raise ValueError(f"{what} needs a contiguous 1-D tensor, got "
                         f"shape {tuple(flat.shape)} stride "
                         f"{tuple(flat.stride())}")


def _entry_point(name: str = "repro_quantize_int8"):
    """A C entry point of the built library, with its C signature
    (pointers and the stream as ``c_void_p``, n as ``int64_t``, dtype
    and chunk counts as ``int``)."""
    fn = getattr(build.load("quantize"), name)
    fn.argtypes = list(_ARGTYPES[name])
    fn.restype = ctypes.c_int
    return fn


_P, _I, _N = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
_ARGTYPES = {
    # x, dtype, n, q, scale, partials, stream
    "repro_quantize_int8": [_P, _I, _N] + [_P] * 4,
    # x, dtype, n, residual, q, scale, partials, stream
    "repro_quantize_int8_ef": [_P, _I, _N] + [_P] * 5,
    # gathered q, scales, p, n, out, stream
    "repro_int8_decode_sum": [_P, _P, _I, _N, _P, _P],
}


def _launch(name: str, *args) -> None:
    rc = _entry_point(name)(*args)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {rc}")


def quantize_kernel(flat: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the Hopper kernel on the current stream (no synchronise).
    Returns ``(q int8 (n,), scale f32 (1,))``."""
    _check(flat)
    q, scale, partials = _outputs(flat)
    _launch("repro_quantize_int8", flat.data_ptr(), _DTYPE_CODES[flat.dtype],
            flat.numel(), q.data_ptr(), scale.data_ptr(),
            partials.data_ptr(), _stream(flat))
    quantize_kernel.launches += 1
    return q, scale


def quantize_ef_kernel(flat: torch.Tensor, residual: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the error-feedback encode on the current stream (no
    synchronise): ``(q int8 (n,), scale f32 (1,))`` of ``flat +
    residual``; ``residual`` is updated in place."""
    _check(flat)
    _check(residual, "quantize kernel's residual", (torch.float32,))
    if residual.numel() != flat.numel() or residual.device != flat.device:
        raise ValueError(f"residual of {residual.numel()} on "
                         f"{residual.device} for a buffer of "
                         f"{flat.numel()} on {flat.device}")
    q, scale, partials = _outputs(flat)
    _launch("repro_quantize_int8_ef", flat.data_ptr(),
            _DTYPE_CODES[flat.dtype], flat.numel(), residual.data_ptr(),
            q.data_ptr(), scale.data_ptr(), partials.data_ptr(),
            _stream(flat))
    quantize_kernel.launches += 1
    quantize_ef_kernel.launches += 1
    return q, scale


def decode_sum_kernel(gathered_q: torch.Tensor, scales: torch.Tensor,
                      n_chunks: int) -> torch.Tensor:
    """Launch the decode-sum on the current stream (no synchronise).
    Returns f32 (n,) with n = ``gathered_q.numel() // n_chunks``."""
    _check(gathered_q, "decode-sum kernel", (torch.int8,))
    _check(scales, "decode-sum kernel's scales", (torch.float32,))
    total = gathered_q.numel()
    if n_chunks < 1 or total % n_chunks or scales.numel() != n_chunks \
            or scales.device != gathered_q.device:
        raise ValueError(f"decode-sum of {total} int8 in {n_chunks} chunks "
                         f"with {scales.numel()} scales on {scales.device}")
    n = total // n_chunks
    out = torch.empty(n, dtype=torch.float32, device=gathered_q.device)
    _launch("repro_int8_decode_sum", gathered_q.data_ptr(),
            scales.data_ptr(), n_chunks, n, out.data_ptr(),
            _stream(gathered_q))
    decode_sum_kernel.launches += 1
    return out


def _outputs(flat: torch.Tensor):
    dev = flat.device
    return (torch.empty(flat.numel(), dtype=torch.int8, device=dev),
            torch.empty(1, dtype=torch.float32, device=dev),
            torch.empty(_PARTIAL_WORDS, dtype=torch.int32, device=dev))


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


quantize_kernel.launches = 0
quantize_ef_kernel.launches = 0
decode_sum_kernel.launches = 0


def reset_launches() -> None:
    """Set every launch counter of this module to 0."""
    quantize_kernel.launches = 0
    quantize_ef_kernel.launches = 0
    decode_sum_kernel.launches = 0
