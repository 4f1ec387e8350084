"""Densify IndexedSlices: scatter-add rows into a dense tensor.

The per-step hot spot of the paper's fix: the sparse embedding gradient
``(n rows, d_model)`` at token ids ``indices`` becomes the dense
``(vocab, d_model)`` tensor the allreduce exchanges.

Two versions of one function, with the same numerics (rows accumulate in
f32, duplicates sum, ids outside ``[0, vocab)`` are dropped, then one cast
to the values' dtype — ``repro.kernels.densify``'s contract):

  * ``densify_kernel`` launches the hand-written Hopper kernel
    (``csrc/densify.cu``) on CUDA tensors and counts its launches in
    ``densify_kernel.launches``: a counting sort of the rows by id into a
    small int32 workspace, each id's rows put in ascending order, then
    one pass that writes every output row once, summing its rows in that
    order, so the result is the same bit for bit from run to run;
  * ``densify_plain`` is the plain PyTorch version (f32 ``index_add_``
    over the valid rows), which CPU tensors take.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def densify_plain(indices: torch.Tensor, values: torch.Tensor,
                  dense_shape: Tuple[int, int]) -> torch.Tensor:
    """Plain PyTorch version: f32 ``index_add_`` of the valid rows, then
    a cast to the values' dtype."""
    vocab = dense_shape[0]
    valid = (indices >= 0) & (indices < vocab)
    acc = torch.zeros(dense_shape, dtype=torch.float32, device=values.device)
    acc.index_add_(0, indices[valid].long(), values[valid].float())
    return acc.to(values.dtype)


def _check(indices: torch.Tensor, values: torch.Tensor,
           dense_shape: Tuple[int, int]) -> None:
    if indices.device.type != "cuda" or values.device != indices.device:
        raise ValueError(f"densify kernel needs indices and values on one "
                         f"CUDA device, got {indices.device} and "
                         f"{values.device}")
    if indices.dtype != torch.int32 or indices.dim() != 1 \
            or not indices.is_contiguous():
        raise ValueError(f"densify kernel needs contiguous 1-D int32 "
                         f"indices, got {indices.dtype} "
                         f"{tuple(indices.shape)}")
    if values.dtype not in _DTYPE_CODES:
        raise ValueError(f"densify kernel takes float32 or bfloat16 "
                         f"values, got {values.dtype}")
    if len(dense_shape) != 2 or values.dim() != 2 \
            or values.shape[0] != indices.shape[0] \
            or values.shape[1] != dense_shape[1] \
            or not values.is_contiguous():
        raise ValueError(f"densify kernel needs contiguous values "
                         f"(n, d) = ({indices.shape[0]}, {dense_shape[-1]})"
                         f" for dense_shape (vocab, d) = {dense_shape}, "
                         f"got {tuple(values.shape)}")


def workspace_ints(n: int, vocab: int) -> int:
    """int32s of workspace one launch needs: the CSR offsets
    (vocab + 1), the grouped row list and its sorted copy (n each), the
    list of output rows with many input rows (vocab + 1) and room for the
    id counts (vocab + 1) where they do not fit in shared memory; the
    source refuses less."""
    return 2 * n + 3 * (vocab + 1)


def _entry_point():
    """``repro_densify`` from the built library, with its C signature
    (pointers and the stream as ``c_void_p``; sizes, the workspace's
    among them, as ``int64_t``)."""
    fn = build.load("densify").repro_densify
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int64] * 4 \
        + [ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def densify_kernel(indices: torch.Tensor, values: torch.Tensor,
                   dense_shape: Tuple[int, int]) -> torch.Tensor:
    """Launch the Hopper kernel on the current stream (no synchronise)."""
    dense_shape = tuple(int(s) for s in dense_shape)
    _check(indices, values, dense_shape)
    fn = _entry_point()
    n, vocab = indices.shape[0], dense_shape[0]
    out = torch.empty(dense_shape, dtype=values.dtype, device=values.device)
    ws = torch.empty(workspace_ints(n, vocab), dtype=torch.int32,
                     device=values.device)
    stream = torch.cuda.current_stream(values.device).cuda_stream
    rc = fn(indices.data_ptr(), values.data_ptr(), out.data_ptr(),
            ws.data_ptr(), n, vocab, dense_shape[1], ws.numel(),
            _DTYPE_CODES[values.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"densify kernel launch failed: cudaError {rc}")
    densify_kernel.launches += 1
    return out


densify_kernel.launches = 0
