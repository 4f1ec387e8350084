"""Public wrappers around the port's kernels.

Each wrapper dispatches on the device of the tensors it is given: a CUDA
tensor launches the hand-written kernel (or raises), a CPU tensor takes
the kernel's plain PyTorch version.  Nothing falls back from one to the
other.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels.densify import densify_kernel, densify_plain


def densify(indices: torch.Tensor, values: torch.Tensor,
            dense_shape: Tuple[int, int]) -> torch.Tensor:
    """Scatter-add ``values`` rows at ``indices`` into zeros(dense_shape).

    Negative / out-of-range indices are dropped (padding convention) by
    both versions.  Returns a tensor of the values' dtype."""
    dense_shape = tuple(int(s) for s in dense_shape)
    indices = indices.to(torch.int32).contiguous()
    values = values.contiguous()
    if indices.device.type == "cuda":
        return densify_kernel(indices, values, dense_shape)
    if indices.device.type == "cpu":
        return densify_plain(indices, values, dense_shape)
    raise ValueError(f"densify: unsupported device {indices.device}")
