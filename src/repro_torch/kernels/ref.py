"""Plain-torch oracles for the port's kernels (``repro.kernels.ref``)."""
from __future__ import annotations

from typing import Tuple

import torch


def densify_ref(indices: torch.Tensor, values: torch.Tensor,
                dense_shape: Tuple[int, ...]) -> torch.Tensor:
    """Scatter-add rows into a zero dense tensor (duplicates sum), in the
    values' dtype.  Rows with index < 0 or >= vocab are dropped."""
    vocab = dense_shape[0]
    valid = (indices >= 0) & (indices < vocab)
    safe = torch.where(valid, indices, torch.zeros_like(indices))
    vals = torch.where(valid[:, None], values, torch.zeros_like(values))
    zeros = torch.zeros(dense_shape, dtype=values.dtype,
                        device=values.device)
    return zeros.index_add_(0, safe.long(), vals)
