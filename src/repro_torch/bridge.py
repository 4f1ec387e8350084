"""Numpy <-> torch trees, so the port can start from the reference's
parameters bitwise.

``to_torch`` takes a nested dict of numpy arrays (the reference's params,
``jax.tree_util.tree_map(np.asarray, params)``) and returns the same tree
of tensors on the device the caller names (there is no default: nothing
lands on the CPU unless asked for); ``to_numpy`` goes back.  bfloat16
arrays (numpy's ``ml_dtypes`` bfloat16) cross by reinterpreting their
16-bit patterns, so nothing is rounded; ``to_numpy`` returns bfloat16
tensors as float32, which holds every bfloat16 value exactly.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.tree import tree_map


def array_to_tensor(a, device) -> torch.Tensor:
    a = np.array(a)                  # an owned, writable, contiguous copy
    if a.dtype.name == "bfloat16":
        bits = torch.from_numpy(a.view(np.int16))
        return bits.view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def tensor_to_array(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()


def to_torch(tree, device):
    return tree_map(lambda a: array_to_tensor(a, device), tree)


def to_numpy(tree):
    return tree_map(tensor_to_array, tree)
