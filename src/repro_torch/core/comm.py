"""Cross-worker gradient exchange collectives on ``torch.distributed``.

The torch counterpart of ``repro.core.comm``: the paper's Horovod/MPI
collectives over a process group (NCCL on the card, gloo on the CPU).

  * Horovod allgather of IndexedSlices -> ``all_gather_slices`` (message
    bytes grow linearly in worker count)
  * Horovod allreduce of dense tensors -> ``all_reduce_dense`` (constant
    in worker count — the paper's fix)

Every function takes ``group``: a ``torch.distributed`` process group, or
``None`` for the local path, where each collective is a no-op (the
reference's ``axis_name=None``).  Collectives never modify their inputs.
Each collective function counts its calls in ``<fn>.calls``, the
comm-layer audit of how many collectives a step issued.

``*_bytes`` helpers give the exact wire size of each collective (static
functions of shapes), shared with the reference's accounting.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Union

import torch
import torch.distributed as dist

from repro_torch.core.indexed_slices import IndexedSlices

Group = Optional[dist.ProcessGroup]

_DTYPES = {
    "float32": torch.float32, "float16": torch.float16,
    "bfloat16": torch.bfloat16, "float64": torch.float64,
    "int8": torch.int8, "uint8": torch.uint8, "int16": torch.int16,
    "int32": torch.int32, "int64": torch.int64, "bool": torch.bool,
}
_NAMES = {v: k for k, v in _DTYPES.items()}


def dtype_name(dtype: Union[str, torch.dtype]) -> str:
    """Canonical (numpy-style) name of a dtype, e.g. ``"bfloat16"``."""
    if isinstance(dtype, str):
        if dtype not in _DTYPES:
            raise ValueError(f"unknown dtype name {dtype!r}")
        return dtype
    return _NAMES[dtype]


def torch_dtype(name: Union[str, torch.dtype]) -> torch.dtype:
    return name if isinstance(name, torch.dtype) else _DTYPES[name]


def dtype_bytes(dtype) -> int:
    return torch_dtype(dtype).itemsize


def axis_size(group: Group) -> int:
    return 1 if group is None else dist.get_world_size(group)


# ---------------------------------------------------------------------------
# Dense exchange (the paper's fix: accumulate by REDUCTION)
# ---------------------------------------------------------------------------

def all_reduce_dense(x: torch.Tensor, group: Group,
                     average: bool = True) -> torch.Tensor:
    """Dense allreduce across the group (Horovod allreduce)."""
    if group is None:
        return x
    out = x.clone()
    dist.all_reduce(out, group=group)
    all_reduce_dense.calls += 1
    if average:
        out = out / axis_size(group)
    return out


def all_gather_dense(x: torch.Tensor, group: Group) -> torch.Tensor:
    """Tiled allgather over dim 0, in rank order."""
    if group is None:
        return x
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(axis_size(group))]
    dist.all_gather(parts, x, group=group)
    all_gather_dense.calls += 1
    return torch.cat(parts)


all_reduce_dense.calls = 0
all_gather_dense.calls = 0


# ---------------------------------------------------------------------------
# Sparse exchange (the pathological path: accumulate by GATHER)
# ---------------------------------------------------------------------------

def all_gather_slices(s: IndexedSlices, group: Group) -> IndexedSlices:
    """Allgather of IndexedSlices (Horovod's sparse path): the output row
    count is ``P * n``."""
    if group is None:
        return s
    return IndexedSlices(indices=all_gather_dense(s.indices, group),
                         values=all_gather_dense(s.values, group),
                         dense_shape=s.dense_shape)


# ---------------------------------------------------------------------------
# Wire-size accounting (static), the reference's formulas
# ---------------------------------------------------------------------------

def allreduce_wire_bytes(shape: Sequence[int], dtype, n_workers: int) -> int:
    """Bytes moved per worker by a ring allreduce: 2 (P-1)/P * size."""
    size = math.prod(shape) * dtype_bytes(dtype)
    if n_workers <= 1:
        return 0
    return int(2 * (n_workers - 1) / n_workers * size)


def gathered_buffer_bytes(rows: int, row_elems: int, dtype, n_workers: int,
                          index_dtype="int32") -> int:
    """Size of the accumulated IndexedSlices buffer each worker holds
    after the gather (paper Fig. 3a / Fig. 5)."""
    per_worker = rows * (row_elems * dtype_bytes(dtype)
                         + dtype_bytes(index_dtype))
    return int(n_workers * per_worker)


def dense_buffer_bytes(shape: Sequence[int], dtype) -> int:
    """Size of the dense accumulated tensor (constant in worker count)."""
    return int(math.prod(shape) * dtype_bytes(dtype))
