"""Horovod-style tensor fusion.

The torch counterpart of ``repro.core.fusion``: first-fit-decreasing
bucketing of the flattened gradient tree into fusion buffers of at most
``threshold_bytes`` (the paper's runs use 128 MiB), one collective per
buffer, exact unpacking.  The plan depends on shapes and dtypes only, so
``meta`` tensors plan as well as real ones.
"""
from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Sequence, Tuple

import torch

from repro_torch.core.comm import dtype_name, torch_dtype
from repro_torch.tree import tree_flatten, tree_unflatten

DEFAULT_FUSION_THRESHOLD = 128 * 1024 * 1024  # Horovod default in the paper


@dataclasses.dataclass(frozen=True)
class _Slot:
    leaf_idx: int
    offset: int     # element offset within the bucket
    size: int       # element count
    shape: Tuple[int, ...]
    dtype: str = "float32"   # original leaf dtype, restored by unpack


@dataclasses.dataclass(frozen=True)
class FusionPlan:
    """Static assignment of leaves to fusion buckets."""
    buckets: Tuple[Tuple[_Slot, ...], ...]
    treedef: Any                 # None when planned from a flat leaf list
    n_leaves: int

    @property
    def n_buckets(self) -> int:
        return len(self.buckets)


def _leaves(grads) -> Tuple[List[Any], Any]:
    if isinstance(grads, (list, tuple)):
        return list(grads), None
    return tree_flatten(grads)


def plan_fusion(grads, threshold_bytes: int = DEFAULT_FUSION_THRESHOLD
                ) -> FusionPlan:
    """Greedy first-fit-decreasing bucketing of dense gradient leaves
    (a dict tree, or a flat list of leaves)."""
    leaves, treedef = _leaves(grads)
    nbytes = [leaf.numel() * leaf.element_size() for leaf in leaves]
    order = sorted(range(len(leaves)), key=lambda i: -nbytes[i])
    buckets: List[List[_Slot]] = []
    fill_bytes: List[int] = []
    for i in order:
        leaf = leaves[i]
        slot = dict(size=leaf.numel(), shape=tuple(leaf.shape),
                    dtype=dtype_name(leaf.dtype))
        for b, fb in enumerate(fill_bytes):
            if fb + nbytes[i] <= threshold_bytes:
                offset = sum(s.size for s in buckets[b])
                buckets[b].append(_Slot(i, offset, **slot))
                fill_bytes[b] += nbytes[i]
                break
        else:
            buckets.append([_Slot(i, 0, **slot)])
            fill_bytes.append(nbytes[i])
    return FusionPlan(buckets=tuple(tuple(b) for b in buckets),
                      treedef=treedef, n_leaves=len(leaves))


def pack(grads, plan: FusionPlan, dtype: Optional[torch.dtype] = None
         ) -> List[torch.Tensor]:
    """Concatenate leaves into 1-D fusion buffers per the plan."""
    leaves, _ = _leaves(grads)
    buffers = []
    for bucket in plan.buckets:
        parts = [leaves[s.leaf_idx].reshape(-1) for s in bucket]
        if dtype is not None:
            parts = [p.to(dtype) for p in parts]
        buffers.append(torch.cat(parts) if len(parts) > 1 else parts[0])
    return buffers


def unpack(buffers: Sequence[torch.Tensor], plan: FusionPlan):
    """Invert ``pack``: split buffers back into the original leaves,
    restoring each leaf's planned dtype (lossless round trip even when
    ``pack`` narrowed the wire)."""
    leaves: List[Optional[torch.Tensor]] = [None] * plan.n_leaves
    for buf, bucket in zip(buffers, plan.buckets):
        for s in bucket:
            x = buf[s.offset:s.offset + s.size].reshape(s.shape)
            leaves[s.leaf_idx] = x.to(torch_dtype(s.dtype))
    if plan.treedef is None:
        return leaves
    return tree_unflatten(plan.treedef, leaves)
