"""Tensor accumulation strategies — the heart of the paper.

The torch counterpart of ``repro.core.accumulation``:

  * ``tf_algorithm1`` — TensorFlow's ``_AggregatedGrads`` rule (paper
    Algorithm 1): if ANY contribution is an IndexedSlices, downgrade ALL
    to IndexedSlices and accumulate by concatenation (gather).
  * ``proposed_algorithm2`` — the paper's proposed fix (Algorithm 2): if
    ANY contribution is dense, densify all and reduce; only all-sparse
    inputs stay sparse.
  * ``sparse_as_dense`` pre-pass — Horovod's shipped fix (Listing 1):
    convert every IndexedSlices to dense BEFORE the rule runs.

A contribution list holds the cotangents one variable received from its
several uses (a tied embedding gets a sparse lookup and a dense
projection contribution).
"""
from __future__ import annotations

from typing import List, Sequence, Union

import torch

from repro_torch.core.indexed_slices import IndexedSlices, concat_slices

Contribution = Union[torch.Tensor, IndexedSlices]


def _all_dense(grads: Sequence[Contribution]) -> bool:
    return all(not isinstance(g, IndexedSlices) for g in grads)


def _any_dense(grads: Sequence[Contribution]) -> bool:
    return any(not isinstance(g, IndexedSlices) for g in grads)


def dense_to_slices(g: torch.Tensor) -> IndexedSlices:
    """TF's downgrade of a dense tensor to IndexedSlices: every row, with
    indices = arange (larger than the dense tensor itself)."""
    n = g.shape[0]
    return IndexedSlices(indices=torch.arange(n, dtype=torch.int32,
                                              device=g.device),
                         values=g, dense_shape=tuple(g.shape))


def densify(g: Contribution, use_kernel: bool = False) -> torch.Tensor:
    """Convert a contribution to dense.  ``use_kernel`` goes through
    ``kernels.ops.densify`` (the Hopper kernel on CUDA tensors, its plain
    version on CPU tensors); otherwise ``IndexedSlices.to_dense``."""
    if not isinstance(g, IndexedSlices):
        return g
    if use_kernel:
        from repro_torch.kernels import ops as kernel_ops
        return kernel_ops.densify(g.indices, g.values, g.dense_shape)
    return g.to_dense()


def accumulate_gradients(
    grads: Sequence[Contribution],
    algorithm: str = "tf_algorithm1",
    sparse_as_dense: bool = False,
    use_kernel: bool = False,
) -> Contribution:
    """Accumulate the contributions for ONE variable: a dense tensor
    (reduce path) or an IndexedSlices (gather path)."""
    grads = list(grads)
    if sparse_as_dense:
        grads = [densify(g, use_kernel=use_kernel) for g in grads]
    if algorithm == "tf_algorithm1":
        return _tf_algorithm1(grads, use_kernel)
    elif algorithm == "proposed_algorithm2":
        return _proposed_algorithm2(grads, use_kernel)
    raise ValueError(f"unknown accumulation algorithm: {algorithm}")


def _tf_algorithm1(grads: List[Contribution], use_kernel: bool) -> Contribution:
    """Paper Algorithm 1 (TensorFlow _AggregatedGrads)."""
    if len(grads) < 2:
        return grads[0]
    if _all_dense(grads):
        out = grads[0]
        for g in grads[1:]:
            out = out + g
        return out
    slices = [g if isinstance(g, IndexedSlices) else dense_to_slices(g)
              for g in grads]
    return concat_slices(tuple(slices))


def _proposed_algorithm2(grads: List[Contribution],
                         use_kernel: bool) -> Contribution:
    """Paper Algorithm 2 (proposed TF fix)."""
    if len(grads) < 2:
        return grads[0]
    if _all_dense(grads):
        out = grads[0]
        for g in grads[1:]:
            out = out + g
        return out
    if _any_dense(grads):
        dense = [densify(g, use_kernel=use_kernel) for g in grads]
        out = dense[0]
        for g in dense[1:]:
            out = out + g
        return out
    return concat_slices(tuple(grads))


def accumulated_nbytes(g: Contribution) -> int:
    """Size in bytes of the accumulated representation (paper Fig. 5)."""
    if isinstance(g, IndexedSlices):
        return g.nbytes
    return int(g.numel() * g.element_size())
