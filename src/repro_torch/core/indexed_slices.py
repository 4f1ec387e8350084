"""IndexedSlices: a sparse row-slice gradient representation.

The torch counterpart of ``repro.core.indexed_slices`` (itself the
analogue of ``tf.IndexedSlices``): a pair ``(indices, values)`` plus a
static ``dense_shape``.  ``values[i]`` is the gradient contribution to row
``indices[i]`` of a dense ``dense_shape`` tensor; duplicate indices mean
*sum* (``tf.gather``'s VJP semantics).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch


@dataclasses.dataclass
class IndexedSlices:
    """Sparse rows ``values`` scattered at ``indices`` of a dense tensor.

    Attributes:
      indices: int32 ``(n,)`` row ids (duplicates allowed, meaning +=).
      values:  ``(n, *dense_shape[1:])`` rows.
      dense_shape: static tuple, shape of the equivalent dense tensor.
    """

    indices: torch.Tensor
    values: torch.Tensor
    dense_shape: Tuple[int, ...]

    @property
    def dtype(self) -> torch.dtype:
        return self.values.dtype

    @property
    def nbytes(self) -> int:
        """Wire size of this representation (indices + values)."""
        return int(self.indices.numel() * self.indices.element_size()
                   + self.values.numel() * self.values.element_size())

    def to_dense(self) -> torch.Tensor:
        """Densify by scatter-add into zeros, adding in the values' dtype
        (the reference path; ``core.accumulation.densify(use_kernel=True)``
        takes the kernel)."""
        zeros = torch.zeros(self.dense_shape, dtype=self.values.dtype,
                            device=self.values.device)
        return zeros.index_add_(0, self.indices.long(), self.values)

    @classmethod
    def from_dense(cls, dense: torch.Tensor,
                   indices: torch.Tensor) -> "IndexedSlices":
        """The rows ``dense[indices]`` as IndexedSlices of ``dense``'s
        shape (the row gather of ``tf.gather``)."""
        return cls(indices=indices, values=dense[indices.long()],
                   dense_shape=tuple(dense.shape))

    def __repr__(self):
        return (f"IndexedSlices(n={self.indices.shape[0]}, "
                f"dense_shape={self.dense_shape}, dtype={self.values.dtype})")


def is_indexed_slices(x) -> bool:
    return isinstance(x, IndexedSlices)


def concat_slices(slices: Tuple[IndexedSlices, ...]) -> IndexedSlices:
    """Concatenate IndexedSlices — TF's *gather* accumulation.  The row
    count is the SUM of the inputs' row counts: the representation growth
    the paper identifies."""
    if not slices:
        raise ValueError("concat_slices needs at least one IndexedSlices")
    shapes = {s.dense_shape for s in slices}
    if len(shapes) != 1:
        raise ValueError(f"mismatched dense_shapes: {shapes}")
    return IndexedSlices(
        indices=torch.cat([s.indices for s in slices]),
        values=torch.cat([s.values for s in slices]),
        dense_shape=slices[0].dense_shape,
    )
