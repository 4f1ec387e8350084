"""Activation sharding constraints (``repro.models.activation_sharding``).

With FSDP-sharded weights (output dim over ``("model", "data")``) a
partitioner must choose between de-sharding the batch and gathering the
weight when a product's output would carry the ``data`` axis twice.
Pinning the residual stream to batch-over-data, replicated over every
other mesh dim, forces the cheap choice (gather the weight shard, classic
FSDP).

The partitioned step installs the data-parallel axis names
(``activation_sharding``); the model calls ``constrain_batch`` on the
embedding and on each block's output.  On a plain tensor, or with no axes
installed, it is the identity; on a ``DTensor`` it redistributes to
``Shard(0)`` on each installed data axis and ``Replicate()`` on every
other mesh dim: the reference's ``P(dp_axes, None, ...)``, where
``None`` is replicated, not unconstrained.

``split_heads`` views a projection as heads; ``whole_over_model``
gathers a DTensor over ``model``; ``vocab_sharded`` lays a
tied embedding out for the output projection,
and ``logsumexp`` reduces vocab-parallel logits on their shards.
``shard_local`` runs a body whose work is local to a batch shard and a
head shard (attention, the SSD scan, the xLSTM recurrences, MoE dispatch
and combine) through ``local_map`` with its placements declared, so a
partitioned step neither finds an op without a sharding strategy there
nor gathers the body's inputs wholesale.  On plain tensors it calls the
body as it is.
"""
from __future__ import annotations

import contextlib
import math
from contextvars import ContextVar
from typing import Callable, Optional, Sequence, Tuple

import torch

_DP_AXES: ContextVar[Optional[Tuple[str, ...]]] = ContextVar(
    "repro_torch_dp_axes", default=None)


@contextlib.contextmanager
def activation_sharding(dp_axes: Sequence[str]):
    token = _DP_AXES.set(tuple(dp_axes))
    try:
        yield
    finally:
        _DP_AXES.reset(token)


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def batch_placements(mesh, dim: Optional[int] = None, n: int = 0,
                     axes: Optional[Tuple[str, ...]] = None,
                     batch: Optional[int] = None) -> tuple:
    """``Shard(0)`` on each data axis (the installed ones, or ``axes``)
    where ``batch`` (dim 0's size, when given) divides evenly over them,
    ``Shard(dim)`` on ``model`` where ``n`` (that dim's size) divides
    evenly over it, ``Replicate()`` elsewhere."""
    from torch.distributed.tensor import Replicate, Shard
    axes = _DP_AXES.get() if axes is None else axes
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    if axes and batch is not None and batch % math.prod(
            sizes[a] for a in axes if a in sizes):
        axes = ()
    out = []
    for name, size in zip(mesh.mesh_dim_names, mesh.shape):
        if axes and name in axes:
            out.append(Shard(0))
        elif (name == "model" and dim is not None and size > 1
              and n and n % size == 0):
            out.append(Shard(dim))
        else:
            out.append(Replicate())
    return tuple(out)


def constrain_batch(x: torch.Tensor) -> torch.Tensor:
    """Pin dim 0 (batch) to the data-parallel axes, every other mesh dim
    replicated (see the module docstring)."""
    if _DP_AXES.get() is None or not is_dtensor(x):
        return x
    want = batch_placements(x.device_mesh, batch=x.shape[0])
    if tuple(x.placements) == want:
        return x
    return x.redistribute(x.device_mesh, want)


def vocab_sharded(table: torch.Tensor) -> torch.Tensor:
    """A tied (vocab, d) table laid out for the output projection: the
    vocab dim over ``model`` (where it divides evenly), replicated on
    every other mesh dim, so the logits come out vocab-parallel rather
    than as partial sums over a sharded d.  The identity on a plain
    tensor."""
    if not is_dtensor(table):
        return table
    want = batch_placements(table.device_mesh, 0, table.shape[0], axes=())
    if tuple(table.placements) == want:
        return table
    return table.redistribute(table.device_mesh, want)


def replicated(x: torch.Tensor) -> torch.Tensor:
    """A DTensor made whole on every rank (``Replicate()`` on each mesh
    dim); anything else as it is."""
    from torch.distributed.tensor import Replicate
    if not is_dtensor(x):
        return x
    want = [Replicate()] * x.device_mesh.ndim
    if list(x.placements) == want:
        return x
    return x.redistribute(x.device_mesh, want)


def whole_over_model(x: torch.Tensor) -> torch.Tensor:
    """A DTensor split over ``model`` gathered there (its other
    placements kept); anything else as it is."""
    from torch.distributed.tensor import Replicate, Shard
    if not is_dtensor(x) or "model" not in x.device_mesh.mesh_dim_names:
        return x
    i = x.device_mesh.mesh_dim_names.index("model")
    if not isinstance(x.placements[i], Shard):
        return x
    pl = list(x.placements)
    pl[i] = Replicate()
    return x.redistribute(x.device_mesh, pl)


def split_heads(x: torch.Tensor, n: int, hd: int) -> torch.Tensor:
    """(B, S, n * hd) -> (B, S, n, hd).  A DTensor whose last dim is split
    over mesh dims whose product ``n`` is not a multiple of (GQA's kv
    heads on a wide model axis, a cache state split over data and model)
    is gathered over them first: DTensor has no view that splits a
    head."""
    from torch.distributed.tensor import Replicate, Shard
    if is_dtensor(x):
        last = x.dim() - 1
        split = [i for i, p in enumerate(x.placements)
                 if isinstance(p, Shard) and p.dim in (-1, last)]
        if n % math.prod(x.device_mesh.shape[i] for i in split):
            pl = list(x.placements)
            for i in split:
                pl[i] = Replicate()
            x = x.redistribute(x.device_mesh, pl)
    return x.reshape(x.shape[0], x.shape[1], n, hd)


def logsumexp(x: torch.Tensor) -> torch.Tensor:
    """``torch.logsumexp`` over the last dim.  On a DTensor whose last dim
    is sharded (vocab-parallel logits) it is taken as the max-shifted sum,
    so both reductions run on the shards and only the (B, s, 1) max and
    sum cross ranks, where DTensor would gather the logits for the
    fused op."""
    from torch.distributed.tensor import Shard
    if not is_dtensor(x) or not any(
            isinstance(p, Shard) and p.dim in (-1, x.dim() - 1)
            for p in x.placements):
        return torch.logsumexp(x, dim=-1)
    m = torch.amax(x, dim=-1, keepdim=True).detach()
    return (m + torch.log(torch.sum(torch.exp(x - m), dim=-1,
                                    keepdim=True)))[..., 0]


def shard_local(fn: Callable, args: Sequence, in_dims: Sequence,
                out_dims, n: int):
    """``fn(*args)`` on each rank's shard of its tensors.  One entry of
    ``in_dims`` an argument, naming its layout: a dim ``d`` (the batch,
    dim 0, over the data axes where the first DTensor's dim 0 divides
    evenly over them, and dim ``d`` over ``model`` when ``n`` divides
    evenly over it), ``None`` (the batch only), ``("m", d)``
    (dim ``d`` over ``model`` as before, no batch dim) or ``"r"``
    (replicated).  The entry of an argument that is not a tensor is
    ignored and the argument passed as it is; a plain tensor among
    DTensors is taken as replicated.  ``out_dims`` is one such
    entry, or a tuple of them for a tuple of outputs.  Without a DTensor
    among ``args`` it is ``fn(*args)``."""
    if not any(is_dtensor(a) for a in args):
        return fn(*args)
    from torch.distributed.tensor import DTensor, Replicate
    from torch.distributed.tensor.experimental import local_map
    first = next(a for a in args if is_dtensor(a))
    mesh, batch = first.device_mesh, first.shape[0]
    # a plain tensor among DTensors holds the global value (a fresh
    # state, a constant): replicated, then cut to its layout
    args = [DTensor.from_local(a, mesh, [Replicate()] * mesh.ndim,
                               run_check=False)
            if isinstance(a, torch.Tensor) and not is_dtensor(a) else a
            for a in args]

    def pl(d):          # one tensor's placements: a list (a tuple would
        if d == "r":    # be one per output)
            return [Replicate()] * mesh.ndim
        if isinstance(d, tuple):
            return list(batch_placements(mesh, d[1], n, axes=()))
        return list(batch_placements(mesh, d, n, batch=batch))
    ins = tuple(pl(d) if is_dtensor(a) else None
                for a, d in zip(args, in_dims))
    outs = (tuple(pl(d) for d in out_dims)
            if isinstance(out_dims, tuple) and out_dims[0] != "m"
            else pl(out_dims))
    return local_map(fn, out_placements=outs, in_placements=ins,
                     device_mesh=mesh, redistribute_inputs=True)(*args)
