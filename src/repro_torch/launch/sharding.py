"""Sharding rules: params, optimizer state, batches and caches -> mesh
(``repro.launch.sharding``, rules verbatim).

A spec is a tuple with one entry per dim: ``None`` (replicated), an axis
name, or a tuple of two or more axis names (the dim split over their
product, in that order), normalised as ``PartitionSpec`` normalises its
entries.  The strategy is the reference's FSDP x TP hybrid: for every
parameter leaf (past the leading scan/layer dim) the output dim goes over
``model`` (column-parallel, plus ``data`` on the same dim under FSDP),
the input dim of a row-parallel weight over ``model`` only, MoE expert
dims over ``model``; batches shard their batch dim over the data axes
(the 500k decode cache its sequence dim instead).  ``placements`` turns
a spec into DTensor placements, ``shard_shape`` gives the per-device
shape the dry run's memory accounting sums.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Tuple

from repro_torch.launch.mesh import MeshSpec

Spec = Tuple[Any, ...]


def _axis_sizes(mesh: MeshSpec) -> Dict[str, int]:
    return dict(zip(mesh.axis_names, mesh.shape))


def param_spec(path: Tuple[str, ...], shape: Tuple[int, ...],
               mesh: MeshSpec, scanned: bool, fsdp: bool = True) -> Spec:
    """The spec of one parameter leaf."""
    sizes = _axis_sizes(mesh)
    n_model = sizes.get("model", 1)
    n_data = sizes.get("data", 1)
    spec: list = [None] * len(shape)
    start = 1 if scanned and len(shape) > 1 else 0
    dims = list(range(start, len(shape)))
    # MoE expert weights: expert-parallel over `model`, FSDP over `data`
    # on the hidden (f) dim of the up projections only (w_down's last dim
    # is the residual width, whose data-sharding would collide with the
    # batch axis)
    expert_weight = (any(n in ("w_gate", "w_up", "w_down") for n in path)
                     and len(shape) - start == 3)
    if expert_weight and n_model > 1 and shape[start] % n_model == 0:
        spec[start] = "model"
        last = len(shape) - 1
        if (fsdp and n_data > 1 and shape[last] % n_data == 0
                and path[-1] != "w_down"):
            spec[last] = "data"
        return tuple(spec)
    # Megatron pairing: column-parallel weights shard their output (last)
    # dim over `model` (+ `data` under FSDP); row-parallel weights (wo /
    # w_out / w_down / w_ff2) their input dim over `model` only, so the
    # paired products contract locally
    last = len(shape) - 1
    name = path[-1] if path else ""
    row_parallel = name in ("wo", "w_out", "w_down", "w_ff2")
    if row_parallel and len(shape) - start >= 2 \
            and shape[start] % n_model == 0 and n_model > 1:
        spec[start] = "model"
        return tuple(spec)
    if n_model > 1 and shape[last] % n_model == 0 and shape[last] >= n_model:
        if fsdp and n_data > 1 and shape[last] % (n_model * n_data) == 0:
            spec[last] = ("model", "data")
        else:
            spec[last] = "model"
        return tuple(spec)
    # fallback: the largest divisible dim over model only
    dims.sort(key=lambda i: -shape[i])
    for i in dims:
        if n_model > 1 and shape[i] % n_model == 0 and shape[i] >= n_model:
            spec[i] = "model"
            break
    return tuple(spec)


def _map_with_keys(fn, tree, prefix: Tuple[str, ...] = ()):
    """``fn(key path, leaf)`` over dicts (their keys), named tuples
    (their field names) and lists, the names ``jax.tree_util`` paths
    carry."""
    if isinstance(tree, dict):
        return {k: _map_with_keys(fn, v, prefix + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map_with_keys(fn, getattr(tree, f),
                                           prefix + (f,))
                            for f in tree._fields))
    if isinstance(tree, list):
        return [_map_with_keys(fn, v, prefix + (f"[{i}]",))
                for i, v in enumerate(tree)]
    return fn(prefix, tree)


def _map_leaves(fn, tree):
    return _map_with_keys(lambda _, leaf: fn(leaf), tree)


def params_shardings(params: Any, mesh: MeshSpec, fsdp: bool = True) -> Any:
    """A spec for every leaf of ``params`` (or of an optimizer state
    holding params-shaped trees); meta tensors will do."""
    def one(names, leaf):
        shape = tuple(leaf.shape)
        # stacked layer params have the scan dim first
        scanned = any(n in ("layers", "mamba", "mlstm", "slstm")
                      for n in names)
        if len(shape) == 0:
            return ()
        return param_spec(tuple(names), shape, mesh, scanned, fsdp)
    return _map_with_keys(one, params)


def _entry(axes: Tuple[str, ...]):
    """One spec entry for a dim split over ``axes``."""
    if not axes:
        return None
    return axes[0] if len(axes) == 1 else tuple(axes)


def _padded(spec: Spec, ndim: int) -> Spec:
    return tuple(spec) + (None,) * (ndim - len(spec))


def batch_shardings(batch: Any, mesh: MeshSpec, shard_seq: bool = False,
                    dp_axes=None) -> Any:
    """Batch dim over (pod, data); optionally the seq dim instead when
    batch == 1 (long-context decode)."""
    dp = (tuple(dp_axes) if dp_axes is not None else
          tuple(a for a in mesh.axis_names if a != "model"))

    def one(leaf):
        shape = tuple(leaf.shape)
        if len(shape) == 0:
            return ()
        if shard_seq and len(shape) >= 2 and shape[0] == 1:
            return _padded((None, _entry(dp)), len(shape))
        total = math.prod(_axis_sizes(mesh)[a] for a in dp)
        if shape[0] % total == 0:
            return _padded((_entry(dp),), len(shape))
        return _padded((), len(shape))
    return _map_leaves(one, batch)


def cache_shardings(cache: Any, mesh: MeshSpec, batch: int) -> Any:
    """KV/state caches, laid out (L, B, S, ...): B over (pod, data) when
    divisible, else S over (pod, data); the (long) sequence dim over
    ``model``, which keeps decode attention's contractions local."""
    sizes = _axis_sizes(mesh)
    dp = tuple(a for a in mesh.axis_names if a != "model")
    n_dp = math.prod(sizes[a] for a in dp)
    n_model = sizes.get("model", 1)

    def one(leaf):
        shape = tuple(leaf.shape)
        if len(shape) <= 1:
            return _padded((), len(shape))
        spec: list = [None] * len(shape)
        # the batch dim (== batch) after the leading stack dim
        bdim = None
        for i, s in enumerate(shape):
            if s == batch and i > 0:
                bdim = i
                break
        if bdim is None and shape[0] == batch:
            bdim = 0
        batch_sharded = False
        if bdim is not None and batch % n_dp == 0 and batch >= n_dp:
            spec[bdim] = _entry(dp)
            batch_sharded = True
        # the sequence dim: the longest dim that isn't batch/stack
        sdim = None
        if len(shape) >= 3:
            cand = [(s, i) for i, s in enumerate(shape)
                    if i not in (0, bdim)]
            if cand:
                s_len, sdim = max(cand)
                if s_len < 1024:
                    sdim = None
        if sdim is not None:
            if not batch_sharded and shape[sdim] % (n_dp * n_model) == 0:
                spec[sdim] = _entry(dp + ("model",))
            elif shape[sdim] % n_model == 0 and n_model > 1:
                spec[sdim] = "model"
        return tuple(spec)
    return _map_leaves(one, cache)


def replicated(tree: Any, mesh: MeshSpec) -> Any:
    return _map_leaves(lambda leaf: _padded((), len(leaf.shape)), tree)


def _axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def shard_shape(shape, spec: Spec, mesh: MeshSpec) -> Tuple[int, ...]:
    """The per-device shape of a ``shape`` tensor laid out by ``spec``
    (a dim split over axes of product n holds ceil(size / n))."""
    sizes = _axis_sizes(mesh)
    spec = _padded(spec, len(shape))
    return tuple(-(-int(s) // math.prod(sizes[a] for a in _axes(e)))
                 for s, e in zip(shape, spec))


def placements(spec: Spec, mesh: MeshSpec) -> tuple:
    """DTensor placements of ``spec``, one per mesh dim: ``Shard(i)``
    where tensor dim i is split over that axis, else ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard
    out = []
    for axis in mesh.axis_names:
        dims = [i for i, e in enumerate(spec) if axis in _axes(e)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


def shard_bytes(tree: Any, specs: Any, mesh: MeshSpec) -> int:
    """Per-device bytes of ``tree`` laid out by ``specs`` (a tree of the
    same structure, as the functions above return)."""
    leaves, spec_leaves = flatten(tree), flatten(specs)
    if len(leaves) != len(spec_leaves):
        raise ValueError(f"{len(leaves)} leaves but {len(spec_leaves)} "
                         f"specs")
    return sum(math.prod(shard_shape(t.shape, s, mesh)) * t.element_size()
               for t, s in zip(leaves, spec_leaves))


def flatten(tree) -> list:
    """The leaves of a tree of ``_map_with_keys``' containers, a spec
    tuple among them."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in flatten(tree[k])]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [x for f in tree._fields for x in flatten(getattr(tree, f))]
    if isinstance(tree, list):
        return [x for v in tree for x in flatten(v)]
    return [tree]
