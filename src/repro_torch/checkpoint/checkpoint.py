"""Tree checkpoints: a flat-key npz with a dtype- and shape-exact round
trip (``repro.checkpoint.checkpoint``), in the reference's file format,
so one file moves between the two packages.

Keys are ``/``-joined tree paths: dict keys as they are (sorted, as the
tree's leaf order is), ``#i`` for the entries of a tuple, a list or an
``ExchangeState``, ``@name`` for the fields of a NamedTuple
(``AdamState``, ``Zero1State``).  bfloat16 tensors are stored as their
uint16 bit patterns under a ``:bf16`` suffix (numpy has no bfloat16).
The file is written to a temporary name and renamed, so a crash never
leaves half a checkpoint under a step's name.

``ShardedCheckpoint`` adds the worker dimension: every rank holds its own
slice of the ZeRO-1 state and its own error-feedback residuals, and the
file holds the reference's GLOBAL view (dense-stage Zero1State entries
and residuals of P slices, in rank order).  Rank 0 writes it after the
slices are gathered; on restore every rank reads it and keeps its own
slice, so a checkpoint resumes only on the worker count it was saved
with (the shape check names the ZeRO-1 shard).
"""
from __future__ import annotations

import os
import re
import tempfile
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import comm
from repro_torch.core.codecs import ExchangeState
from repro_torch.optim import zero1

BF16_SUFFIX = ":bf16"


# ---------------------------------------------------------------------------
# The tree walker: dicts, tuples, lists, NamedTuples and ExchangeState
# ---------------------------------------------------------------------------

def _children(node) -> List[Tuple[str, Any]]:
    """``(key, child)`` pairs of a tree node, in the reference's leaf
    order; ``None`` and empty tuples are nodes without children."""
    if isinstance(node, dict):
        return [(str(k), node[k]) for k in sorted(node)]
    if isinstance(node, ExchangeState):
        return [(f"#{i}", s) for i, s in enumerate(node.bucket_states)]
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return [(f"@{f}", getattr(node, f)) for f in node._fields]
    if isinstance(node, (tuple, list)):
        return [(f"#{i}", c) for i, c in enumerate(node)]
    if node is None:
        return []
    raise TypeError(f"checkpoint: cannot walk a {type(node).__name__}")


def _rebuild(node, children: List[Any]):
    if isinstance(node, dict):
        return dict(zip(sorted(node), children))
    if isinstance(node, ExchangeState):
        return ExchangeState(children)
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return type(node)(*children)
    if isinstance(node, (tuple, list)):
        return type(node)(children)
    return node


# Module-level recursions (a nested function that calls itself is a
# reference cycle, which would keep every tensor it saw alive).

def _flatten(node, prefix: str, out: List[Tuple[str, torch.Tensor]]):
    if isinstance(node, torch.Tensor):
        out.append((prefix, node))
        return
    for key, child in _children(node):
        _flatten(child, f"{prefix}/{key}" if prefix else key, out)


def _unflatten(node, it):
    if isinstance(node, torch.Tensor):
        return next(it)
    return _rebuild(node, [_unflatten(c, it) for _, c in _children(node)])


def flatten_with_paths(tree) -> List[Tuple[str, torch.Tensor]]:
    """``(key, tensor)`` for every leaf, in leaf order (the reference's
    ``jax.tree_util.tree_flatten_with_path`` keys, ``/``-joined)."""
    out: List[Tuple[str, torch.Tensor]] = []
    _flatten(tree, "", out)
    return out


def nbytes(tree) -> int:
    """Bytes the tensors of a tree hold (a training state, a Zero1State
    or an AdamState): what ``optimizer_state_bytes`` predicts for the
    optimizer state."""
    return sum(t.numel() * t.element_size()
               for _, t in flatten_with_paths(tree))


def _to_numpy(t: torch.Tensor) -> Tuple[str, np.ndarray]:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return BF16_SUFFIX, t.view(torch.int16).numpy().view(np.uint16)
    return "", t.numpy()


# ---------------------------------------------------------------------------
# Files
# ---------------------------------------------------------------------------

def _path(directory: str, step: int) -> str:
    return os.path.join(directory, f"ckpt_{step:08d}.npz")


def save_checkpoint(directory: str, step: int, tree: Any) -> str:
    """Write ``tree`` as ``ckpt_{step:08d}.npz`` in ``directory``
    (created if missing), atomically; returns the path."""
    os.makedirs(directory, exist_ok=True)
    flat: Dict[str, np.ndarray] = {}
    for key, t in flatten_with_paths(tree):
        suffix, arr = _to_numpy(t)
        flat[key + suffix] = arr
    path = _path(directory, step)
    fd, tmp = tempfile.mkstemp(dir=directory, suffix=".tmp")
    with os.fdopen(fd, "wb") as f:
        np.savez(f, **flat)
    os.replace(tmp, path)
    return path


def restore_checkpoint(directory: str, like: Any,
                       step: Optional[int] = None) -> Tuple[Any, int]:
    """Restore into the structure of ``like`` (the template: each leaf's
    shape, dtype and device); ``step=None`` takes the latest.  Returns
    ``(tree, step)``."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {directory}")
    pairs = flatten_with_paths(like)
    keys = [key + (BF16_SUFFIX if t.dtype == torch.bfloat16 else "")
            for key, t in pairs]
    with np.load(_path(directory, step)) as data:
        missing = set(keys) - set(data.files)
        extra = set(data.files) - set(keys)
        if missing or extra:
            raise ValueError(f"checkpoint mismatch: missing="
                             f"{sorted(missing)[:5]} extra="
                             f"{sorted(extra)[:5]}")
        new_leaves = []
        for key, (_, leaf) in zip(keys, pairs):
            arr = data[key]
            if tuple(arr.shape) != tuple(leaf.shape):
                hint = ""
                if "param_shards" in key or "opt_slots" in key:
                    # Zero1State leaves are 1/P flat shards of the mesh
                    hint = (" — this looks like a ZeRO-1 shard: zero1 "
                            "optimizer state is partitioned by mesh size, "
                            "so a checkpoint only resumes on the worker "
                            "count it was saved with")
                raise ValueError(f"shape mismatch at {key}: "
                                 f"{tuple(arr.shape)} vs "
                                 f"{tuple(leaf.shape)}{hint}")
            if key.endswith(BF16_SUFFIX):
                t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
            else:
                t = torch.from_numpy(arr)
            new_leaves.append(t.to(device=leaf.device, dtype=leaf.dtype))
    return _unflatten(like, iter(new_leaves)), step


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = [int(m.group(1)) for f in os.listdir(directory)
             if (m := re.match(r"ckpt_(\d+)\.npz$", f))]
    return max(steps) if steps else None


# ---------------------------------------------------------------------------
# The worker dimension
# ---------------------------------------------------------------------------

class ShardedCheckpoint:
    """Checkpoints of a rank's training state (a tuple such as ``(params,
    opt_state, exchange_state)``) in the reference's global view.

    ``group`` is the data-parallel process group whose ranks hold the
    slices (``None``: a world of 1, where the local view is the global
    one); ``plan`` is the ExchangePlan a ``Zero1State`` was built for
    (needed at a world above 1).  Parameters and a replicated
    ``AdamState`` are the same on every rank and pass as they are.
    ``save`` and ``restore`` are collectives: every rank calls them."""

    def __init__(self, plan=None, group=None):
        self.plan = plan
        self.group = group
        groups = comm.groups(group)
        if len(groups) > 1:
            raise ValueError("ShardedCheckpoint runs over one process "
                             "group (the data-parallel world)")
        self.world = comm.axis_size(groups)
        self.rank = dist.get_rank(groups[0]) if groups else 0

    def _map(self, tree, on_zero1, on_residual):
        """``tree`` with each Zero1State and each residual of an
        ExchangeState mapped (nothing to map at a world of 1)."""
        if self.world == 1:
            return tree
        out = []
        for part in tree:
            if isinstance(part, zero1.Zero1State):
                if self.plan is None:
                    raise ValueError("ShardedCheckpoint: a Zero1State at a "
                                     "world above 1 needs its plan")
                part = on_zero1(part)
            elif isinstance(part, ExchangeState):
                part = ExchangeState([
                    on_residual(s) if isinstance(s, torch.Tensor) else s
                    for s in part.bucket_states])
            out.append(part)
        return type(tree)(out)

    def to_global(self, tree):
        """The global view of every rank's ``tree`` (a collective)."""
        return self._map(
            tree, lambda z: zero1.gather_state(self.plan, z, self.group),
            lambda r: comm.wait(comm.all_gather_dense(r, self.group)))

    def template(self, tree):
        """Empty tensors of the global view's shapes (no collective)."""
        def wide(t):
            return torch.empty((self.world * t.shape[0],), dtype=t.dtype,
                               device=t.device)

        def on_zero1(z):
            dense = [st.kind == "dense" for st in self.plan.schedule.stages]
            return zero1.Zero1State(
                step=z.step,
                param_shards=tuple(
                    wide(m) if d and not isinstance(m, tuple) else m
                    for d, m in zip(dense, z.param_shards)),
                opt_slots=tuple(tuple(map(wide, s)) if d else s
                                for d, s in zip(dense, z.opt_slots)))
        return self._map(tree, on_zero1, wide)

    def to_local(self, tree):
        """This rank's slice of a global-view ``tree``."""
        def residual(r):
            n = r.shape[0] // self.world
            return r.narrow(0, self.rank * n, n).clone()
        return self._map(
            tree, lambda z: zero1.local_state(self.plan, z, self.rank,
                                              self.world), residual)

    def save(self, directory: str, step: int, tree) -> Optional[str]:
        """Gather the global view and write it from rank 0 (the others
        return None once it is written)."""
        full = self.to_global(tree)
        path = save_checkpoint(directory, step, full) \
            if self.rank == 0 else None
        if self.world > 1:
            dist.barrier(group=self.group)
        return path

    def restore(self, directory: str, like, step: Optional[int] = None):
        """Read the global view into ``like``'s structure and keep this
        rank's slice; returns ``(tree, step)``."""
        full, step = restore_checkpoint(directory, self.template(like),
                                        step)
        return self.to_local(full), step
