"""The partitioned step: DTensors over a ``DeviceMesh`` (the port's
counterpart of the reference's ``jit`` with ``in_shardings`` /
``out_shardings``, which GSPMD partitions).

Every argument leaf becomes a ``DTensor`` laid out by its spec
(``launch.sharding``): ``distribute`` takes each rank's block of a real
tensor, or an empty meta tensor of the block's shape, so nothing is
allocated at the global size on meta.  Products then follow DTensor's
sharding propagation, which inserts the collectives the Megatron column
and row rules call for; the bodies local to a batch shard and a head
shard run through ``local_map`` (``models.activation_sharding.
shard_local``); the residual stream is pinned by ``constrain_batch``.

A dim split over ``("model", "data")`` (the FSDP column rule) becomes
``Shard(d)`` on both mesh dims, which DTensor splits in mesh order
(data-major) where the reference's spec is model-major: the bytes a rank
holds and every result are the same, only which block each rank holds
differs.  The port takes DTensor's order.

  * ``partitioned_grads`` / ``make_partitioned_train_step``: the train
    step of ``training.make_train_step`` on DTensors.  The gradients come
    back from the backward as DTensor leaves them (``Partial`` over the
    data axes, where the batch was split) and are redistributed to their
    parameters' layouts: the data-parallel reduction the partitioner
    inserts (an all-reduce, or a reduce-scatter for an FSDP leaf).  The
    plan's exchange then runs on each rank's shards (``local_map``, the
    local path: no collective of its own), and AdamW updates the shards.
    Data-sharded weights, and each layer's vectors, are gathered before
    the forward (``fsdp_gathered``), as in the prefill and serve steps
    (``partitioned_call``, which also reduces their outputs' partial
    sums).
  * ``CollectiveRecorder``: a dispatch mode that counts every functional
    collective DTensor dispatches, by kind and by mesh dim, with the
    bytes of the local tensor each call returns (the reference bills an
    HLO collective's result bytes).
  * ``LiveBytes``: the peak of the bytes of the local tensors' storages
    alive at once, counted from the storages the run creates (those of
    its arguments are not counted), each freed when its last tensor
    goes.
"""
from __future__ import annotations

import contextlib
import weakref
from typing import Any, Callable, Dict, Optional, Sequence

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten as _pt_flatten
from torch.utils._pytree import tree_unflatten as _pt_unflatten

from repro_torch.launch import sharding as shard_lib
from repro_torch.launch.flops import _skipped
from repro_torch.models.activation_sharding import (activation_sharding,
                                                    is_dtensor)
from repro_torch.optim.base import apply_updates
from repro_torch.training.gradients import grad_contributions
from repro_torch.tree import tree_flatten, tree_map, tree_unflatten

#: functional collective -> the kind it is billed under
COLLECTIVE_KINDS = {"all_reduce": "all_reduce",
                    "all_gather_into_tensor": "all_gather",
                    "reduce_scatter_tensor": "reduce_scatter",
                    "all_to_all_single": "all_to_all"}


# ---------------------------------------------------------------------------
# Laying arguments out
# ---------------------------------------------------------------------------

def local_shard(t: torch.Tensor, dmesh, placements) -> torch.Tensor:
    """This rank's block of ``t`` under ``placements`` (an empty meta
    tensor of the block's shape when ``t`` is on meta)."""
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset)
    shape, offset = compute_local_shape_and_global_offset(
        t.shape, dmesh, list(placements))
    if t.device.type == "meta":
        return torch.empty(shape, dtype=t.dtype, device="meta")
    index = tuple(slice(o, o + n) for o, n in zip(offset, shape))
    return t[index].contiguous()


def as_dtensor(t: torch.Tensor, dmesh, placements):
    """``t`` (the global tensor, every rank holding the same) as a DTensor
    laid out by ``placements``, from this rank's block alone."""
    from torch.distributed.tensor import DTensor
    local = local_shard(t, dmesh, placements)
    stride = torch.empty(t.shape, device="meta").stride()
    return DTensor.from_local(local, dmesh, list(placements),
                              run_check=False, shape=t.shape, stride=stride)


def _zip_map(fn, tree, specs):
    """``fn(leaf, spec)`` over a tree of ``launch.sharding``'s containers
    and the spec tree of the same structure."""
    if isinstance(tree, dict):
        return {k: _zip_map(fn, v, specs[k]) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_zip_map(fn, getattr(tree, f),
                                     getattr(specs, f))
                            for f in tree._fields))
    if isinstance(tree, list):
        return [_zip_map(fn, v, s) for v, s in zip(tree, specs)]
    return fn(tree, specs)


def distribute(tree: Any, specs: Any, mesh_spec, dmesh) -> Any:
    """Every tensor leaf of ``tree`` as a DTensor laid out by its spec
    (``specs`` a tree of ``launch.sharding`` specs; ``None`` leaves the
    tree as it is)."""
    if specs is None:
        return tree

    def one(t, spec):
        if not isinstance(t, torch.Tensor):
            return t
        return as_dtensor(t, dmesh, shard_lib.placements(spec, mesh_spec))
    return _zip_map(one, tree, specs)


def gather(tree: Any) -> Any:
    """The global value of every DTensor leaf (a collective per sharded
    leaf); other leaves as they are."""
    return tree_map(lambda t: t.full_tensor() if is_dtensor(t) else t,
                    tree)


def local_bytes(tree: Any) -> int:
    """This rank's bytes of the tensors of ``tree`` (a DTensor's local
    block)."""
    total = 0
    for t in _pt_flatten(tree)[0]:
        if is_dtensor(t):
            t = t.to_local()
        if isinstance(t, torch.Tensor):
            total += t.numel() * t.element_size()
    return total


@contextlib.contextmanager
def partitioned(dp_axes: Sequence[str]):
    """The context a partitioned step runs in: the data axes installed
    for ``constrain_batch``, plain tensors (positions, masks, constants)
    taken as replicated, and DTensor's notes on multi-dim redistributes
    silenced."""
    import logging
    from torch.distributed.tensor.experimental import implicit_replication
    log = logging.getLogger("torch.distributed.tensor._redistribute")
    level = log.level
    log.setLevel(logging.ERROR)
    try:
        with activation_sharding(dp_axes), implicit_replication():
            yield
    finally:
        log.setLevel(level)


# ---------------------------------------------------------------------------
# The train step
# ---------------------------------------------------------------------------

def gathered_over(t, axes: Sequence[str]):
    """A DTensor parameter with its shards over ``axes`` gathered (the
    FSDP weight gather); its other placements kept."""
    if not is_dtensor(t):
        return t
    from torch.distributed.tensor import Replicate
    want = [Replicate() if name in axes else pl for name, pl in
            zip(t.device_mesh.mesh_dim_names, t.placements)]
    if want == list(t.placements):
        return t
    return t.redistribute(t.device_mesh, want)


#: the parameter blocks stacked on a leading layer axis
STACKED = ("layers", "mamba", "mlstm", "slstm")


def fsdp_gathered(params, dp_axes: Sequence[str]):
    """``params`` with every leaf's data-axis shards gathered, and each
    layer's vectors (norm scales, biases) gathered over every mesh dim:
    a few KB, which DTensor would otherwise meet by sharding the
    activations they scale over ``model``."""
    out = {}
    for key, sub in params.items():
        lead = 1 if key in STACKED else 0

        def one(p):
            if not is_dtensor(p):
                return p
            axes = (p.device_mesh.mesh_dim_names if p.dim() - lead <= 1
                    else dp_axes)
            return gathered_over(p, axes)
        out[key] = tree_map(one, sub)
    return out


def reduced(t):
    """A DTensor with its partial sums reduced (``Partial`` placements
    made ``Replicate()``), as a step's outputs leave it; anything else
    as it is."""
    from torch.distributed.tensor import Partial, Replicate
    if not is_dtensor(t) or not any(isinstance(p, Partial)
                                    for p in t.placements):
        return t
    return t.redistribute(t.device_mesh, [
        Replicate() if isinstance(p, Partial) else p for p in t.placements])


def partitioned_call(fn: Callable, dp_axes: Sequence[str]) -> Callable:
    """``fn(params, *rest)`` (a prefill or serve step) run on DTensors:
    the parameters FSDP-gathered (``fsdp_gathered``) inside the
    ``partitioned`` context, the outputs' partial sums reduced."""
    def run(params, *rest):
        with partitioned(dp_axes):
            out = fn(fsdp_gathered(params, dp_axes), *rest)
            leaves, spec = _pt_flatten(out)
            return _pt_unflatten([reduced(t) for t in leaves], spec)
    return run


def partitioned_grads(model, params, batch, dp_axes: Sequence[str],
                      **loss_kw):
    """``grad_contributions`` on DTensor arguments (dense embedding
    gradient), each gradient redistributed to its parameter's layout.
    Returns (grads, loss, metrics).

    A parameter sharded over a data axis (FSDP) is gathered over it
    before the forward, classic FSDP, which is the choice the reference
    pins its activations to force.  DTensor picks each op's strategy by
    what its inputs cost to redistribute, and left alone it would gather
    the batch instead and reduce the products' outputs over the data axes
    (the tied head's f32 logits among them).  The gather's backward
    reduce-scatters those leaves' gradients."""
    with partitioned(dp_axes):
        grads, loss, metrics = grad_contributions(
            model, fsdp_gathered(params, dp_axes), batch, **loss_kw)
        grads = tree_map(
            lambda g, p: (g.redistribute(p.device_mesh, p.placements)
                          if is_dtensor(g) else g), grads, params)
    return grads, loss, metrics


def shard_exchange(opt, grads, state):
    """The plan's exchange of ``grads`` on each rank's shards (the local
    path: ``opt`` has no group).  Returns (dense tree, state)."""
    if opt.group is not None:
        raise ValueError("the partitioned step reduces over the mesh; its "
                         "optimizer takes no process group")
    if opt.exchange_config.codec_obj.stateful:
        raise ValueError("the partitioned step runs stateless codecs only")
    leaves, treedef = tree_flatten(grads)
    if not any(is_dtensor(g) for g in leaves):
        return opt.exchange(grads, state=state)
    from torch.distributed.tensor.experimental import local_map
    mesh = leaves[0].device_mesh
    places = tuple(list(g.placements) for g in leaves)

    def run(*local):
        tree = tree_unflatten(treedef, list(local))
        out, _ = opt.exchange(tree, state=opt.init_exchange_state(
            tree, device=local[0].device))
        return tuple(tree_flatten(out)[0])
    out = local_map(run, out_placements=places, in_placements=places,
                    device_mesh=mesh)(*leaves)
    return tree_unflatten(treedef, list(out)), state


def make_partitioned_train_step(model, opt, dp_axes: Sequence[str],
                                **loss_kw) -> Callable:
    """``step(params, opt_state, ex_state, batch) -> (params, opt_state,
    ex_state, metrics)`` on DTensors laid out over one mesh (see the
    module docstring): ``make_train_step``'s fused path, with
    ``loss_kw`` passed to ``Model.loss``."""
    def step(params, opt_state, ex_state, batch):
        grads, loss, metrics = partitioned_grads(model, params, batch,
                                                 dp_axes, **loss_kw)
        with partitioned(dp_axes):
            dense, ex_state = shard_exchange(opt, grads, ex_state)
            updates, opt_state = opt.base.update(dense, opt_state, params)
            params = apply_updates(params, updates)
        n_stages = opt.plan(grads).schedule.n_stages
        metrics = dict(metrics, loss=loss,
                       exchange_stages=torch.tensor(n_stages,
                                                    dtype=torch.int32))
        return params, opt_state, ex_state, metrics
    return step


# ---------------------------------------------------------------------------
# What the run dispatched
# ---------------------------------------------------------------------------

class CollectiveRecorder(TorchDispatchMode):
    """Counts the functional collectives dispatched inside ``with
    CollectiveRecorder(dmesh) as r:``, by kind and by mesh dim name
    (``r.counts[dim][kind]``, ``r.bytes[dim][kind]``: the bytes of the
    local tensor each call returns)."""

    def __init__(self, dmesh) -> None:
        super().__init__()
        self.dims = {dmesh.get_group(i).group_name: name
                     for i, name in enumerate(dmesh.mesh_dim_names)}
        self.counts: Dict[str, Dict[str, int]] = {}
        self.bytes: Dict[str, Dict[str, float]] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if _skipped(types) == "dtensor":
            return NotImplemented
        out = func(*args, **(kwargs or {}))
        name = func.overloadpacket.__name__
        if (func.namespace == "_c10d_functional"
                and name in COLLECTIVE_KINDS and not _skipped(types)):
            groups = [a for a in args if isinstance(a, str)]
            dim = self.dims.get(groups[-1], groups[-1]) if groups else "?"
            kind = COLLECTIVE_KINDS[name]
            nbytes = sum(t.numel() * t.element_size()
                         for t in _pt_flatten(out)[0]
                         if isinstance(t, torch.Tensor))
            c = self.counts.setdefault(dim, {})
            b = self.bytes.setdefault(dim, {})
            c[kind] = c.get(kind, 0) + 1
            b[kind] = b.get(kind, 0.0) + float(nbytes)
        return out

    def by_kind(self, dims: Optional[Sequence[str]] = None):
        """(counts, bytes) by kind, summed over ``dims`` (every mesh dim
        when None)."""
        counts: Dict[str, int] = {}
        nbytes: Dict[str, float] = {}
        for dim in self.counts:
            if dims is not None and dim not in dims:
                continue
            for k, n in self.counts[dim].items():
                counts[k] = counts.get(k, 0) + n
                nbytes[k] = nbytes.get(k, 0.0) + self.bytes[dim][k]
        return counts, nbytes


class LiveBytes(TorchDispatchMode):
    """``peak``: the most bytes of storages created inside ``with
    LiveBytes() as m:`` alive at one time (see the module docstring)."""

    def __init__(self) -> None:
        super().__init__()
        self.live = 0
        self.peak = 0
        self._seen: Dict[int, int] = {}

    def _free(self, key: int) -> None:
        self.live -= self._seen.pop(key, 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        skip = _skipped(types)
        if skip == "dtensor":
            return NotImplemented
        out = func(*args, **(kwargs or {}))
        if skip:
            return out
        for t in _pt_flatten(out)[0]:
            if not isinstance(t, torch.Tensor) or is_dtensor(t):
                continue
            st = t.untyped_storage()
            key = st._cdata
            if key in self._seen:
                continue
            self._seen[key] = st.nbytes()
            self.live += st.nbytes()
            weakref.finalize(st, self._free, key)
        self.peak = max(self.peak, self.live)
        return out

