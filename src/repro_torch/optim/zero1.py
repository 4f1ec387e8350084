"""ZeRO-1 on the ExchangePlan's buckets (``repro.optim.zero1``): the
AdamW state sharded along the bucket partition, with the updated
parameters allgathered back through the same schedule.

  1. each dense bucket's packed gradient is reduce-scattered (linear
     wire codecs) or allgathered with its scales, decode-summed and
     sliced (quantised codecs: the replicated path's numerics, error-
     feedback residuals included);
  2. each worker runs ``Optimizer.flat_update`` on its 1/P flat shard of
     (f32 master params, EMA buffers) in bucket slot order; under the
     default lossless ``param_codec`` the master shard is re-derived
     from the replicated params every step and not stored;
  3. the UPDATED param shards ride back through the schedule as a
     codec-encoded allgather (``ExchangeConfig.param_codec``); gather
     stages (sparse leaves) take the replicated update.

Every rank is its own process and holds only its own slice
(``local_state``); the reference's GLOBAL view (dense-stage entries of
P x shard elements, what ``shard_map`` splits over dim 0) is built by
``init_state`` and ``gather_state``, so parity tests and checkpoints
compare like with like.  ``shard_map``'s partitioning (the reference's
``state_specs``) has no counterpart: ``local_state`` stands in for it.
"""
from __future__ import annotations

import math
from typing import Any, NamedTuple, Optional, Tuple, Union

import torch

from repro_torch.core import comm
from repro_torch.core.codecs import ExchangeState
from repro_torch.core.exchange import DenseSpec
from repro_torch.tree import tree_flatten, tree_unflatten


class Zero1State(NamedTuple):
    """Sharded optimizer state, one entry per BucketSchedule stage.

    ``param_shards[k]`` / ``opt_slots[k]`` are flat 1-D tensors in bucket
    slot order: for dense stages this rank's ``zero1_shard_elems`` slice
    (or, in the global view, all P slices), the bucket padded to a
    multiple of P.  ``param_shards`` (the f32 master copy) is kept only
    under a lossy ``param_codec``, else ``()``; gather stages keep ``()``
    and replicated flat EMA buffers.  ``step`` is the shared int32 step
    counter."""
    step: torch.Tensor
    param_shards: Tuple[Any, ...]
    opt_slots: Tuple[Tuple[Any, ...], ...]

    @property
    def n_stages(self) -> int:
        return len(self.param_shards)


def _require_flat(base) -> None:
    if getattr(base, "flat_init", None) is None \
            or getattr(base, "flat_update", None) is None:
        raise ValueError(
            "zero1 needs an optimizer with a flat-shard path "
            "(Optimizer.flat_init / flat_update); adamw() provides one, "
            f"{base!r} does not")


def _leaf_dense_elems(spec) -> int:
    shape = spec.shape if isinstance(spec, DenseSpec) else spec.dense_shape
    return math.prod(shape)


def _param_leaves(plan, params) -> list:
    """The params tree's leaves in the plan's leaf order, checked
    against the plan's dense shapes."""
    leaves = tree_flatten(params)[0]
    if len(leaves) != plan.n_leaves:
        raise ValueError(
            f"params tree has {len(leaves)} leaves but the plan was "
            f"compiled for {plan.n_leaves} gradient leaves — zero1 "
            f"shards params along the grad-tree bucket layout, so the "
            f"trees must mirror each other")
    for leaf, spec in zip(leaves, plan.leaf_specs):
        shape = (spec.shape if isinstance(spec, DenseSpec)
                 else spec.dense_shape)
        if tuple(leaf.shape) != tuple(shape):
            raise ValueError(
                f"param leaf shape {tuple(leaf.shape)} does not match "
                f"the plan's dense shape {tuple(shape)}")
    return leaves


def _workers(n_workers: Union[int, Tuple[int, ...]]) -> int:
    return (int(n_workers) if isinstance(n_workers, int)
            else int(math.prod(n_workers)))


def _pack_bucket_params(plan, stage, leaves, p: int) -> torch.Tensor:
    """The stage's bucket packed from the params: flat f32 in bucket
    slot order, padded to ``P * shard_elems``."""
    b = plan.dense_buckets[stage.bucket_id]
    parts = [leaves[plan.dense_leaf_ids[s.leaf_idx]].reshape(-1)
             .to(torch.float32) for s in b.slots]
    buf = parts[0] if len(parts) == 1 else torch.cat(parts)
    padded = plan.zero1_shard_elems(stage, p) * p
    if padded != b.n_elems:
        buf = torch.cat([buf, buf.new_zeros(padded - b.n_elems)])
    return buf


def bucket_layout(plan, tree, n_workers: int = 1) -> list:
    """A tree shaped like the params (the params themselves, or a
    replicated AdamState's ``mu`` or ``nu``) laid out as a global
    Zero1State's entries: per dense stage its bucket packed in slot
    order, f32, padded to P x ``zero1_shard_elems``; per gather stage
    the flat leaf.  What the ZeRO-1 state is compared with."""
    leaves = tree_flatten(tree)[0]
    p = _workers(n_workers)
    return [_pack_bucket_params(plan, st, leaves, p) if st.kind == "dense"
            else leaves[st.bucket_id].reshape(-1).to(torch.float32)
            for st in plan.schedule.stages]


def _chunk(x: torch.Tensor, rank: int, n: int) -> torch.Tensor:
    """Chunk ``rank`` of ``n`` elements of a flat tensor, as a tensor of
    its own (the rest of ``x`` is not kept alive)."""
    if x.shape[0] == n:
        return x
    return x.narrow(0, rank * n, n).clone()


def _params_device(params):
    leaves = tree_flatten(params)[0]
    if not leaves:
        raise ValueError("zero1: the params tree has no leaves")
    return leaves[0].device


def _build(plan, base, params, p: int, rank: Optional[int]) -> Zero1State:
    """The state for ``p`` workers: the global view (``rank=None``) or
    rank ``rank``'s slice of it."""
    _require_flat(base)
    if not plan.config.zero1:
        raise ValueError("plan was compiled without zero1=True")
    keep_master = plan.config.param_codec != "identity"
    leaves = _param_leaves(plan, params)
    device = _params_device(params)
    shards, slots = [], []
    for st in plan.schedule.stages:
        if st.kind == "dense":
            n = plan.zero1_shard_elems(st, p)
            width = n * p if rank is None else n
            master = ()
            if keep_master:
                master = _pack_bucket_params(plan, st, leaves, p)
                if rank is not None:
                    master = _chunk(master, rank, n)
            shards.append(master)
            slots.append(tuple(base.flat_init(width, device=device)))
        else:
            shards.append(())
            slots.append(tuple(base.flat_init(
                _leaf_dense_elems(plan.leaf_specs[st.bucket_id]),
                device=device)))
    return Zero1State(step=torch.zeros((), dtype=torch.int32,
                                       device=device),
                      param_shards=tuple(shards), opt_slots=tuple(slots))


def init_state(plan, base, params, n_workers: int = 1) -> Zero1State:
    """The GLOBAL Zero1State of the reference: per dense stage, zero EMA
    buffers from ``base.flat_init`` over the padded bucket (split over
    dim 0 it is every worker's shard) and, under a lossy
    ``param_codec`` only, the packed f32 master params; per gather stage
    replicated flat EMA buffers.  On the device of the params."""
    return _build(plan, base, params, _workers(n_workers), None)


def init_local_state(plan, base, params, rank: int,
                     n_workers: int) -> Zero1State:
    """Rank ``rank``'s slice of ``init_state(..., n_workers)``, built
    directly: no rank materialises the global view."""
    return _build(plan, base, params, _workers(n_workers), rank)


def local_state(plan, state: Zero1State, rank: int,
                n_workers: int) -> Zero1State:
    """Rank ``rank``'s slice of a global Zero1State: dense-stage entries
    take the rank's dim-0 chunk; gather-stage EMA buffers and ``step``
    stay replicated."""
    p = _workers(n_workers)
    shards, slots = [], []
    for st, master, slot in zip(plan.schedule.stages, state.param_shards,
                                state.opt_slots):
        if st.kind != "dense":
            shards.append(master)
            slots.append(slot)
            continue
        n = plan.zero1_shard_elems(st, p)
        shards.append(master if isinstance(master, tuple)
                      else _chunk(master, rank, n))
        slots.append(tuple(_chunk(s, rank, n) for s in slot))
    return Zero1State(step=state.step, param_shards=tuple(shards),
                      opt_slots=tuple(slots))


def _all_gather(x: torch.Tensor, group) -> torch.Tensor:
    return comm.wait(comm.all_gather_dense(x, group))


def gather_state(plan, state: Zero1State, group) -> Zero1State:
    """The global view of every rank's local Zero1State: each dense-stage
    entry allgathered over ``group`` (rank order); the inverse of
    ``local_state``.  A collective: every rank of the group calls it.
    At a world of 1 the local view is the global one."""
    if group is None or comm.axis_size(group) == 1:
        return state
    shards, slots = [], []
    for st, master, slot in zip(plan.schedule.stages, state.param_shards,
                                state.opt_slots):
        if st.kind != "dense":
            shards.append(master)
            slots.append(slot)
            continue
        shards.append(master if isinstance(master, tuple)
                      else _all_gather(master, group))
        slots.append(tuple(_all_gather(s, group) for s in slot))
    return Zero1State(step=state.step, param_shards=tuple(shards),
                      opt_slots=tuple(slots))


def check_state(plan, state: Zero1State, p: int) -> None:
    """Check a Zero1State against the plan and the worker count it will
    run on: a state sharded for another worker count fails HERE with
    the re-partitioning explanation.  Takes the local and the global
    view."""
    if not isinstance(state, Zero1State):
        raise TypeError(f"opt_state must be a Zero1State, got "
                        f"{type(state).__name__}")
    if state.n_stages != plan.schedule.n_stages:
        raise ValueError(
            f"Zero1State has {state.n_stages} stage entries but the "
            f"plan schedules {plan.schedule.n_stages} — state from a "
            f"different plan?")
    for k, st in enumerate(plan.schedule.stages):
        if st.kind != "dense":
            continue
        expect = plan.zero1_shard_elems(st, p)
        arr = state.param_shards[k]
        if isinstance(arr, tuple):           # identity param codec:
            if not state.opt_slots[k]:       # no master copy kept
                continue
            arr = state.opt_slots[k][0]
        got = arr.shape[0]
        if got not in (expect, expect * p):      # local | global view
            raise ValueError(
                f"Zero1State stage {k} holds a {got}-element param "
                f"shard but the plan expects {expect} per worker on "
                f"{p} workers — ZeRO-1 shards are partitioned by mesh "
                f"size, so a checkpoint can only resume on the mesh it "
                f"was saved from (or re-initialise the optimizer state)")


def zero1_step(plan, base, grads, params, z_state: Zero1State,
               group: comm.Group, average: bool = True,
               ex_state: Optional[ExchangeState] = None):
    """One fused ZeRO-1 step over ``group`` (one process group, or None
    for the local path): the gradient collectives through the
    BucketSchedule, the flat-shard optimizer update on this rank's
    slice, the updated-param allgather.  ``z_state`` is this rank's
    local Zero1State.  Returns ``(new_params, new_z_state, new
    ExchangeState)``; ``ex_state`` may be left out for a stateless
    codec.

    Every stage's gradient collectives launch before any is finished or
    any optimizer math runs (the "staged" order); each param allgather
    follows its stage's update.  For linear codecs and the default
    ``param_codec="identity"`` the new params are bitwise those of the
    replicated exchange + update + ``apply_updates``."""
    _require_flat(base)
    ex_state, raw, p, inv_scale = plan._exchange_setup(grads, group,
                                                       average, ex_state)
    check_state(plan, z_state, p)
    groups = plan._check_groups(group)
    leaves_p = _param_leaves(plan, params)
    stages = plan.schedule.stages

    # the grad half: every stage's collectives issued before any finish
    acc: list = [None] * plan.n_leaves
    inflight: dict = {}
    new_states = []
    for k, (st, bs) in enumerate(zip(stages, ex_state.bucket_states)):
        plan._accumulate_stage(st, raw, acc)
        if st.kind == "dense":
            inflight[k], bs = plan.zero1_launch_grad(st, acc, group, bs)
        else:
            inflight[k] = plan._launch_gather(st, acc, groups)
        new_states.append(bs)
    del acc, raw
    shard_grads: dict = {}
    gather_grads: list = [None] * plan.n_leaves
    for k, st in enumerate(stages):
        if st.kind == "dense":
            shard_grads[k] = plan.zero1_finish_grad(st, inflight.pop(k),
                                                    group, inv_scale)
        else:
            plan._finish_gather(st, inflight.pop(k), gather_grads,
                                inv_scale, p)

    # the optimizer half: the flat update of this rank's shards, then
    # the updated params ride back through the schedule
    step = z_state.step + 1
    rank = plan.worker_index(groups)
    out = list(leaves_p)
    new_shards, new_slots = [], []
    for k, st in enumerate(stages):
        if st.kind == "dense":
            master = z_state.param_shards[k]
            keep_master = not isinstance(master, tuple)
            if not keep_master:
                # identity param wire: the replicated params ARE an exact
                # f32 copy of the master, so slice the local shard out
                # of the packed bucket instead of storing it
                master = _chunk(_pack_bucket_params(plan, st, leaves_p, p),
                                rank, plan.zero1_shard_elems(st, p))
            new_p, slot = base.flat_update(shard_grads.pop(k),
                                           z_state.opt_slots[k], master,
                                           step)
            plan.zero1_allgather_params(st, new_p, out, group)
            new_shards.append(new_p if keep_master else ())
            new_slots.append(tuple(slot))
        else:
            # gather leaves take the replicated update: the same flat
            # math on the whole (flattened) leaf, on every worker
            i = st.bucket_id
            leaf = leaves_p[i]
            new_flat, slot = base.flat_update(
                gather_grads[i].reshape(-1), z_state.opt_slots[k],
                leaf.reshape(-1).to(torch.float32), step)
            gather_grads[i] = None
            out[i] = new_flat.reshape(leaf.shape).to(leaf.dtype)
            new_shards.append(())
            new_slots.append(tuple(slot))
    new_z = Zero1State(step=step, param_shards=tuple(new_shards),
                       opt_slots=tuple(new_slots))
    return tree_unflatten(plan.treedef, out), new_z, \
        ExchangeState(new_states)


# ---------------------------------------------------------------------------
# Memory accounting
# ---------------------------------------------------------------------------

def optimizer_state_bytes(plan, n_workers: Union[int, Tuple[int, ...]],
                          state_dtype: str = "float32",
                          zero1: Optional[bool] = None,
                          ema_buffers: int = 2) -> int:
    """Per-worker optimizer-state bytes under a plan's bucket layout.

    Replicated AdamW holds ``ema_buffers`` leaf-shaped EMA tensors (at
    ``state_dtype``) for every param on every worker.  ZeRO-1 holds the
    1/P flat shard of the EMA buffers per dense bucket (padding
    included), plus the 1/P f32 master shard when a lossy
    ``param_codec`` forces one to be stored, plus replicated EMA for
    gather leaves.  ``zero1=None`` follows the plan's config; ``True``
    or ``False`` prices the other strategy on the same layout.  The
    int32 step counter adds 4 bytes."""
    sd = comm.dtype_bytes(state_dtype)
    if zero1 is None:
        zero1 = plan.config.zero1
    if not zero1:
        total = sum(_leaf_dense_elems(s) for s in plan.leaf_specs)
        return total * ema_buffers * sd + 4          # + step counter
    p = _workers(n_workers)
    master = 4 if plan.config.param_codec != "identity" else 0
    total = 4                                        # step counter
    for st in plan.schedule.stages:
        if st.kind == "dense":
            shard = plan.zero1_shard_elems(st, p)
            total += shard * (master + ema_buffers * sd)
        else:
            total += (_leaf_dense_elems(plan.leaf_specs[st.bucket_id])
                      * ema_buffers * sd)
    return total
