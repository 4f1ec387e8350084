"""Gradient computation with faithful sparse-embedding instrumentation
(``repro.training.gradients.grad_contributions``).

``sparse_embedding=False``: ordinary dense autograd; the embedding's
gradient is the scatter-add-densified tensor.

``sparse_embedding=True``: TensorFlow's behaviour.  The lookup runs
through a zero ``tap`` with the table detached, so autograd yields the
PER-TOKEN rows — ``tf.gather``'s IndexedSlices, duplicates and all.  A
tied table additionally receives the DENSE gradient of the output
projection, giving the mixed ``[IndexedSlices, dense]`` contribution list
that trips TF's Algorithm 1 (paper §3).

``wait_free_grad_exchange`` is the step of ``overlap="backward"``: each
top-level block's bucket collectives launch from a hook inside the
backward pass (``repro.training.gradients``' wait-free backprop).
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Tuple

import torch

from repro_torch.core import comm
from repro_torch.core.codecs import ExchangeState
from repro_torch.core.indexed_slices import IndexedSlices
from repro_torch.models.layers import backward_hook
from repro_torch.tree import tree_flatten, tree_map, tree_unflatten


def grad_contributions(model, params, batch: Dict[str, torch.Tensor],
                       sparse_embedding: bool = False,
                       **loss_kw) -> Tuple[Any, torch.Tensor, Dict]:
    """Returns (grad-contribution tree, loss, metrics), all detached.

    The tree matches ``params``, except that under
    ``sparse_embedding=True`` the ``embedding`` leaf is a LIST of
    contributions ([IndexedSlices] or [IndexedSlices, dense]).
    """
    leaves, treedef = tree_flatten(params)
    leaves = [p.detach().requires_grad_(True) for p in leaves]
    p = tree_unflatten(treedef, leaves)
    taps = None
    if sparse_embedding:
        tokens = batch["tokens"]
        table = p["embedding"]
        taps = torch.zeros(tokens.shape + (model.cfg.d_model,),
                           dtype=table.dtype, device=table.device,
                           requires_grad=True)
    loss, metrics = model.loss(p, batch, taps=taps, **loss_kw)
    wrt = leaves + ([taps] if taps is not None else [])
    grads = torch.autograd.grad(loss, wrt, allow_unused=True)
    g_leaves = [torch.zeros_like(x) if g is None else g
                for x, g in zip(leaves, grads)]
    g_params = tree_unflatten(treedef, g_leaves)
    metrics = {k: v.detach() for k, v in metrics.items()}
    if not sparse_embedding:
        return g_params, loss.detach(), metrics
    slices = IndexedSlices(
        indices=batch["tokens"].reshape(-1).to(torch.int32),
        values=grads[-1].reshape(-1, model.cfg.d_model),
        dense_shape=tuple(params["embedding"].shape))
    if model.cfg.tied_embeddings:
        # the table's gradient is the tied projection's dense cotangent;
        # with the sparse lookup rows it is the paper's Algorithm-1 trigger
        g_params["embedding"] = [slices, g_params["embedding"]]
    else:
        # the detached table gets no gradient: the sparse rows replace it
        g_params["embedding"] = [slices]
    return g_params, loss.detach(), metrics


def abstract_grad_contributions(model, params, batch,
                                sparse_embedding: bool = False,
                                **loss_kw):
    """One worker's gradient-contribution tree on ``meta`` tensors, with
    no forward and no backward pass: the structure ``grad_contributions``
    returns, which ``compile_plan`` and
    ``DistributedOptimizer.init_exchange_state`` are keyed on.  The one
    place the launcher, the scripts and the tests take it from, so the
    convention cannot drift between them.  ``params`` and ``batch`` may
    be concrete or ``meta``: only their shapes and dtypes are read.
    ``loss_kw`` is accepted for the reference's signature; no loss
    option changes the tree's shapes."""
    del loss_kw
    return wait_free_contribution_structs(
        model, params, batch, sparse_embedding=sparse_embedding)


# -- wait-free backprop (overlap="backward") ---------------------------------

def _as_list(x) -> list:
    return x if isinstance(x, list) else [x]


def _meta(t: torch.Tensor) -> torch.Tensor:
    return torch.empty(t.shape, dtype=t.dtype, device="meta")


def _contrib_meta(c):
    if isinstance(c, IndexedSlices):
        return IndexedSlices(_meta(c.indices), _meta(c.values),
                             tuple(c.dense_shape))
    return _meta(c)


def wait_free_contribution_structs(model, params, batch,
                                   sparse_embedding: bool = False,
                                   partial=None):
    """The contribution tree the wait-free step assembles, on ``meta``
    tensors and without a backward pass: the structure
    ``grad_contributions`` (with any deferred microbatches' ``partial``
    in front of each leaf) hands the fused exchange, so both paths
    compile the same plan and their ``ExchangeState``s are
    interchangeable."""
    g: Dict[str, Any] = {k: tree_map(_meta, v) for k, v in params.items()}
    if sparse_embedding:
        emb = params["embedding"]
        rows = math.prod(batch["tokens"].shape)
        slices = IndexedSlices(
            indices=torch.empty((rows,), dtype=torch.int32, device="meta"),
            values=torch.empty((rows, model.cfg.d_model), dtype=emb.dtype,
                               device="meta"),
            dense_shape=tuple(emb.shape))
        g["embedding"] = ([slices, _meta(emb)]
                          if model.cfg.tied_embeddings else [slices])
    if partial is not None:
        g = tree_map(lambda a, b: [_contrib_meta(c) for c in _as_list(a)]
                     + _as_list(b), partial, g)
    return g


def wait_free_grad_exchange(model, opt, params, batch, *, state=None,
                            sparse_embedding: bool = False, partial=None,
                            loss_scale=None, loss_denom: int = 1,
                            **loss_kw):
    """Gradient step with the bucket collectives launched INSIDE the
    backward pass (wait-free backprop).

    Every hooked top-level block goes through ``backward_hook``; once
    autograd has the block's whole gradient the hook folds in the block's
    ``partial`` (deferred microbatches), accumulates, packs, encodes and
    launches that block's stages, asynchronously, while earlier blocks
    are still differentiating.  Gather stages and unhooked blocks (the
    sparse embedding, whose contributions are assembled outside autograd)
    launch as a tail after autograd returns; then every stage finishes in
    schedule order.  The per-stage ops are ``execute_fused``'s, so the
    result is bitwise the fused exchange of the same contribution tree.

    ``loss_scale`` multiplies the loss before differentiation (a power of
    two commutes with every rounding, so the gradients equal post-hoc
    scaling bitwise); ``loss_denom`` divides every contribution of this
    batch (the deferred-microbatch ``g / n``); ``partial`` is the
    already-scaled contribution tree of the first n - 1 microbatches.

    Returns ``(dense grad tree, new ExchangeState, loss, metrics)``;
    loss and metrics are unscaled and from this batch only.
    Error-feedback residuals are updated in place.
    """
    structs = wait_free_contribution_structs(
        model, params, batch, sparse_embedding=sparse_embedding,
        partial=partial)
    plan = opt.plan(structs)
    group = opt.group          # a process group, a tuple of them, or None
    p = comm.axis_size(group)  # the product of the levels' sizes
    inv_scale = (1.0 / p) if opt.average and comm.groups(group) else None
    stage_states = list(plan._check_state(state, params).bucket_states)
    stages = plan.schedule.stages

    hooked_blocks = set(model.grad_blocks(params))
    if sparse_embedding:
        hooked_blocks.discard("embedding")
    block_stages, tail_ids = plan.backward_block_stages(hooked_blocks)
    # global leaf ids per block, in flatten order: a block's subtree
    # flattens to the same relative order, so ids zip with its leaves
    block_leaf_ids: Dict[str, List[int]] = {}
    for i, b in enumerate(plan.leaf_blocks):
        block_leaf_ids.setdefault(b, []).append(i)

    def _div(c):
        return c if loss_denom == 1 else c / loss_denom

    acc: List[Any] = [None] * plan.n_leaves
    inflight: Dict[int, Tuple] = {}

    def launch(sid, raw):
        st = stages[sid]
        plan._accumulate_stage(st, raw, acc)
        inflight[sid], stage_states[sid] = plan.launch_stage(
            st, acc, group, stage_states[sid])
        for i in st.leaf_ids:
            acc[i] = None

    def make_bwd(key, stage_ids):
        ids = block_leaf_ids[key]
        p_leaves = (tree_flatten(partial[key])[0] if partial is not None
                    else None)

        def bwd_fn(g_block):
            raw: List[Any] = [None] * plan.n_leaves
            for j, (lid, gl) in enumerate(zip(ids,
                                              tree_flatten(g_block)[0])):
                c = _div(gl)
                raw[lid] = [p_leaves[j], c] if p_leaves is not None else c
            for sid in stage_ids:
                launch(sid, raw)

        return bwd_fn

    leaves, treedef = tree_flatten(params)
    leaves = [x.detach().requires_grad_(True) for x in leaves]
    p_ = tree_unflatten(treedef, leaves)
    tapped = dict(p_)
    for key, sids in block_stages.items():
        tapped[key] = backward_hook(make_bwd(key, sids))(p_[key])
    taps = None
    if sparse_embedding:
        tokens = batch["tokens"]
        table = params["embedding"]
        taps = torch.zeros(tokens.shape + (model.cfg.d_model,),
                           dtype=table.dtype, device=table.device,
                           requires_grad=True)
    loss, metrics = model.loss(tapped, batch, taps=taps, **loss_kw)
    scaled = loss if loss_scale is None else loss * loss_scale
    wrt = leaves + ([taps] if taps is not None else [])
    grads = torch.autograd.grad(scaled, wrt, allow_unused=True)
    # hooked leaves come back None (their hooks exchanged them); an
    # unused unhooked leaf gets zeros, as grad_contributions gives it
    hooked_leaves = {i for key in block_stages
                     for i in block_leaf_ids[key]}
    g_params = tree_unflatten(treedef, [
        g if g is not None or i in hooked_leaves else torch.zeros_like(x)
        for i, (x, g) in enumerate(zip(leaves, grads[:len(leaves)]))])

    # -- tail: contributions assembled outside autograd ----------------------
    contrib: Dict[str, Any] = {}
    for key in params:
        if key in block_stages:
            contrib[key] = params[key]        # exchanged in the backward
            continue
        if key == "embedding" and sparse_embedding:
            slices = IndexedSlices(
                indices=batch["tokens"].reshape(-1).to(torch.int32),
                values=_div(grads[-1].reshape(-1, model.cfg.d_model)),
                dense_shape=tuple(params["embedding"].shape))
            c: Any = ([slices, _div(g_params["embedding"])]
                      if model.cfg.tied_embeddings else [slices])
        else:
            c = tree_map(_div, g_params[key])
        if partial is not None:
            c = tree_map(lambda a, b: _as_list(a) + _as_list(b),
                         partial[key], c)
        contrib[key] = c
    raw_tail = tree_flatten(contrib)[0]
    for sid in tail_ids:
        launch(sid, raw_tail)

    out: List[Any] = [None] * plan.n_leaves
    for sid, st in enumerate(stages):
        plan.finish_stage(st, inflight.pop(sid), out, inv_scale, p)
    metrics = {k: v.detach() for k, v in metrics.items()}
    metrics["exchange_stages"] = torch.tensor(plan.schedule.n_stages,
                                              dtype=torch.int32)
    return (tree_unflatten(plan.treedef, out), ExchangeState(stage_states),
            loss.detach(), metrics)
