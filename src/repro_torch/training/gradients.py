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
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.core.indexed_slices import IndexedSlices
from repro_torch.tree import tree_flatten, tree_unflatten


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
