"""Microbatch gradient accumulation and dynamic loss scaling
(``repro.training.microbatch``).

When memory, not the worker count, limits the batch, the same global
batch comes from ACCUMULATING microbatch gradients locally before the
single cross-worker exchange.  ``accumulate_microbatches`` runs the loss
over a (M, ...) stacked batch one microbatch at a time, summing local
gradients in the reference's order (g0, then + g1, ...); the
DistributedOptimizer then exchanges once.

``LossScaler`` is dynamic loss scaling for bf16/f16 training (Ott et al.
2018, the paper's ref [12]): scale up every ``growth_interval`` good
steps, halve and SKIP the step on non-finite gradients.  Every decision
stays on the device (``torch.where``), so a step never waits for the
host.

The reference multiplies gradients by a strongly typed f32 scale, so JAX
promotes bf16 contributions to f32; ``_scale_grad_tree`` promotes the
same way (a bf16 tensor times a 0-dim f32 tensor stays bf16 in PyTorch),
so the loss-scaled exchange moves the reference's wire dtypes.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, NamedTuple, Tuple

import torch

from repro_torch.core.indexed_slices import IndexedSlices
from repro_torch.optim.base import apply_updates
from repro_torch.training.gradients import (grad_contributions,
                                            wait_free_grad_exchange)
from repro_torch.tree import tree_flatten, tree_map


def split_microbatches(batch: Dict[str, torch.Tensor], n: int
                       ) -> Dict[str, torch.Tensor]:
    """(B, ...) -> (n, B/n, ...) per leaf."""
    def split(x):
        b = x.shape[0]
        assert b % n == 0, (b, n)
        return x.reshape((n, b // n) + tuple(x.shape[1:]))
    return tree_map(split, batch)


def _microbatch(stacked, i: int):
    return tree_map(lambda x: x[i], stacked)


def _combine(denom: int):
    """Per-leaf combiner: dense leaves summed, IndexedSlices
    concatenated, everything divided by ``denom``."""
    def combine(*leaves):
        if isinstance(leaves[0], list):          # contribution lists
            out = []
            for contribs in zip(*leaves):
                if isinstance(contribs[0], IndexedSlices):
                    idx = torch.cat([c.indices for c in contribs])
                    vals = torch.cat([c.values for c in contribs]) / denom
                    out.append(IndexedSlices(idx, vals,
                                             contribs[0].dense_shape))
                else:
                    out.append(sum(contribs) / denom)
            return out
        return sum(leaves) / denom
    return combine


def _scale_contribs(grads, denom: int):
    """Divide every contribution (dense, IndexedSlices or list) by
    ``denom`` without merging anything."""
    return tree_map(lambda leaf: _scale_contrib(leaf, denom), grads)


def _scale_contrib(leaf, denom: int):
    if isinstance(leaf, list):
        return [_scale_contrib(c, denom) for c in leaf]
    if isinstance(leaf, IndexedSlices):
        return IndexedSlices(leaf.indices, leaf.values / denom,
                             leaf.dense_shape)
    return leaf / denom


def _as_contrib_list(leaf) -> list:
    return list(leaf) if isinstance(leaf, list) else [leaf]


def _sum_tree(acc, g):
    return tree_map(lambda a, b: a + b, acc, g)


def accumulate_microbatches(model, params, stacked_batch,
                            sparse_embedding: bool = False,
                            defer_final: bool = False,
                            **loss_kw) -> Tuple[Any, torch.Tensor, Dict]:
    """Mean of the per-microbatch gradients, one microbatch at a time.
    Sparse embedding contributions accumulate by CONCATENATION (each
    microbatch contributes its own token rows), so the paper's
    gather-vs-reduce choice applies to microbatching too.

    With ``defer_final=True`` the final microbatch is not folded into the
    sum: every leaf comes back as the contribution list
    ``[partial_over_first_n-1, final]`` (each entry divided by n), so a
    staged exchange (``ExchangeConfig(overlap="staged")``) does the last
    accumulation per stage, between earlier stages' launches."""
    n = tree_flatten(stacked_batch)[0][0].shape[0]

    def one(i):
        return grad_contributions(model, params,
                                  _microbatch(stacked_batch, i),
                                  sparse_embedding=sparse_embedding,
                                  **loss_kw)

    if not sparse_embedding:
        acc, loss_sum, metrics0 = one(0)
        last = n - 1 if defer_final and n > 1 else n
        for i in range(1, last):
            g, loss, _ = one(i)
            acc = _sum_tree(acc, g)
            loss_sum = loss_sum + loss
        if last < n:
            g_last, loss_last, _ = one(n - 1)
            grads = tree_map(lambda a, b: [a / n, b / n], acc, g_last)
            return grads, (loss_sum + loss_last) / n, metrics0
        return tree_map(lambda g: g / n, acc), loss_sum / n, metrics0

    grads_list, losses = [], []
    for i in range(n):
        g, loss, _ = one(i)
        grads_list.append(g)
        losses.append(loss)
    if defer_final and n > 1:
        partial = (grads_list[0] if n == 2 else
                   tree_map(_combine(1), *grads_list[:-1]))
        partial = _scale_contribs(partial, n)
        final = _scale_contribs(grads_list[-1], n)
        grads = tree_map(lambda a, b: _as_contrib_list(a)
                         + _as_contrib_list(b), partial, final)
        return grads, sum(losses) / n, {}
    return tree_map(_combine(n), *grads_list), sum(losses) / n, {}


def accumulate_partial_microbatches(model, params, stacked_batch,
                                    sparse_embedding: bool = False,
                                    **loss_kw):
    """The first n - 1 microbatches folded into the deferred ``partial``
    contribution, op for op ``accumulate_microbatches(defer_final=True)``'s
    partial entry.  Returns ``(partial, final_microbatch,
    partial_loss_sum, n)``; the wait-free step differentiates only the
    final microbatch and folds ``partial`` in per block inside the
    backward pass.  ``partial`` is ``None`` for a single microbatch."""
    first = tree_flatten(stacked_batch)[0][0]
    n = first.shape[0]
    mb_last = _microbatch(stacked_batch, n - 1)
    if n == 1:
        return None, mb_last, torch.zeros((), dtype=torch.float32,
                                          device=first.device), n

    def one(i):
        return grad_contributions(model, params,
                                  _microbatch(stacked_batch, i),
                                  sparse_embedding=sparse_embedding,
                                  **loss_kw)

    if not sparse_embedding:
        acc, loss_sum, _ = one(0)
        for i in range(1, n - 1):
            g, loss, _ = one(i)
            acc = _sum_tree(acc, g)
            loss_sum = loss_sum + loss
        return tree_map(lambda a: a / n, acc), mb_last, loss_sum, n

    grads_list, losses = [], []
    for i in range(n - 1):
        g, loss, _ = one(i)
        grads_list.append(g)
        losses.append(loss)
    partial = (grads_list[0] if n == 2 else
               tree_map(_combine(1), *grads_list))
    return _scale_contribs(partial, n), mb_last, sum(losses), n


def _times_scale(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """``x * scale`` in JAX's promotion: a bf16 tensor times an f32
    scale is an f32 product."""
    return x.to(torch.promote_types(x.dtype, scale.dtype)) * scale


def _scale_grad_tree(grads, scale: torch.Tensor):
    """Multiply every contribution (dense, list, IndexedSlices) by the
    loss scale: the post-hoc gradient scaling of the fused path."""
    def one(c):
        if isinstance(c, IndexedSlices):
            return IndexedSlices(c.indices, _times_scale(c.values, scale),
                                 c.dense_shape)
        return _times_scale(c, scale)
    return tree_map(lambda g: [one(c) for c in g] if isinstance(g, list)
                    else one(g), grads)


class ScalerState(NamedTuple):
    scale: torch.Tensor           # current loss scale, f32 0-dim
    good_steps: torch.Tensor      # consecutive finite-grad steps, int32


@dataclasses.dataclass(frozen=True)
class LossScaler:
    init_scale: float = 2.0 ** 15
    growth_factor: float = 2.0
    backoff_factor: float = 0.5
    growth_interval: int = 200

    def init(self, device="cuda") -> ScalerState:
        """The first state, on ``device``: the card unless the caller
        asks for the CPU."""
        return ScalerState(
            scale=torch.tensor(self.init_scale, dtype=torch.float32,
                               device=device),
            good_steps=torch.zeros((), dtype=torch.int32, device=device))

    def scale_loss(self, loss: torch.Tensor,
                   state: ScalerState) -> torch.Tensor:
        return loss * state.scale

    def unscale_and_check(self, grads, state: ScalerState):
        """Returns (unscaled grads, finite flag, new state), all on the
        device.  On overflow the caller must SKIP the update (see
        ``make_scaled_train_step``)."""
        scale = state.scale
        finite = torch.ones((), dtype=torch.bool, device=scale.device)
        for g in tree_flatten(grads)[0]:
            finite = finite & torch.isfinite(g).all()
        grads = tree_map(lambda g: (g.to(torch.promote_types(
            g.dtype, scale.dtype)) / scale).to(g.dtype), grads)
        grow = state.good_steps + 1 >= self.growth_interval
        new_scale = torch.where(
            finite, torch.where(grow, scale * self.growth_factor, scale),
            torch.clamp(scale * self.backoff_factor, min=1.0))
        zero = torch.zeros_like(state.good_steps)
        new_good = torch.where(
            finite, torch.where(grow, zero, state.good_steps + 1), zero)
        return grads, finite, ScalerState(new_scale, new_good)


def _where_tree(finite: torch.Tensor, new, old):
    """``where(finite, new, old)`` leaf by leaf over dicts and (named)
    tuples of tensors."""
    if isinstance(new, dict):
        return {k: _where_tree(finite, new[k], old[k]) for k in new}
    if isinstance(new, tuple):
        vals = [_where_tree(finite, a, b) for a, b in zip(new, old)]
        return type(new)(*vals) if hasattr(new, "_fields") \
            else type(new)(vals)
    return torch.where(finite, new, old)


def _residuals(ex_state):
    return [s for s in ex_state.bucket_states if isinstance(s, torch.Tensor)]


def make_scaled_train_step(model, opt, scaler: LossScaler,
                           n_microbatches: int = 1,
                           sparse_embedding: bool = False,
                           **loss_kw) -> Callable:
    """Train step with loss scaling and optional microbatch accumulation:
    ``step(params, opt_state, scaler_state, ex_state, batch) -> (params,
    opt_state, scaler_state, ex_state, metrics)``.  Overflowed steps
    leave params and optimizer state untouched and the scale backs off.

    Under ``overlap="staged"`` the final microbatch's gradient goes to the
    exchange unsummed (``defer_final``): the staged schedule folds it in
    per bucket.  Under ``overlap="backward"`` only the final microbatch is
    differentiated, with its block collectives launched mid-backward
    (``wait_free_grad_exchange``).

    Error-feedback residuals (updated in place by the exchange) are
    copied before it, restored on an overflowed step (a non-finite
    encode banks NaN residuals that would poison every later wire), and,
    since they live in loss-scaled units, multiplied by ``new / old``
    whenever the scale moves.  ``step.stateful_exchange`` says whether the
    codec carries such state."""
    cfg = opt.exchange_config
    wait_free = cfg.overlap_backward
    defer_final = bool(cfg.overlap) and not wait_free and n_microbatches > 1
    stateful = cfg.codec_obj.stateful

    def step(params, opt_state, scaler_state, ex_state, batch):
        old_scale = scaler_state.scale
        saved = [r.clone() for r in _residuals(ex_state)] if stateful \
            else []
        if wait_free:
            if n_microbatches > 1:
                stacked = split_microbatches(batch, n_microbatches)
                partial, mb_last, loss_sum, _ = \
                    accumulate_partial_microbatches(
                        model, params, stacked,
                        sparse_embedding=sparse_embedding, **loss_kw)
                partial = _scale_grad_tree(partial, old_scale)
            else:
                partial, mb_last, loss_sum = None, batch, None
            dense, ex_state, loss_last, metrics = wait_free_grad_exchange(
                model, opt, params, mb_last, state=ex_state,
                sparse_embedding=sparse_embedding, partial=partial,
                loss_scale=old_scale, loss_denom=n_microbatches, **loss_kw)
            loss = (loss_last if loss_sum is None
                    else (loss_sum + loss_last) / n_microbatches)
        else:
            if n_microbatches > 1:
                grads, loss, metrics = accumulate_microbatches(
                    model, params,
                    split_microbatches(batch, n_microbatches),
                    sparse_embedding=sparse_embedding,
                    defer_final=defer_final, **loss_kw)
            else:
                grads, loss, metrics = grad_contributions(
                    model, params, batch,
                    sparse_embedding=sparse_embedding, **loss_kw)
            grads = _scale_grad_tree(grads, old_scale)
            dense, ex_state = opt.exchange(grads, state=ex_state)
        dense, finite, scaler_state = scaler.unscale_and_check(
            dense, scaler_state)
        updates, new_opt_state = opt.base.update(dense, opt_state, params)
        params = _where_tree(finite, apply_updates(params, updates), params)
        opt_state = _where_tree(finite, new_opt_state, opt_state)
        if stateful:
            new_scale = scaler_state.scale
            rescale = torch.where(new_scale == old_scale,
                                  torch.ones_like(new_scale),
                                  new_scale / old_scale)
            for r, old in zip(_residuals(ex_state), saved):
                torch.where(finite, r, old, out=r)
                r.mul_(rescale)
        metrics = dict(metrics, loss=loss, loss_scale=scaler_state.scale,
                       overflow=~finite)
        return params, opt_state, scaler_state, ex_state, metrics

    step.stateful_exchange = stateful
    return step
