"""Train step factory: loss -> contributions -> exchange -> update
(``repro.training.train_step.make_train_step``, fused-exchange branch)."""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.core.dist_opt import DistributedOptimizer
from repro_torch.optim.base import apply_updates
from repro_torch.training.gradients import grad_contributions


def make_train_step(model, opt: DistributedOptimizer,
                    sparse_embedding: bool = False,
                    **loss_kw) -> Callable:
    """Returns ``step(params, opt_state, ex_state, batch) -> (params,
    opt_state, ex_state, metrics)``: gradient contributions, the planned
    exchange (every bucket accumulated, reduced and unpacked in schedule
    order, the codec's ``ExchangeState`` threaded through), then the
    optimizer update on the exchanged dense tree."""

    def step(params, opt_state, ex_state, batch):
        grads, loss, metrics = grad_contributions(
            model, params, batch, sparse_embedding=sparse_embedding,
            **loss_kw)
        dense, ex_state = opt.exchange(grads, state=ex_state)
        n_stages = opt.plan(grads).schedule.n_stages
        metrics = dict(metrics, loss=loss,
                       exchange_stages=torch.tensor(n_stages,
                                                    dtype=torch.int32))
        updates, opt_state = opt.base.update(dense, opt_state, params)
        return apply_updates(params, updates), opt_state, ex_state, metrics

    return step
