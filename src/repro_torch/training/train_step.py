"""Train step factory: loss -> contributions -> exchange -> update
(``repro.training.train_step.make_train_step``).

The exchange is split out of the optimizer update, so the step follows
``ExchangeConfig.overlap``: fused (each bucket finishes before the next
launches), ``"staged"`` (every bucket's collective launches before any
unpacks) or ``"backward"`` (wait-free: each block's buckets launch from
inside the backward pass).  ``metrics["exchange_stages"]`` reports how
many stages the schedule ran.  Under ``ExchangeConfig(zero1=True)``
``opt_state`` is this rank's ``Zero1State`` (``opt.init_zero1_state``)
and the step runs the fused ZeRO-1 schedule (``opt.zero1_step``)
instead of exchange-then-update.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.core.dist_opt import DistributedOptimizer
from repro_torch.optim.base import apply_updates
from repro_torch.training.gradients import (grad_contributions,
                                            wait_free_grad_exchange)


def make_train_step(model, opt: DistributedOptimizer,
                    sparse_embedding: bool = False,
                    **loss_kw) -> Callable:
    """Returns ``step(params, opt_state, ex_state, batch) -> (params,
    opt_state, ex_state, metrics)``: gradient contributions, the planned
    exchange (the codec's ``ExchangeState`` threaded through), then the
    optimizer update on the exchanged dense tree."""
    cfg = opt.exchange_config
    wait_free = cfg.overlap_backward
    do_exchange = opt.exchange_scheduled if cfg.overlap else opt.exchange

    def step(params, opt_state, ex_state, batch):
        if cfg.zero1:
            # the exchange IS the update: grad reduce-scatter, the flat
            # shard update of this rank's slice, the param allgather
            grads, loss, metrics = grad_contributions(
                model, params, batch, sparse_embedding=sparse_embedding,
                **loss_kw)
            params, opt_state, ex_state = opt.zero1_step(
                grads, params, opt_state, exchange_state=ex_state)
            n_stages = opt.plan(grads).schedule.n_stages
            metrics = dict(metrics, loss=loss,
                           exchange_stages=torch.tensor(n_stages,
                                                        dtype=torch.int32))
            return params, opt_state, ex_state, metrics
        if wait_free:
            dense, ex_state, loss, metrics = wait_free_grad_exchange(
                model, opt, params, batch, state=ex_state,
                sparse_embedding=sparse_embedding, **loss_kw)
            metrics = dict(metrics, loss=loss)
        else:
            grads, loss, metrics = grad_contributions(
                model, params, batch, sparse_embedding=sparse_embedding,
                **loss_kw)
            dense, ex_state = do_exchange(grads, state=ex_state)
            n_stages = opt.plan(grads).schedule.n_stages
            metrics = dict(metrics, loss=loss,
                           exchange_stages=torch.tensor(n_stages,
                                                        dtype=torch.int32))
        updates, opt_state = opt.base.update(dense, opt_state, params)
        return apply_updates(params, updates), opt_state, ex_state, metrics

    return step
