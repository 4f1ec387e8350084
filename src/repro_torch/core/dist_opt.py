"""DistributedOptimizer — the paper's Horovod API, in PyTorch.

Wraps an ``repro_torch.optim.Optimizer``.  The exchange is driven by one
statically compiled ``ExchangePlan`` per gradient-tree structure
(``repro_torch.core.exchange``), as in ``repro.core.dist_opt``:

    opt = DistributedOptimizer(base, exchange=ExchangeConfig(
        sparse_as_dense=True, use_kernel=True), group=dist.group.WORLD)

``group=None`` is the local path (no collectives, no averaging).
"""
from __future__ import annotations

from typing import Optional

from repro_torch.core import comm, exchange
from repro_torch.core.exchange import ExchangeConfig
from repro_torch.optim.base import Optimizer


class DistributedOptimizer:
    """Wrapper around an Optimizer adding the distributed exchange."""

    def __init__(self, base: Optimizer,
                 exchange: Optional[ExchangeConfig] = None,
                 group: comm.Group = None, average: bool = True):
        self.base = base
        self.group = group
        self.average = average
        self._exchange_config = (exchange if exchange is not None
                                 else ExchangeConfig())

    def init(self, params):
        return self.base.init(params)

    def update(self, grads, state, params):
        return self.base.update(self.exchange(grads), state, params)

    @property
    def exchange_config(self) -> ExchangeConfig:
        return self._exchange_config

    def plan(self, grads) -> exchange.ExchangePlan:
        """The (cached) static schedule for this gradient tree."""
        return exchange.compile_plan(grads, self._exchange_config)

    def exchange(self, grads):
        """Accumulate, exchange across the group, densify: the dense
        gradient tree every worker applies."""
        return self.plan(grads).execute_fused(grads, self.group,
                                              average=self.average)
