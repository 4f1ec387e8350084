"""DistributedOptimizer — the paper's Horovod API, in PyTorch.

Wraps an ``repro_torch.optim.Optimizer``.  The exchange is driven by one
statically compiled ``ExchangePlan`` per gradient-tree structure
(``repro_torch.core.exchange``), as in ``repro.core.dist_opt``:

    opt = DistributedOptimizer(base, exchange=ExchangeConfig(
        sparse_as_dense=True, use_kernel=True), group=dist.group.WORLD)

``group`` is a process group, a tuple of process groups (one per level
of a hierarchical backend, outermost first:
``(cross_pod_group, within_pod_group)``) or ``None`` for the local path
(no collectives, no averaging).  Averaging divides by the product of the
levels' sizes.  The
codec's ``ExchangeState`` (error-feedback residuals for ``"int8+ef"``,
empty entries for a stateless codec) is threaded through
``exchange(grads, state) -> (tree, state)``; ``init_exchange_state``
builds the first.  ``exchange`` honours ``ExchangeConfig.overlap``;
``exchange_scheduled`` and ``exchange_fused`` take one path whatever it
says; ``broadcast`` sends a tree from one worker through the same plan.
Under ``ExchangeConfig(zero1=True)`` the exchange and the update are one
step, ``zero1_step``, over this rank's local ``Zero1State``
(``init_zero1_state``).
"""
from __future__ import annotations

from typing import Optional

from repro_torch.core import comm, exchange
from repro_torch.core.codecs import ExchangeState
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
        return self.base.update(self.exchange(grads)[0], state, params)

    @property
    def exchange_config(self) -> ExchangeConfig:
        return self._exchange_config

    def init_exchange_state(self, grads, device=None) -> ExchangeState:
        """Initial codec state for this gradient-tree structure: zero
        residuals (the empty state for stateless codecs) on ``device``,
        by default the device of the gradient leaves.  ``grads`` may hold
        ``meta`` tensors, and then ``device`` must be given: a
        ``ValueError`` says so."""
        return self.plan(grads).init_state(device=device, grads=grads)

    def plan(self, grads) -> exchange.ExchangePlan:
        """The (cached) static schedule for this gradient tree."""
        return exchange.compile_plan(grads, self._exchange_config)

    def exchange(self, grads, state: Optional[ExchangeState] = None):
        """Accumulate, exchange across the group, densify: returns
        ``(the dense gradient tree every worker applies, new
        ExchangeState)``.  Honours ``exchange_config.overlap`` (staged
        or fused).  ``state`` may be left out for a stateless codec."""
        return self.plan(grads).execute(grads, self.group,
                                        average=self.average, state=state)

    def exchange_scheduled(self, grads,
                           state: Optional[ExchangeState] = None):
        """Staged exchange whatever ``overlap`` says: every stage's
        collective launches, in reverse-layer order and interleaved with
        the per-stage accumulate and pack, before any stage unpacks."""
        return self.plan(grads).execute_scheduled(grads, self.group,
                                                  average=self.average,
                                                  state=state)

    def exchange_fused(self, grads, state: Optional[ExchangeState] = None):
        """Serial path whatever ``overlap`` says: each stage finishes
        before the next launches."""
        return self.plan(grads).execute_fused(grads, self.group,
                                              average=self.average,
                                              state=state)

    def broadcast(self, tree, root: int = 0):
        """Broadcast a dense tree from worker ``root`` over ``group``
        through the plan's buckets and codec: the serving hot swap."""
        return self.plan(tree).broadcast(tree, self.group, root=root)

    # -- ZeRO-1: sharded optimizer state (exchange fused with update) --------
    @property
    def zero1(self) -> bool:
        """True when the exchange config shards optimizer state: the step
        must then go through ``zero1_step``, not exchange + update."""
        return self._exchange_config.zero1

    def init_zero1_state(self, grads, params):
        """This rank's local Zero1State (flat EMA shards in bucket slot
        order, and the f32 master shards under a lossy ``param_codec``)
        for this gradient-tree structure, built directly for the rank
        and the worker count of ``group`` (the global view at P = 1 with
        no group), on the device of the params.  ``grads`` may hold
        ``meta`` tensors."""
        # lazy import: optim.zero1 consumes core.exchange, not the other
        # way round at import time
        from repro_torch.optim import zero1 as zero1_lib
        groups = comm.groups(self.group)
        plan = self.plan(grads)
        return zero1_lib.init_local_state(
            plan, self.base, params, rank=plan.worker_index(groups),
            n_workers=comm.axis_size(groups))

    def zero1_step(self, grads, params, z_state,
                   exchange_state: Optional[ExchangeState] = None):
        """One fused ZeRO-1 step: the bucket-scheduled grad reduce-scatter,
        the flat-shard optimizer update of this rank's 1/P slice, and the
        updated-param allgather back through the same schedule.  Returns
        ``(new_params, new_z_state, new_exchange_state)``."""
        from repro_torch.optim import zero1 as zero1_lib
        return zero1_lib.zero1_step(self.plan(grads), self.base, grads,
                                    params, z_state, self.group,
                                    average=self.average,
                                    ex_state=exchange_state)
