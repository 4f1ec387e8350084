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
(``init_zero1_state``).  ``exchange_stats`` gives the static per-step
accounting (``ExchangeStats``) with the cost model's prediction.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Union

from repro_torch.core import comm, exchange
from repro_torch.core.codecs import ExchangeState
from repro_torch.core.exchange import ExchangeConfig
from repro_torch.optim.base import Optimizer


@dataclasses.dataclass(frozen=True)
class ExchangeStats:
    """Static per-step accounting (``repro.core.dist_opt.ExchangeStats``).

    Derived entirely from the ExchangePlan: the same numbers the runtime
    collectives move.  ``strategy`` names the accumulation rule and the
    active codec/backend; the schedule fields mirror the plan's
    ``BucketSchedule``, so the launcher's printout says what will run per
    stage.
    """
    accumulated_bytes: int       # size of accumulated representation
    wire_bytes: int              # bytes moved by the collective (per worker)
    n_collectives: int
    strategy: str
    n_stages: int = 1            # BucketSchedule stages (1 bucket each)
    overlap: Union[bool, str] = False    # False | "staged" | "backward"
    schedule_table: str = ""     # plan.describe_schedule(n_workers)
    state_bytes: int = 0         # per-worker codec-state memory (residuals)
    state_bytes_per_bucket: tuple = ()   # same, stage by stage
    hop_wire_bytes: tuple = ()   # per-mesh-level wire (hierarchical runs)
    predicted_comm_us: float = 0.0   # cost-model estimate (tuning.cost)
    cost_profile: str = ""       # BandwidthProfile the estimate used
    param_bytes: int = 0         # per-worker model params (replicated)
    grad_bytes: int = 0          # per-worker gradient tree
    opt_state_bytes: int = 0     # per-worker optimizer state (EMA + step;
    #                              1/P flat shards + f32 master under zero1)
    zero1: bool = False          # optimizer state sharded over the mesh?

    def describe(self) -> str:
        """One-look summary of what the exchange will actually run:
        strategy, totals, codec-state memory, and the per-stage
        BucketSchedule (with per-hop wire on hierarchical runs)."""
        ov = self.overlap
        mode = ("off" if not ov
                else "on" if ov in (True, "staged") else str(ov))
        head = (f"exchange: strategy={self.strategy} "
                f"collectives={self.n_collectives} "
                f"wire_bytes/worker={self.wire_bytes} "
                f"accumulated_bytes={self.accumulated_bytes} "
                f"stages={self.n_stages} "
                f"overlap={mode}")
        if self.cost_profile:
            head += (f" predicted_comm_us={self.predicted_comm_us:.1f} "
                     f"(profile={self.cost_profile})")
        if self.param_bytes or self.opt_state_bytes:
            opt_tag = "zero1-sharded" if self.zero1 else "replicated"
            head += (f"\nmemory/worker: params={self.param_bytes} B "
                     f"grads={self.grad_bytes} B "
                     f"opt_state={self.opt_state_bytes} B ({opt_tag}) "
                     f"codec_state={self.state_bytes} B")
        if self.state_bytes:
            per = ",".join(str(b) for b in self.state_bytes_per_bucket)
            head += (f"\ncodec state: {self.state_bytes} B/worker "
                     f"residual memory (per bucket: [{per}])")
        if len(self.hop_wire_bytes) > 1:
            hops = ", ".join(f"L{k}={b}"
                             for k, b in enumerate(self.hop_wire_bytes))
            head += f"\nper-hop wire B/worker (outermost first): {hops}"
        if self.schedule_table:
            return head + "\n" + self.schedule_table
        return head


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

    # -- static accounting (no devices needed) -------------------------------
    def exchange_stats(self, grads, n_workers: Union[int, tuple],
                       profile: Optional[str] = "ib") -> ExchangeStats:
        """Static per-step accounting plus the cost model's
        ``predicted_comm_us`` under ``profile`` (a BandwidthProfile preset
        name, JSON path, or instance; ``None`` skips the prediction).
        ``grads`` may hold ``meta`` tensors.  The strategy names a backend
        other than the default ``flat`` (the reference's ``jax``), so the
        two packages' strings are equal for every config."""
        plan = self.plan(grads)
        predicted_us, profile_name = 0.0, ""
        if profile is not None:
            # lazy import: tuning consumes core, not the other way round
            from repro_torch.tuning import cost as tuning_cost
            from repro_torch.tuning.profile import get_profile
            prof = get_profile(profile)
            predicted_us = tuning_cost.predict_comm_us(plan, n_workers,
                                                       prof)
            profile_name = prof.name
        cfg = plan.config
        strategy = ("dense_reduce" if cfg.sparse_as_dense
                    else f"{cfg.algorithm}")
        if cfg.reduce_scatter:
            strategy += "+reduce_scatter"
        if cfg.zero1:
            strategy += "+zero1"
            if cfg.param_codec != "identity":
                strategy += f"+param_codec:{cfg.param_codec}"
        if cfg.codec != "identity":
            strategy += f"+codec:{cfg.codec}"
        if cfg.backend != "flat":
            strategy += f"+backend:{cfg.backend}"
        if cfg.overlap:
            strategy += ("+overlap" if cfg.overlap == "staged"
                         else f"+overlap:{cfg.overlap}")
        from repro_torch.optim import zero1 as zero1_lib   # lazy (see above)
        opt_state_bytes = zero1_lib.optimizer_state_bytes(
            plan, n_workers,
            state_dtype=getattr(self.base, "state_dtype", "float32"))
        return ExchangeStats(
            accumulated_bytes=plan.buffer_bytes(n_workers),
            wire_bytes=plan.wire_bytes(n_workers),
            n_collectives=plan.n_collectives,
            strategy=strategy,
            n_stages=plan.schedule.n_stages,
            overlap=cfg.overlap,
            schedule_table=plan.describe_schedule(n_workers),
            state_bytes=plan.state_bytes(),
            state_bytes_per_bucket=plan.state_bytes_per_stage(),
            hop_wire_bytes=plan.hop_wire_bytes(n_workers),
            predicted_comm_us=predicted_us,
            cost_profile=profile_name,
            param_bytes=plan.param_bytes(),
            grad_bytes=plan.param_bytes(),
            opt_state_bytes=opt_state_bytes,
            zero1=cfg.zero1)
