"""SLO-aware continuous batching over the paged KV cache
(``repro.serving.scheduler``).

Many requests of different lengths run through one fixed-slot decode
step:

* an **admission queue** ordered by (priority, deadline), a heap, so
  urgent work overtakes best-effort work;
* **paged slots**: each slot's KV lives in pool blocks
  (``serving.paged_cache``), allocated as the request grows and freed the
  step it finishes;
* **chunked prefill** through the same ``decode_step`` as decode: a
  prefilling slot feeds ``prefill_chunk`` prompt tokens a step while its
  neighbours decode one token each (per-slot ``n_valid`` masks the
  padding rows);
* **preemption**: when the block pool runs dry, or a request blows its
  deadline while more urgent work waits, the victim's blocks are released
  and it goes back to the queue; on readmission it re-prefills its prompt
  and what it generated so far, so greedy decoding resumes exactly;
* **hot swap**: ``begin_hot_swap`` streams new weights one
  ``ExchangePlan`` bucket a step (``engine.HotSwapStream``) and flips
  atomically.

Everything observable goes through ``telemetry.metrics``, under the
reference's names: counters (``sched/steps``, ``sched/completed``,
``sched/preempted``, ...), gauges (``sched/queue_depth``,
``sched/free_blocks``, ...) and the ``serve/ttft`` / ``serve/tpot``
latency histograms.  The step runs on the device of the params; its
cached attention is always the plain ``decode_attention`` (no encoder
states), so the batcher takes no ``attn_impl``.
"""
from __future__ import annotations

import dataclasses
import heapq
import time
from collections import deque
from typing import List, Optional

import numpy as np
import torch

from repro_torch.core.backend import DEFAULT_BACKEND
from repro_torch.serving.engine import HotSwapStream, broadcast_plan
from repro_torch.serving.paged_cache import (PagedKVCache, gather_view,
                                             writeback)
from repro_torch.telemetry.metrics import MetricsLogger


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray              # (P,) int32
    max_new: int = 16
    eos_id: int = 2
    priority: int = 0               # lower value = more urgent
    deadline_ms: Optional[float] = None   # end-to-end budget from submit
    # filled by the scheduler:
    output: Optional[List[int]] = None
    submit_t: float = 0.0
    first_token_t: Optional[float] = None
    finish_t: Optional[float] = None
    n_preempted: int = 0


@dataclasses.dataclass(frozen=True)
class SLOConfig:
    """Serving objectives and the policies that chase them.

    ``ttft_target_ms`` / ``tpot_target_ms`` are attainment targets
    (violations are counted a finished request); ``prefill_chunk`` is the
    prompt tokens a prefilling slot takes a step (1 disables chunking);
    ``preempt_over_budget`` lets a running request that has blown
    ``deadline_ms`` be requeued while more urgent work waits."""
    ttft_target_ms: float = 1000.0
    tpot_target_ms: float = 200.0
    prefill_chunk: int = 8
    preempt_over_budget: bool = True


class ContinuousBatcher:
    """Paged, SLO-scheduled continuous batching (see the module
    docstring).

    ``cache_len`` bounds a request's context (prompt + max_new); the pool
    holds ``n_blocks`` blocks of ``block_size`` tokens, by default enough
    for every slot at ``cache_len``.  Sized below that it serves the same
    slots in less memory and preempts when the tokens in flight exceed
    the pool."""

    def __init__(self, model, params, n_slots: int, cache_len: int,
                 block_size: int = 8,
                 n_blocks: Optional[int] = None,
                 slo: Optional[SLOConfig] = None,
                 metrics: Optional[MetricsLogger] = None):
        self.model = model
        self.params = params
        self.params_version = 0
        self.n_slots = n_slots
        self.cache_len = cache_len
        self.slo = slo or SLOConfig()
        self.metrics = metrics or MetricsLogger()
        self.device = params["embedding"].device
        # chunked prefill needs the per-row causal decode mask: attention
        # caches only; recurrent families step one token at a time
        self._chunkable = model.cfg.family not in ("ssm", "hybrid")
        chunk = self.slo.prefill_chunk if self._chunkable else 1
        self._chunk = max(1, chunk)
        if n_blocks is None:
            n_blocks = n_slots * (-(-cache_len // block_size))
        # view headroom: a chunk-wide step writes chunk rows from every
        # slot's position (at most cache_len - 1) before the writeback
        # leaves out the invalid ones, so the view reaches row
        # cache_len - 1 + chunk; with chunk == 1 that is the dense width
        max_blocks = -(-(cache_len + self._chunk - 1) // block_size)
        self.paged = PagedKVCache(model, n_slots, block_size, n_blocks,
                                  max_blocks, self.device)
        # per-slot bookkeeping (host side)
        self.slot_req: List[Optional[Request]] = [None] * n_slots
        self.slot_pending: List[deque] = [deque() for _ in range(n_slots)]
        self.slot_len = np.zeros((n_slots,), np.int64)
        self._queue: List = []          # heap of (prio, deadline, seq, req)
        self._seq = 0
        self._swap: Optional[HotSwapStream] = None

    # -- public API ---------------------------------------------------------
    def submit(self, req: Request) -> None:
        if len(req.prompt) + req.max_new > self.cache_len:
            raise ValueError(
                f"request {req.uid}: prompt({len(req.prompt)}) + "
                f"max_new({req.max_new}) > cache_len({self.cache_len})")
        need = -(-(len(req.prompt) + req.max_new) // self.paged.block_size)
        if need > self.paged.n_blocks:
            raise ValueError(
                f"request {req.uid} needs {need} blocks but the pool has "
                f"only {self.paged.n_blocks}: it could never complete")
        if req.output is None:
            req.output = []
        req.submit_t = time.perf_counter()
        self._push(req)

    @property
    def queue_depth(self) -> int:
        return len(self._queue)

    @property
    def utilisation(self) -> float:
        slot = self.metrics.counter("sched/slot_steps").value
        act = self.metrics.counter("sched/active_slot_steps").value
        return act / slot if slot else 0.0

    @property
    def swap_in_flight(self) -> bool:
        return self._swap is not None

    def begin_hot_swap(self, new_params, codec: str = "identity",
                       backend: str = DEFAULT_BACKEND,
                       version: Optional[int] = None,
                       fusion_threshold: Optional[int] = None
                       ) -> HotSwapStream:
        """Start streaming new weights: one bucket lands a ``step()`` and
        the live params flip atomically after the last one."""
        if self._swap is not None:
            raise ValueError("hot swap already in flight "
                             f"(version {self._swap.version})")
        plan = broadcast_plan(new_params, codec=codec, backend=backend,
                              fusion_threshold=fusion_threshold)
        self._swap = HotSwapStream(
            plan, self.params, new_params,
            self.params_version + 1 if version is None else version)
        return self._swap

    def run(self, max_steps: int = 10_000) -> List[Request]:
        """Drive until the queue and the slots (and any swap) drain.
        Returns the completed requests."""
        done: List[Request] = []
        for _ in range(max_steps):
            if not self.step(done):
                break
        while self._swap is not None:
            self._swap_advance()
        return done

    def step(self, done: Optional[List[Request]] = None) -> bool:
        """One engine step: admit, maybe preempt, decode or prefill one
        batched chunk, advance a swap in flight by one bucket.  Returns
        False when there is nothing left to do."""
        if done is None:
            done = []
        now = time.perf_counter()
        self._maybe_preempt(now)
        self._admit(now)
        active = [s for s in range(self.n_slots)
                  if self.slot_req[s] is not None]
        if not active:
            if self._swap is not None:
                self._swap_advance()
                return True
            return False
        self._one_step(active, done)
        if self._swap is not None:
            self._swap_advance()
        self._set_gauges()
        return True

    # -- queue --------------------------------------------------------------
    def _push(self, req: Request) -> None:
        heapq.heappush(self._queue, (*self._queue_key(req), self._seq, req))
        self._seq += 1

    def _queue_key(self, req: Request):
        dl = (req.submit_t + req.deadline_ms / 1e3
              if req.deadline_ms is not None else float("inf"))
        return (req.priority, dl)

    # -- admission / preemption ---------------------------------------------
    def _admit(self, now: float) -> None:
        refill = np.zeros((self.n_slots,), bool)
        for s in range(self.n_slots):
            if self.slot_req[s] is not None or not self._queue:
                continue
            if self.paged.n_free_blocks == 0:
                break
            _, _, _, req = heapq.heappop(self._queue)
            self.slot_req[s] = req
            # re-prefill prompt + generated-so-far after a preemption
            self.slot_pending[s] = deque(
                list(req.prompt.tolist()) + list(req.output))
            self.slot_len[s] = 0
            self.paged.ensure(s, 1)
            refill[s] = True
            self.metrics.counter("sched/admitted").inc()
            self.metrics.histogram("serve/queue_wait").observe(
                now - req.submit_t)
        if refill.any():
            # copy-free refill: zero length and recurrent state of the
            # recycled slots; in-flight neighbours are untouched
            self.paged.reset(refill)

    def _maybe_preempt(self, now: float) -> None:
        """Deadline policy: a running request that has blown its budget
        loses its slot to strictly more urgent waiting work."""
        if not self.slo.preempt_over_budget or not self._queue:
            return
        head = self._queue[0][3]
        for s in range(self.n_slots):
            req = self.slot_req[s]
            if req is None or req.deadline_ms is None:
                continue
            if (now > req.submit_t + req.deadline_ms / 1e3
                    and self._queue_key(head) < self._queue_key(req)):
                self._preempt_slot(s)
                return                        # at most one a step

    def _preempt_slot(self, s: int) -> None:
        req = self.slot_req[s]
        req.n_preempted += 1
        self.paged.release(s)
        self.slot_req[s] = None
        self.slot_pending[s].clear()
        self.slot_len[s] = 0
        self._push(req)
        self.metrics.counter("sched/preempted").inc()

    def _preempt_for_blocks(self, needing: int) -> bool:
        """Pool-dry policy: evict the least urgent active request (the
        needing slot itself may be the victim)."""
        victims = [s for s in range(self.n_slots)
                   if self.slot_req[s] is not None]
        if not victims:
            return False
        worst = max(victims,
                    key=lambda s: (self._queue_key(self.slot_req[s]),
                                   -self.slot_len[s]))
        self._preempt_slot(worst)
        return worst != needing

    # -- the step -----------------------------------------------------------
    @torch.no_grad()
    def device_step(self, toks: np.ndarray, n_valid: np.ndarray
                    ) -> torch.Tensor:
        """The step on the card: gather the slots' views, ``decode_step``
        on them, write the new rows back.  ``toks`` (n_slots, chunk) and
        ``n_valid`` (n_slots,) are host arrays; returns the logits."""
        chunk = toks.shape[1]
        paged = self.paged
        view = gather_view(paged.state, paged.tables(), paged._paged)
        logits, new_view = self.model.decode_step(
            self.params, view, torch.as_tensor(toks, device=self.device),
            n_valid=torch.as_tensor(n_valid, device=self.device))
        paged.state = writeback(paged.state, new_view, paged.block_tables,
                                self.slot_len, n_valid, chunk, paged._paged,
                                paged.block_size, paged.n_blocks)
        return logits

    def _one_step(self, active: List[int], done: List[Request]) -> None:
        # interleaving policy: prefill work widens the step to
        # prefill_chunk; decoding neighbours ride along with n_valid=1
        chunk = (self._chunk
                 if any(self.slot_pending[s] for s in active) else 1)
        want = np.zeros((self.n_slots,), np.int32)
        for s in active:
            pend = len(self.slot_pending[s])
            want[s] = min(chunk, pend) if pend else 1
        # block capacity (preempting when the pool runs dry)
        for s in list(active):
            if self.slot_req[s] is None:
                continue
            while not self.paged.ensure(s, int(self.slot_len[s] + want[s])):
                if not self._preempt_for_blocks(s) \
                        or self.slot_req[s] is None:
                    break
        active = [s for s in active if self.slot_req[s] is not None]
        if not active:
            return
        toks = np.zeros((self.n_slots, chunk), np.int32)
        n_valid = np.zeros((self.n_slots,), np.int32)
        for s in active:
            req = self.slot_req[s]
            if self.slot_pending[s]:
                k = int(want[s])
                for j in range(k):
                    toks[s, j] = self.slot_pending[s].popleft()
                n_valid[s] = k
            else:
                toks[s, 0] = req.output[-1]
                n_valid[s] = 1
        t0 = time.perf_counter()
        logits = self.device_step(toks, n_valid)
        nxt = torch.argmax(logits, dim=-1).to(torch.int32).cpu().numpy()
        if nxt.ndim == 1:
            nxt = nxt[:, None]
        step_dt = time.perf_counter() - t0
        now = time.perf_counter()
        self.slot_len += n_valid.astype(np.int64)
        self.metrics.counter("sched/steps").inc()
        self.metrics.counter("sched/slot_steps").inc(self.n_slots)
        self.metrics.counter("sched/active_slot_steps").inc(len(active))
        self.metrics.counter("sched/tokens").inc(int(n_valid.sum()))
        for s in active:
            req = self.slot_req[s]
            if self.slot_pending[s]:
                continue                       # still prefilling
            tok = int(nxt[s, int(n_valid[s]) - 1])
            if req.first_token_t is None:
                req.first_token_t = now
                self.metrics.histogram("serve/ttft").observe(
                    now - req.submit_t)
            else:
                self.metrics.histogram("serve/tpot").observe(step_dt)
            req.output.append(tok)
            if tok == req.eos_id or len(req.output) >= req.max_new:
                self._finish(s, req, now, done)

    def _finish(self, s: int, req: Request, now: float,
                done: List[Request]) -> None:
        req.finish_t = now
        self.paged.release(s)                  # free-on-finish
        self.slot_req[s] = None
        self.slot_len[s] = 0
        done.append(req)
        self.metrics.counter("sched/completed").inc()
        if req.first_token_t is not None:
            ttft_ms = (req.first_token_t - req.submit_t) * 1e3
            if ttft_ms > self.slo.ttft_target_ms:
                self.metrics.counter("sched/ttft_violations").inc()
            n_dec = max(len(req.output) - 1, 0)
            if n_dec:
                tpot_ms = (req.finish_t - req.first_token_t) / n_dec * 1e3
                if tpot_ms > self.slo.tpot_target_ms:
                    self.metrics.counter("sched/tpot_violations").inc()

    # -- hot swap -----------------------------------------------------------
    @torch.no_grad()
    def _swap_advance(self) -> None:
        if self._swap.step():
            self.params = self._swap.result()
            self.params_version = self._swap.version
            self.metrics.counter("serve/hot_swaps").inc()
            self.metrics.gauge("serve/params_version").set(
                self.params_version)
            self._swap = None

    def _set_gauges(self) -> None:
        self.metrics.gauge("sched/queue_depth").set(len(self._queue))
        self.metrics.gauge("sched/free_blocks").set(
            self.paged.n_free_blocks)
        self.metrics.gauge("sched/active_slots").set(
            sum(r is not None for r in self.slot_req))
        self.metrics.gauge("sched/utilisation").set(self.utilisation)
