"""Batched serving engine: prefill + greedy decode over a KV cache, and the
streamed weight hot swap (``repro.serving.engine``).

``generate`` prefills the prompts through ``Model.prefill`` and then
decodes one token a step through ``Model.decode_step`` for the whole
batch, masking rows that have emitted EOS.  It passes no encoder states,
as the reference's engine does, so its cached self-attention always runs
the plain ``decode_attention`` and it takes no ``attn_impl``.

``broadcast_params`` is the serving-side weight hot swap: refreshed
weights on one worker fan out to the rest through the same
``ExchangePlan`` buckets, ``WireCodec`` and ``CollectiveBackend`` as the
training exchange, one broadcast a bucket, optionally on a narrowed
(bf16, int8) wire.  ``HotSwapStream`` lands one bucket a call, so a
serving loop interleaves the swap with its decode steps and flips to the
new version atomically.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.core import comm
from repro_torch.core.backend import DEFAULT_BACKEND
from repro_torch.core.exchange import ExchangeConfig, ExchangePlan, \
    compile_plan
from repro_torch.tree import tree_flatten, tree_unflatten


def sample_greedy(logits: torch.Tensor) -> torch.Tensor:
    return torch.argmax(logits, dim=-1).to(torch.int32)


def broadcast_plan(params, codec: str = "identity",
                   backend: str = DEFAULT_BACKEND,
                   fusion_threshold: Optional[int] = None) -> ExchangePlan:
    """Compile (or fetch from the plan cache) the ExchangePlan that
    broadcasts a params tree: ``sparse_as_dense``, since weights are
    dense.  An int8 wire encodes through ``ops.quantize_int8``: the
    kernel on a CUDA tensor, which multiplies by ``1 / scale`` as the
    reference's ``use_kernel=True`` path does (its default divides)."""
    return compile_plan(params, ExchangeConfig(
        sparse_as_dense=True, codec=codec, backend=backend,
        fusion_threshold=fusion_threshold))


def broadcast_params(params, plan: Optional[ExchangePlan] = None,
                     backend: Optional[str] = None,
                     codec: Optional[str] = None,
                     group: comm.Group = None, root: int = 0,
                     fusion_threshold: Optional[int] = None):
    """Weight hot swap: broadcast ``params`` from worker ``root`` of
    ``group`` through the plan's buckets, one (codec-narrowed) broadcast
    a bucket.  ``group=None`` is the local codec round trip
    (single-process serving).  A ``codec`` or ``backend`` that
    contradicts a given ``plan`` is an error: the plan fixes both."""
    if plan is None:
        plan = broadcast_plan(params, codec=codec or "identity",
                              backend=backend or DEFAULT_BACKEND,
                              fusion_threshold=fusion_threshold)
    else:
        if backend is not None and backend != plan.config.backend:
            raise ValueError(f"plan was compiled for backend="
                             f"{plan.config.backend!r}, got {backend!r}")
        if codec is not None and codec != plan.config.codec:
            raise ValueError(f"plan was compiled for codec="
                             f"{plan.config.codec!r}, got {codec!r}")
    return plan.broadcast(params, group, root=root)


class HotSwapStream:
    """Weight refresh one ``ExchangePlan`` bucket at a time.

    Double-buffered: the new weights stream through
    ``plan.broadcast_bucket`` into a staging list that starts as the live
    leaves, and each ``step()`` replaces one bucket's entries, so the
    serving loop runs a bucket between decode steps and in-flight
    requests never pause.  The live params are not written; once every
    bucket has landed, ``result()`` is the whole new tree for an atomic
    flip, so no step sees some leaves old and some new."""

    def __init__(self, plan: ExchangePlan, current_params, new_params,
                 version: int, group: comm.Group = None, root: int = 0):
        self.plan = plan
        self.version = version
        self.root = root
        self._groups = plan._check_groups(group)
        leaves, treedef = tree_flatten(new_params)
        if treedef != plan.treedef:
            raise ValueError(f"params tree changed: {treedef} != planned "
                             f"{plan.treedef}")
        self._new_leaves = leaves
        self._staged = list(tree_flatten(current_params)[0])
        self._i = 0

    @property
    def n_buckets(self) -> int:
        return len(self.plan.dense_buckets)

    @property
    def buckets_done(self) -> int:
        return self._i

    @property
    def done(self) -> bool:
        return self._i >= self.n_buckets

    def step(self) -> bool:
        """Land one bucket in the staging list; True once all have."""
        if not self.done:
            self.plan.broadcast_bucket(self._i, self._new_leaves,
                                       self._staged, self._groups,
                                       root=self.root)
            self._i += 1
        return self.done

    def result(self):
        if not self.done:
            raise ValueError(f"swap incomplete: {self._i}/"
                             f"{self.n_buckets} buckets landed")
        return tree_unflatten(self.plan.treedef, self._staged)


def _sync(t: torch.Tensor) -> None:
    """Wait for the card's work on ``t`` (a latency must cover it)."""
    if t.is_cuda:
        torch.cuda.synchronize(t.device)


@dataclasses.dataclass
class ServeEngine:
    model: object
    params: object
    cache_len: int
    window: Optional[int] = None
    ring: bool = False
    eos_id: int = 2
    metrics: object = None              # telemetry.metrics.MetricsLogger
    params_version: int = 0

    def __post_init__(self):
        self._swap: Optional[HotSwapStream] = None

    def begin_hot_swap(self, new_params, codec: str = "identity",
                       backend: str = DEFAULT_BACKEND,
                       version: Optional[int] = None,
                       fusion_threshold: Optional[int] = None
                       ) -> HotSwapStream:
        """Start a streamed weight refresh (``HotSwapStream``); drive it
        with ``hot_swap_step()`` between decode steps."""
        if self._swap is not None:
            raise ValueError("hot swap already in flight "
                             f"(version {self._swap.version})")
        plan = broadcast_plan(new_params, codec=codec, backend=backend,
                              fusion_threshold=fusion_threshold)
        self._swap = HotSwapStream(
            plan, self.params, new_params,
            self.params_version + 1 if version is None else version)
        return self._swap

    @property
    def swap_in_flight(self) -> bool:
        return self._swap is not None

    def hot_swap_step(self) -> bool:
        """Land one bucket of the swap in flight; the live params flip
        (and ``params_version`` moves) when the last lands.  True when
        no swap remains in flight."""
        if self._swap is None:
            return True
        if self._swap.step():
            self.params = self._swap.result()
            self.params_version = self._swap.version
            if self.metrics is not None:
                self.metrics.counter("serve/hot_swaps").inc()
                self.metrics.gauge("serve/params_version").set(
                    self.params_version)
            self._swap = None
            return True
        return False

    def hot_swap(self, new_params, codec: str = "identity",
                 backend: str = DEFAULT_BACKEND) -> None:
        """One-shot swap: every bucket through the plan's pack, codec and
        unpack on this process (a narrowed codec shows the precision it
        would have on the wire), then the flip."""
        self.begin_hot_swap(new_params, codec=codec, backend=backend)
        while not self.hot_swap_step():
            pass

    def latency_summary(self) -> Dict[str, Dict]:
        """p50/p99 summaries of the latency histograms recorded so far
        (empty without ``metrics``)."""
        if self.metrics is None:
            return {}
        return {name: h.summary()
                for name, h in self.metrics.histograms.items()}

    @torch.no_grad()
    def generate(self, prompts: np.ndarray, max_new: int = 32
                 ) -> np.ndarray:
        """prompts (B, P) int32 -> generated (B, n) int32, n <= max_new.

        Rows that hit EOS are FINISHED: every later position is masked to
        ``eos_id``.  Generation stops once every row has finished.  With
        ``metrics`` set, records ``serve/prefill``, ``serve/ttft``
        (prefill and the first token on the host) and
        ``serve/decode_token`` latencies, waiting for the card inside each
        interval."""
        prefill_h = decode_h = ttft_h = None
        if self.metrics is not None:
            prefill_h = self.metrics.histogram("serve/prefill")
            decode_h = self.metrics.histogram("serve/decode_token")
            ttft_h = self.metrics.histogram("serve/ttft")
        device = self.params["embedding"].device
        tokens = torch.as_tensor(np.asarray(prompts), device=device)
        b = tokens.shape[0]
        cache = self.model.init_cache(b, self.cache_len, device=device)
        t_start = t0 = time.perf_counter()
        logits, cache = self.model.prefill(
            self.params, cache, tokens, window=self.window, ring=self.ring)
        if prefill_h is not None:
            _sync(logits)
            prefill_h.observe(time.perf_counter() - t0)
        out = []
        tok = sample_greedy(logits)[:, None]
        if ttft_h is not None:
            _sync(tok)
            ttft_h.observe(time.perf_counter() - t_start)
        done = torch.zeros((b,), dtype=torch.bool, device=device)
        eos = torch.tensor(self.eos_id, dtype=torch.int32, device=device)
        for _ in range(max_new):
            out.append(tok[:, 0].cpu().numpy())
            done = done | (tok[:, 0] == self.eos_id)
            if bool(done.all()):
                break
            t0 = time.perf_counter()
            logits, cache = self.model.decode_step(
                self.params, cache, tok, window=self.window, ring=self.ring)
            # finished rows emit eos_id, not whatever the model sampled
            tok = torch.where(done[:, None], eos,
                              sample_greedy(logits)[:, None])
            if decode_h is not None:
                _sync(tok)
                decode_h.observe(time.perf_counter() - t0)
        if self.metrics is not None:
            self.metrics.counter("serve/requests").inc(b)
            self.metrics.counter("serve/tokens").inc(b * len(out))
        return np.stack(out, axis=1)
