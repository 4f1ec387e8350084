"""CollectiveBackend — how a packed bucket crosses the workers.

The torch counterpart of ``repro.core.backend``.  The ExchangePlan
decides *what* moves (buckets, codecs, collective kinds); a backend
decides *how*: which collectives of ``repro_torch.core.comm`` each
bucket collective issues, and what they cost on the wire.  Backends take
``groups``, a tuple of process groups, outermost level first (the
reference's tuple of mesh axes), and implement four collectives over
packed 1-D buckets (``all_reduce``, ``reduce_scatter``, ``all_gather``,
and ``broadcast`` as mask and sum) plus the static wire and launch
accounting.  All reductions return sums (averaging stays with the
caller); every collective returns a ``comm.Pending`` or a finished
tensor, which ``comm.wait`` turns into the result.

Shipped backends:

  * ``flat``          — one allreduce / reduce-scatter / allgather over
                        one process group (the reference's ``"jax"``);
  * ``hierarchical``  — one allreduce per level, innermost first (the
                        two-level allreduce over ``(cross_pod,
                        within_pod)``); quantised wires are reduced hop by
                        hop with a requantize between levels (the plan's
                        ``_hop_reduce_dense``);
  * ``ringsim``       — the literal ring over send/recv on one group: a
                        bucket allreduce is 2(P-1) chunk hops
                        (``comm.ring_shift``), in the reference's chunk
                        order, so every worker sums in the reference's
                        order.

Wire billing for telemetry sits in the comm functions every backend
collective reaches (``comm.reduce_scatter_dense`` for the flat
reduce-scatter, ``comm.ring_*`` for the ring, the allreduce for the
mask-and-sum broadcast), with the reference's formulas and kinds.

The ``hlo_ops_*`` counts keep the reference's names, where they count
the collective ops of the lowered HLO.  Here they count the collective
calls the comm layer issues (``comm.calls()``: allreduces, allgathers,
reduce-scatters and ring hops), and the tests hold them to those
counters.

Registry: ``register_backend`` / ``get_backend`` / ``available_backends``.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.core import comm
from repro_torch.core.codecs import WireCodec, padded_elems

#: collective kinds a bucket can be scheduled onto
ALLREDUCE = "allreduce"
REDUCE_SCATTER = "reduce_scatter"       # reduce-scatter + tiled allgather
ALLGATHER = "allgather"                 # sparse gather buckets only


def _prod(levels: Sequence[int]) -> int:
    return int(math.prod(levels))


class CollectiveBackend:
    """Protocol for collective implementations.  Subclass + register."""

    name: str = "abstract"

    # -- runtime collectives ------------------------------------------------
    def all_reduce(self, x: torch.Tensor, groups: Tuple):
        raise NotImplementedError

    def reduce_scatter(self, x: torch.Tensor, groups: Tuple):
        """Tiled over dim 0; the caller pads ``x`` to a multiple of P."""
        raise NotImplementedError

    def all_gather(self, x: torch.Tensor, groups: Tuple):
        """Tiled concatenation over dim 0 (worker order)."""
        raise NotImplementedError

    def broadcast(self, x: torch.Tensor, groups: Tuple, root: int = 0):
        """Every worker receives worker ``root``'s value (mask + sum, the
        collective-free lowering of broadcast)."""
        if not groups:
            return x
        flat = 0
        for g in groups:
            flat = flat * comm.axis_size(g) + dist.get_rank(g)
        masked = x if flat == root else torch.zeros_like(x)
        return self.all_reduce(masked, groups)

    # -- static wire accounting (per packed bucket, per worker) -------------
    def dense_wire_bytes(self, kind: str, n_elems: int, native_dtype,
                         codec: WireCodec, levels: Sequence[int]) -> int:
        """Bytes this backend moves per worker for one dense bucket."""
        p = _prod(levels)
        if p <= 1:
            return 0
        if not codec.linear:
            # non-linear codecs exchange via allgather of (values, scales)
            return self.gather_wire_bytes(
                codec.wire_bytes(n_elems, native_dtype), levels)
        dt = codec.wire_dtype(native_dtype)
        if kind == ALLREDUCE:
            return self.allreduce_wire_bytes(n_elems, dt, levels)
        if kind == REDUCE_SCATTER:
            return self.rs_ag_wire_bytes(n_elems, dt, levels)
        raise ValueError(f"unknown dense collective kind {kind!r}")

    def gather_wire_bytes(self, payload_bytes: int,
                          levels: Sequence[int]) -> int:
        """Allgather of an opaque payload: every worker receives the
        other P-1 workers' payloads (backend-invariant total)."""
        return (_prod(levels) - 1) * payload_bytes

    # -- per-level (hop) accounting -----------------------------------------
    def dense_hop_wire_bytes(self, kind: str, n_elems: int, native_dtype,
                             codec: WireCodec, levels: Sequence[int]
                             ) -> Tuple[int, ...]:
        """Per-level wire bytes for one dense bucket, in ``levels``
        order.  Flat backends move everything in one hop."""
        return (self.dense_wire_bytes(kind, n_elems, native_dtype, codec,
                                      levels),)

    def gather_hop_wire_bytes(self, payload_bytes: int,
                              levels: Sequence[int]) -> Tuple[int, ...]:
        """Per-level wire bytes for one gather bucket."""
        return (self.gather_wire_bytes(payload_bytes, levels),)

    def dense_hop_ops(self, kind: str, codec: WireCodec,
                      levels: Sequence[int]) -> Tuple[int, ...]:
        """Per-level collective calls for one dense bucket (split as the
        ``*_hop_wire_bytes`` pair; sums to ``hlo_ops_dense``)."""
        return (self.hlo_ops_dense(kind, codec, levels),)

    def gather_hop_ops(self, n_tensors: int,
                       levels: Sequence[int]) -> Tuple[int, ...]:
        """Per-level collective calls for one gather bucket."""
        return (self.hlo_ops_gather(n_tensors, levels),)

    def allreduce_wire_bytes(self, n_elems: int, wire_dtype,
                             levels: Sequence[int]) -> int:
        raise NotImplementedError

    def rs_ag_wire_bytes(self, n_elems: int, wire_dtype,
                         levels: Sequence[int]) -> int:
        raise NotImplementedError

    # -- static launch accounting (the comm counters' contract) -------------
    def hlo_ops_dense(self, kind: str, codec: WireCodec,
                      levels: Sequence[int]) -> int:
        """Collective calls issued per dense bucket."""
        raise NotImplementedError

    def hlo_ops_reduce_scatter(self, levels: Sequence[int]) -> int:
        """Collective calls issued by one bare reduce-scatter (ZeRO-1's
        grad half, with no trailing allgather)."""
        raise NotImplementedError

    def hlo_ops_gather(self, n_tensors: int, levels: Sequence[int]) -> int:
        """Collective calls issued per sparse gather bucket exchanging
        ``n_tensors`` tensors (indices + values [+ scales])."""
        raise NotImplementedError

    def logical_collectives(self, kind: str, n_levels: int = 1) -> int:
        """P-independent logical launch count (plan.n_collectives)."""
        raise NotImplementedError

    def __repr__(self):
        return f"{type(self).__name__}({self.name!r})"


class FlatCollectives(CollectiveBackend):
    """Default backend: one collective over one process group (the
    reference's ``"jax"`` backend, flat over the product of the mesh
    axes)."""

    name = "flat"

    def all_reduce(self, x, groups):
        return comm.all_reduce_dense(x, groups, average=False)

    def reduce_scatter(self, x, groups):
        return comm.reduce_scatter_dense(x, groups, average=False)

    def all_gather(self, x, groups):
        return comm.all_gather_dense(x, groups)

    def allreduce_wire_bytes(self, n_elems, wire_dtype, levels):
        return comm.allreduce_wire_bytes((n_elems,), wire_dtype,
                                         _prod(levels))

    def rs_ag_wire_bytes(self, n_elems, wire_dtype, levels):
        p = _prod(levels)
        return (comm.reduce_scatter_wire_bytes(n_elems, wire_dtype, p)
                + comm.allgather_dense_wire_bytes(n_elems, wire_dtype, p))

    def hlo_ops_dense(self, kind, codec, levels):
        if not codec.linear:               # values + scales allgathers
            return 2 * len(levels)
        return {ALLREDUCE: 1, REDUCE_SCATTER: 1 + len(levels)}[kind]

    def hlo_ops_reduce_scatter(self, levels):
        return 1                           # one flat reduce-scatter

    def hlo_ops_gather(self, n_tensors, levels):
        return n_tensors * len(levels)     # one allgather per level each

    def logical_collectives(self, kind, n_levels=1):
        return {ALLREDUCE: 1, REDUCE_SCATTER: 2, ALLGATHER: 1}[kind]


class HierarchicalBackend(FlatCollectives):
    """Per-level collectives: one allreduce per level, innermost first —
    within-pod rings, then cross-pod rings, instead of one flat ring
    over the slow inter-pod links."""

    name = "hierarchical"

    def all_reduce(self, x, groups):
        return comm.two_level_all_reduce(x, groups, average=False)

    def reduce_scatter(self, x, groups):
        raise ValueError("hierarchical backend does not implement "
                         "reduce_scatter; use backend='flat' (one "
                         "reduce-scatter) for the RS+AG decomposition")

    def hlo_ops_reduce_scatter(self, levels):
        raise ValueError("hierarchical backend has no reduce-scatter "
                         "path")

    def allreduce_wire_bytes(self, n_elems, wire_dtype, levels):
        return comm.hierarchical_allreduce_wire_bytes(
            (n_elems,), wire_dtype, levels)

    def rs_ag_wire_bytes(self, n_elems, wire_dtype, levels):
        raise ValueError("hierarchical backend has no RS+AG path")

    def dense_wire_bytes(self, kind, n_elems, native_dtype, codec, levels):
        # exactly the sum of the per-hop bill, so the two accountings
        # cannot diverge
        return sum(self.dense_hop_wire_bytes(kind, n_elems, native_dtype,
                                             codec, levels))

    def dense_hop_wire_bytes(self, kind, n_elems, native_dtype, codec,
                             levels):
        if _prod(levels) <= 1:
            return tuple(0 for _ in levels)
        if not codec.linear:
            # per-hop requantizing reduction: at every level each worker
            # gathers its group's (values, scales), decode-sums and
            # re-encodes the partial sum for the next level, so each hop
            # moves (p_k - 1) payloads instead of the full gather's (P-1)
            payload = codec.wire_bytes(n_elems, native_dtype)
            return tuple((pk - 1) * payload for pk in levels)
        if kind != ALLREDUCE:
            raise ValueError("hierarchical backend has no RS+AG path")
        dt = codec.wire_dtype(native_dtype)
        return tuple(comm.allreduce_wire_bytes((n_elems,), dt, pk)
                     for pk in levels)

    def gather_hop_wire_bytes(self, payload_bytes, levels):
        # per-level tiled allgathers, innermost first: results telescope
        # (rows concatenate, nothing to requantize between levels)
        out, inner = [], 1
        for pk in reversed(tuple(levels)):
            out.append((pk - 1) * inner * payload_bytes)
            inner *= pk
        return tuple(reversed(out))

    def hlo_ops_dense(self, kind, codec, levels):
        if not codec.linear:
            return 2 * len(levels)         # (values, scales) per hop
        if kind == ALLREDUCE:
            return len(levels)             # one allreduce per level
        raise ValueError("hierarchical backend has no RS+AG path")

    def dense_hop_ops(self, kind, codec, levels):
        if not codec.linear:
            return tuple(2 for _ in levels)
        if kind == ALLREDUCE:
            return tuple(1 for _ in levels)
        raise ValueError("hierarchical backend has no RS+AG path")

    def gather_hop_ops(self, n_tensors, levels):
        return tuple(n_tensors for _ in levels)

    def logical_collectives(self, kind, n_levels=1):
        if kind == ALLREDUCE:
            return n_levels
        return super().logical_collectives(kind, n_levels)


class RingSimBackend(CollectiveBackend):
    """The ring over send/recv on one process group.

    A bucket allreduce is the literal ring schedule: P-1 reduce-scatter
    hops, then P-1 allgather hops, each moving one 1/P chunk, so
    2(P-1) ``comm.ring_shift`` calls whose bytes sum to the ring
    allreduce's wire formula, in the reference's chunk order.  One level
    only; nothing is issued at P = 1.
    """

    name = "ringsim"

    @staticmethod
    def _ring(groups):
        if len(groups) != 1:
            raise ValueError("ringsim backend runs over exactly one "
                             f"process group, got {len(groups)}")
        return groups[0]

    def all_reduce(self, x, groups):
        return comm.ring_all_reduce(x, self._ring(groups))

    def reduce_scatter(self, x, groups):
        return comm.ring_reduce_scatter(x, self._ring(groups))

    def all_gather(self, x, groups):
        return comm.ring_all_gather(x, self._ring(groups))

    # -- accounting: explicit per-hop chunk traffic -------------------------
    def allreduce_wire_bytes(self, n_elems, wire_dtype, levels):
        p = _prod(levels)
        if p <= 1:
            return 0
        chunk = padded_elems(n_elems, p) // p
        return int(2 * (p - 1) * chunk * comm.dtype_bytes(wire_dtype))

    def rs_ag_wire_bytes(self, n_elems, wire_dtype, levels):
        # the ring IS the RS+AG decomposition; same hops either way
        return self.allreduce_wire_bytes(n_elems, wire_dtype, levels)

    def hlo_ops_dense(self, kind, codec, levels):
        # RS hops + AG hops, or the values and scales ring gathers
        return 2 * max(_prod(levels) - 1, 0)

    def hlo_ops_reduce_scatter(self, levels):
        return max(_prod(levels) - 1, 0)   # the ring's P-1 RS hops

    def hlo_ops_gather(self, n_tensors, levels):
        return n_tensors * max(_prod(levels) - 1, 0)

    def logical_collectives(self, kind, n_levels=1):
        return {ALLREDUCE: 1, REDUCE_SCATTER: 2, ALLGATHER: 1}[kind]


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_BACKENDS: Dict[str, CollectiveBackend] = {}


def register_backend(backend: CollectiveBackend,
                     name: Optional[str] = None) -> None:
    """Extension point: a backend registered here is addressable as
    ``ExchangeConfig(backend=<name>)``."""
    _BACKENDS[name or backend.name] = backend


register_backend(FlatCollectives())
register_backend(HierarchicalBackend())
register_backend(RingSimBackend())

#: the default backend's name
DEFAULT_BACKEND = "flat"


def available_backends() -> Tuple[str, ...]:
    return tuple(sorted(_BACKENDS))


def get_backend(name) -> CollectiveBackend:
    if isinstance(name, CollectiveBackend):
        return name
    if name is None:
        return _BACKENDS[DEFAULT_BACKEND]
    if name not in _BACKENDS:
        raise ValueError(f"unknown collective backend {name!r} "
                         f"(registered: {', '.join(available_backends())})")
    return _BACKENDS[name]
