"""ExchangePlan — one static collective schedule for accumulation, fusion
and cross-worker gradient exchange.

The torch counterpart of ``repro.core.exchange``, for the configuration
space this port carries: the wire codecs of ``repro_torch.core.codecs``
(identity, bf16/f16/fp8 casts, int8, each with optional error feedback)
and the collective backends of ``repro_torch.core.backend`` (flat,
hierarchical, ring simulation) over a process group or a tuple of them
(one per mesh level, outermost first).  Per gradient-tree structure it
compiles, once:

  1. **classify** every leaf's contribution list through the configured
     accumulation rule (paper Alg. 1 / Alg. 2 / the ``sparse_as_dense``
     Listing-1 pre-pass) to its post-accumulation representation;
  2. **bucket** dense leaves into Horovod-style fusion buffers
     (first-fit-decreasing, one group per codec wire dtype) and give each
     sparse IndexedSlices leaf its own gather stage;
  3. **select a collective** per dense bucket: allreduce, or
     reduce-scatter + allgather (``reduce_scatter=True``);
  4. a **BucketSchedule**: one stage per bucket, sorted reverse-layer
     (descending readiness key).

``execute_fused`` runs the stages serially: accumulate, pack (the
densification of deferred-sparse leaves happens here, through the
densify kernel when ``use_kernel`` is set), encode, the stage's
collectives, decode, unpack.  ``execute_scheduled`` runs the same
per-stage ops but launches every stage's collective (asynchronously)
before any stage unpacks; ``execute`` picks one by
``ExchangeConfig.overlap``.  Under ``overlap="backward"`` buckets are
snapped to top-level blocks, so ``backward_block_stages`` can hand each
block's stages to a hook inside the backward pass
(``training.gradients.wait_free_grad_exchange``).  Linear codecs
allreduce the wire (or reduce-scatter it, then allgather the shards);
non-linear ones (int8) allgather (values, scales) and sum after decode,
and on the hierarchical backend do so one level at a time, re-encoding
the partial sum between levels (``_hop_reduce_dense``).  Such a stage is
a chain: hop k+1's encode needs hop k's decode-sum, so it waits on its
own earlier hops inside ``launch_stage`` (on NCCL a stream wait) and
leaves only its last hop in flight.  Every codec threads an
``ExchangeState`` through the exchange (empty entries for stateless
codecs).
Under ``zero1=True`` the exchange is fused with the optimizer update
and driven by ``optim.zero1.zero1_step``: ``zero1_launch_grad`` /
``zero1_finish_grad`` reduce each dense bucket to this rank's flat f32
shard (a reduce-scatter, or the quantised allgather and decode-sum then
a slice), and ``zero1_allgather_params`` brings the updated param shards
back through ``param_codec``; the grads-only ``execute`` paths refuse
such a plan.
The plan is the single source of the byte and launch accounting
(``wire_bytes`` / ``hop_wire_bytes`` / ``buffer_bytes`` /
``n_collectives`` / ``hlo_collectives`` / ``state_bytes``), which equals
the reference plan's for the same tree exactly; each stage delegates to
the backend.
Every stage has a name (``stage_name``, the reference's strings, e.g.
``exchange/s03/allreduce/bucket=dense2/trigger=block5``), and each stage's
accumulate, launch and finish run inside ``telemetry.hooks.stage_scope``
of it, so the wire recorder bills each collective to its stage; the
phase taps (``accumulate``, ``pack``, ``collective`` once the stage's
collectives have been waited for, ``unpack``) return their argument
untouched unless a tracer is installed.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import hashlib
import math
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

from repro_torch.core import accumulation, backend as backend_lib, codecs, \
    comm, fusion
from repro_torch.core.backend import ALLGATHER, ALLREDUCE, REDUCE_SCATTER
from repro_torch.core.codecs import ExchangeState
from repro_torch.core.indexed_slices import IndexedSlices, concat_slices
from repro_torch.telemetry import hooks as _telemetry
from repro_torch.tree import tree_flatten, tree_unflatten, treedef_str

Levels = Union[int, Sequence[int]]


def _stage_scope(name: str):
    """``telemetry.hooks.stage_scope(name)`` and, only while a tracer is
    installed, a ``torch.profiler.record_function`` range of the same name
    (the reference's ``jax.named_scope``): the untraced step gains no
    dispatcher call."""
    if _telemetry.tracer() is None:
        return _telemetry.stage_scope(name)
    return _traced_scope(name)


@contextlib.contextmanager
def _traced_scope(name: str):
    with _telemetry.stage_scope(name), torch.profiler.record_function(name):
        yield


def _tap_first(phase: str, stage: "BucketStage", leaves: List[Any]) -> None:
    """Tap ``phase`` once for ``stage`` on the first of its leaves (a
    traced step only)."""
    if _telemetry.tracer() is not None:
        i0 = min(stage.leaf_ids)
        leaves[i0] = _telemetry.tap(phase, leaves[i0])


@dataclasses.dataclass(frozen=True)
class ExchangeConfig:
    """Everything the planner needs to know, all static.  ``codec`` and
    ``backend`` name entries of the ``repro_torch.core.codecs`` and
    ``repro_torch.core.backend`` registries.  ``error_feedback`` and the
    deprecated spellings ``wire_dtype`` and ``hierarchical`` are
    normalised onto ``codec`` and ``backend`` in ``__post_init__``, so
    equivalent configs compare, hash and cache identically."""
    algorithm: str = "tf_algorithm1"         # paper Alg. 1 (TF upstream)
    sparse_as_dense: bool = False            # Horovod Listing-1 pre-pass
    fusion_threshold: Optional[int] = None   # bytes; None = bucket/leaf
    reduce_scatter: bool = False             # RS+AG instead of allreduce
    use_kernel: bool = False                 # densify kernel
    codec: str = "identity"                  # WireCodec registry name
    backend: str = backend_lib.DEFAULT_BACKEND   # CollectiveBackend name
    hierarchy_levels: int = 2                # levels a hierarchical plan spans
    error_feedback: bool = False             # -> codec="<codec>+ef"
    overlap: Union[bool, str] = False        # False | "staged" | "backward".
    #                                          "staged" (legacy True): every
    #                                          bucket's collective launches
    #                                          before any unpacks.
    #                                          "backward": buckets snap to
    #                                          top-level blocks and launch
    #                                          from inside the backward pass
    zero1: bool = False                      # ZeRO-1: reduce-scatter grads,
    #                                          update this worker's 1/P flat
    #                                          shard, allgather the UPDATED
    #                                          PARAMS back through the same
    #                                          schedule (optim/zero1.py)
    param_codec: str = "identity"            # WireCodec of the zero1 param
    #                                          allgather (stateless only;
    #                                          "identity" keeps zero1 bitwise
    #                                          the replicated path)
    # -- deprecated spellings, folded into codec/backend ---------------------
    wire_dtype: Optional[str] = None         # -> codec=<cast codec>
    hierarchical: bool = False               # -> backend="hierarchical"

    def __post_init__(self):
        if self.algorithm not in ("tf_algorithm1", "proposed_algorithm2"):
            raise ValueError(
                f"unknown accumulation algorithm: {self.algorithm}")
        # normalise overlap onto False | "staged" | "backward" so legacy
        # bool configs compare, hash and cache as the string spellings
        ov = self.overlap
        if ov in (False, None, "none", "off"):
            ov = False
        elif ov in (True, "staged", "on"):
            ov = "staged"
        elif ov != "backward":
            raise ValueError(f"unknown overlap mode: {self.overlap!r} "
                             f"(expected False, 'staged' or 'backward')")
        object.__setattr__(self, "overlap", ov)
        if self.wire_dtype is not None:
            mapped = codecs.codec_name_for_wire_dtype(self.wire_dtype)
            if self.codec not in ("identity", mapped):
                raise ValueError(
                    f"conflicting wire_dtype={self.wire_dtype!r} and "
                    f"codec={self.codec!r}")
            object.__setattr__(self, "codec", mapped)
            object.__setattr__(self, "wire_dtype", None)
        if self.error_feedback:
            name = codecs.get_codec(self.codec).name
            if not name.endswith(codecs.EF_SUFFIX):
                name += codecs.EF_SUFFIX
            object.__setattr__(self, "codec", name)
            object.__setattr__(self, "error_feedback", False)
        if self.hierarchical:
            if self.backend not in (backend_lib.DEFAULT_BACKEND,
                                    "hierarchical"):
                raise ValueError(
                    f"conflicting hierarchical=True and "
                    f"backend={self.backend!r}")
            object.__setattr__(self, "backend", "hierarchical")
            object.__setattr__(self, "hierarchical", False)
        # resolve + normalise the registry names (raises on unknown ones)
        object.__setattr__(self, "codec", codecs.get_codec(self.codec).name)
        backend_lib.get_backend(self.backend)
        if self.reduce_scatter:
            if not self.codec_obj.linear:
                raise ValueError(
                    f"codec {self.codec!r} is non-linear (quantised wires "
                    f"cannot be reduced in flight) and has no "
                    f"reduce_scatter path; use the default allreduce")
            if self.codec_obj.stateful:
                raise ValueError(
                    f"codec {self.codec!r} is stateful; the RS+AG "
                    f"decomposition has no stateful encode hook — use "
                    f"the default allreduce")
            if self.backend == "hierarchical":
                raise ValueError("hierarchical backend has no RS+AG path; "
                                 "use backend='flat' or 'ringsim'")
        # resolve + normalise the zero1 param-allgather codec
        object.__setattr__(self, "param_codec",
                           codecs.get_codec(self.param_codec).name)
        if self.zero1:
            if self.reduce_scatter:
                raise ValueError(
                    "zero1 subsumes reduce_scatter: the grad "
                    "reduce-scatter and the updated-param allgather ARE "
                    "the RS+AG decomposition with the optimizer update "
                    "in between — drop reduce_scatter=True")
            if self.backend == "hierarchical":
                raise ValueError("hierarchical backend has no "
                                 "reduce-scatter path; zero1 needs "
                                 "backend='flat' or 'ringsim'")
            if self.overlap == "backward":
                raise ValueError(
                    "zero1 does not compose with overlap='backward': the "
                    "updated-param allgather needs the sharded optimizer "
                    "update, which runs AFTER the backward pass — use "
                    "overlap='staged' (grad reduce-scatters still launch "
                    "before any param allgather)")
            if self.param_codec_obj.stateful:
                raise ValueError(
                    f"param_codec {self.param_codec!r} is stateful; the "
                    f"param allgather broadcasts state (the updated "
                    f"params), so error-feedback residuals would "
                    f"double-apply — use a stateless codec")
        elif self.param_codec != "identity":
            raise ValueError("param_codec configures the zero1 param "
                             "allgather; set zero1=True")

    @property
    def codec_obj(self) -> codecs.WireCodec:
        return codecs.get_codec(self.codec)

    @property
    def param_codec_obj(self) -> codecs.WireCodec:
        return codecs.get_codec(self.param_codec)

    @property
    def backend_obj(self) -> backend_lib.CollectiveBackend:
        return backend_lib.get_backend(self.backend)

    @property
    def is_hierarchical(self) -> bool:
        return self.backend == "hierarchical"

    @property
    def dense_collective(self) -> str:
        if self.zero1 or self.reduce_scatter:
            return REDUCE_SCATTER
        return ALLREDUCE

    @property
    def overlap_backward(self) -> bool:
        """Wait-free backprop: collectives launch mid-backward."""
        return self.overlap == "backward"


# ---------------------------------------------------------------------------
# Static leaf specs + classification (Alg. 1 / Alg. 2, shapes only)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DenseSpec:
    shape: Tuple[int, ...]
    dtype: str

    @property
    def size(self) -> int:
        return math.prod(self.shape)


@dataclasses.dataclass(frozen=True)
class SparseSpec:
    rows: int
    dense_shape: Tuple[int, ...]
    dtype: str
    index_dtype: str = "int32"

    @property
    def row_elems(self) -> int:
        return math.prod(self.dense_shape[1:])


LeafSpec = Union[DenseSpec, SparseSpec]


def contribution_spec(g) -> LeafSpec:
    if isinstance(g, IndexedSlices):
        return SparseSpec(rows=int(g.indices.shape[0]),
                          dense_shape=tuple(g.dense_shape),
                          dtype=comm.dtype_name(g.values.dtype),
                          index_dtype=comm.dtype_name(g.indices.dtype))
    return DenseSpec(shape=tuple(g.shape), dtype=comm.dtype_name(g.dtype))


def classify(contribs: Tuple[LeafSpec, ...],
             config: ExchangeConfig) -> LeafSpec:
    """Static mirror of ``accumulation.accumulate_gradients``: the
    post-accumulation representation of one variable's contributions."""
    def result_dtype() -> str:
        out = comm.torch_dtype(contribs[0].dtype)
        for c in contribs[1:]:
            out = torch.promote_types(out, comm.torch_dtype(c.dtype))
        return comm.dtype_name(out)

    def dense_result() -> DenseSpec:
        shape = next((c.shape for c in contribs
                      if isinstance(c, DenseSpec)), None)
        if shape is None:                # all-sparse: densified shape
            shape = contribs[0].dense_shape
        return DenseSpec(shape=tuple(shape), dtype=result_dtype())

    def gather_result() -> SparseSpec:
        # dense contributions downgrade to all-rows slices (Alg. 1)
        rows = sum(c.rows if isinstance(c, SparseSpec) else c.shape[0]
                   for c in contribs)
        sparse = [c for c in contribs if isinstance(c, SparseSpec)]
        return SparseSpec(rows=rows, dense_shape=tuple(sparse[0].dense_shape),
                          dtype=result_dtype(),
                          index_dtype=sparse[0].index_dtype)

    any_sparse = any(isinstance(c, SparseSpec) for c in contribs)
    any_dense = any(isinstance(c, DenseSpec) for c in contribs)

    if config.sparse_as_dense:               # Listing-1 pre-pass: all dense
        return dense_result()
    if len(contribs) < 2:                    # pass-through
        return contribs[0]
    if not any_sparse:
        return dense_result()                # dense reduce
    if config.algorithm == "tf_algorithm1":
        return gather_result()               # ANY sparse => gather
    if any_dense:
        return dense_result()                # Alg. 2 lines 5-7: densify
    return gather_result()                   # all-sparse stays sparse


# ---------------------------------------------------------------------------
# Runtime accumulation matching the classification
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _Pending:
    """A dense-destined leaf whose densification is deferred to pack
    time."""
    slices: Optional[IndexedSlices]
    dense: Optional[torch.Tensor]


def _accumulate_leaf(leaf, spec: LeafSpec, config: ExchangeConfig):
    """Accumulate one variable's contributions to the representation the
    plan classified.  Dense-destined leaves with sparse contributions
    come back as ``_Pending`` — densified later, inside pack."""
    contribs = leaf if isinstance(leaf, list) else [leaf]
    sparse = [c for c in contribs if isinstance(c, IndexedSlices)]
    dense = [c for c in contribs if not isinstance(c, IndexedSlices)]

    if isinstance(spec, SparseSpec):         # gather path
        if len(contribs) == 1:
            return contribs[0]
        slices = [c if isinstance(c, IndexedSlices)
                  else accumulation.dense_to_slices(c) for c in contribs]
        return concat_slices(tuple(slices))

    dense_sum = None
    if dense:
        dense_sum = dense[0]
        for g in dense[1:]:
            dense_sum = dense_sum + g
    if not sparse:
        return dense_sum
    merged = sparse[0] if len(sparse) == 1 else concat_slices(tuple(sparse))
    return _Pending(slices=merged, dense=dense_sum)


def _materialise(x, config: ExchangeConfig) -> torch.Tensor:
    """Densify a pending leaf (kernel when ``config.use_kernel``)."""
    if isinstance(x, _Pending):
        out = None
        if x.slices is not None:
            out = accumulation.densify(x.slices,
                                       use_kernel=config.use_kernel)
        if x.dense is not None:
            out = x.dense if out is None else out + x.dense
        return out
    if isinstance(x, IndexedSlices):
        return accumulation.densify(x, use_kernel=config.use_kernel)
    return x


# ---------------------------------------------------------------------------
# The plan
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DenseBucket:
    """One fusion buffer: contiguous slots over the dense-leaf list."""
    slots: Tuple[fusion._Slot, ...]     # leaf_idx indexes dense_leaf_ids
    collective: str
    n_elems: int
    wire_dtype: str


@dataclasses.dataclass(frozen=True)
class BucketStage:
    """One schedule unit: ``pack -> collective -> unpack`` for a single
    bucket.  ``leaf_ids`` is its readiness key: backward emits leaves in
    reverse flatten order, so a stage is ready once its smallest leaf id
    has been emitted."""
    kind: str                    # "dense" | "gather"
    bucket_id: int               # index into dense_buckets, or the leaf id
    leaf_ids: Tuple[int, ...]
    trigger: str = ""            # top-level block whose backward emission
    #                              makes the stage launchable (the block
    #                              of the ready_key leaf)

    @property
    def ready_key(self) -> int:
        return min(self.leaf_ids)


@dataclasses.dataclass(frozen=True)
class BucketSchedule:
    """Stages sorted reverse-layer (descending ``ready_key``)."""
    stages: Tuple[BucketStage, ...]

    @property
    def n_stages(self) -> int:
        return len(self.stages)


@dataclasses.dataclass(frozen=True)
class ExchangePlan:
    """Static schedule for one gradient-tree structure."""
    treedef: Any
    contrib_specs: Tuple[Tuple[LeafSpec, ...], ...]
    leaf_specs: Tuple[LeafSpec, ...]     # post-accumulation, per leaf
    dense_leaf_ids: Tuple[int, ...]
    dense_buckets: Tuple[DenseBucket, ...]
    gather_leaf_ids: Tuple[int, ...]
    config: ExchangeConfig
    schedule: BucketSchedule
    leaf_blocks: Tuple[str, ...] = ()    # top-level block of every leaf

    # -- static accounting ---------------------------------------------------
    @property
    def n_leaves(self) -> int:
        return len(self.leaf_specs)

    @property
    def fingerprint(self) -> str:
        """Stable digest of the gradient-tree structure this plan was
        compiled for (``tree_fingerprint``): the plan cache's key and, in
        structural form, the tuning artifact's."""
        return tree_fingerprint(self.treedef, self.contrib_specs)

    @property
    def n_buckets(self) -> int:
        return len(self.dense_buckets) + len(self.gather_leaf_ids)

    @property
    def n_collectives(self) -> int:
        """Logical collective launches (P-independent): the sum of the
        per-stage counts."""
        return sum(self.stage_collectives(s) for s in self.schedule.stages)

    # -- ZeRO-1 accounting --------------------------------------------------
    @property
    def _zero1_param_tensors(self) -> int:
        """Tensors the zero1 param allgather moves per dense stage: the
        encoded shard, plus the per-worker scales of a sided codec."""
        return 1 + (0 if self.config.param_codec_obj.linear else 1)

    def zero1_shard_elems(self, stage: BucketStage,
                          n_workers: Levels) -> int:
        """Per-worker flat shard length of one dense stage's bucket under
        ZeRO-1 (the bucket padded to a multiple of P): the slice of
        (params, EMA buffers) this worker owns and updates."""
        p = math.prod(self._levels(n_workers))
        b = self.dense_buckets[stage.bucket_id]
        return codecs.padded_elems(b.n_elems, p) // p

    def _zero1_param_hop_wire_bytes(self, stage: BucketStage,
                                    n_workers: Levels) -> Tuple[int, ...]:
        """Per-hop wire bytes of one dense stage's updated-param
        allgather: every worker receives the other P-1 encoded shards
        (and their scales)."""
        levels = self._levels(n_workers)
        if math.prod(levels) <= 1:
            return tuple(0 for _ in levels)
        payload = self.config.param_codec_obj.wire_bytes(
            self.zero1_shard_elems(stage, n_workers), "float32")
        return self.config.backend_obj.gather_hop_wire_bytes(payload,
                                                             levels)

    def stage_collectives(self, stage: BucketStage) -> int:
        """Logical collectives one stage launches (P-independent)."""
        if stage.kind == "dense" and self.config.zero1:
            # the grad half (a reduce-scatter for linear wires, values
            # and scales allgathers for quantised ones) + the updated-
            # param allgather half
            grad = 1 if self.config.codec_obj.linear else 2
            return grad + self._zero1_param_tensors
        if not self.config.codec_obj.linear:
            # non-linear codecs never reduce in flight: every bucket is a
            # values and a scales allgather (the gather stage's indices
            # are billed with its values); on the hierarchical backend a
            # dense bucket runs one such round per level
            if stage.kind == "dense" and self.config.is_hierarchical:
                return 2 * self.config.hierarchy_levels
            return 2
        be = self.config.backend_obj
        nl = self.config.hierarchy_levels
        if stage.kind == "dense":
            return be.logical_collectives(
                self.dense_buckets[stage.bucket_id].collective, nl)
        return be.logical_collectives(ALLGATHER, nl)

    def stage_wire_bytes(self, stage: BucketStage, n_workers: Levels) -> int:
        """Bytes one stage moves per worker (sum over the level hops)."""
        return sum(self.stage_hop_wire_bytes(stage, n_workers))

    def stage_hop_wire_bytes(self, stage: BucketStage, n_workers: Levels
                             ) -> Tuple[int, ...]:
        """Per-level wire bytes of one stage, outermost level first; flat
        backends report one hop, the hierarchical one bills each level
        (for non-linear codecs the requantized payload per hop)."""
        levels = self._levels(n_workers)
        be = self.config.backend_obj
        if stage.kind == "dense":
            b = self.dense_buckets[stage.bucket_id]
            codec = self.config.codec_obj
            if self.config.zero1:
                if codec.linear:
                    p = math.prod(levels)
                    grad = (int(comm.reduce_scatter_wire_bytes(
                        b.n_elems, b.wire_dtype, p)) if p > 1 else 0,)
                else:
                    # quantised grads move as the replicated path's
                    # (values, scales) allgather: the shard is sliced
                    # after the decode-sum
                    grad = be.dense_hop_wire_bytes(
                        b.collective, b.n_elems, b.wire_dtype, codec,
                        levels)
                param = self._zero1_param_hop_wire_bytes(stage, n_workers)
                return tuple(g + q for g, q in zip(grad, param))
            return be.dense_hop_wire_bytes(b.collective, b.n_elems,
                                           b.wire_dtype, codec, levels)
        return be.gather_hop_wire_bytes(
            self._gather_payload_bytes(self.leaf_specs[stage.bucket_id]),
            levels)

    def _gather_tensors(self) -> int:
        """Tensors one gather stage exchanges: indices and values, plus
        scales for a non-linear codec."""
        return 2 + (0 if self.config.codec_obj.linear else 1)

    def stage_hlo_collectives(self, stage: BucketStage,
                              n_workers: Levels) -> int:
        """Collective calls one stage issues through the comm layer (the
        reference's HLO op count of the same stage)."""
        levels = self._levels(n_workers)
        be = self.config.backend_obj
        codec = self.config.codec_obj
        if stage.kind == "dense":
            b = self.dense_buckets[stage.bucket_id]
            if self.config.zero1:
                grad = (be.hlo_ops_reduce_scatter(levels) if codec.linear
                        else be.hlo_ops_dense(b.collective, codec, levels))
                return grad + be.hlo_ops_gather(self._zero1_param_tensors,
                                                levels)
            return be.hlo_ops_dense(b.collective, codec, levels)
        return be.hlo_ops_gather(self._gather_tensors(), levels)

    def stage_hop_ops(self, stage: BucketStage, n_workers: Levels
                      ) -> Tuple[int, ...]:
        """Per-level collective calls of one stage, split as
        ``stage_hop_wire_bytes``; sums to ``stage_hlo_collectives``."""
        levels = self._levels(n_workers)
        be = self.config.backend_obj
        codec = self.config.codec_obj
        if stage.kind == "dense":
            b = self.dense_buckets[stage.bucket_id]
            if self.config.zero1:
                grad = ((be.hlo_ops_reduce_scatter(levels),)
                        if codec.linear
                        else be.dense_hop_ops(b.collective, codec, levels))
                param = be.gather_hop_ops(self._zero1_param_tensors,
                                          levels)
                return tuple(g + q for g, q in zip(grad, param))
            return be.dense_hop_ops(b.collective, codec, levels)
        return be.gather_hop_ops(self._gather_tensors(), levels)

    def _levels(self, n_workers: Levels) -> Tuple[int, ...]:
        levels = (tuple(n_workers) if not isinstance(n_workers, int)
                  else (n_workers,))
        if self.config.is_hierarchical \
                and len(levels) != self.config.hierarchy_levels:
            raise ValueError(
                f"hierarchical plan with {self.config.hierarchy_levels} "
                f"levels needs per-level worker counts, got {n_workers!r}")
        return levels

    def _gather_payload_bytes(self, spec: SparseSpec) -> int:
        """Per-worker encoded IndexedSlices payload (values in the wire
        dtype + native-width indices + codec side scales)."""
        codec = self.config.codec_obj
        return (codec.wire_bytes(spec.rows * spec.row_elems, spec.dtype)
                + spec.rows * comm.dtype_bytes(spec.index_dtype))

    def wire_bytes(self, n_workers: Levels) -> int:
        """Bytes moved per worker per step (sum over the stages).  A
        hierarchical plan takes ``n_workers`` as a per-level tuple,
        outermost first (e.g. ``(n_pods, workers_per_pod)``)."""
        return sum(self.stage_wire_bytes(s, n_workers)
                   for s in self.schedule.stages)

    def hop_wire_bytes(self, n_workers: Levels) -> Tuple[int, ...]:
        """Per-level wire bytes summed over the stages (outermost level
        first); sums to ``wire_bytes``."""
        out = [0] * len(self._levels(n_workers))
        for stage in self.schedule.stages:
            for k, b in enumerate(self.stage_hop_wire_bytes(stage,
                                                            n_workers)):
                out[k] += b
        return tuple(out)

    def hlo_collectives(self, n_workers: Levels) -> int:
        """Collective calls one exchange issues through the comm layer
        (``comm.calls()`` summed, ``two_level_all_reduce`` aside, which
        issues its levels' allreduces): the reference's exact HLO
        collective count of the same plan."""
        return sum(self.stage_hlo_collectives(s, n_workers)
                   for s in self.schedule.stages)

    def buffer_bytes(self, n_workers: Levels) -> int:
        """Size of the accumulated representation each worker holds after
        exchange (paper Fig. 3 / Fig. 5): gather buffers grow linearly in
        P (wire-dtype values, native indices and one scale per worker for
        sided codecs), dense buffers are constant."""
        p = (n_workers if isinstance(n_workers, int)
             else math.prod(n_workers))
        codec = self.config.codec_obj
        total = self.dense_bytes
        for i in self.gather_leaf_ids:
            s = self.leaf_specs[i]
            total += comm.gathered_buffer_bytes(
                s.rows, s.row_elems, codec.wire_dtype(s.dtype), p,
                index_dtype=s.index_dtype)
            total += p * codec.scale_bytes
        return total

    @property
    def dense_bytes(self) -> int:
        """Total dense accumulated gradient bytes (P-independent)."""
        return sum(comm.dense_buffer_bytes(self.leaf_specs[i].shape,
                                           self.leaf_specs[i].dtype)
                   for i in self.dense_leaf_ids)

    def param_bytes(self) -> int:
        """Per-worker parameter memory (params are replicated under every
        strategy, zero1 included: only the master copy shards): every
        leaf's dense shape at its native dtype.  Sparse grad leaves still
        correspond to dense param tensors."""
        total = 0
        for s in self.leaf_specs:
            shape = s.shape if isinstance(s, DenseSpec) else s.dense_shape
            total += math.prod(shape) * comm.dtype_bytes(s.dtype)
        return total

    @property
    def sparse_bytes_per_worker(self) -> int:
        """Per-worker IndexedSlices bytes entering the gather collectives
        (the paper model's S term)."""
        total = 0
        for i in self.gather_leaf_ids:
            s = self.leaf_specs[i]
            total += s.rows * (s.row_elems * comm.dtype_bytes(s.dtype)
                               + comm.dtype_bytes(s.index_dtype))
        return total

    def describe(self) -> str:
        """Human-readable bucket/collective table naming the active codec
        and backend per bucket (the reference's, with the port's backend
        names: ``flat`` for its ``jax``)."""
        codec, be = self.config.codec, self.config.backend
        lines = ["| bucket | kind | collective | codec | backend | elems "
                 "| wire dtype |",
                 "|---|---|---|---|---|---|---|"]
        for k, b in enumerate(self.dense_buckets):
            lines.append(f"| {k} | dense x{len(b.slots)} | {b.collective} "
                         f"| {codec} | {be} | {b.n_elems} "
                         f"| {b.wire_dtype} |")
        for k, i in enumerate(self.gather_leaf_ids):
            s = self.leaf_specs[i]
            lines.append(f"| g{k} | sparse rows={s.rows} | allgather "
                         f"| {codec} | {be} | {s.rows * s.row_elems} "
                         f"| {self.config.codec_obj.wire_dtype(s.dtype)} |")
        return "\n".join(lines)

    def describe_schedule(self, n_workers: Union[Levels, None] = None
                          ) -> str:
        """Human-readable BucketSchedule: stage launch order, readiness
        keys, per-stage collectives (and wire bytes when ``n_workers`` is
        given): what a step will actually run."""
        sch = self.schedule
        ov = self.config.overlap
        mode = ("wait-free backward" if ov == "backward"
                else "overlap" if ov else "fused")
        launch = ("each stage launches from inside the backward pass, "
                  "the moment its trigger block's cotangents are emitted"
                  if ov == "backward"
                  else "launch order reverse-layer (descending readiness "
                  "key)")
        lines = [f"schedule: {sch.n_stages} stages ({mode}), {launch}"]
        state_per_stage = self.state_bytes_per_stage()
        for k, st in enumerate(sch.stages):
            wire = ""
            if n_workers is not None:
                wire = f", {self.stage_wire_bytes(st, n_workers)} wire B"
            state = (f", {state_per_stage[k]} state B"
                     if state_per_stage[k] else "")
            trig = f", trigger={st.trigger}" if st.trigger else ""
            lines.append(
                f"  stage {k}: {st.kind} bucket {st.bucket_id}, "
                f"{len(st.leaf_ids)} leaves (ready@{st.ready_key}"
                f"{trig}), "
                f"{self.stage_collectives(st)} collectives{wire}{state}")
        if n_workers is not None and self.config.is_hierarchical:
            hops = self.hop_wire_bytes(n_workers)
            lines.append("  per-hop wire B (outermost level first): "
                         + ", ".join(f"L{k}={b}"
                                     for k, b in enumerate(hops)))
        return "\n".join(lines)

    # -- telemetry naming ----------------------------------------------------
    def stage_name(self, stage: BucketStage,
                   index: Optional[int] = None) -> str:
        """Structured name of one stage, the identity telemetry keys
        everything on (stage scopes, wire-recorder attribution, trace
        rows, the predicted-vs-measured report):

            exchange/s03/allreduce/bucket=dense2[/trigger=block5]
        """
        if index is None:
            return self._stage_names_by_key[(stage.kind, stage.bucket_id)]
        if stage.kind == "dense":
            coll = self.dense_buckets[stage.bucket_id].collective
            bucket = f"dense{stage.bucket_id}"
        else:
            coll = ALLGATHER
            bucket = f"leaf{stage.bucket_id}"
        name = f"exchange/s{index:02d}/{coll}/bucket={bucket}"
        if stage.trigger:
            name += f"/trigger={stage.trigger}"
        return name

    def stage_names(self) -> Tuple[str, ...]:
        """Stage names in schedule order (one per stage)."""
        return tuple(self._stage_names_by_key.values())

    @functools.cached_property
    def _stage_names_by_key(self) -> Dict[Tuple[str, int], str]:
        # built once per plan: the exchange names every stage on every step
        return {(s.kind, s.bucket_id): self.stage_name(s, k)
                for k, s in enumerate(self.schedule.stages)}

    # -- codec state ---------------------------------------------------------
    def init_state(self, device=None, grads=None) -> ExchangeState:
        """Initial codec state: one entry per schedule stage (``()`` for
        zero-state codecs), sized for this worker, on ``device`` or, when
        it is None, on the device of ``grads``' leaves (see
        ``state_device``)."""
        return self.config.codec_obj.init_state(
            self, device=state_device(device, grads))

    def stage_n_elems(self, stage: BucketStage) -> int:
        """Per-worker element count of one stage's payload — the size
        codec state and its byte accounting are both keyed on."""
        if stage.kind == "dense":
            return self.dense_buckets[stage.bucket_id].n_elems
        spec = self.leaf_specs[stage.bucket_id]
        return spec.rows * spec.row_elems

    def state_bytes_per_stage(self) -> Tuple[int, ...]:
        """Per-worker codec-state memory, stage by stage."""
        codec = self.config.codec_obj
        return tuple(codec.state_bytes(self.stage_n_elems(s), kind=s.kind)
                     for s in self.schedule.stages)

    def state_bytes(self) -> int:
        """Total per-worker codec-state memory (0 for stateless)."""
        return sum(self.state_bytes_per_stage())

    def _check_state(self, state, grads=None) -> ExchangeState:
        """``state``, or the empty state of a stateless codec (on the
        device of ``grads``) for ``None``."""
        codec = self.config.codec_obj
        if state is None:
            if codec.stateful:
                raise ValueError(
                    f"codec {codec.name!r} is stateful: pass "
                    f"state=plan.init_state() and thread the returned "
                    f"state into the next step")
            return self.init_state(grads=grads)
        if not isinstance(state, ExchangeState):
            raise TypeError(f"state must be an ExchangeState, got "
                            f"{type(state).__name__}")
        if state.n_stages != self.schedule.n_stages:
            raise ValueError(
                f"ExchangeState has {state.n_stages} stage entries but "
                f"the plan schedules {self.schedule.n_stages} — state "
                f"from a different plan?")
        return state

    # -- execution -----------------------------------------------------------
    def pack_bucket(self, bucket: DenseBucket, leaves: List[Any]
                    ) -> torch.Tensor:
        """Fuse a bucket into one 1-D buffer; deferred sparse slots are
        densified here.  Stateless linear codecs pack straight into the
        wire dtype; non-linear and stateful codecs pack f32 and encode
        afterwards (the absmax scale needs the full-precision buffer, and
        the residual is added before narrowing).  The int8 codecs take a
        single-slot bucket's f32 or bf16 leaf as it is: their encode
        widens it exactly as the cast to f32 would."""
        codec = self.config.codec_obj
        if codecs.is_int8(codec) and len(bucket.slots) == 1:
            leaf_id = self.dense_leaf_ids[bucket.slots[0].leaf_idx]
            x = _materialise(leaves[leaf_id], self.config).reshape(-1)
            if x.dtype in (torch.float32, torch.bfloat16):
                return x
            return x.to(torch.float32)
        pack = comm.torch_dtype(bucket.wire_dtype
                                if codec.linear and not codec.stateful
                                else "float32")
        parts = []
        for slot in bucket.slots:
            leaf_id = self.dense_leaf_ids[slot.leaf_idx]
            x = _materialise(leaves[leaf_id], self.config).reshape(-1)
            if comm.is_fp8(pack):          # the reference's rounding
                parts.append(comm.fp8_encode(x, pack).view(torch.uint8))
            else:
                parts.append(x.to(pack))
        buf = parts[0] if len(parts) == 1 else torch.cat(parts)
        return buf.view(pack)

    def unpack_bucket(self, bucket: DenseBucket, buf: torch.Tensor,
                      out: List[Any], inv_scale: Optional[float]) -> None:
        """Split, reshape, restore each leaf's dtype, apply averaging."""
        for slot in bucket.slots:
            leaf_id = self.dense_leaf_ids[slot.leaf_idx]
            spec = self.leaf_specs[leaf_id]
            x = buf[slot.offset:slot.offset + slot.size]
            x = x.reshape(spec.shape).to(comm.torch_dtype(spec.dtype))
            if inv_scale is not None:
                x = x * inv_scale
            out[leaf_id] = x

    def _check_groups(self, group: comm.Group) -> Tuple:
        """``group`` as a tuple of process groups, checked against the
        backend: the hierarchical one takes ``hierarchy_levels`` groups
        (outermost first), the others one."""
        groups = comm.groups(group)
        if not groups:
            return groups
        if self.config.is_hierarchical:
            if len(groups) != self.config.hierarchy_levels:
                raise ValueError(
                    f"hierarchical plan spans {self.config.hierarchy_levels}"
                    f" levels but got {len(groups)} process groups")
        elif len(groups) != 1:
            raise ValueError(
                f"backend {self.config.backend!r} runs over one process "
                f"group, got {len(groups)} (a tuple of groups needs "
                f"backend='hierarchical')")
        return groups

    def _hop_reduce_dense(self, buf: torch.Tensor, bstate, groups: Tuple
                          ) -> Tuple[Tuple, Any]:
        """Per-hop requantizing reduction of one packed bucket on the
        hierarchical backend: innermost level first, each level encodes,
        allgathers (values, scales) over its group and decode-sums, and
        the f32 partial sum is re-encoded (``requantize``) for the next
        level, so every hop moves the quantised payload of its own group
        only.  Hop 0 is the only stateful encode.  Each hop but the last
        is waited for here (hop k+1 encodes hop k's sum); the last hop's
        gathers are returned in flight, with their chunk count, for
        ``_finish_dense`` to decode-sum."""
        codec = self.config.codec_obj
        be = self.config.backend_obj
        last = len(groups) - 1
        for level, g in enumerate(reversed(groups)):
            wire, scale, bstate = codec.encode_hop(buf, bstate, level)
            p_k = comm.axis_size(g)
            g_wire = be.all_gather(wire, (g,))
            g_scale = (be.all_gather(scale, (g,))
                       if scale is not None else None)
            if level == last:
                return (g_wire, g_scale, p_k), bstate
            buf = codec.reduce_hop(comm.wait(g_wire), comm.wait(g_scale),
                                   p_k, torch.float32)

    def _launch_dense(self, stage: BucketStage, leaves: List[Any],
                      groups: Tuple, p: int, bstate) -> Tuple[Tuple, Any]:
        """Pack one dense bucket, encode it and issue its collective(s)
        through the backend.  Linear codecs return the reduced wire
        (decode is the unpack upcast): an allreduce, or a reduce-scatter
        of the buffer padded to a multiple of P whose shard is then
        allgathered.  Non-linear codecs return the gathered (wire,
        scales, chunks) triple, decoded and summed at finish (on the
        hierarchical backend, the last hop of ``_hop_reduce_dense``; on
        the local path, their own decode).  Returns (inflight, new
        bucket state)."""
        codec = self.config.codec_obj
        be = self.config.backend_obj
        bucket = self.dense_buckets[stage.bucket_id]
        buf = _telemetry.tap("pack", self.pack_bucket(bucket, leaves))
        if not codec.linear and self.config.is_hierarchical \
                and len(groups) > 1:
            return self._hop_reduce_dense(buf, bstate, groups)
        # stateless linear codecs packed straight into the wire dtype, so
        # their encode returns the packed buffer itself
        wire, scale, bstate = codec.encode_stateful(buf, bstate)
        if codec.linear:
            if scale is not None:
                raise ValueError(f"linear codec {codec.name!r} returned "
                                 f"side scales; scales cannot be summed "
                                 f"in flight")
            if not groups:
                return (wire,), bstate
            if bucket.collective == REDUCE_SCATTER:
                wire = _pad(wire, codecs.padded_elems(wire.shape[0], p))
                # the allgather takes the reduce-scatter's shard: wait
                # for it here (on NCCL a stream wait)
                shard = comm.wait(be.reduce_scatter(wire, groups))
                return (comm.then(be.all_gather(shard, groups),
                                  lambda full: full[:bucket.n_elems]),), \
                    bstate
            return (be.all_reduce(wire, groups),), bstate
        # quantised: every worker has its own scale, so the wire cannot
        # be reduced in flight — allgather (values, scales)
        if not groups:
            return (codecs.sum_decoded(codec, wire, scale, 1,
                                       torch.float32),), bstate
        return (be.all_gather(wire, groups), be.all_gather(scale, groups),
                p), bstate

    def _finish_dense(self, stage: BucketStage, inflight: Tuple,
                      out: List[Any], inv_scale: Optional[float]) -> None:
        """Wait, decode-sum (gathered non-linear payloads) + unpack."""
        if len(inflight) == 3:
            g_wire, g_scale, n_chunks = inflight
            g_wire, g_scale = comm.wait(g_wire), comm.wait(g_scale)
            buf = self.config.codec_obj.reduce_hop(
                _telemetry.tap("collective", g_wire), g_scale, n_chunks,
                torch.float32)
        else:
            buf = _telemetry.tap("collective", comm.wait(inflight[0]))
        self.unpack_bucket(self.dense_buckets[stage.bucket_id], buf, out,
                           inv_scale)

    def _launch_gather(self, stage: BucketStage, leaves: List[Any],
                       groups: Tuple) -> Tuple:
        """Encode the accumulated IndexedSlices leaf's values and
        allgather (indices, wire[, scales]) through the backend.  Only
        the wire is narrow: decode happens at finish, before the
        scatter-add."""
        s = leaves[stage.bucket_id]
        be = self.config.backend_obj
        wire, scale = self.config.codec_obj.encode(s.values)
        wire = _telemetry.tap("pack", wire)
        rows = s.values.shape[0]
        if not groups:
            return (s.indices, wire, scale, rows)
        g_scales = (be.all_gather(scale, groups)
                    if scale is not None else None)
        return (be.all_gather(s.indices, groups),
                be.all_gather(wire, groups), g_scales, rows)

    def _finish_gather(self, stage: BucketStage, inflight: Tuple,
                       out: List[Any], inv_scale: Optional[float],
                       p: int) -> None:
        """Decode (each worker's chunk against its own scale), densify,
        restore the leaf dtype, apply averaging."""
        spec = self.leaf_specs[stage.bucket_id]
        codec = self.config.codec_obj
        dtype = comm.torch_dtype(spec.dtype)
        g_idx, g_wire, g_scales = (comm.wait(x) for x in inflight[:3])
        g_idx = _telemetry.tap("collective", g_idx)
        rows = inflight[3]
        if g_scales is None:
            g_vals = codec.decode(g_wire, None, dtype)
        else:
            per = g_wire.to(torch.float32).reshape(
                (p, rows) + tuple(g_wire.shape[1:]))
            per = per * g_scales.to(torch.float32).reshape(
                (p,) + (1,) * (per.dim() - 1))
            g_vals = per.reshape(g_wire.shape).to(dtype)
        g = IndexedSlices(g_idx, g_vals, spec.dense_shape)
        x = accumulation.densify(g, use_kernel=self.config.use_kernel)
        x = x.to(dtype)
        if inv_scale is not None:
            x = x * inv_scale
        out[stage.bucket_id] = x

    def launch_stage(self, stage: BucketStage, leaves: List[Any],
                     group: comm.Group, bstate: Any = ()
                     ) -> Tuple[Tuple, Any]:
        """Pack + issue one stage's collective(s) over ``group`` (a
        process group, a tuple of them, or None); returns ``(inflight,
        new bucket state)``: the payload ``finish_stage`` waits for and
        consumes.  A stage of several hops (reduce-scatter then
        allgather, the hierarchical per-hop reduction) waits here on all
        but its last."""
        groups = self._check_groups(group)
        with _stage_scope(self.stage_name(stage)):
            if stage.kind == "dense":
                return self._launch_dense(stage, leaves, groups,
                                          comm.axis_size(groups), bstate)
            return self._launch_gather(stage, leaves, groups), bstate

    def finish_stage(self, stage: BucketStage, inflight: Tuple,
                     out: List[Any], inv_scale: Optional[float],
                     p: int) -> None:
        """Unpack one launched stage into ``out`` (decode, densify
        gathers, restore dtypes, apply averaging).  Its ``collective``
        tap fires once the stage's collectives have been waited for (on
        the card: an event recorded after them on the stream)."""
        with _stage_scope(self.stage_name(stage)):
            if stage.kind == "dense":
                self._finish_dense(stage, inflight, out, inv_scale)
            else:
                self._finish_gather(stage, inflight, out, inv_scale, p)
            _tap_first("unpack", stage, out)

    def accumulate(self, grads) -> List[Any]:
        """Step 1 at run time: every leaf accumulated to the planned
        representation (dense leaves with sparse contributions come back
        ``_Pending``, densified later inside pack)."""
        return [_accumulate_leaf(leaf, spec, self.config)
                for leaf, spec in zip(self._flatten_checked(grads),
                                      self.leaf_specs)]

    def accumulate_tree(self, grads):
        """Step 1 as a public tree: dense-destined leaves densified (the
        densify kernel when ``config.use_kernel``), gather-destined
        leaves still IndexedSlices: the paper's per-variable
        accumulation before any collective."""
        out = [_materialise(x, self.config) if isinstance(x, _Pending)
               else x for x in self.accumulate(grads)]
        return tree_unflatten(self.treedef, out)

    def _flatten_checked(self, grads) -> List[Any]:
        leaves, treedef = tree_flatten(grads)
        if treedef != self.treedef:
            raise ValueError(f"grad tree structure changed: {treedef} "
                             f"!= planned {self.treedef}")
        return leaves

    def backward_block_stages(self, hooked_blocks=None
                              ) -> Tuple[Dict[str, Tuple[int, ...]],
                                         Tuple[int, ...]]:
        """Split the schedule for wait-free (in-backward) launch: returns
        ``(block -> stage indices, tail stage indices)``.  A stage is
        hookable when it is dense and every leaf it consumes lives in one
        top-level block (guaranteed by the block-aligned bucketing of
        ``overlap="backward"``) that is in ``hooked_blocks`` (``None`` =
        every labelled block).  Gather stages and stages of unhooked
        blocks form the tail, run after autograd returns.  Indices stay
        in schedule order, so they index ``ExchangeState.bucket_states``
        directly."""
        hooked: Dict[str, List[int]] = {}
        tail: List[int] = []
        for k, st in enumerate(self.schedule.stages):
            blocks = ({self.leaf_blocks[i] for i in st.leaf_ids}
                      if self.leaf_blocks else {""})
            b = blocks.pop() if len(blocks) == 1 else None
            if (st.kind == "dense" and b
                    and (hooked_blocks is None or b in hooked_blocks)):
                hooked.setdefault(b, []).append(k)
            else:
                tail.append(k)
        return ({k: tuple(v) for k, v in hooked.items()}, tuple(tail))

    def _accumulate_stage(self, stage: BucketStage, raw: List[Any],
                         acc: List[Any]) -> None:
        """Fold this stage's leaves to their classified representation
        (the per-stage part of the paper's step 1).  Its ``accumulate``
        tap fires for every stage, a leaf whose densification is deferred
        to pack included (the reference taps array leaves only)."""
        with _stage_scope(self.stage_name(stage)):
            for i in stage.leaf_ids:
                acc[i] = _accumulate_leaf(raw[i], self.leaf_specs[i],
                                          self.config)
            _tap_first("accumulate", stage, acc)

    def _exchange_setup(self, grads, group: comm.Group, average: bool,
                        state):
        state = self._check_state(state, grads)
        raw = self._flatten_checked(grads)
        groups = self._check_groups(group)
        p = comm.axis_size(groups)
        inv_scale = (1.0 / p) if average and groups else None
        return state, raw, p, inv_scale

    def execute(self, grads, group: comm.Group, average: bool = True,
                state: Optional[ExchangeState] = None
                ) -> Tuple[Any, ExchangeState]:
        """Accumulate, exchange, densify, honouring ``config.overlap``:
        any overlap mode takes ``execute_scheduled``, none
        ``execute_fused``.  Both run the same per-stage ops, so their
        results are bitwise equal."""
        self._check_not_zero1()
        if self.config.overlap:
            return self.execute_scheduled(grads, group, average=average,
                                          state=state)
        return self.execute_fused(grads, group, average=average,
                                  state=state)

    def execute_fused(self, grads, group: comm.Group,
                      average: bool = True,
                      state: Optional[ExchangeState] = None
                      ) -> Tuple[Any, ExchangeState]:
        """Serial path: each stage is accumulated, launched and finished
        before the next starts.  ``group=None`` is the local path (every
        collective a no-op, no averaging; the codec round trip still
        runs).  Returns ``(tree, new ExchangeState)``; ``state`` may be
        left out for a stateless codec.  Error-feedback residuals are
        updated in place."""
        self._check_not_zero1()
        state, raw, p, inv_scale = self._exchange_setup(grads, group,
                                                        average, state)
        acc: List[Any] = [None] * self.n_leaves
        out: List[Any] = [None] * self.n_leaves
        new_states: List[Any] = []
        for stage, bstate in zip(self.schedule.stages, state.bucket_states):
            self._accumulate_stage(stage, raw, acc)
            inflight, bstate = self.launch_stage(stage, acc, group, bstate)
            new_states.append(bstate)
            self.finish_stage(stage, inflight, out, inv_scale, p)
        return tree_unflatten(self.treedef, out), ExchangeState(new_states)

    def execute_scheduled(self, grads, group: comm.Group,
                          average: bool = True,
                          state: Optional[ExchangeState] = None
                          ) -> Tuple[Any, ExchangeState]:
        """Overlap path: stages launch in schedule (reverse-layer) order,
        each stage's accumulate and pack running while the earlier
        stages' collectives are in flight; the unpacks run once every
        collective has been issued.  Same arguments and result as
        ``execute_fused``."""
        self._check_not_zero1()
        state, raw, p, inv_scale = self._exchange_setup(grads, group,
                                                        average, state)
        acc: List[Any] = [None] * self.n_leaves
        inflight: List[Tuple] = []
        new_states: List[Any] = []
        for stage, bstate in zip(self.schedule.stages, state.bucket_states):
            self._accumulate_stage(stage, raw, acc)
            fl, bstate = self.launch_stage(stage, acc, group, bstate)
            inflight.append(fl)
            new_states.append(bstate)
        out: List[Any] = [None] * self.n_leaves
        for stage, fl in zip(self.schedule.stages, inflight):
            self.finish_stage(stage, fl, out, inv_scale, p)
        return tree_unflatten(self.treedef, out), ExchangeState(new_states)

    # -- broadcast (the serving hot swap) ------------------------------------
    def broadcast(self, tree, group: comm.Group, root: int = 0):
        """Broadcast a tree (refreshed serving weights) from worker
        ``root`` through the same buckets, codec and backend as the
        gradient exchange.  ``group=None`` is the local codec round trip.
        Needs an all-dense plan (compile with ``sparse_as_dense=True``)."""
        if self.gather_leaf_ids:
            raise ValueError("broadcast needs an all-dense plan; compile "
                             "with sparse_as_dense=True")
        leaves, treedef = tree_flatten(tree)
        if treedef != self.treedef:
            raise ValueError(f"tree structure changed: {treedef} "
                             f"!= planned {self.treedef}")
        groups = self._check_groups(group)
        out: List[Any] = list(leaves)
        for b_id in range(len(self.dense_buckets)):
            self.broadcast_bucket(b_id, leaves, out, groups, root=root)
        return tree_unflatten(self.treedef, out)

    def broadcast_bucket(self, b_id: int, leaves: List[Any],
                         out: List[Any], groups: Tuple,
                         root: int = 0) -> None:
        """One bucket of ``broadcast``: pack, encode (a non-linear codec),
        broadcast over ``groups`` (the checked tuple; ``()`` is local),
        decode, unpack into ``out``.  ``out``'s entries are replaced, the
        tensors they held are not written: the streaming unit of the
        serving hot swap (``serving.engine.HotSwapStream``)."""
        bucket = self.dense_buckets[b_id]
        codec = self.config.codec_obj
        be = self.config.backend_obj
        with _stage_scope(f"exchange/broadcast/bucket=dense{b_id}"):
            buf = self.pack_bucket(bucket, leaves)
            if codec.linear:
                if groups:
                    buf = comm.wait(be.broadcast(buf, groups, root=root))
            else:
                wire, scale = codec.encode(buf)
                if groups:
                    wire = comm.wait(be.broadcast(wire, groups, root=root))
                    scale = comm.wait(be.broadcast(scale, groups,
                                                   root=root))
                buf = codec.decode(wire, scale, "float32")
            self.unpack_bucket(bucket, buf, out, None)


    # -- ZeRO-1 execution (the exchange fused with the update) ---------------
    def _check_not_zero1(self) -> None:
        if self.config.zero1:
            raise ValueError(
                "zero1 plans fuse the exchange with the optimizer "
                "update (grad reduce-scatter -> shard update -> param "
                "allgather); there is no grads-only execute path — "
                "drive the plan through DistributedOptimizer.zero1_step")

    @staticmethod
    def worker_index(groups: Tuple) -> int:
        """This process's rank in its (one) process group: the dim-0
        chunk of a tiled reduce-scatter or allgather it owns (0 on the
        local path)."""
        return dist.get_rank(groups[0]) if groups else 0

    def zero1_launch_grad(self, stage: BucketStage, leaves: List[Any],
                          group: comm.Group, bstate) -> Tuple[Tuple, Any]:
        """The first half of the reference's ``zero1_grad_shard``, split so
        that every stage's collectives can be in flight before the first
        is finished.  Pack one dense stage, encode it and issue its grad
        collectives:
        a linear wire is padded to P x ``zero1_shard_elems`` and
        reduce-scattered (no grad allgather ever happens; the updated
        params ride back instead); a quantised wire is allgathered with
        its scales, as the replicated path does.  Returns ``(inflight,
        new bucket state)`` for ``zero1_finish_grad``."""
        with _stage_scope(self.stage_name(stage)):
            return self._zero1_launch_grad(stage, leaves, group, bstate)

    def _zero1_launch_grad(self, stage: BucketStage, leaves: List[Any],
                           group: comm.Group, bstate) -> Tuple[Tuple, Any]:
        groups = self._check_groups(group)
        p = comm.axis_size(groups)
        bucket = self.dense_buckets[stage.bucket_id]
        codec = self.config.codec_obj
        wire, scale, bstate = codec.encode_stateful(
            _telemetry.tap("pack", self.pack_bucket(bucket, leaves)), bstate)
        if codec.linear:
            if scale is not None:
                raise ValueError(
                    f"linear codec {codec.name!r} returned side scales; "
                    f"scales cannot be reduce-scattered")
            wire = _pad(wire, self.zero1_shard_elems(stage, p) * p)
            if not groups:
                return (wire,), bstate
            return (self.config.backend_obj.reduce_scatter(wire, groups),), \
                bstate
        if not groups:
            return (wire, scale, 1), bstate
        be = self.config.backend_obj
        return (be.all_gather(wire, groups), be.all_gather(scale, groups),
                p), bstate

    def zero1_finish_grad(self, stage: BucketStage, inflight: Tuple,
                          group: comm.Group,
                          inv_scale: Optional[float]) -> torch.Tensor:
        """This worker's flat f32 gradient shard of one dense stage
        (``zero1_shard_elems`` long, zero-padded tail): the reduce-
        scattered wire upcast, or, for a quantised wire, the decode-sum
        of the full bucket padded and sliced to this worker's chunk (so
        gradients and error-feedback residuals are the replicated
        path's), then averaged (f32 first, then ``* inv_scale``)."""
        with _stage_scope(self.stage_name(stage)):
            return self._zero1_finish_grad(stage, inflight, group,
                                           inv_scale)

    def _zero1_finish_grad(self, stage: BucketStage, inflight: Tuple,
                           group: comm.Group,
                           inv_scale: Optional[float]) -> torch.Tensor:
        groups = self._check_groups(group)
        p = comm.axis_size(groups)
        if len(inflight) == 1:
            shard = _telemetry.tap("collective",
                                   comm.wait(inflight[0])).to(torch.float32)
        else:
            g_wire, g_scale, n_chunks = inflight
            g_wire, g_scale = comm.wait(g_wire), comm.wait(g_scale)
            red = self.config.codec_obj.reduce_hop(
                _telemetry.tap("collective", g_wire), g_scale, n_chunks,
                torch.float32)
            n = self.zero1_shard_elems(stage, p)
            red = _pad(red, n * p)
            shard = red if red.shape[0] == n else red.narrow(
                0, self.worker_index(groups) * n, n).clone()
        if inv_scale is not None:
            shard = shard * inv_scale
        return shard

    def zero1_allgather_params(self, stage: BucketStage,
                               shard: torch.Tensor, out: List[Any],
                               group: comm.Group) -> None:
        """Broadcast one dense stage's UPDATED param shard to every worker
        through the (stateless) param codec and unpack the reassembled
        bucket into ``out``'s param leaves, each cast to its dtype.  A
        quantised param wire decodes each worker's chunk against that
        worker's own scale, as the gather path does; it never sums.  The
        param half bills to the same stage name as the grad half, so a
        stage's recorded wire totals its whole schedule."""
        groups = self._check_groups(group)
        p = comm.axis_size(groups)
        bucket = self.dense_buckets[stage.bucket_id]
        pc = self.config.param_codec_obj
        be = self.config.backend_obj
        with _stage_scope(self.stage_name(stage)):
            wire, scale = pc.encode(shard.to(torch.float32))
            if not groups:
                buf = pc.decode(wire, scale, torch.float32)
            elif pc.linear:
                buf = pc.decode(comm.wait(be.all_gather(wire, groups)),
                                None, torch.float32)
            else:
                g_wire = comm.wait(be.all_gather(wire, groups))
                g_scale = comm.wait(be.all_gather(scale, groups))
                per = g_wire.to(torch.float32).reshape(p, shard.shape[0])
                per = per * g_scale.to(torch.float32).reshape(p, 1)
                buf = per.reshape(-1)
            buf = _telemetry.tap("collective", buf)
            self.unpack_bucket(bucket, buf[:bucket.n_elems], out, None)
            _tap_first("unpack", stage, out)


def _pad(x: torch.Tensor, n: int) -> torch.Tensor:
    """``x`` (1-D) zero-padded to ``n`` elements; float8 buffers are
    padded through their bits."""
    pad = n - x.shape[0]
    if not pad:
        return x
    bits = comm._bits(x)
    return torch.cat([bits, bits.new_zeros(pad)]).view(x.dtype)


# ---------------------------------------------------------------------------
# Compilation + cache
# ---------------------------------------------------------------------------

_PLAN_CACHE: Dict[Any, ExchangePlan] = {}
_PLAN_CACHE_MAX = 256      # specs include sparse row counts, which vary
_CACHE_STATS = {"hits": 0, "misses": 0}

_FINGERPRINT_VERSION = "fp1"


def tree_fingerprint(treedef, contrib_specs, exact: bool = True) -> str:
    """Stable hex digest of a gradient-tree structure: the treedef and
    every contribution's shape and dtype.  It is the sha256 of a
    canonical ``repr`` (not Python's salted ``hash``), so it is the same
    across processes, and the treedef is rendered as ``jax.tree_util``
    renders the same tree (``treedef_str``), so the digest equals the
    reference package's for the same tree.

    ``exact=False`` sets every sparse row count (which follows the
    microbatch's token count) to 0: the structural fingerprint that keys
    the tuning artifact, so one tuned config covers every batch size of a
    model.  The plan cache keys on the exact digest, since plans bill
    wire bytes by the row."""
    if not exact:
        contrib_specs = tuple(
            tuple(dataclasses.replace(c, rows=0)
                  if isinstance(c, SparseSpec) else c for c in contribs)
            for contribs in contrib_specs)
    payload = repr((_FINGERPRINT_VERSION, exact, treedef_str(treedef),
                    contrib_specs))
    return hashlib.sha256(payload.encode()).hexdigest()[:16]


def fingerprint(grads, exact: bool = True) -> str:
    """``tree_fingerprint`` of a gradient tree (tensors on any device,
    ``meta`` included: only the structure matters)."""
    leaves, treedef = tree_flatten(grads)
    return tree_fingerprint(treedef, _contrib_specs(leaves), exact=exact)


def _leaf_tensors(leaf):
    if isinstance(leaf, list):
        for c in leaf:
            yield from _leaf_tensors(c)
    elif isinstance(leaf, IndexedSlices):
        yield leaf.values
    elif isinstance(leaf, torch.Tensor):
        yield leaf


def state_device(device, grads) -> torch.device:
    """Where codec state lives: ``device`` if given, else the device of
    the gradient leaves.  Raises ``ValueError`` when neither names a real
    device (no ``device`` and no leaves, leaves on several devices, or
    leaves on ``meta``): nothing falls back to the CPU."""
    if device is not None:
        return torch.device(device)
    leaves = tree_flatten(grads)[0] if grads is not None else []
    found = {t.device for leaf in leaves for t in _leaf_tensors(leaf)}
    if len(found) != 1:
        raise ValueError(f"codec state: pass device= (the gradient leaves "
                         f"are on {sorted(map(str, found)) or 'no device'})")
    (dev,) = found
    if dev.type == "meta":
        raise ValueError("codec state: the gradient leaves are on meta; "
                         "pass device= for the state")
    return dev


def _contrib_specs(leaves) -> Tuple[Tuple[LeafSpec, ...], ...]:
    return tuple(
        tuple(contribution_spec(c)
              for c in (leaf if isinstance(leaf, list) else [leaf]))
        for leaf in leaves)


def _build_plan(treedef, contrib_specs: Tuple[Tuple[LeafSpec, ...], ...],
                config: ExchangeConfig,
                leaf_blocks: Optional[Tuple[str, ...]] = None
                ) -> ExchangePlan:
    leaf_specs = tuple(classify(c, config) for c in contrib_specs)
    if leaf_blocks is None:
        leaf_blocks = ("",) * len(leaf_specs)
    dense_ids = tuple(i for i, s in enumerate(leaf_specs)
                      if isinstance(s, DenseSpec))
    gather_ids = tuple(i for i, s in enumerate(leaf_specs)
                       if isinstance(s, SparseSpec))

    # bucket dense leaves with the fusion planner, one group per codec
    # wire dtype, so packed buffers never promote and byte accounting is
    # exact; thresholds are in wire bytes (an int8 wire packs four times
    # the f32 elements per bucket).  Under overlap="backward" the groups
    # are also split by top-level block: a bucket that crossed blocks
    # could not launch until both blocks' gradients were emitted
    codec = config.codec_obj
    groups: Dict[Tuple[str, str], List[int]] = {}
    for i in dense_ids:
        block = leaf_blocks[i] if config.overlap_backward else ""
        groups.setdefault((block, codec.wire_dtype(leaf_specs[i].dtype)),
                          []).append(i)
    threshold = (config.fusion_threshold
                 if config.fusion_threshold is not None else 0)
    dense_ids = tuple(i for ids in groups.values() for i in ids)
    buckets = []
    base = 0
    for (_, dt), ids in groups.items():
        structs = [torch.empty(leaf_specs[i].shape, device="meta",
                               dtype=comm.torch_dtype(dt)) for i in ids]
        fplan = fusion.plan_fusion(structs, threshold_bytes=threshold)
        for bucket in fplan.buckets:
            slots = tuple(dataclasses.replace(s, leaf_idx=s.leaf_idx + base)
                          for s in bucket)
            buckets.append(DenseBucket(
                slots=slots, collective=config.dense_collective,
                n_elems=sum(s.size for s in slots), wire_dtype=dt))
        base += len(ids)

    stages = []
    for bi, b in enumerate(buckets):
        ids = tuple(dense_ids[s.leaf_idx] for s in b.slots)
        stages.append(BucketStage(kind="dense", bucket_id=bi, leaf_ids=ids,
                                  trigger=leaf_blocks[min(ids)]))
    stages += [BucketStage(kind="gather", bucket_id=gi, leaf_ids=(gi,),
                           trigger=leaf_blocks[gi]) for gi in gather_ids]
    stages.sort(key=lambda s: -s.ready_key)
    return ExchangePlan(treedef=treedef, contrib_specs=contrib_specs,
                        leaf_specs=leaf_specs, dense_leaf_ids=dense_ids,
                        dense_buckets=tuple(buckets),
                        gather_leaf_ids=gather_ids, config=config,
                        schedule=BucketSchedule(stages=tuple(stages)),
                        leaf_blocks=tuple(leaf_blocks))


def leaf_block_labels(grads) -> Tuple[str, ...]:
    """Top-level block label of every leaf, in flatten order
    (contribution lists are single leaves): the partition wait-free
    backprop snaps its buckets to.  A tree that is a single leaf has the
    label ``""``."""
    if not isinstance(grads, dict):
        return ("",) * len(tree_flatten(grads)[0])
    return tuple(str(key) for key in sorted(grads)
                 for _ in tree_flatten(grads[key])[0])


def compile_plan(grads, config: ExchangeConfig) -> ExchangePlan:
    """Compile (or fetch from cache) the ExchangePlan for a gradient
    tree.  Only the tree structure and the shapes/dtypes of its
    contributions matter, so ``meta`` tensors compile the same plan."""
    leaves, treedef = tree_flatten(grads)
    contrib_specs = _contrib_specs(leaves)
    key = (tree_fingerprint(treedef, contrib_specs), config)
    plan = _PLAN_CACHE.get(key)
    if plan is not None:
        _CACHE_STATS["hits"] += 1
        return plan
    _CACHE_STATS["misses"] += 1
    plan = _build_plan(treedef, contrib_specs, config,
                       leaf_blocks=leaf_block_labels(grads))
    if len(_PLAN_CACHE) >= _PLAN_CACHE_MAX:       # FIFO bound
        _PLAN_CACHE.pop(next(iter(_PLAN_CACHE)))
    _PLAN_CACHE[key] = plan
    return plan


def plan_cache_info() -> Dict[str, int]:
    """The plan cache's hits, misses and size since the last clear."""
    return dict(_CACHE_STATS, size=len(_PLAN_CACHE))


def clear_plan_cache() -> None:
    _PLAN_CACHE.clear()
    _CACHE_STATS["hits"] = _CACHE_STATS["misses"] = 0
