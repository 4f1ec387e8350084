"""ExchangePlan — one static collective schedule for accumulation, fusion
and cross-worker gradient exchange.

The torch counterpart of ``repro.core.exchange``, for the configuration
space this port carries: the identity wire codec and flat collectives
over one process group.  Per gradient-tree structure it compiles, once:

  1. **classify** every leaf's contribution list through the configured
     accumulation rule (paper Alg. 1 / Alg. 2 / the ``sparse_as_dense``
     Listing-1 pre-pass) to its post-accumulation representation;
  2. **bucket** dense leaves into Horovod-style fusion buffers
     (first-fit-decreasing) and give each sparse IndexedSlices leaf its
     own gather stage;
  3. a **BucketSchedule**: one stage per bucket, sorted reverse-layer
     (descending readiness key).

``execute_fused`` runs the stages serially: accumulate, pack (the
densification of deferred-sparse leaves happens here, through the
densify kernel when ``use_kernel`` is set), one allreduce or allgather,
unpack.  The plan is the single source of the byte accounting
(``wire_bytes`` / ``buffer_bytes`` / ``n_collectives``), which equals the
reference plan's for the same tree exactly.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import torch

from repro_torch.core import accumulation, comm, fusion
from repro_torch.core.indexed_slices import IndexedSlices, concat_slices
from repro_torch.tree import tree_flatten, tree_unflatten

ALLREDUCE = "allreduce"


@dataclasses.dataclass(frozen=True)
class ExchangeConfig:
    """Everything the planner needs to know, all static.  The wire codec
    is the identity and collectives are flat over one process group."""
    algorithm: str = "tf_algorithm1"         # paper Alg. 1 (TF upstream)
    sparse_as_dense: bool = False            # Horovod Listing-1 pre-pass
    fusion_threshold: Optional[int] = None   # bytes; None = bucket/leaf
    use_kernel: bool = False                 # densify through the kernel

    def __post_init__(self):
        if self.algorithm not in ("tf_algorithm1", "proposed_algorithm2"):
            raise ValueError(
                f"unknown accumulation algorithm: {self.algorithm}")


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

    # -- static accounting ---------------------------------------------------
    @property
    def n_leaves(self) -> int:
        return len(self.leaf_specs)

    @property
    def n_buckets(self) -> int:
        return len(self.dense_buckets) + len(self.gather_leaf_ids)

    @property
    def n_collectives(self) -> int:
        """Logical collective launches (P-independent): one allreduce per
        dense stage, one allgather per gather stage."""
        return self.schedule.n_stages

    def stage_wire_bytes(self, stage: BucketStage, n_workers: int) -> int:
        """Bytes one stage moves per worker."""
        if n_workers <= 1:
            return 0
        if stage.kind == "dense":
            b = self.dense_buckets[stage.bucket_id]
            return comm.allreduce_wire_bytes((b.n_elems,), b.wire_dtype,
                                             n_workers)
        return (n_workers - 1) * self._gather_payload_bytes(
            self.leaf_specs[stage.bucket_id])

    def _gather_payload_bytes(self, spec: SparseSpec) -> int:
        """Per-worker IndexedSlices payload (values + indices)."""
        return (spec.rows * spec.row_elems * comm.dtype_bytes(spec.dtype)
                + spec.rows * comm.dtype_bytes(spec.index_dtype))

    def wire_bytes(self, n_workers: int) -> int:
        """Bytes moved per worker per step (sum over the stages)."""
        return sum(self.stage_wire_bytes(s, n_workers)
                   for s in self.schedule.stages)

    def buffer_bytes(self, n_workers: int) -> int:
        """Size of the accumulated representation each worker holds after
        exchange (paper Fig. 3 / Fig. 5): gather buffers grow linearly in
        P, dense buffers are constant."""
        total = self.dense_bytes
        for i in self.gather_leaf_ids:
            s = self.leaf_specs[i]
            total += comm.gathered_buffer_bytes(
                s.rows, s.row_elems, s.dtype, n_workers,
                index_dtype=s.index_dtype)
        return total

    @property
    def dense_bytes(self) -> int:
        """Total dense accumulated gradient bytes (P-independent)."""
        return sum(comm.dense_buffer_bytes(self.leaf_specs[i].shape,
                                           self.leaf_specs[i].dtype)
                   for i in self.dense_leaf_ids)

    # -- execution -----------------------------------------------------------
    def pack_bucket(self, bucket: DenseBucket, leaves: List[Any]
                    ) -> torch.Tensor:
        """Fuse a bucket into one 1-D buffer in its wire dtype; deferred
        sparse slots are densified here."""
        wire = comm.torch_dtype(bucket.wire_dtype)
        parts = []
        for slot in bucket.slots:
            leaf_id = self.dense_leaf_ids[slot.leaf_idx]
            x = _materialise(leaves[leaf_id], self.config)
            parts.append(x.reshape(-1).to(wire))
        return parts[0] if len(parts) == 1 else torch.cat(parts)

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

    def launch_stage(self, stage: BucketStage, leaves: List[Any],
                     group: comm.Group) -> Tuple:
        """Pack + issue one stage's collective(s)."""
        if stage.kind == "dense":
            buf = self.pack_bucket(self.dense_buckets[stage.bucket_id],
                                   leaves)
            return (comm.all_reduce_dense(buf, group, average=False),)
        g = comm.all_gather_slices(leaves[stage.bucket_id], group)
        return (g.indices, g.values)

    def finish_stage(self, stage: BucketStage, inflight: Tuple,
                     out: List[Any], inv_scale: Optional[float]) -> None:
        """Unpack one launched stage into ``out`` (densify gathers,
        restore dtypes, apply averaging)."""
        if stage.kind == "dense":
            self.unpack_bucket(self.dense_buckets[stage.bucket_id],
                               inflight[0], out, inv_scale)
            return
        spec = self.leaf_specs[stage.bucket_id]
        dtype = comm.torch_dtype(spec.dtype)
        g_idx, g_vals = inflight
        g = IndexedSlices(g_idx, g_vals.to(dtype), spec.dense_shape)
        x = accumulation.densify(g, use_kernel=self.config.use_kernel)
        x = x.to(dtype)
        if inv_scale is not None:
            x = x * inv_scale
        out[stage.bucket_id] = x

    def _flatten_checked(self, grads) -> List[Any]:
        leaves, treedef = tree_flatten(grads)
        if treedef != self.treedef:
            raise ValueError(f"grad tree structure changed: {treedef} "
                             f"!= planned {self.treedef}")
        return leaves

    def execute_fused(self, grads, group: comm.Group,
                      average: bool = True):
        """Serial path: each stage is accumulated, launched and finished
        before the next starts.  ``group=None`` is the local path (every
        collective a no-op, no averaging)."""
        raw = self._flatten_checked(grads)
        p = comm.axis_size(group)
        inv_scale = (1.0 / p) if average and group is not None else None
        acc: List[Any] = [None] * self.n_leaves
        out: List[Any] = [None] * self.n_leaves
        for stage in self.schedule.stages:
            for i in stage.leaf_ids:
                acc[i] = _accumulate_leaf(raw[i], self.leaf_specs[i],
                                          self.config)
            inflight = self.launch_stage(stage, acc, group)
            self.finish_stage(stage, inflight, out, inv_scale)
        return tree_unflatten(self.treedef, out)


# ---------------------------------------------------------------------------
# Compilation + cache
# ---------------------------------------------------------------------------

_PLAN_CACHE: Dict[Any, ExchangePlan] = {}
_PLAN_CACHE_MAX = 256      # specs include sparse row counts, which vary


def _contrib_specs(leaves) -> Tuple[Tuple[LeafSpec, ...], ...]:
    return tuple(
        tuple(contribution_spec(c)
              for c in (leaf if isinstance(leaf, list) else [leaf]))
        for leaf in leaves)


def _build_plan(treedef, contrib_specs: Tuple[Tuple[LeafSpec, ...], ...],
                config: ExchangeConfig) -> ExchangePlan:
    leaf_specs = tuple(classify(c, config) for c in contrib_specs)
    dense_ids = tuple(i for i, s in enumerate(leaf_specs)
                      if isinstance(s, DenseSpec))
    gather_ids = tuple(i for i, s in enumerate(leaf_specs)
                       if isinstance(s, SparseSpec))

    # bucket dense leaves with the fusion planner, one group per wire
    # dtype, so packed buffers never promote and byte accounting is exact
    groups: Dict[str, List[int]] = {}
    for i in dense_ids:
        groups.setdefault(leaf_specs[i].dtype, []).append(i)
    threshold = (config.fusion_threshold
                 if config.fusion_threshold is not None else 0)
    dense_ids = tuple(i for ids in groups.values() for i in ids)
    buckets = []
    base = 0
    for dt, ids in groups.items():
        structs = [torch.empty(leaf_specs[i].shape, device="meta",
                               dtype=comm.torch_dtype(dt)) for i in ids]
        fplan = fusion.plan_fusion(structs, threshold_bytes=threshold)
        for bucket in fplan.buckets:
            slots = tuple(dataclasses.replace(s, leaf_idx=s.leaf_idx + base)
                          for s in bucket)
            buckets.append(DenseBucket(
                slots=slots, collective=ALLREDUCE,
                n_elems=sum(s.size for s in slots), wire_dtype=dt))
        base += len(ids)

    stages = [BucketStage(kind="dense", bucket_id=bi,
                          leaf_ids=tuple(dense_ids[s.leaf_idx]
                                         for s in b.slots))
              for bi, b in enumerate(buckets)]
    stages += [BucketStage(kind="gather", bucket_id=gi, leaf_ids=(gi,))
               for gi in gather_ids]
    stages.sort(key=lambda s: -s.ready_key)
    return ExchangePlan(treedef=treedef, contrib_specs=contrib_specs,
                        leaf_specs=leaf_specs, dense_leaf_ids=dense_ids,
                        dense_buckets=tuple(buckets),
                        gather_leaf_ids=gather_ids, config=config,
                        schedule=BucketSchedule(stages=tuple(stages)))


def compile_plan(grads, config: ExchangeConfig) -> ExchangePlan:
    """Compile (or fetch from cache) the ExchangePlan for a gradient
    tree.  Only the tree structure and the shapes/dtypes of its
    contributions matter, so ``meta`` tensors compile the same plan."""
    leaves, treedef = tree_flatten(grads)
    contrib_specs = _contrib_specs(leaves)
    key = (treedef, contrib_specs, config)
    plan = _PLAN_CACHE.get(key)
    if plan is None:
        plan = _build_plan(treedef, contrib_specs, config)
        if len(_PLAN_CACHE) >= _PLAN_CACHE_MAX:       # FIFO bound
            _PLAN_CACHE.pop(next(iter(_PLAN_CACHE)))
        _PLAN_CACHE[key] = plan
    return plan
