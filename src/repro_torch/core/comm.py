"""Cross-worker gradient exchange collectives on ``torch.distributed``.

The torch counterpart of ``repro.core.comm``: the paper's Horovod/MPI
collectives over a process group (NCCL on the card, gloo on the CPU).

  * Horovod allgather of IndexedSlices -> ``all_gather_slices``, the
    ``all_gather_dense`` of its indices and (encoded) values (message
    bytes grow linearly in worker count)
  * Horovod allreduce of dense tensors -> ``all_reduce_dense`` (constant
    in worker count — the paper's fix)

Every function takes ``group``: a ``torch.distributed`` process group, a
tuple of groups (one per mesh level, outermost first: the reference's
tuple of mesh axes, e.g. ``(cross_pod, within_pod)`` for its
``("pod", "data")``), or ``None`` for the local path, where each
collective is a no-op (the reference's ``axis_name=None``).
``axis_size`` of a tuple is the product of its sizes.  Collectives never
modify their inputs.
Each collective function counts its calls in ``<fn>.calls`` when it
issues the collective, the comm-layer audit of how many collectives a
step issued.  A collective over a group returns a ``Pending`` at once
(the work is in flight, its buffers held) and ``wait`` finishes it: the
fused exchange finishes each stage as soon as it is launched, the staged
and wait-free exchanges launch every stage's collective before any stage
unpacks.

Beyond the flat allreduce and allgather: ``reduce_scatter_dense``
(tiled over dim 0), ``two_level_all_reduce`` (one allreduce per level,
innermost first) and ``ring_shift``, one hop of a ring (send to the
next rank, receive from the previous one), which the ring schedule
(``ring_reduce_scatter``, ``ring_all_reduce``, ``ring_all_gather``) is
built from.  The process groups' backends refuse float8 tensors (gloo
says "Invalid scalar type"), so float8 buffers travel as their uint8 bit
patterns: an allgather moves the bytes as they are, and the allreduce and
reduce-scatter of a float8 buffer run the ring schedule on the bits,
adding after each hop as the reference adds float8 (widen to f32, add,
round back with its overflow rule, ``fp8_encode``); they count as one
call of the collective they stand for.

``*_bytes`` helpers give the exact wire size of each collective (static
functions of shapes), shared with the reference's accounting.  While a
``telemetry.hooks.WireRecorder`` is installed, every collective here
bills its per-worker wire bytes to the enclosing stage with the
reference's per-hop formula and kind (``all-reduce``, ``reduce-scatter``,
``all-gather``, and ``collective-permute`` for the ring); with none
installed the gate is one global read.
"""
from __future__ import annotations

import math
import warnings
from typing import Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

from repro_torch.core.indexed_slices import IndexedSlices
from repro_torch.telemetry import hooks as _telemetry

Group = Union[None, dist.ProcessGroup, Tuple[dist.ProcessGroup, ...]]

_DTYPES = {
    "float32": torch.float32, "float16": torch.float16,
    "bfloat16": torch.bfloat16, "float64": torch.float64,
    "int8": torch.int8, "uint8": torch.uint8, "int16": torch.int16,
    "int32": torch.int32, "int64": torch.int64, "bool": torch.bool,
    "float8_e4m3fn": torch.float8_e4m3fn, "float8_e5m2": torch.float8_e5m2,
}
_NAMES = {v: k for k, v in _DTYPES.items()}


def dtype_name(dtype: Union[str, torch.dtype]) -> str:
    """Canonical (numpy-style) name of a dtype, e.g. ``"bfloat16"``."""
    if isinstance(dtype, str):
        if dtype not in _DTYPES:
            raise ValueError(f"unknown dtype name {dtype!r}")
        return dtype
    return _NAMES[dtype]


def torch_dtype(name: Union[str, torch.dtype]) -> torch.dtype:
    return name if isinstance(name, torch.dtype) else _DTYPES[name]


def dtype_bytes(dtype) -> int:
    return torch_dtype(dtype).itemsize


def groups(group: Group) -> Tuple[dist.ProcessGroup, ...]:
    """``group`` as a tuple of process groups, outermost level first
    (``()`` for the local path)."""
    if group is None:
        return ()
    if isinstance(group, (tuple, list)):
        return tuple(group)
    return (group,)


def axis_size(group: Group) -> int:
    """Workers a collective over ``group`` spans: the product of the
    levels' sizes (1 on the local path)."""
    return math.prod(dist.get_world_size(g) for g in groups(group))


def _one(group: Group, what: str) -> dist.ProcessGroup:
    gs = groups(group)
    if len(gs) != 1:
        raise ValueError(f"{what} runs over one process group, got "
                         f"{len(gs)}")
    return gs[0]


# ---------------------------------------------------------------------------
# float8 on the wire: the reference's cast and add
# ---------------------------------------------------------------------------

#: per float8 dtype: the |x| past which the reference's cast overflows,
#: whether |x| equal to it overflows too (the tie rounds to the even
#: neighbour: 448 for e4m3fn, inf for e5m2), the magnitude byte it then
#: gives, and its NaN byte (the sign bit is kept in both)
FP8_OVERFLOW = {
    torch.float8_e4m3fn: (464.0, False, 0x7F, 0x7F),     # NaN: no inf
    torch.float8_e5m2: (61440.0, True, 0x7C, 0x7E),      # inf
}


def is_fp8(dtype) -> bool:
    return dtype in FP8_OVERFLOW


def fp8_encode(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Round ``x`` (any float dtype) to the float8 ``dtype`` as the
    reference does (``jnp.asarray(x).astype(dtype)``): round to nearest
    even, and past the largest finite value's rounding limit NaN for
    e4m3fn (which has no inf) and inf for e5m2, ±inf alike.  PyTorch's
    CPU cast saturates e4m3fn to ±448 instead (its CUDA cast does not,
    in the versions checked), which would turn an overflowed gradient
    into a finite one and hide it from the loss scaler's finiteness
    check; only its rounding inside the range is used."""
    limit, tie_over, over_byte, nan_byte = FP8_OVERFLOW[dtype]
    x32 = x.to(torch.float32)
    mag = x32.abs()
    over = (mag >= limit) if tie_over else (mag > limit)
    sign = (x32.view(torch.int32) < 0).to(torch.uint8) << 7
    bits = x32.to(dtype).view(torch.uint8)
    bits = torch.where(over, sign | over_byte, bits)
    bits = torch.where(torch.isnan(x32), sign | nan_byte, bits)
    return bits.view(dtype)


def fp8_add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a + b`` of two float8 tensors as the reference adds them: both
    widened to f32, added, and rounded back by ``fp8_encode``."""
    return fp8_encode(a.to(torch.float32) + b.to(torch.float32), a.dtype)


# ---------------------------------------------------------------------------
# Dense exchange (the paper's fix: accumulate by REDUCTION)
# ---------------------------------------------------------------------------

class Pending:
    """An issued collective: its work handle, the buffers it reads and
    writes (held until it finishes), and the step that turns its output
    into the result once the work is done."""

    __slots__ = ("_work", "_buffers", "_finish")

    def __init__(self, work, buffers, finish):
        self._work, self._buffers, self._finish = work, buffers, finish

    def wait(self) -> torch.Tensor:
        """Wait for the work (on the card: order the current stream after
        it) and return the result; the buffers are released."""
        self._work.wait()
        out = self._finish()
        self._work = self._buffers = self._finish = None
        return out


class _Works:
    """Several work handles waited on as one (a hop's send and
    receive); ``_Works(())`` is work already done."""

    __slots__ = ("_works",)

    def __init__(self, works):
        self._works = tuple(works)

    def wait(self) -> None:
        for w in self._works:
            w.wait()


def wait(x):
    """The result of ``x``: a ``Pending`` finished, anything else as it
    is (the local path's no-op collectives return their input)."""
    return x.wait() if isinstance(x, Pending) else x


def then(x, fn):
    """``fn`` of ``x``'s result: a ``Pending`` that applies ``fn`` when
    it is finished if ``x`` is one, else ``fn(x)`` at once."""
    if not isinstance(x, Pending):
        return fn(x)
    return Pending(_Works(()), (x,), lambda: fn(x.wait()))


def _bits(x: torch.Tensor) -> torch.Tensor:
    """A float8 tensor's uint8 bit patterns (the tensor itself for any
    other dtype): what the process groups' backends take."""
    return x.view(torch.uint8) if is_fp8(x.dtype) else x


def all_reduce_dense(x: torch.Tensor, group: Group, average: bool = True):
    """Dense allreduce across one group (Horovod allreduce), returned as
    a ``Pending``.  A float8 buffer runs the ring schedule on its bit
    patterns with the reference's float8 add (``fp8_add``)."""
    if group is None:
        return x
    g = _one(group, "all_reduce_dense")
    all_reduce_dense.calls += 1
    p = axis_size(g)
    if _telemetry.wire_recorder() is not None:
        _telemetry.record_collective("all-reduce", allreduce_wire_bytes(
            x.shape, x.dtype, p))
    if is_fp8(x.dtype):
        if average:
            raise ValueError("all_reduce_dense: a float8 sum is averaged "
                             "after it is decoded (average=False)")
        out = _ring_all_reduce(x, g, _shift)
        return Pending(_Works(()), (), lambda: out)
    out = x.clone()
    work = dist.all_reduce(out, group=g, async_op=True)
    finish = (lambda: out / p) if average else (lambda: out)
    return Pending(work, (x, out), finish)


def reduce_scatter_dense(x: torch.Tensor, group: Group,
                         average: bool = True):
    """Tiled reduce-scatter over dim 0 across one group: rank r receives
    the sum of chunk r of ``x``, whose length must be a multiple of the
    group's size (the caller pads).  Returned as a ``Pending``; a float8
    buffer runs the ring's reduce-scatter on its bits."""
    if group is None:
        return x
    g = _one(group, "reduce_scatter_dense")
    p = axis_size(g)
    if x.shape[0] % p:
        raise ValueError(f"reduce_scatter_dense: {x.shape[0]} rows do not "
                         f"split into {p} chunks (pad to a multiple)")
    reduce_scatter_dense.calls += 1
    if _telemetry.wire_recorder() is not None:
        _telemetry.record_collective(
            "reduce-scatter", reduce_scatter_wire_bytes(
                math.prod(x.shape), x.dtype, p))
    if is_fp8(x.dtype):
        if average:
            raise ValueError("reduce_scatter_dense: a float8 sum is "
                             "averaged after it is decoded (average=False)")
        out = _ring_reduce_scatter(x, g, _shift)
        return Pending(_Works(()), (), lambda: out)
    x = x.contiguous()
    out = torch.empty((x.shape[0] // p,) + tuple(x.shape[1:]),
                      dtype=x.dtype, device=x.device)
    with warnings.catch_warnings():      # gloo: "deprecated", runs it
        warnings.simplefilter("ignore")
        work = dist.reduce_scatter_tensor(out, x, group=g, async_op=True)
    finish = (lambda: out / p) if average else (lambda: out)
    return Pending(work, (x, out), finish)


def all_gather_dense(x: torch.Tensor, group: Group, bill: bool = True):
    """Tiled allgather over dim 0, in rank order, returned as a
    ``Pending``.  Over a tuple of groups one allgather per level,
    innermost first (the results telescope to the product's rank
    order); each level but the last is waited for before the next is
    issued.  Float8 buffers move as their bits.  ``bill=False`` leaves
    the wire recorder to the caller (``all_gather_slices`` bills its two
    tensors as one collective, as the reference does)."""
    gs = groups(group)
    if not gs:
        return x
    dtype = x.dtype
    x = _bits(x.contiguous())
    for k, g in enumerate(reversed(gs)):
        parts = [torch.empty_like(x) for _ in range(axis_size(g))]
        if bill and _telemetry.wire_recorder() is not None:
            # per-level billing telescopes to (P-1) * the original bytes
            _telemetry.record_collective(
                "all-gather", (len(parts) - 1) * x.numel()
                * x.element_size())
        work = dist.all_gather(parts, x, group=g, async_op=True)
        all_gather_dense.calls += 1
        pending = Pending(work, (x, parts),
                          lambda parts=parts: torch.cat(parts).view(dtype))
        if k == len(gs) - 1:
            return pending
        x = _bits(pending.wait())


def all_gather_slices(s: IndexedSlices, group: Group) -> IndexedSlices:
    """Allgather of IndexedSlices (Horovod's sparse path): indices and
    values through ``all_gather_dense``, one level at a time, innermost
    first.  The output has ``P * n`` rows in rank order: the
    linear-in-worker-count growth behind the paper's 11.4 GB buffers at
    64 workers.  Each level bills one ``all-gather`` of
    ``(p - 1) * (index + value bytes)`` to the wire recorder."""
    gs = groups(group)
    if not gs:
        return s
    indices, values = s.indices, s.values
    for g in reversed(gs):
        if _telemetry.wire_recorder() is not None:
            _telemetry.record_collective(
                "all-gather", (axis_size(g) - 1)
                * (indices.numel() * indices.element_size()
                   + values.numel() * values.element_size()))
        g_idx = all_gather_dense(indices, (g,), bill=False)
        g_val = all_gather_dense(values, (g,), bill=False)
        indices, values = wait(g_idx), wait(g_val)
    return IndexedSlices(indices=indices, values=values,
                         dense_shape=s.dense_shape)


def two_level_all_reduce(x: torch.Tensor, group: Group,
                         average: bool = True):
    """Hierarchical allreduce: one ``all_reduce_dense`` per level,
    innermost first (within-pod, then cross-pod, for ``(cross_pod,
    within_pod)``), each level but the last waited for before the next
    is issued (on NCCL the wait orders the stream, the host goes on).
    Returned as a ``Pending``.  Each level's ``all_reduce_dense`` bills
    its own hop, as the reference bills one psum per axis."""
    gs = groups(group)
    if not gs:
        return x
    two_level_all_reduce.calls += 1
    p = axis_size(gs)
    for k, g in enumerate(reversed(gs)):
        pending = all_reduce_dense(x, g, average=False)
        if k == len(gs) - 1:
            break
        x = pending.wait()
    if not average:
        return pending
    return Pending(_Works(()), (), lambda: pending.wait() / p)


# ---------------------------------------------------------------------------
# The ring (send/recv hops), in the reference ring simulation's chunk order
# ---------------------------------------------------------------------------

def _shift(x: torch.Tensor, group: dist.ProcessGroup) -> Pending:
    """One hop: send ``x`` to the next rank of ``group`` and receive the
    previous rank's tensor of the same shape."""
    p, r = dist.get_world_size(group), dist.get_rank(group)
    nxt = dist.get_global_rank(group, (r + 1) % p)
    prv = dist.get_global_rank(group, (r - 1) % p)
    x = x.contiguous()
    buf = torch.empty_like(x)
    works = dist.batch_isend_irecv([
        dist.P2POp(dist.isend, _bits(x), nxt, group=group),
        dist.P2POp(dist.irecv, _bits(buf), prv, group=group)])
    return Pending(_Works(works), (x, buf), lambda: buf)


def ring_shift(x: torch.Tensor, group: Group) -> Pending:
    """One hop of a ring over one group (send to rank r+1, receive from
    rank r-1), returned as a ``Pending``."""
    ring_shift.calls += 1
    return _shift(x, _one(group, "ring_shift"))


def _adder(dtype):
    """The ring's add for buffers of ``dtype``; float8 buffers travel as
    their bits, so their add takes and gives bits."""
    if not is_fp8(dtype):
        return torch.add
    return lambda a, b: fp8_add(a.view(dtype), b.view(dtype)).view(
        torch.uint8)


def _ring_chunks(x: torch.Tensor, p: int) -> torch.Tensor:
    """``x`` zero-padded to a multiple of ``p`` rows as ``(p, chunk)``."""
    n = x.shape[0]
    chunk = -(-n // p)
    if p * chunk != n:
        x = torch.cat([x, x.new_zeros(p * chunk - n)])
    return x.reshape(p, chunk)


def _rs_phase(x, group, start_offset: int, hop):
    """P-1 hops; rank r ends holding the full sum of chunk ``(r +
    start_offset - (p-1)) % p``, each hop adding its own chunk to the
    one it received (``received + own``).  Works on ``_bits(x)``."""
    p, r = dist.get_world_size(group), dist.get_rank(group)
    add = _adder(x.dtype)
    xp = _ring_chunks(_bits(x), p)
    cur = xp[(r + start_offset) % p]
    for s in range(1, p):
        cur = add(hop(cur, group).wait(), xp[(r + start_offset - s) % p])
    return xp, cur, r, p


def _ring_all_reduce(x, group, hop):
    if dist.get_world_size(group) == 1:
        return x
    n = x.shape[0]
    xp, cur, r, p = _rs_phase(x, group, 0, hop)
    # rank r now owns chunk (r + 1) % p; circulate every chunk back
    out = torch.empty_like(xp)
    out[(r + 1) % p] = cur
    for s in range(1, p):
        cur = hop(cur, group).wait()
        out[(r + 1 - s) % p] = cur
    return out.reshape(-1)[:n].view(x.dtype)


def _ring_reduce_scatter(x, group, hop):
    if dist.get_world_size(group) == 1:
        return x
    # start at r - 1 so rank r ends owning chunk r (the tiled order)
    return _rs_phase(x, group, -1, hop)[1].view(x.dtype)


def ring_all_reduce(x: torch.Tensor, group: Group) -> torch.Tensor:
    """The literal ring allreduce of a flat buffer over one group: P-1
    reduce-scatter hops, then P-1 allgather hops, each moving one 1/P
    chunk (``x`` zero-padded to a multiple of P), as the reference's
    ring simulation orders them, so every rank sums in its order.  No
    hop at P = 1.  Returns the sum (float8 added as the reference adds
    it)."""
    g = _one(group, "ring_all_reduce")
    p = dist.get_world_size(g)
    if p > 1 and _telemetry.wire_recorder() is not None:
        _telemetry.record_collective(
            "collective-permute",
            2 * (p - 1) * -(-x.shape[0] // p) * x.element_size())
    return _ring_all_reduce(x, g, ring_shift)


def ring_reduce_scatter(x: torch.Tensor, group: Group) -> torch.Tensor:
    """The ring's P-1 reduce-scatter hops: rank r returns the sum of
    chunk r of ``x`` (whose length the caller pads to a multiple of
    P)."""
    g = _one(group, "ring_reduce_scatter")
    p = dist.get_world_size(g)
    if p > 1 and _telemetry.wire_recorder() is not None:
        _telemetry.record_collective(
            "collective-permute",
            (p - 1) * -(-x.shape[0] // p) * x.element_size())
    return _ring_reduce_scatter(x, g, ring_shift)


def ring_all_gather(x: torch.Tensor, group: Group) -> torch.Tensor:
    """The ring's P-1 allgather hops: every rank's ``x`` concatenated
    over dim 0 in rank order."""
    g = _one(group, "ring_all_gather")
    p, r = dist.get_world_size(g), dist.get_rank(g)
    if p == 1:
        return x
    if _telemetry.wire_recorder() is not None:
        _telemetry.record_collective(
            "collective-permute", (p - 1) * x.numel() * x.element_size())
    bits = _bits(x)
    parts = bits.new_empty((p,) + tuple(x.shape))
    parts[r] = bits
    cur = bits
    for s in range(1, p):
        cur = ring_shift(cur, g).wait()
        parts[(r - s) % p] = cur
    return parts.reshape((p * x.shape[0],) + tuple(x.shape[1:])).view(
        x.dtype)


all_reduce_dense.calls = 0
reduce_scatter_dense.calls = 0
all_gather_dense.calls = 0
two_level_all_reduce.calls = 0
ring_shift.calls = 0

#: every collective function's call counter, by name
COUNTED = (all_reduce_dense, reduce_scatter_dense, all_gather_dense,
           two_level_all_reduce, ring_shift)


def reset_calls() -> None:
    """Set every collective function's call counter to 0."""
    for fn in COUNTED:
        fn.calls = 0


def calls() -> dict:
    """Every collective function's call counter, by name."""
    return {fn.__name__: fn.calls for fn in COUNTED}


# ---------------------------------------------------------------------------
# Wire-size accounting (static), the reference's formulas
# ---------------------------------------------------------------------------

def allreduce_wire_bytes(shape: Sequence[int], dtype, n_workers: int) -> int:
    """Bytes moved per worker by a ring allreduce: 2 (P-1)/P * size."""
    size = math.prod(shape) * dtype_bytes(dtype)
    if n_workers <= 1:
        return 0
    return int(2 * (n_workers - 1) / n_workers * size)


def allgather_wire_bytes(rows: int, row_elems: int, dtype, n_workers: int,
                         index_dtype="int32") -> int:
    """Bytes moved per worker by an allgather of IndexedSlices: every
    worker receives the other P-1 workers' rows (values + indices)."""
    if n_workers <= 1:
        return 0
    per_worker = rows * (row_elems * dtype_bytes(dtype)
                         + dtype_bytes(index_dtype))
    return int((n_workers - 1) * per_worker)


def reduce_scatter_wire_bytes(n_elems: int, dtype, n_workers: int) -> int:
    """Bytes moved per worker by a tiled reduce-scatter of an
    ``n_elems``-element buffer (padded to a multiple of P)."""
    if n_workers <= 1:
        return 0
    padded = -(-n_elems // n_workers) * n_workers
    return int((n_workers - 1) / n_workers * padded * dtype_bytes(dtype))


def allgather_dense_wire_bytes(n_elems: int, dtype, n_workers: int) -> int:
    """Bytes moved per worker by a tiled allgather re-assembling an
    ``n_elems``-element buffer from its ``1/P`` shards."""
    return reduce_scatter_wire_bytes(n_elems, dtype, n_workers)


def hierarchical_allreduce_wire_bytes(shape: Sequence[int], dtype,
                                      level_sizes: Sequence[int]) -> int:
    """Bytes moved per worker by a per-level allreduce: one ring
    allreduce of the full buffer per level."""
    return sum(allreduce_wire_bytes(shape, dtype, p) for p in level_sizes)


def gathered_buffer_bytes(rows: int, row_elems: int, dtype, n_workers: int,
                          index_dtype="int32") -> int:
    """Size of the accumulated IndexedSlices buffer each worker holds
    after the gather (paper Fig. 3a / Fig. 5)."""
    per_worker = rows * (row_elems * dtype_bytes(dtype)
                         + dtype_bytes(index_dtype))
    return int(n_workers * per_worker)


def dense_buffer_bytes(shape: Sequence[int], dtype) -> int:
    """Size of the dense accumulated tensor (constant in worker count)."""
    return int(math.prod(shape) * dtype_bytes(dtype))
