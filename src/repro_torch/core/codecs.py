"""WireCodec — pluggable gradient wire formats, with explicit state.

The torch counterpart of ``repro.core.codecs``, where each rank is its
own process:

    init_state(plan, device=) -> ExchangeState (one entry per stage)
    encode(buf)               -> (wire values, optional side scales)
    encode_stateful(buf, st)  -> (wire, scales, new bucket state)
    encode_hop(buf, st, k)    -> hop-k encode (k=0 consumes the state)
    requantize(buf)           -> stateless re-encode between mesh levels
    reduce_hop(gathered, …)   -> decode + sum one hop's gathered payloads
    decode(wire, scale, …)    -> buf in the native dtype
    wire_bytes(n_elems)       -> exact encoded payload size

with a registry so codecs resolve by name (``get_codec("int8+ef")``).

Codecs come in two families the exchange must distinguish:

  * **linear** codecs (identity, bf16/f16 casts): the encoded buffer can
    be summed by the collective itself (an allreduce of the bf16 buffer);
  * **non-linear** codecs (int8 + per-bucket absmax scale): workers
    quantise against their own scale, so the plan allgathers (values,
    scales) and sums after decode (``sum_decoded``).  On the
    hierarchical backend it runs one (encode -> gather -> ``reduce_hop``)
    round per mesh level, re-encoding the partial sums with
    ``requantize`` between levels.

And in two statefulness families:

  * **stateless** codecs: the base-class defaults are the zero-state
    adapter — ``init_bucket_state`` returns ``()`` and
    ``encode_stateful`` passes the state through;
  * **stateful** codecs: ``ErrorFeedbackCodec`` wraps a stateless codec
    and keeps one f32 residual per dense fusion buffer (registry names
    take an ``+ef`` suffix).

``Int8Codec`` quantises through ``repro_torch.kernels.ops.quantize_int8``
(``quantize_int8_ef`` under error feedback, which takes the residual's
add and subtraction in; a requantize takes the stateless encode) and
sums gathered payloads through ``ops.int8_decode_sum``: the CUDA kernels
for CUDA tensors, their plain versions for CPU tensors.

The fp8 cast codecs (``f8e4m3``, ``f8e5m2``) round as the reference's
cast does, NaN past e4m3fn's range (``comm.fp8_encode``), not as
PyTorch's saturating cast; their buffers cross the process groups as
uint8 bit patterns (``repro_torch.core.comm``).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import comm
from repro_torch.kernels import ops

#: suffix marking an ErrorFeedback-wrapped codec in the registry
EF_SUFFIX = "+ef"

_DTYPE_ALIASES = {"bf16": "bfloat16", "f32": "float32", "fp32": "float32",
                  "f16": "float16", "fp16": "float16",
                  "f8e4m3": "float8_e4m3fn", "fp8e4m3": "float8_e4m3fn",
                  "f8e5m2": "float8_e5m2", "fp8e5m2": "float8_e5m2"}


def canonical_dtype(name) -> Optional[str]:
    """Normalise a dtype spec (``"bf16"``, ``torch.bfloat16``, a numpy
    dtype name such as ``"f4"``) to its canonical numpy name, or None."""
    if name is None:
        return None
    if isinstance(name, torch.dtype):
        return comm.dtype_name(name)
    if isinstance(name, str) and name in _DTYPE_ALIASES:
        name = _DTYPE_ALIASES[name]
    if isinstance(name, str) and name in comm._DTYPES:
        return name
    try:
        out = np.dtype(name).name
    except TypeError:
        out = None
    if out not in comm._DTYPES:
        raise ValueError(f"unknown wire dtype {name!r} (try 'bf16', "
                         f"'f16', or any numpy dtype name)")
    return out


class ExchangeState:
    """Codec state for one ExchangePlan: one entry per
    ``plan.schedule.stages`` (same order) — ``()`` for zero-state
    stages, a flat f32 residual tensor on the worker's device for
    ErrorFeedback dense buckets, which each exchange updates in place.
    Each rank holds its own."""

    __slots__ = ("bucket_states",)

    def __init__(self, bucket_states):
        self.bucket_states = tuple(bucket_states)

    @property
    def n_stages(self) -> int:
        return len(self.bucket_states)

    def __repr__(self):
        kinds = ["-" if isinstance(s, tuple) and not s
                 else tuple(s.shape) for s in self.bucket_states]
        return f"ExchangeState({kinds})"


class WireCodec:
    """Protocol for wire formats.  Subclass and ``register_codec``.

    The stateful methods default to the ZERO-STATE ADAPTER (empty state,
    pass-through), so stateless codecs ride the stateful exchange path
    unchanged."""

    #: registry name
    name: str = "abstract"
    #: True when the encoded buffer may be summed by the collective
    #: directly; False forces the allgather + decode-sum path
    linear: bool = True
    #: bytes of side-tensor (scales) per encoded buffer
    scale_bytes: int = 0
    #: True when the codec carries per-bucket memory across steps
    stateful: bool = False
    #: cost metadata for the cost model (``repro_torch.tuning.cost``):
    #: full-precision memory passes over the bucket per encode + decode
    #: round (0 = free pass-through, 1 = one narrowing cast, 2 = scale
    #: + quantise and decode + sum), billed against the profile's
    #: ``hbm_bw`` once per requantize round
    cost_passes: float = 0.0

    def wire_dtype(self, native_dtype: str) -> str:
        """Dtype of the encoded values buffer."""
        raise NotImplementedError

    def encode(self, buf: torch.Tensor
               ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """buf -> (wire values, side scales or None)."""
        raise NotImplementedError

    def decode(self, wire: torch.Tensor, scale: Optional[torch.Tensor],
               native_dtype) -> torch.Tensor:
        """Invert ``encode`` back to ``native_dtype``."""
        raise NotImplementedError

    def wire_bytes(self, n_elems: int, native_dtype="float32") -> int:
        """Exact payload bytes (values + side scales) for ``n_elems``."""
        return (n_elems * comm.dtype_bytes(self.wire_dtype(native_dtype))
                + self.scale_bytes)

    # -- stateful protocol (defaults = the zero-state adapter) --------------
    def init_bucket_state(self, n_elems: int, kind: str = "dense", *,
                          device) -> Any:
        """Initial state for one schedule stage on ``device`` (required:
        state beside CUDA gradients must not land on the CPU by default);
        ``()`` = no state."""
        del n_elems, kind, device
        return ()

    def init_state(self, plan, *, device) -> ExchangeState:
        """One ``init_bucket_state`` entry per schedule stage, each sized
        for this worker alone (every rank is its own process, so the
        reference's ``shard_map`` global view has no counterpart)."""
        return ExchangeState([
            self.init_bucket_state(plan.stage_n_elems(stage),
                                   kind=stage.kind, device=device)
            for stage in plan.schedule.stages])

    def state_bytes(self, n_elems: int, kind: str = "dense") -> int:
        """Per-worker codec-state memory for one stage (accounting)."""
        del n_elems, kind
        return 0

    def encode_stateful(self, buf: torch.Tensor, state: Any
                        ) -> Tuple[torch.Tensor, Optional[torch.Tensor],
                                   Any]:
        """``(wire, scales, new state)``; by default the stateless
        ``encode`` with the state passed through untouched."""
        wire, scale = self.encode(buf)
        return wire, scale, state

    def requantize(self, buf: torch.Tensor
                   ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """Re-encode a partially reduced buffer between mesh levels (the
        hierarchical per-hop path).  Stateless by construction: the
        error of hop > 0 is the same on every worker of the reduced
        group, so it must not enter a worker's own feedback state."""
        return self.encode(buf)

    def encode_hop(self, buf: torch.Tensor, state: Any, level: int
                   ) -> Tuple[torch.Tensor, Optional[torch.Tensor], Any]:
        """Hop-``level`` encode of the hierarchical reduction: level 0 is
        the worker's own encode (consumes and updates the state), later
        levels requantize the partial sums statelessly."""
        if level == 0:
            return self.encode_stateful(buf, state)
        wire, scale = self.requantize(buf)
        return wire, scale, state

    def reduce_hop(self, gathered_wire: torch.Tensor,
                   gathered_scales: Optional[torch.Tensor], n_chunks: int,
                   native_dtype) -> torch.Tensor:
        """Decode one hop's ``n_chunks`` gathered payloads and sum them
        (the per-level reduction of the hierarchical path)."""
        return sum_decoded(self, gathered_wire, gathered_scales, n_chunks,
                           native_dtype)

    def __repr__(self):
        return f"{type(self).__name__}({self.name!r})"


class IdentityCodec(WireCodec):
    """No-op wire: native dtype straight onto the collective."""

    name = "identity"
    linear = True

    def wire_dtype(self, native_dtype: str) -> str:
        return comm.dtype_name(native_dtype)

    def encode(self, buf):
        return buf, None

    def decode(self, wire, scale, native_dtype):
        return wire.to(comm.torch_dtype(native_dtype))


class CastCodec(WireCodec):
    """Downcast on encode, upcast on decode (Ott et al. 2018 fp16
    wire).  A float8 target rounds as the reference's cast does
    (``comm.fp8_encode``)."""

    linear = True
    cost_passes = 1.0        # one narrowing cast + one widening cast

    def __init__(self, target_dtype, name: Optional[str] = None):
        self.target = canonical_dtype(target_dtype)
        self.name = name or self.target

    def wire_dtype(self, native_dtype: str) -> str:
        return self.target

    def encode(self, buf):
        dt = comm.torch_dtype(self.target)
        if comm.is_fp8(dt) and buf.dtype != dt:
            return comm.fp8_encode(buf, dt), None
        return buf.to(dt), None

    def decode(self, wire, scale, native_dtype):
        return wire.to(comm.torch_dtype(native_dtype))


class Int8Codec(WireCodec):
    """int8 values + one f32 absmax scale per buffer.

    ``q = clip(round(x * (1 / scale)), -127, 127)`` with
    ``scale = max(absmax(x), 1e-30) / 127``: the round-trip error is at
    most ``scale / 2`` per element.  Non-linear: each worker's scale
    differs, so the exchange allgathers (values, scales) and sums after
    decode.
    """

    name = "int8"
    linear = False
    scale_bytes = 4          # one f32 scale per bucket
    cost_passes = 2.0        # absmax + quantise, then decode + sum
    QMAX = 127.0

    def wire_dtype(self, native_dtype: str) -> str:
        return "int8"

    def encode(self, buf):
        q, scale = ops.quantize_int8(buf)
        return q.reshape(buf.shape), scale

    def encode_ef(self, buf, residual):
        """The error-feedback encode in one call: ``(q, scale)`` of
        ``buf + residual``, and the round trip's error left in
        ``residual`` (flat f32, updated in place)."""
        return ops.quantize_int8_ef(buf, residual)

    def decode(self, wire, scale, native_dtype):
        out = wire.to(torch.float32) * scale.to(torch.float32)
        return out.to(comm.torch_dtype(native_dtype))

    def max_error(self, buf) -> float:
        """Per-element round-trip bound for a concrete buffer (tests)."""
        absmax = float(buf.abs().max()) if buf.numel() else 0.0
        return absmax / self.QMAX / 2 + 1e-12


class ErrorFeedbackCodec(WireCodec):
    """Wrap a stateless codec with per-bucket quantisation-error memory
    (EF-SGD / 1-bit-Adam construction).

    Each step encodes ``compensated = grad + residual`` through the inner
    codec and keeps ``compensated - decode(encode(compensated))`` as the
    next step's residual.  State lives per DENSE fusion bucket (one flat
    f32 residual of the bucket's ``n_elems``); gather stages stay
    zero-state, since their rows change identity every step.  Linearity,
    wire dtype and scale accounting delegate to the inner codec; the
    residual adds no wire bytes.
    """

    stateful = True

    def __init__(self, inner: WireCodec):
        if inner.stateful:
            raise ValueError(f"cannot stack error feedback on the "
                             f"already-stateful codec {inner.name!r}")
        self.inner = inner
        self.name = inner.name + EF_SUFFIX
        self.linear = inner.linear
        self.scale_bytes = inner.scale_bytes
        # residual add + round-trip error bank, on top of the inner wire
        self.cost_passes = inner.cost_passes + 2.0

    def wire_dtype(self, native_dtype: str) -> str:
        return self.inner.wire_dtype(native_dtype)

    # stateless encodes (gather stages) delegate inward
    def encode(self, buf):
        return self.inner.encode(buf)

    def decode(self, wire, scale, native_dtype):
        return self.inner.decode(wire, scale, native_dtype)

    def init_bucket_state(self, n_elems: int, kind: str = "dense", *,
                          device):
        if kind != "dense":
            return ()
        return torch.zeros((n_elems,), dtype=torch.float32, device=device)

    def state_bytes(self, n_elems: int, kind: str = "dense") -> int:
        return 4 * n_elems if kind == "dense" else 0

    def encode_stateful(self, buf, state):
        """Updates the residual tensor in place and returns it, so one
        residual per bucket is alive at any time."""
        if isinstance(state, tuple) and not state:   # zero-state stage
            wire, scale = self.inner.encode(buf)
            return wire, scale, state
        if isinstance(self.inner, Int8Codec):
            wire, scale = self.inner.encode_ef(buf, state)
            return wire, scale, state
        state.add_(buf)                      # compensated = grad + residual
        wire, scale = self.inner.encode(state)
        if wire.data_ptr() == state.data_ptr():      # identity's wire
            wire = wire.clone()
        state.sub_(self.inner.decode(wire, scale, torch.float32)
                   .reshape(state.shape))
        return wire, scale, state

    def max_error(self, buf) -> float:
        return self.inner.max_error(buf)


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_CODECS: Dict[str, WireCodec] = {}

#: lazily built ErrorFeedback wrappers, keyed by full "<inner>+ef" name,
#: kept out of _CODECS so ``available_codecs()`` stays the base list
_EF_CACHE: Dict[str, WireCodec] = {}


def register_codec(codec: WireCodec, name: Optional[str] = None) -> None:
    key = name or codec.name
    _CODECS[key] = codec
    # a cached "<name>+ef" wrapper would keep encoding with the codec
    # this call just replaced
    _EF_CACHE.pop(key + EF_SUFFIX, None)


register_codec(IdentityCodec())
register_codec(CastCodec("bfloat16", name="bf16"))
register_codec(CastCodec("float16", name="f16"))
register_codec(Int8Codec())
# fp8 wires on the cast-codec path: e4m3 (3 mantissa bits, range ±448)
# and e5m2 (2 mantissa bits, range ±57344); linear, so the encoded
# buffer sums in flight
register_codec(CastCodec("float8_e4m3fn", name="f8e4m3"))
register_codec(CastCodec("float8_e5m2", name="f8e5m2"))


def available_codecs() -> Tuple[str, ...]:
    return tuple(sorted(_CODECS))


def get_codec(name) -> WireCodec:
    """Resolve a codec by registry name.

    Dtype names (``"bfloat16"``, ``"float16"``, ...) resolve to a
    ``CastCodec``, so the deprecated ``wire_dtype=`` spelling takes any
    dtype name the port knows.  An ``+ef`` suffix wraps the named codec
    in ``ErrorFeedbackCodec`` (cached, so repeated lookups share one
    instance and one plan-cache identity).
    """
    if isinstance(name, WireCodec):
        return name
    if name is None:
        return _CODECS["identity"]
    if isinstance(name, str) and name.endswith(EF_SUFFIX):
        if name not in _EF_CACHE:
            _EF_CACHE[name] = ErrorFeedbackCodec(
                get_codec(name[:-len(EF_SUFFIX)]))
        return _EF_CACHE[name]
    if name in _CODECS:
        return _CODECS[name]
    try:
        dt = canonical_dtype(name)
    except ValueError:
        raise ValueError(f"unknown codec {name!r} (registered: "
                         f"{', '.join(available_codecs())}, each with an "
                         f"optional {EF_SUFFIX!r} suffix, or a dtype "
                         f"name)") from None
    if dt in _CODECS:
        return _CODECS[dt]
    for c in _CODECS.values():
        if isinstance(c, CastCodec) and c.target == dt:
            return c
    codec = IdentityCodec() if dt == "float32" else CastCodec(dt)
    register_codec(codec, name=dt)
    return codec


def codec_name_for_wire_dtype(wire_dtype) -> str:
    """Map the deprecated ``wire_dtype`` flag onto a codec name."""
    dt = canonical_dtype(wire_dtype)
    if dt is None or dt == "float32":
        return "identity"
    for name, c in _CODECS.items():
        if isinstance(c, CastCodec) and c.target == dt:
            return name
    get_codec(dt)
    return dt


def is_int8(codec: WireCodec) -> bool:
    """True for the int8 wire, with or without error feedback."""
    return isinstance(getattr(codec, "inner", codec), Int8Codec)


def sum_decoded(codec: WireCodec, gathered_wire: torch.Tensor,
                gathered_scales: Optional[torch.Tensor], n_chunks: int,
                native_dtype) -> torch.Tensor:
    """Decode ``n_chunks`` per-worker payloads (stacked on dim 0 of a
    flat gathered buffer) and sum them — the post-gather reduction for
    non-linear codecs.  Accumulates in f32 whatever the wire dtype; the
    int8 codecs add the decodes in worker order in one pass
    (``ops.int8_decode_sum``)."""
    if is_int8(codec):
        return ops.int8_decode_sum(gathered_wire, gathered_scales,
                                   n_chunks).to(
                                       comm.torch_dtype(native_dtype))
    chunks = gathered_wire.reshape((n_chunks, -1)).to(torch.float32)
    if gathered_scales is not None:
        chunks = chunks * gathered_scales.reshape(
            (n_chunks, 1)).to(torch.float32)
    return chunks.sum(dim=0).to(comm.torch_dtype(native_dtype))


def padded_elems(n_elems: int, n_workers: int) -> int:
    """Round ``n_elems`` up to a multiple of ``n_workers`` (tiled
    reduce-scatter / ring-chunking padding)."""
    return -(-n_elems // max(n_workers, 1)) * max(n_workers, 1)
