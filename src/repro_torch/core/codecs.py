"""WireCodec — pluggable gradient wire formats, with explicit state.

The torch counterpart of ``repro.core.codecs`` for a flat process group,
where each rank is its own process:

    init_state(plan, device=) -> ExchangeState (one entry per stage)
    encode(buf)               -> (wire values, optional side scales)
    encode_stateful(buf, st)  -> (wire, scales, new bucket state)
    decode(wire, scale, …)    -> buf in the native dtype
    wire_bytes(n_elems)       -> exact encoded payload size

with a registry so codecs resolve by name (``get_codec("int8+ef")``).

Codecs come in two families the exchange must distinguish:

  * **linear** codecs (identity, bf16/f16 casts): the encoded buffer can
    be summed by the collective itself (an allreduce of the bf16 buffer);
  * **non-linear** codecs (int8 + per-bucket absmax scale): workers
    quantise against their own scale, so the plan allgathers (values,
    scales) and sums after decode (``sum_decoded``).

And in two statefulness families:

  * **stateless** codecs: the base-class defaults are the zero-state
    adapter — ``init_bucket_state`` returns ``()`` and
    ``encode_stateful`` passes the state through;
  * **stateful** codecs: ``ErrorFeedbackCodec`` wraps a stateless codec
    and keeps one f32 residual per dense fusion buffer (registry names
    take an ``+ef`` suffix).

``Int8Codec`` quantises through ``repro_torch.kernels.ops.quantize_int8``:
the CUDA kernel for CUDA tensors, its plain version for CPU tensors.  The
fp8 cast codecs of the reference are not carried: gloo refuses
``float8_e4m3fn`` in ``all_gather`` and ``all_reduce``.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.core import comm
from repro_torch.kernels import ops

#: suffix marking an ErrorFeedback-wrapped codec in the registry
EF_SUFFIX = "+ef"


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
    wire)."""

    linear = True

    def __init__(self, target_dtype, name: Optional[str] = None):
        self.target = comm.dtype_name(target_dtype)
        self.name = name or self.target

    def wire_dtype(self, native_dtype: str) -> str:
        return self.target

    def encode(self, buf):
        return buf.to(comm.torch_dtype(self.target)), None

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
    QMAX = 127.0

    def wire_dtype(self, native_dtype: str) -> str:
        return "int8"

    def encode(self, buf):
        q, scale = ops.quantize_int8(buf)
        return q.reshape(buf.shape), scale

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


def available_codecs() -> Tuple[str, ...]:
    return tuple(sorted(_CODECS))


def get_codec(name) -> WireCodec:
    """Resolve a codec by registry name.

    An ``+ef`` suffix wraps the named codec in ``ErrorFeedbackCodec``
    (cached, so repeated lookups share one instance and one plan-cache
    identity).
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
    raise ValueError(f"unknown codec {name!r} (registered: "
                     f"{', '.join(available_codecs())}, each with an "
                     f"optional {EF_SUFFIX!r} suffix)")


def sum_decoded(codec: WireCodec, gathered_wire: torch.Tensor,
                gathered_scales: Optional[torch.Tensor], n_chunks: int,
                native_dtype) -> torch.Tensor:
    """Decode ``n_chunks`` per-worker payloads (stacked on dim 0 of a
    flat gathered buffer) and sum them — the post-gather reduction for
    non-linear codecs.  Accumulates in f32 whatever the wire dtype."""
    chunks = gathered_wire.reshape((n_chunks, -1)).to(torch.float32)
    if gathered_scales is not None:
        chunks = chunks * gathered_scales.reshape(
            (n_chunks, 1)).to(torch.float32)
    return chunks.sum(dim=0).to(comm.torch_dtype(native_dtype))
