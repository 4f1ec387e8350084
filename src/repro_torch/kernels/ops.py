"""Public wrappers around the port's kernels.

Each wrapper dispatches on the device of the tensors it is given: a CUDA
tensor launches the hand-written kernel (or raises), a CPU tensor takes
the kernel's plain PyTorch version, and so does a ``meta`` tensor (the
dry run: shapes only).  Nothing falls back from one to the other.

While a FLOP counter is active (``repro_torch.launch.flops``) a launch
bills what its plain version counts on the same shapes, and the
dispatcher's count of the launch's own ops is set aside
(``_launch``), so a step counts the same FLOPs on every route.  The
attention kernel bills ``chunked_attention``'s count: its own plain
version sweeps the key blocks that the causal mask empties, which the
kernel and the chunked route skip.

``flash_attention`` also selects the attention algorithm by ``impl``,
named after what it runs; each maps to one ``impl`` of
``repro.kernels.ops.flash_attention``:

  ========== ================ ==========================================
  port impl  reference impl   what it runs
  ========== ================ ==========================================
  "ref"      "xla"            full softmax (``ref.attention_ref``)
  "chunked"  "xla_chunked"    online softmax over kv chunks in plain
                              PyTorch (``chunked_attention``); the
                              training path, differentiable
  "kernel"   "pallas"         the flash attention kernel (forward only)
  ========== ================ ==========================================

The models' ``attn_impl`` arguments take the same names.

``ssd`` (the Mamba2 chunked scan) likewise:

  ========== ================ ==========================================
  port impl  reference impl   what it runs
  ========== ================ ==========================================
  "ref"      "xla"            the sequential recurrence (``ref.ssd_ref``,
                              tests only)
  "kernel"   "pallas"         the SSD kernel (forward only)
  ========== ================ ==========================================
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ref
from repro_torch.kernels.densify import densify_kernel, densify_plain
from repro_torch.kernels.flash_attention import (
    NEG_INF, flash_attention_kernel, flash_attention_plain)
from repro_torch.kernels.quantize import (
    decode_sum_kernel, decode_sum_plain, quantize_ef_kernel,
    quantize_ef_plain, quantize_kernel, quantize_plain)
from repro_torch.kernels.ssd import ssd_kernel, ssd_plain
from repro_torch.telemetry import hooks as _hooks

ATTN_IMPLS = ("ref", "chunked", "kernel")
SSD_IMPLS = ("ref", "kernel")
SCORE_BLOCK_ELEMS = 1 << 28     # f32 scores of one chunked_attention block
_PLAIN_DEVICES = ("cpu", "meta")


def _launch(run, plain, *args):
    """``run()`` launches a kernel.  While a FLOP counter is active, the
    launch is billed what ``plain(*args)`` counts on tensors of the same
    shapes (``launch.flops.billed``); otherwise this is ``run()``, at the
    cost of one global read."""
    if _hooks.flop_counter() is None:
        return run()
    from repro_torch.launch import flops
    return flops.billed(run, lambda: flops.work_of(plain, *args))


def densify(indices: torch.Tensor, values: torch.Tensor,
            dense_shape: Tuple[int, int]) -> torch.Tensor:
    """Scatter-add ``values`` rows at ``indices`` into zeros(dense_shape).

    Negative / out-of-range indices are dropped (padding convention) by
    both versions.  Returns a tensor of the values' dtype."""
    dense_shape = tuple(int(s) for s in dense_shape)
    indices = indices.to(torch.int32).contiguous()
    values = values.contiguous()
    if indices.device.type == "cuda":
        return _launch(lambda: densify_kernel(indices, values, dense_shape),
                       densify_plain, indices, values, dense_shape)
    if indices.device.type in _PLAIN_DEVICES:
        return densify_plain(indices, values, dense_shape)
    raise ValueError(f"densify: unsupported device {indices.device}")


def quantize_int8(flat: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Quantise a flat f32/bf16 buffer to ``(int8 values (n,), f32
    absmax scale (1,))``; dequantise with ``q.float() * scale``."""
    flat = flat.reshape(-1)
    if flat.device.type == "cuda":
        return _launch(lambda: quantize_kernel(flat.contiguous()),
                       quantize_plain, flat)
    if flat.device.type in _PLAIN_DEVICES:
        return quantize_plain(flat)
    raise ValueError(f"quantize_int8: unsupported device {flat.device}")


def quantize_int8_ef(flat: torch.Tensor, residual: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The error-feedback encode: quantise ``flat + residual`` (f32/bf16
    buffer, f32 residual of as many elements) to ``(int8 (n,), f32
    scale (1,))`` and leave ``compensated - decoded`` in ``residual``,
    updated in place (the tensor keeps its identity)."""
    flat = flat.reshape(-1)
    if residual.dim() != 1 or residual.numel() != flat.numel():
        raise ValueError(f"quantize_int8_ef: residual of shape "
                         f"{tuple(residual.shape)} for {flat.numel()} "
                         f"elements")
    if flat.device.type == "cuda":
        return _launch(lambda: quantize_ef_kernel(flat.contiguous(),
                                                  residual),
                       quantize_ef_plain, flat, residual)
    if flat.device.type in _PLAIN_DEVICES:
        return quantize_ef_plain(flat, residual)
    raise ValueError(f"quantize_int8_ef: unsupported device {flat.device}")


def int8_decode_sum(gathered_q: torch.Tensor, scales: torch.Tensor,
                    n_chunks: int) -> torch.Tensor:
    """Decode ``n_chunks`` int8 chunks stacked in ``gathered_q`` against
    their f32 scales and sum them in chunk order -> f32 (n,)."""
    gathered_q = gathered_q.reshape(-1)
    scales = scales.reshape(-1)
    if gathered_q.device.type == "cuda":
        return _launch(lambda: decode_sum_kernel(
                           gathered_q.contiguous(),
                           scales.to(torch.float32).contiguous(), n_chunks),
                       decode_sum_plain, gathered_q, scales, n_chunks)
    if gathered_q.device.type in _PLAIN_DEVICES:
        return decode_sum_plain(gathered_q, scales, n_chunks)
    raise ValueError(f"int8_decode_sum: unsupported device "
                     f"{gathered_q.device}")


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------

def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def _expand_kv(k: torch.Tensor, n_heads: int) -> torch.Tensor:
    """GQA: repeat kv heads to match query heads, ``jnp.repeat``'s order.
    (B, S, Hkv, D) -> (B, S, H, D)."""
    if k.shape[2] == n_heads:
        return k
    return k.repeat_interleave(n_heads // k.shape[2], dim=2)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: Optional[int] = None,
                    impl: str = "kernel",
                    block_k: Optional[int] = None) -> torch.Tensor:
    """Multi-head attention, q (B, Sq, H, D), k/v (B, Sk, Hkv, D) (GQA
    ok) -> (B, Sq, H, Dv) in q's dtype.  Query i sits at position
    ``i + Sk - Sq``.  ``impl`` as in the module docstring; ``block_k``
    sets the chunk of ``"chunked"`` (4096 keys by default, never more
    than Sk rounded up to 8).  Under ``"kernel"`` mixed head dims
    (Dv != D, MLA) take ``"chunked"`` on every device, as the reference
    sends them from its Pallas impl to ``xla_chunked``: the route is
    chosen from the shapes before any launch (the kernel itself takes
    Dv == D only)."""
    if impl not in ATTN_IMPLS:
        raise ValueError(f"flash_attention: impl {impl!r} not in "
                         f"{ATTN_IMPLS}")
    if impl == "kernel" and v.shape[-1] != q.shape[-1]:
        impl = "chunked"
    if impl == "ref":
        h = q.shape[2]
        return ref.attention_ref(q, _expand_kv(k, h), _expand_kv(v, h),
                                 causal=causal, window=window)
    if impl == "chunked":
        return chunked_attention(q, k, v, causal=causal, window=window,
                                 block_k=block_k or 4096)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError("flash_attention: the kernel has no backward "
                           "(nor has the reference's); differentiate "
                           "through impl='chunked'")
    if q.device.type == "cuda":
        return _launch(lambda: flash_attention_kernel(q, k, v, causal=causal,
                                                      window=window),
                       chunked_attention, q, k, v, causal, window)
    if q.device.type == "cpu":
        return _launch(lambda: flash_attention_plain(q, k, v, causal=causal,
                                                     window=window),
                       chunked_attention, q, k, v, causal, window)
    if q.device.type == "meta":
        return chunked_attention(q, k, v, causal, window)
    raise ValueError(f"flash_attention: unsupported device {q.device}")


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      causal: bool, window: Optional[int] = None,
                      block_k: int = 4096) -> torch.Tensor:
    """Online-softmax attention over kv chunks, in f32 (the reference's
    ``_chunked_attention``).

    q (B, Sq, H, D), k/v (B, Sk, Hkv, D) -> (B, Sq, H, Dv) in q's dtype.
    Scale ``D**-0.5`` applied to q; query i sits at position
    ``i + Sk - Sq``; causal keeps keys at or before it, ``window`` keeps
    the last ``window`` of those.  Running ``(acc, m, l)`` with ``l``
    clamped at 1e-30.

    The query rows run in blocks sized so that one f32 score block holds
    at most ``SCORE_BLOCK_ELEMS`` elements (one block at training and
    test sizes; 2048 rows at 32 heads and 32768 tokens, where the whole
    block would take 17 GB; no cap on meta tensors, which allocate
    nothing), a causal block spans at most ``block_k`` rows, and it skips
    the kv chunks that start after its last query.  None of this changes
    a row's result: rows are independent, and a chunk with every key
    masked leaves ``(acc, m, l)`` as they were (alpha 1, p 0)."""
    b, sq, h, d = q.shape
    k, v = _expand_kv(k, h), _expand_kv(v, h)
    sk = k.shape[1]
    block_k = min(block_k, _round_up(sk, 8))
    nchunks = -(-sk // block_k)
    pad = nchunks * block_k - sk
    kp = F.pad(k, (0, 0, 0, 0, 0, pad))
    vp = F.pad(v, (0, 0, 0, 0, 0, pad))
    qf = q.to(torch.float32) * d ** -0.5
    block_q = (sq if q.device.type == "meta"
               else max(1, SCORE_BLOCK_ELEMS // (b * h * block_k)))
    if causal and nchunks > 1:
        block_q = min(block_q, block_k)
    outs = []
    for q0 in range(0, sq, block_q):
        q_pos = torch.arange(q0, min(q0 + block_q, sq),
                             device=q.device) + (sk - sq)
        last = q0 + len(q_pos) - 1 + sk - sq
        n = min(nchunks, last // block_k + 1) if causal else nchunks
        outs.append(_chunked_rows(qf[:, q0:q0 + block_q], kp, vp, q_pos,
                                  sk, block_k, max(n, 1), causal, window))
    out = outs[0] if len(outs) == 1 else torch.cat(outs, dim=2)
    return out.transpose(1, 2).to(q.dtype)


def _chunked_rows(qf, kp, vp, q_pos, sk, block_k, nchunks, causal,
                  window) -> torch.Tensor:
    """``chunked_attention``'s online softmax for the query rows ``qf``
    (B, rows, H, D), scaled f32, at positions ``q_pos``, over the first
    ``nchunks`` chunks of the padded ``kp``/``vp``: (B, H, rows, Dv) in
    f32."""
    b, sq, h, _ = qf.shape
    dv = vp.shape[-1]
    acc = torch.zeros((b, h, sq, dv), dtype=torch.float32, device=qf.device)
    m = torch.full((b, h, sq), NEG_INF, dtype=torch.float32,
                   device=qf.device)
    l = torch.zeros((b, h, sq), dtype=torch.float32, device=qf.device)
    for ci in range(nchunks):
        sl = slice(ci * block_k, (ci + 1) * block_k)
        kb = kp[:, sl].to(torch.float32)
        vb = vp[:, sl].to(torch.float32)
        s = torch.einsum("bqhd,bkhd->bhqk", qf, kb)
        k_pos = ci * block_k + torch.arange(block_k, device=qf.device)
        mask = (k_pos[None, :] < sk).expand(sq, block_k)
        if causal:
            mask = mask & (q_pos[:, None] >= k_pos[None, :])
        if window is not None:
            mask = mask & ((q_pos[:, None] - k_pos[None, :]) < window)
        s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        p = torch.where(mask, p, 0.0)
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("bhqk,bkhd->bhqd", p, vb)
        m = m_new
    return acc / torch.clamp(l, min=1e-30)[..., None]


# ---------------------------------------------------------------------------
# ssd (Mamba2 chunked scan)
# ---------------------------------------------------------------------------

def ssd(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
        b: torch.Tensor, c: torch.Tensor, chunk: int = 64,
        impl: str = "kernel") -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan over heads with shared B/C.

    x (B, S, H, P), dt (B, S, H), a (H,), b/c (B, S, N); S is padded to
    a multiple of ``chunk`` (zero dt: the padding leaves the state as it
    is).  Returns (y (B, S, H, P) f32, final state (B, H, N, P) f32).
    ``impl`` as in the module docstring.  Under ``"kernel"`` a CUDA
    tensor launches the kernel (or raises) and a CPU tensor takes
    ``ssd_plain``; inputs that require grad raise, as the kernel has no
    backward (nor has the reference's)."""
    if impl not in SSD_IMPLS:
        raise ValueError(f"ssd: impl {impl!r} not in {SSD_IMPLS}")
    bb, s, h, p = x.shape
    n = b.shape[-1]
    if impl == "ref":
        xf = x.permute(0, 2, 1, 3).reshape(bb * h, s, p)
        dtf = dt.permute(0, 2, 1).reshape(bb * h, s)
        bf = b[:, None].expand(bb, h, s, n).reshape(bb * h, s, n)
        cf = c[:, None].expand(bb, h, s, n).reshape(bb * h, s, n)
        y, state = ref.ssd_ref(xf, dtf, a.repeat(bb), bf, cf)
        return (y.reshape(bb, h, s, p).permute(0, 2, 1, 3),
                state.reshape(bb, h, n, p))
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t in (x, dt, a, b, c)):
        raise RuntimeError("ssd: the kernel has no backward (nor has the "
                           "reference's)")
    pad = (-s) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        b = F.pad(b, (0, 0, 0, pad))
        c = F.pad(c, (0, 0, 0, pad))
    if x.device.type == "cuda":
        y, state = _launch(lambda: ssd_kernel(x, dt, a, b, c, chunk),
                           ssd_plain, x, dt, a, b, c, chunk)
    elif x.device.type in _PLAIN_DEVICES:
        y, state = ssd_plain(x, dt, a, b, c, chunk)
    else:
        raise ValueError(f"ssd: unsupported device {x.device}")
    return y[:, :s], state
