"""Neural-net layers of the ported model path (``repro.models.layers``).

Plain functions on tensors: ``init_*`` build parameter dicts (drawing from
an explicit ``torch.Generator``), the others take ``(params, inputs)``.
Parameter layouts and the numerics (f32 norms, RoPE and softmax; matmuls
in the parameters' dtype) follow the reference, so both packages compute
the same function from the same parameters.

Attention is plain PyTorch (``chunked_attention``): einsums and an online
softmax over kv chunks, the reference's ``xla_chunked`` path.  It calls no
fused library kernel.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig

Params = Dict[str, Any]
NEG_INF = -1e30


def _dtype(cfg: ArchConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def dense_init(gen: Optional[torch.Generator], shape, device,
               scale: Optional[float] = None,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """N(0, 1) * scale drawn in f32, then cast (``layers.dense_init``)."""
    if scale is None:
        scale = 1.0 / math.sqrt(shape[0])
    x = torch.empty(shape, dtype=torch.float32, device=device)
    return (x.normal_(generator=gen) * scale).to(dtype)


# ---------------------------------------------------------------------------
# Norms and RoPE
# ---------------------------------------------------------------------------

def init_rmsnorm(d: int, dtype: torch.dtype, device) -> Params:
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def rmsnorm(p: Params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    x32 = x.to(torch.float32)
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * p["scale"]).to(x.dtype)


def rope_freqs(head_dim: int, theta: float, fraction: float, device):
    rot = int(head_dim * fraction) // 2 * 2
    inv = 1.0 / (theta ** (torch.arange(0, rot, 2, dtype=torch.float32,
                                        device=device) / rot))
    return inv, rot


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               fraction: float = 1.0) -> torch.Tensor:
    """x: (B, S, H, D); positions: (S,) or (B, S).  Rotates interleaved
    pairs of the first ``fraction`` of the head dim, in f32."""
    d = x.shape[-1]
    inv, rot = rope_freqs(d, theta, fraction, x.device)
    if rot == 0:
        return x
    if positions.dim() == 1:
        positions = positions[None, :]
    ang = positions[..., None].to(torch.float32) * inv     # (B, S, rot/2)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    xr = x[..., :rot].to(torch.float32)
    x1, x2 = xr[..., 0::2], xr[..., 1::2]
    o1 = x1 * cos - x2 * sin
    o2 = x1 * sin + x2 * cos
    out = torch.stack([o1, o2], dim=-1).reshape(x.shape[:-1] + (rot,))
    return torch.cat([out.to(x.dtype), x[..., rot:]], dim=-1)


# ---------------------------------------------------------------------------
# Attention (no cache: training)
# ---------------------------------------------------------------------------

def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      causal: bool, window: Optional[int] = None,
                      block_k: int = 4096) -> torch.Tensor:
    """Online-softmax attention over kv chunks, in f32.

    q (B, Sq, H, D), k/v (B, Sk, Hkv, D) -> (B, Sq, H, D) in q's dtype.
    Scale ``D**-0.5``; query i sits at position ``i + Sk - Sq``; causal
    keeps keys at or before it, ``window`` keeps the last ``window`` of
    those.  Running ``(acc, m, l)`` with ``l`` clamped at 1e-30, as in
    ``repro.kernels.ops._chunked_attention``."""
    b, sq, h, d = q.shape
    if k.shape[2] != h:                                  # GQA
        k = k.repeat_interleave(h // k.shape[2], dim=2)
        v = v.repeat_interleave(h // v.shape[2], dim=2)
    dv = v.shape[-1]
    sk = k.shape[1]
    block_k = min(block_k, _round_up(sk, 8))
    nchunks = -(-sk // block_k)
    pad = nchunks * block_k - sk
    kp = F.pad(k, (0, 0, 0, 0, 0, pad))
    vp = F.pad(v, (0, 0, 0, 0, 0, pad))
    qf = q.to(torch.float32) * d ** -0.5
    q_pos = torch.arange(sq, device=q.device) + (sk - sq)
    acc = torch.zeros((b, h, sq, dv), dtype=torch.float32, device=q.device)
    m = torch.full((b, h, sq), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, sq), dtype=torch.float32, device=q.device)
    for ci in range(nchunks):
        sl = slice(ci * block_k, (ci + 1) * block_k)
        kb = kp[:, sl].to(torch.float32)
        vb = vp[:, sl].to(torch.float32)
        s = torch.einsum("bqhd,bkhd->bhqk", qf, kb)
        k_pos = ci * block_k + torch.arange(block_k, device=q.device)
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
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.transpose(1, 2).to(q.dtype)


def init_attention(gen, cfg: ArchConfig, device) -> Params:
    d, h, kv = cfg.d_model, cfg.n_heads, cfg.n_kv_heads
    hd = cfg.resolved_head_dim
    dt = _dtype(cfg)
    return {"wq": dense_init(gen, (d, h * hd), device, dtype=dt),
            "wk": dense_init(gen, (d, kv * hd), device, dtype=dt),
            "wv": dense_init(gen, (d, kv * hd), device, dtype=dt),
            "wo": dense_init(gen, (h * hd, d), device, dtype=dt)}


def attention(p: Params, cfg: ArchConfig, x: torch.Tensor,
              positions: torch.Tensor,
              window: Optional[int] = None) -> torch.Tensor:
    """Causal self-attention with GQA and RoPE over the whole sequence."""
    b, s, _ = x.shape
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    q = (x @ p["wq"]).reshape(b, s, h, hd)
    k = (x @ p["wk"]).reshape(b, s, kv, hd)
    v = (x @ p["wv"]).reshape(b, s, kv, hd)
    q = apply_rope(q, positions, cfg.rope_theta, cfg.rope_fraction)
    k = apply_rope(k, positions, cfg.rope_theta, cfg.rope_fraction)
    out = chunked_attention(q, k, v, causal=True, window=window)
    return out.reshape(b, s, h * hd) @ p["wo"]


def init_cross_attention(gen, cfg: ArchConfig, device) -> Params:
    d, h, hd = cfg.d_model, cfg.n_heads, cfg.resolved_head_dim
    dt = _dtype(cfg)
    return {"wq": dense_init(gen, (d, h * hd), device, dtype=dt),
            "wk": dense_init(gen, (d, h * hd), device, dtype=dt),
            "wv": dense_init(gen, (d, h * hd), device, dtype=dt),
            "wo": dense_init(gen, (h * hd, d), device, dtype=dt)}


def cross_attention(p: Params, cfg: ArchConfig, x: torch.Tensor,
                    enc: torch.Tensor) -> torch.Tensor:
    """Non-causal attention from decoder states to encoder states."""
    b, s, _ = x.shape
    f = enc.shape[1]
    h, hd = cfg.n_heads, cfg.resolved_head_dim
    q = (x @ p["wq"]).reshape(b, s, h, hd)
    k = (enc @ p["wk"]).reshape(b, f, h, hd)
    v = (enc @ p["wv"]).reshape(b, f, h, hd)
    out = chunked_attention(q, k, v, causal=False, window=None)
    return out.reshape(b, s, h * hd) @ p["wo"]


# ---------------------------------------------------------------------------
# MLP, embedding, tied projection
# ---------------------------------------------------------------------------

def init_mlp(gen, d: int, d_ff: int, dtype: torch.dtype, device) -> Params:
    return {"w_gate": dense_init(gen, (d, d_ff), device, dtype=dtype),
            "w_up": dense_init(gen, (d, d_ff), device, dtype=dtype),
            "w_down": dense_init(gen, (d_ff, d), device, dtype=dtype)}


def mlp(p: Params, x: torch.Tensor) -> torch.Tensor:
    """SwiGLU: (silu(x W_gate) * x W_up) W_down."""
    return (F.silu(x @ p["w_gate"]) * (x @ p["w_up"])) @ p["w_down"]


def init_embedding(gen, vocab: int, d: int, dtype: torch.dtype,
                   device) -> torch.Tensor:
    return dense_init(gen, (vocab, d), device, scale=d ** -0.5, dtype=dtype)


def embed(table: torch.Tensor, ids: torch.Tensor,
          tap: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Embedding lookup.  With ``tap`` (zeros (B, S, d) that require
    grad) the table is detached and the lookup routed through the tap, so
    ``d(loss)/d(tap)`` is the PER-TOKEN cotangent — ``tf.gather``'s
    IndexedSlices values (see ``training.gradients``)."""
    if tap is None:
        return table[ids.long()]
    return table.detach()[ids.long()] + tap


def tied_logits(table: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """Projection through the shared embedding: the DENSE cotangent
    contribution to the tied weight."""
    return h @ table.t()
