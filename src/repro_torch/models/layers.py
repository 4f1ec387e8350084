"""Neural-net layers of the ported model path (``repro.models.layers``).

Plain functions on tensors: ``init_*`` build parameter dicts (drawing from
an explicit ``torch.Generator``), the others take ``(params, inputs)``.
Parameter layouts and the numerics (f32 norms, RoPE and softmax; matmuls
in the parameters' dtype) follow the reference, so both packages compute
the same function from the same parameters.

The MoE FFN (``moe_ffn``) is plain PyTorch, as the reference's is plain
jnp: a router, one-hot dispatch and combine, and batched expert matmuls.
So is MLA (``init_mla``, ``mla_attention``, ``mla_attention_absorbed``:
DeepSeek-V2's latent attention, its compressed cache and the absorbed
decode).

Attention without a cache dispatches through
``repro_torch.kernels.ops.flash_attention``, so ``attn_impl`` ("ref",
"chunked" or "kernel"; see that module) is a runtime choice; cached
decode attention (``decode_attention``) is plain PyTorch, as the
reference's is plain jnp.

On DTensors (the partitioned step, ``launch/partitioned.py``) the
attention and the grouped MoE dispatch run on each rank's shards
(``attend``, ``_moe_experts``), a cache write lands in the rank's own
block (``_sharded_update``), and the layout helpers of
``models/activation_sharding.py`` gather what DTensor cannot split; on
plain tensors each is the code it wraps.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops as kops
from repro_torch.kernels.flash_attention import NEG_INF
from repro_torch.models.activation_sharding import (is_dtensor, replicated,
                                                    shard_local,
                                                    split_heads,
                                                    whole_over_model)
from repro_torch.tree import tree_flatten, tree_unflatten

Params = Dict[str, Any]


def _dtype(cfg: ArchConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


_LN2 = 0.6931471805599453                   # the f64 nearest ln 2
_SQRT_HALF = 0.7071067811865476
#: 2 atanh(t) = 2 t (1 + t^2/3 + t^4/5 + ...): |t| <= 0.1716 below, so
#: eight terms leave ~1e-14
_ATANH_C = [1.0 / (2 * k + 1) for k in range(8)]
#: candidate pairs a round: every operand stays under ATen's parallel
#: grain (32768 elements), so no op of a draw starts a thread team
_MAX_PAIRS = 16000


def _log_f64(x: torch.Tensor) -> torch.Tensor:
    """ln x of positive f64 ``x`` from +, -, *, / and ``frexp``: x = m 2^e
    with m in [sqrt(1/2), sqrt(2)), ln m = 2 atanh((m - 1) / (m + 1))."""
    m, e = torch.frexp(x)
    low = m < _SQRT_HALF
    m = torch.where(low, m + m, m)
    e = e.sub_(low.to(e.dtype)).to(torch.float64).mul_(_LN2)
    t = (m - 1.0).div_(m.add_(1.0))
    z = t * t
    p = torch.full_like(z, _ATANH_C[-1])
    for c in reversed(_ATANH_C[:-1]):
        p = p.mul_(z).add_(c)
    return p.mul_(t).mul_(2.0).add_(e)


def _sqrt_f64(x: torch.Tensor) -> torch.Tensor:
    """sqrt x of positive f64 ``x`` from +, *, / and ``frexp``: x = m 4^h
    with m in [1/2, 2), four Newton steps from (m + 1) / 2 (relative error
    6e-2, 2e-3, 2e-6, 1e-12, then rounding), times 2^h built from its
    bits.  ``torch.sqrt`` may go to MKL's vector math, whose code also
    depends on the host's ISA."""
    m, e = torch.frexp(x)
    odd = (e & 1).bool()
    m = torch.where(odd, m + m, m)
    h = (e - odd.to(e.dtype)) >> 1
    y = (m + 1.0).mul_(0.5)
    for _ in range(4):
        y = (m / y).add_(y).mul_(0.5)
    return y.mul_(((h.to(torch.int64) + 1023) << 52).view(torch.float64))


def _cpu_normal(gen: torch.Generator, n: int) -> torch.Tensor:
    """``n`` N(0, 1) values in f32 whose bits depend on ``gen``'s state
    and ``n`` alone.  ATen's CPU ``normal_`` takes its log, cos and sin
    from code chosen by the host's vector ISA (AVX-512, AVX2 or none),
    which rounds differently.  Here the only draws are integers, and
    Marsaglia's polar method maps them with integer arithmetic and exact
    or correctly rounded f64 operations, rounded once to f32.  Each
    candidate pair is one 62-bit integer: two odd 31-bit coordinates
    x, y in (-2^31, 2^31), kept when x^2 + y^2 < 2^62 (exact in int64)."""
    out = torch.empty(n, dtype=torch.float32)
    pos = 0
    while pos < n:
        want = (n - pos + 1) // 2                  # pairs; ~4/pi drawn
        k = torch.randint(0, 1 << 62, (min(_MAX_PAIRS, want * 4 // 3 + 32),),
                          generator=gen)
        x = (k >> 31).mul_(2).sub_((1 << 31) - 1)
        y = (k & ((1 << 31) - 1)).mul_(2).sub_((1 << 31) - 1)
        r2 = x * x + y * y
        idx = (r2 < (1 << 62)).nonzero().squeeze(1)
        s = r2.index_select(0, idx).to(torch.float64).mul_(2.0 ** -62)
        f = _sqrt_f64(_log_f64(s).mul_(-2.0).div_(s)).mul_(2.0 ** -31)
        z = torch.stack([x.index_select(0, idx).to(torch.float64).mul_(f),
                         y.index_select(0, idx).to(torch.float64).mul_(f)],
                        1).view(-1)[:n - pos]
        out[pos:pos + z.numel()] = z
        pos += z.numel()
    return out


def normal_f32(gen: Optional[torch.Generator], shape,
               device) -> torch.Tensor:
    """N(0, 1) values in f32 of ``shape`` drawn from ``gen`` on
    ``device``: the one draw of the seeded init.  On the CPU the bits are
    a function of the seed and the shape alone (``_cpu_normal``); the
    card keeps ``normal_`` on its own generator (other numbers from one
    seed, as before), and meta tensors get a shape."""
    device = torch.device(device)
    if device.type != "cpu":
        return torch.empty(shape, dtype=torch.float32,
                           device=device).normal_(generator=gen)
    return _cpu_normal(gen, math.prod(shape)).view(shape)


def dense_init(gen: Optional[torch.Generator], shape, device,
               scale: Optional[float] = None,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """N(0, 1) * scale drawn in f32, then cast (``layers.dense_init``)."""
    if scale is None:
        scale = 1.0 / math.sqrt(shape[0])
    return (normal_f32(gen, shape, device) * scale).to(dtype)


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
# Attention
# ---------------------------------------------------------------------------

def init_attention(gen, cfg: ArchConfig, device) -> Params:
    d, h, kv = cfg.d_model, cfg.n_heads, cfg.n_kv_heads
    hd = cfg.resolved_head_dim
    dt = _dtype(cfg)
    p = {"wq": dense_init(gen, (d, h * hd), device, dtype=dt),
         "wk": dense_init(gen, (d, kv * hd), device, dtype=dt),
         "wv": dense_init(gen, (d, kv * hd), device, dtype=dt),
         "wo": dense_init(gen, (h * hd, d), device, dtype=dt)}
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((h * hd,), dtype=dt, device=device)
        p["bk"] = torch.zeros((kv * hd,), dtype=dt, device=device)
        p["bv"] = torch.zeros((kv * hd,), dtype=dt, device=device)
    return p


def attention(p: Params, cfg: ArchConfig, x: torch.Tensor,
              positions: torch.Tensor,
              kv_cache: Optional[Dict[str, Any]] = None,
              window: Optional[int] = None, attn_impl: str = "chunked"
              ) -> Tuple[torch.Tensor, Optional[Dict[str, Any]]]:
    """Self-attention with GQA, RoPE and an optional KV cache; with
    ``cfg.qkv_bias`` the projections add ``bq``, ``bk``, ``bv``.

    Without a cache: causal attention over x (training, prefill) through
    ``ops.flash_attention(impl=attn_impl)``.  With one: x holds the new
    token(s), written at each slot's own position, and attention runs
    over the cache (``decode_attention``); the updated cache is returned.
    Cache: {"k", "v": (B, C, KV, HD), "length": (B,) tokens seen per
    slot, "ring": bool} -- a ring buffer of the last C tokens if "ring"
    (default: ``window is not None``)."""
    b, s, _ = x.shape
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    q, k, v = x @ p["wq"], x @ p["wk"], x @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = split_heads(q, h, hd)
    k = split_heads(k, kv, hd)
    v = split_heads(v, kv, hd)
    q = apply_rope(q, positions, cfg.rope_theta, cfg.rope_fraction)
    k = apply_rope(k, positions, cfg.rope_theta, cfg.rope_fraction)
    new_cache = None
    if kv_cache is not None:
        cache_len = kv_cache["k"].shape[1]
        pos0 = kv_cache["length"]
        ring = bool(kv_cache.get("ring", window is not None))
        slot = pos0 % cache_len if ring else pos0
        ck = _batched_update(kv_cache["k"], k, slot)
        cv = _batched_update(kv_cache["v"], v, slot)
        new_cache = {"k": ck, "v": cv, "length": pos0 + s, "ring": ring}
        out = decode_attention(q, ck, cv, length=pos0 + s, window=window,
                               ring=ring)
    else:
        out = attend(q, k, v, causal=True, window=window, impl=attn_impl)
    return out.reshape(b, s, h * hd) @ p["wo"], new_cache


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           causal: bool, window: Optional[int], impl: str) -> torch.Tensor:
    """``ops.flash_attention`` on plain tensors.  On DTensors it runs
    on each rank's batch shard and head shard (``shard_local``): the
    heads split over ``model`` where they divide evenly; when the kv
    heads do not (GQA with fewer kv heads than the model axis), each
    rank takes every kv head and keeps the ones its query heads read."""
    def run(q, k, v):
        return kops.flash_attention(q, k, v, causal=causal, window=window,
                                    impl=impl)
    if not is_dtensor(q):
        return run(q, k, v)
    mesh = q.device_mesh
    names = mesh.mesh_dim_names
    m = mesh.shape[names.index("model")] if "model" in names else 1
    h, kv = q.shape[2], k.shape[2]
    if h % m or kv % m == 0:
        return shard_local(run, (q, k, v), (2, 2, 2), 2, n=h)
    rank = mesh.get_local_rank("model")
    hq, g = h // m, h // kv

    def gqa(q, k, v):
        idx = (rank * hq + torch.arange(hq, device=k.device)) // g
        return run(q, k.index_select(2, idx), v.index_select(2, idx))
    return shard_local(gqa, (q, k, v), (2, None, None), 2, n=h)


def _batched_update(cache: torch.Tensor, new: torch.Tensor,
                    pos: torch.Tensor) -> torch.Tensor:
    """Per-slot cache write into a copy: cache (B, C, ...), new (B, s,
    ...), pos (B,) -- each batch entry writes at its OWN position.  As
    ``jax.lax.dynamic_update_slice_in_dim`` does, a start that would run
    past the end is clamped to ``C - s`` (the write lands on the last s
    slots; nothing is dropped or wrapped)."""
    b, c = cache.shape[:2]
    s = new.shape[1]
    if s > c:
        raise ValueError(f"cache update of {s} rows into {c} slots")
    if is_dtensor(cache):
        return _sharded_update(cache, new, pos)
    start = torch.clamp(pos.to(torch.int64), 0, c - s)
    rows = start[:, None] + torch.arange(s, device=cache.device)
    out = cache.clone()
    out[torch.arange(b, device=cache.device)[:, None], rows] = \
        new.to(cache.dtype)
    return out


def _sharded_update(cache, new: torch.Tensor, pos: torch.Tensor):
    """``_batched_update`` of a DTensor cache whose batch and sequence
    dims may be sharded: each rank writes the rows that fall in its own
    block (the others go to a spare row past its end, dropped), from the
    replicated new rows and positions."""
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset)
    from torch.distributed.tensor.experimental import local_map
    mesh = cache.device_mesh
    c, s = cache.shape[1], new.shape[1]
    shape, offset = compute_local_shape_and_global_offset(
        cache.shape, mesh, list(cache.placements))
    (b_l, c_l), (b0, c0) = shape[:2], offset[:2]
    rep = [Replicate()] * mesh.ndim

    def local(cache_l, new_f, pos_f):
        start = torch.clamp(pos_f[b0:b0 + b_l].to(torch.int64), 0, c - s)
        rows = start[:, None] + torch.arange(s, device=cache_l.device) - c0
        rows = torch.where((rows >= 0) & (rows < c_l), rows, c_l)
        out = torch.cat([cache_l, cache_l[:, :1]], dim=1)
        out[torch.arange(b_l, device=cache_l.device)[:, None], rows] = \
            new_f[b0:b0 + b_l].to(cache_l.dtype)
        return out[:, :c_l]
    return local_map(local, out_placements=list(cache.placements),
                     in_placements=(list(cache.placements), rep, rep),
                     device_mesh=mesh, redistribute_inputs=True)(
                         cache, new, pos)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, length: torch.Tensor,
                     window: Optional[int] = None,
                     ring: bool = False) -> torch.Tensor:
    """Attention of a few query rows over a KV cache, plain PyTorch.

    q (B, s, H, D) with small s (decode: s = 1); cache k (B, C, KV, D),
    v (B, C, KV, Dv) -> (B, s, H, Dv); ``length`` (B,) tokens written per
    slot INCLUDING the current ones.
    ring: the cache holds the last C tokens and every written slot is in
    the window.  Otherwise slot == position: slots at or past the row's
    own count are masked, and with ``window`` so are slots ``window`` or
    more behind it.  Row i sits at position ``length - s + i``, so with
    s > 1 (chunked prefill) each row sees slots up to its own.  GQA by
    grouped einsums; scores in f32 (exact products of the cache dtype),
    softmax in f32, probabilities cast to q's dtype for the value sum."""
    b, s, h, d = q.shape
    c, kv = k_cache.shape[1], k_cache.shape[2]
    g = h // kv
    # on DTensors the few query rows go whole over ``model`` (where the
    # cache splits its slots), which the grouped view needs
    qg = whole_over_model(q).reshape(b, s, kv, g, d)
    scores = torch.einsum("bskgd,bckd->bkgsc", qg.to(torch.float32),
                          k_cache.to(torch.float32)) * d ** -0.5
    slots = torch.arange(c, device=q.device)
    length = torch.broadcast_to(length, (b,))
    qpos = length[:, None] - s + 1 + torch.arange(s, device=q.device)
    valid = slots[None, None, :] < torch.clamp(qpos, max=c)[:, :, None]
    if not ring and window is not None:
        valid = valid & (slots[None, None, :] >= (qpos - window)[:, :, None])
    scores = torch.where(valid[:, None, None], scores, NEG_INF)
    p_ = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgsc,bckd->bskgd", p_.to(q.dtype), v_cache)
    # the value head dim: the reference reshapes to q's, which raises at
    # Dv != D (MLA's naive decode)
    return out.reshape(b, s, h, v_cache.shape[-1])


def init_cross_attention(gen, cfg: ArchConfig, device) -> Params:
    d, h, hd = cfg.d_model, cfg.n_heads, cfg.resolved_head_dim
    dt = _dtype(cfg)
    return {"wq": dense_init(gen, (d, h * hd), device, dtype=dt),
            "wk": dense_init(gen, (d, h * hd), device, dtype=dt),
            "wv": dense_init(gen, (d, h * hd), device, dtype=dt),
            "wo": dense_init(gen, (h * hd, d), device, dtype=dt)}


def cross_attention(p: Params, cfg: ArchConfig, x: torch.Tensor,
                    enc: torch.Tensor, attn_impl: str = "chunked"
                    ) -> torch.Tensor:
    """Non-causal attention from decoder states to encoder states.  The
    encoder projections run in the promoted dtype of ``enc`` and the
    weights, as ``jnp.einsum`` promotes them (f32 encoder states give f32
    keys and values under bf16 weights)."""
    b, s, _ = x.shape
    f = enc.shape[1]
    h, hd = cfg.n_heads, cfg.resolved_head_dim
    dt = torch.promote_types(enc.dtype, p["wk"].dtype)
    enc = enc.to(dt)
    q = split_heads(x @ p["wq"], h, hd)
    k = split_heads(enc @ p["wk"].to(dt), h, hd)
    v = split_heads(enc @ p["wv"].to(dt), h, hd)
    out = attend(q, k, v, causal=False, window=None, impl=attn_impl)
    return out.reshape(b, s, h * hd) @ p["wo"]


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V2 multi-head latent attention)
# ---------------------------------------------------------------------------

def init_mla(gen, cfg: ArchConfig, device) -> Params:
    """Full-rank q (d, H * (nope + rope)); the kv compression ``w_dkv``
    (d, kv_lora) with its RMSNorm; ONE rope key head ``w_kr`` (d, rope)
    shared by every head; the up-projections ``w_uk`` (kv_lora, H *
    nope) and ``w_uv`` (kv_lora, H * v); ``wo`` (H * v, d)."""
    m = cfg.mla
    d, h = cfg.d_model, cfg.n_heads
    dt = _dtype(cfg)
    qd = m.nope_dim + m.rope_dim
    return {"wq": dense_init(gen, (d, h * qd), device, dtype=dt),
            "w_dkv": dense_init(gen, (d, m.kv_lora), device, dtype=dt),
            "w_kr": dense_init(gen, (d, m.rope_dim), device, dtype=dt),
            "w_uk": dense_init(gen, (m.kv_lora, h * m.nope_dim), device,
                               dtype=dt),
            "w_uv": dense_init(gen, (m.kv_lora, h * m.v_dim), device,
                               dtype=dt),
            "wo": dense_init(gen, (h * m.v_dim, d), device, dtype=dt),
            "norm_ckv": init_rmsnorm(m.kv_lora, dt, device)}


def _mla_project(p: Params, cfg: ArchConfig, x: torch.Tensor,
                 positions: torch.Tensor):
    """(q_nope (B, s, H, nope), roped q_rope (B, s, H, rope), normed c_kv
    (B, s, kv_lora), roped shared key k_rope (B, s, rope))."""
    m = cfg.mla
    b, s, _ = x.shape
    q = split_heads(x @ p["wq"], cfg.n_heads, m.nope_dim + m.rope_dim)
    q_nope, q_rope = q[..., :m.nope_dim], q[..., m.nope_dim:]
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)
    ckv = rmsnorm(p["norm_ckv"], x @ p["w_dkv"], cfg.norm_eps)
    kr = apply_rope((x @ p["w_kr"])[:, :, None, :], positions,
                    cfg.rope_theta)[:, :, 0, :]
    return q_nope, q_rope, ckv, kr


def _mla_cache_update(kv_cache: Dict[str, Any], ckv: torch.Tensor,
                      kr: torch.Tensor, window: Optional[int], s: int):
    cache_len = kv_cache["ckv"].shape[1]
    pos0 = kv_cache["length"]
    ring = bool(kv_cache.get("ring", window is not None))
    slot = pos0 % cache_len if ring else pos0
    return {"ckv": _batched_update(kv_cache["ckv"], ckv, slot),
            "kr": _batched_update(kv_cache["kr"], kr, slot),
            "length": pos0 + s, "ring": ring}


def mla_attention_absorbed(p: Params, cfg: ArchConfig, x: torch.Tensor,
                           positions: torch.Tensor,
                           kv_cache: Dict[str, Any],
                           window: Optional[int] = None
                           ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Absorbed-matrix MLA decode (DeepSeek-V2 §2.1): scores and context
    in the compressed kv_lora space,

        scores = (q_nope W_uk) . c_kv  +  q_rope . k_rope
        out    = (softmax . c_kv) W_uv W_o,

    with the per-row causal mask, ring and window of
    ``decode_attention``.  The reference accumulates every product in
    f32 (``preferred_element_type``) and promotes ``f32 @ bf16`` to f32;
    PyTorch takes neither, so the operands are cast on purpose: q W_uk
    in f32, cast to x's dtype; scores, context and the W_uv product in
    f32 over an f32 copy of the cache (B, C, kv_lora + rope); the
    probabilities and the output cast to x's dtype where the reference
    casts them."""
    m = cfg.mla
    b, s, _ = x.shape
    h = cfg.n_heads
    f32 = torch.float32
    q_nope, q_rope, ckv, kr = _mla_project(p, cfg, x, positions)
    new_cache = _mla_cache_update(kv_cache, ckv, kr, window, s)
    ckv_c = new_cache["ckv"].to(f32)
    kr_c = new_cache["kr"].to(f32)
    cache_len = ckv_c.shape[1]
    w_uk = p["w_uk"].reshape(m.kv_lora, h, m.nope_dim).to(f32)
    q_abs = torch.einsum("bshn,lhn->bshl", q_nope.to(f32),
                         w_uk).to(x.dtype)
    scores = (torch.einsum("bshl,bSl->bhsS", q_abs.to(f32), ckv_c)
              + torch.einsum("bshr,bSr->bhsS", q_rope.to(f32), kr_c))
    scores = scores * (m.nope_dim + m.rope_dim) ** -0.5
    slots = torch.arange(cache_len, device=x.device)
    newlen = torch.broadcast_to(new_cache["length"], (b,))
    qpos = newlen[:, None] - s + 1 + torch.arange(s, device=x.device)
    valid = slots[None, None, :] < torch.clamp(qpos, max=cache_len)[
        :, :, None]
    if not new_cache["ring"] and window is not None:
        valid = valid & (slots[None, None, :] >= (qpos - window)[:, :, None])
    scores = torch.where(valid[:, None], scores, NEG_INF)
    attn = torch.softmax(scores, dim=-1).to(x.dtype)
    ctx = torch.einsum("bhsS,bSl->bshl", attn.to(f32), ckv_c)
    w_uv = p["w_uv"].reshape(m.kv_lora, h, m.v_dim).to(f32)
    out = torch.einsum("bshl,lhv->bshv", ctx, w_uv)
    out = out.reshape(b, s, h * m.v_dim).to(x.dtype)
    return out @ p["wo"], new_cache


def mla_attention(p: Params, cfg: ArchConfig, x: torch.Tensor,
                  positions: torch.Tensor,
                  kv_cache: Optional[Dict[str, Any]] = None,
                  window: Optional[int] = None, attn_impl: str = "chunked",
                  absorbed: bool = True
                  ) -> Tuple[torch.Tensor, Optional[Dict[str, Any]]]:
    """MLA: the cache holds the COMPRESSED c_kv and the shared rope key,
    {"ckv": (B, C, kv_lora), "kr": (B, C, rope), "length", "ring"}.
    With a cache the decode is absorbed by default
    (``mla_attention_absorbed``); ``absorbed=False`` decompresses the
    cache into per-head keys (nope + rope) and values and runs
    ``decode_attention``.  Without a cache: causal attention through
    ``ops.flash_attention(impl=attn_impl)``, which takes q·k head dim
    nope + rope and v head dim ``v_dim`` (at Dv != D "kernel" takes the
    chunked route)."""
    if kv_cache is not None and absorbed:
        return mla_attention_absorbed(p, cfg, x, positions, kv_cache,
                                      window=window)
    m = cfg.mla
    b, s, _ = x.shape
    h = cfg.n_heads
    q_nope, q_rope, ckv, kr = _mla_project(p, cfg, x, positions)
    new_cache = None
    if kv_cache is not None:
        new_cache = _mla_cache_update(kv_cache, ckv, kr, window, s)
        ckv, kr = new_cache["ckv"], new_cache["kr"]
    k_nope = (ckv @ p["w_uk"]).reshape(b, -1, h, m.nope_dim)
    vv = (ckv @ p["w_uv"]).reshape(b, -1, h, m.v_dim)
    k = torch.cat([k_nope, kr[:, :, None, :].expand(
        k_nope.shape[:3] + (m.rope_dim,))], dim=-1)
    qf = torch.cat([q_nope, q_rope], dim=-1)
    if kv_cache is not None:
        out = decode_attention(qf, k, vv, length=new_cache["length"],
                               window=window, ring=new_cache["ring"])
    else:
        out = attend(qf, k, vv, causal=True, window=window, impl=attn_impl)
    return out.reshape(b, s, h * m.v_dim) @ p["wo"], new_cache


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


# ---------------------------------------------------------------------------
# MoE FFN (GShard grouped-capacity dispatch, shared experts)
# ---------------------------------------------------------------------------

MOE_GROUP = 512                    # tokens per capacity group (GShard)


def init_moe(gen, cfg: ArchConfig, device) -> Params:
    """An f32 router (d, E), E SwiGLU experts stacked on a leading axis
    and ``n_shared`` shared experts as one SwiGLU of ``n_shared * f``."""
    mo = cfg.moe
    d, e, f = cfg.d_model, mo.n_experts, mo.d_ff_expert
    dt = _dtype(cfg)
    scale = 1.0 / math.sqrt(d)
    p = {"router": dense_init(gen, (d, e), device, scale=scale),
         "w_gate": dense_init(gen, (e, d, f), device, scale=scale, dtype=dt),
         "w_up": dense_init(gen, (e, d, f), device, scale=scale, dtype=dt),
         "w_down": dense_init(gen, (e, f, d), device,
                              scale=1.0 / math.sqrt(f), dtype=dt)}
    if mo.n_shared:
        p["shared"] = init_mlp(gen, d, f * mo.n_shared, dt, device)
    return p


def _one_hot(idx: torch.Tensor, n: int, dtype) -> torch.Tensor:
    """``jax.nn.one_hot``: all zeros where ``idx`` is outside [0, n)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def _route(p: Params, x: torch.Tensor, k: int):
    """Router in f32: (probs, normalised top-k gates, expert ids).  Ties
    go to the lowest expert id, as ``jax.lax.top_k`` breaks them (the
    zero rows that pad a group have equal logits): ``argmax`` for k = 1,
    a stable descending sort otherwise."""
    probs = torch.softmax(x.to(torch.float32) @ p["router"], dim=-1)
    if k == 1:
        idx = torch.argmax(probs, dim=-1, keepdim=True)
    else:
        idx = torch.sort(probs, dim=-1, descending=True, stable=True)[1][
            ..., :k]
    vals = torch.gather(probs, -1, idx)
    vals = vals / torch.clamp(vals.sum(dim=-1, keepdim=True), min=1e-9)
    return probs, vals, idx


def _aux(probs: torch.Tensor, idx: torch.Tensor, e: int,
         k: int) -> torch.Tensor:
    """GShard load-balance loss E * sum_e(fraction routed_e * mean
    prob_e), over every row given (a group's padding rows included)."""
    me = probs.reshape(-1, e).mean(dim=0)
    fe = _one_hot(idx, e, torch.float32).reshape(-1, e).mean(dim=0) * k
    return e * torch.sum(fe * me)


def moe_ffn(p: Params, cfg: ArchConfig, x: torch.Tensor,
            dropless: bool = False, group_size: int = MOE_GROUP,
            capacity_override: Optional[int] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k routed experts with grouped capacity dispatch; returns
    (output, router aux loss).

    The B*S tokens are zero-padded to whole groups of ``group_size`` and
    capacity is enforced per group: expert e takes the first ``cap``
    (token, slot) pairs routed to it in token order, ``cap = max(int(gs *
    k / E * capacity_factor), 1)`` or ``capacity_override``; the rest are
    dropped (their gate is zeroed).  Dispatch and combine are one-hot
    products in x's dtype.  The shared experts see every token.
    ``dropless=True`` (decode) runs every expert on every token and gates
    them: exact top-k, no capacity."""
    if dropless:
        return _moe_ffn_dropless(p, cfg, x)
    mo = cfg.moe
    b, s, d = x.shape
    t = b * s
    e, k = mo.n_experts, mo.top_k
    gs = min(group_size, t)
    pad = (-t) % gs
    xt = x.reshape(t, d)
    if pad:
        xt = F.pad(xt, (0, 0, 0, pad))
    ng = (t + pad) // gs
    xg = xt.reshape(ng, gs, d)
    cap = (capacity_override if capacity_override is not None
           else max(int(gs * k / e * mo.capacity_factor), 1))
    yt, me, fe = _moe_experts(p, xg, k, cap)
    yt = yt.reshape(ng * gs, d)
    if pad:
        yt = yt[:t]
    if mo.n_shared:
        yt = yt + mlp(p["shared"], x.reshape(t, d))
    return yt.reshape(b, s, d), e * torch.sum(fe * me)


def _dispatch_combine(router, w_gate, w_up, w_down, xg, k: int, cap: int,
                      lo: int = 0):
    """Route every token of the groups ``xg`` (g, gs, d) over all E
    experts, dispatch it to the experts ``w_*`` hold (E_l of them, from
    expert ``lo``), and combine their outputs.  Returns (the routed
    experts' output (g, gs, d), the routing probabilities' mean over the
    rows (E,), the fraction routed to each expert times k (E,)): the
    aux loss is E * sum(fraction * mean), over every row given (a group's
    padding rows included)."""
    ng, gs, _ = xg.shape
    probs, gate_vals, gate_idx = _route({"router": router}, xg, k)
    e = probs.shape[-1]
    hi = lo + w_gate.shape[0]
    # each (token, slot)'s place in its expert's buffer: an exclusive
    # cumsum in token order over the flattened (gs * k) slots
    onehot = _one_hot(gate_idx, e, torch.int32)              # (g, gs, k, e)
    flat = onehot.reshape(ng, gs * k, e)
    pos_in_e = torch.cumsum(flat, dim=1) - flat
    pos = torch.sum(pos_in_e * flat, dim=-1).reshape(ng, gs, k)
    keep = pos < cap
    gate_vals = gate_vals * keep

    d_e = onehot[..., lo:hi].to(xg.dtype)
    d_c = _one_hot(pos, cap, xg.dtype) * keep[..., None]
    dispatch = torch.einsum("gtke,gtkc->gtec", d_e, d_c)     # (g, gs, e, c)
    xe = torch.einsum("gtec,gtd->gecd", dispatch, xg)        # (g, e, c, d)
    gg = torch.einsum("gecd,edf->gecf", xe, w_gate)
    uu = torch.einsum("gecd,edf->gecf", xe, w_up)
    ye = torch.einsum("gecf,efd->gecd", F.silu(gg) * uu, w_down)
    combine = torch.einsum("gtke,gtkc,gtk->gtec", d_e, d_c,
                           gate_vals.to(xg.dtype))
    yt = torch.einsum("gtec,gecd->gtd", combine, ye)
    me = probs.reshape(-1, e).mean(dim=0)
    fe = _one_hot(gate_idx, e, torch.float32).reshape(-1, e).mean(dim=0) * k
    return yt, me, fe


def _moe_experts(p: Params, xg: torch.Tensor, k: int, cap: int):
    """``_dispatch_combine`` over the groups ``xg``.  On DTensors it runs
    on each rank's batch shard (whole groups) and expert shard: every
    rank routes its tokens over all experts and runs its own, so the
    output is a partial sum over ``model`` where the experts are split
    there; the means of the aux loss are averaged over the data axes."""
    args = (p["router"], p["w_gate"], p["w_up"], p["w_down"], xg)
    if not is_dtensor(xg):
        return _dispatch_combine(*args, k, cap)
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    from repro_torch.models.activation_sharding import batch_placements
    mesh = xg.device_mesh
    names = mesh.mesh_dim_names
    e = p["w_gate"].shape[0]
    m = mesh.shape[names.index("model")] if "model" in names else 1
    split = m > 1 and e % m == 0
    lo = mesh.get_local_rank("model") * (e // m) if split else 0
    rep = [Replicate()] * mesh.ndim
    experts = list(batch_placements(mesh, 0, e if split else 0, axes=()))
    tokens = list(batch_placements(mesh, batch=xg.shape[0]))
    out = list(tokens)
    means = [Partial("avg") if isinstance(pl, Shard) else Replicate()
             for pl in tokens]
    if split:
        out[names.index("model")] = Partial()
    return local_map(
        lambda *a: _dispatch_combine(*a, k, cap, lo=lo),
        out_placements=(out, means, means),
        in_placements=(rep, experts, experts, experts, tokens),
        device_mesh=mesh, redistribute_inputs=True)(*args)


def _moe_ffn_dropless(p: Params, cfg: ArchConfig, x: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    mo = cfg.moe
    b, s, d = x.shape
    t = b * s
    e, k = mo.n_experts, mo.top_k
    xt = x.reshape(t, d)
    probs, gate_vals, gate_idx = _route(p, xt, k)
    gates = torch.zeros((t, e), dtype=x.dtype, device=x.device).scatter(
        1, gate_idx, gate_vals.to(x.dtype))
    # (t, d) @ (E, d, f) broadcasts to one product an expert over the
    # weights as they lie (an einsum would copy them into (d, E*f))
    g = torch.matmul(xt, p["w_gate"])                        # (E, t, f)
    u = torch.matmul(xt, p["w_up"])
    ye = torch.matmul(F.silu(g) * u, p["w_down"])            # (E, t, d)
    yt = torch.einsum("te,etd->td", gates, ye)
    if mo.n_shared:
        yt = yt + mlp(p["shared"], xt)
    return yt.reshape(b, s, d), _aux(probs, gate_idx, e, k)


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
        # on DTensors the whole batch's ids: DTensor (torch 2.11) lays out
        # no backward (index_put) of a lookup by batch-sharded ids, so
        # every data rank looks up all rows and ``constrain_batch`` cuts
        return table[replicated(ids).long()]
    return table.detach()[ids.long()] + tap


def tied_logits(table: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """Projection through the shared embedding: the DENSE cotangent
    contribution to the tied weight."""
    return h @ table.t()


# ---------------------------------------------------------------------------
# Wait-free backprop: per-block gradient hook
# ---------------------------------------------------------------------------

class _BlockHook(torch.autograd.Function):
    """Identity over a block's leaves whose backward hands the leaves'
    gradients to ``bwd_fn`` and hands nothing on to the leaves.
    Autograd runs a node once every output's gradient has arrived, so
    ``bwd_fn`` sees the whole block at once."""

    @staticmethod
    def forward(ctx, bwd_fn, treedef, *leaves):
        ctx.bwd_fn, ctx.treedef = bwd_fn, treedef
        return leaves

    @staticmethod
    def backward(ctx, *grads):
        ctx.bwd_fn(tree_unflatten(ctx.treedef, list(grads)))
        return (None, None) + (None,) * len(grads)


def backward_hook(bwd_fn):
    """Identity boundary on a parameter block whose backward runs
    ``bwd_fn(g_block)`` on the block's gradient tree (zeros for an unused
    leaf) the moment autograd has all of it (the reference's
    ``custom_vjp`` hook, ``repro.models.layers``): the wait-free exchange
    launches the block's bucket collectives there, while earlier layers
    are still differentiating.  Nothing flows on to the block's leaves,
    so ``torch.autograd.grad`` returns ``None`` for them; what the hook
    computes (and any state it updates) it keeps in its closure, where
    JAX threads it out as a cotangent.  The returned ``hook(block) ->
    block`` is an exact identity in forward, so every gradient is
    bitwise the unhooked model's."""
    def hook(block):
        leaves, treedef = tree_flatten(block)
        return tree_unflatten(treedef, list(
            _BlockHook.apply(bwd_fn, treedef, *leaves)))

    return hook
