"""xLSTM blocks: mLSTM (matrix memory) and sLSTM (scalar memory with
exponential gating), both as the stabilised recurrence of
``repro.models.xlstm``, a Python loop over the time steps.

The recurrence is exact for training and decode alike: decode carries a
constant-size (H, P, P) matrix state per mLSTM block.  As in the
reference, q, k and v enter the mLSTM recurrence in f32, and every gate
and state is f32 in any model dtype.  Each step is about a dozen eager
launches per block (a chunkwise-parallel mLSTM would be a speed item,
not a change of semantics).
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers as L
from repro_torch.models.activation_sharding import shard_local, split_heads

Params = Dict[str, Any]
F32 = torch.float32


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

def init_mlstm(gen: Optional[torch.Generator], cfg: ArchConfig,
               device) -> Params:
    """Up-projection to [x, gate z] (d, 2 * d_inner), q/k/v (d_inner,
    d_inner), f32 input and forget gates (d_inner, H) with biases 0 and
    3 (forget gates open at init), a norm and the down-projection."""
    d = cfg.d_model
    d_inner = cfg.xlstm.mlstm_expand * d
    h = cfg.n_heads
    dt = L._dtype(cfg)
    return {
        "w_up": L.dense_init(gen, (d, 2 * d_inner), device, dtype=dt),
        "wq": L.dense_init(gen, (d_inner, d_inner), device, dtype=dt),
        "wk": L.dense_init(gen, (d_inner, d_inner), device, dtype=dt),
        "wv": L.dense_init(gen, (d_inner, d_inner), device, dtype=dt),
        "wi": L.dense_init(gen, (d_inner, h), device),
        "wf": L.dense_init(gen, (d_inner, h), device),
        "bi": torch.zeros((h,), dtype=F32, device=device),
        "bf": torch.full((h,), 3.0, dtype=F32, device=device),
        "norm": L.init_rmsnorm(d_inner, dt, device),
        "w_down": L.dense_init(gen, (d_inner, d), device, dtype=dt),
    }


def _mlstm_scan(q, k, v, i_pre, f_pre, state):
    """Stabilised mLSTM recurrence.  q/k/v (B, S, H, P); i/f (B, S, H)
    f32.  state: {"c": (B, H, P, P), "n": (B, H, P), "m": (B, H)}, f32.
    Returns (y (B, S, H, P) f32, state).

    Each step is the reference's, with what does not depend on c or n
    taken out of the matrix loop and computed for every step at once
    (the same operations on the same values, so the same bits): the
    stabiliser m_t = max(log sigmoid(f_t) + m_{t-1}, i_t) runs as a scan
    of its own over (B, H), then the gates exp(i_t - m_t) and
    exp(log sigmoid(f_t) + m_{t-1} - m_t) and the floor exp(-m_t)."""
    s, p = q.shape[1], q.shape[-1]
    scale = p ** -0.5
    qs = q.to(F32) * scale
    ks = k.to(F32) * scale
    vs = v.to(F32)
    logf = F.logsigmoid(f_pre)
    m, ms = state["m"], []
    for t in range(s):
        m = torch.maximum(logf[:, t] + m, i_pre[:, t])
        ms.append(m)
    m_new = torch.stack(ms, dim=1)
    m_prev = torch.cat([state["m"][:, None], m_new[:, :-1]], dim=1)
    ik = torch.exp(i_pre - m_new)[..., None] * ks      # i_t k_t
    f_ = torch.exp(logf + m_prev - m_new)
    floor = torch.exp(-m_new)
    c, n = state["c"], state["n"]
    ys = []
    for t in range(s):
        qt, ft, kt = qs[:, t], f_[:, t], ik[:, t]
        c = ft[..., None, None] * c + kt[..., :, None] * vs[:, t, :, None, :]
        n = ft[..., None] * n + kt
        hn = torch.einsum("bhp,bhpo->bho", qt, c)
        denom = torch.maximum(torch.abs(torch.einsum("bhp,bhp->bh", qt, n)),
                              floor[:, t])[..., None]
        ys.append(hn / denom)
    return torch.stack(ys, dim=1), {"c": c, "n": n, "m": m}


def mlstm_init_state(cfg: ArchConfig, batch: int, device) -> Dict:
    """Zeros c and n, and m = -1e30: the first step's forget term
    exp(logf + m - m_new) underflows to 0."""
    d_inner = cfg.xlstm.mlstm_expand * cfg.d_model
    h = cfg.n_heads
    p = d_inner // h
    return {"c": torch.zeros((batch, h, p, p), dtype=F32, device=device),
            "n": torch.zeros((batch, h, p), dtype=F32, device=device),
            "m": torch.full((batch, h), -1e30, dtype=F32, device=device)}


def mlstm_forward(p: Params, cfg: ArchConfig, u: torch.Tensor,
                  state: Optional[Dict] = None
                  ) -> Tuple[torch.Tensor, Dict]:
    """u (B, S, d) -> (y (B, S, d), state after the last step).  The
    gates are f32 products of the f32-cast input; the recurrence's
    output is cast to u's dtype, gated by silu(z) and normed."""
    b, s, d = u.shape
    d_inner = cfg.xlstm.mlstm_expand * d
    h = cfg.n_heads
    ph = d_inner // h
    up = u @ p["w_up"]
    xin, z = up[..., :d_inner], up[..., d_inner:]
    q = split_heads(xin @ p["wq"], h, ph)
    k = split_heads(xin @ p["wk"], h, ph)
    v = split_heads(xin @ p["wv"], h, ph)
    x32 = xin.to(F32)
    i_pre = x32 @ p["wi"] + p["bi"]
    f_pre = x32 @ p["wf"] + p["bf"]
    if state is None:
        state = mlstm_init_state(cfg, b, u.device)

    def scan(q, k, v, i_pre, f_pre, c, n, m):
        y, st = _mlstm_scan(q, k, v, i_pre, f_pre, {"c": c, "n": n, "m": m})
        # the heads merged here: DTensor has no view that splits them
        # again for the backward where they did not shard
        return (y.reshape(y.shape[0], y.shape[1], -1), st["c"], st["n"],
                st["m"])
    # local to a batch shard and a head shard on DTensors
    y, c, n, m = shard_local(
        scan, (q, k, v, i_pre, f_pre, state["c"], state["n"], state["m"]),
        (2, 2, 2, 2, 2, 1, 1, 1), (2, 1, 1, 1), n=h)
    state = {"c": c, "n": n, "m": m}
    y = y.to(u.dtype) * F.silu(z)
    y = L.rmsnorm(p["norm"], y, cfg.norm_eps)
    return y @ p["w_down"], state


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

def init_slstm(gen: Optional[torch.Generator], cfg: ArchConfig,
               device) -> Params:
    """Input weights for [z, i, f, o] (d, 4d); f32 block-diagonal
    recurrent weights per head (H, P, 4P) ~ N(0, 1/P); f32 biases, 3 on
    the forget gate; a norm and the FFN (d, int(d * slstm_ff_mult))."""
    d = cfg.d_model
    h = cfg.n_heads
    ph = d // h
    d_ff = int(d * cfg.xlstm.slstm_ff_mult)
    dt = L._dtype(cfg)
    b_zifo = torch.zeros((4 * d,), dtype=F32, device=device)
    b_zifo[2 * d:3 * d] = 3.0                   # forget-gate bias
    return {
        "w_zifo": L.dense_init(gen, (d, 4 * d), device, dtype=dt),
        "r_zifo": L.dense_init(gen, (h, ph, 4 * ph), device,
                               scale=1.0 / math.sqrt(ph)),
        "b_zifo": b_zifo,
        "norm": L.init_rmsnorm(d, dt, device),
        "w_ff1": L.dense_init(gen, (d, d_ff), device, dtype=dt),
        "w_ff2": L.dense_init(gen, (d_ff, d), device, dtype=dt),
    }


def slstm_init_state(cfg: ArchConfig, batch: int, device) -> Dict:
    """c, h and m zero, n one (f32, (B, d) each)."""
    d = cfg.d_model
    return {"c": torch.zeros((batch, d), dtype=F32, device=device),
            "n": torch.ones((batch, d), dtype=F32, device=device),
            "h": torch.zeros((batch, d), dtype=F32, device=device),
            "m": torch.zeros((batch, d), dtype=F32, device=device)}


def slstm_forward(p: Params, cfg: ArchConfig, u: torch.Tensor,
                  state: Optional[Dict] = None
                  ) -> Tuple[torch.Tensor, Dict]:
    """u (B, S, d) -> (y (B, S, d), state after the last step): the
    exponentially gated recurrence over u W_zifo (f32), its hidden states
    cast to u's dtype, normed, then the FFN with the tanh GELU
    (``jax.nn.gelu``'s default)."""
    b, s, d = u.shape
    h = cfg.n_heads
    ph = d // h
    pre = (u @ p["w_zifo"]).to(F32)
    if state is None:
        state = slstm_init_state(cfg, b, u.device)

    def scan(pre, r_zifo, b_zifo, c, n, hh, m):
        bl = pre.shape[0]
        ys = []
        for t in range(s):
            rec = torch.einsum("bhp,hpf->bhf", hh.reshape(bl, h, ph),
                               r_zifo).reshape(bl, 4 * d)
            zifo = pre[:, t] + rec + b_zifo
            z_, i_, f_, o_ = torch.split(zifo, d, dim=-1)
            z = torch.tanh(z_)
            o = torch.sigmoid(o_)
            logf = F.logsigmoid(f_)
            m_new = torch.maximum(logf + m, i_)
            i_s = torch.exp(i_ - m_new)
            f_s = torch.exp(logf + m - m_new)
            c = f_s * c + i_s * z
            n = f_s * n + i_s
            hh = o * c / torch.clamp(n, min=1e-6)
            m = m_new
            ys.append(hh)
        return torch.stack(ys, dim=1), c, n, hh, m
    # local to a batch shard on DTensors; the gates interleave the heads
    # within each of z, i, f and o, so every model rank runs them all
    y, c, n, hh, m = shard_local(
        scan, (pre, p["r_zifo"], p["b_zifo"], state["c"], state["n"],
               state["h"], state["m"]),
        (None, "r", "r", None, None, None, None), (None,) * 5, n=0)
    y = y.to(u.dtype)
    y = L.rmsnorm(p["norm"], y, cfg.norm_eps)
    out = F.gelu(y @ p["w_ff1"], approximate="tanh") @ p["w_ff2"]
    return out, {"c": c, "n": n, "h": hh, "m": m}
