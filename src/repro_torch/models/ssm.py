"""Mamba2 (SSD) block: the chunked scan for prefill, an O(1) recurrent
state for decode (``repro.models.ssm``).  Used by the hybrid family
(zamba2).

Within a chunk the output is a masked attention-like product; across
chunks a small (H, N, P) state is carried.  ``mamba2_forward`` runs the
scan by one of two routes: ``"chunked"``, ``ssd_chunked`` in plain
PyTorch (the reference's model path), or ``"kernel"``,
``repro_torch.kernels.ops.ssd`` (the SSD kernel on the card, its plain
version on the CPU; forward only).
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops as kops
from repro_torch.models import layers as L
from repro_torch.models.activation_sharding import shard_local, split_heads

Params = Dict[str, Any]
NEG_INF = -1e30
SSD_ROUTES = ("chunked", "kernel")


def init_mamba2(gen: Optional[torch.Generator], cfg: ArchConfig,
                device) -> Params:
    """One block's parameters in the reference's layout and
    distributions.  ``a_log``, ``d_skip`` and ``dt_bias`` are f32 in any
    model dtype, and ``a_log`` is deterministic (Mamba2's A in [1, 16])."""
    s = cfg.ssm
    d = cfg.d_model
    d_inner = s.expand * d
    h = d_inner // s.head_dim
    n = s.state_dim
    dt = L._dtype(cfg)
    f32 = torch.float32

    def conv_init(shape):
        return (L.normal_f32(gen, shape, device)
                / math.sqrt(s.conv_dim)).to(dt)

    return {
        "w_z": L.dense_init(gen, (d, d_inner), device, dtype=dt),
        "w_x": L.dense_init(gen, (d, d_inner), device, dtype=dt),
        "w_bc": L.dense_init(gen, (d, 2 * n), device, dtype=dt),
        "w_dt": L.dense_init(gen, (d, h), device, dtype=dt),
        "conv_wx": conv_init((s.conv_dim, d_inner)),
        "conv_bx": torch.zeros((d_inner,), dtype=dt, device=device),
        "conv_wbc": conv_init((s.conv_dim, 2 * n)),
        "conv_bbc": torch.zeros((2 * n,), dtype=dt, device=device),
        "a_log": torch.log(torch.linspace(1.0, 16.0, h, dtype=f32,
                                          device=device)),
        "d_skip": torch.ones((h,), dtype=f32, device=device),
        "dt_bias": torch.full((h,), -4.6, dtype=f32, device=device),
        "norm": L.init_rmsnorm(d_inner, dt, device),
        "w_out": L.dense_init(gen, (d_inner, d), device, dtype=dt),
    }


def _split_in(p: Params, cfg: ArchConfig, u: torch.Tensor):
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    h = d_inner // s.head_dim
    n = s.state_dim
    return (u @ p["w_z"], u @ p["w_x"], u @ p["w_bc"], u @ p["w_dt"],
            d_inner, h, n)


def _causal_conv(w: torch.Tensor, b: torch.Tensor, x: torch.Tensor,
                 state: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Depthwise causal conv1d as K shifted multiply-adds in the input
    dtype (not ``F.conv1d``, which takes cuDNN's TF32 on the card).
    x (B, S, C); w (K, C); ``state`` (B, K-1, C) holds the trailing
    inputs for decode."""
    k = w.shape[0]
    if state is not None:
        xx = torch.cat([state, x], dim=1)               # (B, K-1+S, C)
        new_state = xx[:, -(k - 1):, :]
    else:
        xx = F.pad(x, (0, 0, k - 1, 0))
        new_state = None
    s = x.shape[1]
    out = xx[:, 0:s, :] * w[0]
    for i in range(1, k):
        out = out + xx[:, i:i + s, :] * w[i]
    return F.silu(out + b), new_state


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                b: torch.Tensor, c: torch.Tensor, chunk: int,
                init_state: Optional[torch.Tensor] = None,
                separable: bool = True, clip: float = 60.0
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan (``repro.models.ssm.ssd_chunked``).

    x (B, S, H, P), dt (B, S, H) post-softplus step sizes, a (H,)
    negative decay, b/c (B, S, N) shared by the heads.  Returns
    (y (B, S, H, P), final state (B, H, N, P)), f32.  ``separable``
    factors the intra-chunk decay exp(cum_i - cum_j) as
    exp(cum_i) * exp(-cum_j), with exp(-cum_j) clipped at e^clip and the
    diagonal restored exactly; ``separable=False`` builds the naive
    (i, j, H) decay tensor."""
    bb, s, h, pp = x.shape
    n = b.shape[-1]
    if s % chunk:
        raise ValueError(f"ssd_chunked: sequence {s} is not a multiple of "
                         f"the chunk {chunk}")
    nc = s // chunk
    f32 = torch.float32
    xc = x.reshape(bb, nc, chunk, h, pp).to(f32)
    dtc = dt.reshape(bb, nc, chunk, h).to(f32)
    bc = b.reshape(bb, nc, chunk, n).to(f32)
    cc = c.reshape(bb, nc, chunk, n).to(f32)

    cum = torch.cumsum(dtc * a, dim=2)                    # (B,nc,L,H) <= 0
    tri = torch.ones((chunk, chunk), dtype=torch.bool,
                     device=x.device).tril()
    scores = torch.einsum("bcin,bcjn->bcij", cc, bc)
    if separable:
        pos = torch.exp(cum)
        neg = torch.exp(torch.clamp(-cum, max=clip))
        bj = (neg * dtc)[..., None] * xc
        masked = torch.where(tri, scores, 0.0)
        y_intra = pos[..., None] * torch.einsum("bcij,bcjhp->bcihp",
                                                masked, bj)
        diag_scores = torch.einsum("bcin,bcin->bci", cc, bc)
        corr = (1.0 - pos * neg) * dtc                    # (B,nc,L,H)
        y_intra = y_intra + (diag_scores[..., None] * corr)[..., None] * xc
    else:
        diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]
        m = torch.exp(torch.where(tri[None, None, :, :, None], diff,
                                  NEG_INF))
        y_intra = torch.einsum("bcij,bcijh,bcjh,bcjhp->bcihp", scores, m,
                               dtc, xc)

    decay_to_end = torch.exp(cum[:, :, -1:, :] - cum)     # (B,nc,L,H)
    chunk_states = torch.einsum("bcjn,bcjh,bcjhp->bchnp", bc,
                                dtc * decay_to_end, xc)   # (B,nc,H,N,P)
    chunk_decay = torch.exp(cum[:, :, -1, :])             # (B,nc,H)
    state = (init_state.to(f32) if init_state is not None
             else torch.zeros((bb, h, n, pp), dtype=f32, device=x.device))
    prev = []
    for ci in range(nc):
        prev.append(state)
        state = chunk_decay[:, ci, :, None, None] * state \
            + chunk_states[:, ci]
    y_inter = torch.einsum("bcin,bchnp,bcih->bcihp", cc,
                           torch.stack(prev, 1), torch.exp(cum))
    return (y_intra + y_inter).reshape(bb, s, h, pp), state


def mamba2_forward(p: Params, cfg: ArchConfig, u: torch.Tensor,
                   ssd_route: str = "chunked") -> torch.Tensor:
    """Full-sequence Mamba2 block (prefill).  u (B, S, d) -> (B, S, d);
    ``ssd_route`` as in the module docstring."""
    if ssd_route not in SSD_ROUTES:
        raise ValueError(f"mamba2_forward: ssd_route {ssd_route!r} not in "
                         f"{SSD_ROUTES}")
    s = cfg.ssm
    z, xx, bc, dt_raw, d_inner, h, n = _split_in(p, cfg, u)
    x, _ = _causal_conv(p["conv_wx"], p["conv_bx"], xx)
    bc, _ = _causal_conv(p["conv_wbc"], p["conv_bbc"], bc)
    b = bc[..., :n]
    c = bc[..., n:]
    dt = F.softplus(dt_raw.to(torch.float32) + p["dt_bias"])
    a = -torch.exp(p["a_log"])
    seq = u.shape[1]
    chunk = min(s.chunk, seq)
    pad = (-seq) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, pad))
        b = F.pad(b, (0, 0, 0, pad))
        c = F.pad(c, (0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
    xh = x.reshape(x.shape[0], x.shape[1], h, s.head_dim)

    def scan(xh, dt, a, b, c):
        if ssd_route == "kernel":
            return kops.ssd(xh, dt, a, b, c, chunk, impl="kernel")
        return ssd_chunked(xh, dt, a, b, c, chunk)
    # local to a batch shard and a head shard on DTensors
    y, _ = shard_local(scan, (xh, dt, a, b, c), (2, 2, ("m", 0), None, None),
                       (2, 1), n=h)
    y = y + p["d_skip"][None, None, :, None] * xh.to(torch.float32)
    y = y[:, :seq].reshape(u.shape[0], seq, d_inner).to(u.dtype)
    y = y * F.silu(z)
    y = L.rmsnorm(p["norm"], y, cfg.norm_eps)
    return y @ p["w_out"]


def mamba2_init_cache(cfg: ArchConfig, batch: int, dtype: torch.dtype,
                      device) -> Dict[str, torch.Tensor]:
    """Zeros recurrent cache of one block: the conv inputs' tails in the
    model dtype and the SSM state (B, H, N, P) in f32."""
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    h = d_inner // s.head_dim
    return {
        "conv_x": torch.zeros((batch, s.conv_dim - 1, d_inner), dtype=dtype,
                              device=device),
        "conv_bc": torch.zeros((batch, s.conv_dim - 1, 2 * s.state_dim),
                               dtype=dtype, device=device),
        "ssm": torch.zeros((batch, h, s.state_dim, s.head_dim),
                           dtype=torch.float32, device=device),
    }


def mamba2_decode(p: Params, cfg: ArchConfig, u: torch.Tensor,
                  cache: Dict[str, torch.Tensor]
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One-token recurrent step.  u (B, 1, d) -> ((B, 1, d), new cache)."""
    s = cfg.ssm
    z, xx, bc, dt_raw, d_inner, h, n = _split_in(p, cfg, u)
    x, conv_x = _causal_conv(p["conv_wx"], p["conv_bx"], xx,
                             state=cache["conv_x"])
    bc, conv_bc = _causal_conv(p["conv_wbc"], p["conv_bbc"], bc,
                               state=cache["conv_bc"])
    f32 = torch.float32
    b = bc[:, 0, :n].to(f32)
    c = bc[:, 0, n:].to(f32)
    dt = F.softplus(dt_raw.to(f32) + p["dt_bias"])[:, 0]      # (B, H)
    a = -torch.exp(p["a_log"])
    xh = split_heads(x, h, s.head_dim)[:, 0].to(f32)          # (B, H, P)
    # S = exp(dt a) S + dt * B (x outer)
    decay = torch.exp(dt[:, :, None, None] * a[None, :, None, None])
    inject = torch.einsum("bn,bh,bhp->bhnp", b, dt, xh)
    state = decay * cache["ssm"] + inject
    y = torch.einsum("bn,bhnp->bhp", c, state)
    y = y + p["d_skip"][None, :, None] * xh
    y = y.reshape(u.shape[0], 1, d_inner).to(u.dtype)
    y = y * F.silu(z)
    y = L.rmsnorm(p["norm"], y, cfg.norm_eps)
    return y @ p["w_out"], {"conv_x": conv_x, "conv_bc": conv_bc,
                            "ssm": state}
