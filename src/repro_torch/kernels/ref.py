"""Plain-torch oracles for the port's kernels (``repro.kernels.ref``)."""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def densify_ref(indices: torch.Tensor, values: torch.Tensor,
                dense_shape: Tuple[int, ...]) -> torch.Tensor:
    """Scatter-add rows into a zero dense tensor (duplicates sum), in the
    values' dtype.  Rows with index < 0 or >= vocab are dropped."""
    vocab = dense_shape[0]
    valid = (indices >= 0) & (indices < vocab)
    safe = torch.where(valid, indices, torch.zeros_like(indices))
    vals = torch.where(valid[:, None], values, torch.zeros_like(values))
    zeros = torch.zeros(dense_shape, dtype=values.dtype,
                        device=values.device)
    return zeros.index_add_(0, safe.long(), vals)


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = True, window: Optional[int] = None,
                  scale: Optional[float] = None) -> torch.Tensor:
    """Multi-head attention by full softmax (``repro.kernels.ref``'s
    oracle for flash attention).

    q (B, Sq, H, D), k/v (B, Sk, H, D) -> (B, Sq, H, D) in q's dtype.
    Query i sits at position ``i + Sk - Sq``; ``window`` keeps the last
    ``window`` keys up to and including it.  Fully masked rows give 0.
    Scores are taken in the promoted input dtype, then softmaxed in f32."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    dt = torch.promote_types(q.dtype, k.dtype)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.to(dt),
                          k.to(dt)).to(torch.float32) * scale
    sq, sk = q.shape[1], k.shape[1]
    q_pos = torch.arange(sq, device=q.device)[:, None] + (sk - sq)
    k_pos = torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= q_pos >= k_pos
    if window is not None:
        mask &= (q_pos - k_pos) < window
    logits = logits.masked_fill(~mask, float("-inf"))
    p = torch.nan_to_num(torch.softmax(logits, dim=-1), nan=0.0)
    return torch.einsum("bhqk,bkhd->bqhd", p,
                        v.to(torch.float32)).to(q.dtype)


def ssd_ref(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
            b: torch.Tensor, c: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sequential-recurrence SSD oracle (exact, O(S) Python steps: tests
    only).  x (BH, S, P), dt (BH, S), a (BH,), b/c (BH, S, N).  Returns
    (y (BH, S, P), final state (BH, N, P)), both f32."""
    bh, s, p = x.shape
    n = b.shape[-1]
    f32 = torch.float32
    x, dt, b, c = (t.to(f32) for t in (x, dt, b, c))
    a = a.to(f32)
    state = torch.zeros((bh, n, p), dtype=f32, device=x.device)
    ys = []
    for t in range(s):
        decay = torch.exp(dt[:, t] * a)[:, None, None]
        state = decay * state + (dt[:, t, None] * b[:, t])[..., None] \
            * x[:, t, None, :]
        ys.append(torch.einsum("bn,bnp->bp", c[:, t], state))
    y = torch.stack(ys, 1) if ys else torch.zeros((bh, 0, p), dtype=f32,
                                                  device=x.device)
    return y, state
