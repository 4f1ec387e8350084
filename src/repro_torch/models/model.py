"""Model assembly for the ported family: ``audio`` (enc-dec decoder with
cross-attention to encoder-state embeddings; the paper's transformer-big).

Parameters are one nested dict whose per-layer leaves are stacked on a
leading ``n_layers`` axis, the reference's layout (``repro.models.model``),
so the gradient tree flattens to the same leaves, shapes, dtypes and order
in both packages.  The embedding can run in sparse-instrumentation mode
(``taps``) to emit true IndexedSlices gradients — see
``repro_torch.training.gradients``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers as L
from repro_torch.tree import tree_flatten, tree_map, tree_unflatten

Params = Dict[str, Any]


def _init_block(gen, cfg: ArchConfig, device) -> Params:
    dt = L._dtype(cfg)
    p: Params = {"norm1": L.init_rmsnorm(cfg.d_model, dt, device),
                 "norm2": L.init_rmsnorm(cfg.d_model, dt, device),
                 "attn": L.init_attention(gen, cfg, device),
                 "ffn": L.init_mlp(gen, cfg.d_model, cfg.d_ff, dt, device)}
    if cfg.frontend is not None and cfg.frontend.cross_attention:
        p["norm_x"] = L.init_rmsnorm(cfg.d_model, dt, device)
        p["xattn"] = L.init_cross_attention(gen, cfg, device)
    return p


def _block(p: Params, cfg: ArchConfig, x: torch.Tensor,
           positions: torch.Tensor, enc: Optional[torch.Tensor],
           window: Optional[int]) -> torch.Tensor:
    """Pre-norm self-attention, cross-attention and SwiGLU block."""
    x = x + L.attention(p["attn"], cfg, L.rmsnorm(p["norm1"], x,
                                                  cfg.norm_eps),
                        positions, window=window)
    if enc is not None and "xattn" in p:
        x = x + L.cross_attention(p["xattn"], cfg,
                                  L.rmsnorm(p["norm_x"], x, cfg.norm_eps),
                                  enc)
    return x + L.mlp(p["ffn"], L.rmsnorm(p["norm2"], x, cfg.norm_eps))


def _unstack(stacked: Params):
    """Per-layer views of a stacked layer tree (one ``unbind`` per leaf,
    so backward stacks each leaf's gradient once)."""
    leaves, treedef = tree_flatten(stacked)
    cols = [leaf.unbind(0) for leaf in leaves]
    return [tree_unflatten(treedef, [c[i] for c in cols])
            for i in range(len(cols[0]))]


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ArchConfig

    def __post_init__(self):
        if self.cfg.family != "audio":
            raise ValueError(f"the port models the audio (enc-dec) family "
                             f"only, got {self.cfg.family!r}")

    def init(self, seed: int = 0, device="cpu") -> Params:
        """Random parameters with the reference's distributions, drawn on
        the CPU from ``torch.Generator().manual_seed(seed)`` (so a seed
        gives the same weights on every device) and moved to ``device``.
        ``device="meta"`` gives shapes and dtypes only."""
        device = torch.device(device)
        if device.type == "meta":
            return self._init(None, device)
        params = self._init(torch.Generator().manual_seed(seed), "cpu")
        return tree_map(lambda p: p.to(device), params)

    def _init(self, gen: Optional[torch.Generator], device) -> Params:
        cfg = self.cfg
        dt = L._dtype(cfg)
        params: Params = {
            "embedding": L.init_embedding(gen, cfg.vocab, cfg.d_model, dt,
                                          device),
            "final_norm": L.init_rmsnorm(cfg.d_model, dt, device),
        }
        if not cfg.tied_embeddings:
            params["lm_head"] = L.dense_init(gen, (cfg.d_model, cfg.vocab),
                                             device, dtype=dt)
        blocks = [_init_block(gen, cfg, device) for _ in range(cfg.n_layers)]
        _, treedef = tree_flatten(blocks[0])
        cols = zip(*(tree_flatten(b)[0] for b in blocks))
        params["layers"] = tree_unflatten(treedef,
                                          [torch.stack(c) for c in cols])
        return params

    def head(self, params: Params, h: torch.Tensor) -> torch.Tensor:
        if self.cfg.tied_embeddings:
            return L.tied_logits(params["embedding"], h)
        return h @ params["lm_head"]

    def forward(self, params: Params, batch: Dict[str, torch.Tensor],
                taps: Optional[torch.Tensor] = None,
                window: Optional[int] = None) -> torch.Tensor:
        """Final hidden states (B, S, d) at the token positions."""
        cfg = self.cfg
        x = L.embed(params["embedding"], batch["tokens"], tap=taps)
        enc = None
        if cfg.frontend is not None:
            enc = batch["frontend"].to(x.dtype)
        positions = torch.arange(x.shape[1], device=x.device)
        for lp in _unstack(params["layers"]):
            x = _block(lp, cfg, x, positions, enc, window)
        return L.rmsnorm(params["final_norm"], x, cfg.norm_eps)

    def loss(self, params: Params, batch: Dict[str, torch.Tensor],
             taps: Optional[torch.Tensor] = None,
             window: Optional[int] = None,
             loss_chunk: int = 1024) -> Tuple[torch.Tensor, Dict]:
        """Token-mean cross-entropy, computed ``loss_chunk`` positions at
        a time so only one chunk's f32 logits are live."""
        h = self.forward(params, batch, taps=taps, window=window)
        labels = batch["labels"].long()
        mask = batch.get("loss_mask")
        if mask is None:
            mask = torch.ones(labels.shape, dtype=torch.float32,
                              device=labels.device)
        s = labels.shape[1]
        chunk = min(loss_chunk, s)
        pad = (-s) % chunk
        if pad:
            h = F.pad(h, (0, 0, 0, pad))
            labels = F.pad(labels, (0, pad))
            mask = F.pad(mask, (0, pad))
        tot = torch.zeros((), dtype=torch.float32, device=h.device)
        cnt = torch.zeros((), dtype=torch.float32, device=h.device)
        for c in range(0, s + pad, chunk):
            logits = self.head(params, h[:, c:c + chunk]).to(torch.float32)
            lse = torch.logsumexp(logits, dim=-1)
            picked = torch.gather(logits, -1,
                                  labels[:, c:c + chunk, None])[..., 0]
            mm = mask[:, c:c + chunk]
            tot = tot + torch.sum((lse - picked) * mm)
            cnt = cnt + torch.sum(mm)
        ce = tot / torch.clamp(cnt, min=1.0)
        metrics = {"ce": ce, "aux": torch.zeros_like(ce), "tokens": cnt}
        return ce, metrics


def build_model(cfg: ArchConfig) -> Model:
    return Model(cfg=cfg)
