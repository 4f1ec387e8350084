"""Model assembly for the ported families (``repro.models.model``):

  audio   enc-dec decoder with cross-attention to encoder-state
          embeddings (the paper's transformer-big)
  hybrid  Zamba2: a Mamba2 stack with ONE shared attention block applied
          after every ``attn_every`` Mamba2 blocks (training through the
          differentiable ``ssd_chunked``, as the reference trains it; the
          SSD kernels serve the forward path only)

Training runs ``loss``/``forward``; the prefill step runs ``forward``
and ``head`` on the last position; serving runs ``init_cache``,
``prefill`` and ``decode_step`` (``repro.models.model``'s serving API).

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
from repro_torch.models import ssm as S
from repro_torch.tree import tree_flatten, tree_unflatten

FAMILIES = ("audio", "hybrid")

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
           positions: torch.Tensor, cache: Optional[Dict],
           enc: Optional[torch.Tensor], window: Optional[int],
           attn_impl: str) -> Tuple[torch.Tensor, Optional[Dict]]:
    """Pre-norm self-attention (cached when ``cache`` is given),
    cross-attention to ``enc`` and SwiGLU.  Returns (x, new cache); the
    reference's third output, the MoE auxiliary loss, is always zero for
    this family and is left out."""
    a, new_cache = L.attention(p["attn"], cfg,
                               L.rmsnorm(p["norm1"], x, cfg.norm_eps),
                               positions, kv_cache=cache, window=window,
                               attn_impl=attn_impl)
    x = x + a
    if enc is not None and "xattn" in p:
        x = x + L.cross_attention(p["xattn"], cfg,
                                  L.rmsnorm(p["norm_x"], x, cfg.norm_eps),
                                  enc, attn_impl=attn_impl)
    return x + L.mlp(p["ffn"], L.rmsnorm(p["norm2"], x, cfg.norm_eps)), \
        new_cache


def _unstack(stacked: Params):
    """Per-layer views of a stacked layer tree (one ``unbind`` per leaf,
    so backward stacks each leaf's gradient once)."""
    leaves, treedef = tree_flatten(stacked)
    cols = [leaf.unbind(0) for leaf in leaves]
    return [tree_unflatten(treedef, [c[i] for c in cols])
            for i in range(len(cols[0]))]


def _to(tree, device) -> Params:
    leaves, treedef = tree_flatten(tree)
    return tree_unflatten(treedef, [t.to(device) for t in leaves])


def _stacked(n: int, draw, device) -> Params:
    """``n`` layers from ``draw()`` (one layer's tree, drawn on the host)
    stacked on a leading axis of tensors allocated once on ``device``,
    each layer copied into its slot before the next is drawn."""
    leaves, treedef = tree_flatten(draw())
    out = [torch.empty((n,) + tuple(t.shape), dtype=t.dtype, device=device)
           for t in leaves]
    for i in range(n):
        if i:
            leaves = tree_flatten(draw())[0]
        for dst, src in zip(out, leaves):
            dst[i].copy_(src)
    return tree_unflatten(treedef, out)


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ArchConfig

    def __post_init__(self):
        if self.cfg.family not in FAMILIES:
            raise ValueError(f"the port models the {' and '.join(FAMILIES)} "
                             f"families, got {self.cfg.family!r}")

    def init(self, seed: int = 0, device="cuda") -> Params:
        """Random parameters with the reference's distributions, drawn on
        the CPU from ``torch.Generator().manual_seed(seed)`` (so a seed
        gives the same weights on every device) and placed on
        ``device``: the card unless the caller asks for ``"cpu"``.
        ``device="meta"`` gives shapes and dtypes only.  Stacked layers
        are drawn one layer at a time straight into their slot on
        ``device``, so the host never holds more than one layer."""
        device = torch.device(device)
        gen = (None if device.type == "meta"
               else torch.Generator().manual_seed(seed))
        return self._init(gen, device)

    def _init(self, gen: Optional[torch.Generator], device) -> Params:
        cfg = self.cfg
        dt = L._dtype(cfg)
        host = "meta" if gen is None else "cpu"
        params: Params = {
            "embedding": L.init_embedding(gen, cfg.vocab, cfg.d_model, dt,
                                          host).to(device),
            "final_norm": L.init_rmsnorm(cfg.d_model, dt, device),
        }
        if not cfg.tied_embeddings:
            params["lm_head"] = L.dense_init(gen, (cfg.d_model, cfg.vocab),
                                             host, dtype=dt).to(device)
        if cfg.family == "hybrid":
            params["mamba"] = _stacked(
                cfg.n_layers, lambda: S.init_mamba2(gen, cfg, host), device)
            params["shared_attn"] = _to(_init_block(gen, cfg, host),
                                        device)            # ONE shared
        else:
            params["layers"] = _stacked(
                cfg.n_layers, lambda: _init_block(gen, cfg, host), device)
        return params

    def head(self, params: Params, h: torch.Tensor) -> torch.Tensor:
        if self.cfg.tied_embeddings:
            return L.tied_logits(params["embedding"], h)
        return h @ params["lm_head"]

    def forward(self, params: Params, batch: Dict[str, torch.Tensor],
                taps: Optional[torch.Tensor] = None,
                window: Optional[int] = None,
                attn_impl: str = "chunked") -> torch.Tensor:
        """Final hidden states (B, S, d) at the token positions.
        ``attn_impl`` as in ``repro_torch.kernels.ops``: "chunked"
        (training, differentiable), "kernel" (the flash attention kernel,
        forward only: the prefill step) or "ref".  In the hybrid family
        it also routes the Mamba2 blocks' SSD scan: "kernel" through the
        SSD kernel, the others through the plain ``ssd_chunked``."""
        cfg = self.cfg
        x = L.embed(params["embedding"], batch["tokens"], tap=taps)
        positions = torch.arange(x.shape[1], device=x.device)
        if cfg.family == "hybrid":
            x = self._hybrid_forward(params, x, positions, window,
                                     attn_impl)
        else:
            enc = None
            if cfg.frontend is not None:
                enc = batch["frontend"].to(x.dtype)
            for lp in _unstack(params["layers"]):
                x, _ = _block(lp, cfg, x, positions, None, enc, window,
                              attn_impl)
        return L.rmsnorm(params["final_norm"], x, cfg.norm_eps)

    def _segments(self):
        """Mamba2 layer ids of each segment that ends in the shared
        block, and the trailing ones after the last segment."""
        period, n = self.cfg.attn_every, self.cfg.n_layers
        n_seg = n // period
        return ([range(i * period, (i + 1) * period) for i in range(n_seg)],
                range(n_seg * period, n))

    def _hybrid_forward(self, params, x, positions, window, attn_impl):
        cfg = self.cfg
        route = "kernel" if attn_impl == "kernel" else "chunked"
        mamba = _unstack(params["mamba"])
        segments, trailing = self._segments()
        for seg in segments:
            for i in seg:
                x = x + S.mamba2_forward(mamba[i], cfg, x, ssd_route=route)
            x, _ = _block(params["shared_attn"], cfg, x, positions, None,
                          None, window, attn_impl)
        for i in trailing:
            x = x + S.mamba2_forward(mamba[i], cfg, x, ssd_route=route)
        return x

    def loss(self, params: Params, batch: Dict[str, torch.Tensor],
             taps: Optional[torch.Tensor] = None,
             window: Optional[int] = None,
             loss_chunk: int = 1024,
             attn_impl: str = "chunked") -> Tuple[torch.Tensor, Dict]:
        """Token-mean cross-entropy, computed ``loss_chunk`` positions at
        a time so only one chunk's f32 logits are live."""
        h = self.forward(params, batch, taps=taps, window=window,
                         attn_impl=attn_impl)
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

    # ---------------- serving ----------------
    def init_cache(self, batch: int, cache_len: int, device="cuda") -> Dict:
        """Zeros cache with "length": (B,) int32.  Audio: {"k", "v":
        (n_layers, B, cache_len, KV, HD)} in the model's dtype.  Hybrid:
        "mamba", each Mamba2 block's recurrent cache stacked over
        n_layers (``ssm.mamba2_init_cache``), and "attn": {"k", "v":
        (n_segments, B, cache_len, KV, HD)}, one per use of the shared
        block.  ``cache_len`` is the longest sequence (full cache) or the
        window (ring cache)."""
        cfg = self.cfg
        dt = L._dtype(cfg)
        length = torch.zeros((batch,), dtype=torch.int32, device=device)
        n_kv = cfg.n_layers
        if cfg.family == "hybrid":
            n_kv = cfg.n_layers // cfg.attn_every
        shape = (n_kv, batch, cache_len, cfg.n_kv_heads,
                 cfg.resolved_head_dim)
        kv = {"k": torch.zeros(shape, dtype=dt, device=device),
              "v": torch.zeros(shape, dtype=dt, device=device)}
        if cfg.family != "hybrid":
            return {"length": length, **kv}
        one = S.mamba2_init_cache(cfg, batch, dt, device)
        mamba = {k: torch.zeros((cfg.n_layers,) + tuple(v.shape),
                                dtype=v.dtype, device=device)
                 for k, v in one.items()}
        return {"length": length, "mamba": mamba, "attn": kv}

    def prefill(self, params: Params, cache: Dict, tokens: torch.Tensor,
                enc: Optional[torch.Tensor] = None,
                window: Optional[int] = None, attn_impl: str = "chunked",
                ring: bool = False) -> Tuple[torch.Tensor, Dict]:
        """Sequential prefill: feed ``tokens`` (B, S) one position at a
        time through ``decode_step``; returns (last logits (B, vocab),
        cache)."""
        logits = None
        for i in range(tokens.shape[1]):
            logits, cache = self.decode_step(
                params, cache, tokens[:, i:i + 1], enc=enc, window=window,
                attn_impl=attn_impl, ring=ring)
        return logits, cache

    def decode_step(self, params: Params, cache: Dict,
                    tokens: torch.Tensor,
                    enc: Optional[torch.Tensor] = None,
                    window: Optional[int] = None,
                    attn_impl: str = "chunked", ring: bool = False,
                    n_valid: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, Dict]:
        """One decode step: tokens (B, 1) -> logits (B, vocab) and the
        new cache.  ``enc`` (B, F, d) are the encoder states that every
        layer cross-attends (through ``attn_impl``); the cached
        self-attention is ``decode_attention``.

        Chunked prefill: tokens (B, s) with s > 1 run all s positions in
        one step (non-ring caches; the per-row causal mask keeps it
        exact) and return all s logit rows (B, s, vocab).  ``n_valid``
        (B,), when given, is the count of real tokens per slot: the cache
        length advances by it instead of s."""
        cfg = self.cfg
        x = L.embed(params["embedding"], tokens)
        s = x.shape[1]
        length = cache["length"]
        positions = length[:, None] + torch.arange(s, device=x.device)
        if cfg.family == "hybrid":
            x, cache = self._hybrid_decode(params, cache, x, positions, enc,
                                           window, attn_impl, ring)
        else:
            ks, vs = [], []
            for i, lp in enumerate(_unstack(params["layers"])):
                lc = {"k": cache["k"][i], "v": cache["v"][i],
                      "length": length, "ring": ring}
                x, nc = _block(lp, cfg, x, positions, lc, enc, window,
                               attn_impl)
                ks.append(nc["k"])
                vs.append(nc["v"])
            cache = {**cache, "k": torch.stack(ks), "v": torch.stack(vs)}
        step = n_valid if n_valid is not None else s
        cache = {**cache, "length": (length + step).to(length.dtype)}
        logits = self.head(params, L.rmsnorm(params["final_norm"], x,
                                             cfg.norm_eps))
        return (logits if s > 1 else logits[:, -1]), cache

    def _hybrid_decode(self, params, cache, x, positions, enc, window,
                       attn_impl, ring):
        """One token through the Mamba2 blocks (``mamba2_decode``, the
        recurrent step) and the cached shared block.  Returns (x, cache
        with new "mamba" and "attn")."""
        cfg = self.cfg
        length = cache["length"]
        mamba = _unstack(params["mamba"])
        mcache = _unstack(cache["mamba"])
        new_m: list = [None] * cfg.n_layers
        ks, vs = [], []
        segments, trailing = self._segments()
        for si, seg in enumerate(segments):
            for i in seg:
                y, new_m[i] = S.mamba2_decode(mamba[i], cfg, x, mcache[i])
                x = x + y
            ac = {"k": cache["attn"]["k"][si], "v": cache["attn"]["v"][si],
                  "length": length, "ring": ring}
            x, nc = _block(params["shared_attn"], cfg, x, positions, ac, enc,
                           window, attn_impl)
            ks.append(nc["k"])
            vs.append(nc["v"])
        for i in trailing:
            y, new_m[i] = S.mamba2_decode(mamba[i], cfg, x, mcache[i])
            x = x + y
        stacked = {k: torch.stack([m[k] for m in new_m])
                   for k in cache["mamba"]}
        return x, {**cache, "mamba": stacked,
                   "attn": {"k": torch.stack(ks), "v": torch.stack(vs)}}


def _cache_len(cache: Dict) -> int:
    """The cache's sequence length, from a KV leaf: (L, B, C, ...) or, in
    the hybrid cache, (n_segments, B, C, KV, HD)."""
    if "k" in cache:
        return cache["k"].shape[2]
    return cache["attn"]["k"].shape[2]


def build_model(cfg: ArchConfig) -> Model:
    return Model(cfg=cfg)
