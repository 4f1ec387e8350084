"""Model assembly for the ported families (``repro.models.model``):

  audio   enc-dec decoder with cross-attention to encoder-state
          embeddings (the paper's transformer-big, seamless-m4t)
  dense   llama/qwen/chatglm/deepseek-7b style decoder (GQA, SwiGLU,
          optional q/k/v biases)
  moe     the dense skeleton with a routed MoE FFN and shared experts
          (llama4-scout): grouped capacity dispatch in training and the
          prefill step, dropless (or ``moe_mode="capacity"``) in decode;
          the router's load-balance loss joins the training loss; with
          ``cfg.mla`` the attention is DeepSeek-V2's latent attention
          (deepseek-v2), its cache the compressed c_kv and rope key
  ssm     xLSTM (xlstm-125m): block i is sLSTM iff i % slstm_every == 1,
          else mLSTM; every layer holds both blocks' parameters, as the
          reference's stacked layout does, and uses one
  hybrid  Zamba2: a Mamba2 stack with ONE shared attention block applied
          after every ``attn_every`` Mamba2 blocks (training through the
          differentiable ``ssd_chunked``, as the reference trains it; the
          SSD kernels serve the forward path only)
  vlm     dense decoder consuming [patch embeddings ; token embeddings]:
          the vision prefix without cross-attention (internvl2)

Training runs ``loss``/``forward``; the prefill step runs ``forward``
and ``head`` on the last position; serving runs ``init_cache``,
``prefill``, ``decode_step`` and ``reset_slots`` (``repro.models.model``'s
serving API).

``remat=True`` (training routes only) rematerialises what the
reference wraps in ``jax.checkpoint``: each block of the dense, moe,
audio and vlm families, each hybrid segment (its Mamba2 layers and the
shared block; the trailing layers are not wrapped) and each xLSTM layer,
through ``torch.utils.checkpoint`` (non-reentrant).  The backward
recomputes the unit's forward, with the same ops on the same inputs, so
losses and gradients are bitwise the plain ones'.  The residual stream
passes ``constrain_batch`` where the reference's does (the embedding, each
block's output, the hybrid and xLSTM layer bodies): the identity unless a
partitioned step has installed its data axes
(``repro_torch.models.activation_sharding``).

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
from repro_torch.models.activation_sharding import (constrain_batch,
                                                    logsumexp,
                                                    vocab_sharded)
from repro_torch.models import ssm as S
from repro_torch.models import xlstm as X
from repro_torch.tree import tree_flatten, tree_unflatten

FAMILIES = ("audio", "dense", "hybrid", "moe", "ssm", "vlm")
MOE_MODES = ("dropless", "capacity")

Params = Dict[str, Any]


def _init_block(gen, cfg: ArchConfig, device) -> Params:
    dt = L._dtype(cfg)
    p: Params = {"norm1": L.init_rmsnorm(cfg.d_model, dt, device),
                 "norm2": L.init_rmsnorm(cfg.d_model, dt, device),
                 "attn": (L.init_mla(gen, cfg, device)
                          if cfg.mla is not None
                          else L.init_attention(gen, cfg, device)),
                 "ffn": (L.init_moe(gen, cfg, device) if cfg.moe is not None
                         else L.init_mlp(gen, cfg.d_model, cfg.d_ff, dt,
                                         device))}
    if cfg.frontend is not None and cfg.frontend.cross_attention:
        p["norm_x"] = L.init_rmsnorm(cfg.d_model, dt, device)
        p["xattn"] = L.init_cross_attention(gen, cfg, device)
    return p


def _block(p: Params, cfg: ArchConfig, x: torch.Tensor,
           positions: torch.Tensor, cache: Optional[Dict],
           enc: Optional[torch.Tensor], window: Optional[int],
           attn_impl: str, moe_mode: str = "dropless"
           ) -> Tuple[torch.Tensor, Optional[Dict], torch.Tensor]:
    """Pre-norm self-attention (MLA where the config has it; cached when
    ``cache`` is given), cross-attention to ``enc`` and the FFN: SwiGLU,
    or the MoE FFN.
    Returns (x, new cache, the MoE aux loss: zero without experts).

    MoE without a cache (training, the prefill step): grouped capacity
    dispatch.  With one (decode): dropless, or under
    ``moe_mode="capacity"`` one group of the t = B*s decode tokens with
    ``cap = min(max(8, ceil(4 t k / E)), t)``, four times the balanced
    load."""
    attn_fn = L.mla_attention if cfg.mla is not None else L.attention
    a, new_cache = attn_fn(p["attn"], cfg,
                           L.rmsnorm(p["norm1"], x, cfg.norm_eps),
                           positions, kv_cache=cache, window=window,
                           attn_impl=attn_impl)
    # the reference pins the block's output only, which GSPMD's two-way
    # propagation carries back to these adds; DTensor propagates forward
    # only, so each add is pinned here (the identity unpartitioned)
    x = constrain_batch(x + a)
    if enc is not None and "xattn" in p:
        x = constrain_batch(x + L.cross_attention(
            p["xattn"], cfg, L.rmsnorm(p["norm_x"], x, cfg.norm_eps), enc,
            attn_impl=attn_impl))
    h = L.rmsnorm(p["norm2"], x, cfg.norm_eps)
    if cfg.moe is None:
        return constrain_batch(x + L.mlp(p["ffn"], h)), new_cache, \
            torch.zeros((), dtype=torch.float32, device=x.device)
    if cache is not None and moe_mode == "capacity":
        t = x.shape[0] * x.shape[1]
        mo = cfg.moe
        cap = max(8, -(-t * mo.top_k * 4 // mo.n_experts))
        f, aux = L.moe_ffn(p["ffn"], cfg, h, group_size=t,
                           capacity_override=min(cap, t))
    else:
        f, aux = L.moe_ffn(p["ffn"], cfg, h, dropless=cache is not None)
    return constrain_batch(x + f), new_cache, aux


def _rematted(fn, remat: bool):
    """``fn`` itself, or under ``remat`` a function that runs it through
    ``torch.utils.checkpoint`` (non-reentrant; the model draws no random
    numbers, so no RNG state is kept)."""
    if not remat:
        return fn
    from torch.utils.checkpoint import checkpoint

    def run(*args):
        return checkpoint(fn, *args, use_reentrant=False,
                          preserve_rng_state=False)
    return run


def _unstack(stacked: Params):
    """Per-layer views of a stacked layer tree (one ``unbind`` per leaf,
    so backward stacks each leaf's gradient once)."""
    leaves, treedef = tree_flatten(stacked)
    cols = [leaf.unbind(0) for leaf in leaves]
    return [tree_unflatten(treedef, [c[i] for c in cols])
            for i in range(len(cols[0]))]


def _stacked(n: int, draw, device) -> Params:
    """``n`` layers from ``draw()`` (one layer's tree) stacked on a
    leading axis of tensors allocated once on ``device``, each layer
    copied into its slot before the next is drawn, so no more than one
    layer is ever held twice."""
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
            raise ValueError(f"the port models the {', '.join(FAMILIES)} "
                             f"families, got {self.cfg.family!r}")

    def init(self, seed: int = 0, device="cuda") -> Params:
        """Random parameters with the reference's distributions, drawn on
        ``device`` (the card unless the caller asks for ``"cpu"``) from
        ``torch.Generator(device=device).manual_seed(seed)``.  A seed
        gives the same weights on every call on one kind of device, but
        the card's generator and the CPU's draw different numbers: to
        start the card from the CPU's weights, init on the CPU and copy.
        ``device="meta"`` gives shapes and dtypes only.  Stacked layers
        are drawn one layer at a time and copied into their slot, so a
        full-width model never needs the host's memory or its one
        thread."""
        device = torch.device(device)
        gen = (None if device.type == "meta"
               else torch.Generator(device=device).manual_seed(seed))
        return self._init(gen, device)

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
        if cfg.family == "hybrid":
            params["mamba"] = _stacked(
                cfg.n_layers, lambda: S.init_mamba2(gen, cfg, device),
                device)
            params["shared_attn"] = _init_block(gen, cfg,
                                                device)    # ONE shared
        elif cfg.family == "ssm":
            params["mlstm"] = _stacked(
                cfg.n_layers, lambda: X.init_mlstm(gen, cfg, device), device)
            params["slstm"] = _stacked(
                cfg.n_layers, lambda: X.init_slstm(gen, cfg, device), device)
        else:
            params["layers"] = _stacked(
                cfg.n_layers, lambda: _init_block(gen, cfg, device), device)
        return params

    def grad_blocks(self, params: Params) -> Tuple[str, ...]:
        """Top-level parameter blocks in backward-emission order: the hook
        boundaries of the wait-free exchange
        (``ExchangeConfig(overlap="backward")``).  A stacked layer tree
        (``layers``, ``mamba``, ``mlstm``, ``slstm``) gets its gradient
        in one piece once the last layer's backward is done, so the
        top-level groups are the
        finest emission events; flattening is key-sorted and backward
        emits leaves in reverse flatten order, so the partition is the
        sorted keys, reversed (as ``repro.models.model.Model``)."""
        return tuple(sorted(params.keys(), reverse=True))

    def head(self, params: Params, h: torch.Tensor) -> torch.Tensor:
        if self.cfg.tied_embeddings:
            return L.tied_logits(params["embedding"], h)
        return h @ params["lm_head"]

    def forward(self, params: Params, batch: Dict[str, torch.Tensor],
                taps: Optional[torch.Tensor] = None,
                window: Optional[int] = None,
                attn_impl: str = "chunked",
                remat: bool = False) -> torch.Tensor:
        """Final hidden states (B, S, d) at the token positions
        (``forward_aux`` without its MoE aux loss)."""
        return self.forward_aux(params, batch, taps=taps, window=window,
                                attn_impl=attn_impl, remat=remat)[0]

    def forward_aux(self, params: Params, batch: Dict[str, torch.Tensor],
                    taps: Optional[torch.Tensor] = None,
                    window: Optional[int] = None,
                    attn_impl: str = "chunked",
                    remat: bool = False
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(final hidden states, the MoE aux loss summed over the layers:
        f32, zero without experts), the reference's ``forward``.  Hidden
        states are (B, S, d) at the token positions: a vlm
        prefix (``batch["frontend"]``, B x P x d) runs ahead of the tokens
        and its positions are dropped after the final norm.
        ``attn_impl`` as in ``repro_torch.kernels.ops``: "chunked"
        (training, differentiable), "kernel" (the flash attention kernel,
        forward only: the prefill step) or "ref".  In the hybrid family
        it also routes the Mamba2 blocks' SSD scan: "kernel" through the
        SSD kernel, the others through the plain ``ssd_chunked``; the ssm
        family has no attention and ignores it.  ``remat`` as in the
        module docstring; the "kernel" route runs forward only and
        raises under it."""
        cfg = self.cfg
        if remat and attn_impl == "kernel":
            raise ValueError("remat recomputes for a backward pass, and "
                             "attn_impl='kernel' is forward only: "
                             "differentiate through 'chunked' or 'ref'")
        x = constrain_batch(L.embed(params["embedding"], batch["tokens"],
                                    tap=taps))
        enc, n_prefix = None, 0
        if cfg.frontend is not None:
            fe = batch["frontend"].to(x.dtype)
            if cfg.frontend.cross_attention:
                enc = fe
            else:                                   # vlm prefix
                n_prefix = fe.shape[1]
                x = torch.cat([fe, x], dim=1)
        positions = torch.arange(x.shape[1], device=x.device)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        if cfg.family == "hybrid":
            x = self._hybrid_forward(params, x, positions, window,
                                     attn_impl, remat)
        elif cfg.family == "ssm":
            x = self._xlstm_forward(params, x, remat)
        else:
            def block_fn(lp, xx):
                out, _, a = _block(lp, cfg, xx, positions, None, enc,
                                   window, attn_impl)
                return out, a
            block_fn = _rematted(block_fn, remat)
            for lp in _unstack(params["layers"]):
                x, a = block_fn(lp, x)
                aux = aux + a
        x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
        return (x[:, n_prefix:] if n_prefix else x), aux

    def _segments(self):
        """Mamba2 layer ids of each segment that ends in the shared
        block, and the trailing ones after the last segment."""
        period, n = self.cfg.attn_every, self.cfg.n_layers
        n_seg = n // period
        return ([range(i * period, (i + 1) * period) for i in range(n_seg)],
                range(n_seg * period, n))

    def _hybrid_forward(self, params, x, positions, window, attn_impl,
                        remat=False):
        cfg = self.cfg
        route = "kernel" if attn_impl == "kernel" else "chunked"
        mamba = _unstack(params["mamba"])
        segments, trailing = self._segments()

        def layer(lp, xx):
            return constrain_batch(
                xx + S.mamba2_forward(lp, cfg, xx, ssd_route=route))

        def seg_fn(xx, *seg_layers):
            for lp in seg_layers:
                xx = layer(lp, xx)
            return _block(params["shared_attn"], cfg, xx, positions, None,
                          None, window, attn_impl)[0]
        seg_fn = _rematted(seg_fn, remat)
        for seg in segments:
            x = seg_fn(x, *(mamba[i] for i in seg))
        for i in trailing:
            x = layer(mamba[i], x)
        return x

    def _is_slstm(self, i: int) -> bool:
        return i % self.cfg.xlstm.slstm_every == 1

    def _xlstm_forward(self, params, x, remat=False):
        """Each layer adds its sLSTM or its mLSTM block's output; the
        other block's parameters go unused (zero gradients)."""
        cfg = self.cfg

        def s_layer(ps, xx):
            return constrain_batch(xx + X.slstm_forward(ps, cfg, xx)[0])

        def m_layer(pm, xx):
            return constrain_batch(xx + X.mlstm_forward(pm, cfg, xx)[0])
        s_layer, m_layer = _rematted(s_layer, remat), _rematted(m_layer,
                                                                remat)
        for i, (pm, ps) in enumerate(zip(_unstack(params["mlstm"]),
                                         _unstack(params["slstm"]))):
            x = s_layer(ps, x) if self._is_slstm(i) else m_layer(pm, x)
        return x

    def loss(self, params: Params, batch: Dict[str, torch.Tensor],
             taps: Optional[torch.Tensor] = None,
             window: Optional[int] = None,
             loss_chunk: int = 1024,
             attn_impl: str = "chunked",
             remat: bool = False) -> Tuple[torch.Tensor, Dict]:
        """Token-mean cross-entropy, computed ``loss_chunk`` positions at
        a time so only one chunk's f32 logits are live, plus
        ``router_aux_weight`` times the MoE aux loss (``metrics["aux"]``)
        where the config has experts.  ``remat`` as in ``forward_aux``."""
        h, aux = self.forward_aux(params, batch, taps=taps, window=window,
                                  attn_impl=attn_impl, remat=remat)
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
        head_params = params
        if self.cfg.tied_embeddings:
            head_params = {**params,
                           "embedding": vocab_sharded(params["embedding"])}
        for c in range(0, s + pad, chunk):
            logits = self.head(head_params,
                               h[:, c:c + chunk]).to(torch.float32)
            lse = logsumexp(logits)
            # the difference before the trailing dim goes: gathered from
            # vocab-sharded DTensor logits, the label's logit is a masked
            # partial sum, which DTensor reduces here but not once squeezed
            nll = (lse[..., None] - torch.gather(
                logits, -1, labels[:, c:c + chunk, None]))[..., 0]
            mm = mask[:, c:c + chunk]
            tot = tot + torch.sum(nll * mm)
            cnt = cnt + torch.sum(mm)
        ce = tot / torch.clamp(cnt, min=1.0)
        total = ce
        if self.cfg.moe is not None:
            total = total + self.cfg.moe.router_aux_weight * aux
        return total, {"ce": ce, "aux": aux, "tokens": cnt}

    # ---------------- serving ----------------
    def init_cache(self, batch: int, cache_len: int, device="cuda") -> Dict:
        """A fresh cache with "length": (B,) int32.  Audio, dense, vlm and
        moe: {"k", "v": (n_layers, B, cache_len, KV, HD)} in the model's
        dtype, zeros; with MLA {"ckv": (n_layers, B, cache_len, kv_lora),
        "kr": (n_layers, B, cache_len, rope_dim)}.  Ssm: "mlstm" and "slstm",
        each block's f32 recurrent state stacked over n_layers (every
        layer has both, as the reference's); ``cache_len`` unused.
        Hybrid: "mamba", each Mamba2 block's recurrent cache stacked over
        n_layers (``ssm.mamba2_init_cache``), and "attn": {"k", "v":
        (n_segments, B, cache_len, KV, HD)}, one per use of the shared
        block.  ``cache_len`` is the longest sequence (full cache) or the
        window (ring cache)."""
        cfg = self.cfg
        dt = L._dtype(cfg)
        length = torch.zeros((batch,), dtype=torch.int32, device=device)
        if cfg.family == "ssm":
            return {"length": length,
                    "mlstm": _repeated(cfg.n_layers, X.mlstm_init_state(
                        cfg, batch, device)),
                    "slstm": _repeated(cfg.n_layers, X.slstm_init_state(
                        cfg, batch, device))}
        if cfg.mla is not None:
            m = cfg.mla
            return {"length": length,
                    "ckv": torch.zeros((cfg.n_layers, batch, cache_len,
                                        m.kv_lora), dtype=dt, device=device),
                    "kr": torch.zeros((cfg.n_layers, batch, cache_len,
                                       m.rope_dim), dtype=dt, device=device)}
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
                embeds: Optional[torch.Tensor] = None,
                window: Optional[int] = None, attn_impl: str = "chunked",
                ring: bool = False) -> Tuple[torch.Tensor, Dict]:
        """Sequential prefill: feed ``tokens`` (B, S) one position at a
        time through ``decode_step``; returns (last logits (B, vocab),
        cache).  ``embeds`` (B, P, d), if given, are consumed first, one
        position at a time (the vlm patch prefix)."""
        logits = None
        if embeds is not None:
            for i in range(embeds.shape[1]):
                logits, cache = self.decode_step(
                    params, cache, None, enc=enc, window=window,
                    attn_impl=attn_impl, ring=ring,
                    input_embeds=embeds[:, i:i + 1])
        for i in range(tokens.shape[1]):
            logits, cache = self.decode_step(
                params, cache, tokens[:, i:i + 1], enc=enc, window=window,
                attn_impl=attn_impl, ring=ring)
        return logits, cache

    def reset_slots(self, cache: Dict, mask) -> Dict:
        """Continuous batching: a cache whose slots where ``mask`` (B,)
        is True hold a fresh request's state.  The per-slot ``length`` is
        zeroed (the mask hides stale attention rows) and every (L, B, ...)
        or (B, ...) leaf is re-initialised on those slots, as the
        reference's ``where`` does: the result is a new tree, and no
        tensor of ``cache`` is written."""
        length = cache["length"]
        b = length.shape[0]
        mask = torch.as_tensor(mask, dtype=torch.bool, device=length.device)
        fresh = self.init_cache(b, _cache_len(cache), device=length.device)
        leaves, treedef = tree_flatten(cache)
        new = []
        for old, init in zip(leaves, tree_flatten(fresh)[0]):
            if old.dim() >= 2 and old.shape[1] == b:
                m = mask.reshape((1, b) + (1,) * (old.dim() - 2))
            elif old.dim() >= 1 and old.shape[0] == b:
                m = mask.reshape((b,) + (1,) * (old.dim() - 1))
            else:
                new.append(old)
                continue
            new.append(torch.where(m, init, old))
        return tree_unflatten(treedef, new)

    def decode_step(self, params: Params, cache: Dict,
                    tokens: Optional[torch.Tensor],
                    enc: Optional[torch.Tensor] = None,
                    window: Optional[int] = None,
                    attn_impl: str = "chunked", ring: bool = False,
                    n_valid: Optional[torch.Tensor] = None,
                    input_embeds: Optional[torch.Tensor] = None,
                    moe_mode: str = "dropless"
                    ) -> Tuple[torch.Tensor, Dict]:
        """One decode step: tokens (B, 1) -> logits (B, vocab) and the
        new cache.  ``enc`` (B, F, d) are the encoder states that every
        layer cross-attends (through ``attn_impl``); the cached
        self-attention is ``decode_attention``.  ``input_embeds`` (B, s,
        d) bypasses the token embedding (the vlm patch positions, cast to
        the model's dtype as ``forward`` casts the prefix; ``tokens`` may
        then be None).

        Chunked prefill: tokens (B, s) with s > 1 run all s positions in
        one step (non-ring caches; the per-row causal mask keeps it
        exact) and return all s logit rows (B, s, vocab).  ``n_valid``
        (B,), when given, is the count of real tokens per slot: the cache
        length advances by it instead of s.

        ``moe_mode`` routes the MoE FFN (``_block``): "dropless" (every
        expert on every token, gated) or "capacity" (grouped dispatch
        over the step's tokens at four times the balanced load)."""
        if moe_mode not in MOE_MODES:
            raise ValueError(f"moe_mode must be one of {MOE_MODES}, got "
                             f"{moe_mode!r}")
        cfg = self.cfg
        if input_embeds is not None:
            x = input_embeds.to(L._dtype(cfg))
        else:
            x = L.embed(params["embedding"], tokens)
        s = x.shape[1]
        length = cache["length"]
        positions = length[:, None] + torch.arange(s, device=x.device)
        if cfg.family == "hybrid":
            x, cache = self._hybrid_decode(params, cache, x, positions, enc,
                                           window, attn_impl, ring)
        elif cfg.family == "ssm":
            x, cache = self._xlstm_decode(params, cache, x)
        else:
            names = ("ckv", "kr") if cfg.mla is not None else ("k", "v")
            new = {name: [] for name in names}
            for i, lp in enumerate(_unstack(params["layers"])):
                lc = {name: cache[name][i] for name in names}
                x, nc, _ = _block(lp, cfg, x, positions,
                                  {**lc, "length": length, "ring": ring},
                                  enc, window, attn_impl, moe_mode=moe_mode)
                for name in names:
                    new[name].append(nc[name])
            cache = {**cache, **{name: torch.stack(t)
                                 for name, t in new.items()}}
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
            x, nc, _ = _block(params["shared_attn"], cfg, x, positions, ac,
                              enc, window, attn_impl)
            ks.append(nc["k"])
            vs.append(nc["v"])
        for i in trailing:
            y, new_m[i] = S.mamba2_decode(mamba[i], cfg, x, mcache[i])
            x = x + y
        stacked = {k: torch.stack([m[k] for m in new_m])
                   for k in cache["mamba"]}
        return x, {**cache, "mamba": stacked,
                   "attn": {"k": torch.stack(ks), "v": torch.stack(vs)}}

    def _xlstm_decode(self, params, cache, x):
        """The s tokens of x through each layer's block from its carried
        state (the other block's state passes through).  Returns (x,
        cache with new "mlstm" and "slstm")."""
        cfg = self.cfg
        new_m, new_s = _unstack(cache["mlstm"]), _unstack(cache["slstm"])
        for i, (pm, ps) in enumerate(zip(_unstack(params["mlstm"]),
                                         _unstack(params["slstm"]))):
            if self._is_slstm(i):
                y, new_s[i] = X.slstm_forward(ps, cfg, x, state=new_s[i])
            else:
                y, new_m[i] = X.mlstm_forward(pm, cfg, x, state=new_m[i])
            x = x + y
        return x, {**cache,
                   "mlstm": {k: torch.stack([st[k] for st in new_m])
                             for k in cache["mlstm"]},
                   "slstm": {k: torch.stack([st[k] for st in new_s])
                             for k in cache["slstm"]}}


def _repeated(n: int, one: Dict[str, torch.Tensor]) -> Dict:
    """``one``'s leaves repeated on a new leading axis of ``n``."""
    return {k: v[None].repeat((n,) + (1,) * v.dim()) for k, v in one.items()}


def _cache_len(cache: Dict) -> int:
    """The cache's sequence length, from a KV leaf: (L, B, C, ...), MLA's
    (L, B, C, kv_lora) or, in the hybrid cache, (n_segments, B, C, KV,
    HD); 1 for the ssm cache, which has no length-shaped leaf (as the
    reference's)."""
    for key in ("k", "ckv"):
        if key in cache:
            return cache[key].shape[2]
    if "attn" in cache:
        return cache["attn"]["k"].shape[2]
    return 1


def build_model(cfg: ArchConfig) -> Model:
    return Model(cfg=cfg)
