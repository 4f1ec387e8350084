"""Meta-tensor input specs for every (arch x input-shape) combination
(``repro.launch.specs``).

Nothing here allocates: params, batches and caches are tensors on the
``meta`` device, the port's counterpart of ``jax.ShapeDtypeStruct``, with
the reference's shapes and dtypes.  ``launch.dryrun`` runs the
production steps on them.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig, InputShape
from repro_torch.models import build_model
from repro_torch.tree import tree_map

META = torch.device("meta")


def shape_structs(tree: Any) -> Any:
    """A meta tensor of each leaf's shape and dtype."""
    return tree_map(lambda x: torch.empty(tuple(x.shape), dtype=x.dtype,
                                          device=META), tree)


def params_structs(cfg: ArchConfig) -> Any:
    """The parameters as meta tensors (no memory, no draws)."""
    return build_model(cfg).init(device=META)


def input_specs(cfg: ArchConfig, shape: InputShape
                ) -> Dict[str, torch.Tensor]:
    """Batch specs for a train/prefill step."""
    b, s = shape.global_batch, shape.seq_len
    specs = {
        "tokens": torch.empty((b, s), dtype=torch.int32, device=META),
        "labels": torch.empty((b, s), dtype=torch.int32, device=META),
    }
    if cfg.frontend is not None:
        specs["frontend"] = torch.empty(
            (b, cfg.frontend.n_embeds, cfg.d_model), dtype=torch.float32,
            device=META)
    if shape.kind != "train":
        specs.pop("labels")
    return specs


def decode_specs(cfg: ArchConfig, shape: InputShape
                 ) -> Tuple[Dict, Any, Optional[int], bool]:
    """(token specs, cache specs, window, ring) for a serve_step.

    decode_32k: a full KV cache of seq_len.  long_500k (contexts over
    65536 tokens): attention archs keep the sliding-window ring buffer of
    ``window`` tokens; SSM and hybrid state is O(1) anyway."""
    b, s = shape.global_batch, shape.seq_len
    model = build_model(cfg)
    long_ctx = s > 65536
    window = cfg.sliding_window if long_ctx else None
    ring = window is not None and long_ctx
    cache_len = min(window, s) if ring else s
    cache = model.init_cache(b, cache_len, device=META)
    toks = {"tokens": torch.empty((b, 1), dtype=torch.int32, device=META)}
    if cfg.frontend is not None and cfg.frontend.cross_attention:
        toks["enc"] = torch.empty((b, cfg.frontend.n_embeds, cfg.d_model),
                                  dtype=torch.float32, device=META)
    return toks, cache, window, ring
