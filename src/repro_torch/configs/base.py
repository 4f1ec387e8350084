"""ArchConfig: the declarative model config, the port's own copy.

Mirrors ``repro.configs.base`` for the fields the ported model path
reads.  ``reduced()`` derives the CPU test variant exactly as the
reference does (<=2 layers, d_model<=128, vocab<=512, float32), so both
packages build the same shapes from the same config.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Optional


@dataclasses.dataclass(frozen=True)
class FrontendConfig:
    kind: str                  # "audio" | "vision"
    n_embeds: int              # frames (audio) or patches (vision)
    cross_attention: bool      # True: enc-dec cross-attn; False: prefix


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                # this port: audio (enc-dec decoder)
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    source: str = ""           # citation
    head_dim: Optional[int] = None
    tied_embeddings: bool = False
    rope_theta: float = 10000.0
    rope_fraction: float = 1.0
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"
    sliding_window: Optional[int] = None
    attn_every: Optional[int] = None
    frontend: Optional[FrontendConfig] = None

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def with_(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)

    def reduced(self) -> "ArchConfig":
        """CPU test variant of the same family."""
        d = min(self.d_model, 128)
        heads = min(self.n_heads, 4)
        kv = max(1, min(self.n_kv_heads, heads))
        while heads % kv:
            kv -= 1
        kw = dict(
            name=self.name + "-reduced",
            n_layers=2 if self.attn_every is None else 4,
            d_model=d, n_heads=heads, n_kv_heads=kv,
            d_ff=min(self.d_ff, 256) if self.d_ff else 0,
            vocab=min(self.vocab, 512),
            head_dim=d // heads,
            dtype="float32",
            attn_every=2 if self.attn_every is not None else None,
        )
        if self.frontend is not None:
            kw["frontend"] = dataclasses.replace(self.frontend, n_embeds=16)
        return self.with_(**kw)


ARCH_IDS = ("transformer-big",)


def get_config(arch_id: str) -> ArchConfig:
    if arch_id not in ARCH_IDS:
        raise ValueError(f"unknown arch {arch_id!r}; the port supports "
                         f"{', '.join(ARCH_IDS)}")
    mod_name = arch_id.replace("-", "_").replace(".", "_")
    mod = importlib.import_module(f"repro_torch.configs.{mod_name}")
    return mod.CONFIG
