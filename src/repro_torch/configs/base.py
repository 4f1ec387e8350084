"""ArchConfig: the declarative model config, the port's own copy.

Mirrors ``repro.configs.base`` for the fields the ported model path
reads.  ``reduced()`` derives the CPU test variant exactly as the
reference does (<=2 layers, or 4 with ``attn_every`` 2 for the hybrid
family; d_model<=128, vocab<=512, float32; 4 experts of 64 for the moe
family; MLA's latent at 32 with 16 + 16 q·k and 32 v head dims), so
both packages build the same shapes from the same config.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, Optional


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared: int = 0          # shared (always-on) experts
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    kv_lora: int               # compressed kv dim (c_kv)
    q_lora: int = 0            # 0 = full-rank q projection
    rope_dim: int = 64         # per-head rope sub-dim (shared key rope)
    nope_dim: int = 128        # per-head non-rope sub-dim
    v_dim: int = 128


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    state_dim: int             # N
    head_dim: int = 64         # P
    expand: int = 2
    conv_dim: int = 4
    chunk: int = 256


@dataclasses.dataclass(frozen=True)
class XLSTMConfig:
    slstm_every: int = 4       # block i is sLSTM iff i % slstm_every == 1
    mlstm_expand: int = 2
    slstm_ff_mult: float = 1.3333


@dataclasses.dataclass(frozen=True)
class FrontendConfig:
    kind: str                  # "audio" | "vision"
    n_embeds: int              # frames (audio) or patches (vision)
    cross_attention: bool      # True: enc-dec cross-attn; False: prefix


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                # audio (enc-dec) | dense | hybrid |
                               # moe (with mla: deepseek-v2) | ssm | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    source: str = ""           # citation
    head_dim: Optional[int] = None
    tied_embeddings: bool = False
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    rope_fraction: float = 1.0   # chatglm applies RoPE to half the head dim
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"
    sliding_window: Optional[int] = None
    attn_every: Optional[int] = None       # hybrid: shared attn block period
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    xlstm: Optional[XLSTMConfig] = None
    frontend: Optional[FrontendConfig] = None

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def sub_quadratic(self) -> bool:
        """Can this arch run long_500k? (SSM/hybrid natively; attention
        archs through a sliding window.)"""
        return (self.family in ("ssm", "hybrid")
                or self.sliding_window is not None)

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
        if self.moe is not None:
            kw["moe"] = dataclasses.replace(
                self.moe, n_experts=4, top_k=min(self.moe.top_k, 2),
                d_ff_expert=64, n_shared=min(self.moe.n_shared, 1))
        if self.mla is not None:
            kw["mla"] = MLAConfig(kv_lora=32, q_lora=0, rope_dim=16,
                                  nope_dim=16, v_dim=32)
        if self.ssm is not None:
            kw["ssm"] = dataclasses.replace(self.ssm, state_dim=16,
                                            head_dim=16, chunk=32)
        if self.frontend is not None:
            kw["frontend"] = dataclasses.replace(self.frontend, n_embeds=16)
        return self.with_(**kw)


ARCH_IDS = ("zamba2-7b", "seamless-m4t-large-v2", "qwen2.5-32b",
            "deepseek-7b", "llama3.2-1b", "llama4-scout-17b-a16e",
            "deepseek-v2-236b", "internvl2-1b", "xlstm-125m",
            "chatglm3-6b", "transformer-big")


def get_config(arch_id: str) -> ArchConfig:
    if arch_id not in ARCH_IDS:
        raise ValueError(f"unknown arch {arch_id!r}; the port supports "
                         f"{', '.join(ARCH_IDS)}")
    mod_name = arch_id.replace("-", "_").replace(".", "_")
    mod = importlib.import_module(f"repro_torch.configs.{mod_name}")
    return mod.CONFIG


def all_configs() -> Dict[str, ArchConfig]:
    return {a: get_config(a) for a in ARCH_IDS}


# ---------------------------------------------------------------------------
# Input shapes (the reference's assigned ones)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str                  # train | prefill | decode


INPUT_SHAPES: Dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}
