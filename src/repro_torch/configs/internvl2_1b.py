"""InternVL2-1B language backbone (Qwen2-0.5B-like) consuming InternViT
patch embeddings through a 256-position prefix stub [arXiv:2404.16821]."""
from repro_torch.configs.base import ArchConfig, FrontendConfig

CONFIG = ArchConfig(
    name="internvl2-1b",
    family="vlm",
    n_layers=24,
    d_model=896,
    n_heads=14,
    n_kv_heads=2,
    d_ff=4864,
    vocab=151655,
    tied_embeddings=True,
    qkv_bias=True,
    sliding_window=8192,
    frontend=FrontendConfig(kind="vision", n_embeds=256,
                            cross_attention=False),
    source="arXiv:2404.16821",
)
