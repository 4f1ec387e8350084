"""ChatGLM3-6B — GQA with 2 kv heads, QKV bias, partial RoPE (half the
head dim) [arXiv:2406.12793]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="chatglm3-6b",
    family="dense",
    n_layers=28,
    d_model=4096,
    n_heads=32,
    n_kv_heads=2,
    d_ff=13696,
    vocab=65024,
    rope_fraction=0.5,
    qkv_bias=True,
    sliding_window=8192,
    source="arXiv:2406.12793",
)
