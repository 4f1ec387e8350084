"""DeepSeek-V2-236B — MLA (kv_lora=512) + MoE 2 shared + 160 routed top-6
[arXiv:2405.04434]."""
from repro_torch.configs.base import ArchConfig, MLAConfig, MoEConfig

CONFIG = ArchConfig(
    name="deepseek-v2-236b",
    family="moe",
    n_layers=60,
    d_model=5120,
    n_heads=128,
    n_kv_heads=128,
    d_ff=1536,
    vocab=102400,
    moe=MoEConfig(n_experts=160, top_k=6, d_ff_expert=1536, n_shared=2),
    mla=MLAConfig(kv_lora=512, q_lora=0, rope_dim=64, nope_dim=128,
                  v_dim=128),
    sliding_window=8192,
    source="arXiv:2405.04434",
)
