"""Zamba2-7B — hybrid Mamba2 + shared attention blocks [arXiv:2411.15242].

81 Mamba2 blocks with ONE shared attention+MLP block applied after every
6th (Zamba2's shared-block design, without the per-use LoRA deltas), as
the reference package models it.
"""
from repro_torch.configs.base import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    name="zamba2-7b",
    family="hybrid",
    n_layers=81,
    d_model=3584,
    n_heads=32,
    n_kv_heads=32,
    d_ff=14336,
    vocab=32000,
    ssm=SSMConfig(state_dim=64, head_dim=64, expand=2, conv_dim=4, chunk=256),
    attn_every=6,
    sliding_window=8192,     # shared attention block windows at 500k context
    source="arXiv:2411.15242",
)
