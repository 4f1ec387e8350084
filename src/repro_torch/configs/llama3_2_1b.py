"""Llama-3.2-1B — small llama3 with TIED embeddings [hf:meta-llama/Llama-3.2-1B].

The tied embedding and output projection are the shared-weight design
the paper identifies as the trigger for TensorFlow's assumed-sparse
accumulation.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llama3.2-1b",
    family="dense",
    n_layers=16,
    d_model=2048,
    n_heads=32,
    n_kv_heads=8,
    d_ff=8192,
    vocab=128256,
    head_dim=64,
    tied_embeddings=True,
    rope_theta=500000.0,
    sliding_window=8192,
    source="hf:meta-llama/Llama-3.2-1B",
)
