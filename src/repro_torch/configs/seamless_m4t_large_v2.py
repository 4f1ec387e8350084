"""SeamlessM4T-large-v2 text decoder backbone [arXiv:2308.11596].

Encoder-decoder: the conformer speech encoder is a stub (precomputed
frame embeddings, the pipeline's ``frontend``); this config is the
24-layer text decoder cross-attending those frames, with a tied
256206-row embedding and output projection — the paper's mixed sparse
and dense gradient at 7.6 times transformer-big's vocabulary.
"""
from repro_torch.configs.base import ArchConfig, FrontendConfig

CONFIG = ArchConfig(
    name="seamless-m4t-large-v2",
    family="audio",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=8192,
    vocab=256206,
    tied_embeddings=True,
    sliding_window=8192,
    frontend=FrontendConfig(kind="audio", n_embeds=1024,
                            cross_attention=True),
    source="arXiv:2308.11596",
)
