"""The paper's own model: TensorFlow official Transformer "big"
(Vaswani et al. 2017) — enc-dec, d_model=1024, 16 heads, d_ff=4096,
shared source/target/softmax embedding (vocab 33708, WMT17 en-de BPE).

Modelled, as in the reference package, as the decoder backbone with
cross-attention to encoder states supplied through the audio frontend
stub, so the tied embedding is used by both the lookup and the output
projection.
"""
from repro_torch.configs.base import ArchConfig, FrontendConfig

CONFIG = ArchConfig(
    name="transformer-big",
    family="audio",
    n_layers=6,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    vocab=33708,
    tied_embeddings=True,
    sliding_window=8192,
    frontend=FrontendConfig(kind="audio", n_embeds=256,
                            cross_attention=True),
    source="arXiv:1706.03762 / tensorflow/models official transformer",
)
