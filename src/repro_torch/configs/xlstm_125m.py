"""xLSTM-125M — sLSTM + mLSTM blocks [arXiv:2405.04517]. d_ff=0: the
up/down projections live inside the xLSTM blocks."""
from repro_torch.configs.base import ArchConfig, XLSTMConfig

CONFIG = ArchConfig(
    name="xlstm-125m",
    family="ssm",
    n_layers=12,
    d_model=768,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab=50304,
    tied_embeddings=True,
    xlstm=XLSTMConfig(slstm_every=4, mlstm_expand=2),
    source="arXiv:2405.04517",
)
