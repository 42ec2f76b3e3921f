"""xlstm-350m  [arXiv:2405.04517]
24L d_model=1024 4H d_ff=0 vocab=50304. sLSTM + mLSTM blocks (7:1 mLSTM:sLSTM).
Fully recurrent, O(1) decode state => long_500k runs."""
from repro_torch.configs.base import ModelConfig, XLSTMConfig

CONFIG = ModelConfig(
    name="xlstm-350m",
    family="ssm",
    n_layers=24,
    d_model=1024,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    xlstm=XLSTMConfig(slstm_every=8),
    tie_embeddings=True,
    sub_quadratic=True,
)

SMOKE = ModelConfig(
    name="xlstm-smoke",
    family="ssm",
    n_layers=4,
    d_model=64,
    n_heads=2,
    n_kv_heads=2,
    d_ff=0,
    vocab_size=256,
    xlstm=XLSTMConfig(slstm_every=2),
    tie_embeddings=True,
    sub_quadratic=True,
)
