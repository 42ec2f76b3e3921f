"""whisper-tiny  [arXiv:2212.04356]
4L d_model=384 6H d_ff=1536 vocab=51865, enc-dec. Conv frontend is a STUB:
input_specs() provides precomputed frame embeddings (batch, T_enc, d_model).
6 heads < model-axis 16 => attention is replicated over `model`, FFN sharded."""
from repro_torch.configs.base import ModelConfig, EncDecConfig

CONFIG = ModelConfig(
    name="whisper-tiny",
    family="audio",
    n_layers=4,                    # decoder layers
    d_model=384,
    n_heads=6,
    n_kv_heads=6,
    d_ff=1536,
    vocab_size=51865,
    encdec=EncDecConfig(n_enc_layers=4),
)

SMOKE = ModelConfig(
    name="whisper-smoke",
    family="audio",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=128,
    vocab_size=256,
    encdec=EncDecConfig(n_enc_layers=2),
)
