"""granite-8b  [arXiv:2405.04324] -- llama-arch code model.
36L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=49152."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-8b",
    family="dense",
    n_layers=36,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=49152,
    rope_theta=10000.0,
    kv_replication=2,
)

SMOKE = ModelConfig(
    name="granite-smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=160,
    vocab_size=256,
)
