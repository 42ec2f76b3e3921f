"""llama3-8b  [arXiv:2407.21783]
32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=128256."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama3-8b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=128256,
    rope_theta=500000.0,
    kv_replication=2,
)

SMOKE = ModelConfig(
    name="llama3-smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=160,
    vocab_size=256,
)
