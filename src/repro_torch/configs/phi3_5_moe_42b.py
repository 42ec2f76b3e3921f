"""phi3.5-moe-42b-a6.6b  [hf:microsoft/Phi-3.5-MoE-instruct]
32L d_model=4096 32H (GQA kv=8) d_ff=6400 vocab=32064, MoE 16 experts top-2."""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="phi3.5-moe-42b-a6.6b",
    family="moe",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=6400,
    vocab_size=32064,
    moe=MoEConfig(n_experts=16, top_k=2),
    rope_theta=10000.0,
    kv_replication=2,
)

SMOKE = ModelConfig(
    name="phi3.5-moe-smoke",
    family="moe",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=96,
    vocab_size=256,
    moe=MoEConfig(n_experts=4, top_k=2),
)
