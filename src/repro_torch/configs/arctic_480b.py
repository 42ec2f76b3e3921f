"""arctic-480b  [hf:Snowflake/snowflake-arctic-base]
35L d_model=7168 56H (GQA kv=8) d_ff=4864 vocab=32000, MoE 128 experts top-2
+ dense residual FFN, weights sharded over the data axis too (FSDP). Trains
with Adafactor: AdamW's fp32 moments alone would be 3.8 TB."""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="arctic-480b",
    family="moe",
    n_layers=35,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=4864,
    vocab_size=32000,
    moe=MoEConfig(n_experts=128, top_k=2, dense_residual_ff=2 * 7168),
    optimizer="adafactor",
    fsdp=True,
    pad_heads_to=64,
    kv_replication=2,
)

SMOKE = ModelConfig(
    name="arctic-smoke",
    family="moe",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=64,
    vocab_size=256,
    moe=MoEConfig(n_experts=8, top_k=2, dense_residual_ff=96),
    optimizer="adafactor",
)
