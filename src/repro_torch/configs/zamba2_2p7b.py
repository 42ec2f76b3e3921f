"""zamba2-2.7b  [arXiv:2411.15242]
54L d_model=2560 32H (GQA kv=32) d_ff=10240 vocab=32000, ssm_state=64.
Mamba2 backbone + shared attention block every 6 layers. The long-context
fields of the JAX config (a 4096-token window for long_500k) are not read
by the port's prefill and decode."""
from repro_torch.configs.base import HybridConfig, ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b",
    family="hybrid",
    n_layers=54,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    d_ff=10240,
    vocab_size=32000,
    ssm=SSMConfig(d_state=64, expand=2, head_dim=64, chunk_size=256),
    hybrid=HybridConfig(attn_every=6, shared_attention=True),
)

SMOKE = ModelConfig(
    name="zamba2-smoke",
    family="hybrid",
    n_layers=4,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=128,
    vocab_size=256,
    ssm=SSMConfig(d_state=16, expand=2, head_dim=16, chunk_size=32),
    hybrid=HybridConfig(attn_every=2, shared_attention=True),
)
