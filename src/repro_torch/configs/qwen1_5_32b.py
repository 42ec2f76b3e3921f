"""qwen1.5-32b  [hf:Qwen/Qwen1.5-* family]
64L d_model=5120 40H (MHA kv=40) d_ff=27392 vocab=152064, QKV bias,
int8 KV cache, heads padded 40 -> 48."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-32b",
    family="dense",
    n_layers=64,
    d_model=5120,
    n_heads=40,
    n_kv_heads=40,
    d_ff=27392,
    vocab_size=152064,
    qkv_bias=True,
    rope_theta=1000000.0,
    kv_cache_dtype="int8",
    pad_heads_to=48,
    pad_kv_heads_to=48,
)

SMOKE = ModelConfig(
    name="qwen-smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=192,
    vocab_size=256,
    qkv_bias=True,
    kv_cache_dtype="int8",
    pad_heads_to=6,
    pad_kv_heads_to=6,
)
