"""internvl2-76b  [arXiv:2404.16821] -- InternViT + InternLM2 backbone.
80L d_model=8192 64H (GQA kv=8) d_ff=28672 vocab=128256.
The ViT frontend is a STUB: input_specs() provides precomputed patch
embeddings already projected to d_model (prepended to the token sequence).
FSDP weight sharding: 152 GB bf16 over model=16 alone would be 9.5 GB/chip
before activations/optimizer."""
from repro_torch.configs.base import ModelConfig, VLMConfig

CONFIG = ModelConfig(
    name="internvl2-76b",
    family="vlm",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=28672,
    vocab_size=128256,
    vlm=VLMConfig(n_patches=256),
    fsdp=True,
    kv_replication=2,
)

SMOKE = ModelConfig(
    name="internvl2-smoke",
    family="vlm",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=160,
    vocab_size=256,
    vlm=VLMConfig(n_patches=8),
)
