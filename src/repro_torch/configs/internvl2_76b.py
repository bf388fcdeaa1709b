"""internvl2-76b — VLM: InternViT frontend (STUB) + LLaMA3-70B-class LM
backbone [arXiv:2404.16821; unverified]. input_specs() provides
precomputed patch embeddings (batch, n_vision_tokens, d_model); the LM
consumes [vision prefix | text tokens]."""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="internvl2-76b",
    family="vlm",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=28672,
    vocab=128256,
    rope_theta=500_000.0,
    n_vision_tokens=256,
    remat="full",
    kv_cache_dtype="float8_e4m3fn",  # decode_32k cache fits HBM
    source="arXiv:2404.16821",
    verified="unverified",
)

SMOKE = CONFIG.replace(
    name="internvl2-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
    d_ff=128, vocab=256, n_vision_tokens=4, dtype="float32", kv_cache_dtype="float32",
    attn_q_chunk=16,
)
