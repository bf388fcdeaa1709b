"""grok-1-314b — MoE, 8 experts top-2 [hf:xai-org/grok-1; unverified]."""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="grok-1-314b",
    family="moe",
    n_layers=64,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=32768,
    vocab=131072,
    moe_n_experts=8,
    moe_top_k=2,
    moe_n_shared=0,
    moe_d_ff=32768,
    moe_scan_experts=True,   # 8 x (6144 x 32768) mats: gather one at a time
    moe_capacity_factor=1.0,
    grad_accum_dtype="bfloat16",
    moe_token_chunks=16,
    remat="full",
    kv_cache_dtype="float8_e4m3fn",
    source="hf:xai-org/grok-1",
    verified="unverified",
)

SMOKE = CONFIG.replace(
    name="grok-1-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
    d_ff=128, vocab=256, moe_n_experts=4, moe_top_k=2, moe_d_ff=128,
    dtype="float32", kv_cache_dtype="float32", grad_accum_dtype="float32",
    attn_q_chunk=16,
)
