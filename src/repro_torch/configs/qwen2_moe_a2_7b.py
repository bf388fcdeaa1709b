"""qwen2-moe-a2.7b — 60 routed experts top-4 + shared experts
[hf:Qwen/Qwen1.5-MoE-A2.7B; hf]. The shared-expert path is 4x the routed
expert width (shared_expert_intermediate_size = 4 * 1408)."""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    vocab=151936,
    qkv_bias=True,
    moe_n_experts=60,
    moe_top_k=4,
    moe_n_shared=4,
    moe_d_ff=1408,
    moe_token_chunks=4,
    remat="full",
    source="hf:Qwen/Qwen1.5-MoE-A2.7B",
    verified="hf",
)

SMOKE = CONFIG.replace(
    name="qwen2-moe-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_head=16,
    d_ff=64, vocab=256, moe_n_experts=8, moe_top_k=2, moe_n_shared=1,
    moe_d_ff=64, dtype="float32", attn_q_chunk=16,
)
