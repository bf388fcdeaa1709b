"""glm4-9b — dense GQA (kv=2) with partial RoPE [hf:THUDM/glm-4-9b; hf]."""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="glm4-9b",
    family="dense",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=2,
    d_ff=13696,
    vocab=151552,
    qkv_bias=True,           # GLM4 add_qkv_bias
    rope_fraction=0.5,       # GLM applies rotary to half the head dim
    rope_theta=10000.0,
    source="hf:THUDM/glm-4-9b",
    verified="hf",
)

SMOKE = CONFIG.replace(
    name="glm4-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
    d_ff=112, vocab=256, dtype="float32", attn_q_chunk=16,
)
