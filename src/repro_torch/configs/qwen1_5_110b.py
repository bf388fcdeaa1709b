"""qwen1.5-110b — dense GQA transformer with QKV bias
[hf:Qwen/Qwen1.5-110B (family: Qwen/Qwen1.5-0.5B); hf]."""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen1.5-110b",
    family="dense",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=49152,
    vocab=152064,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    remat="full",
    kv_cache_dtype="float8_e4m3fn",  # decode_32k cache fits HBM
    source="hf:Qwen/Qwen1.5-110B",
    verified="hf",
)

SMOKE = CONFIG.replace(
    name="qwen1.5-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
    d_ff=160, vocab=256, dtype="float32", kv_cache_dtype="float32", attn_q_chunk=16,
)
