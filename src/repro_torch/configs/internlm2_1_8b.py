"""internlm2-1.8b — dense GQA transformer [arXiv:2403.17297; hf]."""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="internlm2-1.8b",
    family="dense",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    d_ff=8192,
    vocab=92544,
    rope_theta=1_000_000.0,
    source="arXiv:2403.17297",
    verified="hf",
)

SMOKE = CONFIG.replace(
    name="internlm2-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
    d_ff=128, vocab=256, dtype="float32", attn_q_chunk=16,
)
