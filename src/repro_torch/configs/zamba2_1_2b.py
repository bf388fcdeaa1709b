"""zamba2-1.2b — hybrid Mamba2 backbone + shared attention block
[arXiv:2411.15242; hf]. The shared transformer block (one set of weights)
is applied every `hybrid_shared_every` mamba layers; d_ff/heads describe
that shared block. Sub-quadratic: runs long_500k."""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-1.2b",
    family="hybrid",
    n_layers=38,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab=32000,
    ssm_state=64,
    ssm_conv=4,
    ssm_expand=2,
    ssm_headdim=64,
    hybrid_shared_every=6,
    source="arXiv:2411.15242",
    verified="hf",
)

SMOKE = CONFIG.replace(
    name="zamba2-smoke",
    n_layers=5, d_model=64, n_heads=4, n_kv_heads=4, d_head=16,
    d_ff=128, vocab=256, ssm_state=16, ssm_headdim=16,
    hybrid_shared_every=2, dtype="float32", attn_q_chunk=16, ssd_chunk=8,
)
