"""command-r-35b — dense GQA, no biases
[hf:CohereForAI/c4ai-command-r-v01; unverified].

The HF config also uses parallel attn+FFN residual and layernorm; the
assigned spec pins only "GQA, no-bias", so we keep the shared sequential
block and note the deviation here (unverified tier)."""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="command-r-35b",
    family="dense",
    n_layers=40,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=22528,
    vocab=256000,
    norm="layernorm",
    rope_theta=8_000_000.0,
    source="hf:CohereForAI/c4ai-command-r-v01",
    verified="unverified",
)

SMOKE = CONFIG.replace(
    name="command-r-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
    d_ff=96, vocab=512, dtype="float32", attn_q_chunk=16,
)
