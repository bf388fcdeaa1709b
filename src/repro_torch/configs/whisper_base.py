"""whisper-base — encoder-decoder audio transformer [arXiv:2212.04356;
unverified]. The conv frame frontend is a STUB per the assignment:
input_specs() provides precomputed (batch, frames, d_model) embeddings.

6L here = 6 encoder + 6 decoder layers (whisper-base layout)."""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-base",
    family="encdec",
    n_layers=6,              # decoder layers
    enc_layers=6,
    d_model=512,
    n_heads=8,
    n_kv_heads=8,
    d_ff=2048,
    vocab=51865,
    norm="layernorm",
    act="gelu",
    qkv_bias=True,
    out_bias=True,
    pos="learned",
    rope_fraction=0.0,
    max_enc_len=4096,
    max_seq=40960,           # decode_32k cache + learned pos table
    source="arXiv:2212.04356",
    verified="unverified",
)

SMOKE = CONFIG.replace(
    name="whisper-smoke",
    n_layers=2, enc_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    d_head=16, d_ff=128, vocab=256, max_enc_len=32, max_seq=64,
    dtype="float32", attn_q_chunk=16,
)
