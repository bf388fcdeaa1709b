"""Config dataclasses: architectures and input shapes (twin of
`repro/configs/base.py`, field for field).

Every assigned architecture is an ArchConfig instance in configs/<id>.py with
the exact public-literature hyperparameters, plus a reduced `smoke()` variant
of the same family for CPU tests. Input-shape cells come from SHAPES below
(the assigned seq_len x global_batch grid).

The port builds every family (`models/model.py`), and every config
compares equal to the reference's field for field; `decode_unroll` is
kept as data and has no effect here (the port's decode stacks are Python
loops over per-layer modules). `remat` checkpoints each layer of a
training forward in every stack the reference wraps (`models/blocks`).
"""

from __future__ import annotations

import dataclasses

import torch

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
_KV_DTYPES = {**_DTYPES, "float8_e4m3fn": torch.float8_e4m3fn}


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str          # dense | moe | hybrid | xlstm | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: int = 0                  # default d_model // n_heads

    # block options
    norm: str = "rmsnorm"            # rmsnorm | layernorm
    act: str = "swiglu"              # swiglu | gelu
    qkv_bias: bool = False
    out_bias: bool = False
    pos: str = "rope"                # rope | learned | none
    rope_theta: float = 10000.0
    rope_fraction: float = 1.0
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"          # compute/param dtype

    # MoE
    moe_n_experts: int = 0
    moe_top_k: int = 0
    moe_n_shared: int = 0
    moe_d_ff: int = 0
    moe_capacity_factor: float = 1.25
    moe_scan_experts: bool = False
    moe_token_chunks: int = 1

    # SSM (mamba2 / zamba2 hybrid)
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_headdim: int = 64
    hybrid_shared_every: int = 6     # shared attn block period (zamba2)

    # xLSTM
    xlstm_pf: int = 2
    xlstm_conv: int = 4
    slstm_every: int = 4             # one sLSTM per this many layers

    # enc-dec (whisper)
    enc_layers: int = 0
    max_enc_len: int = 4096

    # VLM
    n_vision_tokens: int = 0

    # runtime
    max_seq: int = 8192              # learned-pos table size
    remat: str = "dots"              # none | full | dots
    attn_q_chunk: int = 1024
    ssd_chunk: int = 128
    decode_unroll: bool = False      # no effect in the port
    kv_cache_dtype: str = "auto"      # "auto" follows dtype;
                                      # "float8_e4m3fn" halves decode HBM
    grad_accum_dtype: str = "float32"  # microbatch gradient accumulator

    @property
    def torch_kv_dtype(self) -> torch.dtype:
        name = self.kv_cache_dtype
        if name == "auto":
            name = self.dtype
        return _KV_DTYPES[name]

    # provenance
    source: str = ""
    verified: str = "unverified"     # hf | arxiv | unverified

    def __post_init__(self):
        if self.d_head == 0:
            object.__setattr__(self, "d_head", self.d_model // self.n_heads)

    @property
    def torch_dtype(self) -> torch.dtype:
        return _DTYPES[self.dtype]

    @property
    def sub_quadratic(self) -> bool:
        """Can this arch run long_500k? (SSM / hybrid / linear recurrent.)"""
        return self.family in ("hybrid", "xlstm")

    @property
    def has_decoder(self) -> bool:
        return True  # every assigned arch has an autoregressive decoder

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                        # train | prefill | decode

    @property
    def is_train(self) -> bool:
        return self.kind == "train"


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


def shape_applicable(arch: ArchConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """(runs?, reason) — the long_500k / encoder-only skip rules."""
    if shape.name == "long_500k" and not arch.sub_quadratic:
        return False, ("full softmax attention is quadratic; long_500k is "
                       "assigned only to SSM/hybrid/linear archs "
                       "(DESIGN.md section 6)")
    return True, ""
