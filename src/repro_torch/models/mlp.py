"""Dense MLP blocks: SwiGLU (LLaMA-family default) and GELU (whisper/ViT)
(twin of `repro/models/mlp.py`; with no mesh the reference's activation
sharding constraints are the identity, so the port has none)."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models import nn


def swiglu_spec(d_model: int, d_ff: int, n_layers: int, dtype):
    return {
        "w_gate": nn.dense_spec(d_model, d_ff, "embed", "mlp", dtype=dtype),
        "w_up": nn.dense_spec(d_model, d_ff, "embed", "mlp", dtype=dtype),
        "w_down": nn.dense_spec(d_ff, d_model, "mlp", "embed", dtype=dtype,
                                init="fanin_deep",
                                scale=1.0 / max(n_layers, 1) ** 0.5),
    }


def swiglu(params, x: torch.Tensor) -> torch.Tensor:
    g = nn.dense(params["w_gate"], x)
    u = nn.dense(params["w_up"], x)
    return nn.dense(params["w_down"], F.silu(g) * u)


def gelu_mlp_spec(d_model: int, d_ff: int, n_layers: int, dtype,
                  *, bias: bool = True):
    return {
        "w_in": nn.dense_spec(d_model, d_ff, "embed", "mlp", bias=bias,
                              dtype=dtype),
        "w_out": nn.dense_spec(d_ff, d_model, "mlp", "embed", bias=bias,
                               dtype=dtype, init="fanin_deep",
                               scale=1.0 / max(n_layers, 1) ** 0.5),
    }


def gelu_mlp(params, x: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu's default is the tanh approximation
    h = F.gelu(nn.dense(params["w_in"], x), approximate="tanh")
    return nn.dense(params["w_out"], h)
