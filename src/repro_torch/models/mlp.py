"""Dense MLP blocks: SwiGLU (LLaMA-family default) and GELU (whisper/ViT)
(twin of `repro/models/mlp.py`; the hidden activation is constrained to
the "mlp" sharding of `repro_torch.sharding` under an active mesh, the
identity otherwise)."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models import nn
from repro_torch.sharding import shard_activation


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
    h = shard_activation(F.silu(g) * u, ("batch", None, "mlp"))
    return nn.dense(params["w_down"], h)


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
    h = shard_activation(h, ("batch", None, "mlp"))
    return nn.dense(params["w_out"], h)
