"""Mamba2 (SSD) blocks, the zamba2 hybrid backbone (twin of
`repro/models/ssm.py`).

Training / prefill use the chunked SSD algorithm (Mamba2 paper, "minimal
SSD"): an intra-chunk quadratic term (matmuls over the chunk length) plus
an inter-chunk state recurrence, a Python loop over chunks with its carry
in float32 where the reference scans. O(S * L) compute, O(1) state.

Decode keeps (conv_state, ssm_state) per layer and advances one token in
O(d_inner * d_state).

As the reference: n_groups = 1 (B, C shared across heads), no
norm-before-gate variant, and the chunk shrinks to the largest divisor of
the sequence length. The products promote their operands as JAX does
(`nn.einsum`), and the casts to the input dtype before the off-diagonal
product stand where the reference has them: at bf16 the parity depends
on them.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models import nn
from repro_torch.sharding import shard_activation


def mamba2_spec(cfg, dtype):
    d = cfg.d_model
    d_inner = cfg.ssm_expand * d
    nh = d_inner // cfg.ssm_headdim
    n = cfg.ssm_state
    conv_dim = d_inner + 2 * n
    return {
        "in_proj": nn.dense_spec(d, 2 * d_inner + 2 * n + nh, "embed",
                                 "mlp", dtype=dtype),
        "conv_w": nn.ParamSpec((cfg.ssm_conv, conv_dim), (None, "mlp"),
                               init="fanin", dtype=dtype),
        "conv_b": nn.ParamSpec((conv_dim,), ("mlp",), init="zeros",
                               dtype=dtype),
        "a_log": nn.ParamSpec((nh,), (None,), init="zeros",
                              dtype=torch.float32),
        "d_skip": nn.ParamSpec((nh,), (None,), init="ones",
                               dtype=torch.float32),
        "dt_bias": nn.ParamSpec((nh,), (None,), init="zeros",
                                dtype=torch.float32),
        "norm": nn.rmsnorm_spec(d_inner, dtype=dtype),
        "out_proj": nn.dense_spec(d_inner, d, "mlp", "embed", dtype=dtype,
                                  init="fanin_deep",
                                  scale=1.0 / max(cfg.n_layers, 1) ** 0.5),
    }


def _split_proj(cfg, zxbcdt):
    d_inner = cfg.ssm_expand * cfg.d_model
    n = cfg.ssm_state
    z = zxbcdt[..., :d_inner]
    xbc = zxbcdt[..., d_inner:2 * d_inner + 2 * n]
    dt = zxbcdt[..., 2 * d_inner + 2 * n:]
    return z, xbc, dt  # dt: (..., nh)


def _segsum(a):
    """(..., l) log-decays -> (..., l, l) lower-triangular cumulative sums
    (-inf above the diagonal)."""
    l = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((l, l), dtype=torch.bool,
                                 device=a.device))
    return torch.where(mask, diff, float("-inf"))


def _causal_conv(xbc, conv_w, conv_b, *, conv_state=None):
    """Depthwise causal conv, width K. xbc: (B, S, C); conv_w: (K, C).
    Returns (silu(conv + b), the last K-1 inputs as the new conv state)."""
    k = conv_w.shape[0]
    if conv_state is None:
        pad = xbc.new_zeros((xbc.shape[0], k - 1, xbc.shape[-1]))
    else:
        pad = conv_state
    xp = torch.cat([pad, xbc], dim=1)
    s = xbc.shape[1]
    out = sum(xp[:, i:i + s, :] * conv_w[i] for i in range(k))
    new_state = xp[:, -(k - 1):, :] if k > 1 else pad
    return F.silu(out + conv_b), new_state


def ssd_chunked(x, log_a, b_mat, c_mat, *, chunk: int, initial_state=None):
    """Chunked SSD scan.

    x:      (B, S, H, P)  dt-scaled inputs
    log_a:  (B, S, H)     per-step log decay (<= 0)
    b_mat:  (B, S, N)     input->state projection (shared across heads)
    c_mat:  (B, S, N)     state->output projection
    Returns (y (B,S,H,P), final_state (B,H,P,N)), both in x's dtype.
    """
    bsz, s, h, p = x.shape
    n = b_mat.shape[-1]
    while s % chunk != 0:   # largest divisor of s not exceeding the request
        chunk -= 1
    nc = s // chunk

    xc = x.reshape(bsz, nc, chunk, h, p)
    ac = log_a.reshape(bsz, nc, chunk, h).permute(0, 3, 1, 2)   # (B,H,C,L)
    bc = b_mat.reshape(bsz, nc, chunk, n)
    cc = c_mat.reshape(bsz, nc, chunk, n)

    a_cum = torch.cumsum(ac, dim=-1)                             # (B,H,C,L)
    l_mat = torch.exp(_segsum(ac))                               # (B,H,C,L,L)

    # 1. intra-chunk (diagonal blocks)
    scores = nn.einsum("bczn,bcln->bczl", cc, bc)
    y_diag = nn.einsum("bczl,bhczl,bclhp->bczhp", scores, l_mat, xc)

    # 2. per-chunk end states
    decay_states = torch.exp(a_cum[..., -1:] - a_cum)            # (B,H,C,L)
    states = nn.einsum("bhcl,bcln,bclhp->bchpn", decay_states, bc, xc)

    # 3. inter-chunk recurrence, the carry in float32
    chunk_decay = torch.exp(a_cum[..., -1])                      # (B,H,C)
    if initial_state is None:
        carry = torch.zeros((bsz, h, p, n), dtype=torch.float32,
                            device=x.device)
    else:
        carry = initial_state.float()
    prevs = []
    for c in range(nc):
        prevs.append(carry)
        carry = chunk_decay[:, :, c, None, None] * carry \
            + states[:, c].float()
    prev_states = torch.stack(prevs, dim=1)                      # (B,C,H,P,N)

    # 4. inter-chunk contribution
    decay_out = torch.exp(a_cum)                                 # (B,H,C,L)
    y_off = nn.einsum("bczn,bchpn,bhcz->bczhp", cc,
                      prev_states.to(x.dtype), decay_out.to(x.dtype))

    y = (y_diag + y_off).reshape(bsz, s, h, p).to(x.dtype)
    return y, carry.to(x.dtype)


def mamba2_forward(params, cfg, x, *, chunk: int = 128, state=None):
    """Full-sequence Mamba2 mixer. Returns (y, {'conv', 'ssm'})."""
    bsz, s, d = x.shape
    d_inner = cfg.ssm_expand * d
    nh = d_inner // cfg.ssm_headdim
    n = cfg.ssm_state

    zxbcdt = nn.dense(params["in_proj"], x)
    z, xbc, dt = _split_proj(cfg, zxbcdt)
    conv_state = None if state is None else state["conv"]
    xbc, new_conv = _causal_conv(xbc, params["conv_w"], params["conv_b"],
                                 conv_state=conv_state)
    xs, b_mat, c_mat = (xbc[..., :d_inner], xbc[..., d_inner:d_inner + n],
                        xbc[..., d_inner + n:])

    dt = F.softplus(dt.float() + params["dt_bias"])              # (B,S,H)
    a = -torch.exp(params["a_log"])                              # (H,) < 0
    log_a = dt * a                                               # (B,S,H)

    xh = xs.reshape(bsz, s, nh, cfg.ssm_headdim)
    xdt = xh * dt[..., None].to(xh.dtype)
    ssm_state = None if state is None else state["ssm"]
    y, final = ssd_chunked(xdt, log_a, b_mat, c_mat, chunk=min(chunk, s),
                           initial_state=ssm_state)
    y = y + xh * params["d_skip"][None, None, :, None].to(xh.dtype)
    y = y.reshape(bsz, s, d_inner)
    y = nn.rmsnorm(params["norm"], y * F.silu(z), eps=cfg.norm_eps)
    y = shard_activation(y, ("batch", None, "mlp"))
    return nn.dense(params["out_proj"], y), {"conv": new_conv, "ssm": final}


def mamba2_decode(params, cfg, x, state):
    """One-token step. x: (B, 1, D); state {'conv': (B,K-1,C), 'ssm':
    (B,H,P,N)}. Returns (y, the new state); O(1) in sequence length."""
    bsz, _, d = x.shape
    d_inner = cfg.ssm_expand * d
    nh = d_inner // cfg.ssm_headdim
    n = cfg.ssm_state

    zxbcdt = nn.dense(params["in_proj"], x)
    z, xbc, dt = _split_proj(cfg, zxbcdt)
    xbc, new_conv = _causal_conv(xbc, params["conv_w"], params["conv_b"],
                                 conv_state=state["conv"])
    xs, b_mat, c_mat = (xbc[..., :d_inner], xbc[..., d_inner:d_inner + n],
                        xbc[..., d_inner + n:])

    dt = F.softplus(dt.float() + params["dt_bias"])
    a = -torch.exp(params["a_log"])
    decay = torch.exp(dt * a)[:, 0]                              # (B,H)

    xh = xs.reshape(bsz, nh, cfg.ssm_headdim)
    xdt = xh * dt[:, 0, :, None].to(xh.dtype)
    outer = nn.einsum("bhp,bn->bhpn", xdt, b_mat[:, 0])
    new_ssm = decay[..., None, None].to(xh.dtype) * state["ssm"] + outer
    y = nn.einsum("bhpn,bn->bhp", new_ssm, c_mat[:, 0])
    y = y + xh * params["d_skip"][None, :, None].to(xh.dtype)
    y = y.reshape(bsz, 1, d_inner)
    y = nn.rmsnorm(params["norm"], y * F.silu(z), eps=cfg.norm_eps)
    return (nn.dense(params["out_proj"], y),
            {"conv": new_conv, "ssm": new_ssm})


def mamba2_state_spec(cfg, batch: int, dtype=torch.float32) -> dict:
    """{'conv', 'ssm'}: (shape, dtype) of one layer's decode state."""
    d_inner = cfg.ssm_expand * cfg.d_model
    nh = d_inner // cfg.ssm_headdim
    conv_dim = d_inner + 2 * cfg.ssm_state
    return {
        "conv": ((batch, cfg.ssm_conv - 1, conv_dim), dtype),
        "ssm": ((batch, nh, cfg.ssm_headdim, cfg.ssm_state), dtype),
    }
