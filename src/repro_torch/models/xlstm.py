"""xLSTM blocks (arXiv:2405.04517): mLSTM (matrix memory, parallelizable)
and sLSTM (scalar memory, strictly recurrent) (twin of
`repro/models/xlstm.py`).

mLSTM training / prefill use the stabilized chunkwise-parallel form: an
attention-like product inside a chunk with a gate-derived decay matrix,
and a (C, n, m) state carried across chunks by a Python loop where the
reference scans. Decode uses the recurrent form, O(1) a token.

sLSTM has no parallel form (a true recurrence with exponential gating):
a time loop. xlstm-350m interleaves one sLSTM block per `slstm_every`
layers.

The stabiliser's "minus infinity" is NEG_INF = -1e30, as the reference's:
the running max m starts there, and exp(x - m) of two true infinities
would be NaN.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models import nn
from repro_torch.sharding import shard_activation

NEG_INF = -1e30


def _gelu(x):
    # jax.nn.gelu's default is the tanh approximation
    return F.gelu(x, approximate="tanh")


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

def mlstm_spec(cfg, dtype):
    d = cfg.d_model
    d_inner = cfg.xlstm_pf * d                 # projection factor 2
    h = cfg.n_heads
    return {
        "up": nn.dense_spec(d, 2 * d_inner, "embed", "mlp", dtype=dtype),
        "conv_w": nn.ParamSpec((cfg.xlstm_conv, d_inner), (None, "mlp"),
                               init="fanin", dtype=dtype),
        "conv_b": nn.ParamSpec((d_inner,), ("mlp",), init="zeros",
                               dtype=dtype),
        "wq": nn.dense_spec(d_inner, d_inner, "mlp", None, dtype=dtype),
        "wk": nn.dense_spec(d_inner, d_inner, "mlp", None, dtype=dtype),
        "wv": nn.dense_spec(d_inner, d_inner, "mlp", None, dtype=dtype),
        "w_i": nn.dense_spec(d_inner, h, "mlp", None, dtype=torch.float32),
        "w_f": nn.dense_spec(d_inner, h, "mlp", None, dtype=torch.float32),
        "norm": nn.rmsnorm_spec(d_inner, dtype=dtype),
        "down": nn.dense_spec(d_inner, d, "mlp", "embed", dtype=dtype,
                              init="fanin_deep",
                              scale=1.0 / max(cfg.n_layers, 1) ** 0.5),
    }


def _conv_window(xp, w, s):
    """sum_i xp[:, i:i+s] * w[i]: the causal conv over a padded input."""
    return sum(xp[:, i:i + s, :] * w[i] for i in range(w.shape[0]))


def _causal_conv1d(x, w, b):
    k = w.shape[0]
    pad = x.new_zeros((x.shape[0], k - 1, x.shape[-1]))
    xp = torch.cat([pad, x], dim=1)
    return F.silu(_conv_window(xp, w, x.shape[1]) + b)


def mlstm_chunked(q, k, v, i_gate, f_gate, *, chunk: int = 256, state=None):
    """Chunkwise-parallel stabilized mLSTM.

    Intra-chunk: a decay matrix D from cumulative log-f and the input
    gates, stabilized by a running max; across chunks: the (C, n, m)
    state. O(S * chunk) memory. The chunk shrinks to the largest divisor
    of S.

    q,k,v: (B,S,H,Dh); i_gate,f_gate: (B,S,H) raw pre-activations.
    Returns (out (B,S,H,Dh) in v's dtype, final state {c,n,m} f32).
    """
    b, s, h, dh = q.shape
    chunk = min(chunk, s)
    while s % chunk != 0:
        chunk -= 1
    nc = s // chunk
    k = k * (dh ** -0.5)

    if state is None:
        c = torch.zeros((b, h, dh, dh), dtype=torch.float32, device=q.device)
        n = torch.zeros((b, h, dh), dtype=torch.float32, device=q.device)
        m = torch.full((b, h), NEG_INF, dtype=torch.float32, device=q.device)
    else:
        c, n, m = (state["c"].float(), state["n"].float(),
                   state["m"].float())

    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=q.device))
    outs = []
    for j in range(nc):
        sl = slice(j * chunk, (j + 1) * chunk)
        qc, kc, vc, ic, fc = (q[:, sl], k[:, sl], v[:, sl], i_gate[:, sl],
                              f_gate[:, sl])
        log_f = F.logsigmoid(fc.float())
        cum_f = torch.cumsum(log_f, dim=1)                # (B,L,H) inclusive
        # intra-chunk decay D[t,s'] = F_t - F_s' + i_s'  (s' <= t)
        dmat = (cum_f[:, :, None, :] - cum_f[:, None, :, :]
                + ic.float()[:, None, :, :])              # (B,T,S,H)
        dmat = torch.where(tri[None, :, :, None], dmat, NEG_INF)
        m_intra = torch.amax(dmat, dim=2)                 # (B,T,H)
        m_inter = cum_f + m[:, None, :]                   # (B,T,H)
        m_t = torch.maximum(m_intra, m_inter)
        dexp = torch.exp(dmat - m_t[:, :, None, :])
        scores = torch.einsum("bthd,bshd->btsh", qc, kc).float()
        scores = scores * dexp
        inter_scale = torch.exp(m_inter - m_t)            # (B,T,H)
        out_intra = torch.einsum("btsh,bshd->bthd", scores.to(vc.dtype), vc)
        # c layout is (B, H, d_v, e_k): contract q with the K dim (e)
        out_inter = torch.einsum("bthe,bhde->bthd", qc.float(), c)
        num = out_intra.float() + inter_scale[..., None] * out_inter
        den_intra = scores.sum(dim=2)                     # (B,T,H)
        den_inter = torch.einsum("bthe,bhe->bth", qc.float(), n)
        den = torch.abs(den_intra + inter_scale * den_inter)
        den = torch.maximum(den, torch.exp(-m_t))
        outs.append(num / torch.clamp(den[..., None], min=1e-6))

        # chunk-end state update
        f_last = cum_f[:, -1, :]                          # (B,H)
        decay_s = f_last[:, None, :] - cum_f + ic.float()  # (B,L,H)
        m_new = torch.maximum(f_last + m, torch.amax(decay_s, dim=1))
        w_s = torch.exp(decay_s - m_new[:, None, :])      # (B,L,H)
        carry_scale = torch.exp(f_last + m - m_new)       # (B,H)
        c = (carry_scale[..., None, None] * c
             + torch.einsum("blh,blhd,blhe->bhde", w_s, vc.float(),
                            kc.float()))
        n = (carry_scale[..., None] * n
             + torch.einsum("blh,blhd->bhd", w_s, kc.float()))
        m = m_new
    out = outs[0] if nc == 1 else torch.cat(outs, dim=1)
    return out.to(v.dtype), {"c": c, "n": n, "m": m}


def mlstm_forward(params, cfg, x, *, chunk: int = 256, state=None,
                  return_state: bool = False):
    b, s, d = x.shape
    d_inner = cfg.xlstm_pf * d
    h = cfg.n_heads
    dh = d_inner // h
    xz = nn.dense(params["up"], x)
    xi_raw, z = xz[..., :d_inner], xz[..., d_inner:]
    conv_state = None if state is None else state["conv"]
    kw = params["conv_w"].shape[0]
    if conv_state is not None:
        xp = torch.cat([conv_state, xi_raw], dim=1)
        xi = F.silu(_conv_window(xp, params["conv_w"], s) + params["conv_b"])
    else:
        xi = _causal_conv1d(xi_raw, params["conv_w"], params["conv_b"])
    q = nn.dense(params["wq"], xi).reshape(b, s, h, dh)
    k = nn.dense(params["wk"], xi).reshape(b, s, h, dh)
    v = nn.dense(params["wv"], xi).reshape(b, s, h, dh)
    i_gate = nn.dense(params["w_i"], xi.float())
    f_gate = nn.dense(params["w_f"], xi.float())
    mstate = None if state is None else {k_: state[k_]
                                         for k_ in ("c", "n", "m")}
    o, new_state = mlstm_chunked(q, k, v, i_gate, f_gate, chunk=chunk,
                                 state=mstate)
    o = o.reshape(b, s, d_inner)
    o = nn.rmsnorm(params["norm"], o, eps=cfg.norm_eps)
    o = o * F.silu(z)
    o = shard_activation(o, ("batch", None, "mlp"))
    y = nn.dense(params["down"], o)
    if return_state:
        if conv_state is None:
            pad = xi_raw.new_zeros((b, kw - 1, d_inner))
            xp_full = torch.cat([pad, xi_raw], dim=1)
        else:
            xp_full = torch.cat([conv_state, xi_raw], dim=1)
        new_state = dict(new_state)
        new_state["conv"] = xp_full[:, -(kw - 1):, :]
        return y, new_state
    return y


def mlstm_state_spec(cfg, batch: int, dtype=torch.float32) -> dict:
    """{'c', 'n', 'm', 'conv'}: (shape, dtype) of one layer's state."""
    d_inner = cfg.xlstm_pf * cfg.d_model
    h = cfg.n_heads
    dh = d_inner // h
    return {
        "c": ((batch, h, dh, dh), dtype),
        "n": ((batch, h, dh), dtype),
        "m": ((batch, h), dtype),
        "conv": ((batch, cfg.xlstm_conv - 1, d_inner), dtype),
    }


def mlstm_decode(params, cfg, x, state):
    """Recurrent mLSTM step. x: (B,1,D). State: c (B,H,Dh,Dh), n, m, conv."""
    b, _, d = x.shape
    d_inner = cfg.xlstm_pf * d
    h = cfg.n_heads
    dh = d_inner // h
    xz = nn.dense(params["up"], x)
    xi, z = xz[..., :d_inner], xz[..., d_inner:]
    k_w = params["conv_w"].shape[0]
    xp = torch.cat([state["conv"], xi], dim=1)
    xc = F.silu(_conv_window(xp, params["conv_w"], 1) + params["conv_b"])
    new_conv = xp[:, -(k_w - 1):, :]

    q = nn.dense(params["wq"], xc).reshape(b, h, dh)
    k = nn.dense(params["wk"], xc).reshape(b, h, dh) * (dh ** -0.5)
    v = nn.dense(params["wv"], xc).reshape(b, h, dh)
    i_raw = nn.dense(params["w_i"], xc.float())[:, 0]               # (B,H)
    f_raw = nn.dense(params["w_f"], xc.float())[:, 0]

    log_f = F.logsigmoid(f_raw)
    m_new = torch.maximum(log_f + state["m"], i_raw)
    i_s = torch.exp(i_raw - m_new)
    f_s = torch.exp(log_f + state["m"] - m_new)

    c_new = (f_s[..., None, None] * state["c"]
             + i_s[..., None, None] * torch.einsum("bhd,bhe->bhde", v, k))
    n_new = f_s[..., None] * state["n"] + i_s[..., None] * k
    hnum = nn.einsum("bhde,bhe->bhd", c_new, q)
    hden = torch.maximum(torch.abs(nn.einsum("bhe,bhe->bh", n_new, q)),
                         torch.exp(-m_new))
    o = (hnum / hden[..., None]).reshape(b, 1, d_inner).to(x.dtype)
    o = nn.rmsnorm(params["norm"], o, eps=cfg.norm_eps) * F.silu(z)
    y = nn.dense(params["down"], o)
    return y, {"c": c_new, "n": n_new, "m": m_new, "conv": new_conv}


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

def slstm_spec(cfg, dtype):
    d = cfg.d_model
    h = cfg.n_heads
    dh = d // h
    gates = {}
    for g in ("i", "f", "z", "o"):
        gates[f"w_{g}"] = nn.dense_spec(d, d, "embed", "heads", dtype=dtype)
        gates[f"r_{g}"] = nn.ParamSpec((h, dh, dh), (None, "heads", None),
                                       init="fanin", dtype=dtype)
        gates[f"b_{g}"] = nn.ParamSpec((d,), ("heads",), init="zeros",
                                       dtype=torch.float32)
    ff = max(1, int(cfg.d_model * 4 // 3))
    gates["norm"] = nn.rmsnorm_spec(d, dtype=dtype)
    gates["ff_up"] = nn.dense_spec(d, 2 * ff, "embed", "mlp", dtype=dtype)
    gates["ff_down"] = nn.dense_spec(ff, d, "mlp", "embed", dtype=dtype,
                                     init="fanin_deep",
                                     scale=1.0 / max(cfg.n_layers, 1) ** 0.5)
    return gates


def slstm_state_spec(cfg, batch: int, dtype=torch.float32) -> dict:
    """{'c', 'n', 'h', 'm'}: (shape, dtype) of one layer's state."""
    return {k: ((batch, cfg.d_model), dtype) for k in ("c", "n", "h", "m")}


def _slstm_cell(params, cfg, x_t, state):
    """One sLSTM step. x_t: (B, D)."""
    b, d = x_t.shape
    h = cfg.n_heads
    dh = d // h
    h_prev = state["h"].reshape(b, h, dh)

    def gate(name):
        wx = nn.dense(params[f"w_{name}"], x_t).reshape(b, h, dh)
        rh = torch.einsum("bhd,hde->bhe", h_prev,
                          params[f"r_{name}"].to(h_prev.dtype))
        return (wx + rh).reshape(b, d).float() + params[f"b_{name}"]

    i_raw, f_raw, z_raw, o_raw = gate("i"), gate("f"), gate("z"), gate("o")
    log_f = F.logsigmoid(f_raw)
    m_new = torch.maximum(log_f + state["m"], i_raw)
    i_s = torch.exp(i_raw - m_new)
    f_s = torch.exp(log_f + state["m"] - m_new)
    c_new = f_s * state["c"] + i_s * torch.tanh(z_raw)
    n_new = f_s * state["n"] + i_s
    h_new = torch.sigmoid(o_raw) * c_new / torch.clamp(n_new, min=1e-6)
    return {"c": c_new, "n": n_new, "h": h_new, "m": m_new}


def _slstm_out(params, cfg, y):
    y = nn.rmsnorm(params["norm"], y, eps=cfg.norm_eps)
    up = nn.dense(params["ff_up"], y)
    half = up.shape[-1] // 2
    return nn.dense(params["ff_down"], _gelu(up[..., :half]) * up[..., half:])


def slstm_forward(params, cfg, x, *, state=None):
    """The recurrence over time. x: (B,S,D). Returns (y, final_state)."""
    b, s, d = x.shape
    if state is None:
        state = {k: torch.zeros((b, d), dtype=torch.float32, device=x.device)
                 for k in ("c", "n", "h", "m")}
    hs = []
    for t in range(s):
        state = _slstm_cell(params, cfg, x[:, t], state)
        hs.append(state["h"])
    y = torch.stack(hs, dim=1).to(x.dtype)
    return _slstm_out(params, cfg, y), state


def slstm_decode(params, cfg, x, state):
    new = _slstm_cell(params, cfg, x[:, 0, :], state)
    y = new["h"][:, None, :].to(x.dtype)
    return _slstm_out(params, cfg, y), new
