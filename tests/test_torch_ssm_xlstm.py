"""The port's recurrent mixers (`repro_torch.models.ssm`, `.xlstm`) and
their blocks and stacks against the reference on the CPU, on the same
numpy inputs and weights, and the reference's identities proven again in
the port: SSD == the naive recurrence, a split sequence with the state
carried == one pass, mamba2 / mLSTM / sLSTM decode == their forward
forms."""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

os.environ.setdefault("REPRO_TORCH_AUTOTUNE_CACHE", "off")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import SMOKES as JSMOKES  # noqa: E402
from repro.models import blocks as jblocks  # noqa: E402
from repro.models import nn as jnn  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro.models import xlstm as jxlstm  # noqa: E402
from repro_torch.configs.registry import SMOKES  # noqa: E402
from repro_torch.models import blocks, ssm, xlstm  # noqa: E402

# f32 parity with the reference: the two frameworks sum in different
# orders (~1e-6 on unit-scale values; the recurrences carry it along)
RTOL = ATOL = 2e-5
# the reference's bars for a decode recurrence against the chunked form
REC_RTOL, REC_ATOL = 2e-3, 3e-4
ZAMBA, XL = "zamba2-1.2b", "xlstm-350m"


def _np(x):
    return np.asarray(x, dtype=np.float32)


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _torch_tree(tree):
    if isinstance(tree, dict):
        return {k: _torch_tree(v) for k, v in tree.items()}
    return _t(tree)


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(_np(got), _np(want), rtol=rtol, atol=atol)


def _close_tree(got, want, rtol=RTOL, atol=ATOL):
    assert sorted(got) == sorted(want)
    for k in want:
        _close(got[k], want[k], rtol, atol)


def _params(spec_fn, arch, seed):
    """A block's params from the reference's init, every 1-D leaf (biases
    at 0, norm scales at 1, the SSM's a_log / dt_bias / d_skip) moved off
    its constant, as numpy."""
    params = jnn.init_params(jax.random.key(seed),
                             spec_fn(JSMOKES[arch], jnp.float32))
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: np.asarray(a) + (rng.normal(0, 0.3, a.shape).astype(
            np.float32) if a.ndim == 1 else 0), params)


def _ssd_inputs(b, s, h, p, n, seed, decay=0.1):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, s, h, p)).astype(np.float32),
            (-np.abs(rng.normal(size=(b, s, h))) * decay).astype(np.float32),
            rng.normal(size=(b, s, n)).astype(np.float32),
            rng.normal(size=(b, s, n)).astype(np.float32))


# ---------------------------------------------------------------------------
# SSD
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("s,chunk", [(16, 4), (16, 16), (12, 5), (7, 4)])
@pytest.mark.parametrize("with_state", [False, True])
def test_ssd_chunked_matches_reference(s, chunk, with_state):
    """Chunks dividing, whole, and shrinking to a divisor (12 by 5 -> 4,
    7 by 4 -> 1); with and without an initial state."""
    x, log_a, bm, cm = _ssd_inputs(2, s, 3, 4, 5, seed=s + chunk)
    st = (np.random.default_rng(1).normal(size=(2, 3, 4, 5))
          .astype(np.float32) if with_state else None)
    wy, wf = jssm.ssd_chunked(
        jnp.asarray(x), jnp.asarray(log_a), jnp.asarray(bm), jnp.asarray(cm),
        chunk=chunk, initial_state=None if st is None else jnp.asarray(st))
    gy, gf = ssm.ssd_chunked(_t(x), _t(log_a), _t(bm), _t(cm), chunk=chunk,
                             initial_state=None if st is None else _t(st))
    _close(gy, wy)
    _close(gf, wf)


def test_ssd_chunked_matches_naive_recurrence():
    """S_t = a_t S_{t-1} + x_t B_t^T; y_t = S_t C_t, in float64."""
    b, s, h, p, n = 2, 16, 3, 4, 5
    x, log_a, bm, cm = _ssd_inputs(b, s, h, p, n, seed=0)
    state = np.zeros((b, h, p, n))
    ys = []
    for t in range(s):
        a = np.exp(log_a[:, t].astype(np.float64))
        state = a[..., None, None] * state + np.einsum(
            "bhp,bn->bhpn", x[:, t].astype(np.float64), bm[:, t])
        ys.append(np.einsum("bhpn,bn->bhp", state, cm[:, t]))
    want = np.stack(ys, axis=1)
    for chunk in (4, 8, 16):
        got, final = ssm.ssd_chunked(_t(x), _t(log_a), _t(bm), _t(cm),
                                     chunk=chunk)
        _close(got, want, rtol=2e-4, atol=2e-4)
        _close(final, state, rtol=2e-4, atol=2e-4)


def test_ssd_initial_state_continuation():
    """Splitting a sequence in two with the state carried == one pass."""
    x, log_a, bm, cm = [_t(a) for a in _ssd_inputs(1, 12, 2, 4, 3, seed=1,
                                                   decay=0.2)]
    full, _ = ssm.ssd_chunked(x, log_a, bm, cm, chunk=4)
    y1, st = ssm.ssd_chunked(x[:, :8], log_a[:, :8], bm[:, :8], cm[:, :8],
                             chunk=4)
    y2, _ = ssm.ssd_chunked(x[:, 8:], log_a[:, 8:], bm[:, 8:], cm[:, 8:],
                            chunk=4, initial_state=st)
    _close(torch.cat([y1, y2], 1), full, rtol=1e-4, atol=1e-4)


def test_ssd_bf16_casts_as_the_reference():
    """bf16 inputs: the reference casts the carried states and the decay
    to bf16 before the off-diagonal product; the port casts at the same
    places, so both round alike (2e-2 of unit-scale outputs, a bf16 ulp
    or two), and both return bf16."""
    x, log_a, bm, cm = _ssd_inputs(2, 16, 3, 4, 5, seed=3)
    wy, wf = jssm.ssd_chunked(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(log_a),
        jnp.asarray(bm, jnp.bfloat16), jnp.asarray(cm, jnp.bfloat16),
        chunk=4)
    gy, gf = ssm.ssd_chunked(_t(x).bfloat16(), _t(log_a), _t(bm).bfloat16(),
                             _t(cm).bfloat16(), chunk=4)
    assert gy.dtype == gf.dtype == torch.bfloat16
    scale = float(np.abs(_np(wy)).max())
    _close(gy.float(), wy, rtol=0, atol=2e-2 * scale)
    _close(gf.float(), wf, rtol=0, atol=2e-2 * float(np.abs(_np(wf)).max()))


# ---------------------------------------------------------------------------
# Mamba2
# ---------------------------------------------------------------------------

def _mamba_state(cfg, b, rng):
    d_inner = cfg.ssm_expand * cfg.d_model
    nh = d_inner // cfg.ssm_headdim
    return {"conv": rng.normal(size=(b, cfg.ssm_conv - 1,
                                     d_inner + 2 * cfg.ssm_state))
            .astype(np.float32),
            "ssm": rng.normal(size=(b, nh, cfg.ssm_headdim, cfg.ssm_state))
            .astype(np.float32)}


@pytest.mark.parametrize("with_state", [False, True])
def test_mamba2_forward_matches_reference(with_state):
    cfg, jcfg = SMOKES[ZAMBA], JSMOKES[ZAMBA]
    params = _params(jssm.mamba2_spec, ZAMBA, seed=0)
    rng = np.random.default_rng(2)
    x = (rng.normal(size=(2, 12, cfg.d_model)) * 0.5).astype(np.float32)
    st = _mamba_state(cfg, 2, rng) if with_state else None
    wy, ws = jssm.mamba2_forward(
        jax.tree.map(jnp.asarray, params), jcfg, jnp.asarray(x), chunk=5,
        state=None if st is None else jax.tree.map(jnp.asarray, st))
    gy, gs = ssm.mamba2_forward(_torch_tree(params), cfg, _t(x), chunk=5,
                                state=None if st is None else
                                _torch_tree(st))
    _close(gy, wy)
    _close_tree(gs, ws)


def test_mamba2_decode_matches_reference():
    cfg, jcfg = SMOKES[ZAMBA], JSMOKES[ZAMBA]
    params = _params(jssm.mamba2_spec, ZAMBA, seed=1)
    rng = np.random.default_rng(3)
    st = _mamba_state(cfg, 2, rng)
    jst, tst = jax.tree.map(jnp.asarray, st), _torch_tree(st)
    for _ in range(3):
        x = rng.normal(size=(2, 1, cfg.d_model)).astype(np.float32)
        wy, jst = jssm.mamba2_decode(jax.tree.map(jnp.asarray, params), jcfg,
                                     jnp.asarray(x), jst)
        gy, tst = ssm.mamba2_decode(_torch_tree(params), cfg, _t(x), tst)
        _close(gy, wy)
        _close_tree(tst, jst)


def test_mamba_block_decode_matches_forward():
    cfg = SMOKES[ZAMBA]
    params = _torch_tree(_params(jblocks.mamba_block_spec, ZAMBA, 0))
    rng = np.random.default_rng(2)
    b, s = 2, 10
    x = _t(rng.normal(size=(b, s, cfg.d_model)) * 0.1)
    y_full, _ = blocks.mamba_block(params, cfg, x, chunk=5)
    state = {k: torch.zeros(shape, dtype=dt) for k, (shape, dt) in
             ssm.mamba2_state_spec(cfg, b).items()}
    outs = []
    for t in range(s):
        y, state = blocks.mamba_block_decode(params, cfg, x[:, t:t + 1],
                                             state)
        outs.append(y[:, 0])
    _close(torch.stack(outs, 1), y_full, rtol=REC_RTOL, atol=2e-4)


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

def _mlstm_inputs(b, s, h, dh, seed):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(b, s, h, dh)).astype(np.float32)
               for _ in range(3))
    ig = rng.normal(size=(b, s, h)).astype(np.float32)
    fg = (rng.normal(size=(b, s, h)) + 2.0).astype(np.float32)
    return q, k, v, ig, fg


@pytest.mark.parametrize("s,chunk", [(16, 4), (16, 256), (13, 4), (12, 5)])
@pytest.mark.parametrize("with_state", [False, True])
def test_mlstm_chunked_matches_reference(s, chunk, with_state):
    """The chunk shrinks on an odd S (13 by 4 -> 1) and on 12 by 5 -> 4."""
    q, k, v, ig, fg = _mlstm_inputs(2, s, 4, 8, seed=s * 3 + chunk)
    st = None
    if with_state:
        rng = np.random.default_rng(7)
        st = {"c": rng.normal(size=(2, 4, 8, 8)).astype(np.float32),
              "n": rng.normal(size=(2, 4, 8)).astype(np.float32),
              "m": rng.normal(size=(2, 4)).astype(np.float32)}
    wo, ws = jxlstm.mlstm_chunked(
        *map(jnp.asarray, (q, k, v, ig, fg)), chunk=chunk,
        state=None if st is None else jax.tree.map(jnp.asarray, st))
    go, gs = xlstm.mlstm_chunked(*map(_t, (q, k, v, ig, fg)), chunk=chunk,
                                 state=None if st is None else
                                 _torch_tree(st))
    _close(go, wo)
    _close_tree(gs, ws, rtol=RTOL, atol=1e-4)


def _mlstm_state(cfg, b, rng):
    d_inner = cfg.xlstm_pf * cfg.d_model
    h = cfg.n_heads
    dh = d_inner // h
    return {"c": rng.normal(size=(b, h, dh, dh)).astype(np.float32),
            "n": rng.normal(size=(b, h, dh)).astype(np.float32),
            "m": rng.normal(size=(b, h)).astype(np.float32),
            "conv": rng.normal(size=(b, cfg.xlstm_conv - 1, d_inner))
            .astype(np.float32)}


@pytest.mark.parametrize("with_state", [False, True])
def test_mlstm_forward_matches_reference(with_state):
    cfg, jcfg = SMOKES[XL], JSMOKES[XL]
    params = _params(jxlstm.mlstm_spec, XL, seed=2)
    rng = np.random.default_rng(4)
    x = (rng.normal(size=(2, 12, cfg.d_model)) * 0.3).astype(np.float32)
    st = _mlstm_state(cfg, 2, rng) if with_state else None
    wy, ws = jxlstm.mlstm_forward(
        jax.tree.map(jnp.asarray, params), jcfg, jnp.asarray(x), chunk=4,
        state=None if st is None else jax.tree.map(jnp.asarray, st),
        return_state=True)
    gy, gs = xlstm.mlstm_forward(
        _torch_tree(params), cfg, _t(x), chunk=4,
        state=None if st is None else _torch_tree(st), return_state=True)
    _close(gy, wy)
    _close_tree(gs, ws, rtol=RTOL, atol=1e-4)
    gy2 = xlstm.mlstm_forward(_torch_tree(params), cfg, _t(x), chunk=4,
                              state=None if st is None else _torch_tree(st))
    assert torch.equal(gy2, gy)


def test_mlstm_decode_matches_reference():
    cfg, jcfg = SMOKES[XL], JSMOKES[XL]
    params = _params(jxlstm.mlstm_spec, XL, seed=3)
    rng = np.random.default_rng(5)
    st = _mlstm_state(cfg, 2, rng)
    jst, tst = jax.tree.map(jnp.asarray, st), _torch_tree(st)
    for _ in range(3):
        x = rng.normal(size=(2, 1, cfg.d_model)).astype(np.float32)
        wy, jst = jxlstm.mlstm_decode(jax.tree.map(jnp.asarray, params),
                                      jcfg, jnp.asarray(x), jst)
        gy, tst = xlstm.mlstm_decode(_torch_tree(params), cfg, _t(x), tst)
        _close(gy, wy)
        _close_tree(tst, jst, rtol=RTOL, atol=1e-4)


def test_mlstm_chunked_matches_decode_recurrence():
    cfg = SMOKES[XL]
    params = _torch_tree(_params(jblocks.mlstm_block_spec, XL, seed=3))
    rng = np.random.default_rng(4)
    b, s = 2, 12
    x = _t(rng.normal(size=(b, s, cfg.d_model)) * 0.3)
    y_full = blocks.mlstm_block(params, cfg, x, chunk=4)
    state = {k: (torch.full(shape, xlstm.NEG_INF) if k == "m"
                 else torch.zeros(shape, dtype=dt))
             for k, (shape, dt) in xlstm.mlstm_state_spec(cfg, b).items()}
    outs = []
    for t in range(s):
        y, state = blocks.mlstm_block_decode(params, cfg, x[:, t:t + 1],
                                             state)
        outs.append(y[:, 0])
    _close(torch.stack(outs, 1), y_full, rtol=REC_RTOL, atol=REC_ATOL)


def test_mlstm_stabilizer_is_finite_at_the_start():
    """m starts at NEG_INF = -1e30 (not -inf): the first chunk's
    exp(m_inter - m_t) and the state update stay finite."""
    q, k, v, ig, fg = map(_t, _mlstm_inputs(1, 8, 2, 4, seed=9))
    out, st = xlstm.mlstm_chunked(q, k, v, ig, fg, chunk=4)
    assert bool(torch.isfinite(out).all())
    assert all(bool(torch.isfinite(t).all()) for t in st.values())


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

def _slstm_state(cfg, b, rng):
    return {k: (rng.normal(size=(b, cfg.d_model)) * (0.5 if k != "n"
                                                      else 0.1) +
                (1.0 if k == "n" else 0.0)).astype(np.float32)
            for k in ("c", "n", "h", "m")}


@pytest.mark.parametrize("with_state", [False, True])
def test_slstm_forward_matches_reference(with_state):
    cfg, jcfg = SMOKES[XL], JSMOKES[XL]
    params = _params(jxlstm.slstm_spec, XL, seed=4)
    rng = np.random.default_rng(6)
    x = (rng.normal(size=(2, 9, cfg.d_model)) * 0.3).astype(np.float32)
    st = _slstm_state(cfg, 2, rng) if with_state else None
    wy, ws = jxlstm.slstm_forward(
        jax.tree.map(jnp.asarray, params), jcfg, jnp.asarray(x),
        state=None if st is None else jax.tree.map(jnp.asarray, st))
    gy, gs = xlstm.slstm_forward(_torch_tree(params), cfg, _t(x),
                                 state=None if st is None else
                                 _torch_tree(st))
    _close(gy, wy)
    _close_tree(gs, ws)


def test_slstm_decode_matches_reference():
    cfg, jcfg = SMOKES[XL], JSMOKES[XL]
    params = _params(jxlstm.slstm_spec, XL, seed=5)
    rng = np.random.default_rng(7)
    st = _slstm_state(cfg, 2, rng)
    x = rng.normal(size=(2, 1, cfg.d_model)).astype(np.float32)
    wy, ws = jxlstm.slstm_decode(jax.tree.map(jnp.asarray, params), jcfg,
                                 jnp.asarray(x),
                                 jax.tree.map(jnp.asarray, st))
    gy, gs = xlstm.slstm_decode(_torch_tree(params), cfg, _t(x),
                                _torch_tree(st))
    _close(gy, wy)
    _close_tree(gs, ws)


def test_slstm_forward_matches_stepwise():
    cfg = SMOKES[XL]
    params = _torch_tree(_params(jblocks.slstm_block_spec, XL, seed=5))
    rng = np.random.default_rng(6)
    b, s = 2, 9
    x = _t(rng.normal(size=(b, s, cfg.d_model)) * 0.3)
    y_full, _ = blocks.slstm_block(params, cfg, x)
    state = {k: torch.zeros((b, cfg.d_model)) for k in ("c", "n", "h", "m")}
    outs = []
    for t in range(s):
        y, state = blocks.slstm_block_decode(params, cfg, x[:, t:t + 1],
                                             state)
        outs.append(y[:, 0])
    _close(torch.stack(outs, 1), y_full, rtol=REC_RTOL, atol=REC_ATOL)


# ---------------------------------------------------------------------------
# Blocks and stacks against the reference
# ---------------------------------------------------------------------------

def _stacked(spec_fn, arch, n, seed):
    """n layers' params, stacked (reference) and as a list (port)."""
    layers = [_params(spec_fn, arch, seed + i) for i in range(n)]
    stacked = jax.tree.map(lambda *xs: jnp.asarray(np.stack(xs)), *layers)
    return stacked, [_torch_tree(p) for p in layers]


def test_mamba_stacks_match_reference():
    cfg, jcfg = SMOKES[ZAMBA], JSMOKES[ZAMBA]
    jstack, tlayers = _stacked(jblocks.mamba_block_spec, ZAMBA, 3, seed=10)
    rng = np.random.default_rng(8)
    x = (rng.normal(size=(2, 12, cfg.d_model)) * 0.5).astype(np.float32)
    want = jblocks.mamba_stack(jstack, jcfg, jnp.asarray(x), chunk=4)
    _close(blocks.mamba_stack(tlayers, cfg, _t(x), chunk=4), want)
    wx, wst = jblocks.mamba_stack_prefill(jstack, jcfg, jnp.asarray(x),
                                          chunk=4)
    gx, gst = blocks.mamba_stack_prefill(tlayers, cfg, _t(x), chunk=4)
    _close(gx, wx)
    _close_tree(gst, wst)
    tok = rng.normal(size=(2, 1, cfg.d_model)).astype(np.float32)
    wx, wst = jblocks.mamba_stack_decode(jstack, jcfg, jnp.asarray(tok), wst)
    gx, gst = blocks.mamba_stack_decode(tlayers, cfg, _t(tok), gst)
    _close(gx, wx)
    _close_tree(gst, wst)


def test_xlstm_blocks_and_stacks_match_reference():
    cfg, jcfg = SMOKES[XL], JSMOKES[XL]
    jstack, tlayers = _stacked(jblocks.mlstm_block_spec, XL, 2, seed=20)
    rng = np.random.default_rng(9)
    x = (rng.normal(size=(2, 12, cfg.d_model)) * 0.5).astype(np.float32)
    want = jblocks.mlstm_stack(jstack, jcfg, jnp.asarray(x), chunk=5)
    _close(blocks.mlstm_stack(tlayers, cfg, _t(x), chunk=5), want)
    wx, wst = jblocks.mlstm_stack_prefill(jstack, jcfg, jnp.asarray(x),
                                          chunk=5)
    gx, gst = blocks.mlstm_stack_prefill(tlayers, cfg, _t(x), chunk=5)
    _close(gx, wx)
    _close_tree(gst, wst, rtol=RTOL, atol=1e-4)
    tok = rng.normal(size=(2, 1, cfg.d_model)).astype(np.float32)
    wx, wst = jblocks.mlstm_stack_decode(jstack, jcfg, jnp.asarray(tok), wst)
    gx, gst = blocks.mlstm_stack_decode(tlayers, cfg, _t(tok), gst)
    _close(gx, wx)
    _close_tree(gst, wst, rtol=RTOL, atol=1e-4)

    sl = _params(jblocks.slstm_block_spec, XL, seed=30)
    wy, ws = jblocks.slstm_block(jax.tree.map(jnp.asarray, sl), jcfg,
                                 jnp.asarray(x))
    gy, gs = blocks.slstm_block(_torch_tree(sl), cfg, _t(x))
    _close(gy, wy)
    _close_tree(gs, ws)
    wy, ws = jblocks.slstm_block_decode(jax.tree.map(jnp.asarray, sl), jcfg,
                                        jnp.asarray(tok), ws)
    gy, gs = blocks.slstm_block_decode(_torch_tree(sl), cfg, _t(tok), gs)
    _close(gy, wy)
    _close_tree(gs, ws)


@pytest.mark.parametrize("kind", ["mamba", "mlstm"])
def test_recurrent_stacks_remat_changes_memory_never_bits(kind):
    """The stacks the reference wraps in its remat policy: none, full and
    dots give the same loss and gradients bit for bit."""
    arch = ZAMBA if kind == "mamba" else XL
    cfg = SMOKES[arch]
    spec = (jblocks.mamba_block_spec if kind == "mamba"
            else jblocks.mlstm_block_spec)
    _, layers = _stacked(spec, arch, 2, seed=40)
    x = _t(np.random.default_rng(1).normal(size=(2, 8, cfg.d_model)))
    stack = blocks.mamba_stack if kind == "mamba" else blocks.mlstm_stack
    out = {}
    for policy in ("none", "full", "dots"):
        ps = [jax.tree.map(lambda a: a.clone().requires_grad_(), p)
              for p in layers]
        y = stack(ps, cfg, x, chunk=4, remat=policy)
        loss = (y ** 2).sum()
        out[policy] = (loss, torch.autograd.grad(
            loss, [leaf for p in ps for leaf in jax.tree.leaves(p)]))
    for policy in ("full", "dots"):
        assert torch.equal(out[policy][0], out["none"][0])
        assert all(torch.equal(a, b) for a, b in
                   zip(out[policy][1], out["none"][1]))
