"""The port's MoE FFN (`repro_torch.models.moe`) and the MoE decoder block
against the reference on the CPU, on the same numpy inputs and weights:
the router, the dispatch ranks (exactly), the FFN with token chunks and
with the expert loop, the block, and the reference's own identities
proven again in the port (no-drop == the dense mixture, scan-experts ==
einsum, capacity drops with unique slots, the shared path at capacity
factor 0, the decode-time drops)."""

import math
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

os.environ.setdefault("REPRO_TORCH_AUTOTUNE_CACHE", "off")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import SMOKES as JSMOKES  # noqa: E402
from repro.models import blocks as jblocks  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import nn as jnn  # noqa: E402
from repro.models.model import _positions as j_positions  # noqa: E402
from repro.models.model import build_model as jbuild  # noqa: E402
from repro_torch import compat  # noqa: E402
from repro_torch.configs.registry import ARCHS, SMOKES  # noqa: E402
from repro_torch.models import blocks, moe, nn  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402

MOE = ["grok-1-314b", "qwen2-moe-a2.7b"]
# f32 parity with the reference: the frameworks sum in different orders
# (~1e-6 on unit-scale values)
RTOL = ATOL = 1e-5


def _np(x):
    return np.asarray(x, dtype=np.float32)


def _torch_tree(tree):
    if isinstance(tree, dict):
        return {k: _torch_tree(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree, dtype=np.float32))


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(_np(got), _np(want), rtol=rtol, atol=atol)


def _setup(arch, seed=0, **over):
    """(reference cfg, port cfg, moe params as numpy with every 1-D leaf
    moved off its constant, x (2, 8, D))."""
    jcfg, tcfg = JSMOKES[arch].replace(**over), SMOKES[arch].replace(**over)
    params = jnn.init_params(jax.random.key(seed),
                             jmoe.moe_spec(jcfg, jnp.float32))
    rng = np.random.default_rng(seed)
    params = jax.tree.map(
        lambda a: np.asarray(a) + (rng.normal(0, 0.3, a.shape).astype(
            np.float32) if a.ndim == 1 else 0), params)
    x = (rng.normal(size=(2, 8, jcfg.d_model)) * 0.5).astype(np.float32)
    return jcfg, tcfg, params, x


def _both(fn_j, fn_t, params, *args):
    want = fn_j(jax.tree.map(jnp.asarray, params),
                *[jnp.asarray(a) if isinstance(a, np.ndarray) else a
                  for a in args])
    got = fn_t(_torch_tree(params),
               *[torch.from_numpy(a) if isinstance(a, np.ndarray) else a
                 for a in args])
    return want, got


# ---------------------------------------------------------------------------
# Router and dispatch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", MOE)
def test_route_matches_reference(arch):
    jcfg, _, params, x = _setup(arch)
    x2d = x.reshape(-1, jcfg.d_model)
    e, k = jcfg.moe_n_experts, jcfg.moe_top_k
    (jw, jids, jaux), (tw, tids, taux) = _both(
        lambda p, x_: jmoe._route(p["router"], x_, e, k),
        lambda p, x_: moe._route(p["router"], x_, e, k), params, x2d)
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    _close(tw, jw)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-6)
    assert tw.dtype == torch.float32


@pytest.mark.parametrize("t,k,e,capacity", [(16, 2, 4, 3), (64, 2, 5, 1000),
                                            (37, 4, 60, 1), (33, 1, 2, 7)])
def test_dispatch_indices_equal_reference_exactly(t, k, e, capacity):
    rng = np.random.default_rng(t * 31 + e)
    ids = rng.integers(0, e, size=(t, k)).astype(np.int32)
    jpos, jkeep = jmoe._dispatch_indices(jnp.asarray(ids), e, capacity)
    tpos, tkeep = moe._dispatch_indices(torch.from_numpy(ids).long(), e,
                                        capacity)
    np.testing.assert_array_equal(tpos.numpy(), np.asarray(jpos))
    np.testing.assert_array_equal(tkeep.numpy(), np.asarray(jkeep))


def test_dispatch_capacity_drops():
    """The reference's case: with capacity 1, one slot per expert."""
    ids = torch.tensor([[0], [0], [0], [1]])
    pos, keep = moe._dispatch_indices(ids, n_experts=2, capacity=1)
    assert int(keep.sum()) == 2
    assert int(pos[0, 0]) == 0 and not bool(keep[1, 0])


def test_dispatch_positions_unique_per_expert():
    rng = np.random.default_rng(0)
    ids = torch.from_numpy(rng.integers(0, 5, size=(64, 2)))
    pos, keep = moe._dispatch_indices(ids, n_experts=5, capacity=1000)
    assert bool(keep.all())
    flat_e, flat_p = ids.reshape(-1).numpy(), pos.reshape(-1).numpy()
    for e in range(5):
        np.testing.assert_array_equal(np.sort(flat_p[flat_e == e]),
                                      np.arange(int((flat_e == e).sum())))


# ---------------------------------------------------------------------------
# The FFN
# ---------------------------------------------------------------------------

CASES = {
    "default": {},                           # capacity 1.25: drops
    "no_drop": {"moe_capacity_factor": 8.0},
    "token_chunks": {"moe_token_chunks": 4},
    "chunks_not_dividing": {"moe_token_chunks": 3},    # runs unchunked
    "scan_experts": {"moe_scan_experts": True},
    "tight": {"moe_capacity_factor": 0.3},
}


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("arch", MOE)
def test_moe_ffn_matches_reference(arch, case):
    jcfg, tcfg, params, x = _setup(arch, seed=1, **CASES[case])
    (jy, jaux), (ty, taux) = _both(
        lambda p, x_: jmoe.moe_ffn(p, jcfg, x_),
        lambda p, x_: moe.moe_ffn(p, tcfg, x_), params, x)
    _close(ty, jy)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-6)


@pytest.mark.parametrize("arch", MOE)
def test_moe_ffn_gradients_match_reference(arch):
    """d(sum(y * r) + aux)/d(params, x), the expert loop under checkpoint
    (grok-1) included."""
    jcfg, tcfg, params, x = _setup(arch, seed=2)
    r = np.random.default_rng(9).normal(size=x.shape).astype(np.float32)

    def jloss(p, x_):
        y, aux = jmoe.moe_ffn(p, jcfg, x_)
        return jnp.sum(y * r) + aux

    jg, jgx = jax.grad(jloss, argnums=(0, 1))(
        jax.tree.map(jnp.asarray, params), jnp.asarray(x))
    tp = jax.tree.map(lambda a: a.requires_grad_(), _torch_tree(params))
    tx = torch.from_numpy(x).requires_grad_()
    y, aux = moe.moe_ffn(tp, tcfg, tx)
    loss = torch.sum(y * torch.from_numpy(r)) + aux
    leaves = jax.tree.leaves(tp) + [tx]
    grads = torch.autograd.grad(loss, leaves)
    for g, w in zip(grads, jax.tree.leaves(jg) + [jgx]):
        w = _np(w)
        assert float(np.abs(g.numpy() - w).max()) <= 1e-5 * max(
            float(np.abs(w).max()), 1e-6)


def _dense_mixture(params, cfg, x):
    """Ground truth: every expert on every token, weighted by the router
    (the reference test's), in the port."""
    b, s, d = x.shape
    x2d = x.reshape(-1, d)
    probs = torch.softmax(nn.dense(params["router"], x2d), dim=-1)
    w, ids = torch.topk(probs, cfg.moe_top_k)
    w = w / w.sum(-1, keepdim=True)
    g = torch.einsum("td,edf->tef", x2d, params["w_gate"])
    u = torch.einsum("td,edf->tef", x2d, params["w_up"])
    y_all = torch.einsum("tef,efd->ted", torch.nn.functional.silu(g) * u,
                         params["w_down"])
    mask = torch.zeros_like(probs).scatter(1, ids, w)
    y = torch.einsum("ted,te->td", y_all, mask)
    if "shared" in params:
        from repro_torch.models import mlp
        gate = torch.sigmoid(nn.dense(params["shared_gate"], x2d))
        y = y + mlp.swiglu(params["shared"], x2d) * gate
    return y.reshape(b, s, d)


@pytest.mark.parametrize("arch", MOE)
def test_no_drop_matches_dense_mixture(arch):
    _, tcfg, params, x = _setup(arch, moe_capacity_factor=16.0)
    p = _torch_tree(params)
    got, aux = moe.moe_ffn(p, tcfg, torch.from_numpy(x))
    _close(got, _dense_mixture(p, tcfg, torch.from_numpy(x)), rtol=2e-4,
           atol=2e-5)
    assert float(aux) > 0


def test_scan_experts_equals_einsum():
    _, tcfg, params, x = _setup("grok-1-314b", seed=3,
                                moe_capacity_factor=16.0)
    p, xt = _torch_tree(params), torch.from_numpy(x)
    y_scan, _ = moe.moe_ffn(p, tcfg.replace(moe_scan_experts=True), xt)
    y_ein, _ = moe.moe_ffn(p, tcfg.replace(moe_scan_experts=False), xt)
    _close(y_scan, y_ein, rtol=1e-5, atol=1e-6)


def test_zero_capacity_factor_keeps_the_shared_path():
    """The reference's case: capacity factor 1e-9 (capacity 1, one slot
    an expert) gives finite outputs; and a token whose routed
    assignments were all dropped gets the shared expert's output
    alone (one chunk of tokens, so capacity counts all 16)."""
    _, tcfg, params, x = _setup("qwen2-moe-a2.7b", seed=5,
                                moe_capacity_factor=1e-9,
                                moe_token_chunks=1)
    p, xt = _torch_tree(params), torch.from_numpy(x)
    y, _ = moe.moe_ffn(p, tcfg, xt)
    assert bool(torch.isfinite(y).all())
    x2d = xt.reshape(-1, tcfg.d_model)
    _, ids, _ = moe._route(p["router"], x2d, tcfg.moe_n_experts,
                           tcfg.moe_top_k)
    _, keep = moe._dispatch_indices(ids, tcfg.moe_n_experts, 1)
    dropped = ~keep.any(dim=1)
    assert bool(dropped.any())
    from repro_torch.models import mlp
    shared = mlp.swiglu(p["shared"], x2d) * torch.sigmoid(
        nn.dense(p["shared_gate"], x2d))
    _close(y.reshape(-1, tcfg.d_model)[dropped], shared[dropped], rtol=0,
           atol=1e-6)


def test_decode_capacity_drops_tokens_as_the_reference():
    """At decode T = B: qwen2-moe's full capacity int(1.25 x 4 x 4 / 60)
    + 1 = 1 at B = 4, and the smoke's int(1.25 x 4 x 2 / 8) + 1 = 2; a
    token colliding past it is dropped, as in the reference, so the
    output differs from the no-drop one where the reference's does."""
    cfg = SMOKES["qwen2-moe-a2.7b"]
    big = ARCHS["qwen2-moe-a2.7b"]
    assert int(big.moe_capacity_factor * 4 * big.moe_top_k
               / big.moe_n_experts) + 1 == 1
    jcfg, tcfg, params, _ = _setup("qwen2-moe-a2.7b", seed=7)
    x = np.random.default_rng(7).normal(size=(16, 1, cfg.d_model)) \
        .astype(np.float32)
    (jy, _), (ty, _) = _both(lambda p, x_: jmoe.moe_ffn(p, jcfg, x_),
                             lambda p, x_: moe.moe_ffn(p, tcfg, x_),
                             params, x)
    _close(ty, jy)
    x2d = torch.from_numpy(x).reshape(16, -1)
    _, ids, _ = moe._route(_torch_tree(params)["router"], x2d,
                           tcfg.moe_n_experts, tcfg.moe_top_k)
    cap = int(tcfg.moe_capacity_factor * 16 * tcfg.moe_top_k
              / tcfg.moe_n_experts) + 1
    _, keep = moe._dispatch_indices(ids, tcfg.moe_n_experts, cap)
    assert not bool(keep.all())
    y8, _ = moe.moe_ffn(_torch_tree(params),
                        tcfg.replace(moe_capacity_factor=8.0),
                        torch.from_numpy(x))
    assert float((y8 - ty).abs().max()) > 1e-3


# ---------------------------------------------------------------------------
# The MoE decoder block and model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", MOE)
def test_moe_decoder_block_matches_reference(arch):
    jcfg, tcfg = JSMOKES[arch], SMOKES[arch]
    params = jbuild(jcfg).init(jax.random.key(4))
    layer = jax.tree.map(lambda a: np.asarray(a[1]), params["layers"])
    x = np.random.default_rng(5).normal(
        size=(2, 32, jcfg.d_model)).astype(np.float32)
    want, aux, (wk, wv) = jblocks.decoder_block(
        jax.tree.map(jnp.asarray, layer), jcfg, jnp.asarray(x),
        j_positions(2, 32), q_chunk=jcfg.attn_q_chunk)
    got, gaux, (gk, gv) = blocks.decoder_block(
        _torch_tree(layer), tcfg, torch.from_numpy(x),
        tmodel._positions(2, 32), q_chunk=tcfg.attn_q_chunk)
    _close(got, want)
    _close(gk, wk)
    _close(gv, wv)
    np.testing.assert_allclose(float(gaux), float(aux), rtol=1e-6)
    assert float(gaux) > 0


@pytest.mark.parametrize("arch", MOE)
def test_moe_model_decodes_with_drops_as_the_reference(arch):
    """The whole model at the config's capacity factor (drops at decode),
    prefill and four decode steps at B = 4, logits and caches."""
    jm = jbuild(JSMOKES[arch])
    params = jm.init(jax.random.key(0))
    tm = compat.lm_params_from_reference(
        SMOKES[arch], jax.tree.map(np.asarray, params), device="cpu")
    rng = np.random.default_rng(6)
    toks = rng.integers(0, jm.cfg.vocab, size=(4, 8)).astype(np.int32)
    want, wc = jm.prefill(params, {"tokens": jnp.asarray(toks)}, max_len=12)
    got, gc = tm.prefill({"tokens": torch.from_numpy(toks)}, max_len=12)
    _close(got, want)
    for t in range(8, 12):
        tok = rng.integers(0, jm.cfg.vocab, size=(4, 1)).astype(np.int32)
        want, wc = jm.decode_step(params, jnp.asarray(tok), wc,
                                  jnp.asarray(t, jnp.int32))
        got, gc = tm.decode_step(torch.from_numpy(tok), gc, t)
        _close(got, want)
    for k in ("k", "v"):
        _close(gc[k], wc[k])


def test_expert_leaves_take_the_stacked_fan_in():
    """An expert leaf (L, E, d, f) is drawn at scale / sqrt(L E d), the
    reference's fan-in of its stacked leaf; the router (L, d, E) at
    1 / sqrt(L d). Widened smoke so each leaf has >= 16k entries."""
    over = dict(d_model=128, moe_d_ff=128, moe_n_experts=8)
    cfg, jcfg = SMOKES["grok-1-314b"].replace(**over), \
        JSMOKES["grok-1-314b"].replace(**over)
    m = tmodel.build_model(cfg, device="cpu",
                           generator=torch.Generator().manual_seed(2))
    ref = jbuild(jcfg).init(jax.random.key(2))
    L, e, d, f = cfg.n_layers, 8, 128, 128
    laws = {"w_gate": 1 / math.sqrt(L * e * d),
            "w_up": 1 / math.sqrt(L * e * d),
            "w_down": (1 / math.sqrt(L)) / math.sqrt(L * e * f)}
    for name, want in laws.items():
        got = torch.stack([layer["ffn"][name] for layer in m.layers]).double()
        assert abs(float(got.std()) / want - 1) < 0.05, name
        ref_std = float(np.asarray(ref["layers"]["ffn"][name]).std())
        assert abs(ref_std / want - 1) < 0.05, name
        assert abs(float(got.mean())) < 5 * want / math.sqrt(got.numel())
    router = torch.stack([layer["ffn"]["router"]["w"]
                          for layer in m.layers]).double()
    assert abs(float(router.std()) * math.sqrt(L * d) - 1) < 0.05
