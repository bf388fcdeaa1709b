"""The port's LM configs and decoder models (`repro_torch.configs`,
`repro_torch.models`) against the reference on the CPU: the configs field
for field, every family's spec trees leaf for leaf, each module of the
decoder (dense, MoE and VLM) and the whole model on the reference's own
weights (carried across by
`compat.lm_params_from_reference`), the precision cases, and the port's
own identities (decode == teacher-forced, q-chunk invariance, the init
laws' statistics)."""

import dataclasses
import math
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

# Plans follow the planner's rules, never a winner persisted in the
# host's default autotune cache (the reference's conftest turns its
# own off); tests of the cache point it at files of their own.
os.environ.setdefault("REPRO_TORCH_AUTOTUNE_CACHE", "off")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import base as jbase  # noqa: E402
from repro.configs.registry import ARCHS as JARCHS  # noqa: E402
from repro.configs.registry import SMOKES as JSMOKES  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import blocks as jblocks  # noqa: E402
from repro.models import mlp as jmlp  # noqa: E402
from repro.models import nn as jnn  # noqa: E402
from repro.models import rope as jrope  # noqa: E402
from repro.models.model import _positions as j_positions  # noqa: E402
from repro.models.model import build_model as jbuild  # noqa: E402
from repro_torch import compat  # noqa: E402
from repro_torch.configs import base  # noqa: E402
from repro_torch.configs.registry import (ARCHS, SMOKES,  # noqa: E402
                                          list_archs)
from repro_torch.models import attention, blocks, mlp, nn, rope  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402

DENSE = ["internlm2-1.8b", "qwen1.5-110b", "command-r-35b", "glm4-9b"]
# every family `DecoderLM` builds: dense, MoE and VLM
DECODER = DENSE + ["grok-1-314b", "qwen2-moe-a2.7b", "internvl2-76b"]
# the reference's decode test lifts MoE capacity so no token is dropped
NO_DROP = {"moe_capacity_factor": 8.0}
# f32 parity of a module or the model with the reference: the two
# frameworks sum in different orders (~1e-6 on unit-scale values)
RTOL = ATOL = 1e-5
B, T = 2, 12
TOL = 2e-4      # the reference's decode == teacher-forced bar


def _np(x):
    return np.asarray(x, dtype=np.float32)


def _torch_tree(tree):
    if isinstance(tree, dict):
        return {k: _torch_tree(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree, dtype=np.float32))


def _jittered(tree, rng):
    """The reference's init tree as numpy, every 1-D leaf (biases at 0,
    norm scales at 1) moved off its constant so that it is tested."""
    if isinstance(tree, dict):
        return {k: _jittered(v, rng) for k, v in tree.items()}
    a = np.array(tree, dtype=np.float32)
    if a.ndim == 1:
        a = a + rng.normal(0.0, 0.3, a.shape).astype(np.float32)
    return a


def _layer0(arch, seed=0):
    """(reference cfg, port cfg, jittered layer-0 params as numpy)."""
    jcfg, tcfg = JSMOKES[arch], SMOKES[arch]
    params = jbuild(jcfg).init(jax.random.key(seed))
    layer = jax.tree.map(lambda a: a[0], params["layers"])
    return jcfg, tcfg, _jittered(layer, np.random.default_rng(seed))


def _ref_and_port(arch, seed=0, **over):
    """(reference model, its params, the port's model on its weights)."""
    jcfg = JSMOKES[arch].replace(**over) if over else JSMOKES[arch]
    tcfg = SMOKES[arch].replace(**over) if over else SMOKES[arch]
    jm = jbuild(jcfg)
    params = jm.init(jax.random.key(seed))
    tm = compat.lm_params_from_reference(
        tcfg, jax.tree.map(np.asarray, params), device="cpu")
    return jm, params, tm


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(_np(got), _np(want), rtol=rtol, atol=atol)


# ---------------------------------------------------------------------------
# Configs and specs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", list_archs())
def test_arch_config_equals_reference(arch):
    for port, ref in ((ARCHS[arch], JARCHS[arch]),
                      (SMOKES[arch], JSMOKES[arch])):
        assert [f.name for f in dataclasses.fields(port)] == \
            [f.name for f in dataclasses.fields(ref)]
        assert dataclasses.asdict(port) == dataclasses.asdict(ref)
        assert str(port.torch_dtype).removeprefix("torch.") == \
            jnp.dtype(ref.jnp_dtype).name
        assert str(port.torch_kv_dtype).removeprefix("torch.") == \
            jnp.dtype(ref.jnp_kv_dtype).name
        for name, shape in base.SHAPES.items():
            assert dataclasses.asdict(shape) == \
                dataclasses.asdict(jbase.SHAPES[name])
            assert base.shape_applicable(port, shape) == \
                jbase.shape_applicable(ref, jbase.SHAPES[name])
    assert list(ARCHS) == list(JARCHS) and list(SMOKES) == list(JSMOKES)


def _ref_leaves(spec_tree):
    leaves = jax.tree_util.tree_leaves_with_path(spec_tree,
                                                 is_leaf=jnn.is_spec)
    return {"/".join(k.key for k in path): s for path, s in leaves}


@pytest.mark.parametrize("arch", list_archs())
def test_param_specs_equal_reference(arch):
    """Full configs: every family's spec tree equals the reference's leaf
    for leaf, so the parameter counts (from specs, no allocation) are
    equal, and `build_model` picks the reference's class for it."""
    cfg, jcfg = ARCHS[arch], JARCHS[arch]
    jm = jbuild(jcfg)
    jspecs = jm.param_specs()
    assert tmodel.FAMILIES[cfg.family].__name__ == type(jm).__name__
    ref = _ref_leaves(jspecs)
    port = dict(nn.spec_leaves(tmodel.param_specs(cfg)))
    assert sorted(port) == sorted(ref)
    for path, s in port.items():
        r = ref[path]
        assert (tuple(s.shape), tuple(s.axes), s.init, s.scale) == \
            (tuple(r.shape), tuple(r.axes), r.init, r.scale), path
        assert str(s.dtype).removeprefix("torch.") == jnp.dtype(r.dtype).name
    assert nn.count_params(tmodel.param_specs(cfg)) == sum(
        math.prod(r.shape) for r in ref.values())


def test_internlm2_full_width_parameter_count():
    # 24 layers x 62,918,656 + embedding and unembedding 2 x 189,530,112
    # + the final norm's 2,048
    assert nn.count_params(tmodel.param_specs(ARCHS["internlm2-1.8b"])) \
        == 1_889_110_016


def test_init_laws_by_leaf_statistics():
    """The port's own draws follow the reference's laws, leaf by leaf,
    checked by statistics (never equality with JAX draws) against the
    same leaf of the reference's `model.init`: normal 0.02 * scale, fanin
    / fanin_deep at scale / sqrt(fan_in) with the fan-in of the
    reference's spec (a layer leaf's is that of its stacked (L, d_in,
    d_out) form, L * d_in), zeros, ones. The smoke is widened so that
    each drawn leaf has >= 16k entries and keeps L = 2 layers, where a
    per-layer fan-in would be sqrt(2) too wide: each std (the port's and
    the reference's layer slice) within 5% of the law's and of each
    other, the port's mean within 5 standard errors of 0."""
    over = dict(d_model=512, d_ff=512, vocab=1024)
    cfg, jcfg = (SMOKES["qwen1.5-110b"].replace(**over),
                 JSMOKES["qwen1.5-110b"].replace(**over))
    assert cfg.n_layers >= 2
    m = tmodel.DecoderLM(cfg, generator=torch.Generator().manual_seed(3),
                         device="cpu")
    jm = jbuild(jcfg)
    ref = jm.init(jax.random.key(3))
    ref_specs = _ref_leaves(jm.param_specs())
    specs = tmodel.param_specs(cfg)       # the reference's, layers stacked

    def leaf_of(tree, path):
        for k in path.split("/"):
            tree = tree[k]
        return tree

    trees = [(name, getattr(m, name), None)
             for name in ("embed", "unembed", "final_norm")]
    trees += [("layers", layer, l) for l, layer in enumerate(m.layers)]
    checked = 0
    for top, tree, l in trees:
        for path, spec in nn.spec_leaves(specs[top]):
            leaf = leaf_of(tree, path)
            rspec = ref_specs[f"{top}/{path}"]
            want_leaf = np.asarray(leaf_of(ref[top], path), np.float64)
            shape = tuple(spec.shape)
            if l is not None:
                shape, want_leaf = shape[1:], want_leaf[l]
            assert tuple(leaf.shape) == shape, path
            assert leaf.dtype == spec.dtype
            if spec.init == "zeros":
                assert bool((leaf == 0).all()), path
                continue
            if spec.init == "ones":
                assert bool((leaf == 1).all()), path
                continue
            if spec.init == "normal":
                want = 0.02 * rspec.scale
            else:
                want = rspec.scale / math.sqrt(math.prod(rspec.shape[:-1]))
            x = leaf.double()
            assert x.numel() >= 16_384, path
            got = float(x.std())
            assert abs(got / want - 1) < 0.05, (top, l, path, got, want)
            assert abs(want_leaf.std() / want - 1) < 0.05, (top, l, path)
            assert abs(got / want_leaf.std() - 1) < 0.05, (top, l, path)
            assert abs(float(x.mean())) < 5 * want / math.sqrt(x.numel())
            checked += 1
    assert checked == 2 + 7 * cfg.n_layers   # embed, unembed, 7 a layer


def test_init_is_seeded():
    cfg = SMOKES["internlm2-1.8b"]

    def draw(seed):
        m = tmodel.DecoderLM(cfg, device="cpu",
                             generator=torch.Generator().manual_seed(seed))
        return [p.clone() for p in m.parameters()]

    a, b, c = draw(5), draw(5), draw(6)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], c[0])


# ---------------------------------------------------------------------------
# Modules against the reference (f32)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fraction,theta", [(1.0, 1e6), (0.5, 1e4),
                                            (0.3, 8e6), (0.0, 1e4)])
def test_apply_rope_matches_reference(fraction, theta):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 9, 4, 16)).astype(np.float32)
    pos = rng.integers(0, 4000, size=(2, 9)).astype(np.int32)
    want = jrope.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta=theta,
                            fraction=fraction)
    got = rope.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                          theta=theta, fraction=fraction)
    _close(got, want)


@pytest.mark.parametrize("norm", ["rmsnorm", "layernorm"])
def test_norms_match_reference(norm):
    rng = np.random.default_rng(1)
    x = (3.0 * rng.normal(size=(2, 7, 64)) + 0.5).astype(np.float32)
    params = {"scale": rng.normal(size=64).astype(np.float32),
              "bias": rng.normal(size=64).astype(np.float32)}
    if norm == "rmsnorm":
        params.pop("bias")
    want = getattr(jnn, norm)(jax.tree.map(jnp.asarray, params),
                              jnp.asarray(x), eps=1e-5)
    got = getattr(nn, norm)(_torch_tree(params), torch.from_numpy(x),
                            eps=1e-5)
    _close(got, want)


@pytest.mark.parametrize("kind", ["swiglu", "gelu_mlp"])
def test_mlps_match_reference(kind):
    rng = np.random.default_rng(2)
    spec = (jmlp.swiglu_spec(64, 96, 2, jnp.float32) if kind == "swiglu"
            else jmlp.gelu_mlp_spec(64, 96, 2, jnp.float32))
    params = _jittered(jnn.init_params(jax.random.key(2), spec), rng)
    x = rng.normal(size=(2, 5, 64)).astype(np.float32)
    want = getattr(jmlp, kind)(jax.tree.map(jnp.asarray, params),
                               jnp.asarray(x))
    got = getattr(mlp, kind)(_torch_tree(params), torch.from_numpy(x))
    _close(got, want)


@pytest.mark.parametrize("arch", DECODER)
@pytest.mark.parametrize("s,q_chunk", [(32, 16), (32, 1024), (24, 16)])
def test_full_attention_matches_reference(arch, s, q_chunk):
    """q_chunk 16 over 32 tokens runs two chunks; 1,024 the whole
    sequence; 24 tokens do not divide by 16 and take the whole sequence,
    as the reference's irregular-length fallback."""
    jcfg, tcfg, layer = _layer0(arch)
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, s, jcfg.d_model)).astype(np.float32)
    want, (wk, wv) = jattn.full_attention(
        jax.tree.map(jnp.asarray, layer["attn"]), jcfg, jnp.asarray(x),
        j_positions(2, s), q_chunk=q_chunk)
    got, (gk, gv) = attention.full_attention(
        _torch_tree(layer["attn"]), tcfg, torch.from_numpy(x),
        tmodel._positions(2, s), q_chunk=q_chunk)
    _close(got, want)
    _close(gk, wk)
    _close(gv, wv)


@pytest.mark.parametrize("arch", DECODER)
def test_decode_attention_matches_reference(arch):
    """Both decode forms at cache_len 5 of a 12-long cache filled with
    random k/v (entries past cache_len must be masked, whatever they
    hold): the outputs, the readonly form's new k/v and the written
    cache."""
    jcfg, tcfg, layer = _layer0(arch)
    rng = np.random.default_rng(4)
    flat = jcfg.n_kv_heads * jcfg.d_head
    x = rng.normal(size=(2, 1, jcfg.d_model)).astype(np.float32)
    cache = {k: rng.normal(size=(2, 12, flat)).astype(np.float32)
             for k in ("k", "v")}
    jp, tp = jax.tree.map(jnp.asarray, layer["attn"]), \
        _torch_tree(layer["attn"])

    want, wk, wv = jattn.decode_attention_readonly(
        jp, jcfg, jnp.asarray(x), jax.tree.map(jnp.asarray, cache), 5)
    got, gk, gv = attention.decode_attention_readonly(
        tp, tcfg, torch.from_numpy(x), _torch_tree(cache), 5)
    _close(got, want)
    _close(gk, wk)
    _close(gv, wv)

    want, wcache = jattn.decode_attention(
        jp, jcfg, jnp.asarray(x), jax.tree.map(jnp.asarray, cache), 5)
    got, gcache = attention.decode_attention(
        tp, tcfg, torch.from_numpy(x), _torch_tree(cache), 5)
    _close(got, want)
    for k in ("k", "v"):
        _close(gcache[k], wcache[k])


@pytest.mark.parametrize("arch", DECODER)
def test_decoder_block_matches_reference(arch):
    jcfg, tcfg, layer = _layer0(arch)
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 32, jcfg.d_model)).astype(np.float32)
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
    assert (float(gaux) > 0) == (jcfg.family == "moe")


@pytest.mark.parametrize("arch", DECODER)
def test_prefill_and_decode_step_match_reference(arch):
    """The whole model on the reference's weights: prefill's last logits
    and caches (padded to max_len), then three decode steps' logits and
    caches."""
    jm, params, tm = _ref_and_port(arch)
    rng = np.random.default_rng(6)
    toks = rng.integers(0, jm.cfg.vocab, size=(B, T)).astype(np.int32)
    want, wc = jm.prefill(params, {"tokens": jnp.asarray(toks)},
                          max_len=T + 4)
    got, gc = tm.prefill({"tokens": torch.from_numpy(toks)}, max_len=T + 4)
    _close(got, want)
    for k in ("k", "v"):
        assert tuple(gc[k].shape) == tuple(wc[k].shape)
        _close(gc[k], wc[k])
    step = jax.jit(jm.decode_step)
    for t in range(T, T + 3):
        tok = rng.integers(0, jm.cfg.vocab, size=(B, 1)).astype(np.int32)
        want, wc = step(params, jnp.asarray(tok), wc,
                        jnp.asarray(t, jnp.int32))
        got, gc = tm.decode_step(torch.from_numpy(tok), gc, t)
        assert got.dtype == torch.float32 and tuple(got.shape) == \
            (B, 1, jm.cfg.vocab)
        _close(got, want)
        for k in ("k", "v"):
            _close(gc[k], wc[k])


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "command-r-35b"])
def test_cache_writing_stack_and_seed_cache_match_reference(arch):
    """The cache-writing decode stack (decoder_block_decode a layer) and
    seed_cache against the reference's, and in the port the writing
    stack == the readonly stack + one column write (the serving path)."""
    jm, params, tm = _ref_and_port(arch)
    cfg = tm.cfg
    rng = np.random.default_rng(9)
    flat = cfg.n_kv_heads * cfg.d_head
    k, v = (rng.normal(size=(B, 5, cfg.n_kv_heads, cfg.d_head))
            .astype(np.float32) for _ in range(2))
    zeros = np.zeros((B, 8, flat), np.float32)
    want = jattn.seed_cache({n: jnp.asarray(zeros) for n in "kv"},
                            jnp.asarray(k), jnp.asarray(v), start=2)
    got = attention.seed_cache({n: torch.zeros(zeros.shape) for n in "kv"},
                               torch.from_numpy(k), torch.from_numpy(v),
                               start=2)
    for n in "kv":
        np.testing.assert_array_equal(got[n].numpy(), _np(want[n]))

    caches = {n: rng.normal(size=(cfg.n_layers, B, 8, flat))
              .astype(np.float32) for n in "kv"}
    x = rng.normal(size=(B, 1, cfg.d_model)).astype(np.float32)
    wx, wc = jblocks.stack_decode(params["layers"], jm.cfg, jnp.asarray(x),
                                  jax.tree.map(jnp.asarray, caches), 4)
    gx, gc = blocks.stack_decode(tm.layers, cfg, torch.from_numpy(x),
                                 _torch_tree(caches), 4)
    _close(gx, wx)
    for n in "kv":
        _close(gc[n], wc[n])
    rc = _torch_tree(caches)
    rx, k_news, v_news = blocks.stack_decode_readonly(
        tm.layers, cfg, torch.from_numpy(x), rc, 4)
    blocks.write_cache_column(rc, k_news, v_news, 4)
    _close(rx, gx, rtol=0, atol=1e-6)
    for n in "kv":
        _close(rc[n], gc[n], rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# Precision cases
# ---------------------------------------------------------------------------

# bf16 weights and activations: torch rounds each op's output to bf16,
# where XLA may keep a fused elementwise chain (RoPE, the norms, SiLU x
# up) in f32 and round once, so about a third of the bf16 cache entries
# differ by an ulp; on the unit-scale f32 logits (|x| <= ~3.2, bf16 ulp
# 1.6e-2) that is 2-3e-2 at the smoke size. The bar is 5e-2 absolute
# (about 3 ulps), and the tokens agree wherever the top-two gap exceeds
# twice it.
BF16_ATOL = 5e-2


def test_bf16_model_matches_reference():
    jm, params, tm = _ref_and_port("internlm2-1.8b", dtype="bfloat16")
    assert next(tm.parameters()).dtype == torch.bfloat16
    assert tm.init_caches(B, 4)["k"].dtype == torch.bfloat16
    rng = np.random.default_rng(7)
    toks = rng.integers(0, jm.cfg.vocab, size=(B, T)).astype(np.int32)
    want, wc = jm.prefill(params, {"tokens": jnp.asarray(toks)},
                          max_len=T + 2)
    got, gc = tm.prefill({"tokens": torch.from_numpy(toks)}, max_len=T + 2)
    _close(got, want, rtol=0, atol=BF16_ATOL)
    for t in range(T, T + 2):
        tok = toks[:, t - T:t - T + 1]
        want, wc = jm.decode_step(params, jnp.asarray(tok), wc,
                                  jnp.asarray(t, jnp.int32))
        got, gc = tm.decode_step(torch.from_numpy(tok), gc, t)
        _close(got, want, rtol=0, atol=BF16_ATOL)
        w = np.sort(_np(want)[:, 0], axis=-1)
        clear = (w[:, -1] - w[:, -2]) > 2 * BF16_ATOL
        np.testing.assert_array_equal(_np(got)[:, 0].argmax(-1)[clear],
                                      _np(want)[:, 0].argmax(-1)[clear])


def test_fp8_kv_cache_matches_reference():
    """kv_cache_dtype float8_e4m3fn: every cache write rounds as the
    reference's cast (to nearest even); the caches agree entry for entry
    wherever the two f32 k/v round to the same fp8 value (a value within
    1e-5 of a rounding midpoint may round the other way: at most a few
    entries), and the logits at the f32 bar plus what such an entry
    moves."""
    jm, params, tm = _ref_and_port("internlm2-1.8b",
                                   kv_cache_dtype="float8_e4m3fn")
    assert tm.init_caches(B, 4)["k"].dtype == torch.float8_e4m3fn
    rng = np.random.default_rng(8)
    toks = rng.integers(0, jm.cfg.vocab, size=(B, T)).astype(np.int32)
    want, wc = jm.prefill(params, {"tokens": jnp.asarray(toks)},
                          max_len=T + 3)
    got, gc = tm.prefill({"tokens": torch.from_numpy(toks)}, max_len=T + 3)
    _close(got, want)
    for t in range(T, T + 3):
        tok = toks[:, t - T:t - T + 1]
        want, wc = jm.decode_step(params, jnp.asarray(tok), wc,
                                  jnp.asarray(t, jnp.int32))
        got, gc = tm.decode_step(torch.from_numpy(tok), gc, t)
        _close(got, want, rtol=1e-4, atol=1e-4)
    for k in ("k", "v"):
        g, w = gc[k].float().numpy(), _np(wc[k])
        assert g.shape == w.shape
        assert np.mean(g != w) < 1e-3, k


def test_fp8_cache_write_gives_nan_where_the_reference_does():
    """A k/v past fp8's range: NaN (with its sign) above 464 as the
    reference's cast, 448 between 448 and 464, never saturated."""
    vals = np.array([1.0, -3.3, 447.0, 460.0, -463.0, 470.0, -600.0, 1e6],
                    np.float32)
    l_, b_, s_ = 2, 1, 4
    new = np.broadcast_to(vals, (l_, b_, 1, vals.size)).copy()
    zeros = np.zeros((l_, b_, s_, vals.size), np.float32)
    wc = jblocks.write_cache_column(
        {k: jnp.asarray(zeros).astype(jnp.float8_e4m3fn) for k in "kv"},
        jnp.asarray(new), jnp.asarray(new), 2)
    gc = blocks.write_cache_column(
        {k: torch.zeros(zeros.shape, dtype=torch.float8_e4m3fn)
         for k in "kv"}, torch.from_numpy(new), torch.from_numpy(new), 2)
    for k in "kv":
        g, w = gc[k].float().numpy(), _np(wc[k])
        np.testing.assert_array_equal(g, w)      # NaN where NaN
        assert np.isnan(g[0, 0, 2, 5:]).all()
        np.testing.assert_array_equal(g[0, 0, 2, 2:5], [448, 448, -448])


def test_cache_write_past_the_end_clamps_like_the_reference():
    new = np.ones((2, 1, 1, 3), np.float32)
    zeros = np.zeros((2, 1, 4, 3), np.float32)
    for t in (3, 4, 9):
        wc = jblocks.write_cache_column(
            {k: jnp.asarray(zeros) for k in "kv"}, jnp.asarray(new * t),
            jnp.asarray(new * t), t)
        gc = blocks.write_cache_column(
            {k: torch.from_numpy(zeros.copy()) for k in "kv"},
            torch.from_numpy(new * t), torch.from_numpy(new * t), t)
        np.testing.assert_array_equal(gc["k"].numpy(), _np(wc["k"]))


# ---------------------------------------------------------------------------
# The port's own identities
# ---------------------------------------------------------------------------

def _teacher_forced_logits(m, toks):
    h, _ = m._embed_input({"tokens": toks})
    h, _, _ = m._backbone(h, tmodel._positions(*toks.shape))
    return (h @ m.unembed["w"]).float()


@pytest.mark.parametrize("arch", DECODER)
def test_decode_matches_teacher_forced(arch):
    """The reference's identity (tests/test_decode_parity.py), on the
    port's own weights: the decode loop with caches reproduces the
    teacher-forced logits at every position (MoE at capacity factor 8,
    as there)."""
    cfg = SMOKES[arch].replace(**(NO_DROP if SMOKES[arch].family == "moe"
                                  else {}))
    m = tmodel.build_model(cfg, device="cpu",
                           generator=torch.Generator().manual_seed(0))
    rng = np.random.default_rng(1)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, size=(B, T))
                            .astype(np.int32))
    with torch.inference_mode():
        ref = _teacher_forced_logits(m, toks)
    caches = m.init_caches(batch=B, max_len=T + 4)
    for t in range(T):
        logits, caches = m.decode_step(toks[:, t:t + 1], caches, t)
        err = float((logits[:, 0] - ref[:, t]).abs().max())
        assert err < TOL, f"{arch} step {t}: err={err}"


def test_prefill_matches_decode_loop():
    """prefill() + its caches == the decode loop from scratch."""
    cfg = SMOKES["internlm2-1.8b"]
    m = tmodel.build_model(cfg, device="cpu")
    rng = np.random.default_rng(3)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, size=(B, T))
                            .astype(np.int32))
    logits_p, caches_p = m.prefill({"tokens": toks}, max_len=T + 4)
    caches = m.init_caches(batch=B, max_len=T + 4)
    for t in range(T):
        logits_d, caches = m.decode_step(toks[:, t:t + 1], caches, t)
    _close(logits_p, logits_d, rtol=0, atol=TOL)
    for k in ("k", "v"):
        _close(caches_p[k][:, :, :T], caches[k][:, :, :T], rtol=0, atol=TOL)


@pytest.mark.parametrize("arch", DECODER)
def test_full_attention_is_q_chunk_invariant(arch):
    """Each query row attends to the same keys whatever chunk holds it:
    chunks of 4, 8, 16 and the whole sequence agree within 1e-6."""
    tcfg = SMOKES[arch]
    params = nn.init_params(attention.attention_spec(tcfg, torch.float32),
                            torch.Generator().manual_seed(4), "cpu")
    x = torch.from_numpy(np.random.default_rng(4).normal(
        size=(2, 32, tcfg.d_model)).astype(np.float32))
    pos = tmodel._positions(2, 32)
    whole, _ = attention.full_attention(params, tcfg, x, pos, q_chunk=32)
    for q_chunk in (4, 8, 16):
        got, _ = attention.full_attention(params, tcfg, x, pos,
                                          q_chunk=q_chunk)
        _close(got, whole, rtol=0, atol=1e-6)
