"""The port's other LM families (MoE, VLM, hybrid zamba2, xLSTM, whisper
enc-dec) against the reference on the CPU at the smoke configs: the
models built by `build_model` with the reference's spec trees, the
weights carried across by `compat`, prefill + decode_step, the loss (ce
and aux) with every gradient leaf, the cross attention and the whisper
blocks, the init laws of the nested stacks by statistics, decode ==
teacher-forced for every family, and the entry points (`ServeLoop` over
recurrent states, `launch.serve lm --arch`, `launch.train --arch`)."""

import math
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

os.environ.setdefault("REPRO_TORCH_AUTOTUNE_CACHE", "off")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import obs as jobs  # noqa: E402
from repro.configs.registry import SMOKES as JSMOKES  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import blocks as jblocks  # noqa: E402
from repro.models import nn as jnn  # noqa: E402
from repro.models.model import _positions as j_positions  # noqa: E402
from repro.models.model import build_model as jbuild  # noqa: E402
from repro.serve import engine as jengine  # noqa: E402
from repro_torch import compat, obs  # noqa: E402
from repro_torch.configs.registry import SMOKES, list_archs  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import attention, blocks, nn  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.optim.optimizers import stack_layers  # noqa: E402
from repro_torch.serve import engine  # noqa: E402
from repro_torch.train import step as tstep  # noqa: E402
from repro_torch.utils.tree import tree_leaves  # noqa: E402

FAMILIES = ["grok-1-314b", "qwen2-moe-a2.7b", "internvl2-76b",
            "zamba2-1.2b", "xlstm-350m", "whisper-base"]
DECODER_ONLY = [a for a in FAMILIES if a != "whisper-base"]
RECURRENT = ["zamba2-1.2b", "xlstm-350m"]
# the reference's decode test lifts MoE capacity so no token is dropped
NO_DROP = {"moe_capacity_factor": 8.0}
# f32 parity of the model with the reference on its weights: the two
# frameworks sum in different orders (~1e-6 at unit scale, ~1e-5 after
# the recurrences)
RTOL = ATOL = 2e-5
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-5      # of the leaf's largest |entry|
# ... or of this share of the model's largest gradient entry, where a
# leaf's own gradient is rounding noise: whisper's key biases (softmax
# ignores a shift shared by a query's scores, so the true gradient is 0)
# and sLSTM's b_i at init (~4e-9 where the largest entry is ~1)
GRAD_FLOOR = 1e-3
TOL = 2e-4           # the reference's decode == teacher-forced bar
B, T = 2, 12
N_VIS, N_FRAMES = 4, 16


def _np(x):
    return np.asarray(x, dtype=np.float32)


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(_np(got), _np(want), rtol=rtol, atol=atol)


def _over(arch):
    return NO_DROP if JSMOKES[arch].family == "moe" else {}


def _ref_and_port(arch, seed=0, **over):
    """(reference model, its params, the port's model on its weights)."""
    jcfg, tcfg = JSMOKES[arch].replace(**over), SMOKES[arch].replace(**over)
    jm = jbuild(jcfg)
    params = jm.init(jax.random.key(seed))
    tm = compat.lm_params_from_reference(
        tcfg, jax.tree.map(np.asarray, params), device="cpu")
    return jm, params, tm


def _batch(cfg, seed=0, b=B, t=T, targets=False):
    """A numpy batch of the family's inputs: tokens, a vision prefix for
    vlm, frames for enc-dec."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab, size=(b, t))
           .astype(np.int32)}
    if cfg.family == "vlm":
        out["vision_embeds"] = rng.normal(size=(b, N_VIS, cfg.d_model)) \
            .astype(np.float32)
    if cfg.family == "encdec":
        out["frames"] = rng.normal(size=(b, N_FRAMES, cfg.d_model)) \
            .astype(np.float32)
    if targets:
        out["targets"] = rng.integers(0, cfg.vocab, size=(b, t)) \
            .astype(np.int32)
    return out


def _j(batch):
    return jax.tree.map(jnp.asarray, batch)


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _ref_leaves(spec_tree):
    leaves = jax.tree_util.tree_leaves_with_path(spec_tree,
                                                 is_leaf=jnn.is_spec)
    return {"/".join(k.key for k in path): s for path, s in leaves}


def _stacked_np(tree):
    return jax.tree.map(lambda x: x.detach().float().numpy(),
                        stack_layers(tree))


# ---------------------------------------------------------------------------
# Building every family
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", list_archs())
def test_build_model_builds_every_smoke_with_the_reference_specs(arch):
    """Every SMOKES entry builds (no family raises), as the family's
    class, with the reference's spec tree leaf for leaf and every
    weight's shape and dtype from it."""
    cfg = SMOKES[arch]
    m = tmodel.build_model(cfg, device="cpu",
                           generator=torch.Generator().manual_seed(1))
    assert type(m) is tmodel.FAMILIES[cfg.family]
    assert type(m).__name__ == type(jbuild(JSMOKES[arch])).__name__
    ref = _ref_leaves(jbuild(JSMOKES[arch]).param_specs())
    port = dict(nn.spec_leaves(m.param_specs()))
    assert sorted(port) == sorted(ref)
    for path, s in port.items():
        r = ref[path]
        assert (tuple(s.shape), tuple(s.axes), s.init, s.scale) == \
            (tuple(r.shape), tuple(r.axes), r.init, r.scale), path
    stacked = stack_layers(m.param_tree())
    for path, s in port.items():
        leaf = stacked
        for k in path.split("/"):
            leaf = leaf[k]
        assert tuple(leaf.shape) == tuple(s.shape), path
        assert leaf.dtype == s.dtype, path
    assert sum(p.numel() for p in m.parameters()) == \
        nn.count_params(m.param_specs())


def test_a_class_refuses_another_family():
    with pytest.raises(ValueError, match="hybrid"):
        tmodel.DecoderLM(SMOKES["zamba2-1.2b"], device="cpu")


# ---------------------------------------------------------------------------
# The model on the reference's weights
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", FAMILIES)
def test_prefill_and_decode_steps_match_reference(arch):
    """prefill's last logits and every cache / state leaf, then three
    decode steps' logits and caches, at the config's own capacity factor
    (MoE drops at decode as the reference does)."""
    jm, params, tm = _ref_and_port(arch)
    batch = _batch(jm.cfg, seed=6)
    want, wc = jm.prefill(params, _j(batch), max_len=T + N_VIS + 4)
    got, gc = tm.prefill(_t(batch), max_len=T + N_VIS + 4)
    _close(got, want)
    assert [tuple(x.shape) for x in tree_leaves(gc)] == \
        [tuple(x.shape) for x in jax.tree.leaves(wc)]
    for g, w in zip(tree_leaves(gc), jax.tree.leaves(wc)):
        _close(g.float(), w, atol=1e-4)
    rng = np.random.default_rng(7)
    s0 = T + (N_VIS if jm.cfg.family == "vlm" else 0)
    step = jax.jit(jm.decode_step)
    for t in range(s0, s0 + 3):
        tok = rng.integers(0, jm.cfg.vocab, size=(B, 1)).astype(np.int32)
        want, wc = step(params, jnp.asarray(tok), wc,
                        jnp.asarray(t, jnp.int32))
        got, gc = tm.decode_step(torch.from_numpy(tok), gc, t)
        assert got.dtype == torch.float32 and tuple(got.shape) == \
            (B, 1, jm.cfg.vocab)
        _close(got, want)
    for g, w in zip(tree_leaves(gc), jax.tree.leaves(wc)):
        _close(g.float(), w, atol=1e-4)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("arch", FAMILIES)
def test_loss_and_every_gradient_leaf_match_reference(arch, masked):
    """The loss, its ce and aux (the MoE balance loss; the families
    without one report ce only, as the reference), and every gradient
    leaf within 1e-5 of the leaf's largest entry (of 1e-3 of the model's
    largest where the leaf's is smaller: GRAD_FLOOR)."""
    jm, params, tm = _ref_and_port(arch)
    batch = _batch(jm.cfg, seed=3, targets=True)
    if masked:
        batch["loss_mask"] = (np.random.default_rng(1).random(
            batch["targets"].shape) < 0.7).astype(np.float32)
    (jl, jmet), jg = jax.value_and_grad(jm.loss, has_aux=True)(
        params, _j(batch))
    tl, tmet, tg = tstep.value_and_grad(tm, tstep.to_device(batch, "cpu"))
    np.testing.assert_allclose(float(tl), float(jl), rtol=LOSS_RTOL)
    assert sorted(tmet) == sorted(jmet)
    for k in jmet:
        np.testing.assert_allclose(float(tmet[k]), float(jmet[k]),
                                   rtol=LOSS_RTOL)
    if jm.cfg.family == "moe":
        assert float(tmet["aux"]) > 0
    top = max(float(np.max(np.abs(_np(w)))) for w in jax.tree.leaves(jg))
    for (path, w), g in zip(jax.tree_util.tree_leaves_with_path(jg),
                            jax.tree.leaves(_stacked_np(tg))):
        w = _np(w)
        assert g.shape == w.shape, path
        err = float(np.max(np.abs(g - w)))
        scale = max(float(np.max(np.abs(w))), GRAD_FLOOR * top)
        assert err <= GRAD_TOL * scale, (jax.tree_util.keystr(path), err)


def test_vlm_prefix_enters_the_logits_and_leaves_the_loss():
    """internvl2: the vision prefix moves the text positions' logits, the
    loss counts text positions only, and a batch without the prefix runs
    as the dense model."""
    jm, params, tm = _ref_and_port("internvl2-76b")
    batch = _batch(tm.cfg, seed=2, targets=True)
    with_vis, _ = tm.prefill(_t(batch))
    text = {k: v for k, v in batch.items() if k != "vision_embeds"}
    without, _ = tm.prefill(_t(text))
    assert float((with_vis - without).abs().max()) > 1e-3
    want, _ = jm.prefill(params, _j(text))
    _close(without, want)
    with torch.no_grad():
        loss, met = tm.loss(_t(batch))
    assert float(met["aux"]) == 0.0 and loss.ndim == 0


# ---------------------------------------------------------------------------
# Cross attention and the whisper blocks
# ---------------------------------------------------------------------------

def _whisper_layer(seed=0):
    jcfg, tcfg = JSMOKES["whisper-base"], SMOKES["whisper-base"]
    params = jbuild(jcfg).init(jax.random.key(seed))
    rng = np.random.default_rng(seed)

    def jitter(a):
        a = np.array(a, np.float32)
        return a + (rng.normal(0, 0.3, a.shape).astype(np.float32)
                    if a.ndim == 1 else 0)
    dec = jax.tree.map(lambda a: jitter(a[0]), params["dec_layers"])
    enc = jax.tree.map(lambda a: jitter(a[0]), params["enc_layers"])
    return jcfg, tcfg, enc, dec


def _tt(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


def test_cross_attention_and_cross_kv_match_reference():
    jcfg, tcfg, _, dec = _whisper_layer(1)
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 5, jcfg.d_model)).astype(np.float32)
    enc = rng.normal(size=(2, 16, jcfg.d_model)).astype(np.float32)
    jp, tp = jax.tree.map(jnp.asarray, dec["cross"]), _tt(dec["cross"])
    want = jattn.cross_attention(jp, jcfg, jnp.asarray(x),
                                 enc_out=jnp.asarray(enc))
    got = attention.cross_attention(tp, tcfg, torch.from_numpy(x),
                                    enc_out=torch.from_numpy(enc))
    _close(got, want)
    wkv = jattn.cross_kv(jp, jcfg, jnp.asarray(enc))
    gkv = attention.cross_kv(tp, tcfg, torch.from_numpy(enc))
    for k in ("k", "v"):
        _close(gkv[k], wkv[k])
    # the precomputed form == computing k / v from enc_out
    got_flat = attention.cross_attention(tp, tcfg, torch.from_numpy(x),
                                         kv_flat=gkv)
    _close(got_flat, want)
    want_flat = jattn.cross_attention(jp, jcfg, jnp.asarray(x),
                                      kv_flat=wkv)
    _close(got_flat, want_flat)


def test_whisper_blocks_and_stacks_match_reference():
    jcfg, tcfg, enc_p, dec_p = _whisper_layer(2)
    rng = np.random.default_rng(2)
    frames = rng.normal(size=(2, 16, jcfg.d_model)).astype(np.float32)
    x = rng.normal(size=(2, 8, jcfg.d_model)).astype(np.float32)
    want = jblocks.encoder_block(jax.tree.map(jnp.asarray, enc_p), jcfg,
                                 jnp.asarray(frames), j_positions(2, 16),
                                 q_chunk=jcfg.attn_q_chunk)
    got = blocks.encoder_block(_tt(enc_p), tcfg, torch.from_numpy(frames),
                               tmodel._positions(2, 16),
                               q_chunk=tcfg.attn_q_chunk)
    _close(got, want)
    enc_out = np.asarray(want)
    want, (wk, wv) = jblocks.encdec_block(
        jax.tree.map(jnp.asarray, dec_p), jcfg, jnp.asarray(x),
        jnp.asarray(enc_out), j_positions(2, 8), q_chunk=jcfg.attn_q_chunk)
    got, (gk, gv) = blocks.encdec_block(
        _tt(dec_p), tcfg, torch.from_numpy(x), torch.from_numpy(enc_out),
        tmodel._positions(2, 8), q_chunk=tcfg.attn_q_chunk)
    _close(got, want)
    _close(gk, wk)
    _close(gv, wv)

    # stacks of two layers, the decode stack on a cache of random k/v
    stack_j = jax.tree.map(lambda a: jnp.stack([jnp.asarray(a)] * 2), dec_p)
    layers_t = [_tt(dec_p), _tt(dec_p)]
    want, (wk, _) = jblocks.encdec_stack(
        stack_j, jcfg, jnp.asarray(x), jnp.asarray(enc_out),
        j_positions(2, 8), q_chunk=jcfg.attn_q_chunk, collect_kv=True)
    got, (gk, _) = blocks.encdec_stack(
        layers_t, tcfg, torch.from_numpy(x), torch.from_numpy(enc_out),
        tmodel._positions(2, 8), q_chunk=tcfg.attn_q_chunk, collect_kv=True)
    _close(got, want)
    _close(gk, wk)
    flat = jcfg.n_kv_heads * jcfg.d_head
    cache = {k: rng.normal(size=(2, 2, 12, flat)).astype(np.float32)
             for k in ("k", "v")}
    cross = {k: rng.normal(size=(2, 2, 16, flat)).astype(np.float32)
             for k in ("k", "v")}
    tok = rng.normal(size=(2, 1, jcfg.d_model)).astype(np.float32)
    want, wc = jblocks.encdec_stack_decode(
        stack_j, jcfg, jnp.asarray(tok), jax.tree.map(jnp.asarray, cache),
        jax.tree.map(jnp.asarray, cross), 5)
    got, gc = blocks.encdec_stack_decode(
        layers_t, tcfg, torch.from_numpy(tok), _tt(cache), _tt(cross), 5)
    _close(got, want)
    for k in ("k", "v"):
        _close(gc[k], wc[k])


# ---------------------------------------------------------------------------
# Init laws of the nested stacks
# ---------------------------------------------------------------------------

def _law(spec):
    """The std the reference's law gives its (stacked) spec."""
    if spec.init == "normal":
        return 0.02 * spec.scale
    return spec.scale / math.sqrt(math.prod(spec.shape[:-1]))


@pytest.mark.parametrize("arch,over,must", [
    # xLSTM: mLSTM (n_seg, every-1, ...) = (2, 2, ...); sLSTM's r_* (2, H,
    # dh, dh) take n_seg H dh
    ("xlstm-350m", dict(d_model=128, n_layers=6, slstm_every=3, vocab=512),
     ("mlstm/cell/up/w", "mlstm/cell/wq/w", "slstm/cell/r_i",
      "slstm/cell/w_f/w", "unembed/w")),
    # zamba2: the shared block is not stacked (plain d_in), the mamba
    # layers are (L, ...)
    ("zamba2-1.2b", dict(d_model=128, d_ff=256, vocab=512),
     ("shared_attn/attn/wq/w", "shared_attn/ffn/w_down/w",
      "mamba/mixer/in_proj/w", "mamba/mixer/out_proj/w")),
    # MoE: expert leaves (L, E, d, f) take L E d
    ("qwen2-moe-a2.7b", dict(d_model=128, moe_d_ff=128, vocab=512),
     ("layers/ffn/w_gate", "layers/ffn/w_down", "layers/ffn/shared/w_up/w",
      "layers/attn/wq/w")),
])
def test_init_laws_of_the_nested_stacks(arch, over, must):
    """The port's own draws (never equal to JAX's) follow the reference's
    laws with the fan-in of the reference's stacked leaf, checked by
    statistics on every drawn leaf of >= 8,192 entries: each std (the
    port's, stacked as the reference's, and the reference's) within 6% of
    the law's, the port's mean within 5 standard errors of 0, zeros and
    ones exact. `must` names leaves whose stacked fan-in differs from a
    per-layer one by sqrt(2) or more."""
    cfg, jcfg = SMOKES[arch].replace(**over), JSMOKES[arch].replace(**over)
    m = tmodel.build_model(cfg, device="cpu",
                           generator=torch.Generator().manual_seed(3))
    ref = jbuild(jcfg).init(jax.random.key(3))
    ref_specs = _ref_leaves(jbuild(jcfg).param_specs())
    port = stack_layers(m.param_tree())
    checked = set()
    for path, spec in ref_specs.items():
        leaf, rleaf = port, ref
        for k in path.split("/"):
            leaf, rleaf = leaf[k], rleaf[k]
        x, rx = leaf.detach().double(), np.asarray(rleaf, np.float64)
        if spec.init == "zeros":
            assert bool((x == 0).all()), path
            continue
        if spec.init == "ones":
            assert bool((x == 1).all()), path
            continue
        if x.numel() < 8192:
            continue
        want = _law(spec)
        assert abs(float(x.std()) / want - 1) < 0.06, (path, float(x.std()),
                                                       want)
        assert abs(float(rx.std()) / want - 1) < 0.06, path
        assert abs(float(x.mean())) < 5 * want / math.sqrt(x.numel()), path
        checked.add(path)
    assert set(must) <= checked, set(must) - checked
    for path in must:
        spec = ref_specs[path]
        if spec.init != "normal":
            depth = tmodel.STACK_DEPTH.get(path.split("/")[0], 0)
            per_layer = spec.scale / math.sqrt(max(
                math.prod(spec.shape[depth:-1]), 1))
            assert depth == 0 or per_layer / _law(spec) >= math.sqrt(2) - 1e-9


# ---------------------------------------------------------------------------
# The port's own identities
# ---------------------------------------------------------------------------

def _teacher_forced_logits(m, batch):
    """Every position's f32 logits by the forward pass."""
    with torch.inference_mode():
        toks = batch["tokens"]
        fam = m.cfg.family
        if fam in ("dense", "moe", "vlm"):
            h, n_vis = m._embed_input(batch)
            h, _, _ = m._backbone(h, tmodel._positions(*h.shape[:2]))
            h = h[:, n_vis:]
        elif fam == "hybrid":
            h = m._forward(m._embed_tokens(toks),
                           tmodel._positions(*toks.shape))
        elif fam == "xlstm":
            h = m._forward(m._embed_tokens(toks))
        else:
            h, _ = m._decoder(toks, m.encode(batch["frames"]))
        return (h @ m.unembed["w"]).float()


@pytest.mark.parametrize("arch", FAMILIES)
def test_decode_matches_teacher_forced(arch):
    """The reference's identity (tests/test_decode_parity.py) on the
    port's own weights: a decode loop from init_caches reproduces the
    teacher-forced logits at every position (MoE at capacity factor 8;
    whisper's cross caches filled from its frames, as the reference's
    test fills them)."""
    cfg = SMOKES[arch].replace(**_over(arch))
    m = tmodel.build_model(cfg, device="cpu",
                           generator=torch.Generator().manual_seed(0))
    batch = _t(_batch(cfg, seed=1))
    batch.pop("vision_embeds", None)
    ref = _teacher_forced_logits(m, batch)
    toks = batch["tokens"]
    if cfg.family == "encdec":
        caches = m.init_caches(batch=B, max_len=T + 4, enc_len=N_FRAMES)
        with torch.inference_mode():
            enc_out = m.encode(batch["frames"])
            kvs = [attention.cross_kv(layer["cross"], cfg, enc_out)
                   for layer in m.dec_layers]
        caches["cross"] = {k: torch.stack([c[k] for c in kvs])
                           for k in ("k", "v")}
    else:
        caches = m.init_caches(batch=B, max_len=T + 4)
    for t in range(T):
        logits, caches = m.decode_step(toks[:, t:t + 1], caches, t)
        err = float((logits[:, 0] - ref[:, t]).abs().max())
        assert err < TOL, f"{arch} step {t}: err={err}"


@pytest.mark.parametrize("arch", ["zamba2-1.2b", "xlstm-350m",
                                  "whisper-base", "internvl2-76b"])
def test_prefill_then_decode_continues_the_teacher_forced_logits(arch):
    """prefill over the first T - 3 tokens, then three decode steps on its
    caches == the teacher-forced logits of the whole sequence (a vlm's
    prefix in front)."""
    cfg = SMOKES[arch]
    m = tmodel.build_model(cfg, device="cpu",
                           generator=torch.Generator().manual_seed(2))
    batch = _t(_batch(cfg, seed=4))
    ref = _teacher_forced_logits(m, batch)
    toks = batch["tokens"]
    head = dict(batch, tokens=toks[:, :T - 3])
    logits, caches = m.prefill(head, max_len=T + N_VIS + 2)
    _close(logits[:, 0], ref[:, T - 4], rtol=0, atol=TOL)
    n_vis = N_VIS if cfg.family == "vlm" else 0
    for t in range(T - 3, T):
        logits, caches = m.decode_step(toks[:, t:t + 1], caches, t + n_vis)
        _close(logits[:, 0], ref[:, t], rtol=0, atol=TOL)


def test_encdec_init_caches_default_enc_len():
    m = tmodel.build_model(SMOKES["whisper-base"], device="cpu")
    c = m.init_caches(batch=2, max_len=8)
    assert tuple(c["cross"]["k"].shape)[2] == min(m.cfg.max_enc_len, 1500)
    assert tuple(c["self"]["v"].shape) == (m.cfg.n_layers, 2, 8,
                                           m.cfg.n_kv_heads * m.cfg.d_head)


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------

def _ref_serve(jm, params, prompts, max_new, *, batch=2, max_len=32):
    """The reference's ServeLoop, every step's (token, logits) recorded."""
    loop = jengine.ServeLoop(jm, params, batch_size=batch, max_len=max_len)
    trace, inner = [], loop.step_fn

    def recording(*args):
        out = inner(*args)
        trace.append((np.asarray(out[0]), np.asarray(out[1])))
        return out

    loop.step_fn = recording
    reqs = [jengine.Request(prompt=p, max_new_tokens=k)
            for p, k in zip(prompts, max_new)]
    with jobs.session():
        done = loop.run(reqs, max_steps=200, key=jax.random.key(1))
    return done, trace


@pytest.mark.parametrize("arch", RECURRENT + ["qwen2-moe-a2.7b"])
def test_serve_loop_over_recurrent_states_replays_the_reference(arch):
    """ServeLoop over caches that are recurrent states (and an MoE model
    at its decode-time drops): out-of-phase requests, each step's logits
    held to the reference's and its token fed back, so the generated
    tokens equal. As the reference, admitting a request resets no state:
    a late-admitted request continues from its slot's previous
    occupant's state (and the shared cache_len)."""
    jm, params, tm = _ref_and_port(arch)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, jm.cfg.vocab, size=(3,)).astype(np.int32)
               for _ in range(5)]
    max_new = [2, 6, 3, 5, 4]
    done_j, trace = _ref_serve(jm, params, prompts, max_new)
    steps, errs = iter(trace), []

    def replay(logits, generator):
        nxt, want = next(steps)
        errs.append(float(np.abs(logits.numpy() - want).max()))
        return torch.from_numpy(nxt[:, 0].copy())

    loop = engine.ServeLoop(tm, batch_size=2, max_len=32, sampler=replay)
    reqs = [engine.Request(prompt=p, max_new_tokens=k)
            for p, k in zip(prompts, max_new)]
    with obs.session():
        done = loop.run(reqs, max_steps=200)
    assert len(errs) == len(trace) and max(errs) < 1e-4, max(errs)
    assert [r.generated for r in done] == [r.generated for r in done_j]
    assert all(r.done for r in done)


@pytest.mark.parametrize("arch", DECODER_ONLY)
def test_cli_lm_runs_every_decoder_family(arch, capsys):
    rc = launch_serve.main(["lm", "--arch", arch, "--smoke", "--requests",
                            "3", "--batch", "2", "--max-new", "3",
                            "--device", "cpu"])
    out = capsys.readouterr().out
    assert rc == 0
    assert f"arch={SMOKES[arch].name} requests=3 generated=9 tok" in out


def test_cli_lm_refuses_encdec_as_the_reference():
    with pytest.raises(SystemExit, match="decoder-only"):
        launch_serve.main(["lm", "--arch", "whisper-base", "--smoke",
                           "--device", "cpu"])


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "internvl2-76b",
                                  "zamba2-1.2b", "xlstm-350m"])
def test_train_launcher_runs_every_decoder_family(arch, tmp_path, capsys):
    rc = launch_train.main(["--arch", arch, "--smoke", "--steps", "3",
                            "--batch", "4", "--seq", "16", "--ckpt-dir",
                            str(tmp_path / "ckpt"), "--ckpt-every", "2",
                            "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert rc == 0
    assert out[0].startswith(f"[train] arch={SMOKES[arch].name} steps=3 ")
    first, last = (float(x.split("=")[1]) for x in out[1].split()[2:])
    assert np.isfinite([first, last]).all()
