"""The training half of the port's LM (`models.model.chunked_cross_entropy`,
`DecoderLM.loss`, `blocks.stack_forward`'s remat, `train.step`,
`compat.train_state_from_reference`) against the reference on the CPU.

The loss and every leaf of its gradient against `jax.grad` of the
reference on the reference's own weights; remat in none / full / dots
equal bit for bit (and each saving less than the last); 3 SGDM and 3
AdamW steps from the reference's train state against the reference's
jitted step; 4 microbatches against 1 and against the reference's 4; one
step of every other family (MoE, VLM, hybrid, xLSTM, enc-dec), with
AdamW and, on the nested stacks, Adafactor.
"""

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

from repro import optim as joptim  # noqa: E402
from repro.configs.registry import SMOKES as JSMOKES  # noqa: E402
from repro.data.tokens import SyntheticTokenDataset as JDataset  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.train import step as jstep  # noqa: E402
from repro_torch import compat, optim  # noqa: E402
from repro_torch.configs.registry import SMOKES  # noqa: E402
from repro_torch.models import blocks  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.optim.optimizers import stack_layers  # noqa: E402
from repro_torch.train import step as tstep  # noqa: E402
from repro_torch.utils.tree import tree_leaves  # noqa: E402

ARCHS = ["internlm2-1.8b", "glm4-9b"]
# f32: the two frameworks sum in different orders (~1e-6 relative on the
# loss; a gradient leaf within 1e-6 of its largest entry in practice)
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-5      # of the leaf's largest |entry|
PARAM_RTOL, PARAM_ATOL = 1e-5, 1e-6


def _ref_and_port(arch, seed=0, **over):
    jcfg = JSMOKES[arch].replace(**over) if over else JSMOKES[arch]
    tcfg = SMOKES[arch].replace(**over) if over else SMOKES[arch]
    jm = jmodel.build_model(jcfg)
    params = jm.init(jax.random.key(seed))
    tm = compat.lm_params_from_reference(
        tcfg, jax.tree.map(np.asarray, params), device="cpu")
    return jm, params, tm


def _batch(cfg, b=4, s=16, seed=3, index=0):
    return JDataset(vocab=cfg.vocab, seq_len=s, global_batch=b,
                    seed=seed).batch(index)


def _stacked_np(tree):
    return jax.tree.map(lambda x: x.detach().float().numpy(),
                        stack_layers(tree))


def _grads_close(got, want, tol=GRAD_TOL):
    for (path, w), g in zip(jax.tree_util.tree_leaves_with_path(want),
                            jax.tree.leaves(got)):
        w = np.asarray(w, np.float32)
        assert g.shape == w.shape, path
        scale = float(np.max(np.abs(w)))
        err = float(np.max(np.abs(g - w)))
        assert err <= tol * scale, (jax.tree_util.keystr(path), err, scale)


# ---------------------------------------------------------------------------
# The chunked cross entropy
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("s,chunk", [(16, 4), (16, 16), (12, 5), (9, 1024)])
@pytest.mark.parametrize("masked", [False, True])
def test_chunked_cross_entropy_matches_reference(s, chunk, masked):
    rng = np.random.default_rng(s * 7 + chunk)
    b, d, v = 3, 8, 37
    x = rng.normal(size=(b, s, d)).astype(np.float32)
    w = rng.normal(size=(d, v)).astype(np.float32)
    t = rng.integers(0, v, size=(b, s)).astype(np.int32)
    mask = ((rng.random((b, s)) < 0.6) if masked
            else np.ones((b, s))).astype(np.float32)
    want = jmodel.chunked_cross_entropy(jnp.asarray(x), jnp.asarray(t),
                                        jnp.asarray(mask), jnp.asarray(w),
                                        chunk=chunk)
    got = tmodel.chunked_cross_entropy(
        torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(mask),
        torch.from_numpy(w), chunk=chunk)
    assert got.dtype == torch.float32 and got.ndim == 0
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_chunked_cross_entropy_of_an_empty_mask_is_zero():
    x = torch.ones(2, 4, 3)
    w = torch.ones(3, 5)
    t = torch.zeros(2, 4, dtype=torch.int32)
    got = tmodel.chunked_cross_entropy(x, t, torch.zeros(2, 4), w, chunk=2)
    assert float(got) == 0.0


def test_chunked_cross_entropy_in_bf16_takes_logits_in_bf16():
    """The product is in the model's dtype, then float32: as the
    reference, bf16 logits round before the log-sum-exp."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 8, 16)).astype(np.float32)
    w = rng.normal(size=(16, 50)).astype(np.float32)
    t = rng.integers(0, 50, size=(2, 8)).astype(np.int32)
    m = np.ones((2, 8), np.float32)
    want = jmodel.chunked_cross_entropy(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(t), jnp.asarray(m),
        jnp.asarray(w, jnp.bfloat16), chunk=4)
    got = tmodel.chunked_cross_entropy(
        torch.from_numpy(x).bfloat16(), torch.from_numpy(t),
        torch.from_numpy(m), torch.from_numpy(w).bfloat16(), chunk=4)
    np.testing.assert_allclose(float(got), float(want), rtol=2e-3)


# ---------------------------------------------------------------------------
# The loss and its gradient
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_every_gradient_leaf_match_reference(arch, masked):
    jm, params, tm = _ref_and_port(arch)
    b = _batch(jm.cfg)
    if masked:
        b["loss_mask"] = (np.random.default_rng(1).random(
            b["targets"].shape) < 0.7).astype(np.float32)
    (jl, jmet), jg = jax.value_and_grad(jm.loss, has_aux=True)(
        params, jax.tree.map(jnp.asarray, b))
    tl, tmet, tg = tstep.value_and_grad(tm, tstep.to_device(b, "cpu"))
    np.testing.assert_allclose(float(tl), float(jl), rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(tmet["ce"]), float(jmet["ce"]),
                               rtol=LOSS_RTOL)
    assert float(tmet["aux"]) == float(jmet["aux"]) == 0.0
    _grads_close(_stacked_np(tg), jg)
    # the grads are the model's own leaves' grads: in the params' dtype
    assert all(g.dtype == p.dtype for g, p in
               zip(tree_leaves(tg), tree_leaves(tm.param_tree())))


def test_bf16_loss_and_gradient_match_reference():
    jm, params, tm = _ref_and_port("internlm2-1.8b", dtype="bfloat16")
    b = _batch(jm.cfg)
    (jl, _), jg = jax.value_and_grad(jm.loss, has_aux=True)(
        params, jax.tree.map(jnp.asarray, b))
    tl, _, tg = tstep.value_and_grad(tm, tstep.to_device(b, "cpu"))
    assert all(g.dtype == torch.bfloat16 for g in tree_leaves(tg))
    # bf16: XLA may round a fused chain once where torch rounds each op
    np.testing.assert_allclose(float(tl), float(jl), rtol=5e-3)
    _grads_close(_stacked_np(tg), jg, tol=5e-2)


def test_loss_runs_the_model_on_its_own_parameters():
    _, _, tm = _ref_and_port("internlm2-1.8b")
    assert all(p.requires_grad for p in tm.parameters())
    loss, _ = tm.loss(tstep.to_device(_batch(tm.cfg), "cpu"))
    loss.backward()
    assert all(p.grad is not None for p in tm.parameters())


def test_serving_stays_outside_autograd():
    _, _, tm = _ref_and_port("internlm2-1.8b")
    toks = torch.from_numpy(_batch(tm.cfg)["tokens"])
    logits, caches = tm.prefill({"tokens": toks}, max_len=20)
    assert not logits.requires_grad and logits.is_inference()
    logits, _ = tm.decode_step(toks[:, :1], caches, toks.shape[1])
    assert not logits.requires_grad and logits.is_inference()


# ---------------------------------------------------------------------------
# Remat
# ---------------------------------------------------------------------------

def _remat_run(tm, batch, monkeypatch):
    """(loss, grads, bytes autograd saved outside the checkpoints, decoder
    block executions, the dots policy's MUST_SAVE decisions)."""
    saved, runs, kept = [], [], []
    block, policy = blocks.decoder_block, blocks._save_dots

    def counted_block(*a, **k):
        runs.append(1)
        return block(*a, **k)

    def counted_policy(ctx, op, *a, **k):
        out = policy(ctx, op, *a, **k)
        kept.append(out == blocks.CheckpointPolicy.MUST_SAVE)
        return out

    def pack(t):
        saved.append(t.numel() * t.element_size())
        return t

    monkeypatch.setattr(blocks, "decoder_block", counted_block)
    monkeypatch.setattr(blocks, "_save_dots", counted_policy)
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        loss, _ = tm.loss(batch)
    grads = torch.autograd.grad(loss, list(tm.parameters()))
    monkeypatch.undo()
    return loss, grads, sum(saved), len(runs), sum(kept)


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_changes_memory_never_bits(arch, monkeypatch):
    _, _, tm = _ref_and_port(arch)
    batch = tstep.to_device(_batch(tm.cfg), "cpu")
    out = {}
    for policy in ("none", "full", "dots"):
        tm.cfg = tm.cfg.replace(remat=policy)
        out[policy] = _remat_run(tm, batch, monkeypatch)
    for policy in ("full", "dots"):
        assert torch.equal(out[policy][0], out["none"][0])
        for a, b in zip(out[policy][1], out["none"][1]):
            assert torch.equal(a, b), policy
    n = tm.cfg.n_layers
    # a checkpointed layer keeps only its input outside the checkpoint
    # and runs again in the backward pass; dots keeps the layer's seven
    # weight products (q, k, v, o, gate, up, down) for it
    assert out["full"][2] == out["dots"][2] < out["none"][2]
    assert [out[p][3] for p in ("none", "full", "dots")] == [n, 2 * n, 2 * n]
    assert (out["none"][4], out["full"][4], out["dots"][4]) == (0, 0, 7 * n)


def test_remat_policy_is_checked():
    _, _, tm = _ref_and_port("internlm2-1.8b")
    tm.cfg = tm.cfg.replace(remat="offload")
    with pytest.raises(ValueError):
        tm.loss(tstep.to_device(_batch(tm.cfg), "cpu"))
    # no remat while no gradient is recorded (serving): no error either
    with torch.no_grad():
        tm.loss(tstep.to_device(_batch(tm.cfg), "cpu"))


def test_dots_policy_saves_the_weight_products_only():
    ctx = None
    assert blocks._save_dots(ctx, torch.ops.aten.mm.default) == \
        blocks.CheckpointPolicy.MUST_SAVE
    assert blocks._save_dots(ctx, torch.ops.aten.addmm.default) == \
        blocks.CheckpointPolicy.MUST_SAVE
    assert blocks._save_dots(ctx, torch.ops.aten.bmm.default) == \
        blocks.CheckpointPolicy.PREFER_RECOMPUTE


# ---------------------------------------------------------------------------
# Training steps from the reference's state
# ---------------------------------------------------------------------------

def _params_close(got, want, atol=PARAM_ATOL):
    for (path, w), g in zip(jax.tree_util.tree_leaves_with_path(want),
                            jax.tree.leaves(got)):
        np.testing.assert_allclose(g, np.asarray(w, np.float32),
                                   rtol=PARAM_RTOL, atol=atol,
                                   err_msg=jax.tree_util.keystr(path))


def _run_both(arch, make, lr, steps=3, n_micro=1, **over):
    """The reference's jitted step and the port's step from the same
    state over `steps` batches: (per-step reference metrics, port
    metrics, reference final state, port final state)."""
    jm, _, tm = _ref_and_port(arch, **over)
    jopt, topt = make(joptim), make(optim)
    js = jstep.make_train_state_init(jm, jopt)(jax.random.key(0))
    ts = compat.train_state_from_reference(
        tm.cfg, jax.tree.map(np.asarray, js), device="cpu")
    jf = jax.jit(jstep.make_train_step(
        jm, jopt, schedule=lambda s: jnp.asarray(lr, jnp.float32),
        n_microbatches=n_micro))
    tf = tstep.make_train_step(
        tm, topt, schedule=lambda s: torch.tensor(lr),
        n_microbatches=n_micro)
    jms, tms = [], []
    for i in range(steps):
        b = _batch(jm.cfg, b=8, index=i)
        js, jmet = jf(js, b)
        ts, tmet = tf(ts, b)
        jms.append({k: float(v) for k, v in jmet.items()})
        tms.append({k: float(v) for k, v in tmet.items()})
    return jms, tms, js, ts


@pytest.mark.parametrize("arch", ARCHS)
def test_three_sgdm_steps_match_reference(arch):
    jms, tms, js, ts = _run_both(arch, lambda m: m.sgdm(), 1e-2)
    for j, t in zip(jms, tms):
        np.testing.assert_allclose(t["loss"], j["loss"], rtol=LOSS_RTOL)
        np.testing.assert_allclose(t["grad_norm"], j["grad_norm"],
                                   rtol=LOSS_RTOL)
        assert t["lr"] == j["lr"]
    _params_close(_stacked_np(ts.params), js.params)
    _params_close(_stacked_np(ts.opt_state["m"]), js.opt_state["m"],
                  atol=1e-5)
    assert int(ts.step) == int(js.step) == 3


def _adaptive_params_close(got, want, lr, steps=3):
    """An adaptive optimizer's params after `steps` steps. Its step is ~
    lr x sign(g) where |g| >> sqrt(nu): at elements whose gradient is 0
    up to rounding (glm4's key bias: softmax ignores a shift shared by a
    query's scores), the two frameworks' updates may differ by up to lr
    a step, so the bar there is `steps` x lr absolute; 99% of all
    elements meet the tight bar."""
    n = tight = 0
    for (path, w), g in zip(jax.tree_util.tree_leaves_with_path(want),
                            jax.tree.leaves(got)):
        w = np.asarray(w, np.float32)
        err = np.abs(g - w)
        assert np.all(err <= PARAM_RTOL * np.abs(w) + steps * lr), \
            (jax.tree_util.keystr(path), float(err.max()))
        tight += int(np.sum(err <= PARAM_RTOL * np.abs(w) + PARAM_ATOL))
        n += err.size
    assert tight >= 0.99 * n, tight / n


def _moments_close(got, want, tol=GRAD_TOL):
    """Moments of the gradient: each leaf within tol of its largest
    entry, as the gradients are."""
    _grads_close(jax.tree.leaves(got), want, tol)


@pytest.mark.parametrize("arch", ARCHS)
def test_three_adamw_steps_match_reference(arch):
    lr = 3e-3
    jms, tms, js, ts = _run_both(arch, lambda m: m.adamw(), lr)
    for j, t in zip(jms, tms):
        np.testing.assert_allclose(t["loss"], j["loss"], rtol=LOSS_RTOL)
        np.testing.assert_allclose(t["grad_norm"], j["grad_norm"],
                                   rtol=LOSS_RTOL)
    _adaptive_params_close(_stacked_np(ts.params), js.params, lr)
    # steps 2 and 3 take their gradients at params that differ by up to
    # lr at the noise elements: the moments within 1e-3 of each leaf's
    # largest entry (they hold at GRAD_TOL after the first step)
    for k in ("mu", "nu"):
        _moments_close(_stacked_np(ts.opt_state[k]), js.opt_state[k], 1e-3)
    assert int(ts.opt_state["count"]) == int(js.opt_state["count"]) == 3
    _, _, js1, ts1 = _run_both(arch, lambda m: m.adamw(), lr, steps=1)
    for k in ("mu", "nu"):
        _moments_close(_stacked_np(ts1.opt_state[k]), js1.opt_state[k])


def test_adafactor_steps_from_the_references_state():
    lr = 1e-2
    jms, tms, js, ts = _run_both("glm4-9b",
                                 lambda m: m.adafactor(momentum=0.9), lr)
    for j, t in zip(jms, tms):
        np.testing.assert_allclose(t["loss"], j["loss"], rtol=LOSS_RTOL)
    _adaptive_params_close(_stacked_np(ts.params), js.params, lr)


def test_train_state_from_reference_layouts():
    jm, _, tm = _ref_and_port("internlm2-1.8b", dtype="bfloat16")
    for make in (joptim.adamw, joptim.sgdm,
                 lambda: joptim.adafactor(momentum=0.9)):
        opt = make()
        js = jstep.make_train_state_init(jm, opt)(jax.random.key(1))
        ts = compat.train_state_from_reference(
            tm.cfg, jax.tree.map(np.asarray, js), device="cpu")
        assert isinstance(ts, tstep.TrainState)
        assert ts.step.dtype == torch.int32 and int(ts.step) == 0
        assert len(ts.params["layers"]) == tm.cfg.n_layers
        # the params come back as the reference's, leaf for leaf
        for w, g in zip(jax.tree.leaves(js.params),
                        jax.tree.leaves(_stacked_np(ts.params))):
            np.testing.assert_array_equal(g, np.asarray(w, np.float32))
        if "f" in ts.opt_state:
            assert ts.opt_state["f"]["layers"]["ln1"]["scale"]["m"].dtype \
                == torch.bfloat16
        else:
            for k, v in ts.opt_state.items():
                if k != "count":
                    assert len(v["layers"]) == tm.cfg.n_layers


# ---------------------------------------------------------------------------
# Microbatches
# ---------------------------------------------------------------------------

def test_microbatch_accumulation_matches_full_batch():
    """4 microbatches against 1 (the reference's bar), and against the
    reference's 4 microbatches."""
    sgd = lambda m: m.sgdm(momentum=0.0)  # noqa: E731
    jm1, tm1, js1, ts1 = _run_both("glm4-9b", sgd, 1e-2, steps=1)
    jm4, tm4, js4, ts4 = _run_both("glm4-9b", sgd, 1e-2, steps=1,
                                   n_micro=4)
    assert abs(tm1[0]["loss"] - tm4[0]["loss"]) < 1e-4
    for a, b in zip(jax.tree.leaves(_stacked_np(ts1.params)),
                    jax.tree.leaves(_stacked_np(ts4.params))):
        np.testing.assert_allclose(a, b, rtol=2e-3, atol=2e-5)
    np.testing.assert_allclose(tm4[0]["loss"], jm4[0]["loss"],
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(tm4[0]["grad_norm"], jm4[0]["grad_norm"],
                               rtol=LOSS_RTOL)
    _params_close(_stacked_np(ts4.params), js4.params)


def test_microbatch_grads_reach_the_optimizer_in_the_accumulator_dtype():
    """bf16 params: one microbatch hands bf16 grads on, four hand f32
    (summed in accum_dtype and divided by n), as the reference."""
    seen = []

    def spy(make):
        inner = make()

        def update(grads, state, params, lr):
            seen.append({g.dtype for g in tree_leaves(grads)})
            return inner.update(grads, state, params, lr)
        return optim.Optimizer(init=inner.init, update=update)

    _, _, tm = _ref_and_port("internlm2-1.8b", dtype="bfloat16")
    for n in (1, 4):
        opt = spy(optim.sgdm)
        state = tstep.TrainState(params=tm.param_tree(),
                                 opt_state=opt.init(tm.param_tree()),
                                 step=torch.zeros((), dtype=torch.int32))
        tstep.make_train_step(tm, opt, n_microbatches=n)(
            state, _batch(tm.cfg, b=8))
    assert seen == [{torch.bfloat16}, {torch.float32}]


def test_train_step_updates_the_model_in_place_and_reloads_a_restored_state():
    _, _, tm = _ref_and_port("internlm2-1.8b")
    opt = optim.adamw()
    init = tstep.make_train_state_init(tm, opt)
    state = init(torch.Generator().manual_seed(0))
    assert all(a is b for a, b in zip(tree_leaves(state.params),
                                      tree_leaves(tm.param_tree())))
    step = tstep.make_train_step(tm, opt)
    s1, m1 = step(state, _batch(tm.cfg))
    assert set(m1) == {"loss", "grad_norm", "lr"}
    assert all(a is b for a, b in zip(tree_leaves(s1.params),
                                      tree_leaves(tm.param_tree())))
    copy = tstep.TrainState(
        params=jax.tree.map(lambda x: x.detach().clone(), s1.params),
        opt_state=jax.tree.map(lambda x: x.clone(), s1.opt_state),
        step=s1.step.clone())
    s2, m2 = step(s1, _batch(tm.cfg, index=1))
    # a state of other tensors (as a restore gives) is copied in first
    init(torch.Generator().manual_seed(5))
    s2b, m2b = step(copy, _batch(tm.cfg, index=1))
    assert float(m2["loss"]) == float(m2b["loss"])
    for a, b in zip(tree_leaves(s2.params), tree_leaves(s2b.params)):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# One step of every other family
# ---------------------------------------------------------------------------

# leaves whose gradient is rounding noise (whisper's key biases: softmax
# ignores a shift shared by a query's scores; sLSTM's b_i at init): held
# within GRAD_TOL of this share of the model's largest gradient entry
GRAD_FLOOR = 1e-3


def _family_batch(cfg, seed=3):
    """The dataset's tokens and targets, plus the family's other inputs:
    a vision prefix for vlm, frames for enc-dec."""
    b = _batch(cfg, b=4, index=0, seed=seed)
    rng = np.random.default_rng(seed)
    if cfg.family == "vlm":
        b["vision_embeds"] = rng.normal(size=(4, 3, cfg.d_model)) \
            .astype(np.float32)
    if cfg.family == "encdec":
        b["frames"] = rng.normal(size=(4, 10, cfg.d_model)) \
            .astype(np.float32)
    return b


@pytest.mark.parametrize("arch,make", [
    ("grok-1-314b", "adamw"), ("qwen2-moe-a2.7b", "adamw"),
    ("internvl2-76b", "adamw"), ("zamba2-1.2b", "adamw"),
    ("xlstm-350m", "adamw"), ("whisper-base", "adamw"),
    ("xlstm-350m", "adafactor"), ("grok-1-314b", "adafactor")])
def test_one_step_of_every_family_matches_reference(arch, make):
    """From the reference's train state: the loss and every gradient leaf
    (within 1e-5 of the leaf's largest entry, or of 1e-3 of the model's
    largest where a leaf's own is noise), then one step's loss, grad norm
    and params (99% at 1e-5 |p| + 1e-6, all within lr: PR 29's bars).
    MoE at its config's capacity factor, grok-1's experts looped under
    checkpoint; Adafactor's statistics over the reference's stacked
    leaves, xLSTM's (n_seg, every-1, ...) mLSTM stack included."""
    lr = 3e-3
    opts = {"adamw": lambda m: m.adamw(),
            "adafactor": lambda m: m.adafactor(momentum=0.9)}
    jm, _, tm = _ref_and_port(arch)
    jopt, topt = opts[make](joptim), opts[make](optim)
    js = jstep.make_train_state_init(jm, jopt)(jax.random.key(0))
    ts = compat.train_state_from_reference(
        tm.cfg, jax.tree.map(np.asarray, js), device="cpu")
    b = _family_batch(jm.cfg)
    (jl, _), jg = jax.jit(jax.value_and_grad(jm.loss, has_aux=True))(
        js.params, b)
    tm.load_params(ts.params)
    tl, _, tg = tstep.value_and_grad(tm, tstep.to_device(b, "cpu"))
    np.testing.assert_allclose(float(tl), float(jl), rtol=LOSS_RTOL)
    top = max(float(np.max(np.abs(np.asarray(w, np.float32))))
              for w in jax.tree.leaves(jg))
    for (path, w), g in zip(jax.tree_util.tree_leaves_with_path(jg),
                            jax.tree.leaves(_stacked_np(tg))):
        w = np.asarray(w, np.float32)
        assert g.shape == w.shape, path
        scale = max(float(np.max(np.abs(w))), GRAD_FLOOR * top)
        assert float(np.max(np.abs(g - w))) <= GRAD_TOL * scale, \
            jax.tree_util.keystr(path)
    jf = jax.jit(jstep.make_train_step(
        jm, jopt, schedule=lambda s: jnp.asarray(lr, jnp.float32)))
    tf = tstep.make_train_step(tm, topt, schedule=lambda s: torch.tensor(lr))
    js, jmet = jf(js, b)
    ts, tmet = tf(ts, b)
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(tmet[k]), float(jmet[k]),
                                   rtol=LOSS_RTOL)
    _adaptive_params_close(_stacked_np(ts.params), js.params, lr, steps=1)
    assert int(ts.step) == int(js.step) == 1
