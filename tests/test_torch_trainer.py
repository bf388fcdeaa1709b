"""The port's token data, loaders, fault-tolerant trainer, training
launcher and TrainState checkpoints (`repro_torch.data.tokens`,
`data.loader`, `runtime.trainer`, `launch.train`, `checkpoint.manager`)
against the reference's on the CPU.

Batches and a resumed loader equal the reference's bit for bit; a run
that fails and restarts from its checkpoint ends on the uninterrupted
run's params bit for bit; on the reference's weights the trainer's report
(losses with the replayed steps) equals the reference trainer's at a
stated bar; training reduces the loss; the launcher runs; a TrainState
with bf16 leaves survives a checkpoint round trip bit for bit.
"""

import io
import os
import contextlib

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
from repro.data import loader as jloader  # noqa: E402
from repro.data import tokens as jtokens  # noqa: E402
from repro.models.model import build_model as jbuild  # noqa: E402
from repro.runtime import trainer as jtrainer  # noqa: E402
from repro.train import step as jstep  # noqa: E402
from repro_torch import compat, obs, optim  # noqa: E402
from repro_torch.checkpoint.manager import CheckpointManager  # noqa: E402
from repro_torch.configs.registry import SMOKES  # noqa: E402
from repro_torch.data import loader, tokens  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import nn  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.runtime import trainer  # noqa: E402
from repro_torch.train import step as tstep  # noqa: E402
from repro_torch.utils.tree import tree_leaves  # noqa: E402

ARCH = "internlm2-1.8b"
# the trainer on the reference's weights: 15 AdamW steps (12 and 3
# replayed) drift apart by the f32 rounding of both frameworks, amplified
# by AdamW's normalisation at near-zero gradients: losses at rtol 1e-4
LOSS_RTOL = 1e-4


# ---------------------------------------------------------------------------
# Data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    {"vocab": 256, "seq_len": 16, "global_batch": 4, "seed": 5},
    {"vocab": 92544, "seq_len": 64, "global_batch": 8, "seed": 0},
    {"vocab": 50, "seq_len": 7, "global_batch": 6, "seed": 3,
     "zipf_a": 1.5, "repeat_p": 0.6},
])
def test_token_batches_equal_the_reference_bit_for_bit(kw):
    ds, jds = tokens.SyntheticTokenDataset(**kw), \
        jtokens.SyntheticTokenDataset(**kw)
    for i in (0, 1, 17):
        got, want = ds.batch(i), jds.batch(i)
        for k in ("tokens", "targets"):
            assert got[k].dtype == np.int32
            np.testing.assert_array_equal(got[k], want[k])
        np.testing.assert_array_equal(got["tokens"][:, 1:],
                                      got["targets"][:, :-1])
    lo, hi = 1, kw["global_batch"] - 1
    for k in ("tokens", "targets"):
        np.testing.assert_array_equal(ds.batch(3, lo=lo, hi=hi)[k],
                                      jds.batch(3, lo=lo, hi=hi)[k])
    for a, b in zip(tokens.make_token_batches(kw["vocab"], kw["seq_len"],
                                              kw["global_batch"], 3,
                                              seed=kw["seed"]),
                    jtokens.make_token_batches(kw["vocab"], kw["seq_len"],
                                               kw["global_batch"], 3,
                                               seed=kw["seed"])):
        np.testing.assert_array_equal(a["tokens"], b["tokens"])


@pytest.mark.parametrize("n_hosts,host", [(1, 0), (2, 1), (4, 2)])
def test_sharded_loader_resume_equals_the_reference(n_hosts, host):
    kw = {"vocab": 256, "seq_len": 8, "global_batch": 8, "seed": 2}
    ours = loader.ShardedLoader(tokens.SyntheticTokenDataset(**kw),
                                n_hosts=n_hosts, host_index=host)
    ref = jloader.ShardedLoader(jtokens.SyntheticTokenDataset(**kw),
                                n_hosts=n_hosts, host_index=host)
    for _ in range(3):
        np.testing.assert_array_equal(next(ours)["tokens"],
                                      next(ref)["tokens"])
    saved = ours.state()
    assert saved == ref.state() == {"index": 3}
    later = [next(ours)["targets"] for _ in range(2)]
    again = loader.ShardedLoader(tokens.SyntheticTokenDataset(**kw),
                                 n_hosts=n_hosts, host_index=host)
    again.restore(saved)
    jref = jloader.ShardedLoader(jtokens.SyntheticTokenDataset(**kw),
                                 n_hosts=n_hosts, host_index=host)
    jref.restore(saved)
    for want in later:
        got = next(again)["targets"]
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, next(jref)["targets"])
    assert got.shape == (8 // n_hosts, 8)


def test_prefetch_loader_keeps_the_order():
    ds = tokens.SyntheticTokenDataset(vocab=64, seq_len=4, global_batch=2)
    it = (ds.batch(i) for i in range(5))
    got = list(loader.PrefetchLoader(it, depth=2))
    assert len(got) == 5
    for i, b in enumerate(got):
        np.testing.assert_array_equal(b["tokens"], ds.batch(i)["tokens"])


# ---------------------------------------------------------------------------
# TrainState checkpoints
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("make", [optim.adamw, optim.sgdm,
                                  lambda: optim.adafactor(momentum=0.9)])
def test_train_state_checkpoint_round_trip_bf16(tmp_path, make):
    cfg = SMOKES[ARCH].replace(dtype="bfloat16")
    model = build_model(cfg, device="cpu")
    opt = make()
    init = tstep.make_train_state_init(model, opt)
    state = init(torch.Generator().manual_seed(3))
    step = tstep.make_train_step(model, opt)
    ds = tokens.SyntheticTokenDataset(vocab=cfg.vocab, seq_len=8,
                                      global_batch=2)
    state, _ = step(state, ds.batch(0))
    # the state's params are the model's own weights: keep a copy before
    # the template's init draws new ones into them
    state = tstep.TrainState(*[
        jax.tree.map(lambda x: x.detach().clone(), part)
        for part in (state.params, state.opt_state, state.step)])
    dtypes = {str(x.dtype) for x in tree_leaves(state)}
    assert "torch.bfloat16" in dtypes and "torch.int32" in dtypes
    mgr = CheckpointManager(tmp_path)
    mgr.save(state, step=1, extras={"loader": {"index": 1}})
    mgr.wait()
    template = init(torch.Generator().manual_seed(9))
    back, manifest = mgr.restore(template)
    assert isinstance(back, tstep.TrainState)
    assert manifest["extras"]["loader"] == {"index": 1}
    keys = list(manifest["leaves"])
    assert keys[-1] == "2" and keys[0].startswith("0/embed")
    for a, b in zip(tree_leaves(state), tree_leaves(back)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert len(back.params["layers"]) == cfg.n_layers


# ---------------------------------------------------------------------------
# The trainer
# ---------------------------------------------------------------------------

def _trainer(tmp_path, tag, init_state=None, model=None, opt=None):
    cfg = SMOKES[ARCH]
    model = model or build_model(cfg, device="cpu")
    opt = opt or optim.adamw()
    ds = tokens.SyntheticTokenDataset(vocab=cfg.vocab, seq_len=16,
                                      global_batch=4, seed=5)
    return trainer.FaultTolerantTrainer(
        train_step=tstep.make_train_step(model, opt),
        init_state=init_state or tstep.make_train_state_init(model, opt),
        dataset=ds, ckpt_dir=tmp_path / tag, checkpoint_every=5,
        device="cpu"), model


def test_restart_equals_uninterrupted(tmp_path):
    clean, m_clean = _trainer(tmp_path, "clean")
    rep_clean = clean.run(n_steps=12, seed=0)
    assert rep_clean.restarts == 0 and rep_clean.steps_run == 12
    final_clean = [p.detach().clone() for p in m_clean.parameters()]

    faulty, m_faulty = _trainer(tmp_path, "faulty")
    rep = faulty.run(n_steps=12, seed=0, fail_at_step=8)
    assert rep.restarts == 1 and rep.final_step == 12
    assert rep.steps_run == 15 and len(rep.losses) == 15
    # the replayed steps (5-7) repeat the clean run's losses exactly
    assert rep.losses[8:11] == rep_clean.losses[5:8]
    assert rep.losses[:8] == rep_clean.losses[:8]
    assert rep.losses[11:] == rep_clean.losses[8:]
    for a, b in zip(final_clean, m_faulty.parameters()):
        assert torch.equal(a, b)

    s_clean, _ = clean.manager.restore(
        clean.init_state(clean.generator(0)))
    s_faulty, _ = faulty.manager.restore(
        faulty.init_state(faulty.generator(0)))
    assert int(s_clean.step) == int(s_faulty.step) == 10
    for a, b in zip(tree_leaves(s_clean), tree_leaves(s_faulty)):
        assert torch.equal(a, b)


def test_trainer_resumes_what_the_directory_holds(tmp_path):
    first, _ = _trainer(tmp_path, "run")
    first.run(n_steps=10, seed=0)
    again, _ = _trainer(tmp_path, "run")
    rep = again.run(n_steps=12, seed=0)
    assert rep.steps_run == 2 and rep.final_step == 12


def test_trainer_gives_up_after_max_restarts(tmp_path):
    t, _ = _trainer(tmp_path, "x")
    with pytest.raises(trainer.SimulatedFailure):
        t.run(n_steps=4, seed=0, fail_at_step=0, max_restarts=-1)


def test_trainer_spans_carry_step_and_loss(tmp_path):
    t, model = _trainer(tmp_path, "obs")
    with obs.session():
        obs.clear()
        before = obs.metrics.value("train.steps", 0.0)
        rep = t.run(n_steps=3, seed=0)
        steps = obs.metrics.value("train.steps", 0.0) - before
        n_params = obs.metrics.gauge_value("train.params")
        events = obs.events()
    spans = [e for e in events if e["name"] == "train.step"]
    assert steps == 3 and len(spans) == 3
    assert n_params == nn.count_params(model.param_specs())
    assert [s["args"]["step"] for s in spans] == [0, 1, 2]
    for name in ("train.grads", "train.update"):
        inner = [e for e in events if e["name"] == name]
        assert len(inner) == 3
        assert all(e["args"]["parent"] == "train.step" for e in inner)
    assert [s["args"]["loss"] for s in spans] == rep.losses


def test_trainer_report_matches_the_reference_on_its_weights(tmp_path):
    """The reference's trainer and the port's from the same weights and
    optimizer state (carried across), failing at step 8 of 12."""
    jcfg, cfg = JSMOKES[ARCH], SMOKES[ARCH]
    jm = jbuild(jcfg)
    jopt = joptim.adamw()
    js0 = jstep.make_train_state_init(jm, jopt)(jax.random.key(0))
    np_state = jax.tree.map(np.asarray, js0)
    jds = jtokens.SyntheticTokenDataset(vocab=jcfg.vocab, seq_len=16,
                                        global_batch=4, seed=5)
    jt = jtrainer.FaultTolerantTrainer(
        train_step=jax.jit(jstep.make_train_step(jm, jopt)),
        init_state=lambda key: js0, dataset=jds,
        ckpt_dir=tmp_path / "ref", checkpoint_every=5)
    jrep = jt.run(n_steps=12, seed=0, fail_at_step=8)

    model = build_model(cfg, device="cpu")
    t, _ = _trainer(
        tmp_path, "port", model=model,
        init_state=lambda g: compat.train_state_from_reference(
            cfg, np_state, device="cpu"))
    rep = t.run(n_steps=12, seed=0, fail_at_step=8)
    assert (rep.steps_run, rep.restarts, rep.final_step) == \
        (jrep.steps_run, jrep.restarts, jrep.final_step) == (15, 1, 12)
    np.testing.assert_allclose(rep.losses, jrep.losses, rtol=LOSS_RTOL)


def test_training_reduces_loss():
    cfg = SMOKES[ARCH]
    model = build_model(cfg, device="cpu")
    opt = optim.adamw()
    step = tstep.make_train_step(
        model, opt, schedule=lambda s: torch.tensor(3e-3))
    state = tstep.make_train_state_init(model, opt)(
        torch.Generator().manual_seed(0))
    ds = tokens.SyntheticTokenDataset(vocab=cfg.vocab, seq_len=32,
                                      global_batch=8, seed=0)
    losses = []
    for i in range(30):
        state, metrics = step(state, ds.batch(i))
        losses.append(float(metrics["loss"]))
    assert losses[-1] < losses[0] - 0.3, (losses[0], losses[-1])
    assert all(np.isfinite(losses))


def test_default_optimizer_for_equals_the_reference():
    from repro.configs.registry import ARCHS as JARCHS
    from repro_torch.configs.registry import ARCHS
    for name in ARCHS:
        assert tstep.default_optimizer_for(ARCHS[name]).name == \
            jstep.default_optimizer_for(JARCHS[name]).name


# ---------------------------------------------------------------------------
# The launcher
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("extra", [[], ["--fail-at", "3", "--ckpt-every",
                                        "2"], ["--microbatches", "2"]])
def test_launcher_smoke(tmp_path, extra):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = launch_train.main(["--smoke", "--steps", "5", "--batch", "4",
                                "--seq", "16", "--device", "cpu",
                                "--ckpt-dir", str(tmp_path / "ck")] + extra)
    assert rc == 0
    lines = out.getvalue().splitlines()
    assert len(lines) == 2
    assert lines[0].startswith("[train] arch=internlm2-smoke steps=5 ")
    restarts = 1 if "--fail-at" in extra else 0
    assert f" restarts={restarts} " in lines[0]
    first, last = (float(x.split("=")[1]) for x in lines[1].split()[2:])
    assert np.isfinite(first) and np.isfinite(last)


def test_launcher_flags_equal_the_reference():
    """Every flag of the reference's launcher, with its default, plus
    --device (the temp directory holds the default checkpoint dir)."""
    import argparse
    import ast
    import inspect
    from repro.launch import train as jlaunch
    ref = {}
    for node in ast.walk(ast.parse(inspect.getsource(jlaunch.main))):
        if isinstance(node, ast.Call) and getattr(
                node.func, "attr", "") == "add_argument":
            kw = {k.arg: k.value for k in node.keywords}
            ref[node.args[0].value] = (ast.literal_eval(kw["default"])
                                       if "default" in kw else None)
    ours = {a.option_strings[0]: a.default
            for a in launch_train.parser()._actions
            if not isinstance(a, argparse._HelpAction)}
    assert set(ours) == set(ref) | {"--device"}
    for flag, default in ref.items():
        if flag == "--ckpt-dir":
            assert ours[flag].endswith("repro_torch_ckpt")
        elif flag != "--smoke":
            assert ours[flag] == default, flag
    assert ours["--device"] == "cuda"


def test_launcher_refuses_the_card_without_one(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        launch_train.main(["--smoke", "--steps", "1", "--ckpt-dir",
                           str(tmp_path / "ck")])
