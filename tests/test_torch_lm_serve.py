"""The port's LM serving path (`repro_torch.serve.engine`,
`repro_torch.launch.serve lm`) against the reference on the CPU: the
continuous-batching loop step by step on the reference's weights, its
counters, the shared-cache_len behaviour of a late-admitted request, the
samplers, the CLI, and model embeddings -> distances -> PERMANOVA."""

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

from repro import obs as jobs  # noqa: E402
from repro.configs.registry import SMOKES as JSMOKES  # noqa: E402
from repro.core import distance as jdist  # noqa: E402
from repro.core import permutations as jperm  # noqa: E402
from repro.core.permanova import permanova as jpermanova  # noqa: E402
from repro.models.model import _positions as j_positions  # noqa: E402
from repro.models.model import build_model as jbuild  # noqa: E402
from repro.serve import engine as jengine  # noqa: E402
from repro_torch import compat, obs  # noqa: E402
from repro_torch.configs.registry import SMOKES  # noqa: E402
from repro_torch.core import distance  # noqa: E402
from repro_torch.core.permanova import permanova  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.pipeline.api import pipeline  # noqa: E402
from repro_torch.serve import engine  # noqa: E402

ARCH = "internlm2-1.8b"
# a step's f32 logits against the reference's on the same weights and
# cache: the frameworks sum in different orders (~1e-6 at unit scale)
LOGIT_BAR = 1e-5
COUNTERS = ("serve.requests_admitted", "serve.requests_completed",
            "serve.steps")


@pytest.fixture(scope="module")
def ref_and_port():
    """(reference model, its params, the port's model on its weights):
    the reference test's smoke and key."""
    jm = jbuild(JSMOKES[ARCH])
    params = jm.init(jax.random.key(0))
    tm = compat.lm_params_from_reference(
        SMOKES[ARCH], jax.tree.map(np.asarray, params), device="cpu")
    return jm, params, tm


def _prompts(vocab, n=6, length=3, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=(length,)).astype(np.int32)
            for _ in range(n)]


def _ref_run(jm, params, prompts, max_new, *, batch=2, max_len=32):
    """The reference ServeLoop with every step's (next token, logits)
    recorded, and its obs counters."""
    loop = jengine.ServeLoop(jm, params, batch_size=batch, max_len=max_len)
    trace, inner = [], loop.step_fn

    def recording(*args):
        out = inner(*args)
        trace.append((np.asarray(out[0]), np.asarray(out[1])))
        return out

    loop.step_fn = recording
    reqs = [jengine.Request(prompt=p, max_new_tokens=k)
            for p, k in zip(prompts, max_new)]
    before = {c: jobs.metrics.value(c, 0.0) for c in COUNTERS}
    with jobs.session():
        done = loop.run(reqs, max_steps=200, key=jax.random.key(1))
        counts = {c: jobs.metrics.value(c, 0.0) - before[c]
                  for c in COUNTERS}
    return done, trace, counts


def _port_run(tm, prompts, max_new, *, sampler=None, batch=2, max_len=32,
              generator=None):
    loop = engine.ServeLoop(tm, batch_size=batch, max_len=max_len,
                            sampler=sampler)
    reqs = [engine.Request(prompt=p, max_new_tokens=k)
            for p, k in zip(prompts, max_new)]
    before = {c: obs.metrics.value(c, 0.0) for c in COUNTERS}
    with obs.session():
        done = loop.run(reqs, max_steps=200, generator=generator)
        counts = {c: obs.metrics.value(c, 0.0) - before[c]
                  for c in COUNTERS}
    return done, counts


def _replay(trace):
    """A port sampler that holds each step's logits to the reference's
    and returns the reference's token; the errors it saw."""
    steps, errs = iter(trace), []

    def sample(logits, generator):
        nxt, want = next(steps)
        errs.append(float(np.abs(logits.numpy() - want).max()))
        return torch.from_numpy(nxt[:, 0].copy())

    return sample, errs


# test_serve_loop_continuous_batching's case: 6 requests of 3 tokens, 5
# new tokens each, batch 2, max_len 32; and one whose slots fall out of
# phase (different lengths), so requests are admitted while the other
# slot is mid-sequence
CASES = {"reference_case": [5] * 6, "out_of_phase": [2, 6, 3, 5, 4, 2]}


@pytest.mark.parametrize("case", list(CASES))
def test_serve_loop_replays_the_reference(ref_and_port, case):
    """Each step's logits (every slot, occupied or not) against the
    reference's at LOGIT_BAR, the reference's token fed back; the
    requests' tokens, the steps and the obs counters are equal."""
    jm, params, tm = ref_and_port
    prompts, max_new = _prompts(jm.cfg.vocab), CASES[case]
    ref, trace, ref_counts = _ref_run(jm, params, prompts, max_new)
    sampler, errs = _replay(trace)
    got, counts = _port_run(tm, prompts, max_new, sampler=sampler)
    assert len(errs) == len(trace) == ref_counts["serve.steps"]
    assert max(errs) < LOGIT_BAR, errs
    assert [r.generated for r in got] == [r.generated for r in ref]
    assert all(r.done for r in got)
    assert [len(r.generated) for r in got] == max_new
    assert counts == ref_counts
    assert ref_counts["serve.requests_admitted"] == \
        ref_counts["serve.requests_completed"] == 6


@pytest.mark.parametrize("case", list(CASES))
def test_serve_loop_greedy_matches_the_reference(ref_and_port, case):
    """The port's own greedy run: equal tokens at every step up to the
    first whose top-two logit gap (in the reference's logits) is within
    the logit bar, where an argmax may flip (none in these cases)."""
    jm, params, tm = ref_and_port
    prompts, max_new = _prompts(jm.cfg.vocab), CASES[case]
    ref, trace, ref_counts = _ref_run(jm, params, prompts, max_new)
    gaps = [np.diff(np.sort(logits[:, -1], axis=-1)[:, -2:]).min()
            for _, logits in trace]
    assert min(gaps) > LOGIT_BAR
    got, counts = _port_run(tm, prompts, max_new)
    assert [r.generated for r in got] == [r.generated for r in ref]
    assert counts == ref_counts
    for tok in got[0].generated:
        assert 0 <= tok < jm.cfg.vocab


def test_late_admitted_request_shares_cache_len(ref_and_port):
    """The reference's loop decodes every slot at one cache_len (the
    longest slot's length) and does not reset a reused slot's cache, so
    a request admitted while the other slot is mid-sequence writes at
    that column, takes its RoPE position from it and attends to the
    previous occupant's k/v. The port reproduces it: those requests'
    tokens equal the reference's and differ from the same request served
    alone."""
    jm, params, tm = ref_and_port
    prompts, max_new = _prompts(jm.cfg.vocab), CASES["out_of_phase"]
    ref, _, _ = _ref_run(jm, params, prompts, max_new)
    got, _ = _port_run(tm, prompts, max_new)
    alone = [_port_run(tm, [p], [k])[0][0].generated
             for p, k in zip(prompts, max_new)]
    assert [r.generated for r in got] == [r.generated for r in ref]
    # the first two start together at cache_len 0, as if alone
    assert [r.generated for r in got[:2]] == alone[:2]
    shifted = [i for i in range(2, 6) if got[i].generated != alone[i]]
    assert shifted, "no late-admitted request saw the shared cache_len"
    ref_alone = [jengine.ServeLoop(jm, params, batch_size=2, max_len=32)
                 .run([jengine.Request(prompt=prompts[i],
                                       max_new_tokens=max_new[i])])[0]
                 .generated for i in shifted]
    assert ref_alone == [alone[i] for i in shifted]


def test_temperature_sampler_is_seeded(ref_and_port):
    _, _, tm = ref_and_port
    prompts = _prompts(tm.cfg.vocab, seed=1)

    def run(seed):
        done, _ = _port_run(
            tm, prompts, [5] * 6, sampler=engine.temperature_sample(0.8),
            generator=torch.Generator().manual_seed(seed))
        return [r.generated for r in done]

    a, b, c = run(3), run(3), run(4)
    assert a == b and a != c
    assert all(0 <= t < tm.cfg.vocab for toks in a for t in toks)
    logits = torch.zeros(2, 1, 5)
    logits[:, 0, 3] = 50.0     # a near-certain token wins at T = 0.8
    g = torch.Generator().manual_seed(0)
    assert engine.temperature_sample(0.8)(logits, g).tolist() == [3, 3]
    assert engine.greedy_sample(logits).dtype == torch.int32


def test_serve_greedy_is_deterministic():
    """The reference's test_serve_greedy_is_deterministic on the port's
    own glm4 smoke (half-rotary, qkv bias)."""
    cfg = SMOKES["glm4-9b"]
    m = tmodel.build_model(cfg, device="cpu",
                           generator=torch.Generator().manual_seed(2))
    prompt = np.random.default_rng(2).integers(
        0, cfg.vocab, size=(4,)).astype(np.int32)

    def gen():
        loop = engine.ServeLoop(m, batch_size=1, max_len=32)
        return loop.run([engine.Request(prompt=prompt.copy(),
                                        max_new_tokens=6)],
                        max_steps=64)[0].generated

    assert gen() == gen()


def test_make_prefill_and_serve_step(ref_and_port):
    """The step factories: prefill then one serve step equal the model's
    own calls (greedy)."""
    _, _, tm = ref_and_port
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, tm.cfg.vocab, size=(2, 6)).astype(np.int32))
    logits, caches = engine.make_prefill(tm)({"tokens": toks}, 8)
    want, _ = tm.prefill({"tokens": toks}, max_len=8)
    assert torch.equal(logits, want)
    nxt, step_logits, caches = engine.make_serve_step(tm)(
        toks[:, -1:], caches, 6, None)
    assert tuple(nxt.shape) == (2, 1)
    assert torch.equal(nxt[:, 0], engine.greedy_sample(step_logits))


@pytest.mark.parametrize("argv", [
    ["lm", "--smoke", "--device", "cpu"],
    ["--smoke", "--device", "cpu", "--greedy", "--requests", "5"],
])
def test_cli_lm_smoke(argv, capsys):
    """`lm --smoke` with the reference's defaults, and no subcommand
    meaning `lm` as in the reference's launcher."""
    assert launch_serve.main(argv) == 0
    out = capsys.readouterr().out
    n = 5 if "--requests" in argv else 12
    assert f"[serve] arch=internlm2-smoke requests={n} generated={16 * n} " \
        in out
    assert "on cpu" in out


def test_cli_lm_runs_the_requested_sampler():
    ap = launch_serve.parser()
    args = ap.parse_args(["lm", "--smoke", "--device", "cpu", "--requests",
                          "4", "--greedy"])
    cfg, greedy1, _ = launch_serve.serve_lm(args)
    _, greedy2, _ = launch_serve.serve_lm(args)
    args = ap.parse_args(["lm", "--smoke", "--device", "cpu", "--requests",
                          "4"])
    _, temp1, _ = launch_serve.serve_lm(args)
    _, temp2, _ = launch_serve.serve_lm(args)
    toks = [[r.generated for r in d] for d in (greedy1, greedy2, temp1,
                                               temp2)]
    assert toks[0] == toks[1] and toks[2] == toks[3] and toks[0] != toks[2]
    assert cfg.name == "internlm2-smoke"
    if not torch.cuda.is_available():
        # the default device is the card, and there is none to fall back
        # from: the demo raises rather than run on the host
        with pytest.raises(RuntimeError, match="device='cuda'"):
            launch_serve.serve_lm(ap.parse_args(["lm", "--smoke"]))


def test_embedding_permanova_matches_the_reference(ref_and_port):
    """tests/test_train_serve.py::test_embedding_permanova_end_to_end on
    the port: the same smoke weights and tokens (two conditions: the
    whole vocabulary against a 16-token dialect), hidden states
    mean-pooled within 1e-5 of the reference's; then euclidean distances
    and PERMANOVA with the reference's own draws as explicit labels: F at
    rtol 1e-4, p equal. The port's features path (pipeline, euclidean,
    its own draws) agrees with its distance + permanova at the same seed."""
    jm, params, tm = ref_and_port
    rng = np.random.default_rng(0)
    n, s = 24, 16
    groups = np.repeat([0, 1], n // 2).astype(np.int32)
    toks = np.where((groups[:, None] == 0),
                    rng.integers(0, jm.cfg.vocab, size=(n, s)),
                    rng.integers(0, 16, size=(n, s))).astype(np.int32)

    h, _ = jm._embed_input(params, {"tokens": jnp.asarray(toks)})
    h, _, _ = jm._backbone(params, h, j_positions(n, s))
    emb_ref = np.asarray(jnp.mean(h, axis=1), np.float32)
    key = jax.random.key(0)
    res_ref = jpermanova(jdist.euclidean(jnp.asarray(emb_ref)),
                         jnp.asarray(groups), n_perms=99, key=key)
    assert float(res_ref.p_value) <= 0.05

    with torch.inference_mode():
        th, _ = tm._embed_input({"tokens": torch.from_numpy(toks)})
        th, _, _ = tm._backbone(th, tmodel._positions(n, s))
        emb = th.mean(dim=1)
    np.testing.assert_allclose(emb.numpy(), emb_ref, rtol=0, atol=1e-5)

    dm, g, perms = compat.from_reference(
        None, groups, jperm.permutation_batch(key, jnp.asarray(groups), 0,
                                              100), device="cpu")
    res = permanova(distance.euclidean(emb), g, n_perms=99, perms=perms,
                    device="cpu")
    np.testing.assert_allclose(float(res.f_stat), float(res_ref.f_stat),
                               rtol=1e-4)
    assert float(res.p_value) == float(res_ref.p_value)

    own = permanova(distance.euclidean(emb), g, n_perms=99, device="cpu")
    feat = pipeline(emb, g, metric="euclidean", n_perms=99, device="cpu")
    np.testing.assert_allclose(float(feat.f_stat), float(own.f_stat),
                               rtol=1e-4)
    assert float(feat.p_value) == float(own.p_value) <= 0.05
