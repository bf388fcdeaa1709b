"""The port's always-on PERMANOVA server (repro_torch.serve) on the CPU.

First the sentinel repair its padded studies rest on: the plain brute,
tiled and one-hot s_W forms weigh a label outside [0, G) as 0, so a study
zero-padded to a bucket with sentinel pad labels gives the unpadded s_W.
Then the serving block steps on the reference's own masked draws against
the reference's steps (rtol 1e-4), and the whole server fed the
reference's draws (`draws=`) against the reference server: F at rtol
1e-4, p equal, each null F within PERF.md §2's f32 allowance, for labels,
strata, a dense design and a features request; on its own draws a served
study equals the port's unpadded engine.run / run_design / pipeline() at
that bar (the masked draws are the unpadded ones). Then the reference's
`tests/test_serve_permanova.py` cases on the port, with kernel builds,
loads and bucket misses in place of jaxpr retraces (the port traces
nothing)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import permutations as jperm  # noqa: E402
from repro.engine import registry as jregistry  # noqa: E402
from repro.engine import scheduler as jscheduler  # noqa: E402
from repro.serve import permanova as jserve  # noqa: E402
from repro_torch import engine, obs, pipeline  # noqa: E402
from repro_torch.core import design, fstat, permutations  # noqa: E402
from repro_torch.engine import planner, registry, scheduler  # noqa: E402
from repro_torch.obs import cudahooks  # noqa: E402
from repro_torch.serve.permanova import (PermanovaServer,  # noqa: E402
                                         ServerOverloaded, StudyRequest,
                                         _next_bucket,
                                         serve_stats_from_events)

RTOL = 1e-4            # the repo's bar: F at rtol 1e-4, p equal
NULL_RTOL = 2e-6       # PERF.md §2: 2 x SW_MAIN_RTOL
CPU = dict(device="cpu")


@pytest.fixture(scope="module", autouse=True)
def _autotune_cache(tmp_path_factory):
    """Serving persists `serveplan|` entries: never in the default file."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv(planner.AUTOTUNE_CACHE_ENV,
                  str(tmp_path_factory.mktemp("tune") / "autotune.json"))
        yield
    planner.load_autotune_cache(reload=True)


def _euclidean(x):
    d = np.sqrt(((x[:, None, :].astype(np.float64) - x[None, :, :]) ** 2)
                .sum(-1))
    return d.astype(np.float32)


@pytest.fixture(scope="module")
def studies():
    rng = np.random.default_rng(7)
    out = []
    for n in (23, 19, 30):
        x = rng.normal(size=(n, 5)).astype(np.float32)
        g = rng.integers(0, 3, size=n).astype(np.int32)
        out.append((_euclidean(x), g))
    return out


def _srv(**kw):
    return PermanovaServer(**CPU, **kw)


# ---------------------------------------------------------------------------
# The sentinel repair: padded == unpadded in every plain s_W form.
# ---------------------------------------------------------------------------

def _padded(n, n_pad, g_count, p_count, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 4)).astype(np.float32)
    mat2 = torch.from_numpy(_euclidean(x) ** 2)
    g = torch.from_numpy(rng.integers(0, g_count, size=n).astype(np.int32))
    g_pad = torch.full((n_pad,), g_count, dtype=torch.int32)
    g_pad[:n] = g
    m_pad = torch.zeros((n_pad, n_pad))
    m_pad[:n, :n] = mat2
    labels = permutations.masked_permutation_batch(g_pad, n, 0, p_count,
                                                   seed=seed)
    inv_gs = permutations.inv_group_sizes(g_pad, g_count)
    return mat2, m_pad, labels, inv_gs


SENTINEL_FORMS = {
    "brute": lambda m, g, w: fstat.sw_brute(m, g, w, block=3),
    "tiled": lambda m, g, w: fstat.sw_tiled(m, g, w, tile=16),
    "one-hot": lambda m, g, w: fstat.sw_matmul(m, g, w, perm_block=4),
    "kernel plain version (ops.permanova_sw on the CPU)":
        lambda m, g, w: registry.get("brute").bound()(m, g, w),
}


@pytest.mark.parametrize("form", sorted(SENTINEL_FORMS))
@pytest.mark.parametrize("n,n_pad,g_count", [(23, 32, 3), (37, 64, 4),
                                             (9, 16, 8)])
def test_sentinel_label_weighs_zero(form, n, n_pad, g_count):
    """A zero-padded study whose pad rows carry the sentinel label G gives
    the unpadded study's s_W (the masked draws keep the pads in place and
    give the valid prefix the unpadded draws)."""
    mat2, m_pad, labels, inv_gs = _padded(n, n_pad, g_count, 11, n)
    fn = SENTINEL_FORMS[form]
    got = fn(m_pad, labels, inv_gs)
    want = fn(mat2, labels[:, :n].contiguous(), inv_gs)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-4,
                               atol=1e-5)
    assert torch.isfinite(got).all()


def test_sentinel_onehot_factor_row_is_zero():
    """The one-hot factor of a label outside [0, G) is a zero row (the
    matmul kernel matches no column for it)."""
    w = torch.tensor([0.5, 0.25, 0.125])
    e = fstat.onehot_perm_factors(torch.tensor([[0, 3, 2, -1]],
                                               dtype=torch.int32), w,
                                  torch.float32)
    assert torch.equal(e[0, 1], torch.zeros(3))
    assert torch.equal(e[0, 3], torch.zeros(3))
    assert float(e[0, 0, 0]) == float(fstat.rounded_sqrt(w, torch.float32)[0])
    assert torch.equal(fstat.label_weights(torch.tensor([2, 3, -1, 0]), w),
                       torch.tensor([0.125, 0.0, 0.0, 0.5]))


# ---------------------------------------------------------------------------
# The serving block steps against the reference's, on its masked draws.
# ---------------------------------------------------------------------------

def _pad_study(dm, g, n_pad, g_count):
    n = dm.shape[0]
    m = np.zeros((n_pad, n_pad), np.float32)
    m[:n, :n] = dm * dm
    gp = np.full((n_pad,), g_count, np.int32)
    gp[:n] = g
    return m, gp


def _ref_draws(kind, n_groups=3):
    """draws(request, lo, rows, n_pad) giving the reference server's own
    masked draws for one block: labels, labels within strata, or a dense
    design's index permutations."""
    def draws(req, lo, rows, n_pad):
        g = np.asarray(req.grouping, np.int32)
        n = g.shape[0]
        key = jax.random.key(int(req.seed))
        nv = jnp.int32(n)
        gp = np.full((n_pad,), n_groups, np.int32)
        gp[:n] = g
        if kind == "labels":
            return np.asarray(jperm.masked_permutation_batch_dyn(
                key, jnp.asarray(gp), nv, jnp.int32(lo), rows))
        st = np.zeros((n_pad,), np.int32)
        if req.strata is not None:
            st[:n] = req.strata
        stm = jperm.masked_strata(jnp.asarray(st), nv)
        if kind == "strata":
            return np.asarray(jperm.strata_label_batch_dyn(
                key, jnp.asarray(gp), stm, jnp.int32(lo), rows))
        return np.asarray(jperm.strata_permutation_batch_dyn(
            key, stm, jnp.int32(lo), rows))
    return draws


@pytest.mark.parametrize("impl", ["brute", "matmul"])
@pytest.mark.parametrize("strata", [False, True])
def test_sw_block_matches_the_reference_step(studies, impl, strata):
    dm, g = studies[0]
    n, n_pad, block = dm.shape[0], 32, 16
    st = (np.arange(n) % 3).astype(np.int32) if strata else None
    m, gp = _pad_study(dm, g, n_pad, 3)
    inv = np.array(jperm.inv_group_sizes(jnp.asarray(gp), 3))
    req = StudyRequest(grouping=g, dm=dm, seed=5, strata=st)
    draws = _ref_draws("strata" if strata else "labels")
    st_pad = None
    if strata:
        st_pad = np.zeros((n_pad,), np.int32)
        st_pad[:n] = st
    for lo in (0, 16, 48):
        want = jscheduler.sw_block(
            jnp.asarray(m), jnp.asarray(gp), jnp.int32(n), jnp.asarray(inv),
            jax.random.key(5), lo, fn=jregistry.get(impl).bound(),
            block=block,
            strata=None if st_pad is None else jnp.asarray(st_pad))
        got = scheduler.sw_block(
            torch.from_numpy(m), torch.from_numpy(gp), n,
            torch.from_numpy(inv), 5, lo, fn=registry.get(impl).bound(),
            block=block, perms=torch.from_numpy(np.array(
                draws(req, lo, block, n_pad))))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL)


def test_sw_cols_block_matches_the_reference_step(studies):
    from repro.core import design as jdesign
    dm, g = studies[2]
    n, n_pad, block = dm.shape[0], 32, 16
    cov = np.random.default_rng(3).normal(size=n)
    m, _ = _pad_study(dm, g, n_pad, 3)
    jd = jdesign.pad_design(jdesign.build(grouping=g, covariates=cov,
                                          n_groups=3, force_dense=True),
                            n_pad)
    td = design.pad_design(design.build(grouping=g, covariates=cov,
                                        n_groups=3, force_dense=True,
                                        **CPU), n_pad)
    strata = np.zeros((n_pad,), np.int32)
    req = StudyRequest(grouping=g, dm=dm, seed=2, covariates=cov)
    for lo in (0, 32):
        want = jscheduler.sw_cols_block(
            jnp.asarray(m), jd.basis, jnp.asarray(strata), jnp.int32(n),
            jax.random.key(2), lo, fn=jregistry.bound_cols("matmul"),
            block=block)
        got = scheduler.sw_cols_block(
            torch.from_numpy(m), td.basis, torch.from_numpy(strata), n, 2,
            lo, fn=registry.bound_cols("matmul"), block=block,
            index_perms=torch.from_numpy(np.array(_ref_draws("cols")(
                req, lo, block, n_pad))))
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=RTOL, atol=1e-6 * float(m.sum()))


def test_block_steps_on_own_draws_equal_the_unpadded_sweep(studies):
    """The masked block steps give a padded study the unpadded study's
    draws: the blocks of a padded study reassemble the unpadded sweep's
    s_W at the bar, bit for bit on the labels themselves."""
    dm, g = studies[1]
    n = dm.shape[0]
    m, gp = _pad_study(dm, g, 32, 3)
    inv = permutations.inv_group_sizes(torch.from_numpy(gp), 3)
    fn = registry.get("brute").bound()
    got = torch.cat([scheduler.sw_block(
        torch.from_numpy(m), torch.from_numpy(gp), n, inv, 9, lo, fn=fn,
        block=8) for lo in range(0, 40, 8)])
    mat2 = torch.from_numpy(dm * dm)
    want, _ = scheduler.sw_batch(mat2, torch.from_numpy(g), inv, 40, fn,
                                 seed=9)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6)
    labels = permutations.masked_permutation_batch(torch.from_numpy(gp), n,
                                                   0, 40, seed=9)
    assert torch.equal(labels[:, :n], permutations.permutation_batch(
        torch.from_numpy(g), 0, 40, seed=9))


# ---------------------------------------------------------------------------
# The server against the reference server, and against the port's own
# unpadded runs.
# ---------------------------------------------------------------------------

def _null_allowance(res):
    """PERF.md §2's f32 allowance on each null F (per term for a
    design)."""
    if res.terms is None or len(res.terms) == 1:
        c = (res.n_objects - res.n_groups) / (res.n_groups - 1)
        return {None: NULL_RTOL * (res.f_perms.double().abs() + c)}
    k = sum(t.df for t in res.terms) + 1
    dof = res.n_objects - k
    e = NULL_RTOL / 2 * float(res.s_t)
    return {t.name: 2.0 * e * (k * t.f_perms.double().abs() + dof)
            / float(res.s_w) for t in res.terms}


def _assert_close(res, ref):
    """F at rtol 1e-4, p equal, each null F within the f32 allowance (per
    term for a design)."""
    allow = _null_allowance(res)
    pairs = ([(res, ref)] if None in allow
             else list(zip(res.terms, ref.terms)))
    for t, u in pairs:
        name = getattr(t, "name", None) if None not in allow else None
        np.testing.assert_allclose(float(t.f_stat), float(u.f_stat),
                                   rtol=RTOL, err_msg=str(name))
        # p equal: (count + 1) / (n_perms + 1), float64 or float32
        assert (np.float32(float(t.p_value))
                == np.float32(float(u.p_value))), name
        d_null = (t.f_perms.double()
                  - torch.from_numpy(np.asarray(u.f_perms, np.float64)))
        assert bool((d_null.abs() <= allow[name]).all()), (
            name, float(d_null.abs().max()))


def _requests(studies, kind, cls):
    dm, g = studies[0]
    n = dm.shape[0]
    rng = np.random.default_rng(4)
    out = []
    for s in range(2):
        kw = dict(grouping=g, n_perms=63, seed=s)
        if kind == "strata":
            kw["strata"] = (np.arange(n) % 2).astype(np.int32)
        if kind == "cols":
            kw["covariates"] = rng.normal(size=n)
        if kind == "features":
            x = np.abs(rng.normal(size=(n, 6))).astype(np.float32)
            out.append(cls(x=x, metric="braycurtis", **kw))
        else:
            out.append(cls(dm=dm, **kw))
    return out


@pytest.mark.parametrize("kind", ["labels", "strata", "cols", "features"])
@pytest.mark.parametrize("batched", [False, True])
def test_server_matches_the_reference_server(studies, kind, batched):
    ref = jserve.PermanovaServer(workers=2, block=16).serve(
        _requests(studies, kind, jserve.StudyRequest), batched=batched)
    draws = _ref_draws({"features": "labels"}.get(kind, kind))
    got = _srv(workers=2, block=16, draws=draws).serve(
        _requests(studies, kind, StudyRequest), batched=batched)
    for a, b in zip(got, ref):
        assert a.status == b.status == "ok", (a.error, b.error)
        assert a.batched == b.batched == batched
        assert a.bucket == b.bucket
        _assert_close(a.result, b.result)


@pytest.mark.parametrize("kind", ["labels", "strata", "cols", "features"])
def test_served_equals_the_unpadded_port_run(studies, kind):
    reqs = _requests(studies, kind, StudyRequest)
    served = _srv(workers=2, block=16).serve(reqs)
    for req, res in zip(reqs, served):
        assert res.status == "ok", res.error
        kw = dict(n_perms=req.n_perms, seed=req.seed, n_groups=3, **CPU)
        if kind == "features":
            ref = pipeline.pipeline(req.x, req.grouping, metric=req.metric,
                                    **kw)
        else:
            ref = engine.run(req.dm, req.grouping, strata=req.strata,
                             covariates=req.covariates, **kw)
        _assert_close(res.result, ref)


def test_mesh_and_a_missing_card_raise():
    with pytest.raises(NotImplementedError, match="multi-device"):
        PermanovaServer(device="cpu", mesh=object())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            PermanovaServer()


# ---------------------------------------------------------------------------
# The reference's serving cases on the port.
# ---------------------------------------------------------------------------

class TestStatistics:
    def test_observed_matches_unpadded_labels(self, studies):
        dm, g = studies[0]
        res = _srv(workers=2, block=64).process(
            StudyRequest(grouping=g, dm=dm, n_perms=99))
        ref = engine.run(dm, g, n_perms=9, **CPU)
        assert float(res.result.f_stat) == pytest.approx(
            float(ref.f_stat), rel=1e-5)
        assert res.result.n_objects == dm.shape[0]

    def test_observed_matches_unpadded_dense(self, studies):
        dm, g = studies[0]
        cov = np.random.default_rng(0).normal(size=dm.shape[0])
        res = _srv(workers=2, block=64).process(
            StudyRequest(grouping=g, dm=dm, covariates=cov, n_perms=99))
        ref = engine.run(dm, g, covariates=cov, n_perms=9, **CPU)
        assert float(res.result.f_stat) == pytest.approx(
            float(ref.f_stat), rel=1e-5)
        assert [t.name for t in res.result.terms] == ["cov0", "grouping"]

    def test_strata_and_weights_modes(self, studies):
        dm, g = studies[0]
        n = dm.shape[0]
        srv = _srv(workers=2, block=32)
        strata = (np.arange(n) % 2).astype(np.int32)
        r1 = srv.process(StudyRequest(grouping=g, dm=dm, strata=strata,
                                      n_perms=63))
        assert r1.status == "ok" and "labels_strata" in r1.bucket
        w = np.linspace(0.5, 1.5, n)
        r2 = srv.process(StudyRequest(grouping=g, dm=dm, weights=w,
                                      n_perms=63))
        assert r2.status == "ok" and "cols" in r2.bucket

    def test_features_path(self):
        rng = np.random.default_rng(1)
        x = np.abs(rng.normal(size=(23, 6))).astype(np.float32)
        g = rng.integers(0, 2, size=23).astype(np.int32)
        res = _srv(workers=2, block=64).process(
            StudyRequest(grouping=g, x=x, metric="braycurtis", n_perms=49))
        assert res.status == "ok"
        ref = pipeline.pipeline(x, g, metric="braycurtis", n_perms=9, **CPU)
        assert float(res.result.f_stat) == pytest.approx(
            float(ref.f_stat), rel=1e-5)

    def test_bad_request_fails_not_raises(self, studies):
        dm, g = studies[0]
        res = _srv().process(StudyRequest(grouping=g))      # no dm, no x
        assert res.status == "failed" and "dm" in res.error


def _warm_counters():
    return {k: obs.metrics.value(k, 0.0)
            for k in (cudahooks.BUILDS, cudahooks.LOADS,
                      "serve.bucket_misses")}


class TestBuckets:
    def test_warm_bucket_builds_nothing_and_hits(self, studies):
        # different n, different n_perms, different seed — same bucket:
        # a warm server builds or loads no kernel library and misses no
        # bucket (the reference counts zero jaxpr retraces here)
        (dm1, g1), (dm2, g2), _ = studies
        obs.enable(trace=False, metrics=True)
        try:
            srv = _srv(workers=2, block=32)
            srv.process(StudyRequest(grouping=g1, dm=dm1, n_perms=31,
                                     seed=1))
            before = _warm_counters()
            r = srv.process(StudyRequest(grouping=g2, dm=dm2, n_perms=63,
                                         seed=2))
            after = _warm_counters()
        finally:
            obs.disable()
        assert r.status == "ok"
        assert after == before
        assert srv._buckets[(32, 3, "labels", 0)].hits == 2

    def test_bucket_sizing(self, studies):
        dm, g = studies[0]
        srv = _srv(workers=1, block=32, bucket_sizes=[24, 64])
        res = srv.process(StudyRequest(grouping=g, dm=dm, n_perms=15))
        assert "n=24" in res.bucket
        ref = engine.run(dm, g, n_perms=9, **CPU)
        assert float(res.result.f_stat) == pytest.approx(
            float(ref.f_stat), rel=1e-5)

    def test_plan_persisted_and_reused(self, studies, tmp_path,
                                       monkeypatch):
        dm, g = studies[0]
        monkeypatch.setenv(planner.AUTOTUNE_CACHE_ENV,
                           str(tmp_path / "tune.json"))
        planner.load_autotune_cache(reload=True)
        _srv(workers=1, block=32).process(
            StudyRequest(grouping=g, dm=dm, n_perms=15))
        key = "serveplan|cpu|n32|g3|labels|k0"
        entry = planner.measured_entry(key)
        assert entry is not None and "impl" in entry
        # a fresh server (warm restart) pins the persisted plan
        planner.load_autotune_cache(reload=True)
        res = _srv(workers=1, block=32).process(
            StudyRequest(grouping=g, dm=dm, n_perms=15))
        assert f"->{entry['impl']}" in res.bucket
        planner.load_autotune_cache(reload=True)


class TestAdmission:
    def test_bounded_queue_sheds(self, studies):
        dm, g = studies[0]
        srv = _srv(workers=1, queue_limit=2)
        reqs = [StudyRequest(grouping=g, dm=dm, n_perms=9, seed=i)
                for i in range(4)]
        out = srv.serve(reqs)
        assert [r.status for r in out] == ["ok", "ok", "shed", "shed"]
        assert all(r.request_id for r in out)

    def test_backpressure_signal_and_raise(self, studies):
        dm, g = studies[0]
        srv = _srv(workers=1, queue_limit=2)
        assert not srv.backpressure
        srv.submit(StudyRequest(grouping=g, dm=dm, n_perms=9))
        srv.submit(StudyRequest(grouping=g, dm=dm, n_perms=9))
        assert srv.backpressure
        with pytest.raises(ServerOverloaded):
            srv.submit(StudyRequest(grouping=g, dm=dm, n_perms=9),
                       shed="raise")
        assert len(srv.pump()) == 2
        assert not srv.backpressure


class TestTelemetry:
    def test_serve_step_spans_and_stats(self, studies, tmp_path):
        dm, g = studies[0]
        srv = _srv(workers=2, block=32)
        obs.clear()
        with obs.session(str(tmp_path / "serve_trace.json")):
            for i in range(4):
                srv.process(StudyRequest(grouping=g, dm=dm, n_perms=15,
                                         seed=i))
            evs = obs.events()
            stats = serve_stats_from_events(evs)
        assert stats["requests"] == 4
        assert stats["requests_per_s"] > 0
        assert stats["p99_s"] >= stats["p50_s"] > 0
        # block spans nest under the request step spans
        blocks = [e for e in evs if e["name"] == "serve.block"]
        assert blocks and all(e["args"]["parent"] == "serve.step"
                              for e in blocks)
        s = srv.stats()
        assert s["requests"] == 4 and s["p99_s"] >= s["p50_s"]
        assert s["buckets"] == 1
        assert (tmp_path / "serve_trace.json").exists()

    def test_stage1_span_of_a_features_request(self):
        rng = np.random.default_rng(1)
        x = np.abs(rng.normal(size=(20, 6))).astype(np.float32)
        g = rng.integers(0, 2, size=20).astype(np.int32)
        obs.clear()
        with obs.session():
            _srv(workers=1).process(StudyRequest(grouping=g, x=x,
                                                 n_perms=9))
            evs = obs.events()
        st = [e for e in evs if e["name"] == "serve.stage1"]
        assert len(st) == 1 and st[0]["args"]["parent"] == "serve.step"
        assert st[0]["args"]["metric"] == "braycurtis"

    def test_serving_counters(self, studies):
        dm, g = studies[0]
        obs.enable(trace=False, metrics=True)
        try:
            snap0 = obs.metrics.snapshot()
            srv = _srv(workers=1, queue_limit=1)
            srv.submit(StudyRequest(grouping=g, dm=dm, n_perms=9))
            srv.submit(StudyRequest(grouping=g, dm=dm, n_perms=9))  # shed
            srv.pump()
            d = obs.metrics.counter_delta(snap0)
        finally:
            obs.disable()
        assert d.get("serve.requests_admitted") == 1.0
        assert d.get("serve.requests_shed") == 1.0
        assert d.get("serve.requests_completed") == 1.0
        assert d.get("serve.bucket_misses") == 1.0
        assert d.get("serve.steps") == 1.0


def _same_bucket_reqs(studies, n_perms=63):
    """Six requests with mixed n (23/19/30) that all land in the n=32
    power-of-two bucket — the coalescing unit."""
    return [StudyRequest(grouping=g, dm=dm, n_perms=n_perms, seed=i)
            for i, (dm, g) in enumerate(studies * 2)]


def _same(a, b):
    return (torch.equal(a.result.f_perms, b.result.f_perms)
            and torch.equal(a.result.p_value, b.result.p_value)
            and torch.equal(a.result.f_stat, b.result.f_stat))


class TestBatched:
    def test_batched_bit_identical_to_pump(self, studies):
        serial = _srv(workers=2, block=16).serve(_same_bucket_reqs(studies))
        srv = _srv(workers=2, block=16, max_batch=8)
        batched = srv.serve(_same_bucket_reqs(studies), batched=True)
        assert [r.status for r in serial] == ["ok"] * 6
        for a, b in zip(serial, batched):
            assert b.status == "ok" and b.batched and not a.batched
            assert _same(a, b)
        assert srv._buckets[(32, 3, "labels", 0)].hits == 6

    def test_mixed_n_perms_same_bucket(self, studies):
        # blocks span the longest sweep; a shorter member computes no rows
        # past its own sweep, and its draws are unchanged
        dm, g = studies[0]

        def reqs():
            return [StudyRequest(grouping=g, dm=dm, n_perms=np_, seed=s)
                    for s, np_ in enumerate((31, 63, 15, 9))]
        serial = _srv(workers=2, block=16).serve(reqs())
        batched = _srv(workers=2, block=16).serve(reqs(), batched=True)
        for a, b in zip(serial, batched):
            assert b.status == "ok" and b.n_perms_done == a.n_perms_done
            assert _same(a, b)

    def test_batched_warm_replay_builds_nothing(self, studies):
        obs.enable(trace=False, metrics=True)
        try:
            srv = _srv(workers=2, block=16, max_batch=3)
            srv.serve(_same_bucket_reqs(studies)[:3], batched=True)
            before = _warm_counters()
            out = srv.serve(_same_bucket_reqs(studies)[3:], batched=True)
            after = _warm_counters()
        finally:
            obs.disable()
        assert [r.status for r in out] == ["ok"] * 3
        assert after == before

    def test_submit_returns_future_completed_by_pump(self, studies):
        dm, g = studies[0]
        srv = _srv(workers=1)
        fut = srv.submit(StudyRequest(grouping=g, dm=dm, n_perms=9))
        assert not fut.done()
        (res,) = srv.pump()
        assert fut.done() and fut.result() is res
        assert res.status == "ok"

    def test_async_worker_threads(self, studies):
        srv = _srv(workers=2, block=16, max_batch=4)
        srv.start(threads=2)
        try:
            futs = [srv.submit(r) for r in _same_bucket_reqs(studies)]
            out = [f.result(timeout=300) for f in futs]
        finally:
            srv.stop()
        assert [r.status for r in out] == ["ok"] * 6
        serial = _srv(workers=2, block=16).serve(_same_bucket_reqs(studies))
        for a, b in zip(serial, out):
            assert _same(a, b)

    def test_worker_threads_under_contention(self, studies):
        """More worker threads than cores and a short switch interval:
        every future completes, each request exactly once, with the
        serial result (the device work is serialised by the server's
        lock; the queue and counters by its condition)."""
        import os
        import sys
        reqs = _same_bucket_reqs(studies, n_perms=15) * 3
        serial = _srv(workers=2, block=8).serve(
            _same_bucket_reqs(studies, n_perms=15) * 3)
        old = sys.getswitchinterval()
        sys.setswitchinterval(1e-5)
        srv = _srv(workers=2, block=8, max_batch=3)
        try:
            srv.start(threads=2 * (os.cpu_count() or 1) + 1)
            threads = list(srv._threads)
            futs = [srv.submit(r) for r in reqs]
            out = [f.result(timeout=120) for f in futs]
        finally:
            srv.stop(timeout=60)
            sys.setswitchinterval(old)
        assert not any(t.is_alive() for t in threads)
        assert srv.queue_depth == 0
        assert srv.stats()["requests"] == len(reqs)
        for a, b in zip(serial, out):
            assert b.status == "ok" and _same(a, b)

    def test_batch_telemetry(self, studies):
        obs.enable(trace=True, metrics=True)
        try:
            obs.clear()
            snap0 = obs.metrics.snapshot()
            srv = _srv(workers=2, block=16, max_batch=8)
            srv.serve(_same_bucket_reqs(studies), batched=True)
            d = obs.metrics.counter_delta(snap0)
            evs = obs.events()
        finally:
            obs.disable()
            obs.clear()
        assert d.get("serve.batches", 0) >= 1
        assert d.get("serve.batched_requests") == 6.0
        hist = obs.metrics.REGISTRY.histogram("serve.batch_size")
        assert hist.count >= 1 and hist.max <= 8
        stats = serve_stats_from_events(evs)
        assert stats["requests"] == 6
        assert np.isfinite(stats["requests_per_s"])
        assert any(e["name"] == "serve.batch" for e in evs)

    @pytest.mark.parametrize("kind", ["cols", "strata"])
    def test_design_modes_batched_match_serial(self, studies, kind):
        dm, g = studies[0]
        n = dm.shape[0]
        cov = np.random.default_rng(3).normal(size=n)
        extra = ({"covariates": cov} if kind == "cols"
                 else {"strata": (np.arange(n) % 3).astype(np.int32)})

        def reqs():
            return [StudyRequest(grouping=g, dm=dm, n_perms=31, seed=s,
                                 **extra) for s in range(3)]
        serial = _srv(workers=2, block=16).serve(reqs())
        batched = _srv(workers=2, block=16).serve(reqs(), batched=True)
        for a, b in zip(serial, batched):
            assert a.status == b.status == "ok"
            assert _same(a, b) and b.batched
            for ta, tb in zip(a.result.terms or (), b.result.terms or ()):
                assert float(ta.p_value) == float(tb.p_value)


class TestBucketOverflow:
    def test_next_bucket_overflow_raises(self):
        with pytest.raises(ValueError, match="largest configured bucket"):
            _next_bucket(40, [16, 32])
        assert _next_bucket(40, None) == 64        # open-ended default
        assert _next_bucket(30, [16, 32]) == 32

    def test_process_overflow_fails_cleanly(self, studies):
        dm, g = studies[2]                         # n=30
        res = _srv(bucket_sizes=[16, 24]).process(
            StudyRequest(grouping=g, dm=dm, n_perms=9))
        assert res.status == "failed"
        assert "bucket" in res.error

    def test_submit_overflow_fails_future_pump_survives(self, studies):
        (dm_ok, g_ok), _, (dm_big, g_big) = studies   # n=23 / n=30
        srv = _srv(bucket_sizes=[24])
        f_bad = srv.submit(StudyRequest(grouping=g_big, dm=dm_big,
                                        n_perms=9))
        f_ok = srv.submit(StudyRequest(grouping=g_ok, dm=dm_ok, n_perms=9))
        assert f_bad.done()
        assert f_bad.result().status == "failed"
        assert "bucket" in f_bad.result().error
        out = srv.pump()                           # loop must not crash
        assert len(out) == 1 and out[0].status == "ok"
        assert f_ok.result().status == "ok"

    def test_batched_stream_with_overflow_member(self, studies):
        (dm_ok, g_ok), _, (dm_big, g_big) = studies
        srv = _srv(bucket_sizes=[24], max_batch=4)
        out = srv.serve([StudyRequest(grouping=g_big, dm=dm_big, n_perms=9),
                         StudyRequest(grouping=g_ok, dm=dm_ok, n_perms=9)],
                        batched=True)
        assert [r.status for r in out] == ["failed", "ok"]


class TestStatsEdgeCases:
    def test_stats_empty_window(self):
        s = _srv().stats()
        assert s["requests"] == 0 and s["requests_per_s"] == 0.0
        assert s["p50_s"] == 0.0 and s["p99_s"] == 0.0

    def test_stats_single_sample_not_inf(self, studies):
        from repro_torch.runtime.faultinject import VirtualClock
        dm, g = studies[0]
        srv = _srv(workers=1, clock=VirtualClock())
        srv.process(StudyRequest(grouping=g, dm=dm, n_perms=9))
        s = srv.stats()
        assert s["requests"] == 1
        assert np.isfinite(s["requests_per_s"])
        assert s["p50_s"] == s["p99_s"]

    def test_stats_single_sample_real_clock(self, studies):
        dm, g = studies[0]
        srv = _srv(workers=1)
        srv.process(StudyRequest(grouping=g, dm=dm, n_perms=9))
        s = srv.stats()
        assert np.isfinite(s["requests_per_s"])
        assert s["requests_per_s"] > 0.0

    def test_event_stats_empty_and_tiny_windows(self):
        assert serve_stats_from_events([]) == {
            "requests": 0, "requests_per_s": 0.0,
            "p50_s": 0.0, "p99_s": 0.0}
        one = [{"name": "serve.step", "ph": "X", "ts": 5.0, "dur": 2.0}]
        s = serve_stats_from_events(one)
        assert s["requests"] == 1 and np.isfinite(s["requests_per_s"])
        assert s["p50_s"] == s["p99_s"] == pytest.approx(2.0 / 1e6)
        zero = [{"name": "serve.step", "ph": "X", "ts": 5.0, "dur": 0.0}]
        s = serve_stats_from_events(zero)
        assert s["requests"] == 1 and s["requests_per_s"] == 0.0
