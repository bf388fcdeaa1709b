"""Deterministic chaos suite for the port's always-on PERMANOVA server
(the reference's `tests/test_chaos.py` on repro_torch, on the CPU).

Every injected fault — worker death, stragglers, dropped heartbeats
(zombies), simulated OOM, full fleet loss, server restart, corrupted plan
cache — must converge to the SAME F statistic and permutation set as the
failure-free serving run, bit for bit: recovery is recomputation of
blocks whose draws are keyed by their global permutation index, never
approximate reconciliation. All chaos is seeded and applied against a
virtual clock, so any failure replays exactly.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

# Plans follow the planner's rules, never a winner persisted in the
# host's default autotune cache (the reference's conftest turns its
# own off); tests of the cache point it at files of their own.
os.environ.setdefault("REPRO_TORCH_AUTOTUNE_CACHE", "off")

from repro_torch.core.distance import distance_matrix  # noqa: E402
from repro_torch.engine import planner  # noqa: E402
from repro_torch.runtime.elastic import (AllWorkersDead,  # noqa: E402
                                         ElasticBlockExecutor)
from repro_torch.runtime.faultinject import (FaultInjector,  # noqa: E402
                                             VirtualClock)
from repro_torch.serve import permanova as serve_mod  # noqa: E402
from repro_torch.serve.permanova import (RetryPolicy,  # noqa: E402
                                         StudyRequest, mc_pvalue_ci)


def PermanovaServer(**kw):
    return serve_mod.PermanovaServer(device="cpu", **kw)


@pytest.fixture(scope="module", autouse=True)
def _autotune_cache(tmp_path_factory):
    """Serving persists `serveplan|` entries: never in the default file."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv(planner.AUTOTUNE_CACHE_ENV,
                  str(tmp_path_factory.mktemp("tune") / "autotune.json"))
        yield
    planner.load_autotune_cache(reload=True)


@pytest.fixture(scope="module")
def study():
    rng = np.random.default_rng(42)
    x = rng.normal(size=(23, 6)).astype(np.float32)
    g = rng.integers(0, 3, size=23).astype(np.int32)
    dm = distance_matrix(torch.from_numpy(x), "euclidean").numpy()
    return dm, g


def _serve(study, injector=None, *, workers=3, block=16, n_perms=127,
           seed=0, **kw):
    dm, g = study
    srv = PermanovaServer(workers=workers, block=block,
                          clock=VirtualClock(), injector=injector, **kw)
    return srv.process(StudyRequest(grouping=g, dm=dm, n_perms=n_perms,
                                    seed=seed))


@pytest.fixture(scope="module")
def clean(study):
    """The failure-free serving run every chaos case must reproduce."""
    return _serve(study)


def _assert_identical(res, clean):
    assert res.status == "ok"
    assert torch.equal(res.result.f_stat, clean.result.f_stat)
    assert torch.equal(res.result.p_value, clean.result.p_value)
    assert torch.equal(res.result.f_perms, clean.result.f_perms)


class TestFaultConvergence:
    def test_kill_one_worker(self, study, clean):
        inj = FaultInjector(seed=1).kill_worker_after_blocks(0, 1)
        res = _serve(study, inj)
        _assert_identical(res, clean)
        assert any("kill worker=0" in h for h in res.report.history)

    def test_kill_majority_of_fleet(self, study, clean):
        inj = (FaultInjector(seed=2)
               .kill_worker_after_blocks(0, 0)
               .kill_worker_after_blocks(2, 1))
        res = _serve(study, inj)
        _assert_identical(res, clean)

    def test_straggler_speculation(self, study, clean):
        # worker 1 takes 50x the others' block time: past the straggler
        # factor its blocks are speculatively recomputed elsewhere and
        # the duplicate completions must agree bit-for-bit (asserted
        # inside the executor; a mismatch raises).
        inj = (FaultInjector(seed=3)
               .delay_block(None, 0.01).delay_block(1, 0.5))
        res = _serve(study, inj)
        _assert_identical(res, clean)
        assert res.report.speculative >= 1

    def test_dropped_heartbeats_zombie_fenced(self, study, clean):
        # worker 0's beats are lost long enough for the monitor to
        # declare it dead while it computed a block: the late report
        # carries a stale incarnation, is rejected, and the block is
        # recomputed bit-identically (the zombie's value is checked
        # against the committed one inside the executor).
        inj = (FaultInjector(seed=4)
               .delay_block(None, 2.0)          # clock moves; timeout=5
               .drop_heartbeats(0, 12))
        res = _serve(study, inj)
        _assert_identical(res, clean)
        assert 0 in res.report.workers_died
        assert res.report.recomputed + res.report.stale_beats_rejected >= 1

    def test_simulated_oom_retried(self, study, clean):
        # block 0 OOMs once on EVERY worker (specs are (worker, block)
        # keyed, so at least the first two attempts fail under any
        # round-robin routing): jittered backoff + requeue each time,
        # then success within the block-level retry budget.
        inj = FaultInjector(seed=5)
        for w in range(3):
            inj.oom_at_block(w, 0)
        res = _serve(study, inj)
        _assert_identical(res, clean)
        assert res.report.transient_failures >= 2

    def test_seeded_random_chaos(self, study, clean):
        # a different storm per seed, all replayable: each must converge
        for seed in range(5):
            rng = np.random.default_rng(seed)
            inj = FaultInjector(seed=seed)
            inj.delay_block(None, float(rng.uniform(0.01, 0.1)))
            if rng.random() < 0.8:
                inj.kill_worker_after_blocks(int(rng.integers(0, 3)),
                                             int(rng.integers(0, 3)))
            if rng.random() < 0.8:
                inj.drop_heartbeats(int(rng.integers(0, 3)),
                                    int(rng.integers(1, 8)))
            if rng.random() < 0.8:
                inj.oom_at_block(int(rng.integers(0, 3)),
                                 int(rng.integers(0, 8)))
            res = _serve(study, inj)
            _assert_identical(res, clean)


class TestRequestRetries:
    def test_fleet_loss_restarts_and_recovers(self, study, clean):
        # every worker dies before finishing: attempt 1 raises
        # AllWorkersDead; the jittered-backoff retry restarts a fresh
        # fleet (kill declarations are consumed) and must reproduce the
        # failure-free result exactly.
        inj = FaultInjector(seed=6)
        for w in range(3):
            inj.kill_worker_after_blocks(w, 0)
        res = _serve(study, inj)
        _assert_identical(res, clean)
        assert res.retries == 1

    def test_oom_escalates_to_request_retry(self, study, clean):
        # the same block OOMs on every worker more times than the
        # block-level retry budget: SimulatedOOM escapes the executor,
        # the request retries with a fresh fleet and drains the fault.
        inj = FaultInjector(seed=7)
        for w in range(3):
            inj.oom_at_block(w, 0, times=2)
        res = _serve(study, inj, max_transient_retries=2)
        _assert_identical(res, clean)
        assert res.retries >= 1

    def test_retry_exhaustion_fails_cleanly(self, study):
        dm, g = study
        inj = FaultInjector(seed=8)
        for w in range(2):
            inj.kill_worker_after_blocks(w, 0)
        srv = PermanovaServer(workers=2, block=16, clock=VirtualClock(),
                              injector=inj,
                              retry=RetryPolicy(max_retries=0))
        res = srv.process(StudyRequest(grouping=g, dm=dm, n_perms=63))
        assert res.status == "failed"
        assert not res.ok
        assert "AllWorkersDead" in res.error


class TestDeadlineDegradation:
    def test_degraded_ci_contains_full_p(self, study):
        dm, g = study
        inj = FaultInjector(seed=9).delay_block(None, 0.2)
        srv = PermanovaServer(workers=2, block=16, clock=VirtualClock(),
                              injector=inj)
        res = srv.process(StudyRequest(grouping=g, dm=dm, n_perms=255,
                                       seed=0, deadline_s=1.0))
        assert res.status == "degraded" and res.degraded
        assert 0 < res.n_perms_done < 255
        assert res.result.method.endswith("+degraded")

        full = PermanovaServer(workers=2, block=16).process(
            StudyRequest(grouping=g, dm=dm, n_perms=255, seed=0))
        # the degraded null is a PREFIX of the full run's (same stream)
        m = res.n_perms_done
        assert torch.equal(res.result.f_perms, full.result.f_perms[: m + 1])
        # and the attached 95% Monte-Carlo CI covers the p-value the
        # full-n_perms run reports (deterministic for this seed)
        lo, hi = res.p_ci
        assert lo <= float(full.result.p_value) <= hi
        assert lo <= float(res.result.p_value) <= hi

    def test_deadline_before_observed_fails(self, study):
        dm, g = study
        inj = FaultInjector(seed=10).delay_block(None, 1.0)
        srv = PermanovaServer(workers=2, block=16, clock=VirtualClock(),
                              injector=inj)
        res = srv.process(StudyRequest(grouping=g, dm=dm, n_perms=63,
                                       deadline_s=0.0))
        assert res.status == "failed"
        assert "observed" in res.error

    def test_mc_pvalue_ci_properties(self):
        lo, hi = mc_pvalue_ci(10, 50, 999)
        assert 0.0 < lo <= hi < 1.0
        # finished sweep: degenerate point interval at the exact p
        lo, hi = mc_pvalue_ci(42, 255, 255)
        assert lo == hi == pytest.approx(43.0 / 256.0)
        # extremes stay inside (0, 1]
        lo0, hi0 = mc_pvalue_ci(0, 20, 999)
        assert lo0 >= 1.0 / 1000.0 and hi0 < 1.0
        lom, him = mc_pvalue_ci(20, 20, 999)
        assert him <= 1.0 and lom > 0.5


class TestRestartResume:
    def test_server_restart_finishes_in_flight_request(self, study,
                                                       tmp_path):
        dm, g = study
        full = PermanovaServer(workers=2, block=16).process(
            StudyRequest(grouping=g, dm=dm, n_perms=255, seed=0))

        # phase 1: deadline kills the request mid-flight; partial s_W
        # accumulators are checkpointed through checkpoint/manager.py
        inj = FaultInjector(seed=11).delay_block(None, 0.2)
        srv1 = PermanovaServer(workers=2, block=16, clock=VirtualClock(),
                               injector=inj, ckpt_dir=tmp_path,
                               checkpoint_every=2)
        r1 = srv1.process(StudyRequest(grouping=g, dm=dm, n_perms=255,
                                       seed=0, deadline_s=1.0,
                                       request_id="restart-me"))
        assert r1.status == "degraded"
        assert (tmp_path / "restart-me").exists()

        # phase 2: a NEW server (fresh process stand-in) resumes from the
        # checkpoint — only the missing blocks run, and the end state is
        # bit-identical to the uninterrupted run
        srv2 = PermanovaServer(workers=2, block=16, ckpt_dir=tmp_path)
        r2 = srv2.process(StudyRequest(grouping=g, dm=dm, n_perms=255,
                                       seed=0, request_id="restart-me"))
        assert r2.status == "ok"
        assert r2.report.committed < r2.report.n_blocks
        assert torch.equal(r2.result.f_perms, full.result.f_perms)
        # finished request's checkpoint state is cleaned up
        assert not (tmp_path / "restart-me").exists()

    def test_mismatched_checkpoint_ignored(self, study, tmp_path):
        # a checkpoint from a DIFFERENT request config (other seed) must
        # not be resumed into this request
        dm, g = study
        inj = FaultInjector(seed=12).delay_block(None, 0.2)
        srv1 = PermanovaServer(workers=2, block=16, clock=VirtualClock(),
                               injector=inj, ckpt_dir=tmp_path,
                               checkpoint_every=1)
        srv1.process(StudyRequest(grouping=g, dm=dm, n_perms=255, seed=5,
                                  deadline_s=1.0, request_id="shared-id"))
        srv2 = PermanovaServer(workers=2, block=16, ckpt_dir=tmp_path)
        r = srv2.process(StudyRequest(grouping=g, dm=dm, n_perms=255,
                                      seed=0, request_id="shared-id"))
        assert r.status == "ok"
        assert r.report.committed == r.report.n_blocks   # full recompute
        full = PermanovaServer(workers=2, block=16).process(
            StudyRequest(grouping=g, dm=dm, n_perms=255, seed=0))
        assert torch.equal(r.result.f_perms, full.result.f_perms)


class TestCorruptPlanCache:
    def test_corrupt_cache_entry_degrades_to_heuristic(self, study,
                                                       tmp_path,
                                                       monkeypatch, clean):
        # chaos case 'corrupt-cache-entry': a served request persists its
        # bucket plan; the cache file is then truncated mid-document (as
        # a crash mid-write would). A fresh server must quarantine the
        # corrupt file, fall back to the plan heuristic, and serve
        # bit-identical results.
        path = tmp_path / "autotune.json"
        monkeypatch.setenv(planner.AUTOTUNE_CACHE_ENV, str(path))
        planner.load_autotune_cache(reload=True)
        res1 = _serve(study)
        _assert_identical(res1, clean)
        assert path.exists()

        FaultInjector.corrupt_cache_file(str(path))
        planner._WARNED.discard("corrupt")
        planner.load_autotune_cache(reload=True)
        res2 = _serve(study)
        _assert_identical(res2, clean)
        assert path.with_suffix(".json.corrupt").exists()
        planner.load_autotune_cache(reload=True)


def _batch_reqs(study, *, n_perms=127, deadline_idx=None,
                deadline_s=None):
    """Four same-bucket requests with distinct seeds (the coalescing
    unit for the batched chaos cases)."""
    dm, g = study
    out = []
    for s in range(4):
        r = StudyRequest(grouping=g, dm=dm, n_perms=n_perms, seed=s,
                         request_id=f"b{s}")
        if deadline_idx == s:
            r.deadline_s = deadline_s
        out.append(r)
    return out


class TestBatchedChaos:
    @pytest.fixture(scope="class")
    def clean_batch(self, study):
        """Failure-free SERIAL results — the reference every batched and
        faulted run must reproduce bit-for-bit."""
        srv = PermanovaServer(workers=3, block=16, clock=VirtualClock())
        return srv.serve(_batch_reqs(study))

    def test_batched_matches_serial(self, study, clean_batch):
        srv = PermanovaServer(workers=3, block=16, clock=VirtualClock())
        out = srv.serve(_batch_reqs(study), batched=True)
        for a, c in zip(out, clean_batch):
            assert a.batched
            _assert_identical(a, c)

    def test_batched_survives_worker_death(self, study, clean_batch):
        inj = FaultInjector(seed=21).kill_worker_after_blocks(0, 1)
        srv = PermanovaServer(workers=3, block=16, clock=VirtualClock(),
                              injector=inj)
        out = srv.serve(_batch_reqs(study), batched=True)
        for a, c in zip(out, clean_batch):
            _assert_identical(a, c)
        assert any(any("kill worker=0" in h for h in a.report.history)
                   for a in out)

    def test_batched_survives_fleet_loss_via_retry(self, study,
                                                   clean_batch):
        inj = FaultInjector(seed=22)
        for w in range(3):
            inj.kill_worker_after_blocks(w, 0)
        srv = PermanovaServer(workers=3, block=16, clock=VirtualClock(),
                              injector=inj)
        out = srv.serve(_batch_reqs(study), batched=True)
        for a, c in zip(out, clean_batch):
            _assert_identical(a, c)
        assert all(a.retries >= 1 for a in out)

    def test_batched_deadline_degrades_one_member(self, study,
                                                  clean_batch):
        # one member carries a deadline; it degrades while the other
        # three finish exactly — then idle-capacity resume pushes the
        # EXACT result to the degraded caller's `final` future.
        inj = FaultInjector(seed=23).delay_block(None, 0.2)
        srv = PermanovaServer(workers=3, block=16, clock=VirtualClock(),
                              injector=inj)
        out = srv.serve(_batch_reqs(study, deadline_idx=1, deadline_s=1.0),
                        batched=True)
        assert [r.status for r in out] == ["ok", "degraded", "ok", "ok"]
        for i in (0, 2, 3):
            _assert_identical(out[i], clean_batch[i])
        deg = out[1]
        assert 0 < deg.n_perms_done < 127 and deg.p_ci is not None
        # degraded null is a prefix of the clean full null (same stream)
        m = deg.n_perms_done
        assert torch.equal(deg.result.f_perms,
                           clean_batch[1].result.f_perms[: m + 1])
        lo, hi = deg.p_ci
        assert lo <= float(clean_batch[1].result.p_value) <= hi
        # opportunistic resume: the permutation tail completes exactly
        assert deg.final is not None and srv.resume_backlog == 1
        (exact,) = srv.resume_degraded()
        _assert_identical(exact, clean_batch[1])
        assert exact.n_perms_done == 127
        assert deg.final.done() and deg.final.result() is exact

    def test_serial_degraded_resume_exact(self, study, clean):
        # the serial path gets the same opportunistic-resume contract
        inj = FaultInjector(seed=24).delay_block(None, 0.2)
        dm, g = study
        srv = PermanovaServer(workers=3, block=16, clock=VirtualClock(),
                              injector=inj)
        res = srv.process(StudyRequest(grouping=g, dm=dm, n_perms=127,
                                       seed=0, deadline_s=1.0))
        assert res.status == "degraded" and res.final is not None
        (exact,) = srv.resume_degraded()
        _assert_identical(exact, clean)
        assert res.final.result() is exact


class TestBucketDriftRestart:
    def test_restart_with_changed_buckets_recomputes(self, study,
                                                     tmp_path):
        from repro_torch import obs
        dm, g = study
        # phase 1: bucket_sizes=[32] — deadline kills the request
        # mid-flight, partial s_W checkpointed under n_pad=32
        inj = FaultInjector(seed=31).delay_block(None, 0.2)
        srv1 = PermanovaServer(workers=2, block=16, bucket_sizes=[32],
                               clock=VirtualClock(), injector=inj,
                               ckpt_dir=tmp_path, checkpoint_every=2)
        r1 = srv1.process(StudyRequest(grouping=g, dm=dm, n_perms=255,
                                       seed=0, deadline_s=1.0,
                                       request_id="drift-me"))
        assert r1.status == "degraded"
        assert (tmp_path / "drift-me").exists()

        # phase 2: restart with bucket_sizes=[24] — the bucket changed,
        # and with it the kernels' summation order, so the checkpointed
        # s_W is NOT resumed; the server must ignore it (counter, no
        # crash) and recompute
        obs.enable(trace=False, metrics=True)
        try:
            snap0 = obs.metrics.snapshot()
            srv2 = PermanovaServer(workers=2, block=16, bucket_sizes=[24],
                                   ckpt_dir=tmp_path)
            r2 = srv2.process(StudyRequest(grouping=g, dm=dm, n_perms=255,
                                           seed=0, request_id="drift-me"))
            d = obs.metrics.counter_delta(snap0)
        finally:
            obs.disable()
        assert r2.status == "ok"
        assert d.get("serve.ckpt_bucket_drift", 0) >= 1.0
        assert not d.get("serve.resumed_requests")
        assert r2.report.committed == r2.report.n_blocks  # full recompute
        clean24 = PermanovaServer(workers=2, block=16,
                                  bucket_sizes=[24]).process(
            StudyRequest(grouping=g, dm=dm, n_perms=255, seed=0))
        assert torch.equal(r2.result.f_perms, clean24.result.f_perms)

    def test_same_buckets_still_resume(self, study, tmp_path):
        # control: identical bucket_sizes across the restart DOES resume
        dm, g = study
        inj = FaultInjector(seed=32).delay_block(None, 0.2)
        srv1 = PermanovaServer(workers=2, block=16, bucket_sizes=[32],
                               clock=VirtualClock(), injector=inj,
                               ckpt_dir=tmp_path, checkpoint_every=2)
        r1 = srv1.process(StudyRequest(grouping=g, dm=dm, n_perms=255,
                                       seed=0, deadline_s=1.0,
                                       request_id="stay-me"))
        assert r1.status == "degraded"
        srv2 = PermanovaServer(workers=2, block=16, bucket_sizes=[32],
                               ckpt_dir=tmp_path)
        r2 = srv2.process(StudyRequest(grouping=g, dm=dm, n_perms=255,
                                       seed=0, request_id="stay-me"))
        assert r2.status == "ok"
        assert r2.report.committed < r2.report.n_blocks   # real resume


class TestDegradedCiExtremes:
    """Satellite: the beta-binomial predictive CI must stay clamped and
    ordered at the extremes (0 hits / all hits) on BOTH quantile paths,
    and always bracket the degraded point estimate (k+1)/(m+1)."""

    def _paths(self):
        paths = [False]            # normal-approx fallback, always on
        try:
            import scipy.stats  # noqa: F401
            paths.append(True)
        except ImportError:
            pass
        return paths

    def _check(self, k, m, n_full, use_scipy):
        lo, hi = mc_pvalue_ci(k, m, n_full, use_scipy=use_scipy)
        p_hat = (k + 1.0) / (m + 1.0)
        assert lo <= hi, (k, m, n_full, use_scipy)
        assert lo <= p_hat <= hi, (k, m, n_full, use_scipy, lo, hi)
        assert lo >= 1.0 / (n_full + 1.0)
        assert hi <= 1.0

    def test_extremes_both_paths(self):
        for use_scipy in self._paths():
            for m, n_full in [(1, 999), (10, 999), (255, 999), (1, 2),
                              (50, 51)]:
                self._check(0, m, n_full, use_scipy)     # zero hits
                self._check(m, m, n_full, use_scipy)     # all hits
            self._check(0, 1, 10 ** 6, use_scipy)        # tiny m, huge n

    def test_property_lo_p_hi(self):
        try:
            from hypothesis import given, settings
            from hypothesis import strategies as st
        except ImportError:
            rng = np.random.default_rng(0)
            for _ in range(300):
                n_full = int(rng.integers(1, 10000))
                m = int(rng.integers(0, n_full + 1))
                k = int(rng.integers(0, m + 1))
                for use_scipy in self._paths():
                    self._check(k, m, n_full, use_scipy)
            return

        paths = self._paths()

        @settings(max_examples=200, deadline=None)
        @given(data=st.data(), n_full=st.integers(1, 10000))
        def prop(data, n_full):
            m = data.draw(st.integers(0, n_full))
            k = data.draw(st.integers(0, m))
            for use_scipy in paths:
                self._check(k, m, n_full, use_scipy)

        prop()


def _sum_blocks(lo, hi):
    """Deterministic stand-in for an s_W block: value = f(global index)."""
    return np.sqrt(np.arange(lo, hi, dtype=np.float32) + 1.0)


class TestKillPointProperty:
    """Property: killing ANY worker at ANY block boundary (under any
    speculative-duplicate completion order the executor produces) yields
    s_W partials bit-identical to the single-worker run. Uses Hypothesis
    when installed; otherwise sweeps the full (worker, kill point, fleet)
    grid — the domain is small enough to enumerate."""

    N_BLOCKS = 7

    def _reference(self):
        exe = ElasticBlockExecutor(self.N_BLOCKS, workers=1,
                                   clock=VirtualClock())
        out, done, _ = exe.run(_sum_blocks,
                               [(i * 4, i * 4 + 4)
                                for i in range(self.N_BLOCKS)])
        assert done.all()
        return out

    def _run_case(self, n_workers, victim, kill_at, delay_victim):
        ref = self._reference()
        inj = FaultInjector(seed=0)
        inj.kill_worker_after_blocks(victim, kill_at)
        if delay_victim:        # also make the victim a straggler first
            inj.delay_block(None, 0.01).delay_block(victim, 0.2)
        exe = ElasticBlockExecutor(self.N_BLOCKS, workers=n_workers,
                                   clock=VirtualClock(), injector=inj)
        try:
            out, done, rep = exe.run(
                _sum_blocks, [(i * 4, i * 4 + 4)
                              for i in range(self.N_BLOCKS)])
        except AllWorkersDead:
            assert n_workers == 1    # only a lone fleet can fully die
            return
        assert done.all()
        np.testing.assert_array_equal(out, ref)

    def test_kill_anywhere_bit_identical(self):
        try:
            from hypothesis import given, settings
            from hypothesis import strategies as st
        except ImportError:
            for n_workers in (2, 3, 4):
                for victim in range(n_workers):
                    for kill_at in range(self.N_BLOCKS + 1):
                        for delay in (False, True):
                            self._run_case(n_workers, victim, kill_at,
                                           delay)
            return

        @settings(max_examples=120, deadline=None)
        @given(n_workers=st.integers(2, 4),
               victim=st.integers(0, 3),
               kill_at=st.integers(0, self.N_BLOCKS + 1),
               delay=st.booleans())
        def prop(n_workers, victim, kill_at, delay):
            self._run_case(n_workers, victim % n_workers, kill_at, delay)

        prop()
