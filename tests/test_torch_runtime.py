"""The port's fault-tolerant runtime (repro_torch.runtime): heartbeats,
incarnation fencing and the elastic permutation runner, as the reference's
`tests/test_runtime.py` holds them (its trainer case belongs to the LM
scaffold). The blocks are the port's s_W on its own label draws, so
recovery, rescaling and straggler re-dispatch must reproduce the clean
run bit for bit."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import fstat, permutations  # noqa: E402
from repro_torch.runtime import (ElasticPermutationRunner,  # noqa: E402
                                 HeartbeatMonitor)


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


class TestHeartbeat:
    def test_failure_detection_and_recovery(self):
        clock = FakeClock()
        mon = HeartbeatMonitor(4, timeout=5.0, clock=clock)
        dead, recovered = [], []
        mon.on_failure.append(dead.append)
        mon.on_recovery.append(recovered.append)

        clock.t = 3.0
        for w in (0, 1, 2):
            mon.beat(w)
        clock.t = 6.0
        assert mon.check() == [3]
        assert mon.alive_workers == [0, 1, 2]
        mon.beat(3)
        assert recovered == [3]
        assert 3 in mon.alive_workers
        assert dead == [3]


def _block_fn(mat2, grouping, inv_gs, seed=0):
    mat2 = torch.from_numpy(np.array(mat2))
    g = torch.from_numpy(np.array(grouping))
    w = torch.from_numpy(np.array(inv_gs))

    def compute(worker_id, lo, hi):
        # worker identity must NOT matter: the draws are keyed by the
        # global permutation index
        perms = permutations.permutation_batch(g, lo, hi, seed=seed)
        return fstat.sw_brute(mat2, perms, w).double().numpy()

    return compute


class TestElasticRunner:
    def test_failure_recovery_is_bit_identical(self, small_study):
        _, grouping, inv_gs, mat2 = small_study
        fn = _block_fn(mat2, grouping, inv_gs)

        clean = ElasticPermutationRunner(64, block_size=16)
        ref = clean.run(fn, workers=[0, 1, 2, 3])

        faulty = ElasticPermutationRunner(64, block_size=16)
        got = faulty.run(fn, workers=[0, 1, 2, 3], fail_at={1: 0})
        np.testing.assert_array_equal(ref, got)
        assert any("fail" in h for h in faulty.history)

    def test_elastic_scale_down_and_up(self, small_study):
        _, grouping, inv_gs, mat2 = small_study
        fn = _block_fn(mat2, grouping, inv_gs)
        two = ElasticPermutationRunner(48, block_size=8).run(
            fn, workers=[0, 1])
        eight = ElasticPermutationRunner(48, block_size=8).run(
            fn, workers=list(range(8)))
        np.testing.assert_array_equal(two, eight)

    def test_straggler_redispatch(self, small_study):
        _, grouping, inv_gs, mat2 = small_study
        fn = _block_fn(mat2, grouping, inv_gs)
        r = ElasticPermutationRunner(48, block_size=8,
                                     straggler_factor=0.5)
        got = r.run(fn, workers=[0, 1], slow_workers={1: 100.0})
        clean = ElasticPermutationRunner(48, block_size=8).run(
            fn, workers=[0])
        np.testing.assert_array_equal(got, clean)
        assert any("straggler" in h for h in r.history)

    def test_blocks_equal_one_sweep(self, small_study):
        """The runner's blocks reassemble the one-shot sweep of the same
        draws: a block is a pure function of its index range."""
        _, grouping, inv_gs, mat2 = small_study
        fn = _block_fn(mat2, grouping, inv_gs, seed=3)
        got = ElasticPermutationRunner(40, block_size=7).run(
            fn, workers=[0, 1, 2])
        np.testing.assert_array_equal(got, fn(0, 0, 40))


class TestIncarnationFencing:
    """Recovery/zombie semantics of the heartbeat monitor: incarnations
    bump on every dead->alive transition and on fence(); stale beats are
    rejected without refreshing liveness; on_recovery fires exactly once
    per transition."""

    def _mon(self):
        clock = FakeClock()
        mon = HeartbeatMonitor(2, timeout=5.0, clock=clock)
        events = {"dead": [], "recovered": []}
        mon.on_failure.append(events["dead"].append)
        mon.on_recovery.append(events["recovered"].append)
        return clock, mon, events

    def test_recovery_bumps_incarnation_and_fires_once(self):
        clock, mon, ev = self._mon()
        assert mon.incarnation(0) == 0
        clock.t = 6.0
        assert mon.check() == [0, 1]
        mon.beat(0)                      # rejoin
        assert ev["recovered"] == [0]
        assert mon.incarnation(0) == 1   # new incarnation
        mon.beat(0)                      # steady-state beat: no re-fire,
        mon.beat(0, incarnation=1)       # no extra bump
        assert ev["recovered"] == [0]
        assert mon.incarnation(0) == 1

    def test_stale_incarnation_rejected_no_liveness_refresh(self):
        clock, mon, ev = self._mon()
        clock.t = 3.0
        mon.beat(0, incarnation=0)
        fenced = mon.fence(0)            # re-dispatch invalidates inc 0
        assert fenced == 1
        clock.t = 4.0
        assert mon.beat(0, incarnation=0) is False
        assert mon.workers[0].stale_beats == 1
        assert mon.workers[0].last_beat == 3.0
        assert mon.beat(0, incarnation=1) is True
        assert mon.workers[0].last_beat == 4.0

    def test_zombie_cannot_double_report_after_recovery(self):
        clock, mon, ev = self._mon()
        clock.t = 6.0
        mon.check()                      # 0 and 1 die
        mon.fence(0)                     # scheduler re-dispatches 0's work
        mon.beat(0)                      # genuine rejoin: alive again...
        assert ev["recovered"] == [0]
        inc = mon.incarnation(0)
        assert inc == 2                  # fence bump + recovery bump
        # ...but its PRE-DEATH incarnation stays fenced
        assert mon.beat(0, incarnation=0) is False
        assert mon.beat(0, incarnation=inc) is True

    def test_unclaimed_beat_is_always_a_rejoin(self):
        clock, mon, ev = self._mon()
        clock.t = 6.0
        mon.check()
        mon.fence(1)
        assert mon.beat(1) is True
        assert ev["recovered"] == [1]

    def test_fleet_snapshot_merges_worker_beats(self):
        clock, mon, _ = self._mon()
        mon.beat(0, snapshot={"counters": {"blocks": 3.0},
                              "gauges": {"mem": 10.0}})
        mon.beat(1, snapshot={"counters": {"blocks": 4.0},
                              "gauges": {"mem": 7.0}})
        merged = mon.fleet_snapshot()
        assert merged["counters"]["blocks"] == 7.0   # counters sum
        assert merged["gauges"]["mem"] == 10.0       # gauges max


def test_runtime_imports_no_jax_or_reference():
    """The runtime, checkpoint and serving modules import torch, numpy and
    the port only: neither jax, ml_dtypes nor the reference package."""
    import subprocess
    import sys
    code = ("import sys; import repro_torch.runtime, repro_torch.checkpoint,"
            " repro_torch.serve, repro_torch.launch.serve;"
            " bad = sorted(m for m in sys.modules if m.split('.')[0] in"
            " ('jax', 'jaxlib', 'ml_dtypes', 'repro'));"
            " print(bad); sys.exit(1 if bad else 0)")
    import os
    env = dict(os.environ)
    src = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "src")
    env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
