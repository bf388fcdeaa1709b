"""The port's telemetry (repro_torch.obs) against the reference's
(repro.obs).

First the reference's own obs tests held against the port's obs: span
nesting and the Chrome export, the stage table, sessions, the disabled
mode (the shared no-op span; no allocation, no event, no counter, no
device sync), counters and snapshot merging, the ring buffer, budgets
and the report. Then parity: the same numpy inputs, with the reference's
draws fed to the port (`perms=` / `index_perms=`), through the reference
on JAX CPU and through the port with `device="cpu"`; for every path the
multiset of span (name, parent, depth) and the shared counters must be
equal, and the predicted traffic of every span (and
`pipeline.predicted_bytes`) equal at rtol 1e-12, apart from the
divergences each case names with its reason. F and p keep their bar
(rtol 1e-4, p equal). Last, the card's traffic models against counts
worked out by enumerating each kernel's copies at small shapes, the build
hook with a stub nvcc, and the CLI's --trace / --metrics.
"""

import collections
import json
import os
import stat
import tracemalloc
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

# Plans follow the planner's rules, never a winner persisted in the
# host's default autotune cache (the reference's conftest turns its
# own off); tests of the cache point it at files of their own.
os.environ.setdefault("REPRO_TORCH_AUTOTUNE_CACHE", "off")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import engine as jengine  # noqa: E402
from repro import obs as jobs  # noqa: E402
from repro import pipeline as jpipe  # noqa: E402
from repro.core import permutations as jperm  # noqa: E402
from repro.data import slabcache as jslabcache  # noqa: E402
from repro.engine import planner as jeplanner  # noqa: E402
from repro_torch import engine, hw, obs, pipeline  # noqa: E402
from repro_torch.core import design as design_mod  # noqa: E402
from repro_torch.data import slabcache  # noqa: E402
from repro_torch.engine import api as eapi  # noqa: E402
from repro_torch.engine import planner as eplanner  # noqa: E402
from repro_torch.kernels import _build, tile_visit_elems  # noqa: E402
from repro_torch.kernels.distance import ops as dops  # noqa: E402
from repro_torch.kernels.fused_sw import ops as fops  # noqa: E402
from repro_torch.kernels.permanova_sw import ops as swops  # noqa: E402
from repro_torch.launch import permanova as cli  # noqa: E402
from repro_torch.obs import cudahooks  # noqa: E402

N, D, G = 61, 16, 4
PERMS = 39
N_TOTAL = PERMS + 1
ROW_BLOCK = 16          # 61 = 3 x 16 + 13: a ragged last slab
CHUNK = 16              # 40 = 2 x 16 + 8: a ragged last chunk
SLAB = 23               # out of core: 61 = 2 x 23 + 15
HOST = 1024             # a device budget below the table: 'host'
RTOL = 1e-4
BYTES_RTOL = 1e-12
SHARED = ("engine.perm_chunks", "pipeline.mat2_bytes_built",
          "fused.row_slabs", "fused.chunk_steps", "prefetch.slabs",
          "prefetch.bytes", "engine.studies", "autotune.cache.hit",
          "autotune.cache.miss", "autotune.cache.stale_dropped",
          "autotune.cache.corrupt_quarantined", "autotune.measured")


@pytest.fixture(autouse=True)
def _clean_obs(tmp_path, monkeypatch):
    """Every test starts and ends with both packages' telemetry off and
    their buffers empty; each autotune cache is a file of the test's own
    (so the cache counters see a fresh file)."""
    monkeypatch.setenv(eplanner.AUTOTUNE_CACHE_ENV,
                       str(tmp_path / "port_tune.json"))
    monkeypatch.setenv(jeplanner.AUTOTUNE_CACHE_ENV,
                       str(tmp_path / "ref_tune.json"))
    eplanner.load_autotune_cache(reload=True)
    jeplanner.load_autotune_cache(reload=True)
    jeplanner._AUTOTUNE_CACHE.clear()
    for o in (obs, jobs):
        o.disable()
        o.clear()
        o.metrics.reset()
    yield
    for o in (obs, jobs):
        o.disable()
        o.clear()
        o.metrics.reset()
    # leave both planners on the process's own cache, with no winner
    # measured here remembered
    monkeypatch.undo()
    eplanner.load_autotune_cache(reload=True)
    jeplanner.load_autotune_cache(reload=True)
    jeplanner._AUTOTUNE_CACHE.clear()


def _study(seed=3, n=N, d=D):
    rng = np.random.default_rng(seed)
    x = rng.gamma(1.0, 1.0, size=(n, d)).astype(np.float32)
    x *= rng.random(size=(n, d)) < 0.6
    x[:, 0] = np.maximum(x[:, 0], 1e-3)
    grouping = rng.integers(0, G, size=n).astype(np.int32)
    grouping[:G] = np.arange(G)
    x[grouping == 1, 1] += 1.5               # a planted effect
    cov = rng.normal(size=(n, 2))
    strata = (np.arange(n) % 3).astype(np.int32)
    return x, grouping, cov, strata


KEY = jax.random.key(7)


def _labels(grouping, strata=None, key=KEY):
    if strata is None:
        p = jperm.permutation_batch(key, jnp.asarray(grouping), 0, N_TOTAL)
    else:
        p = jperm.strata_label_batch_dyn(key, jnp.asarray(grouping),
                                         jnp.asarray(strata), 0, N_TOTAL)
    return torch.from_numpy(np.array(p))


def _index_perms(strata, key=KEY):
    p = jperm.strata_permutation_batch(key, jnp.asarray(strata), 0, N_TOTAL)
    return torch.from_numpy(np.array(p))


# ---------------------------------------------------------------------------
# The reference's obs tests, held against the port's obs.
# ---------------------------------------------------------------------------

class TestSpans:
    def test_nesting_depth_and_parent(self):
        obs.enable(trace=True, metrics=False)
        with obs.span("outer"):
            with obs.span("inner", {"k": 1}):
                pass
        evs = {e["name"]: e for e in obs.events()}
        assert evs["outer"]["args"]["depth"] == 0
        assert "parent" not in evs["outer"]["args"]
        assert evs["inner"]["args"]["depth"] == 1
        assert evs["inner"]["args"]["parent"] == "outer"
        assert evs["inner"]["args"]["k"] == 1
        assert evs["inner"]["ts"] >= evs["outer"]["ts"]
        assert (evs["inner"]["ts"] + evs["inner"]["dur"]
                <= evs["outer"]["ts"] + evs["outer"]["dur"] + 1e-3)

    def test_export_chrome_trace_shape(self, tmp_path):
        obs.enable(trace=True, metrics=False)
        with obs.span("stage1.test", {"predicted_bytes": 64.0}):
            pass
        path = str(tmp_path / "trace.json")
        obs.trace.export(path, extra_metadata={"run": "t"})
        with open(path) as f:
            doc = json.load(f)
        assert doc["displayTimeUnit"] == "ms"
        assert doc["otherData"]["source"] == "repro_torch.obs"
        assert doc["otherData"]["run"] == "t"
        (ev,) = doc["traceEvents"]
        assert ev["ph"] == "X" and ev["cat"] == "repro_torch"
        assert {"name", "ts", "dur", "pid", "tid", "args"} <= set(ev)
        assert ev["args"]["predicted_bytes"] == 64.0

    def test_stage_table_aggregates(self):
        obs.enable(trace=True, metrics=False)
        for _ in range(3):
            with obs.span("s", {"predicted_bytes": 10.0}):
                pass
        row = obs.trace.stage_table()["s"]
        assert row["calls"] == 3
        assert row["predicted_bytes"] == 30.0
        assert row["total_s"] >= 0.0 and row["mean_s"] >= 0.0

    def test_session_restores_prior_state(self, tmp_path):
        assert not obs.enabled()
        path = str(tmp_path / "t.json")
        with obs.session(path):
            assert obs.trace_enabled()
            with obs.span("inside"):
                pass
        assert not obs.enabled()
        assert json.load(open(path))["traceEvents"]
        obs.enable(trace=False, metrics=True)
        with obs.session():
            assert obs.trace_enabled() and obs.metrics_enabled()
        assert (obs.trace_enabled(), obs.metrics_enabled()) == (False, True)

    def test_span_attrs_are_read_at_exit(self):
        obs.enable(trace=True, metrics=False)
        attrs = {"predicted_bytes": 1.0}
        with obs.span("s", attrs):
            attrs["stall_ms"] = 2.5
        (ev,) = obs.events()
        assert ev["args"]["stall_ms"] == 2.5

    def test_a_new_thread_starts_at_depth_zero(self):
        import threading
        obs.enable(trace=True, metrics=False)

        def work():
            with obs.span("prefetch.fetch"):
                pass
        with obs.span("bridge.ooc"):
            t = threading.Thread(target=work)
            t.start()
            t.join()
        evs = {e["name"]: e for e in obs.events()}
        assert evs["prefetch.fetch"]["args"]["depth"] == 0
        assert "parent" not in evs["prefetch.fetch"]["args"]
        assert evs["prefetch.fetch"]["tid"] != evs["bridge.ooc"]["tid"]

    def test_emit_complete(self):
        obs.emit_complete("serve.step", 0, 10)
        assert obs.events() == []
        obs.enable(trace=True, metrics=False)
        obs.emit_complete("serve.step", 1000, 4000, {"request": 3})
        (ev,) = obs.events()
        assert ev["dur"] == 3.0 and ev["args"] == {"request": 3}

    def test_stamps_are_on_the_profilers_clock(self):
        """An obs span's ts (microseconds since the Unix epoch) lies within
        1 ms of the start of its own record_function range in the
        profiler's events, so the two traces lie over each other."""
        obs.enable(trace=True, metrics=False)
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            # the first range a process records sets up the profiler's
            # per-thread state after its start is stamped (~0.7 ms on an
            # idle host): a one-off delay, not an offset of the clocks
            with torch.profiler.record_function("warm-up"):
                pass
            for _ in range(3):
                with obs.span("stage1.clocked"):
                    torch.ones(4).sum()
        starts = sorted(e.start_ns() / 1e3
                        for e in prof.profiler.kineto_results.events()
                        if e.name() == "stage1.clocked")
        ts = sorted(e["ts"] for e in obs.events())
        assert len(starts) == len(ts) == 3
        for a, b in zip(starts, ts):
            assert abs(a - b) < 1e3, (a, b)

    def test_spans_are_profiler_ranges(self):
        obs.enable(trace=True, metrics=False)
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            with obs.span("stage1.profiled"):
                torch.ones(4).sum()
        names = {e.key for e in prof.key_averages()}
        assert "stage1.profiled" in names


class TestDisabledMode:
    def test_span_is_shared_noop_singleton(self):
        assert obs.span("a") is obs.span("b", {"x": 1})
        assert obs.span("a") is obs.core.NOOP_SPAN

    def test_no_events_no_counters(self):
        with obs.span("ghost"):
            pass
        obs.metrics.inc("ghost.counter")
        cudahooks.count_launch("brute")
        cudahooks.count_build(1.0)
        obs.emit_complete("ghost", 0, 1)
        assert obs.events() == []
        assert obs.metrics.snapshot() == {"counters": {}, "gauges": {},
                                          "histograms": {}}

    def test_hot_path_allocation_free(self):
        for _ in range(4):
            with obs.span("warm"):
                pass
            obs.metrics.inc("warm")
            cudahooks.count_launch("warm")
        tracemalloc.start()
        try:
            before = tracemalloc.take_snapshot()
            for _ in range(100):
                with obs.span("hot"):
                    pass
                obs.metrics.inc("hot", 1.0)
                cudahooks.count_launch("brute")
                obs.maybe_block(None)
            after = tracemalloc.take_snapshot()
        finally:
            tracemalloc.stop()
        grown = sum(s.size_diff for s in after.compare_to(before, "lineno")
                    if s.size_diff > 0 and any(
                        "obs" in (fr.filename or "")
                        for fr in s.traceback))
        assert grown == 0, f"disabled obs hot path allocated {grown} bytes"

    def test_no_device_sync_while_off(self, monkeypatch):
        calls = []
        monkeypatch.setattr(torch.cuda, "synchronize",
                            lambda *a: calls.append(a))

        class Dev:                 # a stand-in tensor on a CUDA device
            device = torch.device("cuda", 0)
        monkeypatch.setattr(obs.core, "_cuda_devices",
                            lambda x: {Dev.device})
        x = torch.zeros(3)
        assert obs.maybe_block(x) is x
        assert calls == [] and obs.events() == []
        obs.enable(trace=True, metrics=False)
        obs.maybe_block(x)
        assert len(calls) == 1 and obs.events() == []

    def test_no_device_sync_under_a_profiler(self, monkeypatch):
        """While a torch.profiler records, the traced run keeps the
        untraced schedule: maybe_block waits for nothing; outside it, it
        waits as before."""
        calls = []
        monkeypatch.setattr(torch.cuda, "synchronize",
                            lambda *a: calls.append(a))

        class Dev:                 # a stand-in tensor on a CUDA device
            device = torch.device("cuda", 0)
        monkeypatch.setattr(obs.core, "_cuda_devices",
                            lambda x: {Dev.device})
        x = torch.zeros(3)
        obs.enable(trace=True, metrics=False)
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]):
            assert obs.maybe_block(x) is x
            with obs.span("engine.sw_chunk"):
                obs.maybe_block(x)
        assert calls == []
        obs.maybe_block(x)
        assert len(calls) == 1

    def test_cpu_tensors_need_no_sync(self, monkeypatch):
        calls = []
        monkeypatch.setattr(torch.cuda, "synchronize",
                            lambda *a: calls.append(a))
        obs.enable(trace=True, metrics=False)
        obs.maybe_block((torch.zeros(2), [torch.ones(1)]))
        assert calls == []

    def test_untraced_pipeline_records_nothing(self):
        x, g, _, _ = _study()
        pipeline.pipeline(torch.from_numpy(x), torch.from_numpy(g),
                          n_perms=PERMS, materialize="stream",
                          row_block=ROW_BLOCK, chunk=CHUNK, device="cpu")
        assert obs.events() == []
        assert obs.metrics.snapshot()["counters"] == {}


class TestCounters:
    def test_mat2_bytes_built_exact(self):
        from repro_torch.pipeline.streaming import build_mat2_streaming
        n, d = 96, 16
        x = torch.from_numpy(np.random.default_rng(0).random((n, d))
                             .astype(np.float32))
        prepare, rows_fn, _ = pipeline.registry.get(
            "braycurtis.blocked").bound(block=32)
        obs.enable(trace=True, metrics=True)
        mat2, _ = build_mat2_streaming(prepare(x), rows_fn, block=32)
        assert obs.metrics.value("pipeline.mat2_bytes_built") == 4.0 * n * n
        assert tuple(mat2.shape) == (n, n)
        assert obs.trace.stage_table()["stream.mat2_block"]["calls"] == 3

    def test_merge_snapshots(self):
        hosts = [
            {"counters": {"engine.perm_chunks": 3.0},
             "gauges": {"device0.peak_bytes_in_use": 100.0},
             "histograms": {"t": {"count": 2, "total": 4.0,
                                  "min": 1.0, "max": 3.0}}},
            {"counters": {"engine.perm_chunks": 5.0},
             "gauges": {"device0.peak_bytes_in_use": 250.0},
             "histograms": {"t": {"count": 1, "total": 9.0,
                                  "min": 9.0, "max": 9.0}}},
        ]
        m = obs.metrics.merge_snapshots(hosts)
        assert m == jobs.metrics.merge_snapshots(hosts)
        assert m["counters"]["engine.perm_chunks"] == 8.0
        assert m["gauges"]["device0.peak_bytes_in_use"] == 250.0
        h = m["histograms"]["t"]
        assert (h["count"], h["total"], h["min"], h["max"]) == (3, 13.0,
                                                                1.0, 9.0)

    def test_counter_delta(self):
        obs.enable(trace=False, metrics=True)
        obs.metrics.inc("a", 2.0)
        before = obs.metrics.snapshot()
        obs.metrics.inc("a", 3.0)
        obs.metrics.inc("b", 1.0)
        assert obs.metrics.counter_delta(before) == {"a": 3.0, "b": 1.0}

    def test_launch_counters_follow_the_launches_keys(self):
        obs.enable(trace=False, metrics=True)
        cudahooks.count_launch("fused_sw[fp8]")
        cudahooks.count_launch("brute")
        cudahooks.count_launch("brute")
        assert cudahooks.launch_counts(obs.metrics.snapshot()) == {
            "brute": 2.0, "fused_sw[fp8]": 1.0}

    def test_record_device_memory_skips_the_cpu(self):
        obs.enable(trace=False, metrics=True)
        obs.record_device_memory()
        assert obs.metrics.snapshot()["gauges"] == {}


class TestAutotuneCacheCounters:
    def test_hit_miss(self):
        obs.enable(trace=False, metrics=True)
        assert eplanner.measured_impl("cpu", 64, 4) is None
        assert obs.metrics.value("autotune.cache.miss") == 1.0
        eplanner.record_entry(eplanner._persist_key("cpu", 64, 4),
                              {"impl": "matmul",
                               "candidates": engine.registry.names()})
        assert eplanner.measured_impl("cpu", 64, 4) == "matmul"
        assert obs.metrics.value("autotune.cache.hit") == 1.0

    def test_stale_schema_dropped_counter(self, tmp_path, monkeypatch):
        path = str(tmp_path / "stale.json")
        with open(path, "w") as f:
            json.dump({"dist|cpu|braycurtis|blocked": {"impl": "blocked"}},
                      f)
        monkeypatch.setenv(eplanner.AUTOTUNE_CACHE_ENV, path)
        obs.enable(trace=False, metrics=True)
        assert eplanner.load_autotune_cache(reload=True) == {}
        assert obs.metrics.value("autotune.cache.stale_dropped") == 1.0

    def test_corrupt_cache_quarantined_counter(self, tmp_path, monkeypatch):
        path = str(tmp_path / "corrupt.json")
        with open(path, "w") as f:
            f.write("{not json")
        monkeypatch.setenv(eplanner.AUTOTUNE_CACHE_ENV, path)
        obs.enable(trace=False, metrics=True)
        assert eplanner.load_autotune_cache(reload=True) == {}
        assert obs.metrics.value("autotune.cache.corrupt_quarantined") == 1.0
        assert os.path.exists(path + ".corrupt")


def test_slabcache_quarantine_counter(tmp_path):
    x, *_ = _study()
    cache = slabcache.build_slab_cache(tmp_path / "c", x, slab_rows=SLAB)
    with open(os.path.join(cache.path, "slab_00001.bin"), "r+b") as f:
        f.truncate(8)
    obs.enable(trace=False, metrics=True)
    with pytest.raises(slabcache.SlabCacheError):
        slabcache.SlabCache.open(cache.path)
    assert obs.metrics.value("slabcache.corrupt_quarantined") == 1.0


class TestSpanRingBuffer:
    def test_cap_keeps_most_recent_spans(self, tmp_path):
        prev = obs.buffer_cap()
        obs.enable(trace=True, metrics=False)
        try:
            obs.set_buffer_cap(10)
            for i in range(25):
                with obs.span(f"serve.step{i}"):
                    pass
            assert [e["name"] for e in obs.events()] == [
                f"serve.step{i}" for i in range(15, 25)]
            assert obs.dropped_events() == 15
            out = tmp_path / "ring.json"
            obs.trace.export(str(out))
            names = [e["name"] for e in json.loads(out.read_text())
                     ["traceEvents"]]
            assert names == [f"serve.step{i}" for i in range(15, 25)]
        finally:
            obs.set_buffer_cap(prev)

    def test_shrinking_cap_trims_immediately(self):
        prev = obs.buffer_cap()
        obs.enable(trace=True, metrics=False)
        try:
            obs.set_buffer_cap(None)
            for i in range(8):
                with obs.span(f"s{i}"):
                    pass
            obs.set_buffer_cap(3)
            assert [e["name"] for e in obs.events()] == ["s5", "s6", "s7"]
            assert obs.dropped_events() == 5
            obs.clear()
            assert obs.dropped_events() == 0
        finally:
            obs.set_buffer_cap(prev)

    def test_cap_env_name(self):
        assert obs.core.MAX_EVENTS_ENV == "REPRO_TORCH_OBS_MAX_EVENTS"


class TestReport:
    def _spans(self):
        obs.enable(trace=True, metrics=True)
        for name, b in (("stage1.braycurtis", 2e9), ("fusedk.chunk", 0.0)):
            with obs.span(name, {"predicted_bytes": b} if b else None):
                pass
        obs.metrics.inc("engine.perm_chunks", 5)

    def test_budget_violations(self):
        self._spans()
        assert obs.budget_violations({"stage1.*": 1e6, "nothing.*": 0}) == []
        (v,) = obs.budget_violations({"stage1.*": 0.0, "fusedk.*": 1e6})
        assert v["pattern"] == "stage1.*"
        assert v["stages"] == ["stage1.braycurtis"]

    def test_report_renders_rows_counters_and_budgets(self):
        self._spans()
        text = obs.report(file=None, budgets={"stage1.*": 0.0,
                                               "missing": 1.0})
        assert "GB/s" in text and "stage1.braycurtis" in text
        assert "fusedk.chunk" in text          # the untimed table
        assert "engine.perm_chunks = 5" in text
        assert "stage1.*" in text and "[OVER]" in text
        assert "missing" in text and "[not run]" in text

    def test_stage_rows_flag_below_the_reference(self):
        self._spans()
        (row,) = obs.stage_rows(peak_gbps=1e12)
        assert row["stage"] == "stage1.braycurtis" and row["flagged"]
        (row,) = obs.stage_rows(peak_gbps=1e-12)
        assert not row["flagged"]

    def test_reference_bandwidth_by_backend(self, monkeypatch):
        import importlib
        # (the package's `report` is the function; these are the modules)
        rep = importlib.import_module("repro_torch.obs.report")
        jrep = importlib.import_module("repro.obs.report")
        monkeypatch.delenv(rep.PEAK_GBPS_ENV, raising=False)
        monkeypatch.delenv(jrep.PEAK_GBPS_ENV, raising=False)
        # cpu: the reference's number, so a CPU report reads as its
        assert rep.reference_gbps("cpu") == jrep.reference_gbps("cpu")
        assert rep.reference_gbps("cpu") == hw.MI300A_CPU_STREAM_TRIAD / 1e9
        # cuda: the card's measured triad (the registry's hbm tier)
        assert rep.reference_gbps("cuda") == \
            pipeline.registry.CUDA_TIER_GBPS["hbm"] == 3091.2
        monkeypatch.setenv(rep.PEAK_GBPS_ENV, "123.5")
        assert rep.reference_gbps("cuda") == 123.5
        assert rep.PEAK_GBPS_ENV == "REPRO_TORCH_OBS_PEAK_GBPS"

    def test_render_table_equals_the_reference(self):
        from repro.roofline.report import render_table as jrender
        from repro_torch.roofline.report import render_table
        rows = [["a", "1", "2.50"], ["bbbb", "22", "3"]]
        assert render_table(["x", "y", "z"], rows) == \
            jrender(["x", "y", "z"], rows)

    def test_ridge_points(self):
        assert hw.ridge_point_bf16() == pytest.approx(989e12 / 3.35e12)
        assert hw.ridge_point_f32() == pytest.approx(20.0)
        assert hw.TARGET is hw.H100_SXM


# ---------------------------------------------------------------------------
# Parity with the reference: span trees, shared counters, predicted bytes.
# ---------------------------------------------------------------------------

def _traced(o, fn):
    """Run fn under o's telemetry from a clean state; (result, events,
    snapshot)."""
    o.clear()
    o.metrics.reset()
    o.enable(trace=True, metrics=True)
    try:
        res = fn()
    finally:
        events, snap = o.events(), o.metrics.snapshot()
        o.disable()
    return res, events, snap


def _tree(events):
    return collections.Counter(
        (e["name"], e["args"].get("parent"), e["args"]["depth"])
        for e in events)


# The port's own spans, which the reference has not: a call of
# engine.run / run_design, its planning, each chunk's draw. They are taken
# out of the port's tree before it is held to the reference's, and held
# on their own by TestPortOnlySpans.
PORT_ONLY = ("engine.run", "engine.plan", "engine.draw")


def _without(events, names=PORT_ONLY):
    """The events with the spans `names` taken out, each other span's
    parent and depth as if those had never been opened. The nesting is
    rebuilt from the completion order: a span's event is appended when
    it closes, after its children's, on its own thread."""
    done = collections.defaultdict(list)     # tid -> [(event, children)]
    for e in events:
        depth = e["args"]["depth"]
        pending = done[e["tid"]]
        children = []
        while pending and pending[-1][0]["args"]["depth"] > depth:
            children.append(pending.pop())
        pending.append((e, children[::-1]))
    out = []

    def walk(node, parent, depth):
        e, children = node
        if e["name"] in names:
            for c in children:
                walk(c, parent, depth)
            return
        args = {k: v for k, v in e["args"].items() if k != "parent"}
        args["depth"] = depth
        if parent is not None:
            args["parent"] = parent
        out.append({**e, "args": args})
        for c in children:
            walk(c, e["name"], depth + 1)
    for roots in done.values():
        for node in roots:
            walk(node, None, 0)
    return out


def _shared(snap):
    c = snap["counters"]
    return {k: c[k] for k in SHARED if k in c}


def _predicted(events):
    """Predicted bytes summed per span name."""
    out = collections.defaultdict(float)
    for e in events:
        if "predicted_bytes" in e["args"]:
            out[e["name"]] += e["args"]["predicted_bytes"]
    return dict(out)


def _assert_close_bytes(port, ref):
    assert set(port) == set(ref), (port, ref)
    for k in ref:
        np.testing.assert_allclose(port[k], ref[k], rtol=BYTES_RTOL,
                                   err_msg=k)


def _assert_same_test(res_t, res_j):
    pairs = ([(res_t, res_j)] if res_j.terms is None
             else list(zip(res_t.terms, res_j.terms)))
    for t, u in pairs:
        np.testing.assert_allclose(np.asarray(t.f_stat, np.float64),
                                   np.asarray(u.f_stat, np.float64),
                                   rtol=RTOL)
        np.testing.assert_array_equal(np.asarray(t.p_value),
                                      np.asarray(u.p_value))


def _check(ref_fn, port_fn, *, tree=None, counters=None, predicted=None):
    """Run both traced; hold the port's tree (less PORT_ONLY), shared
    counters and predicted bytes to the reference's, each transformed
    first by the case's named divergence (tree / counters / predicted: a
    function of the reference's value returning what the port must
    show)."""
    res_j, ev_j, snap_j = _traced(jobs, ref_fn)
    res_t, ev_t, snap_t = _traced(obs, port_fn)
    _assert_same_test(res_t, res_j)
    want_tree = _tree(ev_j) if tree is None else tree(_tree(ev_j))
    assert _tree(_without(ev_t)) == want_tree
    want_counters = (_shared(snap_j) if counters is None
                     else counters(_shared(snap_j)))
    assert _shared(snap_t) == want_counters
    want_bytes = (_predicted(ev_j) if predicted is None
                  else predicted(_predicted(ev_j)))
    _assert_close_bytes(_predicted(ev_t), want_bytes)
    # pipeline.predicted_bytes counts the stage-1 and bridge spans' bytes
    for snap, want in ((snap_j, _predicted(ev_j)), (snap_t, want_bytes)):
        np.testing.assert_allclose(
            snap["counters"].get("pipeline.predicted_bytes", 0.0),
            sum(v for k, v in want.items()
                if k.startswith(("stage1.", "bridge."))), rtol=BYTES_RTOL)
    return ev_t


BRIDGES = ["dense", "stream", "fused", "fused-kernel"]


@pytest.mark.parametrize("bridge", BRIDGES)
def test_bridge_trees_counters_and_bytes_equal_the_reference(bridge):
    x, g, _, _ = _study()
    kw = dict(n_perms=PERMS, materialize=bridge, row_block=ROW_BLOCK,
              chunk=CHUNK, n_groups=G)
    _check(lambda: jpipe.pipeline(jnp.asarray(x), jnp.asarray(g), key=KEY,
                                  **kw),
           lambda: pipeline.pipeline(torch.from_numpy(x),
                                     torch.from_numpy(g), perms=_labels(g),
                                     device="cpu", **kw))


def test_the_megakernel_kind_equals_the_pallas_kind():
    """fused_impl 'pallas' (the reference's kernel, interpret mode) and
    'cuda' (the port's, its plain version on CPU tensors): the same spans
    (one fusedk.chunk a chunk) and counters. Divergence: the predicted
    feature traffic is each kernel's own tiling (the port's 64 x 64
    tiles j >= i against the Pallas kernel's full grid of 128 x 128
    tiles), so the bridge's bytes are the port's model."""
    x, g, _, _ = _study()
    kw = dict(n_perms=PERMS, materialize="fused-kernel", chunk=CHUNK,
              n_groups=G, metric="braycurtis")
    fspec = pipeline.registry.get_fused("braycurtis.fusedk.cuda")
    n_chunks = -(-N_TOTAL // CHUNK)
    port_bytes = (pipeline.registry.fused_feat_traffic_bytes(fspec, N, D)
                  * n_chunks + 4.0 * CHUNK * N * (G + 1) * n_chunks)
    ev = _check(
        lambda: jpipe.pipeline(jnp.asarray(x), jnp.asarray(g), key=KEY,
                               fused_impl="pallas", **kw),
        lambda: pipeline.pipeline(torch.from_numpy(x), torch.from_numpy(g),
                                  perms=_labels(g), fused_impl="cuda",
                                  device="cpu", **kw),
        predicted=lambda ref: {"bridge.fused-kernel": port_bytes})
    assert sum(e["name"] == "fusedk.chunk" for e in ev) == n_chunks


DESIGNS = [("covariates", "dense"), ("covariates", "stream"),
           ("covariates", "fused"), ("covariates", "fused-kernel"),
           ("strata", "fused"), ("strata", "fused-kernel"),
           ("strata", "dense")]


@pytest.mark.parametrize("design,bridge", DESIGNS)
def test_design_trees_counters_and_bytes_equal_the_reference(design,
                                                             bridge):
    x, g, cov, strata = _study()
    kw = dict(n_perms=PERMS, materialize=bridge, row_block=ROW_BLOCK,
              chunk=CHUNK, n_groups=G, strata=strata)
    if design == "covariates":
        kw["covariates"] = cov
        draws = {"index_perms": _index_perms(strata)}
    else:
        draws = {"perms": _labels(g, strata)}
    _check(lambda: jpipe.pipeline(jnp.asarray(x), jnp.asarray(g), key=KEY,
                                  **kw),
           lambda: pipeline.pipeline(torch.from_numpy(x),
                                     torch.from_numpy(g), device="cpu",
                                     **draws, **kw))


@pytest.mark.parametrize("materialize", ["fused", "fused-kernel"])
@pytest.mark.parametrize("mode", ["labels", "design"])
def test_out_of_core_trees_counters_and_bytes_equal_the_reference(
        tmp_path, materialize, mode):
    """Both read the same slab cache (the format is shared). Each row slab
    is an `ooc.row_slab` span holding its column fetches' waits; the row
    slab's own wait sits under `bridge.ooc`; every fetch is a depth-0
    `prefetch.fetch` on the worker thread."""
    x, g, cov, strata = _study()
    cache = jslabcache.build_slab_cache(str(tmp_path / "cache"), x,
                                        slab_rows=SLAB)
    kw = dict(n_perms=PERMS, materialize=materialize, chunk=CHUNK,
              n_groups=G, device_budget_bytes=HOST)
    draws = {"perms": _labels(g)}
    if mode == "design":
        kw.update(covariates=cov, strata=strata)
        draws = {"index_perms": _index_perms(strata)}
    ev = _check(
        lambda: jpipe.pipeline(jslabcache.SlabCache.open(cache.path),
                               jnp.asarray(g), key=KEY, **kw),
        lambda: pipeline.pipeline(slabcache.SlabCache.open(cache.path),
                                  torch.from_numpy(g), device="cpu",
                                  **draws, **kw))
    n_slabs = -(-N // SLAB)
    tree = _tree(ev)
    assert tree[("ooc.row_slab", "bridge.ooc", 1)] == n_slabs
    assert tree[("prefetch.wait", "ooc.row_slab", 2)] == n_slabs ** 2
    assert tree[("prefetch.fetch", None, 0)] == n_slabs * (n_slabs + 1)
    (ooc,) = [e for e in ev if e["name"] == "bridge.ooc"]
    assert ooc["args"]["disk_bytes_read"] == 4 * N * D * (n_slabs + 1)
    assert ooc["args"]["stall_ms"] >= 0.0


@pytest.mark.parametrize("chunk", [None, CHUNK])
def test_engine_run_tree_counters_and_bytes_equal_the_reference(chunk):
    x, g, _, _ = _study()
    dm = jnp.asarray(np.asarray(
        jpipe.get("braycurtis.blocked").bound()[2](jnp.asarray(x))))
    _check(lambda: jengine.run(dm, jnp.asarray(g), n_perms=PERMS, key=KEY,
                               n_groups=G, chunk=chunk),
           lambda: engine.run(torch.from_numpy(np.array(dm)),
                              torch.from_numpy(g), n_perms=PERMS,
                              perms=_labels(g), n_groups=G, chunk=chunk,
                              device="cpu"))


def _engine_inputs():
    x, g, cov, strata = _study()
    dm = np.array(jpipe.get("braycurtis.blocked").bound()[2](jnp.asarray(x)))
    return torch.from_numpy(dm), torch.from_numpy(g), cov, strata


# each case's draw kind: plain labels; strata, which run() hands over to
# the design path; covariates (and strata), a dense design
PORT_CASES = {"labels": "labels", "strata": "strata", "covariates": "index"}


class TestPortOnlySpans:
    """engine.run -> {engine.plan, engine.sw -> engine.sw_chunk ->
    engine.draw}: one engine.run and one engine.plan a call (also when
    run() hands over to the design path), one engine.draw a chunk."""

    def _run(self, case, chunk, seed=5, **extra):
        dm, g, cov, strata = _engine_inputs()
        design = {"labels": {}, "strata": {"strata": strata},
                  "covariates": {"covariates": cov, "strata": strata}}[case]
        return engine.run(dm, g, n_perms=PERMS, seed=seed, n_groups=G,
                          chunk=chunk, device="cpu", **design, **extra)

    @pytest.mark.parametrize("chunk", [None, CHUNK])
    @pytest.mark.parametrize("case", list(PORT_CASES))
    def test_tree_and_attrs(self, case, chunk):
        res, ev, _ = _traced(obs, lambda: self._run(case, chunk))
        n_chunks = int(res.plan.split("chunks=")[1].split()[0])
        if chunk is not None:
            assert n_chunks == -(-N_TOTAL // CHUNK)
        assert _tree(ev) == collections.Counter({
            ("engine.run", None, 0): 1,
            ("engine.plan", "engine.run", 1): 1,
            ("engine.sw", "engine.run", 1): 1,
            ("engine.sw_chunk", "engine.sw", 2): n_chunks,
            ("engine.draw", "engine.sw_chunk", 3): n_chunks})
        (run,) = [e for e in ev if e["name"] == "engine.run"]
        (plan,) = [e for e in ev if e["name"] == "engine.plan"]
        assert {k: run["args"][k] for k in ("seed", "n", "n_total",
                                            "chunks")} == {
            "seed": 5, "n": N, "n_total": N_TOTAL, "chunks": n_chunks}
        assert run["args"]["impl"] == plan["args"]["impl"]
        assert plan["args"]["reason"]
        draws = [e["args"] for e in ev if e["name"] == "engine.draw"]
        assert {(d["source"], d["kind"]) for d in draws} == {
            ("seed", PORT_CASES[case])}
        assert sum(d["rows"] for d in draws) == N_TOTAL
        assert all(d["sub_blocks"] >= 1 for d in draws)
        # the plan closes before the sweep opens, inside the call
        (sw,) = [e for e in ev if e["name"] == "engine.sw"]
        assert run["ts"] <= plan["ts"]
        assert plan["ts"] + plan["dur"] <= sw["ts"]
        assert sw["ts"] + sw["dur"] <= run["ts"] + run["dur"]

    def test_sliced_draws_name_their_source(self):
        dm, g, _, strata = _engine_inputs()
        _, ev, _ = _traced(obs, lambda: engine.run(
            dm, g, n_perms=PERMS, perms=_labels(g), n_groups=G, chunk=CHUNK,
            device="cpu"))
        draws = [e["args"] for e in ev if e["name"] == "engine.draw"]
        assert [d["source"] for d in draws] == ["perms"] * 3
        assert [d["sub_blocks"] for d in draws] == [0] * 3
        # run_design entered directly is one engine.run too
        des = design_mod.build(grouping=g, strata=strata, n_groups=G,
                               device="cpu")
        _, ev, _ = _traced(obs, lambda: engine.run_design(
            dm, des, n_perms=PERMS, index_perms=_index_perms(strata),
            chunk=CHUNK, device="cpu"))
        assert sum(e["name"] == "engine.run" for e in ev) == 1
        assert {e["args"]["source"] for e in ev
                if e["name"] == "engine.draw"} == {"index_perms"}

    @pytest.mark.parametrize("case", list(PORT_CASES))
    def test_traced_equals_untraced_bit_for_bit(self, case):
        plain = self._run(case, CHUNK)
        traced, _, _ = _traced(obs, lambda: self._run(case, CHUNK))
        pairs = ([(plain, traced)] if plain.terms is None
                 else list(zip(plain.terms, traced.terms)))
        for a, b in pairs:
            assert torch.equal(a.f_perms, b.f_perms)
            assert torch.equal(a.p_value, b.p_value)

    def test_without_rebuilds_the_reference_nesting(self):
        """_without takes the port's spans out and leaves what they held
        one level up, on each thread."""
        obs.enable(trace=True, metrics=False)
        with obs.span("engine.run"):
            with obs.span("engine.plan"):
                pass
            with obs.span("engine.sw"):
                for _ in range(2):
                    with obs.span("engine.sw_chunk"):
                        with obs.span("engine.draw"):
                            pass
        assert _tree(_without(obs.events())) == collections.Counter({
            ("engine.sw", None, 0): 1,
            ("engine.sw_chunk", "engine.sw", 1): 2})


AUTOTUNE_ORDER = ("brute", "matmul", "tiled")   # both packages' order


def _pin_shootout(monkeypatch, winner):
    """Give both shoot-outs a clock that ranks the candidates the same
    way, `winner` fastest: the port's `planner.time_call` (called once a
    candidate, in `AUTOTUNE_ORDER`) and the reference's
    `time.perf_counter` (read twice a candidate, in the same order) by
    a stand-in `time` in its planner's namespace. Each stand-in still
    runs its candidate (the port's calls it once). Host timing on a
    loaded machine could otherwise rank them differently in the two
    packages, and the span trees, counters and predicted bytes follow
    the winner."""
    ms = {name: 1.0 + (name != winner) * (1 + AUTOTUNE_ORDER.index(name))
          for name in AUTOTUNE_ORDER}
    port_times = iter(ms[name] for _ in range(2) for name in AUTOTUNE_ORDER)

    def time_call(fn, device, calls=eplanner.TIMED_CALLS):
        fn()
        return next(port_times)

    ticks = iter(t for _ in range(2) for name in AUTOTUNE_ORDER
                 for t in (0.0, ms[name] * 1e-3))
    monkeypatch.setattr(eplanner, "time_call", time_call)
    monkeypatch.setattr(jeplanner, "time", types.SimpleNamespace(
        perf_counter=lambda: next(ticks)))
    assert eplanner.registry.names() == list(AUTOTUNE_ORDER)
    assert jeplanner._default_candidates("cpu") == list(AUTOTUNE_ORDER)


def _autotune_runs(dm, g):
    return (lambda: jengine.run(jnp.asarray(dm), jnp.asarray(g),
                                n_perms=PERMS, key=KEY, n_groups=G,
                                autotune=True),
            lambda: engine.run(torch.from_numpy(dm), torch.from_numpy(g),
                               n_perms=PERMS, perms=_labels(g), n_groups=G,
                               autotune=True, device="cpu"))


@pytest.mark.parametrize("winner", AUTOTUNE_ORDER)
def test_autotune_winner_trees_counters_and_bytes_equal_the_reference(
        winner, monkeypatch):
    """With the shoot-outs' clocks pinned, both packages pick `winner`:
    its span tree, counters and predicted bytes are the reference's, on
    the measuring call and on the cached one."""
    _pin_shootout(monkeypatch, winner)
    x, g, _, _ = _study()
    dm = np.array(jpipe.get("braycurtis.blocked").bound()[2](jnp.asarray(x)))
    ref_fn, port_fn = _autotune_runs(dm, g)
    for _ in range(2):      # a miss and a measurement, then hits
        _check(ref_fn, port_fn)
    for planner in (eplanner, jeplanner):
        (entry,) = planner.load_autotune_cache().values()
        assert entry["impl"] == winner


def test_autotune_counters_equal_the_reference():
    """On the host's own clocks the two shoot-outs may pick different
    winners, so only what no winner changes is compared: F and p, and
    the autotune counters (a miss and a measurement, then a hit)."""
    x, g, _, _ = _study()
    dm = np.array(jpipe.get("braycurtis.blocked").bound()[2](jnp.asarray(x)))
    ref_fn, port_fn = _autotune_runs(dm, g)
    keys = ("autotune.cache.miss", "autotune.cache.hit", "autotune.measured")
    for call in range(2):
        res_j, _, snap_j = _traced(jobs, ref_fn)
        res_t, _, snap_t = _traced(obs, port_fn)
        _assert_same_test(res_t, res_j)
        want = ({"autotune.cache.miss": 1.0, "autotune.measured": 1.0}
                if call == 0 else {"autotune.cache.hit": 1.0})
        for snap in (snap_j, snap_t):
            got = {k: snap["counters"][k] for k in keys
                   if k in snap["counters"]}
            assert got == want


def _many_inputs(s_count=3):
    studies = [_study(20 + s) for s in range(s_count)]
    xs = np.stack([st[0] for st in studies])
    gs = np.stack([st[1] for st in studies])
    perms = torch.from_numpy(np.stack([np.array(jperm.permutation_batch(
        jax.random.fold_in(KEY, s), jnp.asarray(gs[s]), 0, N_TOTAL))
        for s in range(s_count)]))
    return xs, gs, perms


def _per_study_chunks(ref_counters, s_count, n_chunks):
    """Divergence of a many-study run: the port runs each study through
    its own chunked sweep, where the reference's one vmapped program
    counts no chunks, so `engine.perm_chunks` is S x the study's chunks."""
    return {**ref_counters, "engine.perm_chunks": float(s_count * n_chunks)}


@pytest.mark.parametrize("kind", ["labels", "design", "pipeline-dense"])
def test_permanova_many_tree_counters_and_bytes(kind):
    """Divergence: the port runs the studies one after another, each
    study's sweep in chunks, so `engine.studies` holds S x n_chunks
    `engine.sw_chunk` spans where the reference's vmapped program has
    none; and `engine.perm_chunks` counts them. pipeline_many's dense
    bridge builds the studies' matrices (no span in either package) and
    runs the same batch."""
    xs, gs, perms = _many_inputs()
    dense = jpipe.get("braycurtis.blocked").bound()[2]
    dms = np.stack([np.array(dense(jnp.asarray(x))) for x in xs])
    kw = dict(n_groups=G, n_perms=PERMS, chunk=CHUNK)
    draws = {"perms": perms}
    if kind == "design":
        kw["covariates"] = np.stack([_study(20 + s)[2] for s in range(3)])
        draws = {"index_perms": torch.from_numpy(np.stack([np.array(
            jperm.strata_permutation_batch(
                jax.random.fold_in(KEY, s), jnp.zeros((N,), jnp.int32), 0,
                N_TOTAL)) for s in range(3)]))}
    n_chunks = -(-N_TOTAL // CHUNK)

    def tree(ref):
        want = collections.Counter(ref)
        want[("engine.sw_chunk", "engine.studies", 1)] = 3 * n_chunks
        return want
    if kind == "pipeline-dense":
        kw["materialize"] = "dense"
        ref_fn = lambda: jpipe.pipeline_many(  # noqa: E731
            jnp.asarray(xs), jnp.asarray(gs), key=KEY, **kw)
        port_fn = lambda: pipeline.pipeline_many(  # noqa: E731
            torch.from_numpy(xs), torch.from_numpy(gs), device="cpu",
            **draws, **kw)
    else:
        ref_fn = lambda: jengine.permanova_many(  # noqa: E731
            jnp.asarray(dms), jnp.asarray(gs), key=KEY, **kw)
        port_fn = lambda: engine.permanova_many(  # noqa: E731
            torch.from_numpy(dms), torch.from_numpy(gs), device="cpu",
            **draws, **kw)
    _check(ref_fn, port_fn, tree=tree,
           counters=lambda c: _per_study_chunks(c, 3, n_chunks))


def test_pipeline_many_fused_kernel_tree_counters_and_bytes():
    """Divergence: the port runs each study's own fused-kernel bridge (S
    `bridge.fused-kernel` spans, each the study's traffic) where the
    reference runs one vmapped bridge for the batch (one span, S x the
    traffic); the total is the same. Its sweeps count their chunks."""
    xs, gs, perms = _many_inputs()
    kw = dict(n_groups=G, n_perms=PERMS, materialize="fused-kernel",
              chunk=CHUNK)
    n_chunks = -(-N_TOTAL // CHUNK)

    def tree(ref):
        assert ref == collections.Counter(
            {("bridge.fused-kernel", None, 0): 1})
        return collections.Counter({("bridge.fused-kernel", None, 0): 3})
    _check(lambda: jpipe.pipeline_many(jnp.asarray(xs), jnp.asarray(gs),
                                       key=KEY, **kw),
           lambda: pipeline.pipeline_many(torch.from_numpy(xs),
                                          torch.from_numpy(gs), perms=perms,
                                          device="cpu", **kw),
           tree=tree,
           counters=lambda c: _per_study_chunks(c, 3, n_chunks))


def test_pipeline_trace_kwarg_exports_loadable_json(tmp_path):
    x, g, _, _ = _study()
    path = str(tmp_path / "pipe.json")
    res = pipeline.pipeline(torch.from_numpy(x), torch.from_numpy(g),
                            n_perms=19, materialize="stream", trace=path,
                            device="cpu")
    assert 0.0 <= float(res.p_value) <= 1.0
    names = {e["name"] for e in json.load(open(path))["traceEvents"]}
    assert {"stage1.braycurtis", "stream.mat2_block", "engine.sw",
            "engine.sw_chunk"} <= names
    assert not obs.enabled()


@pytest.mark.parametrize("materialize", ["stream", "fused-kernel"])
def test_traced_equals_untraced_bit_for_bit(materialize):
    x, g, cov, strata = _study()
    kw = dict(n_perms=PERMS, materialize=materialize, row_block=ROW_BLOCK,
              chunk=CHUNK, device="cpu", covariates=cov, strata=strata)
    args = (torch.from_numpy(x), torch.from_numpy(g))
    plain = pipeline.pipeline(*args, **kw)
    traced = pipeline.pipeline(*args, trace=True, **kw)
    for a, b in zip(plain.terms, traced.terms):
        assert torch.equal(a.f_perms, b.f_perms)
        assert torch.equal(a.p_value, b.p_value)


# ---------------------------------------------------------------------------
# The card's traffic models against counts worked out by enumeration.
# ---------------------------------------------------------------------------

def _copies(pred_rows, pred_cols):
    return sum(1 for i in pred_rows for j in pred_cols)


def _enum_sw(variant, n, p, g):
    """Bytes of one s_W launch, counted copy by copy as the source
    issues them (a masked copy reads nothing), each block on its own."""
    t = 64
    nb = -(-n // t)
    total = 0
    if variant == "brute":
        for p0 in range(0, p, 128):
            here = min(128, p - p0)
            for band in range(nb):
                r0 = band * t
                total += 4 * here * min(t, n - r0)       # row labels
                for tb in range(band, nb):
                    c0 = tb * t
                    total += 4 * sum(1 for i in range(r0, min(r0 + t, n))
                                     for j in range(c0, min(c0 + t, n))
                                     if j > i)           # mat2, j > i
                    total += 4 * here * min(t, n - c0)   # column labels
                total += 4 * here                         # its partials
        return total + 4 * p * nb + 4 * p                 # the sum
    if variant == "permblock":
        blocks = 0
        for ti in range(nb):
            for jt0 in range(ti, nb, 16):
                blocks += 1
                r0 = ti * t
                for tj in range(jt0, min(jt0 + 16, nb)):
                    c0 = tj * t
                    total += 4 * sum(1 for i in range(r0, min(r0 + t, n))
                                     for j in range(c0, min(c0 + t, n))
                                     if j > i)
                    for p0 in range(0, p, 128):
                        here = min(128, p - p0)
                        total += 4 * here * (min(t, n - c0) + min(t, n - r0))
                        total += 4 * here * (2 if tj > jt0 else 1)
        return total + 4 * p * blocks + 4 * p
    pb = swops.matmul_perm_block(g)
    for p0 in range(0, p, pb):
        here = min(pb, p - p0)
        for band in range(nb):
            rows = min(t, n - band * t)
            total += 4 * rows * n + 4 * here * n + 4 * here * rows
            total += 4 * here
    return total + 4 * p * nb + 4 * p


@pytest.mark.parametrize("variant", swops.VARIANTS)
@pytest.mark.parametrize("n,p,g", [(130, 5, 3), (64, 130, 2), (200, 257, 8),
                                   (70, 3, 256)])
def test_sw_launch_bytes_match_an_enumeration(variant, n, p, g):
    """(The enumeration covers one slice of 256 one-hot columns; more
    groups than that: test_matmul_slices_reload_the_band.)"""
    assert swops.launch_bytes(variant, n, p, g) == _enum_sw(variant, n, p, g)


def test_matmul_slices_reload_the_band():
    n, p, g = 70, 3, 300
    nb = 2
    slices = 2                      # 300 one-hot columns: two of 256
    want = (p * slices * (4 * n * n + 4 * n * nb + 4 * n)
            + 2 * 4 * p * nb + 4 * p)
    assert swops.launch_bytes("matmul", n, p, g) == want


@pytest.mark.parametrize("nr,n,sym", [(130, 130, True), (70, 200, False),
                                      (64, 64, True), (1, 65, False)])
def test_tile_visits_match_an_enumeration(nr, n, sym):
    t = 64
    visits = cols = rows = 0
    for ti in range(-(-nr // t)):
        for tj in range(-(-n // t)):
            if sym and tj < ti:
                continue
            visits += 1
            cols += min(t, n - tj * t)
            rows += min(t, nr - ti * t)
    assert tile_visit_elems(nr, n, t, sym) == (visits, cols, rows)


def test_fused_and_distance_launch_bytes_by_hand():
    n, d, p = 130, 5, 7                 # 3 tiles of 64: 6 visits j >= i
    visits, cols, rows = 6, 64 * 1 + 64 * 2 + 2 * 3, 64 * 3 + 64 * 2 + 2
    slots = fops.n_slots(n, n, True, "fused_sw")
    want = (4.0 * d * (cols + rows) + 4.0 * p * (cols + rows)
            + 8.0 * p * visits + 8.0 * p * slots + 16.0 * slots + 4.0 * p)
    assert fops.launch_bytes(n, n, d, p) == want
    k = 3
    slots = fops.n_slots(n, n, True, "fused_sw_cols")
    q = p * k
    assert fops.launch_bytes(n, n, d, p, n_cols=k, feat_bytes=2.0) == (
        2.0 * d * (cols + rows) + 4.0 * q * (cols + rows)
        + 8.0 * q * visits + 8.0 * q * slots + 16.0 * slots + 4.0 * q)
    # the distance kernel: 128 x 128 tiles; 130 rows -> 2 x 2, j >= i: 3
    assert dops.launch_bytes(130, 130, d, symmetric=True) == (
        4.0 * d * ((128 + 2 * 2) + (128 * 2 + 2)) + 4.0 * 130 * 130)


def test_cuda_sw_traffic_counts_launches_and_draws():
    n, n_total, chunk = 300, 1000, 384
    got = eapi._sw_traffic_bytes("brute", n, n_total, chunk,
                                 backend="cuda", n_groups=4)
    want = sum(swops.launch_bytes("brute", n, p, 4) + 4.0 * p * n
               for p in (384, 384, 232))
    assert got == want
    # brute stages the triangle once per 128 permutations, where the
    # reference's model streams all of mat2 once per permutation
    assert got < eapi._sw_traffic_bytes("brute", n, n_total, chunk) / 20
    # cpu, and a dense design's per-column companion: the reference's
    assert eapi._sw_traffic_bytes("brute", n, n_total, chunk, 5,
                                  backend="cuda", n_groups=4) == \
        eapi._sw_traffic_bytes("brute", n, n_total, chunk, 5)


def test_emp_traffic_models_stay_under_the_hbm_rate():
    """At the EMP shape and the card's measured kernel times (PERF.md
    §6), each launch's modelled bytes would move under the HBM rate: the
    models count the loads the source issues, not one pass of mat2 per
    permutation."""
    n = hw.PAPER_N_DIMS
    cases = [(swops.launch_bytes("brute", n, 2668, 8), 92.953e-3),
             (swops.launch_bytes("permblock", n, 1024, 8), 38.385e-3),
             (swops.launch_bytes("matmul", n, 1024, 8), 139.558e-3),
             (fops.launch_bytes(n, n, 128, 896), 40.732e-3),
             (fops.launch_bytes(n, n, 128, 204, n_cols=10), 45.842e-3),
             (dops.launch_bytes(n, n, 128, symmetric=True), 4.652e-3)]
    for b, seconds in cases:
        assert b / seconds < hw.H100_SXM.hbm_bandwidth


# ---------------------------------------------------------------------------
# The build hook and the CLI.
# ---------------------------------------------------------------------------

def test_build_counts_builds_and_loads(tmp_path, monkeypatch):
    stub = tmp_path / "nvcc"
    stub.write_text("#!/bin/sh\nwhile [ $# -gt 0 ]; do\n"
                    "  if [ \"$1\" = -o ]; then touch \"$2\"; fi\n"
                    "  shift\ndone\n")
    stub.chmod(stub.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(_build, "find_nvcc", lambda: str(stub))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    source = tmp_path / "k.cu"
    source.write_text("// a kernel\n")
    obs.enable(trace=False, metrics=True)
    out = _build.build(source)
    assert out.exists() and out.parent == tmp_path / "build"
    snap = obs.metrics.snapshot()
    assert snap["counters"] == {"cuda.builds": 1.0}
    assert snap["histograms"]["cuda.build_seconds"]["count"] == 1
    assert _build.build(source) == out
    assert obs.metrics.value("cuda.loads") == 1.0
    assert obs.metrics.value("cuda.builds") == 1.0


@pytest.mark.parametrize("extra", [[], ["--from-features"]])
def test_cli_trace_and_metrics(tmp_path, capsys, extra):
    path = str(tmp_path / "cli.json")
    assert cli.main(["--samples", "48", "--perms", "19", "--device", "cpu",
                     "--trace", path, "--metrics", *extra]) == 0
    out = capsys.readouterr().out
    doc = json.load(open(path))
    names = {e["name"] for e in doc["traceEvents"]}
    assert "engine.sw" in names
    assert ("stage1.braycurtis" in names) == bool(extra)
    assert f"trace written to {path}" in out
    assert "predicted-vs-measured per stage" in out
    assert "engine.perm_chunks" in out
