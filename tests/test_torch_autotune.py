"""The port's measured autotune and its persisted cache against the
reference: the cache's robustness (two writers, schema migrate-or-drop, a
failed write, a truncated file), its separation (its own variable and
file, keys by device kind), the shoot-outs of the engine and the pipeline
and the plans that read their winners, and --autotune on the CLI. Every
test points REPRO_TORCH_AUTOTUNE_CACHE at its own tmp_path."""

import dataclasses
import json
import logging
import os
import subprocess
import sys
import time
import warnings

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
from repro import pipeline as jpipe  # noqa: E402
from repro.core import permutations as jperm  # noqa: E402
from repro.engine import planner as jplanner  # noqa: E402
from repro_torch import engine, pipeline  # noqa: E402
from repro_torch.core import design  # noqa: E402
from repro_torch.engine import planner, registry  # noqa: E402
from repro_torch.kernels import ShapeNotSupported  # noqa: E402
from repro_torch.launch import permanova as cli  # noqa: E402
from repro_torch.pipeline import planner as pplanner  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(REPO, "src")
N, D, G, N_PERMS = 40, 12, 3, 49
F_RTOL = 1e-4        # the repo's bar: F at rtol 1e-4, p equal
H100 = "cuda:NVIDIA H100 80GB HBM3"


@pytest.fixture(autouse=True)
def cache(tmp_path, monkeypatch):
    """This test's own cache file (the default path is never written)."""
    path = tmp_path / "autotune.json"
    monkeypatch.setenv(planner.AUTOTUNE_CACHE_ENV, str(path))
    planner.load_autotune_cache(reload=True)
    return path


def _study(n=N, d=D, g=G, seed=3):
    rng = np.random.default_rng(seed)
    x = rng.gamma(1.0, 1.0, size=(n, d)).astype(np.float32)
    x *= rng.random(size=(n, d)) < 0.6
    x[:, 0] = np.maximum(x[:, 0], 1e-3)
    grouping = rng.integers(0, g, size=n).astype(np.int32)
    grouping[:g] = np.arange(g)
    return x, grouping


def _dm(x):
    from repro_torch.core import distance
    return distance.distance_matrix(torch.from_numpy(x), "braycurtis")


def _ref_perms(grouping, seed=0):
    p = jperm.permutation_batch(jax.random.key(seed), jnp.asarray(grouping),
                                0, N_PERMS + 1)
    return torch.from_numpy(np.array(p))


# ---------------------------------------------------------------------------
# The cache file (counterparts of tests/test_autotune_cache.py).
# ---------------------------------------------------------------------------

WRITER = r"""
import sys, time
from repro_torch.engine import planner

name, n_writes, settle = sys.argv[1], int(sys.argv[2]), float(sys.argv[3])
for i in range(n_writes):
    planner.record_entry(f"dist|cpu|stress|{name}", {
        "impl": name, "ms": float(i), "bucket": 32, "i": i})
# a staggered last write re-reads the file first, so the last publisher
# has seen the other writer's key
time.sleep(settle)
planner.load_autotune_cache(reload=True)
planner.record_entry(f"dist|cpu|stress|{name}", {
    "impl": name, "ms": -1.0, "bucket": 32})
print("WRITER-DONE", name)
"""


def test_two_writers_never_corrupt_cache(cache, tmp_path):
    """Two processes hammering record_entry on one file: every read in
    between parses as a whole JSON document (atomic publish), no temp
    file is left, and both writers' keys survive (merge on save)."""
    env = dict(os.environ)
    env[planner.AUTOTUNE_CACHE_ENV] = str(cache)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    procs = [subprocess.Popen(
        [sys.executable, "-c", WRITER, name, "40", settle], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for name, settle in (("writerA", "0.3"), ("writerB", "0.9"))]
    deadline = time.time() + 120
    parses = 0
    while any(p.poll() is None for p in procs):
        if time.time() > deadline:
            for p in procs:
                p.kill()
            raise AssertionError("writers did not finish in time")
        if cache.exists():
            data = json.loads(cache.read_text())
            assert isinstance(data, dict)
            parses += 1
        time.sleep(0.005)
    for p in procs:
        out, err = p.communicate(timeout=60)
        assert p.returncode == 0, f"writer failed:\n{out}\n{err}"
        assert "WRITER-DONE" in out
    assert parses > 0
    data = json.loads(cache.read_text())
    assert "dist|cpu|stress|writerA" in data
    assert "dist|cpu|stress|writerB" in data
    assert all("impl" in v for v in data.values())
    assert not [p for p in os.listdir(tmp_path) if ".tmp." in p]


def test_schema_migrate_or_drop(cache):
    """dist| / fusedk| entries without the current schema are dropped on
    load; the s_W shoot-out keys (no schema) are kept; record_entry
    stamps the schema and a dropped key is not written back."""
    cache.write_text(json.dumps({
        "fusedk|cpu|jaccard|jaccard.fusedk.torch": {
            "impl": "jaccard.fusedk.torch", "ms": 1.0, "bucket": 64},
        "dist|cpu|jaccard|jaccard.blocked": {
            "impl": "jaccard.blocked", "ms": 2.0, "bucket": 64},
        "fusedk|cpu|euclidean|euclidean.fusedk.torch": {
            "impl": "euclidean.fusedk.torch", "ms": 3.0, "bucket": 64,
            "schema": 1},
        "fusedk|cpu|braycurtis|braycurtis.fusedk.torch|fp8": {
            "impl": "braycurtis.fusedk.torch", "ms": 4.0, "bucket": 64,
            "schema": planner.CACHE_SCHEMA},
        "cpu|n64|g8": {"impl": "matmul", "candidates": ["matmul"]},
    }))
    data = planner.load_autotune_cache(reload=True)
    assert set(data) == {"fusedk|cpu|braycurtis|braycurtis.fusedk.torch|fp8",
                         "cpu|n64|g8"}
    planner.record_entry("fusedk|cpu|jaccard|jaccard.fusedk.torch", {
        "impl": "jaccard.fusedk.torch", "ms": 6.0, "bucket": 64,
        "tuning": {"feat_packed": 1}})
    data = planner.load_autotune_cache(reload=True)
    entry = data["fusedk|cpu|jaccard|jaccard.fusedk.torch"]
    assert entry["schema"] == planner.CACHE_SCHEMA
    assert entry["tuning"]["feat_packed"] == 1
    on_disk = json.loads(cache.read_text())
    assert "dist|cpu|jaccard|jaccard.blocked" not in on_disk
    assert "cpu|n64|g8" in on_disk


def test_failed_write_leaves_no_temp(cache, tmp_path, monkeypatch):
    """A writer that dies mid-serialization leaves no temp file and no
    cache file."""
    def boom(*a, **k):
        raise KeyboardInterrupt("simulated death mid-write")

    monkeypatch.setattr(json, "dump", boom)
    with pytest.raises(KeyboardInterrupt):
        planner.record_entry("dist|cpu|x|doomed", {
            "impl": "doomed", "ms": 1.0, "bucket": 32})
    monkeypatch.undo()
    assert not [p for p in os.listdir(tmp_path) if ".tmp." in p]
    assert not cache.exists()


def test_truncated_cache_quarantined_and_served_empty(cache, caplog):
    """A truncated document is quarantined under `.corrupt`, warned about
    once, served as an empty cache, and new measurements persist."""
    planner.record_entry("dist|cpu|x|ok", {"impl": "ok", "ms": 1.0,
                                           "bucket": 32})
    text = cache.read_text()
    cache.write_text(text[:len(text) // 2])
    planner._WARNED.discard("corrupt")
    with caplog.at_level(logging.WARNING, logger=planner.__name__):
        assert planner.load_autotune_cache(reload=True) == {}
        assert planner.load_autotune_cache(reload=True) == {}
    warned = [r for r in caplog.records if "corrupt" in r.getMessage()]
    assert len(warned) == 1
    assert os.path.exists(str(cache) + ".corrupt") and not cache.exists()
    planner.record_entry("dist|cpu|x|fresh", {"impl": "fresh", "ms": 2.0,
                                              "bucket": 32})
    assert set(json.loads(cache.read_text())) == {"dist|cpu|x|fresh"}


def test_cache_is_the_ports_own(monkeypatch):
    """Its own variable and default file, apart from the reference's;
    'off' disables it."""
    assert planner.AUTOTUNE_CACHE_ENV == "REPRO_TORCH_AUTOTUNE_CACHE"
    assert planner.AUTOTUNE_CACHE_ENV != jplanner.AUTOTUNE_CACHE_ENV
    monkeypatch.delenv(planner.AUTOTUNE_CACHE_ENV)
    monkeypatch.delenv(jplanner.AUTOTUNE_CACHE_ENV, raising=False)
    mine = planner.autotune_cache_path()
    assert mine == os.path.join(os.path.expanduser("~"), ".cache",
                                "repro_torch", "autotune.json")
    assert mine != jplanner.autotune_cache_path()
    monkeypatch.setenv(planner.AUTOTUNE_CACHE_ENV, "off")
    assert planner.autotune_cache_path() is None


# ---------------------------------------------------------------------------
# The s_W shoot-out.
# ---------------------------------------------------------------------------

def test_cpu_shootout_persists_winner_read_by_plan(cache):
    """engine.run(autotune=True) measures every registered impl once,
    persists the winner under the CPU's kind, matches the reference (F at
    rtol 1e-4, p equal, on the reference's labels); a later plan reads
    the winner back and a second tuned run measures nothing."""
    x, grouping = _study()
    dm = _dm(x)
    perms = _ref_perms(grouping)
    before = planner.MEASURED["sw"]
    res = engine.run(dm, torch.from_numpy(grouping), n_perms=N_PERMS,
                     perms=perms, autotune=True, device="cpu")
    assert planner.MEASURED["sw"] == before + 1
    assert "empirical autotune winner" in res.plan
    ref = jengine.run(jnp.asarray(dm.numpy()), jnp.asarray(grouping),
                      n_perms=N_PERMS, key=jax.random.key(0))
    np.testing.assert_allclose(float(res.f_stat), float(ref.f_stat),
                               rtol=F_RTOL)
    assert float(res.p_value) == float(ref.p_value)

    data = json.loads(cache.read_text())
    entry = data[f"cpu|n{planner._bucket(N)}|g{G}"]
    assert entry["candidates"] == registry.names()
    assert set(entry["times_ms"]) == set(registry.names())
    assert entry["impl"] == min(entry["times_ms"],
                                key=entry["times_ms"].get)
    assert entry["sample_perms"] == planner.SAMPLE_PERMS
    assert entry["calls"] == planner.TIMED_CALLS >= 3

    planner.load_autotune_cache(reload=True)          # a new process
    pl = planner.plan(N, N_PERMS + 1, backend="cpu", n_groups=G)
    assert pl.impl == entry["impl"]
    assert pl.reason.startswith("persisted autotune measurement")
    again = engine.run(dm, torch.from_numpy(grouping), n_perms=N_PERMS,
                       perms=perms, autotune=True, device="cpu")
    assert planner.MEASURED["sw"] == before + 1
    assert torch.equal(again.f_perms, res.f_perms)
    plain = engine.run(dm, torch.from_numpy(grouping), n_perms=N_PERMS,
                       perms=perms, device="cpu")
    assert "persisted autotune measurement" in plain.plan


def test_restricted_shootout_does_not_overwrite_broader(cache):
    """A shoot-out over a subset of the candidates never replaces a
    broader persisted one, and a broader request does not trust a
    restricted winner."""
    x, grouping = _study()
    dm = _dm(x)
    mat2 = dm * dm
    g = torch.from_numpy(grouping)
    inv_gs = engine.api.permutations.inv_group_sizes(g, G)
    key = f"cpu|n{planner._bucket(N)}|g{G}"
    planner.autotune(mat2, g, inv_gs, candidates=["brute", "tiled"])
    narrow = json.loads(cache.read_text())[key]
    assert narrow["candidates"] == ["brute", "tiled"]
    assert planner.measured_impl("cpu", N, G) is None
    planner.autotune(mat2, g, inv_gs)
    broad = json.loads(cache.read_text())[key]
    assert broad["candidates"] == registry.names()
    planner.autotune(mat2, g, inv_gs, candidates=["matmul"])
    assert json.loads(cache.read_text())[key] == broad
    assert planner.measured_impl("cpu", N, G) == broad["impl"]


def test_device_kind_in_the_key(cache):
    """A card's entry is never read by a cpu plan (nor by a plan for the
    card made without one), and a cpu entry by none but cpu plans."""
    names = registry.names()
    cache.write_text(json.dumps({
        f"{H100}|n64|g{G}": {"impl": "brute", "candidates": names},
        f"cuda:NVIDIA A100-SXM4-80GB|n64|g{G}": {"impl": "tiled",
                                                 "candidates": names}}))
    planner.load_autotune_cache(reload=True)
    pl = planner.plan(N, N_PERMS + 1, backend="cpu", n_groups=G)
    assert pl.impl == "matmul" and "persisted" not in pl.reason
    assert planner.device_kind("cpu") == "cpu"
    if not torch.cuda.is_available():
        assert planner.device_kind("cuda") is None
        assert planner.measured_impl("cuda", N, G) is None
        assert planner.plan(N, N_PERMS + 1, backend="cuda",
                            n_groups=G).impl == "brute"
    cache.write_text(json.dumps({f"cpu|n64|g{G}": {
        "impl": "tiled", "candidates": names}}))
    planner.load_autotune_cache(reload=True)
    assert planner.plan(N, N_PERMS + 1, backend="cpu",
                        n_groups=G).impl == "tiled"
    assert planner.plan(N, N_PERMS + 1, backend="cpu", n_groups=G + 1,
                        ).impl == "matmul"


def test_tiled_winner_keeps_its_chunk_model(cache):
    """A measured winner still goes through its own chunk model: a tiled
    winner on the card is charged permblock's partials."""
    names = registry.names()
    n = 25145
    kind = planner.device_kind("cpu")
    cache.write_text(json.dumps({f"{kind}|n{planner._bucket(n)}|g8": {
        "impl": "tiled", "candidates": names}}))
    planner.load_autotune_cache(reload=True)
    pl = planner.plan(n, 4000, backend="cpu", n_groups=8)
    assert pl.impl == "tiled"
    assert pl.chunk == planner.plan(n, 4000, backend="cpu",
                                    impl="tiled").chunk
    card = planner.plan(n, 4000, backend="cuda", impl="tiled")
    assert card.chunk < planner.plan(n, 4000, backend="cuda",
                                     impl="brute").chunk


def test_only_a_shape_the_kernel_cannot_take_skips_a_candidate(monkeypatch):
    """kernels.ShapeNotSupported skips a candidate; any other failure of a
    candidate raises (a kernel's build or launch error is not
    swallowed)."""
    x, grouping = _study()
    mat2 = _dm(x) ** 2
    g = torch.from_numpy(grouping)
    inv_gs = engine.api.permutations.inv_group_sizes(g, G)

    def swap(err):
        def plain(*a, **k):
            raise err
        monkeypatch.setitem(registry._REGISTRY, "tiled", dataclasses.replace(
            registry.get("tiled"), plain=plain, tuning={}))

    swap(ShapeNotSupported("exceeds the permblock kernel's grid"))
    assert planner.autotune(mat2, g, inv_gs, use_cache=False) in (
        "brute", "matmul")
    swap(RuntimeError("nvcc failed"))
    with pytest.raises(RuntimeError, match="nvcc failed"):
        planner.autotune(mat2, g, inv_gs, use_cache=False)


def test_pinned_impl_and_dense_design_warn(cache):
    x, grouping = _study()
    dm = _dm(x)
    g = torch.from_numpy(grouping)
    with pytest.warns(UserWarning, match="impl is pinned"):
        res = engine.run(dm, g, n_perms=9, impl="brute", autotune=True,
                         device="cpu")
    assert res.plan.startswith("brute[") and not cache.exists()
    cov = np.random.default_rng(1).normal(size=(N, 2))
    with pytest.warns(UserWarning, match="dense designs"):
        engine.run(dm, g, n_perms=9, covariates=cov, autotune=True,
                   device="cpu")
    assert not cache.exists()
    # a labels-mode design (one factor within strata) is measured
    strata = np.repeat(np.arange(4), N // 4).astype(np.int32)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        res = engine.run(dm, g, n_perms=9, strata=strata, autotune=True,
                         device="cpu")
    assert "empirical autotune winner" in res.plan and cache.exists()
    d = design.build(grouping=grouping, strata=strata, device="cpu")
    assert "empirical autotune winner" in engine.run_design(
        dm, d, n_perms=9, autotune=True, device="cpu").plan


# ---------------------------------------------------------------------------
# The pipeline's shoot-outs.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bridge", ["dense", "stream"])
def test_stage1_shootout_persists_and_plans_read_it(cache, bridge):
    """On the dense and stream bridges autotune measures the stage-1
    candidates (and the s_W impl), matching the reference's F and p on
    its labels; plan_pipeline then reads the stage-1 winner back."""
    x, grouping = _study()
    perms = _ref_perms(grouping)
    res = pipeline.pipeline(torch.from_numpy(x), torch.from_numpy(grouping),
                            n_perms=N_PERMS, perms=perms, materialize=bridge,
                            autotune=True, device="cpu")
    ref = jpipe.pipeline(jnp.asarray(x), jnp.asarray(grouping),
                         n_perms=N_PERMS, key=jax.random.key(0),
                         materialize=bridge)
    np.testing.assert_allclose(float(res.f_stat), float(ref.f_stat),
                               rtol=F_RTOL)
    assert float(res.p_value) == float(ref.p_value)
    assert "empirical autotune winner" in res.plan
    data = json.loads(cache.read_text())
    cands = pplanner._stage1_candidates("braycurtis", "cpu")
    for c in cands:
        e = data[f"dist|cpu|braycurtis|{c}"]
        assert e["schema"] == planner.CACHE_SCHEMA and e["ms"] > 0
    planner.load_autotune_cache(reload=True)
    before = dict(planner.MEASURED)
    pl = pplanner.plan_pipeline(N, D, N_PERMS + 1, G, backend="cpu",
                                materialize=bridge)
    assert pl.reason.startswith("persisted stage-1 autotune measurement")
    assert pl.dist_impl == min(
        cands, key=lambda c: data[f"dist|cpu|braycurtis|{c}"]["ms"])
    assert pplanner.autotune_stage1(torch.from_numpy(x), "braycurtis") \
        == pl.dist_impl
    assert dict(planner.MEASURED) == before
    on_card = pplanner.plan_pipeline(N, D, N_PERMS + 1, G, backend="cuda",
                                     materialize=bridge)
    assert on_card.dist_impl == "braycurtis.cuda"
    assert pplanner._stage1_candidates("braycurtis", "cuda") == \
        ["braycurtis.cuda"]


def test_fused_shootout_on_the_fused_kernel_bridge(cache):
    """On the fused-kernel bridge autotune measures the fused candidates
    (one on each device: the torch sweep here, the megakernel on the
    card), keyed with the precision; the plan reads the winner back."""
    x, grouping = _study()
    perms = _ref_perms(grouping)
    res = pipeline.pipeline(torch.from_numpy(x), torch.from_numpy(grouping),
                            n_perms=N_PERMS, perms=perms,
                            materialize="fused-kernel", autotune=True,
                            device="cpu")
    ref = jpipe.pipeline(jnp.asarray(x), jnp.asarray(grouping),
                         n_perms=N_PERMS, key=jax.random.key(0),
                         materialize="fused-kernel")
    np.testing.assert_allclose(float(res.f_stat), float(ref.f_stat),
                               rtol=F_RTOL)
    assert float(res.p_value) == float(ref.p_value)
    data = json.loads(cache.read_text())
    entry = data["fusedk|cpu|braycurtis|braycurtis.fusedk.torch"]
    assert entry["tuning"] == {"feat_bf16": 0, "feat_fp8": 0}
    assert pplanner._fused_candidates("braycurtis", "cuda") == \
        ["braycurtis.fusedk.cuda"]
    assert pplanner._fused_key("cpu", "braycurtis", "b", {"feat_fp8": 1}) \
        .endswith("|fp8")
    pl = pplanner.plan_pipeline(N, D, N_PERMS + 1, G, backend="cpu",
                                materialize="fused-kernel")
    assert "persisted fused-kernel autotune measurement" in pl.reason
    fp8 = pplanner.plan_pipeline(N, D, N_PERMS + 1, G, backend="cpu",
                                 materialize="fused-kernel",
                                 fused_tuning={"feat_fp8": 1})
    assert "persisted fused-kernel" not in fp8.reason
    with pytest.warns(UserWarning, match="fused bridge"):
        pipeline.pipeline(torch.from_numpy(x), torch.from_numpy(grouping),
                          n_perms=9, materialize="fused", autotune=True,
                          device="cpu")


def test_cli_autotune(cache, capsys):
    """--autotune measures and persists; a later run without it plans the
    persisted winner."""
    argv = ["--samples", "48", "--perms", "19", "--device", "cpu"]
    assert cli.main(argv + ["--autotune"]) == 0
    out = capsys.readouterr().out
    assert "empirical autotune winner" in out and cache.exists()
    planner.load_autotune_cache(reload=True)
    assert cli.main(argv) == 0
    assert "persisted autotune measurement" in capsys.readouterr().out
    assert cli.main(argv + ["--from-features", "--autotune"]) == 0
    out = capsys.readouterr().out
    assert "empirical autotune winner" in out
    assert any(k.startswith("dist|cpu|braycurtis|")
               for k in json.loads(cache.read_text()))
