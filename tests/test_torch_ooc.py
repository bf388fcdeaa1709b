"""The port's out-of-core tier: pipeline() on a slab cache.

- Identity: below 'hbm' the out-of-core sweep equals the in-memory fused
  bridge at row_block == slab_rows BIT FOR BIT (F, p, s_T and the whole
  null; per term for designs), for every metric, both forms ('fused',
  'fused-kernel'), labels, labels within strata and a dense design, on an
  odd slab of 23 rows, from a csr cache (jaccard f32 and packed) and from
  a directory path; the 'hbm' short circuit equals the resident run.
- Width: every registry rows function gives each pair the same bits on a
  (slab, n) call and on a (slab, slab) tile (exact equality).
- Against the reference: on the reference's draws, the port's out-of-core
  run against the reference's in-memory fused bridge: F at rtol 1e-4, p
  equal, the null within the f32 allowance of PERF.md §2 (2e-6 (F + (n -
  G) / (G - 1)); per design term 2e-6 s_T (K F + dof) / SS_resid).
- Planning: tier grading, the environment override, the traffic model
  and plan_slab_rows against the reference's on a grid (exact); the
  out-of-core plan's geometry and refusals; the card's footprint model.
"""

import functools
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

from repro import pipeline as jpipe  # noqa: E402
from repro.core import permutations as jperm  # noqa: E402
from repro.pipeline import planner as jplanner  # noqa: E402
from repro.pipeline import registry as jregistry  # noqa: E402
from repro_torch import pipeline  # noqa: E402
from repro_torch.data import slabcache  # noqa: E402
from repro_torch.kernels.distance import ops as dops  # noqa: E402
from repro_torch.pipeline import planner, registry, streaming  # noqa: E402

N, D, G = 100, 24, 4
SLAB = 23            # 100 = 4 x 23 + 8: an odd slab, a ragged last one
PERMS = 49
METRICS = ["aitchison", "braycurtis", "euclidean", "jaccard"]
FORMS = ["fused", "fused-kernel"]
MODES = ["labels", "strata", "design"]
HOST = 1024          # a device budget below every table here: 'host'
RTOL = 1e-4
NULL_RTOL = 2e-6     # PERF.md §2: 2 x SW_MAIN_RTOL


@functools.lru_cache(maxsize=None)
def _study(seed=0, n=N, d=D):
    rng = np.random.default_rng(seed)
    x = rng.gamma(1.0, 1.0, size=(n, d)).astype(np.float32)
    x *= rng.random(size=(n, d)) < 0.5
    x[:, 0] = np.maximum(x[:, 0], 1e-3)
    grouping = rng.integers(0, G, size=n).astype(np.int32)
    grouping[:G] = np.arange(G)
    cov = rng.normal(size=(n, 2))
    strata = (np.arange(n) % 4).astype(np.int32)
    return x, grouping, cov, strata


def _mode_kw(mode, seed=0):
    _, _, cov, strata = _study(seed)
    return {"labels": {}, "strata": {"strata": strata},
            "design": {"covariates": cov, "strata": strata}}[mode]


def _cache(tmp_path, x, fmt="dense", slab=SLAB):
    return slabcache.build_slab_cache(tmp_path / f"c_{fmt}_{slab}", x,
                                      slab_rows=slab, fmt=fmt)


def _assert_identical(res, ref):
    """Bit for bit: F, p, s_T and every null F (each term's, for a
    design)."""
    if ref.terms is None:
        assert torch.equal(res.f_perms, ref.f_perms)
        assert torch.equal(res.p_value, ref.p_value)
        assert torch.equal(res.s_t, ref.s_t)
        assert torch.equal(res.s_w, ref.s_w)
        return
    assert [t.name for t in res.terms] == [t.name for t in ref.terms]
    for a, b in zip(res.terms, ref.terms):
        assert torch.equal(a.f_perms, b.f_perms), a.name
        assert torch.equal(a.p_value, b.p_value), a.name


def _in_memory(x, grouping, **kw):
    return pipeline.pipeline(torch.from_numpy(x), grouping, n_perms=PERMS,
                             materialize="fused", row_block=SLAB,
                             n_groups=G, device="cpu", **kw)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("metric", METRICS)
def test_ooc_equals_the_fused_bridge_bit_for_bit(tmp_path, metric, form,
                                                 mode):
    x, grouping, _, _ = _study()
    kw = dict(metric=metric, **_mode_kw(mode))
    res = pipeline.pipeline(_cache(tmp_path, x), grouping, n_perms=PERMS,
                            materialize=form, n_groups=G,
                            device_budget_bytes=HOST, device="cpu", **kw)
    want = {"labels": f"pipeline[ooc-{form}]",
            "strata": f"pipeline[ooc-{form}+strata]",
            "design": f"pipeline-design[ooc-{form}]"}[mode]
    assert res.method == want
    assert "residency=host slabs=5x23" in res.plan
    assert f"tiles=25 ({metric}." in res.plan
    st = res.ooc_stats                   # the sweep's own OocStats
    assert (st.n_slabs, st.slab_rows, st.tiles) == (5, SLAB, 25)
    _assert_identical(res, _in_memory(x, grouping, **kw))


@pytest.mark.parametrize("packed", [0, 1])
def test_csr_jaccard_equals_the_fused_bridge_on_presence(tmp_path, packed):
    """A csr cache holds the presence structure; jaccard from it (f32, or
    packed words) equals the in-memory run on the 0/1 table."""
    x, grouping, _, _ = _study(1)
    cache = _cache(tmp_path, x, fmt="csr")
    tuning = {"packed": packed}
    res = pipeline.pipeline(cache, grouping, metric="jaccard",
                            n_perms=PERMS, dist_tuning=tuning,
                            device_budget_bytes=HOST, device="cpu")
    presence = (x > 0).astype(np.float32)
    _assert_identical(res, _in_memory(presence, grouping, metric="jaccard",
                                      dist_tuning=tuning))
    with pytest.raises(ValueError, match="presence"):
        pipeline.pipeline(cache, grouping, metric="braycurtis",
                          n_perms=PERMS, device_budget_bytes=HOST,
                          device="cpu")


def test_directory_path_runs_out_of_core(tmp_path):
    x, grouping, _, _ = _study(2)
    cache = _cache(tmp_path, x)
    res = pipeline.pipeline(cache.path, grouping, n_perms=PERMS,
                            device_budget_bytes=HOST, device="cpu")
    assert res.method == "pipeline[ooc-fused-kernel]"
    _assert_identical(res, _in_memory(x, grouping))


@pytest.mark.parametrize("mode", MODES)
def test_hbm_short_circuit_equals_the_resident_run(tmp_path, mode):
    x, grouping, _, _ = _study(3)
    kw = _mode_kw(mode, 3)
    res = pipeline.pipeline(_cache(tmp_path, x), grouping, n_perms=PERMS,
                            n_groups=G, device="cpu", **kw)
    assert res.plan.endswith("| features=slab-cache(residency=hbm)")
    ref = pipeline.pipeline(torch.from_numpy(x), grouping, n_perms=PERMS,
                            n_groups=G, device="cpu", **kw)
    assert res.plan.startswith(ref.plan)
    _assert_identical(res, ref)


def test_ordination_autotune_and_mesh_guards(tmp_path):
    x, grouping, _, _ = _study(4)
    cache = _cache(tmp_path, x)
    kw = dict(n_perms=PERMS, device_budget_bytes=HOST, device="cpu")
    with pytest.raises(ValueError, match="resident"):
        pipeline.pipeline(cache, grouping, ordination=2, **kw)
    with pytest.warns(UserWarning, match="autotune"):
        res = pipeline.pipeline(cache, grouping, autotune=True, **kw)
    _assert_identical(res, pipeline.pipeline(cache, grouping, **kw))
    with pytest.raises(ValueError, match="single-device"):
        pipeline.pipeline(cache, grouping, mesh=object(), **kw)


def test_ooc_sweep_reports_its_reads_and_tiles(tmp_path):
    x, grouping, _, _ = _study(5)
    cache = _cache(tmp_path, x)
    prepare, rows_fn, _ = registry.get("braycurtis.cuda").bound()
    inv_gs = torch.full((G,), 1.0 / 25)
    before = dict(dops.LAUNCHES)
    s_w, s_t, st = streaming.fused_sw_ooc(
        cache, prepare, rows_fn, torch.from_numpy(grouping), inv_gs,
        PERMS + 1, chunk=17)
    assert dops.LAUNCHES == before      # CPU tensors: the plain version
    assert (st.n_slabs, st.tiles, st.n_chunks) == (5, 25, 3)
    assert st.disk_bytes_read == registry.ooc_disk_traffic_bytes(
        cache.n_slabs, cache.disk_bytes)
    assert st.stall_s >= 0 and st.sweep_s > 0
    want, want_t, _ = streaming.fused_sw(
        prepare(torch.from_numpy(x)), rows_fn, torch.from_numpy(grouping),
        inv_gs, PERMS + 1, row_block=SLAB, chunk=17)
    assert torch.equal(s_w, want) and torch.equal(s_t, want_t)


@pytest.mark.parametrize("metric", METRICS)
def test_inplace_prepare_gives_the_prepare_bits(metric):
    """The sweep prepares its own fetched slabs in place
    (core.distance.inplace_prepare): the same bits as the copying prepare
    (exact equality), written into the slab itself."""
    from repro_torch.core import distance as cdist
    x, _, _, _ = _study(7)
    prepare, _, _ = registry.get(f"{metric}.cuda").bound()
    want = prepare(torch.from_numpy(x))
    slab = torch.from_numpy(x.copy())
    got = cdist.inplace_prepare(prepare)(slab)
    assert torch.equal(got, want)
    assert got.data_ptr() == slab.data_ptr()


def test_ooc_row_blocks_equal_mat2_row_blocks(tmp_path):
    """The generator's assembled row slabs, one preallocated buffer
    reused, equal mat2_row_blocks' slabs bit for bit (the ragged last one
    unpadded)."""
    x, _, _, _ = _study(6)
    cache = _cache(tmp_path, x)
    for metric in METRICS:
        prepare, rows_fn, _ = registry.get(f"{metric}.cuda").bound()
        want = list(streaming.mat2_row_blocks(
            prepare(torch.from_numpy(x)), rows_fn, block=SLAB))
        stats = {}
        got = [(lo, slab.clone()) for lo, slab in
               streaming.ooc_mat2_row_blocks(cache, prepare, rows_fn,
                                             device="cpu", stats=stats)]
        assert [lo for lo, _ in got] == [lo for lo, _ in want]
        for (_, a), (_, b) in zip(got, want):
            assert torch.equal(a, b), metric
        assert stats["tiles"] == cache.n_slabs ** 2


@pytest.mark.parametrize("kind", ["cuda", "blocked", "dense"])
@pytest.mark.parametrize("metric", METRICS)
def test_rows_functions_do_not_depend_on_the_call_width(metric, kind):
    """Each pair's bits on a (slab, n) call and on a (slab, slab) tile
    agree exactly: the CPU Gram forms multiply-and-sum per pair (a CPU
    matmul picks its blocking by width, which changed euclidean and
    aitchison in thousands of elements)."""
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.gamma(1.0, 1.0, (200, 64)).astype(np.float32))
    prepare, rows_fn, _ = registry.get(f"{metric}.{kind}").bound()
    xp = prepare(x)
    for lo in range(0, 200, SLAB):
        full = rows_fn(xp[lo:lo + SLAB], xp)
        for c in range(0, 200, SLAB):
            tile = rows_fn(xp[lo:lo + SLAB], xp[c:c + SLAB])
            assert torch.equal(tile, full[:, c:c + SLAB]), (lo, c)


# ---------------------------------------------------------------------------
# Against the reference, on its draws.
# ---------------------------------------------------------------------------

def _reference_draws(mode, grouping, strata, key):
    n_total = PERMS + 1
    if mode == "labels":
        p = jperm.permutation_batch(key, jnp.asarray(grouping), 0, n_total)
        return {"perms": torch.from_numpy(np.array(p))}
    if mode == "strata":
        p = jperm.strata_label_batch_dyn(key, jnp.asarray(grouping),
                                         jnp.asarray(strata), 0, n_total)
        return {"perms": torch.from_numpy(np.array(p))}
    p = jperm.strata_permutation_batch(key, jnp.asarray(strata), 0, n_total)
    return {"index_perms": torch.from_numpy(np.array(p))}


def _null_allowance(res):
    """PERF.md §2's f32 allowance on each null F (per term for a
    design)."""
    if res.terms is None:
        c = (res.n_objects - res.n_groups) / (res.n_groups - 1)
        return {None: NULL_RTOL * (res.f_perms.abs() + c)}
    k = sum(t.df for t in res.terms) + 1
    dof = res.n_objects - k
    e = NULL_RTOL / 2 * float(res.s_t)
    return {t.name: 2.0 * e * (k * t.f_perms.abs() + dof) / float(res.s_w)
            for t in res.terms}


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("metric", METRICS)
def test_ooc_matches_the_reference_fused_bridge(tmp_path, metric, mode):
    x, grouping, _, strata = _study(8)
    kw = dict(metric=metric, **_mode_kw(mode, 8))
    key = jax.random.key(11)
    ref = jpipe.pipeline(jnp.asarray(x), grouping, n_perms=PERMS,
                         materialize="fused", row_block=SLAB, n_groups=G,
                         key=key, **kw)
    res = pipeline.pipeline(_cache(tmp_path, x), grouping, n_perms=PERMS,
                            n_groups=G, device_budget_bytes=HOST,
                            device="cpu",
                            **_reference_draws(mode, grouping, strata, key),
                            **kw)
    pairs = ([(res, ref)] if ref.terms is None
             else list(zip(res.terms, ref.terms)))
    allow = _null_allowance(res)
    for t, u in pairs:
        name = getattr(t, "name", None)
        np.testing.assert_allclose(float(t.f_stat), float(u.f_stat),
                                   rtol=RTOL, err_msg=str(name))
        assert float(t.p_value) == float(u.p_value), name
        d_null = (t.f_perms.double()
                  - torch.from_numpy(np.asarray(u.f_perms, np.float64)))
        assert bool((d_null.abs() <= allow[name]).all()), (
            name, float(d_null.abs().max()))


# ---------------------------------------------------------------------------
# Planning.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("feature_bytes", [1, 2 ** 20, 2 ** 20 + 1, 2 ** 30,
                                           2 ** 30 + 1, 2 ** 40])
@pytest.mark.parametrize("device_budget", [2 ** 20, 2 ** 31])
def test_residency_tiers_and_traffic_equal_the_reference(feature_bytes,
                                                         device_budget):
    kw = dict(device_budget_bytes=device_budget, host_budget_bytes=2 ** 30)
    assert registry.residency_tier(feature_bytes, **kw) == \
        jregistry.residency_tier(feature_bytes, **kw)
    for n_slabs in (1, 4, 13):
        assert registry.ooc_disk_traffic_bytes(n_slabs, feature_bytes) == \
            jregistry.ooc_disk_traffic_bytes(n_slabs, feature_bytes)


@pytest.mark.parametrize("tier", registry.RESIDENCY_TIERS)
def test_tier_bandwidths_and_their_override(tier, monkeypatch):
    """On 'cpu' the reference's model, number for number; on 'cuda' the
    card's (no vmem there); $REPRO_TORCH_TIER_GBPS_<TIER> overrides the
    port's, and the reference's variable does not."""
    for var in (f"REPRO_TIER_GBPS_{tier.upper()}",
                registry.TIER_ENV_PREFIX + tier.upper()):
        monkeypatch.delenv(var, raising=False)
    assert registry.tier_bandwidth_gbps(tier, "cpu") == \
        jregistry.tier_bandwidth_gbps(tier, "cpu")
    if tier == "vmem":
        with pytest.raises(ValueError, match="shared memory"):
            registry.tier_bandwidth_gbps(tier, "cuda")
        assert tier not in registry.backend_tiers("cuda")
    else:
        assert registry.tier_bandwidth_gbps(tier, "cuda") == \
            registry.CUDA_TIER_GBPS[tier]
    monkeypatch.setenv(f"REPRO_TIER_GBPS_{tier.upper()}", "7.5")
    assert registry.tier_bandwidth_gbps(tier, "cpu") == \
        registry.CPU_TIER_GBPS[tier]
    monkeypatch.setenv(registry.TIER_ENV_PREFIX + tier.upper(), "5.5")
    assert registry.tier_bandwidth_gbps(tier, "cpu") == 5.5
    assert registry.tier_bandwidth_gbps(tier, "cuda") == 5.5


@pytest.mark.parametrize("n,d", [(100, 24), (25145, 128), (25145, 16384),
                                 (100000, 4096), (7, 3)])
@pytest.mark.parametrize("budget", [None, 2 ** 26, 2 ** 31, 64 * 2 ** 30])
def test_plan_slab_rows_equals_the_reference(n, d, budget):
    assert planner.plan_slab_rows(n, d, device_budget_bytes=budget) == \
        jplanner.plan_slab_rows(n, d, device_budget_bytes=budget)


def _ooc_plan(module, **kw):
    args = dict(features_on_disk=True, slab_rows=SLAB,
                features_disk_bytes=4 * N * D, device_budget_bytes=HOST)
    if module is planner:
        args["backend"] = kw.pop("backend", "cpu")
    args.update(kw)
    return module.plan_pipeline(N, D, PERMS + 1, G, **args)


@pytest.mark.parametrize("materialize", [None, "fused", "fused-kernel"])
@pytest.mark.parametrize("host_budget", [None, 2048])
def test_ooc_plan_equals_the_reference_on_cpu(materialize, host_budget):
    pl = _ooc_plan(planner, materialize=materialize,
                   host_budget_bytes=host_budget)
    ref = _ooc_plan(jplanner, materialize=materialize,
                    host_budget_bytes=host_budget)
    assert pl.residency == ref.residency == ("host" if host_budget is None
                                             else "disk")
    assert (pl.materialize, pl.row_block, pl.slab_rows, pl.disk_bytes) == \
        (ref.materialize, ref.row_block, ref.slab_rows, ref.disk_bytes)
    assert pl.row_block == SLAB
    assert (pl.sw.impl, pl.sw.chunk) == (ref.sw.impl, ref.sw.chunk)
    assert pl.fused_impl == (None if ref.fused_impl is None else
                             ref.fused_impl.replace(".xla", ".torch"))
    assert pl.ooc_footprint is None          # modelled for the card only
    text = pl.explain()
    for line in ("residency: ", "tier bandwidth model", "slab-cache traffic"):
        assert line in text
    assert text.splitlines()[1:4] == ref.explain().splitlines()[1:4]


def test_ooc_plan_refusals():
    for bad in ("dense", "stream"):
        with pytest.raises(ValueError, match="resident"):
            _ooc_plan(planner, materialize=bad)
    for impl in ("cuda", "pallas", "braycurtis.fusedk.cuda"):
        with pytest.raises(ValueError, match="resident feature table"):
            _ooc_plan(planner, backend="cuda", fused_impl=impl)
    with pytest.raises(ValueError, match="f32"):
        _ooc_plan(planner, fused_tuning=registry.precision_tuning("fp8"))
    with pytest.raises(ValueError, match="slab_rows"):
        _ooc_plan(planner, slab_rows=None)


def test_cuda_ooc_plan_models_its_footprint():
    """On the card the out-of-core plan models the sweep's device
    footprint and prints it; the EMP-width cell (25,145 x 16,384 f32,
    slabs of 2,048, a 1.5 GiB budget) fits, with the parts the sweep
    holds; a budget under the footprint raises naming the least."""
    n, d, slab = 25145, 16384, 2048
    budget = 1.5 * 2 ** 30
    pl = planner.plan_pipeline(
        n, d, 4000, 8, backend="cuda", features_on_disk=True,
        slab_rows=slab, features_disk_bytes=4 * n * d,
        device_budget_bytes=budget)
    assert pl.residency == "host" and pl.row_block == slab
    assert pl.fused_impl == "braycurtis.fusedk.torch"
    assert pl.dist_impl == "braycurtis.cuda"
    parts = pl.ooc_footprint
    assert parts["feature slabs"] == 5 * 4 * slab * d
    assert parts["mat2 row slab"] == 4 * slab * n
    assert "prepared slabs" not in parts
    # the slab phase (tiles) and the label phase (labels) never overlap;
    # the feature slabs, the mat2 row slab and the slack count in both
    assert parts["labels"] > parts["tiles"]
    assert pl.ooc_peak == sum(parts.values()) - parts["tiles"]
    assert pl.ooc_peak <= budget
    assert "sweep device footprint" in pl.explain()

    def ooc(metric, rows, **kw):
        return planner.plan_pipeline(
            n, d, 4000, 8, backend="cuda", metric=metric,
            features_on_disk=True, slab_rows=rows, features_disk_bytes=10,
            device_budget_bytes=budget, **kw)
    # clr and presence run in place on the fetched slabs: aitchison and
    # jaccard hold what braycurtis holds; packed jaccard adds its words
    for metric in ("aitchison", "jaccard"):
        assert ooc(metric, slab).ooc_footprint == parts
    jac = ooc("jaccard", slab // 2, dist_tuning={"packed": 1})
    assert jac.ooc_footprint["prepared slabs"] == 4 * slab // 2 * d // 4
    # a slab phase larger than the label phase sets the peak
    assert planner.ooc_peak_bytes(
        {"feature slabs": 10, "prepared slabs": 5, "tiles": 3, "labels": 4,
         "mat2 row slab": 2, "slack": 1}) == 10 + 2 + 1 + 8
    need = pl.ooc_peak
    with pytest.raises(ValueError, match=f"device_budget_bytes >= {need}"):
        planner.plan_pipeline(
            n, d, 4000, 8, backend="cuda", features_on_disk=True,
            slab_rows=slab, features_disk_bytes=4 * n * d,
            device_budget_bytes=need - 1)


def test_cli_builds_then_reopens_a_features_cache(tmp_path, capsys):
    """--features-cache builds the cache from the synthetic study on first
    use and opens it after that; below the device budget the run is out
    of core, at the default budget the resident path, with one F."""
    from repro_torch.launch import permanova as cli
    argv = ["--samples", "61", "--features", "12", "--groups", "4",
            "--perms", "19", "--device", "cpu", "--features-cache",
            str(tmp_path / "cache"), "--slab-rows", "16"]
    assert cli.main(argv + ["--device-budget-mb", "0.001"]) == 0
    built = capsys.readouterr().out
    assert "built slab cache" in built and "4 slabs x 16 rows" in built
    assert "residency=host slabs=4x16" in built
    assert cli.main(argv + ["--device-budget-mb", "0.001"]) == 0
    reopened = capsys.readouterr().out
    assert "opened slab cache" in reopened
    assert cli.main(argv) == 0
    resident = capsys.readouterr().out
    assert "features=slab-cache(residency=hbm)" in resident

    def f_line(out):
        return [ln for ln in out.splitlines() if " F=" in ln]
    assert f_line(built) == f_line(reopened)
    assert float(f_line(resident)[0].split("F=")[1].split()[0]) == \
        pytest.approx(float(f_line(built)[0].split("F=")[1].split()[0]),
                      rel=RTOL)
