"""The port's engine against the reference's: engine.run with the
reference's own label draws (F at rtol=1e-4, p exactly equal) in batch and
streaming mode, the planner's rules and plan strings, the registry, the
scheduler's chunk invariance, the CLI, and the no-card behaviour."""

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

from repro import engine as jengine  # noqa: E402
from repro.core import permutations as jperm  # noqa: E402
from repro.data import microbiome as jmicro  # noqa: E402
from repro.core import distance as jdist  # noqa: E402
from repro_torch import engine  # noqa: E402
from repro_torch.compat import from_reference  # noqa: E402
from repro_torch.core import fstat  # noqa: E402
from repro_torch.engine import planner, registry, scheduler  # noqa: E402
from repro_torch.launch import permanova as cli  # noqa: E402

# (n, n_features, n_groups, effect, seed, n_perms)
STUDIES = {
    "null48": (48, 32, 3, 0.0, 7, 99),
    "effect61": (61, 24, 4, 0.4, 3, 79),
}


def _study(name):
    n, d, g, effect, seed, n_perms = STUDIES[name]
    x, grouping = jmicro.synthetic_study(n, d, g, effect_size=effect,
                                         seed=seed)
    dm = np.asarray(jdist.braycurtis(jnp.asarray(x)))
    key = jax.random.key(seed + 100)
    perms = jperm.permutation_batch(key, jnp.asarray(grouping), 0,
                                    n_perms + 1)
    return dm, grouping, key, perms, n_perms


@pytest.mark.parametrize("mode", ["batch", "stream"])
@pytest.mark.parametrize("impl", ["brute", "tiled", "matmul"])
@pytest.mark.parametrize("study", sorted(STUDIES))
def test_run_matches_reference(study, impl, mode):
    dm, grouping, key, perms, n_perms = _study(study)
    chunk = 32 if mode == "stream" else None
    res_j = jengine.run(jnp.asarray(dm), jnp.asarray(grouping),
                        n_perms=n_perms, key=key, impl=impl, chunk=chunk)
    dm_t, g_t, perms_t = from_reference(dm, grouping, perms, device="cpu")
    res_t = engine.run(dm_t, g_t, n_perms=n_perms, perms=perms_t, impl=impl,
                       chunk=chunk, device="cpu")
    np.testing.assert_allclose(float(res_t.f_stat), float(res_j.f_stat),
                               rtol=1e-4)
    assert float(res_t.p_value) == float(res_j.p_value)
    np.testing.assert_allclose(res_t.f_perms.numpy(),
                               np.asarray(res_j.f_perms), rtol=1e-4)
    # the same plan string, the backend name aside
    assert res_t.plan == res_j.plan
    assert res_t.method == res_j.method


@pytest.mark.parametrize("alias,name", sorted(registry.ALIASES.items()))
def test_pallas_aliases_match_reference_kernels(alias, name):
    """`--impl pallas_*` keeps its choices: the port's alias runs its
    impl, the reference its Pallas kernel (interpret mode)."""
    dm, grouping, key, perms, n_perms = _study("effect61")
    res_j = jengine.run(jnp.asarray(dm), jnp.asarray(grouping),
                        n_perms=n_perms, key=key, impl=alias,
                        tuning={"tile_r": 32, "tile_c": 32, "perm_block": 8})
    dm_t, g_t, perms_t = from_reference(dm, grouping, perms, device="cpu")
    res_t = engine.run(dm_t, g_t, n_perms=n_perms, perms=perms_t,
                       impl=alias, device="cpu")
    assert res_t.method == f"permanova[{name}]"
    np.testing.assert_allclose(float(res_t.f_stat), float(res_j.f_stat),
                               rtol=1e-4)
    assert float(res_t.p_value) == float(res_j.p_value)


# ---------------------------------------------------------------------------
# Planner.
# ---------------------------------------------------------------------------

def test_planner_paper_rules():
    assert planner.plan(25145, 4000, backend="cuda").impl == "brute"
    assert planner.plan(512, 1000, backend="cpu").impl == "matmul"
    assert planner.plan(4096, 1000, backend="cpu").impl == "tiled"


def test_emp_shape_streams_two_chunks():
    """The paper's EMP shape under the default 256 MiB label budget: the
    scheduler really streams (2,668 + 1,332 permutations)."""
    pl = planner.plan(25145, 4000, backend="cuda")
    assert pl.streaming and pl.chunk == 2668
    assert -(-4000 // pl.chunk) == 2
    assert pl.chunk == jengine.chunk_for_budget(
        25145, 4000, jengine.get("brute"), 8)


@pytest.mark.parametrize("n,n_total,kw", [
    (512, 1000, {}),
    (4096, 1000, {}),
    (3000, 50000, {"memory_budget_bytes": 2 ** 24}),
    (100, 1000, {"chunk": 128}),
    (100, 1000, {"impl": "tiled"}),
    (100, 1000, {"impl": "matmul", "chunk": 5000}),
])
def test_plan_describe_matches_reference_on_cpu(n, n_total, kw):
    got = planner.plan(n, n_total, backend="cpu", **kw)
    want = jengine.plan(n, n_total, 8, backend="cpu", **kw)
    assert got.describe() == want.describe()
    assert (got.chunk, got.streaming) == (want.chunk, want.streaming)


@pytest.mark.parametrize("impl,kernel", [
    ("brute", "brute"), ("tiled", "permblock"), ("matmul", "matmul")])
def test_plan_on_cuda_names_the_kernel_not_plain_knobs(impl, kernel):
    """On the card the kernel runs, so the plan carries none of the plain
    form's knobs and names the kernel instead."""
    pl = planner.plan(2000, 1000, backend="cuda", impl=impl)
    assert pl.tuning == {} and pl.kernel == kernel
    assert pl.describe() == (f"{impl}[{kernel} kernel] batch on cuda: "
                             "caller-pinned impl")
    assert planner.plan(2000, 1000, backend="cpu", impl=impl).kernel is None


@pytest.mark.parametrize("n,n_total,budget", [
    (25145, 4000, None), (25145, 1000, None), (10000, 50000, 2 ** 26),
    (2049, 100000, None)])
def test_cuda_tiled_chunk_charges_the_permblock_partials(n, n_total, budget):
    """On the card the tiled impl runs the permblock kernel, whose
    partials are (blocks, chunk) f32: the plan charges them beside the
    (chunk, n) labels, so labels plus partials (plus the per-permutation
    output) stay inside the label budget, and one permutation more would
    not fit. At the EMP shape that is 2,224 a chunk (5,025 blocks), still
    2 chunks for 4,000. Brute's and matmul's chunks, and every cpu plan,
    stay the reference's."""
    from repro_torch.kernels.permanova_sw import ops
    pl = planner.plan(n, n_total, backend="cuda", impl="tiled",
                      memory_budget_bytes=budget)
    limit = planner.label_budget(budget)
    per_perm = 4 * n + 8 + 4 * ops.permblock_blocks(n)
    assert pl.kernel == "permblock"
    assert pl.chunk * per_perm <= limit
    assert pl.chunk == n_total or (pl.chunk + 1) * per_perm > limit
    if (n, n_total, budget) == (25145, 4000, None):
        assert ops.permblock_blocks(n) == 5025
        assert pl.chunk == 2224 and -(-n_total // pl.chunk) == 2
    for impl in ("brute", "matmul"):
        assert planner.plan(n, n_total, backend="cuda", impl=impl,
                            memory_budget_bytes=budget).chunk == \
            planner.chunk_for_budget(n, n_total, budget)
    got = planner.plan(n, n_total, backend="cpu", impl="tiled",
                       memory_budget_bytes=budget)
    want = jengine.plan(n, n_total, 8, backend="cpu", impl="tiled",
                        memory_budget_bytes=budget)
    assert (got.chunk, got.describe()) == (want.chunk, want.describe())


def test_chunk_for_budget_warns_below_minimum():
    with pytest.warns(UserWarning, match="minimum chunk"):
        assert planner.chunk_for_budget(10_000, 5000, 1024) == \
            planner.MIN_CHUNK


# ---------------------------------------------------------------------------
# Registry and scheduler.
# ---------------------------------------------------------------------------

def test_registry_names_aliases_and_kernels():
    assert registry.names() == ["brute", "matmul", "tiled"]
    for alias, name in registry.ALIASES.items():
        assert registry.get(alias) is registry.get(name)
    assert {registry.get(n).kernel for n in registry.names()} == \
        {"brute", "permblock", "matmul"}
    with pytest.raises(KeyError, match="unknown s_W impl"):
        registry.get("fused")
    with pytest.raises(ValueError, match="duplicate"):
        registry.register(registry.get("brute"))


@pytest.mark.parametrize("name", ["brute", "tiled", "matmul"])
def test_registry_cpu_dispatch_is_plain_form(name):
    rng = np.random.default_rng(0)
    d = rng.random((33, 33)).astype(np.float32)
    mat2 = torch.from_numpy(((d + d.T) / 2) ** 2).fill_diagonal_(0.0)
    labels = torch.from_numpy(
        np.stack([rng.permutation(np.arange(33) % 3) for _ in range(5)])
        .astype(np.int32))
    w = torch.full((3,), 1 / 11, dtype=torch.float32)
    plain = {"brute": fstat.sw_brute, "tiled": fstat.sw_tiled,
             "matmul": fstat.sw_matmul}[name]
    fn = registry.get(name).bound(bogus=3)
    torch.testing.assert_close(fn(mat2, labels, w), plain(mat2, labels, w),
                               rtol=0, atol=0)


@pytest.mark.parametrize("impl", ["brute", "tiled", "matmul"])
def test_streaming_equals_batch(impl):
    """Chunked sweeps reproduce the one-shot sweep: labels depend on the
    global permutation index only."""
    dm, grouping, _, _, _ = _study("null48")
    dm_t, g_t, _ = from_reference(dm, grouping, device="cpu")
    mat2 = dm_t * dm_t
    w = engine.api.permutations.inv_group_sizes(g_t, 3)
    fn = registry.get(impl).bound()
    batch, st_b = scheduler.sw_batch(mat2, g_t, w, 150, fn, seed=9)
    stream, st_s = scheduler.sw_streaming(mat2, g_t, w, 150, fn, chunk=64,
                                          seed=9)
    assert (st_b.n_chunks, st_s.n_chunks, st_s.chunk) == (1, 3, 64)
    assert st_s.peak_label_bytes == 4 * 64 * 48
    torch.testing.assert_close(stream, batch, rtol=1e-6, atol=0)


def test_scheduler_rejects_misshapen_perms():
    dm, grouping, _, _, _ = _study("null48")
    dm_t, g_t, _ = from_reference(dm, grouping, device="cpu")
    with pytest.raises(ValueError, match="perms must be"):
        engine.run(dm_t, g_t, n_perms=9,
                   perms=torch.zeros((9, 48), dtype=torch.int32),
                   device="cpu")


def test_run_seed_path_is_chunk_invariant():
    dm, grouping, _, _, _ = _study("effect61")
    dm_t, g_t, _ = from_reference(dm, grouping, device="cpu")
    a = engine.run(dm_t, g_t, n_perms=199, seed=4, impl="brute",
                   device="cpu")
    b = engine.run(dm_t, g_t, n_perms=199, seed=4, impl="brute", chunk=70,
                   device="cpu")
    torch.testing.assert_close(a.f_perms, b.f_perms, rtol=0, atol=0)
    assert a.plan.endswith("chunks=1") and b.plan.endswith("chunks=3")
    assert 0.0 < float(a.p_value) <= 1.0


def test_run_designs_not_ported_yet(tmp_path):
    """Designs came with the designs slice: a strata design now runs and
    reports its term; the many-study design runs came with the
    many-study slice (engine.permanova_many), its study-axis sharding
    with the multi-device slice (here a one-rank world's mesh: the
    unsharded batch bit for bit); a custom sw_fn with a design
    raises ValueError as in the reference."""
    dm, grouping, _, _, _ = _study("null48")
    res = engine.run(dm, grouping, strata=np.zeros(48, np.int32), n_perms=9,
                     device="cpu")
    assert res.terms is not None and res.method.endswith("+strata]")
    assert engine.permanova_many is engine.api.permanova_many
    many = engine.permanova_many(np.stack([dm, dm]), np.stack([grouping] * 2),
                                 n_groups=int(grouping.max()) + 1,
                                 strata=np.zeros((2, 48), np.int32),
                                 n_perms=9, device="cpu")
    assert len(many) == 2 and many.terms is not None
    from repro_torch.launch import mesh as pmesh
    with pmesh.world_of_one("cpu", tmp_path):
        mesh = pmesh.make_mesh((1, 1), ("data", "model"), device_type="cpu")
        one = engine.permanova_many(np.stack([dm]), np.stack([grouping]),
                                    n_groups=int(grouping.max()) + 1,
                                    n_perms=9, mesh=mesh, device="cpu")
    assert torch.equal(one.f_perms, engine.permanova_many(
        np.stack([dm]), np.stack([grouping]),
        n_groups=int(grouping.max()) + 1, n_perms=9,
        device="cpu").f_perms)
    with pytest.raises(ValueError, match="sw_fn"):
        engine.run(dm, grouping, strata=np.zeros(48, np.int32),
                   sw_fn=lambda *a: None, device="cpu")


def test_run_defaults_to_cuda_and_raises_without_it():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    dm, grouping, _, _, _ = _study("null48")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        engine.run(dm, grouping, n_perms=9)


# ---------------------------------------------------------------------------
# CLI.
# ---------------------------------------------------------------------------

def test_cli_runs_on_cpu(capsys):
    assert cli.main(["--samples", "64", "--features", "16", "--groups", "4",
                     "--perms", "49", "--device", "cpu", "--chunk", "20",
                     "--impl", "pallas_brute"]) == 0
    out = capsys.readouterr().out
    assert "plan: brute[block=32] stream(chunk=20) on cpu" in out
    assert "chunks=3" in out and "F=" in out and "p=" in out


def test_cli_matches_reference_cli_statistic(capsys):
    """Same seed, same study and distances: the observed F is the
    reference CLI's (the p-values differ: the label streams differ)."""
    from repro.launch import permanova as jcli
    import sys
    argv = ["--samples", "64", "--features", "16", "--groups", "4",
            "--perms", "19", "--impl", "matmul"]
    cli.main(argv + ["--device", "cpu"])
    f_t = capsys.readouterr().out.split("F=")[1].split()[0]
    old = sys.argv
    try:
        sys.argv = ["permanova"] + argv
        jcli.main()
    finally:
        sys.argv = old
    f_j = capsys.readouterr().out.split("F=")[1].split()[0]
    assert float(f_t) == pytest.approx(float(f_j), rel=1e-4)


def test_cli_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        cli.main(["--samples", "16", "--perms", "9"])
