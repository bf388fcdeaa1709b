"""The port's features -> F/p pipeline against the reference's: pipeline()
through the dense, stream, fused and fused-kernel bridges for every metric
and distance-impl kind (the reference's Pallas kernels in interpret mode),
with the reference's own label draws (F and the null at rtol 1e-4, p
exactly equal); the planner on 'cpu' field for field and on 'cuda'; the
streaming mat2 build and Gower marginals; engine.run(squared=, s_t=);
permanova() on features; the CLI; and the options that wait for later
slices."""

import contextlib
import functools
import os
import re
import sys

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
from repro.core.permanova import permanova as jpermanova  # noqa: E402
from repro.data import microbiome as jmicro  # noqa: E402
from repro.pipeline import planner as jplanner  # noqa: E402
from repro_torch import engine, pipeline  # noqa: E402
from repro_torch.compat import from_reference  # noqa: E402
from repro_torch.core import distance, permutations  # noqa: E402
from repro_torch.core.permanova import permanova, s_total  # noqa: E402
from repro_torch.kernels.distance import ops as dops  # noqa: E402
from repro_torch.kernels.fused_sw import ops as fops  # noqa: E402
from repro_torch.launch import permanova as cli  # noqa: E402
from repro_torch.pipeline import planner, registry, streaming  # noqa: E402

METRICS = ["aitchison", "braycurtis", "euclidean", "jaccard"]
# (n, n_features, n_groups, effect, seed, n_perms)
STUDY = (61, 24, 4, 0.4, 3, 49)
ROW_BLOCK = 16                  # 61 = 3 x 16 + 13: a ragged last slab
RTOL = 1e-4


@functools.lru_cache(maxsize=None)
def _study(n=STUDY[0], d=STUDY[1]):
    _, _, g, effect, seed, n_perms = STUDY
    x, grouping = jmicro.synthetic_study(n, d, g, effect_size=effect,
                                         seed=seed)
    key = jax.random.key(seed + 100)
    perms = np.asarray(jperm.permutation_batch(key, jnp.asarray(grouping),
                                               0, n_perms + 1))
    return x, grouping, key, perms, n_perms


def _port_args(grouping, perms):
    _, g_t, p_t = from_reference(None, grouping, perms, device="cpu")
    return g_t, p_t


def _assert_same_test(res_t, res_j):
    np.testing.assert_allclose(float(res_t.f_stat), float(res_j.f_stat),
                               rtol=RTOL)
    assert float(res_t.p_value) == float(res_j.p_value)
    np.testing.assert_allclose(res_t.f_perms.numpy(),
                               np.asarray(res_j.f_perms), rtol=RTOL)


# The port's names for what the reference's fused-kernel plans name: its
# kinds 'cuda' / 'torch' for 'pallas' / 'xla', and the plain sweep's
# reason. The CUDA kind takes no tile knobs and reports its own 64-row
# tile where the Pallas kind reports its VMEM tiles.
AS_REFERENCE = [(".fusedk.torch", ".fusedk.xla"),
                (".fusedk.cuda", ".fusedk.pallas"),
                ("one-pass torch sweep", "one-jit XLA sweep"),
                (":: torch rows=", ":: xla rows=")]


def _as_reference(text):
    for port, reference in AS_REFERENCE:
        text = text.replace(port, reference)
    return text


def _without_tiles(plan):
    """A fused-kernel plan string without its tuning dict and what the
    sweep reports after ' :: ' (tile sizes differ by design)."""
    head, rest = plan.split("[", 1)
    return head + rest.split("]", 1)[1].split(" :: ")[0]


@pytest.mark.parametrize("bridge", ["dense", "stream"])
@pytest.mark.parametrize("kind", ["pallas", "dense", "blocked"])
@pytest.mark.parametrize("metric", METRICS)
def test_pipeline_matches_reference(metric, kind, bridge):
    x, grouping, key, perms, n_perms = _study()
    kw = dict(metric=metric, n_perms=n_perms, materialize=bridge,
              dist_impl=f"{metric}.{kind}", row_block=ROW_BLOCK)
    res_j = jpipe.pipeline(jnp.asarray(x), jnp.asarray(grouping), key=key,
                           **kw)
    g_t, p_t = _port_args(grouping, perms)
    res_t = pipeline.pipeline(torch.from_numpy(x), g_t, perms=p_t,
                              device="cpu", **kw)
    _assert_same_test(res_t, res_j)
    if kind == "pallas":
        # the kernel kind is '<metric>.cuda' and takes no tile knobs
        assert res_t.method == res_j.method.replace(".pallas", ".cuda")
        assert res_t.plan.split("]", 1)[1] == res_j.plan.split("]", 1)[1]
    else:
        assert (res_t.method, res_t.plan) == (res_j.method, res_j.plan)


FUSED_CASES = {   # port (materialize, fused_impl) -> the reference's
    "fused-kernel-torch": ("fused-kernel", "torch", "xla"),
    "fused-kernel-cuda": ("fused-kernel", "cuda", "pallas"),
    "fused": ("fused", "auto", "auto"),
}


@pytest.mark.parametrize("case", sorted(FUSED_CASES))
@pytest.mark.parametrize("metric", METRICS)
def test_fused_bridges_match_reference(metric, case):
    """The fused bridges on the reference's labels: the torch sweep
    against the reference's XLA sweep, the CUDA kind (its plain version on
    CPU tensors) against the Pallas megakernel in interpret mode, and the
    two-stage fused bridge against the reference's."""
    mat, impl_t, impl_j = FUSED_CASES[case]
    x, grouping, key, perms, n_perms = _study()
    kw = dict(metric=metric, n_perms=n_perms, materialize=mat,
              row_block=ROW_BLOCK)
    res_j = jpipe.pipeline(jnp.asarray(x), jnp.asarray(grouping), key=key,
                           fused_impl=impl_j, **kw)
    g_t, p_t = _port_args(grouping, perms)
    res_t = pipeline.pipeline(torch.from_numpy(x), g_t, perms=p_t,
                              fused_impl=impl_t, device="cpu", **kw)
    _assert_same_test(res_t, res_j)
    assert res_t.method == res_j.method
    if case == "fused-kernel-cuda":
        assert _without_tiles(_as_reference(res_t.plan)) == \
            _without_tiles(res_j.plan)
    else:
        assert _as_reference(res_t.plan) == res_j.plan


@pytest.mark.parametrize("metric", METRICS)
def test_fused_bridges_equal_dense_within_port(metric):
    x, grouping, _, perms, n_perms = _study()
    g_t, p_t = _port_args(grouping, perms)
    kw = dict(metric=metric, n_perms=n_perms, perms=p_t,
              row_block=ROW_BLOCK, device="cpu")
    dense = pipeline.pipeline(torch.from_numpy(x), g_t, materialize="dense",
                              **kw)
    for mat, impl in (("fused-kernel", "cuda"), ("fused-kernel", "torch"),
                      ("fused", "auto")):
        res = pipeline.pipeline(torch.from_numpy(x), g_t, materialize=mat,
                                fused_impl=impl, **kw)
        torch.testing.assert_close(res.f_perms, dense.f_perms, rtol=RTOL,
                                   atol=0)
        assert float(res.p_value) == float(dense.p_value)
        assert res.method.split("->")[1] == mat
        assert res.f_perms.dtype == torch.float32


@pytest.mark.parametrize("bridge", ["fused-kernel-cuda", "fused-kernel-torch",
                                    "fused"])
def test_fused_bridges_are_chunk_invariant(bridge):
    """chunk=7 (8 chunks of the 50 slots) against one chunk: the same
    labels by global index, so the same null."""
    mat, impl, _ = FUSED_CASES[bridge]
    x, grouping, _, _, n_perms = _study()
    g_t = torch.from_numpy(grouping)
    runs = [pipeline.pipeline(torch.from_numpy(x), g_t, n_perms=n_perms,
                              seed=4, materialize=mat, fused_impl=impl,
                              row_block=ROW_BLOCK, chunk=c, device="cpu")
            for c in (None, 7)]
    torch.testing.assert_close(runs[1].f_perms, runs[0].f_perms, rtol=1e-5,
                               atol=0)
    assert float(runs[1].p_value) == float(runs[0].p_value)
    assert "chunks=1" in runs[0].plan and "chunks=8" in runs[1].plan


@pytest.mark.parametrize("metric", METRICS)
def test_small_matrix_budget_resolves_the_fused_kernel_bridge(metric):
    """Where not even one (n, n) buffer fits the matrix budget (as the
    default 1 GiB at the EMP shape), 'auto' plans the fused-kernel
    bridge: the torch sweep on the CPU, as the reference's XLA sweep."""
    x, grouping, key, perms, n_perms = _study()
    kw = dict(metric=metric, n_perms=n_perms, matrix_budget_bytes=1024)
    res_j = jpipe.pipeline(jnp.asarray(x), jnp.asarray(grouping), key=key,
                           **kw)
    g_t, p_t = _port_args(grouping, perms)
    res_t = pipeline.pipeline(torch.from_numpy(x), g_t, perms=p_t,
                              device="cpu", **kw)
    _assert_same_test(res_t, res_j)
    assert res_t.method == res_j.method == \
        f"pipeline[{res_t.method[9:].split('->')[0]}->fused-kernel->matmul]"
    assert _as_reference(res_t.plan) == res_j.plan
    assert res_t.plan.startswith(f"{metric}.fusedk.torch[")


@pytest.mark.parametrize("metric", METRICS)
def test_permanova_on_features_at_default_budget_reaches_fused_kernel(
        metric, monkeypatch):
    """permanova(features) passes no matrix budget: the planner's default
    decides. With the default shrunk below one (n, n) buffer in both
    packages (as 1 GiB is at n > 16,384), both run the fused-kernel
    bridge and agree."""
    for mod in (planner, jplanner):
        monkeypatch.setattr(mod, "DEFAULT_MATRIX_BUDGET_BYTES", 1024)
    x, grouping, key, perms, n_perms = _study()
    res_j = jpermanova(jnp.asarray(x), jnp.asarray(grouping),
                       n_perms=n_perms, key=key, metric=metric)
    g_t, p_t = _port_args(grouping, perms)
    res_t = permanova(torch.from_numpy(x), g_t, n_perms=n_perms, perms=p_t,
                      metric=metric, device="cpu")
    _assert_same_test(res_t, res_j)
    assert "->fused-kernel->" in res_t.method
    assert res_t.method == res_j.method


@pytest.mark.parametrize("metric", METRICS)
def test_stream_equals_dense_within_port(metric):
    x, grouping, _, perms, n_perms = _study()
    g_t, p_t = _port_args(grouping, perms)
    runs = [pipeline.pipeline(torch.from_numpy(x), g_t, metric=metric,
                              n_perms=n_perms, perms=p_t, materialize=m,
                              row_block=ROW_BLOCK, device="cpu")
            for m in ("dense", "stream")]
    torch.testing.assert_close(runs[1].f_perms, runs[0].f_perms,
                               rtol=1e-5, atol=0)
    assert float(runs[1].p_value) == float(runs[0].p_value)
    assert runs[1].method.split("->")[1] == "stream"


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("block", [7, 16, 61, 100])
def test_stream_mat2_ragged_blocks(metric, block):
    """Row blocks that do not divide n: mat2 is the dense D squared with
    an exact zero diagonal, the float64 row sums and s_T are its own, and
    both match the reference's build_mat2_streaming."""
    x, *_ = _study()
    _, rows_fn, dense_fn = registry.get(f"{metric}.cuda").bound()
    prep = registry.get(f"{metric}.cuda").make_prepare()
    xt = torch.from_numpy(x)
    mat2, gower = streaming.build_mat2_streaming(prep(xt), rows_fn,
                                                 block=block)
    dm = dense_fn(xt)
    torch.testing.assert_close(mat2, dm * dm, rtol=1e-5, atol=1e-6)
    assert torch.all(torch.diagonal(mat2) == 0.0)
    assert gower.row_sums.dtype == torch.float64
    torch.testing.assert_close(gower.row_sums,
                               mat2.double().sum(dim=1), rtol=1e-12, atol=0)
    assert gower.s_t == pytest.approx(float(s_total(mat2)), rel=1e-6)
    jspec = jpipe.get(f"{metric}.blocked")
    jprep, jrows, _ = jspec.bound()
    jmat2, jgower = jpipe.build_mat2_streaming(jprep(jnp.asarray(x)), jrows,
                                               block=block)
    np.testing.assert_allclose(mat2.numpy(), jmat2, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(gower.row_sums.numpy(), jgower.row_sums,
                               rtol=1e-5)
    assert gower.s_t == pytest.approx(jgower.s_t, rel=1e-5)


def test_mat2_row_blocks_cover_rows_once():
    x, *_ = _study()
    xt = distance.presence_prepare(torch.from_numpy(x))
    _, rows_fn, _ = registry.get("jaccard.cuda").bound()
    spans = [(lo, slab.shape[0]) for lo, slab in
             streaming.mat2_row_blocks(xt, rows_fn, block=16)]
    assert spans == [(0, 16), (16, 16), (32, 16), (48, 13)]


@pytest.mark.parametrize("with_stats", [False, True])
def test_gower_center_matches_reference(with_stats):
    x, *_ = _study()
    _, rows_fn, _ = registry.get("braycurtis.blocked").bound()
    mat2, gower = streaming.build_mat2_streaming(torch.from_numpy(x),
                                                 rows_fn, block=20)
    jm2, jg = jpipe.build_mat2_streaming(jnp.asarray(x),
                                         jpipe.get("braycurtis.blocked")
                                         .bound()[1], block=20)
    got = streaming.gower_center(mat2, gower if with_stats else None)
    want = jpipe.gower_center(jnp.asarray(jm2), jg if with_stats else None)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-6)
    torch.testing.assert_close(got.sum(dim=1), torch.zeros(got.shape[0]),
                               rtol=0, atol=1e-5)


def test_run_squared_and_s_t_are_taken_as_given():
    x, grouping, _, perms, n_perms = _study()
    g_t, p_t = _port_args(grouping, perms)
    dm = distance.braycurtis(torch.from_numpy(x))
    mat2 = dm * dm
    kw = dict(n_perms=n_perms, perms=p_t, device="cpu")
    plain = engine.run(dm, g_t, **kw)
    squared = engine.run(mat2, g_t, squared=True, **kw)
    given = engine.run(mat2, g_t, squared=True, s_t=float(s_total(mat2)),
                       **kw)
    for res in (squared, given):
        torch.testing.assert_close(res.f_perms, plain.f_perms, rtol=0,
                                   atol=0)
        assert float(res.p_value) == float(plain.p_value)
    doubled = engine.run(mat2, g_t, squared=True,
                         s_t=2 * float(s_total(mat2)), **kw)
    assert float(doubled.s_t) == pytest.approx(2 * float(plain.s_t))
    assert float(doubled.f_stat) > float(plain.f_stat)


# ---------------------------------------------------------------------------
# Planner.
# ---------------------------------------------------------------------------

PLAN_CASES = {
    "small-dense": (61, 24, "braycurtis", {}),
    "euclidean-dense-form": (1000, 64, "euclidean", {}),
    "euclidean-spills-llc": (2500, 64, "euclidean", {}),
    "jaccard-slab-budget": (1500, 32, "jaccard",
                            {"slab_budget_bytes": 2 ** 22}),
    "aitchison-stream": (3000, 128, "aitchison",
                         {"matrix_budget_bytes": 2 ** 26}),
    "braycurtis-stream": (5000, 128, "braycurtis",
                          {"matrix_budget_bytes": 2 ** 27}),
    "fused-kernel": (20000, 128, "braycurtis", {}),
    "fused-kernel-budget": (3000, 16, "euclidean",
                            {"matrix_budget_bytes": 2 ** 24,
                             "memory_budget_bytes": 2 ** 22}),
    "fused-downgrade": (20000, 128, "braycurtis", {"sw_impl": "brute"}),
    "pinned-everything": (700, 40, "jaccard",
                          {"dist_impl": "blocked", "materialize": "stream",
                           "row_block": 50, "sw_impl": "tiled",
                           "chunk": 100}),
    "label-budget": (900, 20, "euclidean",
                     {"memory_budget_bytes": 2 ** 18}),
}


@pytest.mark.parametrize("case", sorted(PLAN_CASES))
def test_plan_pipeline_matches_reference_on_cpu(case):
    n, d, metric, kw = PLAN_CASES[case]
    got = planner.plan_pipeline(n, d, 1000, 8, backend="cpu", metric=metric,
                                **kw)
    want = jplanner.plan_pipeline(n, d, 1000, 8, backend="cpu",
                                  metric=metric, **kw)
    assert (got.dist_impl, got.dist_tuning, got.materialize,
            got.row_block) == (want.dist_impl, want.dist_tuning,
                               want.materialize, want.row_block)
    assert got.sw.describe() == want.sw.describe()
    assert (got.sw.chunk, got.sw.streaming) == (want.sw.chunk,
                                                want.sw.streaming)
    assert (got.n, got.d, got.n_groups) == (n, d, 8)
    assert got.fused_tuning == want.fused_tuning
    if want.fused_impl is None:
        assert got.fused_impl is None
    else:
        assert got.fused_impl == registry.get_fused(want.fused_impl).name
    assert _as_reference(got.reason) == want.reason
    assert _as_reference(got.describe()) == want.describe()
    if got.materialize != "fused-kernel":
        # the reference adds its per-precision traffic table to fused plans
        assert got.explain() == want.explain()


def test_plan_pipeline_rejects_what_the_reference_rejects():
    for mod in (planner, jplanner):
        with pytest.raises(ValueError, match="cannot honor"):
            mod.plan_pipeline(100, 8, 100, 2, backend="cpu",
                              materialize="fused-kernel", sw_impl="tiled")
        with pytest.raises(ValueError, match="materialize="):
            mod.plan_pipeline(100, 8, 100, 2, backend="cpu",
                              materialize="sideways")
        with pytest.raises(ValueError, match="computes"):
            mod.plan_pipeline(100, 8, 100, 2, backend="cpu",
                              metric="jaccard", dist_impl="euclidean.dense")
        with pytest.raises(KeyError, match="unknown metric"):
            mod.plan_pipeline(100, 8, 100, 2, backend="cpu",
                              metric="cosine")


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("n", [10, 300, 25145])
def test_planner_on_cuda_picks_the_kernel(metric, n):
    pl = planner.plan_pipeline(n, 128, 4000, 8, backend="cuda",
                               metric=metric)
    assert pl.dist_impl == f"{metric}.cuda"
    assert pl.sw.impl == "brute" or pl.materialize in planner.FUSED_MODES
    if pl.materialize == "fused-kernel":
        # the megakernel for every n: it masks ragged shapes
        assert pl.fused_impl == f"{metric}.fusedk.cuda"
        assert pl.sw.kernel is None    # no s_W kernel runs on this bridge
        assert pl.describe().startswith(f"{metric}.fusedk.cuda[")
    # the reference's Pallas workset model sizes the row block: 256 at
    # the EMP shape under the default 128 MiB slab budget
    assert pl.row_block == (256 if n == 25145 else n)


def test_emp_bridges_follow_the_matrix_budget():
    n = 25145
    kw = dict(backend="cuda", metric="braycurtis")
    gib = 1024 ** 3
    assert planner.plan_pipeline(n, 128, 4000, 8, matrix_budget_bytes=6 * gib,
                                 **kw).materialize == "dense"
    assert planner.plan_pipeline(n, 128, 4000, 8, matrix_budget_bytes=3 * gib,
                                 **kw).materialize == "stream"
    pl = planner.plan_pipeline(n, 128, 4000, 8, **kw)
    assert (pl.materialize, pl.fused_impl) == ("fused-kernel",
                                               "braycurtis.fusedk.cuda")
    # the kernel's workset (its partials, 4,096 slots x 4 B a permutation
    # and 32 KiB of totals, and the (chunk, n) labels), the label draw's
    # sub-blocks in what it leaves and a 4 MiB slack share 256 MiB; of
    # the whole 128-permutation passes that fit, 896 costs least (5
    # launches, 45 draws of 91 rows; 1,664 would take 3 launches but 100
    # draws of 40 rows)
    assert pl.sw.chunk == 896 and -(-4000 // pl.sw.chunk) == 5
    assert pl.reason.endswith(
        "; kernel workset 100MiB, labels draw 151MiB beside 100MiB of it, "
        "slack 4.0MiB, of 256MiB; chunk 896 of least modelled time (5 "
        "launches, 45 draws of 91 rows); hand-written CUDA megakernel "
        "(masks ragged shapes, so no tile-viability floor)")
    assert pl.describe_stage1() == (
        "braycurtis.fusedk.cuda[feat_bf16=0,feat_fp8=0] -> "
        "fused-kernel(rows=256)")


@pytest.mark.parametrize("n,d,n_perms,budget", [
    (25145, 128, 4000, None), (331, 24, 999, 2 ** 20),
    (1100, 16, 5000, 3 * 2 ** 20), (97, 8, 50, None),
    (70000, 128, 4000, None)])
def test_cuda_fused_chunk_fits_the_kernel_workset(n, d, n_perms, budget):
    """On the card the fused-kernel chunk is a whole number of the
    kernel's 128-permutation passes (or every slot) whose workset (the
    registry's model: partials and (chunk, n) labels), one draw row and
    the sweep's slack fit the label budget; the draw's sub-blocks take
    what the workset and the slack leave, so all three stay inside the
    budget. Among those chunks it is the one of least modelled time: a
    launch's feature phase (9.8 ms at the EMP shape, scaled by n^2 d)
    against the draw's sub-blocks (each the longer of 1.9 ms and 0.02 ms
    a row of 25,145 samples), recomputed here for every candidate.
    With partials of fixed slots this holds at any n the labels allow:
    at n = 70,000 (where the old row-sum partials left no room for one
    pass) 512 permutations, 8 launches for 4,000 slots. The CPU plan
    stays the reference's field for field."""
    kw = dict(metric="braycurtis", materialize="fused-kernel",
              memory_budget_bytes=budget)
    pl = planner.plan_pipeline(n, d, n_perms, 8, backend="cuda", **kw)
    spec = registry.get_fused(pl.fused_impl)
    cap = 256 * 2 ** 20 if budget is None else budget
    slack = min(4 * 2 ** 20, cap / 16)
    q = fops.SW_PASS

    def ws(chunk):
        return spec.workset_bytes(n, d, chunk, 8, pl.row_block)

    def cost(chunk):
        rows = permutations.draw_rows(n, cap - slack - ws(chunk))
        draws = 0.0
        for lo in range(0, n_perms, chunk):
            for a in range(lo, min(lo + chunk, n_perms), rows):
                r = min(rows, lo + chunk - a, n_perms - a)
                draws += max(1.9, 0.02 * n / 25145 * r)
        launches = -(-n_perms // chunk)
        return (launches * 9.8 * (n / 25145) ** 2 * d / 128 + draws,
                launches)
    assert spec.kind == "cuda" and spec.chunk_quantum == q
    assert ws(pl.sw.chunk) == fops.workspace_bytes(n, n, pl.sw.chunk) \
        + 4 * pl.sw.chunk * n
    assert pl.draw_budget == cap - slack - ws(pl.sw.chunk)
    rows = permutations.draw_rows(n, pl.draw_budget)
    assert ws(pl.sw.chunk) + permutations.draw_transient_bytes(rows, n) \
        + slack <= cap
    assert pl.sw.chunk % q == 0 or pl.sw.chunk == n_perms
    fits = [c for c in list(range(q, n_perms, q)) + [n_perms]
            if ws(c) + permutations.draw_transient_bytes(1, n) + slack
            <= cap]
    assert pl.sw.chunk in fits
    assert all(cost(pl.sw.chunk) <= cost(c) for c in fits)
    assert "exceeds" not in pl.reason
    if n == 70000:
        assert (pl.sw.chunk, -(-4000 // pl.sw.chunk)) == (512, 8)
    got = planner.plan_pipeline(n, d, n_perms, 8, backend="cpu", **kw)
    want = jplanner.plan_pipeline(n, d, n_perms, 8, backend="cpu", **kw)
    assert (got.sw.chunk, got.sw.describe(), got.row_block) == \
        (want.sw.chunk, want.sw.describe(), want.row_block)
    assert _as_reference(got.reason) == want.reason
    assert got.draw_budget is None


@pytest.mark.parametrize("n", [25145, 60000, 100000])
@pytest.mark.parametrize("k", [None, 10])
def test_cuda_fused_workset_and_draw_fit_the_budget(n, k):
    """The budget bounds the whole bridge: at n = 25,145, 60,000 and
    100,000, for labels, labels within strata and a K = 10 design, the
    card's plan puts the kernel's workset (partials, labels or index and
    basis) and the sweep's slack inside the default 256 MiB, and so its
    draw's modelled transients (by the kind of draw) beside what the
    sweep holds while it draws (all of the workset but a design's basis,
    gathered after the draw), with at least one pass a chunk (128
    permutations; a design at least one 128-q pass, 13 permutations at K
    = 10); explain() prints the split. Nothing in the workset grows with
    n^2: the partials take the same bytes a permutation at every n, and
    the fixed part stays 32 KiB."""
    for draw in (("labels", "strata") if k is None else ("labels",)):
        pl = planner.plan_pipeline(n, 128, 4000, 8, backend="cuda",
                                   design_cols=k, draw=draw)
        kind = "index" if k is not None else draw
        assert pl.materialize == "fused-kernel" and pl.draw == kind
        parts = registry.fused_cuda_workset(n, pl.sw.chunk, k)
        rows = permutations.draw_rows(n, pl.draw_budget, kind)
        draw_bytes = permutations.draw_transient_bytes(rows, n, kind)
        cap = 256 * 2 ** 20
        at_draw = sum(v for p, v in parts.items() if p != "basis")
        assert sum(parts.values()) + 4 * 2 ** 20 <= cap
        assert at_draw + draw_bytes + 4 * 2 ** 20 <= cap
        assert rows >= 1 and pl.budget == cap
        assert pl.sw.chunk >= (fops.SW_PASS if k is None
                               else -(-fops.Q_PASS // k))
        kernel = "fused_sw" if k is None else "fused_sw_cols"
        width = 1 if k is None else k
        slots = fops.n_slots(n, n, True, kernel)
        assert slots == fops.LAYOUT[kernel][1]
        assert parts["partials"] == 4 * slots * pl.sw.chunk * width \
            + 8 * (slots + 1) + 4 * pl.sw.chunk * width
        assert fops.workspace_bytes(n, n, 0) <= 32 * 1024 + 8
        split = pl.explain().splitlines()[1]
        assert split.startswith(f"kernel workset at chunk {pl.sw.chunk}: "
                                "partials ")
        assert f"({slots} slots); {kind} draw " in split
        assert f"({min(rows, pl.sw.chunk)} rows of {n}) beside " \
            f"{at_draw / 2 ** 20:.2f}MiB of it; slack 4.00MiB; peak " in split
        assert split.endswith("of 256.00MiB")


def test_cuda_fused_plan_raises_below_one_pass():
    """Where not even one pass fits, the card's plan raises and names the
    least budget that would fit; that budget plans one pass."""
    with pytest.raises(ValueError, match="memory_budget_bytes >= ") as err:
        planner.plan_pipeline(25145, 128, 4000, 8, backend="cuda",
                              memory_budget_bytes=8 * 2 ** 20)
    least = int(str(err.value).rsplit(">= ", 1)[1])
    pl = planner.plan_pipeline(25145, 128, 4000, 8, backend="cuda",
                               memory_budget_bytes=least)
    assert pl.sw.chunk == fops.SW_PASS
    with pytest.raises(ValueError, match="memory_budget_bytes >= "):
        planner.plan_pipeline(25145, 128, 4000, 8, backend="cuda",
                              memory_budget_bytes=least - 1)
    # the CPU plan keeps the reference's one-hot chunk at any budget
    assert planner.plan_pipeline(25145, 128, 4000, 8, backend="cpu",
                                 materialize="fused-kernel",
                                 memory_budget_bytes=8 * 2 ** 20).sw.chunk


@pytest.mark.parametrize("form,kind", [
    ("labels", "labels"), ("strata", "strata"), ("covariates", "index")])
def test_fused_kernel_record_reports_slots_and_draws(form, kind):
    """The megakernel sweep's plan record carries what it ran with: the
    kernel's slots and the draws' sub-block rows with their modelled
    transients, by kind of draw (free labels, labels within strata, a
    dense design's index permutations); explicit draws make none. The
    card's plan charges the kind it will draw: at the EMP shape a strata
    draw gets fewer rows a sub-block than a free one."""
    rng = np.random.default_rng(0)
    n = 40
    x = rng.gamma(1.0, 1.0, (n, 6)).astype(np.float32)
    g = rng.integers(0, 3, n).astype(np.int32)
    kw = dict(n_perms=19, materialize="fused-kernel", fused_impl="cuda",
              device="cpu")
    if form == "strata":
        kw["strata"] = (np.arange(n) % 2).astype(np.int32)
    if form == "covariates":
        kw["covariates"] = rng.normal(size=(n, 2))
    res = pipeline.pipeline(x, g, **kw)
    slots = fops.n_slots(n, n, True, "fused_sw_cols" if form == "covariates"
                         else "fused_sw")
    draw = permutations.draw_transient_bytes(20, n, kind)
    assert f" slots={slots} draw=20rows/{draw / 2 ** 20:.2f}MiB" in res.plan
    if form == "labels":
        perms = permutations.permutation_batch(torch.from_numpy(g), 0, 20,
                                               seed=0)
        explicit = pipeline.pipeline(x, g, perms=perms, **kw)
        assert " draw=0rows/0.00MiB" in explicit.plan
        free, within = (planner.plan_pipeline(
            25145, 128, 4000, 8, backend="cuda", draw=d)
            for d in ("labels", "strata"))
        assert (free.draw, within.draw) == ("labels", "strata")
        assert permutations.draw_rows(25145, within.draw_budget, "strata") \
            < permutations.draw_rows(25145, free.draw_budget)
    with pytest.raises(ValueError, match="draw="):
        planner.plan_pipeline(n, 6, 20, 3, backend="cuda", draw="index")


@pytest.mark.parametrize("pinned,name", [
    ("pallas", "jaccard.fusedk.cuda"), ("cuda", "jaccard.fusedk.cuda"),
    ("xla", "jaccard.fusedk.torch"), ("torch", "jaccard.fusedk.torch"),
    ("jaccard.fusedk.xla", "jaccard.fusedk.torch")])
def test_fused_impl_pins_and_aliases(pinned, name):
    pl = planner.plan_pipeline(100, 8, 100, 2, backend="cpu",
                               metric="jaccard", materialize="fused-kernel",
                               fused_impl=pinned)
    assert pl.fused_impl == name
    assert pl.fused_tuning == {"feat_bf16": 0, "feat_fp8": 0,
                               "feat_packed": 0}
    assert pl.reason.endswith("; caller-pinned fused impl")


def test_fused_tuning_keeps_known_keys_and_rejects_precision():
    """Known keys are kept, others dropped; a precision knob resolves into
    the plan since the precision slice, and one the impl cannot run
    (packed on euclidean) is rejected."""
    kw = dict(backend="cpu", metric="euclidean", materialize="fused-kernel")
    pl = planner.plan_pipeline(100, 8, 100, 2, fused_tuning={
        "tile_r": 32, "feat_bf16": 0}, **kw)
    assert pl.fused_tuning == {"feat_bf16": 0, "feat_fp8": 0}
    pl = planner.plan_pipeline(100, 8, 100, 2,
                               fused_tuning={"feat_fp8": 1}, **kw)
    assert pl.fused_tuning == {"feat_bf16": 0, "feat_fp8": 1}
    with pytest.raises(ValueError, match="jaccard"):
        planner.plan_pipeline(100, 8, 100, 2,
                              fused_tuning={"feat_packed": 1}, **kw)
    with pytest.raises(ValueError, match="computes"):
        planner.plan_pipeline(100, 8, 100, 2, fused_impl="jaccard.fusedk.cuda",
                              **kw)


def test_pallas_alias_resolves_to_the_kernel_kind():
    pl = planner.plan_pipeline(100, 8, 100, 2, backend="cpu",
                               metric="jaccard", dist_impl="jaccard.pallas")
    assert pl.dist_impl == "jaccard.cuda" and pl.dist_tuning == {"packed": 0}
    assert pl.describe_stage1() == "jaccard.cuda[packed=0] -> dense(rows=100)"


# ---------------------------------------------------------------------------
# Registry.
# ---------------------------------------------------------------------------

def test_registry_names_kinds_and_aliases():
    assert registry.metrics() == METRICS == jpipe.metrics()
    assert registry.names(kind="cuda") == [f"{m}.cuda" for m in METRICS]
    assert registry.names(backend="cpu") == [
        n for n in jpipe.names(backend="cpu")]
    for m in METRICS:
        assert registry.get(f"{m}.pallas") is registry.get(f"{m}.cuda")
        assert registry.get(f"{m}.cuda").backends == ("cuda",)
        assert registry.get(f"{m}.cuda").workset_bytes(1000, 64, 128) == \
            jpipe.get(f"{m}.pallas").workset_bytes(1000, 64, 128)
    assert registry.get("jaccard.cuda").tuning == {"packed": 0}
    with pytest.raises(KeyError, match="unknown distance impl"):
        registry.get("braycurtis.fusedk")
    with pytest.raises(ValueError, match="duplicate"):
        registry.register(registry.get("euclidean.dense"))


def test_fused_registry_names_kinds_and_aliases():
    assert registry.fused_names(kind="cuda") == [
        f"{m}.fusedk.cuda" for m in METRICS]
    assert registry.fused_names(backend="cpu") == [
        f"{m}.fusedk.torch" for m in METRICS]
    assert registry.fused_names(metric="jaccard") == [
        "jaccard.fusedk.cuda", "jaccard.fusedk.torch"]
    for m in METRICS:
        cuda, plain = (registry.get_fused(f"{m}.fusedk.{k}")
                       for k in ("cuda", "torch"))
        assert registry.get_fused(f"{m}.fusedk.pallas") is cuda
        assert registry.get_fused(f"{m}.fusedk.xla") is plain
        assert (cuda.backends, plain.backends) == (("cuda",), ("cpu",))
        kmetric = "euclidean" if m == "aitchison" else m
        assert cuda.kernel_metric == plain.kernel_metric == kmetric
        # the precision keys at 0, as the reference's, field for field
        want = {k: v for k, v in jpipe.get_fused(f"{m}.fusedk.xla")
                .tuning.items()}
        assert cuda.tuning == plain.tuning == want
        # the plain sweep keeps the reference's model; the kernel's counts
        # its partials (4,096 slots at the EMP shape, their f64 totals and
        # the (P,) s_W) and labels
        args = (25145, 128, 156, 8, 256)
        assert plain.workset_bytes(*args) == \
            jpipe.get_fused(f"{m}.fusedk.xla").workset_bytes(*args)
        assert cuda.workset_bytes(*args) == \
            4 * 4096 * 156 + 8 * 4097 + 4 * 156 + 4 * 156 * 25145
    with pytest.raises(KeyError, match="unknown fused impl"):
        registry.get_fused("braycurtis.cuda")
    with pytest.raises(ValueError, match="duplicate"):
        registry.register_fused(registry.get_fused("euclidean.fusedk.cuda"))


def test_bound_resolves_tuning_once():
    spec = registry.get("braycurtis.blocked")
    a = spec.bound(block=32, bogus=1)
    assert spec.bound(block=32) is a
    assert spec.bound(block=64) is not a


@pytest.mark.parametrize("packed", [0, 1])
def test_kernel_kind_dispatches_to_the_wrappers(packed):
    x, *_ = _study()
    xt = torch.from_numpy(x)
    prep, rows_fn, dense_fn = registry.get("jaccard.cuda").bound(
        packed=packed)
    xp = prep(xt)
    want = dops.pairwise_distance(xp, metric="jaccard", packed=packed)
    assert torch.equal(dense_fn(xt), want)
    assert torch.equal(rows_fn(xp[:5], xp),
                       dops.pairwise_distance_rows(xp[:5], xp,
                                                   metric="jaccard",
                                                   packed=packed))
    if packed:   # bit-identical to the float kernel's plain version
        assert torch.equal(want, registry.get("jaccard.cuda").bound()[2](xt))


# ---------------------------------------------------------------------------
# Entry points.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("metric", METRICS)
def test_permanova_on_features_matches_reference(metric):
    x, grouping, key, perms, n_perms = _study()
    res_j = jpermanova(jnp.asarray(x), jnp.asarray(grouping),
                       n_perms=n_perms, key=key, metric=metric)
    g_t, p_t = _port_args(grouping, perms)
    res_t = permanova(torch.from_numpy(x), g_t, n_perms=n_perms, perms=p_t,
                      metric=metric, device="cpu")
    _assert_same_test(res_t, res_j)
    assert (res_t.method, res_t.plan) == (res_j.method, res_j.plan)


def test_permanova_routes_a_non_square_table_without_metric():
    x, grouping, key, perms, n_perms = _study()
    g_t, p_t = _port_args(grouping, perms)
    res = permanova(torch.from_numpy(x), g_t, n_perms=n_perms, perms=p_t,
                    device="cpu")
    assert res.method.startswith("pipeline[braycurtis.")


def _slab_cache(tmp_path):
    """A slab cache of the study written by the reference (the port opens
    it: the format is shared)."""
    from repro.data import slabcache
    x, *_ = _study()
    return slabcache.build_slab_cache(str(tmp_path / "cache"), x,
                                      slab_rows=16)


def _exported_trace(path):
    """The call's Chrome trace was written to `path` (stage 1 and the
    engine's sweep in it) and telemetry is off again after the call."""
    import json

    from repro_torch import obs
    with open(path) as f:
        doc = json.load(f)
    names = {e["name"] for e in doc["traceEvents"]}
    return ({"stage1.braycurtis", "engine.sw"} <= names
            and doc["otherData"]["source"] == "repro_torch.obs"
            and not obs.enabled())


@pytest.mark.parametrize("case", [
    "feat_bf16", "ordination", "mesh", "autotune", "trace", "path",
    "slab-cache", "covariates", "strata", "weights"])
def test_not_ported_options_raise(case, tmp_path, monkeypatch):
    x, grouping, _, _, _ = _study()
    x = torch.from_numpy(x)
    kw = {}
    stack = contextlib.ExitStack()      # the mesh case's one-rank world
    exc, match = NotImplementedError, "slice"
    if case == "feat_bf16":
        # the precision knobs run on the fused-kernel bridge since the
        # precision slice; on another bridge they cannot, and the planner
        # refuses them rather than run f32
        kw.update(materialize="dense", fused_tuning={"feat_bf16": 1})
        exc, match = ValueError, "fused-kernel"
    elif case == "ordination":
        # ported since the ordination slice: it runs (eigh on this dense
        # plan)
        kw["ordination"] = 2
        exc = None
    elif case == "mesh":
        # ported since the multi-device slice: a one-rank world's mesh runs
        # the sharded fused-kernel sweep (worlds of several ranks:
        # tests/test_torch_mesh.py)
        from repro_torch.launch import mesh as pmesh
        stack.enter_context(pmesh.world_of_one("cpu", tmp_path))
        kw["mesh"] = pmesh.make_mesh((1, 1), ("data", "model"),
                                     device_type="cpu")
        exc = None
    elif case == "autotune":
        # ported since the autotune slice: it runs, and its cache is a
        # file of this test's own
        monkeypatch.setenv(engine.planner.AUTOTUNE_CACHE_ENV,
                           str(tmp_path / "autotune.json"))
        kw["autotune"] = True
        exc = None
    elif case == "trace":
        # ported since the telemetry slice: it runs, and the Chrome trace
        # of the call is exported to the path given
        kw["trace"] = str(tmp_path / "trace.json")
        exc = None
    elif case == "path":
        # ported since the out-of-core slice: a cache's directory runs; at
        # the default 2 GiB device budget the table is resident ('hbm')
        x = _slab_cache(tmp_path).path
        exc = None
    elif case == "slab-cache":
        # ported since the out-of-core slice: below the device budget the
        # sweep runs out of core
        from repro_torch.data import slabcache as port_slabcache
        x = port_slabcache.SlabCache.open(_slab_cache(tmp_path).path)
        kw["device_budget_bytes"] = 1024
        exc = None
    # designs run since the designs slice; a design with a mesh raises
    # the reference's ValueError (shard design studies with pipeline_many)
    elif case == "covariates":
        kw.update(covariates={"age": np.zeros(len(grouping))}, mesh=object())
    elif case == "strata":
        kw.update(strata=np.zeros(len(grouping), np.int32), mesh=object())
    elif case == "weights":
        kw.update(weights=np.ones(len(grouping)), mesh=object())
    if case in ("covariates", "strata", "weights"):
        exc, match = ValueError, "plain single-factor"
        with pytest.raises(ValueError) as ref:
            jpipe.pipeline(jnp.asarray(x.numpy()), jnp.asarray(grouping),
                           n_perms=9, **kw)
        match = re.escape(str(ref.value))
    if exc is None:
        with stack:
            res = pipeline.pipeline(x, torch.from_numpy(grouping),
                                    n_perms=9, device="cpu", **kw)
        ran = {"ordination": lambda: (res.ordination.k == 2
                                      and res.ordination.method == "eigh"),
               "autotune": lambda: "empirical autotune winner" in res.plan,
               "trace": lambda: _exported_trace(kw["trace"]),
               "path": lambda: res.plan.endswith(
                   "| features=slab-cache(residency=hbm)"),
               "slab-cache": lambda: (res.method
                                      == "pipeline[ooc-fused-kernel]"),
               "mesh": lambda: ":: cuda+mesh " in res.plan}
        assert ran[case](), res.plan
        return
    with pytest.raises(exc, match=match):
        pipeline.pipeline(x, torch.from_numpy(grouping), n_perms=9,
                          device="cpu", **kw)


def test_pipeline_defaults_to_cuda_and_raises_without_it():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    x, grouping, *_ = _study()
    with pytest.raises(RuntimeError, match="cuda"):
        pipeline.pipeline(x, grouping, n_perms=9)


def test_cpu_pipeline_launches_no_kernel():
    x, grouping, *_ = _study()
    before = (dict(dops.LAUNCHES), dict(fops.LAUNCHES))
    for bridge in ("dense", "stream", "fused", "fused-kernel"):
        pipeline.pipeline(x, grouping, n_perms=9, materialize=bridge,
                          dist_impl="braycurtis.cuda", fused_impl="cuda",
                          device="cpu")
    assert (dops.LAUNCHES, fops.LAUNCHES) == before


def test_cli_from_features_runs_on_cpu(capsys):
    assert cli.main(["--samples", "64", "--features", "16", "--groups", "4",
                     "--perms", "49", "--device", "cpu", "--from-features",
                     "--materialize", "stream", "--dist-impl",
                     "braycurtis.cuda"]) == 0
    out = capsys.readouterr().out
    assert "plan: braycurtis.cuda[] -> stream(rows=64)" in out
    assert "pipeline" in out and "F=" in out and "p=" in out


@pytest.mark.parametrize("extra", [
    ["--from-features"],
    ["--materialize", "stream", "--metric", "jaccard"],
    ["--dist-impl", "euclidean.dense", "--metric", "euclidean"],
    ["--from-features", "--materialize", "fused-kernel"],
    ["--materialize", "fused", "--metric", "aitchison"],
    ["--materialize", "fused-kernel", "--fused-impl", "xla", "--metric",
     "jaccard"],
])
def test_cli_from_features_matches_reference_cli_statistic(capsys, extra):
    """Same seed, same study: the observed F is the reference CLI's (the
    p-values differ: the label streams differ)."""
    from repro.launch import permanova as jcli
    argv = ["--samples", "64", "--features", "16", "--groups", "4",
            "--perms", "19"] + extra
    cli.main(argv + ["--device", "cpu"])
    out_t = capsys.readouterr().out
    old = sys.argv
    try:
        sys.argv = ["permanova"] + argv
        jcli.main()
    finally:
        sys.argv = old
    out_j = capsys.readouterr().out
    f_t = out_t.split("F=")[1].split()[0]
    f_j = out_j.split("F=")[1].split()[0]
    assert float(f_t) == pytest.approx(float(f_j), rel=1e-4)
    assert _as_reference(out_t.split("plan: ")[1].split(" :: ")[0]) == \
        out_j.split("plan: ")[1].split(" :: ")[0]


@pytest.mark.parametrize("bridge,impl", [("fused-kernel", "cuda"),
                                         ("fused-kernel", "torch"),
                                         ("fused", "auto")])
def test_cli_fused_bridges_run_on_cpu(capsys, bridge, impl):
    assert cli.main(["--samples", "64", "--features", "16", "--groups", "4",
                     "--perms", "49", "--device", "cpu", "--materialize",
                     bridge, "--fused-impl", impl]) == 0
    out = capsys.readouterr().out
    head = (f"plan: braycurtis.fusedk.{impl}[feat_bf16=0,feat_fp8=0] -> "
            "fused-kernel(rows=64)" if bridge == "fused-kernel" else
            "plan: braycurtis.blocked[block=64] -> fused(rows=64)")
    assert head in out
    assert "F=" in out and "p=" in out
