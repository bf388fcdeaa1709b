"""The port's precision modes against the reference's, on the same numpy
inputs: the fp8 helpers (scale, bytes, the 464 boundary), the bf16 cast,
the precision tags, both fused wrappers in each feature mode (their plain
versions here; the reference's megakernels in interpret mode), fp8 against
an fp64 oracle, the two fused-kernel sweeps at fp8, pipeline() at each
precision on the reference's permutations, the traffic and workset
models, explain()'s precision table, and --feat-precision on the CLI. The
CUDA kernels run only on the card; `chip_smoke.py` holds each mode's
kernel against these plain versions there."""

import functools
import os
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
from repro.core import distance as jdist  # noqa: E402
from repro.core import permutations as jperm  # noqa: E402
from repro.kernels.fused_sw import ops as jops  # noqa: E402
from repro.pipeline import registry as jreg  # noqa: E402
from repro_torch import pipeline  # noqa: E402
from repro_torch.core import distance, permutations  # noqa: E402
from repro_torch.kernels.fused_sw import ops, ref  # noqa: E402
from repro_torch.launch import permanova as cli  # noqa: E402
from repro_torch.pipeline import planner, registry, streaming  # noqa: E402

N, D, G = 53, 24, 5        # prime n, ragged groups (the reference's envelope)
METRICS = ["aitchison", "braycurtis", "euclidean", "jaccard"]
MODES = [(m, tag) for m in METRICS for tag in ("bf16", "fp8", "packed")
         if tag != "packed" or m == "jaccard"]
# port (plain version) against the reference's megakernel: what the two
# f32 accumulation orders leave on s_W and the row sums
RTOL, ATOL = 1e-4, 1e-5
# per-column forms cancel to ~s_T / n: held per entry to a fraction of s_T
COLS_S_T = 1e-6
# the reference's bars for fp8 s_W against the fp64 oracle
# (tests/test_precision.py:197): quantization through each metric's
# finalize; presence bits are exact in e4m3
FP8_TOLS = {"euclidean": 2e-2, "braycurtis": 2e-2, "jaccard": 1e-5}
# the reference's Pallas tiles in its parity tests
TILES = dict(tile_r=16, tile_c=16, feat_block=8, perm_block=4)
SLAB = (7, 30)             # an offset row slab: rows [7, 30)


def _study(seed=0, n=N, d=D, g=G):
    rng = np.random.default_rng(seed)
    x = rng.gamma(1.0, 1.0, size=(n, d)).astype(np.float32)
    x *= rng.random(size=(n, d)) < 0.5
    x[:, 0] = np.maximum(x[:, 0], 1e-3)
    grouping = rng.integers(0, g, size=n).astype(np.int32)
    grouping[:g] = np.arange(g)          # ragged sizes, every group present
    return x, grouping


def _perm_batch(grouping, n_perms, seed=3):
    rng = np.random.default_rng(seed)
    return np.stack([rng.permutation(grouping)
                     for _ in range(n_perms)]).astype(np.int32)


def _basis(n_perms, k, seed=6, n=N):
    """(P, n, K) f32 permuted orthonormal basis with an intercept."""
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(np.concatenate(
        [np.ones((n, 1)), rng.normal(size=(n, k - 1))], axis=1))
    perms = np.stack([np.arange(n)] + [rng.permutation(n)
                                       for _ in range(n_perms - 1)])
    return q[perms].astype(np.float32)


def _prep(metric, seed=1):
    """The reference's prepared features (numpy) and the port's tensor."""
    x, grouping = _study(seed=seed)
    prep = np.asarray(jdist.ROW_METRICS[metric].prepare(jnp.asarray(x)))
    tprep = distance.ROW_METRICS[metric].prepare(
        torch.from_numpy(x)).contiguous()
    return prep, tprep, grouping


def _knobs(tag):
    return registry.precision_tuning(tag)


# ---------------------------------------------------------------------------
# fp8 helpers and the bf16 cast
# ---------------------------------------------------------------------------

def _f32_bits(v):
    return np.asarray(v, np.float32).view(np.uint32)


@pytest.mark.parametrize("case", ["study", "wide", "zeros", "negative"])
def test_fp8_scale_is_bit_equal(case):
    x = {"study": _study()[0],
         "wide": np.asarray([[0.5, -900.0, 3.0]], np.float32),
         "zeros": np.zeros((2, 2), np.float32),
         "negative": -_study(seed=2)[0] * 1e3}[case]
    got = distance.fp8_scale(torch.from_numpy(x))
    want = jdist.fp8_scale(jnp.asarray(x))
    assert got.dtype == torch.float32 and got.dim() == 0
    assert _f32_bits(got.numpy()) == _f32_bits(want)
    assert distance.FP8_MAX == jdist.FP8_MAX


def test_fp8_metric_scale_pins_jaccard_to_one():
    x = torch.from_numpy(_study()[0] * 7)
    assert float(distance.fp8_metric_scale(x, "jaccard")) == 1.0
    for metric in ("braycurtis", "euclidean"):
        assert _f32_bits(distance.fp8_metric_scale(x, metric).numpy()) == \
            _f32_bits(jdist.fp8_metric_scale(jnp.asarray(x.numpy()), metric))


@pytest.mark.parametrize("metric", METRICS)
def test_fp8_quantized_bytes_equal_the_reference(metric):
    """x / s cast to e4m3 byte for byte, and the round trip value for
    value, on each metric's prepared table at its own scale."""
    prep, tprep, _ = _prep(metric)
    s_j = jdist.fp8_metric_scale(jnp.asarray(prep), metric)
    s_t = distance.fp8_metric_scale(tprep, metric)
    q_j = np.asarray((jnp.asarray(prep) / s_j).astype(jnp.float8_e4m3fn))
    q_t = distance.fp8_quantize(tprep, s_t)
    np.testing.assert_array_equal(q_t.view(torch.uint8).numpy(),
                                  q_j.view(np.uint8))
    np.testing.assert_array_equal(
        distance.fp8_roundtrip(tprep, s_t).numpy(),
        np.asarray(jdist.fp8_roundtrip(jnp.asarray(prep), s_j)))


@pytest.mark.parametrize("scale", [1.0, 0.5])
def test_fp8_boundary_at_464_with_a_pinned_scale(scale):
    """Past |x| / s = 464 the reference's cast gives NaN (with x's sign),
    where torch's alone saturates to +-448; 464 itself rounds to 448."""
    v = np.asarray([0.0, 447.0, 448.0, 456.0, 463.99, 464.0, 464.01, 465.0,
                    1e4, np.inf, -464.0, -464.5, -np.inf], np.float32)
    x = v * np.float32(scale)
    got = distance.fp8_quantize(torch.from_numpy(x), scale)
    want = np.asarray((jnp.asarray(x) / jnp.float32(scale)).astype(
        jnp.float8_e4m3fn))
    np.testing.assert_array_equal(got.view(torch.uint8).numpy(),
                                  want.view(np.uint8))
    rt = distance.fp8_roundtrip(torch.from_numpy(x), scale).numpy()
    np.testing.assert_array_equal(
        rt, np.asarray(jdist.fp8_roundtrip(jnp.asarray(x), scale)))
    assert np.isnan(rt[6:10]).all() and np.isnan(rt[11:]).all()
    assert rt[5] == 448.0 * scale and rt[10] == -448.0 * scale


@pytest.mark.parametrize("metric", METRICS)
def test_bf16_cast_is_byte_equal(metric):
    prep, tprep, _ = _prep(metric)
    got = tprep.to(torch.bfloat16).view(torch.int16).numpy()
    want = np.asarray(jnp.asarray(prep).astype(jnp.bfloat16)).view(np.int16)
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# Precision tags
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tuning", [
    None, {}, {"feat_bf16": 1}, {"feat_fp8": 1}, {"feat_packed": 1},
    {"feat_bf16": 1, "feat_fp8": 1}, {"feat_fp8": 1, "feat_packed": 1},
    {"feat_bf16": 0, "feat_fp8": 0, "tile_r": 32}])
def test_precision_tags_match_the_reference(tuning):
    assert registry.PRECISIONS == jreg.PRECISIONS
    assert registry.precision_tag(tuning) == jreg.precision_tag(tuning)
    assert registry.feat_element_bytes(tuning) == \
        jreg.feat_element_bytes(tuning)
    for tag in registry.PRECISIONS:
        assert registry.precision_tuning(tag) == jreg.precision_tuning(tag)
        assert registry.precision_tag(registry.precision_tuning(tag)) == tag
    with pytest.raises(ValueError, match="unknown precision"):
        registry.precision_tuning("int4")


# ---------------------------------------------------------------------------
# The fused wrappers in each feature mode
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _reference_rows(metric, tag, slab):
    prep, _, grouping = _prep(metric)
    g = _perm_batch(grouping, 9)
    inv = np.asarray(jperm.inv_group_sizes(jnp.asarray(grouping), G))
    lo, hi = slab
    sw, rs = jops.fused_sw_rows(
        jnp.asarray(prep[lo:hi]), jnp.asarray(prep), jnp.asarray(g[:, lo:hi]),
        jnp.asarray(g), jnp.asarray(inv), lo, metric=metric, **TILES,
        **_knobs(tag))
    return np.asarray(sw), np.asarray(rs)


def _port_rows(metric, tag, slab, fn=ops.fused_sw_rows):
    _, tprep, grouping = _prep(metric)
    g = torch.from_numpy(_perm_batch(grouping, 9))
    inv = permutations.inv_group_sizes(torch.from_numpy(grouping), G)
    lo, hi = slab
    return fn(tprep[lo:hi].contiguous(), tprep, g[:, lo:hi].contiguous(), g,
              inv, lo, metric=metric, **_knobs(tag))


@pytest.mark.parametrize("slab", [(0, N), SLAB])
@pytest.mark.parametrize("metric,tag", MODES)
def test_fused_sw_rows_matches_reference_in_each_mode(metric, tag, slab):
    """The wrapper on CPU tensors (the plain version: the features
    round-tripped through the mode, then f32) against the reference's
    megakernel in the same mode, interpret mode, full table and an
    offset row slab."""
    sw, rs = _port_rows(metric, tag, slab)
    sw_j, rs_j = _reference_rows(metric, tag, slab)
    assert sw.dtype == rs.dtype == torch.float32
    np.testing.assert_allclose(sw.numpy(), sw_j, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(rs.numpy(), rs_j, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("metric,tag", MODES)
def test_plain_version_is_the_wrapper_on_cpu_in_each_mode(metric, tag):
    for a, b in zip(_port_rows(metric, tag, SLAB),
                    _port_rows(metric, tag, SLAB, fn=ref.fused_sw_ref)):
        assert torch.equal(a, b)


@functools.lru_cache(maxsize=None)
def _reference_cols(metric, tag):
    prep, _, _ = _prep(metric)
    v = _basis(6, 5)
    sc, rs = jops.fused_sw_rows_cols(
        jnp.asarray(prep), jnp.asarray(prep), jnp.asarray(v), jnp.asarray(v),
        0, metric=metric, **TILES, **_knobs(tag))
    return np.asarray(sc), np.asarray(rs)


@pytest.mark.parametrize("metric,tag", MODES)
def test_fused_sw_rows_cols_matches_reference_in_each_mode(metric, tag):
    """The dense-design wrapper (plain version) against the reference's
    cols megakernel in the same mode: each per-column form within 1e-6
    s_T (the forms cancel to ~s_T / n, so a relative bar means little),
    the row sums at rtol 1e-4."""
    _, tprep, _ = _prep(metric)
    v = torch.from_numpy(_basis(6, 5))
    sc, rs = ops.fused_sw_rows_cols(tprep, tprep, v, v, 0, metric=metric,
                                    **_knobs(tag))
    sc_j, rs_j = _reference_cols(metric, tag)
    s_t = float(rs_j.astype(np.float64).sum()) / 2.0 / N
    assert sc.shape == (6, 5) and sc.dtype == torch.float32
    assert np.abs(sc.numpy() - sc_j).max() <= COLS_S_T * s_t
    np.testing.assert_allclose(rs.numpy(), rs_j, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("slab", [(0, N), SLAB])
def test_packed_equals_f32_jaccard_bit_for_bit(slab):
    """On presence data the packed mode's values are the f32 jaccard's:
    both forms give the same bits, labels and dense design."""
    assert all(torch.equal(a, b) for a, b in zip(
        _port_rows("jaccard", "packed", slab),
        _port_rows("jaccard", "f32", slab)))
    _, tprep, _ = _prep("jaccard")
    v = torch.from_numpy(_basis(4, 3))
    lo, hi = slab
    xr, vr = tprep[lo:hi].contiguous(), v[:, lo:hi].contiguous()
    a = ops.fused_sw_rows_cols(xr, tprep, vr, v, lo, metric="jaccard",
                               feat_packed=1)
    b = ops.fused_sw_rows_cols(xr, tprep, vr, v, lo, metric="jaccard")
    assert all(torch.equal(u, w) for u, w in zip(a, b))


def _sw_oracle_f64(xprep64, metric, g_batch, inv_gs):
    """fp64 numpy s_W for explicit label batches (the reference test's
    oracle, tests/test_precision.py)."""
    if metric == "euclidean":
        sq = (xprep64 * xprep64).sum(axis=1)
        dm2 = np.maximum(sq[:, None] + sq[None, :]
                         - 2.0 * xprep64 @ xprep64.T, 0.0)
    elif metric == "braycurtis":
        num = np.abs(xprep64[:, None, :] - xprep64[None, :, :]).sum(-1)
        den = (xprep64[:, None, :] + xprep64[None, :, :]).sum(-1)
        dm2 = (num / np.maximum(den, 1e-30)) ** 2
    else:
        b = (xprep64 > 0).astype(np.float64)
        inter = b @ b.T
        card = b.sum(axis=1)
        union = card[:, None] + card[None, :] - inter
        dm2 = (1.0 - inter / np.maximum(union, 1.0)) ** 2
    np.fill_diagonal(dm2, 0.0)
    out = []
    for g in g_batch:
        s = sum(inv_gs[k] * dm2[np.ix_(g == k, g == k)].sum()
                for k in range(len(inv_gs)))
        out.append(0.5 * s)
    return np.asarray(out)


@pytest.mark.parametrize("metric", ["euclidean", "braycurtis", "jaccard"])
def test_fp8_against_an_fp64_oracle(metric):
    """The fp8 mode's s_W against fp64 on the unquantized table, at the
    reference's per-metric bars."""
    x, grouping = _study(seed=6)
    tprep = distance.ROW_METRICS[metric].prepare(torch.from_numpy(x))
    g = _perm_batch(grouping, 8)
    inv = permutations.inv_group_sizes(torch.from_numpy(grouping), G)
    sw8, _ = ops.fused_sw_rows(tprep, tprep, torch.from_numpy(g),
                               torch.from_numpy(g), inv, 0, metric=metric,
                               feat_fp8=1)
    oracle = _sw_oracle_f64(tprep.double().numpy(), metric, g,
                            inv.double().numpy())
    np.testing.assert_allclose(sw8.numpy(), oracle, rtol=FP8_TOLS[metric])


@pytest.mark.parametrize("case,match", [
    ("packed_braycurtis", "jaccard"), ("packed_aitchison", "jaccard"),
    ("bf16_fp8", "mutually exclusive"), ("fp8_packed", "mutually exclusive")])
@pytest.mark.parametrize("form", ["rows", "cols"])
def test_wrappers_refuse_what_the_reference_refuses(case, match, form):
    metric = case.split("_")[1] if case.startswith("packed") else "jaccard"
    knobs = {"packed_braycurtis": {"feat_packed": 1},
             "packed_aitchison": {"feat_packed": 1},
             "bf16_fp8": {"feat_bf16": 1, "feat_fp8": 1},
             "fp8_packed": {"feat_fp8": 1, "feat_packed": 1}}[case]
    _, tprep, grouping = _prep(metric)
    g = torch.from_numpy(_perm_batch(grouping, 2))
    inv = permutations.inv_group_sizes(torch.from_numpy(grouping), G)
    v = torch.from_numpy(_basis(2, 3))
    with pytest.raises(ValueError, match=match):
        if form == "rows":
            ops.fused_sw_rows(tprep, tprep, g, g, inv, 0, metric=metric,
                              **knobs)
        else:
            ops.fused_sw_rows_cols(tprep, tprep, v, v, 0, metric=metric,
                                   **knobs)
    if form == "rows":      # the reference refuses the same call
        with pytest.raises(ValueError, match=match):
            jops.fused_sw_rows(jnp.asarray(tprep.numpy()),
                               jnp.asarray(tprep.numpy()),
                               jnp.asarray(g.numpy()),
                               jnp.asarray(g.numpy()),
                               jnp.asarray(inv.numpy()), 0, metric=metric,
                               **knobs)


def test_a_pinned_fp8_scale_is_honoured():
    """feat_scale pins the calibration: the result is the plain version
    on the table round-tripped at that scale, not at the table's own."""
    _, tprep, grouping = _prep("braycurtis")
    g = torch.from_numpy(_perm_batch(grouping, 4))
    inv = permutations.inv_group_sizes(torch.from_numpy(grouping), G)
    pinned = ops.fused_sw_rows(tprep, tprep, g, g, inv, 0, feat_fp8=1,
                               feat_scale=0.05)
    rt = distance.fp8_roundtrip(tprep, 0.05)
    want = ops.fused_sw_rows(rt, rt, g, g, inv, 0)
    own = ops.fused_sw_rows(tprep, tprep, g, g, inv, 0, feat_fp8=1)
    assert all(torch.equal(a, b) for a, b in zip(pinned, want))
    assert not torch.equal(pinned[0], own[0])


def test_quantize_slabs_gives_the_kernels_operands():
    _, tprep, _ = _prep("euclidean")
    for tag, dtype, width in (("f32", torch.float32, D),
                              ("bf16", torch.bfloat16, D),
                              ("fp8", torch.float8_e4m3fn, D),
                              ("packed", torch.int32, -(-D // 32))):
        metric = "jaccard" if tag == "packed" else "euclidean"
        mode, scale = ref.resolve_precision(tprep, metric, **_knobs(tag))
        assert mode == tag and (scale is None) == (tag != "fp8")
        xr, xc = ops.quantize_slabs(tprep[:9], tprep, mode, scale)
        assert xr.dtype == xc.dtype == dtype and xc.shape == (N, width)
        assert xr.shape == (9, width) and xr.is_contiguous()
    _, scale = ref.resolve_precision(tprep, "euclidean", feat_fp8=1)
    assert torch.equal(scale, distance.fp8_scale(tprep))
    _, pinned = ref.resolve_precision(tprep, "euclidean", feat_fp8=1,
                                      feat_scale=0.25)
    assert pinned.dtype == torch.float32 and float(pinned) == 0.25
    xr, xc = ops.quantize_slabs(tprep, tprep, "packed")
    assert xr is xc                 # the table itself is quantized once
    torch.testing.assert_close(xc, distance.pack_presence_bits(tprep))


# ---------------------------------------------------------------------------
# The fused-kernel sweeps and pipeline() at each precision
# ---------------------------------------------------------------------------

def test_both_sweeps_agree_at_fp8():
    """The CUDA kind (its plain version on CPU tensors) and the torch
    sweep quantize alike (one per-study scale), so they agree to f32
    accumulation order at fp8 (the reference's
    test_megakernel_matches_xla_at_fp8)."""
    x, grouping = _study(seed=7)
    rows = distance.ROW_METRICS["braycurtis"].rows
    xp = torch.from_numpy(x)
    g = torch.from_numpy(grouping)
    inv = permutations.inv_group_sizes(g, G)
    kw = dict(kernel_metric="braycurtis", row_block=16, chunk=7, seed=11,
              tuning={"feat_fp8": 1})
    sw_c, st_c, _ = streaming.fused_kernel_sw(xp, rows, g, inv, 21,
                                              impl="cuda", **kw)
    sw_t, st_t, _ = streaming.fused_kernel_sw(xp, rows, g, inv, 21,
                                              impl="torch", **kw)
    torch.testing.assert_close(sw_c, sw_t, rtol=1e-4, atol=0)
    assert float(st_c) == pytest.approx(float(st_t), rel=1e-4)
    f32, _, _ = streaming.fused_kernel_sw(xp, rows, g, inv, 21, impl="cuda",
                                          **{**kw, "tuning": None})
    assert not torch.equal(sw_c, f32)


@functools.lru_cache(maxsize=None)
def _pipeline_reference(metric, tag, impl, design):
    x, grouping = _study(seed=4)
    key = jax.random.key(5)
    kw = dict(metric=metric, n_perms=29, materialize="fused-kernel",
              fused_impl=impl, fused_tuning={**TILES, **_knobs(tag)})
    n_total = 30
    if design:
        cov = np.random.default_rng(8).normal(size=(N, 2))
        res = jpipe.pipeline(jnp.asarray(x), jnp.asarray(grouping), key=key,
                             covariates=cov, **kw)
        perms = np.array(jperm.strata_permutation_batch(
            key, jnp.zeros(N, jnp.int32), 0, n_total))
        stats = [(float(t.f_stat), float(t.p_value)) for t in res.terms]
        return x, grouping, cov, perms, stats
    res = jpipe.pipeline(jnp.asarray(x), jnp.asarray(grouping), key=key,
                         **kw)
    perms = np.asarray(jperm.permutation_batch(key, jnp.asarray(grouping), 0,
                                               n_total))
    return x, grouping, None, perms, [(float(res.f_stat),
                                       float(res.p_value))]


@pytest.mark.parametrize("impl", [("cuda", "pallas"), ("torch", "xla")])
@pytest.mark.parametrize("metric,tag", [
    ("braycurtis", "bf16"), ("braycurtis", "fp8"), ("euclidean", "fp8"),
    ("aitchison", "bf16"), ("jaccard", "fp8"), ("jaccard", "packed")])
def test_pipeline_at_each_precision_matches_reference(metric, tag, impl):
    """pipeline() on the fused-kernel bridge at a precision, fed the
    reference's label draws: F within rtol 1e-4 of the reference's
    pipeline() at the same precision (its megakernel in interpret mode,
    or its XLA sweep), p equal."""
    impl_t, impl_j = impl
    x, grouping, _, perms, want = _pipeline_reference(metric, tag, impl_j,
                                                      False)
    res = pipeline.pipeline(torch.from_numpy(x), torch.from_numpy(grouping),
                            metric=metric, n_perms=29,
                            perms=torch.from_numpy(perms.astype(np.int32)),
                            materialize="fused-kernel", fused_impl=impl_t,
                            fused_tuning=_knobs(tag), device="cpu")
    f, p = want[0]
    assert float(res.f_stat) == pytest.approx(f, rel=RTOL)
    assert float(res.p_value) == p
    assert f"feat_{tag}=1" in res.plan.split(" -> ")[0]


@pytest.mark.parametrize("impl", [("cuda", "pallas"), ("torch", "xla")])
@pytest.mark.parametrize("metric,tag", [("braycurtis", "fp8"),
                                        ("braycurtis", "bf16"),
                                        ("jaccard", "packed")])
def test_design_pipeline_at_each_precision_matches_reference(metric, tag,
                                                             impl):
    """A covariate design at a precision on the reference's index
    permutations: per-term F within rtol 1e-4, p equal."""
    impl_t, impl_j = impl
    x, grouping, cov, perms, want = _pipeline_reference(metric, tag, impl_j,
                                                        True)
    res = pipeline.pipeline(
        torch.from_numpy(x), torch.from_numpy(grouping), metric=metric,
        n_perms=29, covariates=cov,
        index_perms=torch.from_numpy(perms.astype(np.int32)),
        materialize="fused-kernel", fused_impl=impl_t,
        fused_tuning=_knobs(tag), device="cpu")
    got = [(float(t.f_stat), float(t.p_value)) for t in res.terms]
    np.testing.assert_allclose([g[0] for g in got], [w[0] for w in want],
                               rtol=RTOL)
    assert [g[1] for g in got] == [w[1] for w in want]


@pytest.mark.parametrize("design", [False, True])
def test_packed_pipeline_equals_f32_jaccard_bit_for_bit(design):
    x, grouping = _study(seed=9)
    kw = dict(metric="jaccard", n_perms=19, seed=2,
              materialize="fused-kernel", fused_impl="cuda", device="cpu")
    if design:
        kw["covariates"] = np.random.default_rng(1).normal(size=(N, 2))
    a = pipeline.pipeline(x, grouping, fused_tuning={"feat_packed": 1}, **kw)
    b = pipeline.pipeline(x, grouping, **kw)
    for u, w in (zip(a.terms, b.terms) if design else [(a, b)]):
        assert torch.equal(u.f_perms, w.f_perms)
        assert float(u.p_value) == float(w.p_value)


@pytest.mark.parametrize("case", ["dense_bridge", "stream_bridge",
                                  "fused_bridge", "auto_small_n",
                                  "packed_braycurtis", "two_knobs"])
def test_planner_refuses_precision_it_cannot_run(case):
    """Precision knobs select the fused kernels' feature modes: on another
    bridge, packed on a non-jaccard body, or two knobs at once, the plan
    is refused (ValueError) instead of silently running f32."""
    kw = dict(backend="cpu", metric="braycurtis",
              fused_tuning={"feat_fp8": 1})
    if case.endswith("_bridge"):
        kw["materialize"] = case.split("_")[0]
    elif case == "packed_braycurtis":
        kw.update(materialize="fused-kernel", fused_tuning={"feat_packed": 1})
    elif case == "two_knobs":
        kw.update(materialize="fused-kernel", metric="jaccard",
                  fused_tuning={"feat_bf16": 1, "feat_packed": 1})
    with pytest.raises(ValueError, match="fused-kernel|jaccard|exclusive"):
        planner.plan_pipeline(100, 8, 100, 2, **kw)


def test_planner_resolves_the_knobs_into_fused_tuning():
    for tag in registry.PRECISIONS:
        metric = "jaccard" if tag == "packed" else "euclidean"
        pl = planner.plan_pipeline(100, 8, 100, 2, backend="cpu",
                                   metric=metric, materialize="fused-kernel",
                                   fused_tuning=_knobs(tag))
        assert registry.precision_tag(pl.fused_tuning) == tag
        t = ",".join(f"{k}={v}" for k, v in sorted(pl.fused_tuning.items()))
        assert pl.describe_stage1().startswith(f"{metric}.fusedk.torch[{t}]")


# ---------------------------------------------------------------------------
# Traffic and workset models, explain()
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("metric", METRICS)
def test_torch_kind_models_equal_the_reference_xla_kind(metric):
    spec = registry.get_fused(f"{metric}.fusedk.torch")
    jspec = jreg.get_fused(f"{metric}.fusedk.xla")
    for tag in registry.PRECISIONS:
        t = _knobs(tag)
        for n, d, block in ((512, 256, 256), (1000, 64, 128)):
            assert registry.fused_feat_traffic_bytes(spec, n, d, t, block) \
                == jreg.fused_feat_traffic_bytes(jspec, n, d, t, block)
            assert registry.fused_workset_bytes(spec, n, d, 64, 8, block, t) \
                == jreg.fused_workset_bytes(jspec, n, d, 64, 8, block, t)


def test_cuda_kind_traffic_follows_the_element_width():
    """The kernel's model: the 64 x 64 tiles j >= i of the sweep's
    whole-table call, each staging 64 rows' and 64 columns' features at
    the mode's width, so f32 : bf16 : fp8 : packed = 32 : 16 : 8 : 1 (the
    reference's 32x packed cut), and the quantized table is what a mode
    adds to the workset."""
    spec = registry.get_fused("jaccard.fusedk.cuda")
    n, d = 1024, 512
    t = {tag: registry.fused_feat_traffic_bytes(spec, n, d, _knobs(tag))
         for tag in registry.PRECISIONS}
    nt = n // 64
    assert t["f32"] == 4.0 * d * nt * (nt + 1) / 2 * 128
    assert t["f32"] / t["packed"] == 32.0
    assert t["f32"] == 2 * t["bf16"] == 4 * t["fp8"]
    base = spec.workset_bytes(n, d, 64, 8, 256)
    for tag in registry.PRECISIONS:
        extra = registry.fused_workset_bytes(spec, n, d, 64, 8, 256,
                                             _knobs(tag)) - base
        assert extra == (0 if tag == "f32" else
                         registry.feat_element_bytes(_knobs(tag)) * n * d)


@pytest.mark.parametrize("metric,kind", [("jaccard", "cuda"),
                                         ("jaccard", "torch"),
                                         ("euclidean", "cuda")])
def test_explain_lists_each_precision_and_marks_the_planned(metric, kind):
    tag = "packed" if metric == "jaccard" else "fp8"
    pl = planner.plan_pipeline(512, 64, 100, 8, backend="cpu", metric=metric,
                               materialize="fused-kernel", fused_impl=kind,
                               fused_tuning=_knobs(tag))
    text = pl.explain()
    rows = [ln.split(":")[0].strip() for ln in text.splitlines()[2:]]
    assert rows == (["f32", "bf16", "fp8", "packed"] if metric == "jaccard"
                    else ["f32", "bf16", "fp8"])
    planned = [ln for ln in text.splitlines() if ln.endswith("<- planned")]
    assert len(planned) == 1 and planned[0].strip().startswith(tag)
    assert f"{kind} kind" in text.splitlines()[1]
    # the reference's table for the reference's kind, row for row
    jpl = jpipe.plan_pipeline(512, 64, 100, 8, backend="cpu", metric=metric,
                              materialize="fused-kernel",
                              fused_impl="xla" if kind == "torch" else
                              "pallas", fused_tuning=_knobs(tag))
    if kind == "torch":
        assert text.splitlines()[2:] == jpl.explain().splitlines()[2:]
    assert planner.plan_pipeline(512, 64, 100, 8, backend="cpu",
                                 metric=metric,
                                 materialize="dense").explain() == \
        planner.plan_pipeline(512, 64, 100, 8, backend="cpu", metric=metric,
                              materialize="dense").describe()


# ---------------------------------------------------------------------------
# --feat-precision on the CLI
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tag,metric", [("bf16", "braycurtis"),
                                        ("fp8", "euclidean"),
                                        ("packed", "jaccard")])
def test_cli_feat_precision_runs_on_cpu(capsys, tag, metric):
    """--feat-precision routes to the fused-kernel bridge (the torch
    sweep on the CPU) at that precision; the observed F is the reference
    CLI's at the same precision (the label streams differ, so p may)."""
    from repro.launch import permanova as jcli
    argv = ["--samples", "64", "--features", "16", "--groups", "4",
            "--perms", "19", "--metric", metric, "--feat-precision", tag]
    assert cli.main(argv + ["--device", "cpu"]) == 0
    out_t = capsys.readouterr().out
    head = out_t.split("plan: ")[1].split(" -> ")[:2]
    assert head[0].startswith(f"{metric}.fusedk.torch[")
    assert f"feat_{tag}=1" in head[0] and head[1] == "fused-kernel(rows=64)"
    old = sys.argv
    try:
        sys.argv = ["permanova"] + argv + ["--fused-impl", "xla"]
        jcli.main()
    finally:
        sys.argv = old
    out_j = capsys.readouterr().out
    f_t = float(out_t.split("F=")[1].split()[0])
    f_j = float(out_j.split("F=")[1].split()[0])
    assert f_t == pytest.approx(f_j, rel=RTOL)


def test_cli_feat_precision_refuses_another_bridge(capsys):
    with pytest.raises(SystemExit):
        cli.main(["--samples", "64", "--perms", "9", "--device", "cpu",
                  "--feat-precision", "fp8", "--materialize", "stream"])
    assert "--feat-precision applies to the fused-kernel sweep" in \
        capsys.readouterr().err
