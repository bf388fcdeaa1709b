"""The port's fused distance -> s_W wrapper and plain version against the
reference's megakernel (interpret mode) and its plain version, on the same
numpy inputs: every metric at the reference test's shape (prime n, ragged
groups), offset row slabs, the global-index mask, the precision knobs (the
modes themselves are held to the reference in test_torch_precision.py),
the wrapper's contract, the single-pass sweeps of
pipeline.streaming, and the kernel build/binding. The CUDA kernel itself
runs only on the card; `chip_smoke.py` holds it against this plain
version there."""

import functools
import os
import re
import subprocess
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

from repro.core import distance as jdist  # noqa: E402
from repro.core import permutations as jperm  # noqa: E402
from repro.kernels.fused_sw import ops as jops  # noqa: E402
from repro.kernels.fused_sw import ref as jref  # noqa: E402
from repro.pipeline import streaming as jstreaming  # noqa: E402
from repro_torch.core import design, distance, permutations  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.fused_sw import ops, ref  # noqa: E402
from repro_torch.kernels.permanova_sw import ref as ref_sw  # noqa: E402,E501
from repro_torch.pipeline import streaming  # noqa: E402

N, D, G = 53, 24, 5            # prime n, ragged group sizes
METRICS = ["aitchison", "braycurtis", "euclidean", "jaccard"]
# the reference's own bar for the megakernel against its oracle
# (tests/test_fused_sw.py), and for offset slabs against the full call
RTOL, ATOL = 2e-4, 1e-5
SLAB_RTOL = 1e-4
# the reference's Pallas tiles in its parity test: odd tiles, PB = 4
TILES = dict(tile_r=16, tile_c=16, feat_block=8, perm_block=4)


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


def _operands(metric, seed=1, n_perms=10):
    """numpy (prepared features, labels, inv_gs) from the reference's
    prepare, and the port's tensors of the same values."""
    x, grouping = _study(seed=seed)
    prep = np.asarray(jdist.ROW_METRICS[metric].prepare(jnp.asarray(x)))
    inv = np.asarray(jperm.inv_group_sizes(jnp.asarray(grouping), G))
    g = _perm_batch(grouping, n_perms)
    tprep = distance.ROW_METRICS[metric].prepare(
        torch.from_numpy(x)).contiguous()
    return (prep, g, inv), (tprep, torch.from_numpy(g),
                            torch.from_numpy(inv.copy()))


@functools.lru_cache(maxsize=None)
def _reference(metric, form):
    (prep, g, inv), _ = _operands(metric)
    args = (jnp.asarray(prep), jnp.asarray(prep), jnp.asarray(g),
            jnp.asarray(g), jnp.asarray(inv), 0)
    if form == "kernel":
        sw, rs = jops.fused_sw_rows(*args, metric=metric, **TILES)
    else:
        sw, rs = jref.fused_sw_ref(*args, metric=metric)
    return np.asarray(sw), np.asarray(rs)


@pytest.mark.parametrize("form", ["kernel", "oracle"])
@pytest.mark.parametrize("metric", METRICS)
def test_port_matches_reference(metric, form):
    """ops.fused_sw_rows on CPU tensors (the plain version) against the
    reference's megakernel in interpret mode and its jnp oracle."""
    _, (xp, g, inv) = _operands(metric)
    sw, rs = ops.fused_sw_rows(xp, xp, g, g, inv, 0, metric=metric)
    sw_j, rs_j = _reference(metric, form)
    assert sw.dtype == rs.dtype == torch.float32
    assert sw.shape == (10,) and rs.shape == (N,)
    np.testing.assert_allclose(sw.numpy(), sw_j, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(rs.numpy(), rs_j, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("metric", METRICS)
def test_plain_version_is_the_wrapper_on_cpu(metric):
    _, (xp, g, inv) = _operands(metric)
    got = ops.fused_sw_rows(xp, xp, g, g, inv, 0, metric=metric)
    want = ref.fused_sw_ref(xp, xp, g, g, inv, 0, metric=metric)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("metric", METRICS)
def test_offset_slabs_sum_to_the_full_call(metric):
    """Slabs of 19 rows at their global offsets (19 divides nothing here):
    the s_W partials sum to the full call and the row sums concatenate to
    it; the diagonal is masked at row_offset + r == c, not r == c."""
    _, (xp, g, inv) = _operands(metric, seed=3, n_perms=7)
    full, rs_full = ops.fused_sw_rows(xp, xp, g, g, inv, 0, metric=metric)
    acc, parts = torch.zeros_like(full), []
    for lo in range(0, N, 19):
        hi = min(lo + 19, N)
        sw, rs = ops.fused_sw_rows(xp[lo:hi].contiguous(), xp,
                                   g[:, lo:hi].contiguous(), g, inv, lo,
                                   metric=metric)
        acc += sw
        parts.append(rs)
    torch.testing.assert_close(acc, full, rtol=SLAB_RTOL, atol=0)
    torch.testing.assert_close(torch.cat(parts), rs_full, rtol=SLAB_RTOL,
                               atol=0)


def test_offset_slabs_match_the_reference_kernel():
    (prep, g, inv), (xp, tg, tinv) = _operands("braycurtis", seed=3,
                                               n_perms=7)
    for lo in range(0, N, 19):
        hi = min(lo + 19, N)
        sw_j, rs_j = jops.fused_sw_rows(
            jnp.asarray(prep[lo:hi]), jnp.asarray(prep),
            jnp.asarray(g[:, lo:hi]), jnp.asarray(g), jnp.asarray(inv), lo,
            metric="braycurtis", tile_r=8, tile_c=16, feat_block=8,
            perm_block=4)
        sw, rs = ops.fused_sw_rows(xp[lo:hi].contiguous(), xp,
                                   tg[:, lo:hi].contiguous(), tg, tinv, lo)
        np.testing.assert_allclose(sw.numpy(), np.asarray(sw_j), rtol=RTOL,
                                   atol=ATOL)
        np.testing.assert_allclose(rs.numpy(), np.asarray(rs_j), rtol=RTOL,
                                   atol=ATOL)


@pytest.mark.parametrize("n_valid", [N - 1, 40])
def test_n_valid_masks_pad_rows_and_columns(n_valid):
    """Rows or columns at or past n_valid add nothing: the call equals
    the call on the first n_valid samples (row sums of pad rows are 0)."""
    _, (xp, g, inv) = _operands("euclidean")
    sw, rs = ops.fused_sw_rows(xp, xp, g, g, inv, 0, metric="euclidean",
                               n_valid=n_valid)
    xs, gs = xp[:n_valid].contiguous(), g[:, :n_valid].contiguous()
    sw_s, rs_s = ops.fused_sw_rows(xs, xs, gs, gs, inv, 0,
                                   metric="euclidean")
    torch.testing.assert_close(sw, sw_s, rtol=1e-6, atol=0)
    torch.testing.assert_close(rs[:n_valid], rs_s, rtol=1e-6, atol=0)
    assert torch.all(rs[n_valid:] == 0)


def test_euclidean_self_pairs_are_masked():
    """The Gram trick leaves f32 residue on the self pair; the mask zeroes
    it, so the row sums equal those of the exact-zero-diagonal mat2."""
    _, (xp, g, inv) = _operands("euclidean")
    _, rs = ops.fused_sw_rows(xp, xp, g, g, inv, 0, metric="euclidean")
    d = distance.euclidean_rows(xp, xp)
    m2 = (d * d).fill_diagonal_(0.0)
    torch.testing.assert_close(rs, m2.sum(dim=1), rtol=1e-6, atol=0)


def test_tile_knobs_are_accepted_and_ignored():
    _, (xp, g, inv) = _operands("jaccard")
    a = ops.fused_sw_rows(xp, xp, g, g, inv, 0, metric="jaccard")
    b = ops.fused_sw_rows(xp, xp, g, g, inv, 0, metric="jaccard", **TILES)
    for u, v in zip(a, b):
        assert torch.equal(u, v)


@pytest.mark.parametrize("fn", ["ops", "ref"])
@pytest.mark.parametrize("knob,value", [
    ("feat_bf16", 1), ("feat_fp8", 1), ("feat_packed", 1),
    ("feat_scale", 0.5)])
def test_precision_knobs_raise_naming_their_slice(fn, knob, value):
    """The knobs raised until the precision slice ported them (hence the
    name); now each runs, in the wrapper and the plain version alike, and
    equals the f32 plain version on the table round-tripped through its
    mode (packed on jaccard's presence data; feat_scale alone pins
    nothing, as in the reference)."""
    metric = "jaccard" if knob == "feat_packed" else "braycurtis"
    _, (xp, g, inv) = _operands(metric)
    call = ops.fused_sw_rows if fn == "ops" else ref.fused_sw_ref
    got = call(xp, xp, g, g, inv, 0, metric=metric, **{knob: value})
    mode = ref.feature_mode(metric, **({} if knob == "feat_scale"
                                       else {knob: value}))
    scale = distance.fp8_scale(xp) if mode == "fp8" else None
    rt = ref.roundtrip(xp, mode, scale)
    want = ref.fused_sw_ref(rt, rt, g, g, inv, 0, metric=metric)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    if knob in ("feat_bf16", "feat_fp8"):    # the mode changed the values
        assert not torch.equal(got[0], ref.fused_sw_ref(
            xp, xp, g, g, inv, 0, metric=metric)[0])


@pytest.mark.parametrize("case,exc", [
    ("unknown_metric", ValueError),
    ("one_dim", ValueError),
    ("widths_differ", ValueError),
    ("f64", TypeError),
    ("labels_int64", TypeError),
    ("labels_shape", ValueError),
    ("inv_gs_f64", TypeError),
    ("not_contiguous", ValueError),
    ("mixed_devices", ValueError),
    ("negative_offset", ValueError),
    ("n_valid_too_large", ValueError),
])
def test_wrapper_rejects(case, exc):
    _, (xp, g, inv) = _operands("braycurtis")
    kw = dict(metric="braycurtis")
    xr, x, gr, gc, off = xp, xp, g, g, 0
    if case == "unknown_metric":
        kw["metric"] = "cosine"
    elif case == "one_dim":
        xr = xp[0]
    elif case == "widths_differ":
        x = xp[:, :5].contiguous()
    elif case == "f64":
        xr = xp.double()
    elif case == "labels_int64":
        gr = g.long()
    elif case == "labels_shape":
        gr = g[:, :10].contiguous()
    elif case == "inv_gs_f64":
        inv = inv.double()
    elif case == "not_contiguous":
        x = xp.T.contiguous().T
    elif case == "mixed_devices":
        gc = g.to("meta")
    elif case == "negative_offset":
        off = -1
    elif case == "n_valid_too_large":
        kw["n_valid"] = N + 1
    with pytest.raises(exc):
        ops.fused_sw_rows(xr, x, gr, gc, inv, off, **kw)


def test_cpu_calls_launch_nothing():
    _, (xp, g, inv) = _operands("braycurtis")
    v = torch.from_numpy(_basis(7, 3))
    before = dict(ops.LAUNCHES)
    for metric in METRICS:
        ops.fused_sw_rows(xp, xp, g, g, inv, 0, metric=metric)
        ops.fused_sw_rows_cols(xp, xp, v, v, 0, metric=metric)
    assert ops.LAUNCHES == before
    assert set(before) == {ops.launch_key(k, m) for k in ops.KERNELS
                           for m in ops.MODES}


def test_partials_at_the_emp_shape():
    """The sweep's call (the whole table against itself) is symmetric:
    5,025 work items, each a row tile and a strip of 16 column tiles at
    or past the diagonal (sum_{c < 25} (393 - 16 c)), walked by
    min(SW_SLOTS, items) = 4,096 slots, with one running s_W per (slot,
    permutation) and one f64 D2 total per slot: 16 KiB a permutation,
    under a sixth of the labels' 4 n, and 32 KiB whatever the chunk and
    the n, where the earlier layout also held (strips + row tiles) x n row
    sums (40.1 MiB at n = 25,145, 633.6 MiB at 100,000). At the plan's EMP
    chunk (1,664) partials and labels take 185.7 MiB of the 256 MiB
    budget. A slab call walks every (row tile, strip) item; the row sums,
    when a direct caller asks for them, take (strips + row tiles, n)
    floats for that call only."""
    n, chunk = 25145, 1664
    items = sum(393 - 16 * c for c in range(25))
    assert items == 5025 and ops.n_slots(n, n, True) == ops.SW_SLOTS == 4096
    assert ops.partial_shapes(n, n, chunk) == ((4096, chunk), (4097,))
    assert ops.workspace_bytes(n, n, chunk) == \
        4 * 4096 * chunk + 8 * 4097 + 4 * chunk
    assert 6 * 4 * 4096 < 4 * n
    assert (ops.workspace_bytes(n, n, chunk) + 4 * chunk * n) / 2 ** 20 \
        == pytest.approx(185.65, abs=0.01)
    for big in (60000, 100000):
        assert ops.workspace_bytes(big, big, 0) == 8 * 4097
    assert ops.partial_shapes(n, n, chunk, symmetric=False) == \
        ((4096, chunk), (4097,))
    assert ops.partial_shapes(300, n, 7) == ((5 * 25, 7), (126,))
    assert ops.row_sum_shape(n, n, True) == (25 + 393, n)
    assert ops.row_sum_shape(300, n, False) == (25, 300)
    assert len(_tile_blocks(n, n, True, ops.SW_STRIP_TILES)) == items
    assert _tile_blocks(n, n, True, ops.SW_STRIP_TILES)[393] == (0, 16, 1)


@pytest.mark.parametrize("kernel", ["fused_sw", "fused_sw_cols"])
@pytest.mark.parametrize("nr,n,symmetric", [
    (25145, 25145, True), (25145, 25145, False), (300, 25145, False),
    (331, 331, True), (2047, 2047, True), (60000, 60000, True)])
def test_slot_walk_covers_every_work_item_once(kernel, nr, n, symmetric):
    """A Python model of the kernels' item-to-slot map (_slot_items: slot
    s walks the work items s, s + slots, ..., the source's item loop):
    every (row tile, strip) item of the launch, in the order _tile_blocks
    models, is visited by exactly one slot, in increasing order within
    the slot; the slots, and so each item's slot and place in it, depend
    on the shape alone: the partials' rows are the same for any P."""
    strip = ops.LAYOUT[kernel][0]
    tiles = _tile_blocks(nr, n, symmetric, strip)
    slots = ops.n_slots(nr, n, symmetric, kernel)
    assert slots == min(ops.LAYOUT[kernel][1], len(tiles))
    walks = [_slot_items(s, len(tiles), slots) for s in range(slots)]
    seen = sorted(b for w in walks for b in w)
    assert seen == list(range(len(tiles)))
    assert all(w == sorted(w) and w[0] == s for s, w in enumerate(walks))
    shapes = ops.partial_shapes if kernel == "fused_sw" else (
        lambda *a: ops.cols_partial_shapes(*a[:3], 10, *a[3:]))
    for p in (1, 129, 5000):
        assert shapes(nr, n, p, symmetric)[0] == (slots, p * (
            1 if kernel == "fused_sw" else 10))


# ---------------------------------------------------------------------------
# The dense-design kernel's wrapper and plain version (fused_sw_cols).
# ---------------------------------------------------------------------------

def _basis(n_perms, k, seed=6, n=N):
    """(P, n, K) f32 permuted design basis: an orthonormal basis with an
    intercept column, rows gathered by random permutations."""
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(np.concatenate(
        [np.ones((n, 1)), rng.normal(size=(n, k - 1))], axis=1))
    perms = np.stack([np.arange(n)] + [rng.permutation(n)
                                       for _ in range(n_perms - 1)])
    return q[perms].astype(np.float32)


@functools.lru_cache(maxsize=None)
def _cols_reference(metric, n_perms=6, k=5):
    (prep, _, _), _ = _operands(metric)
    v = _basis(n_perms, k)
    sc, rs = jops.fused_sw_rows_cols(
        jnp.asarray(prep), jnp.asarray(prep), jnp.asarray(v), jnp.asarray(v),
        0, metric=metric, **TILES)
    return np.asarray(sc), np.asarray(rs)


@pytest.mark.parametrize("metric", METRICS)
def test_cols_port_matches_reference_kernel(metric):
    """ops.fused_sw_rows_cols on CPU tensors (the plain version) against
    the reference's dense-design megakernel in interpret mode, prime n,
    K = 5 (padded to 8 lanes there): rtol 2e-4, atol 1e-5."""
    _, (xp, _, _) = _operands(metric)
    v = torch.from_numpy(_basis(6, 5))
    sc, rs = ops.fused_sw_rows_cols(xp, xp, v, v, 0, metric=metric)
    sc_j, rs_j = _cols_reference(metric)
    assert sc.dtype == rs.dtype == torch.float32
    assert sc.shape == (6, 5) and rs.shape == (N,)
    np.testing.assert_allclose(sc.numpy(), sc_j, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(rs.numpy(), rs_j, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("metric", METRICS)
def test_cols_plain_version_is_the_wrapper_on_cpu(metric):
    _, (xp, _, _) = _operands(metric)
    v = torch.from_numpy(_basis(4, 3))
    got = ops.fused_sw_rows_cols(xp, xp, v, v, 0, metric=metric)
    want = ref.fused_sw_cols_ref(xp, xp, v, v, 0, metric=metric)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("metric", METRICS)
def test_cols_offset_slabs_sum_to_the_full_call(metric):
    """Slabs of 19 rows at their global offsets, over the table padded
    with zero rows past n_valid = N (so the last slab is all pad rows and
    gives exact zeros): the per-column partials sum to the full call and
    the row sums concatenate to it."""
    _, (xp, _, _) = _operands(metric, seed=3)
    v = torch.from_numpy(_basis(5, 4, seed=3))
    full, rs_full = ops.fused_sw_rows_cols(xp, xp, v, v, 0, metric=metric)
    pad = 76 - N
    xq = torch.nn.functional.pad(xp, (0, 0, 0, pad))
    vq = torch.nn.functional.pad(v, (0, 0, 0, pad))
    acc, parts = torch.zeros_like(full), []
    for lo in range(0, 76, 19):
        sc, rs = ops.fused_sw_rows_cols(
            xq[lo:lo + 19].contiguous(), xq, vq[:, lo:lo + 19].contiguous(),
            vq, lo, metric=metric, n_valid=N)
        acc += sc
        parts.append(rs)
    assert torch.all(sc == 0) and torch.all(rs == 0)   # rows 57-75: pad
    torch.testing.assert_close(acc, full, rtol=SLAB_RTOL, atol=ATOL)
    torch.testing.assert_close(torch.cat(parts)[:N], rs_full,
                               rtol=SLAB_RTOL, atol=0)


def test_cols_offset_slabs_match_the_reference_kernel():
    """Odd slabs (odd n, a ragged last slab) against the reference's
    kernel at the same offsets, with n_valid masking the last rows."""
    (prep, _, _), (xp, _, _) = _operands("braycurtis", seed=3)
    v = _basis(5, 7, seed=3)
    vt = torch.from_numpy(v)
    for lo in range(0, N, 23):
        hi = min(lo + 23, N)
        sc_j, rs_j = jops.fused_sw_rows_cols(
            jnp.asarray(prep[lo:hi]), jnp.asarray(prep),
            jnp.asarray(v[:, lo:hi]), jnp.asarray(v), lo,
            metric="braycurtis", n_valid=N - 4, tile_r=8, tile_c=16,
            feat_block=8, perm_block=2)
        sc, rs = ops.fused_sw_rows_cols(xp[lo:hi].contiguous(), xp,
                                        vt[:, lo:hi].contiguous(), vt, lo,
                                        n_valid=N - 4)
        np.testing.assert_allclose(sc.numpy(), np.asarray(sc_j), rtol=RTOL,
                                   atol=ATOL)
        np.testing.assert_allclose(rs.numpy(), np.asarray(rs_j), rtol=RTOL,
                                   atol=ATOL)


def test_cols_with_one_hot_columns_is_the_label_statistic():
    """With the one-hot factor sqrt(1/n_g) 1[g_i == g] as the basis, the
    per-column forms sum to the label kernel's s_W (rtol 1e-5)."""
    _, (xp, g, inv) = _operands("euclidean")
    from repro_torch.core import fstat
    e = fstat.onehot_perm_factors(g, inv, torch.float32).contiguous()
    sc, rs = ops.fused_sw_rows_cols(xp, xp, e, e, 0, metric="euclidean")
    sw, rs_l = ops.fused_sw_rows(xp, xp, g, g, inv, 0, metric="euclidean")
    torch.testing.assert_close(sc.sum(dim=1), sw, rtol=1e-5, atol=0)
    torch.testing.assert_close(rs, rs_l, rtol=1e-6, atol=0)


def _masked_d2_f64(xp, metric):
    """The plain version's own f32 masked D^2 of the whole table, as a
    float64 numpy array (diagonal zeroed)."""
    d = ref.ROWS_FNS[metric](xp, xp)
    m2 = (d * d).double().numpy()
    np.fill_diagonal(m2, 0.0)
    return m2


def _ulps(got, oracle):
    """Largest distance of float32 results from a float64 oracle, in
    units of the f32 spacing at the oracle's value."""
    o32 = np.abs(oracle).astype(np.float32)
    return float((np.abs(np.asarray(got, np.float64) - oracle)
                  / np.spacing(o32).astype(np.float64)).max())


@pytest.mark.parametrize("metric", ["euclidean", "jaccard"])
def test_plain_versions_contract_in_float64(metric):
    """The plain versions contract each 256-row block in float64: against
    an fp64 numpy oracle of the same f32 squared distances, at n = 700
    (three blocks), their f32 results are the oracle correctly rounded
    (within half an ulp), where a contraction of the same blocks in f32
    (the plain versions before they went to float64) is several ulps off."""
    from repro_torch.core import fstat
    n = 700
    x, grouping = _study(seed=5, n=n, d=24)
    xp = distance.ROW_METRICS[metric].prepare(
        torch.from_numpy(x)).contiguous()
    m2 = _masked_d2_f64(xp, metric)
    blocks = range(0, n, 256)
    v = torch.from_numpy(_basis(4, 6, seed=5, n=n))
    oracle = 0.5 * np.stack([(m2 @ vp * vp).sum(0)
                             for vp in v.double().numpy()])
    sc, _ = ref.fused_sw_cols_ref(xp, xp, v, v, 0, metric=metric)
    f32 = sum(fstat.sw_cols_contract(
        torch.from_numpy(m2[lo:lo + 256]).float(), v, v[:, lo:lo + 256])
        .double() for lo in blocks).numpy()
    assert _ulps(sc.numpy(), oracle) <= 0.5 + 1e-9
    assert _ulps(f32, oracle) >= 4.0

    g = torch.from_numpy(_perm_batch(grouping, 4))
    inv = permutations.inv_group_sizes(torch.from_numpy(grouping), G)
    e = fstat.onehot_perm_factors(g, inv, torch.float32)
    e64 = e.double().numpy()
    oracle_w = 0.5 * np.stack([(m2 @ ep * ep).sum() for ep in e64])
    sw, _ = ref.fused_sw_ref(xp, xp, g, g, inv, 0, metric=metric)
    f32_w = sum(fstat.sw_matmul_contract(
        torch.from_numpy(m2[lo:lo + 256]).float(), e, e[:, lo:lo + 256])
        .double() for lo in blocks).numpy()
    assert _ulps(sw.numpy(), oracle_w) <= 0.5 + 1e-9
    assert _ulps(f32_w, oracle_w) > _ulps(sw.numpy(), oracle_w)


@pytest.mark.parametrize("knob,value", [
    ("feat_bf16", 1), ("feat_fp8", 1), ("feat_packed", 1),
    ("feat_scale", 0.5)])
def test_cols_precision_knobs_raise_naming_their_slice(knob, value):
    """The dense-design sweeps turned a precision knob away until the
    precision slice (hence the name); now both kinds run it and agree
    (rtol 1e-5), and on jaccard's presence data every mode's values are
    the f32 ones, so each kind equals its own f32 run bit for bit."""
    _, (xp, g, _) = _operands("jaccard")
    des = design.build(grouping=g[0], covariates=xp[:, 0].double(),
                       device="cpu")
    assert des.mode == design.MODE_DENSE
    rows = distance.ROW_METRICS["jaccard"].rows
    kw = dict(kernel_metric="jaccard", row_block=8, chunk=2, seed=3)
    runs = {}
    for impl in ("cuda", "torch"):
        runs[impl] = streaming.fused_kernel_sw_design(
            xp, rows, des, 4, impl=impl, tuning={knob: value}, **kw)
        f32 = streaming.fused_kernel_sw_design(xp, rows, des, 4, impl=impl,
                                               **kw)
        assert torch.equal(runs[impl][0], f32[0])
        assert float(runs[impl][1]) == float(f32[1])
    torch.testing.assert_close(runs["cuda"][0], runs["torch"][0], rtol=1e-5,
                               atol=1e-9)


@pytest.mark.parametrize("case,exc", [
    ("unknown_metric", ValueError),
    ("basis_2d", ValueError),
    ("basis_rows", ValueError),
    ("basis_k", ValueError),
    ("basis_f64", TypeError),
    ("not_contiguous", ValueError),
    ("mixed_devices", ValueError),
    ("negative_offset", ValueError),
    ("n_valid_zero", ValueError),
])
def test_cols_wrapper_rejects(case, exc):
    _, (xp, _, _) = _operands("braycurtis")
    v = torch.from_numpy(_basis(3, 4))
    kw = dict(metric="braycurtis")
    vr, vc, off = v, v, 0
    if case == "unknown_metric":
        kw["metric"] = "cosine"
    elif case == "basis_2d":
        vr = v[0]
    elif case == "basis_rows":
        vr = v[:, :10].contiguous()
    elif case == "basis_k":
        vr = v[:, :, :2].contiguous()
    elif case == "basis_f64":
        vc = v.double()
    elif case == "not_contiguous":
        vc = v.transpose(0, 1).contiguous().transpose(0, 1)
    elif case == "mixed_devices":
        vc = v.to("meta")
    elif case == "negative_offset":
        off = -1
    elif case == "n_valid_zero":
        kw["n_valid"] = 0
    with pytest.raises(exc):
        ops.fused_sw_rows_cols(xp, xp, vr, vc, off, **kw)


def test_cols_partials_at_the_emp_design_chunk():
    """The design sweep's call (the whole table against itself) is
    symmetric: 38,809 work items (a strip of 2 column tiles at or past
    the diagonal, sum_{c < 197} (393 - 2c)) walked by COLS_SLOTS = 2,048
    slots, one running (P * K) partial row per slot and one f64 D2 total
    per slot: 80 KiB a permutation at K = 10, under a thirteenth of the
    (n, K) basis and index it gathers (1.06 MiB), and 16 KiB whatever the
    chunk and the n, where the earlier layout held one row per item and
    (197 + 393) x n row sums (244.6 MiB at the old chunk of 127). At the
    plan's EMP design chunk (166) partials, index and basis take 188.1 MiB
    of the 256 MiB budget."""
    n, chunk, k = 25145, 166, 10
    items = sum(393 - 2 * c for c in range(197))
    assert items == 38809
    assert ops.n_slots(n, n, True, "fused_sw_cols") == ops.COLS_SLOTS == 2048
    assert ops.cols_partial_shapes(n, n, chunk, k) == \
        ((2048, chunk * k), (2049,))
    assert ops.cols_workspace_bytes(n, n, chunk, k) == \
        4 * 2048 * chunk * k + 8 * 2049 + 4 * chunk * k
    assert 13 * 4 * 2048 * k < 4 * n * (k + 1)
    assert (ops.cols_workspace_bytes(n, n, chunk, k)
            + 4 * chunk * n * (k + 1)) / 2 ** 20 == pytest.approx(188.14,
                                                                 abs=0.01)
    assert ops.cols_partial_shapes(100, 70, 3, 2) == ((2 * 1, 6), (3,))
    assert ops.cols_partial_shapes(n, n, chunk, k, symmetric=False) == \
        ((2048, chunk * k), (2049,))
    assert ops.row_sum_shape(n, n, True, "fused_sw_cols") == (197 + 393, n)
    assert ops.row_sum_shape(100, 70, False, "fused_sw_cols") == (1, 100)
    assert len(_tile_blocks(n, n, True)) == items
    assert _tile_blocks(n, n, True)[:2] == [(0, 0, 0), (1, 1, 0)]
    assert _tile_blocks(n, n, True)[393] == (0, 2, 1)
    assert len(_tile_blocks(n, n, False)) == 393 * 197
    assert _tile_blocks(130, 70, False) == [(0, 0, 0), (1, 0, 0), (2, 0, 0)]


def _slot_items(slot, n_items, slots):
    """The work items slot `slot` of a launch walks, in its order (the
    kernels' `for (b = blockIdx.x; b < n_items; b += gridDim.x)`)."""
    return list(range(slot, n_items, slots))


def _tile_blocks(nr, n, symmetric, strip=ops.STRIP_TILES):
    """A fused kernel's work items in order (fused_sw.cu, tile_block),
    as (row tile, first column tile, row-sum row), for strips of `strip`
    column tiles (ops.STRIP_TILES for the dense-design kernel,
    ops.SW_STRIP_TILES for the labels kernel): a symmetric call takes the
    strips starting at the diagonal and every `strip` tiles after it,
    strip offset first; a slab call every (row tile, strip) with the row
    tile fastest."""
    t, s = ops.TILE, strip
    nti, ntj = -(-nr // t), -(-n // t)
    n_strips = -(-ntj // s)
    if not symmetric:
        return [(b % nti, (b // nti) * s, b // nti)
                for b in range(nti * n_strips)]
    return [(ti, ti + c * s, c) for c in range(n_strips)
            for ti in range(ntj - c * s)]


def _masked_d2_f32(xp, metric):
    """The plain version's masked f32 D^2 of the whole table, in float64."""
    return torch.cat([blk for _, _, blk in ref._masked_d2_blocks(
        xp, xp, 0, metric, xp.shape[0], dict(feat_bf16=0, feat_fp8=0,
                                             feat_packed=0,
                                             feat_scale=None))]).double()


def _symmetric_decomposition(xp, v, metric):
    """s_cols and row sums as the symmetric kernel assembles them, in
    float64 on the plain version's masked f32 D^2: its work items
    (_tile_blocks) visit only the column tiles j >= i, diagonal tiles
    at 1/2 and off-diagonal ones at 1, in passes of Q_PASS q, each into
    the running partial of the slot that walks it (_slot_items); each
    item's row sums go to its strip's row and its off-diagonal tiles'
    column sums to its row tile's row; the slots are summed at the end."""
    n, (p, _, k) = xp.shape[0], v.shape
    t = ops.TILE
    m2 = _masked_d2_f32(xp, metric)
    vq = v.double().permute(1, 0, 2).reshape(n, p * k)     # (n, Q)
    (n_slots, nq), _ = ops.cols_partial_shapes(n, n, p, k)
    rows, _ = ops.row_sum_shape(n, n, True, "fused_sw_cols")
    n_strips = rows - -(-n // t)
    blocks = _tile_blocks(n, n, True)
    slot_of = {b: s for s in range(n_slots)
               for b in _slot_items(s, len(blocks), n_slots)}
    assert sorted(slot_of) == list(range(len(blocks)))
    s_part = torch.zeros((n_slots, nq), dtype=torch.float64)
    rs_part = torch.zeros((rows, n), dtype=torch.float64)
    ntj = -(-n // t)
    for b, (ti, jt0, slot) in enumerate(blocks):
        r = slice(ti * t, min(ti * t + t, n))
        for jt in range(jt0, min(jt0 + ops.STRIP_TILES, ntj)):
            c = slice(jt * t, min(jt * t + t, n))
            tile = m2[r, c]
            wt = 0.5 if jt == ti else 1.0
            for q0 in range(0, nq, ops.Q_PASS):
                q = slice(q0, min(q0 + ops.Q_PASS, nq))
                s_part[slot_of[b], q] += ((wt * tile) @ vq[c, q]
                                          * vq[r, q]).sum(0)
            rs_part[slot, r] += tile.sum(1)
            if jt != ti:
                rs_part[n_strips + ti, c] += tile.sum(0)
    return s_part.sum(0).view(p, k), rs_part.sum(0)


@pytest.mark.parametrize("p,k", [(261, 1), (29, 3)])
def test_symmetric_decomposition_equals_the_plain_version(p, k):
    """The symmetric kernel's decomposition (upper tiles only, diagonal
    tiles at 1/2, column sums standing in for the mirrored rows' sums)
    gives the plain version's s_cols within 1e-6 s_T and its row sums at
    rtol 1e-6, at a ragged n (331: six 64-row tiles, three strips, the
    last tile 11 rows), K = 1, and P * K not a multiple of the 128-q
    pass."""
    x, _ = _study(seed=8, n=331, d=24)
    xp = distance.ROW_METRICS["braycurtis"].prepare(
        torch.from_numpy(x)).contiguous()
    v = torch.from_numpy(_basis(p, k, seed=8, n=331))
    sc, rs = _symmetric_decomposition(xp, v, "braycurtis")
    sc_p, rs_p = ref.fused_sw_cols_ref(xp, xp, v, v, 0, metric="braycurtis")
    s_t = float(rs_p.double().sum()) / 2.0 / 331
    assert float((sc - sc_p.double()).abs().max()) <= 1e-6 * s_t
    torch.testing.assert_close(rs, rs_p.double(), rtol=1e-6, atol=0)


def _labels_symmetric_decomposition(xp, g, inv, metric, strip):
    """s_W and row sums as the symmetric labels kernel assembles them, in
    float64 on the plain version's masked f32 D^2: its blocks
    (_tile_blocks, strips of `strip` column tiles) visit only the column
    tiles j >= i, diagonal tiles at 1/2 and off-diagonal ones at 1; each
    tile goes through passes of SW_PASS permutations, in which the
    same-group sums per (row, permutation) are weighted by w[g_r] once and
    added into the running s_W of the slot that walks the item (slots of
    the kernel's map, _slot_items, at the kernel's strips); each item's
    row sums go to its strip's row and its off-diagonal tiles' column sums
    to its row tile's row; the slots are summed at the end."""
    n, p = xp.shape[0], g.shape[0]
    t = ops.TILE
    m2 = _masked_d2_f32(xp, metric)
    w = inv.double()
    ntj = -(-n // t)
    n_strips = -(-ntj // strip)
    blocks = _tile_blocks(n, n, True, strip)
    n_slots = min(ops.SW_SLOTS, len(blocks))
    slot_of = {b: b % n_slots for b in range(len(blocks))}
    s_part = torch.zeros((n_slots, p), dtype=torch.float64)
    rs_part = torch.zeros((n_strips + ntj, n), dtype=torch.float64)
    if strip == ops.SW_STRIP_TILES:
        assert ops.partial_shapes(n, n, p) == ((n_slots, p), (n_slots + 1,))
        assert ops.row_sum_shape(n, n, True) == tuple(rs_part.shape)
        assert n_slots == ops.n_slots(n, n, True)
    for b, (ti, jt0, slot) in enumerate(blocks):
        r = slice(ti * t, min(ti * t + t, n))
        for jt in range(jt0, min(jt0 + strip, ntj)):
            c = slice(jt * t, min(jt * t + t, n))
            tile = m2[r, c] * (0.5 if jt == ti else 1.0)
            for p0 in range(0, p, ops.SW_PASS):
                q = slice(p0, min(p0 + ops.SW_PASS, p))
                gr, gc = g[q, r].long(), g[q, c].long()
                same = gr[:, :, None] == gc[:, None, :]
                acc = torch.where(same, tile[None], 0.0).sum(2)
                s_part[slot_of[b], q] += (acc * w[gr]).sum(1)
            rs_part[slot, r] += m2[r, c].sum(1)
            if jt != ti:
                rs_part[n_strips + ti, c] += m2[r, c].sum(0)
    return s_part.sum(0), rs_part.sum(0)


@pytest.mark.parametrize("strip", [ops.SW_STRIP_TILES, 2])
@pytest.mark.parametrize("p,g", [(261, 8), (29, 8), (261, 300), (29, 300)])
def test_labels_symmetric_decomposition_equals_the_plain_version(p, g,
                                                                 strip):
    """The symmetric labels kernel's decomposition (upper tiles only,
    diagonal tiles at 1/2, passes of 128 permutations with w[g_r] once a
    pass, column sums standing in for the mirrored rows' sums) gives the
    plain version's s_W within 1e-6 relative and its row sums at rtol
    1e-6, at a ragged n (331: six 64-row tiles, the last 11 rows), P
    across (261) and inside (29) a 128-permutation pass, G = 8 and 300,
    with the kernel's strips (one strip a row tile at this n) and strips
    of 2 tiles (three strip offsets)."""
    x, grouping = _study(seed=10, n=331, d=24, g=g)
    xp = distance.ROW_METRICS["braycurtis"].prepare(
        torch.from_numpy(x)).contiguous()
    labels = torch.from_numpy(_perm_batch(grouping, p, seed=10))
    inv = permutations.inv_group_sizes(torch.from_numpy(grouping), g)
    sw, rs = _labels_symmetric_decomposition(xp, labels, inv, "braycurtis",
                                             strip)
    sw_p, rs_p = ref.fused_sw_ref(xp, xp, labels, labels, inv, 0,
                                  metric="braycurtis")
    assert float(((sw - sw_p.double()).abs() / sw_p.double()).max()) <= 1e-6
    torch.testing.assert_close(rs, rs_p.double(), rtol=1e-6, atol=0)


def test_three_tf32_products_reproduce_the_cols_forms_and_one_does_not():
    """The cols kernel's product on the tensor cores: neither D^2 nor the
    basis is 0/1, so both are split, hi = tf32(x) and lo = tf32(x - hi),
    and hi.hi + hi.lo + lo.hi (exact products summed in float64) gives the
    float64 per-column forms within 1e-6 s_T, the bar the kernel is held
    to, at a small ragged shape; one TF32 product misses it."""
    n = 203
    x, _ = _study(seed=9, n=n, d=24)
    xp = distance.ROW_METRICS["euclidean"].prepare(
        torch.from_numpy(x)).contiguous()
    m2 = torch.from_numpy(_masked_d2_f64(xp, "euclidean"))
    v = torch.from_numpy(_basis(5, 7, seed=9, n=n))
    s_t = float(m2.sum()) / 2.0 / n
    oracle = 0.5 * torch.stack([(m2 @ vp * vp).sum(0)
                                for vp in v.double()])
    a = m2.float()
    a_hi = ref_sw.tf32_round(a)
    a_lo = ref_sw.tf32_round(a - a_hi)

    def forms(products):
        out = []
        for vp in v:
            b_hi = ref_sw.tf32_round(vp)
            b_lo = ref_sw.tf32_round(vp - b_hi)
            y = a_hi.double() @ b_hi.double()
            if products == 3:
                y = y + a_hi.double() @ b_lo.double() \
                    + a_lo.double() @ b_hi.double()
            out.append(0.5 * (y * vp.double()).sum(0))
        return torch.stack(out)

    three, one = forms(3), forms(1)
    assert float((three - oracle).abs().max()) <= 1e-6 * s_t
    assert float((one - oracle).abs().max()) > 1e-6 * s_t


# ---------------------------------------------------------------------------
# The single-pass sweeps (pipeline.streaming).
# ---------------------------------------------------------------------------

def _sweep_inputs(metric="braycurtis", n_total=101, seed=4):
    x, grouping = _study(seed=seed)
    key = jax.random.key(7)
    perms = np.asarray(jperm.permutation_batch(key, jnp.asarray(grouping),
                                               0, n_total))
    xp = distance.ROW_METRICS[metric].prepare(torch.from_numpy(x))
    g = torch.from_numpy(grouping)
    inv = permutations.inv_group_sizes(g, G)
    return x, grouping, key, perms, xp, g, inv


@functools.lru_cache(maxsize=None)
def _reference_sweep():
    x, grouping, key, *_ = _sweep_inputs()
    mdef = jdist.ROW_METRICS["braycurtis"]
    xp = mdef.prepare(jnp.asarray(x))
    inv = jperm.inv_group_sizes(jnp.asarray(grouping), G)
    sw, s_t, _ = jstreaming.fused_sw(xp, mdef.rows, jnp.asarray(grouping),
                                     inv, key, 101, row_block=13, chunk=17)
    return np.asarray(sw), float(s_t)


@pytest.mark.parametrize("impl", ["cuda", "torch", "fused"])
def test_sweeps_match_the_reference_fused_bridge(impl):
    """fused_kernel_sw (both kinds) and fused_sw against the reference's
    fused bridge on the reference's own labels (101 permutation slots in
    chunks of 17, row blocks of 13)."""
    _, _, _, perms, xp, g, inv = _sweep_inputs()
    rows = distance.ROW_METRICS["braycurtis"].rows
    kw = dict(row_block=13, chunk=17, perms=torch.from_numpy(perms.copy()))
    if impl == "fused":
        sw, s_t, stats = streaming.fused_sw(xp, rows, g, inv, 101, **kw)
        assert (stats.n_row_blocks, stats.n_chunks) == (5, 6)
    else:
        sw, s_t, stats = streaming.fused_kernel_sw(
            xp, rows, g, inv, 101, impl=impl, kernel_metric="braycurtis",
            tuning={"feat_bf16": 0, "feat_fp8": 0}, **kw)
        assert (stats.impl, stats.n_chunks) == (impl, 6)
        assert stats.row_block == (ops.TILE if impl == "cuda" else 13)
    ref_sw, ref_st = _reference_sweep()
    assert sw.dtype == s_t.dtype == torch.float64 and s_t.dim() == 0
    np.testing.assert_allclose(sw.numpy(), ref_sw, rtol=1e-4)
    assert float(s_t) == pytest.approx(ref_st, rel=1e-5)


@pytest.mark.parametrize("impl", ["cuda", "torch"])
def test_sweeps_are_chunk_invariant(impl):
    _, _, _, perms, xp, g, inv = _sweep_inputs(n_total=40)
    rows = distance.ROW_METRICS["braycurtis"].rows
    p = torch.from_numpy(perms.copy())
    runs = [streaming.fused_kernel_sw(
        xp, rows, g, inv, 40, impl=impl, kernel_metric="braycurtis",
        row_block=16, chunk=c, perms=p) for c in (40, 7)]
    torch.testing.assert_close(runs[1][0], runs[0][0], rtol=1e-6, atol=0)
    assert float(runs[1][1]) == float(runs[0][1])
    assert (runs[0][2].n_chunks, runs[1][2].n_chunks) == (1, 6)


@pytest.mark.parametrize("form", ["labels", "strata", "design"])
def test_megakernel_sweeps_are_chunk_invariant_bit_for_bit(form):
    """Through the megakernel sweeps (their plain versions here, the
    kernels and the slot sum on the card), s_W or s_cols and s_T are the
    same bits at two chunkings (one chunk of 40, six of 7): each
    permutation's statistic and the D2 total never depend on the chunk."""
    _, grouping, _, _, xp, g, inv = _sweep_inputs(n_total=40)
    rng = np.random.default_rng(11)
    strata = rng.integers(0, 3, N).astype(np.int32)
    des = design.build(grouping=grouping, covariates={
        "a": rng.normal(size=N)}, strata=strata, n_groups=G, device="cpu")
    runs = []
    for chunk in (40, 7):
        if form == "design":
            runs.append(streaming.fused_sw_megakernel_design(
                xp, des, 40, kernel_metric="braycurtis", chunk=chunk,
                seed=3))
        else:
            runs.append(streaming.fused_sw_megakernel(
                xp, g, inv, 40, kernel_metric="braycurtis", chunk=chunk,
                seed=3, strata=(torch.from_numpy(strata)
                                if form == "strata" else None)))
    assert torch.equal(runs[0][0], runs[1][0])
    assert float(runs[0][1]) == float(runs[1][1])
    assert (runs[0][2].n_chunks, runs[1][2].n_chunks) == (1, 6)


@pytest.mark.parametrize("mode", ["f32", "fp8", "packed"])
@pytest.mark.parametrize("form", ["labels", "design"])
def test_megakernel_sweeps_quantize_the_table_once(monkeypatch, mode, form):
    """A megakernel sweep quantizes the feature table once (its
    quantization and transients are not paid a launch) and hands every
    launch the same quantized pair, the pair quantize_slabs gives for the
    table at the sweep's precision; the statistic is the one without."""
    metric = "jaccard" if mode == "packed" else "braycurtis"
    _, grouping, _, _, xp, g, inv = _sweep_inputs(metric, n_total=30)
    knobs = {"f32": {}, "fp8": {"feat_fp8": 1},
             "packed": {"feat_packed": 1}}[mode]
    des = design.build(grouping=grouping, covariates={
        "a": np.random.default_rng(2).normal(size=N)}, n_groups=G,
        device="cpu")
    quantize, rows, cols = ops.quantize_slabs, ops.fused_sw_rows, \
        ops.fused_sw_rows_cols
    seen = {"quantize": 0, "pairs": []}

    def spy_q(*a, **k):
        seen["quantize"] += 1
        return quantize(*a, **k)

    def spy_launch(fn):
        def launch(*a, quantized=None, **k):
            seen["pairs"].append(quantized)
            return fn(*a, quantized=quantized, **k)
        return launch
    monkeypatch.setattr(ops, "quantize_slabs", spy_q)
    monkeypatch.setattr(ops, "fused_sw_rows", spy_launch(rows))
    monkeypatch.setattr(ops, "fused_sw_rows_cols", spy_launch(cols))

    def sweep():
        if form == "design":
            return streaming.fused_sw_megakernel_design(
                xp, des, 30, kernel_metric=metric, chunk=7, seed=3,
                tuning=knobs)
        return streaming.fused_sw_megakernel(
            xp, g, inv, 30, kernel_metric=metric, chunk=7, seed=3,
            tuning=knobs)
    got = sweep()
    assert seen["quantize"] == 1 and len(seen["pairs"]) == 5
    first = seen["pairs"][0]
    assert all(p is first for p in seen["pairs"])
    scale = (ref.resolve_precision(xp, metric, **knobs)[1]
             if mode == "fp8" else None)
    want = quantize(xp, xp, mode, scale)
    assert all(torch.equal(a, b) for a, b in zip(first, want))
    monkeypatch.undo()
    again = sweep()
    assert torch.equal(got[0], again[0]) and float(got[1]) == float(again[1])


def test_megakernel_sweep_labels_from_seed_match_explicit_labels():
    _, _, _, _, xp, g, inv = _sweep_inputs()
    labels = permutations.permutation_batch(g, 0, 30, seed=5)
    a = streaming.fused_sw_megakernel(xp, g, inv, 30,
                                      kernel_metric="braycurtis", chunk=8,
                                      seed=5)
    b = streaming.fused_sw_megakernel(xp, g, inv, 30,
                                      kernel_metric="braycurtis", chunk=8,
                                      perms=labels)
    assert torch.equal(a[0], b[0]) and float(a[1]) == float(b[1])


def test_sweeps_reject_what_they_cannot_run():
    _, _, _, _, xp, g, inv = _sweep_inputs()
    rows = distance.ROW_METRICS["braycurtis"].rows
    kw = dict(kernel_metric="braycurtis", row_block=13, chunk=17)
    with pytest.raises(ValueError, match="fused-kernel impl"):
        streaming.fused_kernel_sw(xp, rows, g, inv, 10, impl="pallas", **kw)
    with pytest.raises(ValueError, match="jaccard"):
        streaming.fused_kernel_sw(xp, rows, g, inv, 10, impl="torch",
                                  tuning={"feat_packed": 1}, **kw)
    with pytest.raises(ValueError, match="perms must be"):
        streaming.fused_kernel_sw(xp, rows, g, inv, 10, impl="cuda",
                                  perms=torch.zeros((3, N), dtype=torch.int32),
                                  **kw)


# ---------------------------------------------------------------------------
# Build and binding (the compile itself happens on the card's machine).
# ---------------------------------------------------------------------------

def test_build_command_names_sm90a_and_the_source():
    cmd = _build.nvcc_command("nvcc", ops.SOURCE,
                              _build.library_path(ops.SOURCE))
    assert "arch=compute_90a,code=sm_90a" in cmd
    assert cmd[-1].endswith(os.path.join("fused_sw", "csrc", "fused_sw.cu"))
    assert not any("fast_math" in c or "fast-math" in c for c in cmd)
    assert _build.library_path(ops.SOURCE).name.startswith("fused_sw-")


def test_ctypes_signature_matches_source():
    import ctypes
    src = ops.SOURCE.read_text()
    for name, (argtypes, restype) in ops.SIGNATURES.items():
        m = re.search(rf"\b(int|void) {name}\(([^)]*)\)\s*\{{", src)
        params = [p.strip() for p in m.group(2).split(",")]
        assert len(params) == len(argtypes), name
        assert (restype is None) == (m.group(1) == "void"), name
        for p, t in zip(params, argtypes):
            if "*" in p:
                assert t is ctypes.c_void_p, p
            elif p.startswith("long long"):
                assert t is ctypes.c_longlong, p
            else:
                assert p.startswith("int ") and t is ctypes.c_int, p


def test_source_names_what_it_replaces_and_its_constants():
    src = ops.SOURCE.read_text()
    assert "src/repro/kernels/fused_sw/kernel.py:193" in src
    assert "src/repro/kernels/fused_sw/kernel.py:338" in src
    assert f"constexpr int kTile = {ops.TILE};" in src
    assert f"constexpr int kStripTiles = {ops.STRIP_TILES};" in src
    # the labels kernel: strips of SW_STRIP_TILES tiles, the symmetric
    # visit, passes of SW_PASS permutations on brute's compare-and-add,
    # one running s_W partial per (slot, permutation) over the slot's
    # work items, and the slots summed in a fixed order by a second kernel
    assert f"constexpr int kSwStripTiles = {ops.SW_STRIP_TILES};" in src
    assert f"constexpr int kSwPass = {ops.SW_PASS};" in src
    assert f"constexpr int kSwSlots = {ops.SW_SLOTS};" in src
    assert f"constexpr int kColsSlots = {ops.COLS_SLOTS};" in src
    for needle in ("for (int64_t b = blockIdx.x; b < n_items; "
                   "b += gridDim.x) {",
                   "tile_block<kSwStripTiles>(b, nti, ntj, sym)",
                   "const float wt = mirrored ? 1.f : 0.5f;",
                   "if (g == gc[k].x) acc[r][k] += m.x;",
                   "v = fmaf(acc[r][k], row_weight(gr[r][k], inv_gs, "
                   "n_groups), v);",
                   "out[p] += v;",
                   "rs_part[(n_strips + blk.ti) * n + j] = cs_sum;",
                   "n_slots<kSwStripTiles, kSwSlots>(",
                   "for (int64_t k = warp; k < slots; k += kSumWarps) "
                   "s += part[k * nq + q];",
                   "kSwSmemBytes);"):
        assert needle in src, needle
    # the dense-design kernel: the symmetric visit of the tiles j >= i,
    # the product in 3xTF32 on the tensor cores (wgmma, both operands split
    # hi / lo) through a cp.async ring in dynamic shared memory raised past
    # 48 KB, and the block order _tile_blocks models
    assert f"constexpr int kQPass = {ops.Q_PASS};" in src
    for needle in ("constexpr int kKc = 16;",
                   "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32",
                   "cvt.rna.tf32.f32", "fence.proxy.async.shared::cta",
                   "wgmma_tf32(dd, ah[f], bh, f > 0);",
                   "wgmma_tf32(dd, ah[f], bl, 1);",
                   "wgmma_tf32(dd, al[f], bh, 1);",
                   "const float wt = sym && jt != blk.ti ? 1.f : 0.5f;",
                   "rs_part[(n_strips + blk.ti) * n + j] = s;",
                   "tile_block<kStripTiles>(b, nti, ntj, sym)",
                   "n_slots<kStripTiles, kColsSlots>(",
                   "out[q] = prev[h] + s;",
                   "cp.async.ca.shared.global",
                   "cudaFuncAttributeMaxDynamicSharedMemorySize",
                   "return {b, b + c * S, c};",
                   "if (!sym) return {b % nti, (b / nti) * S, b / nti};"):
        assert needle in src, needle
    functors = {"braycurtis": "BrayCurtis", "euclidean": "Euclidean",
                "jaccard": "Jaccard"}
    for metric, kind in ops._KIND.items():     # the wrapper's C switches
        assert f"case {kind}:\n      return launch<{functors[metric]}, L>" \
            in src
        assert f"case {kind}:\n      return launch_cols<{functors[metric]}, " \
            "L>" in src
    loaders = {"f32": "F32In", "bf16": "Bf16In", "fp8": "Fp8In"}
    for mode, i in ops._MODE.items():
        if mode == "packed":
            assert f"case {i}:\n      if (kind != 2)" in src
            assert "return launch<PackedJaccard, PackedIn>(" in src
            assert "return launch_cols<PackedJaccard, PackedIn>(" in src
        else:
            assert f"return launch_kind<{loaders[mode]}>(" in src
            assert f"return launch_cols_kind<{loaders[mode]}>(" in src
    assert "cublas" not in src.lower() and "cudnn" not in src.lower()
    assert "atomicAdd" not in src and "fast_math" not in src.replace(
        "--use_fast_math", "")


def test_importing_the_port_builds_nothing():
    """Every module imports without nvcc and without building: the
    library is built at the first launch on the card."""
    code = ("import repro_torch.pipeline, repro_torch.launch.permanova, "
            "repro_torch.kernels.fused_sw.ops as f\n"
            "print(f._lib is None)\n")
    env = dict(os.environ,
               PYTHONPATH=os.path.join(os.path.dirname(
                   os.path.dirname(os.path.abspath(__file__))), "src"),
               PATH="/nonexistent", CUDA_HOME="/nonexistent")
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120,
                         check=True).stdout
    assert out.strip() == "True"
