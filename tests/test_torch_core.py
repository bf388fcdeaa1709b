"""The port's core modules against the reference: synthetic data, the four
distance metrics, the permutation source, the s_W forms and permanova();
plus hw, compat and the import boundary of the port."""

import os
import re
import subprocess
import sys
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

from repro.core import distance as jdist  # noqa: E402
from repro.core import fstat as jfstat  # noqa: E402
from repro.core import permutations as jperm  # noqa: E402
from repro.core.permanova import (f_from_sw as j_f_from_sw,  # noqa: E402
                                  p_value_from_null as j_p_value,
                                  permanova as jpermanova,
                                  s_total as j_s_total)
from repro.data import microbiome as jmicro  # noqa: E402
from repro_torch import hw  # noqa: E402
from repro_torch.compat import from_reference  # noqa: E402
from repro_torch.core import distance, fstat, permutations  # noqa: E402
from repro_torch.core.permanova import (  # noqa: E402
    f_from_sw, p_value_from_null, permanova, s_total)
from repro_torch.data import microbiome  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(REPO, "src")


@pytest.mark.parametrize("args", [(48, 32, 3, 0.0, 7), (61, 20, 4, 1.0, 2),
                                  (30, 16, 8, 0.5, 0)])
def test_synthetic_study_same_draws(args):
    n, d, g, effect, seed = args
    x_t, g_t = microbiome.synthetic_study(n, d, g, effect_size=effect,
                                          seed=seed)
    x_j, g_j = jmicro.synthetic_study(n, d, g, effect_size=effect, seed=seed)
    np.testing.assert_array_equal(x_t, x_j)
    np.testing.assert_array_equal(g_t, g_j)


# ---------------------------------------------------------------------------
# Distances.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("metric", sorted(distance.METRICS))
@pytest.mark.parametrize("n", [37, 64])
def test_distance_matrix_matches_reference(metric, n):
    x, _ = jmicro.synthetic_study(n, 24, 3, effect_size=0.5, seed=n)
    got = distance.distance_matrix(torch.from_numpy(x), metric)
    want = np.asarray(jdist.distance_matrix(jnp.asarray(x), metric))
    assert got.dtype == torch.float32 and got.shape == (n, n)
    # rtol 1e-5 for f32 distances; atol only for entries that are 0 in
    # both (the diagonal) or cancel in the Gram trick
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    assert distance.validate_distance_matrix(got)["ok"]


@pytest.mark.parametrize("metric", ["braycurtis", "jaccard"])
def test_blocked_rows_ragged_block(metric):
    x, _ = jmicro.synthetic_study(50, 16, 3, seed=1)
    full = distance.distance_matrix(torch.from_numpy(x), metric, block=50)
    ragged = distance.distance_matrix(torch.from_numpy(x), metric, block=16)
    torch.testing.assert_close(ragged, full, rtol=0, atol=0)


def test_validate_distance_matrix_matches_reference():
    rng = np.random.default_rng(0)
    d = rng.random((20, 20)).astype(np.float32)
    d[3, 5] += 0.5                      # asymmetric, nonzero diagonal
    d[0, 0] = 0.25
    got = distance.validate_distance_matrix(torch.from_numpy(d))
    want = jdist.validate_distance_matrix(jnp.asarray(d))
    assert got["ok"] == want["ok"] is False
    for k in ("symmetric_maxerr", "diag_maxabs", "min_value"):
        assert got[k] == pytest.approx(want[k], rel=1e-6)


@pytest.mark.parametrize("name", ["euclidean_rows", "braycurtis_rows",
                                  "jaccard_rows"])
def test_row_primitives_match_reference(name):
    x, _ = jmicro.synthetic_study(40, 24, 3, seed=9)
    xp = distance.ROW_METRICS[name.split("_")[0]].prepare(x)
    jxp = jdist.ROW_METRICS[name.split("_")[0]].prepare(jnp.asarray(x))
    got = getattr(distance, name)(xp[:7], xp)
    want = np.asarray(getattr(jdist, name)(jxp[:7], jxp))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# Permutation source.
# ---------------------------------------------------------------------------

_M32 = 0xFFFFFFFF


def _py_mix32(x):
    x ^= x >> 16
    x = (x * 0x7FEB352D) & _M32
    x ^= x >> 15
    x = (x * 0x846CA68B) & _M32
    return x ^ (x >> 16)


def _py_key(seed, p, i):
    """The generator's key in plain Python integers (unbounded, so no
    overflow or sign to get wrong)."""
    s = (seed & _M32) ^ ((seed >> 32) & _M32)
    halves = []
    for salt in permutations._SALTS:
        row = _py_mix32(_py_mix32(s ^ salt) ^ (p & _M32))
        halves.append(_py_mix32(row ^ _py_mix32(i ^ salt)))
    return ((halves[0] >> 1) << 32) | halves[1]


@pytest.mark.parametrize("seed", [0, 7, 2 ** 40 + 5])
def test_keys_match_integer_reference(seed):
    idx = torch.tensor([0, 1, 999, 2 ** 31 + 7], dtype=torch.int64)
    keys = permutations.permutation_keys(seed, idx, 13)
    want = [[_py_key(seed, int(p), i) for i in range(13)] for p in idx]
    assert keys.dtype == torch.int64
    assert keys.tolist() == want
    assert int(keys.min()) >= 0


def _grouping(n=57, g=4, seed=0):
    rng = np.random.default_rng(seed)
    grouping = rng.integers(0, g, size=n).astype(np.int32)
    grouping[:g] = np.arange(g)
    return torch.from_numpy(grouping)


def test_permutation_batch_properties():
    grouping = _grouping()
    labels = permutations.permutation_batch(grouping, 0, 64, seed=3)
    assert labels.dtype == torch.int32 and labels.shape == (64, 57)
    torch.testing.assert_close(labels[0], grouping, rtol=0, atol=0)
    want = torch.bincount(grouping.long(), minlength=4)
    for row in labels:
        torch.testing.assert_close(torch.bincount(row.long(), minlength=4),
                                   want, rtol=0, atol=0)
    # rows are distinct draws, not copies of the identity
    assert len({tuple(r.tolist()) for r in labels}) == 64


@pytest.mark.parametrize("cuts", [(0, 37, 100), (0, 1, 2, 50, 100),
                                  (0, 64, 100)])
def test_permutation_batch_chunk_invariant(cuts):
    grouping = _grouping()
    full = permutations.permutation_batch(grouping, 0, 100, seed=11)
    parts = [permutations.permutation_batch(grouping, lo, hi, seed=11)
             for lo, hi in zip(cuts[:-1], cuts[1:])]
    torch.testing.assert_close(torch.cat(parts), full, rtol=0, atol=0)


def test_permutation_batch_seed_and_identity():
    grouping = _grouping()
    a = permutations.permutation_batch(grouping, 0, 8, seed=1)
    b = permutations.permutation_batch(grouping, 0, 8, seed=2)
    assert not torch.equal(a[1:], b[1:])
    torch.testing.assert_close(a[0], b[0], rtol=0, atol=0)   # identity
    torch.testing.assert_close(
        a, permutations.permutation_batch(grouping, 0, 8, seed=1),
        rtol=0, atol=0)
    # only global index 0 is the identity: a chunk starting later is not
    later = permutations.permutation_batch(grouping, 1, 8, seed=1)
    torch.testing.assert_close(later, a[1:], rtol=0, atol=0)
    assert not torch.equal(later[0], grouping)


def test_permutation_batch_is_uniform_enough():
    """Each sample lands on each position about equally often (a coarse
    check that the keys carry no structure the argsort would keep)."""
    n, p = 16, 4000
    ident = torch.arange(n, dtype=torch.int32)
    labels = permutations.permutation_batch(ident, 1, p + 1, seed=0)
    pos = torch.arange(n)[None, :].expand(p, n)
    counts = torch.zeros((n, n)).index_put_(
        (labels.long().flatten(), pos.flatten()), torch.ones(p * n),
        accumulate=True)
    expected = p / n
    chi2 = float(((counts - expected) ** 2 / expected).sum())
    assert chi2 < 2 * (n - 1) ** 2      # dof (n-1)^2 = 225, mean 225


def _whole_chunk_draws(grouping, strata, lo, hi, seed):
    """The draws of [lo, hi) made in one piece, as the generator made them
    before it drew in sub-blocks: (labels, strata index perms, strata
    labels)."""
    n = grouping.shape[0]
    idx = torch.arange(lo, hi, dtype=torch.int64)
    order = torch.argsort(permutations.permutation_keys(seed, idx, n),
                          dim=1, stable=True)
    labels = grouping.to(torch.int32)[order]
    s = strata.to(torch.int64)
    a = torch.gather(order, 1, torch.argsort(s[order], dim=1, stable=True))
    perms = torch.empty_like(a)
    perms[:, torch.argsort(s, stable=True)] = a
    perms = perms.to(torch.int32)
    if lo == 0:
        labels[0] = grouping
        perms[0] = torch.arange(n, dtype=torch.int32)
    return labels, perms, grouping.to(torch.int32)[perms.long()]


@pytest.mark.parametrize("lo,hi", [(0, 23), (5, 40)])
@pytest.mark.parametrize("block_rows", [1, 3, "chunk", None])
def test_draws_are_bit_identical_for_every_sub_block(block_rows, lo, hi):
    """permutation_batch, strata_permutation_batch and strata_label_batch
    give the same rows, bit for bit, whatever rows a sub-block holds (1, 3,
    the whole chunk, or None: the range in one piece), and the rows of the
    draw made in one piece."""
    grouping = _grouping()
    strata = torch.from_numpy(
        np.random.default_rng(2).integers(0, 3, size=57).astype(np.int32))
    rows = hi - lo if block_rows == "chunk" else block_rows
    want = _whole_chunk_draws(grouping, strata, lo, hi, seed=13)
    got = (permutations.permutation_batch(grouping, lo, hi, seed=13,
                                          block_rows=rows),
           permutations.strata_permutation_batch(strata, lo, hi, seed=13,
                                                 block_rows=rows),
           permutations.strata_label_batch(grouping, strata, lo, hi,
                                           seed=13, block_rows=rows))
    for g, w in zip(got, want):
        assert g.dtype == torch.int32 and g.shape == (hi - lo, 57)
        assert torch.equal(g, w)


def test_draw_sub_block_fits_the_planners_label_budget():
    """At the EMP shape (n = 25,145) the sub-block the planner's label
    budget gives keeps the draws' modelled transients (65 B an element and
    1 MiB of allocator excess for each of the 9 int64 arrays) within that
    budget, while the whole chunk the same budget sizes (4 n + 8 bytes a
    permutation) would not; a smaller budget gives a smaller sub-block."""
    from repro_torch.engine import planner
    n = 25145
    budget = planner.DEFAULT_STREAM_BUDGET_BYTES
    rows = permutations.draw_rows(n, budget)
    assert rows == 158
    assert permutations.draw_transient_bytes(rows, n) <= budget
    assert permutations.draw_transient_bytes(rows + 1, n) > budget
    chunk = planner.chunk_for_budget(n, 4000, budget)
    assert chunk == 2668
    assert permutations.draw_transient_bytes(chunk, n) > 10 * budget
    assert permutations.draw_rows(n, budget / 4) == 35 < rows // 4
    assert permutations.draw_rows(n, 1.0) == 1
    with pytest.raises(ValueError, match="block_rows"):
        permutations.permutation_batch(_grouping(), 0, 4, block_rows=0)


def test_scheduler_draws_in_budget_sized_sub_blocks(monkeypatch):
    """The engine's label sweep hands the draw the sub-block its label
    budget gives (the planner's default when none is given), and the
    result is the same for any budget."""
    from repro_torch.engine import planner, scheduler
    seen = []
    orig = permutations.permutation_batch

    def spy(grouping, lo, hi, *, seed=0, block_rows=None):
        seen.append(block_rows)
        return orig(grouping, lo, hi, seed=seed, block_rows=block_rows)

    monkeypatch.setattr(permutations, "permutation_batch", spy)
    grouping = _grouping()
    budget = 65 * 57 * 5          # five rows of transients
    a = scheduler._labels(grouping, 0, 30, seed=4, perms=None,
                          draw_budget=budget)
    b = scheduler._labels(grouping, 0, 30, seed=4, perms=None)
    assert seen == [5, permutations.draw_rows(
        57, planner.DEFAULT_STREAM_BUDGET_BYTES)]
    assert torch.equal(a, b)


@pytest.mark.parametrize("kind,per_element", [
    ("labels", 65), ("strata", 84), ("index", 80)])
def test_draw_model_is_by_kind_of_draw(kind, per_element):
    """Each kind of draw has its own bytes an element (the strata label
    draw holds two argsorts, its index rows and their gather; the index
    draw the two argsorts and a scatter) and 1 MiB of allocator excess
    for each int64 array of more than 1 MiB: the sub-block rows a budget
    gives follow them, so a strata or index draw takes fewer rows than a
    free one in the same budget, and its model stays within it. Arrays
    of at most 1 MiB carry no excess."""
    n, budget = 25145, 256 * 2 ** 20
    assert permutations.DRAW_BYTES_PER_ELEMENT[kind] == per_element
    arrays = -(-per_element // 8)
    rows = permutations.draw_rows(n, budget, kind)
    assert rows == (budget - arrays * 2 ** 20) // (per_element * n)
    assert permutations.draw_transient_bytes(5, n, kind) == \
        per_element * 5 * n               # 5 rows: arrays under 1 MiB
    assert permutations.draw_transient_bytes(6, n, kind) == \
        per_element * 6 * n + arrays * 2 ** 20
    assert permutations.draw_transient_bytes(rows, n, kind) <= budget
    assert permutations.draw_transient_bytes(rows + 1, n, kind) > budget
    assert permutations.draw_rows(n, budget) == \
        permutations.draw_rows(n, budget, "labels")
    assert rows <= permutations.draw_rows(n, budget)


def test_scheduler_draws_each_kind_in_its_own_sub_blocks(monkeypatch):
    """The engine's label sweep sizes a strata label draw's sub-blocks by
    the strata model and an index draw's by the index model; the values
    do not depend on the sub-block size."""
    from repro_torch.engine import scheduler
    seen = []
    orig_s = permutations.strata_label_batch
    orig_i = permutations.strata_permutation_batch

    def spy_s(grouping, strata, lo, hi, *, seed=0, block_rows=None):
        seen.append(("strata", block_rows))
        return orig_s(grouping, strata, lo, hi, seed=seed,
                      block_rows=block_rows)

    def spy_i(strata, lo, hi, *, seed=0, block_rows=None):
        seen.append(("index", block_rows))
        return orig_i(strata, lo, hi, seed=seed, block_rows=block_rows)

    monkeypatch.setattr(permutations, "strata_label_batch", spy_s)
    monkeypatch.setattr(permutations, "strata_permutation_batch", spy_i)
    grouping = _grouping()
    strata = (torch.arange(57) % 3).to(torch.int32)
    budget = 84 * 57 * 5 + 1           # five rows of strata transients
    a = scheduler._labels(grouping, 0, 30, seed=4, perms=None,
                          strata=strata, draw_budget=budget)
    b = scheduler._index_perms(strata, 0, 30, seed=4, index_perms=None,
                               draw_budget=budget)
    assert seen[0] == ("strata", 5) and seen[-1] == ("index", 5)
    monkeypatch.undo()
    assert torch.equal(a, permutations.strata_label_batch(
        grouping, strata, 0, 30, seed=4))
    assert torch.equal(b, permutations.strata_permutation_batch(
        strata, 0, 30, seed=4))


def test_group_sizes_match_reference():
    grouping = _grouping(40, 5, seed=2)
    np.testing.assert_array_equal(
        permutations.group_sizes(grouping, 6).numpy(),
        np.asarray(jperm.group_sizes(jnp.asarray(grouping.numpy()), 6)))


# ---------------------------------------------------------------------------
# s_W forms, one permutation at a time, against the reference's.
# ---------------------------------------------------------------------------

def _sw_instance(n, g, seed):
    rng = np.random.default_rng(seed)
    d = rng.random((n, n)).astype(np.float32)
    d = (d + d.T) / 2
    np.fill_diagonal(d, 0.0)
    grouping = rng.integers(0, g, size=n).astype(np.int32)
    grouping[:g] = np.arange(g)
    inv_gs = np.array(jperm.inv_group_sizes(jnp.asarray(grouping), g))
    gperms = np.stack([rng.permutation(grouping) for _ in range(6)])
    return d * d, grouping, inv_gs, gperms


@pytest.mark.parametrize("n,g", [(37, 4), (64, 3), (9, 8)])
@pytest.mark.parametrize("form", ["sw_brute_one", "sw_tiled_one"])
def test_single_perm_forms_match_reference(form, n, g):
    mat2, grouping, inv_gs, _ = _sw_instance(n, g, seed=n)
    kw = {"tile": 16} if form == "sw_tiled_one" else {}
    got = getattr(fstat, form)(torch.from_numpy(mat2),
                               torch.from_numpy(grouping),
                               torch.from_numpy(inv_gs), **kw)
    want = getattr(jfstat, form)(jnp.asarray(mat2), jnp.asarray(grouping),
                                 jnp.asarray(inv_gs), **kw)
    np.testing.assert_allclose(float(got), float(want), rtol=5e-5)


@pytest.mark.parametrize("n,g,n_pad", [(37, 4, 37), (64, 3, 64),
                                       (9, 8, 9), (23, 3, 32)])
def test_sw_full_one_matches_reference_and_brute(n, g, n_pad):
    """The full-matrix form against the reference's and the port's
    upper-triangle brute form, also on a study zero-padded to n_pad whose
    pad rows carry the sentinel label G (weight 0)."""
    mat2, grouping, inv_gs, gperms = _sw_instance(n, g, seed=n + 1)
    m = np.zeros((n_pad, n_pad), np.float32)
    m[:n, :n] = mat2
    for labels in [grouping, *gperms[:2]]:
        lab = np.full((n_pad,), g, np.int32)
        lab[:n] = labels
        got = fstat.sw_full_one(torch.from_numpy(m), torch.from_numpy(lab),
                                torch.from_numpy(inv_gs))
        want = jfstat.sw_full_one(jnp.asarray(m), jnp.asarray(lab),
                                  jnp.asarray(inv_gs))
        brute = fstat.sw_brute_one(torch.from_numpy(mat2),
                                   torch.from_numpy(labels),
                                   torch.from_numpy(inv_gs))
        np.testing.assert_allclose(float(got), float(want), rtol=1e-4)
        np.testing.assert_allclose(float(got), float(brute), rtol=1e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_onehot_factors_and_matmul_block_match_reference(dtype):
    mat2, _, inv_gs, gperms = _sw_instance(40, 3, seed=5)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    e_t = fstat.onehot_perm_factors(torch.from_numpy(gperms),
                                    torch.from_numpy(inv_gs), tdt)
    e_j = jfstat.onehot_perm_factors(jnp.asarray(gperms),
                                     jnp.asarray(inv_gs), jdt)
    np.testing.assert_array_equal(e_t.float().numpy(),
                                  np.asarray(e_j.astype(jnp.float32)))
    got = fstat.sw_matmul_block(torch.from_numpy(mat2),
                                torch.from_numpy(gperms),
                                torch.from_numpy(inv_gs))
    want = jfstat.sw_matmul_block(jnp.asarray(mat2), jnp.asarray(gperms),
                                  jnp.asarray(inv_gs))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=5e-5)


@pytest.mark.parametrize("sizes", [(7, 14), (14, 3, 28, 1), (56, 7, 112)])
def test_onehot_sqrt_is_correctly_rounded(sizes):
    """sqrt(w) in the one-hot factor and in the matmul kernel's operand is
    the correctly rounded f32 square root at group sizes where torch's own
    f32 sqrt can be 1 ulp off (1/14 on some CPUs): bit-equal to numpy's
    and to the reference's factor."""
    from repro_torch.kernels.permanova_sw import ops as sw_ops
    grouping = np.repeat(np.arange(len(sizes)), sizes).astype(np.int32)
    g = len(sizes)
    inv_t = permutations.inv_group_sizes(torch.from_numpy(grouping), g)
    inv_j = np.asarray(jperm.inv_group_sizes(jnp.asarray(grouping), g))
    np.testing.assert_array_equal(inv_t.numpy(), inv_j)
    want = np.sqrt(inv_j)
    assert want.dtype == np.float32
    np.testing.assert_array_equal(
        fstat.rounded_sqrt(inv_t, torch.float32).numpy(), want)
    np.testing.assert_array_equal(
        sw_ops._rounded_sqrt_w(inv_t, torch.float32).numpy(), want)
    gperms = grouping[None, :]
    e_t = fstat.onehot_perm_factors(torch.from_numpy(gperms), inv_t,
                                    torch.float32)
    e_j = jfstat.onehot_perm_factors(jnp.asarray(gperms),
                                     jnp.asarray(inv_j), jnp.float32)
    np.testing.assert_array_equal(e_t.numpy(), np.asarray(e_j))
    np.testing.assert_array_equal(e_t[0, np.arange(len(grouping)),
                                      grouping].numpy(), want[grouping])


def test_tiled_pad_keeps_requested_tile():
    """Prime n pads to the requested tile with sentinel labels: the result
    equals the unpadded brute force."""
    mat2, _, inv_gs, gperms = _sw_instance(53, 5, seed=4)
    args = (torch.from_numpy(mat2), torch.from_numpy(gperms),
            torch.from_numpy(inv_gs))
    torch.testing.assert_close(fstat.sw_tiled(*args, tile=16),
                               fstat.sw_brute(*args), rtol=5e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# permanova core.
# ---------------------------------------------------------------------------

def test_statistics_helpers_match_reference():
    mat2, _, _, _ = _sw_instance(30, 3, seed=8)
    rng = np.random.default_rng(1)
    s_w = rng.random(50).astype(np.float32) * 10 + 1
    st_t = s_total(torch.from_numpy(mat2))
    st_j = j_s_total(jnp.asarray(mat2))
    assert float(st_t) == pytest.approx(float(st_j), rel=1e-6)
    s_t = float(st_j)           # one s_T for both: F cancels s_T - s_W
    f_t = f_from_sw(torch.from_numpy(s_w), torch.tensor(s_t), 30, 3)
    f_j = j_f_from_sw(jnp.asarray(s_w), jnp.float32(s_t), 30, 3)
    np.testing.assert_allclose(f_t.numpy(), np.asarray(f_j), rtol=1e-6)
    f_ties = np.array([2.0, 1.0, 2.0, 3.0, 0.5], np.float32)
    p_t = float(p_value_from_null(torch.from_numpy(f_ties)))
    assert p_t == float(j_p_value(jnp.asarray(f_ties)))
    assert p_t == pytest.approx(0.6)    # ties count as >= observed


@pytest.mark.parametrize("impl", ["brute", "tiled", "matmul", "auto"])
def test_permanova_matches_reference(impl, small_study):
    dm, grouping, _, _ = small_study
    key = jax.random.key(3)
    res_j = jpermanova(jnp.asarray(dm), jnp.asarray(grouping), n_perms=49,
                       key=key,
                       sw_impl="matmul" if impl == "auto" else impl)
    dm_t, g_t, perms = from_reference(
        dm, grouping, jperm.permutation_batch(key, jnp.asarray(grouping), 0,
                                              50), device="cpu")
    res_t = permanova(dm_t, g_t, n_perms=49, perms=perms, sw_impl=impl,
                      device="cpu")
    np.testing.assert_allclose(float(res_t.f_stat), float(res_j.f_stat),
                               rtol=1e-4)
    assert float(res_t.p_value) == float(res_j.p_value)
    np.testing.assert_allclose(res_t.f_perms.numpy(),
                               np.asarray(res_j.f_perms), rtol=1e-4)
    assert float(res_t.r2) == pytest.approx(float(res_j.r2), rel=1e-4)
    assert (res_t.n_objects, res_t.n_groups, res_t.n_perms) == \
        (res_j.n_objects, res_j.n_groups, res_j.n_perms)


@pytest.mark.parametrize("kw", [
    {"covariates": {"age": np.zeros(48)}},
    {"strata": np.zeros(48, np.int32)},
    {"weights": np.ones(48)},
    # the features path (metric=) takes designs too
    {"metric": "braycurtis", "weights": np.ones(48)},
], ids=["covariates", "strata", "weights", "metric"])
def test_permanova_later_slices_raise(kw, small_study):
    """These options waited for the designs slice, which has landed: each
    now runs and reports per-term statistics (test_torch_design.py holds
    them against the reference)."""
    dm, grouping, _ = from_reference(*small_study[:2], device="cpu")
    res = permanova(dm, grouping, n_perms=9, device="cpu", **kw)
    assert res.terms is not None and res.terms[-1].name == "grouping"
    assert res.f_perms.shape == (10,) and 0.0 < float(res.p_value) <= 1.0


def test_permanova_features_input_raises():
    """An (n, d) table routes to the pipeline, which has no place for a
    custom s_W callable: sw_fn raises there, as in the reference."""
    x, grouping = microbiome.synthetic_study(20, 8, 2, seed=0)
    with pytest.raises(ValueError, match="features path"):
        permanova(torch.from_numpy(x), torch.from_numpy(grouping),
                  n_perms=9, sw_fn=lambda *a: None, device="cpu")


def test_permanova_warns_on_square_feature_table():
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.random((12, 12)).astype(np.float32) + 1.0)
    with pytest.warns(UserWarning, match="does not look like a distance"):
        permanova(x, torch.arange(12) % 2, n_perms=9, device="cpu")


def test_permanova_defaults_to_cuda_and_raises_without_it():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    x, grouping = microbiome.synthetic_study(20, 8, 2, seed=0)
    dm = distance.braycurtis(x)
    with pytest.raises(RuntimeError, match="cuda"):
        permanova(dm, torch.from_numpy(grouping), n_perms=9)


# ---------------------------------------------------------------------------
# hw, compat, and the port's import boundary.
# ---------------------------------------------------------------------------

def test_hw_constants_and_device_resolution():
    chip = hw.H100_SXM
    assert chip.sms == 132 and chip.hbm_bandwidth == 3.35e12
    assert chip.peak_flops_f32 == 67e12 and chip.peak_flops_bf16 == 989e12
    assert chip.l2_bytes == 50e6 and chip.hbm_bytes == 80e9
    assert chip.smem_per_block == 227 * 1024
    assert (hw.PAPER_N_DIMS, hw.PAPER_N_PERMS) == (25145, 3999)
    assert hw.resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        hw.resolve_device("meta")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            hw.resolve_device("cuda")


def test_from_reference_copies_read_only_arrays():
    dm = np.asarray(jnp.ones((4, 4)))
    assert not dm.flags.writeable
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        dm_t, g_t, p_t = from_reference(dm, np.arange(4), None,
                                        device="cpu")
    assert dm_t.dtype == torch.float32 and g_t.dtype == torch.int32
    assert p_t is None
    dm_t[0, 0] = 5.0                     # a copy, not a view of `dm`
    assert dm[0, 0] == 1.0
    writable = np.zeros((2, 3), np.int32)
    _, _, p_t = from_reference(perms=writable, device="cpu")
    assert p_t.shape == (2, 3) and p_t.dtype == torch.int32


_FORBIDDEN = re.compile(r"^\s*(import|from)\s+(jax|repro)(\.|\s|$)", re.M)


def test_port_sources_import_no_reference():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(SRC, "repro_torch")):
        files += [os.path.join(root, f) for f in names if f.endswith(".py")]
    assert len(files) > 15
    for path in files:
        with open(path) as f:
            assert not _FORBIDDEN.search(f.read()), path


def test_port_loads_no_jax_or_reference_modules():
    code = ("import sys, repro_torch.engine, repro_torch.launch.permanova, "
            "repro_torch.compat, repro_torch.core, repro_torch.pipeline\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro'))\n"
            "print(bad)\n")
    env = dict(os.environ, PYTHONPATH=SRC)
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120,
                         check=True).stdout
    assert out.strip() == "[]"
