"""The port's designs (covariates, strata, weights) against the reference's
on the same numpy inputs: the fp64 design builder, per-term statistics,
the strata-restricted generator, the per-column contraction forms,
engine.run_design / permanova() with the reference's own index
permutations, pipeline() through all four bridges for every metric, the
planners' dense-design sizing, the synthetic design columns and the CLI.
Each test states its tolerance. The fused_sw_cols kernel itself runs only
on the card; `chip_smoke.py` holds it against its plain version there,
and tests/test_torch_fused.py holds that plain version against the
reference's kernel."""

import dataclasses
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

from repro import engine as jengine  # noqa: E402
from repro import pipeline as jpipe  # noqa: E402
from repro.core import design as jdsg  # noqa: E402
from repro.core import distance as jdist  # noqa: E402
from repro.core import fstat as jfstat  # noqa: E402
from repro.core import permutations as jperm  # noqa: E402
from repro.core.permanova import permanova as jpermanova  # noqa: E402
from repro.data import microbiome as jmicro  # noqa: E402
from repro.engine import planner as jeplanner  # noqa: E402
from repro.engine import registry as jregistry  # noqa: E402
from repro.pipeline import planner as jpplanner  # noqa: E402
from repro_torch import engine, pipeline  # noqa: E402
from repro_torch.core import design, fstat, permutations  # noqa: E402
from repro_torch.core.permanova import permanova  # noqa: E402
from repro_torch.data import microbiome  # noqa: E402
from repro_torch.engine import planner, registry  # noqa: E402
from repro_torch.kernels.fused_sw import ops as fops  # noqa: E402
from repro_torch.launch import permanova as cli  # noqa: E402
from repro_torch.pipeline import planner as pplanner  # noqa: E402
from repro_torch.pipeline import registry as pregistry  # noqa: E402
from repro_torch.pipeline import streaming  # noqa: E402

G = 4
METRICS = ["aitchison", "braycurtis", "euclidean", "jaccard"]
BRIDGES = ["dense", "stream", "fused", "fused-kernel"]
# the reference's bars (tests/test_design.py): the fp64 projection oracle
# on a resident matrix, and every bridge against the oracle
ENGINE_RTOL, ENGINE_ATOL = 1e-4, 1e-5        # port vs reference, same perms
ORACLE_RTOL, ORACLE_ATOL = 5e-4, 1e-5
BRIDGE_RTOL, BRIDGE_ATOL = 2e-3, 1e-4
# per-column forms in f32 against the reference's f32 forms
COLS_RTOL, COLS_ATOL = 1e-5, 1e-6


def _study(n, d=12, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.gamma(1.0, 1.0, size=(n, d)).astype(np.float32)
    x[rng.random((n, d)) < 0.4] = 0.0
    x[:, 0] = np.maximum(x[:, 0], 1e-3)     # no all-zero row
    labels = rng.integers(0, G, size=n).astype(np.int32)
    labels[:G] = np.arange(G)
    cov = rng.normal(size=(n, 2))
    strata = (np.arange(n) % 3).astype(np.int32)
    weights = rng.gamma(4.0, 0.25, size=n)
    return x, labels, cov, strata, weights


def _sym_dm(n, seed):
    rng = np.random.default_rng(seed)
    d = rng.random((n, n)).astype(np.float32)
    d = (d + d.T) / 2
    np.fill_diagonal(d, 0.0)
    return d


DESIGNS = {
    "covariates": lambda cov, strata, w: dict(covariates=cov),
    "weights": lambda cov, strata, w: dict(covariates=cov, weights=w),
    "strata": lambda cov, strata, w: dict(strata=strata),
    "covariates+strata": lambda cov, strata, w: dict(covariates=cov,
                                                     strata=strata),
}


def _design_kw(case, n, seed):
    _, labels, cov, strata, w = _study(n, seed=seed)
    return labels, DESIGNS[case](cov, strata, w)


def _index_perms(kw, n, n_total, key):
    """The reference's own index permutations for this design (its free
    draws are the strata generator on zeros), as the port's tensor."""
    strata = kw.get("strata", np.zeros(n, np.int32))
    p = jperm.strata_permutation_batch(key, jnp.asarray(strata), 0, n_total)
    return torch.from_numpy(np.array(p))


def _assert_terms(res_t, res_j, rtol, atol):
    assert [t.name for t in res_t.terms] == [t.name for t in res_j.terms]
    assert [t.df for t in res_t.terms] == [t.df for t in res_j.terms]
    got = [float(t.f_stat) for t in res_t.terms]
    want = [float(t.f_stat) for t in res_j.terms]
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)
    assert [float(t.p_value) for t in res_t.terms] == \
        [float(t.p_value) for t in res_j.terms]


def oracle_term_f_fp64(dm, labels, cov, *, weights=None):
    """Explicit sequential-projection oracle (fp64 hat matrices, pinv),
    independent of either package's basis code: residual SS of the
    cumulative model t is 0.5 tr(H_t W^1/2 mat2 W^1/2)."""
    n = dm.shape[0]
    m2 = np.asarray(dm, np.float64) ** 2
    w = np.ones(n) if weights is None else np.asarray(weights, np.float64)
    sw = np.sqrt(w)
    mt = sw[:, None] * m2 * sw[None, :]
    onehot = np.zeros((n, G))
    onehot[np.arange(n), labels] = 1.0
    blocks = [np.ones((n, 1))] + [cov[:, j:j + 1]
                                  for j in range(cov.shape[1])] + [onehot]
    resid, dfs, rank_prev = [], [], 0
    for t in range(1, len(blocks) + 1):
        xt = sw[:, None] * np.concatenate(blocks[:t], axis=1)
        hat = xt @ np.linalg.pinv(xt)
        resid.append(0.5 * np.sum(hat * mt))
        rank = np.linalg.matrix_rank(xt)
        dfs.append(rank - rank_prev)
        rank_prev = rank
    ss = [resid[t] - resid[t + 1] for t in range(len(resid) - 1)]
    denom = resid[-1] / (n - rank_prev)
    return [s / max(df, 1) / denom for s, df in zip(ss, dfs[1:])]


# ---------------------------------------------------------------------------
# core.design: the fp64 builder and the per-term assembly.
# ---------------------------------------------------------------------------

BUILD_CASES = {
    "covariates": lambda x, lab, cov, st, w: dict(grouping=lab,
                                                   covariates=cov),
    "two_factors": lambda x, lab, cov, st, w: dict(
        grouping=lab, factors={"site": st}),
    "weights": lambda x, lab, cov, st, w: dict(grouping=lab, covariates=cov,
                                               weights=w),
    "collinear": lambda x, lab, cov, st, w: dict(
        grouping=lab, covariates={"a": cov[:, 0], "a3": 3.0 * cov[:, 0]}),
    "strata": lambda x, lab, cov, st, w: dict(grouping=lab, covariates=cov,
                                              strata=st),
    "covariates_only": lambda x, lab, cov, st, w: dict(covariates=cov),
    "factor_with_weights": lambda x, lab, cov, st, w: dict(grouping=lab,
                                                           weights=w),
}


@pytest.mark.parametrize("case", sorted(BUILD_CASES))
def test_build_matches_reference(case):
    """basis64 equal to the reference's at 1e-12 (the same numpy code on
    the same host), the f32 operand equal, and the same terms, spans,
    dfs and residual dof."""
    x, lab, cov, st, w = _study(23, seed=2)
    kw = BUILD_CASES[case](x, lab, cov, st, w)
    ref = jdsg.build(n_groups=G if "grouping" in kw else None, **kw)
    got = design.build(n_groups=G if "grouping" in kw else None,
                       device="cpu", **kw)
    assert got.mode == ref.mode == design.MODE_DENSE
    assert [dataclass_tuple(t) for t in got.terms] == \
        [dataclass_tuple(t) for t in ref.terms]
    assert (got.dof_resid, got.rank, got.k_cols, got.n) == \
        (ref.dof_resid, ref.rank, ref.k_cols, ref.n)
    np.testing.assert_allclose(got.basis64, ref.basis64, rtol=0, atol=1e-12)
    np.testing.assert_array_equal(got.basis.numpy(), np.asarray(ref.basis))
    assert got.basis.dtype == torch.float32
    if "strata" in kw:
        np.testing.assert_array_equal(got.strata.numpy(), st)
    assert got.describe() == ref.describe()
    if case == "collinear":
        assert [t.df for t in got.terms] == [1, 1, 0, G - 1]


def dataclass_tuple(t):
    return (t.name, t.kind, t.df, t.lo, t.hi)


def test_saturated_design_raises_as_reference():
    labels = np.arange(5).astype(np.int32)
    for build in (jdsg.build, functools.partial(design.build, device="cpu")):
        with pytest.raises(ValueError, match="saturated"):
            build(grouping=labels, n_groups=5, weights=np.ones(5))


@pytest.mark.parametrize("kw,match", [
    ({"weights": -np.ones(16)}, "non-negative"),
    ({"weights": np.ones(7)}, "weights must be"),
    ({"covariates": np.ones((7, 2))}, "covariates must be"),
], ids=["negative", "length", "covariate_rows"])
def test_build_validates_as_reference(kw, match):
    _, labels, _, _, _ = _study(16, seed=4)
    for build in (jdsg.build, functools.partial(design.build, device="cpu")):
        with pytest.raises(ValueError, match=match):
            build(grouping=labels, n_groups=G, **kw)


def test_single_factor_is_labels_mode_and_strata_is_not_plain():
    _, labels, _, strata, _ = _study(20, seed=1)
    d = design.build(grouping=labels, n_groups=G, device="cpu")
    assert d.mode == design.MODE_LABELS and d.is_plain_labels
    assert [t.df for t in d.terms] == [1, G - 1] and d.dof_resid == 20 - G
    ops = d.operands
    np.testing.assert_array_equal(ops.grouping.numpy(), labels)
    ref_inv = jperm.inv_group_sizes(jnp.asarray(labels), G)
    np.testing.assert_array_equal(ops.inv_group_sizes.numpy(),
                                  np.asarray(ref_inv))
    ds = design.Design.from_labels(labels, strata=strata, device="cpu")
    assert ds.mode == design.MODE_LABELS and not ds.is_plain_labels
    assert ds.describe() == jdsg.Design.from_labels(
        jnp.asarray(labels), strata=strata).describe()
    dense = design.build(grouping=labels, covariates=np.ones((20, 1)),
                         n_groups=G, device="cpu")
    assert dense.operands.term_cols == tuple((t.lo, t.hi)
                                             for t in dense.terms)
    assert design.Design.from_labels(dense) is dense


def test_builders_default_to_cuda_and_raise_without_it():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _, labels, cov, _, _ = _study(12, seed=3)
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        design.build(grouping=labels, covariates=cov, n_groups=G)
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        design.Design.from_labels(labels)


def test_term_stats_match_reference():
    """The same s_cols through both assemblies: rtol 1e-6, a collinear
    (df 0) term reporting F = 0 in both."""
    _, labels, cov, _, _ = _study(25, seed=5)
    covs = {"a": cov[:, 0], "a2": 2.0 * cov[:, 0], "b": cov[:, 1]}
    ref = jdsg.build(grouping=labels, covariates=covs, n_groups=G)
    got = design.build(grouping=labels, covariates=covs, n_groups=G,
                       device="cpu")
    s_cols = np.random.default_rng(5).normal(
        size=(9, got.k_cols)).astype(np.float32)
    s_cols[:, 0] = np.abs(s_cols[:, 0]) + 50.0     # intercept: s_T
    s_cols[:, 1:] = -np.abs(s_cols[:, 1:])         # explained SS >= 0
    tj = jdsg.term_stats(jnp.asarray(s_cols), ref)
    tt = design.term_stats(torch.from_numpy(s_cols), got)
    for name in ("ss_resid", "s_t", "ss_terms", "f_terms"):
        np.testing.assert_allclose(getattr(tt, name).numpy(),
                                   np.asarray(getattr(tj, name)), rtol=1e-6,
                                   err_msg=name)
    assert float(tt.f_terms[0, 1]) == 0.0          # 'a2' is collinear
    ss_resid = design.term_stats(torch.from_numpy(s_cols), got,
                                 dof_resid=7).f_terms
    np.testing.assert_allclose(
        ss_resid.numpy(),
        np.asarray(jdsg.term_stats(jnp.asarray(s_cols), ref,
                                   dof_resid=7).f_terms), rtol=1e-6)


def test_observed_scols_fp64_and_pad_design_match_reference():
    dm = _sym_dm(18, seed=6)
    _, labels, cov, strata, _ = _study(18, seed=6)
    ref = jdsg.build(grouping=labels, covariates=cov, strata=strata,
                     n_groups=G)
    got = design.build(grouping=labels, covariates=cov, strata=strata,
                       n_groups=G, device="cpu")
    np.testing.assert_allclose(design.observed_scols_fp64(dm * dm, got),
                               jdsg.observed_scols_fp64(dm * dm, ref),
                               rtol=1e-12)
    pr, pg = jdsg.pad_design(ref, 23), design.pad_design(got, 23)
    np.testing.assert_array_equal(pg.basis64, pr.basis64)
    np.testing.assert_array_equal(pg.basis.numpy(), np.asarray(pr.basis))
    np.testing.assert_array_equal(pg.strata.numpy(), np.asarray(pr.strata))
    np.testing.assert_array_equal(pg.grouping.numpy(),
                                  np.asarray(pr.grouping))
    assert design.pad_design(got, 18) is got
    with pytest.raises(ValueError, match="n_pad"):
        design.pad_design(got, 10)
    with pytest.raises(ValueError, match="dense-mode"):
        design.pad_design(design.Design.from_labels(labels, device="cpu"),
                          20)


# ---------------------------------------------------------------------------
# core.permutations: the strata-restricted generator.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,n_strata,seed", [(7, 1, 0), (13, 3, 1),
                                             (29, 4, 2), (64, 2, 3)])
def test_strata_perms_are_permutations_within_blocks(n, n_strata, seed):
    rng = np.random.default_rng(seed)
    strata = torch.from_numpy(rng.integers(0, n_strata, n).astype(np.int32))
    grouping = torch.from_numpy(rng.integers(0, 3, n).astype(np.int32))
    perms = permutations.strata_permutation_batch(strata, 0, 12, seed=seed)
    assert perms.dtype == torch.int32 and perms.shape == (12, n)
    assert torch.equal(perms[0], torch.arange(n, dtype=torch.int32))
    for p in perms:
        assert sorted(p.tolist()) == list(range(n))           # a permutation
        assert torch.equal(strata[p.long()], strata)         # blocks kept
    labels = permutations.strata_label_batch(grouping, strata, 0, 12,
                                             seed=seed)
    assert torch.equal(labels, grouping[perms.long()])
    for row in labels:      # each block keeps its label multiset
        for s in range(n_strata):
            m = strata == s
            assert sorted(row[m].tolist()) == sorted(grouping[m].tolist())
    assert len({tuple(p.tolist()) for p in perms[1:]}) > 1


@pytest.mark.parametrize("cuts", [(0, 5, 17), (0, 1, 2, 17), (0, 17)])
def test_strata_perms_are_chunk_invariant(cuts):
    strata = torch.from_numpy((np.arange(31) % 4).astype(np.int32))
    full = permutations.strata_permutation_batch(strata, 0, 17, seed=9)
    parts = torch.cat([permutations.strata_permutation_batch(
        strata, lo, hi, seed=9) for lo, hi in zip(cuts, cuts[1:])])
    assert torch.equal(parts, full)


def test_constant_strata_equal_the_free_draws():
    """A constant strata vector gives the free generator's argsort(keys):
    the labels-mode draws of a free design are the plain path's."""
    grouping = torch.from_numpy(
        np.random.default_rng(0).integers(0, 5, 40).astype(np.int32))
    for const in (0, 7):
        strata = torch.full((40,), const, dtype=torch.int32)
        labels = permutations.strata_label_batch(grouping, strata, 3, 20,
                                                 seed=4)
        assert torch.equal(labels, permutations.permutation_batch(
            grouping, 3, 20, seed=4))


def test_strata_perms_seed_changes_draws():
    strata = torch.from_numpy((np.arange(30) % 2).astype(np.int32))
    a = permutations.strata_permutation_batch(strata, 1, 6, seed=1)
    b = permutations.strata_permutation_batch(strata, 1, 6, seed=2)
    assert not torch.equal(a, b)


def test_masked_strata_matches_reference():
    for strata in (np.arange(15) % 2, np.full(15, 15)):
        strata = strata.astype(np.int32)
        got = permutations.masked_strata(torch.from_numpy(strata), 11)
        want = jperm.masked_strata(jnp.asarray(strata), jnp.int32(11))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        perms = permutations.strata_permutation_batch(got, 0, 8, seed=1)
        for p in perms:
            assert set(p[11:].tolist()) == set(range(11, 15))


# ---------------------------------------------------------------------------
# core.fstat: the per-column contraction forms.
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _cols_instance(n=22, p=7, seed=11):
    dm = _sym_dm(n, seed)
    _, labels, cov, strata, _ = _study(n, seed=seed)
    des = jdsg.build(grouping=labels, covariates=cov, n_groups=G)
    perms = jperm.strata_permutation_batch(jax.random.key(seed),
                                           jnp.zeros((n,), jnp.int32), 0, p)
    v = np.array(jfstat.basis_perm_factors(des.basis, perms))
    return dm * dm, np.array(des.basis), np.array(perms), v


@pytest.mark.parametrize("form", ["contract", "block", "matmul", "brute"])
def test_sw_cols_forms_match_reference(form):
    """Each per-column form against the reference's at rtol 1e-5 / atol
    1e-6 (f32 both sides, sums in other orders)."""
    mat2, basis, perms, v = _cols_instance()
    vt = fstat.basis_perm_factors(torch.from_numpy(basis),
                                  torch.from_numpy(perms))
    np.testing.assert_array_equal(vt.numpy(), v)
    m, vj = jnp.asarray(mat2), jnp.asarray(v)
    mt = torch.from_numpy(mat2)
    if form == "contract":
        got = fstat.sw_cols_contract(mt[5:14], vt, vt[:, 5:14])
        want = jfstat.sw_cols_contract(m[5:14], vj, vj[:, 5:14])
    elif form == "block":
        got, want = fstat.sw_cols_block(mt, vt), jfstat.sw_cols_block(m, vj)
    elif form == "matmul":
        got = fstat.sw_cols_matmul(mt, vt, perm_block=3)
        want = jfstat.sw_cols_matmul(m, vj, perm_block=3)
    else:
        got = fstat.sw_cols_brute(mt, vt, block=4)
        want = jfstat.sw_cols_brute(m, vj, block=4)
    assert got.shape == (v.shape[0] if form != "contract" else 7,
                         v.shape[2])
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=COLS_RTOL, atol=COLS_ATOL)


def _block_sparse_basis(n=24, seed=13):
    """Strata (3 blocks) and a basis whose columns live inside one or two
    blocks, plus one dense column: the column groups are nontrivial."""
    rng = np.random.default_rng(seed)
    strata = (np.arange(n) % 3).astype(np.int32)
    basis = np.zeros((n, 6), np.float32)
    basis[:, 0] = rng.normal(size=n)
    for k, blocks in enumerate([(0,), (0,), (1,), (2,), (1, 2)], start=1):
        rows = np.isin(strata, blocks)
        basis[rows, k] = rng.normal(size=int(rows.sum()))
    return strata, basis, _sym_dm(n, seed)


def test_sparse_col_groups_and_contraction_match_reference():
    """The block-sparse contraction: its groups as the reference's, its
    value as the reference's at rtol 1e-5 / atol 1e-6, and as the port's
    own dense contraction at the same bar (their sums differ only in
    order and in exact zeros)."""
    strata, basis, dm = _block_sparse_basis()
    groups_j = jfstat.sparse_col_groups(jnp.asarray(basis), strata)
    groups_t = fstat.sparse_col_groups(torch.from_numpy(basis),
                                       torch.from_numpy(strata))
    assert groups_t == groups_j and len(groups_t) == 5
    perms = jperm.strata_permutation_batch(jax.random.key(2),
                                           jnp.asarray(strata), 0, 5)
    v = np.array(jfstat.basis_perm_factors(jnp.asarray(basis), perms))
    mat2 = dm * dm
    want = jfstat.sw_cols_contract_sparse(jnp.asarray(mat2[3:17]),
                                          jnp.asarray(v),
                                          jnp.asarray(v[:, 3:17]), groups_j)
    vt = torch.from_numpy(v)
    got = fstat.sw_cols_contract_sparse(torch.from_numpy(mat2[3:17]), vt,
                                        vt[:, 3:17], groups_t)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=COLS_RTOL, atol=COLS_ATOL)
    dense = fstat.sw_cols_contract(torch.from_numpy(mat2[3:17]), vt,
                                   vt[:, 3:17])
    np.testing.assert_allclose(got.numpy(), dense.numpy(), rtol=COLS_RTOL,
                               atol=COLS_ATOL)
    one = ((tuple(range(v.shape[2])), tuple(range(24))),)
    assert torch.equal(fstat.sw_cols_contract_sparse(
        torch.from_numpy(mat2), vt, vt, one),
        fstat.sw_cols_contract(torch.from_numpy(mat2), vt, vt))


# ---------------------------------------------------------------------------
# engine: run_design and permanova() against the reference.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("impl", ["auto", "brute", "tiled", "matmul"])
@pytest.mark.parametrize("case", sorted(DESIGNS))
def test_run_design_matches_reference(case, impl):
    """engine.run with a design against the reference's on its own index
    permutations: per-term F at rtol 1e-4 / atol 1e-5, p equal, the same
    method string, on the same chunking."""
    n = 26
    dm = _sym_dm(n, seed=7)
    labels, kw = _design_kw(case, n, seed=7)
    key = jax.random.key(3)
    ref = jengine.run(jnp.asarray(dm), jnp.asarray(labels), n_perms=29,
                      key=key, n_groups=G, impl=impl, chunk=11, **kw)
    got = engine.run(dm, labels, n_perms=29, n_groups=G, impl=impl,
                     chunk=11, index_perms=_index_perms(kw, n, 30, key),
                     device="cpu", **kw)
    _assert_terms(got, ref, ENGINE_RTOL, ENGINE_ATOL)
    assert got.method == ref.method
    assert got.plan.split(" chunks=")[1] == ref.plan.split(" chunks=")[1]
    np.testing.assert_allclose(float(got.f_stat), float(ref.f_stat),
                               rtol=ENGINE_RTOL)
    assert float(got.p_value) == float(ref.p_value)


@pytest.mark.parametrize("case", sorted(DESIGNS))
def test_permanova_matches_reference_and_fp64_oracle(case):
    """permanova() with a design against the reference's permanova() on
    its index permutations (rtol 1e-4 / atol 1e-5, p equal), and per-term
    F against the fp64 projection oracle at the reference's bar (rtol
    5e-4, atol 1e-5)."""
    n = 27
    x, labels, cov, strata, w = _study(n, seed=8)
    dm = np.asarray(jdist.distance_matrix(jnp.asarray(x), "braycurtis"))
    kw = DESIGNS[case](cov, strata, w)
    key = jax.random.key(5)
    ref = jpermanova(jnp.asarray(dm), labels, n_perms=19, key=key,
                     n_groups=G, **kw)
    got = permanova(torch.from_numpy(dm.copy()), labels, n_perms=19,
                    n_groups=G,
                    index_perms=_index_perms(kw, n, 20, key), device="cpu",
                    **kw)
    _assert_terms(got, ref, ENGINE_RTOL, ENGINE_ATOL)
    oracle = oracle_term_f_fp64(dm, labels,
                                kw.get("covariates", np.zeros((n, 0))),
                                weights=kw.get("weights"))
    np.testing.assert_allclose([float(t.f_stat) for t in got.terms], oracle,
                               rtol=ORACLE_RTOL, atol=ORACLE_ATOL)
    for t in got.terms:
        assert t.f_perms.shape == (20,) and 0.0 < float(t.p_value) <= 1.0
        assert float(t.r2) == pytest.approx(float(t.ss) / float(got.s_t))


@pytest.mark.parametrize("case", ["covariates+strata", "weights"])
def test_dense_design_null_is_bit_equal_at_chunk_1_and_40(case):
    """A permutation's per-column forms do not depend on how many
    permutations share the product: chunk 1 (one permutation a product)
    and chunk 40 (all of them in one) give the same null bit for bit."""
    n = 30
    dm = _sym_dm(n, seed=9)
    labels, kw = _design_kw(case, n, seed=9)
    a = engine.run(dm, labels, n_perms=39, seed=4, chunk=40, device="cpu",
                   **kw)
    b = engine.run(dm, labels, n_perms=39, seed=4, chunk=1, device="cpu",
                   **kw)
    assert "chunks=1 " in a.plan and "chunks=40 " in b.plan
    for ta, tb in zip(a.terms, b.terms):
        assert torch.equal(ta.f_perms, tb.f_perms)


def test_design_runs_from_seed_are_chunk_invariant_and_restricted():
    """From `seed` the design draws are the port's own: any chunking gives
    the same null, and the strata-restricted null differs from the free
    one while the observed F is the same."""
    n = 30
    dm = _sym_dm(n, seed=9)
    labels, kw = _design_kw("covariates+strata", n, seed=9)
    a = engine.run(dm, labels, n_perms=39, seed=4, chunk=40, device="cpu",
                   **kw)
    b = engine.run(dm, labels, n_perms=39, seed=4, chunk=7, device="cpu",
                   **kw)
    for ta, tb in zip(a.terms, b.terms):
        torch.testing.assert_close(ta.f_perms, tb.f_perms, rtol=1e-6,
                                   atol=0)
    free = engine.run(dm, labels, n_perms=39, seed=4, device="cpu",
                      covariates=kw["covariates"])
    assert float(free.f_stat) == pytest.approx(float(a.f_stat), rel=1e-6)
    assert not torch.equal(free.f_perms[1:], a.f_perms[1:])
    st = engine.run(dm, labels, n_perms=39, seed=4, device="cpu",
                    strata=kw["strata"])
    plain = engine.run(dm, labels, n_perms=39, seed=4, device="cpu")
    assert float(st.f_stat) == pytest.approx(float(plain.f_stat), rel=1e-6)
    assert st.terms[0].df == G - 1 and "strata" in st.method


@pytest.mark.parametrize("impl", ["brute", "matmul", "tiled"])
def test_plain_label_design_stays_on_the_label_path(impl):
    """Design.from_labels without strata is the plain label path: the same
    null bit for bit, the same method and plan, no terms."""
    dm = _sym_dm(18, seed=6)
    _, labels, _, _, _ = _study(18, seed=6)
    raw = engine.run(dm, labels, n_perms=19, seed=2, impl=impl,
                     device="cpu")
    via = engine.run(dm, design.Design.from_labels(labels, device="cpu"),
                     n_perms=19,
                     seed=2, impl=impl, device="cpu")
    assert torch.equal(raw.f_perms, via.f_perms)
    assert (raw.method, raw.plan) == (via.method, via.plan)
    assert via.terms is None


@pytest.mark.parametrize("bridge", BRIDGES)
def test_plain_label_design_stays_on_the_label_path_in_pipeline(bridge):
    x, labels, _, _, _ = _study(22, d=8, seed=9)
    kw = dict(n_perms=9, seed=5, materialize=bridge, device="cpu")
    raw = pipeline.pipeline(torch.from_numpy(x), labels, **kw)
    via = pipeline.pipeline(torch.from_numpy(x),
                            design.Design.from_labels(labels, device="cpu"),
                            **kw)
    assert torch.equal(raw.f_perms, via.f_perms)
    assert (raw.method, raw.plan) == (via.method, via.plan)
    assert via.terms is None


def test_run_design_rejects_what_it_cannot_run():
    n = 16
    dm = _sym_dm(n, seed=1)
    labels, kw = _design_kw("covariates", n, seed=1)
    des = design.build(grouping=labels, n_groups=G, device="cpu", **kw)
    with pytest.raises(ValueError, match="index_perms"):
        engine.run_design(dm, des, n_perms=3,
                          perms=torch.zeros((4, n), dtype=torch.int32),
                          device="cpu")
    with pytest.raises(ValueError, match="not both"):
        engine.run(dm, des, covariates=kw["covariates"], device="cpu")
    with pytest.raises(ValueError, match="sw_fn"):
        engine.run(dm, labels, strata=np.zeros(n, np.int32),
                   sw_fn=lambda *a: None, device="cpu")
    with pytest.raises(ValueError, match="design is for"):
        engine.run_design(dm[:10, :10], des, n_perms=3, device="cpu")
    with pytest.raises(ValueError, match="index_perms must be"):
        engine.run(dm, labels, n_perms=3, device="cpu",
                   index_perms=torch.zeros((3, n), dtype=torch.int32), **kw)


def test_labels_mode_design_takes_explicit_labels():
    """perms= (explicit labels) stays accepted on a labels-mode design:
    the same result as index_perms gathered into labels."""
    n = 20
    dm = _sym_dm(n, seed=3)
    labels, kw = _design_kw("strata", n, seed=3)
    idx = permutations.strata_permutation_batch(
        torch.from_numpy(kw["strata"]), 0, 10, seed=1)
    a = engine.run(dm, labels, n_perms=9, index_perms=idx, device="cpu",
                   **kw)
    b = engine.run(dm, labels, n_perms=9, device="cpu",
                   perms=torch.from_numpy(labels)[idx.long()], **kw)
    assert torch.equal(a.f_perms, b.f_perms)


# ---------------------------------------------------------------------------
# Planners: dense designs.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,n_perms,n_cols,budget", [
    (25145, 4000, 10, None), (300, 1000, 3, 2 ** 20), (64, 10, 6, None)])
def test_chunk_for_budget_charges_the_basis_as_reference(n, n_perms, n_cols,
                                                         budget):
    want = jeplanner.chunk_for_budget(n, n_perms, jregistry.get("matmul"),
                                      8, budget, n_cols=n_cols)
    assert planner.chunk_for_budget(n, n_perms, budget,
                                    n_cols=n_cols) == want


@pytest.mark.parametrize("impl", [None, "brute", "tiled", "matmul"])
def test_design_plan_matches_reference_on_cpu(impl):
    got = planner.plan(300, 1000, backend="cpu", impl=impl, n_cols=7,
                       memory_budget_bytes=2 ** 22)
    want = jeplanner.plan(300, 1000, 8, backend="cpu", impl=impl, n_cols=7,
                          memory_budget_bytes=2 ** 22)
    assert (got.impl, got.chunk, got.streaming) == \
        (want.impl, want.chunk, want.streaming)
    assert got.describe() == want.describe()


def test_design_plan_on_cuda_runs_the_brute_companion_without_a_kernel():
    pl = planner.plan(25145, 4000, backend="cuda", n_cols=10)
    assert (pl.impl, pl.kernel, pl.chunk) == ("brute", None, 242)
    assert pl.describe().startswith("brute[block=32] stream(chunk=242) on "
                                    "cuda: dense design, GPU")
    assert registry.resolve_cols("tiled")[0] == "matmul"
    assert registry.resolve_cols("pallas_brute")[1] is fstat.sw_cols_brute
    fn = registry.bound_cols("matmul", perm_block=5, block=3)
    assert fn.keywords == {"perm_block": 5}
    assert registry.bound_cols("brute") is fstat.sw_cols_brute


@pytest.mark.parametrize("materialize", ["auto", "dense", "fused",
                                         "fused-kernel"])
def test_pipeline_plan_with_design_cols_matches_reference_on_cpu(
        materialize):
    kw = dict(metric="braycurtis", materialize=materialize,
              matrix_budget_bytes=2 ** 18, design_cols=9)
    got = pplanner.plan_pipeline(300, 16, 500, 4, backend="cpu", **kw)
    want = jpplanner.plan_pipeline(300, 16, 500, 4, backend="cpu", **kw)
    assert (got.materialize, got.sw.impl, got.sw.chunk, got.row_block) == \
        (want.materialize, want.sw.impl, want.sw.chunk, want.row_block)


def test_emp_design_plans_on_cuda():
    """At the EMP shape with the default budgets: a K = 10 design takes
    the fused-kernel bridge in chunks the fused_sw_cols kernel's workset
    sizes on the card: its partials (2,048 slots x K floats), index and
    basis (4 n (K + 1) bytes) a permutation and the slack share 256 MiB,
    and the index draw's sub-blocks what the partials and the index leave
    (the basis is gathered after the draw); of the whole 128-q passes
    that fit, 204 permutations (16 passes) cost least: 20 launches for
    4,000 slots, 40 index draws of 107 rows (where the reference's
    one-hot model took 127 and 32 launches); strata only keeps the label
    chunk, which the fused_sw kernel's workset and the strata draw size:
    896 (5 launches). The CPU plan keeps the one-hot chunk."""
    pl = pplanner.plan_pipeline(25145, 128, 4000, 8, backend="cuda",
                                design_cols=10)
    assert (pl.materialize, pl.fused_impl, pl.sw.chunk) == \
        ("fused-kernel", "braycurtis.fusedk.cuda", 204)
    assert -(-4000 // pl.sw.chunk) == 20 and 204 * 10 // 128 == 15
    assert "(20 launches, 40 draws of 107 rows)" in pl.reason
    pl = pplanner.plan_pipeline(25145, 128, 4000, 8, backend="cuda",
                                draw="strata")
    assert (pl.materialize, pl.sw.chunk) == ("fused-kernel", 896)
    assert -(-4000 // pl.sw.chunk) == 5
    pl = pplanner.plan_pipeline(25145, 128, 4000, 8, backend="cpu",
                                design_cols=10)
    assert pl.sw.chunk == 127 and pl.draw_budget is None


def test_fused_workset_charges_the_cols_workspace():
    cuda = pregistry.get_fused("braycurtis.fusedk.cuda")
    torch_kind = pregistry.get_fused("braycurtis.fusedk.torch")
    n, chunk = 25145, 127
    assert cuda.workset_bytes(n, 128, chunk, 8, 64, n_cols=10) == \
        fops.cols_workspace_bytes(n, n, chunk, 10) + 4 * chunk * n * 11
    assert cuda.workset_bytes(n, 128, chunk, 8, 64, n_cols=10) < 2 ** 30
    assert torch_kind.workset_bytes(n, 128, chunk, 8, 64, n_cols=10) == \
        4 * 64 * n + 4 * chunk * n * 11
    args = (1000, 64, 50, 8, 128)
    assert torch_kind.workset_bytes(*args) == jpipe.get_fused(
        "braycurtis.fusedk.xla").workset_bytes(*args)


# ---------------------------------------------------------------------------
# pipeline(): every bridge and metric against the reference.
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _pipeline_reference(metric, bridge, case):
    n = 24
    x, labels, cov, strata, w = _study(n, d=10, seed=12)
    kw = DESIGNS[case](cov, strata, w)
    key = jax.random.key(0)
    res = jpipe.pipeline(jnp.asarray(x), labels, metric=metric, n_perms=19,
                         materialize=bridge, n_groups=G, key=key,
                         row_block=8, **kw)
    terms = [(t.name, t.df, float(t.f_stat), float(t.p_value))
             for t in res.terms]
    return x, labels, kw, _index_perms(kw, n, 20, key), terms, res.method


def _pipeline_case(bridge, metric):
    return {"dense": "covariates", "stream": "weights",
            "fused": "covariates+strata",
            "fused-kernel": "covariates"}[bridge] if metric != "braycurtis" \
        else None


@pytest.mark.parametrize("bridge", BRIDGES)
@pytest.mark.parametrize("metric", METRICS)
def test_pipeline_design_matches_reference(metric, bridge):
    """pipeline() with a design through each bridge and metric against the
    reference's on its index permutations: per-term F at the reference's
    test_bridges_match_oracle bar (rtol 2e-3, atol 1e-4), p equal. Bray-
    Curtis runs every design; the other metrics one each."""
    cases = ([_pipeline_case(bridge, metric)] if metric != "braycurtis"
             else sorted(DESIGNS))
    for case in cases:
        x, labels, kw, idx, want, method = _pipeline_reference(metric,
                                                               bridge, case)
        res = pipeline.pipeline(torch.from_numpy(x), labels, metric=metric,
                                n_perms=19, materialize=bridge, n_groups=G,
                                index_perms=idx, row_block=8, device="cpu",
                                **kw)
        got = [(t.name, t.df, float(t.f_stat), float(t.p_value))
               for t in res.terms]
        assert [g[:2] for g in got] == [w[:2] for w in want], case
        np.testing.assert_allclose([g[2] for g in got],
                                   [w[2] for w in want], rtol=BRIDGE_RTOL,
                                   atol=BRIDGE_ATOL, err_msg=case)
        assert [g[3] for g in got] == [w[3] for w in want], case
        assert res.method == method.replace(":xla", ":torch"), case
        assert res.plan.endswith(")") and "design[" in res.plan


@pytest.mark.parametrize("case", ["covariates", "strata"])
def test_fused_kernel_cuda_kind_plain_version_equals_torch_sweep(case):
    """On CPU tensors the CUDA kind of the fused-kernel bridge runs the
    megakernels' plain versions: the same per-term F and p as the plain
    torch sweep on the same draws, and no launch."""
    x, labels, cov, strata, w = _study(29, d=9, seed=14)
    kw = DESIGNS[case](cov, strata, w)
    before = dict(fops.LAUNCHES)
    runs = [pipeline.pipeline(torch.from_numpy(x), labels, n_perms=15,
                              seed=3, materialize="fused-kernel",
                              fused_impl=impl, chunk=6, device="cpu", **kw)
            for impl in ("cuda", "torch")]
    assert fops.LAUNCHES == before
    for a, b in zip(runs[0].terms, runs[1].terms):
        torch.testing.assert_close(a.f_perms, b.f_perms, rtol=1e-5,
                                   atol=1e-5)
        assert float(a.p_value) == float(b.p_value)
    assert runs[0].method.endswith(":cuda]" if case == "covariates"
                                   else ":cuda+strata]")


def test_design_sweeps_are_chunk_invariant_and_block_sparse_is_exact():
    """The design sweeps of pipeline.streaming at the per-column bar (rtol
    1e-5, atol 1e-6; other row blocks and chunks sum in other orders):
    the plain sweep's block-sparse form at two chunkings equals the dense
    contraction of the megakernel sweep's plain version, and the torch
    kind of the fused-kernel sweep is the plain sweep."""
    strata, basis, _ = _block_sparse_basis(n=30, seed=4)
    x, labels, cov, *_ = _study(30, d=8, seed=4)
    des = dataclasses.replace(
        design.build(grouping=labels, covariates=cov[:, :1], n_groups=G,
                     strata=strata, device="cpu"), basis=torch.from_numpy(basis))
    assert len(fstat.sparse_col_groups(des.basis, des.strata)) == 5
    xp = torch.from_numpy(x)
    from repro_torch.core.distance import ROW_METRICS
    rows = ROW_METRICS["braycurtis"].rows
    a, s_t, stats = streaming.fused_sw_design(xp, rows, des, 25,
                                              row_block=7, chunk=25)
    b, _, _ = streaming.fused_sw_design(xp, rows, des, 25, row_block=11,
                                        chunk=6)
    assert (stats.n_row_blocks, stats.n_chunks) == (5, 1)
    torch.testing.assert_close(a, b, rtol=COLS_RTOL, atol=COLS_ATOL)
    c, s_t2, kst = streaming.fused_kernel_sw_design(
        xp, rows, des, 25, impl="cuda", kernel_metric="braycurtis",
        row_block=9, chunk=10)
    d, _, dst = streaming.fused_kernel_sw_design(
        xp, rows, des, 25, impl="torch", kernel_metric="braycurtis",
        row_block=9, chunk=10)
    assert (kst.impl, kst.n_chunks, kst.row_block) == ("cuda", 3, fops.TILE)
    assert (dst.impl, dst.n_chunks, dst.row_block) == ("torch", 3, 9)
    torch.testing.assert_close(c, a, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(d, a, rtol=1e-5, atol=1e-6)
    assert float(s_t2) == pytest.approx(float(s_t), rel=1e-6)
    with pytest.raises(ValueError, match="fused-kernel impl"):
        streaming.fused_kernel_sw_design(xp, rows, des, 5, impl="pallas",
                                         kernel_metric="braycurtis",
                                         row_block=9, chunk=5)


def test_pipeline_design_rejects_what_it_cannot_run():
    x, labels, cov, strata, _ = _study(20, d=6, seed=2)
    xt = torch.from_numpy(x)
    des = design.build(grouping=labels, covariates=cov, n_groups=G,
                       device="cpu")
    with pytest.raises(ValueError, match="plain single-factor") as port:
        pipeline.pipeline(xt, des, n_perms=3, mesh=object(), device="cpu")
    with pytest.raises(ValueError) as ref:      # the reference's refusal
        jpipe.pipeline(jnp.asarray(x), jnp.asarray(labels), n_perms=3,
                       covariates=cov, mesh=object())
    assert str(port.value) == str(ref.value)
    with pytest.raises(ValueError, match="not both"):
        pipeline.pipeline(xt, des, n_perms=3, strata=strata, device="cpu")
    with pytest.raises(ValueError, match="design is for"):
        pipeline.pipeline(xt[:12], des, n_perms=3, device="cpu")
    with pytest.raises(ValueError, match="index_perms"):
        pipeline.pipeline(xt, labels, n_perms=3, covariates=cov,
                          perms=torch.zeros((4, 20), dtype=torch.int32),
                          device="cpu")
    with pytest.raises(ValueError, match="grouping labels"):
        pipeline.pipeline(xt, None, n_perms=3, device="cpu")


def test_prebuilt_design_and_covariates_only_run_in_pipeline():
    x, labels, cov, strata, w = _study(26, d=7, seed=6)
    xt = torch.from_numpy(x)
    des = design.build(grouping=labels, covariates=cov, weights=w,
                       n_groups=G, device="cpu")
    a = pipeline.pipeline(xt, des, n_perms=9, seed=1, device="cpu")
    b = pipeline.pipeline(xt, labels, n_perms=9, seed=1, covariates=cov,
                          weights=w, n_groups=G, device="cpu")
    assert torch.equal(a.f_perms, b.f_perms) and a.plan == b.plan
    assert "[weighted]" in a.plan
    c = pipeline.pipeline(xt, None, n_perms=9, seed=1, covariates=cov,
                          device="cpu")
    assert [t.name for t in c.terms] == ["cov0", "cov1"]
    assert c.n_groups == 3          # the rank when there is no factor


# ---------------------------------------------------------------------------
# Data and CLI.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(), dict(n_strata=4, weighted=True),
    dict(covariate_names=("a",), n_strata=1, seed=3)])
def test_synthetic_design_same_draws(kw):
    got = microbiome.synthetic_design(50, **kw)
    want = jmicro.synthetic_design(50, **kw)
    for g, w in zip(got, want):
        if w is None:
            assert g is None
        elif isinstance(w, dict):
            assert list(g) == list(w)
            for k in w:
                np.testing.assert_array_equal(g[k], w[k])
        else:
            np.testing.assert_array_equal(g, w)


def test_cli_design_flags_run_on_cpu(capsys):
    assert cli.main(["--from-features", "--covariates", "age,depth",
                     "--strata", "site:4", "--weights", "--device", "cpu",
                     "--samples", "96", "--perms", "49"]) == 0
    out = capsys.readouterr().out
    assert "plan: " in out and "design[dense] ~ age(1)+depth(1)+grouping(7)"\
        " [strata,weighted]" in out
    rows = [line.split() for line in out.splitlines()
            if line.startswith("[permanova] ") and line.split()[1] in
            ("age", "depth", "grouping")]
    assert [r[1] for r in rows] == ["age", "depth", "grouping"]
    assert [int(r[2]) for r in rows] == [1, 1, 7]
    assert all(0.0 < float(r[6]) <= 1.0 for r in rows)


def test_cli_design_observed_f_matches_reference():
    """The port's CLI and the reference's draw different permutations but
    the same study and design: the observed per-term F agree (rtol
    1e-4)."""
    x, grouping = jmicro.synthetic_study(80, 16, 3, effect_size=1.0, seed=2)
    cov, strata, _ = jmicro.synthetic_design(80, n_strata=3, seed=2)
    ref = jpipe.pipeline(jnp.asarray(x), jnp.asarray(grouping), n_perms=9,
                         covariates=cov, strata=strata,
                         key=jax.random.key(2))
    got = pipeline.pipeline(torch.from_numpy(x), grouping, n_perms=9, seed=2,
                            covariates=cov, strata=strata, device="cpu")
    np.testing.assert_allclose([float(t.f_stat) for t in got.terms],
                               [float(t.f_stat) for t in ref.terms],
                               rtol=1e-4)
