"""The port's PCoA ordination against a float64 eigh oracle and against
the reference's own results: every path and metric, the start block the
reference draws fed through v0= / probe=, trace == s_T, every bridge,
designs, many-study batches (stacked, study views, ragged pad rows exactly
zero), ordination off by default, and --pcoa on the CLI."""

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
from repro.core import distance as jdist  # noqa: E402
from repro.pipeline import ordination as jordn  # noqa: E402
from repro_torch import engine, pipeline  # noqa: E402
from repro_torch.core import distance  # noqa: E402
from repro_torch.launch import permanova as cli  # noqa: E402
from repro_torch.pipeline import ordination as ordn  # noqa: E402

N, D, G, K = 37, 12, 4, 3
METRICS = ("euclidean", "braycurtis", "jaccard", "aitchison")
RTOL = 2e-4          # the reference's bar (tests/test_ordination.py:40)


def _study(seed=3, n=N, d=D, g=G):
    rng = np.random.default_rng(seed)
    x = rng.gamma(1.0, 1.0, size=(n, d)).astype(np.float32)
    x *= rng.random(size=(n, d)) < 0.6
    x[:, 0] = np.maximum(x[:, 0], 1e-3)
    grouping = rng.integers(0, g, size=n).astype(np.int32)
    grouping[:g] = np.arange(g)
    return x, grouping


def _mat2(x, metric):
    """(prepared table, rows fn, mat2 f32 numpy) from the port's own
    distances, the diagonal exactly zero."""
    mdef = distance.ROW_METRICS[metric]
    xp = mdef.prepare(torch.from_numpy(x))
    dmat = mdef.rows(xp, xp).numpy().copy()
    np.fill_diagonal(dmat, 0.0)
    return xp, mdef.rows, (dmat * dmat).astype(np.float32)


def _oracle(mat2, k):
    """Dense float64 Gower centering + eigh."""
    n = mat2.shape[0]
    m = np.asarray(mat2, np.float64)
    j = np.eye(n) - np.ones((n, n)) / n
    g = -0.5 * j @ m @ j
    w, v = np.linalg.eigh(g)
    order = np.argsort(-w)[:k]
    wk, vk = w[order], v[:, order]
    return wk, vk * np.sqrt(np.maximum(wk, 0.0)), np.trace(g)


def _aligned(c, ref):
    sgn = np.sign(np.sum(c * ref, axis=0))
    sgn[sgn == 0] = 1.0
    return c * sgn


def _assert_matches(res, wk, coords_ref, s_t, *, rtol=RTOL):
    scale = np.abs(wk).max()
    np.testing.assert_allclose(res.eigvals.numpy(), wk, rtol=rtol,
                               atol=rtol * scale)
    c = res.coords.numpy()
    np.testing.assert_allclose(_aligned(c, coords_ref), coords_ref,
                               rtol=rtol,
                               atol=rtol * np.abs(coords_ref).max())
    np.testing.assert_allclose(res.explained.numpy(), wk / s_t, rtol=1e-3,
                               atol=1e-5)


def _assert_same(res, ref, *, rtol=RTOL):
    """The port's result against the reference's on the same inputs."""
    _assert_matches(res, np.asarray(ref.eigvals), np.asarray(ref.coords),
                    float(np.asarray(ref.eigvals)[0]
                          / np.asarray(ref.explained)[0]), rtol=rtol)


def _ref_start(n, k, oversample=ordn.DEFAULT_OVERSAMPLE):
    """The reference's own start block and probe (subspace_eigs with its
    default key(0)) as tensors."""
    key = jax.random.key(0)
    p = int(min(n, k + oversample))
    v0 = jax.random.normal(jax.random.fold_in(key, 0), (n, p), jnp.float32)
    probe = jax.random.normal(jax.random.fold_in(key, 1), (n, 1),
                              jnp.float32)
    return torch.from_numpy(np.array(v0)), torch.from_numpy(np.array(probe))


@pytest.mark.parametrize("metric", METRICS)
def test_every_path_matches_the_fp64_oracle(metric):
    x, _ = _study()
    xp, rows, mat2 = _mat2(x, metric)
    wk, coords_ref, s_t = _oracle(mat2, K)
    m2 = torch.from_numpy(mat2)
    for res, method in ((ordn.pcoa_eigh(m2, K), "eigh"),
                        (ordn.pcoa_subspace(m2, K), "subspace"),
                        (ordn.pcoa_features(xp, rows, K, row_block=13),
                         "subspace-stream")):
        assert res.method == method and res.k == K
        _assert_matches(res, wk, coords_ref, s_t)
    assert ordn.pcoa_eigh(m2, K).iterations is None


@pytest.mark.parametrize("metric", METRICS)
def test_every_path_matches_the_reference(metric):
    """The same mat2 (and table) through the reference's paths and the
    port's, the port fed the reference's start block and probe."""
    x, _ = _study(seed=4)
    xp, rows, mat2 = _mat2(x, metric)
    jm2 = jnp.asarray(mat2)
    v0, probe = _ref_start(N, K)
    m2 = torch.from_numpy(mat2)
    _assert_same(ordn.pcoa_eigh(m2, K), jordn.pcoa_eigh(jm2, K))
    _assert_same(ordn.pcoa_subspace(m2, K, v0=v0, probe=probe),
                 jordn.pcoa_subspace(jm2, K))
    jdef = jdist.ROW_METRICS[metric]
    jxp = jdef.prepare(jnp.asarray(x))
    _assert_same(ordn.pcoa_features(xp, rows, K, row_block=13, v0=v0,
                                    probe=probe),
                 jordn.pcoa_features(jxp, jdef.rows, K, row_block=13))


def test_start_block_is_the_seeds_and_explicit_blocks_are_checked():
    v0, probe = ordn.start_block(N, K + 8, seed=5)
    v0b, probeb = ordn.start_block(N, K + 8, seed=5)
    assert torch.equal(v0, v0b) and torch.equal(probe, probeb)
    assert not torch.equal(v0, ordn.start_block(N, K + 8, seed=6)[0])
    x, _ = _study()
    m2 = torch.from_numpy(_mat2(x, "euclidean")[2])
    a = ordn.pcoa_subspace(m2, K, seed=5)
    b = ordn.pcoa_subspace(m2, K, v0=v0, probe=probe)
    assert torch.equal(a.coords, b.coords)
    with pytest.raises(ValueError, match="v0 must be"):
        ordn.pcoa_subspace(m2, K, v0=v0[:, :3], probe=probe)


def test_iterations_are_recorded_and_capped():
    x, _ = _study()
    m2 = torch.from_numpy(_mat2(x, "braycurtis")[2])
    capped = ordn.pcoa_subspace(m2, K, iters=5)
    assert capped.iterations == 5
    loose = ordn.pcoa_subspace(m2, K, iters=ordn.DEFAULT_ITERS)
    assert 1 <= loose.iterations <= ordn.DEFAULT_ITERS
    gv = ordn.centered_matvec(lambda v: m2 @ v, m2.sum(1), m2.sum(), N)
    _, _, early = ordn.subspace_eigs(gv, N, K, tol=1e-2)
    assert early < ordn.DEFAULT_ITERS


def test_trace_is_s_total():
    """trace(G) == s_T: explained variance is the fraction of the
    PERMANOVA total sum of squares."""
    x, grouping = _study(seed=5)
    for bridge in ("dense", "stream", "fused", "fused-kernel"):
        res = pipeline.pipeline(x, grouping, n_groups=G, n_perms=9,
                                materialize=bridge, ordination=K,
                                device="cpu")
        total = (res.ordination.eigvals / res.ordination.explained).numpy()
        np.testing.assert_allclose(total, float(res.s_t), rtol=1e-4)


def test_every_bridge_agrees_and_matches_the_reference():
    """pipeline(..., ordination=k) on all four bridges gives the embedding
    of the oracle; the stream / fused ones never build a second (n, n)
    array. The reference's pipeline on the same features agrees."""
    x, grouping = _study(seed=7)
    _, _, mat2 = _mat2(x, "braycurtis")
    wk, coords_ref, s_t = _oracle(mat2, K)
    methods = {"dense": "eigh", "stream": "subspace",
               "fused": "subspace-stream", "fused-kernel": "subspace-stream"}
    for bridge, method in methods.items():
        res = pipeline.pipeline(x, grouping, n_groups=G, n_perms=9,
                                materialize=bridge, ordination=K,
                                device="cpu")
        assert res.ordination.method == method
        assert res.ordination.coords.shape == (N, K)
        _assert_matches(res.ordination, wk, coords_ref, s_t)
        ref = jpipe.pipeline(jnp.asarray(x), jnp.asarray(grouping),
                             n_groups=G, n_perms=9, materialize=bridge,
                             ordination=K)
        _assert_same(res.ordination, ref.ordination, rtol=2e-3)


@pytest.mark.parametrize("bridge", ["dense", "stream", "fused-kernel"])
def test_design_paths_carry_the_ordination(bridge):
    """A design (covariates within strata) leaves the embedding as it is:
    it depends on the distances alone."""
    x, grouping = _study(seed=8)
    _, _, mat2 = _mat2(x, "braycurtis")
    wk, coords_ref, s_t = _oracle(mat2, K)
    cov = np.random.default_rng(2).normal(size=(N, 1))
    strata = (np.arange(N) % 3).astype(np.int32)
    res = pipeline.pipeline(x, grouping, n_groups=G, n_perms=9,
                            materialize=bridge, ordination=K, covariates=cov,
                            strata=strata, device="cpu")
    assert res.terms is not None
    _assert_matches(res.ordination, wk, coords_ref, s_t)


def test_off_by_default():
    x, grouping = _study()
    assert pipeline.pipeline(x, grouping, n_groups=G, n_perms=9,
                             device="cpu").ordination is None
    dm = torch.from_numpy(np.sqrt(_mat2(x, "euclidean")[2]))
    assert engine.permanova_many(dm[None], grouping[None], n_groups=G,
                                 n_perms=9, device="cpu").ordination is None


def test_pipeline_many_fused_matches_dense():
    x0, g0 = _study(seed=11, n=32)
    x1, g1 = _study(seed=12, n=32)
    xs, gs = np.stack([x0, x1]), np.stack([g0, g1])
    md = pipeline.pipeline_many(xs, gs, n_groups=G, n_perms=9,
                                materialize="dense", ordination=2,
                                device="cpu")
    mf = pipeline.pipeline_many(xs, gs, n_groups=G, n_perms=9,
                                materialize="fused-kernel", ordination=2,
                                device="cpu")
    assert md.ordination.coords.shape == (2, 32, 2)
    assert mf.ordination.method == "subspace-stream"
    assert len(mf.ordination.iterations) == 2
    np.testing.assert_allclose(mf.ordination.coords.abs().numpy(),
                               md.ordination.coords.abs().numpy(),
                               rtol=2e-3, atol=1e-4)
    np.testing.assert_allclose(mf.ordination.eigvals.numpy(),
                               md.ordination.eigvals.numpy(), rtol=1e-3)
    for s, x in enumerate((x0, x1)):
        wk, coords_ref, s_t = _oracle(_mat2(x, "braycurtis")[2], 2)
        _assert_matches(mf.ordination.study(s), wk, coords_ref, s_t)
        assert mf.study(s).ordination.k == 2


def test_stacked_and_study_view():
    x0, g0 = _study(seed=21, n=24)
    _, _, mat2 = _mat2(x0, "braycurtis")
    dmat = np.sqrt(mat2)
    dms = np.stack([dmat, dmat])
    gs = np.stack([g0, g0])
    many = engine.permanova_many(dms, gs, n_groups=G, n_perms=9,
                                 ordination=2, device="cpu")
    wk, coords_ref, s_t = _oracle(mat2, 2)
    _assert_matches(many.ordination.study(0), wk, coords_ref, s_t,
                    rtol=5e-4)
    one = many.study(1)
    assert one.ordination is not None and one.ordination.k == 2
    np.testing.assert_allclose(many.r2.numpy(),
                               1.0 - (many.s_w / many.s_t).numpy(),
                               rtol=1e-6)
    ref = jengine.permanova_many(jnp.asarray(dms), jnp.asarray(gs),
                                 n_groups=G, n_perms=9, ordination=2)
    v0, probe = _ref_start(24, 2)
    mine = ordn.pcoa_many(torch.from_numpy(dms), 2, v0=v0, probe=probe)
    for s in range(2):
        _assert_same(mine.study(s), ref.ordination.study(s))


def test_ragged_pad_coords_zero():
    """Each ragged study runs unpadded at its own n_s and is zero-filled
    to the batch width: pad rows exactly zero, the valid block the
    oracle's and the reference's masked batch's (fed its start block)."""
    sizes = (14, 23, 17)
    n_pad = 32
    dms, gs = [], []
    for i, m in enumerate(sizes):
        x, g = _study(seed=30 + i, n=m)
        dms.append(np.sqrt(_mat2(x, "euclidean")[2]))
        gs.append(g)
    many = engine.permanova_many(dms, gs, n_groups=G, n_perms=9,
                                 ordination=2, n_pad=n_pad, device="cpu")
    coords = many.ordination.coords.numpy()
    assert coords.shape == (3, n_pad, 2)
    ref = jengine.permanova_many(dms, gs, n_groups=G, n_perms=9,
                                 ordination=2, n_pad=n_pad)
    v0, probe = _ref_start(n_pad, 2)
    mine = ordn.pcoa_many([torch.from_numpy(d) for d in dms], 2,
                          n_pad=n_pad, v0=v0, probe=probe)
    for s, m in enumerate(sizes):
        assert np.all(coords[s, m:] == 0.0), s
        wk, coords_ref, s_t = _oracle(dms[s] * dms[s], 2)
        res_s = many.ordination.study(s)
        valid = ordn.PCoAResult(coords=res_s.coords[:m],
                                eigvals=res_s.eigvals,
                                explained=res_s.explained,
                                method=res_s.method)
        _assert_matches(valid, wk, coords_ref, s_t, rtol=1e-3)
        r = ref.ordination.study(s)
        _assert_same(mine.study(s), jordn.PCoAResult(
            coords=r.coords, eigvals=r.eigvals, explained=r.explained,
            method=r.method), rtol=1e-3)
        assert np.all(mine.coords[s, m:].numpy() == 0.0)


def test_many_design_batch_carries_the_ordination():
    sizes = (20, 26)
    dms, gs, covs = [], [], []
    for i, m in enumerate(sizes):
        x, g = _study(seed=40 + i, n=m)
        dms.append(np.sqrt(_mat2(x, "braycurtis")[2]))
        gs.append(g)
        covs.append(np.random.default_rng(i).normal(size=(m, 1)))
    many = engine.permanova_many(dms, gs, n_groups=G, n_perms=9,
                                 covariates=covs, ordination=2,
                                 device="cpu")
    assert many.terms is not None
    for s, m in enumerate(sizes):
        wk, coords_ref, s_t = _oracle(dms[s] * dms[s], 2)
        res = many.study(s).ordination
        assert np.all(res.coords[m:].numpy() == 0.0)
        _assert_matches(ordn.PCoAResult(
            coords=res.coords[:m], eigvals=res.eigvals,
            explained=res.explained, method=res.method), wk, coords_ref,
            s_t, rtol=1e-3)


def test_cli_pcoa(capsys):
    assert cli.main(["--samples", "48", "--perms", "19", "--device", "cpu",
                     "--pcoa", "2"]) == 0
    out = capsys.readouterr().out
    assert "pipeline device=cpu" in out
    assert "[permanova] pcoa[eigh] k=2 explained=[" in out
    assert "coords=(48, 2)" in out
    assert cli.main(["--samples", "48", "--perms", "19", "--device", "cpu",
                     "--pcoa", "2", "--materialize", "stream"]) == 0
    assert "pcoa[subspace] k=2" in capsys.readouterr().out
