"""The port's many-study runs (engine.permanova_many, pipeline.pipeline_many)
against the reference's on the same numpy inputs, fed the reference's own
per-study draws (fold_in(key, s); the masked draws for ragged studies; the
strata index permutations for designs): F at rtol 1e-4 with p equal. Then
the port's own identities, bit for bit: stacked study s equals a
single-study run with seed=study_seed(seed, s), a padded study its
unpadded run, and the masked draws' valid prefix the unpadded draws. On
the card `chip_smoke.py` runs the same forms at the EMP shape."""

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
from repro.core import permutations as jperm  # noqa: E402
from repro_torch import engine, pipeline  # noqa: E402
from repro_torch.core import design, permutations  # noqa: E402

G = 3
N_PERMS = 29
N_TOTAL = N_PERMS + 1
F_RTOL = 1e-4          # the repo's bar: F at rtol 1e-4, p equal
SIZES = (24, 37, 31)   # a ragged batch
N_PAD = 48


def _features(n, seed, d=10):
    rng = np.random.default_rng(seed)
    x = rng.gamma(1.0, 1.0, size=(n, d)).astype(np.float32)
    x[rng.random((n, d)) < 0.4] = 0.0
    x[:, 0] = np.maximum(x[:, 0], 1e-3)
    g = rng.integers(0, G, size=n).astype(np.int32)
    g[:G] = np.arange(G)
    x[g == 1, 1] += 2.0                      # a planted effect
    return x, g


def _dm(x):
    """A Bray-Curtis matrix in float64 -> f32, the same for both packages."""
    num = np.abs(x[:, None, :] - x[None, :, :]).sum(-1, dtype=np.float64)
    den = (x.sum(1)[:, None] + x.sum(1)[None, :]).astype(np.float64)
    d = (num / np.maximum(den, 1e-30)).astype(np.float32)
    np.fill_diagonal(d, 0.0)
    return d


def _ragged():
    studies = [_features(n, 10 + i) for i, n in enumerate(SIZES)]
    return ([_dm(x) for x, _ in studies], [g for _, g in studies],
            [x for x, _ in studies])


def _stacked(n=32, s_count=3):
    studies = [_features(n, 20 + i) for i in range(s_count)]
    xs = np.stack([x for x, _ in studies])
    gs = np.stack([g for _, g in studies])
    return np.stack([_dm(x) for x in xs]), gs, xs


def _covariates(sizes, seed=3):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(m, 2)) for m in sizes]


def _strata(sizes):
    return [(np.arange(m) % 3).astype(np.int32) for m in sizes]


KEY = jax.random.key(4)


def _study_key(s):
    return jax.random.fold_in(KEY, s)


def _ref_labels(gs):
    """The reference's stacked draws: study s's permutation_batch from
    fold_in(key, s), (S, n_total, n)."""
    return torch.from_numpy(np.stack([np.asarray(jperm.permutation_batch(
        _study_key(s), jnp.asarray(g), 0, N_TOTAL))
        for s, g in enumerate(gs)]))


def _ref_masked_labels(groupings, n_pad):
    """The reference's ragged draws: its masked generator over each
    sentinel-padded study, (S, n_total, n_pad)."""
    out = []
    for s, g in enumerate(groupings):
        gp = np.full(n_pad, G, np.int32)
        gp[:len(g)] = g
        out.append(np.asarray(jperm.masked_permutation_batch_dyn(
            _study_key(s), jnp.asarray(gp), len(g), 0, N_TOTAL)))
    return torch.from_numpy(np.stack(out))


def _ref_index_perms(strata, sizes, n_pad):
    """The reference's design draws: strata index permutations of each
    padded study within its masked strata (zeros for free draws)."""
    out = []
    for s, m in enumerate(sizes):
        st = np.zeros(n_pad, np.int32)
        if strata is not None:
            st[:m] = strata[s]
        st = jperm.masked_strata(jnp.asarray(st), m)
        out.append(np.asarray(jperm.strata_permutation_batch(
            _study_key(s), st, 0, N_TOTAL)))
    return torch.from_numpy(np.stack(out))


def _assert_many(res_t, res_j):
    np.testing.assert_allclose(res_t.f_stat.numpy(),
                               np.asarray(res_j.f_stat), rtol=F_RTOL)
    assert res_t.p_value.tolist() == pytest.approx(
        np.asarray(res_j.p_value).tolist(), abs=0)
    np.testing.assert_allclose(res_t.f_perms.numpy(),
                               np.asarray(res_j.f_perms), rtol=F_RTOL)
    assert len(res_t) == len(res_j)


def _assert_many_terms(res_t, res_j):
    assert [t.name for t in res_t.terms] == [t.name for t in res_j.terms]
    for tt, tj in zip(res_t.terms, res_j.terms):
        np.testing.assert_allclose(tt.f_stat.numpy(), np.asarray(tj.f_stat),
                                   rtol=F_RTOL)
        assert tt.p_value.tolist() == np.asarray(tj.p_value).tolist()
    _assert_many(res_t, res_j)


# ---------------------------------------------------------------------------
# Seeds and masked draws.
# ---------------------------------------------------------------------------

def test_study_seed_is_a_counter_hash_of_seed_and_study():
    seeds = [permutations.study_seed(7, s) for s in range(64)]
    assert len(set(seeds)) == 64
    assert all(0 <= v < 2 ** 32 for v in seeds)
    assert seeds == [permutations.study_seed(7, s) for s in range(64)]
    assert permutations.study_seed(8, 0) != seeds[0]
    # the seed folds its two 32-bit halves, as permutation_keys does
    assert permutations.study_seed(2 ** 32 + 3, 1) == \
        permutations.study_seed(2 ** 32 + 3, 1)


@pytest.mark.parametrize("block_rows", [None, 1, 5])
def test_masked_draws_are_the_unpadded_draws_bit_for_bit(block_rows):
    """The masked generator keys the valid prefix with the unpadded
    study's keys: its prefix is permutation_batch on the prefix, for any
    sub-block size, and the sentinel pad stays in place; the masked strata
    draw (pads in their own stratum) has the unpadded strata draw as its
    prefix and maps pads among themselves."""
    g = torch.from_numpy(_features(37, 1)[1])
    pad = torch.full((11,), G, dtype=torch.int32)
    gp = torch.cat([g, pad])
    got = permutations.masked_permutation_batch(gp, 37, 3, 19, seed=5,
                                                block_rows=block_rows)
    want = permutations.permutation_batch(g, 3, 19, seed=5)
    assert torch.equal(got[:, :37], want)
    assert bool((got[:, 37:] == G).all())
    first = permutations.masked_permutation_batch(gp, 37, 0, 2, seed=5)
    assert torch.equal(first[0], gp)
    strata = torch.from_numpy(_strata([37])[0])
    sp = permutations.masked_strata(torch.cat([strata, torch.zeros(
        11, dtype=torch.int32)]), 37)
    idx = permutations.strata_permutation_batch(sp, 0, 9, seed=5,
                                                block_rows=block_rows)
    assert torch.equal(idx[:, :37], permutations.strata_permutation_batch(
        strata, 0, 9, seed=5))
    assert bool((idx[:, 37:] >= 37).all())


def test_masked_permute_grouping_permutes_the_prefix_only():
    g = torch.from_numpy(_features(30, 2)[1])
    gp = torch.cat([g, torch.full((6,), G, dtype=torch.int32)])
    one = permutations.masked_permute_grouping(gp, 30, 4, seed=9)
    assert torch.equal(one, permutations.masked_permutation_batch(
        gp, 30, 4, 5, seed=9)[0])
    assert sorted(one[:30].tolist()) == sorted(g.tolist())
    assert one[30:].tolist() == [G] * 6
    # index 0 is a draw too (the batch puts the identity there)
    assert not torch.equal(permutations.masked_permute_grouping(
        gp, 30, 0, seed=9), gp)


# ---------------------------------------------------------------------------
# engine.permanova_many against the reference.
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _ref_engine(form):
    if form == "stacked":
        dms, gs, _ = _stacked()
        return jengine.permanova_many(jnp.asarray(dms), jnp.asarray(gs),
                                      n_groups=G, n_perms=N_PERMS, key=KEY)
    dms, gs, _ = _ragged()
    kw = dict(n_pad=N_PAD) if form == "ragged" else {}
    if form == "design_stacked":
        dms, gs, _ = _stacked()
        return jengine.permanova_many(
            jnp.asarray(dms), jnp.asarray(gs), n_groups=G, n_perms=N_PERMS,
            key=KEY, covariates=np.stack(_covariates([32] * 3)),
            strata=np.stack(_strata([32] * 3)))
    if form == "design_ragged":
        return jengine.permanova_many(
            dms, gs, n_groups=G, n_perms=N_PERMS, key=KEY, n_pad=N_PAD,
            covariates=_covariates(SIZES), weights=[
                np.linspace(0.5, 1.5, m) for m in SIZES])
    return jengine.permanova_many(dms, gs, n_groups=G, n_perms=N_PERMS,
                                  key=KEY, **kw)


def test_permanova_many_stacked_matches_the_reference():
    dms, gs, _ = _stacked()
    res = engine.permanova_many(dms, gs, n_groups=G, n_perms=N_PERMS,
                                perms=_ref_labels(gs), device="cpu")
    _assert_many(res, _ref_engine("stacked"))
    assert res.n_valid is None and res.n_objects == 32
    assert "studies=3" in res.plan and "[in turn]" in res.plan


def test_permanova_many_ragged_matches_the_reference():
    """A ragged list with n_pad = 48 (the reference pads to it, the port
    runs each study on its own matrix): F, p and the null per study
    against the reference's masked run, fed the valid prefix of its
    masked draws; per-study dof and s_T from the true n_s."""
    dms, gs, _ = _ragged()
    res = engine.permanova_many(dms, gs, n_groups=G, n_perms=N_PERMS,
                                n_pad=N_PAD, device="cpu",
                                perms=_ref_masked_labels(gs, N_PAD))
    ref = _ref_engine("ragged")
    _assert_many(res, ref)
    assert res.n_valid.tolist() == list(SIZES) and res.n_objects == N_PAD
    np.testing.assert_allclose(res.s_t.numpy(), np.asarray(ref.s_t),
                               rtol=1e-5)
    np.testing.assert_allclose(res.r2.numpy(), np.asarray(ref.r2),
                               rtol=1e-4)


@pytest.mark.parametrize("form", ["design_stacked", "design_ragged"])
def test_permanova_many_designs_match_the_reference(form):
    """Covariates within strata (stacked) and covariates with weights
    (ragged, n_pad): every study compiles to the dense design; per-term F
    and p against the reference's batch on its own index permutations."""
    if form == "design_stacked":
        dms, gs, _ = _stacked()
        cov, st = np.stack(_covariates([32] * 3)), np.stack(_strata([32] * 3))
        res = engine.permanova_many(
            dms, gs, n_groups=G, n_perms=N_PERMS, covariates=cov, strata=st,
            index_perms=_ref_index_perms(st, [32] * 3, 32), device="cpu")
    else:
        dms, gs, _ = _ragged()
        res = engine.permanova_many(
            dms, gs, n_groups=G, n_perms=N_PERMS, n_pad=N_PAD,
            covariates=_covariates(SIZES),
            weights=[np.linspace(0.5, 1.5, m) for m in SIZES],
            index_perms=_ref_index_perms(None, SIZES, N_PAD), device="cpu")
    _assert_many_terms(res, _ref_engine(form))
    assert [t.name for t in res.terms][-1] == "grouping"


# ---------------------------------------------------------------------------
# pipeline.pipeline_many against the reference.
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _ref_pipeline(materialize, designed):
    _, gs, xs = _stacked()
    kw = {}
    if designed:
        kw = dict(covariates=np.stack(_covariates([32] * 3)))
    return jpipe.pipeline_many(jnp.asarray(xs), jnp.asarray(gs), n_groups=G,
                               n_perms=N_PERMS, key=KEY,
                               materialize=materialize, **kw)


@pytest.mark.parametrize("materialize,fused_impl,designed", [
    ("dense", "auto", False), ("fused-kernel", "torch", False),
    ("fused-kernel", "cuda", False), ("dense", "auto", True),
    ("fused-kernel", "torch", True), ("fused-kernel", "cuda", True)])
def test_pipeline_many_matches_the_reference(materialize, fused_impl,
                                             designed):
    """Features of 3 stacked studies -> F and p through the dense bridge
    and the fused-kernel bridge (its plain torch sweep and the megakernel
    sweep's plain version), labels and a covariate design, against the
    reference's pipeline_many on its own per-study draws."""
    _, gs, xs = _stacked()
    kw = dict(n_groups=G, n_perms=N_PERMS, materialize=materialize,
              fused_impl=fused_impl, device="cpu")
    if designed:
        cov = np.stack(_covariates([32] * 3))
        res = pipeline.pipeline_many(
            xs, gs, covariates=cov,
            index_perms=_ref_index_perms(None, [32] * 3, 32), **kw)
        _assert_many_terms(res, _ref_pipeline(materialize, True))
    else:
        res = pipeline.pipeline_many(xs, gs, perms=_ref_labels(gs), **kw)
        _assert_many(res, _ref_pipeline(materialize, False))
    if materialize == "fused-kernel":
        assert f"braycurtis.fusedk.{fused_impl}[" in res.plan
        assert res.plan.endswith("studies=3 [in turn]")


def test_pipeline_many_auto_picks_the_bridge_by_the_stack():
    """'auto' builds the distance stack only when it fits the matrix
    budget; past it, the fused-kernel bridge (as the reference's)."""
    _, gs, xs = _stacked()
    kw = dict(n_groups=G, n_perms=9, device="cpu")
    assert "dense(per study)" in pipeline.pipeline_many(xs, gs, **kw).plan
    small = pipeline.pipeline_many(xs, gs, matrix_budget_bytes=4 * 32 * 32,
                                   **kw)
    assert "fused-kernel(rows=" in small.plan
    with pytest.warns(UserWarning, match="exceeding the matrix budget"):
        pipeline.pipeline_many(xs, gs, materialize="dense",
                               matrix_budget_bytes=4 * 32 * 32, **kw)


# ---------------------------------------------------------------------------
# The port's own identities, bit for bit.
# ---------------------------------------------------------------------------

def test_stacked_study_equals_its_single_study_run():
    """Study s of a stacked batch draws from study_seed(seed, s): its F
    null and p equal engine.run / run_design / pipeline() of that study
    alone with that seed at the same plan, bit for bit."""
    dms, gs, xs = _stacked()
    budget = 256 * 2 ** 20 / 3       # a cpu batch plans each study at 1/S
    res = engine.permanova_many(dms, gs, n_groups=G, n_perms=N_PERMS,
                                seed=11, device="cpu")
    cov = np.stack(_covariates([32] * 3))
    des = engine.permanova_many(dms, gs, n_groups=G, n_perms=N_PERMS,
                                seed=11, covariates=cov, device="cpu")
    pipe = pipeline.pipeline_many(xs, gs, n_groups=G, n_perms=N_PERMS,
                                  seed=11, materialize="fused-kernel",
                                  fused_impl="cuda", device="cpu")
    for s in range(3):
        seed_s = permutations.study_seed(11, s)
        one = engine.run(dms[s], gs[s], n_perms=N_PERMS, seed=seed_s,
                         memory_budget_bytes=budget, device="cpu")
        assert torch.equal(res.f_perms[s], one.f_perms)
        assert float(res.p_value[s]) == float(one.p_value)
        d = design.build(grouping=gs[s], covariates=cov[s], n_groups=G,
                         force_dense=True, device="cpu")
        one = engine.run_design(dms[s], d, n_perms=N_PERMS, seed=seed_s,
                                memory_budget_bytes=budget, device="cpu")
        for t_many, t_one in zip(des.terms, one.terms):
            assert torch.equal(t_many.f_perms[s], t_one.f_perms)
        one = pipeline.pipeline(xs[s], gs[s], n_perms=N_PERMS, seed=seed_s,
                                materialize="fused-kernel",
                                fused_impl="cuda", memory_budget_bytes=budget,
                                device="cpu")
        assert torch.equal(pipe.f_perms[s], one.f_perms)
        assert float(pipe.p_value[s]) == float(one.p_value)


@pytest.mark.parametrize("designed", [False, True])
def test_padded_study_equals_its_unpadded_run(designed):
    """A ragged batch at two recorded widths (the largest study, and n_pad
    = 48) and each study alone: the same F null and p bit for bit (at
    one chunk), labels and a covariate-within-strata design. The port
    runs each ragged study unpadded, so this holds by construction; the
    masked draws' own identity is held above."""
    dms, gs, _ = _ragged()
    kw = dict(n_groups=G, n_perms=N_PERMS, seed=3, chunk=11, device="cpu")
    if designed:
        kw.update(covariates=_covariates(SIZES), strata=_strata(SIZES))
    runs = [engine.permanova_many(dms, gs, **kw),
            engine.permanova_many(dms, gs, n_pad=N_PAD, **kw)]
    assert [r.n_objects for r in runs] == [max(SIZES), N_PAD]
    for s in range(len(SIZES)):
        seed_s = permutations.study_seed(3, s)
        if designed:
            d = design.build(grouping=gs[s], covariates=kw["covariates"][s],
                             strata=kw["strata"][s], n_groups=G,
                             force_dense=True, device="cpu")
            one = engine.run_design(dms[s], d, n_perms=N_PERMS, seed=seed_s,
                                    chunk=11, device="cpu")
        else:
            one = engine.run(dms[s], gs[s], n_perms=N_PERMS, seed=seed_s,
                             chunk=11, device="cpu")
        for r in runs:
            assert torch.equal(r.f_perms[s], one.f_perms)
            assert float(r.p_value[s]) == float(one.p_value)
            assert r.study(s).n_objects == SIZES[s]


def test_ragged_studies_run_on_their_own_operands():
    """A ragged batch is not padded on the port: each study keeps its own
    (n_s, n_s) matrix and labels, n_pad is checked and recorded, and
    explicit per-study draws of width n_pad are cut to each study's
    first n_s columns."""
    dms, gs, _ = _ragged()
    mats, labels, n_valid, n = engine.api._ragged_studies(dms, gs, N_PAD)
    assert n == N_PAD and n_valid.tolist() == list(SIZES)
    assert [tuple(m.shape) for m in mats] == [(m, m) for m in SIZES]
    assert [tuple(g.shape) for g in labels] == [(m,) for m in SIZES]
    assert all(torch.equal(m, torch.from_numpy(d))
               for m, d in zip(mats, dms))
    perms = _ref_masked_labels(gs, N_PAD)
    for s, m in enumerate(SIZES):
        cut = engine.api._study_draws(perms, s, m)
        assert tuple(cut.shape) == (N_TOTAL, m) and cut.is_contiguous()
        assert torch.equal(cut, perms[s, :, :m])
    assert engine.api._study_draws(None, 0, 5) is None
    with pytest.raises(ValueError, match="study 1: expected a square"):
        engine.api._ragged_studies([dms[0], dms[1][:, :5]], gs[:2])


@pytest.mark.parametrize("materialize,fused_impl", [
    ("dense", "auto"), ("fused-kernel", "torch"), ("fused-kernel", "cuda")])
def test_pipeline_many_rejects_a_covariate_collinear_in_one_study(
        materialize, fused_impl):
    """Every bridge of pipeline_many builds all the studies' designs
    together, so a covariate collinear in one study only (one term
    structure per study no longer) raises, as the reference's batch
    does, instead of reporting study 0's df for every study."""
    _, gs, xs = _stacked()
    cov = np.stack(_covariates([32] * 3))
    cov[1, :, 1] = 2.0 * cov[1, :, 0]
    with pytest.raises(ValueError, match="different design structures"):
        pipeline.pipeline_many(xs, gs, n_groups=G, n_perms=9, covariates=cov,
                               materialize=materialize,
                               fused_impl=fused_impl, device="cpu")


def test_many_result_contract():
    dms, gs, _ = _ragged()
    res = engine.permanova_many(dms, gs, n_groups=G, n_perms=9, n_pad=N_PAD,
                                device="cpu")
    assert len(res) == 3
    one = res.study(1)
    assert (one.n_objects, one.n_groups, one.n_perms) == (SIZES[1], G, 9)
    assert float(one.f_stat) == float(res.f_stat[1])
    torch.testing.assert_close(res.r2, 1.0 - res.s_w / res.s_t)
    des = engine.permanova_many(dms, gs, n_groups=G, n_perms=9,
                                covariates=_covariates(SIZES), device="cpu")
    assert [t.name for t in des.study(2).terms] == ["cov0", "cov1",
                                                    "grouping"]
    assert float(des.study(2).f_stat) == float(des.terms[-1].f_stat[2])


def test_budget_split_cuda_whole_cpu_a_share():
    """The reference's vmap holds every study live, so its per-study plan
    gets 1/S of the label budget; the port's 'cuda' batch runs studies one
    after another and gives each the whole budget, planned at its own
    n_valid; a 'cpu' batch keeps the reference's plan field for field."""
    assert engine.api._study_budgets("cuda", None, 3) is None
    assert engine.api._study_budgets("cuda", 2 ** 20, 3) == 2 ** 20
    assert engine.api._study_budgets("cpu", None, 4) == 64 * 2 ** 20
    pl = engine.api._many_plan("cuda", 10240, 1500, 4000, impl="auto",
                               budget=None, chunk=None)
    assert pl == engine.planner.plan(1500, 4000, backend="cuda")
    dms, gs, _ = _stacked()
    res = engine.permanova_many(dms, gs, n_groups=G, n_perms=N_PERMS,
                                device="cpu")
    ref = _ref_engine("stacked")
    assert res.plan.replace("[in turn]", "[vmap]") == ref.plan


def test_many_rejects_what_it_cannot_run(tmp_path):
    from repro_torch.launch import mesh as pmesh
    dms, gs, xs = _ragged()
    kw = dict(n_groups=G, n_perms=9, device="cpu")
    # study-axis sharding runs since the multi-device slice (worlds of
    # several ranks: tests/test_torch_mesh.py); a one-rank world's mesh
    # runs the ragged batch as it is
    with pmesh.world_of_one("cpu", tmp_path):
        mesh = pmesh.make_mesh((1, 1), ("data", "model"), device_type="cpu")
        assert torch.equal(
            engine.permanova_many(dms, gs, mesh=mesh, **kw).f_perms,
            engine.permanova_many(dms, gs, **kw).f_perms)
    # ordination runs since the ordination slice: each ragged study's
    # axes, zero past its n_s
    assert engine.permanova_many(dms, gs, ordination=2, **kw) \
        .ordination.coords.shape == (len(SIZES), max(SIZES), 2)
    with pytest.raises(ValueError, match="n_pad=30 is smaller"):
        engine.permanova_many(dms, gs, n_pad=30, **kw)
    with pytest.raises(ValueError, match="perms must be"):
        engine.permanova_many(dms, gs, perms=torch.zeros(
            (3, 10, 5), dtype=torch.int32), **kw)
    with pytest.raises(ValueError, match="index_perms= applies"):
        engine.permanova_many(dms, gs, index_perms=torch.zeros(
            (3, 10, 37), dtype=torch.int32), **kw)
    cov = _covariates(SIZES)
    cov[1] = np.stack([cov[1][:, 0], 2.0 * cov[1][:, 0]], axis=1)
    with pytest.raises(ValueError, match="different design structures"):
        engine.permanova_many(dms, gs, covariates=cov, **kw)
    _, gs2, xs2 = _stacked()
    with pytest.raises(ValueError, match="fused-kernel only"):
        pipeline.pipeline_many(xs2, gs2, mesh=object(), materialize="dense",
                               **kw)
    with pytest.raises(ValueError, match="stream/fused are single-study"):
        pipeline.pipeline_many(xs2, gs2, materialize="stream", **kw)
    with pytest.raises(ValueError, match=r"\(S, n, d\)"):
        pipeline.pipeline_many(xs2[0], gs2, **kw)
