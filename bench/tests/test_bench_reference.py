"""The reference against the test's definition on tiny cases, and its
frozen draws against the program's."""

import itertools

import numpy as np
import pytest
import torch

from bench.reference import draws, permanova as ref


def _study(n=14, g=3, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.random((n, 5))
    d = np.abs(x[:, None, :] - x[None, :, :]).sum(-1)
    lab = np.arange(n) % g
    rng.shuffle(lab)
    return torch.from_numpy(d), torch.from_numpy(lab)


def _sw_loops(d2, labels):
    """s_W = sum_g (1/n_g) sum_{i<j in g} d_ij^2, by loops."""
    n = len(labels)
    sizes = np.bincount(labels)
    return sum(d2[i, j] / sizes[labels[i]]
               for i, j in itertools.combinations(range(n), 2)
               if labels[i] == labels[j])


@pytest.mark.parametrize("strata", [False, True])
def test_label_test_is_the_definition(strata):
    d, lab = _study()
    g = 3
    st = torch.arange(14) % 2 if strata else None
    d2 = ref.squared_from_matrix(d)
    (term,) = ref.label_test(d2, lab, g, n_perms=9, seed=5, strata=st)
    rows = draws.label_perms(lab, 5, 0, 10, st).numpy()
    d2n = d2.numpy()
    s_t = d2n[np.triu_indices(14, 1)].sum() / 14
    for p in range(10):
        s_w = _sw_loops(d2n, rows[p])
        f = ((s_t - s_w) / (g - 1)) / (s_w / (14 - g))
        assert term.f[p].item() == pytest.approx(f, rel=1e-12)
    assert term.p == (int((term.f[1:] >= term.f[0]).sum()) + 1) / 10
    if strata:       # a within-strata draw keeps each sample's stratum
        idx = draws.index_perms(5, 0, 10, 14, "cpu", st)
        assert bool((st[idx] == st[None, :]).all())


def test_design_test_is_the_projection():
    """Sequential SS from hat matrices: SS_t = tr((H_t - H_{t-1}) G)."""
    d, lab = _study(n=16, g=3, seed=1)
    rng = np.random.default_rng(2)
    covs = [torch.from_numpy(rng.normal(size=16)) for _ in range(2)]
    d2 = ref.squared_from_matrix(d)
    terms = ref.design_test(d2, lab, 3, covs, n_perms=4, seed=3)
    n = 16
    c = np.eye(n) - 1.0 / n
    gower = -0.5 * c @ d2.numpy() @ c
    perms = draws.index_perms(3, 0, 5, n, "cpu").numpy()
    for p in range(5):
        pi = perms[p]
        onehot = np.eye(3)[lab.numpy()][pi]
        cols = [np.ones((n, 1))] + [cv.numpy()[pi][:, None] for cv in covs]
        cols.append(onehot[:, 1:])

        def hat(k):
            x = np.concatenate(cols[:k], axis=1)
            return x @ np.linalg.pinv(x)
        ss = [np.trace((hat(k + 1) - hat(k)) @ gower) for k in range(1, 4)]
        resid = np.trace((np.eye(n) - hat(4)) @ gower)
        dfs = [1, 1, 2]
        for t, term in enumerate(terms):
            f = (ss[t] / dfs[t]) / (resid / (n - 5))
            assert term.f[p].item() == pytest.approx(f, rel=1e-9)


def test_braycurtis_is_the_definition():
    x = torch.rand(9, 6, dtype=torch.float64)
    d2 = ref.squared_braycurtis(x, block=4)
    for i, j in itertools.product(range(9), range(9)):
        want = 0.0 if i == j else float(
            ((x[i] - x[j]).abs().sum() / (x[i] + x[j]).sum()) ** 2)
        assert d2[i, j].item() == pytest.approx(want, rel=1e-12, abs=0)


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 2 ** -10, 3.0 + 2 ** -12])
    got = ref.to_tf32(x)
    assert got.tolist() == [1.0, 1.0 + 2 ** -10, 1.0 + 2 ** -10, 3.0]


@pytest.mark.parametrize("seed", [0, 2 ** 31 + 7, 2 ** 33 + 5])
def test_frozen_draws_equal_the_programs(seed):
    from repro_torch.core import permutations
    g = torch.arange(50, dtype=torch.int32) % 4
    st = (torch.arange(50) * 7 % 5).to(torch.int32)
    assert torch.equal(
        draws.label_perms(g, seed, 3, 40),
        permutations.permutation_batch(g, 3, 40, seed=seed).long())
    assert torch.equal(
        draws.label_perms(g, seed, 0, 40, st),
        permutations.strata_label_batch(g, st, 0, 40, seed=seed).long())
    assert torch.equal(
        draws.index_perms(seed, 0, 40, 50, "cpu"),
        permutations.strata_permutation_batch(
            torch.zeros(50, dtype=torch.int32), 0, 40, seed=seed).long())
