"""Each count of bench/roofline.py against its formula."""

import pytest

from bench import roofline as rl

N, D, P, K = 25145, 128, 4000, 19
SIZES = [5000, 4000, 3000, 2000, 1000, 10145]


def test_pairs_and_matches():
    assert rl.pairs(4) == 6
    assert rl.matches([3, 2, 1]) == 3 + 1 + 0


def test_labels_on_a_matrix_are_compares_at_the_f32_rate():
    pairs = N * (N - 1) / 2
    ops = P * (pairs + rl.matches(SIZES))
    want = max(4.0 * (N * N + P * N + len(SIZES) + P) / 3.35e12,
               ops / 67e12)
    assert rl.sw_labels_s(N, P, SIZES) == pytest.approx(want, rel=1e-12)
    assert 0.019 < rl.sw_labels_s(N, P, SIZES) < 0.025


def test_labels_from_features_add_the_feature_term_at_the_f32_rate():
    pairs = N * (N - 1) / 2
    ops = 2 * pairs * D + P * (pairs + rl.matches(SIZES))
    assert rl.fused_labels_s(N, D, P, SIZES) == pytest.approx(
        ops / 67e12, rel=1e-12)


def test_columns_count_the_product_at_the_tf32_rate():
    pairs = N * (N - 1) / 2
    want = 2 * pairs * D / 67e12 + 2 * pairs * P * K / 495e12
    assert rl.fused_cols_s(N, D, P, K) == pytest.approx(want, rel=1e-12)
    # the product alone at the f32 rate would be 7.4x slower
    assert rl.fused_cols_s(N, D, P, K) < 2 * pairs * P * K / 67e12 / 5


def test_bytes_bound_a_tiny_sweep():
    # one permutation of few pairs: reading the labels outweighs the work
    n, p = 2, 1
    assert rl.sw_labels_s(n, p, [1, 1]) == pytest.approx(
        4.0 * (n * n + p * n + 2 + p) / 3.35e12)
