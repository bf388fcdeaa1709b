"""The check fails what it must: the TF32 control, and a run with its
timed path broken underneath (an answer altered where it is produced:
s_W or a column form, or p by one permutation; half of the permutations
left undrawn), at a size a CPU test holds. The
harness's look for a card is skipped (device='cpu'); the rest of a run is
driven as on the card."""

import pytest
import torch

from bench import control, harness
from conftest import ALL, small

SEEDS = (2 ** 31 + 11, 2 ** 31 + 12, 2 ** 31 + 13)


@pytest.mark.parametrize("name", ALL)
def test_control_fails_and_the_program_passes(name, root):
    c = harness.cell(name, root=root)
    limit = float(c.check["f_gap"])
    for s in SEEDS:
        assert control.readings(c, s, "cpu", True, small(c))["f_gap"] > limit
        got = control.readings(c, s, "cpu", False, small(c))
        assert got["f_gap"] <= limit and got["p_out"] == 0


def _altered(fn, pos):
    """fn's output tuple with element `pos` (s_W, or the column forms,
    then in one column: all of a row scaled alike leaves F as it is) off
    by 5% at one permutation."""
    def wrapped(*a, **k):
        out = list(fn(*a, **k))
        s = out[pos].clone()
        s.view(s.shape[0], -1)[s.shape[0] // 3, -1] *= 1.05
        out[pos] = s
        return tuple(out)
    return wrapped


def _half_labels(fn, n_total):
    """Label draws whose second half of the sweep is left undrawn (the
    observed labels)."""
    def wrapped(grouping, lo, hi, *a, **k):
        out = fn(grouping, lo, hi, *a, **k)
        cut = max(n_total // 2 - lo, 0)
        out[cut:] = grouping.to(out.dtype)
        return out
    return wrapped


def _half_index(fn, n_total):
    def wrapped(strata, lo, hi, *a, **k):
        out = fn(strata, lo, hi, *a, **k)
        cut = max(n_total // 2 - lo, 0)
        out[cut:] = torch.arange(out.shape[1], dtype=out.dtype)
        return out
    return wrapped


def _fault(monkeypatch, kind, n_total):
    from repro_torch.core import permutations
    from repro_torch.engine import api
    from repro_torch.pipeline import streaming
    if kind == "p":         # one permutation more counted at or above F_0
        from repro_torch.pipeline import api as papi
        for mod in (api, papi):
            monkeypatch.setattr(mod, "p_value_from_null", lambda f, _o=(
                mod.p_value_from_null): _o(f) + 1.0 / f.shape[0])
    elif kind == "answer":
        monkeypatch.setattr(api, "_run_sweep", _altered(api._run_sweep, 0))
        monkeypatch.setattr(streaming, "fused_kernel_sw",
                            _altered(streaming.fused_kernel_sw, 0))
        monkeypatch.setattr(streaming, "fused_kernel_sw_design",
                            _altered(streaming.fused_kernel_sw_design, 0))
    else:
        monkeypatch.setattr(permutations, "permutation_batch", _half_labels(
            permutations.permutation_batch, n_total))
        monkeypatch.setattr(
            permutations, "strata_permutation_batch", _half_index(
                permutations.strata_permutation_batch, n_total))


@pytest.mark.parametrize("kind", ["answer", "p", "half"])
@pytest.mark.parametrize("name", ALL)
def test_a_broken_path_is_not_correct(monkeypatch, name, kind, root):
    c = harness.cell(name, root=root)
    sizes = small(c)
    _fault(monkeypatch, kind, sizes["n_perms"] + 1)
    r = harness.run(c, SEEDS[0], 0.3, False, device="cpu", sizes=sizes)
    assert r["attempted"] >= 1 and r["failed"] == 0
    assert not r["correct"], r["checks"]
