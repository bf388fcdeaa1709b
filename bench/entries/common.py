"""What every entry returns: each term's F null and p, on the host once
F and p are there."""

from __future__ import annotations

from typing import List, NamedTuple

import torch


class TermOut(NamedTuple):
    name: str
    f: torch.Tensor     # (n_perms + 1,) on the program's device
    p: float


def outcome(res) -> List[TermOut]:
    """The terms of a program result, F and p read to the host (which
    waits for the card): a design's terms in order, else the factor."""
    if res.terms:
        outs = [TermOut(t.name, t.f_perms, float(t.p_value))
                for t in res.terms]
    else:
        outs = [TermOut("factor", res.f_perms, float(res.p_value))]
    float(res.f_stat)
    return outs


def design_kwargs(test) -> dict:
    """The design arguments of one test: strata, covariates."""
    kw = {}
    if test.strata is not None:
        kw["strata"] = test.strata
    if test.covariates:
        kw["covariates"] = {f"cov{i}": c
                            for i, c in enumerate(test.covariates)}
    return kw
