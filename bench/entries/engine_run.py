"""Entry `engine_run`: the PERMANOVA test on a resident distance matrix,
`repro_torch.engine.run` (the matrix config's `call` keys are passed on)."""

from __future__ import annotations

from .common import design_kwargs, outcome

INPUT = "matrix"


def call(inputs, test, kwargs):
    from repro_torch import engine
    res = engine.run(inputs, test.factor, n_perms=test.n_perms,
                     seed=test.perm_seed, n_groups=test.n_groups,
                     device=inputs.device.type, **design_kwargs(test),
                     **kwargs)
    return outcome(res)
