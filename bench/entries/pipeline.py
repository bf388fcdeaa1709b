"""Entry `pipeline`: the PERMANOVA test from a resident feature table,
`repro_torch.pipeline.pipeline` (the config's `call` keys are passed on:
the metric, and nothing else at the planner's defaults)."""

from __future__ import annotations

from .common import design_kwargs, outcome

INPUT = "table"


def call(inputs, test, kwargs):
    from repro_torch.pipeline import pipeline
    res = pipeline(inputs, test.factor, n_perms=test.n_perms,
                   seed=test.perm_seed, n_groups=test.n_groups,
                   device=inputs.device.type, **design_kwargs(test),
                   **kwargs)
    return outcome(res)
