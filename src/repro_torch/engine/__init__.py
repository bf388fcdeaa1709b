"""Hardware-aware PERMANOVA execution engine (twin of `repro.engine`).

  registry    the s_W impls behind one batch interface; each runs its
              plain form on CPU tensors and its CUDA kernel on the card
  planner     backend + shape -> impl + tuning + streaming chunk
  scheduler   fixed-memory streaming sweeps (labels made on the device
              per chunk from global permutation indices)
  api         run(), the single-study entry; run_design() for designs
              (strata, covariates, weights) with per-term results;
              permanova_many() for a batch of studies, stacked or ragged
"""

from repro_torch.engine import (api, planner, registry,  # noqa: F401
                                scheduler)
from repro_torch.engine.api import (  # noqa: F401
    PermanovaManyResult, design_many_result, design_result,
    label_design_result, permanova_many, run, run_design)
from repro_torch.engine.planner import Plan, chunk_for_budget, plan  # noqa: F401
from repro_torch.engine.registry import SwImpl, get, names  # noqa: F401
from repro_torch.engine.scheduler import (  # noqa: F401
    StreamStats, sw_batch, sw_cols_streaming, sw_streaming)
