"""End-to-end distance->PERMANOVA pipeline (twin of `repro.pipeline`).

Takes a raw abundance table (n, d) plus grouping labels all the way to F
and p under ONE plan:

  registry    every distance implementation (dense and blocked torch
              forms, the hand-written CUDA kernels) behind one interface
              with capability metadata — the stage-1 mirror of
              engine.registry
  planner     joint two-stage plans: distance impl + row block, the
              materialization bridge (dense / stream / fused /
              fused-kernel) with its fused impl, and the engine's s_W
              plan, decided together
  streaming   the stream bridge (the mat2 row-block producer and the
              one-buffer mat2 build + Gower marginals), the fused bridge
              and the fused-kernel sweeps (the CUDA megakernel, its
              plain torch twin)
  api         pipeline(), one study; pipeline_many(), a stack of studies

Entry points routing here: core.permanova.permanova(features, metric=...)
and the launch CLI's --from-features; designs (covariates, strata,
weights) run through every bridge. (Ordination, out-of-core features and
study-axis sharding come with later slices.)
"""

from repro_torch.pipeline import (api, planner, registry,  # noqa: F401
                                  streaming)
from repro_torch.pipeline.api import pipeline, pipeline_many  # noqa: F401
from repro_torch.pipeline.planner import (  # noqa: F401
    DEFAULT_MATRIX_BUDGET_BYTES, PipelinePlan, plan_pipeline)
from repro_torch.pipeline.registry import (DistanceImpl,  # noqa: F401
                                           FusedImpl, fused_names, get,
                                           get_fused, metrics, names)
from repro_torch.pipeline.streaming import (  # noqa: F401
    FusedKernelStats, FusedStats, GowerStats, build_mat2_streaming,
    fused_kernel_sw, fused_kernel_sw_design, fused_sw, fused_sw_design,
    gower_center, mat2_row_blocks)
