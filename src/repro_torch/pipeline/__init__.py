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
              plain torch twin), and the out-of-core sweeps over a slab
              cache (data.slabcache)
  ordination  PCoA from each bridge's own dataflow
  api         pipeline(), one study (features, or a slab cache or its
              path); pipeline_many(), a stack of studies

Entry points routing here: core.permanova.permanova(features, metric=...)
and the launch CLI's --from-features / --features-cache; designs
(covariates, strata, weights) run through every bridge. `mesh=` shards
the fused-kernel bridge's rows (`pipeline`) or the study axis
(`pipeline_many`) over a torch.distributed mesh (`launch.mesh`).
"""

from repro_torch.pipeline import (api, planner, registry,  # noqa: F401
                                  streaming)
from repro_torch.pipeline.api import pipeline, pipeline_many  # noqa: F401
from repro_torch.pipeline.planner import (  # noqa: F401
    DEFAULT_DEVICE_BUDGET_BYTES, DEFAULT_HOST_BUDGET_BYTES,
    DEFAULT_MATRIX_BUDGET_BYTES, PipelinePlan, plan_pipeline,
    plan_slab_rows)
from repro_torch.pipeline.registry import (DistanceImpl,  # noqa: F401
                                           FusedImpl, fused_names, get,
                                           get_fused, metrics, names)
from repro_torch.pipeline.streaming import (  # noqa: F401
    FusedKernelStats, FusedStats, GowerStats, OocStats,
    build_mat2_streaming, fused_kernel_sw, fused_kernel_sw_design,
    fused_sw, fused_sw_design, fused_sw_ooc, fused_sw_ooc_design,
    gower_center, mat2_row_blocks, ooc_mat2_row_blocks)
