"""repro_torch — the PyTorch/CUDA port of the PERMANOVA engine, for one
NVIDIA H100 (Hopper, sm_90a).

The JAX package `repro` is the reference this port is checked against;
each module here has a twin there at the same relative path:

  hw.py          H100 SXM datasheet constants and device resolution
  data/          synthetic microbiome studies (numpy, same draws per seed)
                 and the disk slab cache with its prefetcher to the card
  core/          permutations, s_W forms (fstat), distances, permanova()
  kernels/       hand-written CUDA C++ kernels (sm_90a) + plain versions
  engine/        s_W registry, planner, streaming scheduler, run()
  pipeline/      features -> p under one plan (bridges, out of core)
  serve/         the PERMANOVA service and the LM decode loop
  configs/       the LM architectures (the reference's, field for field)
  models/        every LM family (attention, blocks, MoE, SSM, xLSTM,
                 DecoderLM / HybridLM / XLSTMLM / EncDecLM, the loss)
  sharding/      logical-axis sharding rules, the train state's axes,
                 the models' activation constraints under a mesh
  optim/         AdamW, Adafactor, SGDM, schedules, gradient compression
  train/         the training step (microbatches, clip, optimizer)
  runtime/       the serving runtime and the fault-tolerant trainer
  utils/         tree and timing helpers
  launch/        the permanova CLI (matrix, features and cache paths;
                 --distributed / --shard-rows under torchrun), the serve
                 CLI (permanova, lm), the training CLI, the DeviceMesh
                 helpers (launch/mesh.py: production meshes on a fake
                 process group) and the dry-run (launch/cells.py,
                 launch/dryrun.py)
  roofline/      the dry-run's counted step (op_cost), its roofline
                 terms (analysis) and tables (report)

Entry points run on the card (`device="cuda"`) and raise when there is
none; pass `device="cpu"` to run the plain PyTorch forms on the host.
"""

__version__ = "0.1.0"

from repro_torch.core.distributed import permanova_distributed  # noqa: E402,F401
