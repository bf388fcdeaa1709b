"""Fused distance -> s_W megakernel package.

csrc/fused_sw.cu  the CUDA C++ kernels (D^2 never reaches device memory):
                  one for labels, one for a dense design's basis
ops               wrappers with operand checks and dispatch
                  (`fused_sw_rows`, `fused_sw_rows_cols`)
ref               plain PyTorch versions the kernels are held against
"""

from repro_torch.kernels.fused_sw.ops import (FUSED_METRICS,  # noqa: F401
                                              KERNEL_METRIC, fused_sw_rows,
                                              fused_sw_rows_cols)
from repro_torch.kernels.fused_sw.ref import (fused_sw_cols_ref,  # noqa: F401
                                              fused_sw_ref)
