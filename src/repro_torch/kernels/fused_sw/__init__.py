"""Fused distance -> s_W megakernel package.

csrc/fused_sw.cu  the CUDA C++ kernel (D^2 tiles never leave registers)
ops               wrapper with operand checks and dispatch (`fused_sw_rows`)
ref               plain PyTorch version the kernel is held against
"""

from repro_torch.kernels.fused_sw.ops import (FUSED_METRICS,  # noqa: F401
                                              KERNEL_METRIC, fused_sw_rows)
from repro_torch.kernels.fused_sw.ref import fused_sw_ref  # noqa: F401
