"""STREAM bandwidth probe (copy / scale / add / triad).

csrc/stream.cu  the CUDA C++ kernel (16-byte vector loads, a scalar tail)
ops             `stream_op`, with operand checks and dispatch
ref             the plain PyTorch forms the kernel is held against
"""

from repro_torch.kernels.stream.ops import (BYTES_PER_ELEM, OPS,  # noqa: F401
                                            stream_op)
