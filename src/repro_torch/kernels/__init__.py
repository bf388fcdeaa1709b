"""Hand-written CUDA C++ kernels for Hopper (sm_90a), each beside its plain
PyTorch version (`ref.py`) and a wrapper (`ops.py`) that launches the
kernel on CUDA tensors and runs the plain version on CPU tensors."""


class ShapeNotSupported(ValueError):
    """A kernel does not apply to this shape: its grid or its partial sum
    cannot cover it. The one launch error an autotune shoot-out skips a
    candidate for; every other build or launch error propagates."""
