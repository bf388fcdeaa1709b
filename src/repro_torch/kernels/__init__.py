"""Hand-written CUDA C++ kernels for Hopper (sm_90a), each beside its plain
PyTorch version (`ref.py`) and a wrapper (`ops.py`) that launches the
kernel on CUDA tensors and runs the plain version on CPU tensors."""
