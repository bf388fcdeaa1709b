"""Wrapper around the STREAM bandwidth-probe CUDA kernel (csrc/stream.cu).

Twin of `repro/kernels/stream/ops.py`. The paper calibrates its roofline
with a GPU-aware STREAM variant; the probe measures the device memory
bandwidth the card reaches, to judge the byte-bound kernels against a
measured rate instead of the datasheet's 3.35 TB/s. `stream_op` checks
its operands, then

  * on CPU tensors runs the plain form (`ref.REFS`);
  * on CUDA tensors launches the kernel on the current stream, without
    synchronising, or raises.

There is no fallback from the kernel to its plain form. The library is
built from the source at first use (`kernels/_build.py`). `LAUNCHES`
counts kernel launches per op.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.stream import ref
from repro_torch.obs import cudahooks

OPS = ("copy", "scale", "add", "triad")
# f32 arrays each op moves per element, by the STREAM convention (reads +
# the write): bytes = BYTES_PER_ELEM[op] * 4 * n
BYTES_PER_ELEM = {"copy": 2, "scale": 2, "add": 3, "triad": 3}
LAUNCHES = {op: 0 for op in OPS}
SOURCE = Path(__file__).resolve().parent / "csrc" / "stream.cu"
_OP = {op: i for i, op in enumerate(OPS)}       # the C switch
_lib = None

_PTR, _I64, _I32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
# every pointer and the stream as c_void_p, so no 64-bit address is cut to
# a 32-bit int
SIGNATURES = {
    "stream_launch": ([_I32, _PTR, _PTR, _PTR, _I64, ctypes.c_float, _PTR],
                      _I32),
}


def load_library() -> ctypes.CDLL:
    """Build (at first use) and load the kernel's shared library."""
    global _lib
    if _lib is None:
        lib = _build.load(SOURCE)
        for name, (argtypes, restype) in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = argtypes, restype
        _lib = lib
    return _lib


def _check(a, b, op):
    if op not in OPS:
        raise ValueError(f"unknown STREAM op {op!r}; one of {OPS}")
    for name, t in (("a", a), ("b", b)):
        if t.dim() != 1 or t.shape[0] < 1:
            raise ValueError(f"{name} must be a non-empty 1-D tensor, got "
                             f"{tuple(t.shape)}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if a.shape != b.shape:
        raise ValueError(f"a and b differ in shape: {tuple(a.shape)} vs "
                         f"{tuple(b.shape)}")
    if a.device != b.device:
        raise ValueError(f"operands on different devices: {a.device}, "
                         f"{b.device}")
    if a.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {a.device}")


def stream_op(a: torch.Tensor, b: torch.Tensor, s: float = 3.0, *,
              op: str = "triad", block: int = 65536) -> torch.Tensor:
    """One STREAM op over 1-D float32 a and b (same shape and device):
    copy a, scale s * a, add a + b, triad a + s * b; a new (n,) float32
    tensor. b is read by add and triad only. `block` is the reference's
    Pallas block knob: accepted and ignored (the kernel takes any n, with
    16-byte vector loads and a scalar tail)."""
    del block
    _check(a, b, op)
    if a.device.type == "cpu":
        return ref.REFS[op](a, b, float(s))
    lib = load_library()
    out = torch.empty_like(a)
    err = lib.stream_launch(
        _OP[op], a.data_ptr(), b.data_ptr(), out.data_ptr(), a.shape[0],
        float(s), torch.cuda.current_stream(a.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"stream {op} kernel launch failed: cudaError "
                           f"{err}")
    LAUNCHES[op] += 1
    cudahooks.count_launch(op)
    return out
