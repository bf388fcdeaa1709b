"""Wrappers around the pairwise-distance CUDA kernels (csrc/distance.cu).

Twin of `repro/kernels/distance/ops.py`. Two entry points:

  pairwise_distance       (n, n) matrix from (n, d) features, with an
                          exact zero diagonal
  pairwise_distance_rows  (b, n) slab of rows against the full table, the
                          streaming unit of the pipeline's stream bridge;
                          no diagonal zeroing (the slab does not know its
                          global row offset: the consumer masks it)

and `pairwise_rect`, one kernel on a rectangle, which both call. On CPU
tensors it runs the plain version (`ref.py`); on CUDA tensors it launches
the kernel on the current stream, without synchronising, or raises. There
is no fallback from a kernel to its plain version. The kernels take their
tiles from the source and mask ragged shapes themselves, so nothing is
padded. A call of one table against itself (`is_symmetric_call`: the same
storage, shape and strides, as `pairwise_distance` makes it) computes
the tiles j >= i only and mirrors them; the result is the rectangular
call's bit for bit. `LAUNCHES` counts kernel launches per kernel.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.core.distance import pack_presence_bits
from repro_torch.kernels import ShapeNotSupported, _build, tile_visit_elems
from repro_torch.kernels.distance import ref
from repro_torch.obs import cudahooks

KERNELS = ("braycurtis", "euclidean", "jaccard", "jaccard_packed")
METRICS = ("braycurtis", "euclidean", "jaccard")
LAUNCHES = {k: 0 for k in KERNELS}
SOURCE = Path(__file__).resolve().parent / "csrc" / "distance.cu"

TILE = 128                  # kTile in the source
_lib = None

_PTR, _I64, _I32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
# every pointer and the stream as c_void_p, so no 64-bit address is cut to
# a 32-bit int
SIGNATURES = {
    "distance_launch": ([_I32, _PTR, _PTR, _PTR, _I64, _I64, _I64, _I32,
                         _PTR], _I32),
}


def load_library() -> ctypes.CDLL:
    """Build (at first use) and load the kernels' shared library."""
    global _lib
    if _lib is None:
        lib = _build.load(SOURCE)
        for name, (argtypes, restype) in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = argtypes, restype
        _lib = lib
    return _lib


def _check(xr, xc, kernel):
    if kernel not in KERNELS:
        raise ValueError(f"unknown kernel {kernel!r}; one of {KERNELS}")
    dtype = torch.int32 if kernel == "jaccard_packed" else torch.float32
    for name, t in (("xr", xr), ("xc", xc)):
        if t.dim() != 2 or t.shape[0] < 1 or t.shape[1] < 1:
            raise ValueError(f"{name} must be a non-empty 2-D tensor, got "
                             f"{tuple(t.shape)}")
        if t.dtype != dtype:
            raise TypeError(f"kernel {kernel!r} takes {dtype} operands, "
                            f"got {name} {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if xr.shape[1] != xc.shape[1]:
        raise ValueError(f"feature widths differ: {xr.shape[1]} vs "
                         f"{xc.shape[1]}")
    if xr.device != xc.device:
        raise ValueError(f"operands on different devices: {xr.device}, "
                         f"{xc.device}")
    if xr.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {xr.device}")
    if -(-xr.shape[0] // TILE) * -(-xc.shape[0] // TILE) >= 2 ** 31:
        raise ShapeNotSupported(f"({xr.shape[0]}, {xc.shape[0]}) exceeds "
                                "the kernel's grid")


def launch_bytes(nr: int, n: int, d: int, *, symmetric: bool = False,
                 feat_bytes: float = 4.0) -> float:
    """Device bytes one launch moves, worked out from the source: per
    visited 128 x 128 output tile its rows' and columns' d features (of
    `feat_bytes`: packed jaccard passes its words as d with 4 bytes), and
    the (nr, n) f32 output written once (a symmetric call writes each
    visited tile and its transpose)."""
    _, cols, rows = tile_visit_elems(nr, n, TILE, symmetric)
    return feat_bytes * d * (cols + rows) + 4.0 * nr * n


def is_symmetric_call(xr: torch.Tensor, xc: torch.Tensor) -> bool:
    """Whether a call covers one table against itself: the same storage
    at the same address, shape and strides. The kernel then visits the
    tiles j >= i only and writes each with its transpose. A clone, a row
    slab or an offset view of the table is a rectangular call."""
    return (xr.data_ptr() == xc.data_ptr() and xr.shape == xc.shape
            and xr.stride() == xc.stride())


def pairwise_rect(xr: torch.Tensor, xc: torch.Tensor, *, kernel: str
                  ) -> torch.Tensor:
    """(nr, nc) f32 distances of the rows of xr against the rows of xc.

    kernel: 'braycurtis' | 'euclidean' | 'jaccard' (f32 operands) |
    'jaccard_packed' (int32 words from core.distance.pack_presence_bits).
    When xr and xc are one table (is_symmetric_call), the kernel computes
    each pair once.

    Operand contract for 'jaccard': presence data, every value 0.0 or 1.0
    exactly (core.distance.presence_prepare; the registry's prepare
    supplies it). On the card the kernel converts each value to int8 and
    counts the intersection exactly on the tensor cores; other values give
    wrong counts, and nothing checks them on the device (a check would
    synchronize). Euclidean runs its Gram on the tensor cores as three
    TF32 products, within the f32 bar."""
    _check(xr, xc, kernel)
    if xr.device.type == "cpu":
        return ref.REFS[kernel](xr, xc)
    lib = load_library()
    nr, nc, d = xr.shape[0], xc.shape[0], xr.shape[1]
    out = torch.empty((nr, nc), dtype=torch.float32, device=xr.device)
    stream = torch.cuda.current_stream(xr.device).cuda_stream
    err = lib.distance_launch(KERNELS.index(kernel), xr.data_ptr(),
                              xc.data_ptr(), out.data_ptr(), nr, nc, d,
                              int(is_symmetric_call(xr, xc)), stream)
    if err != 0:
        raise RuntimeError(f"distance {kernel} kernel launch failed: "
                           f"cudaError {err}")
    LAUNCHES[kernel] += 1
    cudahooks.count_launch(kernel)
    return out


def _kernel_for(metric, packed) -> str:
    if metric not in METRICS:
        raise ValueError(f"unknown metric {metric!r}; one of {METRICS}")
    if packed and metric != "jaccard":
        raise ValueError(
            f"packed=1 requires metric='jaccard' (got {metric!r})")
    return "jaccard_packed" if packed else metric


def _operand(x, packed) -> torch.Tensor:
    if packed:
        return pack_presence_bits(x)
    return x.to(torch.float32).contiguous()


def pairwise_distance(x: torch.Tensor, *, metric: str = "braycurtis",
                      packed: int = 0) -> torch.Tensor:
    """(n, n) distance matrix from (n, d) features, zero diagonal.

    Jaccard expects presence/absence floats (distance.presence_prepare);
    the registry's prepare supplies them. packed=1 (jaccard only) packs
    presence into 32-bit words and runs the popcount kernel: the same
    distances bit for bit, from 32x fewer feature bytes. The table goes
    in once as both operands, so on the card each pair is computed once
    (is_symmetric_call)."""
    kernel = _kernel_for(metric, packed)
    xq = _operand(x, packed)
    return pairwise_rect(xq, xq, kernel=kernel).fill_diagonal_(0.0)


def pairwise_distance_rows(x_rows: torch.Tensor, x: torch.Tensor, *,
                           metric: str = "braycurtis", packed: int = 0
                           ) -> torch.Tensor:
    """(b, n) distances of a row slab against the full table; the
    (global_row == col) entries are left as computed (pipeline.streaming
    zeroes them while squaring)."""
    kernel = _kernel_for(metric, packed)
    return pairwise_rect(_operand(x_rows, packed), _operand(x, packed),
                         kernel=kernel)
