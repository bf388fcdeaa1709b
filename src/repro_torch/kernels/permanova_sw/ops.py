"""Wrappers around the permanova_sw CUDA kernels (csrc/permanova_sw.cu).

Twin of `repro/kernels/permanova_sw/ops.py`. `permanova_sw` checks its
operands, then

  * on CPU tensors runs the plain version (`ref.sw_ref`);
  * on CUDA tensors launches the kernel `variant` on the current stream,
    without synchronising, and reduces the kernel's per-block partials with
    one deterministic `torch.sum` — or raises.

There is no fallback from a kernel to the plain version: a failed build
or a refused launch raises. The library is built from the source at first
use (`kernels/_build.py`). `LAUNCHES` counts kernel launches per variant,
so a run can show that it went through the kernels.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.core import fstat
from repro_torch.kernels import ShapeNotSupported, _build, tile_visit_elems
from repro_torch.kernels.permanova_sw import ref
from repro_torch.obs import cudahooks

VARIANTS = ("brute", "permblock", "matmul")
# brute's row-slab entry (permanova_sw_rows) counts under its own key
LAUNCHES = {v: 0 for v in VARIANTS + ("brute_rows",)}
SOURCE = Path(__file__).resolve().parent / "csrc" / "permanova_sw.cu"

_MAX_GRID_Y = 65535
# the permblock kernel's band / tile (kBruteRows) and strip (kPbStripTiles)
PERMBLOCK_TILE = 64
PERMBLOCK_STRIP_TILES = 16
_lib = None

_PTR, _I64, _I32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
# ctypes signatures of the C entry points: every pointer and the stream as
# c_void_p, so no 64-bit address is cut to a 32-bit int.
SIGNATURES = {
    "sw_kernel_config": ([_PTR], None),
    "sw_brute_launch": ([_PTR] * 4 + [_I64, _I64, _I32, _PTR], _I32),
    "sw_brute_rows_launch": ([_PTR] * 4 + [_I64] * 4 + [_I32, _PTR],
                             _I32),
    "sw_permblock_launch": ([_PTR] * 4 + [_I64, _I64, _I32, _PTR], _I32),
    "sw_matmul_launch": ([_PTR] * 4 + [_I64, _I64, _I32, _I32, _PTR], _I32),
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


def kernel_config(lib: ctypes.CDLL) -> dict:
    """The tile constants compiled into the library."""
    out = (ctypes.c_int * 9)()
    lib.sw_kernel_config(out)
    return {"brute_rows": out[0], "permblock_pass": out[1],
            "permblock_tile": out[2], "matmul_rows": out[3],
            "matmul_max_perm_block": out[4], "matmul_columns": out[5],
            "brute_cols": out[6], "brute_perms": out[7],
            "permblock_strip_tiles": out[8]}


def permblock_blocks(n: int, tile: int = PERMBLOCK_TILE,
                     strip: int = PERMBLOCK_STRIP_TILES) -> int:
    """Blocks of the permblock kernel for an (n, n) mat2 (pb_blocks in the
    source): the strips of `strip` column tiles that start at each band's
    diagonal tile and every `strip` tiles after it. Its partials are
    (blocks, P) f32: 5,025 blocks at n = 25,145."""
    nt = -(-n // tile)
    return sum(nt - c * strip for c in range(-(-nt // strip)))


def matmul_perm_block(n_groups: int) -> int:
    """Permutations a matmul block takes: as many as fill 256 one-hot
    columns, at least 1 and at most 128 (matmul_perm_block in the
    source)."""
    return 1 if n_groups >= 256 else min(256 // n_groups, 128)


def launch_bytes(variant: str, n: int, n_perms: int, n_groups: int,
                 elem_bytes: int = 4) -> int:
    """Device bytes one launch of `variant` moves at (n, P = n_perms, G),
    worked out from the source: every global element a block copies or
    loads, counted once a block, every partial it writes, and the
    wrapper's sum of the partials. Copies the kernels mask (j <= i on a
    diagonal tile, rows or columns past n, permutations past P) read
    nothing. w (G floats) is not counted.

      brute      each 64 x 64 upper-triangle tile staged once per
                 128-permutation block: n(n-1)/2 mat2 elements a block of
                 permutations, each tile's column labels (128 x 64) with
                 it, the row labels once a block; partials (P, bands).
      permblock  each upper-triangle tile staged once; per (tile, pass of
                 128) its column labels and its row labels, and the
                 block's running s_W read and rewritten; partials
                 (blocks, P).
      matmul     a block (PB permutations, a 64-row band) reads its band
                 of mat2 (all n columns), the PB x n labels of its
                 columns and its rows' labels, once per slice of 256
                 one-hot columns; partials (P, bands).
    The draws that make the labels are not the kernel's and not counted.
    """
    tile = PERMBLOCK_TILE
    nb = -(-n // tile)
    p = n_perms
    if variant in ("brute", "permblock"):
        tri = n * (n - 1) // 2
        visits, cols, rows = tile_visit_elems(n, n, tile, True)
        if variant == "brute":
            passes = -(-p // 128)
            reads = elem_bytes * passes * tri + 4 * p * (cols + n)
            return reads + 2 * 4 * p * nb + 4 * p
        blocks = permblock_blocks(n)
        reads = elem_bytes * tri + 4 * p * (cols + rows)
        running = 4 * p * visits + 4 * p * (visits - blocks)
        return reads + running + 4 * p * blocks + 4 * p
    if variant == "matmul":
        pb = matmul_perm_block(n_groups)
        loads = 0
        for p0 in range(0, p, pb):
            here = min(pb, p - p0)
            slices = -(-here * n_groups // 256)
            span = here if slices == 1 else 1
            loads += slices * (elem_bytes * n * n + 4 * n * span * nb
                               + 4 * n * span)
        return loads + 2 * 4 * p * nb + 4 * p
    raise ValueError(f"unknown variant {variant!r}; one of {VARIANTS}")


def _rounded_sqrt_w(inv_group_sizes: torch.Tensor, dtype) -> torch.Tensor:
    """sqrt(w) rounded to mat2's dtype, as f32 — what the matmul kernel
    multiplies by (the reference rounds it the same way)."""
    return fstat.rounded_sqrt(inv_group_sizes, dtype).to(torch.float32)


def _check(mat2, groupings, inv_group_sizes, variant):
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}; one of {VARIANTS}")
    if mat2.dim() != 2 or mat2.shape[0] != mat2.shape[1] \
            or mat2.shape[0] < 2:
        raise ValueError(f"mat2 must be (n, n) with n >= 2, got "
                         f"{tuple(mat2.shape)}")
    dtypes = (torch.float32, torch.bfloat16) if variant == "matmul" \
        else (torch.float32,)
    if mat2.dtype not in dtypes:
        raise TypeError(f"variant {variant!r} takes mat2 of dtype "
                        f"{dtypes}, got {mat2.dtype}")
    n = mat2.shape[0]
    if groupings.dim() != 2 or groupings.shape[1] != n \
            or groupings.shape[0] < 1:
        raise ValueError(f"groupings must be (P, {n}) with P >= 1, got "
                         f"{tuple(groupings.shape)}")
    if groupings.dtype != torch.int32:
        raise TypeError(f"groupings must be int32, got {groupings.dtype}")
    if inv_group_sizes.dim() != 1 or inv_group_sizes.shape[0] < 1 \
            or inv_group_sizes.dtype != torch.float32:
        raise TypeError("inv_group_sizes must be a non-empty 1-D float32 "
                        f"tensor, got {inv_group_sizes.dtype} "
                        f"{tuple(inv_group_sizes.shape)}")
    devices = {mat2.device, groupings.device, inv_group_sizes.device}
    if len(devices) != 1:
        raise ValueError(f"operands on different devices: {devices}")
    if mat2.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {mat2.device}")
    if not (mat2.is_contiguous() and groupings.is_contiguous()
            and inv_group_sizes.is_contiguous()):
        raise ValueError("mat2, groupings and inv_group_sizes must be "
                         "contiguous")


def _launch(lib, variant, mat2, groupings, inv_group_sizes, stream: int
            ) -> torch.Tensor:
    """Launch `variant` on `stream`; the (P,) s_W from its partials."""
    partials = launch_partials(lib, variant, mat2, groupings,
                               inv_group_sizes, stream)
    return partials.sum(dim=0 if variant == "permblock" else 1)


def launch_partials(lib, variant, mat2, groupings, inv_group_sizes,
                    stream: int) -> torch.Tensor:
    """Launch `variant` on `stream` into a partials buffer of its own and
    return it: (P, bands) for brute and matmul, (blocks, P) for permblock.
    The kernel allocates nothing else."""
    cfg = kernel_config(lib)
    n, n_perms = mat2.shape[0], groupings.shape[0]
    n_groups = inv_group_sizes.shape[0]
    if variant == "permblock":
        # (blocks, P): one running s_W per (block, permutation)
        shape = (permblock_blocks(n, cfg["permblock_tile"],
                                  cfg["permblock_strip_tiles"]), n_perms)
        too_big = shape[0] >= 2 ** 31
    else:
        rows = cfg["brute_rows"] if variant == "brute" \
            else cfg["matmul_rows"]
        shape = (n_perms, -(-n // rows))
        too_big = shape[1] > _MAX_GRID_Y or n_perms >= 2 ** 31
    if too_big:
        raise ShapeNotSupported(f"shape (P={n_perms}, n={n}) exceeds the "
                                f"{variant} kernel's grid")
    partials = torch.empty(shape, dtype=torch.float32, device=mat2.device)
    args = (mat2.data_ptr(), groupings.data_ptr())
    if variant == "matmul":
        sqrt_w = _rounded_sqrt_w(inv_group_sizes, mat2.dtype)
        err = lib.sw_matmul_launch(*args, sqrt_w.data_ptr(),
                                   partials.data_ptr(), n, n_perms,
                                   n_groups,
                                   int(mat2.dtype == torch.bfloat16),
                                   stream)
    else:
        fn = lib.sw_brute_launch if variant == "brute" \
            else lib.sw_permblock_launch
        err = fn(*args, inv_group_sizes.data_ptr(), partials.data_ptr(),
                 n, n_perms, n_groups, stream)
    if err != 0:
        raise RuntimeError(f"permanova_sw {variant} kernel launch failed: "
                           f"cudaError {err}")
    LAUNCHES[variant] += 1
    cudahooks.count_launch(variant)
    return partials


def permanova_sw(mat2: torch.Tensor, groupings: torch.Tensor,
                 inv_group_sizes: torch.Tensor, *, variant: str = "matmul"
                 ) -> torch.Tensor:
    """(P,) f32 s_W for a batch of permutations.

    mat2:            (n, n) squared distances with a ZERO diagonal. The
                     matmul variant sums the full i != j square and halves
                     it, which is exact only under that precondition. f32,
                     or bf16 for the matmul variant (f32 accumulation).
    groupings:       (P, n) int32 permuted labels.
    inv_group_sizes: (G,) f32.

    The brute kernel applies each staged 64 x 64 tile of the upper
    triangle to 128 permutations (a compare and a predicated add per
    pair and permutation); permblock stages each tile once and applies
    it to every permutation of the call in passes of 128 (the paper's
    Algorithm 2; its partials are (blocks, P), see permblock_blocks);
    matmul takes as many as fill 256 one-hot columns (32 at G = 8, at
    most 128), on the tensor cores (wgmma): two TF32 products of an exact
    split on f32 mat2, one bf16 product on bf16.
    """
    _check(mat2, groupings, inv_group_sizes, variant)
    if mat2.device.type == "cpu":
        if mat2.dtype == torch.bfloat16:
            w = _rounded_sqrt_w(inv_group_sizes, mat2.dtype) ** 2
            return ref.sw_ref(mat2.to(torch.float32), groupings, w)
        return ref.sw_ref(mat2, groupings, inv_group_sizes)
    lib = load_library()
    stream = torch.cuda.current_stream(mat2.device).cuda_stream
    return _launch(lib, variant, mat2, groupings, inv_group_sizes, stream)


def permanova_sw_rows(mat2_rows: torch.Tensor, groupings: torch.Tensor,
                      inv_group_sizes: torch.Tensor, *, row_offset: int
                      ) -> torch.Tensor:
    """(P, ceil(n_rows / 64)) f32 band partials of a row slab of mat2, the
    unit of row-sharded s_W (core.distributed).

    mat2_rows:       (n_rows, n) rows [row_offset, row_offset + n_rows) of
                     the (n, n) squared distances (zero diagonal), f32.
    groupings:       (P, n) int32 permuted labels of every sample.
    inv_group_sizes: (G,) f32.
    row_offset:      a multiple of 64 (the brute kernel's band), else
                     ValueError; the slab must lie inside the matrix.

    On CUDA tensors the brute kernel's row-slab entry runs each band from
    its diagonal tile as the whole-matrix launch does: column y is global
    band row_offset / 64 + y of `launch_partials(.., 'brute', ..)`, bit
    for bit, so the slabs' partials concatenated in row order and summed
    as permanova_sw sums them give its s_W bit for bit. On CPU tensors the
    plain version (ref.sw_rows_ref). Launches count under 'brute_rows'.
    """
    if mat2_rows.dim() != 2 or mat2_rows.shape[0] < 1:
        raise ValueError(f"mat2_rows must be (n_rows, n), got "
                         f"{tuple(mat2_rows.shape)}")
    n_rows, n = (int(v) for v in mat2_rows.shape)
    row_offset = int(row_offset)
    if row_offset % PERMBLOCK_TILE or row_offset < 0 \
            or row_offset + n_rows > n:
        raise ValueError(f"row_offset={row_offset} must be a multiple of "
                         f"{PERMBLOCK_TILE} with the {n_rows}-row slab "
                         f"inside the ({n}, {n}) matrix")
    if mat2_rows.dtype != torch.float32:
        raise TypeError(f"mat2_rows must be float32, got {mat2_rows.dtype}")
    if groupings.dim() != 2 or groupings.shape[1] != n \
            or groupings.shape[0] < 1 or groupings.dtype != torch.int32:
        raise ValueError(f"groupings must be (P, {n}) int32 with P >= 1, "
                         f"got {groupings.dtype} {tuple(groupings.shape)}")
    if inv_group_sizes.dim() != 1 or inv_group_sizes.shape[0] < 1 \
            or inv_group_sizes.dtype != torch.float32:
        raise TypeError("inv_group_sizes must be a non-empty 1-D float32 "
                        "tensor")
    devices = {mat2_rows.device, groupings.device, inv_group_sizes.device}
    if len(devices) != 1:
        raise ValueError(f"operands on different devices: {devices}")
    if not (mat2_rows.is_contiguous() and groupings.is_contiguous()
            and inv_group_sizes.is_contiguous()):
        raise ValueError("mat2_rows, groupings and inv_group_sizes must be "
                         "contiguous")
    if mat2_rows.device.type == "cpu":
        return ref.sw_rows_ref(mat2_rows, groupings, inv_group_sizes,
                               row_offset)
    n_perms = int(groupings.shape[0])
    shape = (n_perms, -(-n_rows // PERMBLOCK_TILE))
    if shape[1] > _MAX_GRID_Y or n_perms >= 2 ** 31:
        raise ShapeNotSupported(f"shape (P={n_perms}, rows={n_rows}) "
                                "exceeds the brute kernel's grid")
    lib = load_library()
    stream = torch.cuda.current_stream(mat2_rows.device).cuda_stream
    partials = torch.empty(shape, dtype=torch.float32,
                           device=mat2_rows.device)
    err = lib.sw_brute_rows_launch(
        mat2_rows.data_ptr(), groupings.data_ptr(),
        inv_group_sizes.data_ptr(), partials.data_ptr(), n, n_rows,
        row_offset, n_perms, int(inv_group_sizes.shape[0]), stream)
    if err != 0:
        raise RuntimeError(f"permanova_sw brute_rows kernel launch failed: "
                           f"cudaError {err}")
    LAUNCHES["brute_rows"] += 1
    cudahooks.count_launch("brute_rows")
    return partials


def make_sw_fn(variant: str = "matmul"):
    """Adapter giving the (mat2, groupings, inv_gs) -> s_W signature that
    engine.run(sw_fn=...) expects."""
    def fn(mat2, groupings, inv_gs):
        return permanova_sw(mat2, groupings, inv_gs, variant=variant)
    return fn
