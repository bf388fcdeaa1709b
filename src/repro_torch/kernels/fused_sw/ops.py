"""Wrapper around the fused distance -> s_W CUDA kernel (csrc/fused_sw.cu).

Twin of `repro/kernels/fused_sw/ops.py`. `fused_sw_rows` is the streaming
unit of the pipeline's fused-kernel bridge: s_W partials and Gower row
sums for one permutation chunk over one row slab, with the D^2 tiles never
reaching device memory; `fused_sw_rows_cols` is the same unit for
a dense design (per-column quadratic forms of a permuted basis). The slab
is the whole table on one card; `row_offset` keeps the sharding contract
(partials of disjoint slabs sum to the full statistic). Each checks its
operands, then

  * on CPU tensors runs the plain version (`ref.fused_sw_ref`,
    `ref.fused_sw_cols_ref`);
  * on CUDA tensors launches its kernel on the current stream, without
    synchronising, and then a second kernel that sums the slots' partials
    in a fixed order — or raises.

The precision knobs (feat_bf16 / feat_fp8 / feat_packed, feat_scale) pick
the kernel's feature mode, as in the reference: the wrapper quantizes the
f32 features it is given (`quantize_slabs`: bf16, e4m3 at one per-study
scale, or 32-bit presence words for jaccard) and launches that mode's
kernel; the plain versions round-trip the same values. There is no
fallback from a kernel to its plain version. The library is built from the
source at first use (`kernels/_build.py`). `LAUNCHES` counts kernel
launches per kernel and mode: 'fused_sw' / 'fused_sw_cols' for f32, e.g.
'fused_sw[fp8]' for another mode.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.core import distance
from repro_torch.kernels import ShapeNotSupported, _build, tile_visit_elems
from repro_torch.kernels.fused_sw import ref
from repro_torch.obs import cudahooks

# aitchison is euclidean geometry over clr-prepared features
KERNEL_METRIC = {"euclidean": "euclidean", "braycurtis": "braycurtis",
                 "jaccard": "jaccard", "aitchison": "euclidean"}
FUSED_METRICS = ("euclidean", "braycurtis", "jaccard")
_KIND = {"braycurtis": 0, "euclidean": 1, "jaccard": 2}   # the C switch
MODES = ("f32", "bf16", "fp8", "packed")
_MODE = {m: i for i, m in enumerate(MODES)}                # the C switch
KERNELS = ("fused_sw", "fused_sw_cols")


def launch_key(kernel: str, mode: str) -> str:
    """The LAUNCHES key of a kernel in a feature mode: the kernel's name
    for f32, 'fused_sw[fp8]' and the like otherwise."""
    return kernel if mode == "f32" else f"{kernel}[{mode}]"


LAUNCHES = {launch_key(k, m): 0 for k in KERNELS for m in MODES}
SOURCE = Path(__file__).resolve().parent / "csrc" / "fused_sw.cu"
TILE = 64                   # kTile in the source
SW_STRIP_TILES = 16         # kSwStripTiles: column tiles per labels block
SW_PASS = 128               # kSwPass: permutations a labels pass
STRIP_TILES = 2             # kStripTiles: column tiles per cols block
Q_PASS = 128                # kQPass: (permutation, column) pairs a pass
SW_SLOTS = 4096             # kSwSlots: most blocks of a labels launch
COLS_SLOTS = 2048           # kColsSlots: most blocks of a cols launch
# each kernel's (column tiles a work item, most slots)
LAYOUT = {"fused_sw": (SW_STRIP_TILES, SW_SLOTS),
          "fused_sw_cols": (STRIP_TILES, COLS_SLOTS)}
_lib = None

_PTR, _I64, _I32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
# every pointer and the stream as c_void_p, so no 64-bit address is cut to
# a 32-bit int
SIGNATURES = {
    "fused_sw_config": ([_PTR], None),
    "fused_sw_launch": ([_I32, _I32] + [_PTR] * 11 + [_I64] * 4
                        + [_I32, _I64, _I64, _I32, _PTR], _I32),
    "fused_sw_cols_config": ([_PTR], None),
    "fused_sw_cols_launch": ([_I32, _I32] + [_PTR] * 10 + [_I64] * 7
                             + [_I32, _PTR], _I32),
}


def load_library() -> ctypes.CDLL:
    """Build (at first use) and load the kernel's shared library. The
    partial buffers are sized from TILE, the strips and the slots, so a
    library compiled with other constants is refused."""
    global _lib
    if _lib is None:
        lib = _build.load(SOURCE)
        for name, (argtypes, restype) in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = argtypes, restype
        cfg, ccfg = kernel_config(lib), cols_kernel_config(lib)
        got = (cfg["tile"], cfg["strip_tiles"], ccfg["strip_tiles"],
               cfg["slots"], ccfg["slots"])
        want = (TILE, SW_STRIP_TILES, STRIP_TILES, SW_SLOTS, COLS_SLOTS)
        if got != want:
            raise RuntimeError(f"{SOURCE.name} was compiled with (kTile, "
                               f"kSwStripTiles, kStripTiles, kSwSlots, "
                               f"kColsSlots) = {got}; ops has {want}")
        _lib = lib
    return _lib


def kernel_config(lib: ctypes.CDLL) -> dict:
    """The labels kernel's constants compiled into the library."""
    out = (ctypes.c_int * 5)()
    lib.fused_sw_config(out)
    return {"tile": out[0], "perm_pass": out[1], "threads": out[2],
            "strip_tiles": out[3], "slots": out[4]}


def cols_kernel_config(lib: ctypes.CDLL) -> dict:
    """The dense-design kernel's constants compiled into the library."""
    out = (ctypes.c_int * 4)()
    lib.fused_sw_cols_config(out)
    return {"strip_tiles": out[0], "q_pass": out[1], "k_chunk": out[2],
            "slots": out[3]}


def _strips(n: int, strip: int = STRIP_TILES) -> int:
    """Strips of `strip` column tiles covering n columns."""
    return -(-(-(-n // TILE)) // strip)


def _n_items(nr: int, n: int, symmetric: bool, strip: int) -> int:
    """Work items of a kernel whose item is a row tile and a strip of
    `strip` column tiles: a slab call has one per (row tile, strip); a
    symmetric call (the whole table against itself) one per strip at or
    past the diagonal, the strips starting at the diagonal tile and every
    `strip` tiles after it."""
    ntj = -(-n // TILE)
    if not symmetric:
        return -(-nr // TILE) * _strips(n, strip)
    return sum(ntj - c * strip for c in range(_strips(n, strip)))


def n_slots(nr: int, n: int, symmetric: bool,
            kernel: str = "fused_sw") -> int:
    """Blocks of a `kernel` launch ('fused_sw' or 'fused_sw_cols'):
    min(its most slots, work items), a function of the call's shape alone
    (never of P or of the card)."""
    strip, most = LAYOUT[kernel]
    return min(most, _n_items(nr, n, symmetric, strip))


def launch_bytes(nr: int, n: int, d: int, n_perms: int, *,
                 feat_bytes: float = 4.0, n_cols=None,
                 symmetric=None) -> float:
    """Device bytes one launch moves (the kernel and its slot sum), worked
    out from the source: per visited 64 x 64 tile its rows' and columns'
    features (d elements of `feat_bytes`; rows past nr, columns past n
    read nothing), and per (tile, pass) its column and row labels and the
    slot's running partial read and rewritten; the slots' partials zeroed
    at the start, their totals, and the slot sum (reads every slot's
    partials, writes the (P,) output). For a dense design (n_cols = K)
    the labels are the (P, n, K) f32 basis: the same walk over Q = P K
    columns. `symmetric` defaults to nr == n (the sweeps' whole-table
    call, tiles j >= i)."""
    sym = nr == n if symmetric is None else bool(symmetric)
    visits, cols, rows = tile_visit_elems(nr, n, TILE, sym)
    q = n_perms * (1 if n_cols is None else int(n_cols))
    slots = n_slots(nr, n, sym,
                    "fused_sw" if n_cols is None else "fused_sw_cols")
    return (feat_bytes * d * (cols + rows) + 4.0 * q * (cols + rows)
            + 8.0 * q * visits + 4.0 * q * slots + 8.0 * slots
            + 4.0 * q * slots + 8.0 * slots + 4.0 * q)


def row_sum_shape(nr: int, n: int, symmetric: bool,
                  kernel: str = "fused_sw") -> tuple:
    """Shape of the row-sum partials a `kernel` call writes when asked for
    its row sums: one row per strip and, for a symmetric call, one per row
    tile for its off-diagonal tiles' column sums, (strips + row tiles,
    n); a slab call (strips, nr). Only the wrappers' direct callers ask
    (row_sums=True); the sweeps take the slots' D2 totals."""
    strip = LAYOUT[kernel][0]
    if symmetric:
        return (_strips(n, strip) + -(-nr // TILE), n)
    return (_strips(n, strip), nr)


def partial_shapes(nr: int, n: int, n_perms: int, symmetric=None):
    """Shapes of the labels kernel's partials: s_W per (slot,
    permutation) and one f64 D2 total per slot plus the grand total (the
    slot sum's output), slots = n_slots(..., 'fused_sw'). Neither grows
    with n^2. `symmetric` defaults to nr == n (the sweep's whole-table
    call)."""
    sym = nr == n if symmetric is None else bool(symmetric)
    slots = n_slots(nr, n, sym, "fused_sw")
    return (slots, n_perms), (slots + 1,)


def alloc_workspace(nr: int, n: int, n_perms: int, device,
                    symmetric=None) -> tuple:
    """Scratch for launches of up to n_perms permutations over an nr-row
    slab, allocated once and reused by every chunk of a sweep: the (slots,
    P) f32 partials and the (slots + 1,) f64 totals."""
    sw_shape, tot_shape = partial_shapes(nr, n, n_perms, symmetric)
    return (torch.empty(sw_shape[0] * sw_shape[1], dtype=torch.float32,
                        device=device),
            torch.empty(tot_shape, dtype=torch.float64, device=device))


def workspace_bytes(nr: int, n: int, n_perms: int, symmetric=None) -> int:
    """Device bytes of a launch beside its operands: the workspace and
    the (P,) s_W it returns."""
    (a, b), (c,) = partial_shapes(nr, n, n_perms, symmetric)
    return 4 * a * b + 8 * c + 4 * n_perms


def cols_partial_shapes(nr: int, n: int, n_perms: int, n_cols: int,
                        symmetric=None):
    """Shapes of the dense-design kernel's partials: one (P * K) row per
    slot (n_slots(..., 'fused_sw_cols')) and the f64 totals as the labels
    kernel's. `symmetric` defaults to nr == n (the design sweep's
    whole-table call)."""
    sym = nr == n if symmetric is None else bool(symmetric)
    slots = n_slots(nr, n, sym, "fused_sw_cols")
    return (slots, n_perms * n_cols), (slots + 1,)


def alloc_cols_workspace(nr: int, n: int, n_perms: int, n_cols: int,
                         device, symmetric=None) -> tuple:
    """Scratch for dense-design launches of up to n_perms permutations and
    n_cols columns over an nr-row slab, allocated once and reused by every
    chunk of a sweep."""
    s_shape, tot_shape = cols_partial_shapes(nr, n, n_perms, n_cols,
                                             symmetric)
    return (torch.empty(s_shape[0] * s_shape[1], dtype=torch.float32,
                        device=device),
            torch.empty(tot_shape, dtype=torch.float64, device=device))


def cols_workspace_bytes(nr: int, n: int, n_perms: int, n_cols: int,
                         symmetric=None) -> int:
    """cols' workspace_bytes: its workspace and the (P, K) s_cols."""
    (a, b), (c,) = cols_partial_shapes(nr, n, n_perms, n_cols, symmetric)
    return 4 * a * b + 8 * c + 4 * n_perms * n_cols


def _check_common(x_rows, x, row_offset, metric, n_valid):
    """The checks both wrappers share: metric, feature tables, offset and
    n_valid."""
    if metric not in KERNEL_METRIC:
        raise ValueError(f"unknown fused metric {metric!r}; one of "
                         f"{sorted(KERNEL_METRIC)}")
    for name, t in (("x_rows", x_rows), ("x", x)):
        if t.dim() != 2 or t.shape[0] < 1 or t.shape[1] < 1:
            raise ValueError(f"{name} must be a non-empty 2-D tensor, got "
                             f"{tuple(t.shape)}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
    if x_rows.shape[1] != x.shape[1]:
        raise ValueError(f"feature widths differ: {x_rows.shape[1]} vs "
                         f"{x.shape[1]}")
    n = x.shape[0]
    if row_offset < 0:
        raise ValueError(f"row_offset must be >= 0, got {row_offset}")
    if not 1 <= n_valid <= n:
        raise ValueError(f"n_valid must be in [1, {n}], got {n_valid}")


def _check_devices(*tensors):
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"operands on different devices: {devices}")
    if tensors[0].device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {tensors[0].device}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("operands must be contiguous")


def _check(x_rows, x, g_rows, g_cols, inv_gs, row_offset, metric, n_valid):
    _check_common(x_rows, x, row_offset, metric, n_valid)
    nr, n = x_rows.shape[0], x.shape[0]
    if g_rows.dim() != 2 or g_cols.dim() != 2 \
            or tuple(g_rows.shape) != (g_cols.shape[0], nr) \
            or g_cols.shape[1] != n or g_cols.shape[0] < 1:
        raise ValueError(f"labels must be (P, {nr}) and (P, {n}) with "
                         f"P >= 1, got {tuple(g_rows.shape)} and "
                         f"{tuple(g_cols.shape)}")
    if g_rows.dtype != torch.int32 or g_cols.dtype != torch.int32:
        raise TypeError(f"labels must be int32, got {g_rows.dtype} and "
                        f"{g_cols.dtype}")
    if inv_gs.dim() != 1 or inv_gs.shape[0] < 1 \
            or inv_gs.dtype != torch.float32:
        raise TypeError("inv_gs must be a non-empty 1-D float32 tensor, got "
                        f"{inv_gs.dtype} {tuple(inv_gs.shape)}")
    _check_devices(x_rows, x, g_rows, g_cols, inv_gs)
    if g_cols.shape[0] >= 2 ** 31:
        raise ShapeNotSupported(f"P = {g_cols.shape[0]} exceeds the "
                                "kernel's slot sum")


def _check_cols(x_rows, x, v_rows, v_cols, row_offset, metric, n_valid):
    _check_common(x_rows, x, row_offset, metric, n_valid)
    nr, n = x_rows.shape[0], x.shape[0]
    if v_rows.dim() != 3 or v_cols.dim() != 3 \
            or tuple(v_rows.shape) != (v_cols.shape[0], nr, v_cols.shape[2]) \
            or v_cols.shape[1] != n or v_cols.shape[0] < 1 \
            or v_cols.shape[2] < 1:
        raise ValueError(f"basis factors must be (P, {nr}, K) and (P, {n}, "
                         f"K) with P, K >= 1, got {tuple(v_rows.shape)} and "
                         f"{tuple(v_cols.shape)}")
    if v_rows.dtype != torch.float32 or v_cols.dtype != torch.float32:
        raise TypeError(f"basis factors must be float32, got "
                        f"{v_rows.dtype} and {v_cols.dtype}")
    _check_devices(x_rows, x, v_rows, v_cols)
    if v_cols.shape[0] * v_cols.shape[2] >= 2 ** 31:
        raise ShapeNotSupported(
            f"P * K = {v_cols.shape[0] * v_cols.shape[2]} exceeds the "
            "kernel's slot sum")


def quantize_slabs(x_rows, x, mode, scale=None):
    """(xr, xc): the slab and the table in the mode's representation
    (ref.resolve_precision gives mode and scale), as the kernel reads
    them: f32 as given; bf16 cast; fp8 e4m3 bytes of x / scale
    (core.distance.fp8_quantize); packed 32-bit presence words (int32
    holding the reference's uint32 bits; the feature axis becomes
    ceil(d / 32) words). A slab that is the table itself is quantized
    once."""
    def q(t):
        if mode == "bf16":
            return t.to(torch.bfloat16)
        if mode == "fp8":
            return distance.fp8_quantize(t, scale)
        if mode == "packed":
            return distance.pack_presence_bits(t)
        return t
    xc = q(x)
    same = x_rows.data_ptr() == x.data_ptr() and x_rows.shape == x.shape
    return (xc if same else q(x_rows)), xc


def _workspace_views(workspace, shapes, alloc, what):
    """(partials (slots, Q) view, totals) of a workspace holding at least
    `shapes` (allocated by `alloc` when None)."""
    (slots, q), (n_tot,) = shapes
    part, tot = alloc() if workspace is None else workspace
    if part.numel() < slots * q or tot.numel() < n_tot:
        raise ValueError(f"workspace too small for {what}")
    return part[:slots * q].view(slots, q), tot[:n_tot]


def _row_sum_buffer(nr, n, symmetric, kernel, row_sums, device):
    """The zeroed row-sum partials of a call that asks for its row sums
    (row_sum_shape; the kernel writes only the rows it visits), else
    None."""
    if not row_sums:
        return None
    return torch.zeros(row_sum_shape(nr, n, symmetric, kernel),
                       dtype=torch.float32, device=device)


def _launch(lib, metric, mode, x_rows, x, scale, g_rows, g_cols, inv_gs,
            row_offset, n_valid, stream: int, workspace=None,
            symmetric=False, row_sums=True):
    """Launch the mode's kernel on `stream` over quantized features
    (quantize_slabs) and the fp8 scale (a float32 scalar on the device,
    or None), then the fixed-order slot sum; (s_W (P,), row_sums (nr,))
    or, with row_sums=False, (s_W (P,), the slab's D2 total 0-d f64).
    `workspace` (alloc_workspace()) holds at least this call's;
    `symmetric` (is_symmetric_call on the f32 operands) visits the column
    tiles j >= i only."""
    nr, n, d = x_rows.shape[0], x.shape[0], x.shape[1]
    p, n_groups = g_cols.shape[0], inv_gs.shape[0]
    part, tot = _workspace_views(
        workspace, partial_shapes(nr, n, p, symmetric),
        lambda: alloc_workspace(nr, n, p, x.device, symmetric),
        f"{p} permutations over ({nr}, {n})")
    rs_part = _row_sum_buffer(nr, n, symmetric, "fused_sw", row_sums,
                              x.device)
    sw = torch.empty(p, dtype=torch.float32, device=x.device)
    err = lib.fused_sw_launch(
        _KIND[KERNEL_METRIC[metric]], _MODE[mode], x_rows.data_ptr(),
        x.data_ptr(), None if scale is None else scale.data_ptr(),
        g_rows.data_ptr(), g_cols.data_ptr(), inv_gs.data_ptr(),
        part.data_ptr(), tot.data_ptr(),
        None if rs_part is None else rs_part.data_ptr(), sw.data_ptr(),
        tot[-1:].data_ptr(), nr, n, d, p, n_groups, row_offset, n_valid,
        int(symmetric), stream)
    key = launch_key("fused_sw", mode)
    if err != 0:
        raise RuntimeError(f"{key} kernel launch failed: cudaError {err}")
    LAUNCHES[key] += 1
    cudahooks.count_launch(key)
    if rs_part is None:
        return sw, tot[-1].clone()
    return sw, rs_part.sum(dim=0)


def fused_sw_rows(x_rows: torch.Tensor, x: torch.Tensor,
                  g_rows: torch.Tensor, g_cols: torch.Tensor,
                  inv_gs: torch.Tensor, row_offset: int = 0, *,
                  metric: str = "braycurtis", n_valid=None,
                  tile_r: int = 128, tile_c: int = 128,
                  feat_block: int = 128, perm_block: int = 16,
                  feat_bf16: int = 0, feat_fp8: int = 0,
                  feat_packed: int = 0, feat_scale=None, workspace=None,
                  row_sums: bool = True, quantized=None):
    """Fused s_W partial for one (row slab x permutation chunk) cell.

    x_rows:   (nr, d) f32 prepared features of the slab's rows.
    x:        (n, d) f32 prepared features of ALL samples (columns).
    g_rows:   (P, nr) int32 permuted labels at the slab's GLOBAL rows.
    g_cols:   (P, n) int32 permuted labels over all samples.
    inv_gs:   (G,) f32 inverse group sizes.
    row_offset: global index of x_rows[0].
    n_valid:  global sample count (pad masking); defaults to n.
    metric:   'euclidean' | 'braycurtis' | 'jaccard' (on presence 0/1
              floats) | 'aitchison' (euclidean over clr features).

    tile_r / tile_c / feat_block / perm_block are the reference's Pallas
    tile knobs: accepted and ignored, since the CUDA kernel's shape is
    fixed: a block owns a 64-row tile and a strip of SW_STRIP_TILES
    64-column tiles, builds each D^2 tile once from 32-feature chunks and
    applies it to every permutation of the call in passes of SW_PASS (one
    accumulator per (row, permutation) in registers). A launch has at
    most SW_SLOTS blocks; each walks a fixed list of (row tile, strip) work
    items with one running s_W partial per permutation, and a second
    kernel sums the slots in a fixed order, so the partials do not grow
    with n^2 and a permutation's s_W is the same bits in any chunk. A
    whole-table call (is_symmetric_call: the sweep's) visits only the
    tiles j >= i.

    Precision knobs (mutually exclusive; the features stay f32 here, the
    wrapper quantizes them):
    feat_bf16:   1 = bf16 features (half the feature bytes; f32 sums).
    feat_fp8:    1 = float8_e4m3fn features x / s with one calibration
                 scale s (max|x| / 448 of the full table, or feat_scale),
                 cast up and multiplied by s as the kernel stages them.
    feat_packed: 1 = 32-bit presence words (jaccard only): popcount
                 bodies, the same bits as the f32 jaccard kernel on
                 presence data.
    feat_scale:  pins the fp8 scale (a float or a one-element tensor;
                 sweeps compute it once per study).

    workspace: partial buffers from alloc_workspace(), reused across the
    chunks of a sweep (allocated per call when None; unused on the CPU).
    row_sums: True (the default, as the reference's) returns the (nr,)
    row sums, from (strips [+ row tiles], n) partials allocated for the
    call; False (the sweeps') returns the slab's D2 total instead, a 0-d
    float64 (sum_r row_sums[r]), from the slots' totals.
    quantized: the (xr, xc) pair quantize_slabs gives for these operands
    at this precision, made once by a sweep that launches on the same
    table many times (so the quantization and its transients are not
    paid a launch); None quantizes here. Unused on the CPU.

    Returns (s_W (P,) f32, row_sums (nr,) f32) or, with row_sums=False,
    (s_W (P,) f32, total 0-d f64). Summing the outputs over disjoint row
    slabs gives the full statistic and the full row sums (or total).
    """
    del tile_r, tile_c, feat_block, perm_block
    n_valid = x.shape[0] if n_valid is None else int(n_valid)
    row_offset = int(row_offset)
    _check(x_rows, x, g_rows, g_cols, inv_gs, row_offset, metric, n_valid)
    precision = dict(feat_bf16=feat_bf16, feat_fp8=feat_fp8,
                     feat_packed=feat_packed, feat_scale=feat_scale)
    if x.device.type == "cpu":
        sw, rs = ref.fused_sw_ref(x_rows, x, g_rows, g_cols, inv_gs,
                                  row_offset, metric=metric, n_valid=n_valid,
                                  **precision)
        return sw, (rs if row_sums else rs.sum(dtype=torch.float64))
    mode, scale = ref.resolve_precision(x, metric, **precision)
    lib = load_library()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    sym = is_symmetric_call(x_rows, x, g_rows, g_cols, row_offset)
    xr, xc = (quantize_slabs(x_rows, x, mode, scale) if quantized is None
              else quantized)
    return _launch(lib, metric, mode, xr, xc, scale, g_rows, g_cols, inv_gs,
                   row_offset, n_valid, stream, workspace, sym, row_sums)


def is_symmetric_call(x_rows, x, r_rows, r_cols, row_offset) -> bool:
    """Whether a call of either kernel covers the whole table against
    itself: the slab is the table and its row operand the columns' (the
    labels, or the basis of a dense design; the same storage, offset 0),
    so the kernel visits the column tiles j >= i only."""
    return (row_offset == 0 and x_rows.data_ptr() == x.data_ptr()
            and x_rows.shape == x.shape
            and r_rows.data_ptr() == r_cols.data_ptr()
            and r_rows.shape == r_cols.shape)


def _launch_cols(lib, metric, mode, x_rows, x, scale, v_rows, v_cols,
                 row_offset, n_valid, stream: int, workspace=None,
                 symmetric=False, row_sums=True):
    """Launch the mode's dense-design kernel on `stream` over quantized
    features (quantize_slabs), then the fixed-order slot sum; (s_cols (P,
    K), row_sums (nr,)) or, with row_sums=False, (s_cols (P, K), the
    slab's D2 total 0-d f64). `workspace` (alloc_cols_workspace()) holds
    at least this call's; `symmetric` (is_symmetric_call on the f32
    operands) visits the column tiles j >= i only."""
    nr, n, d = x_rows.shape[0], x.shape[0], x.shape[1]
    p, k = v_cols.shape[0], v_cols.shape[2]
    part, tot = _workspace_views(
        workspace, cols_partial_shapes(nr, n, p, k, symmetric),
        lambda: alloc_cols_workspace(nr, n, p, k, x.device, symmetric),
        f"{p} permutations x {k} columns over ({nr}, {n})")
    rs_part = _row_sum_buffer(nr, n, symmetric, "fused_sw_cols", row_sums,
                              x.device)
    s_cols = torch.empty((p, k), dtype=torch.float32, device=x.device)
    err = lib.fused_sw_cols_launch(
        _KIND[KERNEL_METRIC[metric]], _MODE[mode], x_rows.data_ptr(),
        x.data_ptr(), None if scale is None else scale.data_ptr(),
        v_rows.data_ptr(), v_cols.data_ptr(), part.data_ptr(),
        tot.data_ptr(), None if rs_part is None else rs_part.data_ptr(),
        s_cols.data_ptr(), tot[-1:].data_ptr(), nr, n, d, p, k, row_offset,
        n_valid, int(symmetric), stream)
    key = launch_key("fused_sw_cols", mode)
    if err != 0:
        raise RuntimeError(f"{key} kernel launch failed: cudaError {err}")
    LAUNCHES[key] += 1
    cudahooks.count_launch(key)
    if rs_part is None:
        return s_cols, tot[-1].clone()
    return s_cols, rs_part.sum(dim=0)


def fused_sw_rows_cols(x_rows: torch.Tensor, x: torch.Tensor,
                       v_rows: torch.Tensor, v_cols: torch.Tensor,
                       row_offset: int = 0, *, metric: str = "braycurtis",
                       n_valid=None, feat_bf16: int = 0, feat_fp8: int = 0,
                       feat_packed: int = 0, feat_scale=None,
                       workspace=None, row_sums: bool = True,
                       quantized=None):
    """Dense-design fused partial: per-COLUMN quadratic forms for one (row
    slab x permutation chunk) cell (core.design's hat-matrix blocks in
    place of the one-hot labels).

    x_rows:   (nr, d) f32 prepared features of the slab's rows.
    x:        (n, d) f32 prepared features of ALL samples (columns).
    v_rows:   (P, nr, K) f32 permuted basis rows at the slab's GLOBAL rows.
    v_cols:   (P, n, K) f32 permuted basis over all samples.
    row_offset / n_valid / metric and the precision knobs (feat_bf16 /
    feat_fp8 / feat_packed / feat_scale): as fused_sw_rows.

    workspace: partial buffers from alloc_cols_workspace(), reused across
    the chunks of a sweep (allocated per call when None; unused on the
    CPU). row_sums and quantized: as fused_sw_rows'.

    Returns (s_cols (P, K) f32, row_sums (nr,) f32) or, with
    row_sums=False, (s_cols (P, K) f32, total 0-d f64). Summing the
    outputs over disjoint row slabs gives the full per-column statistic
    and the full row sums (or total).
    """
    n_valid = x.shape[0] if n_valid is None else int(n_valid)
    row_offset = int(row_offset)
    _check_cols(x_rows, x, v_rows, v_cols, row_offset, metric, n_valid)
    precision = dict(feat_bf16=feat_bf16, feat_fp8=feat_fp8,
                     feat_packed=feat_packed, feat_scale=feat_scale)
    if x.device.type == "cpu":
        sc, rs = ref.fused_sw_cols_ref(x_rows, x, v_rows, v_cols,
                                       row_offset, metric=metric,
                                       n_valid=n_valid, **precision)
        return sc, (rs if row_sums else rs.sum(dtype=torch.float64))
    mode, scale = ref.resolve_precision(x, metric, **precision)
    lib = load_library()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    sym = is_symmetric_call(x_rows, x, v_rows, v_cols, row_offset)
    xr, xc = (quantize_slabs(x_rows, x, mode, scale) if quantized is None
              else quantized)
    return _launch_cols(lib, metric, mode, xr, xc, scale, v_rows, v_cols,
                        row_offset, n_valid, stream, workspace, sym,
                        row_sums)
