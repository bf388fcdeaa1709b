"""The port's permanova_sw plain forms and wrapper against the reference's
Pallas kernels (interpret mode), plus the wrapper's contract and the
kernel build/binding. The CUDA kernels themselves run only on the card;
`chip_smoke.py` holds them against these plain versions there."""

import functools
import os
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

# Plans follow the planner's rules, never a winner persisted in the
# host's default autotune cache (the reference's conftest turns its
# own off); tests of the cache point it at files of their own.
os.environ.setdefault("REPRO_TORCH_AUTOTUNE_CACHE", "off")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import permutations as jperm  # noqa: E402
from repro.kernels.permanova_sw import ops as jops  # noqa: E402
from repro_torch.compat import from_reference  # noqa: E402
from repro_torch.core import fstat  # noqa: E402
from repro_torch.core import permutations as tperm  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.permanova_sw import ops, ref  # noqa: E402

# The reference's kernel sweep (tests/test_kernels_permanova.py):
# (n, n_groups, n_perms, tile, perm_block).
SHAPES = [
    (32, 2, 4, 16, 2),
    (48, 3, 7, 16, 4),
    (64, 5, 16, 32, 8),
    (96, 4, 6, 32, 3),
    (130, 2, 5, 32, 4),     # ragged: padding path
    (57, 7, 9, 16, 16),     # perm_block > n_perms
]
RTOL, ATOL = 5e-5, 1e-5     # the reference's own kernel bar


def _instance(n, g, p, seed=0):
    """numpy (mat2, labels, inv_gs), as the reference's kernel test."""
    rng = np.random.default_rng(seed)
    d = rng.random((n, n)).astype(np.float32)
    d = (d + d.T) / 2
    np.fill_diagonal(d, 0.0)
    grouping = rng.integers(0, g, size=n).astype(np.int32)
    grouping[:g] = np.arange(g)
    inv_gs = np.array(jperm.inv_group_sizes(jnp.asarray(grouping), g))
    gperms = np.stack([rng.permutation(grouping) for _ in range(p)])
    gperms[0] = grouping
    return d * d, gperms.astype(np.int32), inv_gs


def _shape_instance(shape):
    n, g, p, _, _ = shape
    return _instance(n, g, p, seed=n + g + p)


@functools.lru_cache(maxsize=None)
def _jax_sw(variant, shape):
    mat2, gperms, inv_gs = _shape_instance(shape)
    _, _, _, tile, pb = shape
    return np.asarray(jops.permanova_sw(
        jnp.asarray(mat2), jnp.asarray(gperms), jnp.asarray(inv_gs),
        variant=variant, tile_r=tile, tile_c=tile, perm_block=pb))


PORT_FORMS = {
    "sw_brute": lambda m, g, w, v: fstat.sw_brute(m, g, w, block=3),
    "sw_tiled": lambda m, g, w, v: fstat.sw_tiled(m, g, w, tile=16, block=2),
    "sw_matmul": lambda m, g, w, v: fstat.sw_matmul(m, g, w, perm_block=4),
    "sw_ref": lambda m, g, w, v: ref.sw_ref(m, g, w),
    "ops.permanova_sw": lambda m, g, w, v: ops.permanova_sw(m, g, w,
                                                            variant=v),
}


@pytest.mark.parametrize("form", sorted(PORT_FORMS))
@pytest.mark.parametrize("variant", jops.VARIANTS)
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "n{}g{}p{}".format(*s))
def test_port_matches_reference_kernel(form, variant, shape):
    mat2, gperms, inv_gs = _shape_instance(shape)
    got = PORT_FORMS[form](torch.from_numpy(mat2), torch.from_numpy(gperms),
                           torch.from_numpy(inv_gs), variant)
    assert got.dtype == torch.float32 and got.shape == (shape[2],)
    np.testing.assert_allclose(got.numpy(), _jax_sw(variant, shape),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("n,g", [(37, 4), (53, 5), (9, 8), (32, 3)])
@pytest.mark.parametrize("form", sorted(PORT_FORMS))
def test_port_matches_algorithm1(form, n, g):
    """Prime n (the tiled sentinel pad) and singleton groups (9, 8)."""
    mat2, gperms, inv_gs = _instance(n, g, 5, seed=n * g)
    oracle = fstat.sw_algorithm1_numpy(np.sqrt(mat2), gperms, inv_gs)
    got = PORT_FORMS[form](torch.from_numpy(mat2), torch.from_numpy(gperms),
                           torch.from_numpy(inv_gs), "brute")
    np.testing.assert_allclose(got.numpy(), oracle, rtol=RTOL, atol=ATOL)


def test_bf16_matmul_on_cpu_within_reference_bar():
    """bf16 mat2 through the wrapper: its plain version sees what the
    kernel sees (bf16 operands, sqrt(w) rounded to bf16) and stays within
    the reference's 5e-3 bar of the float64 result."""
    mat2, gperms, inv_gs = _instance(64, 4, 8, seed=3)
    m16 = torch.from_numpy(mat2).to(torch.bfloat16)
    got = ops.permanova_sw(m16, torch.from_numpy(gperms),
                           torch.from_numpy(inv_gs), variant="matmul")
    ref64 = ref.sw_ref_f64(mat2, gperms, inv_gs)
    rel = np.max(np.abs(got.double().numpy() - ref64) / np.abs(ref64))
    assert rel < 5e-3, f"bf16 matmul rel err {rel}"
    jax16 = np.asarray(jops.permanova_sw(
        jnp.asarray(mat2).astype(jnp.bfloat16), jnp.asarray(gperms),
        jnp.asarray(inv_gs), variant="matmul", tile_r=32, tile_c=32,
        perm_block=4))
    np.testing.assert_allclose(got.numpy(), jax16, rtol=1e-3)


def test_sw_ref_f64_matches_reference():
    mat2, gperms, inv_gs = _instance(40, 3, 4, seed=1)
    from repro.kernels.permanova_sw import ref as jref
    np.testing.assert_allclose(
        ref.sw_ref_f64(torch.from_numpy(mat2), torch.from_numpy(gperms),
                       torch.from_numpy(inv_gs)),
        jref.sw_ref_f64(mat2, gperms, inv_gs), rtol=1e-12)


def test_cpu_calls_launch_nothing():
    mat2, gperms, inv_gs = _instance(32, 2, 3)
    before = dict(ops.LAUNCHES)
    for v in ops.VARIANTS:
        ops.permanova_sw(torch.from_numpy(mat2), torch.from_numpy(gperms),
                         torch.from_numpy(inv_gs), variant=v)
    assert ops.LAUNCHES == before
    assert set(ops.LAUNCHES) == set(ops.VARIANTS) | {"brute_rows"}


def _operands():
    mat2, gperms, inv_gs = _instance(16, 2, 3)
    return (torch.from_numpy(mat2), torch.from_numpy(gperms),
            torch.from_numpy(inv_gs))


@pytest.mark.parametrize("case,exc", [
    ("unknown_variant", ValueError),
    ("mat2_not_square", ValueError),
    ("mat2_f64", TypeError),
    ("bf16_brute", TypeError),
    ("labels_int64", TypeError),
    ("labels_wrong_n", ValueError),
    ("weights_f64", TypeError),
    ("not_contiguous", ValueError),
    ("mixed_devices", ValueError),
])
def test_wrapper_rejects(case, exc):
    m, g, w = _operands()
    variant = "brute"
    if case == "unknown_variant":
        variant = "pallas"
    elif case == "mat2_not_square":
        m = m[:, :8].contiguous()
    elif case == "mat2_f64":
        m = m.double()
    elif case == "bf16_brute":
        m = m.to(torch.bfloat16)
    elif case == "labels_int64":
        g = g.long()
    elif case == "labels_wrong_n":
        g = g[:, :8].contiguous()
    elif case == "weights_f64":
        w = w.double()
    elif case == "not_contiguous":
        m = m.T
    elif case == "mixed_devices":
        g = g.to("meta")
    with pytest.raises(exc):
        ops.permanova_sw(m, g, w, variant=variant)


def test_make_sw_fn_plugs_into_engine():
    from repro.core import permanova as jpermanova
    from repro_torch import engine
    rng = np.random.default_rng(4)
    x = rng.random((40, 12)).astype(np.float32)
    d = np.abs(x[:, None, :] - x[None, :, :]).sum(-1).astype(np.float32)
    grouping = rng.integers(0, 3, size=40).astype(np.int32)
    grouping[:3] = np.arange(3)
    _, _, perms = from_reference(perms=jperm.permutation_batch(
        jax.random.key(0), jnp.asarray(grouping), 0, 20), device="cpu")
    res_j = jpermanova(jnp.asarray(d), jnp.asarray(grouping), n_perms=19,
                       sw_fn=jops.make_sw_fn("matmul", tile_r=16, tile_c=16,
                                             perm_block=4))
    res_t = engine.run(torch.from_numpy(d), torch.from_numpy(grouping),
                       n_perms=19, perms=perms,
                       sw_fn=ops.make_sw_fn("matmul"), device="cpu")
    np.testing.assert_allclose(float(res_t.f_stat), float(res_j.f_stat),
                               rtol=1e-4)
    assert float(res_t.p_value) == float(res_j.p_value)
    assert res_t.plan == res_j.plan     # <custom sw_fn>[perm_block=64] ...


# ---------------------------------------------------------------------------
# Build and binding (the compile itself happens on the card's machine).
# ---------------------------------------------------------------------------

def test_nvcc_command_targets_sm90a(tmp_path):
    src = tmp_path / "k.cu"
    src.write_text("// empty\n")
    cmd = _build.nvcc_command("nvcc", src, tmp_path / "k.so")
    assert cmd[:3] == ["nvcc", "-gencode", "arch=compute_90a,code=sm_90a"]
    for flag in ("-std=c++17", "-O3", "-shared", "-fPIC"):
        assert flag in cmd


def test_library_path_keyed_by_source(tmp_path):
    src = tmp_path / "k.cu"
    src.write_text("// one\n")
    first = _build.library_path(src)
    assert first.parent == _build.BUILD_DIR
    assert _build.library_path(src) == first
    src.write_text("// two\n")
    assert _build.library_path(src) != first
    assert _build.BUILD_DIR.relative_to(_build.REPO_ROOT).parts == (
        "build", "repro_torch")


def test_missing_nvcc_raises_without_fallback(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "b")
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build.os.path, "isfile", lambda p: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build(ops.SOURCE)
    assert not (tmp_path / "b").exists()


def _c_params(source: str, name: str):
    m = re.search(rf"\b{name}\(([^)]*)\)\s*\{{", source)
    assert m, name
    return [p.strip() for p in m.group(1).split(",") if p.strip()]


@pytest.mark.parametrize("name", sorted(ops.SIGNATURES))
def test_ctypes_signature_matches_source(name):
    """Every pointer parameter of a C entry point is bound as c_void_p
    (else ctypes cuts it to 32 bits), every integer at its C width."""
    import ctypes
    params = _c_params(ops.SOURCE.read_text(), name)
    argtypes, restype = ops.SIGNATURES[name]
    assert len(params) == len(argtypes)
    for p, t in zip(params, argtypes):
        if "*" in p:
            assert t is ctypes.c_void_p, p
        elif p.startswith("long long"):
            assert t is ctypes.c_longlong, p
        else:
            assert p.startswith("int ") and t is ctypes.c_int, p
    assert restype is (None if name == "sw_kernel_config" else ctypes.c_int)


def test_source_names_the_kernels_it_replaces():
    """Each kernel names the TPU kernel it replaces; brute's note says what
    bounds it now (its instruction rate: an integer compare and a predicated
    add per (pair, permutation), its INT32 floor) and keeps Algorithm 3's
    form: a same-group test per (pair, permutation), no one-hot product,
    no tensor cores; no atomics anywhere."""
    src = ops.SOURCE.read_text()
    for fn in ("sw_brute_pallas", "sw_permblock_pallas", "sw_matmul_pallas"):
        assert f"kernels/permanova_sw/kernel.py:{fn}" in src
    assert "atomicAdd" not in src    # partials + torch.sum, not atomics
    brute = src[src.index("// brute —"):src.index("// permblock —")]
    for needle in ("instruction rate: an integer compare", "INT32 pipe",
                   "if (g == gc[k].x) acc[r][k] += m.x;",
                   "const bool ok = i < row_end && j < n && j > i;",
                   "row_weight(gr[r][k], w, n_groups)"):
        assert needle in brute, needle
    assert "wgmma" not in brute.split("// ----")[-1]
    # the row-slab entry refuses an offset off the 64-row band
    assert "row_offset % kBruteRows != 0" in src


def test_brute_band_tile_and_partials_from_the_source():
    """The brute kernel's band (64 rows), column tile (64) and
    permutation block (128), and the permblock kernel's pass (128) and
    strip (16 column tiles), are compile-time constants reported by
    sw_kernel_config; the wrapper sizes the brute partials (P, ceil(n /
    64)) and the permblock partials (blocks, P) from that report (a
    stand-in library fills every partial with 1, so each permutation's
    s_W is the band count, or the block count), and brute's grid is
    (ceil(P / 128), ceil(n / 64)), permblock's pb_blocks(ceil(n / 64))."""
    import ctypes
    src = ops.SOURCE.read_text()
    consts = dict(re.findall(r"constexpr int (kBrute(?:Rows|Cols|Perms)) = "
                             r"(\d+);", src))
    assert consts == {"kBruteRows": "64", "kBruteCols": "64",
                      "kBrutePerms": "128"}
    assert "constexpr int kPbStripTiles = 16;" in src
    assert "constexpr int kPbPass = kBrutePerms;" in src
    assert ops.PERMBLOCK_TILE == 64 and ops.PERMBLOCK_STRIP_TILES == 16
    for i, name in ((0, "kBruteRows"), (1, "kPbPass"), (2, "kBruteRows"),
                    (6, "kBruteCols"), (7, "kBrutePerms"),
                    (8, "kPbStripTiles")):
        assert f"out[{i}] = {name};" in src
    assert "const dim3 grid((unsigned)((n_perms + kBrutePerms - 1) / " \
        "kBrutePerms),\n                  (unsigned)((n + kBruteRows - 1) " \
        "/ kBruteRows));" in src
    assert "2 * kBruteStageBytes;  // 102,400" in src
    assert "const int64_t blocks = pb_blocks((n + kBruteCols - 1) / " \
        "kBruteCols);" in src
    assert "static_assert(kPbSmemBytes == 90112" in src

    class StandIn:
        def sw_kernel_config(self, out):
            for i, v in enumerate((64, 128, 64, 64, 128, 256, 64, 128, 16)):
                out[i] = v

        def _fill(self, partials, shape):
            self.shape = shape
            arr = (ctypes.c_float * (shape[0] * shape[1])).from_address(
                partials)
            for i in range(len(arr)):
                arr[i] = 1.0
            return 0

        def sw_brute_launch(self, mat2, g, w, partials, n, p, n_groups,
                            stream):
            return self._fill(partials, (p, -(-n // 64)))

        def sw_permblock_launch(self, mat2, g, w, partials, n, p,
                                n_groups, stream):
            return self._fill(partials, (ops.permblock_blocks(n), p))

    lib = StandIn()
    assert ops.kernel_config(lib) == {
        "brute_rows": 64, "permblock_pass": 128, "permblock_tile": 64,
        "matmul_rows": 64, "matmul_max_perm_block": 128,
        "matmul_columns": 256, "brute_cols": 64, "brute_perms": 128,
        "permblock_strip_tiles": 16}
    mat2, gperms, inv_gs = _instance(130, 3, 5, seed=2)
    before = dict(ops.LAUNCHES)
    got = ops._launch(lib, "brute", torch.from_numpy(mat2),
                      torch.from_numpy(gperms), torch.from_numpy(inv_gs), 0)
    assert lib.shape == (5, 3)
    assert got.tolist() == [3.0] * 5
    mat2, gperms, inv_gs = _instance(1100, 3, 5, seed=2)
    got = ops._launch(lib, "permblock", torch.from_numpy(mat2),
                      torch.from_numpy(gperms), torch.from_numpy(inv_gs), 0)
    # 18 bands: strips at offset 0 (18 blocks) and 16 (2 blocks)
    assert lib.shape == (20, 5) and ops.permblock_blocks(1100) == 20
    assert got.tolist() == [20.0] * 5
    ops.LAUNCHES.update(before)


def _permblock_blocks_in_order(n):
    """The permblock kernel's blocks in launch order (pb_block in the
    source) as (band, first column tile): the strips of 16 column tiles
    that start at each band's diagonal tile and every 16 tiles after it,
    strip offset first."""
    t, s = ops.PERMBLOCK_TILE, ops.PERMBLOCK_STRIP_TILES
    nt = -(-n // t)
    return [(ti, ti + c * s) for c in range(-(-nt // s))
            for ti in range(nt - c * s)]


def _permblock_model(mat2, labels, w):
    """s_W the permblock kernel's way, in float64: per block, its strip's
    tiles of the upper triangle (the diagonal tile keeps j > i), every
    permutation applied to each staged tile, w[g_r] once per (row,
    permutation), one partial per (block, permutation); the partials
    summed over the blocks."""
    n, t = mat2.shape[0], ops.PERMBLOCK_TILE
    m = torch.triu(torch.from_numpy(mat2).double(), diagonal=1)
    g = torch.from_numpy(labels).long()
    wr = torch.from_numpy(w).double()[g]                     # (P, n)
    blocks = _permblock_blocks_in_order(n)
    partials = torch.zeros(len(blocks), labels.shape[0], dtype=torch.float64)
    nt = -(-n // t)
    for b, (ti, jt0) in enumerate(blocks):
        rows = slice(ti * t, min(n, ti * t + t))
        for jt in range(jt0, min(nt, jt0 + ops.PERMBLOCK_STRIP_TILES)):
            cols = slice(jt * t, min(n, jt * t + t))
            same = g[:, rows, None] == g[:, None, cols]      # (P, r, c)
            per_row = (same * m[rows, cols]).sum(-1)         # (P, r)
            partials[b] += (per_row * wr[:, rows]).sum(-1)
    return partials.sum(0)


@pytest.mark.parametrize("n,p", [(63, 3), (64, 5), (65, 4), (130, 7),
                                 (1023, 2), (1025, 3), (1100, 2)])
def test_permblock_blocks_cover_the_upper_triangle_once(n, p):
    """The kernel's strips of 16 tiles per band visit every tile j >= i
    once (ops.permblock_blocks counts them: 5,025 at the EMP n), and the
    per-(block, permutation) partials sum to the plain s_W."""
    nt = -(-n // ops.PERMBLOCK_TILE)
    blocks = _permblock_blocks_in_order(n)
    assert len(blocks) == ops.permblock_blocks(n)
    tiles = [(ti, jt) for ti, jt0 in blocks
             for jt in range(jt0, min(nt, jt0 + ops.PERMBLOCK_STRIP_TILES))]
    assert sorted(tiles) == [(i, j) for i in range(nt) for j in range(i, nt)]
    assert ops.permblock_blocks(25145) == 5025
    mat2, gperms, inv_gs = _instance(n, 4, p, seed=n)
    np.testing.assert_allclose(
        _permblock_model(mat2, gperms, inv_gs).numpy(),
        ref.sw_ref_f64(mat2, gperms, inv_gs), rtol=1e-12)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "n{}g{}p{}".format(*s))
def test_permblock_model_matches_reference_permblock_kernel(shape):
    """The tiled dataflow the card runs (the kernel's block decomposition,
    every permutation per staged tile) against the reference's
    pallas_permblock kernel (interpret mode) at ragged n and P."""
    mat2, gperms, inv_gs = _shape_instance(shape)
    np.testing.assert_allclose(_permblock_model(mat2, gperms, inv_gs),
                               _jax_sw("permblock", shape), rtol=RTOL,
                               atol=ATOL)


def test_matmul_perm_block_fills_128_onehot_columns():
    """The matmul kernel fixes its perm block from G in the source: as
    many permutations as fill a slice of one-hot columns, at least one.
    The slice is 256 columns wide (32 permutations at G = 8), double the
    128 of the CUDA-core design; the perm block is capped at 128 (only
    G = 1 fills half the slice), and kernel_config reports both
    (matmul_columns, matmul_max_perm_block)."""
    src = ops.SOURCE.read_text()
    assert ("return n_groups >= kMN ? 1 : (kMN / n_groups < kMaxPB ? "
            "kMN / n_groups") in src
    assert "constexpr int kMN = 256;" in src
    assert "constexpr int kMaxPB = 128;" in src
    assert "out[4] = kMaxPB;" in src and "out[5] = kMN;" in src


def test_matmul_source_is_the_tensor_core_design():
    """The matmul kernel runs on the tensor cores (wgmma: two TF32
    products on f32 mat2, one bf16 product on bf16, A from registers, the
    0/1 B tile from shared memory), splits f32 with cvt.rna.tf32, builds
    its B tile from labels, stages through a cp.async ring in dynamic
    shared memory it raises past 48 KB, and calls no library GEMM."""
    src = ops.SOURCE.read_text()
    for needle in ("wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32",
                   "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16",
                   "fence.proxy.async.shared::cta",
                   "cvt.rna.tf32.f32", "cp.async.ca.shared.global",
                   "cp.async.wait_group", "constexpr int kStages = 4;",
                   "cudaFuncAttributeMaxDynamicSharedMemorySize",
                   "E has no low part"):
        assert needle in src, needle
    assert "cublas" not in src.lower() and "cutlass" not in src.lower()


def _onehot_split_sw(mat2, labels, inv_gs, products):
    """s_W as the matmul kernel computes it on f32 mat2, in plain torch:
    the exact 0/1 factor against tf32(x) (products=1) or tf32(x) and
    tf32(x - tf32(x)) (products=2), exact products summed in float64,
    then the weights sqrt(w)^2 applied per row's own group."""
    hi = ref.tf32_round(mat2)
    parts = [hi] if products == 1 else [hi, ref.tf32_round(mat2 - hi)]
    m = sum(part.double() for part in parts)
    sw = ops._rounded_sqrt_w(inv_gs, torch.float32)
    w = (sw * sw).double()
    out = []
    for g in labels.long():
        e = torch.nn.functional.one_hot(g, inv_gs.shape[0]).double()
        y = m @ e                                   # (n, G)
        out.append(0.5 * float((y * e * w[None, :]).sum()))
    return torch.tensor(out, dtype=torch.float64)


def test_tf32_round_is_round_to_nearest_ties_away():
    x = torch.tensor([1.0, 1.0 + 2.0 ** -11, 1.0 + 2.0 ** -10 + 2.0 ** -11,
                      -(1.0 + 2.0 ** -11), 1.0 + 2.0 ** -12, 3.0e-3],
                     dtype=torch.float32)
    got = ref.tf32_round(x)
    want = [1.0, 1.0 + 2.0 ** -10, 1.0 + 2.0 ** -9, -(1.0 + 2.0 ** -10),
            1.0]
    assert got[:5].tolist() == want
    bits = got.view(torch.int32)
    assert bool(((bits & 0x1FFF) == 0).all())
    assert abs(float(got[5]) - 3.0e-3) <= 3.0e-3 * 2.0 ** -11


def test_two_tf32_products_reproduce_f32_and_one_does_not():
    """At a small shape the kernel's split (exact 0/1 factor, hi = tf32(x),
    lo = tf32(x - hi), two exact products) gives the f32 s_W within 1e-6
    relative, the bar the kernel is held to at the main path's shape,
    while a single TF32 pass misses it: why the split is needed, and that
    two products suffice (the factor has no low part)."""
    mat2, gperms, inv_gs = _instance(96, 4, 6, seed=21)
    m, g, w = (torch.from_numpy(a) for a in (mat2, gperms, inv_gs))
    f32 = ref.sw_ref(m, g, w).double()
    ref64 = torch.from_numpy(ref.sw_ref_f64(mat2, gperms, inv_gs))
    two = _onehot_split_sw(m, g, w, products=2)
    one = _onehot_split_sw(m, g, w, products=1)
    rel2 = float(((two - f32).abs() / f32).max())
    rel1 = float(((one - f32).abs() / f32).max())
    assert rel2 <= 1e-6, rel2
    assert float(((two - ref64).abs() / ref64).max()) <= 1e-6
    assert rel1 > 1e-6, rel1


def test_inv_group_sizes_match_reference():
    grouping = np.array([0, 2, 2, 0, 2, 4], np.int32)   # groups 1, 3 empty
    got = tperm.inv_group_sizes(torch.from_numpy(grouping), 5)
    want = np.asarray(jperm.inv_group_sizes(jnp.asarray(grouping), 5))
    np.testing.assert_array_equal(got.numpy(), want)
    assert got[1] == 0 and got[3] == 0
