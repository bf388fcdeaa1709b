"""The port's pairwise-distance wrappers and plain versions against the
reference's Pallas kernels (interpret mode), on the same numpy inputs,
plus the packed-bit identities, the wrappers' contract and the kernel
build/binding. The CUDA kernels themselves run only on the card;
`chip_smoke.py` holds them against these plain versions there."""

import functools
import os
import re
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import distance as jdist  # noqa: E402
from repro.kernels.distance import ops as jops  # noqa: E402
from repro_torch.core import distance  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.distance import ops, ref  # noqa: E402

# The reference's kernel sweep (tests/test_kernels_distance_stream.py) and
# its bar, f32 at rtol 1e-4 / atol 1e-5.
SHAPES = [(32, 16), (48, 20), (64, 130), (130, 64), (96, 96)]
RTOL, ATOL = 1e-4, 1e-5
TILES = dict(tile_r=32, tile_c=32, feat_block=32)
# metric -> (reference prepare, reference ops kwargs): aitchison is the
# euclidean kernel on clr features, jaccard the jaccard kernels on
# presence floats, as the registry feeds them.
CASES = {
    "braycurtis": (jdist._identity_prepare, dict(metric="braycurtis")),
    "euclidean": (jdist._identity_prepare, dict(metric="euclidean")),
    "jaccard": (jdist.presence_prepare, dict(metric="jaccard")),
    "jaccard_packed": (jdist.presence_prepare,
                       dict(metric="jaccard", packed=1)),
    "aitchison": (jdist.clr_prepare, dict(metric="euclidean")),
}
PORT_PREPARE = {"braycurtis": distance._identity_prepare,
                "euclidean": distance._identity_prepare,
                "jaccard": distance.presence_prepare,
                "jaccard_packed": distance.presence_prepare,
                "aitchison": distance.clr_prepare}


def _features(n, d, seed):
    rng = np.random.default_rng(seed)
    x = rng.gamma(0.7, 1.0, size=(n, d)).astype(np.float32)
    x[rng.random((n, d)) < 0.6] = 0.0
    return x


@functools.lru_cache(maxsize=None)
def _reference(case, n, d, rows):
    prep, kw = CASES[case]
    x = prep(jnp.asarray(_features(n, d, n * d)))
    if rows:
        xr = prep(jnp.asarray(_features(rows, d, n * d + 1)))
        return np.asarray(jops.pairwise_distance_rows(xr, x, **TILES, **kw))
    return np.asarray(jops.pairwise_distance(x, **TILES, **kw))


def _port(case, n, d, rows):
    prep = PORT_PREPARE[case]
    kw = dict(CASES[case][1])
    x = prep(torch.from_numpy(_features(n, d, n * d)))
    if rows:
        xr = prep(torch.from_numpy(_features(rows, d, n * d + 1)))
        return ops.pairwise_distance_rows(xr, x, **kw)
    return ops.pairwise_distance(x, **kw)


@pytest.mark.parametrize("rows", [0, 17], ids=["dense", "rows17"])
@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("n,d", SHAPES)
def test_port_matches_reference_kernel(case, n, d, rows):
    """Dense (n, n) and a rectangular (17, n) slab of independent rows,
    each kernel (and aitchison through euclidean) against the reference's
    Pallas kernel in interpret mode."""
    got = _port(case, n, d, rows)
    assert got.dtype == torch.float32
    assert got.shape == ((rows, n) if rows else (n, n))
    np.testing.assert_allclose(got.numpy(), _reference(case, n, d, rows),
                               rtol=RTOL, atol=ATOL)
    if not rows:
        assert torch.all(torch.diagonal(got) == 0.0)


@pytest.mark.parametrize("n,d", [(13, 70), (40, 32), (9, 5), (21, 64),
                                 (6, 1)])
def test_pack_presence_bits_matches_reference(n, d):
    """Bit for bit, the int32 words read as uint32 are the reference's
    words, including bit 31 (features 31, 63, ...) and ragged tails."""
    x = _features(n, d, seed=n + d)
    if d > 31:
        x[::2, 31] = 1.0                      # sets bit 31 of word 0
    got = distance.pack_presence_bits(torch.from_numpy(x))
    want = np.asarray(jdist.pack_presence_bits(jnp.asarray(x)))
    assert got.dtype == torch.int32 and got.shape == (n, -(-d // 32))
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)


@pytest.mark.parametrize("nr,nc,d", [(13, 40, 37), (40, 40, 128),
                                     (7, 3, 5), (33, 65, 64)])
def test_plain_packed_jaccard_equals_float_bit_for_bit(nr, nc, d):
    """The reference's identity, proven again within the port: popcount
    counts and 0/1 matmul counts are exact, the finalize identical."""
    pr = distance.presence_prepare(torch.from_numpy(_features(nr, d, 1)))
    pc = distance.presence_prepare(torch.from_numpy(_features(nc, d, 2)))
    packed = ref.jaccard_packed_ref(distance.pack_presence_bits(pr),
                                    distance.pack_presence_bits(pc))
    assert torch.equal(packed, ref.jaccard_ref(pr, pc))
    x = torch.cat([pr, pc])
    assert torch.equal(ops.pairwise_distance(x, metric="jaccard", packed=1),
                       ops.pairwise_distance(x, metric="jaccard"))


def test_popcount_sum_matches_python():
    rng = np.random.default_rng(0)
    w = rng.integers(-2 ** 31, 2 ** 31, size=(5, 7), dtype=np.int64)
    got = ref.popcount_sum(torch.from_numpy(w.astype(np.int32)))
    want = [sum(bin(int(v) & 0xFFFFFFFF).count("1") for v in row)
            for row in w]
    assert got.tolist() == want


def test_plain_versions_block_rows_without_changing_results(monkeypatch):
    x = torch.from_numpy(_features(23, 9, 3))
    w = distance.pack_presence_bits(x)
    whole = (ref.braycurtis_ref(x, x), ref.jaccard_packed_ref(w, w))
    monkeypatch.setattr(ref, "_MAX_ELEMS", 50)    # a few rows per block
    assert torch.equal(ref.braycurtis_ref(x, x), whole[0])
    assert torch.equal(ref.jaccard_packed_ref(w, w), whole[1])


@pytest.mark.parametrize("metric", ["braycurtis", "euclidean"])
def test_packed_rejected_for_non_jaccard(metric):
    x = torch.from_numpy(_features(8, 4, 0))
    with pytest.raises(ValueError, match="packed=1 requires"):
        ops.pairwise_distance(x, metric=metric, packed=1)
    with pytest.raises(ValueError, match="packed=1 requires"):
        ops.pairwise_distance_rows(x[:3], x, metric=metric, packed=1)
    with pytest.raises(ValueError, match="unknown metric"):
        ops.pairwise_distance(x, metric="aitchison")


@pytest.mark.parametrize("case,exc", [
    ("unknown_kernel", ValueError),
    ("one_dim", ValueError),
    ("widths_differ", ValueError),
    ("f64", TypeError),
    ("packed_float", TypeError),
    ("not_contiguous", ValueError),
    ("mixed_devices", ValueError),
])
def test_rect_rejects(case, exc):
    x = torch.from_numpy(_features(8, 4, 0))
    xr, xc, kernel = x, x, "braycurtis"
    if case == "unknown_kernel":
        kernel = "cosine"
    elif case == "one_dim":
        xr = x[0]
    elif case == "widths_differ":
        xc = x[:, :3].contiguous()
    elif case == "f64":
        xr = x.double()
    elif case == "packed_float":
        kernel = "jaccard_packed"
    elif case == "not_contiguous":
        xr = x.T
    elif case == "mixed_devices":
        xc = x.to("meta")
    with pytest.raises(exc):
        ops.pairwise_rect(xr, xc, kernel=kernel)


def test_cpu_calls_launch_nothing():
    x = distance.presence_prepare(torch.from_numpy(_features(10, 6, 0)))
    before = dict(ops.LAUNCHES)
    for metric in ops.METRICS:
        ops.pairwise_distance(x, metric=metric)
        ops.pairwise_distance_rows(x[:4], x, metric=metric)
    ops.pairwise_distance(x, metric="jaccard", packed=1)
    assert ops.LAUNCHES == before
    assert set(ops.LAUNCHES) == set(ops.KERNELS) == {
        "braycurtis", "euclidean", "jaccard", "jaccard_packed"}


# ---------------------------------------------------------------------------
# Build and binding (the compile itself happens on the card's machine).
# ---------------------------------------------------------------------------

def test_build_command_names_sm90a_and_the_source():
    cmd = _build.nvcc_command("nvcc", ops.SOURCE,
                              _build.library_path(ops.SOURCE))
    assert "arch=compute_90a,code=sm_90a" in cmd
    assert cmd[-1].endswith(os.path.join("distance", "csrc",
                                         "distance.cu"))
    assert not any("fast_math" in c or "fast-math" in c for c in cmd)
    assert _build.library_path(ops.SOURCE).name.startswith("distance-")


def test_ctypes_signature_matches_source():
    import ctypes
    m = re.search(r"\bdistance_launch\(([^)]*)\)\s*\{", ops.SOURCE.read_text())
    params = [p.strip() for p in m.group(1).split(",")]
    argtypes, restype = ops.SIGNATURES["distance_launch"]
    assert len(params) == len(argtypes) and restype is ctypes.c_int
    for p, t in zip(params, argtypes):
        if "*" in p:
            assert t is ctypes.c_void_p, p
        elif p.startswith("long long"):
            assert t is ctypes.c_longlong, p
        else:
            assert p.startswith("int ") and t is ctypes.c_int, p


def test_source_holds_four_kernels_and_names_what_they_replace():
    """One template for the four metrics: 128 x 128 tiles, an 8 x 8
    micro-tile a thread, 32-feature chunks double-buffered through
    cp.async, a symmetric visit of the tiles j >= i that writes each
    off-diagonal tile and its transpose; the wrapper's TILE is the
    source's."""
    src = ops.SOURCE.read_text()
    for fn in ("braycurtis_pallas", "euclidean_pallas", "jaccard_pallas",
               "jaccard_packed_pallas"):
        assert fn in src
    functors = ("BrayCurtis", "Euclidean", "Jaccard", "JaccardPacked")
    for kind, functor in enumerate(functors):     # ops.KERNELS' order
        assert f"case {kind}: return launch<{functor}>" in src
    # the two jaccard kernels share one finalize
    assert src.count("return jaccard_finalize(") == 2
    assert "cublas" not in src.lower() and "cudnn" not in src.lower()
    assert "atomicAdd" not in src
    assert f"constexpr int kTile = {ops.TILE};" in src and ops.TILE == 128
    assert "constexpr int kMicro = 8;" in src
    assert "cp.async.ca.shared.global" in src
    assert "cp_async_wait<1>();" in src          # chunk c + 1 in flight
    assert "return sym ? nti * (nti + 1) / 2 : nti * ntj;" in src
    assert "if (sym && tp.bj != tp.bi) {" in src
    assert "out[j * nc + i] = tile[r * kOutPitch + cc];" in src
    assert "(symmetric && nr != nc)" in src


def _sym_blocks(n, tile=ops.TILE):
    """The kernel's blocks of a symmetric call in launch order
    (tile_pair in the source): row tile by row tile, the tiles j >= i."""
    nt = -(-n // tile)
    return [(i, j) for i in range(nt) for j in range(i, nt)]


@pytest.mark.parametrize("n", [57, 128, 130, 300, 385])
def test_symmetric_visit_writes_every_entry_once(n):
    """The blocks of a whole-table call, each writing its tile and (off
    the diagonal) its transpose, cover every entry of the (n, n) output
    exactly once; mirroring the plain version's tiles j >= i rebuilds the
    plain version's full table bit for bit (|a - b| = |b - a|, and a pair's
    sums are formed the same way in either order)."""
    t = ops.TILE
    x = torch.from_numpy(_features(n, 9, n))
    full = ref.REFS["braycurtis"](x, x)
    count = torch.zeros(n, n, dtype=torch.int32)
    out = torch.full((n, n), float("nan"))
    blocks = _sym_blocks(n)
    assert len(blocks) == (-(-n // t)) * (-(-n // t) + 1) // 2
    for i, j in blocks:
        r, c = slice(i * t, i * t + t), slice(j * t, j * t + t)
        count[r, c] += 1
        out[r, c] = full[r, c]
        if j != i:
            count[c, r] += 1
            out[c, r] = full[r, c].T
    assert bool((count == 1).all())
    assert torch.equal(out, full)


def test_symmetric_predicate_holds_for_one_table_only(monkeypatch):
    """pairwise_distance(x) hands the kernel one table as both operands
    (packed too), so the call is symmetric; a slab, a clone of the table
    or an offset view of it is a rectangular call."""
    x = distance.presence_prepare(torch.from_numpy(_features(40, 64, 3)))
    seen = []
    real = ops.pairwise_rect

    def spy(xr, xc, *, kernel):
        seen.append(ops.is_symmetric_call(xr, xc))
        return real(xr, xc, kernel=kernel)

    monkeypatch.setattr(ops, "pairwise_rect", spy)
    for metric in ops.METRICS:
        ops.pairwise_distance(x, metric=metric)
    ops.pairwise_distance(x, metric="jaccard", packed=1)
    ops.pairwise_distance_rows(x[:7], x)
    assert seen == [True, True, True, True, False]
    assert ops.is_symmetric_call(x, x)
    assert not ops.is_symmetric_call(x, x.clone())
    assert not ops.is_symmetric_call(x[:7], x)          # a slab
    assert not ops.is_symmetric_call(x[1:], x)          # an offset view
    assert not ops.is_symmetric_call(x[:, :32], x[:, :32].contiguous())


def test_importing_the_port_builds_nothing():
    """Every module imports without nvcc and without building: the
    library is built at the first launch on the card."""
    code = ("import repro_torch.pipeline, repro_torch.kernels.distance.ops "
            "as o, repro_torch.kernels.permanova_sw.ops as s, "
            "repro_torch.launch.permanova\n"
            "print(o._lib is None and s._lib is None)\n")
    env = dict(os.environ,
               PYTHONPATH=os.path.join(os.path.dirname(
                   os.path.dirname(os.path.abspath(__file__))), "src"),
               PATH="/nonexistent", CUDA_HOME="/nonexistent")
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120,
                         check=True).stdout
    assert out.strip() == "True"
