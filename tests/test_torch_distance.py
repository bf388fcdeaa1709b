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

# Plans follow the planner's rules, never a winner persisted in the
# host's default autotune cache (the reference's conftest turns its
# own off); tests of the cache point it at files of their own.
os.environ.setdefault("REPRO_TORCH_AUTOTUNE_CACHE", "off")

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
    """Four metrics on 128 x 128 tiles, 32-feature chunks through a
    cp.async double buffer and a symmetric visit of the tiles j >= i that
    writes each off-diagonal tile and its transpose. Bray-Curtis and the
    packed jaccard keep the CUDA-core template (an 8 x 8 micro-tile a
    thread); euclidean and jaccard run their products on the tensor cores
    (wgmma): jaccard as exact int8 counts, euclidean as three TF32
    products whose cross terms keep separate accumulators. The wrapper's
    TILE is the source's."""
    src = ops.SOURCE.read_text()
    for fn in ("braycurtis_pallas", "euclidean_pallas", "jaccard_pallas",
               "jaccard_packed_pallas"):
        assert fn in src
    launches = ("launch<BrayCurtis>", "launch_tc<Euclidean>",
                "launch_tc<Jaccard>", "launch<JaccardPacked>")
    for kind, launch in enumerate(launches):      # ops.KERNELS' order
        assert f"case {kind}: return {launch}" in src
    # the two jaccard kernels share one finalize
    assert src.count("return jaccard_finalize(") == 2
    assert "cublas" not in src.lower() and "cudnn" not in src.lower()
    assert "atomicAdd" not in src
    assert f"constexpr int kTile = {ops.TILE};" in src and ops.TILE == 128
    assert "constexpr int kMicro = 8;" in src
    assert "cp.async.ca.shared.global" in src
    assert "cp.async.cg.shared.global" in src     # the [r][k] staging
    assert "cp_async_wait<1>();" in src          # chunk c + 1 in flight
    assert "return sym ? nti * (nti + 1) / 2 : nti * ntj;" in src
    assert src.count("sym && tp.bj != tp.bi") == 2   # both kernels mirror
    assert "out[j * nc + i] = tile[r * kOutPitch + cc];" in src
    assert "store_row(out + (j0 + cc) * nc + i0," in src   # tc mirror
    assert "(symmetric && nr != nc)" in src
    assert f"constexpr int kStripTiles = {STRIP};" in src   # visit order
    # the tensor-core kernels: their wgmma forms, the TF32 split, the
    # operand contract
    body = {name: src[src.index(f"struct {name} {{"):]
            for name in ("Jaccard", "Euclidean")}
    for name in body:
        body[name] = body[name][:body[name].index("\n};\n")]
    assert "wgmma_s8(" in body["Jaccard"]
    assert "wgmma_tf32(" in body["Euclidean"]
    assert ("wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8" in src
            and "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32" in src)
    assert "cvt.rna.tf32.f32" in src
    # HH in two halves, then X and Y each in an accumulator of its own
    assert body["Euclidean"].count("wgmma_tf32(x,") == 2
    assert body["Euclidean"].count("wgmma_tf32(y,") == 2
    assert "acc[i] += pend[i] + pend[kAcc + i];" in body["Euclidean"]
    assert "OPERAND" in src and "CONTRACT: xr and xc hold presence data" in src


def _sym_blocks(n, tile=ops.TILE):
    """The tiles of a symmetric call, j >= i, row tile by row tile (the
    kernels visit them in _strip_blocks' order)."""
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


# ---------------------------------------------------------------------------
# The tensor-core kernels' arithmetic, modelled on the CPU (the kernels run
# only on the card; chip_smoke.py phases 5 and 7 hold them there).
# ---------------------------------------------------------------------------

KCHUNK = 32   # kChunk in the source: one k32 int8 step, four k8 TF32 steps


def _jaccard_finalize(inter, card_r, card_c):
    """jaccard_finalize in the source, in f32."""
    uni = (card_r[:, None] + card_c[None, :]) - inter
    return 1.0 - inter / torch.clamp(uni, min=1.0)


def _int8_counts(pr, pc):
    """The jaccard kernel's product: each 0/1 float becomes an int8, d is
    zero-filled to a multiple of 32, and each k32 chunk's product is
    summed into s32 counts chunk by chunk."""
    pad = (-pr.shape[1]) % KCHUNK
    a = torch.nn.functional.pad(pr, (0, pad)).to(torch.int8)
    b = torch.nn.functional.pad(pc, (0, pad)).to(torch.int8)
    inter = torch.zeros((a.shape[0], b.shape[0]), dtype=torch.int32)
    for k0 in range(0, a.shape[1], KCHUNK):
        inter += (a[:, k0:k0 + KCHUNK].to(torch.int32)
                  @ b[:, k0:k0 + KCHUNK].to(torch.int32).T)
    return inter


@pytest.mark.parametrize("nr,nc,d", [(57, 57, 3), (130, 97, 37),
                                     (200, 129, 70), (129, 256, 128)])
def test_int8_counts_give_the_plain_jaccard_bit_for_bit(nr, nc, d):
    """Exact int8 counts at ragged (nr, nc, d), d not a multiple of 32:
    the intersection equals the plain version's f32 0/1 product exactly,
    and the shared finalize on it (cardinalities summed in f32) gives the
    plain version's distances bit for bit, and the packed kernel's."""
    pr = distance.presence_prepare(torch.from_numpy(_features(nr, d, 5)))
    pc = distance.presence_prepare(torch.from_numpy(_features(nc, d, 6)))
    inter = _int8_counts(pr, pc)
    assert torch.equal(inter.to(torch.float32), pr @ pc.T)
    got = _jaccard_finalize(inter.to(torch.float32), pr.sum(1), pc.sum(1))
    assert torch.equal(got, ref.jaccard_ref(pr, pc))
    assert torch.equal(got, ref.jaccard_packed_ref(
        distance.pack_presence_bits(pr), distance.pack_presence_bits(pc)))


def _euclid_from_dot(x, dot):
    """sqrt(max(|x|^2 + |y|^2 - 2 dot, 0)) in f32, |x|^2 the f32 sum of
    x x in feature order, the diagonal zeroed as pairwise_distance does."""
    sq = torch.zeros(x.shape[0], dtype=torch.float32)
    for k in range(x.shape[1]):
        sq = sq + x[:, k] * x[:, k]
    d2 = (sq[:, None] + sq[None, :]) - 2.0 * dot
    return torch.sqrt(torch.clamp(d2, min=0.0)).fill_diagonal_(0.0)


def test_three_tf32_products_hold_the_euclidean_bar_and_one_does_not():
    """hi = tf32(x), lo = tf32(x - hi): hi.hi + hi.lo + lo.hi (exact
    products summed in float64) gives euclidean within the kernels' bar
    (rtol 1e-4 / atol 1e-5) of the plain version and within 2x the plain
    f32 version's error against float64, at synthetic_abundance n = 2047,
    d = 128, seed 3; one TF32 product misses the bar."""
    from repro_torch.data.microbiome import synthetic_abundance
    from repro_torch.kernels.permanova_sw.ref import tf32_round
    x = torch.from_numpy(synthetic_abundance(2047, 128, seed=3))
    hi = tf32_round(x)
    lo = tf32_round(x - hi)
    h64, l64 = hi.double(), lo.double()
    one = h64 @ h64.T
    three = one + h64 @ l64.T + l64 @ h64.T
    x64 = x.double()
    sq64 = (x64 * x64).sum(1)
    oracle = torch.sqrt(torch.clamp(
        sq64[:, None] + sq64[None, :] - 2.0 * (x64 @ x64.T), min=0.0)
    ).fill_diagonal_(0.0)
    plain = ref.euclidean_ref(x, x).fill_diagonal_(0.0)
    got3 = _euclid_from_dot(x, three.to(torch.float32))
    got1 = _euclid_from_dot(x, one.to(torch.float32))
    err_plain = float((plain.double() - oracle).abs().max())
    assert torch.allclose(got3, plain, rtol=RTOL, atol=ATOL)
    assert float((got3.double() - oracle).abs().max()) <= 2.0 * err_plain
    assert not torch.allclose(got1, plain, rtol=RTOL, atol=ATOL)


def _tc_dot(a, b, cross):
    """x.y of the rows of a and b (pairwise, same shape) in the euclidean
    kernel's order: per 32-feature chunk, fresh f32 sums (each exact
    product added in k order) of HH over features 0-15 and 16-31 join the
    running sum one after the other; then the cross terms, either as the
    kernel takes them (X = hi_a.lo_b and Y = lo_a.hi_b in separate fresh
    sums, acc += (X + Y)) or in one fresh sum, X's products then Y's
    ('sequential')."""
    from repro_torch.kernels.permanova_sw.ref import tf32_round
    ah, bh = tf32_round(a), tf32_round(b)
    al, bl = tf32_round(a - ah), tf32_round(b - bh)
    acc = torch.zeros(a.shape[0], dtype=torch.float32)

    def fresh(u, v, ks):
        s = torch.zeros_like(acc)
        for k in ks:
            s = s + u[:, k] * v[:, k]       # exact products, f32 sums
        return s

    for k0 in range(0, a.shape[1], KCHUNK):
        half = KCHUNK // 2
        acc = acc + fresh(ah, bh, range(k0, k0 + half))
        acc = acc + fresh(ah, bh, range(k0 + half, k0 + KCHUNK))
        ks = range(k0, k0 + KCHUNK)
        if cross == "separate":
            acc = acc + (fresh(ah, bl, ks) + fresh(al, bh, ks))
        else:
            s = fresh(ah, bl, ks)
            for k in ks:
                s = s + al[:, k] * bh[:, k]
            acc = acc + s
    return acc


def test_separate_cross_accumulators_make_the_dot_symmetric():
    """The euclidean kernel's cross terms in separate accumulators give
    dot(a, b) == dot(b, a) bit for bit (so a whole-table call equals the
    rectangular call), where one accumulator taking hi.lo then lo.hi does
    not on some pairs. Signed features, as aitchison's clr features are,
    leave some dots small beside their terms, where the order shows."""
    rng = np.random.default_rng(11)
    a = torch.from_numpy(rng.standard_normal((4096, 128)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((4096, 128)).astype(np.float32))
    assert torch.equal(_tc_dot(a, b, "separate"), _tc_dot(b, a, "separate"))
    assert not torch.equal(_tc_dot(a, b, "sequential"),
                           _tc_dot(b, a, "sequential"))


STRIP = 16   # kStripTiles in the source


def _strip_blocks(n, tile=ops.TILE, strip=STRIP):
    """A symmetric call's tiles in the kernels' visit order, built
    plainly: strips of `strip` row tiles; in each, its triangle column by
    column (rows up to the column), then the rest of its columns, all its
    rows each."""
    nt = -(-n // tile)
    out = []
    for s0 in range(0, nt, strip):
        rows = range(s0, min(s0 + strip, nt))
        for j in range(s0, nt):
            out += [(i, j) for i in rows if i <= j]
    return out


def _tile_pair(b, nti):
    """tile_pair in the source for a symmetric call: the strip by
    subtraction, a column of the strip's triangle from the quadratic
    (corrected by one either way), the rectangle by division."""
    s0 = 0
    while True:
        w = min(STRIP, nti - s0)
        tri = w * (w + 1) // 2
        size = tri + w * (nti - s0 - w)
        if b >= size:
            b -= size
            s0 += w
            continue
        if b >= tri:
            return s0 + (b - tri) % w, s0 + w + (b - tri) // w
        t = int((np.sqrt(8.0 * b + 1.0) - 1.0) / 2.0)
        while t > 0 and t * (t + 1) // 2 > b:
            t -= 1
        while (t + 1) * (t + 2) // 2 <= b:
            t += 1
        return s0 + (b - t * (t + 1) // 2), s0 + t


@pytest.mark.parametrize("n", [57, 300, 2049, 2177, 25145])
def test_symmetric_tile_index_is_the_strip_order(n):
    """Block b of a whole-table call gets the b-th tile of the strip order
    (tiles j >= i, strips of 16 row tiles, column by column), which covers
    the upper triangle once, at n across one and two strips and the EMP
    n."""
    blocks = _strip_blocks(n)
    nti = -(-n // ops.TILE)
    assert sorted(blocks) == _sym_blocks(n)
    picks = range(len(blocks)) if len(blocks) < 5000 else \
        np.random.default_rng(n).integers(0, len(blocks), 5000).tolist() \
        + [0, len(blocks) - 1]
    for b in picks:
        assert _tile_pair(b, nti) == blocks[b]
