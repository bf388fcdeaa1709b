"""The port's slab cache against the reference's: the on-disk format (a
cache written by either package opens in the other, slab files equal byte
for byte), dense and csr round trips, the writer's appends, quarantine of
corrupt files, synthetic_sparse_counts (the same table and grouping as the
reference's), and the prefetcher's accounting, depth bound, shutdown and
error paths. Equalities here are exact (array_equal, byte equality): the
cache stores raw f32 and csr structure, so nothing may round."""

import os
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

# Plans follow the planner's rules, never a winner persisted in the
# host's default autotune cache (the reference's conftest turns its
# own off); tests of the cache point it at files of their own.
os.environ.setdefault("REPRO_TORCH_AUTOTUNE_CACHE", "off")

from repro.data import microbiome as jmicro  # noqa: E402
from repro.data import slabcache as jslab  # noqa: E402
from repro_torch.data import microbiome  # noqa: E402
from repro_torch.data import slabcache  # noqa: E402

N, D, G = 100, 24, 4
SLAB = 32            # 100 = 3 x 32 + 4: a ragged last slab
FORMATS = ["dense", "csr"]


def _study(seed=0, n=N, d=D):
    rng = np.random.default_rng(seed)
    x = rng.gamma(1.0, 1.0, size=(n, d)).astype(np.float32)
    x *= rng.random(size=(n, d)) < 0.5
    x[:, 0] = np.maximum(x[:, 0], 1e-3)
    return x


def _as_stored(x, fmt):
    return x if fmt == "dense" else (x > 0).astype(np.float32)


def _slab_bytes(path):
    return {name: open(os.path.join(path, name), "rb").read()
            for name in sorted(os.listdir(path))
            if name.startswith("slab_")}


def _no_prefetch_threads(timeout=5.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if not [t for t in threading.enumerate()
                if t.name == "slab-prefetch"]:
            return True
        time.sleep(0.01)
    return False


@pytest.fixture(autouse=True)
def _clean():
    slabcache._WARNED.clear()
    slabcache.COUNTS.clear()
    yield
    assert _no_prefetch_threads(), "slab-prefetch thread leaked"


@pytest.mark.parametrize("fmt", FORMATS)
def test_round_trip(tmp_path, fmt):
    x = _study()
    cache = slabcache.build_slab_cache(tmp_path / "c", x, slab_rows=SLAB,
                                       fmt=fmt)
    assert (cache.n, cache.d, cache.fmt) == (N, D, fmt)
    assert cache.n_slabs == -(-N // SLAB)
    assert cache.rows_in_slab(cache.n_slabs - 1) == N % SLAB
    assert cache.feature_bytes == 4 * N * D
    want = _as_stored(x, fmt)
    np.testing.assert_array_equal(cache.to_array(), want)
    buf = np.full((SLAB, D), 9.0, np.float32)
    tail = cache.read_slab(cache.n_slabs - 1, out=buf)
    np.testing.assert_array_equal(tail, want[(cache.n_slabs - 1) * SLAB:])
    with pytest.raises(IndexError):
        cache.read_slab(cache.n_slabs)
    if fmt == "dense":
        assert cache.disk_bytes == 4 * N * D
    else:   # the structure only: below the dense bytes at ~50% density
        assert cache.disk_bytes < 4 * N * D


def test_build_takes_a_tensor(tmp_path):
    x = _study(1)
    cache = slabcache.build_slab_cache(tmp_path / "c", torch.from_numpy(x),
                                       slab_rows=7)
    assert cache.n_slabs == -(-N // 7)
    np.testing.assert_array_equal(cache.to_array(), x)


@pytest.mark.parametrize("fmt", FORMATS)
def test_uneven_appends_equal_a_one_shot_build(tmp_path, fmt):
    x = _study(3)
    with slabcache.SlabCacheWriter(tmp_path / "w", d=D, slab_rows=SLAB,
                                   fmt=fmt) as w:
        for lo, hi in ((0, 3), (3, 53), (53, N)):
            w.append(x[lo:hi])
    cache = slabcache.SlabCache.open(tmp_path / "w")
    one = slabcache.build_slab_cache(tmp_path / "one", x, slab_rows=SLAB,
                                     fmt=fmt)
    assert cache.meta == one.meta
    assert _slab_bytes(tmp_path / "w") == _slab_bytes(tmp_path / "one")


def test_a_failed_build_publishes_no_manifest(tmp_path):
    with pytest.raises(RuntimeError, match="generator died"):
        with slabcache.SlabCacheWriter(tmp_path / "w", d=D,
                                       slab_rows=SLAB) as w:
            w.append(_study()[:50])
            raise RuntimeError("generator died")
    assert not (tmp_path / "w" / slabcache.META_NAME).exists()
    with pytest.raises(slabcache.SlabCacheError, match="no slab cache"):
        slabcache.SlabCache.open(tmp_path / "w")


def test_empty_finalize_is_refused(tmp_path):
    w = slabcache.SlabCacheWriter(tmp_path / "w", d=D)
    with pytest.raises(slabcache.SlabCacheError, match="empty"):
        w.finalize()


def test_writer_rejects_a_bad_format_and_shape(tmp_path):
    with pytest.raises(ValueError, match="fmt"):
        slabcache.SlabCacheWriter(tmp_path / "w", d=D, fmt="parquet")
    w = slabcache.SlabCacheWriter(tmp_path / "w", d=D)
    with pytest.raises(ValueError, match="rows"):
        w.append(np.zeros((3, D + 1), np.float32))


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("writer", ["reference", "port"])
def test_a_cache_of_either_package_opens_in_the_other(tmp_path, fmt,
                                                      writer):
    """The format is shared: the same manifest, slab files equal byte for
    byte, and the reader of the other package gives the same table."""
    x = _study(4)
    build = {"reference": jslab.build_slab_cache,
             "port": slabcache.build_slab_cache}
    other = "port" if writer == "reference" else "reference"
    build[writer](str(tmp_path / "w"), x, slab_rows=SLAB, fmt=fmt)
    build[other](str(tmp_path / "o"), x, slab_rows=SLAB, fmt=fmt)
    assert _slab_bytes(tmp_path / "w") == _slab_bytes(tmp_path / "o")
    with open(tmp_path / "w" / slabcache.META_NAME) as f:
        meta_w = f.read()
    with open(tmp_path / "o" / slabcache.META_NAME) as f:
        assert f.read() == meta_w
    opener = {"reference": jslab.SlabCache.open,
              "port": slabcache.SlabCache.open}[other]
    np.testing.assert_array_equal(opener(str(tmp_path / "w")).to_array(),
                                  _as_stored(x, fmt))


def test_truncated_slab_is_quarantined(tmp_path):
    slabcache.build_slab_cache(tmp_path / "c", _study(), slab_rows=SLAB)
    victim = tmp_path / "c" / "slab_00001.bin"
    victim.write_bytes(victim.read_bytes()[:100])
    with pytest.raises(slabcache.SlabCacheError, match="truncated"):
        slabcache.SlabCache.open(tmp_path / "c")
    assert (tmp_path / "c" / "slab_00001.bin.corrupt").exists()
    assert not victim.exists()
    assert slabcache.COUNTS["corrupt_quarantined"] == 1


@pytest.mark.parametrize("garble", ["not json", "missing field"])
def test_garbled_manifest_is_quarantined(tmp_path, garble):
    slabcache.build_slab_cache(tmp_path / "c", _study(), slab_rows=SLAB)
    meta = tmp_path / "c" / slabcache.META_NAME
    meta.write_text("{not json" if garble == "not json"
                    else '{"schema": 1, "n": 100}')
    with pytest.raises(slabcache.SlabCacheError,
                       match="unreadable" if garble == "not json"
                       else "malformed"):
        slabcache.SlabCache.open(tmp_path / "c")
    assert (tmp_path / "c" / (slabcache.META_NAME + ".corrupt")).exists()
    assert slabcache.COUNTS["corrupt_quarantined"] == 1


def test_missing_meta_and_slab_are_clear_errors(tmp_path):
    with pytest.raises(slabcache.SlabCacheError, match="no slab cache"):
        slabcache.SlabCache.open(tmp_path / "nothing")
    slabcache.build_slab_cache(tmp_path / "c", _study(), slab_rows=SLAB)
    os.remove(tmp_path / "c" / "slab_00002.bin")
    with pytest.raises(slabcache.SlabCacheError, match="missing"):
        slabcache.SlabCache.open(tmp_path / "c")
    assert slabcache.COUNTS["corrupt_quarantined"] == 0


@pytest.mark.parametrize("fmt", FORMATS)
def test_synthetic_sparse_counts_equal_the_reference(tmp_path, fmt):
    kw = dict(density=0.2, seed=5, slab_rows=32, n_groups=G, fmt=fmt)
    cache, grouping = microbiome.synthetic_sparse_counts(
        90, 16, cache_dir=tmp_path / "port", **kw)
    jcache, jgrouping = jmicro.synthetic_sparse_counts(
        90, 16, cache_dir=str(tmp_path / "ref"), **kw)
    assert _slab_bytes(tmp_path / "port") == _slab_bytes(tmp_path / "ref")
    np.testing.assert_array_equal(cache.to_array(), jcache.to_array())
    np.testing.assert_array_equal(grouping, np.asarray(jgrouping))
    assert set(grouping[:G]) == set(range(G))
    other, _ = microbiome.synthetic_sparse_counts(
        90, 16, cache_dir=tmp_path / "seed6", **{**kw, "seed": 6})
    assert not np.array_equal(cache.to_array(), other.to_array())
    with pytest.raises(ValueError, match="cache_dir"):
        microbiome.synthetic_sparse_counts(90, 16)


def test_prefetcher_accounting_and_contents(tmp_path):
    x = _study()
    cache = slabcache.build_slab_cache(tmp_path / "c", x, slab_rows=SLAB)
    sched = list(slabcache.ooc_schedule(cache.n_slabs))
    assert len(sched) == cache.n_slabs * (cache.n_slabs + 1)
    seen = []
    with slabcache.SlabPrefetcher(cache, sched) as pf:
        for idx, slab in pf:
            rows = cache.rows_in_slab(idx)
            assert slab.shape == (SLAB, D) and slab.dtype == torch.float32
            np.testing.assert_array_equal(
                slab[:rows].numpy(), x[idx * SLAB:idx * SLAB + rows])
            assert not slab[rows:].any()          # zero pad rows
            slab.fill_(-1.0)                      # an owning copy
            seen.append(idx)
    assert seen == sched
    assert pf.slabs_fetched == len(sched)
    assert pf.bytes_read == (cache.n_slabs + 1) * cache.disk_bytes
    assert pf.stall_s >= 0.0


def test_prefetcher_fetches_at_most_depth_ahead(tmp_path):
    cache = slabcache.build_slab_cache(tmp_path / "c", _study(),
                                       slab_rows=8)
    with slabcache.SlabPrefetcher(cache, list(range(cache.n_slabs)),
                                  depth=2) as pf:
        taken = 0
        for _ in range(3):
            next(pf)
            taken += 1
            time.sleep(0.2)       # a slow consumer: the worker waits
            assert pf.slabs_fetched <= taken + 2
        assert pf.slabs_fetched == taken + 2


def test_prefetcher_shuts_down_on_a_mid_sweep_exception(tmp_path):
    cache = slabcache.build_slab_cache(tmp_path / "c", _study(),
                                       slab_rows=SLAB)
    with pytest.raises(RuntimeError, match="sweep died"):
        with slabcache.SlabPrefetcher(
                cache, list(range(cache.n_slabs)) * 4) as pf:
            next(pf)
            raise RuntimeError("sweep died")
    assert _no_prefetch_threads(), \
        "prefetch worker survived a mid-sweep exception"


def test_prefetcher_worker_error_resurfaces(tmp_path):
    cache = slabcache.build_slab_cache(tmp_path / "c", _study(),
                                       slab_rows=SLAB)
    os.remove(tmp_path / "c" / "slab_00001.bin")   # after validation
    with slabcache.SlabPrefetcher(cache, [0, 1, 2]) as pf:
        next(pf)
        with pytest.raises(slabcache.SlabCacheError,
                           match="prefetch failed"):
            for _ in pf:
                pass


def test_prefetcher_refuses_pad_below_the_slab(tmp_path):
    cache = slabcache.build_slab_cache(tmp_path / "c", _study(),
                                       slab_rows=SLAB)
    with pytest.raises(ValueError, match="pad_to"):
        slabcache.SlabPrefetcher(cache, [0], pad_to=SLAB - 1)
    with slabcache.SlabPrefetcher(cache, [3], pad_to=SLAB + 5) as pf:
        _, slab = next(pf)
        assert slab.shape == (SLAB + 5, D)
