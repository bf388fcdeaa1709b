"""Disk-backed feature-slab cache and an asynchronous prefetcher to the card.

Twin of `repro/data/slabcache.py`. The out-of-core tier of the residency
model: a feature table too large for the device budget lives as one file
per ROW SLAB under a cache directory, written once by a build step and
streamed back. While the sweep contracts slab k, a worker thread reads
slab k+1 from disk into pinned host memory and copies it to the card on
a side stream, so disk reads and copies hide behind the distance kernels.

Layout of a cache directory (schema 1, the reference's byte for byte, so
a cache written by either package opens in the other):

  slabmeta.json      schema / shape / format manifest, written LAST and
                     atomically (tmp + fsync + os.replace): a crashed
                     build is indistinguishable from no cache at all
  slab_00000.bin ... one file per row slab:
                       dense  raw float32, C order (rows, d)
                       csr    int64 indptr (rows + 1) ++ int32 column
                              indices: presence structure only, so the
                              presence metric (jaccard) reads only the
                              nonzeros from disk

A corrupt or truncated slab file (or an unreadable manifest) is moved to
`<file>.corrupt` on open, logged once, counted in `COUNTS` (and in obs'
`slabcache.corrupt_quarantined`), and the open fails telling the caller
to rebuild.

`SlabPrefetcher` is the host -> device half: a worker thread reads each
scheduled slab into one of two reused host buffers and hands the consumer
an owning device tensor. On the card the buffers are pinned and the copy
runs on the prefetcher's own CUDA stream, ordered against the consumer's
stream by an event (see the class). The consumer's blocking time is
`stall_s`, the overlap's evidence. While tracing (obs), each fetch is a
`prefetch.fetch` span on the worker thread (its own `tid`, depth 0): the
read, the wait for a slot ahead of the consumer (its attr
`slot_wait_ms`) and the copy, which it waits for on the prefetcher's
stream only. Each wait for a slab is a `prefetch.wait` span on the
consumer. With metrics on, `prefetch.slabs`, `prefetch.bytes` and
`prefetch.stall_ms` count them.
"""

from __future__ import annotations

import collections
import dataclasses
import json
import logging
import os
import queue
import threading
import time
from typing import Iterable, Optional, Sequence

import numpy as np
import torch

from repro_torch import obs as _obs

_log = logging.getLogger("repro_torch.data.slabcache")
_WARNED: set = set()

META_NAME = "slabmeta.json"
SCHEMA = 1
FORMATS = ("dense", "csr")
DEFAULT_SLAB_ROWS = 1024

# Cache-health events of this process ('corrupt_quarantined'), counted
# whether telemetry is on or not; with metrics on (obs) they also count
# as `slabcache.corrupt_quarantined`.
COUNTS: collections.Counter = collections.Counter()


class SlabCacheError(RuntimeError):
    """A slab cache is missing, malformed, or truncated."""


def _warn_once(tag: str, msg: str) -> None:
    """Log a cache-health warning once per process (logging, not
    warnings: the tests run warning-free)."""
    if tag in _WARNED:
        return
    _WARNED.add(tag)
    _log.warning(msg)


def _slab_name(i: int) -> str:
    return f"slab_{i:05d}.bin"


def _quarantine(path: str, why: str) -> str:
    """Move a bad cache file aside so the evidence survives and a rebuild
    starts clean; returns the note on where it went."""
    quarantined = f"{path}.corrupt"
    try:
        os.replace(path, quarantined)
        where = f"; quarantined to {quarantined}"
    except OSError:
        where = " (quarantine rename failed; leaving in place)"
    COUNTS["corrupt_quarantined"] += 1
    _obs.metrics.inc("slabcache.corrupt_quarantined")
    _warn_once("corrupt",
               f"slab cache file {path} is corrupt ({why}){where}. "
               "Rebuild the cache with build_slab_cache().")
    return where


@dataclasses.dataclass(frozen=True)
class SlabMeta:
    """Manifest of one cache directory (the slabmeta.json document)."""
    n: int
    d: int
    slab_rows: int
    fmt: str                      # 'dense' | 'csr'
    n_slabs: int
    slab_nnz: Optional[tuple] = None   # csr: nonzeros per slab

    def rows_in_slab(self, i: int) -> int:
        return min(self.slab_rows, self.n - i * self.slab_rows)

    def slab_file_bytes(self, i: int) -> int:
        rows = self.rows_in_slab(i)
        if self.fmt == "dense":
            return rows * self.d * 4
        return 8 * (rows + 1) + 4 * int(self.slab_nnz[i])


class SlabCacheWriter:
    """Append-rows writer: buffers incoming rows and flushes one slab file
    per `slab_rows`, so the full (n, d) table never has to exist
    (`data.microbiome.synthetic_sparse_counts` appends slab-sized
    pieces). As a context manager it publishes the manifest only on a
    clean exit."""

    def __init__(self, path, *, d: int, slab_rows: int = DEFAULT_SLAB_ROWS,
                 fmt: str = "dense"):
        if fmt not in FORMATS:
            raise ValueError(f"fmt={fmt!r}; expected one of {FORMATS}")
        if slab_rows < 1:
            raise ValueError(f"slab_rows must be >= 1, got {slab_rows}")
        self.path = str(path)
        self.d = int(d)
        self.slab_rows = int(slab_rows)
        self.fmt = fmt
        self._pending: list = []
        self._pending_rows = 0
        self._n = 0
        self._slab_nnz: list = []
        self._n_slabs = 0
        self._finalized = False
        os.makedirs(self.path, exist_ok=True)

    def append(self, rows: np.ndarray) -> None:
        if self._finalized:
            raise SlabCacheError("writer already finalized")
        rows = np.asarray(rows, np.float32)
        if rows.ndim != 2 or rows.shape[1] != self.d:
            raise ValueError(f"expected (r, {self.d}) rows; "
                             f"got shape {rows.shape}")
        self._pending.append(rows)
        self._pending_rows += rows.shape[0]
        self._n += rows.shape[0]
        while self._pending_rows >= self.slab_rows:
            self._flush_slab(self.slab_rows)

    def _take_pending(self, k: int) -> np.ndarray:
        out, taken = [], 0
        while taken < k:
            head = self._pending[0]
            need = k - taken
            if head.shape[0] <= need:
                out.append(head)
                taken += head.shape[0]
                self._pending.pop(0)
            else:
                out.append(head[:need])
                self._pending[0] = head[need:]
                taken = k
        self._pending_rows -= k
        return out[0] if len(out) == 1 else np.concatenate(out, axis=0)

    def _flush_slab(self, k: int) -> None:
        block = np.ascontiguousarray(self._take_pending(k), np.float32)
        fpath = os.path.join(self.path, _slab_name(self._n_slabs))
        if self.fmt == "dense":
            parts = (block,)
        else:
            mask = block > 0
            indptr = np.zeros((block.shape[0] + 1,), np.int64)
            np.cumsum(mask.sum(axis=1), out=indptr[1:])
            indices = np.nonzero(mask)[1].astype(np.int32)
            self._slab_nnz.append(int(indices.shape[0]))
            parts = (indptr, indices)
        expect = sum(p.nbytes for p in parts)
        with open(fpath, "wb") as f:
            for p in parts:
                p.tofile(f)
            f.flush()
            os.fsync(f.fileno())
        got = os.path.getsize(fpath)
        if got != expect:
            raise SlabCacheError(
                f"slab cache build wrote {got} bytes to {fpath}, expected "
                f"{expect} (disk full or interrupted write?); the cache at "
                f"{self.path} is incomplete: rebuild it")
        self._n_slabs += 1

    def finalize(self) -> "SlabCache":
        """Flush the tail slab and publish the manifest (written last and
        atomically: no slabmeta.json, no cache)."""
        if self._finalized:
            raise SlabCacheError("writer already finalized")
        if self._pending_rows:
            self._flush_slab(self._pending_rows)
        if self._n == 0:
            raise SlabCacheError("cannot finalize an empty slab cache")
        self._finalized = True
        meta = {"schema": SCHEMA, "n": self._n, "d": self.d,
                "slab_rows": self.slab_rows, "fmt": self.fmt,
                "n_slabs": self._n_slabs}
        if self.fmt == "csr":
            meta["slab_nnz"] = self._slab_nnz
        tmp = os.path.join(self.path, META_NAME + ".tmp")
        with open(tmp, "w") as f:
            json.dump(meta, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, os.path.join(self.path, META_NAME))
        return SlabCache.open(self.path)

    def __enter__(self):
        return self

    def __exit__(self, exc_type, *exc):
        # publish only on a clean exit; a failed build leaves no manifest
        if exc_type is None and not self._finalized:
            self.finalize()
        return False


def build_slab_cache(path, x, *, slab_rows: int = DEFAULT_SLAB_ROWS,
                     fmt: str = "dense") -> "SlabCache":
    """One-shot build from an in-memory (n, d) array or tensor (generators
    append to a SlabCacheWriter slab by slab instead)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    x = np.asarray(x, np.float32)
    if x.ndim != 2:
        raise ValueError(f"expected (n, d) features; got shape {x.shape}")
    w = SlabCacheWriter(path, d=x.shape[1],
                        slab_rows=min(int(slab_rows), x.shape[0]), fmt=fmt)
    for lo in range(0, x.shape[0], w.slab_rows):
        w.append(x[lo:lo + w.slab_rows])
    return w.finalize()


class SlabCache:
    """Read side of a cache directory: validated manifest + slab reads."""

    def __init__(self, path: str, meta: SlabMeta):
        self.path = path
        self.meta = meta

    @property
    def n(self) -> int:
        return self.meta.n

    @property
    def d(self) -> int:
        return self.meta.d

    @property
    def slab_rows(self) -> int:
        return self.meta.slab_rows

    @property
    def n_slabs(self) -> int:
        return self.meta.n_slabs

    @property
    def fmt(self) -> str:
        return self.meta.fmt

    @property
    def feature_bytes(self) -> int:
        """Device footprint of the expanded f32 table."""
        return 4 * self.meta.n * self.meta.d

    @property
    def disk_bytes(self) -> int:
        """Bytes on disk (csr: the structure only, which the planner's
        disk-traffic model charges)."""
        return sum(self.meta.slab_file_bytes(i)
                   for i in range(self.meta.n_slabs))

    @classmethod
    def open(cls, path) -> "SlabCache":
        path = str(path)
        mpath = os.path.join(path, META_NAME)
        try:
            with open(mpath) as f:
                raw = json.load(f)
        except FileNotFoundError:
            raise SlabCacheError(
                f"no slab cache at {path} ({META_NAME} missing); build one "
                "with build_slab_cache()") from None
        except (OSError, ValueError) as e:
            where = _quarantine(mpath, str(e))
            raise SlabCacheError(
                f"slab cache manifest {mpath} is unreadable{where}; "
                "rebuild the cache") from None
        try:
            if int(raw["schema"]) != SCHEMA:
                raise SlabCacheError(
                    f"slab cache {path} has schema {raw['schema']}, this "
                    f"code reads schema {SCHEMA}; rebuild the cache")
            meta = SlabMeta(
                n=int(raw["n"]), d=int(raw["d"]),
                slab_rows=int(raw["slab_rows"]), fmt=str(raw["fmt"]),
                n_slabs=int(raw["n_slabs"]),
                slab_nnz=(tuple(int(v) for v in raw["slab_nnz"])
                          if raw.get("slab_nnz") is not None else None))
        except SlabCacheError:
            raise
        except (KeyError, TypeError, ValueError) as e:
            where = _quarantine(mpath, f"bad manifest field: {e!r}")
            raise SlabCacheError(
                f"slab cache manifest {mpath} is malformed{where}; "
                "rebuild the cache") from None
        if meta.fmt not in FORMATS:
            raise SlabCacheError(f"slab cache {path}: unknown format "
                                 f"{meta.fmt!r}; expected one of {FORMATS}")
        if meta.fmt == "csr" and (meta.slab_nnz is None
                                  or len(meta.slab_nnz) != meta.n_slabs):
            raise SlabCacheError(f"slab cache {path}: csr manifest is "
                                 "missing per-slab nnz; rebuild the cache")
        # every slab file's size against the manifest, up front: a
        # truncated slab must fail the open, not corrupt a sweep later
        for i in range(meta.n_slabs):
            fpath = os.path.join(path, _slab_name(i))
            expect = meta.slab_file_bytes(i)
            try:
                got = os.path.getsize(fpath)
            except OSError:
                raise SlabCacheError(
                    f"slab cache {path} is missing {_slab_name(i)}; "
                    "rebuild the cache") from None
            if got != expect:
                where = _quarantine(fpath,
                                    f"{got} bytes on disk, expected {expect}")
                raise SlabCacheError(
                    f"slab cache {path}: {_slab_name(i)} is truncated "
                    f"({got} bytes, expected {expect}){where}; rebuild "
                    "the cache")
        return cls(path, meta)

    def rows_in_slab(self, i: int) -> int:
        return self.meta.rows_in_slab(i)

    def read_slab(self, i: int, out: Optional[np.ndarray] = None
                  ) -> np.ndarray:
        """Slab i as (rows_i, d) float32 (csr slabs expand to 0/1
        presence). With `out` (a (>= rows_i, d) buffer) the read fills and
        returns a view of it: the prefetcher's ring path."""
        if not 0 <= i < self.meta.n_slabs:
            raise IndexError(f"slab {i} out of range "
                             f"[0, {self.meta.n_slabs})")
        rows = self.meta.rows_in_slab(i)
        d = self.meta.d
        if out is None:
            out = np.empty((rows, d), np.float32)
        dst = out[:rows]
        fpath = os.path.join(self.path, _slab_name(i))
        if self.meta.fmt == "dense":
            # straight into the caller's buffer (the leading rows of a
            # C-contiguous array are contiguous): one copy, not two
            want = rows * d * 4
            with open(fpath, "rb") as f:
                got = f.readinto(memoryview(dst).cast("B"))
            if got != want:
                raise SlabCacheError(f"slab cache file {fpath} gave {got} "
                                     f"bytes, expected {want}; rebuild the "
                                     "cache")
        else:
            with open(fpath, "rb") as f:
                indptr = np.fromfile(f, np.int64, rows + 1)
                indices = np.fromfile(f, np.int32,
                                      int(self.meta.slab_nnz[i]))
            dst[:] = 0.0
            row_ids = np.repeat(np.arange(rows), np.diff(indptr))
            dst[row_ids, indices] = 1.0
        return dst

    def to_array(self) -> np.ndarray:
        """The full (n, d) float32 table: the 'hbm' residency short
        circuit (the table fits the device budget: read it once, then run
        the in-memory bridges)."""
        out = np.empty((self.meta.n, self.meta.d), np.float32)
        for i in range(self.meta.n_slabs):
            lo = i * self.meta.slab_rows
            self.read_slab(i, out=out[lo:lo + self.meta.slab_rows])
        return out


# ---------------------------------------------------------------------------
# Asynchronous host -> device prefetch.
# ---------------------------------------------------------------------------

_DONE = object()
_POLL_S = 0.05
# Slabs the prefetcher fetches ahead of its consumer: the out-of-core
# sweep's depth, and the one its device footprint model
# (pipeline.planner.ooc_footprint) charges.
PREFETCH_DEPTH = 2


class SlabPrefetcher:
    """Worker thread streaming scheduled slabs to `device`.

    schedule: slab indices in consumption order (repeats allowed: the
    out-of-core sweep reads the column stream again per row slab).
    `depth` bounds the slabs fetched ahead: at most `depth` device slabs
    exist that the consumer has not taken (a semaphore the consumer
    releases as it takes one), so slab k+1 loads while slab k is swept
    at the default depth of 2. Each slab is padded with zero rows to
    `pad_to` rows (default: the cache's slab height; never fewer).

    On a CUDA device the worker reads each slab into one of two pinned
    host buffers (`torch.empty(..., pin_memory=True)`, filled through
    `.numpy()`), allocates the device slab on the prefetcher's own
    stream and copies into it with `non_blocking=True`, then records an
    event on that stream. Before it refills a host buffer it waits on
    the event of that buffer's last copy. The consumer's `__next__`
    makes the current stream wait on the slab's event (the copy has
    landed before any kernel reads it) and calls `record_stream` on the
    slab, so the caching allocator does not hand its memory to a later
    slab while kernels on the consumer's stream still read it. On the
    CPU the worker copies each slab into an owning tensor (the buffers
    are recycled), and nothing is pinned.

    Iteration yields (slab_index, tensor (pad_to, d) float32). Use it
    as a context manager: close() joins the thread even when the sweep
    dies mid-iteration; a worker error resurfaces as SlabCacheError."""

    def __init__(self, cache: SlabCache, schedule: Sequence[int], *,
                 depth: int = PREFETCH_DEPTH,
                 pad_to: Optional[int] = None,
                 device="cpu"):
        self.cache = cache
        self.schedule = list(schedule)
        self.depth = max(1, int(depth))
        self.pad_to = int(pad_to if pad_to is not None else cache.slab_rows)
        if self.pad_to < cache.slab_rows:
            raise ValueError(f"pad_to={self.pad_to} smaller than the "
                             f"cache's slab_rows={cache.slab_rows}")
        self.device = torch.device(device)
        self.stall_s = 0.0
        self.bytes_read = 0
        self.slabs_fetched = 0
        self._cuda = self.device.type == "cuda"
        self._stream = (torch.cuda.Stream(self.device) if self._cuda
                        else None)
        self._ahead = threading.Semaphore(self.depth)
        self._q: queue.Queue = queue.Queue(maxsize=self.depth + 1)
        self._stop = threading.Event()
        self._err: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._worker, daemon=True,
                                        name="slab-prefetch")
        self._thread.start()

    # -- worker side ------------------------------------------------------
    def _put(self, item) -> bool:
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=_POLL_S)
                return True
            except queue.Full:
                continue
        return False

    def _acquire(self) -> bool:
        """One of the `depth` slots ahead of the consumer; False on stop."""
        while not self._stop.is_set():
            if self._ahead.acquire(timeout=_POLL_S):
                return True
        return False

    def _to_device(self, host: torch.Tensor, slot: int, copied: list):
        """An owning copy of the host buffer on the prefetcher's device;
        on the card (tensor, event of the copy), which copied[slot]
        keeps so the buffer is not refilled before the copy lands."""
        if not self._cuda:
            return host.clone(), None
        with torch.cuda.device(self.device), torch.cuda.stream(self._stream):
            dev = torch.empty(host.shape, dtype=host.dtype,
                              device=self.device)
            dev.copy_(host, non_blocking=True)
            ev = torch.cuda.Event()
            ev.record(self._stream)
        copied[slot] = ev
        return dev, ev

    def _worker(self):
        cache = self.cache
        shape = (self.pad_to, cache.d)
        # two host buffers, recycled: a buffer is refilled only after its
        # last copy to the device has landed (copied[slot])
        ring = [torch.zeros(shape, dtype=torch.float32,
                            pin_memory=self._cuda) for _ in range(2)]
        copied = [None, None]
        try:
            for pos, idx in enumerate(self.schedule):
                if self._stop.is_set():
                    return
                slot = pos % 2
                if copied[slot] is not None:
                    copied[slot].synchronize()
                attrs = _fetch_attrs(idx)
                with _obs.span("prefetch.fetch", attrs):
                    buf = ring[slot].numpy()
                    rows = cache.rows_in_slab(idx)
                    cache.read_slab(idx, out=buf)
                    if rows < self.pad_to:
                        buf[rows:] = 0.0
                    t_wait = time.perf_counter()
                    if not self._acquire():
                        return
                    if attrs is not None:   # the wait for a slot ahead
                        attrs["slot_wait_ms"] = round(
                            (time.perf_counter() - t_wait) * 1e3, 3)
                    dev, ev = self._to_device(ring[slot], slot, copied)
                    if ev is not None and attrs is not None:
                        ev.synchronize()   # this copy only, not the sweep
                nbytes = cache.meta.slab_file_bytes(idx)
                self.bytes_read += nbytes
                self.slabs_fetched += 1
                _obs.metrics.inc("prefetch.slabs")
                _obs.metrics.inc("prefetch.bytes", nbytes)
                if not self._put((int(idx), dev, ev)):
                    return
        except BaseException as e:  # noqa: BLE001 — surfaced to consumer
            self._err = e
            self._put(_DONE)
            return
        self._put(_DONE)

    # -- consumer side ----------------------------------------------------
    def __iter__(self):
        return self

    def __next__(self):
        t0 = time.perf_counter()
        with _obs.span("prefetch.wait"):
            item = self._q.get()
        stall = time.perf_counter() - t0
        self.stall_s += stall
        _obs.metrics.inc("prefetch.stall_ms", stall * 1e3)
        if item is _DONE:
            if self._err is not None:
                err, self._err = self._err, None
                raise SlabCacheError(
                    f"slab prefetch failed: {err!r}") from err
            raise StopIteration
        self._ahead.release()
        idx, dev, ev = item
        if ev is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(ev)
            dev.record_stream(stream)
        return idx, dev

    def close(self) -> None:
        """Stop the worker and join it (idempotent; safe mid-iteration):
        drain the queue so a blocked put observes the stop flag."""
        self._stop.set()
        while True:
            try:
                self._q.get_nowait()
            except queue.Empty:
                break
        if self._thread.is_alive():
            self._thread.join(timeout=10.0)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


def _fetch_attrs(idx):
    """The `prefetch.fetch` span's attrs (None while tracing is off)."""
    return {"slab": int(idx)} if _obs.trace_enabled() else None


def ooc_schedule(n_slabs: int) -> Iterable[int]:
    """The out-of-core sweep's slab order: for each row slab r, fetch r
    (the row operand), then every column slab. Total fetches n_slabs *
    (n_slabs + 1): the disk-traffic model's slab count."""
    for r in range(n_slabs):
        yield r
        for c in range(n_slabs):
            yield c
