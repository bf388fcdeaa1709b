"""Hardware-aware planner for the s_W registry.

Twin of `repro/engine/planner.py`. The heuristics encode the paper's
Figure 1 result as dispatch rules:

  backend   choice                       why
  -------   -------------------------   -------------------------------------
  cuda      brute                       the paper's GPU cores prefer the
                                        brute Algorithm 3
  cpu       tiled  (mat2 > LLC)         CPU cores want the cache-tiled
            matmul (mat2 fits cache)    Algorithm 2 once the matrix spills
                                        the last-level cache; below that
                                        the one-hot BLAS form wins

`plan()` is shape/backend arithmetic only, no timing; it also fixes the
streaming chunk, so the live label tensor is (chunk, n) int32 rather
than (n_perms, n). On cuda a kernel whose partials grow with the chunk
(the permblock kernel's (blocks, chunk)) has them charged beside the
labels; cpu plans match the reference's. Dense designs (`n_cols` = K
basis columns) plan a per-column companion instead
(registry.resolve_cols): brute on cuda, matmul on cpu, both plain torch
products, with the chunk sized for the (chunk, n, K) basis factor.

`autotune()` is the optional measure-and-cache pass: it times every
candidate on a sample of the actual problem's permutations and persists
the winner per (device kind, shape bucket, groups) in a JSON cache of the
port's own ($REPRO_TORCH_AUTOTUNE_CACHE, default
~/.cache/repro_torch/autotune.json), which plan() reads back as its
default. A key carries the device's kind ('cpu', or 'cuda:' and the
card's name), so no card's entry is read on another card or on the CPU.
On 'cuda' every candidate is a hand kernel (brute, permblock, matmul) and
is timed by CUDA events; a candidate is skipped only where its kernel
does not apply to the shape (kernels.ShapeNotSupported), every other
build or launch error propagates. With metrics on (obs), the reference's
counters: `autotune.cache.hit` / `.miss` per lookup, `.stale_dropped`
and `.corrupt_quarantined` per cache load, `autotune.measured` per
shoot-out of autotune(); `MEASURED` counts the shoot-outs of every kind
whether telemetry is on or not.
"""

from __future__ import annotations

import collections
import dataclasses
import json
import logging
import os
import statistics
import time
import warnings
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch

from repro_torch.engine import registry
from repro_torch.kernels import ShapeNotSupported
from repro_torch.obs import metrics as _metrics

_log = logging.getLogger(__name__)
_WARNED: set = set()


def _warn_once(tag: str, msg: str) -> None:
    """Log a cache-health warning once per process (logging, not
    warnings: a sweep of many studies over a disabled cache must not emit
    a line per plan)."""
    if tag in _WARNED:
        return
    _WARNED.add(tag)
    _log.warning(msg)

# Model constants (bytes). LLC: an MI300A CCD carries 32 MiB L3; once mat2
# spills it the paper's tiled dataflow wins on CPU.
CPU_LLC_BYTES = 32 * 1024 ** 2
DEFAULT_STREAM_BUDGET_BYTES = 256 * 1024 ** 2
MIN_CHUNK = 64


@dataclasses.dataclass(frozen=True)
class Plan:
    """A resolved execution plan for one PERMANOVA problem."""
    impl: str                 # registry name
    backend: str              # 'cuda' | 'cpu'
    tuning: Dict[str, int]    # the plain form's knobs (SwImpl.bound);
                              # empty on cuda, where the kernel runs
    kernel: Optional[str]     # the kernel that runs on cuda, else None
    chunk: int                # permutations per scheduler dispatch
    streaming: bool           # True when n_perms+1 > chunk
    reason: str

    def describe(self) -> str:
        t = f"{self.kernel} kernel" if self.kernel else ",".join(
            f"{k}={v}" for k, v in sorted(self.tuning.items()))
        mode = f"stream(chunk={self.chunk})" if self.streaming else "batch"
        return f"{self.impl}[{t}] {mode} on {self.backend}: {self.reason}"


def _pick_impl(backend: str, n: int,
               n_groups: Optional[int] = None) -> Tuple[str, str]:
    if n_groups is not None:
        measured = measured_impl(backend, n, n_groups)
        if measured is not None:
            return measured, ("persisted autotune measurement "
                              f"({autotune_cache_path()})")
    if backend == "cuda":
        return "brute", "GPU cores prefer brute force (paper Fig. 1)"
    mat2_bytes = 4 * n * n
    if backend == "cpu" and mat2_bytes > CPU_LLC_BYTES:
        return "tiled", (f"mat2 {mat2_bytes/2**20:.0f}MiB spills the "
                         f"{CPU_LLC_BYTES/2**20:.0f}MiB LLC; cache-tiled "
                         "Algorithm 2 wins on CPU (paper Fig. 1)")
    return "matmul", "mat2 cache-resident; one-hot BLAS form amortizes reads"


def _pick_impl_design(backend: str) -> Tuple[str, str]:
    """Impl for DENSE designs: the re-streaming brute dataflow on the card
    (the paper's Fig. 1 GPU rule), the per-column matmul form elsewhere."""
    if backend == "cuda":
        return "brute", ("dense design, GPU: per-perm re-stream "
                         "(Fig. 1 brute analogue)")
    return "matmul", ("dense design: per-column matmul contraction "
                      "(hat-matrix blocks on the MXU/BLAS path)")


def label_budget(budget_bytes: Optional[float] = None) -> float:
    """The label budget in bytes: the caller's, or the default."""
    return DEFAULT_STREAM_BUDGET_BYTES if budget_bytes is None \
        else budget_bytes


def chunk_for_budget(n: int, n_perms: int,
                     budget_bytes: Optional[float] = None,
                     n_cols: Optional[int] = None,
                     partial_bytes_per_perm: float = 0.0) -> int:
    """Largest permutation chunk whose streamed state — (chunk, n) int32
    labels plus the per-perm output — fits the budget. The resident mat2
    is paid regardless of chunking and is not charged against it. Dense
    designs (n_cols = K basis columns) also stream the gathered (chunk, n,
    K) f32 basis factor and a (chunk, K) output. partial_bytes_per_perm:
    a kernel's partials per permutation (SwImpl.card_bytes_per_perm),
    charged beside the labels."""
    budget = label_budget(budget_bytes)
    per_perm = 4.0 * n + 8.0 + partial_bytes_per_perm
    if n_cols is not None:
        per_perm += 4.0 * n * n_cols + 4.0 * n_cols
    if MIN_CHUNK * per_perm > budget:
        warnings.warn(
            f"label budget {budget/2**20:.2f}MiB cannot hold even the "
            f"minimum chunk ({MIN_CHUNK} perms x {4*n} label bytes) at "
            f"n={n}; proceeding with chunk={MIN_CHUNK} — label memory will "
            "exceed the budget", stacklevel=2)
        return min(MIN_CHUNK, n_perms)
    return min(max(MIN_CHUNK, int(budget // per_perm)), n_perms)


def plan(n: int, n_perms: int, *, backend: str,
         memory_budget_bytes: Optional[float] = None,
         chunk: Optional[int] = None, impl: Optional[str] = None,
         n_cols: Optional[int] = None,
         n_groups: Optional[int] = None) -> Plan:
    """Resolve impl + streaming chunk for one problem.

    n_perms counts all permutation slots (the requested count + 1 for the
    observed labels at index 0). `impl`/`chunk` pin those choices.
    n_cols: the basis width K of a DENSE design; the plan then names the
    impl whose per-column companion runs (a label-only impl resolves to
    matmul's) and no kernel, since the companions are torch products.
    n_groups: the label groups; given, an unpinned label plan takes the
    persisted autotune winner for this (device kind, n bucket, groups)
    where one exists (measured_impl), and still sizes its chunk by that
    impl's own model (a tiled winner's partials on the card).
    """
    if impl is None:
        name, reason = (_pick_impl_design(backend) if n_cols is not None
                        else _pick_impl(backend, n, n_groups))
    else:
        name, reason = impl, "caller-pinned impl"
    if n_cols is not None:
        resolved, _ = registry.resolve_cols(name)
        if resolved != registry.get(name).name:
            reason += (f"; {name!r} is label-only, dense design runs its "
                       f"{resolved!r} companion")
            name = resolved
    spec = registry.get(name)
    on_card = backend == "cuda" and n_cols is None
    if chunk is None:
        partials = spec.card_bytes_per_perm(n) \
            if on_card and spec.card_bytes_per_perm else 0.0
        chunk = chunk_for_budget(n, n_perms, memory_budget_bytes,
                                 n_cols=n_cols,
                                 partial_bytes_per_perm=partials)
    chunk = max(1, min(int(chunk), n_perms))
    return Plan(impl=spec.name, backend=backend,
                tuning={} if on_card else dict(spec.tuning),
                kernel=spec.kernel if on_card else None,
                chunk=chunk, streaming=chunk < n_perms, reason=reason)


# ---------------------------------------------------------------------------
# Empirical autotuner: measure-and-cache on the real operands. Winners are
# memoized in-process AND persisted to a JSON cache, loaded lazily at the
# first plan() and fed back into the heuristic defaults, so a host pays
# each measurement once, not once per process.
# ---------------------------------------------------------------------------

_AUTOTUNE_CACHE: Dict[tuple, str] = {}       # in-process winners
_PERSIST: Optional[Dict[str, dict]] = None   # lazy-loaded disk cache
_PERSIST_PATH: Optional[str] = None          # the file _PERSIST came from
_DIRTY: set = set()                          # keys THIS process measured
AUTOTUNE_CACHE_ENV = "REPRO_TORCH_AUTOTUNE_CACHE"
# Entry schema of the dist| / fusedk| key families (the precision knobs
# are part of a fused key); an entry of another schema is dropped on load
# (migrate-or-drop). The s_W shoot-out keys carry no schema.
CACHE_SCHEMA = 2
# A shoot-out's sample: 1,024 permutations, eight of the card's
# 128-permutation passes, so that each kernel fills the card as the run's
# chunks of thousands do. At one pass brute's 393 bands leave the card
# part-idle and permblock wins by 5% (5.273 against 5.531 ms), while at
# 1,000 and 2,668 permutations brute is 1.13x faster (chip_smoke.py
# phases 4 and 19, NVIDIA H100 80GB HBM3, 700.00 W). TIMED_CALLS: the
# calls timed after the warm-up call, of which the median counts.
SAMPLE_PERMS = 1024
TIMED_CALLS = 3
# Shoot-outs this process ran, by kind ('sw', 'stage1', 'fused'): a run
# that found a persisted winner adds nothing.
MEASURED: collections.Counter = collections.Counter()


def _valid_entry(key: str, val) -> bool:
    if not (isinstance(val, dict) and "impl" in val):
        return False
    if key.startswith(("dist|", "fusedk|")):
        return val.get("schema") == CACHE_SCHEMA
    return True


def _bucket(n: int) -> int:
    """Shape bucket: next power of two (timings are stable within one)."""
    b = 1
    while b < n:
        b *= 2
    return b


def device_kind(backend: str) -> Optional[str]:
    """The device kind a cache key carries: 'cpu', or 'cuda:' and the
    card's name. None for 'cuda' where no card is present (a plan made
    for the card off it reads no measurement)."""
    if backend != "cuda":
        return backend
    if not torch.cuda.is_available():
        return None
    return f"cuda:{torch.cuda.get_device_name()}"


def autotune_cache_path() -> Optional[str]:
    """The cache file: $REPRO_TORCH_AUTOTUNE_CACHE ('off' disables it),
    else ~/.cache/repro_torch/autotune.json."""
    override = os.environ.get(AUTOTUNE_CACHE_ENV)
    if override:
        return None if override.lower() in ("off", "none", "0") else override
    return os.path.join(os.path.expanduser("~"), ".cache", "repro_torch",
                        "autotune.json")


def _persist_key(kind: str, n: int, n_groups: int) -> str:
    return f"{kind}|n{_bucket(n)}|g{n_groups}"


def measured_entry(key: str) -> Optional[dict]:
    """One persisted measurement by raw key (the pipeline planner's
    'dist|<kind>|<metric>|<impl>' and 'fusedk|<kind>|<metric>|<impl>'
    entries are read through this)."""
    return load_autotune_cache().get(key)


def record_entry(key: str, entry: dict) -> None:
    """Persist one measurement under `key`. `entry` must carry an 'impl'
    field; it is stamped with the current CACHE_SCHEMA."""
    if "impl" not in entry:
        raise ValueError("autotune cache entries must carry an 'impl' field")
    entry = dict(entry)
    entry.setdefault("schema", CACHE_SCHEMA)
    cache = load_autotune_cache()   # BEFORE marking dirty: a fresh load
    _DIRTY.add(key)                 # clears _DIRTY
    cache[key] = entry
    _save_autotune_cache()


def load_autotune_cache(*, reload: bool = False) -> Dict[str, dict]:
    """The persisted measurements, loaded on first use, on `reload`, or
    when the cache path changed since the last load (which also clears
    the in-process winners: they belong to the old file)."""
    global _PERSIST, _PERSIST_PATH
    path = autotune_cache_path()
    if _PERSIST is not None and not reload and path == _PERSIST_PATH:
        return _PERSIST
    _PERSIST, _PERSIST_PATH = {}, path
    _DIRTY.clear()
    _AUTOTUNE_CACHE.clear()
    if path and os.path.exists(path):
        try:
            with open(path) as f:
                data = json.load(f)
            if not isinstance(data, dict):
                raise ValueError(f"expected a JSON object, got "
                                 f"{type(data).__name__}")
            _PERSIST = {k: v for k, v in data.items()
                        if _valid_entry(k, v)}
            dropped = len(data) - len(_PERSIST)
            if dropped:
                _metrics.inc("autotune.cache.stale_dropped", dropped)
                _warn_once(
                    "stale", f"autotune cache {path}: dropped {dropped} "
                    f"entr{'y' if dropped == 1 else 'ies'} of another "
                    f"schema (current schema {CACHE_SCHEMA}); they will be "
                    "measured again")
        except (OSError, ValueError) as e:
            # corrupt or unreadable (a crash mid-write truncated it):
            # quarantine it, so the next writer starts clean and the
            # evidence survives, and go on with an empty cache
            _quarantine_corrupt_cache(path, e)
    return _PERSIST


def _quarantine_corrupt_cache(path: str, err: Exception) -> None:
    quarantined = f"{path}.corrupt"
    try:
        os.replace(path, quarantined)
        where = f"; quarantined to {quarantined}"
    except OSError:
        where = " (quarantine rename failed; leaving it in place)"
    _metrics.inc("autotune.cache.corrupt_quarantined")
    _warn_once("corrupt",
               f"autotune cache {path} is corrupt ({err}); continuing "
               f"with an empty cache{where}. Entries will be measured "
               "again.")


def _save_autotune_cache() -> None:
    global _PERSIST
    path = autotune_cache_path()
    if not path:
        _warn_once(
            "disabled", f"autotune cache disabled (${AUTOTUNE_CACHE_ENV}); "
            "measurements will not persist across processes")
        return
    if _PERSIST is None:
        return
    try:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        # merge on save: re-read the file and overlay only the keys THIS
        # process measured (best effort, not locked: two writers racing
        # between the read and the replace can drop one key, which its
        # writer measures again next time)
        on_disk: Dict[str, dict] = {}
        if os.path.exists(path):
            try:
                with open(path) as f:
                    data = json.load(f)
                if isinstance(data, dict):
                    on_disk = {k: v for k, v in data.items()
                               if _valid_entry(k, v)}
            except (OSError, ValueError):
                pass
        ours = {k: v for k, v in _PERSIST.items() if k in _DIRTY}
        _PERSIST = {**on_disk, **ours}
        # atomic publish: a per-pid temp file, fsync, os.replace; readers
        # only ever see a whole document
        tmp = f"{path}.tmp.{os.getpid()}"
        try:
            with open(tmp, "w") as f:
                json.dump(_PERSIST, f, indent=2, sort_keys=True)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
        except BaseException:
            try:
                os.unlink(tmp)               # never leave a partial temp
            except OSError:
                pass
            raise
    except OSError:  # a read-only home: the cache is best effort
        pass


def measured_impl(backend: str, n: int, n_groups: int,
                  candidates: Optional[Sequence[str]] = None
                  ) -> Optional[str]:
    """Persisted winner for this (device kind, n bucket, groups), if any:
    trusted only when it was measured over (at least) the requested
    candidates (default: every registered impl) and is still
    registered."""
    kind = device_kind(backend)
    if kind is None:
        _metrics.inc("autotune.cache.miss")
        return None
    entry = load_autotune_cache().get(_persist_key(kind, n, n_groups))
    if not entry:
        _metrics.inc("autotune.cache.miss")
        return None
    wanted = set(candidates if candidates is not None else registry.names())
    if not wanted <= set(entry.get("candidates", ())):
        _metrics.inc("autotune.cache.miss")
        return None
    name = entry.get("impl")
    try:
        name = registry.get(name).name
    except KeyError:
        _metrics.inc("autotune.cache.miss")
        return None
    _metrics.inc("autotune.cache.hit")
    return name


def time_call(fn: Callable, device: torch.device,
              calls: int = TIMED_CALLS) -> float:
    """Median ms of `calls` calls of fn() after one warm-up call (which
    absorbs a kernel's first-use build). On the card each call is timed
    by CUDA events and waited for; on the CPU by the host clock."""
    fn()
    times = []
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        for _ in range(calls):
            e0.record()
            fn()
            e1.record()
            e1.synchronize()
            times.append(e0.elapsed_time(e1))
    else:
        for _ in range(calls):
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def autotune(mat2: torch.Tensor, grouping: torch.Tensor,
             inv_gs: torch.Tensor, *,
             candidates: Optional[Sequence[str]] = None,
             sample_perms: int = SAMPLE_PERMS, seed: int = 0,
             use_cache: bool = True) -> str:
    """Time each candidate impl on `sample_perms` of the port's draws
    from `seed` over the actual operands, on their device, and return the
    fastest name. Winners are memoized per (device kind, n bucket,
    groups, candidates) and persisted per (device kind, n bucket,
    groups); a restricted shoot-out never overwrites a broader one. On
    'cuda' each candidate launches its hand kernel: a kernel that does
    not apply to the shape is skipped, any other failure raises."""
    from repro_torch.core import permutations   # deferred: import cycle
    backend = mat2.device.type
    n = int(mat2.shape[0])
    n_groups = int(inv_gs.shape[0])
    names = [registry.get(c).name for c in (
        candidates if candidates is not None else registry.names())]
    kind = device_kind(backend)
    memo_key = (kind, _bucket(n), n_groups, tuple(sorted(names)))
    if use_cache:
        load_autotune_cache()      # a changed cache path clears the memo
        if memo_key in _AUTOTUNE_CACHE:
            _metrics.inc("autotune.cache.hit")
            return _AUTOTUNE_CACHE[memo_key]
        persisted = measured_impl(backend, n, n_groups, names)
        if persisted in names:
            _AUTOTUNE_CACHE[memo_key] = persisted
            return persisted

    labels = permutations.permutation_batch(
        grouping, 0, sample_perms, seed=seed,
        block_rows=permutations.draw_rows(n, label_budget()))
    times_ms: Dict[str, float] = {}
    for name in names:
        fn = registry.get(name).bound()
        try:
            times_ms[name] = time_call(lambda: fn(mat2, labels, inv_gs),
                                       mat2.device)
        except ShapeNotSupported:
            continue
    if not times_ms:
        raise RuntimeError("autotune: no candidate impl applies to "
                           f"n={n}, P={sample_perms}")
    MEASURED["sw"] += 1
    _metrics.inc("autotune.measured")
    best = min(times_ms, key=times_ms.get)
    if use_cache:
        _AUTOTUNE_CACHE[memo_key] = best
        pkey = _persist_key(kind, n, n_groups)
        prior = load_autotune_cache().get(pkey)
        # never let a restricted shoot-out overwrite a broader measurement
        if prior is None or not \
                set(names) < set(prior.get("candidates", ())):
            _DIRTY.add(pkey)
            load_autotune_cache()[pkey] = {
                "impl": best, "candidates": sorted(names),
                "times_ms": times_ms, "n": n, "n_groups": n_groups,
                "sample_perms": sample_perms, "calls": TIMED_CALLS}
            _save_autotune_cache()
    return best
