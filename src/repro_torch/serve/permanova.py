"""Always-on multi-tenant PERMANOVA serving with fault tolerance.

Twin of `repro/serve/permanova.py`. A persistent service admitting a
stream of studies (arbitrary n, metric, design) and returning full
PERMANOVA results under production failure modes. The design rests on one
property: the permutation dimension is a bag of idempotent BLOCKS — the
port's draws are a counter hash of (seed, global index, sample), so any
worker, any retry, any speculative duplicate, and any post-restart
recomputation of a block is bit-identical by construction. Recovery is
therefore exact recomputation, never approximate reconciliation.

Layers:

  * SHAPE BUCKETS — each request is padded up to a bucket size (next
    power of two by default): mat2 with zero rows and columns, the labels
    with the sentinel G (weight 0 in every s_W form and kernel), a dense
    design's basis with zero rows. The plan of each (bucket, n_groups,
    mode, K) is made once and persisted in the autotune cache under
    `serveplan|<device kind>|...` keys, so plan decisions survive
    restarts. A warm server builds and loads no kernel library and misses
    no bucket for a request of a known bucket (the reference counts zero
    jaxpr retraces; the port has none to count).
  * BATCH COALESCING — queued requests of the SAME bucket are coalesced
    into one dispatch: their operands are stacked along a leading study
    axis in one host -> device copy per operand, and every permutation
    block runs through the batched steps (scheduler.sw_block_many /
    sw_cols_block_many), which run each study on the launches its serial
    step makes: batched results equal serial ones bit for bit. Blocks
    span the largest n_perms in the batch; a study computes no rows past
    its own sweep.
  * ASYNC ADMISSION — submit() returns a concurrent.futures.Future.
    Background worker threads (start()/stop()) drain the bounded queue,
    coalescing same-bucket neighbours up to `max_batch`; pump() is the
    serial shim (and the bit-identity reference path). All device work
    runs under one lock (`_exec_lock`), on each thread's default stream.
  * ELASTIC EXECUTION — blocks run through
    runtime.elastic.ElasticBlockExecutor, wired to the
    runtime.heartbeat.HeartbeatMonitor failure detector: dead workers'
    blocks are re-dispatched, stragglers are speculatively re-executed,
    zombie completions are fenced off by heartbeat incarnations. All
    chaos comes from the seeded runtime.faultinject.FaultInjector
    against an injected clock. Each block's s_W is copied to the host
    when it commits (one wait for the card a block).
  * ROBUSTNESS POLICY — bounded admission queue with load shedding and a
    backpressure signal; per-request deadlines with graceful degradation
    (a reduced-n_perms result carrying a Monte-Carlo confidence interval
    for the p-value, flagged `degraded=True`); jittered-backoff retries
    for transient failures (simulated device OOM, full fleet loss);
    checkpoint/resume of partial s_W through checkpoint/manager.py, so a
    restarted server finishes in-flight work instead of replaying it.
    Deadline-degraded requests keep their partial s_W in memory and are
    OPPORTUNISTICALLY RESUMED in idle capacity: `ServeResult.final`
    receives the exact full-n_perms result.

Admission state is host-side, as the reference keeps it: the padded mat2
is a numpy array (a features request's distances come from the device's
distance kernel and are copied back), and each request's operands go to
the device once, when it runs.

Determinism: the masked draws give a padded study the unpadded study's
draws (padded == unpadded, unlike the reference, whose masked stream is
its own). The s_W kernels' tile and band order depends on n_pad, though,
so the bits of s_W can move with the bucket: a checkpoint written under
another n_pad is not resumed (warn-once + `serve.ckpt_bucket_drift`), and
the request is recomputed from scratch.
"""

from __future__ import annotations

import dataclasses
import logging
import math
import pathlib
import shutil
import threading
import time
from collections import deque
from concurrent.futures import Future
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import hw
from repro_torch import obs as _obs
from repro_torch.checkpoint import manager as ckpt_mod
from repro_torch.core import design as design_mod
from repro_torch.core.permanova import (PermanovaResult, TermResult, _later,
                                        f_from_sw)
from repro_torch.engine import planner, registry, scheduler
from repro_torch.pipeline import registry as dist_registry
from repro_torch.runtime.elastic import AllWorkersDead, ElasticBlockExecutor
from repro_torch.runtime.faultinject import FaultInjector, SimulatedOOM

_log = logging.getLogger("repro_torch.serve")


# ---------------------------------------------------------------------------
# Request / result contracts.
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class StudyRequest:
    """One tenant study. Provide a distance matrix (`dm`) or raw features
    (`x` + `metric`), as numpy arrays or tensors; `seed` fixes the
    permutation stream end to end."""
    grouping: np.ndarray
    dm: Optional[np.ndarray] = None
    x: Optional[np.ndarray] = None
    metric: str = "braycurtis"
    n_groups: Optional[int] = None
    n_perms: int = 999
    seed: int = 0
    strata: Optional[np.ndarray] = None
    covariates: Optional[np.ndarray] = None
    weights: Optional[np.ndarray] = None
    deadline_s: Optional[float] = None
    request_id: str = ""


@dataclasses.dataclass
class ServeResult:
    """Serving envelope around the statistical result.

    status: 'ok' | 'degraded' | 'shed' | 'failed'.
    degraded=True means the deadline cut the sweep short: `result` holds
    statistics over `n_perms_done` permutations and `p_ci` is a
    Monte-Carlo confidence interval for the p-value the full-n_perms run
    would report. With opportunistic resume (the default), `final` is a
    Future that later receives the EXACT full-n_perms ServeResult,
    computed from the kept partial s_W in idle capacity.
    batched=True marks results produced by a coalesced same-bucket
    dispatch (bit-identical to the serial path by construction).
    """
    request_id: str
    status: str
    result: Optional[PermanovaResult] = None
    degraded: bool = False
    n_perms_done: int = 0
    p_ci: Optional[Tuple[float, float]] = None
    error: str = ""
    retries: int = 0
    wall_s: float = 0.0
    bucket: str = ""
    report: object = None      # runtime.elastic.ExecReport of the last try
    batched: bool = False
    final: Optional[Future] = None

    @property
    def ok(self) -> bool:
        return self.status in ("ok", "degraded")


@dataclasses.dataclass
class RetryPolicy:
    """Jittered exponential backoff for TRANSIENT failures (simulated
    device OOM escaping block-level retry, or losing the whole fleet)."""
    max_retries: int = 3
    base_backoff_s: float = 0.05
    max_backoff_s: float = 2.0
    jitter: float = 0.5


def mc_pvalue_ci(n_ge: int, m: int, n_perms_full: int,
                 conf: float = 0.95,
                 use_scipy: Optional[bool] = None) -> Tuple[float, float]:
    """Predictive CI for the p-value the FULL-n_perms run would report.

    A degraded response completed m of n_perms_full permutations with
    `n_ge` null exceedances. The full run's count is n_ge + B, where B is
    the hits among the permutations the deadline cut off; under a
    Jeffreys Beta(1/2, 1/2) prior on the exceedance probability, B | data
    is beta-binomial. Mapping its conf-level predictive quantiles through
    p = (n_ge + B + 1) / (n_perms_full + 1) yields an interval that
    covers the full run's actual p-value.

    The interval is always ordered and brackets the degraded point
    estimate p_hat = (n_ge + 1)/(m + 1), including at the extremes
    (0 hits or all hits): quantiles are clamped into [0, rest] and the
    bounds into [1/(n_perms_full+1), 1], under both the scipy and the
    normal-approximation paths. use_scipy: None (default) tries scipy
    and falls back; True requires scipy; False forces the fallback.
    """
    m, k, n_full = int(m), int(n_ge), int(n_perms_full)
    rest = max(n_full - m, 0)
    if rest == 0:
        p = (k + 1.0) / (n_full + 1.0)
        return (p, p)
    p_hat = (k + 1.0) / (m + 1.0)
    a, b = k + 0.5, m - k + 0.5
    alpha = 1.0 - conf
    b_lo = b_hi = None
    if use_scipy is None or use_scipy:
        try:
            from scipy.stats import betabinom
            q_lo = float(betabinom.ppf(alpha / 2, rest, a, b))
            q_hi = float(betabinom.ppf(1 - alpha / 2, rest, a, b))
            if math.isfinite(q_lo) and math.isfinite(q_hi):
                b_lo, b_hi = int(q_lo), int(q_hi)
        except Exception:
            if use_scipy:
                raise
    if b_lo is None or b_hi is None:   # normal approx to the predictive
        mean = rest * a / (a + b)
        var = (rest * a * b * (a + b + rest)) / ((a + b) ** 2
                                                 * (a + b + 1.0))
        z = 1.959963984540054 if conf >= 0.95 else 1.6448536269514722
        sd = math.sqrt(max(var, 0.0))
        b_lo = int(math.floor(mean - z * sd))
        b_hi = int(math.ceil(mean + z * sd))
    b_lo = min(max(b_lo, 0), rest)
    b_hi = min(max(b_hi, 0), rest)
    if b_lo > b_hi:
        b_lo, b_hi = b_hi, b_lo
    lo = (k + b_lo + 1.0) / (n_full + 1.0)
    hi = (k + b_hi + 1.0) / (n_full + 1.0)
    lo = max(min(lo, p_hat), 1.0 / (n_full + 1.0))
    hi = min(max(hi, p_hat), 1.0)
    return (lo, hi)


# ---------------------------------------------------------------------------
# Internal prepared request + shape buckets.
# ---------------------------------------------------------------------------

_MODE_LABELS = "labels"
_MODE_STRATA = "labels_strata"
_MODE_COLS = "cols"


@dataclasses.dataclass
class _Class:
    """Light request classification: everything the admission layer needs
    to route a request to its bucket WITHOUT touching the distance
    matrix (bucket signature = (n_pad, n_groups, mode, k_cols))."""
    mode: str
    n: int
    n_groups: int
    n_pad: int
    k_cols: int
    design: Optional[design_mod.Design]
    grouping: np.ndarray


@dataclasses.dataclass
class _Prepared:
    """Admission-side request state, all on the host: numpy arrays, and a
    dense design's padded basis and strata as CPU tensors. The execution
    paths copy each operand to the device once per dispatch unit — per
    request on the serial path, per stacked batch on the coalesced path
    — so admitting a request moves nothing to the device."""
    req: StudyRequest
    mode: str
    n: int                      # true sample count
    n_pad: int
    n_groups: int
    k_cols: int                 # 0 on label modes
    n_total: int                # n_perms + 1
    mat2: np.ndarray            # (n_pad, n_pad) f32, pad rows zero
    grouping: np.ndarray        # (n_pad,) i32, sentinel-padded
    strata: Optional[object]    # (n_pad,) i32: numpy (labels_strata) or
                                # a CPU tensor (cols)
    basis: Optional[torch.Tensor]   # (n_pad, K) f32 on the CPU (cols)
    inv_gs: Optional[np.ndarray]
    design: Optional[design_mod.Design]
    s_t: float
    n_valid: int


@dataclasses.dataclass
class _Bucket:
    key: tuple
    impl: str
    tuning: dict
    fn: Callable
    hits: int = 0

    def describe(self) -> str:
        n_pad, n_groups, mode, k = self.key
        return (f"bucket(n={n_pad},g={n_groups},{mode}"
                + (f",k={k}" if k else "") + f")->{self.impl}")


@dataclasses.dataclass
class _QItem:
    """Admission-queue entry: the request, the caller's future, and the
    lazily computed bucket signature used for coalescing."""
    req: StudyRequest
    future: Optional[Future] = None
    sig: Optional[tuple] = None


@dataclasses.dataclass
class _ResumeWork:
    """A deadline-degraded request's kept partial state, queued for
    opportunistic completion in idle capacity (serial layout)."""
    p: _Prepared
    bucket: _Bucket
    out: np.ndarray
    done: np.ndarray
    spans: List[Tuple[int, int]]
    res: ServeResult
    future: Future


def _next_bucket(n: int, sizes: Optional[List[int]]) -> int:
    if sizes:
        for s in sorted(sizes):
            if s >= n:
                return int(s)
        raise ValueError(
            f"request has n={n} samples but the largest configured bucket "
            f"size is {max(sizes)}; add a larger entry to bucket_sizes= "
            "or pass bucket_sizes=None for open-ended power-of-two "
            "buckets")
    b = 16
    while b < n:
        b *= 2
    return b


class ServerOverloaded(RuntimeError):
    """Raised by submit(..., shed='raise') when the admission queue is
    full — the hard-backpressure signal."""


_drift_warned = False     # warn-once latch for checkpoint bucket drift


def _host(a, dtype) -> np.ndarray:
    """A numpy copy-free view (or a host copy of a tensor) of `a`."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.asarray(a, dtype)


class PermanovaServer:
    """Always-on multi-tenant PERMANOVA service (see module docstring).

    workers / block: the elastic fleet size and the permutation-block
    granularity (the unit of re-dispatch, speculation, and checkpoint).
    queue_limit: bounded admission queue; submissions past it are SHED.
    max_batch: coalescing bound — a drain pass batches up to this many
    queued same-bucket requests into one stacked dispatch.
    device: 'cuda' (default; raises without a card) or 'cpu'; the planner
    plans for its type, and the s_W impls run their kernels on 'cuda'.
    mesh: the reference shards a batch's study axis over a mesh; that
    comes with the multi-device slice (NotImplementedError here).
    opportunistic_resume: keep degraded requests' partial s_W and finish
    the permutation tail in idle capacity (ServeResult.final).
    clock / injector: injectable time and faults — production uses the
    real monotonic clock and no faults; chaos tests drive both.
    ckpt_dir: enables checkpoint/resume of in-flight partial s_W.
    draws: None (the port's masked draws from each request's seed), or a
    callable draws(request, lo, rows, n_pad) giving one block's explicit
    (rows, n_pad) int32 labels (label modes) or index permutations (a
    dense design) for global indices [lo, lo + rows): the server's
    counterpart of engine.run(perms=); parity tests feed the reference's
    masked draws through it.
    """

    def __init__(self, *, workers: int = 4, block: int = 128,
                 queue_limit: int = 64,
                 bucket_sizes: Optional[List[int]] = None,
                 max_batch: int = 8,
                 device="cuda",
                 mesh=None,
                 opportunistic_resume: bool = True,
                 heartbeat_timeout: float = 5.0,
                 straggler_factor: float = 4.0,
                 clock: Optional[Callable[[], float]] = None,
                 injector: Optional[FaultInjector] = None,
                 retry: Optional[RetryPolicy] = None,
                 max_transient_retries: int = 8,
                 ckpt_dir=None, checkpoint_every: int = 8,
                 latency_window: int = 512,
                 draws: Optional[Callable] = None):
        if mesh is not None:
            raise _later("mesh= (study-axis sharding of a batch)",
                         "multi-device")
        self.device = hw.resolve_device(device)
        self.backend = self.device.type
        self.workers = int(workers)
        self.block = int(block)
        self.queue_limit = int(queue_limit)
        self.bucket_sizes = bucket_sizes
        self.max_batch = max(1, int(max_batch))
        self.opportunistic_resume = bool(opportunistic_resume)
        self.heartbeat_timeout = float(heartbeat_timeout)
        self.straggler_factor = float(straggler_factor)
        self.clock = clock or time.monotonic
        self.injector = injector
        self.retry = retry or RetryPolicy()
        self.max_transient_retries = int(max_transient_retries)
        self.ckpt_dir = ckpt_dir
        self.checkpoint_every = int(checkpoint_every)
        self.draws = draws
        self._rng = np.random.default_rng(0)     # retry jitter (seeded)
        self._lock = threading.RLock()
        self._cv = threading.Condition(self._lock)
        self._exec_lock = threading.RLock()      # one dispatch at a time
        self._queue: deque = deque()             # _QItem entries
        self._resume_q: deque = deque()          # _ResumeWork entries
        self._buckets: Dict[tuple, _Bucket] = {}
        self._lat = deque(maxlen=int(latency_window))  # (t_end, dur_s, ok)
        self._seq = 0
        self._threads: List[threading.Thread] = []
        self._stopping = False
        self._abandon = False
        self._inflight = 0

    # -- admission --------------------------------------------------------
    @property
    def queue_depth(self) -> int:
        return len(self._queue)

    @property
    def backpressure(self) -> bool:
        """Soft signal: queue at >= 80% of the admission bound — callers
        should slow down before submissions start shedding."""
        return len(self._queue) >= max(1, int(0.8 * self.queue_limit))

    def submit(self, req: StudyRequest, *, shed: str = "result") -> Future:
        """Admit one request; returns a Future resolving to its
        ServeResult (completed by pump(), serve(), or the background
        worker threads). When the bounded queue is full the request is
        SHED: with shed='result' (default) the future resolves
        immediately to ServeResult(status='shed'); with shed='raise'
        ServerOverloaded is raised. A request that cannot fit any
        configured bucket resolves immediately to status='failed'."""
        fut: Future = Future()
        with self._cv:
            if not req.request_id:
                req.request_id = f"req{self._seq}"
            self._seq += 1
            if len(self._queue) >= self.queue_limit:
                _obs.metrics.inc("serve.requests_shed")
                if shed == "raise":
                    raise ServerOverloaded(
                        f"admission queue full ({self.queue_limit})")
                fut.set_result(ServeResult(
                    request_id=req.request_id, status="shed",
                    error="admission queue full"))
                return fut
            try:
                n = int(np.asarray(req.grouping).shape[0])
                _next_bucket(n, self.bucket_sizes)
            except ValueError as e:
                _obs.metrics.inc("serve.requests_failed")
                fut.set_result(ServeResult(
                    request_id=req.request_id, status="failed",
                    error=f"ValueError: {e}"))
                return fut
            self._queue.append(_QItem(req=req, future=fut))
            _obs.metrics.inc("serve.requests_admitted")
            _obs.metrics.gauge_set("serve.queue_depth", len(self._queue))
            self._cv.notify()
        return fut

    def pump(self, max_requests: Optional[int] = None) -> List[ServeResult]:
        """Process queued requests FIFO, one at a time; returns their
        results. The single-threaded SERIAL shim — no batch coalescing —
        and the bit-identity reference for the batched path."""
        out: List[ServeResult] = []
        while True:
            with self._cv:
                if not self._queue or (max_requests is not None
                                       and len(out) >= max_requests):
                    break
                item = self._queue.popleft()
                _obs.metrics.gauge_set("serve.queue_depth",
                                       len(self._queue))
            res = self.process(item.req)
            self._finish(item, res)
            out.append(res)
        return out

    def drain_batched(self, max_batch: Optional[int] = None
                      ) -> List[ServeResult]:
        """Drain the queue with same-bucket coalescing: each pass pops
        the head request plus every queued request sharing its bucket
        signature (up to max_batch) and executes them as ONE stacked
        dispatch."""
        out: List[ServeResult] = []
        mb = self.max_batch if max_batch is None else max(1, int(max_batch))
        while True:
            batch = self._pop_batch(mb)
            if not batch:
                return out
            out.extend(self._process_batch(batch))

    def serve(self, reqs: List[StudyRequest], *,
              batched: bool = False,
              max_batch: Optional[int] = None) -> List[ServeResult]:
        """Convenience: submit everything, drain, return results in
        request order (shed results land inline). batched=True coalesces
        same-bucket requests into stacked dispatches; the default drains
        serially through pump(). When background workers are running
        (start()), this just submits and waits on the futures."""
        futs = [self.submit(r) for r in reqs]
        if not self._threads:
            if batched:
                self.drain_batched(max_batch)
            else:
                self.pump()
        return [f.result() for f in futs]

    # -- background workers ----------------------------------------------
    def start(self, threads: int = 2) -> None:
        """Start background admission workers: each drains the queue
        (coalescing same-bucket requests up to max_batch), completes
        futures, and — when the queue is empty — opportunistically
        finishes degraded requests' permutation tails."""
        with self._cv:
            if self._threads:
                return
            self._stopping = False
            self._abandon = False
            for i in range(max(1, int(threads))):
                t = threading.Thread(target=self._worker_loop,
                                     name=f"permanova-serve-{i}",
                                     daemon=True)
                t.start()
                self._threads.append(t)

    def stop(self, *, drain: bool = True,
             timeout: Optional[float] = None) -> None:
        """Stop the background workers. drain=True (default) waits for
        the admission and resume queues to empty first; drain=False
        abandons queued work (its futures stay pending)."""
        with self._cv:
            if drain:
                while self._queue or self._resume_q or self._inflight:
                    self._cv.wait(timeout=0.1)
            self._stopping = True
            self._abandon = not drain
            self._cv.notify_all()
        for t in self._threads:
            t.join(timeout=timeout)
        self._threads = []

    def _worker_loop(self) -> None:
        while True:
            with self._cv:
                while (not self._stopping and not self._queue
                       and not self._resume_q):
                    self._cv.wait(timeout=0.2)
                if self._abandon:
                    return
                if self._stopping and not self._queue \
                        and not self._resume_q:
                    return
            batch = self._pop_batch(self.max_batch)
            if batch:
                with self._cv:
                    self._inflight += 1
                try:
                    self._process_batch(batch)
                finally:
                    with self._cv:
                        self._inflight -= 1
                        self._cv.notify_all()
                continue
            work = None
            with self._cv:
                if self._resume_q and not self._queue:
                    work = self._resume_q.popleft()
                    self._inflight += 1
            if work is not None:
                try:
                    self._run_resume(work)
                finally:
                    with self._cv:
                        self._inflight -= 1
                        self._cv.notify_all()

    def _finish(self, item: _QItem, res: ServeResult) -> None:
        if item.future is not None and not item.future.done():
            item.future.set_result(res)
        with self._cv:
            self._cv.notify_all()

    # -- batch coalescing -------------------------------------------------
    def _sig_of(self, item: _QItem) -> Optional[tuple]:
        """Bucket signature of a queued request (cached on the entry).
        Classification failures complete the future as status='failed'
        and return None — one bad request never poisons the drain."""
        if item.sig is not None:
            return item.sig
        try:
            c = self._classify(item.req)
        except Exception as e:
            _obs.metrics.inc("serve.requests_failed")
            self._finish(item, ServeResult(
                request_id=item.req.request_id, status="failed",
                error=f"{type(e).__name__}: {e}"))
            return None
        item.sig = (c.n_pad, c.n_groups, c.mode, c.k_cols)
        return item.sig

    def _pop_batch(self, max_batch: int) -> Optional[List[_QItem]]:
        """Pop the head request plus every queued request with the same
        bucket signature, up to max_batch, preserving FIFO order within
        the batch. Returns None when the queue is empty."""
        with self._cv:
            while self._queue:
                head = self._queue.popleft()
                sig = self._sig_of(head)
                if sig is None:
                    continue
                batch = [head]
                if max_batch > 1 and self._queue:
                    rest: List[_QItem] = []
                    for it in self._queue:
                        s = self._sig_of(it)
                        if s is None:
                            continue
                        if len(batch) < max_batch and s == sig:
                            batch.append(it)
                        else:
                            rest.append(it)
                    self._queue = deque(rest)
                _obs.metrics.gauge_set("serve.queue_depth",
                                       len(self._queue))
                return batch
            return None

    def _process_batch(self, items: List[_QItem]) -> List[ServeResult]:
        """Execute one coalesced batch; completes each item's future and
        returns the results in item order."""
        with self._exec_lock:
            return self._process_batch_locked(items)

    def _process_batch_locked(self, items: List[_QItem]
                              ) -> List[ServeResult]:
        results: Dict[int, ServeResult] = {}
        live: List[Tuple[_QItem, _Prepared]] = []
        for it in items:
            try:
                live.append((it, self._prepare(it.req)))
            except Exception as e:
                r = ServeResult(request_id=it.req.request_id,
                                status="failed",
                                error=f"{type(e).__name__}: {e}")
                _obs.metrics.inc("serve.steps")
                _obs.metrics.inc("serve.requests_failed")
                self._finish(it, r)
                results[id(it)] = r
        # Requests holding a resumable checkpoint peel off to the serial
        # path: their partial state lives in the serial block layout.
        batch = [(it, p) for it, p in live if not self._has_resumable(p)]
        serial = [(it, p) for it, p in live if self._has_resumable(p)]
        if len(batch) == 1:
            serial.insert(0, batch[0])
            batch = []
        if batch:
            preps = [p for _, p in batch]
            S = len(preps)
            _obs.metrics.inc("serve.batches")
            _obs.metrics.inc("serve.batched_requests", S)
            _obs.metrics.observe("serve.batch_size", S)
            t0 = self.clock()
            t0_ns = time.perf_counter_ns()
            try:
                with _obs.span("serve.batch",
                               {"size": S, "bucket": str(preps[0].n_pad)}):
                    rs = self._execute_batch(preps, t0)
            except Exception as e:   # non-transient batch failure
                rs = [ServeResult(request_id=p.req.request_id,
                                  status="failed",
                                  error=f"{type(e).__name__}: {e}")
                      for p in preps]
            t1_ns = time.perf_counter_ns()
            wall = self.clock() - t0
            for (it, p), r in zip(batch, rs):
                r.wall_s = wall
                self._lat.append((self.clock(), wall, r.ok))
                _obs.emit_complete("serve.step", t0_ns, t1_ns,
                                   {"request": r.request_id, "batch": S})
                _obs.metrics.inc("serve.steps")
                if r.status in ("ok", "degraded"):
                    _obs.metrics.inc("serve.requests_completed")
                    if r.degraded:
                        _obs.metrics.inc("serve.requests_degraded")
                elif r.status == "failed":
                    _obs.metrics.inc("serve.requests_failed")
                self._finish(it, r)
                results[id(it)] = r
        for it, p in serial:
            r = self.process(it.req, prepared=p)
            self._finish(it, r)
            results[id(it)] = r
        return [results[id(it)] for it in items]

    def _has_resumable(self, p: _Prepared) -> bool:
        if self.ckpt_dir is None:
            return False
        d = pathlib.Path(self.ckpt_dir) / p.req.request_id
        return ckpt_mod.latest_step(d) is not None

    # -- per-request processing ------------------------------------------
    def process(self, req: StudyRequest, *,
                prepared: Optional[_Prepared] = None) -> ServeResult:
        """Serve one request now (the serial path). prepared: its
        admission state where a batch pass already made it (a request
        peeled off a batch is not prepared twice)."""
        with self._exec_lock:
            t0 = self.clock()
            with _obs.span("serve.step", {"request": req.request_id}):
                res = self._process_with_retries(req, t0, prepared)
            dur = self.clock() - t0
            res.wall_s = dur
            self._lat.append((self.clock(), dur, res.ok))
            _obs.metrics.inc("serve.steps")
            if res.status in ("ok", "degraded"):
                _obs.metrics.inc("serve.requests_completed")
                if res.degraded:
                    _obs.metrics.inc("serve.requests_degraded")
            elif res.status == "failed":
                _obs.metrics.inc("serve.requests_failed")
            return res

    def _process_with_retries(self, req: StudyRequest, t0: float,
                              prepared: Optional[_Prepared] = None
                              ) -> ServeResult:
        policy = self.retry
        last_err = ""
        for attempt in range(policy.max_retries + 1):
            try:
                res = self._execute(req, t0, prepared)
                res.retries = attempt
                return res
            except (SimulatedOOM, AllWorkersDead) as e:
                last_err = f"{type(e).__name__}: {e}"
                _obs.metrics.inc("serve.request_retries")
                if attempt >= policy.max_retries:
                    break
                backoff = min(policy.base_backoff_s * (2 ** attempt),
                              policy.max_backoff_s)
                backoff *= 1.0 + policy.jitter * float(self._rng.uniform())
                self._sleep(backoff)
            except Exception as e:          # non-transient: fail fast
                return ServeResult(request_id=req.request_id,
                                   status="failed",
                                   error=f"{type(e).__name__}: {e}",
                                   retries=attempt)
        return ServeResult(request_id=req.request_id, status="failed",
                           error=last_err, retries=policy.max_retries)

    def _sleep(self, dt: float) -> None:
        sleep = getattr(self.clock, "sleep", None)
        (sleep or time.sleep)(dt)

    # -- preparation ------------------------------------------------------
    def _classify(self, req: StudyRequest) -> _Class:
        grouping = _host(req.grouping, np.int32)
        n = int(grouping.shape[0])
        n_groups = (int(req.n_groups) if req.n_groups is not None
                    else int(grouping.max()) + 1)
        dense = req.covariates is not None or req.weights is not None
        design = None
        if dense:
            design = design_mod.build(
                grouping=grouping, covariates=req.covariates,
                strata=req.strata, weights=req.weights,
                n_groups=n_groups, force_dense=True, device="cpu")
            mode = _MODE_COLS
        elif req.strata is not None:
            design = design_mod.build(grouping=grouping, strata=req.strata,
                                      n_groups=n_groups, device="cpu")
            mode = (_MODE_STRATA if design.mode == design_mod.MODE_LABELS
                    else _MODE_COLS)
        else:
            mode = _MODE_LABELS
        k_cols = design.k_cols if mode == _MODE_COLS else 0
        n_pad = _next_bucket(n, self.bucket_sizes)
        return _Class(mode=mode, n=n, n_groups=n_groups, n_pad=n_pad,
                      k_cols=k_cols, design=design, grouping=grouping)

    def _stage1(self, req: StudyRequest) -> np.ndarray:
        """A features request's (n, n) distances, from the metric's
        distance kernel on the device (its plain version on the CPU),
        copied to the host."""
        _, _, dense = dist_registry.get(f"{req.metric}.cuda").bound()
        x = torch.as_tensor(req.x).to(self.device, torch.float32)
        return dense(x).cpu().numpy()

    def _prepare(self, req: StudyRequest) -> _Prepared:
        if (req.dm is None) == (req.x is None):
            raise ValueError("provide exactly one of dm= or x=")
        c = self._classify(req)
        n, n_groups, mode, n_pad = c.n, c.n_groups, c.mode, c.n_pad
        design = c.design
        if req.dm is not None:
            dm = _host(req.dm, np.float32)
        else:
            with _obs.span("serve.stage1", {"metric": req.metric}):
                dm = self._stage1(req)
        if dm.shape != (n, n):
            raise ValueError(f"dm is {dm.shape}, grouping has n={n}")

        mat2 = np.zeros((n_pad, n_pad), np.float32)
        mat2[:n, :n] = dm * dm
        g_pad = np.full((n_pad,), n_groups, np.int32)    # sentinel pad
        g_pad[:n] = c.grouping
        strata_pad = basis = inv_gs = None
        k_cols = 0
        if mode == _MODE_COLS:
            dpad = design_mod.pad_design(design, n_pad)
            basis = dpad.basis
            k_cols = dpad.k_cols
            strata_pad = (dpad.strata if dpad.strata is not None
                          else torch.zeros((n_pad,), dtype=torch.int32))
            design = dpad
        else:
            # host-side twin of permutations.inv_group_sizes (integer
            # counts, one IEEE division: the same f32 values)
            sizes = np.bincount(g_pad, minlength=n_groups)[:n_groups]
            sizes = sizes.astype(np.float32)
            inv_gs = np.where(
                sizes > 0, 1.0 / np.maximum(sizes, 1.0), 0.0) \
                .astype(np.float32)
            if mode == _MODE_STRATA:
                st = np.zeros((n_pad,), np.int32)
                st[:n] = _host(design.strata, np.int32)[:n]
                strata_pad = st
        s_t = float(mat2.sum()) / 2.0 / n    # pad rows are zero
        return _Prepared(
            req=req, mode=mode, n=n, n_pad=n_pad, n_groups=n_groups,
            k_cols=k_cols, n_total=int(req.n_perms) + 1,
            mat2=mat2, grouping=g_pad,
            strata=strata_pad, basis=basis, inv_gs=inv_gs, design=design,
            s_t=s_t, n_valid=n)

    # -- bucket / plan cache ---------------------------------------------
    def _bucket_for(self, p: _Prepared) -> _Bucket:
        key = (p.n_pad, p.n_groups, p.mode, p.k_cols)
        with self._lock:
            b = self._buckets.get(key)
            if b is not None:
                b.hits += 1
                _obs.metrics.inc("serve.bucket_hits")
                return b
            _obs.metrics.inc("serve.bucket_misses")
            cache_key = (f"serveplan|{planner.device_kind(self.backend)}"
                         f"|n{p.n_pad}|g{p.n_groups}|{p.mode}|k{p.k_cols}")
            impl = tuning = None
            entry = planner.measured_entry(cache_key)
            if entry:
                try:
                    spec = registry.get(entry["impl"])
                    impl = entry["impl"]
                    tuning = {k: v for k, v in (entry.get("tuning") or {})
                              .items() if k in spec.tuning}
                except KeyError:
                    impl = None
            if impl is None:
                cols = p.mode == _MODE_COLS
                pl = planner.plan(
                    p.n_pad, max(p.n_total, self.block),
                    backend=self.backend, chunk=self.block,
                    n_cols=p.k_cols if cols else None,
                    n_groups=None if cols else p.n_groups)
                impl, tuning = pl.impl, dict(pl.tuning)
                planner.record_entry(cache_key, {
                    "impl": impl, "tuning": tuning, "block": self.block,
                    "reason": pl.reason})
            if p.mode == _MODE_COLS:
                fn = registry.bound_cols(impl, **tuning)
            else:
                fn = registry.get(impl).bound(**tuning)
            b = _Bucket(key=key, impl=impl, tuning=tuning, fn=fn, hits=1)
            self._buckets[key] = b
            return b

    # -- execution --------------------------------------------------------
    def _spans(self, p: _Prepared) -> List[Tuple[int, int]]:
        block = min(self.block, p.n_total)
        return [(lo, min(lo + block, p.n_total))
                for lo in range(0, p.n_total, block)]

    def _explicit(self, req: StudyRequest, lo: int, rows: int, n_pad: int):
        """One block's explicit draws from the `draws` seam, on the
        device, or None (the server draws from the seed)."""
        if self.draws is None or rows == 0:
            return None
        return torch.from_numpy(np.array(self.draws(req, lo, rows, n_pad),
                                         np.int32)).to(self.device)

    def _compute_block_fn(self, p: _Prepared, b: _Bucket):
        # one host -> device copy per operand per REQUEST (closed over by
        # every block call): _Prepared holds host arrays, so admission
        # itself moves nothing to the device
        block = min(self.block, p.n_total)
        dev = self.device
        seed = int(p.req.seed)
        mat2 = torch.from_numpy(p.mat2).to(dev)
        if p.mode == _MODE_COLS:
            basis, strata = p.basis.to(dev), p.strata.to(dev)

            def compute(lo, hi):
                with _obs.span("serve.block", {"lo": lo}):
                    s = scheduler.sw_cols_block(
                        mat2, basis, strata, p.n, seed, lo, fn=b.fn,
                        block=block, index_perms=self._explicit(
                            p.req, lo, block, p.n_pad))
                    return s[: hi - lo].cpu().numpy()
        else:
            grouping = torch.from_numpy(p.grouping).to(dev)
            inv_gs = torch.from_numpy(p.inv_gs).to(dev)
            strata = (torch.from_numpy(p.strata).to(dev)
                      if p.strata is not None else None)

            def compute(lo, hi):
                with _obs.span("serve.block", {"lo": lo}):
                    s = scheduler.sw_block(
                        mat2, grouping, p.n, inv_gs, seed, lo, fn=b.fn,
                        block=block, strata=strata,
                        perms=self._explicit(p.req, lo, block, p.n_pad))
                    return s[: hi - lo].cpu().numpy()
        return compute

    def _ckpt_mgr(self, req: StudyRequest):
        if self.ckpt_dir is None:
            return None
        return ckpt_mod.CheckpointManager(
            pathlib.Path(self.ckpt_dir) / req.request_id, keep=2)

    def _executor(self, n_blocks: int) -> ElasticBlockExecutor:
        return ElasticBlockExecutor(
            n_blocks, workers=self.workers, clock=self.clock,
            heartbeat_timeout=self.heartbeat_timeout,
            straggler_factor=self.straggler_factor,
            injector=self.injector or FaultInjector(),
            max_transient_retries=self.max_transient_retries)

    def _execute(self, req: StudyRequest, t0: float,
                 prepared: Optional[_Prepared] = None) -> ServeResult:
        p = prepared if prepared is not None else self._prepare(req)
        b = self._bucket_for(p)
        spans = self._spans(p)
        n_blocks = len(spans)
        out = np.zeros((p.n_total, p.k_cols), np.float32) \
            if p.mode == _MODE_COLS else np.zeros((p.n_total,), np.float32)
        done = np.zeros((n_blocks,), bool)

        mgr = self._ckpt_mgr(req)
        if mgr is not None:
            done, out = self._maybe_resume(mgr, p, done, out, n_blocks)

        deadline = req.deadline_s

        def should_stop() -> bool:
            return (deadline is not None
                    and self.clock() - t0 >= deadline)

        commits_since_ckpt = [0]

        def on_commit(bid: int) -> None:
            # Mirror the commit into the caller-side mask: the executor
            # runs on its own copy of `done` (resume isolation), but it
            # writes `out` in place, so out[spans[bid]] is current here.
            done[bid] = True
            commits_since_ckpt[0] += 1
            if (mgr is not None
                    and commits_since_ckpt[0] % self.checkpoint_every == 0):
                self._checkpoint(mgr, p, out, done)

        out, done, rep = self._executor(n_blocks).run(
            self._compute_block_fn(p, b), spans, out=out, done=done,
            should_stop=should_stop, on_commit=on_commit)
        if rep.stale_beats_rejected:
            _obs.metrics.inc("serve.zombies_fenced",
                             rep.stale_beats_rejected)
        if not done.all():
            if mgr is not None:
                self._checkpoint(mgr, p, out, done)
            if not done[0]:
                return ServeResult(
                    request_id=req.request_id, status="failed",
                    error="deadline expired before the observed statistic",
                    bucket=b.describe(), report=rep)
            res = self._assemble(p, b, out, done, spans, rep,
                                 degraded=True)
            self._queue_resume(p, b, out, done, spans, res)
            return res
        if mgr is not None:
            shutil.rmtree(mgr.directory, ignore_errors=True)   # finished
        return self._assemble(p, b, out, done, spans, rep, degraded=False)

    # -- batched execution ------------------------------------------------
    def _stack_studies(self, lists):
        """Stack per-study operands along a leading study axis on the
        host and ship each stack to the device in ONE copy per operand
        per batch (numpy lists stack as numpy, CPU tensors as tensors)."""
        out = []
        for a in lists:
            if all(isinstance(x, torch.Tensor) for x in a):
                out.append(torch.stack(a).to(self.device))
            else:
                out.append(torch.from_numpy(np.stack(a)).to(self.device))
        return out

    def _execute_batch(self, preps: List[_Prepared],
                       t0: float) -> List[ServeResult]:
        """One coalesced same-bucket dispatch: every permutation block is
        one batched step over the stacked study axis, run through the
        elastic executor as a bag spanning the WHOLE batch. Each study
        runs on its serial step's launches, so each column equals the
        serial path bit for bit. Handles per-request deadlines (expired
        members degrade and leave; the rest keep going) and batch-level
        transient retries."""
        bkt = self._bucket_for(preps[0])
        for p in preps[1:]:
            self._bucket_for(p)     # same key: per-request hit accounting
        S = len(preps)
        mode = preps[0].mode
        max_total = max(p.n_total for p in preps)
        block = min(self.block, max_total)
        spans = [(lo, min(lo + block, max_total))
                 for lo in range(0, max_total, block)]
        n_blocks = len(spans)
        seeds = [int(p.req.seed) for p in preps]
        n_valid = [p.n for p in preps]
        n_totals = [p.n_total for p in preps]

        def explicit(lo):
            if self.draws is None:
                return None
            return [self._explicit(p.req, lo, scheduler._study_rows(
                block, lo, n_totals, s), p.n_pad)
                for s, p in enumerate(preps)]

        if mode == _MODE_COLS:
            mat2_b, basis_b, strata_b = self._stack_studies(
                [[p.mat2 for p in preps], [p.basis for p in preps],
                 [p.strata for p in preps]])
            k_cols = preps[0].k_cols
            out = np.zeros((max_total, S, k_cols), np.float32)

            def compute(lo, hi):
                with _obs.span("serve.block", {"lo": lo, "batch": S}):
                    s = scheduler.sw_cols_block_many(
                        mat2_b, basis_b, strata_b, n_valid, seeds, lo,
                        fn=bkt.fn, block=block, n_totals=n_totals,
                        index_perms=explicit(lo))
                    return s.cpu().numpy().transpose(1, 0, 2)[: hi - lo]
        else:
            lists = [[p.mat2 for p in preps], [p.grouping for p in preps],
                     [p.inv_gs for p in preps]]
            if mode == _MODE_STRATA:
                lists.append([p.strata for p in preps])
            ops = self._stack_studies(lists)
            mat2_b, grouping_b, invgs_b = ops[:3]
            strata_b = ops[3] if mode == _MODE_STRATA else None
            out = np.zeros((max_total, S), np.float32)

            def compute(lo, hi):
                with _obs.span("serve.block", {"lo": lo, "batch": S}):
                    s = scheduler.sw_block_many(
                        mat2_b, grouping_b, n_valid, invgs_b, seeds, lo,
                        fn=bkt.fn, block=block, strata=strata_b,
                        n_totals=n_totals, perms=explicit(lo))
                    return s.cpu().numpy().T[: hi - lo]

        done = np.zeros((n_blocks,), bool)
        need = [np.array([lo < p.n_total for (lo, _) in spans], bool)
                for p in preps]
        deadlines = [t0 + p.req.deadline_s
                     if p.req.deadline_s is not None else None
                     for p in preps]
        results: List[Optional[ServeResult]] = [None] * S
        active = set(range(S))
        retries = 0
        policy = self.retry
        while active:
            dls = [deadlines[i] for i in active if deadlines[i] is not None]
            earliest = min(dls) if dls else None

            def should_stop() -> bool:
                return earliest is not None and self.clock() >= earliest

            try:
                out, done, rep = self._executor(n_blocks).run(
                    compute, spans, out=out, done=done,
                    should_stop=should_stop)
            except (SimulatedOOM, AllWorkersDead) as e:
                retries += 1
                _obs.metrics.inc("serve.request_retries", len(active))
                if retries > policy.max_retries:
                    for i in sorted(active):
                        results[i] = ServeResult(
                            request_id=preps[i].req.request_id,
                            status="failed",
                            error=f"{type(e).__name__}: {e}",
                            retries=retries - 1, batched=True,
                            bucket=bkt.describe())
                    active.clear()
                    break
                backoff = min(policy.base_backoff_s * (2 ** (retries - 1)),
                              policy.max_backoff_s)
                backoff *= 1.0 + policy.jitter * float(self._rng.uniform())
                self._sleep(backoff)
                continue
            if rep.stale_beats_rejected:
                _obs.metrics.inc("serve.zombies_fenced",
                                 rep.stale_beats_rejected)
            for i in sorted(active):
                if bool(done[need[i]].all()):
                    results[i] = self._assemble_from_batch(
                        preps[i], bkt, out, done, spans, rep, i,
                        degraded=False, retries=retries)
                    active.discard(i)
            if not active:
                break
            # should_stop fired: degrade every member past its deadline.
            now = self.clock()
            for i in sorted(active):
                dl = deadlines[i]
                if dl is None or now < dl:
                    continue
                if not done[0]:
                    results[i] = ServeResult(
                        request_id=preps[i].req.request_id,
                        status="failed",
                        error=("deadline expired before the observed "
                               "statistic"),
                        bucket=bkt.describe(), report=rep, batched=True,
                        retries=retries)
                else:
                    results[i] = self._assemble_from_batch(
                        preps[i], bkt, out, done, spans, rep, i,
                        degraded=True, retries=retries)
                active.discard(i)
        return [r for r in results]

    def _assemble_from_batch(self, p: _Prepared, bkt: _Bucket, out, done,
                             spans, rep, i: int, *, degraded: bool,
                             retries: int) -> ServeResult:
        """Slice batch member i back into the serial layout and reuse the
        serial assembly (identical arithmetic => identical results)."""
        if p.mode == _MODE_COLS:
            out_i = np.ascontiguousarray(out[: p.n_total, i, :])
        else:
            out_i = np.ascontiguousarray(out[: p.n_total, i])
        spans_i: List[Tuple[int, int]] = []
        done_i: List[bool] = []
        for bid, (lo, hi) in enumerate(spans):
            if lo >= p.n_total:
                break
            spans_i.append((lo, min(hi, p.n_total)))
            done_i.append(bool(done[bid]))
        done_arr = np.asarray(done_i, bool)
        res = self._assemble(p, bkt, out_i, done_arr, spans_i, rep,
                             degraded=degraded)
        res.batched = True
        res.retries = retries
        if degraded:
            mgr = self._ckpt_mgr(p.req)
            if mgr is not None:
                self._checkpoint(mgr, p, out_i, done_arr)
            self._queue_resume(p, bkt, out_i, done_arr, spans_i, res)
        return res

    # -- opportunistic resume of degraded results -------------------------
    def _queue_resume(self, p: _Prepared, bkt: _Bucket, out, done, spans,
                      res: ServeResult) -> None:
        """Keep a degraded request's partial s_W and queue the
        permutation tail for completion in idle capacity; `res.final`
        receives the exact full-n_perms ServeResult."""
        if not self.opportunistic_resume or bool(np.asarray(done).all()):
            return
        fut: Future = Future()
        res.final = fut
        with self._cv:
            self._resume_q.append(_ResumeWork(
                p=p, bucket=bkt, out=out, done=np.asarray(done, bool),
                spans=list(spans), res=res, future=fut))
            self._cv.notify()
        _obs.metrics.inc("serve.resumes_queued")

    @property
    def resume_backlog(self) -> int:
        return len(self._resume_q)

    def resume_degraded(self, max_items: Optional[int] = None
                        ) -> List[ServeResult]:
        """Synchronously finish queued degraded tails (the cooperative
        twin of the background workers' idle-time resume). Returns the
        exact results, which are also pushed to each ServeResult.final."""
        out: List[ServeResult] = []
        while True:
            with self._cv:
                if not self._resume_q or (max_items is not None
                                          and len(out) >= max_items):
                    return out
                work = self._resume_q.popleft()
            out.append(self._run_resume(work))

    def _run_resume(self, w: _ResumeWork) -> ServeResult:
        with self._exec_lock:
            try:
                out, done, rep = self._executor(len(w.spans)).run(
                    self._compute_block_fn(w.p, w.bucket), w.spans,
                    out=w.out, done=w.done)
                res = self._assemble(w.p, w.bucket, out, done, w.spans,
                                     rep, degraded=False)
                res.retries = w.res.retries
                res.batched = w.res.batched
                _obs.metrics.inc("serve.resumes_completed")
                mgr = self._ckpt_mgr(w.p.req)
                if mgr is not None:
                    shutil.rmtree(mgr.directory, ignore_errors=True)
            except Exception as e:
                res = ServeResult(request_id=w.p.req.request_id,
                                  status="failed",
                                  error=f"{type(e).__name__}: {e}")
            if not w.future.done():
                w.future.set_result(res)
            return res

    # -- checkpoint/resume ------------------------------------------------
    def _checkpoint(self, mgr, p: _Prepared, out: np.ndarray,
                    done: np.ndarray) -> None:
        step = int(done.sum())
        mgr.save({"s_w": out, "done": done.astype(np.uint8)}, step=step,
                 extras={"request_id": p.req.request_id,
                         "n_perms": int(p.req.n_perms),
                         "block": self.block, "seed": int(p.req.seed),
                         "n_pad": int(p.n_pad), "mode": p.mode},
                 blocking=True)
        _obs.metrics.inc("serve.checkpoints")

    def _maybe_resume(self, mgr, p: _Prepared, done, out, n_blocks):
        step = mgr.latest_step()
        if step is None:
            return done, out
        req = p.req
        try:
            tree, manifest = mgr.restore(
                {"s_w": out, "done": done.astype(np.uint8)})
        except Exception:
            return done, out      # unreadable partial state: recompute
        ex = manifest.get("extras", {}) or {}
        # The kernels' summation order depends on n_pad: a checkpoint
        # written under another bucket may hold other bits. Ignore it and
        # recompute.
        if int(ex.get("n_pad", -1)) != int(p.n_pad):
            self._note_bucket_drift(req, ex.get("n_pad"), p.n_pad)
            return done, out
        if (ex.get("block") != self.block
                or ex.get("n_perms") != int(req.n_perms)
                or ex.get("seed") != int(req.seed)):
            return done, out      # different request config: ignore
        done_l = _host(tree["done"], bool)
        out_l = _host(tree["s_w"], out.dtype)
        if done_l.shape != (n_blocks,) or out_l.shape != out.shape:
            return done, out
        _obs.metrics.inc("serve.resumed_requests")
        _obs.metrics.inc("serve.resumed_blocks", float(done_l.sum()))
        return done_l.copy(), out_l.copy()

    def _note_bucket_drift(self, req: StudyRequest, old_pad,
                           new_pad: int) -> None:
        global _drift_warned
        _obs.metrics.inc("serve.ckpt_bucket_drift")
        if not _drift_warned:
            _drift_warned = True
            _log.warning(
                "ignoring checkpoint for %s: saved bucket n_pad=%s no "
                "longer matches current n_pad=%s (bucket_sizes drift); "
                "recomputing from scratch. Further drops are counted in "
                "serve.ckpt_bucket_drift without logging.",
                req.request_id, old_pad, new_pad)

    # -- result assembly --------------------------------------------------
    def _assemble(self, p: _Prepared, b: _Bucket, out, done, spans, rep,
                  *, degraded: bool) -> ServeResult:
        idx = np.concatenate([np.arange(lo, hi)
                              for bid, (lo, hi) in enumerate(spans)
                              if done[bid]]) if not done.all() \
            else np.arange(p.n_total)
        m = int(idx.size) - 1                   # completed permutations
        sub = out[idx]
        method_suffix = "+degraded" if degraded else ""
        plan_str = (f"{b.describe()} block={self.block} "
                    f"blocks={len(spans)} workers={self.workers}")
        if p.mode == _MODE_COLS:
            result = self._design_result(p, sub, m, method_suffix, plan_str)
            f_sub = result.f_perms.double()
        else:
            s_w = torch.from_numpy(np.asarray(sub, np.float64))
            f_sub = f_from_sw(s_w, p.s_t, p.n, p.n_groups)
            n_ge = int((f_sub[1:] >= f_sub[0]).sum())
            result = PermanovaResult(
                f_stat=f_sub[0],
                p_value=torch.tensor((n_ge + 1.0) / (m + 1.0),
                                     dtype=torch.float64),
                s_t=torch.tensor(p.s_t, dtype=torch.float64), s_w=s_w[0],
                f_perms=f_sub, n_objects=p.n, n_groups=p.n_groups,
                n_perms=m,
                method=f"permanova-serve[{b.impl}]{method_suffix}",
                plan=plan_str)
        ci = None
        if degraded:
            n_ge = int((f_sub[1:] >= f_sub[0]).sum())
            ci = mc_pvalue_ci(n_ge, m, int(p.req.n_perms))
        return ServeResult(
            request_id=p.req.request_id,
            status="degraded" if degraded else "ok",
            result=result, degraded=degraded, n_perms_done=m,
            p_ci=ci, bucket=b.describe(), report=rep)

    def _design_result(self, p: _Prepared, s_cols, m: int,
                       method_suffix: str, plan_str: str) -> PermanovaResult:
        design = p.design
        dof_resid = float(p.n - design.rank)
        ts = design_mod.term_stats(torch.from_numpy(np.asarray(s_cols)),
                                   design, dof_resid=dof_resid)
        terms = []
        f_terms = ts.f_terms.double()
        ss_terms = ts.ss_terms.double()
        s_t = float(ts.s_t)
        for i, t in enumerate(design.terms[1:]):
            f_p = f_terms[:, i]
            n_ge = int((f_p[1:] >= f_p[0]).sum())
            terms.append(TermResult(
                name=t.name, kind=t.kind, df=t.df, ss=ss_terms[0, i],
                f_stat=f_p[0],
                p_value=torch.tensor((n_ge + 1.0) / (m + 1.0),
                                     dtype=torch.float64),
                r2=ss_terms[0, i] / s_t, f_perms=f_p))
        last = terms[-1]
        return PermanovaResult(
            f_stat=last.f_stat, p_value=last.p_value,
            s_t=torch.tensor(s_t, dtype=torch.float64),
            s_w=ts.ss_resid[0].double(), f_perms=last.f_perms,
            n_objects=p.n,
            n_groups=(design.n_groups if design.n_groups else design.rank),
            n_perms=m,
            method=f"permanova-serve-design[{p.mode}]{method_suffix}",
            plan=plan_str, terms=tuple(terms))

    # -- telemetry --------------------------------------------------------
    def stats(self) -> dict:
        """Rolling serving stats from the internal latency ring: requests
        per second over the window, p50/p99 step latency, queue depth,
        bucket inventory. (serve_stats_from_events computes the same view
        from exported `serve.step` trace spans.) Well-defined on empty
        and single-sample windows: a zero-width window (e.g. under a
        virtual clock) reports the duration-sum rate, never inf."""
        if not self._lat:
            return {"requests": 0, "requests_per_s": 0.0,
                    "p50_s": 0.0, "p99_s": 0.0,
                    "queue_depth": len(self._queue),
                    "buckets": len(self._buckets)}
        lat = list(self._lat)
        ts = [t for t, _, _ in lat]
        durs = sorted(d for _, d, _ in lat)
        n = len(durs)
        span_s = max(ts) - min(ts) + durs[-1]
        if span_s <= 0.0:
            span_s = float(sum(durs))
        return {
            "requests": n,
            "requests_per_s": n / span_s if span_s > 0.0 else 0.0,
            "p50_s": durs[int(0.50 * (n - 1))],
            "p99_s": durs[int(0.99 * (n - 1))],
            "queue_depth": len(self._queue),
            "buckets": len(self._buckets),
        }


def serve_stats_from_events(events: Optional[list] = None) -> dict:
    """Requests/sec and p50/p99 step latency from `serve.step` trace
    spans: pass a trace_event list or default to the live obs buffer.
    Batched dispatches emit one `serve.step` event PER REQUEST over the
    shared batch window, so the requests/sec here reflects coalesced
    throughput. Empty and single-event windows are well-defined (0.0 rps
    for a zero-width window, never inf)."""
    evs = _obs.events() if events is None else events
    steps = [e for e in evs
             if e.get("name") == "serve.step" and e.get("ph") == "X"]
    if not steps:
        return {"requests": 0, "requests_per_s": 0.0, "p50_s": 0.0,
                "p99_s": 0.0}
    durs = sorted(e["dur"] / 1e6 for e in steps)
    t_lo = min(e["ts"] for e in steps) / 1e6
    t_hi = max((e["ts"] + e["dur"]) for e in steps) / 1e6
    n = len(durs)
    span_s = t_hi - t_lo
    if span_s <= 0.0:
        span_s = float(sum(durs))
    return {"requests": n,
            "requests_per_s": n / span_s if span_s > 0.0 else 0.0,
            "p50_s": durs[int(0.50 * (n - 1))],
            "p99_s": durs[int(0.99 * (n - 1))]}
