"""Elastic, fault-tolerant, straggler-mitigated permutation execution.

Twin of `repro/runtime/elastic.py`: the same single-threaded simulation of
the dispatch loop; obs goes to `repro_torch.obs`, and a block's values
stay numpy (the caller copies each block's s_W off the card).

The PERMANOVA permutation dimension is embarrassingly parallel and
deterministic (grouping p = f(key, p) by fold_in), so the scheduling layer
can treat the job as a bag of idempotent BLOCKS of permutation indices:

  * elastic scaling   — blocks are assigned to whichever workers are alive;
                        workers joining/leaving only changes the assignment
                        map, never the results;
  * fault tolerance   — a dead worker's unfinished blocks return to the
                        queue; any worker recomputes them bit-identically;
  * straggler
    mitigation        — blocks running past `straggler_factor` x the median
                        block time are speculatively re-dispatched; first
                        completion wins (results are identical by
                        construction, so no reconciliation is needed).

This is the cross-node layer above one device's computation: each
"worker" here stands for one device-level job.

A block's values may carry trailing axes: the batched serving path runs
one bag of permutation blocks across a whole SAME-BUCKET BATCH of
studies (each block computes an (hi-lo, S) slab in one batched
dispatch), and every fault-tolerance mechanism — re-dispatch,
speculation, zombie fencing — applies to the slab unchanged, because
the slab is still a pure function of (seeds, lo).

`ElasticBlockExecutor` is the serving-grade engine: a deterministic,
single-threaded simulation of the dispatch loop, wired to the
`runtime.heartbeat.HeartbeatMonitor` failure detector (liveness is the
monitor's verdict, not the executor's private knowledge) and to
`runtime.faultinject.FaultInjector` for seeded chaos. It supports partial
runs (deadline `should_stop`), resume from a done-mask (checkpoint/restart),
and commit-time zombie rejection through heartbeat incarnation fencing.
The original `ElasticPermutationRunner` is kept as the minimal
teaching/test harness.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Callable, Optional

import numpy as np

from repro_torch import obs as _obs
from repro_torch.runtime.faultinject import FaultInjector, SimulatedOOM
from repro_torch.runtime.heartbeat import HeartbeatMonitor


class AllWorkersDead(RuntimeError):
    """Every worker died and none can rejoin — the request-level retry
    policy decides whether to restart the fleet and re-run."""


@dataclasses.dataclass
class BlockResult:
    block_id: int
    lo: int
    hi: int
    values: np.ndarray
    worker_id: int
    elapsed: float
    speculative: bool = False


@dataclasses.dataclass
class ExecReport:
    """How the bag of blocks actually ran (chaos tests assert on this)."""
    n_blocks: int
    committed: int = 0            # blocks whose results were accepted
    recomputed: int = 0           # blocks re-dispatched after a failure
    speculative: int = 0          # straggler duplicate executions
    transient_failures: int = 0   # SimulatedOOM-style retried faults
    stale_beats_rejected: int = 0  # zombie reports fenced off
    workers_died: list = dataclasses.field(default_factory=list)
    stopped: bool = False         # should_stop() ended the run early
    history: list = dataclasses.field(default_factory=list)


class ElasticBlockExecutor:
    """Run `n_blocks` idempotent blocks over simulated workers with
    heartbeat failure detection, re-dispatch, speculation, and fencing.

    The loop is synchronous and fully deterministic: time only moves
    through the injected clock (fault delays, heartbeat timeouts, retry
    backoff), and all chaos comes from the seeded `FaultInjector` — a
    failing run replays exactly.

    Worker liveness is owned by the HeartbeatMonitor: the executor only
    dispatches to monitor-alive workers, requeues on the monitor's
    failure callback, fences the dead worker's incarnation, and rejects
    any late ("zombie") completion whose beat carries a stale
    incarnation — the block is recomputed bit-identically instead, and
    the zombie's value is checked against the committed one.
    """

    def __init__(self, n_blocks: int, *, workers: int,
                 clock: Optional[Callable[[], float]] = None,
                 heartbeat_timeout: float = 5.0,
                 straggler_factor: float = 3.0,
                 injector: Optional[FaultInjector] = None,
                 monitor: Optional[HeartbeatMonitor] = None,
                 max_transient_retries: int = 8,
                 backoff_s: float = 0.05):
        self.n_blocks = int(n_blocks)
        self.workers = list(range(int(workers)))
        self.clock = clock or time.monotonic
        self.injector = injector or FaultInjector()
        self.monitor = monitor or HeartbeatMonitor(
            len(self.workers), timeout=heartbeat_timeout, clock=self.clock)
        self.heartbeat_timeout = float(self.monitor.timeout)
        self.straggler_factor = float(straggler_factor)
        self.max_transient_retries = int(max_transient_retries)
        self.backoff_s = float(backoff_s)
        self._killed: set = set()
        self._report = ExecReport(n_blocks=self.n_blocks)
        self._believed_inc = {w: self.monitor.incarnation(w)
                              for w in self.workers}
        # blocks computed but whose heartbeat report was dropped:
        # bid -> (worker, believed incarnation at compute time, values)
        self._unreported: dict = {}
        self._requeue: deque = deque()
        self.monitor.on_failure.append(self._on_worker_failure)

    # -- failure path -----------------------------------------------------
    def _on_worker_failure(self, wid: int) -> None:
        """Monitor declared `wid` dead: fence its incarnation (so any
        late report is rejected) and return its unreported blocks to the
        queue for bit-identical recomputation."""
        self.monitor.fence(wid)
        self._report.workers_died.append(wid)
        self._report.history.append(f"dead worker={wid}")
        for bid in sorted(b for b, (w, _, _) in self._unreported.items()
                          if w == wid):
            self._requeue.append(bid)
            self._report.recomputed += 1
            self._report.history.append(f"requeue block={bid} from={wid}")

    def _dispatchable(self) -> list:
        alive = set(self.monitor.alive_workers)
        return [w for w in self.workers
                if w in alive and w not in self._killed]

    def _try_rejoin(self) -> bool:
        """A partitioned (not killed) worker that was declared dead comes
        back: an un-claimed beat re-registers it under a fresh
        incarnation (recovery fires exactly once in the monitor)."""
        alive = set(self.monitor.alive_workers)
        for w in self.workers:
            if w in self._killed or w in alive:
                continue
            if self.monitor.beat(w):        # no incarnation claim: rejoin
                self._believed_inc[w] = self.monitor.incarnation(w)
                self._report.history.append(f"rejoin worker={w}")
                return True
        return False

    def _idle_beats(self) -> None:
        """Monitor-alive, non-killed workers beat once per loop turn
        (drops consumed per attempt — the partition fault)."""
        for w in self._dispatchable():
            if self.injector.heartbeat_dropped(w):
                continue
            if self.monitor.beat(w, incarnation=self._believed_inc[w]):
                self._believed_inc[w] = self.monitor.incarnation(w)

    # -- main loop --------------------------------------------------------
    def run(self, compute_block: Callable[[int, int], np.ndarray],
            block_spans: list, *,
            out: Optional[np.ndarray] = None,
            done: Optional[np.ndarray] = None,
            should_stop: Optional[Callable[[], bool]] = None,
            on_commit: Optional[Callable[[int], None]] = None):
        """Execute all not-yet-done blocks.

        compute_block(lo, hi) -> (hi-lo, ...) values — worker identity is
        deliberately NOT an argument: global-index key folding makes the
        result a pure function of the index range, which is the whole
        fault-tolerance story. Values may carry trailing axes (a block
        bag SPANNING A BATCH of same-bucket studies returns (hi-lo, S)
        slabs — one batched dispatch per block); `out` must then be
        provided with matching trailing shape. Re-dispatch, speculation,
        and zombie fencing treat the whole slab as the idempotent unit.
        block_spans: [(lo, hi)] per block id; `out` spans max hi along
        axis 0.
        done: optional (n_blocks,) bool mask — resume support; completed
        blocks are never recomputed.
        Returns (out, done, ExecReport).
        """
        spans = list(block_spans)
        if len(spans) != self.n_blocks:
            raise ValueError(f"{len(spans)} spans for {self.n_blocks} blocks")
        n_slots = max(hi for _, hi in spans) if spans else 0
        out = np.zeros((n_slots,), np.float32) if out is None else out
        if out.shape[0] < n_slots:
            raise ValueError(
                f"out axis 0 is {out.shape[0]}, spans reach {n_slots}")
        done = (np.zeros((self.n_blocks,), bool) if done is None
                else np.asarray(done, bool).copy())
        self._report = rep = ExecReport(n_blocks=self.n_blocks)
        self._unreported.clear()
        self._requeue = deque()
        pending = deque(b for b in range(self.n_blocks) if not done[b])
        times: list = []
        retries: dict = {}
        done_by = {w: 0 for w in self.workers}   # per-worker commit count
        zombie_seen: set = set()                 # count each zombie once
        rr = 0

        def commit(bid: int, w: int, vals: np.ndarray, elapsed: float,
                   speculative: bool = False) -> None:
            lo, hi = spans[bid]
            vals = np.asarray(vals, np.float32)[: hi - lo]
            if bid in self._unreported:
                # a zombie computed this block too — its (rejected) value
                # must equal the committed one: idempotence by key folding
                _, _, zvals = self._unreported.pop(bid)
                if not np.array_equal(np.asarray(zvals, np.float32)
                                      [: hi - lo], vals):
                    raise AssertionError(
                        f"block {bid}: zombie result differs from "
                        "recomputation — idempotence violated")
            out[lo:hi] = vals
            done[bid] = True
            times.append(elapsed)
            done_by[w] = done_by.get(w, 0) + 1
            rep.committed += 1
            if speculative:
                rep.speculative += 1
            if on_commit is not None:
                on_commit(bid)

        while pending or self._requeue or self._unreported:
            if should_stop is not None and should_stop():
                rep.stopped = True
                break
            # failure detection runs every turn against the injected clock
            self.monitor.check()
            self._idle_beats()
            # resolve held-back reports: a fenced worker's late report is
            # a zombie (rejected, recomputed elsewhere); a still-alive
            # worker re-sends its result with its next successful beat
            alive_now = set(self.monitor.alive_workers)
            for bid in sorted(self._unreported):
                w, inc, vals = self._unreported[bid]
                if inc < self.monitor.incarnation(w):
                    accepted = self.monitor.beat(w, incarnation=inc)
                    assert not accepted, "stale beat must be rejected"
                    if (w, bid) not in zombie_seen:
                        zombie_seen.add((w, bid))
                        rep.stale_beats_rejected += 1
                        rep.history.append(f"zombie rejected worker={w} "
                                           f"block={bid}")
                    if done[bid]:      # already recomputed elsewhere:
                        lo, hi = spans[bid]   # verify and drop
                        if not np.array_equal(
                                np.asarray(vals, np.float32)[: hi - lo],
                                out[lo:hi]):
                            raise AssertionError(
                                f"block {bid}: zombie result differs")
                        del self._unreported[bid]
                elif w in alive_now and not done[bid]:
                    # transport retry: the worker is alive and its
                    # incarnation still valid — re-report the result
                    if self.injector.heartbeat_dropped(w):
                        continue
                    if self.monitor.beat(w, incarnation=inc):
                        self._believed_inc[w] = self.monitor.incarnation(w)
                        rep.history.append(f"late report block={bid} "
                                           f"worker={w}")
                        commit(bid, w, vals, elapsed=0.0)
            queue = self._requeue if self._requeue else pending
            if not queue:
                # only unreported blocks remain: let the partition play out
                self.clock_advance(self.heartbeat_timeout + 1e-3)
                continue
            workers = self._dispatchable()
            if not workers:
                if self._try_rejoin():
                    continue
                if all(w in self._killed for w in self.workers):
                    raise AllWorkersDead(
                        f"all {len(self.workers)} workers dead with "
                        f"{len(queue)} blocks pending")
                # silent-but-alive workers exist; age the clock so the
                # monitor resolves them one way or the other
                self.clock_advance(self.heartbeat_timeout + 1e-3)
                continue
            w = workers[rr % len(workers)]
            rr += 1
            if self.injector.worker_should_die(w, done_by[w]):
                # worker dies silently: it stops beating; the block was
                # never taken, so it simply stays queued. The monitor
                # notices after `timeout` without a beat.
                self._killed.add(w)
                rep.history.append(f"kill worker={w}")
                continue
            bid = queue.popleft()
            lo, hi = spans[bid]
            t0 = self.clock()
            try:
                self.injector.maybe_oom(w, bid)
                vals = compute_block(lo, hi)
            except SimulatedOOM:
                rep.transient_failures += 1
                n_try = retries[bid] = retries.get(bid, 0) + 1
                if n_try > self.max_transient_retries:
                    raise
                # jittered backoff, then back of the queue — round-robin
                # lands the retry on a different worker
                self.clock_advance(self.backoff_s * (2 ** (n_try - 1))
                                   * self.injector.jitter())
                (self._requeue if queue is self._requeue
                 else pending).append(bid)
                rep.history.append(f"oom-requeue block={bid} worker={w}")
                continue
            self.clock_advance(self.injector.block_delay(w, bid))
            elapsed = self.clock() - t0
            # straggler speculation: past factor x median, re-dispatch to
            # the currently-fastest other worker; first completion wins
            # (they are identical by construction — asserted)
            speculative = False
            others = [o for o in self._dispatchable() if o != w]
            median = float(np.median(times)) if times else 0.0
            if (others and median > 0.0
                    and elapsed > self.straggler_factor * median):
                w2 = min(others,
                         key=lambda o: self.injector.block_delay(o, bid))
                vals2 = compute_block(lo, hi)
                self.clock_advance(self.injector.block_delay(w2, bid))
                if not np.array_equal(np.asarray(vals, np.float32),
                                      np.asarray(vals2, np.float32)):
                    raise AssertionError(
                        f"block {bid}: speculative duplicate differs — "
                        "idempotence violated")
                rep.history.append(f"straggler block={bid} "
                                   f"worker={w} -> {w2}")
                w, vals, speculative = w2, vals2, True
            # report: the beat carries the result's fencing token
            if self.injector.heartbeat_dropped(w):
                self._unreported[bid] = (w, self._believed_inc[w], vals)
                rep.history.append(f"unreported block={bid} worker={w}")
                continue
            if not self.monitor.beat(w, incarnation=self._believed_inc[w]):
                rep.stale_beats_rejected += 1   # fenced mid-flight
                rep.history.append(f"stale commit rejected worker={w} "
                                   f"block={bid}")
                if not done[bid]:
                    self._requeue.append(bid)
                continue
            self._believed_inc[w] = self.monitor.incarnation(w)
            commit(bid, w, vals, elapsed, speculative)
        _obs.metrics.inc("elastic.blocks_committed", rep.committed)
        if rep.recomputed:
            _obs.metrics.inc("elastic.blocks_recomputed", rep.recomputed)
        rep.history.extend(self.injector.log)
        return out, done, rep

    def clock_advance(self, dt: float) -> None:
        adv = getattr(self.clock, "advance", None)
        if adv is not None:
            adv(dt)
        # real clocks advance themselves; nothing to do


class ElasticPermutationRunner:
    """Minimal reference harness (predates ElasticBlockExecutor; kept for
    its tests and as the simplest statement of the idempotent-block
    idea)."""

    def __init__(self, n_perms: int, *, block_size: int = 256,
                 straggler_factor: float = 3.0):
        self.n_perms = n_perms
        self.block_size = block_size
        self.straggler_factor = straggler_factor
        self.blocks = [(i, lo, min(lo + block_size, n_perms))
                       for i, lo in enumerate(range(0, n_perms, block_size))]
        self.results: dict[int, BlockResult] = {}
        self.history: list[str] = []

    def run(self, compute_block: Callable[[int, int, int], np.ndarray], *,
            workers: list[int], fail_at: Optional[dict] = None,
            slow_workers: Optional[dict] = None) -> np.ndarray:
        """Execute all blocks across `workers`.

        compute_block(worker_id, lo, hi) -> (hi-lo,) statistics.
        fail_at: {worker_id: n_blocks_before_death} for failure injection.
        slow_workers: {worker_id: slowdown_factor} for straggler injection.
        """
        fail_at = dict(fail_at or {})
        slow = dict(slow_workers or {})
        alive = list(workers)
        queue = list(self.blocks)
        done_count = {w: 0 for w in workers}
        times: list[float] = []

        while queue:
            if not alive:
                raise RuntimeError("all workers dead")
            next_queue = []
            for idx, (bid, lo, hi) in enumerate(queue):
                w = alive[idx % len(alive)]
                if w in fail_at and done_count[w] >= fail_at[w]:
                    # worker dies mid-assignment: block returns to queue
                    self.history.append(f"fail worker={w} block={bid}")
                    alive.remove(w)
                    del fail_at[w]
                    next_queue.append((bid, lo, hi))
                    continue
                t0 = time.perf_counter()
                vals = compute_block(w, lo, hi)
                elapsed = (time.perf_counter() - t0) * slow.get(w, 1.0)
                median = float(np.median(times)) if times else elapsed
                speculative = bool(
                    times and elapsed > self.straggler_factor * median)
                if speculative:
                    # re-dispatch to the fastest alive worker; identical
                    # result by determinism — first completion wins
                    w2 = min(alive, key=lambda x: slow.get(x, 1.0))
                    vals2 = compute_block(w2, lo, hi)
                    assert np.allclose(vals, vals2), \
                        "idempotence violated"
                    self.history.append(
                        f"straggler block={bid} worker={w} -> {w2}")
                    vals = vals2
                times.append(elapsed)
                done_count[w] = done_count.get(w, 0) + 1
                self.results[bid] = BlockResult(bid, lo, hi, vals, w,
                                                elapsed, speculative)
            queue = next_queue
        out = np.empty((self.n_perms,), dtype=np.float64)
        for r in self.results.values():
            out[r.lo:r.hi] = r.values
        return out
