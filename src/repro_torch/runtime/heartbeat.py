"""Heartbeat-based failure detection with incarnation fencing.

A copy of `repro/runtime/heartbeat.py`; fleet snapshots merge through
`repro_torch.obs.metrics`.

Each worker (host/pod) reports liveness; the monitor declares a worker dead
after `timeout` without a beat and invokes the registered callbacks (elastic
re-mesh, work re-dispatch). On a real cluster the transport is the cluster
coordinator / etcd; here it is an in-process clock so the *policy* layer
(what to do on failure) is exercised end-to-end by tests.

Incarnation semantics (the fencing-token pattern):

  * every worker carries an integer `incarnation`; beats may carry the
    incarnation the worker believes it has;
  * when the scheduler re-dispatches a dead worker's blocks it calls
    `fence(worker_id)`, bumping the incarnation — from that point a beat
    carrying the OLD incarnation is a ZOMBIE (a worker that was declared
    dead, had its work re-assigned, and came back late) and is REJECTED
    (`beat` returns False), so a zombie can never double-report blocks;
  * a genuine re-join (a beat with no incarnation claim, or with the
    current one) flips the worker back alive, bumps the incarnation, and
    fires `on_recovery` exactly once per dead->alive transition.

Beats may also ship a per-host obs.metrics snapshot; `fleet_snapshot()`
merges the latest snapshot from every worker into one coordinator view
(counters sum, gauges max) — the live-fleet-counters follow-on from the
telemetry PR.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, Optional


@dataclasses.dataclass
class WorkerState:
    worker_id: int
    last_beat: float
    alive: bool = True
    incarnation: int = 0
    snapshot: Optional[dict] = None   # latest shipped metrics snapshot
    stale_beats: int = 0              # rejected zombie beats


class HeartbeatMonitor:
    def __init__(self, n_workers: int, *, timeout: float = 5.0,
                 clock: Optional[Callable[[], float]] = None):
        self.timeout = timeout
        self.clock = clock or time.monotonic
        now = self.clock()
        self.workers = {i: WorkerState(i, now) for i in range(n_workers)}
        self.on_failure: list[Callable[[int], None]] = []
        self.on_recovery: list[Callable[[int], None]] = []
        self._lock = threading.Lock()

    def beat(self, worker_id: int, incarnation: Optional[int] = None,
             snapshot: Optional[dict] = None) -> bool:
        """Record one liveness beat. Returns False for a STALE beat (the
        carried incarnation predates a `fence()`): the beat is discarded —
        last_beat is not refreshed, no recovery fires, and any work the
        zombie reports alongside it must be dropped by the caller."""
        recovered = False
        with self._lock:
            w = self.workers[worker_id]
            if incarnation is not None and incarnation < w.incarnation:
                w.stale_beats += 1
                return False
            w.last_beat = self.clock()
            if snapshot is not None:
                w.snapshot = snapshot
            if not w.alive:
                w.alive = True
                w.incarnation += 1
                recovered = True
        if recovered:
            # exactly once per dead->alive transition, OUTSIDE the lock
            # (callbacks may call back into the monitor)
            for cb in self.on_recovery:
                cb(worker_id)
        return True

    def fence(self, worker_id: int) -> int:
        """Invalidate the worker's current incarnation (call at re-dispatch
        of a dead worker's blocks). Returns the new incarnation; beats
        carrying any older one are rejected from now on."""
        with self._lock:
            w = self.workers[worker_id]
            w.incarnation += 1
            return w.incarnation

    def incarnation(self, worker_id: int) -> int:
        with self._lock:
            return self.workers[worker_id].incarnation

    def check(self) -> list[int]:
        """Returns newly-dead worker ids and fires failure callbacks."""
        now = self.clock()
        newly_dead = []
        with self._lock:
            for w in self.workers.values():
                if w.alive and now - w.last_beat > self.timeout:
                    w.alive = False
                    newly_dead.append(w.worker_id)
        for wid in newly_dead:
            for cb in self.on_failure:
                cb(wid)
        return newly_dead

    @property
    def alive_workers(self) -> list[int]:
        with self._lock:
            return [w.worker_id for w in self.workers.values() if w.alive]

    def fleet_snapshot(self) -> dict:
        """Coordinator view of the fleet: merge the latest metrics snapshot
        shipped by each worker's beats (counters sum, gauges max, histogram
        moments combine — obs.metrics.merge_snapshots semantics)."""
        from repro_torch.obs import metrics as _metrics
        with self._lock:
            snaps = [w.snapshot for w in self.workers.values()
                     if w.snapshot is not None]
        return _metrics.merge_snapshots(snaps)
