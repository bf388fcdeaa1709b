"""Deterministic fault injection for the elastic serving stack.

A copy of `repro/runtime/faultinject.py` (framework-free: numpy only).

Chaos testing a deterministic engine is only useful if the CHAOS itself is
deterministic: every fault here is declared up front (or drawn from a
seeded RNG) and applied against an injected clock, so a failing chaos test
replays bit-identically from its seed. The injector is consumed by
`runtime.elastic.ElasticBlockExecutor` (worker death, per-block delays,
dropped heartbeats, simulated device OOM) and by cache tests
(`corrupt_cache_file`); a "server restart" fault is driven by the tests
themselves through `serve.permanova`'s checkpoint/resume.

Faults supported:
  * kill_worker_after_blocks(w, k)  — worker w stops computing (and
    beating) after completing k blocks; the heartbeat monitor declares it
    dead and its blocks are re-dispatched.
  * delay_block(w, seconds, ...)    — advance the (virtual) clock by
    `seconds` around worker w's blocks: stragglers, deadline pressure.
  * drop_heartbeats(w, count)       — worker w computes but its next
    `count` beats are lost in transit; past the timeout it is declared
    dead even though it did the work (the zombie double-report scenario).
  * oom_at_block(w, block_id, times)— the first `times` attempts of that
    block on worker w raise SimulatedOOM (a transient failure: the retry/
    re-dispatch path must recover).
  * corrupt_cache_file(path)        — truncate a JSON cache mid-document
    (what a crash mid-write leaves behind).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional, Tuple

import numpy as np


class SimulatedOOM(RuntimeError):
    """Injected device OOM — a TRANSIENT failure: the block (or request)
    is expected to succeed when retried/re-dispatched."""


class VirtualClock:
    """Injectable monotonic clock. `advance`/`sleep` move time forward
    explicitly; nothing moves otherwise, so tests control every timeout
    and deadline exactly."""

    def __init__(self, start: float = 0.0):
        self.t = float(start)

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        if dt < 0:
            raise ValueError("clocks run forward")
        self.t += float(dt)

    def sleep(self, dt: float) -> None:   # alias: retry backoff "waits"
        self.advance(dt)


@dataclasses.dataclass
class _OOMSpec:
    remaining: int


class FaultInjector:
    """A declared, seeded fault schedule. All hooks are pure functions of
    (schedule state, arguments) — no wall clock, no global RNG."""

    def __init__(self, seed: int = 0):
        self.rng = np.random.default_rng(seed)
        self._kill_after: Dict[int, int] = {}
        self._delays: Dict[Optional[int], float] = {}
        self._drop_beats: Dict[int, int] = {}
        self._ooms: Dict[Tuple[int, int], _OOMSpec] = {}
        self.log: list[str] = []

    # -- declaration ------------------------------------------------------
    def kill_worker_after_blocks(self, worker: int, k: int) -> "FaultInjector":
        self._kill_after[worker] = int(k)
        return self

    def delay_block(self, worker: Optional[int],
                    seconds: float) -> "FaultInjector":
        """Per-block virtual delay for `worker` (None = every worker's
        baseline; a per-worker entry overrides it)."""
        self._delays[worker] = float(seconds)
        return self

    def drop_heartbeats(self, worker: int, count: int) -> "FaultInjector":
        self._drop_beats[worker] = int(count)
        return self

    def oom_at_block(self, worker: int, block_id: int,
                     times: int = 1) -> "FaultInjector":
        self._ooms[(worker, block_id)] = _OOMSpec(remaining=int(times))
        return self

    # -- hooks consumed by the executor ----------------------------------
    def worker_should_die(self, worker: int, blocks_done: int) -> bool:
        k = self._kill_after.get(worker)
        if k is not None and blocks_done >= k:
            self.log.append(f"kill worker={worker} after={k}")
            del self._kill_after[worker]
            return True
        return False

    def block_delay(self, worker: int, block_id: int) -> float:
        return self._delays.get(worker, self._delays.get(None, 0.0))

    def heartbeat_dropped(self, worker: int) -> bool:
        left = self._drop_beats.get(worker, 0)
        if left > 0:
            self._drop_beats[worker] = left - 1
            self.log.append(f"drop-beat worker={worker}")
            return True
        return False

    def maybe_oom(self, worker: int, block_id: int) -> None:
        spec = self._ooms.get((worker, block_id))
        if spec is not None and spec.remaining > 0:
            spec.remaining -= 1
            self.log.append(f"oom worker={worker} block={block_id}")
            raise SimulatedOOM(
                f"injected device OOM (worker {worker}, block {block_id})")

    # -- filesystem faults -------------------------------------------------
    @staticmethod
    def corrupt_cache_file(path: str, *, keep_bytes: Optional[int] = None
                           ) -> str:
        """Truncate a JSON document mid-write (keep roughly half by
        default) — the on-disk state a crash between write() and fsync
        leaves behind. Returns the path."""
        with open(path, "rb") as f:
            data = f.read()
        cut = len(data) // 2 if keep_bytes is None else int(keep_bytes)
        with open(path, "wb") as f:
            f.write(data[:max(1, cut)])
            f.flush()
            os.fsync(f.fileno())
        return path

    def jitter(self, frac: float = 0.5) -> float:
        """Deterministic (seeded) backoff jitter factor in [1, 1+frac)."""
        return 1.0 + float(self.rng.uniform(0.0, frac))
