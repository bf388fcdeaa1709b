"""Fault-tolerant runtime of the serving path (twin of `repro.runtime`).

  faultinject  seeded, clock-driven chaos: worker death, stragglers,
               dropped heartbeats, simulated device OOM, corrupt caches
  heartbeat    failure detection with incarnation fencing
  elastic      the bag of idempotent permutation blocks: re-dispatch,
               speculation, zombie fencing, partial runs and resume

The reference's `FaultTolerantTrainer` belongs to the LM scaffold and is
not ported here.
"""

from repro_torch.runtime.heartbeat import HeartbeatMonitor, WorkerState  # noqa: F401
from repro_torch.runtime.elastic import (  # noqa: F401
    AllWorkersDead,
    BlockResult,
    ElasticBlockExecutor,
    ElasticPermutationRunner,
    ExecReport,
)
from repro_torch.runtime.faultinject import (  # noqa: F401
    FaultInjector,
    SimulatedOOM,
    VirtualClock,
)
