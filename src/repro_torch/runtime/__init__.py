"""Fault-tolerant runtime of the serving and training paths (twin of
`repro.runtime`).

  faultinject  seeded, clock-driven chaos: worker death, stragglers,
               dropped heartbeats, simulated device OOM, corrupt caches
  heartbeat    failure detection with incarnation fencing
  elastic      the bag of idempotent permutation blocks: re-dispatch,
               speculation, zombie fencing, partial runs and resume
  trainer      the LM's fault-tolerant training loop (checkpoint/restart
               with a rewound data cursor)
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
from repro_torch.runtime.trainer import FaultTolerantTrainer  # noqa: F401
