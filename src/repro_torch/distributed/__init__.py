"""Fault tolerance for the mining/serving stack (DESIGN.md §11).

Three layers, mirroring the paper's Hadoop reliance on task re-execution:

  * :mod:`repro_torch.distributed.checkpoint` — resumable streamed mining:
    ``MiningCheckpoint`` persists the level loop's complete state (levels,
    pass cursor, count accumulator, chunk cursor) next to the store
    manifest; ``mine_streamed(resume=True)`` is dict-identical to an
    uninterrupted mine.
  * :mod:`repro_torch.distributed.fault_tolerance` — retryable SON partitions:
    ``run_partitions`` executes phase-1 mappers through a bounded-retry,
    speculatively re-issuing work queue with explicit failure reporting.
  * :mod:`repro_torch.distributed.supervisor` — supervised serving:
    ``WorkerSupervisor`` restarts a dead gateway dispatch worker (failing
    only the in-flight batch's futures) behind a restart-storm guard;
    ``ReplicaSetSupervisor`` runs the same loop over a router's N gateway
    replicas, declaring a storming replica dead.
"""

from repro_torch.distributed.checkpoint import (
    CheckpointMismatch,
    MiningCheckpoint,
    MiningState,
    mining_fingerprint,
    store_fingerprint,
)
from repro_torch.distributed.fault_tolerance import (
    FaultConfig,
    FaultReport,
    InjectedFailure,
    PartitionFailure,
    retry_delay,
    run_partitions,
)
from repro_torch.distributed.supervisor import (
    ReplicaSetSupervisor,
    RestartGuard,
    WorkerSupervisor,
)
