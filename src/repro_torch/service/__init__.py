"""Transfer Service — multi-tenant async task manager over the chunked engine.

The port's copy of ``repro.service``: tasks are submitted by many tenants,
batched (service.batcher), scheduled under a global mover budget with
chunk-aware marginal-benefit allocation and tenant fairness
(service.scheduler), executed with per-chunk integrity + journaling
(service.service), and survivable across service crashes (service.store).
Where the reference digests on the host, the port digests on the card:
``TransferService(device="cuda")`` (the default; ``"cpu"`` runs the
kernels' plain versions) takes every digest there — movers, read-back and
deferred verifies, dedup probes, the content index and the scrubber. Store shards, event log, chunk journals, the content index and
checkpoint MANIFESTs are byte-compatible with the reference's, so a service
root written by one package is replayed by the other.

    from repro_torch.service import TransferService, ServiceConfig
    svc = TransferService("/srv/transferd", ServiceConfig(pipeline="pipelined"))
    [tid] = svc.submit([(src, dst)], tenant="alice")
    svc.wait(tid)

``testbed`` runs the same scheduling stack in virtual time against the
calibrated simulator (no device, no files).
"""
from repro_torch.service.batcher import BatchConfig, Batcher
from repro_torch.service.ckpt_bridge import CheckpointSubmission, submit_checkpoint
from repro_torch.service.events import EventBus, TaskEvent
from repro_torch.service.scheduler import (
    ActivationIndex,
    AllocationEngine,
    TenantQuota,
    select_activations,
)
from repro_torch.service.service import ServiceConfig, TransferService
from repro_torch.service.store import TaskRecord, TaskStore
from repro_torch.service.task import (
    ACTIVE,
    CANCELED,
    FAILED,
    PAUSED,
    PENDING,
    SUCCEEDED,
    TERMINAL,
    FaultReport,
    ItemReport,
    TaskSpec,
    TaskStatus,
    TransferItem,
)
from repro_torch.service.testbed import (
    FaultLog,
    LoadReport,
    Submission,
    SimTask,
    mixed_workload,
    run_load,
)

__all__ = [
    "ACTIVE", "CANCELED", "FAILED", "PAUSED", "PENDING", "SUCCEEDED", "TERMINAL",
    "ActivationIndex", "AllocationEngine", "BatchConfig", "Batcher",
    "CheckpointSubmission",
    "EventBus", "FaultLog", "FaultReport", "ItemReport", "LoadReport",
    "ServiceConfig", "SimTask", "Submission", "TaskEvent", "TaskRecord",
    "TaskSpec", "TaskStatus", "TaskStore", "TenantQuota", "TransferItem",
    "TransferService", "mixed_workload", "run_load", "select_activations",
    "submit_checkpoint",
]
