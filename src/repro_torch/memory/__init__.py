"""Tiered agent memory: hot (a device lane) / warm (host memory) / cold
(disk).

``SynapseStore`` holds hibernated agents' cache snapshots; ``AgentRegistry``
owns agent identity independent of lane slots, so engines and servers can
register far more agents than they have live lanes. The cold tier is
integrity-checked and crash-recoverable (see ``store`` and
``repro_torch.checkpoint.io``); ``faults.FaultInjector`` drives the
resilience tests.
"""
from .faults import FaultInjector, WorkerKill
from .registry import (
    ACTIVE,
    HIBERNATED,
    LOST,
    REGISTERED,
    AgentRecord,
    AgentRegistry,
)
from .store import (
    COLD,
    WARM,
    SnapshotLostError,
    SynapseStore,
    WakeTicket,
    WorkerDiedError,
)

__all__ = [
    "AgentRecord",
    "AgentRegistry",
    "FaultInjector",
    "SnapshotLostError",
    "SynapseStore",
    "WakeTicket",
    "WorkerDiedError",
    "WorkerKill",
    "ACTIVE",
    "HIBERNATED",
    "LOST",
    "REGISTERED",
    "WARM",
    "COLD",
]
