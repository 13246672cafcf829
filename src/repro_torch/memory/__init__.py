"""Agent identity for the port: ``AgentRegistry`` gives agents an identity
independent of lane slots. The memory tiers (the synapse store, its cold
tier and hibernate/wake) are not ported yet, so the registry is all this
package exports."""
from .registry import (
    ACTIVE,
    HIBERNATED,
    LOST,
    REGISTERED,
    AgentRecord,
    AgentRegistry,
)

__all__ = [
    "AgentRecord",
    "AgentRegistry",
    "ACTIVE",
    "HIBERNATED",
    "LOST",
    "REGISTERED",
]
