"""Agent identity, decoupled from lane slots (a copy of the JAX package's
``repro.memory.registry``, which holds no framework code).

Historically a `CortexEngine` agent *was* its lane: ``mains[i]`` held the
one AgentView that would ever live in lane ``i``. The registry breaks that
identification so an agent can exist without holding a lane (hibernated in
the warm/cold tiers of the `SynapseStore`) and can wake into *any* free
lane. Greedy decoding only depends on a lane's own cache/token/position
state, so the slot an agent wakes into is immaterial to its token stream.

Only identity and host-side bookkeeping live here (the AgentView, its
sampling params, router tails stay keyed by agent_id in the engine's
router). Device state for non-active agents lives in the SynapseStore.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Iterable, List, Optional

# status values
REGISTERED = "registered"  # known, but holds no context (never ran / overwritten)
ACTIVE = "active"          # bound to a live lane on device
HIBERNATED = "hibernated"  # context parked in the SynapseStore (warm/cold)
LOST = "lost"              # context permanently unrecoverable (corrupt/missing blob)


@dataclass
class AgentRecord:
    agent_id: str
    kind: str = "main"          # "main" | "side" | "request"
    status: str = REGISTERED
    lane: int = -1              # valid only while ACTIVE
    last_event: int = 0         # monotonic clock of last submit/wake/bind — LRU key
    bound_tick: int = 0         # engine tick at last bind — idle-ticks policy input
    saved: Any = None           # host bookkeeping while HIBERNATED (view, sampling, ...)


class AgentRegistry:
    """Owns agent_id -> AgentRecord; provides LRU queries for eviction."""

    def __init__(self) -> None:
        self._records: Dict[str, AgentRecord] = {}
        self._clock = 0

    # -- clock ------------------------------------------------------------
    def tick(self) -> int:
        """Advance and return the registry's monotonic event clock."""
        self._clock += 1
        return self._clock

    # -- crud -------------------------------------------------------------
    def register(self, agent_id: str, kind: str = "main") -> AgentRecord:
        rec = self._records.get(agent_id)
        if rec is None:
            rec = AgentRecord(agent_id=agent_id, kind=kind, last_event=self.tick())
            self._records[agent_id] = rec
        return rec

    def get(self, agent_id: str) -> AgentRecord:
        return self._records[agent_id]

    def __contains__(self, agent_id: str) -> bool:
        return agent_id in self._records

    def forget(self, agent_id: str) -> None:
        self._records.pop(agent_id, None)

    # -- state transitions ------------------------------------------------
    def bind(self, agent_id: str, lane: int) -> AgentRecord:
        rec = self._records[agent_id]
        rec.status, rec.lane, rec.saved = ACTIVE, lane, None
        rec.last_event = self.tick()
        return rec

    def hibernate(self, agent_id: str, saved: Any) -> AgentRecord:
        rec = self._records[agent_id]
        rec.status, rec.lane, rec.saved = HIBERNATED, -1, saved
        rec.last_event = self.tick()
        return rec

    def release(self, agent_id: str) -> None:
        """Agent lost its context (overwritten / merged / retired)."""
        rec = self._records.get(agent_id)
        if rec is not None:
            rec.status, rec.lane, rec.saved = REGISTERED, -1, None

    def mark_lost(self, agent_id: str) -> Optional[AgentRecord]:
        """Terminal degradation: the agent's parked context is permanently
        unrecoverable (quarantined blob, vanished file). Identity is kept —
        callers can observe what was lost and why — but the record holds no
        lane and no saved state; only a fresh ``submit`` revives the id."""
        rec = self._records.get(agent_id)
        if rec is not None:
            rec.status, rec.lane, rec.saved = LOST, -1, None
            rec.last_event = self.tick()
        return rec

    # -- queries ----------------------------------------------------------
    def with_status(self, status: str, kind: Optional[str] = None) -> List[AgentRecord]:
        return [
            r
            for r in self._records.values()
            if r.status == status and (kind is None or r.kind == kind)
        ]

    def agent_at(self, lane: int, kind: str) -> Optional[AgentRecord]:
        for r in self._records.values():
            if r.status == ACTIVE and r.kind == kind and r.lane == lane:
                return r
        return None

    def lru_active(
        self, kind: Optional[str] = None, *, exclude: Iterable[str] = ()
    ) -> Optional[AgentRecord]:
        """Least-recently-touched ACTIVE record — the eviction candidate."""
        skip = set(exclude)
        cands = [r for r in self.with_status(ACTIVE, kind) if r.agent_id not in skip]
        return min(cands, key=lambda r: r.last_event) if cands else None

    def counts(self) -> Dict[str, int]:
        by = {REGISTERED: 0, ACTIVE: 0, HIBERNATED: 0, LOST: 0}
        for r in self._records.values():
            by[r.status] += 1
        total = len(self._records)
        return {
            "registered": total,
            "active": by[ACTIVE],
            "hibernated": by[HIBERNATED],
            "lost": by[LOST],
            "dormant": total - by[ACTIVE],
        }
