"""The Prism (paper §3.2): singleton weight sharing.

One copy of the weights lives on the device; every agent holds a reference.
The Prism owns that copy and gives exact byte accounting, so the memory
claims of the paper's Eq. 1 are measured:

    M_total = Mem(W) + sum_i Mem(ctx_i)
"""
from __future__ import annotations

from repro_torch.device import resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import tree_leaves, tree_map


def tree_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


class Prism:
    """Singleton weight store. All agents read through `.params`. The
    weights live on ``device`` (the card unless ``device="cpu"``); leaves
    already there are kept, not copied."""

    def __init__(self, params, cfg: ModelConfig, *, device=None):
        dev = resolve_device(device)
        self._params = tree_map(lambda a: a.to(dev), params)
        self.cfg = cfg
        self._refs: set[str] = set()

    @property
    def params(self):
        return self._params

    @property
    def device(self):
        return self._params["final_norm"].device  # every model has one (not every model an embedding)

    def acquire(self, agent_id: str):
        """Register an agent; returns the shared params (no copy)."""
        self._refs.add(agent_id)
        return self._params

    def release(self, agent_id: str):
        self._refs.discard(agent_id)

    @property
    def n_agents(self) -> int:
        return len(self._refs)

    def weight_bytes(self) -> int:
        return tree_bytes(self._params)

    def memory_report(self, agent_cache_bytes: dict[str, int], *, store_report: dict | None = None,
                      agents: dict[str, int] | None = None) -> dict:
        """Eq. 1 accounting: weights once + per-agent context.

        ``store_report`` (a ``SynapseStore.report()``) splits the total over
        the memory hierarchy: **hot** is the device context of the agents in
        ``agent_cache_bytes``; **warm** and **cold** are the host and disk
        bytes of hibernated agents, which hold no device bytes. ``agents``
        (an ``AgentRegistry.counts()``) gives the registered and active
        counts."""
        ctx = sum(agent_cache_bytes.values())
        rep = {
            "weight_bytes": self.weight_bytes(),
            "n_agents": len(agent_cache_bytes),
            "context_bytes_total": ctx,
            "context_bytes_per_agent": ctx / max(1, len(agent_cache_bytes)),
            "total_bytes": self.weight_bytes() + ctx,
            # counterfactual: each agent carrying its own weight copy
            "standard_architecture_bytes": len(agent_cache_bytes) * self.weight_bytes() + ctx,
        }
        if store_report is not None:
            rep["tiers"] = {
                "hot_bytes": ctx,
                "warm_bytes": store_report.get("warm_bytes", 0),
                "cold_bytes": store_report.get("cold_bytes", 0),
                "cold_raw_bytes": store_report.get("cold_raw_bytes", 0),
                "n_warm": store_report.get("n_warm", 0),
                "n_cold": store_report.get("n_cold", 0),
            }
        if agents is not None:
            rep["agents"] = dict(agents)
        return rep
