"""Ticks issued from CUDA graphs over the window's ticks, in %: the
engine's own counters ``graph_ticks`` over ``graph_ticks + eager_ticks``
(a key's first tick of an engine runs eagerly, its second is captured).
None where the program keeps no such counters."""


def read(d):
    stats = d.engine.get("stats", {})
    n = stats.get("graph_ticks", 0) + stats.get("eager_ticks", 0)
    return 100.0 * stats["graph_ticks"] / n if n else None
