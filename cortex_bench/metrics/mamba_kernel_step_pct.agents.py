"""Mamba2 layer steps that went through the hand-written decode step, in %
of those the engine's decodes issued: the engine's own counters
``mamba_kernel_steps`` over ``mamba_steps`` (each Mamba2 layer of each
decode batch of every tick). None where the program keeps no such counters
or decodes no Mamba2 layer."""


def read(d):
    stats = d.engine.get("stats", {})
    n = stats.get("mamba_steps", 0)
    return 100.0 * stats["mamba_kernel_steps"] / n if n else None
