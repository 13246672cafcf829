"""Median milliseconds of a spawn (``core.engine.spawn_caches``,
synchronised at its end), the profiled stretch left out."""
from cortex_bench import readers


def read(d):
    return readers.span_p50_ms(d, "spawn")
