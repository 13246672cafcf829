"""Median host milliseconds of a merge (``CortexEngine._merge_side``:
``injection.merge_thought`` up to the engine's own sync after it), the
profiled stretch left out."""
from cortex_bench import readers


def read(d):
    return readers.span_p50_ms(d, "merge")
