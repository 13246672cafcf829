"""Share of the profiled stretch's wall time in which no operation ran on
the device: 1 - (union of the device events' intervals / wall), in %."""
from cortex_bench import readers


def read(d):
    return readers.idle_pct(d)
