"""Host milliseconds inside ``core.engine.one_tick``, summed over the
window (the profiled stretch left out), over the virtual ticks they ran."""
from cortex_bench import readers


def read(d):
    return readers.span_ms_per(d, "dispatch")
