"""Share of its roofline the ``synapse_attention`` kernel reaches in the
profiled stretch: the calls' least time (``yardstick.synapse_attention_cost``,
valid keys only, over the H100's HBM rate and bf16 peak) over the device
time of the kernel's launches, in %."""
from cortex_bench import readers


def read(d):
    return readers.roofline_pct(d, "synapse_attention")
