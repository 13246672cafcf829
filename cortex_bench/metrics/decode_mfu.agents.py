"""The decode step's share of the H100's bf16 peak over the profiled
stretch: the operations of the live lanes' decode tokens
(``yardstick.decode_flops`` of the count from the configuration file's
published keys: 2 per weight multiplied, LM head included, attention over
the keys each token reads in each attention layer, and the recurrent
state's updates) over wall x 989e12, in %."""
from cortex_bench import readers


def read(d):
    return readers.decode_mfu_pct(d)
