"""The decode step's share of the H100's bf16 peak over the profiled
stretch: the operations of the live lanes' decode tokens
(``yardstick.decode_flops``: 2 per weight multiplied, LM head included,
plus attention over the keys each token reads) over wall x 989e12, in %."""
from cortex_bench import readers


def read(d):
    return readers.decode_mfu_pct(d)
