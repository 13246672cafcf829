"""Share of its roofline the ``landmark_score`` kernel (density mode, the
spawn's call) reaches in the profiled stretch, as
``synapse_attention_roofline.agents``, in %."""
from cortex_bench import readers


def read(d):
    return readers.roofline_pct(d, "landmark_score")
