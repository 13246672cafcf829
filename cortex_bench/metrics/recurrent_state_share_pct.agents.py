"""The bytes of the lanes' recurrent states over the run's peak device
memory, in %: the engine's own counter ``recurrent_state_bytes`` (every
river and side lane's Mamba2 conv tails and SSM states, counted from their
shapes when the engine is built) over ``torch.cuda.max_memory_allocated()``.
None where the program keeps no such counter or no peak was read."""


def read(d):
    n = d.engine.get("stats", {}).get("recurrent_state_bytes")
    return 100.0 * n / d.peak_bytes if n is not None and d.peak_bytes else None
