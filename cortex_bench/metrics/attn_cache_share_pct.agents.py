"""The bytes of the lanes' attention caches over the run's peak device
memory, in %: the engine's own counter ``attn_cache_bytes`` (the rivers'
full caches and the sides' synapse caches of every attention layer or
shared-block invocation, counted from their shapes when the engine is
built) over ``torch.cuda.max_memory_allocated()``. None where the program
keeps no such counter or no peak was read."""


def read(d):
    n = d.engine.get("stats", {}).get("attn_cache_bytes")
    return 100.0 * n / d.peak_bytes if n is not None and d.peak_bytes else None
