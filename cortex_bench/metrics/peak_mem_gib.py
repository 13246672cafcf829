"""``torch.cuda.max_memory_allocated()`` over the whole run, set-up
included, in GiB."""


def read(d):
    return d.peak_bytes / 2**30 if d.peak_bytes else None
