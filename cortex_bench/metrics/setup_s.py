"""Process start to the first timed instant, in seconds."""


def read(d):
    return d.setup_s
