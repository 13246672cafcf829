"""95th percentile (nearest rank) of the time from each request's due time
to its first generated token, over every request due in the window; a
request with no token by the window's end enters with the time it has
waited so far, so that a stall shows. Milliseconds."""
from cortex_bench.yardstick import percentile


def read(d):
    waits = [(r["first"] if r["first"] is not None and r["first"] <= d.window_s else d.window_s) - r["due"]
             for r in d.requests if r["due"] <= d.window_s]
    return percentile(waits, 95) * 1e3 if waits else None
