"""95th percentile (nearest rank) of each request's time per output token:
(its budget-th token's time - its first token's time) / (budget - 1), over
every request due in the window; a request not at its budget by the
window's end enters with the window's end in place of that time (and its
due time in place of a first token it lacks). Milliseconds."""
from cortex_bench.yardstick import percentile


def read(d):
    out = []
    for r in d.requests:
        if r["due"] > d.window_s or r["budget"] < 2:
            continue
        first = r["first"] if r["first"] is not None and r["first"] <= d.window_s else r["due"]
        last = r["budget_at"] if r["budget_at"] is not None and r["budget_at"] <= d.window_s else d.window_s
        out.append(max(0.0, last - first) / (r["budget"] - 1))
    return percentile(out, 95) * 1e3 if out else None
