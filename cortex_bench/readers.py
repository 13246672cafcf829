"""Arithmetic the metric readers share (``metrics/<metric>.py`` each name
one of these with the data it reads)."""
from __future__ import annotations

from cortex_bench.yardstick import BF16_FLOP_PER_S, percentile


def span_ms_per(d, name: str):
    """Host milliseconds in a span, summed, over the number of spans."""
    s = d.spans.get(name, [])
    return sum(s) * 1e3 / len(s) if s else None


def span_p50_ms(d, name: str):
    s = d.spans.get(name, [])
    return percentile(s, 50) * 1e3 if s else None


def roofline_pct(d, kernel: str):
    t = d.stretch.get(f"{kernel}_device_s")
    return 100.0 * d.stretch[f"{kernel}_bound_s"] / t if t else None


def idle_pct(d):
    w = d.stretch.get("window_s")
    return 100.0 * (1.0 - d.stretch["busy_s"] / w) if w else None


def decode_mfu_pct(d):
    w = d.stretch.get("window_s")
    if not w or not d.stretch.get("decode_tokens"):
        return None
    return 100.0 * d.stretch["decode_flops"] / (w * BF16_FLOP_PER_S)


def queue_wait_p50_ms(d):
    """Median of admission - due time over the requests admitted in the window."""
    w = [r["admit"] - r["due"] for r in d.requests if r["admit"] is not None and r["admit"] <= d.window_s]
    return percentile(w, 50) * 1e3 if w else None
