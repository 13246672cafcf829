"""Readings of the program's own spans (``repro_torch.trace``), beside the
benchmark's probes: where a traced stretch's device idle time and kernel
launches lie among the spans open on the host, and host times of single
spans over the window.

The tracer times its spans on ``time.perf_counter_ns`` and opens a
``cortex.<name>`` profiler range around each. A range that opens before
the profiler starts (the front end's step and the engine's run around the
stretch's first admission) is missing from the profile, so the spans are
taken from the tracer's records and put on the profiler's clock by the
offset at which its records of ``engine.tick`` meet the profile's
``cortex.engine.tick`` ranges (:func:`clock_offset_us`).

Pure arithmetic on plain tuples, but :func:`read_profile`, which takes the
profiler's events.
"""
from __future__ import annotations

import bisect
from collections import Counter

from cortex_bench import yardstick

PREFIX = "cortex."
TICK = "engine.tick"
OUTSIDE = "outside every program span"
BREAKDOWN = ("tick.river", "tick.side", "decode.attn", "tick.sample", "tick.commit")
MATCH_US = 200.0  # a record and its profiler range start, and last, this close once the offset is right


# -- host spans over the window ---------------------------------------------
def outside_cut(records, name: str, cut) -> list[float]:
    """Seconds of each span ``name`` that lies wholly outside ``cut``
    (perf_counter seconds, the traced stretch with its read-out)."""
    a, b = cut
    return [(r.end_ns - r.start_ns) * 1e-9 for r in records
            if r.name == name and (r.end_ns * 1e-9 <= a or r.start_ns * 1e-9 >= b)]


def span_ms_per(records, name: str, cut):
    """Host milliseconds in ``name`` over the number of such spans."""
    s = outside_cut(records, name, cut)
    return sum(s) * 1e3 / len(s) if s else None


def span_p50_ms(records, name: str, cut):
    s = outside_cut(records, name, cut)
    return yardstick.percentile(s, 50) * 1e3 if s else None


# -- the spans on the profiler's clock ----------------------------------------
def pump_thread(records):
    """The thread that ran the ticks (the front end's pump)."""
    c = Counter(r.thread for r in records if r.name == TICK)
    return c.most_common(1)[0][0] if c else None


def clock_offset_us(profile_ticks, record_ticks, prior: float = 0.0):
    """(offset, largest residual) in µs such that a record's start (ns / 1e3)
    plus the offset is its profiler range's start; None where the ranges
    meet no records. ``profile_ticks``: (start, end) of the profile's
    ``cortex.engine.tick`` ranges (µs); ``record_ticks``: (start, end) of
    the records' ticks (ns). A range meets a record whose start and length
    lie within ``MATCH_US`` of its own: ticks come at a steady pace, and
    their lengths tell apart the shifts by whole ticks. Of offsets that
    match as many ranges, the nearest ``prior``."""
    prof = sorted(profile_ticks)
    rec = sorted((a / 1e3, b / 1e3) for a, b in record_ticks)
    starts = [a for a, _ in rec]
    if not prof or not rec:
        return None

    def pairs(off):
        out = []
        for a, b in prof:
            j = bisect.bisect_left(starts, a - off - MATCH_US)
            while j < len(rec) and rec[j][0] + off <= a + MATCH_US:
                ra, rb = rec[j]
                if abs((rb - ra) - (b - a)) <= MATCH_US:
                    out.append(a - ra)
                    break
                j += 1
        return out
    best = max((pairs(prof[0][0] - ra) for ra, _ in rec),
               key=lambda d: (len(d), -abs(yardstick.percentile(d, 50) - prior) if d else 0.0))
    if len(best) < max(1, len(prof) // 2):
        return None
    off = yardstick.percentile(best, 50)
    return off, max(abs(d - off) for d in pairs(off))


def segments(spans):
    """The time covered by nested spans of one thread, cut where a span
    opens or closes: [(start, end, chain)] in order, ``chain`` the names
    open there, outermost first."""
    out, stack, t = [], [], None

    def close_to(limit):
        nonlocal t
        while stack and stack[-1][0] <= limit:
            end = stack[-1][0]
            if end > t:
                out.append((t, end, tuple(n for _, n in stack)))
            t = end
            stack.pop()
    for s, e, name in sorted(spans, key=lambda x: (x[0], -x[1])):
        close_to(s)
        if stack and s > t:
            out.append((t, s, tuple(n for _, n in stack)))
        t = s
        stack.append((min(e, stack[-1][0]) if stack else e, name))
    close_to(float("inf"))
    return out


def attribute(intervals, segs):
    """Length of each of ``intervals`` (sorted, disjoint) under each chain
    of ``segs``, and the length under none: (Counter of chains, outside)."""
    by, outside, j = Counter(), 0.0, 0
    for a, b in intervals:
        while j < len(segs) and segs[j][1] <= a:
            j += 1
        t, k = a, j
        while k < len(segs) and segs[k][0] < b:
            s, e, chain = segs[k]
            if s > t:
                outside += s - t
            lo, hi = max(s, t), min(e, b)
            if hi > lo:
                by[chain] += hi - lo
            t = max(t, hi)
            k += 1
        if b > t:
            outside += b - t
    return by, outside


def chain_at(segs, starts, t):
    """The chain open at ``t`` (``starts``: the segments' starts), or ()."""
    k = bisect.bisect_right(starts, t) - 1
    return segs[k][2] if k >= 0 and segs[k][0] <= t < segs[k][1] else ()


def split(by: Counter, outside: float, key) -> dict:
    out = Counter({OUTSIDE: outside} if outside else {})
    for chain, v in by.items():
        out[key(chain)] += v
    return dict(out)


def stretch_readings(device, launches, spans, start: float, stop: float, n_ticks: int) -> dict:
    """The traced stretch's readings. ``device``: (start, end) of each
    device operation; ``launches``: the host time each was launched at, or
    None where the launch was not found; ``spans``: (start, end, name) of
    the pump thread's spans; all on one clock (µs). ``[start, stop]``: the
    stretch as the benchmark's idle share reads it; ``n_ticks``: the
    ``engine.tick`` spans in it."""
    segs = segments(spans)
    wall = stop - start
    gaps = sorted(yardstick.idle_gaps(device, start, stop))
    by, outside = attribute(gaps, segs)
    idle = sum(by.values()) + outside
    in_tick = sum(v for chain, v in by.items() if TICK in chain)
    starts = [s for s, _, _ in segs]
    chains = [chain_at(segs, starts, t) if t is not None else None for t in launches]
    tick_launches = sum(1 for c in chains if c and TICK in c)
    per_span = Counter((c[-1] if c else OUTSIDE) if c is not None else "launch not found" for c in chains)
    return {
        "idle_share_pct": 100.0 * idle / wall if wall else None,
        "idle_in_tick_pct": 100.0 * in_tick / wall if wall and n_ticks else None,
        "idle_by_innermost_pct": {k: 100.0 * v / wall for k, v in split(by, outside, lambda c: c[-1]).items()},
        "idle_by_top_pct": {k: 100.0 * v / wall for k, v in split(by, outside, lambda c: c[0]).items()},
        "launches_per_tick": tick_launches / n_ticks if n_ticks else None,
        "launches_per_tick_by_span": {k: v / n_ticks for k, v in per_span.items()} if n_ticks else {},
        "ticks": n_ticks,
    }


def read_profile(events, records, t_a: float, t_b: float, is_device_work) -> dict:
    """:func:`stretch_readings` from the profiler's events of a stretch
    that ran from ``t_a`` to ``t_b`` (perf_counter seconds) and the
    tracer's records, over the window the benchmark's idle share reads:
    from the first device operation, the stretch's wall long. Empty where
    the stretch holds no tick or no device work."""
    from torch.autograd import DeviceType

    dev = [e for e in events if is_device_work(e)]
    host = [e for e in events if e.device_type == DeviceType.CPU]
    prof_ticks = [(e.time_range.start, e.time_range.end) for e in host if e.name == PREFIX + TICK]
    pump = pump_thread(records)
    if not dev or not prof_ticks or pump is None:
        return {}
    mine = [r for r in records if r.thread == pump]
    # the profile's clock starts about when the stretch does
    fit = clock_offset_us(prof_ticks, [(r.start_ns, r.end_ns) for r in mine if r.name == TICK], -t_a * 1e6)
    if fit is None:
        return {}
    off, residual = fit
    spans = [(r.start_ns / 1e3 + off, r.end_ns / 1e3 + off, r.name) for r in mine]
    # a device operation's launch: the runtime or driver call that shares
    # its correlation id (cudaLaunchKernel, cuLaunchKernelEx,
    # cudaMemcpyAsync, ...); failing that, the start of the PyTorch op it
    # is linked to
    runtime = {e.id: e.time_range.start for e in host if e.name.startswith("cu")}
    ops = {e.id: e.time_range.start for e in host if not e.name.startswith("cu")}
    launches = [runtime.get(e.id, ops.get(getattr(e, "linked_correlation_id", 0) or -1)) for e in dev]
    w0 = min(e.time_range.start for e in dev)
    out = stretch_readings([(e.time_range.start, e.time_range.end) for e in dev], launches, spans,
                           w0, w0 + (t_b - t_a) * 1e6, len(prof_ticks))
    out["clock_residual_us"] = residual
    out["launches_found"] = sum(t is not None for t in launches)
    out["device_ops"] = len(dev)
    return out
