"""Readings of the program's own spans (``cortex_bench.program_trace``) and
the side-lane occupancy reader, on hand-worked records and synthetic
profiler events."""
import importlib.util
from pathlib import Path
from types import SimpleNamespace

import pytest
from torch.autograd import DeviceType

from cortex_bench import program_trace as pt
from cortex_bench.harness import RunData
from repro_torch.trace import Record

METRICS = Path(__file__).resolve().parents[1] / "metrics"


def reader(name):
    spec = importlib.util.spec_from_file_location(f"m_{name}", METRICS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def rec(name, a_us, b_us, thread=7, i=0):
    return Record(i, 0, name, int(a_us * 1000), int(b_us * 1000), thread, {})


def test_occupancy_reads_the_engine_counters():
    d = RunData(arch={}, window_s=1.0, setup_s=1.0, peak_bytes=0, tokens=[], requests=[],
                engine={"stats": {"side_lane_ticks": 960, "live_side_lane_ticks": 720}})
    assert reader("side_lane_occupancy_pct.agents")(d) == pytest.approx(75.0)
    # a program without the counters, or no tick that stepped sides: nothing
    for stats in ({"ticks": 5}, {"side_lane_ticks": 0, "live_side_lane_ticks": 0}):
        d.engine = {"stats": stats}
        assert reader("side_lane_occupancy_pct.agents")(d) is None


def test_host_spans_leave_the_stretch_out():
    recs = [rec("tick.side", 0, 40_000), rec("tick.side", 1e6, 1.06e6), rec("tick.side", 3e6, 3.02e6),
            rec("merge.sync", 0, 1_000), rec("merge.sync", 2e6, 2.002e6), rec("tick.river", 0, 5e5)]
    cut = (0.9, 2.5)  # seconds: the second tick.side and the second merge.sync lie in it
    assert pt.span_ms_per(recs, "tick.side", cut) == pytest.approx(30.0)
    assert pt.span_p50_ms(recs, "merge.sync", cut) == pytest.approx(1.0)
    assert pt.span_ms_per(recs, "engine.merge", cut) is None and pt.span_p50_ms([], "merge.sync", cut) is None


def test_segments_take_the_innermost_span():
    spans = [(0, 100, "frontend.step"), (10, 90, "engine.run"), (20, 50, "engine.tick"), (20, 30, "tick.river"),
             (35, 50, "tick.commit")]
    segs = pt.segments(spans)
    assert [(a, b, c[-1]) for a, b, c in segs] == [
        (0, 10, "frontend.step"), (10, 20, "engine.run"), (20, 30, "tick.river"), (30, 35, "engine.tick"),
        (35, 50, "tick.commit"), (50, 90, "engine.run"), (90, 100, "frontend.step")]
    assert segs[2][2] == ("frontend.step", "engine.run", "engine.tick", "tick.river")
    by, outside = pt.attribute([(-5, 12), (28, 40), (95, 120)], segs)
    assert outside == 5 + 20
    assert {c[-1]: v for c, v in by.items()} == {"frontend.step": 10 + 5, "engine.run": 2, "tick.river": 2,
                                                 "engine.tick": 5, "tick.commit": 5}


def test_idle_split_sums_to_the_idle_share_and_launches_go_to_the_innermost_span():
    # a stretch of 1000 µs: two ticks, each a river decode and a commit,
    # between them host work outside any tick; the device busy 400 µs
    spans = [(0, 900, "engine.run"),
             (100, 400, "engine.tick"), (100, 300, "tick.river"), (300, 400, "tick.commit"),
             (500, 800, "engine.tick"), (500, 700, "tick.river"), (700, 800, "tick.commit")]
    device = [(150, 250), (350, 400), (550, 650), (750, 800)]
    launches = [120, 310, 520, 710, 950, None]
    device += [(960, 1000), (410, 420)]
    out = pt.stretch_readings(device, launches, spans, 0.0, 1000.0, n_ticks=2)
    busy = 100 + 50 + 100 + 50 + 40 + 10
    assert out["idle_share_pct"] == pytest.approx(100.0 * (1000 - busy) / 1000)
    for key in ("idle_by_innermost_pct", "idle_by_top_pct"):
        assert sum(out[key].values()) == pytest.approx(out["idle_share_pct"])
    # idle inside the ticks: 100-150, 250-300, 300-350 and the same in the second
    assert out["idle_in_tick_pct"] == pytest.approx(100.0 * 2 * 150 / 1000)
    assert out["idle_by_innermost_pct"]["tick.river"] == pytest.approx(100.0 * 2 * 100 / 1000)
    assert out["idle_by_innermost_pct"][pt.OUTSIDE] == pytest.approx(100.0 * 60 / 1000)  # 900-960
    assert out["idle_by_top_pct"]["engine.run"] == pytest.approx(out["idle_share_pct"] - 6.0)
    # four launches inside ticks, one outside every span, one not found
    assert out["launches_per_tick"] == 2.0
    assert out["launches_per_tick_by_span"] == {"tick.river": 1.0, "tick.commit": 1.0, pt.OUTSIDE: 0.5,
                                                "launch not found": 0.5}


def test_nothing_to_read_without_ticks():
    out = pt.stretch_readings([(0, 10)], [0], [], 0.0, 100.0, n_ticks=0)
    assert out["idle_in_tick_pct"] is None and out["launches_per_tick"] is None
    assert out["idle_by_innermost_pct"] == {pt.OUTSIDE: 90.0}


def test_clock_offset_found_from_the_ticks():
    # record ticks every 120 ms on perf_counter, each its own length; the
    # profile saw three of them, 12.3456 s earlier on its own clock, each
    # 3 µs after the record and up to 5 µs longer
    rec_ns = [(int(5e9 + k * 120e6), int(5e9 + k * 120e6 + 80e6 + k * 3e5)) for k in range(40)]
    prof = [(a / 1e3 - 12.3456e6 + 3.0 + (0.5 if k % 2 else 0.0), b / 1e3 - 12.3456e6 + 8.0)
            for k, (a, b) in enumerate(rec_ns[17:20])]
    off, residual = pt.clock_offset_us(prof, rec_ns)
    assert off == pytest.approx(-12.3456e6 + 3.0, abs=1.0) and residual <= 0.5
    # ticks of one length: shifts by whole ticks match as well; the prior
    # picks among them
    same = [(a, a + int(80e6)) for a, _ in rec_ns]
    prof = [(a / 1e3 - 12.3456e6, b / 1e3 - 12.3456e6) for a, b in same[17:20]]
    assert pt.clock_offset_us(prof, same, prior=-12.3e6)[0] == pytest.approx(-12.3456e6)
    assert pt.clock_offset_us(prof, same, prior=-12.3456e6 + 360e3)[0] == pytest.approx(-12.3456e6 + 360e3)
    assert pt.clock_offset_us([(1.0, 2.0)], []) is None and pt.clock_offset_us([], rec_ns) is None


def ev(name, a, b, *, i=0, device=False, linked=0):
    return SimpleNamespace(name=name, id=i, time_range=SimpleNamespace(start=a, end=b),
                           device_type=DeviceType.CUDA if device else DeviceType.CPU, linked_correlation_id=linked)


def test_read_profile_puts_the_records_on_the_profile_clock():
    # perf_counter µs = profile µs + 1e6; the run span opened before the
    # profiler started (absent from the profile, present in the records)
    records = [rec("engine.run", 1e6 - 500, 1e6 + 1100), rec("engine.tick", 1e6 + 100, 1e6 + 400),
               rec("tick.side", 1e6 + 100, 1e6 + 300), rec("engine.tick", 1e6 + 500, 1e6 + 800),
               rec("frontend.step", 0, 1e6 + 2000, thread=9)]  # another thread: not the pump
    events = [ev("cortex.engine.tick", 100.5, 400.5, i=1), ev("cortex.engine.tick", 500.5, 800.5, i=2),
              ev("cortex.engine.tick", 100.5, 400.5, i=1, device=True),   # the range's device-side copy
              ev("cudaLaunchKernel", 150, 152, i=77), ev("kernel_a", 160, 250, i=77, device=True),
              ev("aten::add", 600, 610, i=5), ev("kernel_b", 620, 700, i=91, device=True, linked=5),
              ev("kernel_c", 910, 950, i=92, device=True)]
    work = lambda e: e.device_type == DeviceType.CUDA and e.name.startswith("kernel")
    out = pt.read_profile(events, records, 0.0, 900e-6, work)
    assert out["clock_residual_us"] == pytest.approx(0.0)
    assert out["launches_found"] == 2 and out["device_ops"] == 3
    assert out["launches_per_tick"] == 1.0
    assert out["launches_per_tick_by_span"] == {"tick.side": 0.5, "engine.tick": 0.5, "launch not found": 0.5}
    # the window starts at the first device work (160) and lasts 900 µs;
    # the run span covers it whole (to 1100.5 on the profile clock)
    assert pt.OUTSIDE not in out["idle_by_top_pct"]
    assert sum(out["idle_by_top_pct"].values()) == pytest.approx(out["idle_share_pct"])
    assert out["idle_share_pct"] == pytest.approx(100.0 * (900 - 90 - 80 - 40) / 900)
    # no tick in the profile, or no device work: nothing
    assert pt.read_profile(events[3:], records, 0.0, 1e-3, work) == {}
    assert pt.read_profile(events[:3], records, 0.0, 1e-3, work) == {}
