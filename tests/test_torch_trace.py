"""The port's tracer (``repro_torch.trace``) and the engine's spawn and
side-lane counters, on a small council served by the front end over the
reduced Qwen2.5-0.5B on the CPU.

One council (two requests with more ``[TASK]`` tags than side lanes) runs
three times from the same weights, each under ``torch.profiler``: with
tracing off, with it on, and off again after it was on. Off records
nothing and opens no profiler range; on gives the span tree of the engine
and the front end, each span a ``cortex.<name>`` range in the profile;
greedy streams are bitwise the same either way.
"""
import collections
import contextlib
import json

import pytest
import torch
from test_torch_families import _one_torch_thread  # noqa: F401 (autouse: one intra-op thread)

from repro_torch import trace
from repro_torch.configs import get_config
from repro_torch.core.engine import CortexEngine
from repro_torch.core.prism import Prism
from repro_torch.data.tokenizer import ByteTokenizer
from repro_torch.models import model as tmodel
from repro_torch.serving.frontend import ServingFrontend
from repro_torch.serving.sampler import SamplingParams

PROMPTS = ["plan [TASK: check the math] then [TASK: cite a source] and [TASK: weigh it] ok",
           "sum up [TASK: count the lanes] now"]
MAX_SIDE = 3  # below the four tags: one spawn is dropped


@pytest.fixture(scope="module")
def setup():
    cfg = get_config("qwen2.5-0.5b", reduced=True)
    return cfg, tmodel.init_params(cfg, seed=0, device="cpu")


def council(setup, max_side=MAX_SIDE, profiled=True):
    """Serve PROMPTS to the end, under ``torch.profiler`` where
    ``profiled``. Returns (engine, front end, river task triggers, profiler
    ranges opened, ``cortex.*`` ranges in the profile)."""
    cfg, params = setup
    eng = CortexEngine(Prism(params, cfg, device="cpu"), ByteTokenizer(cfg.vocab_size), n_main=2,
                       max_side=max_side, main_capacity=256, side_max_steps=6, inject_tokens=8, theta=-1.0,
                       sync_every=4, max_window=16, sampling=SamplingParams(greedy=True), device="cpu")
    triggers, ranges = [0], []
    feed = eng.router.feed

    def counted(agent_id, chunk):
        out = feed(agent_id, chunk)
        if any(m.agent_id == agent_id for m in eng.mains):
            triggers[0] += sum(t.kind == "task" for t in out)
        return out
    eng.router.feed = counted
    real = trace.record_function

    def opened(name):
        ranges.append(name)
        return real(name)
    trace.record_function = opened
    try:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) if profiled \
                else contextlib.nullcontext() as prof:
            fe = ServingFrontend(eng, max_queue=8)
            for p in PROMPTS:
                fe.submit(p, max_new_tokens=12)
            fe.serve(max_ticks=400)
    finally:
        trace.record_function = real
    seen = sorted(e.name for e in prof.events() if e.name.startswith(trace.PREFIX)) if profiled else []
    return eng, fe, triggers[0], ranges, seen


def streams(eng, fe):
    return ([fe.requests[rid].stream.text for rid in sorted(fe.requests)],
            [(e["event"], e["agent"], e.get("accepted")) for e in eng.history])


@pytest.fixture(scope="module")
def runs(setup):
    trace.disable()
    trace.clear()
    off = council(setup)
    off_records = trace.records()
    trace.enable()
    try:
        on = council(setup)
    finally:
        trace.disable()
    on_records = trace.records()
    trace.clear()
    again = council(setup, profiled=False)
    return {"off": off, "on": on, "again": again, "off_records": off_records, "on_records": on_records,
            "again_records": trace.records()}


def test_off_records_nothing_and_opens_no_range(runs):
    for run in ("off", "again"):
        assert runs[f"{run}_records"] == []
        assert runs[run][3] == runs[run][4] == []
    # on: one range a span, each in the profile under the span's name
    names = sorted(trace.PREFIX + r.name for r in runs["on_records"])
    assert sorted(runs["on"][3]) == runs["on"][4] == names


def test_no_range_without_a_profiler():
    ranges = []
    real = trace.record_function
    trace.record_function = lambda name: ranges.append(name) or real(name)
    trace.clear()
    trace.enable()
    try:
        with trace.span("engine.tick"):
            pass
    finally:
        trace.disable()
        trace.record_function = real
    assert ranges == [] and [r.name for r in trace.records()] == ["engine.tick"]
    trace.clear()


def test_off_span_is_one_shared_object():
    trace.disable()
    a, b = trace.span("engine.tick"), trace.span("engine.merge", agent="x")
    assert a is b
    with a as s:
        s.set(accepted=True)
    assert trace.records() == []


def test_greedy_streams_bitwise_with_tracing_on_and_off(runs):
    off, on, again = (streams(*runs[k][:2]) for k in ("off", "on", "again"))
    assert off == on == again
    assert any(e == "merge" for e, _, _ in off[1])
    for k in ("off", "on"):
        eng = runs[k][0]
        a, b = eng.state.main_caches.tensors(), runs["again"][0].state.main_caches.tensors()
        assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_span_tree(runs):
    recs = runs["on_records"]
    by_id = {r.id: r for r in recs}
    names = {r.name for r in recs}
    assert {"frontend.step", "frontend.admit", "frontend.retire", "engine.run", "engine.boundary",
            "engine.prefill", "engine.spawn", "spawn.compress", "spawn.write", "engine.dispatch", "engine.tick",
            "tick.river", "tick.side", "tick.sample", "tick.commit", "decode.attn", "engine.fetch",
            "engine.postprocess", "engine.merge", "merge.sync"} <= names
    parent = lambda r: by_id[r.parent].name
    for r in recs:
        if r.name == "engine.tick":
            assert parent(r) == "engine.dispatch"
        elif r.name.startswith("tick."):
            assert parent(r) == "engine.tick"
        elif r.name == "merge.sync":
            assert parent(r) == "engine.merge"
        elif r.name in ("spawn.compress", "spawn.write"):
            assert parent(r) == "engine.spawn"
        elif r.name == "decode.attn":
            assert parent(r) in ("tick.river", "tick.side")
        elif r.name == "engine.prefill":
            assert parent(r) == "frontend.admit"
            assert r.attrs["agent"] == f"fe{by_id[r.parent].attrs['request']}"
        # a child lies inside its parent
        if r.parent:
            p = by_id[r.parent]
            assert p.start_ns <= r.start_ns <= r.end_ns <= p.end_ns and p.thread == r.thread
    # one engine.tick a dispatched tick (an idle engine's ticks dispatch none)
    hist = runs["on"][0].stats["window_hist"]
    n_ticks = sum(r.name == "engine.tick" for r in recs)
    assert n_ticks == sum(w * c for w, c in hist.items()) == sum(r.attrs["ticks"] for r in recs
                                                                 if r.name == "engine.dispatch")
    assert sum(r.name == "decode.attn" for r in recs) > 0


def test_spawn_and_merge_carry_the_river_request(runs):
    eng, fe = runs["on"][:2]
    rivers = {f"fe{rid}" for rid in fe.requests}
    recs = runs["on_records"]
    spawned = {r.attrs["agent"]: r.attrs["parent"] for r in recs if r.name == "engine.spawn"}
    merged = {r.attrs["agent"]: r.attrs["parent"] for r in recs if r.name == "engine.merge"}
    assert spawned and merged and set(spawned.values()) <= rivers
    # a side merges into the river it was spawned from
    assert all(spawned[a] == p for a, p in merged.items())
    accepted = {e["agent"]: e["accepted"] for e in eng.history if e["event"] == "merge"}
    assert {r.attrs["agent"]: r.attrs["accepted"] for r in recs if r.name == "engine.merge"} == accepted
    # each request admitted once; retired once it is done (a retire refused
    # while sides still target the river is tried again later)
    admitted = sorted(r.attrs["request"] for r in recs if r.name == "frontend.admit")
    assert admitted == sorted(fe.requests)
    assert {r.attrs["request"] for r in recs if r.name == "frontend.retire"} == set(fe.requests)


def test_spawn_counters_match_the_triggers(runs, setup):
    for k in ("off", "on"):
        eng, _, triggers = runs[k][:3]
        st = eng.stats
        assert st["spawns"] + st["spawns_dropped"] == triggers > 0
        assert st["spawns"] == sum(e["event"] == "spawn" for e in eng.history)
        assert st["spawns_dropped"] > 0  # four tags, three side lanes
    eng, _, triggers = council(setup, max_side=8, profiled=False)[:3]
    assert eng.stats["spawns_dropped"] == 0 and eng.stats["spawns"] == triggers


def test_side_lane_counters(runs):
    eng = runs["on"][0]
    st = eng.stats
    assert 0 < st["live_side_lane_ticks"] <= st["side_lane_ticks"]
    assert st["side_lane_ticks"] % MAX_SIDE == 0
    # the lanes of every tick that stepped sides, the whole batch
    ticks = sum(r.name == "tick.side" for r in runs["on_records"])
    assert st["side_lane_ticks"] == ticks * MAX_SIDE
    live = sum(r.attrs["sides"] * r.attrs["ticks"] for r in runs["on_records"]
               if r.name == "engine.dispatch")
    assert live == st["live_side_lane_ticks"]


def test_chrome_export_loads_with_every_parent(runs, tmp_path):
    trace.clear()
    trace._records.extend(runs["on_records"])
    try:
        path = tmp_path / "trace.json"
        n = trace.export_chrome(path)
    finally:
        trace.clear()
    events = json.loads(path.read_text())["traceEvents"]
    assert n == len(events) == len(runs["on_records"])
    ids = {e["args"]["id"] for e in events}
    assert all(e["args"]["parent"] in ids for e in events if e["args"]["parent"])
    assert all(e["ph"] == "X" and e["dur"] >= 0 for e in events)


def test_buffer_is_bounded(monkeypatch):
    monkeypatch.setattr(trace, "_records", collections.deque(maxlen=5))
    trace.enable()
    try:
        for i in range(12):
            with trace.span("engine.tick", i=i):
                pass
    finally:
        trace.disable()
    assert [r.attrs["i"] for r in trace.records()] == list(range(7, 12))
    assert trace.records() == list(trace._records)


def test_serve_launcher_writes_the_trace(tmp_path):
    from repro_torch.launch import serve

    path = tmp_path / "serve.json"
    serve.main(["--device", "cpu", "--max-new-tokens", "4", "--no-stream", "--trace-out", str(path)])
    events = json.loads(path.read_text())["traceEvents"]
    names = {e["name"] for e in events}
    assert {"frontend.step", "engine.prefill", "engine.spawn", "engine.tick"} <= names
    assert not trace._on
    trace.clear()
