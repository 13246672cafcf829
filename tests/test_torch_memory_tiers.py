"""The port's memory tiers in the engine and the BatchServer (the engine and
server cases of tests/test_memory_tiers.py and tests/test_resilience.py,
the hibernate case of tests/test_utf8_stream.py and the parked/resuming
admission case of tests/test_serving_frontend.py), on the reduced
Qwen2.5-0.5B in f32 on the CPU.

* ZERO DEVICE BYTES — a hibernated agent vanishes from the engine's
  ``per_agent_bytes`` and reappears under the warm or cold tier.
* PARITY INSIDE THE PORT — an agent hibernated at a drain boundary and
  woken later (into another lane, warm or cold, pipelined or serial, across
  a kill and restart) continues bitwise: its stream is a prefix of a
  never-hibernated run's, and untouched lanes are bitwise that run's.
* PARITY WITH THE JAX ENGINE — the same hibernate/wake schedules give the
  JAX engine's greedy tokens and history, where no greedy step sits on a
  near-tie (every sampled greedy lane's top-2 logit margin is held above
  MARGIN, the logit tolerance of tests/test_torch_model.py).
* ASYNC WAKE — ``wake()`` returns at once; the commit lands between the ring
  fetch and the next dispatch, and the overlapped region reads nothing from
  the device.
* POLICY, FAULTS, SERVER — LRU eviction, idle-tick demotion, refusals,
  degradation to LOST or HIBERNATED under injected faults; park/unpark,
  cancels, deadlines and per-request loss in the BatchServer; the front
  end's admission under parked and resuming lanes.

The lane-mesh cases of the reference (``test_mesh1_*``, ``test_mesh8_*``,
``*_on_mesh``) wait for the port's lane sharding.
"""
import dataclasses
import threading
import time

import jax
import numpy as np
import pytest
import torch

from conftest import hypothesis_tools
from repro.configs import get_config as jax_get_config
from repro.core.engine import CortexEngine as JaxEngine
from repro.core.prism import Prism as JaxPrism
from repro.data.tokenizer import ByteTokenizer as JaxTokenizer
from repro.models import model as jmodel
from repro.serving.sampler import SamplingParams as JaxSampling
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.core import engine as tengine
from repro_torch.core.engine import CortexEngine
from repro_torch.core.prism import Prism
from repro_torch.data.tokenizer import ByteTokenizer
from repro_torch.memory import ACTIVE, HIBERNATED, LOST, FaultInjector, SynapseStore
from repro_torch.serving.frontend import ServingFrontend
from repro_torch.serving.sampler import SamplingParams
from repro_torch.serving.server import BatchServer

MARGIN = 1e-4
PROMPT_A = "calm text with no tags at all"
PROMPT_B = "another quiet prompt, still tagless"
MULTI = "héllo ∑ x² — 日本語 🚀 done"
ENGINE_KW = dict(main_capacity=128, side_max_steps=50, inject_tokens=8, theta=-1.0)


@pytest.fixture(scope="module")
def setup():
    cfg = dataclasses.replace(get_config("qwen2.5-0.5b", reduced=True), compute_dtype="float32")
    jcfg = dataclasses.replace(jax_get_config("qwen2.5-0.5b", reduced=True), compute_dtype="float32")
    jp = jmodel.init_params(jax.random.key(0), jcfg)
    return cfg, bridge.params_from_jax(jax.tree.map(np.asarray, jp), cfg, "cpu"), jcfg, jp


def _engine(setup, *, n_main=2, max_side=2, sync_every=4, store=None, hibernate_idle_ticks=None,
            pipeline=True, wake_deadline_s=None):
    cfg, params = setup[:2]
    return CortexEngine(Prism(params, cfg, device="cpu"), ByteTokenizer(cfg.vocab_size), n_main=n_main,
                        max_side=max_side, sampling=SamplingParams(greedy=True), sync_every=sync_every,
                        pipeline=pipeline, store=store, hibernate_idle_ticks=hibernate_idle_ticks,
                        wake_deadline_s=wake_deadline_s, device="cpu", **ENGINE_KW)


def _jax_engine(setup, *, n_main=2):
    _, _, jcfg, jp = setup
    return JaxEngine(JaxPrism(jp, jcfg), JaxTokenizer(jcfg.vocab_size), n_main=n_main, max_side=2,
                     sampling=JaxSampling(greedy=True), sync_every=4, **ENGINE_KW)


def _cold_store(cold_dir, **kw):
    """warm_capacity_bytes=1 sends every put straight to disk."""
    kw.setdefault("wake_backoff_s", 0.001)
    return SynapseStore(warm_capacity_bytes=1, cold_dir=str(cold_dir), **kw)


class _NoHostReads:
    """Makes every host read of a tensor raise (``.item()``, ``.tolist()``,
    ``.cpu()``, ``.numpy()``, ``bool``/``int``/``float`` of a tensor): on
    the card each of them would wait for the device."""
    NAMES = ("item", "tolist", "cpu", "numpy", "__bool__", "__int__", "__float__")

    def __enter__(self):
        self.mp = pytest.MonkeyPatch()
        for name in self.NAMES:
            def refuse(*a, _name=name, **k):
                raise AssertionError(f"host read of a tensor ({_name}) inside the window")
            self.mp.setattr(torch.Tensor, name, refuse)
        return self

    def __exit__(self, *exc):
        self.mp.undo()


def _main(eng, agent_id):
    return next(m for m in eng.mains if m.agent_id == agent_id)


# ---------------------------------------------------------------------------
# parity with the JAX engine
# ---------------------------------------------------------------------------
def _tier_script(eng):
    """A side hibernated mid-decode and a river hibernated and displaced,
    both woken (the river into another lane), on one engine."""
    m = eng.submit(PROMPT_A, lane=0, agent_id="alice")
    assert eng._spawn_side(m, "probe the claim") is not None
    eng.submit(PROMPT_B, lane=1, agent_id="bob")
    eng.run(28)  # past the task prompt: the side is generating
    eng.hibernate("side0")
    eng.hibernate("bob")
    eng.submit("a displacing resident", lane=1, agent_id="carol")
    eng.run(4)
    assert eng.wake("bob", wait=True).lane == 2
    eng.wake("side0", wait=True)
    eng.run(8)
    return ([list(v.tokens) for v in eng.mains + eng.sides],
            [(e["event"], e.get("agent"), e.get("lane")) for e in eng.history])


def _recording_margins(margins, real):
    def recording(gen, logits, lanes, **kw):
        top2 = torch.topk(logits, 2, dim=-1).values
        margins.extend((top2[:, 0] - top2[:, 1])[lanes.temperature <= 0].tolist())
        return real(gen, logits, lanes, **kw)
    return recording


@pytest.fixture(scope="module")
def jax_parity(setup, tmp_path_factory):
    """The schedule on the JAX engine and on the port's engine (warm, and
    cold through framed blobs), with the port's greedy margins recorded."""
    margins = []
    mp = pytest.MonkeyPatch()
    mp.setattr(tengine, "sample_lanes", _recording_margins(margins, tengine.sample_lanes))
    try:
        out = {"warm": _tier_script(_engine(setup, n_main=3)),
               "cold": _tier_script(_engine(setup, n_main=3, store=_cold_store(tmp_path_factory.mktemp("tiers_parity"))))}
    finally:
        mp.undo()
    out["jax"] = _tier_script(_jax_engine(setup, n_main=3))
    return out, margins


def test_tier_schedule_margins_clear_the_tolerance(jax_parity):
    margins = jax_parity[1]
    assert len(margins) > 100
    assert min(margins) > MARGIN, f"near-tie: min top-2 margin {min(margins):.3g}"


@pytest.mark.parametrize("tier", ["warm", "cold"])
def test_hibernate_wake_schedule_equals_jax_engine(jax_parity, tier):
    """Hibernate a side and a river, displace the river, wake both: the
    port's greedy streams and history (wake lanes included) equal the JAX
    engine's on the same schedule, through the warm and the cold tier."""
    out = jax_parity[0]
    assert out[tier] == out["jax"]


# ---------------------------------------------------------------------------
# engine: hibernate / wake
# ---------------------------------------------------------------------------
def test_hibernate_zero_device_bytes_and_tier_report(setup):
    eng = _engine(setup)
    eng.submit(PROMPT_A, lane=0, agent_id="alice")
    eng.run(8)
    rep0 = eng.memory_report()
    alice_bytes = rep0["per_agent_bytes"]["alice"]
    assert alice_bytes > 0
    syncs = eng.stats["host_syncs"]
    eng.hibernate("alice")
    assert eng.stats["host_syncs"] == syncs + 1  # the one copy off the device
    rep = eng.memory_report()
    assert "alice" not in rep["per_agent_bytes"]
    # warm holds the full snapshot: the cache slice + hidden/token/position
    assert alice_bytes <= rep["tiers"]["warm_bytes"] <= alice_bytes + 4096
    assert rep["tiers"]["hot_bytes"] == rep0["tiers"]["hot_bytes"] - alice_bytes
    assert rep["agents"] == {"registered": 1, "active": 0, "hibernated": 1, "lost": 0, "dormant": 1}
    assert eng.store.tier_of("alice") == "warm" and eng.stats["hibernates"] == 1
    with pytest.raises(ValueError, match="not active"):
        eng.hibernate("alice")


@pytest.mark.parametrize("pipeline", [True, False])
@pytest.mark.parametrize("tier", ["warm", "cold"])
def test_hibernate_wake_parity_main_different_lane(setup, pipeline, tier, tmp_path):
    """Hibernated at tick 8, displaced by a new resident, woken into the
    OTHER lane: the greedy stream is a bitwise prefix of the never-hibernated
    run's, and the displacing resident's stream is its own reference's."""
    ref = _engine(setup, pipeline=pipeline)
    ref.submit(PROMPT_A, lane=0, agent_id="alice")
    ref.run(20)
    ref2 = _engine(setup, pipeline=pipeline)
    ref2.submit(PROMPT_B, lane=0, agent_id="bob")
    ref2.run(16)

    eng = _engine(setup, pipeline=pipeline, store=_cold_store(tmp_path) if tier == "cold" else None)
    eng.submit(PROMPT_A, lane=0, agent_id="alice")
    eng.run(8)
    parked_len = len(eng.mains[0].tokens)
    eng.hibernate("alice")
    assert eng.store.tier_of("alice") == tier
    eng.submit(PROMPT_B, lane=0, agent_id="bob")
    eng.run(4)
    alice = eng.wake("alice", wait=True)
    assert alice.active and alice.lane == 1
    eng.run(12)
    assert len(alice.tokens) == parked_len + 12
    assert alice.tokens == ref.mains[0].tokens[: len(alice.tokens)]
    assert eng.stats["wakes"] == 1 and "alice" not in eng.store
    assert eng.mains[0].tokens == ref2.mains[0].tokens[: len(eng.mains[0].tokens)]


def test_wake_commits_inside_run_without_flush(setup):
    """``wake()`` without wait: the commit rides ``run()``'s window
    boundaries while the other lane keeps decoding; drains still overlap."""
    ref = _engine(setup)
    ref.submit(PROMPT_A, lane=0, agent_id="alice")
    ref.run(40)

    eng = _engine(setup)
    eng.submit(PROMPT_A, lane=0, agent_id="alice")
    eng.run(8)
    eng.hibernate("alice")
    eng.submit(PROMPT_B, lane=0, agent_id="bob")
    assert eng.wake("alice").status == HIBERNATED  # async: still parked
    over0 = eng.stats["overlapped_drains"]
    eng.run(24)
    alice = eng.mains[1]
    assert alice.agent_id == "alice" and alice.active and eng.stats["wakes"] == 1
    assert len(alice.tokens) > 8
    assert alice.tokens == ref.mains[0].tokens[: len(alice.tokens)]
    assert eng.stats["overlapped_drains"] > over0
    assert any(e["event"] == "wake" for e in eng.history)


@pytest.mark.parametrize("faults", [None, "retry"])
def test_wake_overlap_region_reads_nothing_from_the_device(setup, faults, tmp_path):
    """A wake committed between the ring fetch and the next dispatch (after
    two transient read failures, in the second case): the overlapped region
    (gate, dispatch t+1, prefetch, window t's post-processing) reads no
    tensor on the host, and window t does not advance the woken lane."""
    store = _cold_store(tmp_path, faults=FaultInjector().fail_read("alice", times=2)) if faults else None
    eng = _engine(setup, store=store)
    eng.submit(PROMPT_A, lane=0, agent_id="alice")
    eng.run(8)
    eng.hibernate("alice")
    eng.submit(PROMPT_B, lane=0, agent_id="bob")
    eng.drain()
    eng.wake("alice")
    eng._wake_tickets["alice"].result(timeout=60)  # the prefetch landed
    if faults:
        assert eng.store.stats["wake_retries"] == 2

    eng._dispatch_window(4)                      # window t
    eng._prefetch_rings()
    rings = eng._fetch_rings()
    assert eng._commit_ready_wakes(mark_fresh=True) == 1  # the boundary commit
    alice = eng.mains[1]
    assert alice.agent_id == "alice" and alice.active
    n_bob, n_alice = len(eng.mains[0].tokens), len(alice.tokens)
    with _NoHostReads():
        assert eng._gate(rings, 4)
        eng._dispatch_window(4)                  # window t+1: alice aboard
        eng._prefetch_rings()
        eng._postprocess(rings, 4, overlapped=True)
    assert len(eng.mains[0].tokens) == n_bob + 4  # window t predates the wake
    assert len(alice.tokens) == n_alice
    eng.drain()                                  # window t+1 advances both
    assert len(eng.mains[0].tokens) == n_bob + 8 and len(alice.tokens) == n_alice + 4
    ref = _engine(setup)
    ref.submit(PROMPT_A, lane=0, agent_id="alice")
    ref.run(16)
    assert alice.tokens == ref.mains[0].tokens[: len(alice.tokens)]


@pytest.mark.parametrize("tier", ["warm", "cold"])
def test_hibernate_wake_parity_side(setup, tier, tmp_path):
    """A side agent freezes while parked (its step budget does not advance)
    and resumes bitwise; the river is untouched."""
    ref = _engine(setup)
    m = ref.submit(PROMPT_A, lane=0, agent_id="alice")
    assert ref._spawn_side(m, "probe the claim") is not None
    ref.run(40)

    eng = _engine(setup, store=_cold_store(tmp_path) if tier == "cold" else None)
    m = eng.submit(PROMPT_A, lane=0, agent_id="alice")
    assert eng._spawn_side(m, "probe the claim") is not None
    eng.run(28)
    side0 = eng.sides[0]
    assert len(side0.tokens) > side0.prompt_len
    parked_len, parked_steps = len(side0.tokens), side0.steps
    eng.hibernate("side0")
    eng.run(4)
    side = eng.wake("side0", wait=True)
    assert side.active
    eng.run(8)
    assert side.steps == parked_steps + 8
    assert len(side.tokens) == parked_len + 8
    assert side.tokens == ref.sides[0].tokens[: len(side.tokens)]
    assert eng.mains[0].tokens == ref.mains[0].tokens


def test_hibernate_refuses_main_with_children(setup):
    eng = _engine(setup)
    m = eng.submit(PROMPT_A, lane=0, agent_id="alice")
    assert eng._spawn_side(m, "child stream") is not None
    with pytest.raises(ValueError, match="side streams still target"):
        eng.hibernate("alice")
    eng.run(4)
    eng.hibernate("side0")  # a HIBERNATED child still targets the lane
    with pytest.raises(ValueError, match="side streams still target"):
        eng.hibernate("alice")
    with pytest.raises(ValueError, match="side streams still target"):
        eng.retire_main(0)


def test_submit_agent_lru_eviction(setup):
    """A full house hibernates the least recently bound resident: lanes
    bound the *active* agents, not the registered ones."""
    eng = _engine(setup)
    a = eng.submit_agent(PROMPT_A)
    b = eng.submit_agent(PROMPT_B)
    assert {a.lane, b.lane} == {0, 1}
    eng.run(4)
    c = eng.submit_agent("third agent enters")  # evicts a (LRU)
    assert c.active
    assert eng.registry.get(a.agent_id).status == HIBERNATED
    assert eng.registry.get(b.agent_id).status == ACTIVE
    assert eng.store.tier_of(a.agent_id) == "warm"
    rep = eng.memory_report()
    assert rep["agents"]["registered"] == 3
    assert rep["agents"]["active"] == 2 and rep["agents"]["hibernated"] == 1
    parked = len(a.tokens)
    eng.hibernate(b.agent_id)
    woken = eng.wake(a.agent_id, wait=True)
    eng.run(4)
    assert len(woken.tokens) == parked + 4


def test_submit_agent_refuses_when_all_blocked(setup):
    eng = _engine(setup, n_main=1)
    m = eng.submit_agent(PROMPT_A)
    assert eng._spawn_side(m, "pin the lane") is not None
    with pytest.raises(RuntimeError, match="no evictable resident"):
        eng.submit_agent(PROMPT_B)


@pytest.mark.parametrize("pipeline", [True, False])
def test_auto_hibernate_idle_ticks(setup, pipeline):
    eng = _engine(setup, hibernate_idle_ticks=8, pipeline=pipeline)
    eng.submit(PROMPT_A, lane=0, agent_id="alice")
    eng.run(16)
    assert eng.registry.get("alice").status == HIBERNATED
    assert eng.stats["hibernates"] == 1 and not eng._any_active() and "alice" in eng.store
    alice = eng.wake("alice", wait=True)
    n = len(alice.tokens)
    eng.run(4)
    assert len(alice.tokens) == n + 4


def test_resubmit_hibernated_id_drops_snapshot(setup):
    """Re-submitting a parked agent_id replaces the context outright: the
    snapshot and any pending wake are discarded."""
    eng = _engine(setup)
    eng.submit(PROMPT_A, lane=0, agent_id="alice")
    eng.run(4)
    eng.hibernate("alice")
    eng.wake("alice")
    eng.submit(PROMPT_B, lane=0, agent_id="alice")
    assert "alice" not in eng.store and not eng._pending_wakes
    assert eng.registry.get("alice").status == ACTIVE
    eng.run(4)  # no stray commit resurrects the old context
    assert eng.mains[0].agent_id == "alice" and eng.mains[1].active is False
    # the classic per-lane identity stays unique while its agent is parked
    eng.submit(PROMPT_A, lane=1)
    eng.run(4)
    eng.hibernate("main1")
    assert eng.submit(PROMPT_B, lane=1).agent_id.startswith("main1.")


def test_engine_hibernate_preserves_decoder_pending(setup):
    """A codepoint split across the hibernation still decodes exactly once."""
    cfg = setup[0]
    tok = ByteTokenizer(cfg.vocab_size)
    eng = _engine(setup)
    eng.submit(MULTI, lane=0, agent_id="parked")
    eng.run(12)
    eng.hibernate("parked")
    assert eng.wake("parked")
    eng.run(12)
    view = eng.mains[eng.registry.get("parked").lane]
    assert eng.agent_text("parked") == MULTI + tok.decode(view.tokens[view.prompt_len:])


given, settings, st = hypothesis_tools()

_OPS = st.lists(
    st.one_of(
        st.tuples(st.just("run"), st.integers(min_value=1, max_value=9)),
        st.tuples(st.just("hib"), st.just(0)),
        st.tuples(st.just("wake"), st.just(0)),
    ),
    min_size=3,
    max_size=8,
)


@settings(max_examples=5, deadline=None)
@given(ops=_OPS)
def test_property_churn_parity(setup, ops):
    """Random run/hibernate/wake interleavings: bob (never hibernated) stays
    BITWISE the reference, and alice's stream is always a prefix of her
    never-hibernated self."""
    ref = _engine(setup)
    eng = _engine(setup)
    for e in (ref, eng):
        e.submit(PROMPT_A, lane=0, agent_id="alice")
        e.submit(PROMPT_B, lane=1, agent_id="bob")
    for op, n in ops:
        if op == "run":
            ref.run(n)
            eng.run(n)
        elif op == "hib" and eng.registry.get("alice").status == ACTIVE:
            eng.hibernate("alice")
        elif op == "wake" and eng.registry.get("alice").status == HIBERNATED:
            eng.wake("alice")
    if eng.registry.get("alice").status != ACTIVE:
        eng.wake("alice", wait=True)
    ref.run(4)
    eng.run(4)
    assert _main(eng, "bob").tokens == ref.mains[1].tokens
    alice = _main(eng, "alice")
    assert alice.tokens == ref.mains[0].tokens[: len(alice.tokens)]
    assert eng.stats["hibernates"] == eng.stats["wakes"]


# ---------------------------------------------------------------------------
# engine: kill and restart, degradation under faults
# ---------------------------------------------------------------------------
def test_kill_and_restart_replays_bitwise(setup, tmp_path):
    ref = _engine(setup)
    ref.submit(PROMPT_A, lane=0, agent_id="alice")
    ref.submit(PROMPT_B, lane=1, agent_id="bob")
    ref.run(12)
    ref.hibernate("alice")
    ref.run(8)
    ref.wake("alice", wait=True)
    ref.run(12)
    ref_alice = _main(ref, "alice")

    store = _cold_store(tmp_path)
    cold_dir = store.cold_dir
    e1 = _engine(setup, store=store)
    e1.submit(PROMPT_A, lane=0, agent_id="alice")
    e1.submit(PROMPT_B, lane=1, agent_id="bob")
    e1.run(12)
    e1.hibernate("alice")
    assert store.tier_of("alice") == "cold"
    del e1, store  # CRASH: every piece of process state is gone

    store2 = _cold_store(tmp_path)
    assert store2.recover(cold_dir)["recovered"] == ["alice"]
    e2 = _engine(setup, store=store2)
    assert e2.adopt_hibernated() == ["alice"]
    assert e2.registry.get("alice").status == HIBERNATED and e2.stats["recoveries"] == 1
    e2.submit(PROMPT_B, lane=1, agent_id="bob")  # bob replays from scratch
    e2.run(20)
    e2.wake("alice", wait=True)
    e2.run(12)
    alice2 = _main(e2, "alice")
    assert alice2.tokens == ref_alice.tokens and alice2.text == ref_alice.text
    assert e2._main_sp[alice2.lane] == SamplingParams(greedy=True)


def test_recovered_router_tail_still_matches_split_tag(setup, tmp_path):
    """A trigger tag split across the hibernation still fires after a kill
    and restart: the router tail rides the blob's metadata."""
    store = _cold_store(tmp_path)
    eng = _engine(setup, store=store)
    eng.submit(PROMPT_A, lane=0, agent_id="alice")
    eng.run(8)
    eng.router.feed("alice", "some text then [TA")
    eng.hibernate("alice")
    cold_dir = store.cold_dir
    del eng, store

    store2 = _cold_store(tmp_path)
    store2.recover(cold_dir)
    e2 = _engine(setup, store=store2)
    assert e2.adopt_hibernated() == ["alice"]
    trigs = e2.router.feed("alice", "SK: resume work] more text")
    assert [t.kind for t in trigs] == ["task"] and trigs[0].payload == "resume work"


def test_permanent_loss_degrades_lost_engine_keeps_ticking(setup, tmp_path):
    """A corrupt blob at wake: the agent is LOST, its would-be lane stays
    free, the other lane is bitwise a fault-free engine's, and the window
    accounting (one dispatch and one sync per window) holds."""
    ref = _engine(setup)
    ref.submit(PROMPT_A, lane=0, agent_id="alice")
    ref.submit(PROMPT_B, lane=1, agent_id="bob")
    ref.run(32)

    store = _cold_store(tmp_path, faults=FaultInjector().flip_write("alice"))
    eng = _engine(setup, store=store)
    eng.submit(PROMPT_A, lane=0, agent_id="alice")
    eng.submit(PROMPT_B, lane=1, agent_id="bob")
    eng.run(16)
    eng.hibernate("alice")
    eng.wake("alice")
    d0, s0, t0 = eng.stats["tick_dispatches"], eng.stats["host_syncs"], eng.stats["ticks"]
    eng.run(16)
    eng.flush_wakes()
    n_windows = (eng.stats["ticks"] - t0) / eng.sync_every
    assert eng.stats["tick_dispatches"] - d0 == n_windows
    assert eng.stats["host_syncs"] - s0 == n_windows
    assert eng.registry.get("alice").status == LOST
    assert eng.stats["lost_agents"] == 1 and store.stats["quarantined"] == 1
    assert eng.registry.counts()["lost"] == 1
    assert any(e["event"] == "lost" for e in eng.history)
    bob = _main(eng, "bob")
    assert eng.stats["ticks"] == 32
    assert bob.tokens == ref.mains[1].tokens and bob.text == ref.mains[1].text
    eng.submit(PROMPT_A, lane=0, agent_id="carol")
    eng.run(4)
    assert eng.mains[0].agent_id == "carol" and eng.mains[0].active
    with pytest.raises(ValueError):
        eng.wake("alice")


def test_transient_wake_failure_stays_hibernated_then_wakes(setup, tmp_path):
    store = _cold_store(tmp_path, faults=FaultInjector().fail_read("alice", times=99), wake_retries=2)
    eng = _engine(setup, store=store)
    eng.submit(PROMPT_A, lane=0, agent_id="alice")
    eng.run(8)
    eng.hibernate("alice")
    eng.wake("alice")
    eng.run(8)
    eng.flush_wakes()
    assert eng.registry.get("alice").status == HIBERNATED
    assert eng.stats["wake_failures"] == 1 and eng.stats["lost_agents"] == 0
    assert any(e["event"] == "wake_failed" for e in eng.history)
    store.faults = None  # the flaky disk recovers
    assert eng.wake("alice", wait=True).active
    assert eng.registry.get("alice").status == ACTIVE


@pytest.mark.filterwarnings("ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_worker_death_mid_wake_heals_and_engine_continues(setup, tmp_path):
    store = _cold_store(tmp_path, faults=FaultInjector().kill_worker_on_read("alice"))
    eng = _engine(setup, store=store)
    eng.submit(PROMPT_A, lane=0, agent_id="alice")
    eng.run(8)
    eng.hibernate("alice")
    eng.wake("alice")
    deadline = time.monotonic() + 30
    while store._worker.is_alive() and time.monotonic() < deadline:
        time.sleep(0.01)
    eng.run(8)  # the boundary ops heal the worker and fail the wake
    eng.flush_wakes()
    assert store.stats["worker_respawns"] == 1
    assert eng.registry.get("alice").status == HIBERNATED
    store.faults = None
    assert eng.wake("alice", wait=True).active


@pytest.mark.parametrize("default", [False, True])
def test_wake_deadline_degrades_blocked_promotion(setup, default, tmp_path):
    """A promotion blocked past its deadline (the wake's own, or the
    engine's ``wake_deadline_s``) fails at a boundary; the engine ticks on
    and a second wake lands."""
    release = threading.Event()
    store = _cold_store(tmp_path, faults=FaultInjector().block_put("alice", release=release, timeout=30))
    eng = _engine(setup, store=store, wake_deadline_s=0.05 if default else None)
    eng.submit(PROMPT_A, lane=0, agent_id="alice")
    eng.run(8)
    eng.hibernate("alice")
    eng.wake("alice") if default else eng.wake("alice", deadline_s=0.05)
    time.sleep(0.2)
    eng.run(8)
    eng.flush_wakes()
    assert eng.registry.get("alice").status == HIBERNATED
    assert eng.stats["wake_failures"] == 1
    release.set()
    store.faults = None
    assert eng.wake("alice", wait=True, deadline_s=30).active


# ---------------------------------------------------------------------------
# BatchServer park / unpark
# ---------------------------------------------------------------------------
def _server(setup, store=None, n_lanes=2, wake_deadline_s=None):
    cfg, params = setup[:2]
    return BatchServer(params, cfg, ByteTokenizer(cfg.vocab_size), n_lanes=n_lanes, capacity=128,
                       sampling=SamplingParams(greedy=True), store=store, wake_deadline_s=wake_deadline_s,
                       device="cpu")


@pytest.mark.parametrize("tier", ["warm", "cold"])
@pytest.mark.parametrize("pipeline", [False, True])
def test_server_park_unpark_stream_parity(setup, pipeline, tier, tmp_path):
    ref = _server(setup)
    ref.submit(PROMPT_A, max_new_tokens=20)
    ref_req = ref.run_until_done(pipeline=pipeline)[0]

    srv = _server(setup, store=_cold_store(tmp_path) if tier == "cold" else None)
    rid = srv.submit(PROMPT_A, max_new_tokens=20)
    for _ in range(6):
        srv.tick()
    assert srv.park(rid)
    assert srv.lanes == [None, None] and rid in srv.parked
    assert srv.store.tier_of(f"req{rid}") == tier
    rid2 = srv.submit(PROMPT_B, max_new_tokens=6)  # recycles the lane
    for _ in range(3):
        srv.tick()
    assert srv.unpark(rid)
    with _NoHostReads():  # the resume reads its position from the meta, not the device
        srv._admit_unparked(wait=True)
    assert srv.lanes[1].rid == rid
    done = {r.rid: r for r in srv.run_until_done(pipeline=pipeline)}
    assert done[rid].tokens == ref_req.tokens  # bitwise continuation
    assert done[rid2].done
    assert f"req{rid}" not in srv.store


def test_server_park_lands_between_speculative_rollbacks(setup):
    """A park and an unpark land only where nothing is in flight, so the
    pipelined loop's undo record never spans one: through surprise-EOS
    rollbacks (the EOS id set to a token the model emits greedily) the
    parked request resumes bitwise and every stream equals the serial
    loop's."""
    cfg = setup[0]
    outs = []
    for pipeline in (True, False):
        srv = _server(setup)
        probe = _server(setup)
        probe.submit("probe the stream", max_new_tokens=12)
        d = probe.run_until_done(pipeline=False)[0]
        srv.tok.eos_id = d.tokens[d.prompt_len + 3]
        rid = srv.submit(PROMPT_A, max_new_tokens=24)
        for _ in range(5):
            srv.tick()
        assert srv.park(rid)
        srv.submit("probe the stream", max_new_tokens=12)
        srv.submit(PROMPT_B, max_new_tokens=9)
        srv.unpark(rid)
        done = srv.run_until_done(pipeline=pipeline)
        outs.append((sorted((r.rid, tuple(r.tokens), r.status) for r in done), dict(srv.stats)))
        srv.tok.eos_id = ByteTokenizer(cfg.vocab_size).eos_id
    (piped, pstats), (serial, _) = outs
    assert piped == serial and len(piped) == 3
    assert pstats["rollbacks"] >= 1 and pstats["overlapped"] > 0


def test_server_cancel_parked_and_resuming(setup):
    srv = _server(setup)
    rid = srv.submit(PROMPT_A, max_new_tokens=16)
    for _ in range(4):
        srv.tick()
    srv.park(rid)
    assert srv.cancel(rid)  # parked: the snapshot is dropped
    assert f"req{rid}" not in srv.store and rid not in srv.parked

    rid2 = srv.submit(PROMPT_B, max_new_tokens=16)
    for _ in range(4):
        srv.tick()
    srv.park(rid2)
    srv.unpark(rid2)
    assert srv.cancel(rid2)  # mid-resume: the ticket is abandoned
    assert f"req{rid2}" not in srv.store and not srv._resume
    done = {r.rid: r for r in srv.finished}
    assert set(done) == {rid, rid2}
    assert all(r.done and r.status == "cancelled" for r in done.values())
    assert srv.stats["cancelled"] == 2
    assert {r.rid for r in srv.run_until_done()} == {rid, rid2}  # nothing new


@pytest.mark.parametrize("default", [False, True])
def test_server_unpark_deadline_fails_only_that_request(setup, default, tmp_path):
    release = threading.Event()
    store = SynapseStore(warm_capacity_bytes=1, cold_dir=str(tmp_path),
                         wake_backoff_s=0.001)
    srv = _server(setup, store=store)
    r1 = srv.submit(PROMPT_A, max_new_tokens=24)
    r2 = srv.submit(PROMPT_B, max_new_tokens=24)
    for _ in range(2):
        srv.tick()
    assert srv.park(r1) and srv.park(r2)
    # the short block lets the one prefetch worker free itself to serve r2
    # after r1's deadline has expired host-side
    store.faults = FaultInjector().block_put(f"req{r1}", release=release, timeout=0.5)
    if default:
        srv.wake_deadline_s = 0.05
        srv.unpark(r1)
        srv.wake_deadline_s = None
    else:
        srv.unpark(r1, deadline_s=0.05)
    srv.unpark(r2)
    done = {r.rid: r for r in srv.run_until_done()}
    release.set()
    assert done[r1].error is not None and done[r1].status == "error"
    assert done[r2].error is None and len(done[r2].tokens) == done[r2].prompt_len + 24
    assert srv.stats["lost_requests"] == 1


def test_server_lost_parked_snapshot_degrades_per_request(setup, tmp_path):
    """One corrupt parked blob fails ONE request; the other resumes bitwise
    against a never-parked reference."""
    ref = _server(setup)
    rr = ref.submit(PROMPT_B, max_new_tokens=24)
    ref_done = {r.rid: r for r in ref.run_until_done()}

    store = SynapseStore(warm_capacity_bytes=1, cold_dir=str(tmp_path),
                         wake_backoff_s=0.001)
    srv = _server(setup, store=store)
    r1 = srv.submit(PROMPT_A, max_new_tokens=24)
    r2 = srv.submit(PROMPT_B, max_new_tokens=24)
    for _ in range(2):
        srv.tick()
    store.faults = FaultInjector().flip_write(f"req{r1}")
    assert srv.park(r1) and srv.park(r2)
    srv.unpark(r1)
    srv.unpark(r2)
    done = {r.rid: r for r in srv.run_until_done()}
    assert done[r1].error is not None
    assert done[r2].error is None and done[r2].done
    assert store.stats["quarantined"] == 1
    assert done[r2].tokens == ref_done[rr].tokens


@pytest.mark.parametrize("pipeline", [False, True])
def test_admission_under_parked_and_resuming_lanes(setup, pipeline):
    """The front end's free-lane count subtracts queued prompts AND resume
    tickets: a resuming lane is not double-booked (over-admission), and a
    lane parked without a resume is not stranded (under-admission)."""
    srv = _server(setup)
    fe = ServingFrontend(srv, tenants={"t": 1.0})
    s1 = fe.submit("park victim one", tenant="t", max_new_tokens=24)
    s2 = fe.submit("steady stream two", tenant="t", max_new_tokens=24)
    srv._admit()  # the boundary: both admitted onto the two lanes
    assert fe.metrics()["fairness"]["admission_rounds"] == 2
    rid1 = fe.requests[s1.rid].backend_id

    assert srv.park(rid1)
    assert srv.unpark(rid1)  # lane 0 free, but a resume ticket holds it
    s3 = fe.submit("queued three", tenant="t", max_new_tokens=12)
    assert fe._admit_batch() == 0, "over-admitted into a lane reserved by a resume"
    assert len(srv.queue) == 0 and len(fe.fq) == 1
    fe.serve(pipeline=pipeline)
    for s in (s1, s2, s3):
        assert s.done and s.status == "ok"
    assert fe.pending() == 0 and len(fe.fq) == 0

    s4 = fe.submit("park victim four", tenant="t", max_new_tokens=48)
    s5 = fe.submit("waiter five", tenant="t", max_new_tokens=8)
    srv._admit()
    rid4 = fe.requests[s4.rid].backend_id
    assert srv.park(rid4)
    s6 = fe.submit("queued six", tenant="t", max_new_tokens=8)
    assert fe._admit_batch() == 1, "stranded a free lane while a request was parked"
    srv._admit()
    assert all(r is not None for r in srv.lanes)
    assert srv.unpark(rid4)
    fe.serve(pipeline=pipeline)
    for s in (s4, s5, s6):
        assert s.done and s.status == "ok", (s.rid, s.status)
    assert fe.pending() == 0


# ---------------------------------------------------------------------------
# the launcher's tier flags
# ---------------------------------------------------------------------------
def test_launcher_recovers_and_wakes_a_hibernated_agent(setup, tmp_path, capsys):
    """``--cold-dir`` serves with a cold tier; ``--cold-dir --recover``
    rebuilds it after a restart, re-adopts the agent a dead process left
    there and wakes it while serving; ``--recover`` alone is refused."""
    from repro_torch.launch import serve
    from repro_torch.models import model as tmodel

    args = ["--device", "cpu", "--no-stream", "--max-new-tokens", "8", "--cold-dir", str(tmp_path)]
    m = serve.main(args + ["--request", "t:0:hello"])
    assert m["completed"] == 1
    # a dead process's agent, with the launcher's engine settings
    cfg = get_config("qwen2.5-0.5b", reduced=True)
    eng = CortexEngine(Prism(tmodel.init_params(cfg, seed=0, device="cpu"), cfg, device="cpu"),
                       ByteTokenizer(cfg.vocab_size), n_main=2, max_side=4, main_capacity=512,
                       side_max_steps=12, theta=-1.0, sampling=SamplingParams(temperature=1.0),
                       store=SynapseStore(warm_capacity_bytes=1, cold_dir=str(tmp_path)), device="cpu")
    eng.submit(PROMPT_A, lane=0, agent_id="resident")
    eng.run(8)
    eng.hibernate("resident")
    del eng
    capsys.readouterr()
    m = serve.main(args + ["--recover", "--wake-deadline", "30", "--request", "t:0:hello"])
    out = capsys.readouterr().out
    assert m["completed"] == 1
    assert "recover: 1 cold entries rebuilt (0 orphan blobs), 0 quarantined, 0 lost; " \
           "1 agents re-adopted: ['resident']" in out
    assert "agents: 2 registered, 1 active, 0 hibernated, 0 lost" in out  # the resident woke
    assert "1 recoveries" in out
    with pytest.raises(SystemExit):
        serve.main(["--device", "cpu", "--recover"])
