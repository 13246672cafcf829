"""The port's serving front end against the JAX package's (port of
tests/test_serving_frontend.py and the serving cases of
tests/test_utf8_stream.py), with bridged weights, on the reduced
Qwen2.5-0.5B in f32.

* ``FairQueue`` and ``percentile``: the reference's cases against the
  port's copy.
* Over both port backends (BatchServer and CortexEngine) the same requests
  end with the same stream texts, statuses, ``tokens_out`` and token shares
  as the reference's front end over the JAX backends. TTFT and tick
  percentiles are clocks: only checked to be present and finite.
* Cancel (queued and running), the full-queue ``AdmissionError``, lane
  reuse by engine admissions, the ``serve()`` budget's ``ServeStalled``,
  and the stream-backlog overflow, whose outcome is held equal to the
  reference's (the stalled request ends "ok" there: see ROADMAP queue 3).
* Final texts equal the one-shot decode, bitwise, on both backends, serial
  and pipelined.
"""
import dataclasses
import math
import threading
import types

import jax
import numpy as np
import pytest

from repro.configs import get_config as jax_get_config
from repro.core.engine import CortexEngine as JaxEngine
from repro.core.prism import Prism as JaxPrism
from repro.data.tokenizer import ByteTokenizer as JaxTokenizer
from repro.models import model as jmodel
from repro.serving.frontend import ServeStalled as JaxServeStalled
from repro.serving.frontend import ServingFrontend as JaxFrontend
from repro.serving.sampler import SamplingParams as JaxSampling
from repro.serving.server import BatchServer as JaxServer
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.core.engine import CortexEngine
from repro_torch.core.prism import Prism
from repro_torch.data.tokenizer import ByteTokenizer
from repro_torch.serving.frontend import (
    AdmissionError,
    FairQueue,
    FrontRequest,
    ServeStalled,
    ServingFrontend,
    TokenStream,
    percentile,
)
from repro_torch.serving.sampler import SamplingParams
from repro_torch.serving.server import BatchServer

MULTI = "héllo ∑ x² — 日本語 🚀 done"
TERMINAL = ("ok", "cancelled", "error")


@pytest.fixture(scope="module")
def weights():
    jcfg = dataclasses.replace(jax_get_config("qwen2.5-0.5b", reduced=True), compute_dtype="float32")
    jp = jmodel.init_params(jax.random.key(0), jcfg)
    cfg = dataclasses.replace(get_config("qwen2.5-0.5b", reduced=True), compute_dtype="float32")
    return jcfg, jp, cfg, bridge.params_from_jax(jax.tree.map(np.asarray, jp), cfg, "cpu")


def _req(rid, tenant, priority=0, budget=10):
    return FrontRequest(rid, "p", tenant, priority, budget, None, TokenStream(rid))


# ---------------------------------------------------------------------------
# FairQueue and percentile (no model)
# ---------------------------------------------------------------------------
def test_fair_queue_weighted_shares_track_weights():
    fq = FairQueue({"a": 4.0, "b": 1.0}, starvation_rounds=1000)
    for i in range(40):
        fq.push(_req(100 + i, "a"))
        fq.push(_req(200 + i, "b"))
    admitted = [fq.pop().tenant for _ in range(40)]
    for n in (5, 10, 20, 40):
        a = admitted[:n].count("a")
        assert abs(a / n - 0.8) <= 1 / n + 1e-9, f"prefix {n}: {a}/{n}"


def test_fair_queue_priority_preempts_wfq():
    fq = FairQueue({"a": 4.0, "b": 1.0})
    for i in range(4):
        fq.push(_req(10 + i, "a", priority=0))
    fq.push(_req(99, "b", priority=5))
    assert fq.pop().rid == 99


def test_fair_queue_starvation_bound_holds():
    fq = FairQueue({"hog": 100.0, "tiny": 0.01}, starvation_rounds=8)
    fq.push(_req(1, "tiny", priority=-1, budget=10))
    for i in range(200):
        fq.push(_req(100 + i, "hog", priority=3, budget=10))
    waited = next(n for n in range(1, 50) if fq.pop().rid == 1)
    assert waited == fq.starvation_rounds
    assert fq.starvation_promotions == 1


def test_fair_queue_starvation_boundary_exact():
    fq = FairQueue({"hog": 100.0, "tiny": 0.01}, starvation_rounds=4)
    fq.push(_req(1, "tiny", priority=-1))
    for i in range(20):
        fq.push(_req(100 + i, "hog", priority=3))
    for n in range(1, fq.starvation_rounds):
        assert fq.pop().rid != 1, f"promoted early at decision {n}"
    assert fq.starvation_promotions == 0
    assert fq.pop().rid == 1
    assert fq.starvation_promotions == 1


def test_percentile_nearest_rank_deterministic():
    assert percentile([1, 2, 3, 4], 50) == 2.0
    assert percentile([1, 2, 3, 4], 99) == 4.0
    assert percentile([1, 2, 3, 4], 100) == 4.0
    assert percentile([1, 2], 50) == 1.0
    assert percentile([7], 99) == 7.0
    assert percentile([], 50) == 0.0
    s = [5, 1, 9, 3, 7, 2]
    vals = [percentile(s, q) for q in (0, 10, 25, 50, 75, 90, 99, 100)]
    assert vals == sorted(vals)


def test_fair_queue_idle_tenant_banks_no_credit():
    fq = FairQueue({"a": 1.0, "b": 1.0})
    for i in range(10):
        fq.push(_req(i, "a"))
    for _ in range(10):
        fq.pop()
    fq.push(_req(50, "a"))
    fq.push(_req(51, "b"))
    assert {fq.pop().rid, fq.pop().rid} == {50, 51}


def test_fair_queue_remove_and_len():
    fq = FairQueue()
    fq.push(_req(1, "t"))
    fq.push(_req(2, "t"))
    assert len(fq) == 2
    assert fq.remove(1).rid == 1
    assert fq.remove(1) is None
    assert len(fq) == 1 and fq.pop().rid == 2


# ---------------------------------------------------------------------------
# the same front-end scenario over the JAX backends and the port's
# ---------------------------------------------------------------------------
ENGINE_KW = dict(max_side=2, main_capacity=128, inject_tokens=8, theta=-1.0, sync_every=4,
                 pipeline=True)


def _backend(weights, pkg, mode, *, n_lanes=2, n_main=2, **kw):
    jcfg, jp, cfg, params = weights
    if pkg == "jax":
        tok = JaxTokenizer(jcfg.vocab_size)
        if mode == "batch":
            return JaxServer(jp, jcfg, tok, n_lanes=n_lanes, capacity=128, sampling=JaxSampling(greedy=True))
        return JaxEngine(JaxPrism(jp, jcfg), tok, n_main=n_main, sampling=JaxSampling(greedy=True),
                         **{**ENGINE_KW, **kw})
    tok = ByteTokenizer(cfg.vocab_size)
    if mode == "batch":
        return BatchServer(params, cfg, tok, n_lanes=n_lanes, capacity=128,
                           sampling=SamplingParams(greedy=True), device="cpu")
    return CortexEngine(Prism(params, cfg, device="cpu"), tok, n_main=n_main,
                        sampling=SamplingParams(greedy=True), device="cpu", **{**ENGINE_KW, **kw})


def _frontend(weights, pkg, mode, *, fe_kw=None, **kw):
    cls = JaxFrontend if pkg == "jax" else ServingFrontend
    return cls(_backend(weights, pkg, mode, **kw), **(fe_kw or {}))


def _outcome(fe):
    """What a caller of the front end sees: per request status, stream text,
    tokens out and overflow flag; per tenant token share and admissions."""
    m = fe.metrics()
    reqs = {rid: (r.status, r.stream.text, r.tokens_out, r.stream.overflowed, r.stream.status)
            for rid, r in fe.requests.items()}
    tenants = {t: (v["tokens_out"], v["token_share"], v["admitted"], v["rejected"])
               for t, v in m["tenants"].items()}
    return reqs, tenants, m["completed"], m["fairness"]["admission_rounds"]


def _check_clocks(m):
    """Clock readings: present and finite (their values are host times)."""
    for q in ("p50", "p99"):
        assert math.isfinite(m["ttft_s"][q]) and math.isfinite(m["tick_latency_s"][q])
    assert m["tick_latency_s"]["n"] > 0
    for row in m["requests"]:
        if row["status"] == "ok":
            assert row["ttft_s"] is not None and math.isfinite(row["ttft_s"]) and row["ttft_s"] >= 0
            assert row["queue_wait_s"] is not None


def _batch_streams(pkg, weights):
    fe = _frontend(weights, pkg, "batch", fe_kw=dict(tenants={"gold": 4.0, "free": 1.0}))
    for i in range(4):
        fe.submit(f"prompt number {i} é∑", tenant="gold" if i % 2 == 0 else "free", max_new_tokens=16)
    fe.serve(pipeline=True)
    return fe


def _batch_cancel(pkg, weights):
    fe = _frontend(weights, pkg, "batch")
    for i in range(3):
        fe.submit(f"cancel target {i}", max_new_tokens=32)
    fe._admit_batch()  # fills both lanes; rid 3 stays queued
    assert fe.cancel(3) and fe.requests[3].stream.status == "cancelled"
    assert fe.cancel(1) and fe.requests[1].stream.status == "cancelled"
    assert not fe.cancel(1)
    fe.serve()
    assert fe.backend.stats["cancelled"] == 1  # only the running one reached it
    return fe


def _batch_overflow(pkg, weights):
    fe = _frontend(weights, pkg, "batch")
    fe.submit("stalled consumer", max_new_tokens=64, max_buffered_chars=4)
    fe.submit("healthy consumer", max_new_tokens=16)
    fe.serve()
    return fe


def _engine_streams(pkg, weights):
    fe = _frontend(weights, pkg, "cortex", fe_kw=dict(tenants={"gold": 4.0, "free": 1.0}))
    fe.submit("engine prompt é∑ one", tenant="gold", max_new_tokens=10)
    fe.submit("engine prompt two [TASK: look closer]", tenant="free", max_new_tokens=10)
    fe.serve()
    return fe


def _engine_reuse(pkg, weights):
    fe = _frontend(weights, pkg, "cortex", fe_kw=dict(tenants={"t": 1.0}))
    for i in range(4):  # 4 requests, 2 river lanes
        fe.submit(f"queued req {i}", tenant="t", max_new_tokens=8)
    fe.serve()
    return fe


def _engine_cancel(pkg, weights):
    fe = _frontend(weights, pkg, "cortex", fe_kw=dict(tenants={"t": 1.0}))
    fe.submit("long running request", tenant="t", max_new_tokens=10_000)
    fe.backend.run(4)  # admit and the first window
    assert fe.cancel(1)
    fe.backend.run(8)  # the next boundary honours the cancel
    return fe


SCENARIOS = {
    "batch_streams": ("batch", _batch_streams), "batch_cancel": ("batch", _batch_cancel),
    "batch_overflow": ("batch", _batch_overflow), "engine_streams": ("cortex", _engine_streams),
    "engine_reuse": ("cortex", _engine_reuse), "engine_cancel": ("cortex", _engine_cancel),
}


@pytest.fixture(scope="module")
def outcomes(weights):
    """Every scenario through both packages: {name: {pkg: frontend}}."""
    return {name: {pkg: run(pkg, weights) for pkg in ("jax", "port")}
            for name, (_, run) in SCENARIOS.items()}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_frontend_outcome_equals_reference(outcomes, name):
    """Statuses, stream texts, tokens out, overflow flags, token shares and
    admission counts over the port backends == over the JAX backends."""
    ref, got = outcomes[name]["jax"], outcomes[name]["port"]
    assert _outcome(got) == _outcome(ref)
    reqs = _outcome(got)[0]
    assert all(r[0] in TERMINAL for r in reqs.values())
    assert got.pending() == 0
    if name != "engine_cancel":
        _check_clocks(got.metrics())


def test_batch_streams_bitwise_and_slo_keys(outcomes):
    fe = outcomes["batch_streams"]["port"]
    tok = fe.backend.tok
    finished = {r.rid: r for r in fe.backend.finished}
    for rid, req in fe.requests.items():
        assert req.stream.done and req.stream.status == "ok"
        fin = finished[req.backend_id]
        assert req.stream.text == fin.text == tok.decode(fin.tokens[fin.prompt_len:])
        assert req.tokens_out == 16
    m = fe.metrics()
    assert m["completed"] == 4 and m["backend"] == "batch"
    assert abs(sum(v["token_share"] for v in m["tenants"].values()) - 1.0) < 1e-9
    assert m["fairness"]["admission_rounds"] == 4
    assert m["tick_latency_s"]["p99"] >= m["tick_latency_s"]["p50"] > 0


def test_batch_cancel_statuses(outcomes):
    fe = outcomes["batch_cancel"]["port"]
    assert sorted(r["status"] for r in fe.metrics()["requests"]) == ["cancelled", "cancelled", "ok"]


def test_stream_backlog_overflow_matches_reference(outcomes):
    """The stalled consumer's stream overflows and is flagged; the outcome
    (statuses, flags, texts) is the reference's, whatever it is. In the
    reference the flag comes after the healthy request has finished, and
    the speculating pipeline passes no admission boundary while its lane
    composition stays the same, so the deferred cancel lands only after the
    stalled request has run to its budget ("ok")."""
    ref, got = outcomes["batch_overflow"]["jax"], outcomes["batch_overflow"]["port"]
    stalled, healthy = got.requests[1], got.requests[2]
    assert stalled.stream.overflowed and healthy.stream.status == "ok"
    assert stalled.status == ref.requests[1].status
    assert got.backend.stats["cancelled"] == ref.backend.stats["cancelled"]
    fin = {r.rid: r for r in got.backend.finished}[healthy.backend_id]
    assert healthy.stream.text == fin.text == got.backend.tok.decode(fin.tokens[fin.prompt_len:])


def test_engine_streams_bitwise_and_window_granularity(outcomes):
    fe = outcomes["engine_streams"]["port"]
    eng, tok = fe.backend, fe.backend.tok
    assert any(e["event"] == "spawn" for e in eng.history)
    for rid, req in fe.requests.items():
        assert req.stream.done and req.stream.status == "ok"
        view = next(m for m in eng.mains if m.agent_id == req.backend_id)
        assert not view.active  # retired at a boundary
        gen = view.tokens[view.prompt_len:]
        assert req.stream.text == view.text[len(req.prompt):] == tok.decode(gen)
        assert req.max_new_tokens <= req.tokens_out
        if "[TASK:" not in req.prompt:
            # completion is window-granular: overshoot bounded by the windows
            # of one serve chunk (a lane with a live side retires only after
            # the side merges)
            assert req.tokens_out <= req.max_new_tokens + 8 * eng.sync_every
    m = fe.metrics()
    assert m["backend"] == "engine" and m["completed"] == 2
    for row in m["requests"]:
        assert row["ttft_s"] is not None and row["tpot_s"] is not None


def test_engine_admission_reuses_freed_lane(outcomes):
    fe = outcomes["engine_reuse"]["port"]
    assert all(r.stream.status == "ok" for r in fe.requests.values())
    assert fe.metrics()["fairness"]["admission_rounds"] == 4
    assert fe.pending() == 0


def test_engine_cancel_running_at_boundary(outcomes):
    fe = outcomes["engine_cancel"]["port"]
    s = fe.requests[1].stream
    assert s.done and s.status == "cancelled" and fe.pending() == 0


def test_admission_error_on_full_queue(weights):
    fe = _frontend(weights, "port", "batch", fe_kw=dict(max_queue=2))
    fe.submit("a", tenant="t")
    fe.submit("b", tenant="t")
    with pytest.raises(AdmissionError):
        fe.submit("c", tenant="t")
    assert fe.metrics()["tenants"]["t"]["rejected"] == 1
    fe.serve()
    assert fe.metrics()["completed"] == 2


def test_batch_stream_consumed_from_other_thread(weights):
    fe = _frontend(weights, "port", "batch")
    s = fe.submit("threaded stream ∑", max_new_tokens=12)
    got = []
    t = threading.Thread(target=lambda: got.extend(s))
    t.start()
    fe.serve()
    t.join(timeout=30)
    assert not t.is_alive()
    assert "".join(got) == s.text and s.done


def test_engine_tap_records_ttft_only_with_tokens(weights):
    fe = _frontend(weights, "port", "batch")
    fe.backend.stats["ticks"] = 0  # the engine-style counter the tap samples
    req = _req(1, "t")
    fe.requests[1] = req
    fe.live["aid"] = req
    view = types.SimpleNamespace(agent_id="aid", kind="main")
    fe._engine_tap(view, "", [])
    assert req.t_first is None and req.tokens_out == 0
    fe._engine_tap(view, "xy", [1, 2])
    assert req.t_first is not None and req.tokens_out == 2
    t0 = req.t_first
    fe._engine_tap(view, "z", [3])
    assert req.t_first == t0


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_serve_budget_raises_on_stuck_retirement(weights, pkg):
    """A lane whose retirement is refused (a side with a 10k-step budget
    targets it) exhausts the total budget: ServeStalled names the rid, on
    both packages alike."""
    fe = _frontend(weights, pkg, "cortex", n_main=1, side_max_steps=10_000, fe_kw=dict(tenants={"t": 1.0}))
    s = fe.submit("please [TASK: keep thinking] go", tenant="t", max_new_tokens=4)
    with pytest.raises(JaxServeStalled if pkg == "jax" else ServeStalled) as exc:
        fe.serve(max_ticks=64)
    assert exc.value.stuck == [1]
    assert not s.done
    assert fe.requests[1].tokens_out >= 4


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_serial_batch_serve_admits_nothing_as_reference(weights, pkg):
    """``serve(pipeline=False)`` over a BatchServer: the serial loop stops
    before its first tick, where the admission hook would run, because the
    server's own queue and lanes are empty (the front end holds the
    requests), so nothing is admitted and serve raises ServeStalled. The
    port keeps the reference's behaviour (ROADMAP queue 3)."""
    fe = _frontend(weights, pkg, "batch")
    fe.submit("never admitted", max_new_tokens=4)
    with pytest.raises(JaxServeStalled if pkg == "jax" else ServeStalled, match="no progress"):
        fe.serve(pipeline=False)
    assert fe.requests[1].status == "queued"


def test_frontend_refuses_other_backends():
    with pytest.raises(TypeError, match="unsupported backend"):
        ServingFrontend(object())


# ---------------------------------------------------------------------------
# final text == one-shot decode (serving cases of tests/test_utf8_stream.py)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("pipeline", [False, True])
def test_server_text_equals_oneshot_decode(weights, pipeline):
    srv = _backend(weights, "port", "batch")
    tok = srv.tok
    for p in (MULTI, "plain ascii prompt"):
        srv.submit(p, max_new_tokens=24)
    done = srv.run_until_done(pipeline=pipeline)
    assert len(done) == 2
    for req in done:
        gen = req.tokens[req.prompt_len:]
        assert req.text == tok.decode(gen)
        assert any(0x80 <= t < 0x100 for t in gen), "no multi-byte leads: the test lost its teeth"


@pytest.mark.parametrize("pipeline", [False, True])
def test_engine_text_equals_oneshot_decode(weights, pipeline):
    eng = _backend(weights, "port", "cortex", pipeline=pipeline)
    tok = eng.tok
    a = eng.submit(MULTI, lane=0, agent_id="utf8a")
    b = eng.submit("plain ascii prompt", lane=1, agent_id="utf8b")
    eng.run(13)  # mid-window on the serial path: pending bytes likely
    for m, want in ((a, MULTI), (b, "plain ascii prompt")):
        assert eng.agent_text(m.agent_id) == want + tok.decode(m.tokens[m.prompt_len:])
    eng.retire_main(0)
    assert a.text == MULTI + tok.decode(a.tokens[a.prompt_len:])
