"""The port's pipelined, adaptive-window CortexEngine and its BatchServer
against the JAX package's, with bridged weights, on the reduced
Qwen2.5-0.5B in f32 (port of tests/test_adaptive_pipeline.py, plus the
router checks of tests/test_router.py against the port's router copy).

* CHURN PARITY — one script of submit/spawn/merge/retire and ``run(n)``
  (partial windows and a lane restart included) gives the same greedy main
  and side streams, history and dispatch/sync accounting on the port's
  pinned and adaptive pipelined engines as on the JAX engines with the same
  settings, and bitwise the same streams as the port's serial loop. Greedy
  equality with the reference holds only where no step sits on a near-tie,
  so every greedy sample's top-2 logit margin is held above MARGIN (the
  logit tolerance of tests/test_torch_model.py).
* DISPATCH ACCOUNTING, ADAPTATION, the GATE and the overlapped budget cap,
  as in the reference's suite.
* SERVER — the port's BatchServer pipelined run equals its serial run
  bitwise through a surprise-EOS rollback, and its greedy streams equal the
  JAX BatchServer's; a recycled lane never inherits sampling parameters.
"""
import dataclasses
import math

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core.engine import CortexEngine as JaxEngine
from repro.core.prism import Prism as JaxPrism
from repro.data.tokenizer import ByteTokenizer as JaxTokenizer
from repro.models import model as jmodel
from repro.serving.sampler import SamplingParams as JaxSampling
from repro.serving.server import BatchServer as JaxServer
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.core import engine as tengine
from repro_torch.core.engine import AdaptiveWindow, CortexEngine
from repro_torch.core.prism import Prism
from repro_torch.core.router import CortexRouter
from repro_torch.data.tokenizer import ByteTokenizer
from repro_torch.serving import server as tserver
from repro_torch.serving.sampler import SamplingParams
from repro_torch.serving.server import BatchServer

MARGIN = 1e-4
STATS = ("ticks", "tick_dispatches", "macro_dispatches", "aux_dispatches", "host_syncs",
         "drains", "overlapped_drains", "window_hist")


@pytest.fixture(scope="module")
def weights():
    jcfg = dataclasses.replace(jax_get_config("qwen2.5-0.5b", reduced=True), compute_dtype="float32")
    jp = jmodel.init_params(jax.random.key(0), jcfg)
    cfg = dataclasses.replace(get_config("qwen2.5-0.5b", reduced=True), compute_dtype="float32")
    return jcfg, jp, cfg, bridge.params_from_jax(jax.tree.map(np.asarray, jp), cfg, "cpu")


ENGINE_KW = dict(n_main=1, max_side=2, main_capacity=128, inject_tokens=8, theta=-1.0)


def _jax_engine(weights, *, pipeline, max_window=None, sync_every=4, side_max_steps=6):
    jcfg, jp, _, _ = weights
    return JaxEngine(JaxPrism(jp, jcfg), JaxTokenizer(jcfg.vocab_size), side_max_steps=side_max_steps,
                     sampling=JaxSampling(greedy=True), sync_every=sync_every, max_window=max_window,
                     pipeline=pipeline, **ENGINE_KW)


def _engine(weights, *, pipeline, max_window=None, sync_every=4, side_max_steps=6,
            sampling=SamplingParams(greedy=True), side_sampling=None):
    _, _, cfg, params = weights
    return CortexEngine(Prism(params, cfg, device="cpu"), ByteTokenizer(cfg.vocab_size),
                        side_max_steps=side_max_steps, sampling=sampling, side_sampling=side_sampling,
                        sync_every=sync_every, max_window=max_window, pipeline=pipeline,
                        device="cpu", **ENGINE_KW)


def _apply(eng, ops):
    """One churn script, engine-agnostic. Returns (n, tick_dispatches
    delta) of every run op."""
    deltas = []
    for op in ops:
        if op[0] == "submit":
            eng.submit(op[1], lane=0)
        elif op[0] == "run":
            d0 = eng.stats["tick_dispatches"]
            eng.run(op[1])
            deltas.append((op[1], eng.stats["tick_dispatches"] - d0))
        elif op[0] == "spawn":
            eng._spawn_side(eng.mains[0], op[1])  # a drain-boundary spawn, bypassing the router
        elif op[0] == "retire":
            eng.retire_side(op[1])
    return deltas


def _streams(eng):
    return (
        list(eng.mains[0].tokens),
        [list(s.tokens) for s in eng.sides],
        [(e["event"], e.get("accepted")) for e in eng.history],
    )


CHURN_SCRIPT = [
    ("submit", "hello [TASK: go] world"),
    ("run", 7),               # partial trailing window
    ("spawn", "second probe"),
    ("run", 9),               # budget completions -> merges mid-script
    ("retire", 0),
    ("retire", 1),
    ("run", 5),
    ("submit", "calm text with no tags at all"),  # lane restart
    ("run", 24),              # trigger-free stretch: windows may lengthen
    ("run", 3),
]
KINDS = {"serial": dict(pipeline=False), "pinned": dict(pipeline=True),
         "adaptive": dict(pipeline=True, max_window=16)}


def _recording_margins(margins, real):
    """``real`` (a sample_lanes) recording the top-2 logit margin of every
    greedy lane's sample."""

    def recording(gen, logits, lanes, **kw):
        top2 = torch.topk(logits, 2, dim=-1).values
        keep = lanes.temperature <= 0
        margins.extend((top2[:, 0] - top2[:, 1])[keep].tolist())
        return real(gen, logits, lanes, **kw)
    return recording


@pytest.fixture(scope="module")
def churn(weights):
    """The port's three engines (margins recorded) and the JAX engines with
    the pipelined settings, each through the churn script."""
    margins = []
    mp = pytest.MonkeyPatch()
    mp.setattr(tengine, "sample_lanes", _recording_margins(margins, tengine.sample_lanes))
    try:
        port = {k: _engine(weights, **kw) for k, kw in KINDS.items()}
        deltas = {k: _apply(e, CHURN_SCRIPT) for k, e in port.items()}
    finally:
        mp.undo()
    ref = {k: _jax_engine(weights, **KINDS[k]) for k in ("pinned", "adaptive")}
    ref_deltas = {k: _apply(e, CHURN_SCRIPT) for k, e in ref.items()}
    return port, deltas, ref, ref_deltas, margins


def test_churn_margins_clear_the_tolerance(churn):
    margins = churn[4]
    assert len(margins) > 100
    assert min(margins) > MARGIN, f"near-tie: min top-2 margin {min(margins):.3g}"


@pytest.mark.parametrize("kind", ["pinned", "adaptive"])
def test_churn_parity_with_serial_and_reference(churn, kind):
    """Pipelined (pinned, adaptive) == the port's serial loop, bitwise, and
    == the JAX engine with the same settings: streams, history, and the
    dispatch/sync accounting."""
    port, deltas, ref, ref_deltas, _ = churn
    assert _streams(port[kind]) == _streams(port["serial"])
    assert _streams(port[kind]) == _streams(ref[kind])
    for key in STATS:
        assert port[kind].stats[key] == ref[kind].stats[key], key
    assert deltas[kind] == ref_deltas[kind]
    events = [e for e, _ in _streams(port[kind])[2]]
    assert "spawn" in events and "merge" in events and "retire" in events
    for a, b in zip(port[kind].history, ref[kind].history):
        assert a["agent"] == b["agent"]


def test_churn_dispatch_accounting(churn):
    """Per run(n) from a boundary: pinned issues exactly ceil(n/base)
    windows, adaptive at most that many (and fewer over the script)."""
    _, deltas, _, _, _ = churn
    for n, d in deltas["pinned"]:
        assert d == math.ceil(n / 4), (n, d)
    for n, d in deltas["adaptive"]:
        assert d <= math.ceil(n / 4), (n, d)
    assert sum(d for _, d in deltas["adaptive"]) < sum(d for _, d in deltas["pinned"])
    assert deltas["serial"] == deltas["pinned"]


def test_churn_window_hist_accounts_every_tick(churn):
    port = churn[0]
    for eng in port.values():
        hist = eng.stats["window_hist"]
        assert sum(w * c for w, c in hist.items()) == eng.stats["ticks"]
    assert max(port["adaptive"].stats["window_hist"]) > 4   # lengthened
    assert max(port["pinned"].stats["window_hist"]) == 4    # pinned
    assert port["serial"].stats["overlapped_drains"] == 0
    assert port["pinned"].stats["overlapped_drains"] > 0
    assert port["adaptive"].stats["overlapped_drains"] > 0


def test_adaptive_ladder_is_bounded_and_snaps_back(weights):
    eng = _engine(weights, pipeline=True, max_window=16)
    assert eng.window.ladder == (4, 8, 16)
    eng.submit("calm words only", lane=0)
    assert eng.window.propose() == 4  # admission resets
    eng.run(48)
    hist = eng.stats["window_hist"]
    assert hist.get(16, 0) >= 1, hist  # climbed to max_window
    assert eng.stats["tick_dispatches"] < math.ceil(48 / 4)
    eng.submit("another calm prompt", lane=0)
    assert eng.window.propose() == 4
    assert set(hist) <= {1, 3, 4, 8, 16}, hist


def test_overlapped_budget_cap_sees_pending_window(weights):
    """In the overlapped branch the window policy runs before window t's
    post-processing, so the side budget cap counts window t's ring tokens;
    otherwise the merge drifts off the serial tick (sync_every=2,
    max_window=16, side_max_steps=9)."""
    kw = dict(sync_every=2, side_max_steps=9)
    serial = _engine(weights, pipeline=False, **kw)
    adaptive = _engine(weights, pipeline=True, max_window=16, **kw)
    for eng in (serial, adaptive):
        eng.submit("hello [TASK: go] world", lane=0)
        eng.run(48)
    assert _streams(adaptive) == _streams(serial)
    assert any(e == "merge" for e, _ in _streams(serial)[2])
    assert max(adaptive.stats["window_hist"]) > 2


def test_max_window_rounds_down_to_a_ladder_rung(weights):
    assert AdaptiveWindow(8, 12).ladder == (8,)
    assert AdaptiveWindow(8, 12).max_window == 8
    assert AdaptiveWindow(4, 17).ladder == (4, 8, 16)
    assert AdaptiveWindow(2, 16).ladder == (2, 4, 8, 16)
    eng = _engine(weights, pipeline=True, sync_every=4, max_window=13)
    assert eng.max_window == 8
    assert eng.state.main_ring.shape[1] == 8  # ring capacity matches
    assert eng.state.main_ring.data_ptr() == eng.state.rings.data_ptr()
    serial = _engine(weights, pipeline=False, sync_every=4, max_window=64)
    assert serial.max_window == 4  # the serial loop keeps its windows pinned


class _NoHostReads:
    """Makes every host read of a tensor raise: ``.item()``, ``.tolist()``,
    ``.cpu()``, ``.numpy()`` and the implicit ones (``bool``, ``int``,
    ``float`` of a tensor). On the card each of them would wait for the
    device."""
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


def test_overlap_region_reads_nothing_from_the_device(weights):
    """With window t's rings fetched and the gate green, dispatching window
    t+1, enqueueing its ring copy and post-processing window t read no
    tensor on the host (the fetch before it is the window's one sync)."""
    eng = _engine(weights, pipeline=True)
    m = eng.submit("host read probe, no tags", lane=0)
    eng.run(8)
    base = dict(eng.stats)
    n_tok = len(m.tokens)
    eng._dispatch_window(4)                  # window t
    rings = eng._fetch_rings()               # the pipeline's sync point
    with _NoHostReads():
        assert eng._gate(rings, 4)
        eng._dispatch_window(4)              # window t+1
        eng._prefetch_rings()
        eng._postprocess(rings, 4, overlapped=True)
    assert len(m.tokens) == n_tok + 4
    assert eng.stats["host_syncs"] == base["host_syncs"] + 1
    rings2 = eng._fetch_rings()              # waits for the prefetched copy
    eng._postprocess(rings2, 4)
    assert len(m.tokens) == n_tok + 8
    assert eng.stats["host_syncs"] == base["host_syncs"] + 2


def test_fetched_rings_survive_the_next_prefetch(weights):
    """The host rings a fetch returns are a copy: the next window's ring
    copy into the same host buffer leaves them as they were."""
    eng = _engine(weights, pipeline=True)
    eng.submit("two windows", lane=0)
    eng._dispatch_window(4)
    eng._prefetch_rings()
    first = eng._fetch_rings()
    kept = first[0].copy()
    eng._dispatch_window(4)
    eng._prefetch_rings()
    second = eng._fetch_rings()
    np.testing.assert_array_equal(first[0], kept)
    assert not np.array_equal(first[0][:, :4], second[0][:, :4])


def test_gate_is_conservative_on_trigger_bytes(weights):
    eng = _engine(weights, pipeline=True)
    eng.submit("x [TASK: go] y", lane=0)
    n0 = eng.stats["host_syncs"]
    eng._dispatch_window(4)
    rings = eng._fetch_rings()
    assert eng.stats["host_syncs"] == n0 + 1
    forged = (rings[0].copy(), rings[1].copy())
    forged[0][0, 1] = ord("[")
    assert not eng._gate(forged, 4)
    forged2 = (rings[0].copy(), rings[1].copy())
    forged2[0][0, 1] = ord("]")
    rid = eng.mains[0].agent_id
    eng.router._tails[rid] = ("... [TA", 0)
    assert eng.router.plausible(rid)
    assert not eng._gate(forged2, 4)
    eng.router._tails[rid] = ("... [TASK: x] b", 0)
    assert not eng.router.plausible(rid)  # closed tail: ']' alone is safe
    side = next(s for s in eng.sides if s.active)
    real_tokens = side.tokens
    try:
        side.tokens = real_tokens + [0] * (eng.side_max_steps + side.prompt_len - len(real_tokens))
        assert not eng._gate(rings, 4)
    finally:
        side.tokens = real_tokens
    eng._postprocess(rings, 4)


def test_mixed_sampling_lanes_inside_adaptive_windows(weights):
    """Greedy river and filtered stochastic streams in one lengthened window:
    every lane's draws equal the serial pinned loop's, bitwise (one draw per
    virtual tick; the sampler flags change only at drains)."""
    kw = dict(side_max_steps=12, side_sampling=SamplingParams(temperature=1.1, top_k=12))
    serial = _engine(weights, pipeline=False, **kw)
    adaptive = _engine(weights, pipeline=True, max_window=16, **kw)
    for eng in (serial, adaptive):
        eng.submit("mixed [TASK: explore] lanes", lane=0)
        eng.run(28)
    assert _streams(adaptive) == _streams(serial)
    side = next(s for s in adaptive.sides if s.tokens)
    assert len(side.tokens) > side.prompt_len
    assert max(adaptive.stats["window_hist"]) > 4
    assert any(e == "merge" for e, _ in _streams(adaptive)[2])


def test_identity_hooks_and_refusals(weights):
    """Agent identities in the registry, the stream tap and the admission
    hook, and the raises where the reference would hibernate."""
    _, _, cfg, params = weights
    eng = CortexEngine(Prism(params, cfg, device="cpu"), ByteTokenizer(cfg.vocab_size), n_main=2,
                       max_side=2, main_capacity=128, inject_tokens=8, theta=-1.0, side_max_steps=6,
                       sampling=SamplingParams(greedy=True), sync_every=4, device="cpu")
    taps, boundaries = [], []
    eng.stream_tap = lambda view, chunk, toks: taps.append((view.agent_id, len(toks)))
    eng.admission_hook = lambda: boundaries.append(eng._pending)
    a = eng.submit_agent("identity probe [TASK: child]", agent_id="alice")
    assert a.lane == 0 and eng.registry.get("alice").lane == 0
    with pytest.raises(ValueError, match="already active"):
        eng.submit("again", lane=1, agent_id="alice")
    b = eng.submit_agent("second agent")
    assert (b.agent_id, b.lane) == ("agent0", 1)
    with pytest.raises(NotImplementedError, match="ROADMAP item 9"):
        eng.submit_agent("no lane left")
    eng.run(16)  # the side is past its 13-token prompt, short of its budget
    assert boundaries and set(boundaries) == {0}  # only with nothing in flight
    assert ("alice", 4) in taps and ("agent0", 4) in taps
    assert any(aid.startswith("side") for aid, _ in taps)
    assert eng.agent_text("alice") == "identity probe [TASK: child]" + eng.tok.decode(a.tokens[a.prompt_len:])
    with pytest.raises(ValueError, match="side streams still target"):
        eng.retire_main(0)
    eng.retire_main(1)
    assert eng.registry.get("agent0").status == "registered"
    assert eng.memory_report()["agents"]["active"] == 2  # alice and her side
    with pytest.raises(NotImplementedError, match="ROADMAP item 9"):
        CortexEngine(eng.prism, eng.tok, hibernate_idle_ticks=4, device="cpu")


def test_spawn_from_a_later_river_lane_hands_contiguous_keys(weights):
    """With several rivers, a parent lane is a strided slice of the batched
    cache; the landmark sweep gets contiguous keys all the same (the CUDA
    kernel refuses strided ones)."""
    from repro_torch.core import synapse as tsynapse

    _, _, cfg, params = weights
    eng = CortexEngine(Prism(params, cfg, device="cpu"), ByteTokenizer(cfg.vocab_size), n_main=2,
                       max_side=2, main_capacity=64, sampling=SamplingParams(greedy=True), device="cpu")
    seen = []
    real = tsynapse.ops.landmark_score

    def checking(q, keys, *a, **k):
        seen.append(keys.is_contiguous() and q.is_contiguous())
        return real(q, keys, *a, **k)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tsynapse.ops, "landmark_score", checking)
        eng.submit("a river on lane one [TASK: child]", lane=1)
    assert seen and all(seen)


# ---------------------------------------------------------------------------
# BatchServer
# ---------------------------------------------------------------------------
REQS = [
    ("first request", 6, SamplingParams(greedy=True)),
    ("second request", 9, SamplingParams(temperature=0.9, top_k=8)),
    ("third request", 5, None),
    ("fourth request", 7, SamplingParams(temperature=1.2, top_p=0.9)),
]


def _server(weights, tok, **kw):
    _, _, cfg, params = weights
    return BatchServer(params, cfg, tok, n_lanes=2, capacity=64, device="cpu", **kw)


def _greedy_eos(weights, cache_kind):
    """A token the reduced model emits greedily mid-stream: with it as the
    EOS id, greedy requests end by surprise, so the pipelined run must roll
    a speculative step back."""
    srv = _server(weights, ByteTokenizer(512), sampling=SamplingParams(greedy=True), cache_kind=cache_kind)
    srv.submit("probe the stream", max_new_tokens=12)
    done = srv.run_until_done(pipeline=False)
    gen = done[0].tokens[done[0].prompt_len:]
    return gen[3]


@pytest.mark.parametrize("cache_kind", ["full", "synapse"])
def test_batchserver_pipeline_matches_serial_through_rollbacks(weights, cache_kind):
    """Pipelined == serial, bitwise, across lane recycling and surprise-EOS
    rollbacks (the undo of the in-place decode step), for both cache kinds."""
    tok = ByteTokenizer(512)
    tok.eos_id = _greedy_eos(weights, cache_kind)
    reqs = REQS + [("probe the stream", 12, SamplingParams(greedy=True)),
                   ("probe the stream", 40, SamplingParams(greedy=True))]
    outs = []
    for pipeline in (True, False):
        srv = _server(weights, tok, sampling=SamplingParams(temperature=1.0), seed=7, cache_kind=cache_kind)
        for prompt, mnt, sp in reqs:
            srv.submit(prompt, max_new_tokens=mnt, sampling=sp)
        done = srv.run_until_done(max_ticks=400, pipeline=pipeline)
        outs.append(sorted((r.rid, tuple(r.tokens), r.text, r.status) for r in done))
        if pipeline:
            assert srv.stats["overlapped"] > 0
            assert srv.stats["rollbacks"] >= 1
            steps = srv.stats["steps"]
        else:
            assert srv.stats["steps"] == steps
    assert outs[0] == outs[1]
    assert len(outs[0]) == len(reqs)


@pytest.mark.parametrize("cache_kind", ["full", "synapse"])
def test_undo_record_restores_the_caches_bitwise(weights, cache_kind):
    """One decode step in place, then its undo: every cache tensor is as it
    was, the k/v/pos slot, the rescaled score row and the cursor included."""
    tok = ByteTokenizer(512)
    srv = _server(weights, tok, sampling=SamplingParams(greedy=True), cache_kind=cache_kind)
    srv.submit("undo probe", max_new_tokens=8)
    srv._admit()
    before = [a.clone() for c in srv.caches.groups for a in tserver.cache_lib.tensors(c)]
    rec = tserver._undo_record(srv.caches)
    srv._step(srv._host_toks())
    after = [a for c in srv.caches.groups for a in tserver.cache_lib.tensors(c)]
    assert any(not torch.equal(a, b) for a, b in zip(before, after))
    tserver._undo(srv.caches, rec)
    for a, b in zip(before, after):
        assert torch.equal(a, b)


def test_batchserver_greedy_streams_equal_reference(weights):
    """Greedy requests on both servers, more requests than lanes: the same
    tokens and texts."""
    jcfg, jp, _, _ = weights
    prompts = [("first request", 10), ("second é∑ request", 14), ("third", 8)]
    ref = JaxServer(jp, jcfg, JaxTokenizer(jcfg.vocab_size), n_lanes=2, capacity=64,
                    sampling=JaxSampling(greedy=True))
    srv = _server(weights, ByteTokenizer(512), sampling=SamplingParams(greedy=True))
    for s in (ref, srv):
        for p, n in prompts:
            s.submit(p, max_new_tokens=n)
    margins = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tserver, "sample_lanes", _recording_margins(margins, tserver.sample_lanes))
        got = {r.rid: (r.tokens, r.text) for r in srv.run_until_done(pipeline=True)}
    assert len(margins) > 30 and min(margins) > MARGIN, min(margins)
    want = {r.rid: (r.tokens, r.text) for r in ref.run_until_done(pipeline=True)}
    assert got == want


def test_recycled_lane_never_inherits_sampling(weights):
    srv = BatchServer(weights[3], weights[2], ByteTokenizer(512), n_lanes=1, capacity=64,
                      sampling=SamplingParams(temperature=1.0), device="cpu")
    srv.submit("greedy req", max_new_tokens=3, sampling=SamplingParams(greedy=True))
    srv.run_until_done(max_ticks=50)
    assert not srv._samp_cache.valid          # completion invalidated
    srv.submit("default req", max_new_tokens=3)
    srv._admit()
    lanes_samp, use_filters, any_greedy = srv._samp_cache.get(srv._lane_params)
    assert float(lanes_samp.temperature[0]) == 1.0  # NOT the greedy 0.0
    assert not any_greedy and not use_filters
    rid = srv.lanes[0].rid
    assert srv.cancel(rid)
    assert not srv._samp_cache.valid
    assert srv.cancel(rid) is False


def _support(row, p: SamplingParams) -> set:
    """The ids the reference's ``sample`` can draw for one logit row."""
    if p.greedy or p.temperature <= 0:
        return {int(np.argmax(row))}
    x = row.astype(np.float64) / p.temperature
    if p.top_k > 0:
        x = np.where(x < np.sort(x)[::-1][p.top_k - 1], -np.inf, x)
    if p.top_p < 1.0:
        srt = np.sort(x)[::-1]
        prob = np.exp(srt - srt.max()) / np.exp(srt - srt.max()).sum()
        cutoff = srt[min(int((np.cumsum(prob) < p.top_p).sum()), len(srt) - 1)]
        x = np.where(x < cutoff, -np.inf, x)
    return set(np.flatnonzero(np.isfinite(x)).tolist())


@pytest.mark.parametrize("params", [
    dict(greedy=True), dict(temperature=0.7), dict(temperature=1.0, top_k=3),
    dict(temperature=1.3, top_p=0.5), dict(temperature=0.9, top_k=5, top_p=0.6),
], ids=["greedy", "temperature", "top_k", "top_p", "top_k_top_p"])
def test_sample_draws_from_the_reference_support(params):
    """The static-parameter sampler: greedy is the exact argmax; otherwise
    the draws stay in the set the reference's sampler draws from, repeat
    under a fixed generator, and the stacked lane tensors equal the
    reference's."""
    from repro.serving.sampler import sample as jax_sample
    from repro.serving.sampler import stack_lane_params as jax_stack
    from repro_torch.serving.sampler import sample, stack_lane_params

    logits = np.random.default_rng(0).standard_normal((3, 40), dtype=np.float32) * 3
    draw = lambda seed: np.stack([sample(g, torch.from_numpy(logits), SamplingParams(**params)).numpy()
                                  for g in [torch.Generator().manual_seed(seed)] for _ in range(150)])
    got = draw(0)
    np.testing.assert_array_equal(got, draw(0))
    ref = np.stack([np.asarray(jax_sample(jax.random.key(i), jax.numpy.asarray(logits), JaxSampling(**params)))
                    for i in range(150)])
    for row in range(3):
        support = _support(logits[row], SamplingParams(**params))
        assert set(got[:, row]) <= support and set(ref[:, row]) <= support
        if len(support) > 1:
            assert len(set(got[:, row])) > 1  # a draw, not a fixed pick
    lanes = stack_lane_params([SamplingParams(**params), SamplingParams()], device="cpu")
    jlanes = jax_stack([JaxSampling(**params), JaxSampling()])
    for name in ("temperature", "top_k", "top_p"):
        np.testing.assert_array_equal(getattr(lanes, name).numpy(), np.asarray(getattr(jlanes, name)))


# ---------------------------------------------------------------------------
# the router (tests/test_router.py against the port's copy)
# ---------------------------------------------------------------------------
TEXT = "pre amble [TASK: alpha beta] mid [DONE] post [ANSWER: gamma] end"


def _kinds(triggers):
    return [(t.kind, t.payload) for t in triggers]


def _router_every_offset():
    whole = CortexRouter().feed("ref", TEXT)
    assert _kinds(whole) == [("task", "alpha beta"), ("done", ""), ("answer", "gamma")]
    spans = [t.span for t in whole]
    assert spans[0] == (TEXT.index("["), TEXT.index("]") + 1)
    for cut in range(len(TEXT) + 1):
        r = CortexRouter(tail=64)
        got = r.feed("a", TEXT[:cut]) + r.feed("a", TEXT[cut:])
        assert _kinds(got) == _kinds(whole) and [t.span for t in got] == spans, cut


def _router_three_way():
    for c1 in (5, 12, 20):
        for c2 in (c1, c1 + 7, 40):
            r = CortexRouter(tail=64)
            got = (r.feed("a", TEXT[:c1]) + r.feed("a", "") + r.feed("a", TEXT[c1:c2])
                   + r.feed("a", TEXT[c2:]))
            assert _kinds(got) == _kinds(CortexRouter().feed("ref2", TEXT))


def _router_feed_scan():
    r = CortexRouter(tail=64)
    assert _kinds(r.feed("a", TEXT[:30])) == [("task", "alpha beta")]
    assert _kinds(r.scan("a", TEXT)) == [("done", ""), ("answer", "gamma")]
    assert r.scan("a", TEXT) == []
    assert r.feed("a", " [DONE]")[0].kind == "done"


def _router_tag_longer_than_tail():
    tag = f"[TASK: {'x' * 40}]"
    cut = len(tag) // 2
    r = CortexRouter(tail=8)
    assert r.feed("a", tag[:cut]) + r.feed("a", tag[cut:]) == []  # the documented miss
    r2 = CortexRouter(tail=len(tag))
    assert _kinds(r2.feed("a", tag[:cut]) + r2.feed("a", tag[cut:])) == [("task", "x" * 40)]


def _router_plausible():
    r = CortexRouter(tail=64)
    assert not r.plausible("a")
    r.feed("a", "calm text, no brackets")
    assert not r.plausible("a")
    r.feed("a", " now an open [TA")
    assert r.plausible("a")
    assert _kinds(r.feed("a", "SK: finish] done")) == [("task", "finish")]
    assert not r.plausible("a")
    r.feed("a", " stray ] then [ again")
    assert r.plausible("a")
    r.reset("a")
    assert not r.plausible("a")


def _router_spans_absolute():
    r = CortexRouter(tail=16)
    r.feed("a", "x" * 100)
    assert r.feed("a", "[DONE]")[0].span == (100, 106)
    assert r.feed("a", "y" * 3 + "[DONE]")[0].span == (109, 115)


ROUTER_CASES = {
    "every_offset": _router_every_offset, "three_way_and_empty": _router_three_way,
    "feed_scan_dedup": _router_feed_scan, "tag_longer_than_tail": _router_tag_longer_than_tail,
    "plausible": _router_plausible, "spans_absolute": _router_spans_absolute,
}


@pytest.mark.parametrize("case", sorted(ROUTER_CASES) + ["engine_tail_size"])
def test_router_contract(weights, case):
    if case != "engine_tail_size":
        ROUTER_CASES[case]()
        return
    # the engine sizes the tail for its longest tag and a max_window drain
    _, _, cfg, params = weights
    for sync_every, max_window, cap in ((1, None, 64), (8, 64, 64), (4, 16, 200)):
        eng = CortexEngine(Prism(params, cfg, device="cpu"), ByteTokenizer(cfg.vocab_size), n_main=1,
                           max_side=1, sync_every=sync_every, max_window=max_window,
                           side_prompt_cap=cap, main_capacity=32, device="cpu")
        assert eng.router._tail >= len("[TASK: ]") + cap
        assert eng.router._tail >= 8 * eng.max_window
        assert eng.router._tail >= 256
        assert eng.state.rings.shape[1] == eng.max_window
