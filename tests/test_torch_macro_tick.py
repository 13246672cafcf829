"""Macro windows of the port's engine (``CortexEngine.run`` against a loop
of single ticks) on the reduced Qwen2.5-0.5B in f32: the ten cases of
``tests/test_macro_tick.py``, and one fixed example held against the JAX
engine.

Ported cases:

* ``test_macro_matches_single_tick_bitwise``,
  ``test_macro_dispatch_count_is_amortized``,
  ``test_dispatch_count_is_ceil_for_partial_windows``;
* ``test_macro_donation_no_peak_memory_growth``: JAX donates the tick state
  to the scanned dispatch; the port writes in place, so here every cache
  tensor's ``data_ptr()`` is the same before and after a window, and the
  memory report equals the single-tick engine's and stays put. On the card
  ``tests/test_torch_cuda.py::test_macro_window_has_no_peak_memory_growth``
  holds ``torch.cuda.max_memory_allocated`` over a window;
* ``test_zero_host_syncs_inside_macro_window``: a window dispatched under a
  guard that makes every host read of a tensor raise, in place of
  ``jax.transfer_guard("disallow")`` (the card's
  ``set_sync_debug_mode("error")`` guard is in ``tests/test_torch_cuda.py``);
* ``test_greedy_lane_unaffected_by_other_lanes_params``,
  ``test_temperature_zero_reduces_to_argmax``, ``test_sample_lanes_units``,
  ``test_top_p_nests_inside_top_k``;
* ``test_property_macro_equals_single_tick``: port against port, bitwise,
  hypothesis with 5 examples;

and ``test_macro_run_equals_the_reference_engine``: the ``pair`` workload's
macro run against the JAX engine's on bridged weights. Greedy tokens are
held equal only where every sampled greedy lane's top-2 logit margin
exceeds 1e-4, the logit tolerance of ``tests/test_torch_model.py``
(ROADMAP, "Parity tolerances"); the merges' gate scores within 1e-4.
"""
import dataclasses
import math

import jax
import numpy as np
import pytest
import torch
from conftest import hypothesis_tools
from test_torch_pipeline import _NoHostReads
from test_torch_families import _one_torch_thread  # noqa: F401 (autouse: one intra-op thread)

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
from repro_torch.serving.sampler import SamplingParams, sample_lanes, stack_lane_params

MARGIN = 1e-4
PAIR = dict(sync_every=4, max_side=2, theta=-1.0, side_max_steps=6)
PAIR_PROMPT = "hello [TASK: go] world"


@pytest.fixture(scope="module")
def setup():
    jcfg = dataclasses.replace(jax_get_config("qwen2.5-0.5b", reduced=True), compute_dtype="float32")
    cfg = dataclasses.replace(get_config("qwen2.5-0.5b", reduced=True), compute_dtype="float32")
    jp = jax.jit(lambda k: jmodel.init_params(k, jcfg))(jax.random.key(0))
    return cfg, bridge.params_from_jax(jax.tree.map(np.asarray, jp), cfg, "cpu"), jcfg, jp


def _engine(setup, *, sync_every=4, max_side=2, theta=2.0, side_max_steps=6,
            sampling=SamplingParams(greedy=True), side_sampling=None):
    cfg, params = setup[:2]
    return CortexEngine(Prism(params, cfg, device="cpu"), ByteTokenizer(cfg.vocab_size), n_main=1,
                        max_side=max_side, main_capacity=128, side_max_steps=side_max_steps, inject_tokens=8,
                        theta=theta, sampling=sampling, side_sampling=side_sampling, sync_every=sync_every,
                        device="cpu")


def _run_single_tick(eng, n):
    for _ in range(n):
        eng.tick()
    eng.drain()


def _record_margins(eng, margins):
    """Wrap the engine module's sampler: the top-2 logit margin of every
    greedy sample that lands in a ring (live rivers, sides past their forced
    prompt). Returns the undo."""
    real, mp = tengine.sample_lanes, pytest.MonkeyPatch()

    def recording(gen, logits, lanes, **kw):
        st = eng.state
        kept = [st.main_active]
        if logits.shape[0] > st.main_active.shape[0]:
            kept.append(st.side_active & (st.side_step >= st.side_plen - 1))
        top2 = torch.topk(logits, 2, dim=-1).values
        margins.extend((top2[:, 0] - top2[:, 1])[torch.cat(kept)].tolist())
        return real(gen, logits, lanes, **kw)

    mp.setattr(tengine, "sample_lanes", recording)
    return mp.undo


@pytest.fixture(scope="module")
def pair(setup):
    """One spawn/merge workload on the macro path and on the single-tick
    path (theta = -1 accepts the merges, so side thoughts change the river's
    cache mid-run), with the macro run's greedy margins."""
    macro, single = _engine(setup, **PAIR), _engine(setup, **PAIR)
    macro.submit(PAIR_PROMPT, lane=0)
    single.submit(PAIR_PROMPT, lane=0)
    base = dict(macro.stats)
    ptrs = [t.data_ptr() for t in macro.state.main_caches.tensors() + macro.state.side_caches.tensors()]
    margins = []
    undo = _record_margins(macro, margins)
    try:
        macro.run(24)
    finally:
        undo()
    _run_single_tick(single, 24)
    # the macro run as it stood after 24 ticks (later cases run it on)
    after = {"streams": [list(v.tokens) for v in macro.mains + macro.sides], "history": list(macro.history),
             "stats": {k: macro.stats[k] - base[k] for k in ("ticks", "tick_dispatches", "macro_dispatches",
                                                             "drains")}}
    return macro, single, base, ptrs, margins, after


def test_macro_matches_single_tick_bitwise(pair):
    single, after = pair[1], pair[5]
    assert after["streams"] == [list(v.tokens) for v in single.mains + single.sides]
    assert [(e["event"], e.get("accepted")) for e in after["history"]] == \
           [(e["event"], e.get("accepted")) for e in single.history]
    assert any(e["event"] == "merge" for e in after["history"])


def test_macro_dispatch_count_is_amortized(pair):
    # 24 ticks at sync_every = 4: six windows, against twenty-four
    assert pair[5]["stats"] == {"ticks": 24, "tick_dispatches": 24 // 4, "macro_dispatches": 24 // 4,
                                "drains": 24 // 4}


def test_macro_donation_no_peak_memory_growth(pair):
    """Windows write the caches in place (the port's counterpart of the
    reference's donation): the same storage before and after, the single-
    tick engine's memory report, and no growth over more windows."""
    macro, single, _, ptrs = pair[:4]
    tensors = macro.state.main_caches.tensors() + macro.state.side_caches.tensors()
    assert [t.data_ptr() for t in tensors] == ptrs
    rep_m, rep_s = macro.memory_report(), single.memory_report()
    assert rep_m["total_bytes"] == rep_s["total_bytes"]
    assert rep_m["n_agents"] == rep_s["n_agents"]
    macro.run(8)
    assert [t.data_ptr() for t in tensors] == ptrs
    assert macro.memory_report()["total_bytes"] == rep_m["total_bytes"]


def test_macro_run_equals_the_reference_engine(setup, pair):
    """The pair's macro run against the JAX engine's on the same weights and
    prompt: greedy streams, spawns and merges, and the dispatch accounting."""
    margins, after = pair[4:]
    _, _, jcfg, jp = setup
    ref = JaxEngine(JaxPrism(jp, jcfg), JaxTokenizer(jcfg.vocab_size), n_main=1, main_capacity=128,
                    inject_tokens=8, sampling=JaxSampling(greedy=True), **PAIR)
    ref.submit(PAIR_PROMPT, lane=0)
    ref.run(24)
    assert len(margins) > 20 and min(margins) > MARGIN, f"near-tie: min top-2 margin {min(margins):.3g}"
    assert after["streams"] == [list(v.tokens) for v in ref.mains + ref.sides]
    assert [(e["event"], e["agent"], e.get("accepted")) for e in after["history"]] == \
           [(e["event"], e["agent"], e.get("accepted")) for e in ref.history]
    for a, b in zip(ref.history, after["history"]):
        if a["event"] == "merge":
            assert abs(a["gate_score"] - b["gate_score"]) < 1e-4
    assert after["stats"] == {k: ref.stats[k] for k in after["stats"]}


def test_dispatch_count_is_ceil_for_partial_windows(setup):
    eng = _engine(setup, sync_every=4, max_side=1)
    eng.submit("ceil probe", lane=0)
    for n in (8, 7, 3, 1):
        base = eng.stats["tick_dispatches"]
        eng.run(n)  # starts and ends on a drain boundary
        assert eng.stats["tick_dispatches"] - base == math.ceil(n / 4), n


def test_zero_host_syncs_inside_macro_window(setup):
    """A whole window dispatches with no host read; only the drain reads."""
    eng = _engine(setup, sync_every=4, max_side=1)
    m = eng.submit("transfer guard probe", lane=0)
    eng.run(8)
    base, n_tok = dict(eng.stats), len(m.tokens)
    with _NoHostReads():
        eng._dispatch_window(eng.sync_every)
    assert eng.stats["tick_dispatches"] - base["tick_dispatches"] == 1
    assert eng.stats["macro_dispatches"] - base["macro_dispatches"] == 1
    assert eng.stats["host_syncs"] == base["host_syncs"]
    assert eng.stats["drains"] == base["drains"]
    eng.drain()  # one copy of the rings closes the window
    assert eng.stats["host_syncs"] == base["host_syncs"] + 1
    assert len(m.tokens) == n_tok + eng.sync_every


def test_greedy_lane_unaffected_by_other_lanes_params(setup):
    """The greedy river's stream does not move with the side lanes'
    exploration parameters (same generator seed)."""
    streams = []
    for side_sampling in (SamplingParams(temperature=0.9, top_k=8), SamplingParams(temperature=1.4, top_p=0.8)):
        eng = _engine(setup, sync_every=4, max_side=1, side_sampling=side_sampling, side_max_steps=64)
        m = eng.submit("probe [TASK: explore] x", lane=0)
        eng.run(12)
        assert any(s.active for s in eng.sides)  # the stochastic lane ran
        streams.append(list(m.tokens))
    assert streams[0] == streams[1]


def test_temperature_zero_reduces_to_argmax(setup, pair):
    """temperature = 0 equals greedy=True token for token on the pair's
    workload."""
    single = pair[1]
    eng = _engine(setup, **PAIR, sampling=SamplingParams(temperature=0.0))
    eng.submit(PAIR_PROMPT, lane=0)
    eng.run(24)
    assert eng.mains[0].tokens == single.mains[0].tokens


def _argmax_rows(seed, b, v):
    logits = np.random.default_rng(seed).standard_normal((b, v), dtype=np.float32)
    return torch.from_numpy(logits), torch.from_numpy(np.argmax(logits, axis=-1))


def test_sample_lanes_units():
    """Greedy and top-k = 1 lanes are the argmax; a nucleus so tight only
    the top token survives is the argmax; lane parameters are independent."""
    logits, am = _argmax_rows(1, 3, 97)
    gen = lambda: torch.Generator().manual_seed(2)
    stack = lambda ps: stack_lane_params(ps, device="cpu")
    t = sample_lanes(gen(), logits, stack([SamplingParams(temperature=0.0), SamplingParams(temperature=1.0, top_k=1),
                                           SamplingParams(temperature=1.2, top_p=0.85)]))
    assert int(t[0]) == int(am[0]) and int(t[1]) == int(am[1])
    t2 = sample_lanes(gen(), logits, stack([SamplingParams(greedy=True), SamplingParams(temperature=0.7),
                                            SamplingParams(temperature=0.3, top_k=5)]))
    assert int(t2[0]) == int(am[0])
    t3 = sample_lanes(gen(), logits, stack([SamplingParams(temperature=1.0, top_p=1e-6)] * 3))
    np.testing.assert_array_equal(t3.numpy(), am.numpy())


def test_top_p_nests_inside_top_k():
    """The nucleus is taken from the renormalised post-top-k distribution:
    [0.4, 0.3, 0.3] under top_k = 2 is [0.571, 0.429], and top_p = 0.5 then
    keeps only the top token."""
    logits = torch.log(torch.tensor([[0.4, 0.3, 0.3]] * 2))
    lanes = stack_lane_params([SamplingParams(temperature=1.0, top_k=2, top_p=0.5)] * 2, device="cpu")
    for seed in range(8):
        t = sample_lanes(torch.Generator().manual_seed(seed), logits, lanes)
        np.testing.assert_array_equal(t.numpy(), np.zeros(2, np.int32))


given, settings, st = hypothesis_tools()

_PROP = {}  # (id(setup), sync_every, kind) -> engine, reused across examples


def _prop_engine(setup, sync_every, kind):
    key = (id(setup), sync_every, kind)
    if key not in _PROP:
        _PROP[key] = _engine(setup, sync_every=sync_every, max_side=2, theta=-1.0, side_max_steps=4)
    eng = _PROP[key]
    for s in eng.sides:  # clear the streams the previous example left
        if s.active:
            eng.retire_side(s.lane)
    return eng


@settings(max_examples=5, deadline=None)
@given(
    prompt=st.text(alphabet="abcdef ", min_size=1, max_size=12),
    with_task=st.booleans(),
    sync_every=st.sampled_from([1, 2, 4, 8]),
    n_windows=st.integers(min_value=1, max_value=2),
    extra=st.integers(min_value=0, max_value=1),
)
def test_property_macro_equals_single_tick(setup, prompt, with_task, sync_every, n_windows, extra):
    """Random prompts, windows and spawn/merge interleavings: macro windows
    equal single ticks token for token on greedy lanes, partial trailing
    windows included."""
    text = prompt + (" [TASK: check] tail" if with_task else "")
    n = n_windows * sync_every + extra
    macro, single = _prop_engine(setup, sync_every, "macro"), _prop_engine(setup, sync_every, "single")
    mm, ms = macro.submit(text, lane=0), single.submit(text, lane=0)
    base = macro.stats["tick_dispatches"]
    macro.run(n)
    _run_single_tick(single, n)
    assert mm.tokens == ms.tokens
    for sm, ss in zip(macro.sides, single.sides):
        assert sm.tokens == ss.tokens
    assert macro.stats["tick_dispatches"] - base == math.ceil(n / sync_every)
