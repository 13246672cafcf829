"""The port's CortexEngine against the JAX package's (serial loop,
``pipeline=False``) with bridged weights, on the reduced Qwen2.5-0.5B:
greedy river and side token streams, the spawn/merge history and the
dispatch/sync accounting are equal.

Greedy equality is only meaningful where no step sits on a near-tie, so the
run records the top-2 logit margin of every sampled greedy lane and holds
it above MARGIN, the logit tolerance of tests/test_torch_model.py (1e-4).
The port's logits agree with the reference's to ~2e-6 there, so the
reference's margin clears the tolerance too (the smallest margin of this
seed and prompt is ~2.8e-4). If it shrinks, the test fails rather than
loosening.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core.engine import CortexEngine as JaxEngine
from repro.core.prism import Prism as JaxPrism
from repro.data.tokenizer import ByteTokenizer as JaxTokenizer
from repro.models import model as jmodel
from repro.serving.sampler import LaneSampling as JaxLanes
from repro.serving.sampler import SamplingParams as JaxSampling
from repro.serving.sampler import sample_lanes as jax_sample_lanes
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.core import engine as tengine
from repro_torch.core.engine import CortexEngine
from repro_torch.core.prism import Prism
from repro_torch.data.tokenizer import ByteTokenizer
from repro_torch.models import model as tmodel
from repro_torch.serving.sampler import LaneSampling, SamplingParams, sample_lanes

MARGIN = 1e-4
GATE_TOL = 1e-4
KW = dict(n_main=2, max_side=2, main_capacity=256, side_max_steps=6, inject_tokens=8,
          theta=-1.0, sync_every=4)
PROMPTS = ["hello [TASK: verify this claim] world", "plain agent [TASK: second one]"]
N_TICKS = 30


@pytest.fixture(scope="module")
def weights():
    jcfg = jax_get_config("qwen2.5-0.5b", reduced=True)
    jp = jmodel.init_params(jax.random.key(0), jcfg)
    cfg = get_config("qwen2.5-0.5b", reduced=True)
    return jcfg, jp, cfg, bridge.params_from_jax(jax.tree.map(np.asarray, jp), cfg, "cpu")


@pytest.fixture(scope="module")
def reference(weights):
    jcfg, jp, _, _ = weights
    eng = JaxEngine(JaxPrism(jp, jcfg), JaxTokenizer(jcfg.vocab_size),
                    sampling=JaxSampling(greedy=True), pipeline=False, **KW)
    for lane, p in enumerate(PROMPTS):
        eng.submit(p, lane=lane)
    eng.run(N_TICKS)
    return eng


@pytest.fixture(scope="module")
def port(weights):
    """The port's run, recording the top-2 margin of every greedy sample
    that lands in a ring (active rivers, sides past their forced prompt)."""
    _, _, cfg, params = weights
    eng = CortexEngine(Prism(params, cfg, device="cpu"), ByteTokenizer(cfg.vocab_size),
                       sampling=SamplingParams(greedy=True), pipeline=False, device="cpu", **KW)
    margins = []
    real = tengine.sample_lanes

    def recording(gen, logits, lanes, **kw):
        st = eng.state
        kept = [st.main_active]
        if logits.shape[0] > st.main_active.shape[0]:
            kept.append(st.side_active & (st.side_step >= st.side_plen - 1))
        top2 = torch.topk(logits, 2, dim=-1).values
        margins.extend((top2[:, 0] - top2[:, 1])[torch.cat(kept)].tolist())
        return real(gen, logits, lanes, **kw)

    mp = pytest.MonkeyPatch()
    mp.setattr(tengine, "sample_lanes", recording)
    try:
        for lane, p in enumerate(PROMPTS):
            eng.submit(p, lane=lane)
        eng.run(N_TICKS)
    finally:
        mp.undo()
    return eng, margins


def test_greedy_margins_clear_the_tolerance(port):
    _, margins = port
    assert len(margins) > 50
    assert min(margins) > MARGIN, f"near-tie: min top-2 margin {min(margins):.3g}"


@pytest.mark.parametrize("kind", ["main", "side"])
def test_token_streams_equal(reference, port, kind):
    eng, _ = port
    ref_views = reference.mains if kind == "main" else reference.sides
    views = eng.mains if kind == "main" else eng.sides
    for a, b in zip(ref_views, views):
        assert b.tokens == a.tokens, a.agent_id
        assert b.text == a.text
        assert (b.active, b.position, b.steps) == (a.active, a.position, a.steps)
    assert sum(len(v.tokens) for v in views) > 40


def test_spawn_merge_history_equal(reference, port):
    eng, _ = port
    ref, got = reference.history, eng.history
    assert [e["event"] for e in ref].count("merge") >= 2
    assert [(e["event"], e["agent"]) for e in got] == [(e["event"], e["agent"]) for e in ref]
    for a, b in zip(ref, got):
        if a["event"] == "merge":
            assert b["accepted"] == a["accepted"] and b["thought"] == a["thought"]
            assert abs(b["gate_score"] - a["gate_score"]) < GATE_TOL
        else:
            assert b == a


def test_dispatch_and_sync_accounting_equal(reference, port):
    eng, _ = port
    for key, val in eng.stats.items():
        assert val == reference.stats[key], key
    assert eng.stats["tick_dispatches"] == -(-N_TICKS // KW["sync_every"])


def test_main_caches_agree_after_run(reference, port):
    eng, _ = port
    ref = jax.tree.map(np.asarray, reference.state.main_caches)
    for jc, tc in zip(ref.groups, eng.state.main_caches.groups):
        for name, a in bridge.cache_to_numpy(tc).items():
            b = getattr(jc, name)
            if np.issubdtype(b.dtype, np.integer):
                np.testing.assert_array_equal(a, b, err_msg=name)
            else:
                np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4, err_msg=name)


def test_memory_report_counts_weights_once(port):
    eng, _ = port
    eng.submit("one more [TASK: probe] agent", lane=0)
    rep = eng.memory_report()
    assert rep["weight_bytes"] == sum(t.numel() * t.element_size() for t in tmodel.tree_leaves(eng.prism.params))
    assert rep["n_agents"] == 3  # two rivers and the fresh side
    side = next(s for s in eng.sides if s.active)
    assert rep["per_agent_bytes"][side.agent_id] < 0.2 * rep["weight_bytes"]
    assert eng.prism.n_agents == 3
    assert eng.prism.acquire("probe") is eng.prism.params


def test_retire_side_and_main(port):
    eng, _ = port
    side = next(s for s in eng.sides if s.active)
    with pytest.raises(ValueError):
        eng.retire_main(side.parent_lane)
    eng.retire_side(side.lane)
    assert not bool(eng.state.side_active[side.lane])
    eng.retire_main(side.parent_lane)
    assert not bool(eng.state.main_active[side.parent_lane])
    assert [e["event"] for e in eng.history[-2:]] == ["retire", "retire"]


def test_stochastic_lanes_are_deterministic_under_a_seed(weights):
    """The reference's key chain cannot be replayed: a fixed generator seed
    gives the same stream twice, and other seeds other streams."""
    _, _, cfg, params = weights

    def run(seed):
        eng = CortexEngine(Prism(params, cfg, device="cpu"), ByteTokenizer(cfg.vocab_size),
                           sampling=SamplingParams(temperature=1.0, top_k=40, top_p=0.9),
                           device="cpu", seed=seed, n_main=1, max_side=1, main_capacity=64, sync_every=4)
        eng.submit("stochastic", lane=0)
        eng.run(8)
        return eng.mains[0].tokens

    assert run(1) == run(1)
    assert len({tuple(run(s)) for s in (1, 2, 3)}) > 1


def test_sample_lanes_support_matches_reference():
    """Per lane: greedy is the exact argmax; top-k and top-p draws stay in
    the candidate set the reference's sampler draws from."""
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((4, 50), dtype=np.float32) * 3
    temp = np.array([0.0, 1.0, 1.0, 0.7], np.float32)
    top_k = np.array([0, 3, 0, 5], np.int32)
    top_p = np.array([1.0, 1.0, 1e-4, 0.5], np.float32)
    lanes = LaneSampling(*map(torch.from_numpy, (temp, top_k, top_p)))
    jlanes = JaxLanes(*map(jax.numpy.asarray, (temp, top_k, top_p)))
    gen = torch.Generator().manual_seed(0)
    got = np.stack([sample_lanes(gen, torch.from_numpy(logits), lanes).numpy() for _ in range(200)])
    ref = np.stack([np.asarray(jax_sample_lanes(jax.random.key(i), jax.numpy.asarray(logits), jlanes))
                    for i in range(200)])
    order = np.argsort(-logits, axis=-1)
    assert (got[:, 0] == order[0, 0]).all() and (ref[:, 0] == order[0, 0]).all()
    assert set(got[:, 1]) <= set(order[1, :3]) and len(set(got[:, 1])) > 1
    assert set(ref[:, 1]) <= set(order[1, :3])
    assert (got[:, 2] == order[2, 0]).all() and (ref[:, 2] == order[2, 0]).all()  # tiny nucleus: top token
    # lane 3: the top-p nucleus of the renormalised top-5 at temperature 0.7
    top5 = np.sort(logits[3] / 0.7)[::-1][:5]
    p = np.exp(top5 - top5.max()) / np.exp(top5 - top5.max()).sum()
    nucleus = set(order[3, :5][(np.cumsum(p) - p) < 0.5])
    assert set(got[:, 3]) <= nucleus and set(ref[:, 3]) <= nucleus
    gen2 = torch.Generator().manual_seed(0)
    again = np.stack([sample_lanes(gen2, torch.from_numpy(logits), lanes).numpy() for _ in range(200)])
    np.testing.assert_array_equal(got, again)
