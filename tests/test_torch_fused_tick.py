"""The port's fused engine tick (``CortexEngine`` on the reduced
Qwen2.5-0.5B in f32): six of the seven cases of ``tests/test_fused_tick.py``.

Ported cases:

* ``test_fused_tick_matches_legacy_main_decode`` and
  ``test_fused_tick_matches_legacy_side_decode``: the greedy river and side
  streams equal the port's own prefill + per-step ``decode_step`` chain
  (the side's over its spawn-time synapse snapshot), the river's cache
  prefix within 1e-5;
* ``test_drain_cadence_is_invisible_greedy``;
* ``test_tick_is_one_dispatch_zero_syncs``: ``stats["tick_dispatches"]``
  and ``stats["host_syncs"]``, with the reference's
  ``jax.transfer_guard("disallow")`` replaced by a guard that makes every
  host read of a tensor raise (``test_torch_pipeline._NoHostReads``); on the
  card ``tests/test_torch_cuda.py::test_ticks_inside_a_window_make_no_host_sync``
  runs the same ticks under ``set_sync_debug_mode("error")``;
* ``test_lifecycle_with_batched_drain``;
* ``test_router_feed_incremental_exactly_once``.

* ``test_synapse_decode_pallas_matches_piece``: the fused attend
  (``attend_impl="kernel"``, the reference's ``"pallas"``) and
  ``piece_attend`` give the same decode output, cache update and landmark
  mass (bitwise in the port: both are one ``synapse_attention`` call), and
  the reference's ``"piece"`` decode on the same numpy inputs within 1e-5.

The engine's streams against the JAX engine's are held by
``tests/test_torch_engine.py``; these cases hold the tick against the
port's per-step functions, as the reference's do.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_pipeline import _NoHostReads
from test_torch_families import _one_torch_thread  # noqa: F401 (autouse: one intra-op thread)

from repro.configs import get_config as jax_get_config
from repro.core import synapse as jsynapse
from repro.models import attention as jattention
from repro.models import cache as jcache
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.core import synapse as tsynapse
from repro_torch.core.engine import CortexEngine
from repro_torch.core.prism import Prism
from repro_torch.core.router import CortexRouter
from repro_torch.data.tokenizer import ByteTokenizer
from repro_torch.models import cache as tcache
from repro_torch.models import model as tmodel
from repro_torch.serving.sampler import SamplingParams


@pytest.fixture(scope="module")
def setup():
    cfg = dataclasses.replace(get_config("qwen2.5-0.5b", reduced=True), compute_dtype="float32")
    return cfg, tmodel.init_params(cfg, seed=0, device="cpu")


def _engine(cfg, params, *, sync_every=1, max_side=1, theta=2.0, side_max_steps=64):
    return CortexEngine(Prism(params, cfg, device="cpu"), ByteTokenizer(cfg.vocab_size), n_main=1,
                        max_side=max_side, main_capacity=128, side_max_steps=side_max_steps, inject_tokens=8,
                        theta=theta, sampling=SamplingParams(greedy=True), sync_every=sync_every, device="cpu")


def _step(params, cfg, caches, spec, tok, pos):
    logits, _, caches = tmodel.decode_step(
        params, cfg, {"tokens": torch.tensor([tok], dtype=torch.int32),
                      "positions": torch.tensor([pos], dtype=torch.int32)}, caches, spec=spec)
    return int(torch.argmax(logits[0])), caches


def test_fused_tick_matches_legacy_main_decode(setup):
    """The greedy river == prefill + a per-step decode_step chain, cache
    included."""
    cfg, params = setup
    eng = _engine(cfg, params, sync_every=4)
    m = eng.submit("the quick brown fox", lane=0)
    ids, n = list(m.tokens), 8
    eng.run(n)

    spec = tmodel.CacheSpec(kind="full", capacity=128)
    caches = tmodel.init_caches(cfg, 1, spec, device="cpu")
    _, _, caches = tmodel.prefill(params, cfg, {"tokens": torch.tensor([ids], dtype=torch.int32)}, caches,
                                  spec=spec)
    ref, pos = list(ids), len(ids)
    for _ in range(n):
        tok, caches = _step(params, cfg, caches, spec, ref[-1], pos)
        ref.append(tok)
        pos += 1
    assert m.tokens == ref
    got, want = eng.state.main_caches.groups[0], caches.groups[0]
    length = int(want.length[0, 0])
    assert int(got.length[0, 0]) == length
    torch.testing.assert_close(got.k[:, :, :length], want.k[:, :, :length], rtol=1e-5, atol=1e-5)


def test_drain_cadence_is_invisible_greedy(setup):
    """sync_every 1 and 4 give the same river stream."""
    cfg, params = setup
    outs = []
    for sync_every in (1, 4):
        eng = _engine(cfg, params, sync_every=sync_every)
        m = eng.submit("parity probe", lane=0)
        eng.run(8)
        outs.append(list(m.tokens))
    assert outs[0] == outs[1]


def test_fused_tick_matches_legacy_side_decode(setup):
    """The side stream (its task prompt teacher-forced, then greedy) ==
    a decode_step chain over the spawn-time synapse snapshot."""
    cfg, params = setup
    eng = _engine(cfg, params, sync_every=1, side_max_steps=64)
    eng.submit("context context [TASK: think hard] tail", lane=0)
    s = next(s for s in eng.sides if s.active)
    # a copy: the engine's ticks write the live caches in place
    caches = eng.state.side_caches.map(lambda c: tcache.map_cache(torch.clone, c))
    prompt_ids, pos0 = list(s.tokens), s.position
    plen, n = len(prompt_ids), len(prompt_ids) + 6  # teacher forcing and free generation
    eng.run(n)

    generated, last = [], prompt_ids[-1]
    for t in range(n):
        tok, caches = _step(params, cfg, caches, eng.side_spec, prompt_ids[t] if t < plen else last, pos0 + t)
        if t >= plen - 1:
            generated.append(tok)
            last = tok
    assert len(s.tokens) > plen
    assert s.tokens[plen:] == generated[:len(s.tokens) - plen]


def test_tick_is_one_dispatch_zero_syncs(setup):
    """With sync_every > 1 a tick is one dispatch with no host read; the
    window's last tick drains, the one host sync."""
    cfg, params = setup
    eng = _engine(cfg, params, sync_every=4)
    eng.submit("dispatch counting", lane=0)
    for _ in range(4):
        eng.tick()
    base = dict(eng.stats)
    with _NoHostReads():
        for _ in range(3):  # ticks 1..3 of a window: no drain
            eng.tick()
    assert eng.stats["tick_dispatches"] - base["tick_dispatches"] == 3
    for key in ("host_syncs", "drains", "aux_dispatches"):
        assert eng.stats[key] == base[key], key
    eng.tick()  # the 4th tick closes the window
    assert eng.stats["tick_dispatches"] - base["tick_dispatches"] == 4
    assert eng.stats["drains"] == base["drains"] + 1
    assert eng.stats["host_syncs"] == base["host_syncs"] + 1


def test_lifecycle_with_batched_drain(setup):
    """A spawn and an accepted merge with control at drain granularity."""
    cfg, params = setup
    eng = _engine(cfg, params, sync_every=4, max_side=2, theta=-1.0, side_max_steps=6)
    eng.submit("hello [TASK: verify this claim] world", lane=0)
    eng.run(48)  # prompt forcing (~25 ticks), 6 generated, drain slack
    assert "spawn" in [e["event"] for e in eng.history]
    merge = next(e for e in eng.history if e["event"] == "merge")
    assert merge["accepted"] is True  # theta = -1 accepts everything


def test_router_feed_incremental_exactly_once():
    r = CortexRouter()
    assert r.feed("a", "xy [TAS") == []
    trig = r.feed("a", "K: joined] z")
    assert [t.kind for t in trig] == ["task"] and trig[0].payload == "joined"
    assert r.feed("a", "") == []  # the tail rescan does not fire again
    assert r.feed("a", " more text") == []
    assert [t.kind for t in r.feed("a", " [DONE]")] == ["done"]


def test_synapse_decode_pallas_matches_piece():
    """The fused attend (default) and piece_attend give the same decode
    output and cache update; the reference's piece decode agrees."""
    cfg = dataclasses.replace(get_config("qwen2.5-0.5b", reduced=True), compute_dtype="float32")
    jcfg = dataclasses.replace(jax_get_config("qwen2.5-0.5b", reduced=True), compute_dtype="float32")
    jparams = jattention.attn_init(jax.random.key(0), jcfg, jnp.float32)
    params = {k: torch.from_numpy(np.array(v)) for k, v in jparams.items()}
    B, K, W, J = 3, 16, 8, 4
    rng = np.random.default_rng(1)
    jc = jcache.init_synapse_cache(jcfg, B, K, W, J, jnp.float32)
    r = lambda a: rng.standard_normal(a.shape).astype(np.float32)
    jc = dataclasses.replace(
        jc, lm_k=jnp.asarray(r(jc.lm_k)), lm_v=jnp.asarray(r(jc.lm_v)),
        lm_score=jnp.asarray(rng.uniform(size=jc.lm_score.shape).astype(np.float32)),
        lm_count=jnp.asarray([0, 5, K], jnp.int32), win_k=jnp.asarray(r(jc.win_k)), win_v=jnp.asarray(r(jc.win_v)),
        win_count=jnp.asarray([2, W, W + 3], jnp.int32), length=jnp.asarray([2, W + 5, K + W + 3], jnp.int32),
    )
    x = rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
    positions = np.asarray([3, 40, 90], np.int32)
    outs = {}
    for impl in ("kernel", "piece"):
        cache = bridge.cache_from_numpy(jax.tree.map(np.asarray, jc), "cpu")  # decoded in place
        y, cache, stats = tsynapse.synapse_decode(params, cfg, torch.from_numpy(x), cache, torch.from_numpy(positions),
                                                  tsynapse.SynapsePolicy(attend_impl=impl))
        outs[impl] = (y, bridge.cache_to_numpy(cache), stats["attn_mass_landmarks"])
    (y_k, c_k, m_k), (y_p, c_p, m_p) = outs["kernel"], outs["piece"]
    assert torch.equal(y_k, y_p) and torch.equal(m_k, m_p)
    for name in c_k:
        np.testing.assert_array_equal(c_k[name], c_p[name], err_msg=name)
    y_j, c_j, st_j = jsynapse.synapse_decode(jparams, jcfg, jnp.asarray(x), jc, jnp.asarray(positions),
                                             jsynapse.SynapsePolicy(attend_impl="piece"))
    np.testing.assert_allclose(y_p.numpy(), np.asarray(y_j), rtol=1e-5, atol=1e-5)
    for name, want in bridge.cache_to_numpy(bridge.cache_from_numpy(jax.tree.map(np.asarray, c_j), "cpu")).items():
        np.testing.assert_allclose(np.asarray(c_p[name], np.float32), np.asarray(want, np.float32),
                                   rtol=1e-5, atol=1e-5, err_msg=name)
    np.testing.assert_allclose(m_p.numpy(), np.asarray(st_j["attn_mass_landmarks"]), rtol=1e-5, atol=1e-5)
