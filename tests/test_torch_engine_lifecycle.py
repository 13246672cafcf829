"""The port's CortexEngine lifecycle and the Prism's memory accounting
(paper Eq. 1, Tables 1 and 2) on the reduced Qwen2.5-0.5B: the cases of
``tests/test_engine.py`` that had no port counterpart.

Ported cases:

* ``test_full_lifecycle_spawn_merge`` (the reference's sampled rivers);
* ``test_marginal_agent_cost_is_synapse_sized``: the port's lane slice of
  ``side_caches`` is the synapse's bytes (``synapse_bytes``, equal to the
  reference's), under a fifth of the weights;
* ``test_batch_server_completes_requests``;
* ``test_side_agent_sees_compressed_context``: landmarks right after the
  spawn, and the side lane's synapse caches equal to the reference's
  ``spawn_caches`` of the same parent lane (indices, counts and positions
  equal, keys, values and scores within 1e-5).

Near counterparts, not repeated here: ``test_gate_rejects_when_theta_high``
(``test_torch_model.py::test_merge_thought_matches_jax[2.0-False]``, a gate
rejection), ``test_prism_weights_shared_not_copied``
(``test_torch_engine.py::test_memory_report_counts_weights_once``), and
``test_router_triggers_once`` and ``test_router_split_across_chunks``
(``test_torch_pipeline.py::test_router_contract``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_families import _one_torch_thread  # noqa: F401 (autouse: one intra-op thread)

from repro.configs import get_config as jax_get_config
from repro.core import engine as jengine
from repro.core import synapse as jsyn
from repro.models import cache as jcache
from repro.models import model as jmodel
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.core import synapse as tsyn
from repro_torch.core.engine import CortexEngine, _lane_slice
from repro_torch.core.prism import Prism, tree_bytes
from repro_torch.data.tokenizer import ByteTokenizer
from repro_torch.models import model as tmodel
from repro_torch.serving.sampler import SamplingParams
from repro_torch.serving.server import BatchServer


@pytest.fixture(scope="module")
def setup():
    cfg = get_config("qwen2.5-0.5b", reduced=True)
    return cfg, tmodel.init_params(cfg, seed=0, device="cpu")


def _engine(setup, n_main=2, max_side=3, theta=-1.0):
    cfg, params = setup
    return CortexEngine(Prism(params, cfg, device="cpu"), ByteTokenizer(cfg.vocab_size), n_main=n_main,
                        max_side=max_side, main_capacity=256, side_max_steps=6, inject_tokens=8, theta=theta,
                        sampling=SamplingParams(temperature=1.0), device="cpu")


def test_full_lifecycle_spawn_merge(setup):
    eng = _engine(setup)
    eng.submit("hello [TASK: verify this claim] world", lane=0)
    eng.submit("plain agent", lane=1)
    eng.run(40)
    events = [e["event"] for e in eng.history]
    assert "spawn" in events and "merge" in events
    merge = next(e for e in eng.history if e["event"] == "merge")
    assert merge["accepted"] is True  # theta = -1 accepts everything


def test_marginal_agent_cost_is_synapse_sized(setup):
    """Paper Table 2: a side agent costs Mem(synapse), not Mem(W)."""
    eng = _engine(setup)
    eng.submit("main [TASK: one] t", lane=0)
    eng.run(3)
    rep = eng.memory_report()
    side = next(s for s in eng.sides if s.active)
    per_side = tree_bytes(_lane_slice(eng.state.side_caches, side.lane))
    spec = eng.side_spec
    assert per_side == tsyn.synapse_bytes(eng.cfg, spec.n_landmarks, spec.window, spec.n_inject)
    jcfg = dataclasses.replace(jax_get_config("qwen2.5-0.5b", reduced=True), compute_dtype=eng.cfg.compute_dtype)
    assert per_side == jsyn.synapse_bytes(jcfg, spec.n_landmarks, spec.window, spec.n_inject)
    assert rep["per_agent_bytes"][side.agent_id] == per_side
    assert per_side < rep["weight_bytes"] * 0.2


def test_batch_server_completes_requests(setup):
    cfg, params = setup
    srv = BatchServer(params, cfg, ByteTokenizer(cfg.vocab_size), n_lanes=2, capacity=128,
                      sampling=SamplingParams(temperature=1.0), device="cpu")
    for i in range(4):
        srv.submit(f"request number {i}", max_new_tokens=5)
    done = srv.run_until_done(max_ticks=200)
    assert len(done) == 4
    assert all(r.status == "ok" and len(r.text) > 0 for r in done)


def test_side_agent_sees_compressed_context(setup):
    """Right after the spawn the side's synapse holds landmarks of the
    parent's prompt, and equals the reference's compression of the same
    parent lane."""
    eng = _engine(setup)
    eng.submit("the quick brown fox [TASK: recall the animal] jumps", lane=0)
    side = next(s for s in eng.sides if s.active)
    # numpy views of the live caches: compared before the engine ticks on
    parent = bridge.caches_to_numpy(tmodel.lane_caches(eng.state.main_caches, side.parent_lane))
    got = bridge.caches_to_numpy(tmodel.lane_caches(eng.state.side_caches, side.lane))["groups"][0]
    jcfg = dataclasses.replace(jax_get_config("qwen2.5-0.5b", reduced=True), compute_dtype=eng.cfg.compute_dtype)
    jspec = jmodel.CacheSpec(kind="synapse", n_landmarks=eng.side_spec.n_landmarks, window=eng.side_spec.window,
                             n_inject=eng.side_spec.n_inject)
    jparent = jmodel.ModelCaches(groups=(jcache.FullCache(**{k: jnp.asarray(v) for k, v in parent["groups"][0].items()}),),
                                 shared=None)
    want = jax.tree.map(np.asarray, jengine.spawn_caches(jcfg, jparent, jspec).groups[0])
    for name, w in bridge.cache_to_numpy(bridge.cache_from_numpy(want, "cpu")).items():
        if np.issubdtype(w.dtype, np.integer):
            np.testing.assert_array_equal(got[name], w, err_msg=name)
        else:
            np.testing.assert_allclose(got[name], w, rtol=1e-5, atol=1e-5, err_msg=name)
    assert got["lm_count"].min() > 0
    eng.run(2)
    lane = next(s for s in eng.sides if s.active).lane
    assert int(eng.state.side_caches.groups[0].lm_count[0, lane]) > 0
