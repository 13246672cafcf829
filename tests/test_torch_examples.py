"""The port's three serving examples (``repro_torch.examples``) run on the
CPU at their reduced sizes, checked for mechanics (the weights are random,
so the text is not): each one's ``main(["--device", "cpu"])`` and the dict
it returns. Each needs the card unless asked for the CPU.

* quickstart: every request of the four completes with its tokens;
* council of agents: both rivers' tags spawn, every merge is accepted at
  theta = -1, river 0 (greedy) drained the same tokens up to the first
  merge as a run of the same engine with every lane greedy (the other
  lanes' sampling cannot move it), the memory report counts the weights
  once (``tree_bytes`` of the Prism's params) and the context per agent is
  under a fifth of them;
* long-context synapse: the synapse cache's bytes are the same after step
  1 and after the last step, with enough steps (300 >= 2 (K + W + J)) that
  the window evicts into the landmarks, the last logits are finite and the
  landmarks kept lie before the window.

Exact comparisons only: no tolerance.
"""
import pytest
import torch
from test_torch_families import _one_torch_thread  # noqa: F401 (autouse: one intra-op thread)

from repro_torch.core.prism import tree_bytes
from repro_torch.examples import council_of_agents, long_context_synapse, quickstart
from repro_torch.serving.sampler import SamplingParams

EXAMPLES = {"quickstart": quickstart, "council_of_agents": council_of_agents,
            "long_context_synapse": long_context_synapse}


def test_quickstart_completes_every_request():
    out = quickstart.main(["--device", "cpu"])
    assert out["device"] == "cpu" and len(out["requests"]) == 4
    for r in out["requests"]:
        assert r["status"] == "ok"
        assert 0 < len(r["tokens"]) - r["prompt_len"] <= 24
    assert out["stats"]["steps"] > 0


def test_council_spawns_merges_and_keeps_the_greedy_river():
    out = council_of_agents.main(["--device", "cpu"])
    eng = out["engine"]
    assert len(out["spawns"]) >= 2
    assert out["merges"] and all(m["accepted"] for m in out["merges"])
    assert out["ticks"] == 40 and eng.stats["ticks"] == 40
    rep = out["reports"][-1]
    assert rep["weight_bytes"] == tree_bytes(eng.prism.params)
    assert rep["context_bytes_per_agent"] < 0.2 * rep["weight_bytes"]
    assert rep["standard_architecture_bytes"] >= rep["weight_bytes"] * rep["n_agents"]

    greedy = council_of_agents.run_council(
        council_of_agents.build_engine(eng.prism, eng.tok, sampling=SamplingParams(greedy=True),
                                       side_sampling=SamplingParams(greedy=True)))
    n = out["river0_tokens_before_merge"]
    assert n > out["river0_prompt_len"]
    assert out["river0_tokens"][:n] == greedy["river0_tokens"][:n]


def test_long_context_bytes_stay_constant():
    out = long_context_synapse.main(["--device", "cpu"])
    spec = out["spec"]
    K, W, J = spec["n_landmarks"], spec["window"], spec["n_inject"]
    assert out["steps"] >= 2 * (K + W + J) and out["length"] == out["steps"]
    assert out["synapse_bytes"] == out["synapse_bytes_step1"] == out["synapse_bytes_last"]
    assert out["synapse_bytes"] < out["full_cache_bytes"]
    assert out["logits_finite"] and out["logits_shape"] == [1, 512]
    assert out["lm_count"] == K
    assert max(out["lm_pos"]) < out["steps"] - W  # graduated out of the window


@pytest.mark.parametrize("name", sorted(EXAMPLES))
def test_examples_need_the_card_unless_asked(monkeypatch, name):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        EXAMPLES[name].main([])
