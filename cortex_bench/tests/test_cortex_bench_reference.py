"""The plain reference: it agrees with the program's forward pass on the
dense family's features it implements, and refuses what it does not read."""
import json
from pathlib import Path

import pytest
import torch

from cortex_bench.reference.model import RefModel, Unsupported
from cortex_bench.weights import make_weights

CONF = Path(__file__).resolve().parents[1] / "configs" / "qwen2.5-0.5b.json"
SMALL = {"n_layers": 2, "d_model": 128, "n_heads": 4, "n_kv_heads": 2, "d_head": 32, "d_ff": 256, "vocab_size": 512,
         "param_dtype": "float32", "compute_dtype": "float32"}


def arch(**kw):
    return {**json.loads(CONF.read_text())["model"], **SMALL, **kw}


def weights(a, seed=3):
    from repro_torch.models.config import ModelConfig

    w = make_weights(ModelConfig(**a), seed, torch.device("cpu"))
    g = torch.Generator().manual_seed(seed)
    for key in ("q_norm", "k_norm"):  # norms away from one, so that they count
        if key in w["groups"][0]["attn"]:
            t = w["groups"][0]["attn"][key]
            t.mul_(1 + 0.5 * torch.rand(t.shape, generator=g))
    return w


@pytest.mark.parametrize("kw", [{}, {"qkv_bias": False, "qk_norm": True, "tie_embeddings": False}],
                         ids=["qwen2.5", "qwen3"])
def test_reference_matches_the_program_forward(kw):
    from repro_torch.models.config import ModelConfig
    from repro_torch.models.model import forward

    a = arch(**kw)
    w = weights(a)
    tok = torch.randint(0, 256, (2, 40), generator=torch.Generator().manual_seed(1))
    pos = torch.arange(40)[None].expand(2, -1)
    want = forward(w, ModelConfig(**a), {"tokens": tok})[0]
    ref = RefModel(a, w)
    hid, _, _ = ref.prefill(tok, pos)
    got = ref.head(hid)
    assert (got - want).abs().max() < 1e-4 * want.abs().max()


def test_reference_refuses_what_it_does_not_read():
    a = arch()
    w = weights(a)
    with pytest.raises(Unsupported):
        RefModel({**a, "arch_type": "moe", "n_experts": 8}, w)
    extra = {**w, "groups": [{**w["groups"][0], "attn": {**w["groups"][0]["attn"], "q_norm": torch.ones(2, 32)}}]}
    with pytest.raises(Unsupported, match="q_norm"):
        RefModel(a, extra)
    with pytest.raises(Unsupported, match="head"):
        RefModel({**a, "tie_embeddings": False}, w)


def test_sides_are_judged_while_their_ring_fills():
    # a side that serves past the fill of its window ring: the tokens served
    # from then on, after keys start to graduate, are not judged
    from cortex_bench.reference.replay import replay, side_prompt_ids

    a = arch()
    ref = RefModel(a, weights(a))
    eng = {"inject_tokens": 4, "n_landmarks": 8, "window": 16, "side_prompt_cap": 64,
           "policy": {"alpha": 0.5, "coverage_cap": 4.0}}
    req = {"prompt": "p" * 40, "river": [1, 2], "sides": [{"task": "go", "tokens": list(range(30))}], "merges": []}
    with torch.no_grad():
        out = replay(ref, [req], eng)
    judged = 16 - len(side_prompt_ids("go", 64)) + 1
    assert out["sides"].keys == [(0, 0)] * judged
    assert len(out["river"].keys) == 2
