"""The Zamba2-7B cell's reference and check on the CPU: the plain reference
equals ``transformers``' Zamba2 on the same weights, the served weights
draw every leaf of the configuration, and a whole run at a small size
passes while the control and a planted hybrid fault fail."""
import dataclasses
import json
from pathlib import Path

import pytest
import torch

from cortex_bench import harness
from cortex_bench.reference.model import Unsupported
from cortex_bench.reference.zamba2 import RefModel
from cortex_bench.run import verdict_lines
from cortex_bench.weights import make_weights

HERE = Path(__file__).resolve().parents[1]
SEED = 2**31 + 7919

# reduced widths, the published structure: groups, two blocks over three
# uneven depths, the [stream; embeddings] input (d_head = 2 d / heads)
SMALL = {"n_layers": 5, "d_model": 128, "n_heads": 4, "n_kv_heads": 4, "d_head": 64, "d_ff": 256, "vocab_size": 512,
         "ssm_state_size": 16, "ssm_head_dim": 32, "ssm_chunk": 32, "hybrid_layer_ids": [1, 2, 4],
         "shared_mlp_lora_rank": 8, "attn_scale": 32 ** -0.5}
MIX = {"engine": {"n_main": 2, "max_side": 4, "main_capacity": 512, "sync_every": 4, "max_window": 16,
                  "side_max_steps": 12, "inject_tokens": 16, "theta": -1.0},
       "tags": {"share": 1.0, "count": [2, 2], "words": [3, 8]}, "preamble_bytes": {"lo": 40, "hi": 90},
       "river_margin": 200, "max_new_tokens": [10, 10], "queue_depth": 2}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Small CPU ops run fastest on one thread; a parallel test run puts
    several workers on few cores, where each worker's intra-op thread
    pool would contend with the others'."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def small_cfg():
    from repro_torch.models.config import ModelConfig

    model = json.loads((HERE / "configs" / "zamba2-7b.json").read_text())["model"]
    return ModelConfig(**{**model, **SMALL, "param_dtype": "float32", "compute_dtype": "float32"})


def test_every_leaf_of_the_configuration_is_drawn():
    from repro_torch.configs import get_config
    from repro_torch.models.model import abstract_params, tree_leaves

    cfg = get_config("zamba2-7b", reduced=True)
    got = make_weights(cfg, SEED, torch.device("cpu"))
    want = [(tuple(t.shape), t.dtype) for t in tree_leaves(abstract_params(cfg))]
    assert [(tuple(t.shape), t.dtype) for t in tree_leaves(got)] == want
    assert all(bool(torch.isfinite(t).all()) for t in tree_leaves(got))
    # the adapters and the per-depth linears are drawn, not left at zero
    assert all(float(t.abs().max()) > 0 for t in got["hybrid"].values())


def test_the_reference_refuses_what_it_does_not_read():
    cfg = small_cfg()
    w = make_weights(cfg, SEED, torch.device("cpu"))
    arch = dataclasses.asdict(cfg)
    with pytest.raises(Unsupported):
        RefModel({**arch, "qk_norm": True}, w)
    with pytest.raises(Unsupported):
        RefModel(arch, {**w, "head": w["embed"]})
    qwen = json.loads((HERE / "configs" / "qwen2.5-0.5b.json").read_text())["model"]
    with pytest.raises(Unsupported):
        RefModel(qwen, w)


def _hf_model(cfg, w, monkeypatch, chunk: int):
    """``transformers``' Zamba2ForCausalLM at ``cfg``'s sizes and SSD
    chunk ``chunk``, holding ``w`` (the port's layout, nn.Linear's [out,
    in] transposed)."""
    # its PyTorch classes alone: importing TensorFlow beside them costs seconds
    monkeypatch.setenv("USE_TF", "0")
    monkeypatch.setenv("USE_FLAX", "0")
    tr = pytest.importorskip("transformers")
    ids = list(cfg.hybrid_layer_ids)
    hc = tr.Zamba2Config(
        vocab_size=cfg.vocab_size, hidden_size=cfg.d_model, num_hidden_layers=cfg.n_layers,
        layers_block_type=["hybrid" if i in ids else "mamba" for i in range(cfg.n_layers)],
        mamba_d_state=cfg.ssm_state_size, mamba_d_conv=cfg.ssm_conv_width, mamba_expand=cfg.ssm_expand,
        mamba_ngroups=cfg.ssm_ngroups, n_mamba_heads=cfg.ssm_n_heads, chunk_size=chunk,
        intermediate_size=cfg.d_ff, hidden_act="gelu", num_attention_heads=cfg.n_heads,
        num_key_value_heads=cfg.n_kv_heads, num_mem_blocks=cfg.n_shared_blocks, adapter_rank=cfg.shared_mlp_lora_rank,
        use_shared_attention_adapter=False, use_mem_rope=True, rope_theta=cfg.rope_theta, rms_norm_eps=cfg.norm_eps,
        tie_word_embeddings=True, pad_token_id=None,
        # its plain-PyTorch mixer clamps dt at time_step_min; at 1e-9 it runs
        # unclamped, as its kernel path does under the published
        # time_step_limit of null
        time_step_min=1e-9)
    hc._attn_implementation = "eager"
    m = tr.Zamba2ForCausalLM(hc).float().eval()
    T = lambda t: t.T.contiguous()
    assert m.lm_head.weight is m.model.embed_tokens.weight  # tied: one table
    pairs = [(m.model.embed_tokens.weight, w["embed"]), (m.model.final_layernorm.weight, w["final_norm"])]
    g, s, h = w["groups"][0], w["shared_attn"], w["hybrid"]
    for i, layer in enumerate(m.model.layers):
        dec = layer.mamba_decoder if i in ids else layer
        mx, mix = {k: v[i] for k, v in g["mixer"].items()}, dec.mamba
        pairs += [(dec.input_layernorm.weight, g["ln"][i]), (mix.in_proj.weight, T(mx["w_in"])),
                  (mix.conv1d.weight, T(mx["conv_w"])[:, None, :]), (mix.conv1d.bias, mx["conv_b"]),
                  (mix.dt_bias, mx["dt_bias"]), (mix.A_log, mx["a_log"]), (mix.D, mx["d_skip"]),
                  (mix.norm.weight, mx["gate_norm"]), (mix.out_proj.weight, T(mx["w_out"]))]
    for inv, depth in enumerate(ids):
        # the block object is shared by every depth that invokes it
        b, layer = inv % cfg.n_shared_blocks, m.model.layers[depth]
        blk = layer.shared_transformer
        assert blk is m.model.layers[ids[b]].shared_transformer
        ff = blk.feed_forward
        pairs += [(layer.linear.weight, T(h["w_out"][inv])), (blk.input_layernorm.weight, s["ln1"][b]),
                  (blk.pre_ff_layernorm.weight, s["ln2"][b]),
                  (blk.self_attn.q_proj.weight, T(s["attn"]["wq"][b])),
                  (blk.self_attn.k_proj.weight, T(s["attn"]["wk"][b])),
                  (blk.self_attn.v_proj.weight, T(s["attn"]["wv"][b])),
                  (blk.self_attn.o_proj.weight, T(s["attn"]["wo"][b])),
                  (ff.gate_up_proj.weight, T(torch.cat([s["mlp"]["gate"][b], s["mlp"]["up"][b]], 1))),
                  (ff.down_proj.weight, T(s["mlp"]["down"][b])),
                  (ff.gate_up_proj_adapter_list[inv][0].weight, T(h["lora_a"][inv])),
                  (ff.gate_up_proj_adapter_list[inv][1].weight, T(h["lora_b"][inv]))]
    with torch.no_grad():
        for param, val in pairs:
            param.copy_(val)
    assert {id(p) for p in m.parameters()} == {id(p) for p, _ in pairs}
    return m


def test_the_reference_equals_transformers_zamba2(monkeypatch):
    # the reference scans 80 tokens in two blocks, the second short;
    # transformers in one chunk of 128, which it pads: its plain-PyTorch
    # mixer sums the chunk states over the chunk they enter rather than the
    # chunk they leave, so across chunks it is not the recurrence (its
    # kernel path is; the port's chunks and the reference's blocks agree
    # with the token-by-token recurrence). Both in f32: the logits agree to
    # rounding (1e-4 against logits of ~1; a block, adapter, group or linear
    # left out or misplaced moves them by more than 1e-2)
    cfg = small_cfg()
    w = make_weights(cfg, SEED, torch.device("cpu"))
    hf = _hf_model(cfg, w, monkeypatch, chunk=128)
    S = 80
    tok = torch.randint(0, cfg.vocab_size, (2, S), generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        want = hf(input_ids=tok, use_cache=False).logits
        ref = RefModel(dataclasses.asdict(cfg), w)
        hid, kv, states = ref.prefill(tok, torch.arange(S)[None].expand(2, S))
        got = ref.head(hid)
    assert len(kv) == 3 and len(states) == cfg.n_layers
    assert float(want.abs().max()) > 0.1
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4)


def limits():
    return json.loads((HERE / "limits" / "zamba2-council.json").read_text())["limits"]


def small_run(control=False, seed=5):
    res = harness.run("zamba2-council", seed, 2.0, False, device="cpu", control=control,
                      overrides={"model": SMALL, "mix": MIX}, log=lambda *a: None)
    assert res["verdict"] is not None, "no request finished"
    return res


def test_program_passes_and_control_fails():
    res = small_run(control=True)
    v = res["verdict"]
    ok, _ = verdict_lines(v["numbers"], limits())
    assert ok, v["numbers"]
    bad, checks = verdict_lines(v["control"], limits())
    assert not bad, checks
    stats = res["data"].engine["stats"]
    assert stats["state_copy_bytes"] > 0 and stats["state_blend_bytes"] > 0
    assert v["tokens_judged"] > 0 and res["data"].engine["merges"] > 0


def test_a_merge_without_the_blend_fails(monkeypatch):
    # the thought's keys are injected, its terminal Mamba2 state is not
    # blended into the river's
    from repro_torch.core import injection

    monkeypatch.setattr(injection, "blend_state", lambda main, thought, accept: main)
    ok, checks = verdict_lines(small_run()["verdict"]["numbers"], limits())
    assert not ok, checks
