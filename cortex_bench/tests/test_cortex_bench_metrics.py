"""The yardstick's arithmetic and the metric readers, on hand-worked values."""
import importlib.util
import json
from pathlib import Path

import pytest

from cortex_bench import yardstick as ys
from cortex_bench.harness import RunData

METRICS = Path(__file__).resolve().parents[1] / "metrics"
CONF = Path(__file__).resolve().parents[1] / "configs" / "qwen2.5-0.5b.json"


def reader(name):
    spec = importlib.util.spec_from_file_location(f"m_{name}", METRICS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def data(**kw):
    base = dict(arch={}, window_s=10.0, setup_s=1.0, peak_bytes=0, tokens=[], requests=[])
    return RunData(**{**base, **kw})


def test_kernel_costs_by_hand():
    # row 1 of the kernel table, every key valid: 624,256 bytes
    byts, flops = ys.synapse_attention_cost((8, 14, 64), (8, 144, 2, 64), 2, 8 * 144)
    assert byts == 624_256 and flops == 4 * 14 * 64 * 1152
    # only the valid keys' bytes count
    b_half, _ = ys.synapse_attention_cost((8, 14, 64), (8, 144, 2, 64), 2, 576)
    assert byts - b_half == 2 * 576 * 2 * 64 * 2
    # density mode: q, the valid keys, the mask, the f32 density
    byts, flops = ys.landmark_score_cost((24, 14, 64), (24, 1024, 2, 64), 2, 24 * 1024)
    assert byts == 24 * 14 * 64 * 2 + 24 * 1024 * 2 * 64 * 2 + 24 * 1024 + 4 * 24 * 1024
    assert flops == 2 * 14 * 64 * 24 * 1024
    assert ys.bound_s(3.35e12, 0) == pytest.approx(1.0) and ys.bound_s(0, 989e12) == pytest.approx(1.0)


def test_decode_flops_by_hand():
    # qwen2: the count read from the configuration file's published keys
    qwen = json.loads(CONF.read_text())["published"]
    per_layer = 896 * 896 * 2 + 2 * 896 * 128 + 3 * 896 * 4864
    count = ys.decode_count(qwen, [])
    assert count.weights == 24 * per_layer + 896 * 151936 == 493_961_216
    assert count.attention == ((14, 64),) * 24 and count.recurrent == 0
    assert ys.decode_flops(count, 3, 100) == 2.0 * (24 * per_layer + 896 * 151936) * 3 + 4 * 14 * 64 * 100 * 24


# Zamba2-7B-Instruct's published config.json (the model-configs catalog's
# copy of https://huggingface.co/Zyphra/Zamba2-7B-Instruct/blob/main/config.json)
ZAMBA2_7B = {
    "adapter_rank": 128, "add_bias_linear": False, "attention_head_dim": 224, "attention_hidden_size": 7168,
    "chunk_size": 256, "ffn_hidden_size": 14336, "hidden_act": "gelu", "hidden_size": 3584,
    "hybrid_layer_ids": [6, 11, 17, 23, 29, 35, 41, 47, 53, 59, 65, 71, 77], "intermediate_size": 14336,
    "kv_channels": 112,
    "layers_block_type": ["hybrid" if i in (6, 11, 17, 23, 29, 35, 41, 47, 53, 59, 65, 71, 77) else "mamba"
                          for i in range(81)],
    "mamba_d_conv": 4, "mamba_d_state": 64, "mamba_expand": 2, "mamba_headdim": 64, "mamba_ngroups": 2,
    "max_position_embeddings": 4096, "model_type": "zamba2", "n_mamba_heads": 112, "num_attention_heads": 32,
    "num_hidden_layers": 81, "num_key_value_heads": 32, "num_logits_to_keep": 1, "num_mem_blocks": 2,
    "num_query_groups": 32, "rms_norm_eps": 1e-05, "rope_theta": 10000, "time_step_floor": 0.0001,
    "time_step_limit": None, "time_step_max": 0.1, "time_step_min": 0.001, "use_conv_bias": True,
    "use_long_context": False, "use_mem_rope": True, "use_shared_attention_adapter": False,
    "use_shared_mlp_adapter": True, "vocab_size": 32000,
}


def test_zamba2_count_by_hand():
    d, di, gn, ffn, hd = 3584, 7168, 2 * 64, 14336, 32 * 224
    mamba = d * (2 * di + 2 * gn + 112) + (di + 2 * gn) * 4 + di * d
    assert mamba == 78_418_944
    block = 3 * (2 * d) * hd + hd * d + d * 2 * ffn + ffn * d  # q, k, v over [stream; embeddings], o, MLP
    adapter, linear = d * 128 + 128 * 2 * ffn, d * d
    assert block + adapter + linear == 350_945_280
    count = ys.decode_count(ZAMBA2_7B, [])
    assert count.weights == 81 * mamba + 13 * (block + adapter + linear) + d * 32000 == 11_028_911_104
    assert count.attention == ((32, 224),) * 13
    assert count.recurrent == 81 * 4 * 112 * 64 * 64 == 81 * 1_835_008
    # the weights stored: every Mamba layer, the two shared blocks once, each
    # hybrid layer's adapter and linear, the head
    assert 81 * mamba + 2 * block + 13 * (adapter + linear) + d * 32000 == 7_355_225_088
    assert ys.decode_flops(count, 2, 10) == 2.0 * 11_028_911_104 * 2 + 13 * 4 * 32 * 224 * 10 + 81 * 1_835_008 * 2
    # qkv adapters, where the block has them: rank-r maps of the block's input
    with_qkv = ys.decode_count({**ZAMBA2_7B, "use_shared_attention_adapter": True}, [])
    assert with_qkv.weights - count.weights == 13 * 3 * 2 * (7168 * 128)


@pytest.mark.parametrize("published, reduced, named", [
    ({"model_type": "deepseek_v2", "n_routed_experts": 160, "kv_lora_rank": 512}, [], "deepseek_v2"),
    ({"model_type": "qwen3_moe", "num_experts": 128, "num_experts_per_tok": 8}, [], "qwen3_moe"),
    ({"model_type": "rwkv6", "hidden_size": 2048, "num_hidden_layers": 24}, [], "rwkv6"),
    ({"model_type": "not_a_model"}, [], "not_a_model"),
    (None, ["num_hidden_layers"], "qwen2"),
], ids=["deepseek_v2", "qwen3_moe", "rwkv6", "unknown", "reduced"])
def test_decode_count_refuses_what_it_does_not_count(published, reduced, named):
    # a configuration it has no count for is refused by name, not counted
    # wrong; a cut one, not counted as the whole model
    published = published or json.loads(CONF.read_text())["published"]
    with pytest.raises(ValueError, match=named):
        ys.decode_count(published, reduced)


def _zamba2_bench(root):
    conf = {"source": "https://huggingface.co/Zyphra/Zamba2-7B-Instruct", "published": ZAMBA2_7B, "model": {}}
    (root / "zamba2.json").write_text(json.dumps(conf))
    bench = {"configs": [{"name": "zamba2-7b", "file": "zamba2.json", "reduced": []}],
             "workloads": [{"name": "zamba2-council", "config": "zamba2-7b", "traffic": "council"}]}
    return bench, "zamba2-council", 11_028_911_104


@pytest.mark.parametrize("which", ["qwen2.5-0.5b", "zamba2-7b"])
def test_the_harness_counts_from_the_configuration_file(tmp_path, which):
    from cortex_bench import harness

    if which == "qwen2.5-0.5b":
        bench, name, weights, root = harness.load_bench(), "qwen25-council", 493_961_216, harness.ROOT
    else:
        (bench, name, weights), root = _zamba2_bench(tmp_path), tmp_path
    cell, conf, _ = harness.cell_of(bench, name, root=root)
    assert harness.decode_count_of(bench, cell, conf).weights == weights
    # the same file, listed as cut, is refused
    bench["configs"] = [{**c, "reduced": ["num_hidden_layers"]} for c in bench["configs"]]
    with pytest.raises(ValueError, match="cut"):
        harness.decode_count_of(bench, cell, conf)


def test_percentile_nearest_rank():
    xs = list(range(1, 21))
    assert ys.percentile(xs, 95) == 19 and ys.percentile(xs, 50) == 10 and ys.percentile([3.0], 95) == 3.0


def test_idle_share_is_a_union_of_intervals():
    iv = [(0, 4), (2, 6), (8, 9), (8.5, 8.7)]
    assert ys.union_length(iv) == 7
    assert ys.idle_gaps(iv, 0, 10) == [(6, 8), (9, 10)]
    d = data(stretch={"window_s": 10.0, "busy_s": 7.0})
    assert reader("device_idle_share.agents")(d) == pytest.approx(30.0)


def test_rate_over_the_whole_window():
    toks = [(0.5, 10, "main"), (4.0, 30, "side"), (9.9, 20, "side"), (10.5, 99, "main"), (-0.1, 99, "main")]
    assert reader("agent_tokens_per_s")(data(tokens=toks)) == pytest.approx(60 / 10.0)


def row(due, first=None, budget_at=None, budget=5):
    return {"due": due, "first": first, "budget_at": budget_at, "budget": budget}


def test_tails_take_every_request_the_censored_ones_too():
    reqs = [row(0.0, 0.1, 0.5)] * 18 + [row(1.0, 3.0, 7.0), row(2.0)]   # the last never got a token
    d = data(requests=reqs + [row(11.0)])                              # due after the window: not counted
    # waits: 18 x 0.1, 2.0, and 8.0 so far for the one still waiting
    assert reader("ttft_p95_ms")(d) == pytest.approx(2000.0)
    assert reader("ttft_p95_ms")(data(requests=reqs + [row(2.0)] * 3)) == pytest.approx(8000.0)
    # per output token: 18 x 0.1, (7 - 3) / 4 = 1.0, and (10 - 2) / 4 = 2.0 censored
    assert reader("tpot_p95_ms")(d) == pytest.approx(1000.0)


def test_roofline_and_mfu_readers():
    d = data(stretch={"window_s": 2.0, "busy_s": 1.0, "synapse_attention_bound_s": 1e-3,
                      "synapse_attention_device_s": 4e-3, "decode_tokens": 10, "decode_flops": 989e12 * 0.02})
    assert reader("synapse_attention_roofline.agents")(d) == pytest.approx(25.0)
    assert reader("landmark_score_roofline.agents")(d) is None  # nothing to read: left out
    assert reader("decode_mfu.agents")(d) == pytest.approx(1.0)
    spans = {"dispatch": [0.1, 0.3], "merge": [0.01, 0.03, 0.02], "spawn": [0.005]}
    d = data(spans=spans)
    assert reader("dispatch_ms_per_tick.agents")(d) == pytest.approx(200.0)
    assert reader("merge_ms_p50.agents")(d) == pytest.approx(20.0)
    assert reader("spawn_ms_p50.agents")(d) == pytest.approx(5.0)
    assert reader("merge_ms_p50.agents")(data()) is None


def test_device_work_is_chosen_by_kind():
    # a traced stretch's device events: kernels, a copy, and the device-side
    # copies of two ranges, the benchmark's and one the program opens
    # itself; only the work counts, whatever the ranges are named
    from types import SimpleNamespace

    from torch.autograd import DeviceType

    from cortex_bench.harness import is_device_work

    def ev(name, kind, device=DeviceType.CUDA, annotation=False):
        return SimpleNamespace(name=name, device_type=device, is_user_annotation=annotation, activity_type=kind)

    events = [ev("gemv_kernel", "kernel"), ev("Memcpy DtoD", "gpu_memcpy"), ev("Memset", "gpu_memset"),
              ev("cb.dispatch", "gpu_user_annotation", annotation=True),
              ev("engine.window", "gpu_user_annotation", annotation=True),
              ev("engine.window", "user_annotation", device=DeviceType.CPU, annotation=True),
              ev("aten::mm", "cpu_op", device=DeviceType.CPU)]
    assert [e.name for e in events if is_device_work(e)] == ["gemv_kernel", "Memcpy DtoD", "Memset"]
    # a profiler that gives only one of the two marks of an annotation
    assert not is_device_work(ev("engine.window", None, annotation=True))
    assert not is_device_work(ev("engine.window", "gpu_user_annotation"))
