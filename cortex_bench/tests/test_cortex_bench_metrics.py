"""The yardstick's arithmetic and the metric readers, on hand-worked values."""
import importlib.util
from pathlib import Path

import pytest

from cortex_bench import yardstick as ys
from cortex_bench.harness import RunData

METRICS = Path(__file__).resolve().parents[1] / "metrics"


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
    qwen = dict(n_layers=24, d_model=896, n_heads=14, n_kv_heads=2, d_head=64, d_ff=4864, vocab_size=151936)
    per_layer = 896 * 896 * 2 + 2 * 896 * 128 + 3 * 896 * 4864
    assert ys.matmul_params_per_token(qwen) == 24 * per_layer + 896 * 151936
    assert ys.decode_flops(qwen, 3, 100) == 2.0 * (24 * per_layer + 896 * 151936) * 3 + 4 * 14 * 64 * 100 * 24
    # a configuration it has no count for is refused, not counted wrong
    with pytest.raises(ValueError):
        ys.matmul_params_per_token({**qwen, "arch_type": "hybrid", "shared_attn_every": 6})


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
