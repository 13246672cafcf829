"""Zamba2-7B-Instruct's published hybrid in the port, on the CPU: the
registry, the stored weights at full width (on the meta device), prefill
and decode against the plain reference (``cortex_bench/reference/zamba2.py``)
at a reduced size in f32, and the attention scale carried down to both
kernels' entry points (unchanged where a configuration sets none)."""
import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.configs import get_config
from repro_torch.core import synapse as synapse_lib
from repro_torch.kernels import ops
from repro_torch.kernels.landmark_score import landmark_density_ref
from repro_torch.models import attention
from repro_torch.models import model as model_lib
from repro_torch.models.config import ModelConfig

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from cortex_bench.reference.replay import LaneMemory  # noqa: E402
from cortex_bench.reference.zamba2 import RefModel  # noqa: E402
from cortex_bench.weights import make_weights  # noqa: E402

SEED = 2**31 + 104729
# f32 on both sides; the port scans in chunks of 32 (its last one padded),
# the reference in blocks of 64: logits of ~1 agree to ~2e-6. A fault of
# the mechanism (a block, adapter, group, linear or state left out) moves
# them by more than 1e-2
TOL = 1e-4


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Small CPU ops run fastest on one thread; a parallel test run puts
    several workers on few cores, where each worker's intra-op thread
    pool would contend with the others'."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg():
    return dataclasses.replace(get_config("zamba2-7b", reduced=True), param_dtype="float32", compute_dtype="float32")


def test_registry_keeps_the_port_only_config_apart():
    cfg = get_config("zamba2-7b")
    assert "zamba2-7b" not in configs.ARCHS and "zamba2-7b" in configs.PORT_ARCHS
    assert (cfg.n_layers, cfg.d_model, cfg.d_head, cfg.ssm_ngroups, cfg.n_shared_blocks) == (81, 3584, 224, 2, 2)
    assert cfg.n_shared_attn_invocations == 13 and cfg.attn_scale == (224 / 2) ** -0.5
    small = get_config("zamba2-7b", reduced=True)
    assert small.hybrid_layer_ids == (1, 2, 4) and small.n_heads * small.d_head == 2 * small.d_model
    assert (small.ssm_ngroups, small.n_shared_blocks, small.shared_mlp_lora_rank) == (2, 2, 8)
    # a configuration file's list is held as a tuple: the config hashes
    assert hash(ModelConfig(**{**dataclasses.asdict(small), "hybrid_layer_ids": [1, 3]}))
    segs = model_lib.build_segments(cfg)
    assert [(s.start, s.count, s.shared_after) for s in segs[:2]] == [(0, 6, 0), (6, 5, 1)]
    assert segs[-1].start == 77 and segs[-1].count == 4 and segs[-1].shared_after == -1


def test_stored_weights_at_full_width():
    # every Mamba2 layer, the two shared blocks once, each invocation's
    # adapter and linear, the tied table: the yardstick's 7,355,225,088 in
    # matrices, and the norms, biases and per-head scalars beside them
    leaves = model_lib.tree_leaves(model_lib.abstract_params(get_config("zamba2-7b")))
    assert all(t.device.type == "meta" for t in leaves)
    total = sum(t.numel() for t in leaves)
    vectors = (81 * (3584 + 7424 + 3 * 112 + 7168)  # per layer: ln, conv bias, a_log/dt_bias/d_skip, gate norm
               + 2 * (7168 + 3584) + 3584)          # the blocks' two norms, the final norm
    assert total - vectors == 7_355_225_088
    assert total == get_config("zamba2-7b").param_count() + 81 * (7424 + 112) + 3584


@pytest.mark.parametrize("S", [45, 20, 64], ids=["ragged", "short", "whole"])
def test_prefill_and_decode_equal_the_reference(S):
    cfg = _cfg()
    w = make_weights(cfg, SEED, torch.device("cpu"))
    ref = RefModel(dataclasses.asdict(cfg), w)
    steps, B = 6, 2
    tok = torch.randint(0, cfg.vocab_size, (B, S + steps), generator=torch.Generator().manual_seed(S))
    pos = lambda n: torch.arange(n)[None].expand(B, n)
    with torch.no_grad():
        full, _, _ = ref.prefill(tok, pos(S + steps))
        want = ref.head(full)
        spec = model_lib.CacheSpec(kind="full", capacity=96)
        caches = model_lib.init_caches(cfg, B, spec, device="cpu")
        lg, _, caches = model_lib.prefill(w, cfg, {"tokens": tok[:, :S]}, caches, spec=spec)
        torch.testing.assert_close(lg, want[:, S - 1], rtol=0, atol=TOL)
        for t in range(steps):
            p = torch.full((B,), S + t, dtype=torch.int32)
            lg, _, caches = model_lib.decode_step(w, cfg, {"tokens": tok[:, S + t], "positions": p}, caches,
                                                  spec=spec)
            torch.testing.assert_close(lg, want[:, S + t], rtol=0, atol=TOL)
            # the states the port holds are the reference's after S + t + 1 tokens
            _, _, states = ref.prefill(tok[:, :S + t + 1], pos(S + t + 1))
            st = caches.groups[0]
            for i, (conv, ssm) in enumerate(states):
                torch.testing.assert_close(st.ssm[i], ssm, rtol=0, atol=TOL)
                torch.testing.assert_close(st.conv[i], conv, rtol=0, atol=TOL)


def test_decode_needs_the_adapters_and_the_reference_steps_as_it_prefills():
    # the reference's own one-token steps (over a memory per invocation)
    # equal its prefill across two scan blocks; the port's decode with its
    # adapters zeroed leaves the reference by far more than the tolerance
    cfg = _cfg()
    w = make_weights(cfg, SEED, torch.device("cpu"))
    ref = RefModel(dataclasses.asdict(cfg), w)
    S, steps, B = 60, 8, 2
    tok = torch.randint(0, cfg.vocab_size, (B, S + steps), generator=torch.Generator().manual_seed(1))
    pos = lambda n: torch.arange(n)[None].expand(B, n)
    with torch.no_grad():
        full, _, _ = ref.prefill(tok, pos(S + steps))
        want = ref.head(full)
        _, kv, states = ref.prefill(tok[:, :S], pos(S))
        mems = [LaneMemory([k[b] for b in range(B)], [v[b] for b in range(B)], S + steps) for k, v in kv]
        states = [list(s) for s in states]
        no_adapter = {**w, "hybrid": {**w["hybrid"], "lora_b": torch.zeros_like(w["hybrid"]["lora_b"])}}
        spec = model_lib.CacheSpec(kind="full", capacity=96)
        caches = model_lib.init_caches(cfg, B, spec, device="cpu")
        model_lib.prefill(w, cfg, {"tokens": tok[:, :S]}, caches, spec=spec)
        for t in range(steps):
            p = torch.full((B,), S + t, dtype=torch.int32)
            got, _ = ref.step(tok[:, S + t], p, mems, states)
            torch.testing.assert_close(got, want[:, S + t], rtol=0, atol=TOL)
            lg, _, caches = model_lib.decode_step(no_adapter, cfg, {"tokens": tok[:, S + t], "positions": p}, caches,
                                                  spec=spec)
            assert float((lg - want[:, S + t]).abs().max()) > 100 * TOL


def _capture_scales(monkeypatch):
    seen = {}
    attend, score = ops.synapse_attention, ops.landmark_score

    def synapse_attention(q, keys, values, valid, *, scale=None, **kw):
        seen["attend"] = scale
        return attend(q, keys, values, valid, scale=scale, **kw)

    def landmark_score(q, keys, landmarks=None, valid=None, *, scale=None):
        seen["density"] = scale
        return score(q, keys, landmarks, valid, scale=scale)

    monkeypatch.setattr(ops, "synapse_attention", synapse_attention)
    monkeypatch.setattr(ops, "landmark_score", landmark_score)
    return seen


@pytest.mark.parametrize("arch", ["qwen2.5-0.5b", "zamba2-7b"])
def test_the_configured_scale_reaches_both_kernels(arch, monkeypatch):
    # a spawn's density sweep and a side's attend take the model's scale;
    # where a configuration sets none, 1/sqrt(D) exactly as before
    cfg = dataclasses.replace(get_config(arch, reduced=True), param_dtype="float32", compute_dtype="float32")
    want = cfg.attn_scale if cfg.attn_scale is not None else 1.0 / (cfg.d_head ** 0.5)
    seen = _capture_scales(monkeypatch)
    w = make_weights(cfg, SEED, torch.device("cpu"))
    spec = model_lib.CacheSpec(kind="full", capacity=48)
    side = model_lib.CacheSpec(kind="synapse", n_landmarks=8, window=8, n_inject=4)
    caches = model_lib.init_caches(cfg, 1, spec, device="cpu")
    tok = torch.randint(0, cfg.vocab_size, (1, 24), generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        model_lib.prefill(w, cfg, {"tokens": tok}, caches, spec=spec)
        from repro_torch.core.engine import spawn_caches
        comp = spawn_caches(cfg, caches, side)
        model_lib.decode_step(w, cfg, {"tokens": tok[:, -1], "positions": torch.tensor([24], dtype=torch.int32)},
                              comp, spec=side)
    assert seen == {"density": cfg.attn_scale, "attend": want}
    assert (seen["density"] or 1.0 / (cfg.d_head ** 0.5)) == want


def test_without_a_configured_scale_the_attends_are_bitwise_as_before():
    # qwen2.5-0.5b's reduced shapes: the plain decode attend divides by
    # sqrt(D) and the density sweep is the kernel's plain version at
    # 1/sqrt(D), as before the scale was configurable
    cfg = get_config("qwen2.5-0.5b", reduced=True)
    g = torch.Generator().manual_seed(4)
    B, T, H, Hkv, D = 3, 40, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    q, k, v = (torch.randn(s, generator=g) for s in ((B, H, D), (B, T, Hkv, D), (B, T, Hkv, D)))
    valid = torch.rand(B, T, generator=g) < 0.8
    s = torch.einsum("bkgd,btkd->bkgt", q.reshape(B, Hkv, H // Hkv, D), k).float() / np.sqrt(D)
    p = torch.softmax(torch.where(valid[:, None, None, :], s, torch.full_like(s, attention.NEG_INF)), dim=-1)
    out, mass = attention.decode_attend(q, k, v, valid)
    assert torch.equal(out, torch.einsum("bkgt,btkd->bkgd", p, v).reshape(B, H, D))
    assert torch.equal(mass, p.sum(dim=(1, 2)))
    dens, _ = ops.landmark_score(q, k, None, valid)
    assert torch.equal(dens, landmark_density_ref(q, k, valid, None, scale=1.0 / (D ** 0.5))[0])
    assert torch.equal(synapse_lib.kernel_density(q, k, valid), dens)


def test_both_kernels_plan_heads_of_224_on_the_h100():
    # the H100's resident CTAs by cluster size (tests/test_torch_kernel_plans.py)
    from repro_torch.kernels import landmark_score as ls
    from repro_torch.kernels import synapse_attention as sa

    h100 = (264, 264, 248, 240, 224)
    side = sa.launch_plan(96, 144, 32, 32, 224, 2, h100)
    assert (len(side.ranges), side.stages, side.smem) == (1, 3, 105_808)
    # a spawn's sweep over 13 invocations: 16 ranges leave no room for a
    # tile beside 32 query rows, so the plan takes 8 ranges of two kv-head
    # groups (and 4 of four in f32)
    spawn = ls.launch_plan(13, 2048, 32, 32, 224, 0, 2, h100, density=True)
    assert (spawn.ranges_per_lane, spawn.head_groups, spawn.stages, spawn.smem) == (8, 2, 1, 158_096)
    f32 = ls.launch_plan(13, 2048, 32, 32, 224, 0, 4, h100, density=True)
    assert (f32.ranges_per_lane, f32.head_groups) == (4, 4) and f32.smem <= ls.MAX_SMEM
    for kc, density in ((0, False), (64, True)):
        with pytest.raises(ValueError, match="shared-memory limit"):
            ls.launch_plan(13, 2048, 32, 32, 224, kc, 2, h100, density=density)


def test_the_hybrid_spans_and_counters():
    # an engine of the reduced published hybrid: its decode opens a span
    # per run of Mamba2 layers and per block invocation, a spawn copies the
    # parent's state and a merge blends it, under spans of their own; the
    # counters hold the bytes
    from repro_torch import trace
    from repro_torch.core.engine import CortexEngine
    from repro_torch.core.prism import Prism
    from repro_torch.data.tokenizer import ByteTokenizer
    from repro_torch.serving.sampler import SamplingParams

    cfg = _cfg()
    eng = CortexEngine(Prism(make_weights(cfg, SEED, torch.device("cpu")), cfg, device="cpu"),
                       ByteTokenizer(cfg.vocab_size), n_main=1, max_side=2, main_capacity=128, side_max_steps=4,
                       sampling=SamplingParams(greedy=True), theta=-1.0, device="cpu")
    trace.clear()
    trace.enable()
    try:
        eng.submit("a river [TASK: one] [TASK: two] goes on", lane=0)
        eng.run(48)
    finally:
        trace.disable()
    recs = trace.records()
    trace.clear()
    by_id = {r.id: r for r in recs}
    runs = [r.attrs for r in recs if r.name == "decode.mamba"]
    assert {(a["layer"], a["count"]) for a in runs} == {(0, 1), (1, 1), (2, 2), (4, 1)}
    shared = {(r.attrs["invocation"], r.attrs["block"]) for r in recs if r.name == "decode.shared"}
    assert shared == {(0, 0), (1, 1), (2, 0)}
    assert {by_id[r.parent].name for r in recs if r.name == "spawn.state"} == {"engine.spawn"}
    assert {by_id[r.parent].name for r in recs if r.name == "merge.blend"} == {"engine.merge"}
    lane = eng.stats["recurrent_state_bytes"] // (eng.n_main + eng.max_side)
    assert lane == cfg.n_layers * (3 * (cfg.ssm_d_inner + 2 * 2 * cfg.ssm_state_size) * 4
                                   + cfg.ssm_n_heads * cfg.ssm_head_dim * cfg.ssm_state_size * 4)
    spawns, merges = (sum(r.name == n for r in recs) for n in ("spawn.state", "merge.blend"))
    assert spawns == eng.stats["spawns"] == 2 and merges >= 1
    assert eng.stats["state_copy_bytes"] == spawns * lane and eng.stats["state_blend_bytes"] == merges * lane
    assert eng.stats["attn_cache_bytes"] > 0
