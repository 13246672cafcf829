"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: they need an NVIDIA card and ``nvcc`` and skip without
them (the fixture decides at run time, so every worker collects the same
tests). Run them on the card with
``PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py``
(``--noconftest``: the shared conftest imports JAX, which a card's host
need not have).
"""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels import landmark_score as ls
from repro_torch.kernels import ops
from repro_torch.kernels import ref
from repro_torch.kernels import synapse_attention as sa

pytestmark = pytest.mark.cuda

SHAPES = [
    # B, H, Hkv, D, T
    (1, 4, 4, 64, 128),
    (2, 8, 2, 64, 200),
    (2, 9, 3, 64, 321),
    (3, 16, 2, 80, 1000),
    (1, 32, 8, 128, 4096),
    (8, 14, 2, 64, 144),     # side-lane decode of the paper's model
    (24, 14, 2, 64, 1024),   # a spawn's sweep of the paper's model
    (2, 40, 2, 64, 96),      # G = 20: more rows than the kernels hold in registers at once
    (2, 8, 2, 64, 1),        # one key: a cluster of one CTA, a one-key tile
    (2, 8, 2, 64, 33),       # two ranges of 16 and 17 keys; a ragged tile
    (2, 16, 8, 64, 4096),    # Hkv = 8 at the longest T: streamed K/V chunks
    # the other families' (H, Hkv, D) at their side decode's T = K + W + J
    # and a spawn's T = 1024
    (8, 32, 32, 64, 136),    # zamba2's shared MHA block: 4 KB bf16 key rows, one p.V slice
    (6, 32, 32, 64, 1024),   # zamba2's spawn: 6 invocations x 1 lane, 32-key (bf16) / 16-key (f32) tiles
    (8, 32, 4, 128, 136),    # qwen3-moe: G = 8
    (48, 32, 4, 128, 1024),
    (8, 32, 8, 128, 136),    # qwen3-4b, qwen3-8b
    (8, 64, 8, 128, 136),    # qwen2-vl-72b, qwen1.5-110b
    (2, 64, 8, 128, 1024),
]
DTYPES = [torch.float32, torch.bfloat16]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _tol(dtype):
    return dict(rtol=2e-2, atol=2e-2) if dtype == torch.bfloat16 else dict(rtol=1e-5, atol=1e-5)


def _inputs(shape, dtype, dev, seed=0):
    B, H, Hkv, D, T = shape
    g = torch.Generator(device=dev).manual_seed(seed)
    r = lambda *s: torch.randn(s, generator=g, device=dev).to(dtype)
    valid = torch.rand((B, T), generator=g, device=dev) < 0.7
    valid[:, 0] = True
    return r(B, H, D), r(B, T, Hkv, D), r(B, T, Hkv, D), valid


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_synapse_attention_kernel_matches_plain(card, shape, dtype):
    q, k, v, valid = _inputs(shape, dtype, card)
    before = sa.KERNEL.launches
    out, mass = sa.synapse_attention(q, k, v, valid)
    torch.cuda.synchronize()
    assert sa.KERNEL.launches == before + 1
    out_r, mass_r = ref.synapse_attention_ref(q, k, v, valid)
    torch.testing.assert_close(out.float(), out_r.float(), **_tol(dtype))
    torch.testing.assert_close(mass, mass_r, **_tol(dtype))
    torch.testing.assert_close(mass.sum(-1), torch.full_like(mass[:, 0], shape[1]), rtol=1e-3, atol=0)
    again = sa.synapse_attention(q, k, v, valid)
    assert torch.equal(again[0], out) and torch.equal(again[1], mass)  # no atomics: bitwise repeatable


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("with_landmarks", [False, True])
def test_landmark_score_kernel_matches_plain(card, shape, dtype, with_landmarks):
    q, k, _, valid = _inputs(shape, dtype, card, seed=1)
    lm = torch.randn((shape[0], 7, shape[3]), device=card).to(dtype) if with_landmarks else None
    before = ls.KERNEL.launches
    logits, dist = ls.landmark_score(q, k, lm)
    torch.cuda.synchronize()
    assert ls.KERNEL.launches == before + 1
    logits_r, dist_r = ref.landmark_score_ref(q, k, lm)
    torch.testing.assert_close(logits, logits_r, **_tol(dtype))
    if lm is None:
        assert dist is None
    else:
        torch.testing.assert_close(dist, dist_r, **_tol(dtype))
    dens, _ = ops.landmark_score(q, k, None, valid)
    dens_r = torch.softmax(torch.where(valid[:, None], logits_r, torch.full_like(logits_r, ref.NEG_INF)), -1).sum(1)
    torch.testing.assert_close(dens, dens_r, **_tol(dtype))


def test_masked_keys_get_zero_mass_on_card(card):
    q, k, v, _ = _inputs((1, 4, 2, 64, 256), torch.float32, card)
    valid = torch.zeros((1, 256), dtype=torch.bool, device=card)
    valid[:, :10] = True
    _, mass = sa.synapse_attention(q, k, v, valid)
    assert float(mass[:, 10:].max()) < 1e-9
    np.testing.assert_allclose(float(mass.sum()), 4, rtol=1e-4)


@pytest.mark.parametrize("dtype", DTYPES)
def test_invalid_cta_range_and_lane_on_card(card, dtype):
    """One CTA's whole key range invalid (it adds e^(-1e30 - M) = 0) and one
    lane with no valid key at all (uniform weights, no NaN)."""
    shape = (3, 14, 2, 64, 144)
    q, k, v, valid = _inputs(shape, dtype, card, seed=2)
    plan = sa.launch_plan(3, 144, 14, 2, 64, q.element_size())
    a, b = plan.ranges[2]
    valid[0, a:b] = False
    valid[1] = False
    out, mass = sa.synapse_attention(q, k, v, valid)
    out_r, mass_r = ref.synapse_attention_ref(q, k, v, valid)
    torch.testing.assert_close(out.float(), out_r.float(), **_tol(dtype))
    torch.testing.assert_close(mass, mass_r, **_tol(dtype))
    assert float(mass[0, a:b].abs().max()) == 0.0
    torch.testing.assert_close(mass[1], torch.full_like(mass[1], 14 / 144), rtol=1e-5, atol=1e-6)


# (B, H, Hkv, D, T) whose ranges' f32 scores do not fit in shared memory
# beside the queries: the kernel spills them to a device workspace
LONG_T = [(8, 64, 8, 128, 4096), (1, 32, 2, 64, 16384)]


@pytest.mark.parametrize("shape", LONG_T)
@pytest.mark.parametrize("dtype", DTYPES)
def test_synapse_attention_long_key_sets(card, shape, dtype):
    """The spilled plan against the plain version, with masked keys (about
    30 %), one CTA's whole range of lane 0 masked, and bitwise repeats."""
    B, H, Hkv, D, T = shape
    q, k, v, valid = _inputs(shape, dtype, card, seed=3)
    plan = sa.launch_plan(B, T, H, Hkv, D, q.element_size())
    assert plan.spill
    a, b = plan.ranges[3]
    valid[0, a:b] = False
    before = sa.KERNEL.launches
    out, mass = sa.synapse_attention(q, k, v, valid)
    torch.cuda.synchronize()
    assert sa.KERNEL.launches == before + 1
    out_r, mass_r = ref.synapse_attention_ref(q, k, v, valid)
    torch.testing.assert_close(out.float(), out_r.float(), **_tol(dtype))
    torch.testing.assert_close(mass, mass_r, **_tol(dtype))
    torch.testing.assert_close(mass.sum(-1), torch.full_like(mass[:, 0], H), rtol=1e-3, atol=0)
    assert float(mass[0, a:b].abs().max()) == 0.0
    again = sa.synapse_attention(q, k, v, valid)
    assert torch.equal(again[0], out) and torch.equal(again[1], mass)


def test_wrappers_refuse_what_the_kernels_do_not_take(card):
    q, k, v, valid = _inputs((1, 4, 2, 64, 128), torch.float32, card)
    with pytest.raises(TypeError):
        sa.synapse_attention(q.half(), k.half(), v.half(), valid)
    with pytest.raises(ValueError, match="contiguous"):
        sa.synapse_attention(q, k.transpose(1, 2).contiguous().transpose(1, 2), v, valid)
    # a kv head's key row of 6 x 4 = 24 bytes is no multiple of 16
    odd_q, odd_k = torch.zeros((1, 4, 6), device=card), torch.zeros((1, 8, 2, 6), device=card)
    with pytest.raises(ValueError, match="multiple of 16"):
        sa.synapse_attention(odd_q, odd_k, odd_k, torch.ones((1, 8), dtype=torch.bool, device=card))
    with pytest.raises(ValueError, match="multiple of 16"):
        ls.landmark_score(odd_q, odd_k)
    with pytest.raises(ValueError, match="shared-memory"):
        ls.landmark_score(torch.zeros((1, 1024, 64), device=card), torch.zeros((1, 8, 2, 64), device=card))
    with pytest.raises(ValueError, match="multiple"):
        ls.landmark_score(torch.zeros((1, 5, 64), device=card), torch.zeros((1, 8, 2, 64), device=card))


# ---------------------------------------------------------------------------
# the serving path on the card: no host sync inside a window, and the
# BatchServer's speculative pipeline equal to its serial loop
# ---------------------------------------------------------------------------
def _smoke():
    """``chip_smoke.py``, whose sync guards these tests share."""
    root = str(Path(__file__).resolve().parents[1])
    if root not in sys.path:
        sys.path.insert(0, root)
    import chip_smoke

    return chip_smoke


def _reduced(card):
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import model as tmodel

    cfg = dataclasses.replace(get_config("qwen2.5-0.5b", reduced=True), compute_dtype="float32")
    return cfg, tmodel.init_params(cfg, seed=0, device=card)


def test_pipelined_window_makes_no_host_sync(card):
    """Every window's dispatch and ring prefetch, and every overlapped
    post-processing, run under set_sync_debug_mode("error"); the streams
    equal the serial loop's."""
    from repro_torch.core.engine import CortexEngine
    from repro_torch.core.prism import Prism
    from repro_torch.data.tokenizer import ByteTokenizer
    from repro_torch.serving.sampler import SamplingParams

    ops.build_kernels()
    cfg, params = _reduced(card)
    runs = {}
    for pipeline in (False, True):
        eng = CortexEngine(Prism(params, cfg, device=card), ByteTokenizer(cfg.vocab_size), n_main=2,
                           max_side=2, main_capacity=128, inject_tokens=8, theta=-1.0, side_max_steps=12,
                           sampling=SamplingParams(greedy=True), sync_every=4, max_window=16,
                           pipeline=pipeline, device=card)
        if pipeline:
            _smoke().guard_window_no_sync(eng)
        eng.submit("calm words [TASK: look closer] more calm words", lane=0)
        eng.submit("a second calm river", lane=1)
        eng.run(96)
        runs[pipeline] = eng
    piped, serial = runs[True], runs[False]
    assert piped.stats["overlapped_drains"] > 0 and max(piped.stats["window_hist"]) > 4
    assert any(e["event"] == "merge" for e in piped.history)
    for a, b in zip(piped.mains + piped.sides, serial.mains + serial.sides):
        assert a.tokens == b.tokens
    assert [e["event"] for e in piped.history] == [e["event"] for e in serial.history]


def test_batchserver_pipeline_equals_serial_on_card(card):
    """Through a surprise-EOS rollback (the EOS id is set to a token the
    model emits greedily); each step, and each undo record, without a host
    sync."""
    from repro_torch.data.tokenizer import ByteTokenizer
    from repro_torch.serving import server as tserver
    from repro_torch.serving.sampler import SamplingParams

    cfg, params = _reduced(card)
    tok = ByteTokenizer(cfg.vocab_size)
    probe = tserver.BatchServer(params, cfg, tok, n_lanes=2, capacity=64,
                                sampling=SamplingParams(greedy=True), device=card)
    probe.submit("probe the stream", max_new_tokens=12)
    done = probe.run_until_done(pipeline=False)
    tok.eos_id = done[0].tokens[done[0].prompt_len + 3]
    outs, stats = [], []
    for pipeline in (True, False):
        srv = tserver.BatchServer(params, cfg, tok, n_lanes=2, capacity=64,
                                  sampling=SamplingParams(temperature=1.0), seed=7, device=card)
        srv._step = _smoke().no_sync(srv._step)
        for prompt, n, sp in [("first request", 6, SamplingParams(greedy=True)),
                              ("second request", 9, SamplingParams(temperature=0.9, top_k=8)),
                              ("probe the stream", 12, SamplingParams(greedy=True)),
                              ("probe the stream", 40, SamplingParams(greedy=True))]:
            srv.submit(prompt, max_new_tokens=n, sampling=sp)
        outs.append(sorted((r.rid, tuple(r.tokens), r.status) for r in srv.run_until_done(pipeline=pipeline)))
        stats.append(dict(srv.stats))
    assert outs[0] == outs[1] and len(outs[0]) == 4
    assert stats[0]["rollbacks"] >= 1 and stats[0]["overlapped"] > 0
    assert stats[0]["steps"] == stats[1]["steps"]


# ---------------------------------------------------------------------------
# the memory tiers on the card: hibernate and wake bitwise in bf16, a wake
# committed inside a sync-guarded window, a cold round trip of device tensors
# ---------------------------------------------------------------------------
def _bf16_engine(card, params, cfg, store=None, **kw):
    from repro_torch.core.engine import CortexEngine
    from repro_torch.core.prism import Prism
    from repro_torch.data.tokenizer import ByteTokenizer
    from repro_torch.serving.sampler import SamplingParams

    return CortexEngine(Prism(params, cfg, device=card), ByteTokenizer(cfg.vocab_size), n_main=2, max_side=2,
                        main_capacity=128, inject_tokens=8, theta=-1.0, side_max_steps=50,
                        sampling=SamplingParams(greedy=True), sync_every=4, store=store, device=card, **kw)


@pytest.mark.parametrize("tier", ["warm", "cold"])
def test_hibernate_wake_bitwise_bf16_on_card(card, tier, tmp_path):
    """A river hibernated, displaced and woken into the other lane, and a
    side hibernated mid-decode, continue bitwise in bf16 against engines
    that never hibernated."""
    from repro_torch.configs import get_config
    from repro_torch.memory import SynapseStore
    from repro_torch.models import model as tmodel

    ops.build_kernels()
    cfg = get_config("qwen2.5-0.5b", reduced=True)
    assert cfg.compute_dtype == "bfloat16"
    params = tmodel.init_params(cfg, seed=0, device=card)
    store = lambda name: SynapseStore(warm_capacity_bytes=1, cold_dir=str(tmp_path / name)) if tier == "cold" else None
    ref = _bf16_engine(card, params, cfg)
    m = ref.submit("calm text with no tags at all", lane=0, agent_id="alice")
    ref._spawn_side(m, "probe the claim")
    ref.run(48)
    eng = _bf16_engine(card, params, cfg, store=store("side"))
    m = eng.submit("calm text with no tags at all", lane=0, agent_id="alice")
    eng._spawn_side(m, "probe the claim")
    eng.run(28)
    eng.hibernate("side0")
    assert eng.store.tier_of("side0") == tier and eng.state.side_active.device.type == card.type
    eng.run(4)
    side = eng.wake("side0", wait=True)
    eng.run(16)
    assert side.tokens == ref.sides[0].tokens[: len(side.tokens)] and len(side.tokens) > side.prompt_len + 20
    assert eng.mains[0].tokens == ref.mains[0].tokens

    ref = _bf16_engine(card, params, cfg)
    ref.submit("another quiet prompt, still tagless", lane=0, agent_id="bob")
    ref.run(40)
    eng = _bf16_engine(card, params, cfg, store=store("river"))
    eng.submit("another quiet prompt, still tagless", lane=0, agent_id="bob")
    eng.run(8)
    eng.hibernate("bob")
    eng.submit("a displacing resident", lane=0, agent_id="carol")
    eng.run(4)
    bob = eng.wake("bob", wait=True)
    assert bob.lane == 1
    eng.run(20)
    assert bob.tokens == ref.mains[0].tokens[: len(bob.tokens)] and len(bob.tokens) > bob.prompt_len + 20


def test_wake_commits_inside_a_sync_guarded_window(card, tmp_path):
    """A cold wake that lands while ``run`` goes on: every window's dispatch
    and prefetch, every overlapped post-processing and the wake's commit run
    under set_sync_debug_mode("error") (process-wide, so the prefetch
    worker's copies are checked too); the stream is the never-hibernated
    one's."""
    from repro_torch.configs import get_config
    from repro_torch.memory import SynapseStore
    from repro_torch.models import model as tmodel

    cfg = get_config("qwen2.5-0.5b", reduced=True)
    params = tmodel.init_params(cfg, seed=0, device=card)
    ref = _bf16_engine(card, params, cfg, max_window=16)
    ref.submit("calm text with no tags at all", lane=0, agent_id="alice")
    ref.run(64)
    eng = _bf16_engine(card, params, cfg, max_window=16,
                       store=SynapseStore(warm_capacity_bytes=1, cold_dir=str(tmp_path)))
    eng.submit("calm text with no tags at all", lane=0, agent_id="alice")
    eng.run(8)
    eng.hibernate("alice")
    eng.submit("another quiet prompt, still tagless", lane=0, agent_id="bob")
    smoke = _smoke()
    overlapped, commits = [0], [0]
    smoke.guard_window_no_sync(eng, overlapped)
    eng._commit_wake = smoke.no_sync(eng._commit_wake, commits)
    eng.wake("alice")
    eng.run(48)
    alice = next(m for m in eng.mains if m.agent_id == "alice")
    assert commits[0] == 1 and eng.stats["wakes"] == 1 and eng.stats["wake_failures"] == 0
    assert overlapped[0] > 0
    assert alice.tokens == ref.mains[0].tokens[: len(alice.tokens)] and len(alice.tokens) > alice.prompt_len + 20


def test_cold_round_trip_of_device_tensors(card, tmp_path):
    """Card tensors (bf16, f32, int32, a strided lane view) through the cold
    tier come back bitwise, and the prefetch lands them on the card on its
    own stream, ordered by an event."""
    from repro_torch.checkpoint import io as ckpt_io
    from repro_torch.memory import SynapseStore
    from repro_torch.memory import store as tstore

    g = torch.Generator(device=card).manual_seed(0)
    full = torch.randn((4, 3, 64, 2, 64), generator=g, device=card).to(torch.bfloat16)
    snap = {"caches": full[:, 1:2], "hidden": torch.randn(896, generator=g, device=card),
            "tok": torch.tensor(7, dtype=torch.int32, device=card)}
    want = ckpt_io.tree_map(lambda t: t.cpu(), snap)
    store = SynapseStore(warm_capacity_bytes=1, cold_dir=str(tmp_path))
    store.put("a", snap)
    full.zero_()  # the store kept a copy, not a view
    assert store.tier_of("a") == "cold"
    host = store.get_host("a")
    for k in want:
        assert host[k].device.type == "cpu" and ckpt_io.leaf_bytes(host[k]) == ckpt_io.leaf_bytes(want[k])
    tree, event = store.prefetch("a", tstore.device_put_fn(card)).result(timeout=60)
    assert isinstance(event, torch.cuda.Event)
    tree = tstore.ready_on_stream(tree, event, card)
    for k in want:
        assert tree[k].device.type == "cuda" and torch.equal(tree[k].cpu(), want[k])


@pytest.mark.parametrize("tier", ["warm", "cold"])
@pytest.mark.parametrize("pipeline", [False, True])
def test_batchserver_park_unpark_bitwise_on_card(card, pipeline, tier, tmp_path):
    """A request parked into the store and resumed in the other lane, in
    bf16: both requests' tokens equal a run that never parked, and every
    admission of unparked requests runs under set_sync_debug_mode("error")
    (the resume reads its position from the snapshot's meta, not the
    card)."""
    from repro_torch.configs import get_config
    from repro_torch.data.tokenizer import ByteTokenizer
    from repro_torch.memory import SynapseStore
    from repro_torch.models import model as tmodel

    cfg = get_config("qwen2.5-0.5b", reduced=True)
    params = tmodel.init_params(cfg, seed=0, device=card)
    tok = ByteTokenizer(cfg.vocab_size)
    store = SynapseStore(warm_capacity_bytes=1, cold_dir=str(tmp_path)) if tier == "cold" else SynapseStore()
    smoke = _smoke()
    never = smoke.park_run(params, cfg, tok, pipeline)
    got = smoke.park_run(params, cfg, tok, pipeline, store)
    assert got["tier"] == tier and got["a_lane"] == 1
    assert (got["a"], got["b"]) == (never["a"], never["b"])
    assert got["guarded"] >= 1 and got["in_store"] == 0 and got["stats"]["lost_requests"] == 0


def test_zamba2_engine_on_card_equals_the_cpu(card):
    """Reduced zamba2 (Mamba2 layers, the shared block's stacked caches) in
    f32: the pipelined engine on the card, every window under the sync
    guard, against the serial engine on the CPU — the same greedy streams
    and merges; a spawn is one landmark_score launch (the shared stack
    folded into one sweep) and a side tick one synapse_attention launch per
    shared invocation."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.core.engine import CortexEngine
    from repro_torch.core.prism import Prism
    from repro_torch.data.tokenizer import ByteTokenizer
    from repro_torch.models import model as tmodel
    from repro_torch.serving.sampler import SamplingParams

    ops.build_kernels()
    cfg = dataclasses.replace(get_config("zamba2-1.2b", reduced=True), compute_dtype="float32")
    params = tmodel.init_params(cfg, seed=0, device="cpu")
    runs = {}
    for dev in ("cpu", card):
        eng = CortexEngine(Prism(params, cfg, device=dev), ByteTokenizer(cfg.vocab_size), n_main=1, max_side=2,
                           main_capacity=128, inject_tokens=8, theta=-1.0, side_max_steps=8,
                           sampling=SamplingParams(greedy=True), sync_every=4, pipeline=dev != "cpu", device=dev)
        if dev != "cpu":
            _smoke().guard_window_no_sync(eng)
        ops.reset_launches()
        eng.submit("hi [TASK: check it] ok", lane=0)
        eng.run(48)
        runs[dev] = (eng, ops.launch_counts())
    (ref, _), (got, counts) = runs["cpu"], runs[card]
    for a, b in zip(ref.mains + ref.sides, got.mains + got.sides):
        assert b.tokens == a.tokens
    assert [e["event"] for e in got.history] == [e["event"] for e in ref.history] == ["spawn", "merge"]
    assert counts["landmark_score"] == 1
    assert counts["synapse_attention"] > 0 and counts["synapse_attention"] % cfg.n_shared_attn_invocations == 0


# ---------------------------------------------------------------------------
# training on the card
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ["qwen2.5-0.5b", "zamba2-1.2b", "qwen3-moe-30b-a3b"])
def test_reduced_train_step_on_card(card, arch):
    """Two steps at the reduced config in bf16: finite losses, every
    parameter leaf and Adam moment on the card, the params changed, and
    neither Cortex kernel launched (the train forward attends plainly)."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, batch_to, make_batch
    from repro_torch.models import model as tmodel
    from repro_torch.training.optimizer import AdamWConfig
    from repro_torch.training.trainer import init_train_state, make_train_step

    cfg = get_config(arch, reduced=True)
    state = init_train_state(cfg, seed=0, device=card)
    before = [p.detach().clone() for p in tmodel.tree_leaves(state.params)]
    step = make_train_step(cfg, AdamWConfig(warmup_steps=1, total_steps=10))
    ops.reset_launches()
    for i in range(2):
        state, m = step(state, batch_to(make_batch(cfg, DataConfig(seq_len=64, batch_size=4, seed=i)), card))
        assert torch.isfinite(m["loss"]) and m["loss"].device.type == "cuda"
    assert ops.launch_counts() == {"synapse_attention": 0, "landmark_score": 0}
    for tree in (state.params, state.opt.m, state.opt.v):
        assert all(a.is_cuda for a in tmodel.tree_leaves(tree))
    assert state.opt.step.is_cuda and int(state.step) == 2
    assert max(float((p.detach() - p0).abs().max()) for p, p0 in zip(tmodel.tree_leaves(state.params), before)) > 0


def test_adamw_update_on_card_equals_the_cpu(card):
    """Three AdamW steps with clipping on the same f32 tensors on the card
    and on the CPU: rtol 1e-5 (elementwise f32 arithmetic; the global norm
    sums in another order)."""
    from repro_torch.models import model as tmodel
    from repro_torch.training.optimizer import AdamWConfig, adamw_update, init_adamw

    rng = np.random.default_rng(0)
    f = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
    params = {"groups": [{"ln1": 1 + 0.1 * f(2, 64), "w": f(2, 64, 96)}], "embed": f(512, 64), "norm": f(64)}
    grads = [tmodel.tree_map(lambda a: 3 * f(*a.shape), params) for _ in range(3)]
    cfg = AdamWConfig(lr=1e-2, warmup_steps=1, total_steps=5)
    out = {}
    for dev in ("cpu", card):
        p = tmodel.tree_map(lambda a: a.to(dev), params)
        s = init_adamw(p)
        for g in grads:
            p, s, m = adamw_update(cfg, p, tmodel.tree_map(lambda a: a.to(dev), g), s)
        out[dev] = (p, s, m)
    (p0, s0, m0), (p1, s1, m1) = out["cpu"], out[card]
    for tree0, tree1 in ((p0, p1), (s0.m, s1.m), (s0.v, s1.v)):
        for a, b in zip(tmodel.tree_leaves(tree0), tmodel.tree_leaves(tree1)):
            assert b.is_cuda
            torch.testing.assert_close(b.cpu(), a, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(m1["grad_norm"].cpu(), m0["grad_norm"], rtol=1e-5, atol=0)
    assert int(s1.step) == int(s0.step) == 3


# ---------------------------------------------------------------------------
# the card's halves of the ported fused-tick and macro-tick cases, and the
# long-context example's constant memory
# ---------------------------------------------------------------------------
def _window_engine(card, n_layers=2, **kw):
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.core.engine import CortexEngine
    from repro_torch.core.prism import Prism
    from repro_torch.data.tokenizer import ByteTokenizer
    from repro_torch.models import model as tmodel
    from repro_torch.serving.sampler import SamplingParams

    ops.build_kernels()
    cfg = dataclasses.replace(get_config("qwen2.5-0.5b", reduced=True), compute_dtype="float32", n_layers=n_layers)
    eng = CortexEngine(Prism(tmodel.init_params(cfg, seed=0, device=card), cfg, device=card),
                       ByteTokenizer(cfg.vocab_size), n_main=2, max_side=2, theta=-1.0, side_max_steps=64,
                       inject_tokens=8, sampling=SamplingParams(greedy=True), device=card, **kw)
    eng.submit("calm words [TASK: look closer] more calm words", lane=0)
    eng.submit("a second calm river", lane=1)
    return eng


def test_ticks_inside_a_window_make_no_host_sync(card):
    """test_torch_fused_tick.py's and test_torch_macro_tick.py's no-sync
    cases on the card: ticks 1..3 of a window and a whole window each run
    under set_sync_debug_mode("error") as one dispatch; only the drain
    syncs, once."""
    eng = _window_engine(card, main_capacity=128, sync_every=4)
    assert any(s.active for s in eng.sides)
    for _ in range(4):
        eng.tick()
    base = dict(eng.stats)
    guarded_tick = _smoke().no_sync(eng.tick)
    for _ in range(3):
        guarded_tick()
    assert eng.stats["tick_dispatches"] - base["tick_dispatches"] == 3
    assert (eng.stats["host_syncs"], eng.stats["drains"]) == (base["host_syncs"], base["drains"])
    eng.tick()  # the 4th tick drains
    assert eng.stats["host_syncs"] == base["host_syncs"] + 1
    _smoke().no_sync(eng._dispatch_window)(eng.sync_every)
    assert eng.stats["host_syncs"] == base["host_syncs"] + 1
    assert eng.stats["macro_dispatches"] - base["macro_dispatches"] == 1
    eng.drain()
    assert eng.stats["host_syncs"] == base["host_syncs"] + 2


def test_macro_window_has_no_peak_memory_growth(card):
    """test_torch_macro_tick.py's in-place case on the card: over a window
    with live sides, max_memory_allocated (reset just before) stays within
    the bytes allocated before it plus a slack of a quarter of the caches'
    bytes, where a copy of the caches would add all of them. 8 layers, so
    one layer's working set is an eighth of the caches."""
    eng = _window_engine(card, n_layers=8, main_capacity=1024, sync_every=8)
    eng.run(16)  # warm: the first window's allocations are cached
    assert any(s.active for s in eng.sides)
    tensors = eng.state.main_caches.tensors() + eng.state.side_caches.tensors()
    cache_bytes = sum(t.numel() * t.element_size() for t in tensors)
    ptrs = [t.data_ptr() for t in tensors]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    eng._dispatch_window(eng.sync_every)
    torch.cuda.synchronize()
    growth = torch.cuda.max_memory_allocated() - before
    eng.drain()
    assert growth < cache_bytes / 4, (growth, cache_bytes)
    assert [t.data_ptr() for t in tensors] == ptrs


def test_long_context_memory_is_constant_on_card(card):
    """The long-context example at its reduced size on the card: one
    synapse_attention launch per layer and step, memory_allocated the same
    after step 10 and after the last, the cache's bytes constant."""
    from repro_torch.examples import long_context_synapse

    ops.build_kernels()
    ops.reset_launches()
    out = long_context_synapse.main(["--device", "cuda"])
    assert ops.launch_counts() == {"landmark_score": 0, "synapse_attention": out["layers"] * out["steps"]}
    assert out["memory_allocated_step10"] == out["memory_allocated_last"] > 0
    assert out["synapse_bytes"] == out["synapse_bytes_step1"] == out["synapse_bytes_last"]
    assert out["logits_finite"] and out["lm_count"] == out["spec"]["n_landmarks"]


# ---------------------------------------------------------------------------
# lane groups on the card: a NCCL group of one rank, with chip_smoke.py
# phase 10's checks at the reduced config
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def lane_mesh(tmp_path_factory):
    """A NCCL lane group of one rank in this process (``chip_smoke.lane_group``)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: a NCCL lane group")
    with _smoke().lane_group(tmp_path_factory.mktemp("lanes") / "store") as mesh:
        yield mesh


def _lane_setup(card):
    from repro_torch.configs import get_config
    from repro_torch.core.prism import Prism
    from repro_torch.data.tokenizer import ByteTokenizer
    from repro_torch.models import model as tmodel

    ops.build_kernels()
    cfg = get_config("qwen2.5-0.5b", reduced=True)  # bf16, the card's dtype
    return cfg, Prism(tmodel.init_params(cfg, seed=0, device=card), cfg, device=card), ByteTokenizer(cfg.vocab_size)


def test_lane_group_of_one_engine_equals_plain_on_card(card, lane_mesh):
    """Phase 10's engine checks: the mesh-of-one engine's streams, spawns,
    merges and gate scores bitwise the plain engine's; one ring all-gather
    per drain and one in a window run under set_sync_debug_mode("error");
    the kernels once per spawn and once per layer and side tick; the peak
    within the gathered ring buffer of the plain run's; two sides woken into
    each other's lanes keep every stream."""
    cs = _smoke()
    cfg, prism, tok = _lane_setup(card)
    kw = dict(cs.MAIN, side_max_steps=16)
    plain = cs.lane_run(prism, tok, None, engine_kw=kw)
    lane = cs.lane_run(prism, tok, lane_mesh, engine_kw=kw)
    cs.check_lane_runs(plain, lane, cfg)
    swapped = cs.lane_run(prism, tok, lane_mesh, engine_kw=kw, swap=True)
    assert swapped["streams"] == plain["streams"]
    assert set(swapped["lanes"].values()) == {0, 1}


@pytest.mark.parametrize("pipeline", [True, False])
def test_lane_group_batch_server_on_card(card, lane_mesh, pipeline):
    cs = _smoke()
    cfg, prism, tok = _lane_setup(card)
    got = cs.lane_batch(prism.params, cfg, tok, lane_mesh, pipeline, n_tokens=12)
    assert got == cs.lane_batch(prism.params, cfg, tok, None, pipeline, n_tokens=12)


def test_piece_attend_local_path_launches_the_kernel_once(card):
    """With no token axis, piece_attend is one synapse_attention launch over
    the concatenated pieces: bitwise the kernel's own result."""
    from repro_torch.core import synapse_sharded as sh

    ops.build_kernels()
    g = torch.Generator(device=card).manual_seed(0)
    q = torch.randn((8, 14, 64), generator=g, device=card).to(torch.bfloat16)
    pieces = [tuple(torch.randn((8, T, 2, 64), generator=g, device=card).to(torch.bfloat16) for _ in range(2))
              for T in (64, 64, 16)]
    valids = [torch.rand((8, T), generator=g, device=card) < 0.8 for T in (64, 64, 16)]
    before = sa.KERNEL.launches
    out, masses = sh.piece_attend(q, pieces, valids, 0.125)
    torch.cuda.synchronize()
    assert sa.KERNEL.launches == before + 1
    want_out, want_mass = ops.synapse_attention(q, torch.cat([k for k, _ in pieces], 1),
                                                torch.cat([v for _, v in pieces], 1), torch.cat(valids, 1),
                                                scale=0.125)
    assert torch.equal(out, want_out) and torch.equal(torch.cat(masses, 1), want_mass)


def test_make_lane_mesh_refuses_gloo_for_a_cuda_mesh(card, lane_mesh):
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_lane_mesh

    gloo = dist.new_group(backend="gloo")
    with pytest.raises(ValueError, match="needs nccl"):
        make_lane_mesh(group=gloo, device=card)
    with pytest.raises(ValueError, match="needs gloo"):
        make_lane_mesh(group=lane_mesh.group, device="cpu")
    assert lane_mesh.world == 1 and dist.get_backend(lane_mesh.group) == "nccl"


# ---------------------------------------------------------------------------
# training over a mesh on the card, and the wrappers' meta branch
# ---------------------------------------------------------------------------
def test_train_mesh_single_of_one_equals_debug_on_card(card, lane_mesh):
    """``launch.train --mesh single`` on the NCCL group of one ((1, 1)
    mesh; the reduced config, bf16) gives ``--mesh debug``'s losses
    (chip_smoke phase 11's check: bitwise or within 1e-5 relative) and
    launches neither kernel."""
    from repro_torch.launch import train as launch_train

    argv = ["--arch", "qwen2.5-0.5b", "--steps", "3", "--seq", "64", "--batch", "4"]
    ops.reset_launches()
    mesh = launch_train.main(argv + ["--mesh", "single"])
    assert mesh["mesh"] == (1, 1) and not any(ops.launch_counts().values())
    debug = launch_train.main(argv + ["--mesh", "debug"])
    _smoke().check_mesh_losses(mesh["losses"], debug["losses"])


def test_kernel_wrappers_meta_branch_never_launches_and_cuda_does(card):
    ops.build_kernels()
    q, k, v, valid = _inputs((2, 8, 2, 64, 200), torch.bfloat16, card)
    meta = lambda t: torch.empty_like(t, device="meta")
    before = (sa.KERNEL.launches, ls.KERNEL.launches)
    out, mass = sa.synapse_attention(meta(q), meta(k), meta(v), meta(valid))
    lm = k[:, :4, 0].contiguous()
    logits, dist = ls.landmark_score(meta(q), meta(k), meta(lm))
    assert out.is_meta and mass.shape == (2, 200) and logits.shape == (2, 8, 200) and dist.is_meta
    assert (sa.KERNEL.launches, ls.KERNEL.launches) == before
    sa.synapse_attention(q, k, v, valid)
    ls.landmark_score(q, k, lm)
    torch.cuda.synchronize()
    assert (sa.KERNEL.launches, ls.KERNEL.launches) == (before[0] + 1, before[1] + 1)
