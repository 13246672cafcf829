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


def test_wrappers_refuse_what_the_kernels_do_not_take(card):
    q, k, v, valid = _inputs((1, 4, 2, 64, 128), torch.float32, card)
    with pytest.raises(TypeError):
        sa.synapse_attention(q.half(), k.half(), v.half(), valid)
    with pytest.raises(ValueError, match="contiguous"):
        sa.synapse_attention(q, k.transpose(1, 2).contiguous().transpose(1, 2), v, valid)
    # 32 heads x a 2048-key range of f32 scores alone exceed shared memory
    long_k = torch.zeros((1, 16384, 2, 64), device=card)
    with pytest.raises(ValueError, match="shared-memory"):
        sa.synapse_attention(torch.zeros((1, 32, 64), device=card), long_k, long_k,
                             torch.ones((1, 16384), dtype=torch.bool, device=card))
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
