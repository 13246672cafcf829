"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases, each failing the run on its own failure:

1. Build both CUDA kernels from ``src/repro_torch/kernels/csrc`` (one nvcc
   per source, in parallel) and print each one's ptxas summary.
2. Print each kernel's launch plan at the main path's shape (grid,
   cluster, shared-memory bytes) and its ptxas registers and spills. Hold
   each kernel against its plain PyTorch version on the card, at the main
   path's shapes, the kernel-test shapes and the edge shapes (T = 1, 33,
   4096; Hkv = 8; G = 20; a CTA range and a lane with no valid key), in
   f32 (rtol = atol = 1e-5) and bf16 (2e-2), both ``landmark_score``
   branches, each twice to check that the results repeat bitwise; time the
   kernel, the plain version and a one-call library yardstick. Each
   kernel's log line also shows its time before the redesign
   (``EARLIER_MS``, a constant: the ``kernels`` line carries only numbers
   this run measured, and ``bound_ms``).
3. Check the port's model on the card against the same model on the CPU on
   a small input (reduced config, f32, no TF32): logits within 1e-4.
4. Drive the main path at full width: Qwen2.5-0.5B (24 layers, d_model 896,
   vocab 151936, bf16, random weights from a seed) in a CortexEngine whose
   prompt spawns side agents, until every side has merged. Launch counters
   are zeroed just before and read just after; one steady window runs under
   ``torch.cuda.set_sync_debug_mode("error")``.
5. Serve at full width through the serving entry point's classes (the
   front end over each backend, as ``repro_torch.launch.serve`` builds
   them): the pipelined, adaptive-window CortexEngine with four requests
   from two weighted tenants, one prompt spawning sides (every request
   ``ok``, a spawn and a merge, overlapped drains, a window longer than
   ``sync_every``, one ``landmark_score`` launch per spawn and one
   ``synapse_attention`` launch per layer and side tick, each request's
   first tokens, every side stream and the spawns and merges in order equal
   to a ``pipeline=False`` run's, every window's dispatch and overlapped
   post-processing under ``set_sync_debug_mode("error")``); the front end
   over the plain BatchServer's pipelined loop, bitwise equal to the
   server's serial loop; one request over the HTTP/SSE transport, ``ok``,
   its token count over ``GET /v1/metrics`` equal to the in-process one.
   On the full config that is a timing and wire-path run (the random
   full-vocabulary model emits no byte id, so the texts are empty); on the
   reduced config the SSE text, not empty, must equal the in-process
   stream's. Each mode prints its TTFT and tick percentiles, tokens/s,
   memory and seconds.
6. The memory tiers at full width: the pipelined engine of phase 5 with a
   ``SynapseStore`` whose warm tier holds less than one river snapshot and
   whose cold tier is a directory under ``build/``. River alice's two tags
   spawn two sides; river bob has none. After 32 ticks both sides
   (mid-decode) and bob hibernate and go cold; device memory holds none of
   their bytes and each bf16 snapshot's cold round trip is bitwise. Woken at
   once, every stream, spawn and merge (gate scores included) equals a
   never-hibernated run's. Woken after 16 ticks while ``run`` goes on (the
   sides into each other's lanes; every window dispatched while a prefetch
   is in flight and each commit under ``set_sync_debug_mode("error")``), the
   side streams, the merges' agents, thoughts and acceptance, bob's stream
   and alice's up to the reference's merge equal that run's, and the
   kernels launched once per spawn and once per layer and side tick. Then a
   kill and restart (bob warm, woken, hibernated and demoted; a new store
   recovers the directory and a new engine adopts and wakes him: his stream
   goes on as the reference's), and ``python -m repro_torch.launch.serve``
   in process with ``--cold-dir`` and then ``--cold-dir --recover`` over a
   dead process's agent (reduced config). Prints the snapshot and blob
   bytes, the codec, hibernate and wake-to-commit times.
7. Print the ``kernels`` JSON line, the card's name and power limit, and
   the result line.

With no card it exits non-zero at once and prints no result.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import statistics
import subprocess
from collections import Counter
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
BF16_FLOP_PER_S = 989e12       # H100 SXM dense bf16 tensor-core peak
MAIN = dict(n_main=1, max_side=8, main_capacity=1024, sync_every=8, theta=-1.0)
PROMPT = ("The river thinks aloud while its streams work. "
          "[TASK: list the open questions] [TASK: check the last claim] "
          "[TASK: summarise the context so far] Then it goes on.")
SYN_MAIN = (MAIN["max_side"], 14, 2, 64, 64 + 64 + 16)  # side decode: B, H, Hkv, D, T = K + W + J
LM_MAIN = (24, 14, 2, 64, MAIN["main_capacity"])        # spawn: 24 layers x 1 parent lane
TEST_SHAPES = [  # B, H, Hkv, D, T of the kernel tests, and one wide group
    (1, 4, 4, 64, 128), (2, 8, 2, 64, 200), (2, 9, 3, 64, 321),
    (3, 16, 2, 80, 1000), (1, 32, 8, 128, 4096),
    (2, 40, 2, 64, 96),  # G = 20: more query rows than the kernels hold in registers at once
    (2, 8, 2, 64, 1), (2, 8, 2, 64, 33),  # one key; two ranges and a ragged tile
    (2, 16, 8, 64, 4096),  # Hkv = 8 at the longest T
]
# The kernels' times before their redesign, main-path shapes, bf16, L2
# flushed (PERF.md section 6, earlier ms; NVIDIA H100 80GB HBM3, 700.00 W)
EARLIER_MS = {"synapse_attention": 0.0820, "landmark_score": 0.0592}
TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
TIMED_WINDOWS = 5  # main-path windows timed (the first is warm-up), then one profiled


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=30)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 30) -> float:
    """Median device time of one call with the L2 cache flushed before it
    (the 50 MB L2 is cold for these callers: a spawn reads the parent cache
    once, and a decode step streams ~1 GB of weights between attends). The
    flush is large (1 GiB) so that the device is still zeroing it when the
    host has enqueued the call: the host's enqueue time, which a call of
    many small launches can spend, does not enter the reading."""
    flush = torch.empty(1 << 30, dtype=torch.uint8, device="cuda")
    fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(iters):
        flush.zero_()
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        pairs.append((s, e))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def bound(byts: int, flops: int) -> dict:
    """The least time of the work: bytes over HBM rate vs operations over
    the bf16 peak, whichever is larger."""
    t_bytes, t_ops = byts / HBM_BYTES_PER_S * 1e3, flops / BF16_FLOP_PER_S * 1e3
    return dict(bound_ms=max(t_bytes, t_ops), bound_by="bytes" if t_bytes >= t_ops else "operations",
                bytes=byts, flops=flops)


def kernel_inputs(shape, dtype, g):
    """q [B,H,D], keys and values [B,T,Hkv,D], valid [B,T] (about 70 %
    true, key 0 always) and 7 landmarks [B,7,D], random from ``g`` on its
    device."""
    B, H, Hkv, D, T = shape
    r = lambda *s: torch.randn(s, generator=g, device=g.device).to(dtype)
    valid = torch.rand((B, T), generator=g, device=g.device) < 0.7
    valid[:, 0] = True
    return r(B, H, D), r(B, T, Hkv, D), r(B, T, Hkv, D), valid, r(B, 7, D)


def new_engine():
    """The main path's engine: Qwen2.5-0.5B at full width, random weights
    from seed 0, greedy, the ``MAIN`` settings. Returns (config, engine)."""
    from repro_torch.configs import get_config
    from repro_torch.core.engine import CortexEngine
    from repro_torch.core.prism import Prism
    from repro_torch.data.tokenizer import ByteTokenizer
    from repro_torch.models import model as tm
    from repro_torch.serving.sampler import SamplingParams

    cfg = get_config("qwen2.5-0.5b")
    prism = Prism(tm.init_params(cfg, seed=0), cfg)
    return cfg, CortexEngine(prism, ByteTokenizer(cfg.vocab_size), sampling=SamplingParams(greedy=True), **MAIN)


# ---------------------------------------------------------------------------
def check_kernels(dev):
    """Phase 2. Returns {name: record} with the errors and times."""
    from repro_torch.kernels import build
    from repro_torch.kernels import landmark_score as ls
    from repro_torch.kernels import ref
    from repro_torch.kernels import synapse_attention as sa

    B, H, Hkv, D, T = SYN_MAIN
    log(f"plan synapse_attention shape={SYN_MAIN} bf16: {sa.launch_plan(B, T, H, Hkv, D, 2)}")
    B, H, Hkv, D, T = LM_MAIN
    log(f"plan landmark_score shape={LM_MAIN} bf16 density-only: {ls.launch_plan(B, T, H, Hkv, D, 0, 2)}")
    for name in ("synapse_attention", "landmark_score"):
        log(f"ptxas {name}: {build.ptxas_info(name)}")

    g = torch.Generator(device=dev).manual_seed(0)
    inputs = lambda shape, dtype: kernel_inputs(shape, dtype, g)

    def repeat_bitwise(fn, got):
        again = fn()
        if not all(a is b is None or torch.equal(a, b) for a, b in zip(again, got)):
            raise AssertionError("two calls on the same inputs differ: the kernel is not repeatable")

    worst = {"synapse_attention": 0.0, "landmark_score": 0.0}
    # the main side-decode shape again, with the last CTA's range of lane 0
    # and all of lane 1 invalid
    cases = [(shape, None) for shape in [SYN_MAIN, LM_MAIN] + TEST_SHAPES] + [(SYN_MAIN, "invalid")]
    for shape, mask in cases:
        for dtype in (torch.float32, torch.bfloat16):
            t = dict(rtol=TOL[dtype], atol=TOL[dtype])
            q, k, v, valid, lm = inputs(shape, dtype)
            if mask == "invalid":
                B, H, Hkv, D, T = shape
                a, b = sa.launch_plan(B, T, H, Hkv, D, q.element_size()).ranges[-1]
                valid[0, a:b] = False
                valid[1] = False
            out, mass = sa.synapse_attention(q, k, v, valid)
            out_r, mass_r = ref.synapse_attention_ref(q, k, v, valid)
            torch.testing.assert_close(out.float(), out_r.float(), **t)
            torch.testing.assert_close(mass, mass_r, **t)
            torch.testing.assert_close(mass.sum(-1), torch.full_like(mass[:, 0], shape[1]), rtol=1e-3, atol=0)
            repeat_bitwise(lambda: sa.synapse_attention(q, k, v, valid), (out, mass))
            e_sa = max(max_err(out, out_r), max_err(mass, mass_r))
            e_ls = 0.0
            for landmarks in (None, lm):
                logits, dist = ls.landmark_score(q, k, landmarks)
                logits_r, dist_r = ref.landmark_score_ref(q, k, landmarks)
                torch.testing.assert_close(logits, logits_r, **t)
                repeat_bitwise(lambda: ls.landmark_score(q, k, landmarks), (logits, dist))
                e_ls = max(e_ls, max_err(logits, logits_r))
                if landmarks is None:
                    assert dist is None
                else:
                    torch.testing.assert_close(dist, dist_r, **t)
                    e_ls = max(e_ls, max_err(dist, dist_r))
            log(f"check shape={shape}{' ' + mask if mask else ''} dtype={str(dtype)[6:]} "
                f"synapse_attention max_abs_err={e_sa:.3g} landmark_score max_abs_err={e_ls:.3g}")
            worst["synapse_attention"] = max(worst["synapse_attention"], e_sa)
            worst["landmark_score"] = max(worst["landmark_score"], e_ls)

    recs = {}
    # times at the main path's shapes, in the working type (bf16)
    B, H, Hkv, D, T = SYN_MAIN
    q, k, v, valid, _ = inputs(SYN_MAIN, torch.bfloat16)
    qs, ks, vs = q[:, :, None], k.transpose(1, 2).contiguous(), v.transpose(1, 2).contiguous()
    mask = valid[:, None, None, :]
    recs["synapse_attention"] = dict(
        name="synapse_attention", route="cuda",
        source="src/repro_torch/kernels/csrc/synapse_attention.cu",
        replaces="src/repro/kernels/synapse_attention.py:131",
        max_abs_err=worst["synapse_attention"],
        ms=time_ms(lambda: sa.synapse_attention(q, k, v, valid)),
        earlier_ms=EARLIER_MS["synapse_attention"],
        plain_ms=time_ms(lambda: ref.synapse_attention_ref(q, k, v, valid)),
        # SDPA gives out but not the per-key mass: a partial yardstick
        library_ms=time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            qs, ks, vs, attn_mask=mask, enable_gqa=True)),
        **bound(q.numel() * 2 * 2 + 2 * k.numel() * 2 + valid.numel() + B * T * 4, 4 * B * H * T * D),
        shape=list(SYN_MAIN), dtype="bfloat16",
    )
    B, H, Hkv, D, T = LM_MAIN
    q, k, _, _, _ = inputs(LM_MAIN, torch.bfloat16)
    qg, kt = q.reshape(B, Hkv, H // Hkv, D), k.permute(0, 2, 3, 1).contiguous()
    recs["landmark_score"] = dict(
        name="landmark_score", route="cuda",
        source="src/repro_torch/kernels/csrc/landmark_score.cu",
        replaces="src/repro/kernels/landmark_score.py:82",
        max_abs_err=worst["landmark_score"],
        ms=time_ms(lambda: ls.landmark_score(q, k)),
        earlier_ms=EARLIER_MS["landmark_score"],
        plain_ms=time_ms(lambda: ref.landmark_score_ref(q, k)),
        library_ms=time_ms(lambda: torch.matmul(qg, kt)),  # the logits' product alone
        **bound(q.numel() * 2 + k.numel() * 2 + B * H * T * 4, 2 * B * H * T * D),
        shape=list(LM_MAIN), dtype="bfloat16",
    )
    for r in recs.values():
        log("kernel " + json.dumps(r))
    return recs


# ---------------------------------------------------------------------------
def check_reference(dev) -> float:
    """Phase 3: prefill + 12 decode steps on the card against the CPU, with
    the CPU's greedy tokens forced on both, for both cache kinds."""
    from repro_torch.configs import get_config
    from repro_torch.models import model as tm

    cfg = dataclasses.replace(get_config("qwen2.5-0.5b", reduced=True), compute_dtype="float32")
    p_cpu = tm.init_params(cfg, seed=1, device="cpu")
    p_gpu = tm.tree_map(lambda a: a.to(dev), p_cpu)
    toks = torch.randint(0, 256, (2, 40), generator=torch.Generator().manual_seed(1), dtype=torch.int32)
    worst = 0.0
    for kind in ("full", "synapse"):
        spec = tm.CacheSpec(kind=kind, capacity=64, n_landmarks=16, window=8, n_inject=4)
        forced = None
        runs = []
        for p, d in ((p_cpu, "cpu"), (p_gpu, dev)):
            c = tm.init_caches(cfg, 2, spec, device=d)
            logits, _, c = tm.prefill(p, cfg, {"tokens": toks.to(d)}, c, spec=spec)
            out = [logits.cpu()]
            for step in range(12):
                tok = out[-1].argmax(-1).to(torch.int32) if forced is None else forced[step]
                pos = torch.full((2,), 40 + step, dtype=torch.int32)
                logits, _, c = tm.decode_step(p, cfg, {"tokens": tok.to(d), "positions": pos.to(d)}, c, spec=spec)
                out.append(logits.cpu())
            forced = [o.argmax(-1).to(torch.int32) for o in out[:-1]]
            runs.append(torch.stack(out))
        if not torch.isfinite(runs[1]).all():
            raise AssertionError(f"non-finite logits on the card ({kind} cache)")
        torch.testing.assert_close(runs[1], runs[0], rtol=1e-4, atol=1e-4)
        err = max_err(runs[0], runs[1])
        worst = max(worst, err)
        log(f"reference check ({kind} cache, card vs CPU, prefill + 12 steps): max |dlogits| = {err:.3g}")
    return worst


# ---------------------------------------------------------------------------
def profile_window(eng):
    """Profile one steady window (sides live) and print the device's busy
    share and the kernels that take most of its time."""
    from torch.profiler import ProfilerActivity, profile

    assert any(s.active for s in eng.sides)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        eng.macro_tick()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    dev = lambda e: e.self_device_time_total / 1e3  # ms
    # device-side kernel and memcpy events only: the CPU ops that launch
    # them report the same device time again
    events = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(dev(e) for e in events)
    top = sorted(events, key=dev, reverse=True)[:10]
    log(json.dumps({
        "profile_window_ticks": eng.sync_every, "wall_ms": wall_ms, "device_busy_ms": busy_ms,
        "device_idle_share": 1.0 - busy_ms / wall_ms if wall_ms else None,
        "device_events": sum(e.count for e in events),
        "top_device_ms": [[e.key[:70], e.count, round(dev(e), 3)] for e in top],
    }))


def check_launches(label: str, counts: dict, spawns: int, n_layers: int, side_ticks: int):
    """One ``landmark_score`` launch per spawn, one ``synapse_attention``
    launch per layer in every tick that stepped the side lanes."""
    if counts["landmark_score"] != spawns:
        raise AssertionError(f"{label}: landmark_score launched {counts['landmark_score']} times "
                             f"for {spawns} spawns")
    if counts["synapse_attention"] != n_layers * side_ticks:
        raise AssertionError(f"{label}: synapse_attention launched {counts['synapse_attention']} times, "
                             f"expected {n_layers} x {side_ticks} side ticks")


def drive_main_path(card: str) -> dict:
    """Phase 4: the engine at full width. Returns the launch counts."""
    from repro_torch.kernels import ops

    t0 = time.perf_counter()
    cfg, eng = new_engine()
    torch.cuda.synchronize()
    log(f"main path: {cfg.name} L={cfg.n_layers} d_model={cfg.d_model} vocab={cfg.vocab_size} "
        f"compute={eng.cfg.compute_dtype} set up in {time.perf_counter() - t0:.1f} s")
    n_layers, W = cfg.n_layers, eng.sync_every
    torch.cuda.reset_peak_memory_stats()

    ops.reset_launches()
    eng.submit(PROMPT, lane=0)
    side_ticks = 0
    # one steady window with live sides under the sync checker: every tick
    # but the last (whose drain is the window's one sync)
    assert any(s.active for s in eng.sides), "the prompt's tags spawned no side"
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    for _ in range(W - 1):
        eng.tick()
    torch.cuda.set_sync_debug_mode(0)
    eng.tick()
    side_ticks += W
    log(f"steady window of {W} ticks ran under set_sync_debug_mode('error'): no host sync")
    window_s, window_tokens = [], []
    # windows until every side has merged: the first TIMED_WINDOWS are timed
    # (the first of them as warm-up), the next one runs under torch.profiler
    # (its tracing slows what follows it, so nothing after it is timed)
    profiled = False
    for i in range(64):
        if not any(s.active for s in eng.sides):
            break
        side_ticks += W
        if i == TIMED_WINDOWS:
            profile_window(eng)
            profiled = True
            continue
        before = sum(len(v.tokens) for v in eng.mains + eng.sides)
        torch.cuda.synchronize()
        t = time.perf_counter()
        eng.macro_tick()
        torch.cuda.synchronize()
        if i < TIMED_WINDOWS:
            window_s.append(time.perf_counter() - t)
            window_tokens.append(sum(len(v.tokens) for v in eng.mains + eng.sides) - before)
    if not profiled:
        raise AssertionError(f"sides merged within {TIMED_WINDOWS} windows: no window left to profile")
    counts = ops.launch_counts()

    spawns = [e for e in eng.history if e["event"] == "spawn"]
    merges = [e for e in eng.history if e["event"] == "merge"]
    if any(s.active for s in eng.sides):
        raise AssertionError("sides still live after 64 windows")
    if not spawns or not any(m["accepted"] for m in merges):
        raise AssertionError(f"expected a spawn and an accepted merge, history={eng.history}")
    check_launches("main path", counts, len(spawns), n_layers, side_ticks)
    hidden = eng.state.main_hidden
    if not torch.isfinite(hidden).all() or hidden.shape != (1, cfg.d_model):
        raise AssertionError("river hidden state is not finite / of the expected shape")
    toks = eng.mains[0].tokens
    if not all(0 <= t < cfg.vocab_size for t in toks) or len(toks) <= eng.mains[0].prompt_len:
        raise AssertionError("river tokens out of range or none generated")
    steady = window_s[1:]
    tick_ms = statistics.median(steady) / W * 1e3
    tok_s = sum(window_tokens[1:]) / sum(steady)
    log(json.dumps({
        "main_path": cfg.name, "card": card, "spawns": len(spawns),
        "merges": len(merges), "accepted": sum(m["accepted"] for m in merges),
        "gate_scores": [round(m["gate_score"], 4) for m in merges],
        "side_ticks": side_ticks, "windows_timed": len(steady),
        "tick_ms": tick_ms, "tokens_per_s": tok_s,
        "memory_allocated": torch.cuda.memory_allocated(),
        "max_memory_allocated": torch.cuda.max_memory_allocated(),
        "launches": counts,
    }))
    return counts


# ---------------------------------------------------------------------------
SERVE = dict(n_main=2, max_side=8, main_capacity=1024, sync_every=8, max_window=64, theta=-1.0)
SERVE_TENANTS = {"gold": 4.0, "free": 1.0}
SERVE_REQUESTS = [  # tenant, prompt
    ("gold", "Question: what makes this system scale? [TASK: verify the memory math] "
             "[TASK: list the open questions] Answer:"),
    ("free", "Summarize the warp-cortex architecture in one line."),
    ("gold", "The river keeps thinking while nobody asks it anything."),
    ("free", "A second tenant waits for its turn at the card."),
]
SERVE_TOKENS = 128     # max_new_tokens of each cortex-mode and batch-mode request
SERVE_LISTEN_TOKENS = 32


def no_sync(fn, counter=None):
    """``fn`` under ``set_sync_debug_mode("error")``: a host sync inside it
    raises. ``counter`` (a one-item list) counts the guarded calls."""
    def guarded(*a, **k):
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = fn(*a, **k)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        if counter is not None:
            counter[0] += 1
        return out
    return guarded


def guard_window_no_sync(eng, counter=None):
    """Make a host sync an error in every window's dispatch and ring
    prefetch and in every overlapped post-processing of ``eng`` (the
    regions the pipelined run keeps free of host reads). ``counter`` (a
    one-item list) counts the guarded overlapped post-processings. The
    wrappers tie the engine into a reference cycle: ``gc.collect()`` after
    dropping it."""
    eng._dispatch_window = no_sync(eng._dispatch_window)
    eng._prefetch_rings = no_sync(eng._prefetch_rings)
    post = eng._postprocess
    guarded_post = no_sync(post, counter)
    eng._postprocess = lambda rings, n, overlapped=False: (
        guarded_post if overlapped else post)(rings, n, overlapped=overlapped)


def _serving_summary(mode, fe, seconds, card, **extra) -> dict:
    """The numbers a serving mode prints: TTFT and tick percentiles (front
    end clocks on the host), tokens/s over the serve, memory, seconds."""
    m = fe.metrics()
    tokens = sum(r["tokens_out"] for r in m["requests"])
    out = {
        "serving_mode": mode, "card": card, "requests": len(m["requests"]),
        "statuses": sorted(r["status"] for r in m["requests"]),
        "ttft_p50_ms": m["ttft_s"]["p50"] * 1e3, "ttft_p99_ms": m["ttft_s"]["p99"] * 1e3,
        "tick_p50_ms": m["tick_latency_s"]["p50"] * 1e3, "tick_p99_ms": m["tick_latency_s"]["p99"] * 1e3,
        "tick_samples": m["tick_latency_s"]["n"], "tokens_out": tokens, "serve_s": seconds,
        "tokens_per_s": tokens / seconds,
        "token_shares": {t: v["token_share"] for t, v in m["tenants"].items()},
        "memory_allocated": torch.cuda.memory_allocated(),
        "max_memory_allocated": torch.cuda.max_memory_allocated(),
        **extra,
    }
    log(json.dumps(out))
    return out


def _serve_cortex(prism, tok, pipeline: bool, guard: bool):
    """One cortex-mode serve of SERVE_REQUESTS. Returns (front end, engine,
    each agent's tokens by agent id (rivers and sides), seconds, guarded
    overlapped post-processings, side ticks: the ticks of the windows
    dispatched with a side lane live)."""
    from repro_torch.core.engine import CortexEngine
    from repro_torch.serving.frontend import ServingFrontend
    from repro_torch.serving.sampler import SamplingParams

    eng = CortexEngine(prism, tok, sampling=SamplingParams(greedy=True), pipeline=pipeline, **SERVE)
    fe = ServingFrontend(eng, tenants=SERVE_TENANTS, default_max_new_tokens=SERVE_TOKENS)
    streams: dict[str, list] = {}
    fe_tap = eng.stream_tap

    def tap(view, chunk, toks):
        streams.setdefault(view.agent_id, []).extend(toks)
        fe_tap(view, chunk, toks)
    eng.stream_tap = tap
    overlapped, side_ticks = [0], [0]
    if guard:
        guard_window_no_sync(eng, overlapped)
    dispatch = eng._dispatch_window

    def counted(n):
        # the engine steps the side lanes for the whole window when one is
        # live at its dispatch (host mirrors only)
        side_ticks[0] += n if any(s.active for s in eng.sides) else 0
        dispatch(n)
    eng._dispatch_window = counted
    for tenant, prompt in SERVE_REQUESTS:
        fe.submit(prompt, tenant=tenant)
    torch.cuda.synchronize()
    t = time.perf_counter()
    fe.serve()
    torch.cuda.synchronize()
    return fe, eng, streams, time.perf_counter() - t, overlapped[0], side_ticks[0]


def _spawns_and_merges(history) -> list:
    return [tuple(sorted(e.items())) for e in history if e["event"] in ("spawn", "merge")]


def _cortex_mode(prism, tok, card: str) -> dict:
    """The front end over the pipelined, adaptive engine, checked, then over
    the serial engine for the comparison: each request's first tokens, every
    side stream, and the spawns and merges in order. Returns the launch
    counts of the pipelined serve."""
    from repro_torch.kernels import ops

    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    fe, eng, streams, seconds, guarded, side_ticks = _serve_cortex(prism, tok, pipeline=True, guard=True)
    counts = ops.launch_counts()
    events = [e["event"] for e in eng.history]
    bad = [r.rid for r in fe.requests.values() if r.status != "ok"]
    if bad:
        raise AssertionError(f"cortex mode: requests {bad} did not end ok")
    if "spawn" not in events or "merge" not in events:
        raise AssertionError(f"cortex mode: no spawn and merge in the history: {events}")
    if eng.stats["overlapped_drains"] == 0 or guarded == 0:
        raise AssertionError("cortex mode: no drain overlapped the next window")
    if max(eng.stats["window_hist"]) <= eng.sync_every:
        raise AssertionError(f"cortex mode: no window longer than sync_every: {eng.stats['window_hist']}")
    check_launches("cortex mode", counts, events.count("spawn"), eng.cfg.n_layers, side_ticks)
    if any(r.stream.text != tok.decode(streams[r.backend_id]) for r in fe.requests.values()):
        raise AssertionError("cortex mode: a request's stream is not the decode of its tokens")
    _serving_summary(
        "cortex", fe, seconds, card, launches=counts, history=dict(Counter(events)),
        overlapped_drains=eng.stats["overlapped_drains"], window_hist=eng.stats["window_hist"],
        drains=eng.stats["drains"], tick_dispatches=eng.stats["tick_dispatches"],
        ticks=eng.stats["ticks"], side_ticks=side_ticks, guarded_overlapped=guarded)
    aids = [(r.rid, r.backend_id) for r in fe.requests.values()]
    sides = {e["agent"] for e in eng.history if e["event"] == "spawn"}
    spawns_merges = _spawns_and_merges(eng.history)
    del fe, eng
    gc.collect()  # the guard wrappers tie the engine into a reference cycle
    fe_s, eng_s, streams_s, seconds_s, _, _ = _serve_cortex(prism, tok, pipeline=False, guard=False)
    # a request's river runs on until the boundary where its budget is met,
    # and the windows differ: only the first SERVE_TOKENS are the request's
    for rid, aid in aids:
        a, b = streams[aid][:SERVE_TOKENS], streams_s[aid][:SERVE_TOKENS]
        if a != b or tok.decode(a) != tok.decode(b):
            raise AssertionError(f"cortex mode: request {rid}'s first {SERVE_TOKENS} tokens differ "
                                 "between the pipelined and the serial engine")
    # a side runs to its merge on the serial engine's virtual ticks
    for aid in sorted(sides):
        if streams.get(aid) != streams_s.get(aid):
            raise AssertionError(f"cortex mode: side {aid}'s tokens differ between the pipelined "
                                 "and the serial engine")
    if spawns_merges != _spawns_and_merges(eng_s.history):
        raise AssertionError("cortex mode: the spawns and merges (agents, tasks, gate scores, "
                             "thoughts, order) differ between the pipelined and the serial engine")
    log(json.dumps({"serving_mode": "cortex", "serial_serve_s": seconds_s,
                    "serial_tokens_out": sum(r.tokens_out for r in fe_s.requests.values()),
                    "serial_window_hist": eng_s.stats["window_hist"],
                    "pipelined_equals_serial_first_tokens": SERVE_TOKENS,
                    "pipelined_equals_serial_sides": sorted(sides),
                    "pipelined_equals_serial_spawns_merges": len(spawns_merges),
                    "phase_s": time.perf_counter() - t0}))
    return counts


def _batch_mode(params, cfg, tok, card: str):
    """The front end over the pipelined (speculative) BatchServer, against
    the server's own serial loop on the same prompts. (The front end's
    serve(pipeline=False) over a BatchServer admits nothing, as in the
    reference: ROADMAP queue 3.)"""
    from repro_torch.serving.frontend import ServingFrontend
    from repro_torch.serving.sampler import SamplingParams
    from repro_torch.serving.server import BatchServer

    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    srv = BatchServer(params, cfg, tok, n_lanes=4, capacity=512, sampling=SamplingParams(greedy=True))
    bfe = ServingFrontend(srv, tenants=SERVE_TENANTS, default_max_new_tokens=SERVE_TOKENS)
    for tenant, prompt in SERVE_REQUESTS:
        bfe.submit(prompt, tenant=tenant)
    torch.cuda.synchronize()
    t = time.perf_counter()
    bfe.serve(pipeline=True)
    torch.cuda.synchronize()
    _serving_summary("batch", bfe, time.perf_counter() - t, card, rollbacks=srv.stats["rollbacks"],
                     overlapped=srv.stats["overlapped"], steps=srv.stats["steps"])
    piped = {r.prompt: (r.status, r.stream.text, r.tokens_out) for r in bfe.requests.values()}
    piped_tokens = {r.prompt: r.tokens for r in srv.finished}
    srv = BatchServer(params, cfg, tok, n_lanes=4, capacity=512, sampling=SamplingParams(greedy=True))
    for _, prompt in SERVE_REQUESTS:
        srv.submit(prompt, max_new_tokens=SERVE_TOKENS)
    t = time.perf_counter()
    done = srv.run_until_done(pipeline=False)
    torch.cuda.synchronize()
    serial = {r.prompt: (r.status, r.text, len(r.tokens) - r.prompt_len) for r in done}
    if piped != serial or piped_tokens != {r.prompt: r.tokens for r in done}:
        raise AssertionError("batch mode: the pipelined serve differs from the serial loop")
    if any(st != "ok" for st, _, _ in piped.values()):
        raise AssertionError(f"batch mode: statuses {piped}")
    log(json.dumps({"serving_mode": "batch", "serial_s": time.perf_counter() - t,
                    "serial_steps": srv.stats["steps"], "pipelined_equals_serial": True,
                    "phase_s": time.perf_counter() - t0}))


def _listen_mode(prism, card: str, label: str):
    """One cortex request over HTTP/SSE: it must end ``ok`` with its SSE
    text equal to the in-process stream's, its token count over ``GET
    /v1/metrics`` equal to the in-process request's, and the pump without
    an error. On the full config it is a timing and wire-path run: the
    random full-vocabulary model emits no byte id, so both texts are empty
    there; the reduced config's 512-id vocabulary gives a text to compare."""
    from repro_torch.core.engine import CortexEngine
    from repro_torch.data.tokenizer import ByteTokenizer
    from repro_torch.serving.frontend import ServingFrontend
    from repro_torch.serving.sampler import SamplingParams
    from repro_torch.serving.transport import TransportServer, generate_sync, http_json

    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    eng = CortexEngine(prism, ByteTokenizer(prism.cfg.vocab_size), sampling=SamplingParams(greedy=True), **SERVE)
    lfe = ServingFrontend(eng, tenants=SERVE_TENANTS)
    with TransportServer(lfe, "127.0.0.1", 0) as srv:
        t = time.perf_counter()
        out = generate_sync(srv.host, srv.port, SERVE_REQUESTS[0][1], tenant="gold",
                            max_new_tokens=SERVE_LISTEN_TOKENS)
        seconds = time.perf_counter() - t
        code, wire = http_json(srv.host, srv.port, "GET", "/v1/metrics")
        stats = dict(srv.stats)
    req = lfe.requests[out["rid"]]
    if out["http_status"] != 200 or out["status"] != "ok" or out["text"] != req.stream.text:
        raise AssertionError(f"listen ({label}): SSE status {out['http_status']}/{out['status']}, "
                             f"text equal to the in-process stream: {out['text'] == req.stream.text}")
    wire_req = next((r for r in wire.get("requests", []) if r["rid"] == req.rid), None) if code == 200 else None
    if wire_req is None or wire_req["tokens_out"] != req.tokens_out or req.tokens_out < SERVE_LISTEN_TOKENS:
        raise AssertionError(f"listen ({label}): GET /v1/metrics answered {code} with {wire_req}, "
                             f"in process {req.tokens_out} tokens")
    if stats["pump_errors"]:
        raise AssertionError(f"listen ({label}): the pump failed: {stats}")
    if label == "reduced" and not out["text"]:
        raise AssertionError("listen (reduced): the SSE text is empty, nothing was compared")
    _serving_summary(f"listen-{label}", lfe, seconds, card, sse_events=len(out["events"]),
                     sse_chars=len(out["text"]), sse_text_equals_stream=True,
                     wire_tokens_out=wire_req["tokens_out"], transport=stats,
                     phase_s=time.perf_counter() - t0)


def drive_serving(card: str) -> dict:
    """Phase 5: the serving entry point's classes at full width, mode after
    mode (each mode's objects are gone before the next one's memory is
    read). Returns the kernels' launch counts in the cortex-mode serve."""
    from repro_torch.configs import get_config
    from repro_torch.core.prism import Prism
    from repro_torch.data.tokenizer import ByteTokenizer
    from repro_torch.models import model as tm

    cfg, small = get_config("qwen2.5-0.5b"), get_config("qwen2.5-0.5b", reduced=True)
    params = tm.init_params(cfg, seed=0)
    prism = Prism(params, cfg)
    tok = ByteTokenizer(cfg.vocab_size)
    log(f"serving: {cfg.name} L={cfg.n_layers} d_model={cfg.d_model} vocab={cfg.vocab_size} "
        f"compute={cfg.compute_dtype} {SERVE}")
    counts = _cortex_mode(prism, tok, card)
    for mode in (lambda: _batch_mode(params, cfg, tok, card),
                 lambda: _listen_mode(prism, card, "full"),
                 # the full vocabulary's random model rarely emits a byte id,
                 # so its stream text is mostly empty; the reduced config's
                 # 512-id vocabulary gives a text to compare
                 lambda: _listen_mode(Prism(tm.init_params(small, seed=0), small), card, "reduced")):
        gc.collect()
        torch.cuda.empty_cache()
        mode()
    return counts


# ---------------------------------------------------------------------------
TIER_ALICE = ("The river keeps its own counsel while it works. [TASK: weigh the evidence] "
              "[TASK: check the numbers] It goes on thinking aloud.")
TIER_BOB = "A second river with nothing to delegate, thinking on its own."
TIER_SIDES = ("side1", "side0")  # woken in this order, each lands in the other's lane
TIER_WARM_BYTES = 4 << 20  # below one river snapshot (~12.8 MB): the hibernated agents go cold


class _TierProbe:
    """Counts the side ticks of every window the engine dispatches and
    stamps each dispatch with its length and the host clock; stamps each
    wake commit with the host clock and the time its ticket became ready
    (the prefetch worker's read, decode and enqueued copies done)."""

    def __init__(self, eng):
        self.side_ticks, self.commits, self.ready, self.dispatches = 0, {}, {}, []
        dispatch, commit = eng._dispatch_window, eng._commit_wake

        def counted(n):
            self.side_ticks += n if any(s.active for s in eng.sides) else 0
            self.dispatches.append((time.perf_counter(), n))
            dispatch(n)

        def stamped(aid, ticket, **kw):
            landed = commit(aid, ticket, **kw)
            if landed:
                self.commits[aid] = time.perf_counter()
                self.ready[aid] = ticket.resolved_at
            return landed
        eng._dispatch_window, eng._commit_wake = counted, stamped

    def wake_split(self, aid: str, woken_at: float) -> dict:
        """Wake-to-commit of ``aid``, split into the prefetch (wake to
        ticket ready) and the boundary wait (ready to commit), with the
        lengths of the windows dispatched between the wake and the commit."""
        ready, commit = self.ready[aid], self.commits[aid]
        return {"wake_to_commit_ms": (commit - woken_at) * 1e3, "prefetch_ms": (ready - woken_at) * 1e3,
                "boundary_wait_ms": (commit - ready) * 1e3,
                "windows_in_between": [n for t, n in self.dispatches if woken_at <= t <= commit]}


def _tier_engine(prism, tok, store=None):
    """Phase 6's engine: the serving settings, pipelined, greedy."""
    from repro_torch.core.engine import CortexEngine
    from repro_torch.serving.sampler import SamplingParams

    return CortexEngine(prism, tok, sampling=SamplingParams(greedy=True), store=store, **SERVE)


def _tier_run(prism, tok, mode: str, store=None) -> dict:
    """The phase's schedule. Both rivers (alice's tags spawn two sides), 32
    ticks; ``mode`` "immediate" and "delayed" then hibernate both sides
    mid-decode and bob; "immediate" wakes them at once (``wait=True``);
    16 ticks; "delayed" wakes them now, without waiting, so they land while
    ``run`` goes on, with every window dispatched while a prefetch is in
    flight and each wake's commit under ``set_sync_debug_mode("error")``;
    then 64 ticks, until both sides merge, and 32 more. "never" runs the
    same calls without hibernating. Returns the agents' tokens, the spawn
    and merge records and the measurements."""
    from repro_torch.checkpoint import io as ckpt_io
    from repro_torch.kernels import ops
    from repro_torch.memory import store as tstore

    eng = _tier_engine(prism, tok, store)
    probe = _TierProbe(eng)
    at_merge = []
    merge = eng._merge_side
    eng._merge_side = lambda s, thought: (at_merge.append(len(eng.mains[0].tokens)), merge(s, thought))[1]
    ops.reset_launches()
    eng.submit(TIER_ALICE, lane=0, agent_id="alice")
    eng.submit(TIER_BOB, lane=1, agent_id="bob")
    if [e["agent"] for e in eng.history if e["event"] == "spawn"] != ["side0", "side1"]:
        raise AssertionError(f"tiers: expected two spawns, history={eng.history}")
    eng.run(32)
    out = {}
    parked = (*TIER_SIDES, "bob")
    if mode != "never":
        views = {v.agent_id: v for v in eng.mains + eng.sides}
        if any(len(views[s].tokens) <= views[s].prompt_len for s in TIER_SIDES):
            raise AssertionError("tiers: a side is not decoding yet at tick 32")
        eng.drain()
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        kept = {aid: ckpt_io.tree_map(lambda t: t.cpu(), eng._gather_side_lane(views[aid].lane) if aid != "bob"
                                      else eng._gather_main_lane(1)) for aid in parked}
        hib_ms = {}
        for aid in parked:
            t = time.perf_counter()
            eng.hibernate(aid)
            hib_ms[aid] = (time.perf_counter() - t) * 1e3
        torch.cuda.synchronize()
        after = torch.cuda.memory_allocated()
        rep = eng.memory_report()
        if after > before or any(aid in rep["per_agent_bytes"] for aid in parked):
            raise AssertionError(f"tiers: hibernated agents still hold device bytes ({before} -> {after} "
                                 f"allocated, per agent {rep['per_agent_bytes']})")
        if any(eng.store.tier_of(aid) != "cold" for aid in parked):
            raise AssertionError(f"tiers: not all cold: {[eng.store.tier_of(a) for a in parked]}")
        for aid in parked:  # the bf16 snapshot's cold round trip is bitwise
            got = eng.store.get_host(aid)
            la, lb = ckpt_io.tree_flatten_with_path(got), ckpt_io.tree_flatten_with_path(kept[aid])
            if [p for p, _ in la] != [p for p, _ in lb] or any(
                    x.dtype != y.dtype or ckpt_io.leaf_bytes(x) != ckpt_io.leaf_bytes(y)
                    for (_, x), (_, y) in zip(la, lb)):
                raise AssertionError(f"tiers: {aid}'s cold snapshot differs from its lane's bytes")
        blobs = {aid: eng.store._cold[aid] for aid in parked}
        out.update(
            memory_allocated_before_after=[before, after], hibernate_ms=hib_ms, tiers=rep["tiers"],
            snapshot_bytes={aid: tstore.tree_bytes(kept[aid]) for aid in ("side0", "bob")},
            cold_blob_bytes={aid: e.comp_bytes for aid, e in blobs.items()},
            codec=sorted({ckpt_io.codec_name(ckpt_io.parse_frame_header(open(e.path, "rb").read())["codec"])
                          for e in blobs.values()}))
        del kept
    woken_at, guarded = {}, [0]
    if mode == "immediate":
        for aid in parked:
            eng.wake(aid, wait=True)
    eng.run(16)
    if mode == "delayed":
        guard_window_no_sync(eng)
        eng._commit_wake = no_sync(eng._commit_wake, guarded)
        for aid in parked:
            woken_at[aid] = time.perf_counter()
            eng.wake(aid)
    eng.run(64)
    for _ in range(64):
        if sum(e["event"] == "merge" for e in eng.history) == 2:
            break
        eng.run(eng.sync_every)
    else:
        raise AssertionError(f"tiers ({mode}): the sides did not merge: {eng.history}")
    eng.run(32)
    wakes = {e["agent"]: e["lane"] for e in eng.history if e["event"] == "wake"}
    if mode != "never":
        if eng.stats["wakes"] != 3 or eng.stats["wake_failures"] or eng.stats["lost_agents"]:
            raise AssertionError(f"tiers ({mode}): {eng.stats}")
        if (wakes["side1"], wakes["side0"]) != (0, 1):
            raise AssertionError(f"tiers ({mode}): the sides did not wake into each other's lanes: {wakes}")
    if mode == "delayed" and guarded[0] != 3:
        raise AssertionError(f"tiers (delayed): {guarded[0]} guarded wake commits, expected 3")
    streams = {v.agent_id: list(v.tokens) for v in eng.mains}
    for aid in ("side0", "side1"):
        streams[aid] = next(list(s.tokens) for s in eng.sides if s.agent_id == aid)
    out.update(
        mode=mode, streams=streams, records=_spawns_and_merges(eng.history), alice_at_merge=min(at_merge),
        launches=ops.launch_counts(), side_ticks=probe.side_ticks, n_layers=eng.cfg.n_layers,
        spawns=sum(e["event"] == "spawn" for e in eng.history), wake_lanes=wakes, guarded_commits=guarded[0],
        cold_wake_to_commit_ms={aid: probe.wake_split(aid, woken_at[aid]) for aid in woken_at},
        gate_scores=[e["gate_score"] for e in eng.history if e["event"] == "merge"])
    return out


PARK_TOKENS = 48  # max_new_tokens of the parked request


def park_run(params, cfg, tok, pipeline: bool, store=None) -> dict:
    """BatchServer park/unpark: request A decodes 6 serial steps and parks
    (a copy of its lane goes into ``store``), request B takes the freed
    lane, 3 steps later A unparks and resumes in the other lane, and
    ``run_until_done(pipeline=...)`` finishes both. Every admission of
    unparked requests runs under ``set_sync_debug_mode("error")``.
    ``store=None`` runs the same calls without parking (the reference).
    Returns each request's tokens, the guarded admissions and the server's
    stats."""
    from repro_torch.serving.sampler import SamplingParams
    from repro_torch.serving.server import BatchServer

    srv = BatchServer(params, cfg, tok, n_lanes=2, capacity=512, sampling=SamplingParams(greedy=True),
                      store=store, device=params["embed"].device)
    guarded = [0]
    srv._admit_unparked = no_sync(srv._admit_unparked, guarded)
    a = srv.submit(TIER_ALICE, max_new_tokens=PARK_TOKENS)
    for _ in range(6):
        srv.tick()
    if store is not None and not srv.park(a):
        raise AssertionError("park: the request was not on a lane")
    b = srv.submit(TIER_BOB, max_new_tokens=12)
    for _ in range(3):
        srv.tick()
    tier = store.tier_of(f"req{a}") if store is not None else None
    if store is not None:
        srv.unpark(a)
    done = {r.rid: r for r in srv.run_until_done(pipeline=pipeline)}
    if {r.status for r in done.values()} != {"ok"} or set(done) != {a, b}:
        raise AssertionError(f"park: {[(r.rid, r.status, r.error) for r in done.values()]}")
    return {"a": done[a].tokens, "b": done[b].tokens, "a_lane": done[a].lane, "tier": tier,
            "guarded": guarded[0], "stats": dict(srv.stats), "in_store": len(store.keys()) if store else 0}


def _merge_keys(records, keys=("agent", "thought", "accepted")):
    return [tuple(dict(r)[k] for k in keys) for r in records if dict(r)["event"] == "merge"]


def drive_tiers(card: str) -> dict:
    """Phase 6: the memory tiers at full width, their cold blobs in a
    directory under ``build/`` that is removed at the end. Returns the
    launch counts of the delayed-wake run."""
    import shutil
    import tempfile

    t0 = time.perf_counter()
    (ROOT / "build").mkdir(exist_ok=True)
    root = Path(tempfile.mkdtemp(prefix="tiers_", dir=ROOT / "build"))
    try:
        return _drive_tiers(card, root, t0)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _drive_tiers(card: str, root: Path, t0: float) -> dict:
    import contextlib
    import io as stdio

    from repro_torch.configs import get_config
    from repro_torch.core.engine import CortexEngine
    from repro_torch.core.prism import Prism
    from repro_torch.data.tokenizer import ByteTokenizer
    from repro_torch.launch import serve
    from repro_torch.memory import SynapseStore
    from repro_torch.models import model as tm
    from repro_torch.serving.sampler import SamplingParams

    cfg = get_config("qwen2.5-0.5b")
    prism = Prism(tm.init_params(cfg, seed=0), cfg)
    tok = ByteTokenizer(cfg.vocab_size)
    log(f"tiers: {cfg.name} L={cfg.n_layers} d_model={cfg.d_model} compute={cfg.compute_dtype} {SERVE} "
        f"warm_capacity_bytes={TIER_WARM_BYTES} cold_dir={root}")
    store = lambda name, **kw: SynapseStore(cold_dir=str(root / name), **kw)
    ref = _tier_run(prism, tok, "never")
    gc.collect()

    # hibernated to cold and woken at the same boundary: every stream, spawn
    # and merge (gate scores included) is the never-hibernated run's
    immediate = _tier_run(prism, tok, "immediate", store("immediate", warm_capacity_bytes=TIER_WARM_BYTES))
    if immediate["streams"] != ref["streams"] or immediate["records"] != ref["records"]:
        raise AssertionError("tiers (immediate wake): the streams or the spawns and merges differ from "
                             "the never-hibernated run's")
    gc.collect()

    # the phase's schedule: 16 ticks hibernated, woken while run goes on.
    # The sides merge later than in the never-hibernated run (they sat out
    # 16 ticks while alice went on), so the river and the gate see another
    # alice there: alice is compared up to the reference's merge, and each
    # merge by agent, thought and acceptance; every other stream whole
    delayed = _tier_run(prism, tok, "delayed", store("delayed", warm_capacity_bytes=TIER_WARM_BYTES))
    n = ref["alice_at_merge"]
    d, r = delayed["streams"], ref["streams"]
    checks = {
        "sides_equal": all(d[a] == r[a] for a in ("side0", "side1")),
        "bob_prefix_equal": d["bob"] == r["bob"][: len(d["bob"])],
        "alice_equal_to_the_reference_merge": d["alice"][:n] == r["alice"][:n] and len(d["alice"]) > n,
        "spawns_equal": [x for x in delayed["records"] if dict(x)["event"] == "spawn"]
        == [x for x in ref["records"] if dict(x)["event"] == "spawn"],
        "merges_equal_by_agent_thought_acceptance": _merge_keys(delayed["records"]) == _merge_keys(ref["records"]),
    }
    if not all(checks.values()):
        raise AssertionError(f"tiers (delayed wake): {checks}")
    check_launches("tiers", delayed["launches"], delayed["spawns"], delayed["n_layers"], delayed["side_ticks"])
    gc.collect()

    # kill and restart: bob hibernated warm and woken, hibernated again and
    # demoted, then the engine and the store are dropped; a new store
    # recovers the directory and a new engine adopts and wakes bob
    kdir = str(root / "restart")
    st = SynapseStore(cold_dir=kdir)
    eng = _tier_engine(prism, tok, st)
    probe = _TierProbe(eng)
    eng.submit(TIER_BOB, lane=0, agent_id="bob")
    eng.run(16)
    eng.drain()
    torch.cuda.synchronize()
    t = time.perf_counter()
    eng.hibernate("bob")
    warm_hib_ms = (time.perf_counter() - t) * 1e3
    if st.tier_of("bob") != "warm":
        raise AssertionError("tiers (restart): bob is not warm")
    t = time.perf_counter()
    eng.wake("bob")
    eng.run(16)
    warm_wake = probe.wake_split("bob", t)
    eng.run(16)
    eng.hibernate("bob")
    if not st.demote("bob"):
        raise AssertionError("tiers (restart): bob did not demote")
    del eng, st, probe
    gc.collect()
    st = SynapseStore(cold_dir=kdir)
    recovered = st.recover(kdir)
    eng = _tier_engine(prism, tok, st)
    adopted = eng.adopt_hibernated()
    if recovered["recovered"] != ["bob"] or adopted != ["bob"]:
        raise AssertionError(f"tiers (restart): recovered {recovered}, adopted {adopted}")
    eng.wake("bob")
    eng.run(32)
    bob = next(m for m in eng.mains if m.agent_id == "bob")
    if not bob.active or len(bob.tokens) < bob.prompt_len + 64 or bob.tokens != ref["streams"]["bob"][: len(bob.tokens)]:
        raise AssertionError("tiers (restart): bob's stream after the restart is not the reference's")
    restart = {"recovered": recovered["recovered"], "adopted": adopted, "bob_tokens": len(bob.tokens)}
    del eng, st, bob
    gc.collect()

    # the BatchServer parks a request to cold (its 512-slot lane is above
    # the warm capacity) and resumes it in the other lane, in both loops;
    # both requests' tokens equal a run that never parked, and no unparked
    # admission syncs with the card
    park = {}
    for pipeline in (False, True):
        never = park_run(prism.params, cfg, tok, pipeline)
        got = park_run(prism.params, cfg, tok, pipeline,
                       store(f"park_{pipeline}", warm_capacity_bytes=TIER_WARM_BYTES))
        if (got["a"], got["b"]) != (never["a"], never["b"]) or got["tier"] != "cold" or got["a_lane"] != 1 \
                or got["guarded"] < 1 or got["in_store"] or got["stats"]["lost_requests"]:
            raise AssertionError(f"tiers (park, pipeline={pipeline}): {got} vs {never}")
        park[f"pipeline={pipeline}"] = {"tokens": len(got["a"]), "guarded_admissions": got["guarded"],
                                        "rollbacks": got["stats"]["rollbacks"]}
    gc.collect()

    # the launcher, in process, on the reduced config (the smoke's time
    # limit): --cold-dir; a dead process's agent left in the directory; then
    # --cold-dir --recover re-adopts and wakes it while serving
    small = get_config("qwen2.5-0.5b", reduced=True)
    ldir = str(root / "launcher")
    argv = ["--cold-dir", ldir, "--no-stream", "--max-new-tokens", "16"]
    with contextlib.redirect_stdout(stdio.StringIO()):
        m1 = serve.main(argv)
    eng = CortexEngine(Prism(tm.init_params(small, seed=0), small), ByteTokenizer(small.vocab_size),
                       n_main=2, max_side=4, main_capacity=512, side_max_steps=12, theta=-1.0,
                       sampling=SamplingParams(temperature=1.0),
                       store=SynapseStore(cold_dir=ldir, warm_capacity_bytes=1))
    eng.submit(TIER_BOB, lane=0, agent_id="resident")
    eng.run(16)
    eng.hibernate("resident")
    del eng
    gc.collect()
    with contextlib.redirect_stdout(stdio.StringIO()) as second:
        m2 = serve.main(argv + ["--recover", "--wake-deadline", "60"])
    text = second.getvalue()
    if (m1["completed"], m2["completed"]) != (2, 2) or "1 agents re-adopted: ['resident']" not in text \
            or "0 hibernated, 0 lost" not in text:
        raise AssertionError(f"tiers (launcher): {m1['completed']}, {m2['completed']} completed\n{text}")

    keep = ("memory_allocated_before_after", "hibernate_ms", "tiers", "snapshot_bytes", "cold_blob_bytes",
            "codec", "cold_wake_to_commit_ms", "wake_lanes", "guarded_commits", "launches", "side_ticks",
            "gate_scores")
    log(json.dumps({
        "tiers_phase": cfg.name, "card": card, **{k: delayed[k] for k in keep},
        "immediate_equal": True, "immediate_gate_scores": immediate["gate_scores"],
        "reference_gate_scores": ref["gate_scores"], "delayed_checks": checks,
        "warm_hibernate_ms": warm_hib_ms, "warm_wake_to_commit_ms": warm_wake, "restart": restart,
        "batchserver_park": park,
        "launcher": [x for x in text.splitlines() if x.startswith(("recover:", "tiers:", "agents:", "faults:"))],
        "phase_s": time.perf_counter() - t0,
    }))
    return delayed["launches"]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device found (torch.cuda.is_available() is False)", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import ops

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = card_line()
    log(f"card: {card}; torch {torch.__version__} cuda {torch.version.cuda}")

    t0 = time.perf_counter()
    built = ops.build_kernels()
    for name in ops.KERNELS:
        log(f"build {name}: {built.get(name, 'already built')}")
    log(f"build: {time.perf_counter() - t0:.1f} s")

    recs = check_kernels(dev)
    check_reference(dev)
    counts = drive_main_path(card)
    serving = drive_serving(card)
    gc.collect()
    torch.cuda.empty_cache()
    tiers = drive_tiers(card)

    kernels = [dict(recs[name], launches=counts[name], serving_launches=serving[name],
                    tiers_launches=tiers[name]) for name in ops.KERNELS]
    for k in kernels:
        for key in ("shape", "dtype", "bytes", "flops", "earlier_ms"):
            k.pop(key)
    log(json.dumps({"kernels": kernels}))
    log(card)
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
