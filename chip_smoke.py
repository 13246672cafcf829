"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases, each failing the run on its own failure:

1. Build both CUDA kernels from ``src/repro_torch/kernels/csrc`` (one nvcc
   per source, in parallel) and print each one's ptxas summary.
2. Hold each kernel against its plain PyTorch version on the card, at the
   main path's shapes and the kernel-test shapes, in f32 (rtol = atol =
   1e-5) and bf16 (2e-2), both ``landmark_score`` branches; time the
   kernel, the plain version and a one-call library yardstick.
3. Check the port's model on the card against the same model on the CPU on
   a small input (reduced config, f32, no TF32): logits within 1e-4.
4. Drive the main path at full width: Qwen2.5-0.5B (24 layers, d_model 896,
   vocab 151936, bf16, random weights from a seed) in a CortexEngine whose
   prompt spawns side agents, until every side has merged. Launch counters
   are zeroed just before and read just after; one steady window runs under
   ``torch.cuda.set_sync_debug_mode("error")``.
5. Print the ``kernels`` JSON line, the card's name and power limit, and
   the result line.

With no card it exits non-zero at once and prints no result.
"""
from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
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
]
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
    once, and a decode step streams ~1 GB of weights between attends)."""
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
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


# ---------------------------------------------------------------------------
def check_kernels(dev):
    """Phase 2. Returns {name: record} with the errors and times."""
    from repro_torch.kernels import landmark_score as ls
    from repro_torch.kernels import ref
    from repro_torch.kernels import synapse_attention as sa

    g = torch.Generator(device=dev).manual_seed(0)

    def inputs(shape, dtype):
        B, H, Hkv, D, T = shape
        r = lambda *s: torch.randn(s, generator=g, device=dev).to(dtype)
        valid = torch.rand((B, T), generator=g, device=dev) < 0.7
        valid[:, 0] = True
        return r(B, H, D), r(B, T, Hkv, D), r(B, T, Hkv, D), valid, r(B, 7, D)

    worst = {"synapse_attention": 0.0, "landmark_score": 0.0}
    for shape in [SYN_MAIN, LM_MAIN] + TEST_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            t = dict(rtol=TOL[dtype], atol=TOL[dtype])
            q, k, v, valid, lm = inputs(shape, dtype)
            out, mass = sa.synapse_attention(q, k, v, valid)
            out_r, mass_r = ref.synapse_attention_ref(q, k, v, valid)
            torch.testing.assert_close(out.float(), out_r.float(), **t)
            torch.testing.assert_close(mass, mass_r, **t)
            torch.testing.assert_close(mass.sum(-1), torch.full_like(mass[:, 0], shape[1]), rtol=1e-3, atol=0)
            e_sa = max(max_err(out, out_r), max_err(mass, mass_r))
            e_ls = 0.0
            for landmarks in (None, lm):
                logits, dist = ls.landmark_score(q, k, landmarks)
                logits_r, dist_r = ref.landmark_score_ref(q, k, landmarks)
                torch.testing.assert_close(logits, logits_r, **t)
                e_ls = max(e_ls, max_err(logits, logits_r))
                if landmarks is None:
                    assert dist is None
                else:
                    torch.testing.assert_close(dist, dist_r, **t)
                    e_ls = max(e_ls, max_err(dist, dist_r))
            log(f"check shape={shape} dtype={str(dtype)[6:]} "
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


def drive_main_path(card: str) -> dict:
    """Phase 4: the engine at full width. Returns the launch counts."""
    from repro_torch.configs import get_config
    from repro_torch.core.engine import CortexEngine
    from repro_torch.core.prism import Prism
    from repro_torch.data.tokenizer import ByteTokenizer
    from repro_torch.kernels import ops
    from repro_torch.models import model as tm
    from repro_torch.serving.sampler import SamplingParams

    cfg = get_config("qwen2.5-0.5b")
    t0 = time.perf_counter()
    prism = Prism(tm.init_params(cfg, seed=0), cfg)
    eng = CortexEngine(prism, ByteTokenizer(cfg.vocab_size), sampling=SamplingParams(greedy=True), **MAIN)
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
    if counts["landmark_score"] != len(spawns):
        raise AssertionError(f"landmark_score launched {counts['landmark_score']} times for {len(spawns)} spawns")
    if counts["synapse_attention"] != n_layers * side_ticks:
        raise AssertionError(f"synapse_attention launched {counts['synapse_attention']} times, expected "
                             f"{n_layers} x {side_ticks} side ticks")
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

    kernels = [dict(recs[name], launches=counts[name]) for name in ops.KERNELS]
    for k in kernels:
        for key in ("shape", "dtype", "bytes", "flops"):
            k.pop(key)
    log(json.dumps({"kernels": kernels}))
    log(card)
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
