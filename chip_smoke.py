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
   f32 (rtol = atol = 1e-5) and bf16 (2e-2), and ``synapse_attention`` at
   long key sets whose scores spill to device memory (H = 64 at T = 4096,
   H = 32 at T = 16384; one CTA's range masked), both ``landmark_score``
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
7. The other families. zamba2-1.2b at full width and depth in bf16 (38
   Mamba2 layers, the shared attention block invoked 6 times): a pipelined
   CortexEngine whose prompt's three tags spawn three sides (each spawn one
   ``landmark_score`` sweep over the 6 invocations' stacked cache, each
   side tick one ``synapse_attention`` launch per invocation), every side
   merged, every window's dispatch and overlapped post-processing under
   the sync guard, tick ms, tokens/s, memory and one profiled window; the
   BatchServer's pipelined loop bitwise its serial one through a rollback;
   a side and the river hibernated and woken, bitwise a never-hibernated
   run. Then every other decoder family at its published widths (depth
   cut where its bf16 weights would not fit or take too long: ``FAMILIES``)
   — a prefill and 8 greedy steps twice, finite and repeatable, and one
   spawn and merge through the engine (qwen2-vl, whose M-RoPE decode the
   engine's ticks do not drive, through the engine's spawn and merge
   functions), its kernels' launches checked — and one full-size forward
   of the encoder, hubert-xlarge. Phase 2 also holds both kernels at these
   families' (H, Hkv, D) and times them at zamba2's shapes.
8. Training. Qwen2.5-0.5B at full width and depth (f32 params and Adam
   moments, bf16 compute, remat "full") trained 30 steps of 8 x 512
   tokens on the synthetic corpus through ``repro_torch.training``: every
   5th step's loss, the median step ms over steps 5-30, tokens/s, the
   model-FLOP share ``train_mfu`` (6 N tokens / (step s x 989 TFLOP/s)),
   and the peak memory with remat and, over two steps, without. It holds
   the losses finite and falling (the last 5 steps' mean below 0.8 x the
   first 5's), the params changed, one step's loss in bf16 within 2e-2 of
   f32, the peak with remat below the peak without, the checkpoint round
   trip of the trained params bitwise, a BatchServer over the restored
   params returning tokens, and both kernels' launch counters at zero
   while training (the train forward attends with the plain chunked
   attention, as the reference's does). Then every other family two steps
   at its reduced config: finite losses, params changed.
9. The reference's three serving examples at full width, in process
   (``drive_examples``: the council of agents, the long-context synapse
   decode on qwen3-8b, the quickstart).
10. The lane group on the card: a NCCL ``LaneMesh`` of one rank, made in
   process from a FileStore under ``build/`` and destroyed at the end.
   Phase 4's workload on ``CortexEngine(mesh=...)``, Qwen2.5-0.5B at full
   width and depth in bf16, against a ``mesh=None`` engine with the same
   seed: river and side streams, spawns, merges and gate scores bitwise,
   though the lane run hibernates two sides mid-decode and wakes them into
   each other's lanes; ``landmark_score`` launched once per spawn and
   ``synapse_attention`` once per layer and side tick (``piece_attend``'s
   local path); one window's dispatch, ring gather and ring copy under
   ``set_sync_debug_mode("error")``, one all-gather per drain; the peak
   memory before the swap within the gathered ring buffer's bytes of the
   plain run's. Then ``BatchServer(mesh=..., n_lanes=4)`` on both loops,
   bitwise the ``mesh=None`` server. Prints ms per virtual tick, tokens/s
   and memory of both engines.
11. Training over a mesh, and the launch tooling. (a)
   ``repro_torch.launch.train.main(["--mesh", "single", "--full", ...])``
   in process on a NCCL mesh of one rank ((data, model) = (1, 1), a
   FileStore group under ``build/``), Qwen2.5-0.5B at full width and depth,
   10 steps of 8 x 512 tokens: the train state and every batch DTensors,
   the residual stream placed between layers. Its losses equal a ``--mesh
   debug`` run's with the same seed (bitwise, or within 1e-5 relative);
   both runs' median step ms (steps 2-10, each step between two
   synchronisations) and peak memory are printed; neither kernel launches.
   (b) The port's roofline of phase 8's step (the same config, 8 x 512, one
   device, the H100 SXM's spec-sheet rates): phase 8's median step must be
   no shorter than max(compute_s, memory_s); the ratio is printed. (c)
   ``run_registry(10_000)`` for Qwen2.5-0.5B, printed.
12. Print the ``kernels`` JSON line, the card's name and power limit, and
   the result line.

With no card it exits non-zero at once and prints no result.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import math
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
# the other families' (H, Hkv, D): zamba2's shared MHA block (side decode
# and spawn; B = 6 invocations x 1 parent lane), qwen3-moe, qwen3-4b/8b,
# qwen2-vl-72b / qwen1.5-110b; T = K + W + J of a side decode, or a spawn's
SYN_ZAMBA = (MAIN["max_side"], 32, 32, 64, 64 + 64 + 16)
LM_ZAMBA = (6, 32, 32, 64, MAIN["main_capacity"])
FAMILY_SHAPES = [SYN_ZAMBA, LM_ZAMBA, (8, 32, 4, 128, 144), (48, 32, 4, 128, 1024), (8, 32, 8, 128, 144),
                 (36, 32, 8, 128, 1024), (8, 64, 8, 128, 144), (8, 64, 8, 128, 1024)]
# long key sets, whose ranges' f32 scores spill to device memory: qwen2-vl's
# and qwen1.5's heads at a side decode of T = 4096, and 32 heads of 64 at
# T = 16384 (synapse_attention is timed at the first)
SYN_LONG = (8, 64, 8, 128, 4096)
LONG_SHAPES = [SYN_LONG, (1, 32, 2, 64, 16384)]
# the long-context example's side decode: qwen3-8b's heads, one lane,
# T = K + W + J = 32 + 32 + 4
SYN_QWEN3 = (1, 32, 8, 128, 32 + 32 + 4)
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
    cases = [(shape, None) for shape in [SYN_MAIN, LM_MAIN, SYN_QWEN3] + TEST_SHAPES + FAMILY_SHAPES + LONG_SHAPES] + [
        (SYN_MAIN, "invalid"), (SYN_LONG, "invalid")]
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
    # the same at zamba2's shapes (its shared block: H = Hkv = 32, D = 64)
    B, H, Hkv, D, T = SYN_ZAMBA
    q, k, v, valid, _ = inputs(SYN_ZAMBA, torch.bfloat16)
    qs, ks, vs = q[:, :, None], k.transpose(1, 2).contiguous(), v.transpose(1, 2).contiguous()
    mask = valid[:, None, None, :]
    recs["synapse_attention"]["zamba2"] = dict(
        ms=time_ms(lambda: sa.synapse_attention(q, k, v, valid)),
        plain_ms=time_ms(lambda: ref.synapse_attention_ref(q, k, v, valid)),
        library_ms=time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            qs, ks, vs, attn_mask=mask, enable_gqa=True)),
        **bound(q.numel() * 2 * 2 + 2 * k.numel() * 2 + valid.numel() + B * T * 4, 4 * B * H * T * D),
        shape=list(SYN_ZAMBA), plan=str(sa.launch_plan(B, T, H, Hkv, D, 2)))
    # and at a long key set, whose scores spill (qwen2-vl's and qwen1.5's heads)
    B, H, Hkv, D, T = SYN_LONG
    q, k, v, valid, _ = inputs(SYN_LONG, torch.bfloat16)
    qs, ks, vs = q[:, :, None], k.transpose(1, 2).contiguous(), v.transpose(1, 2).contiguous()
    mask = valid[:, None, None, :]
    recs["synapse_attention"]["long_t"] = dict(
        ms=time_ms(lambda: sa.synapse_attention(q, k, v, valid)),
        plain_ms=time_ms(lambda: ref.synapse_attention_ref(q, k, v, valid)),
        library_ms=time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            qs, ks, vs, attn_mask=mask, enable_gqa=True)),
        **bound(q.numel() * 2 * 2 + 2 * k.numel() * 2 + valid.numel() + B * T * 4, 4 * B * H * T * D),
        shape=list(SYN_LONG), plan=str(sa.launch_plan(B, T, H, Hkv, D, 2)))
    # and at qwen3-8b's, the long-context example's (one lane)
    B, H, Hkv, D, T = SYN_QWEN3
    q, k, v, valid, _ = inputs(SYN_QWEN3, torch.bfloat16)
    qs, ks, vs = q[:, :, None], k.transpose(1, 2).contiguous(), v.transpose(1, 2).contiguous()
    mask = valid[:, None, None, :]
    recs["synapse_attention"]["qwen3_8b"] = dict(
        ms=time_ms(lambda: sa.synapse_attention(q, k, v, valid)),
        plain_ms=time_ms(lambda: ref.synapse_attention_ref(q, k, v, valid)),
        library_ms=time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            qs, ks, vs, attn_mask=mask, enable_gqa=True)),
        **bound(q.numel() * 2 * 2 + 2 * k.numel() * 2 + valid.numel() + B * T * 4, 4 * B * H * T * D),
        shape=list(SYN_QWEN3), plan=str(sa.launch_plan(B, T, H, Hkv, D, 2)))
    B, H, Hkv, D, T = LM_ZAMBA
    q, k, _, _, _ = inputs(LM_ZAMBA, torch.bfloat16)
    qg, kt = q.reshape(B, Hkv, H // Hkv, D), k.permute(0, 2, 3, 1).contiguous()
    recs["landmark_score"]["zamba2"] = dict(
        ms=time_ms(lambda: ls.landmark_score(q, k)),
        plain_ms=time_ms(lambda: ref.landmark_score_ref(q, k)),
        library_ms=time_ms(lambda: torch.matmul(qg, kt)),
        **bound(q.numel() * 2 + k.numel() * 2 + B * H * T * 4, 2 * B * H * T * D),
        shape=list(LM_ZAMBA), plan=str(ls.launch_plan(B, T, H, Hkv, D, 0, 2)))
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
def profiled(fn) -> dict:
    """Run ``fn`` once under torch.profiler: its wall ms, the device's busy
    ms and idle share, and the kernels that take most of the device time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    dev = lambda e: e.self_device_time_total / 1e3  # ms
    # device-side kernel and memcpy events only: the CPU ops that launch
    # them report the same device time again
    events = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(dev(e) for e in events)
    top = sorted(events, key=dev, reverse=True)[:10]
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "device_idle_share": 1.0 - busy_ms / wall_ms if wall_ms else None,
            "device_events": sum(e.count for e in events),
            "top_device_ms": [[e.key[:70], e.count, round(dev(e), 3)] for e in top]}


def profile_window(eng):
    """Profile one steady window (sides live) and print the device's busy
    share and the kernels that take most of its time."""
    assert any(s.active for s in eng.sides)
    log(json.dumps({"profile_window_ticks": eng.sync_every, **profiled(eng.macro_tick)}))


def kernel_plan(cfg) -> tuple[int, int]:
    """(landmark_score launches per spawn, synapse_attention launches per
    tick that steps the side lanes): one sweep per stacked full attention
    cache (a GQA group, the hybrid's shared stack), one attend per GQA layer
    and shared invocation. Recurrent states and MLA latents are copied at a
    spawn and decoded without a kernel, as in the reference."""
    gqa_groups = [g for g in cfg.layer_groups() if g.kind == "attn" and cfg.attn_kind == "gqa"]
    shared = cfg.n_shared_attn_invocations
    return len(gqa_groups) + (1 if shared else 0), sum(g.count for g in gqa_groups) + shared


def check_launches(label: str, counts: dict, cfg, spawns: int, side_ticks: int):
    """The launches ``kernel_plan(cfg)`` implies for the spawns and side
    ticks of a run (for the paper's model: one ``landmark_score`` launch
    per spawn, one ``synapse_attention`` launch per layer and side tick)."""
    per_spawn, per_tick = kernel_plan(cfg)
    want = {"landmark_score": per_spawn * spawns, "synapse_attention": per_tick * side_ticks}
    if counts != want:
        raise AssertionError(f"{label}: kernel launches {counts}, expected {want} "
                             f"({spawns} spawns, {side_ticks} side ticks)")


def drive_main_path(card: str) -> dict:
    """Phase 4: the engine at full width. Returns the launch counts."""
    from repro_torch.kernels import ops

    t0 = time.perf_counter()
    cfg, eng = new_engine()
    torch.cuda.synchronize()
    log(f"main path: {cfg.name} L={cfg.n_layers} d_model={cfg.d_model} vocab={cfg.vocab_size} "
        f"compute={eng.cfg.compute_dtype} set up in {time.perf_counter() - t0:.1f} s")
    W = eng.sync_every
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
    check_launches("main path", counts, cfg, len(spawns), side_ticks)
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
    check_launches("cortex mode", counts, eng.cfg, events.count("spawn"), side_ticks)
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
        launches=ops.launch_counts(), side_ticks=probe.side_ticks,
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
    check_launches("tiers", delayed["launches"], cfg, delayed["spawns"], delayed["side_ticks"])
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


# ---------------------------------------------------------------------------
# phase 7: the other families
# ---------------------------------------------------------------------------
FAMILY_MAIN = dict(n_main=1, max_side=8, main_capacity=1024, sync_every=8, max_window=32, theta=-1.0)
# at most ssm_chunk = 128 tokens with the BOS: a Mamba2 prefill takes a
# prompt of at most one chunk or a multiple of it, as in the reference
ZAMBA_PROMPT = ("The river thinks aloud. [TASK: list the open questions] [TASK: check the claim] "
                "[TASK: sum up the context] Go on.")
FAMILY_PROMPT = "A short river. [TASK: check it] Then on."
# (arch, layers run): every decoder family but the paper's model and zamba2,
# at its published widths; full depth where the bf16 weights leave room on
# the card, else cut (the cut's bytes: qwen3-moe 61 GB at full depth,
# qwen2-vl 145 GB, qwen1.5 222 GB, deepseek-v2 510 GB)
FAMILIES = [("rwkv6-1.6b", None), ("qwen3-4b", None), ("qwen3-8b", None), ("smollm-135m", None),
            ("qwen3-moe-30b-a3b", 12), ("qwen2-vl-72b", 8), ("qwen1.5-110b", 6), ("deepseek-v2-236b", 3)]
ENCODER = "hubert-xlarge"
FAMILY_DECODE_STEPS = 8


def _count_side_ticks(eng) -> list:
    """Wrap the engine's window dispatch: the returned one-item list counts
    the ticks of windows dispatched with a side lane live (host mirrors)."""
    side_ticks, dispatch = [0], eng._dispatch_window

    def counted(n):
        side_ticks[0] += n if any(s.active for s in eng.sides) else 0
        dispatch(n)
    eng._dispatch_window = counted
    return side_ticks


def _family_engine(prism, tok, **kw):
    from repro_torch.core.engine import CortexEngine
    from repro_torch.serving.sampler import SamplingParams

    return CortexEngine(prism, tok, sampling=SamplingParams(greedy=True), **{**FAMILY_MAIN, **kw})


def _zamba_tier_run(prism, tok, hibernate: bool) -> dict:
    """The phase-7 engine to the sides' merges and 16 ticks on; with
    ``hibernate``, one side mid-decode and later the river (its sides
    merged) go to the store and wake at the same boundary."""
    eng = _family_engine(prism, tok)
    eng.submit(ZAMBA_PROMPT, lane=0, agent_id="river")
    eng.run(24)
    if hibernate:
        side = next(s for s in eng.sides if s.active)
        eng.hibernate(side.agent_id)
        eng.wake(side.agent_id, wait=True)
    for _ in range(64):
        if not any(s.active for s in eng.sides):
            break
        eng.run(eng.sync_every)
    if hibernate:
        eng.hibernate("river")
        eng.wake("river", wait=True)
    eng.run(16)
    eng.drain()
    return {"streams": {v.agent_id: list(v.tokens) for v in eng.mains + eng.sides},
            "records": _spawns_and_merges(eng.history), "wakes": eng.stats["wakes"]}


def drive_zamba2(card: str) -> dict:
    """Phase 7a: zamba2-1.2b at full width and depth in bf16 through the
    Cortex main path; then the BatchServer and the memory tiers on it.
    Returns the launch counts of the main run."""
    from repro_torch.configs import get_config
    from repro_torch.core.prism import Prism
    from repro_torch.data.tokenizer import ByteTokenizer
    from repro_torch.kernels import ops
    from repro_torch.models import model as tm
    from repro_torch.serving.sampler import SamplingParams
    from repro_torch.serving.server import BatchServer

    t0 = time.perf_counter()
    cfg = dataclasses.replace(get_config("zamba2-1.2b"), param_dtype="bfloat16")
    tok = ByteTokenizer(cfg.vocab_size)
    if len(tok.encode(ZAMBA_PROMPT, bos=True)) > cfg.ssm_chunk:
        raise AssertionError("the zamba2 prompt is longer than one Mamba2 chunk")
    prism = Prism(tm.init_params(cfg, seed=0), cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    eng = _family_engine(prism, tok)
    guarded = [0]
    guard_window_no_sync(eng, guarded)
    side_ticks = _count_side_ticks(eng)
    log(f"zamba2: L={cfg.n_layers} mamba2 + {cfg.n_shared_attn_invocations} shared-attention invocations "
        f"d_model={cfg.d_model} H=Hkv={cfg.n_heads} D={cfg.d_head} vocab={cfg.vocab_size} "
        f"compute={eng.cfg.compute_dtype} weights {prism.weight_bytes() / 1e9:.3f} GB {FAMILY_MAIN}")
    ops.reset_launches()
    eng.submit(ZAMBA_PROMPT, lane=0)
    spawned = sum(s.active for s in eng.sides)
    eng.run(eng.sync_every)
    # windows until every side has merged: the first TIMED_WINDOWS timed
    # (the first of them warm-up), the next one under torch.profiler (its
    # tracing slows what follows it, so nothing after it is timed)
    window_s, window_tokens, profiled = [], [], False
    for i in range(64):
        if not any(s.active for s in eng.sides):
            break
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
    # the river alone: drains overlap the next window (their
    # post-processing runs under the sync guard)
    eng.run(4 * eng.sync_every)
    eng.drain()
    counts = ops.launch_counts()
    events = [e["event"] for e in eng.history]
    if not profiled or any(s.active for s in eng.sides):
        raise AssertionError(f"zamba2: profiled={profiled}, sides live after 64 windows")
    if spawned < 3 or events.count("spawn") < 3 or events.count("merge") < 3:
        raise AssertionError(f"zamba2: expected 3 spawns and 3 merges, history={events}")
    if guarded[0] == 0 or eng.stats["overlapped_drains"] == 0:
        raise AssertionError("zamba2: no overlapped post-processing ran under the sync guard")
    check_launches("zamba2", counts, eng.cfg, events.count("spawn"), side_ticks[0])
    hidden = eng.state.main_hidden
    if not torch.isfinite(hidden).all() or hidden.shape != (1, cfg.d_model):
        raise AssertionError("zamba2: river hidden state is not finite / of the expected shape")
    steady = window_s[1:]
    main = {
        "zamba2": cfg.name, "card": card, "spawns": events.count("spawn"), "merges": events.count("merge"),
        "accepted": sum(e.get("accepted", False) for e in eng.history),
        "gate_scores": [round(e["gate_score"], 4) for e in eng.history if e["event"] == "merge"],
        "side_ticks": side_ticks[0], "windows_timed": len(steady),
        "tick_ms": statistics.median(steady) / eng.sync_every * 1e3,
        "tokens_per_s": sum(window_tokens[1:]) / sum(steady),
        "memory_allocated": torch.cuda.memory_allocated(),
        "max_memory_allocated": torch.cuda.max_memory_allocated(),
        "weight_bytes": prism.weight_bytes(), "launches": counts,
        "guarded_overlapped": guarded[0], "overlapped_drains": eng.stats["overlapped_drains"],
    }
    del eng
    gc.collect()

    # the BatchServer on zamba2: pipelined == serial, bitwise, through a
    # surprise-EOS rollback (the EOS id is a token the model emits greedily)
    reqs = [("first request", 24), ("a second, longer request", 16), ("third", 20), ("the fourth request", 12)]
    srv = BatchServer(prism.params, cfg, tok, n_lanes=4, capacity=256, sampling=SamplingParams(greedy=True))
    srv.submit(reqs[0][0], max_new_tokens=8)
    probe = srv.run_until_done(pipeline=False)[0]
    tok_eos = ByteTokenizer(cfg.vocab_size)
    tok_eos.eos_id = probe.tokens[probe.prompt_len + 3]
    outs = []
    for pipeline in (True, False):
        srv = BatchServer(prism.params, cfg, tok_eos, n_lanes=4, capacity=256, sampling=SamplingParams(greedy=True))
        for prompt, n in reqs:
            srv.submit(prompt, max_new_tokens=n)
        t = time.perf_counter()
        done = srv.run_until_done(pipeline=pipeline)
        torch.cuda.synchronize()
        outs.append((sorted((r.rid, tuple(r.tokens), r.status) for r in done), dict(srv.stats),
                     time.perf_counter() - t))
    if outs[0][0] != outs[1][0] or outs[0][1]["rollbacks"] < 1:
        raise AssertionError(f"zamba2 BatchServer: pipelined != serial or no rollback ({outs[0][1]})")
    batch = {"rollbacks": outs[0][1]["rollbacks"], "overlapped": outs[0][1]["overlapped"],
             "steps": outs[0][1]["steps"], "pipelined_s": outs[0][2], "serial_s": outs[1][2]}
    del srv
    gc.collect()

    # hibernate and wake one side and the river: bitwise the never-hibernated run
    ref = _zamba_tier_run(prism, tok, hibernate=False)
    got = _zamba_tier_run(prism, tok, hibernate=True)
    if got["streams"] != ref["streams"] or got["records"] != ref["records"] or got["wakes"] != 2:
        raise AssertionError("zamba2 tiers: the hibernated run differs from the never-hibernated one")
    log(json.dumps({**main, "batchserver": batch, "hibernate_wake_bitwise": True,
                    "phase_s": time.perf_counter() - t0}))
    del prism
    gc.collect()
    torch.cuda.empty_cache()
    return counts


def _greedy_decode(params, cfg, prompt_ids, steps: int):
    """Prefill and ``steps`` greedy decode steps on one lane (M-RoPE:
    [1, 3, S] positions). Returns (tokens, every step's logits finite)."""
    from repro_torch.models import model as tm

    dev = params["final_norm"].device
    S = len(prompt_ids)
    spec = tm.CacheSpec(kind="full", capacity=S + steps + 1)
    caches = tm.init_caches(cfg, 1, spec, device=dev)
    inputs = {"tokens": torch.tensor([prompt_ids], dtype=torch.int32, device=dev)}
    mrope = cfg.rope_kind == "mrope"
    if mrope:
        inputs["positions"] = torch.arange(S, dtype=torch.int32, device=dev)[None, None].expand(1, 3, S)
    logits, _, caches = tm.prefill(params, cfg, inputs, caches, spec=spec)
    finite, out = bool(torch.isfinite(logits).all()), []
    for t in range(steps):
        nxt = logits.argmax(-1).to(torch.int32)
        out.append(nxt)
        pos = torch.full((1, 3) if mrope else (1,), S + t, dtype=torch.int32, device=dev)
        logits, _, caches = tm.decode_step(params, cfg, {"tokens": nxt, "positions": pos}, caches, spec=spec)
        finite &= bool(torch.isfinite(logits).all())
    return torch.cat(out).tolist(), finite


def _mrope_spawn_merge(prism, cfg, tok) -> dict:
    """The engine's own spawn and merge functions on an M-RoPE model, which
    the engine's ticks cannot drive (one position per lane, as in the
    reference): prefill a river, compress its lane into a side's synapse
    caches (landmark_score), decode the side 8 steps over them
    (synapse_attention), and merge the side's tokens back."""
    from repro_torch.core import engine as te
    from repro_torch.core import injection
    from repro_torch.models import model as tm

    params = tm.cast_params(prism.params, cfg)
    dev = prism.device
    ids = tok.encode(FAMILY_PROMPT, bos=True)
    S = len(ids)
    main_spec = tm.CacheSpec(kind="full", capacity=256)
    side_spec = tm.CacheSpec(kind="synapse", n_landmarks=64, window=64, n_inject=16)
    main = tm.init_caches(cfg, 1, main_spec, device=dev)
    pos = torch.arange(S, dtype=torch.int32, device=dev)[None, None].expand(1, 3, S)
    _, hidden, main = tm.prefill(params, cfg, {"tokens": torch.tensor([ids], dtype=torch.int32, device=dev),
                                               "positions": pos}, main, spec=main_spec)
    side = tm.init_caches(cfg, 1, side_spec, device=dev)
    tm.write_lane(side, te.spawn_caches(cfg, tm.lane_caches(main, 0), side_spec), 0)
    tokens = torch.tensor([ids[-1]], dtype=torch.int32, device=dev)
    out = []
    for t in range(FAMILY_DECODE_STEPS):
        p = torch.full((1, 3), S + t, dtype=torch.int32, device=dev)
        logits, _, side = tm.decode_step(params, cfg, {"tokens": tokens, "positions": p}, side, spec=side_spec)
        tokens = logits.argmax(-1).to(torch.int32)
        out.append(tokens)
    thought = torch.cat(out)[None]
    _, accept, score = injection.merge_thought(params, cfg, main, hidden.float(), thought,
                                               torch.tensor([S], dtype=torch.int32, device=dev),
                                               torch.ones(1, dtype=torch.bool, device=dev), -1.0)
    if not bool(accept[0]) or int(main.groups[0].length[0, 0]) != S + FAMILY_DECODE_STEPS:
        raise AssertionError("qwen2-vl: the merge was not injected")
    return {"spawns": 1, "side_ticks": FAMILY_DECODE_STEPS, "gate_score": float(score[0])}


def drive_family(arch: str, depth, card: str) -> dict:
    """Phase 7b, one family at its published widths (bf16 weights from seed
    0, ``depth`` layers if cut): a prefill and FAMILY_DECODE_STEPS greedy
    steps twice (finite logits, the same tokens), then one spawn and merge
    through the engine, its kernels' launches counted."""
    from repro_torch.configs import get_config
    from repro_torch.core.prism import Prism
    from repro_torch.data.tokenizer import ByteTokenizer
    from repro_torch.kernels import ops
    from repro_torch.models import model as tm

    t0 = time.perf_counter()
    full = get_config(arch)
    cfg = dataclasses.replace(full, param_dtype="bfloat16", n_layers=depth or full.n_layers)
    prism = Prism(tm.init_params(cfg, seed=0), cfg)
    tok = ByteTokenizer(cfg.vocab_size)
    params = tm.cast_params(prism.params, cfg)
    ids = tok.encode(FAMILY_PROMPT, bos=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    runs = [_greedy_decode(params, cfg, ids, FAMILY_DECODE_STEPS) for _ in range(2)]
    if not (runs[0][1] and runs[1][1]) or runs[0][0] != runs[1][0]:
        raise AssertionError(f"{arch}: non-finite logits or greedy decode not repeatable: {runs}")
    ops.reset_launches()
    t = time.perf_counter()
    if cfg.rope_kind == "mrope":
        path = "engine functions (spawn_caches, decode_step, merge_thought)"
        res = _mrope_spawn_merge(prism, cfg, tok)
        spawns, merges, side_ticks = res["spawns"], 1, res["side_ticks"]
        gates = [res["gate_score"]]
    else:
        path = "CortexEngine"
        eng = _family_engine(prism, tok, max_side=1, side_max_steps=FAMILY_DECODE_STEPS, inject_tokens=8,
                             main_capacity=256)
        guard_window_no_sync(eng)
        counted = _count_side_ticks(eng)
        eng.submit(FAMILY_PROMPT, lane=0)
        for _ in range(32):
            if not any(s.active for s in eng.sides):
                break
            eng.run(eng.sync_every)
        eng.drain()
        events = [e["event"] for e in eng.history]
        spawns, merges, side_ticks = events.count("spawn"), events.count("merge"), counted[0]
        gates = [e["gate_score"] for e in eng.history if e["event"] == "merge"]
        if not torch.isfinite(eng.state.main_hidden).all():
            raise AssertionError(f"{arch}: the river's hidden state is not finite")
        del eng
        gc.collect()
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    if spawns != 1 or merges != 1:
        raise AssertionError(f"{arch}: {spawns} spawns and {merges} merges, expected one each")
    check_launches(arch, counts, cfg, spawns, side_ticks)
    rec = {"family": arch, "card": card, "layers": cfg.n_layers, "of_layers": full.n_layers,
           "weight_bytes": prism.weight_bytes(), "path": path, "greedy_tokens": runs[0][0],
           "spawn_merge_s": time.perf_counter() - t, "side_ticks": side_ticks, "gate_scores": gates,
           "launches": counts, "max_memory_allocated": torch.cuda.max_memory_allocated(),
           "phase_s": time.perf_counter() - t0}
    log(json.dumps(rec))
    del prism, params
    gc.collect()
    torch.cuda.empty_cache()
    return counts


def drive_encoder(card: str):
    """Phase 7c: hubert-xlarge, encoder-only, one full-size forward over
    frame embeddings (its only entry point), twice: finite and repeatable."""
    from repro_torch.configs import get_config
    from repro_torch.models import model as tm

    t0 = time.perf_counter()
    cfg = dataclasses.replace(get_config(ENCODER), param_dtype="bfloat16")
    params = tm.init_params(cfg, seed=0)
    dev = params["final_norm"].device
    emb = torch.randn((2, 1000, cfg.d_model), generator=torch.Generator(device=dev).manual_seed(0), device=dev)
    outs = []
    for _ in range(2):
        torch.cuda.synchronize()
        t = time.perf_counter()
        logits, aux = tm.forward(params, cfg, {"embeds": emb})
        torch.cuda.synchronize()
        outs.append((logits, time.perf_counter() - t))
    logits = outs[0][0]
    if logits.shape != (2, 1000, cfg.vocab_size) or not torch.isfinite(logits).all() \
            or not torch.equal(logits, outs[1][0]):
        raise AssertionError(f"{ENCODER}: logits {tuple(logits.shape)} not finite or not repeatable")
    log(json.dumps({"encoder": cfg.name, "card": card, "layers": cfg.n_layers, "frames": 1000, "batch": 2,
                    "forward_s": outs[1][1], "phase_s": time.perf_counter() - t0}))
    del params, outs, logits
    gc.collect()
    torch.cuda.empty_cache()


def drive_families(card: str) -> dict:
    """Phase 7: zamba2 at full width and depth, every other decoder family
    at its published widths, the encoder. Returns the kernels' launches
    on zamba2's main run and summed over the other families."""
    zamba = drive_zamba2(card)
    others = {"landmark_score": 0, "synapse_attention": 0}
    for arch, depth in FAMILIES:
        for k, v in drive_family(arch, depth, card).items():
            others[k] += v
    drive_encoder(card)
    return {"zamba2": zamba, "families": others}


# ---------------------------------------------------------------------------
# phase 8: training
# ---------------------------------------------------------------------------
TRAIN_ARCH = "qwen2.5-0.5b"
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 8, 512, 30  # 4,096 tokens a step
TRAIN_OPT = dict(lr=1e-3, warmup_steps=3, total_steps=TRAIN_STEPS)
TRAIN_REMAT_OFF_STEPS = 2
TRAIN_PROMPTS = ("12+34=", "abcde|")
FAMILY_TRAIN = dict(seq_len=64, batch_size=4, steps=2)  # every other family, reduced config


def _train_run(state, step, batches):
    """``step`` over ``batches``, each timed on the host clock between two
    synchronisations. Returns (state, losses [tensors], seconds per step)."""
    losses, secs = [], []
    for b in batches:
        torch.cuda.synchronize()
        t = time.perf_counter()
        state, m = step(state, b)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t)
        losses.append(m["loss"])
    return state, losses, secs


def _max_change(params, before) -> float:
    """The largest move of any parameter from ``before`` (host copies)."""
    from repro_torch.models import model as tm

    return max(float((p.detach().cpu() - p0).abs().max()) for p, p0 in zip(tm.tree_leaves(params), before))


def drive_training(card: str) -> tuple:
    """Phase 8: train the paper's model at full width and depth, then every
    other family two steps at its reduced config. Returns the kernels'
    launches while training (zero: the train forward's attention is the
    plain chunked one, as in the reference) and the median step ms."""
    from repro_torch.checkpoint import io as ckpt
    from repro_torch.configs import ARCHS, get_config
    from repro_torch.data.pipeline import DataConfig, batch_to, make_batch
    from repro_torch.data.tokenizer import ByteTokenizer
    from repro_torch.kernels import ops
    from repro_torch.models import model as tm
    from repro_torch.serving.sampler import SamplingParams
    from repro_torch.serving.server import BatchServer
    from repro_torch.training.optimizer import AdamWConfig
    from repro_torch.training.trainer import init_train_state, make_eval_step, make_train_step

    t0 = time.perf_counter()
    cfg = dataclasses.replace(get_config(TRAIN_ARCH), param_dtype="float32", compute_dtype="bfloat16",
                              remat=True, remat_policy="full")
    opt = AdamWConfig(**TRAIN_OPT)
    state = init_train_state(cfg, seed=0)
    dev = state.opt.step.device
    n_params = sum(p.numel() for p in tm.tree_leaves(state.params))
    before = [p.detach().cpu() for p in tm.tree_leaves(state.params)]
    batches = [batch_to(make_batch(cfg, DataConfig(seq_len=TRAIN_SEQ, batch_size=TRAIN_BATCH, seed=i)), dev)
               for i in range(TRAIN_STEPS)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    state, losses, secs = _train_run(state, make_train_step(cfg, opt), batches)
    counts = ops.launch_counts()
    peak_remat = torch.cuda.max_memory_allocated()
    losses = torch.stack(losses).tolist()
    for i in range(0, TRAIN_STEPS, 5):
        log(f"train {cfg.name} step {i + 1}: loss {losses[i]:.4f}")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"training: non-finite losses {losses}")
    first5, last5 = statistics.mean(losses[:5]), statistics.mean(losses[-5:])
    if not last5 < 0.8 * first5:
        raise AssertionError(f"training: the loss did not fall (first 5 {first5}, last 5 {last5})")
    if any(counts.values()):
        raise AssertionError(f"training launched the Cortex kernels: {counts}")
    moved = _max_change(state.params, before)
    if not moved > 0:
        raise AssertionError("training: no parameter changed")
    del before
    step_s = statistics.median(secs[4:])  # steps 5..30
    # one more step under the profiler (its result dropped): where the time goes
    profile = profiled(lambda: make_train_step(cfg, opt)(state, batches[-1]))
    gc.collect()
    tokens = TRAIN_BATCH * TRAIN_SEQ

    # one step's loss in bf16 against the same step in f32, on the card
    with torch.no_grad():
        loss16 = float(make_eval_step(cfg)(state.params, batches[0])["loss"])
        loss32 = float(make_eval_step(dataclasses.replace(cfg, compute_dtype="float32"))(state.params, batches[0])["loss"])
    if not abs(loss16 - loss32) <= 2e-2 * abs(loss32):
        raise AssertionError(f"training: bf16 loss {loss16} vs f32 {loss32}")

    # the peak without remat, over two steps from the same state
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _, off_losses, off_secs = _train_run(state, make_train_step(dataclasses.replace(cfg, remat=False), opt),
                                         batches[:TRAIN_REMAT_OFF_STEPS])
    peak_off = torch.cuda.max_memory_allocated()
    if not peak_remat < peak_off:
        raise AssertionError(f"training: the peak with remat ({peak_remat}) is not below without ({peak_off})")
    gc.collect()

    # the trained params through a checkpoint file and back, bitwise, then served
    path = ROOT / "build" / "train_ckpt" / "chip_smoke.wcsb"
    t = time.perf_counter()
    ckpt.save_framed(str(path), state.params)
    save_s, ckpt_bytes = time.perf_counter() - t, path.stat().st_size
    t = time.perf_counter()
    restored = ckpt.load_framed(str(path), state.params)
    load_s = time.perf_counter() - t
    path.unlink()
    got, want = ckpt.tree_flatten_with_path(restored), ckpt.tree_flatten_with_path(state.params)
    if [k for k, _ in got] != [k for k, _ in want] or not all(
            torch.equal(a, b.detach().cpu()) for (_, a), (_, b) in zip(got, want)):
        raise AssertionError("training: the checkpoint round trip is not bitwise")
    del state, got, want
    gc.collect()
    torch.cuda.empty_cache()
    server = BatchServer(ckpt.tree_map(lambda a: a.to(dev), restored), cfg, ByteTokenizer(cfg.vocab_size),
                         n_lanes=2, capacity=64, sampling=SamplingParams(greedy=True))
    for prompt in TRAIN_PROMPTS:
        server.submit(prompt, max_new_tokens=8)
    done = server.run_until_done()
    if len(done) != len(TRAIN_PROMPTS) or not all(r.tokens for r in done):
        raise AssertionError(f"training: the BatchServer over the restored params returned {done}")
    served = {r.prompt: r.tokens for r in done}
    del server, restored
    gc.collect()
    torch.cuda.empty_cache()
    log(json.dumps({
        "training": cfg.name, "card": card, "layers": cfg.n_layers, "d_model": cfg.d_model,
        "vocab": cfg.vocab_size, "params": n_params, "compute": cfg.compute_dtype, "remat": cfg.remat_policy,
        "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "steps": TRAIN_STEPS, "losses": losses,
        "first5_mean": first5, "last5_mean": last5, "step_ms": step_s * 1e3,
        "step_ms_all": [x * 1e3 for x in secs], "tokens_per_s": tokens / step_s,
        "train_mfu": 6 * n_params * tokens / (step_s * BF16_FLOP_PER_S),
        "max_memory_allocated_remat_full": peak_remat, "max_memory_allocated_remat_off": peak_off,
        "remat_off_step_ms": [x * 1e3 for x in off_secs], "remat_off_losses": torch.stack(off_losses).tolist(),
        "loss_bf16": loss16, "loss_f32": loss32, "max_param_change": moved, "profiled_step": profile,
        "ckpt_bytes": ckpt_bytes, "ckpt_save_s": save_s, "ckpt_load_s": load_s, "served_tokens": served,
        "launches": counts, "phase_s": time.perf_counter() - t0}))

    # every other family: two steps at its reduced config
    ops.reset_launches()
    for arch in ARCHS:
        if arch == TRAIN_ARCH:
            continue
        t = time.perf_counter()
        fcfg = get_config(arch, reduced=True)
        state = init_train_state(fcfg, seed=0)
        before = [p.detach().cpu() for p in tm.tree_leaves(state.params)]
        batches = [batch_to(make_batch(fcfg, DataConfig(seq_len=FAMILY_TRAIN["seq_len"],
                                                        batch_size=FAMILY_TRAIN["batch_size"], seed=i)), dev)
                   for i in range(FAMILY_TRAIN["steps"])]
        state, flosses, _ = _train_run(state, make_train_step(fcfg, AdamWConfig(**TRAIN_OPT)), batches)
        flosses = torch.stack(flosses).tolist()
        fmoved = _max_change(state.params, before)
        if not all(math.isfinite(x) for x in flosses) or not fmoved > 0:
            raise AssertionError(f"training {arch}: losses {flosses}, largest parameter change {fmoved}")
        log(json.dumps({"train_family": arch, "card": card, "compute": fcfg.compute_dtype, "losses": flosses,
                        "max_param_change": fmoved, "s": time.perf_counter() - t}))
    family_counts = ops.launch_counts()
    if any(family_counts.values()):
        raise AssertionError(f"training the families launched the Cortex kernels: {family_counts}")
    log(f"phase 8: {time.perf_counter() - t0:.1f} s")
    return counts, step_s * 1e3


# ---------------------------------------------------------------------------
# phase 9: the serving examples at full width
# ---------------------------------------------------------------------------
def _run_counting_side_ticks(fn):
    """``fn()`` with every CortexEngine's window dispatch counting the ticks
    of windows dispatched with a side lane live (host mirrors): the engine
    is built inside ``fn``. Returns (fn's result, side ticks)."""
    from repro_torch.core.engine import CortexEngine

    side_ticks, dispatch = [0], CortexEngine._dispatch_window

    def counted(self, n):
        side_ticks[0] += n if any(s.active for s in self.sides) else 0
        dispatch(self, n)
    CortexEngine._dispatch_window = counted
    try:
        return fn(), side_ticks[0]
    finally:
        CortexEngine._dispatch_window = dispatch


def drive_council(card: str) -> dict:
    """Phase 9a: ``python -m repro_torch.examples.council_of_agents --full``
    in process. Returns the kernels' launches."""
    from repro_torch.configs import get_config
    from repro_torch.core.prism import tree_bytes
    from repro_torch.examples import council_of_agents as council
    from repro_torch.kernels import ops
    from repro_torch.serving.sampler import SamplingParams

    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    out, side_ticks = _run_counting_side_ticks(lambda: council.main(["--full"]))
    counts = ops.launch_counts()
    eng = out.pop("engine")
    check_launches("council", counts, eng.cfg, len(out["spawns"]), side_ticks)
    full = get_config("qwen2.5-0.5b")
    if (eng.cfg.n_layers, eng.cfg.d_model) != (full.n_layers, full.d_model) or len(out["spawns"]) < 2:
        raise AssertionError(f"council: {eng.cfg.name}, {len(out['spawns'])} spawns")
    if not out["merges"] or not all(m["accepted"] for m in out["merges"]):
        raise AssertionError(f"council: merges {out['merges']}, expected every one accepted at theta -1")
    rep = out["reports"][-1]
    if rep["weight_bytes"] != tree_bytes(eng.prism.params):
        raise AssertionError(f"council: weight_bytes {rep['weight_bytes']} != the Prism's params' bytes")
    if not rep["context_bytes_per_agent"] < 0.2 * rep["weight_bytes"]:
        raise AssertionError(f"council: context per agent {rep['context_bytes_per_agent']} not under 20 % of "
                             f"the weights {rep['weight_bytes']}")
    memory = {"memory_allocated": torch.cuda.memory_allocated(), "max_memory_allocated": torch.cuda.max_memory_allocated()}
    # river 0 is greedy: up to the first merge its tokens cannot depend on
    # the other lanes' sampling
    greedy = council.run_council(council.build_engine(eng.prism, eng.tok, sampling=SamplingParams(greedy=True),
                                                      side_sampling=SamplingParams(greedy=True)))
    n = out["river0_tokens_before_merge"]
    if n <= out["river0_prompt_len"] or out["river0_tokens"][:n] != greedy["river0_tokens"][:n]:
        raise AssertionError(f"council: river 0's first {n} tokens differ from the all-greedy run's")
    keys = ("weight_bytes", "context_bytes_per_agent", "total_bytes", "standard_architecture_bytes",
            "serving_weight_bytes", "n_agents", "tick")
    log(json.dumps({
        "example": "council_of_agents --full", "card": card, "arch": out["arch"], "layers": out["layers"],
        "d_model": out["d_model"], "reports": [{k: r[k] for k in keys} for r in out["reports"]],
        "spawns": len(out["spawns"]), "merges": [[m["agent"], m["accepted"], round(m["gate_score"], 4)]
                                                for m in out["merges"]],
        "river0_tokens_checked": n, "side_ticks": side_ticks, "ticks": out["ticks"],
        "ms_per_tick": out["ms_per_tick"], "window_hist": out["stats"]["window_hist"],
        "overlapped_drains": out["stats"]["overlapped_drains"], **memory, "launches": counts,
        "phase_s": time.perf_counter() - t0}))
    return counts


def drive_long_context(card: str) -> dict:
    """Phase 9b: ``python -m repro_torch.examples.long_context_synapse
    --full`` in process. Returns the kernels' launches."""
    from repro_torch.configs import get_config
    from repro_torch.examples import long_context_synapse as lc
    from repro_torch.kernels import ops

    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    out = lc.main(["--full"])
    counts = ops.launch_counts()
    want = {"landmark_score": 0, "synapse_attention": out["layers"] * out["steps"]}
    full = get_config("qwen3-8b")
    if (out["layers"], out["d_model"], out["steps"]) != (full.n_layers, full.d_model, 300) or counts != want:
        raise AssertionError(f"long context: {out['layers']} layers, d {out['d_model']}, {out['steps']} steps, "
                             f"launches {counts}, expected {want}")
    if out["memory_allocated_step10"] != out["memory_allocated_last"]:
        raise AssertionError(f"long context: memory_allocated {out['memory_allocated_step10']} after step 10, "
                             f"{out['memory_allocated_last']} after the last step: the cache grew")
    if not (out["synapse_bytes"] == out["synapse_bytes_step1"] == out["synapse_bytes_last"]
            and out["logits_finite"] and out["lm_count"] == out["spec"]["n_landmarks"]):
        raise AssertionError(f"long context: {out}")
    log(json.dumps({"example": "long_context_synapse --full", "card": card,
                    **{k: v for k, v in out.items() if k != "lm_pos"},
                    "lm_pos_span": [min(out["lm_pos"]), max(out["lm_pos"])],
                    "max_memory_allocated": torch.cuda.max_memory_allocated(), "launches": counts,
                    "phase_s": time.perf_counter() - t0}))
    return counts


def drive_quickstart(card: str) -> dict:
    """Phase 9c: ``python -m repro_torch.examples.quickstart --full`` in
    process. Returns the kernels' launches (none: a BatchServer)."""
    from repro_torch.configs import get_config
    from repro_torch.examples import quickstart
    from repro_torch.kernels import ops

    t0 = time.perf_counter()
    ops.reset_launches()
    out = quickstart.main(["--full"])
    counts = ops.launch_counts()
    reqs = out["requests"]
    full = get_config("qwen2.5-0.5b")
    if (out["layers"], out["d_model"]) != (full.n_layers, full.d_model) or len(reqs) != 4 or any(
            r["status"] != "ok" or len(r["tokens"]) <= r["prompt_len"] for r in reqs) or any(counts.values()):
        raise AssertionError(f"quickstart: {out['layers']} layers, requests {reqs}, launches {counts}")
    log(json.dumps({"example": "quickstart --full", "card": card, "arch": out["arch"],
                    "generated": [len(r["tokens"]) - r["prompt_len"] for r in reqs], "stats": out["stats"],
                    "seconds": out["seconds"], "launches": counts, "phase_s": time.perf_counter() - t0}))
    return counts


def drive_examples(card: str) -> dict:
    """Phase 9: the three examples at full width, each with the launch
    counters zeroed just before it."""
    t0 = time.perf_counter()
    out = {"council": drive_council(card)}
    gc.collect()
    torch.cuda.empty_cache()
    out["long_context"] = drive_long_context(card)
    gc.collect()
    torch.cuda.empty_cache()
    out["quickstart"] = drive_quickstart(card)
    log(f"phase 9: {time.perf_counter() - t0:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phase 10: the lane group on one card
# ---------------------------------------------------------------------------
LANE_SWAP_AFTER = 3   # windows after the second before the peak is read and two sides swap lanes
LANE_BATCH_TOKENS = 32


@contextlib.contextmanager
def nccl_group(path: Path):
    """A default process group of one rank over NCCL, made in this process
    from a FileStore at ``path``; destroyed, and the file removed, on exit."""
    import datetime

    import torch.distributed as dist

    path.parent.mkdir(parents=True, exist_ok=True)
    path.unlink(missing_ok=True)
    dist.init_process_group("nccl", store=dist.FileStore(str(path), 1), rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=300))
    try:
        yield
    finally:
        dist.destroy_process_group()
        path.unlink(missing_ok=True)


@contextlib.contextmanager
def lane_group(path: Path):
    """A lane group of one rank over NCCL (:func:`nccl_group`)."""
    from repro_torch.launch.mesh import make_lane_mesh

    with nccl_group(path):
        yield make_lane_mesh(1)


def lane_run(prism, tok, mesh, *, engine_kw=MAIN, prompt=PROMPT, timed: int = 0, swap: bool = False,
             guard: str | None = "one", profile: bool = False) -> dict:
    """Phase 4's workload on ``CortexEngine(mesh=mesh)``, one ``run`` of
    ``sync_every`` ticks a window: two windows, then ``timed`` timed
    windows and windows until every side has merged. ``guard="one"``: on a
    lane group the second window (the first's drain sets up the group's
    communicator) runs its dispatch, its ring all-gather and its ring copy
    under ``set_sync_debug_mode("error")`` (``guard_window_no_sync``);
    ``guard="every"``: every window after the first, on either engine (the
    guard itself slows the host: ``tools/lane_tick_ab.py``); None: no
    window. With ``profile`` the window after the timed ones runs under
    ``torch.profiler`` (and is not timed). After
    ``LANE_SWAP_AFTER`` windows the peak memory is read and, with ``swap``,
    the first two sides are hibernated and woken at once into each other's
    lanes. Launch counters are zeroed before the submit. Returns the streams
    by agent, the spawns and merges (gate scores), the side ticks, the
    launches, the ring gathers under the guard, the window times and that
    peak."""
    from repro_torch.core.engine import CortexEngine
    from repro_torch.kernels import ops
    from repro_torch.serving.sampler import SamplingParams

    gc.collect()  # an earlier run's engine (a reference cycle) must not count in this one's peak
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    eng = CortexEngine(prism, tok, sampling=SamplingParams(greedy=True), mesh=mesh, **engine_kw)
    side_ticks = _count_side_ticks(eng)
    owned, spawn_lane = [0], eng._spawn_lane

    def counted_spawn(parent, side):  # the spawns this rank compresses: into a side lane it holds
        owned[0] += eng._lanes.local(side) is not None
        spawn_lane(parent, side)
    eng._spawn_lane = counted_spawn
    W = eng.sync_every
    ops.reset_launches()
    eng.submit(prompt, lane=0)
    if sum(e["event"] == "spawn" for e in eng.history) < (2 if swap else 1):
        raise AssertionError(f"lane run: the prompt spawned too few sides, history={eng.history}")
    eng.run(W)
    unguarded = eng.stats.get("ring_gathers")
    if guard == "one" and mesh is not None:
        methods = {k: eng.__dict__.get(k) for k in ("_dispatch_window", "_prefetch_rings", "_postprocess")}
        guard_window_no_sync(eng)
        eng.run(W)
        for k, fn in methods.items():  # the wrappers go: the timed windows run as the plain engine's
            if fn is None:
                delattr(eng, k)
            else:
                setattr(eng, k, fn)
    else:
        if guard == "every":
            guard_window_no_sync(eng)
        eng.run(W)
    guarded = None if mesh is None or guard is None else eng.stats["ring_gathers"] - unguarded
    prof = None
    window_s, window_tokens, peak_before_swap, lanes = [], [], None, None
    for i in range(64):
        if not any(s.active for s in eng.sides):
            break
        if i == LANE_SWAP_AFTER:
            torch.cuda.synchronize()
            peak_before_swap = torch.cuda.max_memory_allocated()
        if swap and i == LANE_SWAP_AFTER:
            a, b = [s for s in eng.sides if s.active][:2]
            lanes = {a.agent_id: a.lane, b.agent_id: b.lane}
            eng.hibernate(a.agent_id)
            eng.hibernate(b.agent_id)
            wb, wa = eng.wake(b.agent_id, wait=True), eng.wake(a.agent_id, wait=True)
            if (wa.lane, wb.lane) != (lanes[b.agent_id], lanes[a.agent_id]):
                raise AssertionError(f"lane run: the sides did not swap lanes ({lanes} -> {wa.lane}, {wb.lane})")
        if profile and i == timed:
            prof = profiled(lambda: eng.run(W))
            continue
        before = sum(len(v.tokens) for v in eng.mains + eng.sides)
        torch.cuda.synchronize()
        t = time.perf_counter()
        eng.run(W)
        torch.cuda.synchronize()
        if i < timed:
            window_s.append(time.perf_counter() - t)
            window_tokens.append(sum(len(v.tokens) for v in eng.mains + eng.sides) - before)
    if any(s.active for s in eng.sides):
        raise AssertionError("lane run: sides still live after 64 windows")
    if guard == "every" and mesh is not None:
        guarded = eng.stats["ring_gathers"] - unguarded
    torch.cuda.synchronize()
    views = {v.agent_id: list(v.tokens) for v in eng.mains + eng.sides if v.tokens}
    steady = window_s[1:]
    return {"streams": views, "records": [(e["event"], e["agent"], e.get("accepted"), e.get("gate_score"))
                                          for e in eng.history if e["event"] in ("spawn", "merge")],
            "side_ticks": side_ticks[0], "owned_spawns": owned[0], "launches": ops.launch_counts(),
            "stats": dict(eng.stats),
            "guarded_gathers": guarded, "lanes": lanes, "profile": prof,
            "tick_ms": statistics.median(steady) / W * 1e3 if steady else None,
            "tokens_per_s": sum(window_tokens[1:]) / sum(steady) if steady else None,
            "peak_before_swap": peak_before_swap, "max_memory_allocated": torch.cuda.max_memory_allocated(),
            # as the caching allocator holds it: in blocks of 512 bytes
            "ring_all_bytes": 0 if eng._ring_all is None else
            -(-eng._ring_all.numel() * eng._ring_all.element_size() // 512) * 512,
            "hidden_ok": bool(torch.isfinite(eng.state.main_hidden).all())}


def lane_batch(params, cfg, tok, mesh, pipeline: bool, n_tokens: int = LANE_BATCH_TOKENS) -> dict:
    """``BatchServer(mesh=mesh, n_lanes=4)``, greedy, the serving phase's
    four prompts of ``n_tokens`` tokens. Returns {prompt: tokens}."""
    from repro_torch.serving.sampler import SamplingParams
    from repro_torch.serving.server import BatchServer

    srv = BatchServer(params, cfg, tok, n_lanes=4, capacity=512, sampling=SamplingParams(greedy=True), mesh=mesh,
                      device=params["embed"].device)
    for _, prompt in SERVE_REQUESTS:
        srv.submit(prompt, max_new_tokens=n_tokens)
    done = srv.run_until_done(pipeline=pipeline)
    if sorted(r.status for r in done) != ["ok"] * len(SERVE_REQUESTS):
        raise AssertionError(f"lane batch: statuses {[r.status for r in done]}")
    return {r.prompt: list(r.tokens) for r in done}


def check_lane_runs(plain: dict, lane: dict, cfg) -> None:
    """The lane group's run against the plain engine's: streams, spawns and
    merges with their gate scores bitwise, one gather per drain, the second
    window's under the sync guard, the kernels launched once
    per spawn into a side lane this rank holds and once per layer and side
    tick (every rank steps its block of sides), the peak (read at the same
    window) within the gathered ring buffer of the plain run's."""
    if lane["streams"] != plain["streams"] or lane["records"] != plain["records"]:
        raise AssertionError("lane group: streams or spawns and merges differ from the mesh=None engine's")
    if not any(r[0] == "merge" and r[2] for r in lane["records"]):
        raise AssertionError(f"lane group: no accepted merge, records={lane['records']}")
    st = lane["stats"]
    if st["ring_gathers"] != st["drains"] or lane["guarded_gathers"] != 1:
        raise AssertionError(f"lane group: {st['ring_gathers']} ring gathers for {st['drains']} drains, "
                             f"{lane['guarded_gathers']} under the sync guard")
    check_launches("lane group", lane["launches"], cfg, lane["owned_spawns"], lane["side_ticks"])
    if lane["peak_before_swap"] is None or plain["peak_before_swap"] is None:
        raise AssertionError(f"lane group: the sides merged within {LANE_SWAP_AFTER} windows: no peak read")
    if lane["peak_before_swap"] > plain["peak_before_swap"] + lane["ring_all_bytes"]:
        raise AssertionError(f"lane group: peak {lane['peak_before_swap']} > mesh=None peak "
                             f"{plain['peak_before_swap']} + {lane['ring_all_bytes']} ring bytes")
    if not lane["hidden_ok"]:
        raise AssertionError("lane group: the river's hidden state is not finite")


def drive_lane_group(card: str) -> dict:
    """Phase 10: Qwen2.5-0.5B at full width and depth on a NCCL lane group of
    one rank. Returns the lane run's launch counts."""
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.core.prism import Prism
    from repro_torch.data.tokenizer import ByteTokenizer
    from repro_torch.models import model as tm

    t0 = time.perf_counter()
    cfg = get_config("qwen2.5-0.5b")
    prism = Prism(tm.init_params(cfg, seed=0), cfg)
    tok = ByteTokenizer(cfg.vocab_size)
    with lane_group(ROOT / "build" / "lane_group.store") as mesh:
        backend = dist.get_backend(mesh.group)
        log(f"lane group: {cfg.name} L={cfg.n_layers} d_model={cfg.d_model} {MAIN}, world {mesh.world} over "
            f"{backend} on {mesh.device}")
        plain = lane_run(prism, tok, None, timed=TIMED_WINDOWS)
        lane = lane_run(prism, tok, mesh, timed=TIMED_WINDOWS)
        check_lane_runs(plain, lane, cfg)
        # two sides hibernated mid-decode and woken into each other's lanes:
        # every stream is the never-hibernated run's (the swapped sides'
        # merges may land in the other order within a drain, which moves the
        # later gate scores, so the merges compare by agent and verdict)
        swapped = lane_run(prism, tok, mesh, timed=TIMED_WINDOWS, swap=True)
        merges = lambda run: sorted(r[1:3] for r in run["records"] if r[0] == "merge")
        if swapped["streams"] != plain["streams"] or merges(swapped) != merges(plain):
            raise AssertionError("lane group: hibernate/wake into each other's lanes changed the streams")
        # the plain engine once more: its windows and the lane group's were
        # timed in turns (plain, lane, lane, plain)
        plain2 = lane_run(prism, tok, None, timed=TIMED_WINDOWS)
        gc.collect()
        batch = {}
        for pipeline in (True, False):
            batch[pipeline] = lane_batch(prism.params, cfg, tok, mesh, pipeline)
            if batch[pipeline] != lane_batch(prism.params, cfg, tok, None, pipeline):
                raise AssertionError(f"lane group: the BatchServer (pipeline={pipeline}) differs from mesh=None")
        if batch[True] != batch[False]:
            raise AssertionError("lane group: the BatchServer's loops differ")
    log(json.dumps({
        "lane_group": cfg.name, "card": card, "world": 1, "backend": backend,
        "spawns": sum(r[0] == "spawn" for r in lane["records"]),
        "merges": sum(r[0] == "merge" for r in lane["records"]),
        "gate_scores": [round(r[3], 4) for r in lane["records"] if r[0] == "merge"],
        "side_ticks": lane["side_ticks"], "swapped_lanes": swapped["lanes"],
        "ring_gathers": lane["stats"]["ring_gathers"], "drains": lane["stats"]["drains"],
        "tick_ms": [lane["tick_ms"], swapped["tick_ms"]],
        "tokens_per_s": [lane["tokens_per_s"], swapped["tokens_per_s"]],
        "plain_tick_ms": [plain["tick_ms"], plain2["tick_ms"]],
        "plain_tokens_per_s": [plain["tokens_per_s"], plain2["tokens_per_s"]],
        "peak_before_swap": lane["peak_before_swap"], "plain_peak_before_swap": plain["peak_before_swap"],
        "max_memory_allocated": lane["max_memory_allocated"], "ring_all_bytes": lane["ring_all_bytes"],
        "batch_tokens": sum(len(t) for t in batch[True].values()), "launches": lane["launches"],
        "phase_s": time.perf_counter() - t0}))
    log(f"phase 10: {time.perf_counter() - t0:.1f} s")
    return lane["launches"]


# ---------------------------------------------------------------------------
# phase 11: training over a mesh, and the launch tooling
# ---------------------------------------------------------------------------
TRAIN_MESH_STEPS = 10
TRAIN_MESH_ARGV = ["--full", "--arch", TRAIN_ARCH, "--steps", str(TRAIN_MESH_STEPS), "--seq", str(TRAIN_SEQ),
                   "--batch", str(TRAIN_BATCH)]


def train_launcher_run(mesh: str) -> dict:
    """``launch.train.main`` with ``--mesh mesh``; each train step timed
    between two synchronisations (the launcher's step wrapped here).
    Returns main's result with "step_ms" (every step's) and "peak"."""
    from repro_torch.launch import train as launch_train

    secs, make = [], launch_train.make_train_step

    def timed(cfg, opt):
        step = make(cfg, opt)

        def run(state, batch):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = step(state, batch)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t)
            return out

        return run

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    launch_train.make_train_step = timed
    try:
        out = launch_train.main(TRAIN_MESH_ARGV + ["--mesh", mesh])
    finally:
        launch_train.make_train_step = make
    out.pop("state")
    return dict(out, step_ms=[x * 1e3 for x in secs], peak=torch.cuda.max_memory_allocated())


def check_mesh_losses(mesh: list, debug: list) -> float:
    """The largest relative difference of the mesh run's losses from the
    debug run's; over 1e-5 fails."""
    worst = max(abs(a - b) / abs(b) for a, b in zip(mesh, debug))
    if len(mesh) != len(debug) or not worst <= 1e-5:
        raise AssertionError(f"train mesh: --mesh single losses {mesh} vs --mesh debug {debug}")
    return worst


def train_roofline(train_step_ms: float) -> dict:
    """The port's roofline of phase 8's step, one device: FLOPs and op bytes
    of the step on ``meta``. A measured step shorter than the bound means
    the count is wrong."""
    from repro_torch.configs import get_config
    from repro_torch.launch import roofline, specs

    cfg = dataclasses.replace(get_config(TRAIN_ARCH), param_dtype="float32", compute_dtype="bfloat16",
                              remat=True, remat_policy="full")
    plan = specs.ShapePlan(cfg.name, "train_phase8", "train", TRAIN_SEQ, TRAIN_BATCH, "none")
    t = time.perf_counter()
    counts = roofline.step_counts(cfg, plan, None)
    terms = roofline.times(counts)
    bound_ms = max(terms["compute_s"], terms["memory_s"]) * 1e3
    if not train_step_ms >= bound_ms:
        raise AssertionError(f"roofline: phase 8's step {train_step_ms} ms is shorter than the bound {bound_ms} ms")
    return {"flops": counts["flops"], "bytes": counts["bytes"], "compute_ms": terms["compute_s"] * 1e3,
            "memory_ms": terms["memory_s"] * 1e3, "bound_ms": bound_ms, "dominant": terms["dominant"],
            "measured_ms": train_step_ms, "measured_over_bound": train_step_ms / bound_ms,
            "model_flops": roofline.model_flops(cfg, plan), "count_s": time.perf_counter() - t}


def drive_train_mesh(card: str, train_step_ms: float) -> dict:
    """Phase 11. Returns the mesh run's launch counts (zero)."""
    from repro_torch.kernels import ops
    from repro_torch.launch import dryrun

    t0 = time.perf_counter()
    with nccl_group(ROOT / "build" / "train_mesh.store"):
        ops.reset_launches()
        mesh = train_launcher_run("single")
        counts = ops.launch_counts()
        debug = train_launcher_run("debug")
    if any(counts.values()):
        raise AssertionError(f"train mesh: the Cortex kernels launched: {counts}")
    if mesh["mesh"] != (1, 1):
        raise AssertionError(f"train mesh: the mesh is {mesh['mesh']}, not (1, 1)")
    worst = check_mesh_losses(mesh["losses"], debug["losses"])
    median = lambda ms: statistics.median(ms[1:])
    log(json.dumps({
        "train_mesh": TRAIN_ARCH, "card": card, "mesh": mesh["mesh"], "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
        "losses": mesh["losses"], "debug_losses": debug["losses"], "bitwise": mesh["losses"] == debug["losses"],
        "max_rel_diff": worst, "step_ms": median(mesh["step_ms"]), "debug_step_ms": median(debug["step_ms"]),
        "first_step_ms": mesh["step_ms"][0], "debug_first_step_ms": debug["step_ms"][0],
        "step_ms_all": mesh["step_ms"], "debug_step_ms_all": debug["step_ms"],
        "max_memory_allocated": mesh["peak"], "debug_max_memory_allocated": debug["peak"],
        "launches": counts}))
    log(json.dumps({"roofline": TRAIN_ARCH, "card": card, "phase8_step": train_roofline(train_step_ms)}))
    reg = dryrun.run_registry(10_000, arch=TRAIN_ARCH)
    log(json.dumps({"registry": TRAIN_ARCH, **{k: reg[k] for k in ("per_agent_snapshot_bytes", "weight_bytes",
                                                                    "cold_codec", "at_n", "at_1m")}}))
    log(f"phase 11: {time.perf_counter() - t0:.1f} s")
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
    serving = drive_serving(card)
    gc.collect()
    torch.cuda.empty_cache()
    tiers = drive_tiers(card)
    gc.collect()
    torch.cuda.empty_cache()
    families = drive_families(card)
    gc.collect()
    torch.cuda.empty_cache()
    training, train_step_ms = drive_training(card)
    gc.collect()
    torch.cuda.empty_cache()
    examples = drive_examples(card)
    gc.collect()
    torch.cuda.empty_cache()
    lanes = drive_lane_group(card)
    gc.collect()
    torch.cuda.empty_cache()
    train_mesh = drive_train_mesh(card, train_step_ms)

    kernels = [dict(recs[name], launches=counts[name], serving_launches=serving[name],
                    tiers_launches=tiers[name], zamba2_launches=families["zamba2"][name],
                    families_launches=families["families"][name], training_launches=training[name],
                    council_launches=examples["council"][name],
                    long_context_launches=examples["long_context"][name],
                    quickstart_launches=examples["quickstart"][name], lane_group_launches=lanes[name],
                    train_mesh_launches=train_mesh[name])
               for name in ops.KERNELS]
    for k in kernels:
        for key in ("shape", "dtype", "bytes", "flops", "earlier_ms"):
            k.pop(key)
        for sub in ("zamba2", "long_t", "qwen3_8b"):
            for key in ("bytes", "flops", "plan"):
                k.get(sub, {}).pop(key, None)
    log(json.dumps({"kernels": kernels}))
    log(card)
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
