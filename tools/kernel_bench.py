"""Time the port's CUDA kernels and the engine's tick on one NVIDIA card,
for one checkout of the repo.

    python3 tools/kernel_bench.py [--root DIR] [--tick] [--sweep] [--label NAME]

``--root`` names the checkout whose ``src/repro_torch`` is timed (default:
this one), so two trees can be compared on one machine in one run, in turns
(parent, change, change, parent), each in its own process. The kernels are
built into that checkout's own ``build/repro_torch/``. Shapes, inputs,
timing and the engine come from ``chip_smoke.py`` of this checkout.

It prints one JSON line: the card's name and power limit, and for each
kernel at the main path's shapes in bf16 the median device time of one
call (``chip_smoke.time_ms``: CUDA events, L2 flushed before each call,
median of 50) at the full batch and at B = 1, the host time to enqueue one
call (mean of 2000, no sync inside), and ``busy_us``, the device time of
one call's kernels from torch.profiler (L2 flushed, launch gaps left out):
``synapse_attention`` at the side decode, ``landmark_score``'s logits at
Qwen2.5-0.5B's and zamba2's spawns, and the spawn's density,
``ops.landmark_score`` with every key valid, at both and at qwen1.5-110b's
heads on one lane of T = 32,768 (one launch in density
mode; in a tree without that mode, the kernel and three PyTorch calls
after it). ``floor_ms`` is the same timing around a one-element ``add_``:
the launch and event overhead any single kernel pays. ``matmul`` entries
time ``torch.matmul`` of the logits at both spawns the same ways. With
``--sweep`` it also times ``landmark_score`` in both modes with tiles of 8
to 64 KB and at most 4 to 64 ranges a lane, and ``synapse_attention``
with ring stages of 16 to 64 KB and at most 4 or 16
ranges a (lane, kv head) (this tree's kernels only). With
``--tick`` it also drives the Qwen2.5-0.5B engine at full width as
``chip_smoke.py`` does and reports the median tick over four timed
windows after a warm-up window.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(HERE))
import chip_smoke as cs  # noqa: E402


def host_us(fn, iters: int = 2000) -> float:
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(iters):
        fn()
    dt = time.perf_counter() - t
    torch.cuda.synchronize()
    return dt / iters * 1e6


def busy_us(fn, iters: int = 20) -> float:
    """Device time of one call from torch.profiler's CUDA kernel records
    (the launch gaps left out), the L2 flushed before each call as in
    ``chip_smoke.time_ms``; the flush's own fill kernels are not counted.
    A call of several kernels counts all of them."""
    from torch.profiler import ProfilerActivity, profile

    flush = torch.empty(1 << 30, dtype=torch.uint8, device="cuda")
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            flush.zero_()
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA
              and "fill" not in e.key.lower()]
    return sum(e.self_device_time_total for e in events) / iters


def kernel_times() -> dict:
    from repro_torch.kernels import landmark_score as ls
    from repro_torch.kernels import ops
    from repro_torch.kernels import synapse_attention as sa

    g = torch.Generator(device="cuda").manual_seed(0)
    rec = {}
    one = torch.zeros(1, device="cuda")
    rec["floor_ms"] = cs.time_ms(lambda: one.add_(1), iters=50)
    for name, shape, call in (
        ("synapse_attention", cs.SYN_MAIN, lambda q, k, v, valid: sa.synapse_attention(q, k, v, valid)),
        ("landmark_score", cs.LM_MAIN, lambda q, k, v, valid: ls.landmark_score(q, k)),
        ("landmark_score_zamba2", cs.LM_ZAMBA, lambda q, k, v, valid: ls.landmark_score(q, k)),
        # the spawn's density: the parent's four-call path, or one launch
        ("landmark_density", cs.LM_MAIN, lambda q, k, v, valid: ops.landmark_score(q, k, None, valid)),
        ("landmark_density_zamba2", cs.LM_ZAMBA, lambda q, k, v, valid: ops.landmark_score(q, k, None, valid)),
        ("landmark_density_long", cs.LM_LONG[1], lambda q, k, v, valid: ops.landmark_score(q, k, None, valid)),
    ):
        r = {}
        for B in (1, shape[0]):
            q, k, v, valid, _ = cs.kernel_inputs((B,) + shape[1:], torch.bfloat16, g)
            valid = torch.ones_like(valid) if name.startswith("landmark_density") else valid
            r[f"B{B}_ms"] = cs.time_ms(lambda: call(q, k, v, valid), iters=50)
        r["host_us"] = host_us(lambda: call(q, k, v, valid))  # at the full batch
        r["busy_us"] = busy_us(lambda: call(q, k, v, valid))
        rec[name] = r
    # the library's product of the logits alone at both spawns, the same two ways
    for name, shape in (("matmul", cs.LM_MAIN), ("matmul_zamba2", cs.LM_ZAMBA)):
        B, H, Hkv, D, T = shape
        q, k, _, _, _ = cs.kernel_inputs(shape, torch.bfloat16, g)
        qg, kt = q.reshape(B, Hkv, H // Hkv, D), k.permute(0, 2, 3, 1).contiguous()
        rec[name] = {f"B{B}_ms": cs.time_ms(lambda: torch.matmul(qg, kt), iters=50),
                     "busy_us": busy_us(lambda: torch.matmul(qg, kt))}
    return rec


def synapse_sweep() -> dict:
    """``synapse_attention`` at the long key set and the long_500k decode
    shape under other launch plans: ring stages of 16, 32 or 64 KB, and at
    most 4 or 16 ranges a (lane, kv head), launched through the wrapper's
    ``launch``; each output must match the wrapper's within the bf16
    tolerance (the ranges change the order of the sums)."""
    from repro_torch.kernels import synapse_attention as sa

    g = torch.Generator(device="cuda").manual_seed(0)
    rec = {}
    for shape in (cs.SYN_LONG, cs.SYN_LONG500K[0]):
        B, H, Hkv, D, T = shape
        q, k, v, valid, _ = cs.kernel_inputs(shape, torch.bfloat16, g)
        want = sa.synapse_attention(q, k, v, valid)
        for stage_bytes in (16384, 32768, 65536):
            for max_cluster in (4, 16):
                plan = sa.card_plan(q.device, B, T, H, Hkv, D, 2, stage_bytes=stage_bytes, max_cluster=max_cluster)
                call = lambda: sa.launch(plan, q, k, v, valid, D ** -0.5)
                out, mass = call()
                torch.testing.assert_close(out.float(), want[0].float(), rtol=2e-2, atol=2e-2)
                torch.testing.assert_close(mass, want[1], rtol=2e-2, atol=2e-2)
                rec[f"{'x'.join(map(str, shape))}_stage{stage_bytes // 1024}k_cmax{max_cluster}"] = {
                    "cluster": plan.cluster, "ctas": plan.ctas, "stages": plan.stages, "chunk_keys": plan.chunk_keys,
                    "ms": cs.time_ms(call, iters=50)}
    return rec


def landmark_sweep() -> dict:
    """``landmark_score`` at both spawns' shapes under other launch plans:
    tiles of about 8 to 64 KB and at most 4, 8 or 16 ranges a lane (32 or 64
    more in logits mode), in
    logits mode and in density mode (every key valid), launched through
    the wrapper's ``launch``. The logits must equal the wrapper's bitwise
    (neither choice changes a sum's order); the density may differ in its
    last bits (the ranges change the order of the softmax's sums)."""
    from repro_torch.kernels import landmark_score as ls

    g = torch.Generator(device="cuda").manual_seed(0)
    rec = {}
    for shape in (cs.LM_MAIN, cs.LM_ZAMBA):
        B, H, Hkv, D, T = shape
        q, k, _, valid, _ = cs.kernel_inputs(shape, torch.bfloat16, g)
        valid = torch.ones_like(valid)
        for density in (False, True):
            want, _ = ls.landmark_density(q, k, None, valid) if density else ls.landmark_score(q, k)
            for stage_bytes in (8192, 16384, 32768, 65536):
                for max_ranges in (4, 8, 16) + (() if density else (32, 64)):
                    plan = ls.card_plan(q.device, B, T, H, Hkv, D, 0, 2, density=density, stage_bytes=stage_bytes,
                                        max_ranges=max_ranges)
                    call = lambda: ls.launch(plan, q, k, None, valid if density else None, D ** -0.5)
                    got, _ = call()
                    if density:
                        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-6)
                    elif not torch.equal(got, want):
                        raise AssertionError(f"landmark_score logits under {plan} differ")
                    rec[f"{'x'.join(map(str, shape))}_{'density' if density else 'logits'}"
                        f"_stage{stage_bytes // 1024}k_ranges{max_ranges}"] = {
                        "ranges": plan.ranges_per_lane, "chunk_keys": plan.chunk_keys, "stages": plan.stages,
                        "ms": cs.time_ms(call, iters=50)}
    return rec


def tick_ms() -> float:
    _, eng = cs.new_engine()
    eng.submit(cs.PROMPT, lane=0)
    times = []
    for _ in range(5):
        if not any(s.active for s in eng.sides):
            break
        torch.cuda.synchronize()
        t = time.perf_counter()
        eng.macro_tick()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
    if len(times) < 5:
        raise AssertionError("sides merged before five windows ran")
    return statistics.median(times[1:]) / eng.sync_every * 1e3


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(HERE))
    ap.add_argument("--tick", action="store_true")
    ap.add_argument("--sweep", action="store_true", help="also time both kernels' other launch plans")
    ap.add_argument("--label", default="")
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("kernel_bench: no CUDA device found", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(a.root).resolve() / "src"))
    from repro_torch.kernels import ops

    ops.build_kernels()
    rec = {"label": a.label, "root": a.root, "card": cs.card_line(), **kernel_times()}
    if a.sweep:
        rec["landmark_sweep"] = landmark_sweep()
        rec["synapse_sweep"] = synapse_sweep()
    if a.tick:
        rec["tick_ms"] = tick_ms()
    print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
