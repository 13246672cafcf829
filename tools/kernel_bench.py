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
median of 50) at the full batch and at B = 1, and the host time to enqueue
one call (mean of 2000, no sync inside). ``floor_ms`` is the same timing
around a one-element ``add_``: the launch and event overhead any single
kernel pays. With ``--sweep`` it also times ``landmark_score`` at tiles
of 32 to 256 keys and 7, 4 or 2 query rows per pass (this tree's kernel
only). With ``--tick`` it also drives the Qwen2.5-0.5B engine at full
width as ``chip_smoke.py`` does and reports the median tick over four
timed windows after a warm-up window.
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


def kernel_times() -> dict:
    from repro_torch.kernels import landmark_score as ls
    from repro_torch.kernels import synapse_attention as sa

    g = torch.Generator(device="cuda").manual_seed(0)
    rec = {}
    one = torch.zeros(1, device="cuda")
    rec["floor_ms"] = cs.time_ms(lambda: one.add_(1), iters=50)
    for name, shape, call in (
        ("synapse_attention", cs.SYN_MAIN, lambda q, k, v, valid: sa.synapse_attention(q, k, v, valid)),
        ("landmark_score", cs.LM_MAIN, lambda q, k, v, valid: ls.landmark_score(q, k)),
    ):
        r = {}
        for B in (1, shape[0]):
            q, k, v, valid, _ = cs.kernel_inputs((B,) + shape[1:], torch.bfloat16, g)
            r[f"B{B}_ms"] = cs.time_ms(lambda: call(q, k, v, valid), iters=50)
        r["host_us"] = host_us(lambda: call(q, k, v, valid))  # at the full batch
        rec[name] = r
    return rec


def landmark_sweep() -> dict:
    """``landmark_score`` at the spawn's shape under other launch plans:
    keys per tile x query rows per pass. The wrapper takes no plan, so the
    launch is built here from its plan's numbers; each output must equal
    the wrapper's bitwise (neither choice changes a sum's order)."""
    from repro_torch.kernels import landmark_score as ls

    B, H, Hkv, D, T = cs.LM_MAIN
    G = H // Hkv
    q, k, _, _, _ = cs.kernel_inputs(cs.LM_MAIN, torch.bfloat16, torch.Generator(device="cuda").manual_seed(0))
    want, _ = ls.landmark_score(q, k)
    base = ls.launch_plan(B, T, H, Hkv, D, 0, 2)
    out = torch.empty_like(want)
    rec = {}
    for bt in (32, 64, 128, 256):
        for rows in (7, 4, 2):
            threads = min(256, -(-(bt * Hkv * -(-G // rows)) // 32) * 32)
            smem = base.smem + (bt - base.block_t) * Hkv * D * 2

            def call():
                ls.KERNEL.launch(q.data_ptr(), k.data_ptr(), None, out.data_ptr(), None, B, T, Hkv, G, D, 0,
                                 bt, rows, threads, smem, D ** -0.5, float(D), 1)
            call()
            if not torch.equal(out, want):
                raise AssertionError(f"landmark_score with {bt}-key tiles and {rows} rows per pass differs")
            rec[f"block_t{bt}_rows{rows}_ms"] = cs.time_ms(call, iters=50)
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
    ap.add_argument("--sweep", action="store_true", help="also time landmark_score's other launch plans")
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
    if a.tick:
        rec["tick_ms"] = tick_ms()
    print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
