"""Where the time goes inside the port's two CUDA kernels, on one NVIDIA card.

    python3 tools/kernel_phases.py

Builds a stamped copy of ``landmark_score.cu`` and ``synapse_attention.cu``
into ``build/kernel_phases/``, with the flags of ``kernels/build.py`` and
``PHASE_MARK`` defined (``csrc/kv_tile.cuh``): at each mark every block
meets at a barrier and thread 0 records ``clock64()`` and
``%globaltimer``. The barriers stop the phases from overlapping, so the
stamped copy is slower than the kernel: its numbers are the cost of each
phase, not the kernel's time (``chip_smoke.py`` and ``tools/kernel_bench.py``
time the kernel itself). The stamped library stands in for the kernel's own
behind its wrapper, so the launches take the wrapper's plan and arguments.
Each kernel runs at the main path's shapes in bf16, at the full batch and
at B = 1, with the L2 flushed before each run; the script prints one JSON
line per case: for each phase the median and largest cycle count over the
blocks, and the nanoseconds from the first block's start to the last
block's end.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]
import chip_smoke as cs  # noqa: E402

OUT = ROOT / "build" / "kernel_phases"
MARKS, MAX_BLOCKS = 8, 8192
HEADER = f"""
__device__ unsigned long long g_stamp[{MAX_BLOCKS * MARKS * 2}];
#define PHASE_MARK(i) do {{ __syncthreads(); if (threadIdx.x == 0) {{ \\
    unsigned long long* s_ = g_stamp + ((blockIdx.y * gridDim.x + blockIdx.x) * {MARKS} + (i)) * 2; \\
    s_[0] = clock64(); asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(s_[1])); }} }} while (0)
#define PHASE_ONLY(...) __VA_ARGS__
extern "C" int stamps_read(void* dst) {{ return (int)cudaMemcpyFromSymbol(dst, g_stamp, sizeof(g_stamp)); }}
"""
PHASES = {  # the phase that ends at mark i + 1
    "landmark_score": ["copies issued, q staged", "keys landed", "density logits"],
    "synapse_attention": ["copies issued, q staged", "scores", "softmax statistics", "p~.V", "exchange",
                          "combine, out, mass"],
}


def build() -> dict:
    from repro_torch.kernels import build as kb

    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in PHASES:
        src = OUT / f"{name}.cu"
        src.write_text(HEADER + f'#include "{kb.CSRC / name}.cu"\n')
        procs[name] = subprocess.Popen([kb.nvcc_path(), *kb.NVCC_FLAGS, "-o", str(OUT / f"lib{name}.so"), str(src)],
                                       stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    libs = {}
    for name, proc in procs.items():
        out, err = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed for the stamped {name}:\n{err}{out}")
        libs[name] = ctypes.CDLL(str(OUT / f"lib{name}.so"))
    return libs


def main() -> int:
    if not torch.cuda.is_available():
        print("kernel_phases: no CUDA device found", file=sys.stderr)
        return 1
    from repro_torch.kernels import landmark_score as ls
    from repro_torch.kernels import synapse_attention as sa

    libs = build()
    for mod in (ls, sa):  # the stamped library behind the wrapper
        kern, lib = mod.KERNEL, libs[mod.KERNEL.name]
        fn = getattr(lib, kern.symbol)
        fn.argtypes, fn.restype = kern.argtypes, ctypes.c_int
        kern._lib, kern._fn = lib, fn
    flush = torch.empty(1 << 30, dtype=torch.uint8, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(0)

    def report(name, label, call, n_blocks):
        buf = (ctypes.c_ulonglong * (MAX_BLOCKS * MARKS * 2))()
        for _ in range(3):  # the last of three runs, each after a flush
            flush.zero_()
            call()
            torch.cuda.synchronize()
        assert libs[name].stamps_read(buf) == 0
        n = len(PHASES[name])
        at = lambda blk, i, what: buf[(blk * MARKS + i) * 2 + what]
        rec = {"kernel": name, "case": label, "first_start_to_last_end_ns":
               max(at(blk, n, 1) for blk in range(n_blocks)) - min(at(blk, 0, 1) for blk in range(n_blocks))}
        for i, phase in enumerate(PHASES[name]):
            cyc = sorted(at(blk, i + 1, 0) - at(blk, i, 0) for blk in range(n_blocks))
            rec[phase] = {"median_cycles": cyc[len(cyc) // 2], "max_cycles": cyc[-1]}
        print(json.dumps(rec), flush=True)

    for shape in (cs.LM_MAIN, (1,) + cs.LM_MAIN[1:]):
        B, H, Hkv, D, T = shape
        q, k, _, _, _ = cs.kernel_inputs(shape, torch.bfloat16, g)
        plan = ls.launch_plan(B, T, H, Hkv, D, 0, 2)
        report("landmark_score", f"B={B} T={T} density-only", lambda: ls.landmark_score(q, k), plan.grid[0] * B)
    for shape in (cs.SYN_MAIN, (1,) + cs.SYN_MAIN[1:]):
        B, H, Hkv, D, T = shape
        q, k, v, valid, _ = cs.kernel_inputs(shape, torch.bfloat16, g)
        plan = sa.launch_plan(B, T, H, Hkv, D, 2)
        report("synapse_attention", f"B={B} T={T}", lambda: sa.synapse_attention(q, k, v, valid), plan.cluster * B)
    return 0


if __name__ == "__main__":
    sys.exit(main())
