#!/usr/bin/env python3
"""The benchmark's one command.

    python3 cortex_bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Runs one cell of ``BENCHMARK.json`` on this machine's card: makes the
weights and the traffic from the seed, warms up, drives the serving front
end for ``--seconds``, checks what the window served against the plain
reference, and prints one JSON line. ``--trace 0`` reports the cell's
end-to-end metrics, ``--trace 1`` its per-layer metrics (host spans over
the window, a profiled stretch of it).

Everything the cell needs is found by name: its configuration's file, its
traffic mix (``traffic/<mix>.json``), each metric's reader
(``metrics/<metric>.py``) and the limits of its check
(``limits/<workload>.json``).
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules() -> list[str]:
    """Top-level names of loaded modules that must not be, compared whole
    (``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def reader(name: str):
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"cortex_bench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def cell_metrics(bench: dict, workload: str, trace: bool) -> list[dict]:
    kind = "per_layer" if trace else "end_to_end"
    return [m for m in bench[kind] if "workloads" not in m or workload in m["workloads"]]


def limits_of(workload: str) -> dict:
    path = HERE / "limits" / f"{workload}.json"
    return json.loads(path.read_text())["limits"]


def verdict_lines(numbers: dict, limits: dict) -> tuple[bool, dict]:
    checks = {k: {"value": v, "limit": limits[k]} for k, v in numbers.items()}
    return all(c["value"] <= c["limit"] for c in checks.values()), checks


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from cortex_bench import harness

    bench = harness.load_bench(ROOT)
    cell = next((w for w in bench["workloads"] if w["name"] == args.workload), None)
    if cell is None:
        print(f"no workload {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    log = lambda *a: print(*a, file=sys.stderr, flush=True)
    res = harness.run(args.workload, args.seed, args.seconds, bool(args.trace), log=log)
    bad = forbidden_modules()
    if bad:
        print(f"loaded after the window: {', '.join(bad)} (the benchmark runs the port alone)", file=sys.stderr)
        return 3
    data = res["data"]
    metrics = {}
    for m in cell_metrics(bench, args.workload, bool(args.trace)):
        v = reader(m["name"])(data)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    verdict = res["verdict"]
    if verdict is None:
        correct, checks = False, {"finished_requests": {"value": 0, "limit": 1}}
    else:
        correct, checks = verdict_lines(verdict["numbers"], limits_of(args.workload))
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": cell["chips"],
              "memory_peak_bytes": data.peak_bytes}
    out = {"correct": correct, "attempted": res["attempted"], "failed": res["failed"], "metrics": metrics,
           "device": device}
    if args.trace:
        device["busy_s"] = data.stretch.get("busy_s", 0.0)
        device["window_s"] = data.stretch.get("window_s", 0.0)
        out["breakdown"] = {"device_ops": data.stretch.get("device_ops", []),
                            "idle_gaps": data.stretch.get("idle_gaps", [])}
    out["checks"] = checks
    for k, c in checks.items():
        log(f"check {k}: {c['value']!r} (limit {c['limit']!r})")
    print(json.dumps(out), flush=True)
    return 0


def script_path() -> None:
    """Run as a script: the checkout's root and ``src/`` on the path, and
    not this directory (whose module names would shadow others)."""
    sys.path[:] = [str(ROOT), str(ROOT / "src")] + [p for p in sys.path if Path(p or ".").resolve() != HERE]


if __name__ == "__main__":
    script_path()
    # one process, few threads: the host drives the card, and idle worker
    # threads only take its cores
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    sys.exit(main())
