#!/usr/bin/env python3
"""Readings of a cell's check over many seeds in one process, for setting
its limits: for each seed a short window at the cell's own load, then the
numbers the check compares for the program and for the control (the
reference at fp8 put in the program's place). Prints one JSON line a seed.

    python3 cortex_bench/calibrate.py --workload <name> --seeds 1,2,3 --seconds 20
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent


def backlog(d) -> dict:
    """Whether an open loop kept up: requests due, finished, still queued
    at the close, the queue wait of the first and last thirds of the
    requests due, and the tails."""
    from cortex_bench import readers
    from cortex_bench.run import reader
    from cortex_bench.yardstick import percentile

    due = sorted((r for r in d.requests if r["due"] <= d.window_s), key=lambda r: r["due"])
    wait = lambda rs: percentile([(r["admit"] if r["admit"] is not None else d.window_s) - r["due"] for r in rs], 50)
    third = max(1, len(due) // 3)
    out = {"due": len(due), "finished": sum(r["status"] == "ok" for r in due),
           "queued_at_close": sum(r["admit"] is None for r in due),
           "wait_first_third_s": wait(due[:third]), "wait_last_third_s": wait(due[-third:]),
           "queue_wait_p50_ms": readers.queue_wait_p50_ms(d), "window_s": d.window_s,
           "tokens_per_s": sum(n for t, n, _ in d.tokens if t <= d.window_s) / d.window_s}
    for name in ("ttft_p95_ms", "tpot_p95_ms"):
        out[name] = reader(name)(d)
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--control", type=int, default=1)
    ap.add_argument("--rates", default="", help="open loop: a sweep of arrival rates (one run each)")
    args = ap.parse_args()
    import torch

    from cortex_bench import harness

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    log = lambda *a: print(*a, file=sys.stderr, flush=True)
    for rate in [float(r) for r in args.rates.split(",") if r]:
        res = harness.run(args.workload, int(args.seeds.split(",")[0]), args.seconds, False, control=False,
                         overrides={"mix": {"rate_per_s": rate}}, log=log)
        print(json.dumps({"rate_per_s": rate, **backlog(res["data"])}), flush=True)
        torch.cuda.empty_cache()
    if args.rates:
        return 0
    for s in args.seeds.split(","):
        res = harness.run(args.workload, int(s), args.seconds, False, control=bool(args.control), log=log)
        v = res["verdict"] or {}
        print(json.dumps({"seed": int(s), "program": v.get("numbers"), "control": v.get("control"),
                          "tokens_judged": v.get("tokens_judged"), "setup_s": res["data"].setup_s,
                          "window_s": res["data"].window_s}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.path[:] = [str(HERE.parent), str(HERE.parent / "src")] + [p for p in sys.path if Path(p or ".").resolve() != HERE]
    sys.exit(main())
