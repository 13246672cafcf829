"""Run one benchmark cell with the program's own tracer (``repro_torch.trace``)
on, and read where its time goes by the program's spans.

    python3 tools/council_trace.py --workload qwen25-council --seed <n> --seconds 51 \\
        --trace <0|1> --program-trace <0|1>

Drives ``cortex_bench.harness.run`` as ``cortex_bench/run.py`` does (the
same set-up, window, probes, profiled stretch and check), with the tracer
on where ``--program-trace 1``, on the card. It prints one JSON line:
``correct``, the cell's metrics as ``cortex_bench/run.py``
reads them for ``--trace``, and from the program's spans:

* ``side_decode_ms_per_tick.agents``: host ms in ``tick.side`` over the
  ticks that stepped side agents, the profiled stretch left out;
* ``merge_sync_ms_p50.agents``: median ms of ``merge.sync``, the wait for
  the gate's decision, the stretch left out;
* with ``--trace 1``, from the profiled stretch
  (``cortex_bench.program_trace.read_profile``):
  ``launches_per_tick.agents`` (device operations launched inside an
  ``engine.tick``, over the stretch's ticks), ``idle_in_tick_pct.agents``
  (stretch time with no device work while the innermost span open on the
  pump thread lies within ``engine.tick``, over the stretch's wall), the
  idle time split by innermost and by outermost span (each summing to
  ``device_idle_share.agents``) and launches per tick by innermost span,
  which it also logs on standard error.

``--program-trace 1 --trace 0`` against ``--program-trace 0 --trace 0``
is the tracer's cost: the tracer's records and profiler ranges and
nothing else.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", default="qwen25-council")
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=51.0)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=1)
    ap.add_argument("--program-trace", type=int, choices=(0, 1), default=1)
    args = ap.parse_args(argv)

    from cortex_bench import harness, program_trace
    from cortex_bench import run as bench
    from repro_torch import trace

    log = lambda *a: print(*a, file=sys.stderr, flush=True)
    held = {}
    Stretch, read_stretch = harness.Stretch, harness.read_stretch

    class Held(Stretch):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            held["stretch"] = self

    def read_both(stretch, pr, arch, log=print):
        out = read_stretch(stretch, pr, arch, log=log)
        held["program"] = program_trace.read_profile(stretch.prof.events(), trace.records(), stretch.t[0],
                                                     stretch.t[1], harness.is_device_work)
        return out

    harness.Stretch, harness.read_stretch = Held, read_both
    trace.clear()
    if args.program_trace:
        trace.enable()
    try:
        res = harness.run(args.workload, args.seed, args.seconds, bool(args.trace), log=log)
    finally:
        trace.disable()
        harness.Stretch, harness.read_stretch = Stretch, read_stretch
    data, recs = res["data"], trace.records()
    trace.clear()
    bench_json = harness.load_bench()
    metrics = {m["name"]: bench.reader(m["name"])(data)
               for m in bench.cell_metrics(bench_json, args.workload, bool(args.trace))}
    st = held.get("stretch")
    cut = (st.t[0], st.t[2]) if st is not None and st.t else (0.0, 0.0)
    prog = held.get("program", {})
    metrics["side_decode_ms_per_tick.agents"] = program_trace.span_ms_per(recs, "tick.side", cut)
    metrics["merge_sync_ms_p50.agents"] = program_trace.span_p50_ms(recs, "merge.sync", cut)
    if args.trace:
        metrics["launches_per_tick.agents"] = prog.get("launches_per_tick")
        metrics["idle_in_tick_pct.agents"] = prog.get("idle_in_tick_pct")
    verdict = res["verdict"]
    correct = verdict is not None and bench.verdict_lines(verdict["numbers"], bench.limits_of(args.workload))[0]
    out = {"workload": args.workload, "seed": args.seed, "trace": args.trace, "program_trace": args.program_trace,
           "correct": correct, "numbers": verdict and verdict["numbers"], "metrics": metrics,
           "records": len(recs), "engine": {k: v for k, v in data.engine["stats"].items() if k != "window_hist"}}
    if prog:
        out["program"] = prog
        log("idle by innermost program span (% of the stretch's wall): "
            + ", ".join(f"{k} {v:.2f}" for k, v in sorted(prog["idle_by_innermost_pct"].items(), key=lambda kv: -kv[1])))
        log("idle by top-level program span: "
            + ", ".join(f"{k} {v:.2f}" for k, v in sorted(prog["idle_by_top_pct"].items(), key=lambda kv: -kv[1])))
        log(f"idle share from the split {prog['idle_share_pct']:.3f} %, the benchmark's "
            f"{metrics.get('device_idle_share.agents')}; clock residual {prog['clock_residual_us']:.1f} us")
        by = prog["launches_per_tick_by_span"]
        log("launches per tick by innermost span: "
            + ", ".join(f"{k} {by.get(k, 0.0):.1f}" for k in program_trace.BREAKDOWN)
            + "; other " + ", ".join(f"{k} {v:.1f}" for k, v in sorted(by.items(), key=lambda kv: -kv[1])
                                     if k not in program_trace.BREAKDOWN))
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    main()
