"""Where the lane group's tick time goes on one card: the plain engine and
the lane engine (a NCCL group of one rank), each with and without the
sync guard (``set_sync_debug_mode("error")``) on every window after the
first, timed in turns.

    python3 tools/lane_tick_ab.py [--rounds 2]

Each run is ``chip_smoke.lane_run`` (phase 4's workload at full width:
Qwen2.5-0.5B, bf16, random weights from seed 0): median ms per virtual
tick and tokens/s over the timed windows after a warm-up window, then one
window under ``torch.profiler`` (device busy ms, idle share, device
events: the kernels and copies the window enqueued). Rounds alternate the
order (plain, plain guarded, lane guarded, lane; then the reverse). It
prints one JSON line per run and the card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(HERE), str(HERE / "src")]
import chip_smoke as cs  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args(argv)
    from repro_torch.configs import get_config
    from repro_torch.core.prism import Prism
    from repro_torch.data.tokenizer import ByteTokenizer
    from repro_torch.kernels import ops
    from repro_torch.models import model as tm

    torch.backends.cuda.matmul.allow_tf32 = False
    ops.build_kernels()
    card = cs.card_line()
    cfg = get_config("qwen2.5-0.5b")
    prism = Prism(tm.init_params(cfg, seed=0), cfg)
    tok = ByteTokenizer(cfg.vocab_size)
    order = [("plain", False, False), ("plain_guarded", False, True), ("lane_guarded", True, True),
             ("lane", True, False)]
    with cs.lane_group(HERE / "build" / "lane_tick_ab.store") as mesh:
        for r in range(args.rounds):
            for label, lane, guard in (order if r % 2 == 0 else order[::-1]):
                run = cs.lane_run(prism, tok, mesh if lane else None, timed=cs.TIMED_WINDOWS,
                                  guard="every" if guard else None, profile=True)
                prof = run["profile"]
                print(json.dumps({"run": label, "round": r, "card": card, "tick_ms": run["tick_ms"],
                                  "tokens_per_s": run["tokens_per_s"],
                                  "profiled_window": {k: prof[k] for k in ("wall_ms", "device_busy_ms",
                                                                           "device_idle_share", "device_events")}}),
                      flush=True)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
