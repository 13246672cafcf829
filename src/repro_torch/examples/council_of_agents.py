"""Council of Agents — the paper's headline scenario, end to end.

    PYTHONPATH=src python -m repro_torch.examples.council_of_agents [--device cpu] [--full]

Port of the JAX package's ``examples/council_of_agents.py``. A main
"River" agent generates; ``[TASK: ...]`` tags spawn side "Stream" agents
that reason over a landmark-compressed snapshot of the river's context
(the Topological Synapse), pass the Validation Gate and merge back by
Referential Injection, all sharing ONE copy of the weights (the Prism).
Two rivers, river 0 greedy and river 1 sampled, five chunks of
``run(8)``; every other chunk prints the memory report (paper Eq. 1), then
the event log. It runs on the card unless ``--device cpu``; Qwen2.5-0.5B's
reduced config unless ``--full`` (24 layers, d_model 896). Weights are
random, from ``init_params`` seeded 0 on the target device.

:func:`main` returns what it prints: the memory reports, the spawns and
merges, river 0's tokens and how many of them were drained before the
first merge landed, the engine's counters, ms per virtual tick, and the
engine itself.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import get_config
from repro_torch.core.engine import CortexEngine
from repro_torch.core.prism import Prism
from repro_torch.data.tokenizer import ByteTokenizer
from repro_torch.device import resolve_device
from repro_torch.models import model as model_lib
from repro_torch.serving.sampler import SamplingParams

ENGINE = dict(
    n_main=2, max_side=4, main_capacity=512, side_max_steps=12, inject_tokens=8,
    theta=-1.0,      # untrained weights: accept all merges for the demo
    sync_every=4,    # whole 4-tick windows between drains...
    max_window=16,   # ...lengthened up to 16 ticks while drains stay quiet
)
# rivers sample by default; freshly spawned streams explore harder
SAMPLING = SamplingParams(temperature=1.0)
SIDE_SAMPLING = SamplingParams(temperature=1.1, top_k=40)
# (prompt, sampling): river 0 decodes greedily, river 1 with the default
RIVERS = [
    ("Research question: why is the sky blue? [TASK: check Rayleigh scattering] "
     "Let me think step by step.", SamplingParams(greedy=True)),
    ("Second river: summarize the meeting notes. [TASK: list action items] ok", None),
]
CHUNKS, CHUNK_TICKS = 5, 8  # 5 pipelined chunks == 40 virtual ticks


def build_engine(prism: Prism, tok: ByteTokenizer, *, sampling: SamplingParams = SAMPLING,
                 side_sampling: SamplingParams = SIDE_SAMPLING) -> CortexEngine:
    """The council's engine on the Prism's device."""
    return CortexEngine(prism, tok, sampling=sampling, side_sampling=side_sampling,
                        device=prism.device, **ENGINE)


def run_council(eng: CortexEngine) -> dict:
    """Submit both rivers and run the chunks; returns the readings."""
    for lane, (prompt, sampling) in enumerate(RIVERS):
        eng.submit(prompt, lane=lane, sampling=sampling)
    reports = []
    before_merge = len(eng.mains[0].tokens)
    if eng.device.type == "cuda":
        torch.cuda.synchronize(eng.device)
    t0 = time.perf_counter()
    for chunk in range(CHUNKS):
        eng.run(CHUNK_TICKS)  # windows lengthen and drains overlap inside each chunk
        if not any(e["event"] == "merge" for e in eng.history):
            before_merge = len(eng.mains[0].tokens)
        if chunk % 2 == 1:
            rep = eng.memory_report()
            st = eng.stats
            reports.append(dict(rep, tick=st["ticks"]))
            print(f"[tick {st['ticks']:3d}] agents={rep['n_agents']} "
                  f"dispatches={st['tick_dispatches']} "
                  f"(ticks/dispatch={st['ticks'] / max(st['tick_dispatches'], 1):.1f} "
                  f"overlapped_drains={st['overlapped_drains']} "
                  f"windows={st['window_hist']}) "
                  f"weights={rep['weight_bytes'] / 1e6:.1f}MB "
                  f"ctx/agent={rep['context_bytes_per_agent'] / 1e6:.2f}MB "
                  f"total={rep['total_bytes'] / 1e6:.1f}MB "
                  f"(standard-arch counterfactual: {rep['standard_architecture_bytes'] / 1e6:.1f}MB)")
    seconds = time.perf_counter() - t0  # each run() ends on a ring fetch, a host sync
    ticks = CHUNKS * CHUNK_TICKS
    return {
        "reports": reports,
        "spawns": [e for e in eng.history if e["event"] == "spawn"],
        "merges": [e for e in eng.history if e["event"] == "merge"],
        "river0_tokens": list(eng.mains[0].tokens),
        "river0_prompt_len": eng.mains[0].prompt_len,
        # river 0's tokens drained by the end of the last chunk with no
        # merge yet: no injected thought can have reached them
        "river0_tokens_before_merge": before_merge,
        "stats": dict(eng.stats),
        "ticks": ticks, "seconds": seconds, "ms_per_tick": seconds / ticks * 1e3,
    }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--full", action="store_true", help="the published widths (default: the reduced config)")
    ap.add_argument("--device", default=None, help="torch device (default: the card)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config("qwen2.5-0.5b", reduced=not args.full)
    print(f"[council] {cfg.name} ({cfg.n_layers}L d={cfg.d_model}) on {device}")
    prism = Prism(model_lib.init_params(cfg, seed=0, device=device), cfg, device=device)
    eng = build_engine(prism, ByteTokenizer(cfg.vocab_size))
    out = run_council(eng)

    print("\n--- event log ---")
    for e in eng.history:
        print(e)
    print("\n--- river 0 text (tail) ---")
    print(repr(eng.mains[0].text[-120:]))
    print(f"[council] {out['ticks']} virtual ticks in {out['seconds']:.2f} s "
          f"({out['ms_per_tick']:.2f} ms per tick)")
    return dict(out, arch=cfg.name, layers=cfg.n_layers, d_model=cfg.d_model, device=str(device),
                river0_text=eng.mains[0].text, engine=eng)


if __name__ == "__main__":
    main()
