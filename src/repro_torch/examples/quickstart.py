"""Quickstart: batched serving of a small model with the public API.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--arch smollm-135m] [--device cpu] [--full]

Port of the JAX package's ``examples/quickstart.py``: a ``BatchServer`` of
4 lanes (capacity 256) serves four requests, each with its own sampling
parameters, through the pipelined drain. It runs on the card unless
``--device cpu``; the reduced config of ``--arch`` unless ``--full`` (the
published widths). Weights are random, from ``init_params`` seeded 0 on
the target device. :func:`main` returns the requests and the server's
counters.
"""
from __future__ import annotations

import argparse
import time

from repro_torch.configs import get_config, list_archs
from repro_torch.data.tokenizer import ByteTokenizer
from repro_torch.device import resolve_device
from repro_torch.models import model as model_lib
from repro_torch.serving.sampler import SamplingParams
from repro_torch.serving.server import BatchServer

# per-request sampling: greedy and exploratory requests batch into the
# same decode and one sampling pass (per-lane temperature/top-k/top-p)
PER_REQUEST = [
    SamplingParams(greedy=True),
    SamplingParams(temperature=0.7, top_k=20),
    SamplingParams(temperature=1.2, top_p=0.9),
    None,  # the server's default
]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="qwen2.5-0.5b", choices=list_archs())
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--max-new-tokens", type=int, default=24)
    ap.add_argument("--full", action="store_true", help="the published widths (default: the reduced config)")
    ap.add_argument("--device", default=None, help="torch device (default: the card)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch, reduced=not args.full)
    print(f"[quickstart] arch={args.arch} ({'full' if args.full else 'reduced'}: "
          f"{cfg.n_layers}L d={cfg.d_model}) on {device}")
    params = model_lib.init_params(cfg, seed=0, device=device)
    tok = ByteTokenizer(cfg.vocab_size)
    server = BatchServer(params, cfg, tok, n_lanes=4, capacity=256,
                         sampling=SamplingParams(temperature=0.9, top_k=40), device=device)
    for i in range(args.requests):
        server.submit(f"request {i}: tell me something.", max_new_tokens=args.max_new_tokens,
                      sampling=PER_REQUEST[i % len(PER_REQUEST)])
    # pipelined drain (default): step t+1 is dispatched before step t's
    # tokens reach the host, so detokenize/EOS checks overlap device decode
    t0 = time.perf_counter()
    done = server.run_until_done()
    seconds = time.perf_counter() - t0
    for r in done:
        print(f"[req {r.rid}] ({r.sampling or server.sampling}) {r.prompt!r} -> {r.text!r}")
    st = server.stats
    print(f"[server] steps={st['steps']} overlapped={st['overlapped']} rollbacks={st['rollbacks']}")
    return {
        "arch": cfg.name, "layers": cfg.n_layers, "d_model": cfg.d_model, "device": str(device),
        "requests": [{"rid": r.rid, "prompt": r.prompt, "status": r.status, "prompt_len": r.prompt_len,
                      "tokens": list(r.tokens), "text": r.text} for r in done],
        "stats": dict(st), "seconds": seconds,
    }


if __name__ == "__main__":
    main()
