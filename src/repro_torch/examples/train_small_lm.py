"""End-to-end training driver: train a small LM for a few hundred steps on
the synthetic corpus, checkpoint it, and sample from it.

    PYTHONPATH=src python -m repro_torch.examples.train_small_lm [--steps 200] [--device cpu]

Port of the JAX package's ``examples/train_small_lm.py``: data pipeline ->
train loop -> checkpoint save and load -> the port's ``BatchServer``
sampling two prompts from the restored weights. It runs on the card unless
``--device cpu``; the checkpoint goes under ``build/`` unless ``--ckpt``
names another path. :func:`main` returns the losses, the checkpoint's size
and the samples.
"""
from __future__ import annotations

import argparse
import os
import time
from pathlib import Path

import torch

from repro_torch.checkpoint import io as ckpt
from repro_torch.configs import get_config
from repro_torch.data.pipeline import DataConfig, batch_to, make_batch
from repro_torch.data.tokenizer import ByteTokenizer
from repro_torch.device import resolve_device
from repro_torch.serving.sampler import SamplingParams
from repro_torch.serving.server import BatchServer
from repro_torch.training.optimizer import AdamWConfig
from repro_torch.training.trainer import init_train_state, make_train_step

DEFAULT_CKPT = Path(__file__).resolve().parents[3] / "build" / "repro_small_lm.wcsb"


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--ckpt", default=str(DEFAULT_CKPT))
    ap.add_argument("--device", default=None, help="torch device (default: the card)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch, reduced=True)
    state = init_train_state(cfg, seed=0, device=device)
    step = make_train_step(cfg, AdamWConfig(lr=3e-3, warmup_steps=20, total_steps=args.steps))

    t0 = time.time()
    losses = []
    for i in range(args.steps):
        batch = batch_to(make_batch(cfg, DataConfig(seq_len=args.seq, batch_size=args.batch, seed=i)), device)
        state, m = step(state, batch)
        losses.append(m["loss"])
        if i % 25 == 0 or i == args.steps - 1:
            print(f"step {i:4d}  loss {float(m['loss']):.4f}  lr {float(m['lr']):.2e}  "
                  f"gnorm {float(m['grad_norm']):.2f}  ({time.time()-t0:.0f}s)", flush=True)

    ckpt.save_framed(args.ckpt, state.params)
    size = os.path.getsize(args.ckpt)
    print(f"checkpoint -> {args.ckpt} ({size/1e6:.1f} MB)")

    restored = ckpt.tree_map(lambda a: a.to(device), ckpt.load_framed(args.ckpt, state.params))
    tok = ByteTokenizer(cfg.vocab_size)
    server = BatchServer(restored, cfg, tok, n_lanes=2, capacity=256,
                         sampling=SamplingParams(temperature=0.7, top_k=20), device=device)
    server.submit("12+34=", max_new_tokens=12)
    server.submit("abcde|", max_new_tokens=12)
    samples = []
    for r in server.run_until_done():
        print(f"sample: {r.prompt!r} -> {r.text!r}")
        samples.append({"prompt": r.prompt, "text": r.text, "tokens": list(r.tokens)})
    return {"losses": torch.stack(losses).tolist(), "ckpt_bytes": size, "samples": samples,
            "restored": restored, "params": state.params}


if __name__ == "__main__":
    main()
