"""Training launcher of the port.

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \\
        --steps 100 --seq 256 --batch 16

    # on the CPU (the default is the card; without one it raises)
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu --steps 3

Port of the JAX package's ``repro.launch.train``: random weights from seed
0, the synthetic corpus (batch ``i`` from seed ``i``), the train step
(AdamW, warmup over the first twentieth of the steps, cosine decay), a log
line every 10 steps and, with ``--ckpt-every``, the params every that many
steps as stored framed blobs under ``--ckpt-dir``. ``--reduced`` (the
default) is the small smoke variant of the config, ``--full`` the
published widths.
``--mesh`` takes ``debug`` (one device) only: the reference's ``single``
and ``multi`` meshes are TPU pods, and training across cards comes with
the launch tooling, ROADMAP item 14. :func:`main` returns the run's
metrics.
"""
from __future__ import annotations

import argparse
import os
from pathlib import Path

import torch

from repro_torch.checkpoint import io as ckpt
from repro_torch.configs import ARCHS, get_config
from repro_torch.data.pipeline import DataConfig, batch_to, make_batch
from repro_torch.device import resolve_device
from repro_torch.training.optimizer import AdamWConfig
from repro_torch.training.trainer import init_train_state, make_train_step

DEFAULT_CKPT_DIR = Path(__file__).resolve().parents[3] / "build" / "train_ckpt"


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="smollm-135m", choices=list(ARCHS))
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--mesh", default="debug", choices=["debug", "single", "multi"])
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--ckpt-dir", default=str(DEFAULT_CKPT_DIR))
    ap.add_argument("--device", default=None, help="torch device (default: the card)")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    """Train; returns {"arch", "device", "steps", "losses" (every step's),
    "final" (the last step's metrics), "checkpoints" (paths written)}."""
    args = parse_args(argv)
    if args.mesh != "debug":
        raise SystemExit(f"--mesh {args.mesh}: the reference's single and multi meshes are TPU pods; the port "
                         f"trains on one device (--mesh debug), and training across cards comes with the "
                         f"launch tooling, ROADMAP item 14")
    device = resolve_device(args.device)
    cfg = get_config(args.arch, reduced=args.reduced)
    opt = AdamWConfig(lr=args.lr, warmup_steps=max(args.steps // 20, 1), total_steps=args.steps)
    step = make_train_step(cfg, opt)
    state = init_train_state(cfg, seed=0, device=device)

    losses, paths, m = [], [], {}
    for i in range(args.steps):
        batch = batch_to(make_batch(cfg, DataConfig(seq_len=args.seq, batch_size=args.batch, seed=i)), device)
        state, m = step(state, batch)
        losses.append(m["loss"])
        if i % 10 == 0 or i == args.steps - 1:
            print(f"step {i:5d}  loss {float(m['loss']):.4f}  lr {float(m['lr']):.3e}", flush=True)
        if args.ckpt_every and i and i % args.ckpt_every == 0:
            paths.append(os.path.join(args.ckpt_dir, f"step{i}.wcsb"))
            ckpt.save_framed(paths[-1], state.params)
    return {"arch": cfg.name, "device": str(device), "steps": args.steps,
            "losses": torch.stack(losses).tolist() if losses else [],
            "final": {k: float(v) for k, v in m.items()}, "checkpoints": paths}


if __name__ == "__main__":
    main()
