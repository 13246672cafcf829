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
``--mesh debug`` (the default) trains on one device. ``--mesh single``
and ``--mesh multi`` train over the production mesh of the group the
process was started in (``repro_torch.launch.mesh``): (data, model), or
(pod, data, model) with two pods, ``model`` being the cards of one host::

    torchrun --nproc-per-node=8 -m repro_torch.launch.train --mesh single --full --arch qwen2.5-0.5b

The train state (params and both AdamW moments) is distributed as DTensors
by ``sharding.param_specs`` (FSDP over the data axes, tensor and expert
parallelism over ``model``), each batch by ``sharding.batch_specs``, and
the residual stream between layers is placed (batch over the data axes,
sequence over ``model``) as the reference's activation anchors place it.
On one card the mesh is (1, 1). ``--ckpt-every`` saves full tensors: every
rank gathers, rank 0 writes. :func:`main` returns the run's metrics.
"""
from __future__ import annotations

import argparse
import os
from pathlib import Path

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch.checkpoint import io as ckpt
from repro_torch.configs import ARCHS, get_config
from repro_torch.data.pipeline import DataConfig, batch_to, make_batch
from repro_torch.device import resolve_device
from repro_torch.launch import sharding as shard_lib
from repro_torch.launch.mesh import MODEL_AXIS, data_axes, make_production_mesh, mesh_device
from repro_torch.models import model as model_lib
from repro_torch.models.model import tree_map
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


def full(t):
    """A DTensor's whole value on every rank (a collective); a plain tensor as it is."""
    return t.full_tensor() if isinstance(t, DTensor) else t


def place_state(state, cfg, mesh):
    """The train state as DTensors on ``mesh``: params by
    ``sharding.param_specs``, the AdamW moments with their params'
    placements, the step counters replicated."""
    return shard_lib.distribute(state, shard_lib.param_specs(state, cfg, mesh), mesh)


def mesh_step(step, cfg, mesh):
    """``step`` (a train step) on ``mesh``: each batch placed by
    ``sharding.batch_specs``, the residual stream placed between layers
    (batch over the data axes, sequence over ``model``), plain tensors
    inside the step taken as replicated, and the metrics returned whole.
    ``mesh`` None: ``step`` as it is."""
    if mesh is None:
        return step
    act = (data_axes(mesh), MODEL_AXIS, None)

    def run(state, batch):
        batch = shard_lib.distribute(batch, shard_lib.batch_specs(batch, cfg, mesh), mesh)
        model_lib.set_activation_sharding(act)
        try:
            with implicit_replication():
                state, m = step(state, batch)
        finally:
            model_lib.set_activation_sharding(None)
        return state, {k: full(v) for k, v in m.items()}

    return run


def main(argv=None) -> dict:
    """Train; returns {"arch", "device", "mesh" (its shape, None for
    debug), "steps", "losses" (every step's), "final" (the last step's
    metrics), "checkpoints" (paths written), "state" (the last)}. A
    process group this call had to make is destroyed before it returns."""
    args = parse_args(argv)
    cfg = get_config(args.arch, reduced=args.reduced)
    opt = AdamWConfig(lr=args.lr, warmup_steps=max(args.steps // 20, 1), total_steps=args.steps)
    mesh, own_group = None, not dist.is_initialized()
    try:
        if args.mesh == "debug":
            device = resolve_device(args.device)
        else:
            try:
                mesh = make_production_mesh(multi_pod=args.mesh == "multi", device=args.device)
            except ValueError as e:
                raise SystemExit(f"--mesh {args.mesh}: {e}") from None
            device = mesh_device(mesh)
        state = init_train_state(cfg, seed=0, device=device)
        if mesh is not None:
            state = place_state(state, cfg, mesh)
        step = mesh_step(make_train_step(cfg, opt), cfg, mesh)
        writer = mesh is None or dist.get_rank() == 0

        losses, paths, m = [], [], {}
        for i in range(args.steps):
            batch = batch_to(make_batch(cfg, DataConfig(seq_len=args.seq, batch_size=args.batch, seed=i)), device)
            state, m = step(state, batch)
            losses.append(m["loss"])
            if writer and (i % 10 == 0 or i == args.steps - 1):
                print(f"step {i:5d}  loss {float(m['loss']):.4f}  lr {float(m['lr']):.3e}", flush=True)
            if args.ckpt_every and i and i % args.ckpt_every == 0:
                params = tree_map(full, state.params)  # every rank gathers, rank 0 writes
                paths.append(os.path.join(args.ckpt_dir, f"step{i}.wcsb"))
                if writer:
                    ckpt.save_framed(paths[-1], params)
        losses = torch.stack(losses).tolist() if losses else []
    finally:
        if own_group and dist.is_initialized():  # a group this call made ends with it
            dist.destroy_process_group()
    return {"arch": cfg.name, "device": str(device), "mesh": None if mesh is None else tuple(mesh.shape),
            "steps": args.steps, "losses": losses,
            "final": {k: float(v) for k, v in m.items()}, "checkpoints": paths, "state": state}


if __name__ == "__main__":
    main()
