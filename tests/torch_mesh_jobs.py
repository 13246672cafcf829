"""Sharded train-step jobs for the CPU tests: the port's train step over a
(data, model) = (2, 2) mesh of gloo ranks, each a process spawned by the
test through ``torch_lane_jobs.Ranks`` (a deadline, every rank killed on
a failure, each rank's traceback reported).

Every rank builds the same reduced config in f32 from the weights the
parent passes (the reference's, through ``bridge``), distributes the train
state by ``sharding.param_specs`` and runs ``launch.train.mesh_step`` over
the same batches. Rank 0 returns the metrics of every step and the
params gathered whole after the last; every rank returns the bytes of its
shards. This module imports torch and the port only, so the ranks start
without JAX.
"""
from __future__ import annotations

import dataclasses

OPT = dict(warmup_steps=1, total_steps=10)  # the reference smoke test's optimizer
SEQ, BATCH, STEPS = 32, 4, 2


def reduced_cfg(arch: str):
    from repro_torch.configs import get_config

    return dataclasses.replace(get_config(arch, reduced=True), compute_dtype="float32")


def batches(cfg) -> list:
    from repro_torch.data.pipeline import DataConfig, batch_to, make_batch

    return [batch_to(make_batch(cfg, DataConfig(seq_len=SEQ, batch_size=BATCH, seed=i)), "cpu")
            for i in range(STEPS)]


def train(cfg, params, mesh) -> dict:
    """STEPS train steps from ``params`` (numpy leaves) on ``mesh`` (None:
    one device): {"metrics": per step, "params": numpy leaves whole,
    "grad0": the first step's gradients (one device only), "shard_bytes":
    this rank's bytes of params and moments, "full_bytes"}."""
    import torch

    from repro_torch import bridge
    from repro_torch.launch.train import full, mesh_step, place_state
    from repro_torch.models.model import tree_leaves, tree_map
    from repro_torch.training.optimizer import AdamWConfig
    from repro_torch.training.trainer import make_train_step, train_state

    state = train_state(bridge.params_from_jax(params, cfg, "cpu"))
    full_bytes = sum(t.numel() * t.element_size() for t in tree_leaves((state.params, state.opt.m, state.opt.v)))
    if mesh is not None:
        state = place_state(state, cfg, mesh)
    local = lambda t: getattr(t, "_local_tensor", t)
    shard_bytes = sum(local(t).numel() * local(t).element_size()
                      for t in tree_leaves((state.params, state.opt.m, state.opt.v)))
    step = mesh_step(make_train_step(cfg, AdamWConfig(**OPT)), cfg, mesh)
    grad0 = None
    if mesh is None:  # the first step's gradients, for the comparison's tolerance
        from repro_torch.training.trainer import loss_fn

        leaves = tree_leaves(state.params)
        grads = torch.autograd.grad(loss_fn(state.params, cfg, batches(cfg)[0])[0], leaves, allow_unused=True)
        it = iter(torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads))
        grad0 = tree_map(lambda _: next(it).numpy(), state.params)
    metrics = []
    for batch in batches(cfg):
        state, m = step(state, batch)
        metrics.append({k: float(v) for k, v in m.items()})
    whole = tree_map(lambda t: full(t).detach().numpy().copy(), state.params)
    return {"metrics": metrics, "params": whole, "grad0": grad0, "shard_bytes": shard_bytes,
            "full_bytes": full_bytes}


def wkv_parity(mesh) -> list:
    """RWKV6's recurrence on ``mesh`` (lanes over ``data``, heads over
    ``model``) against the plain one on the same inputs (seed 0): the
    largest difference of each output, the decode step's (state, out) and
    the scan's (outs, state)."""
    import torch
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.models import rwkv6

    g = torch.Generator().manual_seed(0)
    B, S, h, hs = 4, 3, 4, 8
    u, state = torch.randn(h, hs, generator=g), torch.randn(B, h, hs, hs, generator=g)
    tok = [torch.randn(B, h, hs, generator=g) for _ in range(4)]
    seq = [torch.randn(B, S, h, hs, generator=g) for _ in range(4)]
    put = lambda t, head: distribute_tensor(t, mesh, (Shard(0), Shard(head)))
    du, dstate = distribute_tensor(u, mesh, (Replicate(), Replicate())), put(state, 1)
    got = (*rwkv6._wkv_decode(du, dstate, *(put(t, 1) for t in tok)),
           *rwkv6._wkv_scan(du, dstate, *(put(t, 2) for t in seq)))
    want = (*rwkv6._wkv_step(u, state, *tok), *rwkv6._wkv_recur(u, state, *seq))
    return [float((a.full_tensor() - b).abs().max()) for a, b in zip(got, want)]


def train_job(params_by_arch: dict) -> dict:
    """On every rank of a group of 4: the (2, 2) debug mesh, then
    :func:`train` of each arch and :func:`wkv_parity` (under "wkv")."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_debug_mesh

    mesh = make_debug_mesh(2, 2, device="cpu")
    out = {"wkv": wkv_parity(mesh)}
    for arch, params in params_by_arch.items():
        run = train(reduced_cfg(arch), params, mesh)
        if dist.get_rank() != 0:
            run.pop("params")
        out[arch] = run
    return out
