"""The sharded train step on four cards of one host: FSDP x TP over a
(data, model) = (2, 2) mesh.

    torchrun --nproc-per-node=4 tools/train_mesh.py

Every rank is one process on its own card (``make_debug_mesh(2, 2)``: NCCL
from torchrun's environment, the card of ``LOCAL_RANK``). Qwen2.5-0.5B at
full width and depth (f32 params and Adam moments, bf16 compute, remat
"full", random weights from seed 0) trains ``STEPS`` steps of 8 x 512
tokens on the synthetic corpus through ``launch.train.place_state`` and
``mesh_step``: the train state split by ``sharding.param_specs`` (FSDP
over ``data``, tensor and expert parallelism over ``model``), each batch
over ``data``, the residual stream over ``data`` and ``model`` between
layers. Rank 0 then runs the same steps unsharded on its card (``--mesh
debug``'s step) and every rank's losses are held to those within 2e-3
relative (bf16 compute: a split sum rounds otherwise), each rank's shards
of the params and moments to the bytes worked out from the leaf shapes
alone (:func:`expected_shard_bytes`), and each rank's peak memory to below
the unsharded peak. Rank 0 prints one JSON line with the
card's name and power limit, the step ms (median of steps 2 on) and peak
memory of both runs; a failed check raises, and torchrun fails the run.
"""
from __future__ import annotations

import json
import statistics
import sys
import time
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(HERE), str(HERE / "src")]
import chip_smoke as cs  # noqa: E402

STEPS = 6


def expected_shard_bytes(params) -> int:
    """The bytes a rank of the (2, 2) mesh holds of a Qwen2.5 params-shaped
    tree, from the leaf shapes alone: a half of the tied embedding (its
    vocab dim over ``model``), a quarter of each stacked matrix [L, in, out]
    (one dim over ``data``, the other over ``model``), the stacked norms
    and biases [L, d] and the final norm whole."""
    from repro_torch.models.model import tree_leaves

    def share(t):
        return 2 if t is params["embed"] else 4 if t.dim() == 3 else 1

    return sum(t.numel() * t.element_size() // share(t) for t in tree_leaves(params))


def run(step, state, batches) -> tuple:
    """(losses, step ms each, peak bytes): each step between two synchronisations."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, ms = [], []
    for b in batches:
        torch.cuda.synchronize()
        t = time.perf_counter()
        state, m = step(state, b)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t) * 1e3)
        losses.append(float(m["loss"]))
    return losses, ms, torch.cuda.max_memory_allocated()


def main() -> int:
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, batch_to, make_batch
    from repro_torch.launch.mesh import make_debug_mesh, mesh_device
    from repro_torch.launch.train import mesh_step, place_state
    from repro_torch.models.model import tree_leaves
    from repro_torch.training.optimizer import AdamWConfig
    from repro_torch.training.trainer import init_train_state, make_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = make_debug_mesh(2, 2)
    rank, dev = dist.get_rank(), mesh_device(mesh)
    t0 = time.perf_counter()
    cfg = get_config("qwen2.5-0.5b")
    opt = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=STEPS)
    batches = [batch_to(make_batch(cfg, DataConfig(seq_len=cs.TRAIN_SEQ, batch_size=cs.TRAIN_BATCH, seed=i)), dev)
               for i in range(STEPS)]
    state = place_state(init_train_state(cfg, seed=0, device=dev), cfg, mesh)
    local = lambda t: t._local_tensor
    moments = (state.params, state.opt.m, state.opt.v)
    shard = sum(local(t).numel() * local(t).element_size() for t in tree_leaves(moments))
    whole = sum(t.numel() * t.element_size() for t in tree_leaves(moments))
    expected = sum(expected_shard_bytes(tree) for tree in moments)
    losses, ms, peak = run(mesh_step(make_train_step(cfg, opt), cfg, mesh), state, batches)
    del state, moments
    torch.cuda.empty_cache()
    got = [None] * dist.get_world_size()
    dist.all_gather_object(got, {"losses": losses, "ms": ms, "peak": peak, "shard": shard})
    if rank == 0:
        plain_losses, plain_ms, plain_peak = run(make_train_step(cfg, opt), init_train_state(cfg, seed=0, device=dev),
                                                 batches)
        worst = max(abs(a - b) / abs(b) for r in got for a, b in zip(r["losses"], plain_losses))
        rec = {"train_mesh_4": cfg.name, "card": cs.card_line(), "mesh": tuple(mesh.shape), "steps": STEPS,
               "batch": cs.TRAIN_BATCH, "seq": cs.TRAIN_SEQ, "losses": [r["losses"] for r in got],
               "plain_losses": plain_losses, "max_rel_diff": worst,
               "step_ms": [statistics.median(r["ms"][1:]) for r in got], "first_step_ms": [r["ms"][0] for r in got],
               "plain_step_ms": statistics.median(plain_ms[1:]), "peak": [r["peak"] for r in got],
               "plain_peak": plain_peak, "shard_bytes": [r["shard"] for r in got], "whole_bytes": whole,
               "expected_shard_bytes": expected,
               "s": time.perf_counter() - t0}
        print(json.dumps(rec), flush=True)
        if not worst <= 2e-3:
            raise AssertionError(f"train mesh: losses {rec['losses']} vs unsharded {plain_losses}")
        if not all(r["shard"] == expected for r in got):
            raise AssertionError(f"train mesh: shards {rec['shard_bytes']} of {whole} bytes, {expected} expected")
        if not all(r["peak"] < plain_peak for r in got):
            raise AssertionError(f"train mesh: peaks {rec['peak']} vs unsharded {plain_peak}")
    dist.barrier()
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
