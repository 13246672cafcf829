"""``chip_smoke.py`` phase 10 on a lane group of several cards of one host.

    torchrun --nproc-per-node=N tools/lane_group.py

Every rank is one process on its own card (``make_lane_mesh()``: NCCL from
torchrun's environment, the card of ``LOCAL_RANK``) and runs, at full width
and depth (Qwen2.5-0.5B, bf16, random weights from seed 0), phase 4's
workload twice: on a plain engine of its own (``mesh=None``: each card
holds the whole model) and on ``CortexEngine(mesh=...)`` with
``max_side = 8``, its side lanes split over the N ranks. It holds the lane
run to the plain one with ``chip_smoke.check_lane_runs`` (streams, spawns,
merges and gate scores bitwise; one all-gather per drain, every window
after the first under ``set_sync_debug_mode("error")``; each rank's kernel
launches: one ``landmark_score`` per spawn into a lane it holds, one
``synapse_attention`` per layer and side tick; the peak within the
gathered ring buffer of the plain run's), then ``BatchServer(mesh=...,
n_lanes=4)`` on both loops against the plain server, where N divides 4.
Each rank prints one JSON line with its card's name and power limit, its
times and its readings; a failed check raises, and torchrun fails the run.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(HERE), str(HERE / "src")]
import chip_smoke as cs  # noqa: E402


def main() -> int:
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.core.prism import Prism
    from repro_torch.data.tokenizer import ByteTokenizer
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_lane_mesh
    from repro_torch.models import model as tm

    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = make_lane_mesh()
    t0 = time.perf_counter()
    ops.build_kernels()
    cfg = get_config("qwen2.5-0.5b")
    prism = Prism(tm.init_params(cfg, seed=0), cfg)
    tok = ByteTokenizer(cfg.vocab_size)
    plain = cs.lane_run(prism, tok, None, timed=cs.TIMED_WINDOWS)
    lane = cs.lane_run(prism, tok, mesh, timed=cs.TIMED_WINDOWS)
    cs.check_lane_runs(plain, lane, cfg)
    batch = None
    if 4 % mesh.world == 0:
        batch = {}
        for pipeline in (True, False):
            batch[pipeline] = cs.lane_batch(prism.params, cfg, tok, mesh, pipeline)
            if batch[pipeline] != cs.lane_batch(prism.params, cfg, tok, None, pipeline):
                raise AssertionError(f"lane group: the BatchServer (pipeline={pipeline}) differs from mesh=None")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
                           "-i", str(mesh.device.index)], capture_output=True, text=True, check=True,
                          timeout=30).stdout.strip()
    print(json.dumps({
        "lane_group_rank": mesh.rank, "world": mesh.world, "backend": dist.get_backend(mesh.group),
        "device": str(mesh.device), "card": card, "spawns": sum(r[0] == "spawn" for r in lane["records"]),
        "owned_spawns": lane["owned_spawns"], "merges": sum(r[0] == "merge" for r in lane["records"]),
        "side_ticks": lane["side_ticks"], "launches": lane["launches"],
        "ring_gathers": lane["stats"]["ring_gathers"], "drains": lane["stats"]["drains"],
        "tick_ms": lane["tick_ms"], "tokens_per_s": lane["tokens_per_s"],
        "plain_tick_ms": plain["tick_ms"], "plain_tokens_per_s": plain["tokens_per_s"],
        "peak_before_swap": lane["peak_before_swap"], "plain_peak_before_swap": plain["peak_before_swap"],
        "batch_equal": batch is not None, "seconds": time.perf_counter() - t0}), flush=True)
    dist.barrier(group=mesh.cpu_group)
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
