"""The lane group: side-agent lanes split over a ``torch.distributed`` group.

Port of the lane half of the JAX package's ``repro.launch.mesh``. The
reference's lane mesh is a 1-D device mesh whose ``lane`` axis the engine's
side lanes shard over, under one controller. Here each rank is one process
on one device (SPMD): a :class:`LaneMesh` names the process group, this
rank, the world size and the device, and the engine and the BatchServer
place their lanes by it (``repro_torch.launch.sharding``).

On cards the group is NCCL (one card per rank: ``torchrun
--nproc-per-node=N`` and :func:`make_lane_mesh`, which reads the rank's card
from ``LOCAL_RANK``); on the CPU it is gloo. Host decisions that depend on
time (a wake's prefetch being ready) are agreed over a gloo group beside
the device one (``cpu_group``).
"""
from __future__ import annotations

import datetime
import os
from dataclasses import dataclass

import torch
import torch.distributed as dist

from repro_torch.device import resolve_device

LANE_AXIS = "lane"
# how long a collective may wait for the other ranks before it raises: a
# rank that fails leaves the others blocked in their next collective
TIMEOUT = datetime.timedelta(seconds=300)


@dataclass(frozen=True)
class LaneMesh:
    """One rank's view of the lane group. ``group`` carries the device
    collectives (NCCL on the card, gloo on the CPU); ``cpu_group`` the
    host agreements (gloo)."""

    group: object
    cpu_group: object
    rank: int
    world: int
    device: torch.device
    axis_names: tuple = (LANE_AXIS,)

    @property
    def shape(self) -> dict:
        return {LANE_AXIS: self.world}

    def global_rank(self, rank: int) -> int:
        """The default group's rank of this group's ``rank`` (collectives
        name their source by it)."""
        return dist.get_global_rank(self.group, rank)


def make_lane_mesh(n_lanes: int | None = None, *, group=None, device=None) -> LaneMesh:
    """The lane group over ``group`` (the default group when None) or its
    first ``n_lanes`` ranks. Runs on ``device``, the card unless
    ``device="cpu"`` (under ``torchrun`` the card of ``LOCAL_RANK``).

    When the default group does not exist yet it is made from the
    environment ``torchrun`` sets (NCCL on the card, gloo on the CPU).
    Refused: a CUDA mesh over a gloo group, a CPU mesh over NCCL, and
    ``n_lanes`` larger than the group. Every rank of the default group
    calls this function (a subgroup is made collectively)."""
    if device is None and "LOCAL_RANK" in os.environ:
        device = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
    device = resolve_device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if group is None:
        if not dist.is_initialized():
            dist.init_process_group("nccl" if device.type == "cuda" else "gloo", timeout=TIMEOUT)
        group = dist.group.WORLD
    size = dist.get_world_size(group)
    n = size if n_lanes is None else n_lanes
    if n > size:
        raise ValueError(f"make_lane_mesh: {n} lanes > {size} ranks in the group")
    backend = dist.get_backend(group)
    want = "nccl" if device.type == "cuda" else "gloo"
    if backend != want:
        raise ValueError(f"make_lane_mesh: a {device.type} lane group needs {want}, the group is {backend}")
    ranks = [dist.get_global_rank(group, r) for r in range(n)]
    if n < size:
        group = dist.new_group(ranks, backend=backend, timeout=TIMEOUT)
    cpu_group = group if backend == "gloo" else dist.new_group(ranks, backend="gloo", timeout=TIMEOUT)
    if dist.get_rank() not in ranks:
        raise ValueError(f"make_lane_mesh: rank {dist.get_rank()} is outside the {n}-lane group")
    return LaneMesh(group=group, cpu_group=cpu_group, rank=dist.get_rank(group), world=n, device=device)


def lane_axis(mesh) -> str | None:
    """The lane axis name when ``mesh`` carries one, else None."""
    return LANE_AXIS if mesh is not None and LANE_AXIS in mesh.axis_names else None
