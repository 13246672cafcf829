"""Meshes of the port: the (data, model) meshes of an H100 cluster and the
lane group.

Port of the JAX package's ``repro.launch.mesh``.

**Production meshes.** A ``torch.distributed.device_mesh.DeviceMesh`` with
the reference's axis names: ``single`` is (``data``, ``model``), ``multi``
is (``pod``, ``data``, ``model``) with two pods. The ``model`` axis (tensor
and expert parallelism, the most traffic per step) stays inside one host's
NVLink domain: it is the cards of one host, at most 8. The ``data`` and
``pod`` axes (FSDP and the batch) cross hosts over the network. The dry run
and the roofline use the fixed shapes (32, 8) = 256 ranks and (2, 32, 8) =
512 ranks over a fake process group: 32 hosts of 8 H100s, the same device
counts as the reference's 16x16 and 2x16x16 TPU v5e pods. The constants
below are the H100 SXM's spec-sheet values, not measurements.

**The lane group.** The reference's lane mesh is a 1-D device mesh whose
``lane`` axis the engine's side lanes shard over, under one controller.
Here each rank is one process on one device (SPMD): a :class:`LaneMesh`
names the process group, this rank, the world size and the device, and the
engine and the BatchServer place their lanes by it
(``repro_torch.launch.sharding``).

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
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from repro_torch.device import resolve_device

LANE_AXIS = "lane"
DATA_AXES = ("pod", "data")
MODEL_AXIS = "model"

# H100 SXM, NVIDIA's data sheet (dense rates, 700 W): the roofline's constants
PEAK_FLOPS_BF16 = 989e12   # FLOP/s per card, bf16 tensor cores
HBM_BW = 3.35e12           # bytes/s per card
NVLINK_BW = 450e9          # bytes/s per direction per card (NVLink 4): the model axis
NET_BW = 50e9              # bytes/s per card, one 400 Gb/s NDR port: the data and pod axes
HBM_BYTES = 80e9           # device memory per card
HOST_CARDS = 8             # cards in one NVLink domain (one HGX host)
# the dry run's and the roofline's fixed meshes: 32 hosts of 8 cards
DRYRUN_SHAPES = {False: (32, 8), True: (2, 32, 8)}
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


def production_shape(world: int, *, multi_pod: bool = False, per_host: int | None = None) -> tuple:
    """The production mesh's shape for ``world`` ranks: ``model`` = the
    cards of one host (``per_host``, at most 8), ``data`` = the rest, split
    over two pods when ``multi_pod``. A world that does not split so is
    refused."""
    model = min(HOST_CARDS, per_host or world)
    pods = 2 if multi_pod else 1
    if world % (pods * model):
        raise ValueError(f"a {'multi' if multi_pod else 'single'}-pod mesh of {world} ranks: {world} is not a "
                         f"multiple of {pods} pod(s) x {model} cards per host")
    data = world // (pods * model)
    return (pods, data, model) if multi_pod else (data, model)


def _rank_device(device):
    """The rank's device: under ``torchrun`` the card of ``LOCAL_RANK``."""
    if device is None and "LOCAL_RANK" in os.environ:
        device = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
    device = resolve_device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    return device


def _init_default_group(device) -> None:
    """The default group, when there is none yet: from ``torchrun``'s
    environment, or a group of one over an in-process store for a process
    started alone."""
    if dist.is_initialized():
        return
    backend = "nccl" if device.type == "cuda" else "gloo"
    if "RANK" in os.environ:
        dist.init_process_group(backend, timeout=TIMEOUT)
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1, timeout=TIMEOUT)


def make_production_mesh(multi_pod: bool = False, *, device=None, per_host: int | None = None) -> DeviceMesh:
    """The production mesh over the default group (made as
    :func:`_init_default_group` says when it does not exist yet): (data,
    model), or (pod, data, model) when ``multi_pod``. ``per_host``
    defaults to ``LOCAL_WORLD_SIZE`` (the cards ``torchrun`` started on this
    host). On the ``cpu`` device it runs over gloo, or over the fake group
    the dry run makes."""
    device = _rank_device(device)
    _init_default_group(device)
    world = dist.get_world_size()
    per_host = per_host or int(os.environ.get("LOCAL_WORLD_SIZE", world))
    shape = production_shape(world, multi_pod=multi_pod, per_host=per_host)
    names = ("pod", "data", MODEL_AXIS) if multi_pod else ("data", MODEL_AXIS)
    return init_device_mesh(device.type, shape, mesh_dim_names=names)


def make_debug_mesh(n_data: int = 2, n_model: int = 2, *, device=None) -> DeviceMesh:
    """A small (data, model) mesh for the sharded train step's tests and
    ``tools/train_mesh.py``: the default group must hold n_data * n_model
    ranks."""
    device = _rank_device(device)
    _init_default_group(device)
    if dist.get_world_size() != n_data * n_model:
        raise ValueError(f"make_debug_mesh({n_data}, {n_model}) needs {n_data * n_model} ranks, "
                         f"the group has {dist.get_world_size()}")
    return init_device_mesh(device.type, (n_data, n_model), mesh_dim_names=("data", MODEL_AXIS))


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """This rank's device on ``mesh``: its card, or the CPU."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def axis_sizes(mesh) -> dict:
    """{axis name: size} of a ``DeviceMesh``, or of a plain mapping (a mesh
    known by its shape alone, as the reference's ``AbstractMesh``)."""
    if isinstance(mesh, dict):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def data_axes(mesh) -> tuple[str, ...]:
    return tuple(a for a in axis_sizes(mesh) if a in DATA_AXES)


def model_axis(mesh) -> str:
    return MODEL_AXIS


def make_lane_mesh(n_lanes: int | None = None, *, group=None, device=None) -> LaneMesh:
    """The lane group over ``group`` (the default group when None) or its
    first ``n_lanes`` ranks. Runs on ``device``, the card unless
    ``device="cpu"`` (under ``torchrun`` the card of ``LOCAL_RANK``).

    When the default group does not exist yet it is made from the
    environment ``torchrun`` sets (NCCL on the card, gloo on the CPU).
    Refused: a CUDA mesh over a gloo group, a CPU mesh over NCCL, and
    ``n_lanes`` larger than the group. Every rank of the default group
    calls this function (a subgroup is made collectively)."""
    device = _rank_device(device)
    if group is None:
        _init_default_group(device)
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
