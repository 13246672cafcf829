"""Lane placement on a lane group: the lane half of the JAX package's
``repro.launch.sharding`` (``tick_state_specs``, ``lane_cache_specs``,
``lane_gather``, ``lane_scatter``).

The reference declares placements as PartitionSpecs under one controller.
Here every rank is a process that allocates only its own block of lanes, so
the placement is arithmetic: global lanes ``0..n-1`` are split in
contiguous blocks of ``n / world``, rank ``r`` holding
``[r * n / world, (r + 1) * n / world)``. The engine's rule is the
reference's: every ``side_*`` leaf of its ``TickState`` splits its lane
dimension in those blocks, while the river, the ring cursor and the river's
generator are replicated (every rank steps the river). The BatchServer
splits its request lanes the same way.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.distributed as dist

from repro_torch.checkpoint.io import tree_map
from repro_torch.models import model as model_lib


def lane_owner(s: int, world: int, n: int) -> int:
    """The rank that holds global lane ``s`` of ``n``."""
    return s // (n // world)


def local_lanes(rank: int, world: int, n: int) -> range:
    """The global lanes rank ``rank`` holds."""
    b = n // world
    return range(rank * b, (rank + 1) * b)


def to_local(s: int, world: int, n: int) -> int:
    """Global lane ``s`` as an index into its owner's block."""
    return s % (n // world)


@dataclass(frozen=True)
class Lanes:
    """``n`` global lanes split over ``world`` ranks, seen from ``rank``."""

    n: int
    world: int = 1
    rank: int = 0

    @property
    def block(self) -> int:
        """Lanes per rank: what this rank allocates."""
        return self.n // self.world

    @property
    def span(self) -> slice:
        """This rank's block of global lanes."""
        r = local_lanes(self.rank, self.world, self.n)
        return slice(r.start, r.stop)

    def owner(self, s: int) -> int:
        return lane_owner(s, self.world, self.n)

    def local(self, s: int) -> int | None:
        """``s``'s index into this rank's block, or None on other ranks."""
        return to_local(s, self.world, self.n) if self.owner(s) == self.rank else None


def _lanes(mesh, n: int, what: str, why: str) -> Lanes:
    if mesh is None:
        return Lanes(n)
    if n % mesh.world:
        raise ValueError(f"{what}={n} must be a multiple of the lane-axis size {mesh.world} ({why})")
    return Lanes(n, mesh.world, mesh.rank)


def tick_state_specs(mesh, max_side: int) -> Lanes:
    """The engine's side lanes on ``mesh`` (None: every lane local)."""
    return _lanes(mesh, max_side, "max_side", "every side leaf shards the same lane dim")


def lane_cache_specs(mesh, n_lanes: int) -> Lanes:
    """The BatchServer's request lanes on ``mesh`` (None: every lane local)."""
    return _lanes(mesh, n_lanes, "n_lanes", "every rank holds the same number of request lanes")


def lane_gather(mesh, tree, owner: int):
    """Every rank gets the owner's one-lane ``tree`` (the demote half of a
    hibernate or park): one broadcast per tensor from ``owner``. On the
    owner ``tree`` holds the lane's tensors (views are fine); elsewhere it
    holds tensors of the same shapes and dtypes, whose values are not read.
    Returns new contiguous tensors."""
    def one(t):
        buf = torch.empty(t.shape, dtype=t.dtype, device=t.device)
        if mesh.rank == owner:
            buf.copy_(t)
        dist.broadcast(buf, src=mesh.global_rank(owner), group=mesh.group)
        return buf

    return tree_map(one, tree)


def lane_scatter(lanes: Lanes, caches: model_lib.ModelCaches, part: model_lib.ModelCaches, s: int) -> int | None:
    """Write the one-lane ``part`` into global lane ``s`` of the stacked
    ``caches`` (the promote half of a wake), on the rank that holds it.
    Returns the local index there, None elsewhere."""
    i = lanes.local(s)
    if i is not None:
        model_lib.write_lane(caches, part, i)
    return i


def gather_lanes(mesh, out: torch.Tensor, local: torch.Tensor) -> None:
    """``out`` [world * b, ...] <- every rank's ``local`` [b, ...], in rank
    order: one all-gather, ordered on the device after the work that wrote
    ``local`` (no host sync)."""
    gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
    gather(out, local, group=mesh.group)


def agree(mesh, flags: list[bool], *, every: bool) -> list[bool]:
    """The same host decision on every rank: each flag AND-ed (``every``)
    or OR-ed over the ranks, in one all-reduce on the gloo group. Decisions
    that hang on time (is a prefetch ready, has a deadline passed) differ
    between processes; every rank must take the same branch, or the next
    collective pairs the wrong calls."""
    if mesh is None or not flags:
        return list(flags)
    t = torch.tensor([int(f) for f in flags], dtype=torch.int32)
    dist.all_reduce(t, op=dist.ReduceOp.MIN if every else dist.ReduceOp.MAX, group=mesh.cpu_group)
    return [bool(v) for v in t.tolist()]
