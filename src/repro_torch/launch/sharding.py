"""Placement rules: the (data, model) half and the lane half of the JAX
package's ``repro.launch.sharding``.

**Params, optimizer state, batches and caches** (``param_specs``,
``batch_specs``, ``cache_specs``, ``fit_spec``). The rules are the
reference's, line for line, and return what its ``PartitionSpec``s hold: one
entry per tensor dim, None (replicated), an axis name, or a tuple of axis
names (major to minor). The baseline scheme: FSDP over the (pod, data) axes
on the input dim of every matrix, tensor parallelism over ``model`` on the
heads / ffn / expert dim, experts over ``model``, the batch over (pod,
data), and a full KV cache's capacity dim over ``model`` when the kv-head
count does not divide it. An axis that does not divide a dim is dropped
(``_fit``): no rule makes an invalid placement. :func:`placements` turns a
spec into DTensor placements on a ``DeviceMesh``, and :func:`distribute`
places a whole tree.

**Lanes** (``tick_state_specs``, ``lane_cache_specs``, ``lane_gather``,
``lane_scatter``). The reference declares lane placements as PartitionSpecs
under one controller. Here every rank is a process that allocates only its
own block of lanes, so the placement is arithmetic: global lanes ``0..n-1``
are split in contiguous blocks of ``n / world``, rank ``r`` holding
``[r * n / world, (r + 1) * n / world)``. The engine's rule is the
reference's: every ``side_*`` leaf of its ``TickState`` splits its lane
dimension in those blocks, while the river, the ring cursor and the river's
generator are replicated (every rank steps the river). The BatchServer
splits its request lanes the same way.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor

from repro_torch.checkpoint.io import tree_map
from repro_torch.launch.mesh import MODEL_AXIS, axis_sizes, data_axes
from repro_torch.models import model as model_lib
from repro_torch.models.config import ModelConfig


# ---------------------------------------------------------------------------
# specs: one entry per tensor dim (None, an axis name, or a tuple of names)
# ---------------------------------------------------------------------------
class Spec(tuple):
    """The reference's ``PartitionSpec``: one entry per tensor dim, None,
    an axis name, or a tuple of axis names (major to minor). A leaf of the
    spec trees, not a node."""

    def __repr__(self):
        return f"Spec{tuple.__repr__(self)}"


def _axis_size(sizes: dict, axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    n = 1
    for a in axes:
        n *= sizes[a]
    return n


def _fit(sizes: dict, dim: int, axes):
    """Return ``axes`` if it divides dim, trying progressively smaller subsets."""
    if axes is None:
        return None
    if isinstance(axes, str):
        axes = (axes,)
    for k in range(len(axes), 0, -1):
        cand = axes[-k:]  # prefer keeping the last (usually 'data'/'model')
        if dim % _axis_size(sizes, cand) == 0:
            return cand if len(cand) > 1 else cand[0]
    return None


def _spec(sizes: dict, shape, axes_per_dim) -> Spec:
    return Spec(_fit(sizes, dim, ax) for dim, ax in zip(shape, axes_per_dim))


_IN_OUT = {"wq", "wk", "wv", "gate", "up", "w_in", "wuq", "wuk", "wuv", "wdkv",
           "wdq", "head", "wr", "wg", "embed_proj"}
_OUT_IN = {"wo", "down", "w_out"}


def _param_rule(path_keys: list[str], shape, fsdp, tp):
    name = path_keys[-1]
    nd = len(shape)
    stacked = "groups" in path_keys  # leading layer-stack dim
    off = 1 if stacked and nd >= 2 else 0
    lead = [None] * off
    body = shape[off:]
    bnd = len(body)

    if name == "embed":
        return lead + [tp, None]
    if bnd == 0 or bnd == 1:
        return lead + [None] * bnd
    if name in ("experts_gate", "experts_up"):  # [E, dm, ff]
        return lead + [tp, fsdp, None]
    if name in ("experts_down",):               # [E, ff, dm]
        return lead + [tp, None, fsdp]
    if name == "router":
        return lead + [fsdp, None]
    if name == "lora_a":                        # [n_inv, dm, r]
        return lead + [None, fsdp, None]
    if name == "lora_b":                        # [n_inv, r, out]
        return lead + [None, None, tp]
    if name == "conv_w":                        # [W, channels]
        return lead + [None, tp]
    if name == "u":                             # [h, hs]
        return lead + [tp, None]
    if name in ("mu", "mix_a", "mix_b"):        # rwkv stacked small
        return lead + [None] * bnd
    if name in _OUT_IN and bnd == 2:
        return lead + [tp, fsdp]
    if bnd == 2:
        # default in->out matrices (_IN_OUT + decay_a/decay_b/cmix wk ...)
        return lead + [fsdp, tp]
    return lead + [None] * bnd


def _map_with_names(fn, tree, names=()):
    """``tree`` rebuilt with each leaf (a tensor or a :class:`Spec`)
    replaced by ``fn(names, leaf)``; ``names`` are the dict keys, list
    indices and dataclass fields on the way down (the reference's path
    names)."""
    if tree is None:
        return None
    if isinstance(tree, (torch.Tensor, Spec)):
        return fn(list(names), tree)
    if isinstance(tree, dict):
        return {k: _map_with_names(fn, v, (*names, str(k))) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_with_names(fn, v, (*names, str(i))) for i, v in enumerate(tree))
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return type(tree)(**{f.name: _map_with_names(fn, getattr(tree, f.name), (*names, f.name))
                             for f in dataclasses.fields(tree)})
    raise TypeError(f"unsupported tree node {type(tree).__name__} at {'/'.join(names) or 'the root'}")


def param_specs(params, cfg: ModelConfig, mesh, *, fsdp_on: bool = True):
    """Spec tree matching any params / train-state tree (the moments take
    their params' placements, the step counters replicate).

    fsdp_on=False: pure tensor-parallel weights (replicated over pod/data),
    the serving mode: no per-step weight all-gathers."""
    sizes = axis_sizes(mesh)
    fsdp = data_axes(mesh) if fsdp_on else ()

    def one(names, leaf):
        # disambiguate expert weights (experts/{gate,up,down})
        if len(names) >= 2 and names[-2] == "experts":
            names = names[:-1] + [f"experts_{names[-1]}"]
        return _spec(sizes, leaf.shape, _param_rule(names, leaf.shape, fsdp, MODEL_AXIS))

    return _map_with_names(one, params)


def fit_spec(mesh, shape, axes_per_dim) -> Spec:
    """Public divisibility-aware spec maker."""
    return _spec(axis_sizes(mesh), shape, axes_per_dim)


def batch_specs(batch, cfg: ModelConfig, mesh):
    """tokens/labels [B,S] and embeds [B,S,d] shard batch over (pod, data)."""
    sizes, dp = axis_sizes(mesh), data_axes(mesh)
    return _map_with_names(lambda _, leaf: _spec(sizes, leaf.shape, [dp] + [None] * (len(leaf.shape) - 1)), batch)


def cache_specs(caches, cfg: ModelConfig, mesh, *, synapse_token_shard: bool = True):
    """Stacked caches [L, B, T, Hkv, D] (or state trees [L, B, ...]).

    Batch over (pod, data). For 4D+ cache leaves: try kv-heads over "model";
    if not divisible the _fit fallback replicates, and instead the token /
    capacity dim takes "model" (flash-decode style sharded KV).

    synapse_token_shard=False: landmark/window/inject buffers replicate their
    token dim (they are O(K+W+J) small; sharding it forces a per-step
    all-gather of every synapse buffer)."""
    sizes, dp, tp = axis_sizes(mesh), data_axes(mesh), MODEL_AXIS
    tp_size = sizes[tp]

    def one(names, leaf):
        shape = tuple(leaf.shape)
        nd = len(shape)
        is_synapse_buf = any(n.startswith(("lm_", "win_", "inj_")) for n in names)
        if is_synapse_buf and not synapse_token_shard:
            axes = [None, dp] + [None] * max(nd - 2, 0)
            if nd == 5 and shape[3] % tp_size == 0:
                axes[3] = tp
            return _spec(sizes, shape, axes[:nd])
        if nd <= 1:
            return Spec()
        if nd == 2:  # [L, B] lengths/counts
            return _spec(sizes, shape, [None, dp])
        if nd == 3:  # [L, B, T] pos/score  or [L, B, d] shift states
            return _spec(sizes, shape, [None, dp, None])
        # [L, B, T, Hkv, D] kv   | [L, B, nh, dh, ds] ssm | [L,B,H,hs,hs]
        axes = [None, dp] + [None] * (nd - 2)
        if nd == 5 and shape[3] % tp_size == 0:
            axes[3] = tp            # kv heads over model
        elif nd == 5 and shape[2] % tp_size == 0:
            axes[2] = tp            # capacity over model (flash-decode)
        elif nd == 4 and shape[2] % tp_size == 0:
            axes[2] = tp            # latent capacity / ssm heads over model
        elif nd == 4 and shape[3] % tp_size == 0:
            axes[3] = tp            # channels over model (conv tails etc.)
        return _spec(sizes, shape, axes)

    return _map_with_names(one, caches)


# ---------------------------------------------------------------------------
# specs -> DTensor placements
# ---------------------------------------------------------------------------
def placements(spec: Spec, mesh) -> tuple:
    """DTensor placements on ``mesh`` (a ``DeviceMesh``) for one spec: mesh
    dim ``m`` takes ``Shard(d)`` when tensor dim ``d`` names its axis, else
    ``Replicate()``. Several mesh dims on one tensor dim (("pod", "data")
    under FSDP) split it in mesh-dim order, the first the major, which is
    the reference's block order; a tuple that names its axes in another
    order is refused. A mesh dim of size one splits nothing: it takes
    ``Replicate()`` (some DTensor rules refuse a dim marked split even
    there)."""
    names = list(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for d, axes in enumerate(spec):
        if axes is None:
            continue
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec {spec}: axes {axes} are not in the mesh's order {tuple(names)}")
        for m in idx:
            if mesh.size(m) > 1:
                out[m] = Shard(d)
    return tuple(out)


def shardings_for(specs, mesh):
    """The placements tree of a spec tree (the reference's NamedShardings)."""
    return _map_with_names(lambda _, spec: placements(spec, mesh), specs)


def distribute(tree, specs, mesh):
    """Every tensor leaf of ``tree`` as a DTensor on ``mesh`` placed by its
    spec (the same tensor is expected on every rank; each keeps its shard).
    Leaves that required grad still do."""
    def one(names, leaf):
        pl = placements(_lookup(specs, names), mesh)
        d = distribute_tensor(leaf.detach(), mesh, pl, src_data_rank=None)
        # a shard may be a view of the whole tensor: a copy of its own lets
        # the whole one go
        d = DTensor.from_local(d._local_tensor.clone(), mesh, pl, run_check=False, shape=d.shape, stride=d.stride())
        return d.requires_grad_(leaf.requires_grad)

    return _map_with_names(one, tree)


def _lookup(tree, names):
    for n in names:
        tree = tree[n] if isinstance(tree, dict) else (
            tree[int(n)] if isinstance(tree, (list, tuple)) else getattr(tree, n))
    return tree


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
