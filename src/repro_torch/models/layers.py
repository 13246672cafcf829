"""Primitive layers: norms, rotary embeddings, the SwiGLU MLP, init helpers.

Plain functions on tensors over a parameter dict, as in the JAX package's
``repro.models.layers``. Weights are ``[d_in, d_out]`` and used as
``x @ W``. Initialisers take an explicit ``torch.Generator``.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.launch.mesh import DATA_AXES, MODEL_AXIS


# ---------------------------------------------------------------------------
# explicit redistributions around ops whose DTensor rule cannot take a
# sharded dim (both are no-ops on plain tensors)
# ---------------------------------------------------------------------------
def replicate_dims(x, *dims):
    """``x`` with tensor dims ``dims`` whole on every rank: each mesh dim
    that shards one of them is gathered; other placements stay."""
    if not isinstance(x, DTensor):
        return x
    dims = {d % x.dim() for d in dims}
    want = tuple(Replicate() if isinstance(p, Shard) and p.dim in dims else p for p in x.placements)
    return x if want == tuple(x.placements) else x.redistribute(x.device_mesh, want)


def split_heads(x, n: int, d: int, *, groups: int | None = None):
    """x [..., n * d] -> [..., n, d]. On a mesh, a shard of the last dim
    over mesh dims whose size does not divide ``groups`` (default ``n``)
    is gathered first: the split cannot keep it (9 heads over 8 ranks), nor
    the grouped-query split of the heads into (kv heads, group) when the kv
    heads do not divide (4 kv heads over 8 ranks)."""
    if isinstance(x, DTensor) and (groups or n) % _last_dim_split(x):
        x = replicate_dims(x, -1)
    return x.reshape(*x.shape[:-1], n, d)


def _last_dim_split(x) -> int:
    """How many ways the last dim of a DTensor is split over the mesh."""
    return math.prod(x.device_mesh.size(m) for m, p in enumerate(x.placements)
                     if isinstance(p, Shard) and p.dim % x.dim() == x.dim() - 1)


class _MergeHeads(torch.autograd.Function):
    """[..., n, d] -> [..., n * d] whose backward gathers the gradient's
    last dim when its split does not divide n (the split back to heads
    cannot keep it)."""

    @staticmethod
    def forward(ctx, x):
        ctx.shape = x.shape
        return x.reshape(*x.shape[:-2], -1)

    @staticmethod
    def backward(ctx, g):
        if ctx.shape[-2] % _last_dim_split(g):
            g = replicate_dims(g, -1)
        return g.reshape(ctx.shape)


def merge_heads(x):
    """x [..., n, d] -> [..., n * d]."""
    if isinstance(x, DTensor):
        return _MergeHeads.apply(x)
    return x.reshape(*x.shape[:-2], -1)


class _ContiguousGrad(torch.autograd.Function):
    """Identity whose backward hands on a contiguous gradient: across a
    ``local_map`` boundary a gradient shard may be strided, and some ops'
    backward passes view it."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


def split_mesh(x):
    """The mesh of ``x`` when it is a DTensor on more than one rank, else
    None: on a mesh of one rank nothing is split, and the plain code runs
    as it is (bitwise the one-device run)."""
    return x.device_mesh if isinstance(x, DTensor) and x.device_mesh.size() > 1 else None


def lane_head_placements(x, n_heads: int | None, head_dims: tuple, partial: tuple = ()):
    """(mesh, placements per tensor) of an op on ``x``'s mesh in which
    every (lane, head) computes on its own (the attention cores, Mamba2's
    scan, RWKV6's recurrence): each rank takes its block of lanes (dim 0)
    over the data axes when the lanes divide them, and of heads over the
    model axis when ``n_heads`` divides it (None: the heads stay whole),
    every other dim whole. ``head_dims``: each tensor's head dim (None:
    none); ``partial``: the indices of outputs summed over heads (partial
    over the model axis when the heads are split)."""
    mesh = x.device_mesh
    names = mesh.mesh_dim_names
    dp = [m for m, n in enumerate(names) if n in DATA_AXES]
    lanes = x.shape[0] % math.prod(mesh.size(m) for m in dp) == 0
    heads = n_heads is not None and MODEL_AXIS in names and n_heads % mesh.size(names.index(MODEL_AXIS)) == 0

    def one(i, hd):
        out = []
        for m, n in enumerate(names):
            if m in dp and lanes:
                out.append(Shard(0))
            elif n == MODEL_AXIS and heads:
                out.append(Partial() if i in partial else (Replicate() if hd is None else Shard(hd)))
            else:
                out.append(Replicate())
        return tuple(out)

    return mesh, [one(i, hd) for i, hd in enumerate(head_dims)]


def per_shard(fn, mesh, out_placements, in_placements, *args):
    """``fn(*args)`` on each rank's shards (``local_map``): DTensor
    arguments are redistributed to ``in_placements``, plain tensors taken
    as replicated, and ``fn``'s outputs wrapped with ``out_placements``.
    Gradients cross the boundary contiguous, both ways."""
    from torch.distributed.tensor.experimental import local_map

    rep = [Replicate()] * mesh.ndim
    args = tuple(DTensor.from_local(a, mesh, rep, run_check=False)
                 if isinstance(a, torch.Tensor) and not isinstance(a, DTensor) else a for a in args)

    def contiguous_grads(ts):
        return tuple(_ContiguousGrad.apply(t) if isinstance(t, torch.Tensor) and t.requires_grad else t for t in ts)

    def body(*a):
        out = fn(*contiguous_grads(a))
        return contiguous_grads(out) if isinstance(out, tuple) else contiguous_grads((out,))[0]

    return local_map(body, out_placements=out_placements, in_placements=in_placements, redistribute_inputs=True,
                     device_mesh=mesh)(*args)


def embed_lookup(tokens, table):
    """``table``'s rows at ``tokens``. On a mesh the table is gathered
    whole first (its backward a reduce-scatter of the rows' gradient):
    DTensor's own rule for a lookup into split rows keeps a mask that a
    later step can find stale, and an older one's backward refuses the
    placement."""
    return F.embedding(tokens, replicate_dims(table, 0))


def on_replicas(fn, *args):
    """``fn(*args)``; on a mesh, with every DTensor argument gathered whole
    and ``fn`` run on each rank's full copy (the same work on every rank),
    its one output a replicated DTensor. For ops that must see every element
    (a global sort's scatter) and whose DTensor rules cannot place them."""
    mesh = next((a.device_mesh for a in args if isinstance(a, DTensor)), None)
    if mesh is None:
        return fn(*args)
    rep = (Replicate(),) * mesh.ndim
    return per_shard(fn, mesh, (rep,), tuple(rep if isinstance(a, torch.Tensor) else None for a in args), *args)


def gather_fsdp(w):
    """A weight whole over the data axes (``DATA_AXES``), still split over
    the model axis: FSDP's gather before use."""
    if not isinstance(w, DTensor):
        return w
    names = w.device_mesh.mesh_dim_names
    want = tuple(Replicate() if n in DATA_AXES else p for n, p in zip(names, w.placements))
    return w if want == tuple(w.placements) else w.redistribute(w.device_mesh, want)


# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------
def dense_init(gen: torch.Generator, d_in: int, d_out: int, dtype, device, *, lead=()):
    """Normal weights scaled by 1/sqrt(d_in); ``lead`` prepends stacked
    layer axes."""
    w = torch.randn((*lead, d_in, d_out), generator=gen, device=device, dtype=torch.float32)
    return (w / np.sqrt(d_in)).to(dtype)


def embed_init(gen: torch.Generator, vocab: int, d: int, dtype, device):
    w = torch.randn((vocab, d), generator=gen, device=device, dtype=torch.float32)
    return (w * 0.02).to(dtype)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------
def rms_norm(x, weight, eps: float = 1e-6):
    """RMSNorm with the statistics in f32, cast back to the input dtype."""
    dtype = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * weight.float()).to(dtype)


# ---------------------------------------------------------------------------
# rotary embeddings
# ---------------------------------------------------------------------------
def rope_freqs(d_head: int, theta: float):
    """Inverse frequencies [d_head//2] (f32, computed in numpy as the
    reference does, so both packages start from the same bits)."""
    return 1.0 / (theta ** (np.arange(0, d_head, 2).astype(np.float32) / d_head))


@functools.lru_cache(maxsize=16)
def _inv_freqs(d_head: int, theta: float, device: torch.device):
    """rope_freqs on ``device``, copied there once (at prefill), so a decode
    window makes no host-to-device copy. Callers never mutate it."""
    return torch.from_numpy(rope_freqs(d_head, theta)).to(device)


def apply_rope(x, positions, theta: float):
    """Split-half rotation. x: [..., S, H, D]; positions broadcastable to
    [..., S]. Angles are f32."""
    d = x.shape[-1]
    inv = _inv_freqs(d, theta, x.device)
    ang = positions[..., None].float() * inv  # [..., S, D/2]
    ang = ang[..., None, :]  # broadcast over heads
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


@functools.lru_cache(maxsize=16)
def _mrope_select(d_half: int, sections: tuple[int, int, int], device: torch.device):
    """[3, d_half] f32 one-hot: frequency band i rotates by axis sel[:, i]."""
    sel = np.zeros((3, d_half), np.float32)
    start = 0
    for axis, sec in enumerate(sections):
        sel[axis, start:start + sec] = 1.0
        start += sec
    return torch.from_numpy(sel).to(device)


def apply_mrope(x, positions, theta: float, sections: tuple[int, int, int]):
    """Multimodal RoPE (Qwen2-VL §3): positions [..., 3, S] for (t, h, w).

    The head dim's frequency bands are split into ``sections`` (halved
    dims: sum(sections) == d_head // 2); each band rotates by its own
    positional axis. For text, where the three axes carry the same index,
    this is standard RoPE.
    """
    d = x.shape[-1]
    assert sum(sections) == d // 2, (sections, d)
    inv = _inv_freqs(d, theta, x.device)
    ang_all = positions[..., :, :, None].float() * inv  # [..., 3, S, D/2]
    ang = torch.einsum("...tsd,td->...sd", ang_all, _mrope_select(d // 2, tuple(sections), x.device))
    ang = ang[..., None, :]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------
def swiglu_init(gen: torch.Generator, d_model: int, d_ff: int, dtype, device, *, lead=()):
    return {
        "gate": dense_init(gen, d_model, d_ff, dtype, device, lead=lead),
        "up": dense_init(gen, d_model, d_ff, dtype, device, lead=lead),
        "down": dense_init(gen, d_ff, d_model, dtype, device, lead=lead),
    }


def swiglu(params, x):
    h = F.silu(x @ params["gate"]) * (x @ params["up"])
    return h @ params["down"]
