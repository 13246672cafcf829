"""Sharding-aware primitives for the streaming synapse decode.

Port of the JAX package's ``repro.core.synapse_sharded``:

* ``onehot_write`` / ``onehot_read`` — the cache ring's per-lane write and
  read. With no token axis live they are the exact scatter and gather
  (the engine's hot path); with one live, the one-hot select and
  contraction, elementwise over the token dimension.
* ``piece_attend`` — the side attend, every side layer's on every tick:
  the attend over the ``[landmarks; window; inject]`` pieces, which
  :func:`cat_pieces` concatenates. With no token axis it is ONE
  ``synapse_attention`` launch over the concatenated pieces (the
  hand-written kernel on the card, its plain version on the CPU), or,
  inside an :func:`attend_break` scope, the break a tick's graph capture
  cuts at. With a token axis each rank holds a token shard of every piece:
  the flash-decode combine takes the local max and sum in plain torch, as
  the reference's ``shard_map`` body does in plain ``jnp``, and
  all-reduces the max, the sum and the outputs over the group.

Shard placement is scoped, not global: callers pass a
:class:`ShardContext` or enter :func:`token_sharding`.
"""
from __future__ import annotations

import contextlib
import dataclasses
from contextvars import ContextVar

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch.kernels import ops

NEG_INF = -1e30


@dataclasses.dataclass(frozen=True)
class ShardContext:
    """Token-shard placement for the synapse buffers: the axis their token
    dims are split over (None = everything local) and the mesh that owns
    it — a :class:`~repro_torch.launch.mesh.LaneMesh` or a process group —
    required whenever ``axis`` is set and a collective runs."""

    axis: str | None = None
    mesh: object | None = None


_CTX: ContextVar[ShardContext] = ContextVar("synapse_shard_ctx", default=ShardContext())
# where piece_attend's one-launch path goes instead, inside an
# ``attend_break`` scope (a tick's graph capture cuts there)
_BREAK: ContextVar = ContextVar("synapse_attend_break", default=None)


@contextlib.contextmanager
def token_sharding(axis: str | None, mesh=None):
    """Scoped token-shard placement; restores the previous context on exit,
    on error too."""
    token = _CTX.set(ShardContext(axis, mesh))
    try:
        yield _CTX.get()
    finally:
        _CTX.reset(token)


@contextlib.contextmanager
def attend_break(fn):
    """Within the scope, :func:`piece_attend`'s one-launch path calls
    ``fn(q, pieces, valids, scale)`` in its place, which returns what that
    path returns; restores the previous break on exit, on error too."""
    token = _BREAK.set(fn)
    try:
        yield
    finally:
        _BREAK.reset(token)


def current_context() -> ShardContext:
    return _CTX.get()


def _resolve(ctx: ShardContext | None) -> ShardContext:
    return _CTX.get() if ctx is None else ctx


def onehot_write(buf, slot, new, mask=None, *, ctx: ShardContext | None = None):
    """In place: buf [B,T,...] <- new [B,...] at per-lane ``slot``, only on
    lanes where ``mask`` holds. No token axis: a per-lane scatter, bitwise
    the one-hot select for in-bounds slots (every caller's), without
    [B,T]-shaped masks. A token axis, or a DTensor buffer (on a mesh):
    the one-hot select, elementwise over the token dim."""
    if _resolve(ctx).axis is None and not isinstance(buf, DTensor):
        lane = torch.arange(buf.shape[0], device=buf.device)
        slot = slot.long()
        val = new.to(buf.dtype)
        if mask is not None:
            cur = buf[lane, slot]
            val = torch.where(mask.reshape(mask.shape + (1,) * (val.dim() - 1)), val, cur)
        buf[lane, slot] = val
        return buf
    oh = slot.long()[:, None] == torch.arange(buf.shape[1], device=buf.device)[None, :]  # [B, T]
    if mask is not None:
        oh = oh & mask[:, None]
    oh = oh.reshape(oh.shape + (1,) * (buf.dim() - 2))
    buf.copy_(torch.where(oh, new[:, None].to(buf.dtype), buf))
    return buf


def onehot_read(buf, slot, *, ctx: ShardContext | None = None):
    """buf [B,T,...] -> [B,...] at per-lane ``slot``: a gather with no token
    axis, the one-hot contraction (in f32) with one; the two agree exactly
    for f32 and int32 buffers and in-bounds slots. A DTensor buffer takes
    the contraction too."""
    if _resolve(ctx).axis is None and not isinstance(buf, DTensor):
        return buf[torch.arange(buf.shape[0], device=buf.device), slot.long()]
    oh = (slot.long()[:, None] == torch.arange(buf.shape[1], device=buf.device)[None, :]).float()
    out = torch.einsum("bt,bt...->b...", oh, buf.float())
    return out.to(buf.dtype)


def _group(mesh):
    return getattr(mesh, "group", mesh)


def cat_pieces(pieces, valids, out=None):
    """The ``[landmarks; window; inject]`` key set: pieces [(k_i, v_i)] with
    k_i/v_i [B,T_i,Hkv,D] and valids [(B,T_i)] -> (keys, values, valid)
    concatenated over T. ``out``: (keys, values, valid) buffers of those
    shapes to write into, returned."""
    keys, values, valid = out or (None, None, None)
    return (torch.cat([k for k, _ in pieces], dim=1, out=keys),
            torch.cat([v for _, v in pieces], dim=1, out=values),
            torch.cat(list(valids), dim=1, out=valid))


def piece_attend(q, pieces, valids, scale, *, ctx: ShardContext | None = None):
    """The side attend over [landmarks; window; inject] (k, v) pieces.

    q: [B,H,D]; pieces: [(k_i, v_i)] with k_i/v_i [B,T_i,Hkv,D] (this rank's
    token shard when an axis is live); valids: [(B,T_i)] bools.
    With a live token axis, the flash-decode combine over the group; else,
    inside an :func:`attend_break` scope, the break; else ONE
    ``ops.synapse_attention`` launch over :func:`cat_pieces`.
    Returns (out [B,H,D], masses [(B,T_i)] — per-key probability mass,
    summed over heads, of this rank's keys).
    """
    c = _resolve(ctx)
    sizes = [k.shape[1] for k, _ in pieces]
    if c.axis is None:
        brk = _BREAK.get()
        if brk is not None:
            return brk(q, pieces, valids, scale)
        k_all, v_all, valid_all = cat_pieces(pieces, valids)
        out, mass = ops.synapse_attention(q, k_all, v_all, valid_all, scale=scale)
        return out, list(torch.split(mass, sizes, dim=1))
    if c.mesh is None:
        raise ValueError("piece_attend: ShardContext has an axis but no mesh")
    group = _group(c.mesh)
    B, H, D = q.shape
    Hkv = pieces[0][0].shape[2]
    G = H // Hkv
    k_loc, v_loc, valid_loc = cat_pieces(pieces, valids)
    qg = q.reshape(B, Hkv, G, D)
    s = torch.einsum("bkgd,btkd->bkgt", qg, k_loc).float() * scale
    s = torch.where(valid_loc[:, None, None, :], s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1)
    dist.all_reduce(m, op=dist.ReduceOp.MAX, group=group)
    e = torch.exp(s - m[..., None])
    denom = e.sum(dim=-1)
    dist.all_reduce(denom, op=dist.ReduceOp.SUM, group=group)
    p = e / denom[..., None]
    out = torch.einsum("bkgt,btkd->bkgd", p.to(v_loc.dtype), v_loc)
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    mass = p.sum(dim=(1, 2))
    return out.reshape(B, H, D), list(torch.split(mass, sizes, dim=1))
