"""Referential Injection (paper §3.6).

A side agent's accepted thought is encoded by a forward pass with the shared
weights, and its per-layer K/V are appended to the main agent's caches at
*virtual* RoPE positions: the main stream's tokens and positions are
untouched. Full and MLA caches receive the K/V at the write cursor,
synapse caches in their ``inj_*`` slots. For attention-free layers
(RWKV6, Mamba2 state) injection is a *state blend*: the thought's terminal
recurrent state is mixed into the main state. Port of the JAX package's
``repro.core.injection``; the main caches are updated IN PLACE.
"""
from __future__ import annotations

import torch

from repro_torch import trace
from repro_torch.core import gate as gate_lib
from repro_torch.models import cache as cache_lib
from repro_torch.models import model as model_lib
from repro_torch.models.config import ModelConfig

BLEND_BETA = 0.3  # weight of the thought's state in a blend, as in the reference


def encode_thought_kv(params, cfg: ModelConfig, thought_tokens, virtual_pos):
    """Run a forward pass over the thought and capture per-layer K/V.

    thought_tokens: [B, T] int32; virtual_pos: [B]. Returns the ModelCaches
    of a throwaway prefill with capacity T (exactly the thought's rotated
    K/V) and the terminal hidden state [B, d] for the Validation Gate.
    """
    B, T = thought_tokens.shape
    positions = virtual_pos[:, None] + torch.arange(T, dtype=torch.int32, device=thought_tokens.device)[None, :]
    if cfg.rope_kind == "mrope":
        positions = positions[:, None, :].expand(B, 3, T)
    spec = model_lib.CacheSpec(kind="full", capacity=T)
    caches = model_lib.init_caches(cfg, B, spec, device=thought_tokens.device)
    _, hidden, caches = model_lib.prefill(
        params, cfg, {"tokens": thought_tokens, "positions": positions}, caches, spec=spec
    )
    return caches, hidden


def _append_lanes(dst, src, start, accept):
    """In place: per lane b with accept[b], dst[:, b, start[b]:start[b]+T]
    <- src[:, b]. dst [L,B,S,...], src [L,B,T,...]; ``start`` must keep the
    slice in bounds (callers clamp, as the reference's dynamic_update_slice
    does)."""
    B, T = src.shape[1], src.shape[2]
    idx = start.long()[:, None] + torch.arange(T, device=dst.device)[None, :]  # [B, T]
    lane = torch.arange(B, device=dst.device)[:, None].expand(B, T)
    cur = dst[:, lane, idx]
    acc = accept.reshape((1, B) + (1,) * (cur.dim() - 2))
    dst[:, lane, idx] = torch.where(acc, src.to(dst.dtype), cur)


def inject_full(main: cache_lib.FullCache, thought: cache_lib.FullCache, accept):
    """Append thought K/V into a stacked FullCache group, in place.

    main.*: [L, B, S, ...]; thought.*: [L, B, T, ...]; accept: [B] bool.
    The slice starts at the lane's cursor, clamped to S - T as the
    reference's ``dynamic_update_slice`` clamps it (near capacity the last T
    slots are overwritten); length grows by T for accepted lanes.
    """
    S, T = main.k.shape[2], thought.k.shape[2]
    start = torch.clamp(main.length[0], max=S - T)  # [B] — all layers share lane lengths
    for f in ("k", "v", "pos", "score"):
        _append_lanes(getattr(main, f), getattr(thought, f), start, accept)
    main.length.copy_(torch.where(accept, main.length + T, main.length))
    return main


def inject_synapse(main: cache_lib.SynapseCache, thought: cache_lib.FullCache, accept):
    """Write thought K/V into the synapse's injection slots, in place.
    Thought tokens beyond the J slots are dropped oldest-first."""
    J = main.inj_k.shape[2]
    T = thought.k.shape[2]
    take = min(T, J)
    start = torch.clamp(main.inj_count[0], max=J - take)  # [B]
    _append_lanes(main.inj_k, thought.k[:, :, T - take:], start, accept)
    _append_lanes(main.inj_v, thought.v[:, :, T - take:], start, accept)
    _append_lanes(main.inj_pos, thought.pos[:, :, T - take:], start, accept)
    main.inj_count.copy_(torch.where(accept, torch.clamp(main.inj_count + take, max=J), main.inj_count))
    return main


def inject_mla(main: cache_lib.MLACache, thought: cache_lib.MLACache, accept):
    """Append the thought's latents into a stacked MLACache group, in place
    (the start clamped as in :func:`inject_full`)."""
    S, T = main.ckv.shape[2], thought.ckv.shape[2]
    start = torch.clamp(main.length[0], max=S - T)
    for f in ("ckv", "krope", "score"):
        _append_lanes(getattr(main, f), getattr(thought, f), start, accept)
    main.length.copy_(torch.where(accept, main.length + T, main.length))
    return main


def blend_state(main_state, thought_state, accept):
    """SSM adaptation, in place: mix the thought's terminal recurrent state
    into the main state of accepted lanes, (1 - β) m + β t in f32 with
    β = BLEND_BETA. main/thought: stacked [L, B, ...] states of one kind."""
    for m, t in zip(cache_lib.tensors(main_state), cache_lib.tensors(thought_state)):
        acc = accept.reshape((1, -1) + (1,) * (m.dim() - 2))
        blended = (1.0 - BLEND_BETA) * m.float() + BLEND_BETA * t.float()
        m.copy_(torch.where(acc, blended.to(m.dtype), m))
    return main_state


def _inject_one(m, t, accept):
    if isinstance(m, cache_lib.MLACache):
        return inject_mla(m, t, accept)
    if isinstance(m, cache_lib.SynapseCache):
        return inject_synapse(m, t, accept)
    if isinstance(m, cache_lib.FullCache):
        return inject_full(m, t, accept)
    with trace.span("merge.blend"):
        return blend_state(m, t, accept)


def inject(cfg: ModelConfig, main_caches, thought_caches, accept):
    """Injection across the whole stack — every group and the shared
    block's caches — in place. Both cache trees come from the same cfg."""
    for m, t in zip(main_caches.parts(), thought_caches.parts()):
        _inject_one(m, t, accept)
    return main_caches


def merge_thought(params, cfg: ModelConfig, main_caches, main_hidden, thought_tokens, virtual_pos,
                  lane_mask, theta: float):
    """Encode + Validation Gate + Referential Injection as one step.

    The gate decision stays on the device, so the thought prefill and the
    masked inject always run. Returns (main_caches, accept [B] bool,
    score [B] f32).
    """
    thought_caches, t_hidden = encode_thought_kv(params, cfg, thought_tokens, virtual_pos)
    accept_vec, score = gate_lib.validate(main_hidden, t_hidden, theta)
    accept = accept_vec & lane_mask
    inject(cfg, main_caches, thought_caches, accept)
    return main_caches, accept, score
