"""Multi-head Latent Attention (DeepSeek-V2, arXiv:2405.04434).

Port of the JAX package's ``repro.models.mla``. The KV cache stores only
the latent ``c_kv`` (kv_lora_rank) and one shared rope key per token, which
is itself a KV compression. Decode uses the *absorbed* form: W_uk is folded
into the query and W_uv into the output, so attention runs in latent
space, O(r) per cached token, and returns the per-key mass like the GQA
decode. Plain PyTorch, as the reference is plain jnp.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.models import cache as cache_lib
from repro_torch.models.attention import masked_lane_write
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (apply_rope, dense_init, lane_head_placements, merge_heads, per_shard, rms_norm,
                                      split_heads, split_mesh)

NEG_INF = -1e30
SCORE_EMA = 0.99


def mla_init(gen, cfg: ModelConfig, dtype, device, *, lead=()):
    dm, h = cfg.d_model, cfg.n_heads
    r, dr = cfg.kv_lora_rank, cfg.qk_rope_head_dim
    dn, dv = cfg.qk_nope_head_dim, cfg.v_head_dim
    dense = lambda a, b: dense_init(gen, a, b, dtype, device, lead=lead)
    ones = lambda n: torch.ones((*lead, n), dtype=dtype, device=device)
    qdim = h * (dn + dr)
    p = {}
    if cfg.q_lora_rank:
        p["wdq"] = dense(dm, cfg.q_lora_rank)
        p["q_lora_norm"] = ones(cfg.q_lora_rank)
        p["wuq"] = dense(cfg.q_lora_rank, qdim)
    else:
        p["wq"] = dense(dm, qdim)
    p["wdkv"] = dense(dm, r + dr)
    p["kv_norm"] = ones(r)
    p["wuk"] = dense(r, h * dn)
    p["wuv"] = dense(r, h * dv)
    p["wo"] = dense(h * dv, dm)
    return p


def _queries(p, cfg: ModelConfig, x):
    B, S, _ = x.shape
    h, dn, dr = cfg.n_heads, cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    if cfg.q_lora_rank:
        q = rms_norm(x @ p["wdq"], p["q_lora_norm"], cfg.norm_eps) @ p["wuq"]
    else:
        q = x @ p["wq"]
    q = split_heads(q, h, dn + dr)
    return q[..., :dn], q[..., dn:]  # q_nope [B,S,h,dn], q_rope [B,S,h,dr]


def _latents(p, cfg: ModelConfig, x, positions):
    ckv_full = x @ p["wdkv"]
    ckv, krope = ckv_full[..., :cfg.kv_lora_rank], ckv_full[..., cfg.kv_lora_rank:]
    ckv = rms_norm(ckv, p["kv_norm"], cfg.norm_eps)
    krope = apply_rope(krope[:, :, None, :], positions, cfg.rope_theta)[:, :, 0]
    return ckv, krope  # [B,S,r], [B,S,dr]


def mla_forward(p, cfg: ModelConfig, x, positions, *, chunk: int = 1024):
    """Prefill: materialised keys and values, blocked over queries.
    Returns (y, (ckv, krope)) for the cache fill."""
    B, S, _ = x.shape
    h, dn, dv, dr = cfg.n_heads, cfg.qk_nope_head_dim, cfg.v_head_dim, cfg.qk_rope_head_dim
    qn, qr = _queries(p, cfg, x)
    qr = apply_rope(qr, positions, cfg.rope_theta)
    ckv, krope = _latents(p, cfg, x, positions)
    kn = split_heads(ckv @ p["wuk"], h, dn)
    v = split_heads(ckv @ p["wuv"], h, dv)
    core, kr = functools.partial(_mla_attention, scale=1.0 / np.sqrt(dn + dr), chunk=chunk), krope
    if split_mesh(qn) is not None:  # every (lane, head) on its own: each rank's blocks of them
        mesh, (ph,) = lane_head_placements(qn, h, (2,))
        core = functools.partial(per_shard, core, mesh, (ph,), (ph,) * 5)
        # the shared rope key, one copy a head before the split: its
        # gradient then sums over the heads of every rank
        kr = krope[:, :, None, :].expand(B, S, h, dr)
    out = core(qn, qr, kr, kn, v)
    y = merge_heads(out) @ p["wo"]
    return y, (ckv, krope)


def _mla_attention(qn, qr, krope, kn, v, *, scale: float, chunk: int):
    """Causal attention over materialised keys, blocked over queries:
    [B,S,h,*] -> [B,S,h,dv]; ``krope`` [B,S,dr], or a copy a head [B,S,h,dr]."""
    S = qn.shape[1]
    kpos = torch.arange(S, device=qn.device)
    outs = []
    for c0 in range(0, S, chunk):
        qnc, qrc = qn[:, c0:c0 + chunk], qr[:, c0:c0 + chunk]
        s = torch.einsum("bqhd,bthd->bhqt", qnc, kn) + torch.einsum("bqhd,btd->bhqt", qrc, krope if krope.dim() == 3
                                                                     else krope[:, :, 0])
        s = s.float() * scale
        qpos = c0 + torch.arange(qnc.shape[1], device=qn.device)
        s = torch.where((kpos[None, :] <= qpos[:, None])[None, None], s, torch.full_like(s, NEG_INF))
        pr = torch.softmax(s, dim=-1).to(v.dtype)
        outs.append(torch.einsum("bhqt,bthd->bqhd", pr, v))
    return torch.cat(outs, dim=1)


def mla_decode(p, cfg: ModelConfig, x, cache: cache_lib.MLACache, positions):
    """Absorbed-form single-token decode, updating the cache IN PLACE.
    x: [B,1,dm], positions: [B]. Returns (y [B,1,dm], cache, key_mass [B,S]).

    The reference scatters at ``length``, which JAX drops past capacity; the
    write is masked there, as the GQA decode does, and ``length`` keeps
    growing."""
    B = x.shape[0]
    h, dn, dv, dr, r = (cfg.n_heads, cfg.qk_nope_head_dim, cfg.v_head_dim, cfg.qk_rope_head_dim,
                        cfg.kv_lora_rank)
    qn, qr = _queries(p, cfg, x)
    qr = apply_rope(qr, positions[:, None], cfg.rope_theta)
    ckv_new, krope_new = _latents(p, cfg, x, positions[:, None])
    cap = cache.capacity
    ok = cache.length < cap
    slot = cache.length.clamp(max=cap - 1).long()
    masked_lane_write(cache.ckv, slot, ckv_new[:, 0], ok)
    masked_lane_write(cache.krope, slot, krope_new[:, 0], ok)
    # absorb W_uk into q: q_lat[b,h,r] = sum_dn qn[b,h,dn] * Wuk[r,h,dn]
    q_lat = torch.einsum("bhd,rhd->bhr", qn[:, 0], split_heads(p["wuk"], h, dn))
    s = torch.einsum("bhr,btr->bht", q_lat, cache.ckv) + torch.einsum("bhd,btd->bht", qr[:, 0], cache.krope)
    s = s.float() / np.sqrt(dn + dr)
    valid = torch.arange(cap, device=x.device)[None, :] <= cache.length[:, None]
    s = torch.where(valid[:, None, :], s, torch.full_like(s, NEG_INF))
    pr = torch.softmax(s, dim=-1)
    key_mass = pr.sum(dim=1)  # [B, T]: the density term for the synapse
    out_lat = torch.einsum("bht,btr->bhr", pr.to(cache.ckv.dtype), cache.ckv)
    out = torch.einsum("bhr,rhd->bhd", out_lat, split_heads(p["wuv"], h, dv))
    y = out.reshape(B, h * dv) @ p["wo"]
    masked_lane_write(cache.score, slot, torch.zeros_like(key_mass[:, 0]), ok)
    cache.score.mul_(SCORE_EMA).add_(key_mass)
    cache.length.add_(1)
    return y[:, None, :], cache, key_mass
