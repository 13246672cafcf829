"""GQA attention: prefill (blocked) and decode over a full cache.

Port of the JAX package's ``repro.models.attention``: grouped-query
attention (MHA when n_kv_heads == n_heads), qk norm, qkv bias, RoPE,
M-RoPE (qwen2-vl) or none (hubert), causal or bidirectional masks, and the
zamba2 shared block's stacked per-invocation LoRA on qkv. Decode returns
the per-key attention mass summed over heads — the paper's density term
(§3.3) — so the synapse policy can accumulate scores without a second
pass. The river's attend is plain PyTorch, as it is plain jnp in the
reference.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
from torch.distributed.tensor import DTensor

from repro_torch.models import cache as cache_lib
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (apply_mrope, apply_rope, dense_init, lane_head_placements, merge_heads, per_shard,
                                      rms_norm, split_heads, split_mesh)

NEG_INF = -1e30
SCORE_EMA = 0.99  # decay of the per-slot attention-mass accumulator


def attn_init(gen, cfg: ModelConfig, dtype, device, *, lead=(), n_lora: int = 0):
    """``n_lora`` > 0 adds stacked per-invocation LoRA adapters on the
    fused qkv projection (lora_b starts at zero, as in the reference)."""
    h, hkv, d, dm = cfg.n_heads, cfg.n_kv_heads, cfg.d_head, cfg.d_model
    p = {
        "wq": dense_init(gen, dm, h * d, dtype, device, lead=lead),
        "wk": dense_init(gen, dm, hkv * d, dtype, device, lead=lead),
        "wv": dense_init(gen, dm, hkv * d, dtype, device, lead=lead),
        "wo": dense_init(gen, h * d, dm, dtype, device, lead=lead),
    }
    z = lambda *s: torch.zeros((*lead, *s), dtype=dtype, device=device)
    if cfg.qkv_bias:
        p["bq"], p["bk"], p["bv"] = z(h * d), z(hkv * d), z(hkv * d)
    if cfg.qk_norm:
        p["q_norm"], p["k_norm"] = z(d) + 1, z(d) + 1
    if n_lora > 0:
        r = cfg.shared_attn_lora_rank
        p["lora_a"] = dense_init(gen, dm, r, dtype, device, lead=(*lead, n_lora))
        p["lora_b"] = z(n_lora, r, (h + 2 * hkv) * d)
    return p


def _project_qkv(p, cfg: ModelConfig, x, lora_idx=None):
    """x: [B, S, dm] -> q [B,S,H,D], k/v [B,S,Hkv,D]. ``lora_idx`` picks
    the shared block's per-invocation adapter (a Python int)."""
    B, S, _ = x.shape
    h, hkv, d = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    if lora_idx is not None and "lora_a" in p:
        delta = (x @ p["lora_a"][lora_idx]) @ p["lora_b"][lora_idx]  # [B, S, (h+2hkv)*d]
        q, k, v = q + delta[..., :h * d], k + delta[..., h * d:(h + hkv) * d], v + delta[..., (h + hkv) * d:]
    q, k, v = (split_heads(t, n, d, groups=hkv) for t, n in ((q, h), (k, hkv), (v, hkv)))
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    return q, k, v


def _rotate(cfg: ModelConfig, x, positions):
    if cfg.rope_kind == "none":
        return x
    if cfg.rope_kind == "mrope":
        return apply_mrope(x, positions, cfg.rope_theta, cfg.mrope_sections)
    return apply_rope(x, positions, cfg.rope_theta)


def rotate_one(cfg: ModelConfig, q, k, positions):
    """Rotate one decode token's q [B,1,H,D] and k [B,1,Hkv,D] by
    ``positions`` ([B], or [B,3] for M-RoPE); returns (q, k, the scalar
    position [B] each cache slot records)."""
    q = _rotate(cfg, q, positions[..., None])
    k = _rotate(cfg, k, positions[..., None])
    return q, k, positions[:, 0] if cfg.rope_kind == "mrope" else positions


# ---------------------------------------------------------------------------
# blocked full-sequence attention (prefill)
# ---------------------------------------------------------------------------
def blocked_attention(q, k, v, *, causal: bool, chunk: int = 1024):
    """[B,S,H,D] x [B,T,Hkv,D] -> [B,S,H,D], chunked over queries so peak
    memory is O(chunk * T). On a mesh, on each rank's blocks of lanes and
    heads (:func:`~repro_torch.models.layers.lane_head_placements`)."""
    fn = functools.partial(_blocked_attention, causal=causal, chunk=chunk)
    if split_mesh(q) is None:
        return fn(q, k, v)
    mesh, (pl,) = lane_head_placements(q, k.shape[2], (2,))
    return per_shard(fn, mesh, (pl,), (pl, pl, pl), q, k, v)


def _blocked_attention(q, k, v, *, causal: bool, chunk: int):
    B, S, H, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    qg = q.reshape(B, S, Hkv, G, D)
    scale = 1.0 / np.sqrt(D)
    kpos = torch.arange(T, device=q.device)
    outs = []
    for c0 in range(0, S, chunk):
        qc = qg[:, c0:c0 + chunk]
        s = torch.einsum("bqkgd,btkd->bkgqt", qc, k).float() * scale
        if causal:
            qpos = c0 + torch.arange(qc.shape[1], device=q.device)
            m = kpos[None, :] <= qpos[:, None]  # [chunk, T]
            s = torch.where(m[None, None, None], s, torch.full_like(s, NEG_INF))
        p = torch.softmax(s, dim=-1).to(v.dtype)
        outs.append(torch.einsum("bkgqt,btkd->bqkgd", p, v))
    return torch.cat(outs, dim=1).reshape(B, S, H, D)


def attention_forward(params, cfg: ModelConfig, x, positions, *, lora_idx=None, chunk: int = 1024):
    """Full-sequence forward. Returns (y, (k_rot, v)) for cache fill."""
    q, k, v = _project_qkv(params, cfg, x, lora_idx)
    q = _rotate(cfg, q, positions)
    k = _rotate(cfg, k, positions)
    out = blocked_attention(q, k, v, causal=cfg.causal, chunk=chunk)
    y = merge_heads(out) @ params["wo"]
    return y, (k, v)


# ---------------------------------------------------------------------------
# decode: single-step attend over a key/value set
# ---------------------------------------------------------------------------
def decode_attend(q, keys, values, valid):
    """q: [B,H,D]; keys/values: [B,T,Hkv,D]; valid: [B,T] bool.

    Returns (out [B,H,D], key_mass [B,T] f32): key_mass is the attention
    probability summed over all query heads. p is cast to the value dtype
    before the p·V product, as in the reference. On a mesh, on each rank's
    blocks of lanes and heads (:func:`~repro_torch.models.layers.lane_head_placements`; the key mass then
    a partial sum over ``model``).
    """
    if split_mesh(q) is None:
        return _decode_attend(q, keys, values, valid)
    mesh, (pq, pk, pv, pm) = lane_head_placements(q, keys.shape[2], (1, 2, None, None), partial=(3,))
    return per_shard(_decode_attend, mesh, (pq, pm), (pq, pk, pk, pv), q, keys, values, valid)


def _decode_attend(q, keys, values, valid):
    B, H, D = q.shape
    Hkv = keys.shape[2]
    G = H // Hkv
    qg = q.reshape(B, Hkv, G, D)
    s = torch.einsum("bkgd,btkd->bkgt", qg, keys).float() / np.sqrt(D)
    s = torch.where(valid[:, None, None, :], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgt,btkd->bkgd", p.to(values.dtype), values)
    key_mass = p.sum(dim=(1, 2))  # [B, T]
    return out.reshape(B, H, D), key_mass


def masked_lane_write(buf, slot, val, ok):
    """In place: buf[b, slot[b]] <- val[b] where ok[b]; other lanes keep
    their row. ``slot`` must be in bounds; no device value is read.

    On a mesh (a DTensor cache) the same write is a one-hot select over
    the slots: elementwise, so every rank writes its own shard, where the
    scatter's placement rule could not keep the cache's placement."""
    if isinstance(buf, DTensor):
        hit = (slot[:, None] == torch.arange(buf.shape[1], device=buf.device)[None, :]) & ok[:, None]
        hit = hit.reshape(hit.shape + (1,) * (buf.dim() - 2))
        buf.copy_(torch.where(hit, val.to(buf.dtype)[:, None], buf))
        return
    lane = torch.arange(buf.shape[0], device=buf.device)
    cur = buf[lane, slot]
    m = ok.reshape(ok.shape + (1,) * (cur.dim() - 1))
    buf[lane, slot] = torch.where(m, val.to(buf.dtype), cur)


def attention_decode_full(params, cfg: ModelConfig, x, cache: cache_lib.FullCache, positions):
    """One-token decode against a FullCache, updating the cache IN PLACE.

    x: [B, 1, dm]; positions: [B] (rope index of the new token) or [B,3]
    (M-RoPE). Returns (y [B,1,dm], cache, key_mass [B,S]). The shared
    block's decode takes no LoRA, as in the reference.

    The reference's scatter at ``length`` is dropped by JAX when the cursor
    is past capacity (idle lanes keep counting). A CUDA scatter past the end
    is a device assert, so the write is masked there; ``length`` keeps
    growing as in the reference.
    """
    B = x.shape[0]
    q, k, v = _project_qkv(params, cfg, x)
    q, k, pos_scalar = rotate_one(cfg, q, k, positions)
    q1, k1, v1 = q[:, 0], k[:, 0], v[:, 0]
    cap = cache.capacity
    ok = cache.length < cap
    slot = cache.length.clamp(max=cap - 1).long()
    masked_lane_write(cache.k, slot, k1, ok)
    masked_lane_write(cache.v, slot, v1, ok)
    masked_lane_write(cache.pos, slot, pos_scalar, ok)
    slots = torch.arange(cap, device=x.device)
    valid = slots[None, :] <= cache.length[:, None]  # includes the token just written
    out, key_mass = decode_attend(q1, cache.k, cache.v, valid)
    y = merge_heads(out) @ params["wo"]
    masked_lane_write(cache.score, slot, torch.zeros_like(key_mass[:, 0]), ok)
    cache.score.mul_(SCORE_EMA).add_(key_mass)
    cache.length.add_(1)
    return y[:, None, :], cache, key_mass
