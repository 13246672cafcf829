"""GQA attention: prefill (blocked) and decode over a full cache.

Port of the JAX package's ``repro.models.attention`` for the dense GQA path
(rope, optional qkv bias and qk norm). Decode returns the per-key attention
mass summed over heads — the paper's density term (§3.3) — so the synapse
policy can accumulate scores without a second pass. The river's attend is
plain PyTorch, as it is plain jnp in the reference.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models import cache as cache_lib
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import apply_rope, rms_norm

NEG_INF = -1e30
SCORE_EMA = 0.99  # decay of the per-slot attention-mass accumulator


def check_supported(cfg: ModelConfig):
    """The port's first slice covers the dense GQA attention group only."""
    if cfg.attn_kind != "gqa":
        raise NotImplementedError(
            f"attn_kind={cfg.attn_kind!r}: MLA is ROADMAP queue-1 item 13 (other model families)")
    if cfg.rope_kind not in ("rope", "none"):
        raise NotImplementedError(
            f"rope_kind={cfg.rope_kind!r}: mrope is ROADMAP queue-1 item 13 (other model families)")
    if cfg.shared_attn_every:
        raise NotImplementedError("shared attention (zamba2) is ROADMAP queue-1 item 13")
    for grp in cfg.layer_groups():
        if grp.kind != "attn" or grp.mlp != "dense":
            raise NotImplementedError(
                f"layer group {grp.kind}/{grp.mlp}: only dense attention groups are ported; "
                "the others are ROADMAP queue-1 item 13 (other model families)")


def _project_qkv(p, cfg: ModelConfig, x):
    """x: [B, S, dm] -> q [B,S,H,D], k/v [B,S,Hkv,D]."""
    B, S, _ = x.shape
    h, hkv, d = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(B, S, h, d)
    k = k.reshape(B, S, hkv, d)
    v = v.reshape(B, S, hkv, d)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    return q, k, v


def _rotate(cfg: ModelConfig, x, positions):
    if cfg.rope_kind == "none":
        return x
    return apply_rope(x, positions, cfg.rope_theta)


# ---------------------------------------------------------------------------
# blocked full-sequence attention (prefill)
# ---------------------------------------------------------------------------
def blocked_attention(q, k, v, *, causal: bool, chunk: int = 1024):
    """[B,S,H,D] x [B,T,Hkv,D] -> [B,S,H,D], chunked over queries so peak
    memory is O(chunk * T)."""
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


def attention_forward(params, cfg: ModelConfig, x, positions, *, chunk: int = 1024):
    """Full-sequence forward. Returns (y, (k_rot, v)) for cache fill."""
    q, k, v = _project_qkv(params, cfg, x)
    q = _rotate(cfg, q, positions)
    k = _rotate(cfg, k, positions)
    out = blocked_attention(q, k, v, causal=cfg.causal, chunk=chunk)
    B, S = x.shape[:2]
    y = out.reshape(B, S, -1) @ params["wo"]
    return y, (k, v)


# ---------------------------------------------------------------------------
# decode: single-step attend over a key/value set
# ---------------------------------------------------------------------------
def decode_attend(q, keys, values, valid):
    """q: [B,H,D]; keys/values: [B,T,Hkv,D]; valid: [B,T] bool.

    Returns (out [B,H,D], key_mass [B,T] f32): key_mass is the attention
    probability summed over all query heads. p is cast to the value dtype
    before the p·V product, as in the reference.
    """
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
    their row. ``slot`` must be in bounds; no device value is read."""
    lane = torch.arange(buf.shape[0], device=buf.device)
    cur = buf[lane, slot]
    m = ok.reshape(ok.shape + (1,) * (cur.dim() - 1))
    buf[lane, slot] = torch.where(m, val.to(buf.dtype), cur)


def attention_decode_full(params, cfg: ModelConfig, x, cache: cache_lib.FullCache, positions):
    """One-token decode against a FullCache, updating the cache IN PLACE.

    x: [B, 1, dm]; positions: [B] (rope index of the new token).
    Returns (y [B,1,dm], cache, key_mass [B,S]).

    The reference's scatter at ``length`` is dropped by JAX when the cursor
    is past capacity (idle lanes keep counting). A CUDA scatter past the end
    is a device assert, so the write is masked there; ``length`` keeps
    growing as in the reference.
    """
    B = x.shape[0]
    q, k, v = _project_qkv(params, cfg, x)
    q = _rotate(cfg, q, positions[..., None])
    k = _rotate(cfg, k, positions[..., None])
    q1, k1, v1 = q[:, 0], k[:, 0], v[:, 0]
    cap = cache.capacity
    ok = cache.length < cap
    slot = cache.length.clamp(max=cap - 1).long()
    masked_lane_write(cache.k, slot, k1, ok)
    masked_lane_write(cache.v, slot, v1, ok)
    masked_lane_write(cache.pos, slot, positions, ok)
    slots = torch.arange(cap, device=x.device)
    valid = slots[None, :] <= cache.length[:, None]  # includes the token just written
    out, key_mass = decode_attend(q1, cache.k, cache.v, valid)
    y = out.reshape(B, -1) @ params["wo"]
    masked_lane_write(cache.score, slot, torch.zeros_like(key_mass[:, 0]), ok)
    cache.score.mul_(SCORE_EMA).add_(key_mass)
    cache.length.add_(1)
    return y[:, None, :], cache, key_mass
