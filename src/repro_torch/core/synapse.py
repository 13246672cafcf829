"""The Topological Synapse (paper §3.3) — KV-cache landmark sparsification.

Port of the JAX package's ``repro.core.synapse``. Two modes:

1. ``compress``: one-shot hybrid density-coverage landmark selection from a
   full cache, used when a side agent spawns. The hybrid score is
       score_i = alpha * density_i + (1 - alpha) * coverage_i
   with density from the ``landmark_score`` kernel and coverage the greedy
   maxmin (farthest-point) term.
2. ``synapse_decode``: the same policy run online during decode — a recent
   window ring plus a landmark buffer with hybrid-score eviction; the attend
   is the ``synapse_attention`` kernel (``kernels.ops.synapse_attend``
   routes it on the policy). Caches are updated IN PLACE.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.core import synapse_sharded as sharded
from repro_torch.core.synapse_sharded import onehot_read, onehot_write
from repro_torch.kernels import ops
from repro_torch.models import cache as cache_lib
from repro_torch.models.attention import _project_qkv, decode_attend, rotate_one
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import replicate_dims

NEG_INF = -1e30
INT32_MAX = 2**31 - 1


@dataclass(frozen=True)
class SynapsePolicy:
    alpha: float = 0.5        # density vs coverage blend
    score_ema: float = 0.99   # per-step decay of accumulated attention mass
    coverage_cap: float = 4.0 # maxmin distances saturate here (normalized units)
    # decode attend: "kernel" = one fused ``synapse_attention`` launch over
    # the concatenated [landmarks; window; inject] set (the reference's
    # "pallas"); "piece" = ``synapse_sharded.piece_attend``, the token-sharded
    # flash-decode, whose local path is the same launch. A live shard axis
    # always takes "piece".
    attend_impl: str = "kernel"
    # axis the synapse token dims are split over (None = local); the lane
    # group keeps it None: lanes are split across ranks, each lane's tokens
    # stay on one
    shard_axis: str | None = None


# ---------------------------------------------------------------------------
# shared helpers
# ---------------------------------------------------------------------------
def _pool_heads(k):
    """[..., Hkv, D] -> [..., D] mean over kv heads (coverage geometry)."""
    return k.float().mean(dim=-2)


def _normed_dist(a, b):
    """||a-b|| / sqrt(d): a [..., T, D], b [..., D] -> [..., T]."""
    d = a.shape[-1]
    diff = a - b[..., None, :]
    return torch.sqrt((diff * diff).sum(dim=-1) / d)


def attention_density(q, keys, valid):
    """Softmax attention mass per key, summed over heads (plain PyTorch).

    q: [B, H, D]; keys: [B, T, Hkv, D]; valid: [B, T] -> [B, T] f32.
    """
    _, mass = decode_attend(q, keys, torch.zeros_like(keys), valid)
    return mass


def kernel_density(q, keys, valid):
    """attention_density through the ``landmark_score`` kernel's
    density-only sweep; the valid-masked softmax is a [B,H,T] reduction.
    With a token axis live, the plain reduction, as in the reference."""
    if sharded.get_shard_axis() is not None:
        return attention_density(q, keys, valid)
    density, _ = ops.landmark_score(q, keys, None, valid)
    return density


# ---------------------------------------------------------------------------
# one-shot compression (side-agent spawn)
# ---------------------------------------------------------------------------
def select_landmarks(keys, valid, density, k: int, policy: SynapsePolicy):
    """Greedy hybrid density-coverage selection.

    keys: [B, T, Hkv, D]; valid: [B, T]; density: [B, T].
    Returns indices [B, k], the hybrid scores [B, k] and which picks are
    real ([B, k] bool; False when fewer than k keys are valid).
    """
    B, T = density.shape
    dev = density.device
    pooled = _pool_heads(keys)  # [B, T, D]
    density = density / (density.max(dim=-1, keepdim=True).values + 1e-9)
    cap = policy.coverage_cap
    min_dist = torch.full((B, T), float("inf"), dtype=torch.float32, device=dev)
    chosen_idx = torch.zeros((B, k), dtype=torch.int32, device=dev)
    chosen_score = torch.zeros((B, k), dtype=torch.float32, device=dev)
    taken = torch.zeros((B, T), dtype=torch.bool, device=dev)
    lane = torch.arange(B, device=dev)
    neg = torch.full((B, T), NEG_INF, dtype=torch.float32, device=dev)
    for i in range(k):
        cov = torch.clamp(min_dist, max=cap) / cap
        score = policy.alpha * density + (1.0 - policy.alpha) * cov
        score = torch.where(valid & ~taken, score, neg)
        idx = torch.argmax(score, dim=-1)  # first index on ties, as jnp.argmax
        best = score[lane, idx]
        new_lm = pooled[lane, idx]  # [B, D]
        min_dist = torch.minimum(min_dist, _normed_dist(pooled, new_lm))
        taken[lane, idx] = True
        chosen_idx[:, i] = idx.to(torch.int32)
        chosen_score[:, i] = best
    picked_valid = chosen_score > NEG_INF / 2  # False when T_valid < k (short prompts)
    return chosen_idx, chosen_score, picked_valid


def compress(
    cfg: ModelConfig,
    cache: cache_lib.FullCache,
    query,  # [B, H, D] — the parent's current query (paper: Q_t), or None
            # to use the cache's accumulated attention-mass density
    n_landmarks: int,
    window: int,
    n_inject: int = 0,
    policy: SynapsePolicy = SynapsePolicy(),
) -> cache_lib.SynapseCache:
    """Full cache [B, ...] -> a new SynapseCache for a freshly spawned side
    agent."""
    B, T = cache.pos.shape
    dev = cache.k.device
    slots = torch.arange(T, device=dev)
    valid = slots[None, :] < cache.length[:, None]
    density = kernel_density(query, cache.k, valid) if query is not None else cache.score
    idx, score, picked = select_landmarks(cache.k, valid, density, n_landmarks, policy)
    # landmarks in original position order (a stable sort, as jnp.argsort);
    # invalid picks last
    pos_sel = torch.gather(cache.pos, 1, idx.long())
    pos_sel = torch.where(picked, pos_sel, torch.full_like(pos_sel, INT32_MAX))
    order = torch.argsort(pos_sel, dim=1, stable=True)
    idx = torch.gather(idx.long(), 1, order)
    score = torch.gather(score, 1, order)

    lane = torch.arange(B, device=dev)[:, None]
    syn = cache_lib.init_synapse_cache(
        cfg, B, n_landmarks, window, n_inject, dtype=cache.k.dtype, device=dev
    )
    syn.lm_k = cache.k[lane, idx]
    syn.lm_v = cache.v[lane, idx]
    syn.lm_pos = torch.gather(cache.pos, 1, idx)
    syn.lm_score = score
    syn.lm_count = torch.clamp(cache.length, max=n_landmarks)
    syn.length = cache.length.clone()
    return syn


# ---------------------------------------------------------------------------
# streaming decode over a SynapseCache
# ---------------------------------------------------------------------------
def synapse_decode(
    attn_params,
    cfg: ModelConfig,
    x,          # [B, 1, dm]
    cache: cache_lib.SynapseCache,
    positions,  # [B] (or [B,3] mrope)
    policy: SynapsePolicy = SynapsePolicy(),
):
    """One decode step: attend over [landmarks; window; inject slots], write
    the new token into the window ring, graduate/evict on overflow. The
    cache is updated IN PLACE.

    Returns (y [B,1,dm], cache, stats dict).
    """
    B = x.shape[0]
    dev = x.device
    K, W, J = cache.n_landmarks, cache.window, cache.n_inject
    q, k, v = _project_qkv(attn_params, cfg, x)
    q, k, pos_scalar = rotate_one(cfg, q, k, positions)
    q1, k1, v1 = q[:, 0], k[:, 0], v[:, 0]

    # ---- 1. graduation: the slot the new token will overwrite ----
    slot = torch.remainder(cache.win_count, W)  # [B]
    win_full = cache.win_count >= W
    grad_k = onehot_read(cache.win_k, slot)      # [B, Hkv, D]
    grad_v = onehot_read(cache.win_v, slot)
    grad_pos = onehot_read(cache.win_pos, slot)
    grad_score = onehot_read(cache.win_score, slot)

    pooled_lm = _pool_heads(cache.lm_k)                   # [B, K, D]
    grad_pooled = _pool_heads(grad_k[:, None])[:, 0]      # [B, D]
    dist = _normed_dist(pooled_lm, grad_pooled)           # [B, K]
    lm_slot_valid = torch.arange(K, device=dev)[None, :] < cache.lm_count[:, None]
    inf = torch.full_like(dist, float("inf"))
    # (amin, not min: a plain reduction, which a mesh can split; min's
    # indices cannot be)
    min_dist = torch.amin(torch.where(lm_slot_valid, dist, inf), dim=-1)
    cap = policy.coverage_cap
    cov = torch.clamp(torch.where(torch.isfinite(min_dist), min_dist, torch.full_like(min_dist, cap)), max=cap) / cap

    # rate-based comparison (see the reference): landmark EMAs vs the
    # graduating token's per-step mass, coverage scaled by the mean rate
    one_minus_ema = max(1.0 - policy.score_ema, 1e-6)
    resid = torch.clamp(cache.win_count.float(), min=1.0, max=float(W))
    grad_rate = grad_score / resid
    lm_rate = cache.lm_score * one_minus_ema                      # [B, K]
    min_lm_rate = torch.amin(torch.where(lm_slot_valid, lm_rate, inf), dim=-1)
    mean_lm_rate = torch.where(lm_slot_valid, lm_rate, torch.zeros_like(lm_rate)).sum(dim=-1) / torch.clamp(
        cache.lm_count.float(), min=1.0
    )
    hybrid_rate = policy.alpha * grad_rate + (1 - policy.alpha) * cov * torch.maximum(
        mean_lm_rate, grad_rate
    )

    # candidate landmark slot: first empty, else argmin rate (first on ties)
    evict_slot = torch.where(
        cache.lm_count < K,
        cache.lm_count.long(),
        # (on a mesh the landmark dim is gathered first: the arg-reduction's
        # rule cannot take it split)
        torch.argmin(replicate_dims(torch.where(lm_slot_valid, lm_rate, inf), -1), dim=-1),
    )
    promote = win_full & ((cache.lm_count < K) | (hybrid_rate > min_lm_rate))

    onehot_write(cache.lm_k, evict_slot, grad_k, mask=promote)
    onehot_write(cache.lm_v, evict_slot, grad_v, mask=promote)
    onehot_write(cache.lm_pos, evict_slot, grad_pos, mask=promote)
    # stored back in EMA-steady units so later comparisons stay consistent
    onehot_write(cache.lm_score, evict_slot, hybrid_rate / one_minus_ema, mask=promote)
    cache.lm_count.copy_(torch.where(promote, torch.clamp(cache.lm_count + 1, max=K), cache.lm_count))

    # ---- 2. write the new token into the ring ----
    onehot_write(cache.win_k, slot, k1)
    onehot_write(cache.win_v, slot, v1)
    onehot_write(cache.win_pos, slot, pos_scalar)
    onehot_write(cache.win_score, slot, torch.zeros((B,), dtype=torch.float32, device=dev))

    # ---- 3. attend over [landmarks; window; inject]: one kernel launch ----
    lm_valid = torch.arange(K, device=dev)[None, :] < cache.lm_count[:, None]
    win_valid = torch.arange(W, device=dev)[None, :] < torch.clamp(cache.win_count + 1, max=W)[:, None]
    inj_valid = torch.arange(J, device=dev)[None, :] < cache.inj_count[:, None]
    scale = 1.0 / (q1.shape[-1] ** 0.5)
    out, masses = ops.synapse_attend(
        q1,
        [(cache.lm_k, cache.lm_v), (cache.win_k, cache.win_v), (cache.inj_k, cache.inj_v)],
        [lm_valid, win_valid, inj_valid],
        scale=scale, policy=policy,
    )
    y = out.reshape(B, -1) @ attn_params["wo"]

    # ---- 4. accumulate attention mass (density statistic) ----
    ema = policy.score_ema
    cache.lm_score.mul_(ema).add_(masses[0])
    cache.win_score.mul_(ema).add_(masses[1])
    cache.win_count.add_(1)
    cache.length.add_(1)
    stats = {"promoted": promote, "attn_mass_landmarks": masses[0].sum(-1)}
    return y[:, None, :], cache, stats


def synapse_bytes(cfg: ModelConfig, n_landmarks: int, window: int, n_inject: int, n_layers: int | None = None) -> int:
    """Per-agent synapse footprint (the paper's ~10 MB claim)."""
    syn = cache_lib.init_synapse_cache(cfg, 1, n_landmarks, window, n_inject, device="meta")
    per_layer = cache_lib.cache_bytes(syn)
    return per_layer * (n_layers if n_layers is not None else cfg.n_layers)
