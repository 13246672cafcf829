"""Plain PyTorch versions of the port's CUDA kernels (the allclose targets).

The CPU path of each kernel wrapper runs these, and ``chip_smoke.py`` and
the card-only tests hold the kernels against them on the card. They follow
the JAX package's ``repro.kernels.ref`` oracles, as does
:func:`mamba2_chunk_ref`, the token-by-token oracle of Mamba2's chunked
SSD (plain PyTorch in the model too: the reference has no kernel for it).
"""
from __future__ import annotations

import numpy as np
import torch

NEG_INF = -1e30


def synapse_attention_ref(q, keys, values, valid, scale: float | None = None):
    """q: [B,H,D]; keys/values: [B,T,Hkv,D]; valid: [B,T] bool.

    Returns (out [B,H,D] in q's dtype, mass [B,T] f32): f32 scores times
    ``scale``, invalid keys at the finite NEG_INF (an all-invalid row gives
    uniform weights, not NaN), softmax over T, p·V, and the per-key mass
    summed over all H heads.
    """
    B, H, D = q.shape
    Hkv = keys.shape[2]
    G = H // Hkv
    qg = q.reshape(B, Hkv, G, D).float()
    k = keys.float()
    v = values.float()
    scale = 1.0 / np.sqrt(D) if scale is None else scale
    s = torch.einsum("bkgd,btkd->bkgt", qg, k) * scale
    s = torch.where(valid[:, None, None, :], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgt,btkd->bkgd", p, v)
    mass = p.sum(dim=(1, 2))
    return out.reshape(B, H, D).to(q.dtype), mass


def landmark_score_ref(q, keys, landmarks=None, scale: float | None = None):
    """q: [B,H,D]; keys: [B,T,Hkv,D]; landmarks: [B,Kc,D] pooled centroids,
    or None for the density-only sweep.

    Returns (logits [B,H,T] f32 — pre-softmax density logits, head h reading
    kv head h // G; dist [B,T] f32 — min_j ||mean_kv(k_t) - lm_j|| / sqrt(D),
    or None without landmarks).
    """
    B, H, D = q.shape
    Hkv = keys.shape[2]
    G = H // Hkv
    qg = q.reshape(B, Hkv, G, D).float()
    k = keys.float()
    scale = 1.0 / np.sqrt(D) if scale is None else scale
    logits = (torch.einsum("bkgd,btkd->bkgt", qg, k) * scale).reshape(B, H, -1)
    if landmarks is None:
        return logits, None
    pooled = k.mean(dim=2)  # [B,T,D]
    diff = pooled[:, :, None, :] - landmarks.float()[:, None, :, :]
    d2 = (diff * diff).sum(dim=-1)  # [B,T,Kc]
    dist = torch.sqrt(d2.min(dim=-1).values / D)
    return logits, dist


def mamba2_chunk_ref(x, a_log_decay, b, c, *, chunk: int):
    """Reference chunked-SSD core: the recurrence token by token.

    x: [B,S,nh,dh] (dt-scaled inputs), a_log_decay: [B,S,nh] (log a_t, <=0),
    b, c: [B,S,ds]. Returns y [B,S,nh,dh] f32 (no D-skip or gating: the core
    only). ``chunk`` is unused, as in the reference oracle: the recurrence
    is the same for every chunking.
    """
    B, S, nh, dh = x.shape
    ds = b.shape[-1]
    state = torch.zeros((B, nh, dh, ds), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(S):
        a = torch.exp(a_log_decay[:, t].float())  # [B,nh]
        state = state * a[:, :, None, None] + torch.einsum("bhd,bs->bhds", x[:, t].float(), b[:, t].float())
        ys.append(torch.einsum("bhds,bs->bhd", state, c[:, t].float()))
    return torch.stack(ys, dim=1)
