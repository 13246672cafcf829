"""Primitive layers: norms, rotary embeddings, the SwiGLU MLP, init helpers.

Plain functions on tensors over a parameter dict, as in the JAX package's
``repro.models.layers``. Weights are ``[d_in, d_out]`` and used as
``x @ W``. Initialisers take an explicit ``torch.Generator``.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


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
