"""Decode-time state: plain dataclasses of tensors.

Field names and layouts are the JAX package's (``repro.models.cache``):
k/v are ``[B, T, Hkv, D]``, per-slot scalars ``[B, T]``, cursors ``[B]``.
Inside a model the caches of one layer group are stacked on a leading layer
axis, ``[L, B, ...]``. Caches are fixed-shape: growth is a write cursor,
eviction index arithmetic. Where the JAX package donated buffers, the port
writes into these tensors in place.

* FullCache    — standard KV cache with a per-lane cursor.
* SynapseCache — the paper's Topological Synapse as a streaming cache:
                 K landmark slots + W recent-window ring + J referential-
                 injection slots. O(K+W+J) per agent instead of O(L).
* MLACache     — DeepSeek-V2 latent cache (c_kv + shared rope key).
* Mamba2State  — conv tail + SSD state (O(1)).
* RWKV6State   — token-shift tails + wkv matrix state (O(1)).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from repro_torch.device import torch_dtype
from repro_torch.models.config import ModelConfig


def tensors(cache) -> list[torch.Tensor]:
    """The cache's tensors in field order."""
    return [getattr(cache, f.name) for f in dataclasses.fields(cache)]


def map_cache(fn, cache, *others):
    """New cache of the same kind with ``fn`` applied field by field
    (``fn(a, *b)`` over the matching fields of ``others``)."""
    return type(cache)(**{
        f.name: fn(getattr(cache, f.name), *(getattr(o, f.name) for o in others))
        for f in dataclasses.fields(cache)
    })


def leading(a: torch.Tensor, shape) -> torch.Tensor:
    """The view of ``a`` at offset 0 with ``shape``: where a smaller tensor
    lands when the reference's ``dynamic_update_slice`` writes it at 0."""
    return a[tuple(slice(0, n) for n in shape)] if tuple(a.shape) != tuple(shape) else a


def copy_into(dst, src):
    """In place: every tensor of ``dst`` takes the values of ``src`` (a
    shorter one fills the leading slots, as a reference update at 0 does)."""
    for a, b in zip(tensors(dst), tensors(src)):
        leading(a, b.shape).copy_(b)


@dataclass
class FullCache:
    k: torch.Tensor       # [B, S, Hkv, D]
    v: torch.Tensor       # [B, S, Hkv, D]
    pos: torch.Tensor     # [B, S] int32 — rope position of each slot
    score: torch.Tensor   # [B, S] f32 — accumulated attention mass (density EMA)
    length: torch.Tensor  # [B] int32 — write cursor / valid prefix

    @property
    def capacity(self) -> int:
        return self.k.shape[-3]


@dataclass
class SynapseCache:
    # landmark region (the "Topological Synapse")
    lm_k: torch.Tensor      # [B, K, Hkv, D]
    lm_v: torch.Tensor      # [B, K, Hkv, D]
    lm_pos: torch.Tensor    # [B, K] int32
    lm_score: torch.Tensor  # [B, K] f32 — accumulated hybrid density-coverage score
    lm_count: torch.Tensor  # [B] int32 — populated landmark slots
    # recent window ring
    win_k: torch.Tensor     # [B, W, Hkv, D]
    win_v: torch.Tensor     # [B, W, Hkv, D]
    win_pos: torch.Tensor   # [B, W] int32
    win_score: torch.Tensor # [B, W] f32 — attention mass accumulated while resident
    # referential injection slots (paper §3.6)
    inj_k: torch.Tensor     # [B, J, Hkv, D]
    inj_v: torch.Tensor     # [B, J, Hkv, D]
    inj_pos: torch.Tensor   # [B, J] int32
    inj_count: torch.Tensor # [B] int32
    win_count: torch.Tensor # [B] int32 — tokens written into the ring (fill state)
    length: torch.Tensor    # [B] int32 — total stream tokens seen

    @property
    def n_landmarks(self) -> int:
        return self.lm_k.shape[-3]

    @property
    def window(self) -> int:
        return self.win_k.shape[-3]

    @property
    def n_inject(self) -> int:
        return self.inj_k.shape[-3]


@dataclass
class MLACache:
    ckv: torch.Tensor     # [B, S, r] latent
    krope: torch.Tensor   # [B, S, d_rope] shared rope key
    score: torch.Tensor   # [B, S] f32 — accumulated attention mass (density EMA)
    length: torch.Tensor  # [B] int32

    @property
    def capacity(self) -> int:
        return self.ckv.shape[-2]


@dataclass
class Mamba2State:
    conv: torch.Tensor  # [B, conv_width-1, d_conv_ch] — conv input tail
    ssm: torch.Tensor   # [B, n_heads, d_head, d_state] f32


@dataclass
class RWKV6State:
    shift_tm: torch.Tensor  # [B, d_model] — previous token (time-mix)
    shift_cm: torch.Tensor  # [B, d_model] — previous token (channel-mix)
    wkv: torch.Tensor       # [B, H, head, head] f32 matrix state


# ---------------------------------------------------------------------------
# constructors
# ---------------------------------------------------------------------------
def _dtype(cfg: ModelConfig, dtype):
    return dtype if dtype is not None else torch_dtype(cfg.compute_dtype)


def init_full_cache(cfg: ModelConfig, batch: int, capacity: int, dtype=None, *, device, lead=()) -> FullCache:
    dtype = _dtype(cfg, dtype)
    hkv, d = cfg.n_kv_heads, cfg.d_head
    z = lambda *s, dt=dtype: torch.zeros((*lead, *s), dtype=dt, device=device)
    return FullCache(
        k=z(batch, capacity, hkv, d),
        v=z(batch, capacity, hkv, d),
        pos=z(batch, capacity, dt=torch.int32),
        score=z(batch, capacity, dt=torch.float32),
        length=z(batch, dt=torch.int32),
    )


def init_synapse_cache(
    cfg: ModelConfig,
    batch: int,
    n_landmarks: int,
    window: int,
    n_inject: int = 0,
    dtype=None,
    *,
    device,
    lead=(),
) -> SynapseCache:
    dtype = _dtype(cfg, dtype)
    hkv, d = cfg.n_kv_heads, cfg.d_head
    j = max(n_inject, 1)
    z = lambda *s, dt=dtype: torch.zeros((*lead, *s), dtype=dt, device=device)
    zi = lambda *s: z(*s, dt=torch.int32)
    return SynapseCache(
        lm_k=z(batch, n_landmarks, hkv, d),
        lm_v=z(batch, n_landmarks, hkv, d),
        lm_pos=zi(batch, n_landmarks),
        lm_score=torch.full((*lead, batch, n_landmarks), float("-inf"), dtype=torch.float32, device=device),
        lm_count=zi(batch),
        win_k=z(batch, window, hkv, d),
        win_v=z(batch, window, hkv, d),
        win_pos=zi(batch, window),
        win_score=z(batch, window, dt=torch.float32),
        inj_k=z(batch, j, hkv, d),
        inj_v=z(batch, j, hkv, d),
        inj_pos=zi(batch, j),
        inj_count=zi(batch),
        win_count=zi(batch),
        length=zi(batch),
    )


def init_mla_cache(cfg: ModelConfig, batch: int, capacity: int, dtype=None, *, device, lead=()) -> MLACache:
    dtype = _dtype(cfg, dtype)
    z = lambda *s, dt=dtype: torch.zeros((*lead, *s), dtype=dt, device=device)
    return MLACache(
        ckv=z(batch, capacity, cfg.kv_lora_rank),
        krope=z(batch, capacity, cfg.qk_rope_head_dim),
        score=z(batch, capacity, dt=torch.float32),
        length=z(batch, dt=torch.int32),
    )


def init_mamba2_state(cfg: ModelConfig, batch: int, dtype=None, *, device, lead=()) -> Mamba2State:
    dtype = _dtype(cfg, dtype)
    d_conv_ch = cfg.ssm_d_inner + 2 * cfg.ssm_state_size
    return Mamba2State(
        conv=torch.zeros((*lead, batch, cfg.ssm_conv_width - 1, d_conv_ch), dtype=dtype, device=device),
        ssm=torch.zeros((*lead, batch, cfg.ssm_n_heads, cfg.ssm_head_dim, cfg.ssm_state_size),
                        dtype=torch.float32, device=device),
    )


def init_rwkv6_state(cfg: ModelConfig, batch: int, dtype=None, *, device, lead=()) -> RWKV6State:
    dtype = _dtype(cfg, dtype)
    h, hs = cfg.rwkv_n_heads, cfg.rwkv_head_size
    return RWKV6State(
        shift_tm=torch.zeros((*lead, batch, cfg.d_model), dtype=dtype, device=device),
        shift_cm=torch.zeros((*lead, batch, cfg.d_model), dtype=dtype, device=device),
        wkv=torch.zeros((*lead, batch, h, hs, hs), dtype=torch.float32, device=device),
    )


def cache_bytes(cache) -> int:
    """Exact live bytes of a cache (the paper's 'VRAM per agent')."""
    return sum(t.numel() * t.element_size() for t in tensors(cache))
