"""The benchmark's arithmetic, frozen here so that a change to the program
cannot move the yardstick: the H100's peaks, a kernel call's least time
(``chip_smoke.bound``), the bytes and operations of the two kernels' calls,
a decode token's operations from a configuration's published keys,
nearest-rank percentiles (``serving.frontend.percentile``) and the union
of intervals.
"""
from __future__ import annotations

import math
from typing import NamedTuple

# NVIDIA H100 SXM, data sheet, dense: HBM3 bytes/s and bf16 FLOP/s
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12


def bound_s(byts: float, flops: float) -> float:
    """The least time of the work: bytes over the HBM rate or operations
    over the bf16 peak, whichever is larger."""
    return max(byts / HBM_BYTES_PER_S, flops / BF16_FLOP_PER_S)


def synapse_attention_cost(q_shape, k_shape, elem: int, valid_keys: int) -> tuple[int, int]:
    """(bytes, operations) of one ``synapse_attention`` call: q [B, H, D]
    read and out [B, H, D] written once, the keys and values of the valid
    slots read once, the [B, T] mask read, the [B, T] f32 mass written;
    QK and PV over the valid keys."""
    B, H, D = q_shape
    T, Hkv = k_shape[1], k_shape[2]
    byts = 2 * B * H * D * elem + 2 * valid_keys * Hkv * D * elem + B * T + 4 * B * T
    return byts, 4 * H * D * valid_keys


def landmark_score_cost(q_shape, k_shape, elem: int, valid_keys: int) -> tuple[int, int]:
    """(bytes, operations) of one density-mode ``landmark_score`` call: q
    read once, the valid keys read once, the mask read, the [B, T] f32
    density written; QK over the valid keys."""
    B, H, D = q_shape
    T, Hkv = k_shape[1], k_shape[2]
    byts = B * H * D * elem + valid_keys * Hkv * D * elem + B * T + 4 * B * T
    return byts, 2 * H * D * valid_keys


class DecodeCount(NamedTuple):
    """A decode token's work: the weights it multiplies (the LM head
    included), the (H, D) of each layer that attends over keys, and the
    operations of its recurrent state updates and reads."""

    weights: int
    attention: tuple
    recurrent: int


def _qwen2(p: dict) -> DecodeCount:
    """Qwen2's decoder: GQA with head_dim = hidden / heads, SwiGLU."""
    d, H, Hkv = p["hidden_size"], p["num_attention_heads"], p["num_key_value_heads"]
    D = d // H
    attn = d * H * D * 2 + 2 * d * Hkv * D
    L = p["num_hidden_layers"]
    return DecodeCount(L * (attn + 3 * d * p["intermediate_size"]) + d * p["vocab_size"], ((H, D),) * L, 0)


def _zamba2(p: dict) -> DecodeCount:
    """Zamba2 (``transformers``' ``modeling_zamba2``): a Mamba2 layer at
    every depth; at each ``hybrid`` depth one of the shared blocks runs
    before it, on [stream; embeddings], with its own adapters and its
    ``linear`` after it."""
    kinds = p["layers_block_type"]
    if len(kinds) != p["num_hidden_layers"]:
        raise ValueError(f"zamba2: {len(kinds)} layer types for {p['num_hidden_layers']} layers")
    d, di = p["hidden_size"], p["mamba_expand"] * p["hidden_size"]
    gn = p["mamba_ngroups"] * p["mamba_d_state"]
    mamba = d * (2 * di + 2 * gn + p["n_mamba_heads"]) + (di + 2 * gn) * p["mamba_d_conv"] + di * d
    H, D, Hkv = p["num_attention_heads"], p["attention_head_dim"], p["num_key_value_heads"]
    a, ffn, r = p.get("attention_hidden_size") or 2 * d, p["ffn_hidden_size"], p["adapter_rank"]
    hybrid = a * (H + 2 * Hkv) * D + H * D * d + d * 2 * ffn + ffn * d + d * d
    if p["use_shared_mlp_adapter"]:
        hybrid += d * r + r * 2 * ffn
    if p["use_shared_attention_adapter"]:
        hybrid += 3 * (a * r + r * a)
    n_hybrid = sum(k == "hybrid" for k in kinds)
    recurrent = 4 * p["n_mamba_heads"] * p["mamba_headdim"] * p["mamba_d_state"]
    return DecodeCount(len(kinds) * mamba + n_hybrid * hybrid + d * p["vocab_size"], ((H, D),) * n_hybrid,
                       len(kinds) * recurrent)


COUNTS = {"qwen2": _qwen2, "zamba2": _zamba2}


def decode_count(published: dict, reduced) -> DecodeCount:
    """A decode token's work, from a configuration file's ``published``
    block (the public ``config.json``'s own keys), chosen by its
    ``model_type``. A type without a count here, or a configuration cut
    from its source (``reduced`` not empty), is refused: the published
    keys count the whole model, not the cut one."""
    kind = published.get("model_type")
    if kind not in COUNTS:
        raise ValueError(f"no count of a decode token's work for model_type {kind!r}")
    if reduced:
        raise ValueError(f"model_type {kind!r} is cut from its source ({', '.join(reduced)}): "
                         "its published keys count the whole model")
    return COUNTS[kind](published)


def decode_flops(count: DecodeCount, tokens: int, keys_read: int) -> float:
    """Operations of ``tokens`` decode tokens that together read
    ``keys_read`` keys in each attention layer: 2 per multiplied weight,
    4 * H * D per key read (QK and PV), and the recurrent updates'."""
    attn = sum(4 * H * D for H, D in count.attention) * keys_read
    return float(2 * count.weights * tokens + attn + count.recurrent * tokens)


def percentile(samples, q: float) -> float:
    """Nearest-rank percentile (rank ceil(q/100 * n), 1-based)."""
    s = sorted(samples)
    if not s:
        raise ValueError("no samples")
    return float(s[min(len(s), max(1, math.ceil(q / 100.0 * len(s)))) - 1])


def union_length(intervals) -> float:
    """Total length covered by [start, end) intervals, overlaps once."""
    total, end = 0.0, -math.inf
    for a, b in sorted(intervals):
        if b <= end:
            continue
        total += b - max(a, end)
        end = b
    return total


def idle_gaps(intervals, start: float, stop: float) -> list[tuple[float, float]]:
    """The gaps in [start, stop] that no interval covers, longest first."""
    gaps, end = [], start
    for a, b in sorted(intervals):
        if a > end:
            gaps.append((end, min(a, stop)))
        end = max(end, b)
    if end < stop:
        gaps.append((end, stop))
    return sorted((g for g in gaps if g[1] > g[0]), key=lambda g: g[0] - g[1])
