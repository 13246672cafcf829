"""The benchmark's arithmetic, frozen here so that a change to the program
cannot move the yardstick: the H100's peaks, a kernel call's least time
(``chip_smoke.bound``), the bytes and operations of the two kernels' calls,
a decode token's operations from a configuration's shapes, nearest-rank
percentiles (``serving.frontend.percentile``) and the union of intervals.
"""
from __future__ import annotations

import math

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


def matmul_params_per_token(m: dict) -> int:
    """Weights a decode token multiplies (the LM head included) for the
    ``model`` block of a dense decoder's configuration file."""
    if m.get("arch_type", "dense") != "dense" or m.get("n_experts", 0) or m.get("shared_attn_every", 0):
        raise ValueError(f"no count of a decode token's weights for {m.get('name', m.get('arch_type'))}")
    d, H, Hkv, D = m["d_model"], m["n_heads"], m["n_kv_heads"], m["d_head"]
    attn = d * H * D * 2 + 2 * d * Hkv * D
    return m["n_layers"] * (attn + 3 * d * m["d_ff"]) + d * m["vocab_size"]


def decode_flops(m: dict, tokens: int, keys_read: int) -> float:
    """Operations of ``tokens`` decode tokens that together read
    ``keys_read`` keys in each layer: 2 per multiplied weight, 4 * H * D
    per key read (QK and PV)."""
    return 2.0 * matmul_params_per_token(m) * tokens + 4.0 * m["n_heads"] * m["d_head"] * keys_read * m["n_layers"]


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
