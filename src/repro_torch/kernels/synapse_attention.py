"""Single-token decode attention over a synapse token set: the CUDA kernel
``csrc/synapse_attention.cu`` and its wrapper.

The per-tick hot loop of every side agent: one query per head against the
concatenated [landmarks; window; inject] key set, returning the attention
output and the per-key attention mass summed over heads (the paper's
density statistic). A CPU tensor takes the plain version
(:func:`repro_torch.kernels.ref.synapse_attention_ref`); a CUDA tensor
launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from repro_torch.kernels.build import CudaKernel, align16
from repro_torch.kernels.ref import synapse_attention_ref

MAX_SMEM = 232_448   # bytes of shared memory a block may use on sm_90
THREADS = 256
MAX_CLUSTER = 8      # the portable cluster size
KEYS_PER_CTA = 32    # C = min(MAX_CLUSTER, ceil(T / KEYS_PER_CTA))
MAX_SLICES = 8       # key slices of p.V, summed in order at the end
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_P, _I = ctypes.c_void_p, ctypes.c_int
KERNEL = CudaKernel(
    "synapse_attention", "synapse_attention_launch",
    [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, ctypes.c_float, _I, _P],
)


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    """Geometry of one launch: a grid of (cluster, B) CTAs of ``THREADS``
    threads, clusters of ``cluster`` CTAs, one per lane. CTA r owns the
    keys ``ranges[r]``; its K and V pass through a two-stage ring of
    ``chunk_keys`` keys, ``n_chunks`` chunks a pass (1 when the range fits
    whole); p.V splits the keys into ``slices``; ``smem`` bytes of dynamic
    shared memory per CTA. With ``spill`` the range's H x n_max f32 scores
    do not fit in shared memory and live in a [B, cluster, H, n_max] f32
    workspace in device memory instead."""

    cluster: int
    ranges: tuple[tuple[int, int], ...]
    n_max: int
    chunk_keys: int
    n_chunks: int
    slices: int
    smem: int
    grid: tuple[int, int]
    spill: bool = False
    threads: int = THREADS


@functools.lru_cache(maxsize=256)
def launch_plan(B: int, T: int, H: int, Hkv: int, D: int, elem_bytes: int) -> LaunchPlan:
    """The launch geometry for q [B,H,D] and keys/values [B,T,Hkv,D] of
    ``elem_bytes`` per value; the kernel carves its shared memory by the
    same sums (``smem_bytes`` in the source) and refuses a plan that
    disagrees.

    A range whose scores (H x n_max f32) do not fit in shared memory beside
    the queries spills them to device memory (``spill``); every plan whose
    scores fit is the same as without that branch.

    Raises ValueError naming the reason where the kernel cannot take the
    shape: a kv head's key row whose bytes are not a multiple of 16 (the
    bulk copy and the 16-byte loads need it), or queries and p.V sums that
    alone leave no room for one key of K/V in shared memory.
    """
    if T < 1 or B < 1:
        raise ValueError(f"synapse_attention: empty input (B={B}, T={T})")
    if (D * elem_bytes) % 16:
        raise ValueError(f"synapse_attention: a key row of one kv head is D x {elem_bytes} = {D * elem_bytes} "
                         f"bytes, not a multiple of 16 (the bulk copy and 16-byte loads need it)")
    C = min(MAX_CLUSTER, -(-T // KEYS_PER_CTA))
    ranges = tuple((r * T // C, (r + 1) * T // C) for r in range(C))
    n_max = max(b - a for a, b in ranges)
    row = Hkv * D * elem_bytes
    chunks_per_row = D * elem_bytes // 16
    # mbarriers, q as copied and in f32, (m_r, l_r) with the peers' and the
    # combine weights, the peers' partial outputs, valid flags; and the
    # scores, unless they spill
    fixed = (32 + H * D * (elem_bytes + 4) + align16((2 + 3 * C) * H * 4)
             + align16(C * -(-H * D // C) * 4) + align16(n_max))
    # p.V key slices: as many as keep all threads busy; fewer where that
    # lets the whole range sit in the ring, or else leaves chunks of at
    # least a warp's worth of keys
    cands = [min(MAX_SLICES, max(1, THREADS // (Hkv * chunks_per_row)))]
    while cands[-1] > 1:
        cands.append(cands[-1] // 2)

    def geometry(fixed):
        room = lambda s: (MAX_SMEM - fixed - s * H * D * 4) // (2 * row)
        slices = next((s for s in cands if room(s) >= n_max), None) or \
            next((s for s in cands if room(s) >= KEYS_PER_CTA), 1)
        base = fixed + slices * H * D * 4
        return slices, base, min(n_max, (MAX_SMEM - base) // (2 * row)) if base < MAX_SMEM else 0

    spill = False
    slices, base, chunk_keys = geometry(fixed + align16(H * n_max * 4))
    if chunk_keys < 1:
        spill = True
        slices, base, chunk_keys = geometry(fixed)
    if chunk_keys < 1:
        raise ValueError(f"synapse_attention: the queries and p.V sums of H={H} heads of D={D} ({base} bytes) "
                         f"leave no room for one key of K/V in the {MAX_SMEM}-byte shared-memory limit")
    return LaunchPlan(
        cluster=C, ranges=ranges, n_max=n_max, chunk_keys=chunk_keys,
        n_chunks=-(-n_max // chunk_keys), slices=slices, smem=base + 2 * chunk_keys * row, grid=(C, B),
        spill=spill,
    )


def _check(q, keys, values, valid):
    if not (q.is_cuda and keys.device == q.device and values.device == q.device and valid.device == q.device):
        raise ValueError("synapse_attention: all inputs must lie on one CUDA device")
    if q.dtype not in _DTYPES or keys.dtype != q.dtype or values.dtype != q.dtype:
        raise TypeError(f"synapse_attention: q/keys/values must share one of {list(_DTYPES)}, got "
                        f"{q.dtype}/{keys.dtype}/{values.dtype}")
    if valid.dtype != torch.bool:
        raise TypeError(f"synapse_attention: valid must be bool, got {valid.dtype}")
    B, H, D = q.shape
    if keys.dim() != 4 or keys.shape[0] != B or keys.shape[3] != D or values.shape != keys.shape:
        raise ValueError(f"synapse_attention: keys/values {tuple(keys.shape)}/{tuple(values.shape)} "
                         f"do not match q {tuple(q.shape)}")
    T, Hkv = keys.shape[1], keys.shape[2]
    if H % Hkv:
        raise ValueError(f"synapse_attention: H={H} must be a multiple of Hkv={Hkv}")
    if valid.shape != (B, T):
        raise ValueError(f"synapse_attention: valid {tuple(valid.shape)} != {(B, T)}")
    for name, t in (("q", q), ("keys", keys), ("values", values), ("valid", valid)):
        if not t.is_contiguous():
            raise ValueError(f"synapse_attention: {name} must be contiguous")
    for name, t in (("q", q), ("keys", keys), ("values", values)):
        if t.data_ptr() % 16:
            raise ValueError(f"synapse_attention: {name} must start at a 16-byte aligned address")


def synapse_attention(q, keys, values, valid, *, scale: float | None = None):
    """q: [B,H,D]; keys/values: [B,T,Hkv,D]; valid: [B,T] bool.

    Returns (out [B,H,D] in q's dtype, mass [B,T] f32). ``scale`` defaults
    to 1/sqrt(D).
    """
    B, H, D = q.shape
    scale = 1.0 / (D ** 0.5) if scale is None else scale
    if q.device.type == "cpu":
        return synapse_attention_ref(q, keys, values, valid, scale=scale)
    if q.device.type == "meta":  # the dry run: shapes and FLOP counts, no launch
        return synapse_attention_ref(q, keys, values, valid, scale=scale)
    _check(q, keys, values, valid)
    T, Hkv = keys.shape[1], keys.shape[2]
    plan = launch_plan(B, T, H, Hkv, D, q.element_size())
    out = torch.empty_like(q)
    mass = torch.empty((B, T), dtype=torch.float32, device=q.device)
    ws = torch.empty((B, plan.cluster, H, plan.n_max), dtype=torch.float32, device=q.device) if plan.spill else None
    KERNEL.launch(
        q.data_ptr(), keys.data_ptr(), values.data_ptr(), valid.data_ptr(), out.data_ptr(), mass.data_ptr(),
        None if ws is None else ws.data_ptr(), B, T, Hkv, H // Hkv, D, plan.cluster, plan.n_max, plan.chunk_keys, plan.n_chunks, plan.slices,
        plan.smem, float(scale), _DTYPES[q.dtype],
    )
    return out, mass
