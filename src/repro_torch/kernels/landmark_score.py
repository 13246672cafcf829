"""Hybrid landmark scoring sweep (paper §3.3): the CUDA kernel
``csrc/landmark_score.cu`` and its wrapper.

One pass over a KV cache gives the per-head density logits and, when a
landmark set is given, each key's coverage distance to it. A CPU tensor
takes the plain version (:func:`repro_torch.kernels.ref.landmark_score_ref`);
a CUDA tensor launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from repro_torch.kernels.build import CudaKernel, align16
from repro_torch.kernels.ref import landmark_score_ref

MAX_SMEM = 232_448  # bytes of shared memory a block may use on sm_90
THREADS = 256
BLOCK_T = 64        # keys per block, halved by the plan until the tile fits
BAR_BYTES = 80      # the kernel's mbarriers: q and landmarks, then one per 32 keys
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
KERNEL = CudaKernel(
    "landmark_score", "landmark_score_launch",
    [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _F, _F, _I, _P],
)


def rows_per_pass(G: int) -> int:
    """Query rows a thread takes per pass over its key row (the kernel's
    NR, one of its instantiations 1, 2, 4, 7, 8): no more than a group of
    G needs, 8 at a time beyond 7."""
    return G if G <= 2 else 4 if G <= 4 else 7 if G <= 7 else 8


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    """Geometry of one launch: blocks of ``threads`` threads (one per key,
    kv head and ``rows`` query rows, at most ``THREADS``) on a grid of (key
    tiles, B), each tile ``block_t`` keys brought in by bulk copies of 32
    keys, and ``smem`` bytes of dynamic shared memory per block."""

    block_t: int
    grid: tuple[int, int]
    smem: int
    ranges: tuple[tuple[int, int], ...]  # (start, stop) keys of each block along x
    rows: int
    threads: int


@functools.lru_cache(maxsize=256)
def launch_plan(B: int, T: int, H: int, Hkv: int, D: int, Kc: int, elem_bytes: int) -> LaunchPlan:
    """The launch geometry for q [B,H,D], keys [B,T,Hkv,D] and ``Kc``
    landmarks (0 for the density-only sweep) of ``elem_bytes`` per value.

    Raises ValueError naming the reason where the kernel cannot take the
    shape: a kv head's key row whose bytes are not a multiple of 16 (the
    bulk copy and the 16-byte loads need it), or queries and landmarks that
    leave no room for a tile in shared memory.
    """
    if T < 1 or B < 1:
        raise ValueError(f"landmark_score: empty input (B={B}, T={T})")
    if (D * elem_bytes) % 16:
        raise ValueError(f"landmark_score: a key row of one kv head is D x {elem_bytes} = {D * elem_bytes} "
                         f"bytes, not a multiple of 16 (the bulk copy and 16-byte loads need it)")
    row = Hkv * D * elem_bytes
    # mbarriers, q and landmarks as copied and in f32, the landmarks' norms
    fixed = BAR_BYTES + (H + Kc) * D * (elem_bytes + 4) + align16(Kc * 4)
    block_t = BLOCK_T
    while block_t > 1 and fixed + block_t * row > MAX_SMEM:
        block_t //= 2
    smem = fixed + block_t * row
    if smem > MAX_SMEM:
        raise ValueError(f"landmark_score: {smem} bytes of queries, landmarks and one key row exceed the "
                         f"{MAX_SMEM}-byte shared-memory limit")
    n = -(-T // block_t)
    rows = rows_per_pass(H // Hkv)
    units = block_t * Hkv * -(-(H // Hkv) // rows)
    return LaunchPlan(block_t=block_t, grid=(n, B), smem=smem,
                      ranges=tuple((i * block_t, min(T, (i + 1) * block_t)) for i in range(n)),
                      rows=rows, threads=min(THREADS, -(-units // 32) * 32))


def _check(q, keys, landmarks):
    ins = [("q", q), ("keys", keys)] + ([("landmarks", landmarks)] if landmarks is not None else [])
    for name, t in ins:
        if not t.is_cuda or t.device != q.device:
            raise ValueError(f"landmark_score: {name} must lie on q's CUDA device")
        if t.dtype != q.dtype:
            raise TypeError(f"landmark_score: {name} is {t.dtype}, q is {q.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"landmark_score: {name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"landmark_score: {name} must start at a 16-byte aligned address")
    if q.dtype not in _DTYPES:
        raise TypeError(f"landmark_score: dtype {q.dtype} not in {list(_DTYPES)}")
    B, H, D = q.shape
    if keys.dim() != 4 or keys.shape[0] != B or keys.shape[3] != D:
        raise ValueError(f"landmark_score: keys {tuple(keys.shape)} do not match q {tuple(q.shape)}")
    Hkv = keys.shape[2]
    if H % Hkv:
        raise ValueError(f"landmark_score: H={H} must be a multiple of Hkv={Hkv}")
    if landmarks is not None:
        if landmarks.dim() != 3 or landmarks.shape[0] != B or landmarks.shape[2] != D or landmarks.shape[1] < 1:
            raise ValueError(f"landmark_score: landmarks {tuple(landmarks.shape)} != [B, Kc >= 1, {D}]")


def landmark_score(q, keys, landmarks=None, *, scale: float | None = None):
    """q: [B,H,D]; keys: [B,T,Hkv,D]; landmarks: [B,Kc,D] or None.

    Returns (logits [B,H,T] f32, min_dist [B,T] f32 or None); distances
    are normalised by sqrt(D).
    """
    B, H, D = q.shape
    scale = 1.0 / (D ** 0.5) if scale is None else scale
    if q.device.type == "cpu":
        return landmark_score_ref(q, keys, landmarks, scale=scale)
    if q.device.type == "meta":  # the dry run: shapes and FLOP counts, no launch
        return landmark_score_ref(q, keys, landmarks, scale=scale)
    _check(q, keys, landmarks)
    T, Hkv = keys.shape[1], keys.shape[2]
    kc = 0 if landmarks is None else landmarks.shape[1]
    plan = launch_plan(B, T, H, Hkv, D, kc, q.element_size())
    logits = torch.empty((B, H, T), dtype=torch.float32, device=q.device)
    dist = None if landmarks is None else torch.empty((B, T), dtype=torch.float32, device=q.device)
    KERNEL.launch(
        q.data_ptr(), keys.data_ptr(),
        None if landmarks is None else landmarks.data_ptr(),
        logits.data_ptr(), None if dist is None else dist.data_ptr(),
        B, T, Hkv, H // Hkv, D, kc, plan.block_t, plan.rows, plan.threads, plan.smem,
        float(scale), float(D), _DTYPES[q.dtype],
    )
    return logits, dist
