"""Hybrid landmark scoring sweep (paper §3.3): the CUDA kernel
``csrc/landmark_score.cu`` and its wrapper.

One pass over a KV cache gives the per-head density logits and, when a
landmark set is given, each key's coverage distance to it. A CPU tensor
takes the plain version (:func:`repro_torch.kernels.ref.landmark_score_ref`);
a CUDA tensor launches the kernel or raises.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import CudaKernel
from repro_torch.kernels.ref import landmark_score_ref

MAX_SMEM = 232_448
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
KERNEL = CudaKernel(
    "landmark_score", "landmark_score_launch",
    [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _F, _I, _P],
)


def _check(q, keys, landmarks):
    ins = [("q", q), ("keys", keys)] + ([("landmarks", landmarks)] if landmarks is not None else [])
    for name, t in ins:
        if not t.is_cuda or t.device != q.device:
            raise ValueError(f"landmark_score: {name} must lie on q's CUDA device")
        if t.dtype != q.dtype:
            raise TypeError(f"landmark_score: {name} is {t.dtype}, q is {q.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"landmark_score: {name} must be contiguous")
    if q.dtype not in _DTYPES:
        raise TypeError(f"landmark_score: dtype {q.dtype} not in {list(_DTYPES)}")
    B, H, D = q.shape
    if keys.dim() != 4 or keys.shape[0] != B or keys.shape[3] != D:
        raise ValueError(f"landmark_score: keys {tuple(keys.shape)} do not match q {tuple(q.shape)}")
    Hkv = keys.shape[2]
    if H % Hkv:
        raise ValueError(f"landmark_score: H={H} must be a multiple of Hkv={Hkv}")
    kc = 0
    if landmarks is not None:
        if landmarks.dim() != 3 or landmarks.shape[0] != B or landmarks.shape[2] != D:
            raise ValueError(f"landmark_score: landmarks {tuple(landmarks.shape)} != [B, Kc, {D}]")
        kc = landmarks.shape[1]
    smem = 4 * (H * D + kc * (D + 1))
    if smem > MAX_SMEM:
        raise ValueError(f"landmark_score: {smem} bytes of staged queries/landmarks exceed the "
                         f"{MAX_SMEM}-byte shared-memory limit")


def landmark_score(q, keys, landmarks=None, *, scale: float | None = None):
    """q: [B,H,D]; keys: [B,T,Hkv,D]; landmarks: [B,Kc,D] or None.

    Returns (logits [B,H,T] f32, min_dist [B,T] f32 or None); distances
    are normalised by sqrt(D).
    """
    B, H, D = q.shape
    scale = 1.0 / (D ** 0.5) if scale is None else scale
    if q.device.type == "cpu":
        return landmark_score_ref(q, keys, landmarks, scale=scale)
    _check(q, keys, landmarks)
    T, Hkv = keys.shape[1], keys.shape[2]
    logits = torch.empty((B, H, T), dtype=torch.float32, device=q.device)
    dist = None if landmarks is None else torch.empty((B, T), dtype=torch.float32, device=q.device)
    KERNEL.launch(
        q.data_ptr(), keys.data_ptr(),
        None if landmarks is None else landmarks.data_ptr(),
        logits.data_ptr(), None if dist is None else dist.data_ptr(),
        B, T, Hkv, H // Hkv, D, 0 if landmarks is None else landmarks.shape[1],
        float(scale), float(D), _DTYPES[q.dtype],
    )
    return logits, dist
