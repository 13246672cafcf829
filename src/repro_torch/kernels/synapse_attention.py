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

import torch

from repro_torch.kernels.build import CudaKernel
from repro_torch.kernels.ref import synapse_attention_ref

MAX_SMEM = 232_448          # bytes of shared memory a block may use on sm_90
_REDUCE_FLOATS = 8 * 16 * 32  # the kernel's p.V partial sums: warps x rows x lanes
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_P, _I = ctypes.c_void_p, ctypes.c_int
KERNEL = CudaKernel(
    "synapse_attention", "synapse_attention_launch",
    [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, ctypes.c_float, _I, _P],
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
    smem = 4 * ((H // Hkv) * (D + T) + _REDUCE_FLOATS)
    if smem > MAX_SMEM:
        raise ValueError(f"synapse_attention: {smem} bytes of queries, scores and partial sums "
                         f"exceed the {MAX_SMEM}-byte shared-memory limit (T={T} too long)")
    for name, t in (("q", q), ("keys", keys), ("values", values), ("valid", valid)):
        if not t.is_contiguous():
            raise ValueError(f"synapse_attention: {name} must be contiguous")


def synapse_attention(q, keys, values, valid, *, scale: float | None = None):
    """q: [B,H,D]; keys/values: [B,T,Hkv,D]; valid: [B,T] bool.

    Returns (out [B,H,D] in q's dtype, mass [B,T] f32). ``scale`` defaults
    to 1/sqrt(D).
    """
    B, H, D = q.shape
    scale = 1.0 / (D ** 0.5) if scale is None else scale
    if q.device.type == "cpu":
        return synapse_attention_ref(q, keys, values, valid, scale=scale)
    _check(q, keys, values, valid)
    T, Hkv = keys.shape[1], keys.shape[2]
    out = torch.empty_like(q)
    scratch = torch.empty((B, Hkv, T), dtype=torch.float32, device=q.device)
    KERNEL.launch(
        q.data_ptr(), keys.data_ptr(), values.data_ptr(), valid.data_ptr(),
        out.data_ptr(), scratch.data_ptr(), B, T, Hkv, H // Hkv, D, float(scale), _DTYPES[q.dtype],
    )
    return out, scratch.sum(dim=1)
