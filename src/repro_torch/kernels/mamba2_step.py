"""One Mamba2 decode step with each lane's state updated in place: the
CUDA kernel ``csrc/mamba2_step.cu`` and its wrapper.

The step covers everything between the in-projection's output ``zxbcdt``
and the out-projection's input: the conv over the lane's tail (rolled in
place), dt and the decay, the SSD state update (in place in the cache's
``ssm`` tensor), ``y = H C + D x`` and the group-wise gated RMSNorm. The
plain version is :func:`repro_torch.models.mamba2._decode_core`, which a
CPU tensor takes; a CUDA tensor launches the kernel or raises. The widths
are read from the tensors' shapes: a head width and a state size each one
of :data:`WIDTHS` (the published Zamba2 configs have 64 and 64, their
reduced variants 32 and 16), any B/C group count that divides the heads.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import CudaKernel

WIDTHS = (16, 32, 64)  # the head widths and state sizes the kernel is built for
MAX_CONV = 4           # the widest depthwise conv
_DTYPES = (torch.float32, torch.bfloat16)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# one launch of the C entry point is one step: three grids on the stream
KERNEL = CudaKernel("mamba2_step", "mamba2_step_launch", [_P] * 12 + [_I] * 8 + [_F, _P])


def step_shapes(zxbcdt, conv_state, ssm_state, conv_w, conv_b, dt_bias, a_log, d_skip, gate_norm):
    """(B, heads, head width, state size, groups, conv width) of one step,
    read from the shapes; raises ValueError or TypeError on what the kernel
    does not take. On any device: the wrapper's check, which the CPU tests
    call.

    zxbcdt [B, 2 di + 2 G ds + nh] (z | xBC | dt), conv_state [B, W - 1,
    di + 2 G ds], ssm_state [B, nh, dh, ds] f32, conv_w [W, ch], conv_b
    [ch], dt_bias / a_log / d_skip [nh], gate_norm [di]; di = nh dh; all
    but the state in one working type, f32 or bf16."""
    named = dict(zxbcdt=zxbcdt, conv_state=conv_state, ssm_state=ssm_state, conv_w=conv_w, conv_b=conv_b,
                 dt_bias=dt_bias, a_log=a_log, d_skip=d_skip, gate_norm=gate_norm)
    for name, t in named.items():
        if t.device != zxbcdt.device:
            raise ValueError(f"mamba2_step: {name} is on {t.device}, zxbcdt on {zxbcdt.device}")
        if not t.is_contiguous():
            raise ValueError(f"mamba2_step: {name} must be contiguous")
    if zxbcdt.dtype not in _DTYPES:
        raise TypeError(f"mamba2_step: zxbcdt is {zxbcdt.dtype}, not one of {_DTYPES}")
    if ssm_state.dtype != torch.float32:
        raise TypeError(f"mamba2_step: ssm_state is {ssm_state.dtype}, not torch.float32")
    for name, t in named.items():
        if name != "ssm_state" and t.dtype != zxbcdt.dtype:
            raise TypeError(f"mamba2_step: {name} is {t.dtype}, zxbcdt {zxbcdt.dtype}: the step runs in one "
                            f"working type (the serving casts give every parameter the compute dtype)")
    if ssm_state.dim() != 4:
        raise ValueError(f"mamba2_step: ssm_state {tuple(ssm_state.shape)} is not [B, nh, dh, ds]")
    B, nh, dh, ds = ssm_state.shape
    if dh not in WIDTHS or ds not in WIDTHS:
        raise ValueError(f"mamba2_step: ssm_state {tuple(ssm_state.shape)} has heads of {dh} and a state of {ds}: "
                         f"the kernel takes each of {WIDTHS}")
    if B < 1 or nh < 1:
        raise ValueError(f"mamba2_step: empty ssm_state {tuple(ssm_state.shape)}")
    di = nh * dh
    if conv_state.dim() != 3 or conv_state.shape[0] != B or (conv_state.shape[2] - di) % (2 * ds) \
            or conv_state.shape[2] <= di:
        raise ValueError(f"mamba2_step: conv_state {tuple(conv_state.shape)} is not [{B}, W - 1, {di} + 2 G {ds}]")
    W, ch = conv_state.shape[1] + 1, conv_state.shape[2]
    G = (ch - di) // (2 * ds)
    if nh % G:
        raise ValueError(f"mamba2_step: {G} B/C groups do not divide {nh} heads")
    if not 2 <= W <= MAX_CONV:
        raise ValueError(f"mamba2_step: conv width {W} is not in [2, {MAX_CONV}]")
    want = {"zxbcdt": (B, di + ch + nh), "conv_w": (W, ch), "conv_b": (ch,), "dt_bias": (nh,), "a_log": (nh,),
            "d_skip": (nh,), "gate_norm": (di,)}
    for name, shape in want.items():
        if tuple(named[name].shape) != shape:
            raise ValueError(f"mamba2_step: {name} {tuple(named[name].shape)} != {shape}")
    if ssm_state.data_ptr() % 16:
        raise ValueError("mamba2_step: ssm_state must start at a 16-byte aligned address")
    return B, nh, dh, ds, G, W


def mamba2_step(zxbcdt, conv_state, ssm_state, conv_w, conv_b, dt_bias, a_log, d_skip, gate_norm, *, eps: float):
    """One step on CUDA tensors: ``conv_state`` and ``ssm_state`` take the
    new tail and state in place (the JAX reference returns new ones; the
    port writes the cache's own tensors, so the state is read and written
    once). Returns y [B, di] in zxbcdt's dtype, before the out-projection."""
    if not zxbcdt.is_cuda:
        raise ValueError(f"mamba2_step: the kernel takes CUDA tensors, zxbcdt is on {zxbcdt.device}")
    B, nh, dh, ds, G, W = step_shapes(zxbcdt, conv_state, ssm_state, conv_w, conv_b, dt_bias, a_log, d_skip,
                                      gate_norm)
    di, ch = nh * dh, conv_state.shape[2]
    # a scratch row: conv output, dt, decay, each head's sum of squares; 16-byte aligned rows
    S = -(-(ch + 3 * nh) // 4) * 4
    scratch = torch.empty((B, S), dtype=torch.float32, device=zxbcdt.device)
    gated = torch.empty((B, di), dtype=zxbcdt.dtype, device=zxbcdt.device)
    out = torch.empty_like(gated)
    params = (conv_w, conv_b, dt_bias, a_log, d_skip, gate_norm)
    KERNEL.launch(zxbcdt.data_ptr(), conv_state.data_ptr(), ssm_state.data_ptr(), *(t.data_ptr() for t in params),
                  scratch.data_ptr(), gated.data_ptr(), out.data_ptr(), B, nh, dh, ds, G, W, S,
                  int(zxbcdt.dtype == torch.bfloat16), float(eps))
    return out
