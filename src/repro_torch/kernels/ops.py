"""Public entry points around the port's kernels, as the JAX package's
``repro.kernels.ops`` gives them: the ring append of the engine's token
rings, the synapse attend, and the landmark density sweep.

The CUDA kernels take the true shapes (no padding to tile multiples); on
a CPU tensor each wrapper runs its plain version.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import landmark_score as _ls
from repro_torch.kernels import synapse_attention as _sa
from repro_torch.kernels.build import build_all
from repro_torch.kernels.ref import NEG_INF  # finite mask shared with the kernels and the sampler

KERNELS = {"synapse_attention": _sa.KERNEL, "landmark_score": _ls.KERNEL}


def build_kernels() -> dict[str, str]:
    """Build every kernel not built yet (one nvcc per source, in parallel);
    returns {name: ptxas summary} of those built now."""
    return build_all(list(KERNELS))


def reset_launches():
    for k in KERNELS.values():
        k.launches = 0


def launch_counts() -> dict[str, int]:
    return {name: k.launches for name, k in KERNELS.items()}


def ring_append(ring, vals, cursor: int):
    """In place: ring [B, R] column ``cursor`` <- vals [B]. The cursor is the
    host's count of ticks since the last drain, so no device value is read."""
    ring[:, cursor] = vals.to(ring.dtype)


def synapse_attention(q, keys, values, valid, *, scale: float | None = None):
    """q [B,H,D]; keys/values [B,T,Hkv,D]; valid [B,T] bool ->
    (out [B,H,D], mass [B,T] f32). ``scale`` defaults to 1/sqrt(D)."""
    return _sa.synapse_attention(q, keys, values, valid, scale=scale)


def synapse_attend(q, pieces, valids, *, scale: float | None = None):
    """Attend over [landmarks; window; inject] k/v pieces: concatenate them,
    make ONE :func:`synapse_attention` call, and split the mass back per
    piece. Returns (out [B,H,D], masses — one [B,T_i] per piece)."""
    sizes = [k.shape[1] for k, _ in pieces]
    k_all = torch.cat([k for k, _ in pieces], dim=1)
    v_all = torch.cat([v for _, v in pieces], dim=1)
    valid_all = torch.cat(list(valids), dim=1)
    out, mass = synapse_attention(q, k_all, v_all, valid_all, scale=scale)
    return out, list(torch.split(mass, sizes, dim=1))


def landmark_score(q, keys, landmarks=None, valid=None):
    """Returns (density [B,T] — per-head softmax mass summed over heads,
    min_dist [B,T] or None when ``landmarks`` is None: the kernel skips its
    coverage block for density-only sweeps). ``valid`` ([B,T] bool, optional)
    restricts the softmax to valid keys."""
    D = q.shape[-1]
    logits, dist = _ls.landmark_score(q, keys, landmarks, scale=1.0 / (D ** 0.5))
    if valid is not None:
        logits = torch.where(valid[:, None, :], logits, torch.full_like(logits, NEG_INF))
    density = torch.softmax(logits, dim=-1).sum(dim=1)  # paper: sum_h softmax_h
    return density, dist
