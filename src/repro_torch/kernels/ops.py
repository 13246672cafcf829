"""Public entry points around the port's kernels, as the JAX package's
``repro.kernels.ops`` gives them: the ring append of the engine's token
rings, the synapse attention, and the landmark density sweep. ``KERNELS``
also holds the Mamba2 decode step, which ``models/mamba2.py`` launches.

The CUDA kernels take the true shapes (no padding to tile multiples); on
a CPU tensor each wrapper runs its plain version.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import landmark_score as _ls
from repro_torch.kernels import mamba2_step as _m2
from repro_torch.kernels import synapse_attention as _sa
from repro_torch.kernels.build import build_all
from repro_torch.kernels.ref import NEG_INF  # noqa: F401  (finite mask shared with the kernels and the sampler)

KERNELS = {"synapse_attention": _sa.KERNEL, "landmark_score": _ls.KERNEL, "mamba2_step": _m2.KERNEL}


def build_kernels() -> dict[str, str]:
    """Build every kernel not built yet (one nvcc per source, in parallel);
    returns {name: ptxas summary} of those built now."""
    return build_all(list(KERNELS))


def reset_launches():
    for k in KERNELS.values():
        k.launches = 0


def launch_counts() -> dict[str, int]:
    return {name: k.launches for name, k in KERNELS.items()}


def ring_append(ring, vals, cursor):
    """In place: ring [B, R] column ``cursor`` <- vals [B]. The cursor is the
    host's count of ticks since the last drain, so no device value is read:
    an int, or that int in a [1] int64 tensor on the ring's device, which a
    captured tick's graph reads when it is replayed."""
    if isinstance(cursor, torch.Tensor):
        ring.index_copy_(1, cursor, vals.to(ring.dtype)[:, None])
    else:
        ring[:, cursor] = vals.to(ring.dtype)


def synapse_attention(q, keys, values, valid, *, scale: float | None = None, out=None, mass=None):
    """q [B,H,D]; keys/values [B,T,Hkv,D]; valid [B,T] bool ->
    (out [B,H,D], mass [B,T] f32). ``scale`` defaults to 1/sqrt(D).
    ``out``/``mass``: tensors of those shapes to write into, returned."""
    return _sa.synapse_attention(q, keys, values, valid, scale=scale, out=out, mass=mass)


def landmark_score(q, keys, landmarks=None, valid=None, *, scale: float | None = None):
    """Returns (density [B,T] — per-head softmax mass summed over heads,
    min_dist [B,T] or None when ``landmarks`` is None: the kernel skips its
    coverage block for density-only sweeps). ``valid`` ([B,T] bool,
    optional) restricts the softmax to valid keys; ``scale`` (the model's
    attention scale) defaults to 1/sqrt(D). On a CUDA tensor the whole of
    it, the valid-masked softmax over T and the sum over heads included, is
    one launch of the kernel in density mode, which writes no [B,H,T]
    logits; on a CPU tensor the plain version."""
    return _ls.landmark_density(q, keys, landmarks, valid, scale=scale)
