"""The port's kernel entry points (their plain path, on the CPU) against the
JAX package's oracles and Pallas kernels: the shape/dtype sweep of
tests/test_kernels.py, with its tolerances.

Inputs are made with numpy from a seed and handed to both packages; bf16
inputs round from the same f32 values in both (round to nearest even).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import synapse as jsynapse
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core import synapse as tsynapse
from repro_torch.kernels import ops as tops

SHAPES = [
    # B, H, Hkv, D, T
    (1, 4, 4, 64, 128),
    (2, 8, 2, 64, 200),
    (2, 9, 3, 64, 321),
    (3, 16, 2, 80, 1000),
    (1, 32, 8, 128, 4096),
]
DTYPES = ["float32", "bfloat16"]


def _tol(dtype):
    # bf16 keeps ~3 decimal digits; f32 sums differ only in order
    return dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16" else dict(rtol=1e-5, atol=1e-5)


def _pair(x, dtype):
    """One numpy f32 array as (jax array, torch tensor) in ``dtype``."""
    return jnp.asarray(x).astype(getattr(jnp, dtype)), torch.from_numpy(x).to(getattr(torch, dtype))


def _np32(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(a, np.float32)


def _inputs(shape, seed):
    B, H, Hkv, D, T = shape
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, D), dtype=np.float32)
    k = rng.standard_normal((B, T, Hkv, D), dtype=np.float32)
    v = rng.standard_normal((B, T, Hkv, D), dtype=np.float32)
    valid = rng.random((B, T)) < 0.7
    valid[:, 0] = True
    return q, k, v, valid


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_synapse_attention_matches_ref(shape, dtype):
    H = shape[1]
    q, k, v, valid = _inputs(shape, 0)
    (jq, tq), (jk, tk), (jv, tv) = _pair(q, dtype), _pair(k, dtype), _pair(v, dtype)
    out, mass = tops.synapse_attention(tq, tk, tv, torch.from_numpy(valid))
    out_r, mass_r = jref.synapse_attention_ref(jq, jk, jv, jnp.asarray(valid))
    assert out.dtype == tq.dtype and mass.dtype == torch.float32
    np.testing.assert_allclose(_np32(out), _np32(out_r), **_tol(dtype))
    np.testing.assert_allclose(_np32(mass), _np32(mass_r), **_tol(dtype))
    # probability mass conserves: sums to H per lane
    np.testing.assert_allclose(_np32(mass.sum(-1)), H, rtol=1e-3)


@pytest.mark.parametrize("shape", SHAPES[:4])
def test_synapse_attention_matches_jax_ops(shape):
    """Against the JAX package's public wrapper (the Pallas kernel in
    interpret mode above T=512, its oracle below)."""
    q, k, v, valid = _inputs(shape, 1)
    out, mass = tops.synapse_attention(*map(torch.from_numpy, (q, k, v, valid)))
    out_j, mass_j = jops.synapse_attention(*map(jnp.asarray, (q, k, v, valid)), interpret=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(out_j), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(mass.numpy(), np.asarray(mass_j), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_landmark_score_matches_ref(shape, dtype):
    B, H, Hkv, D, T = shape
    q, k, _, _ = _inputs(shape, 2)
    lm = np.random.default_rng(3).standard_normal((B, 7, D), dtype=np.float32)
    (jq, tq), (jk, tk), (jl, tl) = _pair(q, dtype), _pair(k, dtype), _pair(lm, dtype)
    dens, dist = tops.landmark_score(tq, tk, tl)
    logits_r, dist_r = jref.landmark_score_ref(jq, jk, jl)
    dens_r = np.asarray(jnp.exp(logits_r - logits_r.max(-1, keepdims=True)))
    dens_r = (dens_r / dens_r.sum(-1, keepdims=True)).sum(1)
    np.testing.assert_allclose(dens.numpy(), dens_r, **_tol(dtype))
    np.testing.assert_allclose(dist.numpy(), np.asarray(dist_r), **_tol(dtype))


@pytest.mark.parametrize("shape", SHAPES[:4])
@pytest.mark.parametrize("with_landmarks", [False, True])
def test_landmark_score_matches_jax_ops(shape, with_landmarks):
    """Both branches against the JAX package's wrapper around the Pallas
    kernel (interpret mode), with a valid mask on the softmax."""
    B, H, Hkv, D, T = shape
    q, k, _, valid = _inputs(shape, 4)
    lm = np.random.default_rng(5).standard_normal((B, 5, D), dtype=np.float32) if with_landmarks else None
    dens, dist = tops.landmark_score(
        torch.from_numpy(q), torch.from_numpy(k), None if lm is None else torch.from_numpy(lm),
        torch.from_numpy(valid))
    dens_j, dist_j = jops.landmark_score(
        jnp.asarray(q), jnp.asarray(k), None if lm is None else jnp.asarray(lm), jnp.asarray(valid),
        interpret=True)
    np.testing.assert_allclose(dens.numpy(), np.asarray(dens_j), rtol=1e-5, atol=1e-5)
    if lm is None:
        assert dist is None and dist_j is None
    else:
        np.testing.assert_allclose(dist.numpy(), np.asarray(dist_j), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shape", SHAPES[:4])
def test_density_only_sweep_matches_attention_density(shape):
    """The spawn's density-only sweep (kernel_density) against the JAX
    package's plain attention_density."""
    q, k, _, valid = _inputs(shape, 6)
    dens = tsynapse.kernel_density(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(valid))
    dens_j = jsynapse.attention_density(jnp.asarray(q), jnp.asarray(k), jnp.asarray(valid))
    np.testing.assert_allclose(dens.numpy(), np.asarray(dens_j), rtol=1e-5, atol=1e-5)
    assert float(dens[~torch.from_numpy(valid)].abs().max()) < 1e-9


def test_masked_keys_get_zero_mass():
    B, H, Hkv, D, T = 1, 4, 2, 64, 256
    q, k, v, _ = _inputs((B, H, Hkv, D, T), 7)
    valid = np.zeros((B, T), bool)
    valid[:, :10] = True
    _, mass = tops.synapse_attention(*map(torch.from_numpy, (q, k, v, valid)))
    assert float(mass[:, 10:].max()) < 1e-9
    np.testing.assert_allclose(float(mass.sum()), H, rtol=1e-4)


def test_all_invalid_row_is_uniform_not_nan():
    """The finite NEG_INF mask: a lane with no valid key attends uniformly."""
    B, H, Hkv, D, T = 2, 4, 2, 64, 16
    q, k, v, _ = _inputs((B, H, Hkv, D, T), 8)
    valid = np.zeros((B, T), bool)
    out, mass = tops.synapse_attention(*map(torch.from_numpy, (q, k, v, valid)))
    assert torch.isfinite(out).all()
    np.testing.assert_allclose(mass.numpy(), H / T, rtol=1e-6)


def test_synapse_attend_splits_mass_per_piece():
    B, H, Hkv, D = 2, 8, 2, 64
    rng = np.random.default_rng(9)
    sizes = (5, 7, 3)
    pieces, valids = [], []
    for t in sizes:
        k = torch.from_numpy(rng.standard_normal((B, t, Hkv, D), dtype=np.float32))
        v = torch.from_numpy(rng.standard_normal((B, t, Hkv, D), dtype=np.float32))
        pieces.append((k, v))
        valids.append(torch.from_numpy(rng.random((B, t)) < 0.8))
    q = torch.from_numpy(rng.standard_normal((B, H, D), dtype=np.float32))
    out, masses = tops.synapse_attend(q, pieces, valids)
    out_f, mass_f = tops.synapse_attention(
        q, torch.cat([k for k, _ in pieces], 1), torch.cat([v for _, v in pieces], 1), torch.cat(valids, 1))
    assert [m.shape[1] for m in masses] == list(sizes)
    assert torch.equal(out, out_f) and torch.equal(torch.cat(masses, 1), mass_f)


def test_ring_append_writes_one_column():
    ring = torch.full((3, 4), -1, dtype=torch.int32)
    tops.ring_append(ring, torch.tensor([7, 8, 9]), 2)
    assert ring[:, 2].tolist() == [7, 8, 9] and (ring[:, [0, 1, 3]] == -1).all()
