"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: they need an NVIDIA card and ``nvcc`` and skip without
them (the fixture decides at run time, so every worker collects the same
tests). Run them on the card with
``PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py``
(``--noconftest``: the shared conftest imports JAX, which a card's host
need not have).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import landmark_score as ls
from repro_torch.kernels import ops
from repro_torch.kernels import ref
from repro_torch.kernels import synapse_attention as sa

pytestmark = pytest.mark.cuda

SHAPES = [
    # B, H, Hkv, D, T
    (1, 4, 4, 64, 128),
    (2, 8, 2, 64, 200),
    (2, 9, 3, 64, 321),
    (3, 16, 2, 80, 1000),
    (1, 32, 8, 128, 4096),
    (8, 14, 2, 64, 144),     # side-lane decode of the paper's model
    (24, 14, 2, 64, 1024),   # a spawn's sweep of the paper's model
    (2, 40, 2, 64, 96),      # G = 20: more rows than the kernels hold in registers at once
]
DTYPES = [torch.float32, torch.bfloat16]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _tol(dtype):
    return dict(rtol=2e-2, atol=2e-2) if dtype == torch.bfloat16 else dict(rtol=1e-5, atol=1e-5)


def _inputs(shape, dtype, dev, seed=0):
    B, H, Hkv, D, T = shape
    g = torch.Generator(device=dev).manual_seed(seed)
    r = lambda *s: torch.randn(s, generator=g, device=dev).to(dtype)
    valid = torch.rand((B, T), generator=g, device=dev) < 0.7
    valid[:, 0] = True
    return r(B, H, D), r(B, T, Hkv, D), r(B, T, Hkv, D), valid


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_synapse_attention_kernel_matches_plain(card, shape, dtype):
    q, k, v, valid = _inputs(shape, dtype, card)
    before = sa.KERNEL.launches
    out, mass = sa.synapse_attention(q, k, v, valid)
    torch.cuda.synchronize()
    assert sa.KERNEL.launches == before + 1
    out_r, mass_r = ref.synapse_attention_ref(q, k, v, valid)
    torch.testing.assert_close(out.float(), out_r.float(), **_tol(dtype))
    torch.testing.assert_close(mass, mass_r, **_tol(dtype))
    torch.testing.assert_close(mass.sum(-1), torch.full_like(mass[:, 0], shape[1]), rtol=1e-3, atol=0)
    again = sa.synapse_attention(q, k, v, valid)
    assert torch.equal(again[0], out) and torch.equal(again[1], mass)  # no atomics: bitwise repeatable


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("with_landmarks", [False, True])
def test_landmark_score_kernel_matches_plain(card, shape, dtype, with_landmarks):
    q, k, _, valid = _inputs(shape, dtype, card, seed=1)
    lm = torch.randn((shape[0], 7, shape[3]), device=card).to(dtype) if with_landmarks else None
    before = ls.KERNEL.launches
    logits, dist = ls.landmark_score(q, k, lm)
    torch.cuda.synchronize()
    assert ls.KERNEL.launches == before + 1
    logits_r, dist_r = ref.landmark_score_ref(q, k, lm)
    torch.testing.assert_close(logits, logits_r, **_tol(dtype))
    if lm is None:
        assert dist is None
    else:
        torch.testing.assert_close(dist, dist_r, **_tol(dtype))
    dens, _ = ops.landmark_score(q, k, None, valid)
    dens_r = torch.softmax(torch.where(valid[:, None], logits_r, torch.full_like(logits_r, ref.NEG_INF)), -1).sum(1)
    torch.testing.assert_close(dens, dens_r, **_tol(dtype))


def test_masked_keys_get_zero_mass_on_card(card):
    q, k, v, _ = _inputs((1, 4, 2, 64, 256), torch.float32, card)
    valid = torch.zeros((1, 256), dtype=torch.bool, device=card)
    valid[:, :10] = True
    _, mass = sa.synapse_attention(q, k, v, valid)
    assert float(mass[:, 10:].max()) < 1e-9
    np.testing.assert_allclose(float(mass.sum()), 4, rtol=1e-4)


def test_wrappers_refuse_what_the_kernels_do_not_take(card):
    q, k, v, valid = _inputs((1, 4, 2, 64, 128), torch.float32, card)
    with pytest.raises(TypeError):
        sa.synapse_attention(q.half(), k.half(), v.half(), valid)
    with pytest.raises(ValueError, match="contiguous"):
        sa.synapse_attention(q, k.transpose(1, 2).contiguous().transpose(1, 2), v, valid)
    long_k = torch.zeros((1, 60000, 2, 64), device=card)
    with pytest.raises(ValueError, match="shared-memory"):
        sa.synapse_attention(q, long_k, long_k, torch.ones((1, 60000), dtype=torch.bool, device=card))
    with pytest.raises(ValueError, match="shared-memory"):
        ls.landmark_score(torch.zeros((1, 1024, 64), device=card), torch.zeros((1, 8, 2, 64), device=card))
    with pytest.raises(ValueError, match="multiple"):
        ls.landmark_score(torch.zeros((1, 5, 64), device=card), torch.zeros((1, 8, 2, 64), device=card))
