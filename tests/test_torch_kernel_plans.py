"""The CUDA kernels' launch plans and the kernel's split softmax, on the
CPU.

``landmark_score.launch_plan`` and ``synapse_attention.launch_plan`` are the
pure-Python geometry that the wrappers hand to the card: these tests hold
the same numbers the kernels launch with. The split-softmax test runs the
``synapse_attention`` kernel's arithmetic in torch over the plan's CTAs
(per lane, kv head and key range: max, sum and partial p.V; the ranges
combined in range order; the mass summed over kv heads in order) against
the plain version.
"""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels import landmark_score as ls
from repro_torch.kernels import ref
from repro_torch.kernels import synapse_attention as sa

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402  (its shape lists; it imports no JAX)

SMEM_LIMIT = 232_448
# the CTAs an NVIDIA H100 80GB HBM3 holds at once, two an SM, in clusters of
# 1, 2, 4, 8 and 16 (synapse_attention.resident_ctas on the card, which
# chip_smoke.py phase 2 logs)
H100 = (264, 264, 248, 240, 224)
RES = dict(zip(sa.CLUSTER_SIZES, H100))


def sa_plan(B, T, H, Hkv, D, e, **kw):
    return sa.launch_plan(B, T, H, Hkv, D, e, H100, **kw)


SHAPES = [
    # B, H, Hkv, D: the kernel-test shapes, the main path's, Hkv = 8, G = 20
    (1, 4, 4, 64), (2, 8, 2, 64), (2, 9, 3, 64), (3, 16, 2, 80), (1, 32, 8, 128),
    (8, 14, 2, 64), (24, 14, 2, 64), (2, 40, 2, 64), (2, 16, 8, 64),
]
# the other families' (H, Hkv, D): zamba2's shared MHA block, qwen3-moe,
# qwen3-4b/8b, qwen2-vl-72b and qwen1.5-110b; B = 8 side lanes, 36 = the
# zamba2 spawn's 6 invocations x 6 parent lanes
FAMILY_SHAPES = [(8, 32, 32, 64), (36, 32, 32, 64), (8, 32, 4, 128), (8, 32, 8, 128), (8, 64, 8, 128)]
T_VALUES = [1, 31, 32, 33, 144, 1024, 4096]
ELEM_BYTES = [4, 2]  # float32, bfloat16


def _assert_partition(ranges, T):
    assert ranges[0][0] == 0 and ranges[-1][1] == T
    for (a, b), (c, _) in zip(ranges, ranges[1:]):
        assert b == c
    assert all(b > a for a, b in ranges)


def _check_synapse_plan(p, B, H, Hkv, D, T, e):
    """What every synapse_attention plan holds: the ranges partition T, C is
    the most ranges (a power of two, at most 16, at least 32 keys each where
    T allows) whose grid the card holds in one wave, or, where a range's
    scores and ring would not fit there, the fewest more that fit; the
    ring's chunks cover a range, shared memory fits, and the only device
    workspace is the [B, Hkv, T] mass per kv head where the kv heads do not
    share a cluster (no scores)."""
    C = p.cluster
    assert C in (1, 2, 4, 8, 16) and p.grid == (C, Hkv, B) and p.ctas == C * Hkv * B
    one_wave = C == 1 or (T // sa.MIN_KEYS >= C and B * Hkv * C <= RES[C])
    if not one_wave:  # the fewest ranges past one wave whose scores and ring fit
        with pytest.raises(ValueError, match="shared-memory limit"):
            sa_plan(B, T, H, Hkv, D, e, max_cluster=C // 2)
    assert not one_wave or C == 16 or T // sa.MIN_KEYS < 2 * C or B * Hkv * 2 * C > RES[2 * C]
    assert len(p.ranges) == C
    _assert_partition(p.ranges, T)
    assert p.n_max == max(b - a for a, b in p.ranges) == -(-T // C)
    assert p.chunk_keys % 16 == 0 and 16 <= p.chunk_keys <= 256 and p.chunk_keys < p.n_max + 16
    assert p.n_chunks * p.chunk_keys >= p.n_max > (p.n_chunks - 1) * p.chunk_keys
    assert 2 <= p.stages <= min(sa.MAX_STAGES, max(2, 2 * p.n_chunks))
    assert p.stage_row == (128 * -(-D // 64) if e == 2 else D * 4)
    assert p.score_pitch >= p.n_max and p.score_pitch % 32 == 8
    G = H // Hkv
    # the scores (G x n_max f32) and the ring live in shared memory, within the limit
    assert G * p.score_pitch * 4 + p.stages * p.chunk_keys * p.stage_row < p.smem <= SMEM_LIMIT
    HC = p.kv_cluster
    assert HC == 1 or (HC == Hkv and C * HC in RES and B * Hkv * C <= RES[C * HC]
                       and Hkv * p.n_max * 4 <= sa.KV_SLOTS_BYTES)
    assert p.mass_parts == (Hkv > 1 and HC == 1)
    assert not hasattr(p, "spill")


@pytest.mark.parametrize("T", T_VALUES)
def test_synapse_attention_plan(T):
    for B, H, Hkv, D in SHAPES + FAMILY_SHAPES:
        for e in ELEM_BYTES:
            p = sa_plan(B, T, H, Hkv, D, e)
            _check_synapse_plan(p, B, H, Hkv, D, T, e)
            if e == 2:
                assert p.slices == max(1, 8 // (D // 16 * -(-(H // Hkv) // 8)))
            else:
                assert 1 <= p.slices <= 8 and p.slices * (D * e // 16) <= max(256, D * e // 16)


# every shape chip_smoke.py holds the kernel at, and the reference's long_500k
# decode (T = 4096 + 1024 + 128) at T up to 32,768
SMOKE_SHAPES = sorted({chip_smoke.SYN_MAIN, chip_smoke.SYN_QWEN3, *chip_smoke.TEST_SHAPES, *chip_smoke.FAMILY_SHAPES,
                       *chip_smoke.LONG_SHAPES, *chip_smoke.SYN_LONG500K,
                       (1, 32, 8, 128, 32768), (1, 64, 8, 128, 32768)})


@pytest.mark.parametrize("shape", SMOKE_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_synapse_plan_at_the_smoke_shapes(shape):
    B, H, Hkv, D, T = shape
    for e in ELEM_BYTES:
        _check_synapse_plan(sa_plan(B, T, H, Hkv, D, e), B, H, Hkv, D, T, e)


@pytest.mark.parametrize("T", T_VALUES)
def test_landmark_score_plan(T):
    for B, H, Hkv, D in SHAPES + FAMILY_SHAPES:
        for e in ELEM_BYTES:
            for kc in (0, 7):
                p = ls.launch_plan(B, T, H, Hkv, D, kc, e)
                assert p.block_t in (64, 32, 16, 8, 4, 2, 1)
                assert p.grid == (-(-T // p.block_t), B) and len(p.ranges) == p.grid[0]
                _assert_partition(p.ranges, T)
                assert all(b - a <= p.block_t for a, b in p.ranges)
                assert p.smem <= SMEM_LIMIT
                G = H // Hkv
                assert p.rows in (1, 2, 4, 7, 8) and p.rows >= min(G, 8) and (p.rows == 8 or p.rows - G < 3)
                assert p.threads == min(256, -(-(p.block_t * Hkv * -(-G // p.rows)) // 32) * 32)
                # the slab of the next larger tile would not have fit
                if p.block_t < 64:
                    assert p.smem + p.block_t * Hkv * D * e > SMEM_LIMIT


def test_plans_at_the_main_path_shapes():
    # spawn: 24 layers x 1 lane, bf16: 64-key tiles, 16 x 24 = 384 blocks of
    # 64 keys x 2 kv heads x 1 group of 7 query rows
    p = ls.launch_plan(24, 1024, 14, 2, 64, 0, 2)
    assert p.block_t == 64 and p.grid == (16, 24) and p.threads == 128 and p.rows == 7
    # a 64-key f32 slab of Hkv = 8, D = 128 needs 256 KB: 32 keys fit
    assert ls.launch_plan(1, 4096, 32, 8, 128, 0, 4).block_t == 32
    # side decode: 8 lanes x 2 kv heads, T = 144: 4 ranges of 36 keys (32 at
    # least); the 2 kv heads share a cluster of 8, which sums the mass over
    # them in shared memory: no workspace
    p = sa_plan(8, 144, 14, 2, 64, 2)
    assert p.cluster == 4 and p.kv_cluster == 2 and p.grid == (4, 2, 8) and not p.mass_parts
    assert p.n_chunks == 1 and p.stages == 2
    assert p.ranges == ((0, 36), (36, 72), (72, 108), (108, 144))
    # T = 4096, Hkv = 8, D = 128, f32 on one lane: 16 ranges stream through the ring
    p = sa_plan(1, 4096, 32, 8, 128, 4)
    assert p.cluster == 16 and p.n_chunks > 1


def test_plans_at_the_family_shapes():
    # zamba2's spawn: 6 invocations x 1 parent lane, T = 1024, H = Hkv = 32,
    # D = 64: a key row of 32 kv heads is 4 KB in bf16, so a tile is 32 keys
    # (16 in f32), one bulk copy shorter than the 32-key part; G = 1, so a
    # thread takes one row and the block loops over 1024 (key, kv head)
    # units with 256 threads
    p = ls.launch_plan(6, 1024, 32, 32, 64, 0, 2)
    assert p.block_t == 32 and p.rows == 1 and p.threads == 256 and p.grid == (32, 6)
    assert ls.launch_plan(6, 1024, 32, 32, 64, 0, 4).block_t == 16
    # zamba2's side decode: T = K + W + J = 136; 8 lanes x 32 kv heads are
    # 256 CTAs, all the card holds: one range each, G = 1 (one 8-row group
    # of which one row is real), p.V over 4 tiles of 16 columns in 2 slices
    p = sa_plan(8, 136, 32, 32, 64, 2)
    assert p.cluster == 1 and p.grid == (1, 32, 8) and p.slices == 2 and p.n_chunks == 1
    assert sa_plan(8, 136, 32, 32, 64, 4).n_chunks == 2
    # qwen3-moe: G = 8, 16-byte chunks of a 256-byte bf16 row: 8 rows a pass
    p = ls.launch_plan(48, 1024, 32, 4, 128, 0, 2)
    assert p.rows == 8 and p.block_t == 64
    # qwen3-moe's side decode: 8 x 4 kv heads, ranges of 34 keys; 8 tiles of
    # 16 columns of p.V, one a warp
    p = sa_plan(8, 136, 32, 4, 128, 2)
    assert p.cluster == 4 and p.slices == 1 and p.ctas == 128
    # qwen2-vl / qwen1.5 (H = 64, Hkv = 8) at the side decode's T
    assert sa_plan(8, 136, 64, 8, 128, 4).cluster == 2
    # ... and at T = 4096: 8 x 8 x 2 = 128 CTAs of 2048 keys, one an SM, their
    # 8 x 2048 f32 scores (64 KB) in shared memory beside a 4-stage ring of
    # 128-key chunks (two 64-column boxes of 128 bytes a key)
    p = sa_plan(8, 4096, 64, 8, 128, 2)
    assert p.cluster == 2 and p.n_max == 2048 and p.slices == 1 and p.ctas == 128
    assert p.chunk_keys == 128 and p.n_chunks == 16 and p.stages == 4 and p.smem <= SMEM_LIMIT
    # ... and at T = 16,384: at the one-wave C = 2 a range's 8 x 8192 f32
    # scores (256 KB) would not fit; 4 ranges of 4096 keys do (128 KB beside
    # a 2-stage ring), 256 CTAs, more than one wave
    p = sa_plan(8, 16384, 64, 8, 128, 2)
    assert p.cluster == 4 and p.n_max == 4096 and p.ctas == 256 > H100[2] and p.stages == 2
    assert p.smem <= SMEM_LIMIT


def test_synapse_plan_follows_the_cards_residency():
    """The grid is sized by what the card holds: at the long_500k decode,
    16 ranges a kv head on an H100, 8 on a card that holds half as many
    CTAs."""
    assert sa_plan(1, 5248, 32, 8, 128, 2).cluster == 16
    assert sa.launch_plan(1, 5248, 32, 8, 128, 2, tuple(n // 2 for n in H100)).cluster == 8


@pytest.mark.parametrize("plan", [
    lambda D, e: sa_plan(1, 8, 4, 2, D, e),
    lambda D, e: ls.launch_plan(1, 8, 4, 2, D, 0, e),
    lambda D, e: ls.launch_plan(1, 8, 4, 2, D, 3, e),
], ids=["synapse_attention", "landmark_score", "landmark_score_coverage"])
@pytest.mark.parametrize("D,e", [(6, 4), (4, 2), (12, 2)])
def test_plans_refuse_misaligned_rows(plan, D, e):
    with pytest.raises(ValueError, match="not a multiple of 16"):
        plan(D, e)


@pytest.mark.parametrize("args,reason", [
    ((1, 64, 4, 2, 24, 2), "depth of a bf16 tensor-core step"),      # D = 24: 48-byte rows, but no 16-deep step
    ((1, 64, 4, 2, 320, 4), "tensor-map box"),                      # 320 f32 columns
    ((1, 64, 512, 1, 128, 2), "p.V tiles"),                         # G = 512 rows of 128
    ((1, 1 << 20, 8, 1, 128, 2), "shared-memory limit"),           # 65,536 keys a range: 2 MB of scores
], ids=["bf16_depth", "f32_box", "pv_tiles", "scores"])
def test_synapse_plan_refuses_what_the_kernel_cannot_take(args, reason):
    B, T, H, Hkv, D, e = args
    with pytest.raises(ValueError, match=reason):
        sa_plan(B, T, H, Hkv, D, e)


def test_landmark_plan_refuses_query_rows_that_do_not_fit():
    with pytest.raises(ValueError, match="shared-memory limit"):
        ls.launch_plan(1, 8, 1024, 2, 64, 0, 4)  # 1024 query rows alone


# (B, H, Hkv, D, T): the two largest head shapes of the families at long
# key sets, one lane at T = 32,768, and 8 lanes at T = 16,384, whose scores
# fit only at more ranges than one wave holds
LONG_T = [(8, 64, 8, 128, 4096), (1, 32, 2, 64, 16384), (1, 64, 8, 128, 32768), (8, 64, 8, 128, 16384)]


@pytest.mark.parametrize("shape", LONG_T)
@pytest.mark.parametrize("e", ELEM_BYTES)
def test_synapse_plan_fits_long_ranges(shape, e):
    """A long key set splits into ranges whose G x n_max f32 scores stay in
    shared memory beside the ring: no workspace for scores, only the
    [B, Hkv, T] f32 mass per kv head."""
    B, H, Hkv, D, T = shape
    p = sa_plan(B, T, H, Hkv, D, e)
    _check_synapse_plan(p, B, H, Hkv, D, T, e)
    G = H // Hkv
    # 64 KB of scores at most on one lane up to T = 32,768; 128 KB at 8 lanes
    # of T = 16,384 (4 ranges of 4096 keys, a second wave)
    assert G * p.n_max * 4 <= (64 if B == 1 else 128) * 1024
    assert p.mass_parts and p.kv_cluster == 1 and p.stages >= 2


def _split_attention(q, k, v, valid, ranges, scale):
    """The kernel's arithmetic in torch: for each (lane, kv head, range) CTA
    its m_r, p~ = e^(s - m_r), l_r and o_r = p~ . V over its G query rows;
    per (lane, kv head) the ranges combined in range order, w_r =
    e^(m_r - M) / L; each CTA's mass sum_g p~ w_r; then the mass summed
    over the kv heads in kv-head order."""
    B, H, D = q.shape
    Hkv = k.shape[2]
    G = H // Hkv
    out = torch.zeros((B, Hkv, G, D))
    mass = torch.zeros((B, k.shape[1]))
    for h in range(Hkv):
        qh = q[:, h * G:(h + 1) * G]  # [B, G, D]
        parts = []
        for a, b in ranges:
            s = torch.einsum("bgd,btd->bgt", qh, k[:, a:b, h]) * scale
            s = torch.where(valid[:, None, a:b], s, torch.full_like(s, ref.NEG_INF))
            m = s.amax(-1)
            p = torch.exp(s - m[..., None])
            parts.append((m, p, p.sum(-1), torch.einsum("bgt,btd->bgd", p, v[:, a:b, h])))
        M = parts[0][0]
        for m, _, _, _ in parts[1:]:
            M = torch.maximum(M, m)
        L = torch.zeros_like(M)
        for m, _, l, _ in parts:
            L = L + l * torch.exp(m - M)
        for (a, b), (m, p, _, o) in zip(ranges, parts):
            w = torch.exp(m - M) / L
            out[:, h] += o * w[..., None]
            mass[:, a:b] += (p * w[..., None]).sum(dim=1)
    return out.reshape(B, H, D), mass


@pytest.mark.parametrize("shape", [(8, 14, 2, 64, 144), (2, 9, 3, 64, 321), (2, 40, 2, 64, 96), (2, 8, 2, 64, 65),
                                   (2, 32, 32, 64, 136), (2, 32, 4, 128, 136), (2, 64, 8, 128, 136),
                                   (1, 64, 8, 128, 4096)])  # the last: 16 ranges of 256 keys a kv head
@pytest.mark.parametrize("mask", ["random", "invalid_range", "invalid_lane"])
def test_split_softmax_matches_plain(shape, mask):
    B, H, Hkv, D, T = shape
    rng = np.random.default_rng(sum(shape))
    q, k, v = (torch.from_numpy(rng.standard_normal(s, dtype=np.float32))
               for s in ((B, H, D), (B, T, Hkv, D), (B, T, Hkv, D)))
    valid = torch.from_numpy(rng.random((B, T)) < 0.7)
    valid[:, 0] = True
    ranges = sa_plan(B, T, H, Hkv, D, 4).ranges
    if mask == "invalid_range":  # one CTA sees no valid key of lane 0; the lane's others do
        assert len(ranges) > 1
        a, b = ranges[-1]
        valid[0, a:b] = False
    elif mask == "invalid_lane":  # lane 0 has no valid key at all
        valid[0] = False
    scale = 1.0 / D ** 0.5
    out, mass = _split_attention(q, k, v, valid, ranges, scale)
    out_r, mass_r = ref.synapse_attention_ref(q, k, v, valid, scale=scale)
    torch.testing.assert_close(out, out_r, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(mass, mass_r, rtol=1e-6, atol=1e-6)
    if mask == "invalid_range":
        assert float(mass[0, a:b].abs().max()) == 0.0
    if mask == "invalid_lane":
        torch.testing.assert_close(mass[0], torch.full((T,), H / T), rtol=1e-6, atol=1e-7)
