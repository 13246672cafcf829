"""The CUDA kernels' launch plans and the kernels' split softmaxes, on the
CPU.

``landmark_score.launch_plan`` and ``synapse_attention.launch_plan`` are the
pure-Python geometry that the wrappers hand to the card: these tests hold
the same numbers the kernels launch with. The split-softmax tests run each
kernel's arithmetic in torch over the plan's CTAs against the plain
version: ``synapse_attention``'s per (lane, kv head, key range) max, sum
and partial p.V, the ranges combined in range order, the mass summed over
kv heads in order; ``landmark_score``'s density mode per (lane, key range)
running max and sum per head over its tiles (tiles with no valid key not
loaded), the ranges combined in range order, the density per key summed
over heads.
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


def ls_plan(B, T, H, Hkv, D, kc, e, **kw):
    return ls.launch_plan(B, T, H, Hkv, D, kc, e, H100, **kw)


def _check_landmark_plan(p, B, H, Hkv, D, T, kc, e, density):
    """What every landmark_score plan holds: the ranges partition T, C is
    the most ranges (a power of two, at most 16 in density mode and 64 in
    logits mode, at least 32 keys each where T allows) whose grid the card
    holds in one wave (clusters of C in density mode, single CTAs in logits
    mode); in density mode without landmarks, the most kv-head groups (a
    power of two dividing Hkv) that keep it one wave, one group otherwise,
    and a [B, groups, T] workspace only with more than one; a tile is a multiple of 16
    keys, at most 256 and at most the range rounded up to 16; the stages fit
    shared memory; the range's logits stay in shared memory (``keep``) only
    in density mode, and only where they fit, else a second sweep."""
    C, HG, cap = p.ranges_per_lane, p.head_groups, ls.MAX_CLUSTER if density else ls.MAX_RANGES
    wave = lambda c: RES[c if density else 1]
    assert p.density == density and C in (1, 2, 4, 8, 16, 32, 64) and C <= cap and p.grid == (C, HG, B)
    assert p.cluster == (C if density else 1) and p.ctas == B * C * HG
    assert C == 1 or (T // ls.MIN_KEYS >= C and B * C <= wave(C))
    assert C == cap or T // ls.MIN_KEYS < 2 * C or B * 2 * C > wave(2 * C)
    assert Hkv % HG == 0 and p.parts == (HG > 1)
    if density and not kc:
        assert HG == 1 or B * C * HG <= wave(C)
        assert Hkv % (2 * HG) or B * C * 2 * HG > wave(C)
    else:
        assert HG == 1
    hg = Hkv // HG
    H = hg * (H // Hkv)  # the query heads of one CTA
    assert len(p.ranges) == C
    _assert_partition(p.ranges, T)
    assert p.n_max == max(b - a for a, b in p.ranges) == -(-T // C)
    ck = p.chunk_keys
    assert ck % 16 == 0 and 16 <= ck <= 256 and ck <= -(-p.n_max // 16) * 16
    assert p.n_chunks * ck >= p.n_max > (p.n_chunks - 1) * ck
    assert 1 <= p.stages <= min(ls.MAX_STAGES, p.n_chunks * p.sweeps)
    assert p.stage_bytes == ck * hg * (128 * -(-D // 64) if e == 2 else D * 4)
    assert p.stages * p.stage_bytes < p.smem <= SMEM_LIMIT
    assert not p.keep or density
    if p.keep:  # the range's [H, n] f32 logits beside the ring
        assert H * p.n_max * 4 + p.stages * p.stage_bytes < p.smem
    elif density:  # they would not fit beside one tile even at the smaller budget, in place of a tile's logits
        base = p.smem - p.stages * p.stage_bytes
        assert p.sweeps == 2 and base - H * (ck + 36) * 4 + H * p.n_max * 4 + p.stage_bytes > ls.TWO_PER_SM


@pytest.mark.parametrize("T", T_VALUES)
def test_landmark_score_plan(T):
    for B, H, Hkv, D in SHAPES + FAMILY_SHAPES:
        for e in ELEM_BYTES:
            for kc in (0, 7):
                for density in (False, True):
                    p = ls_plan(B, T, H, Hkv, D, kc, e, density=density)
                    _check_landmark_plan(p, B, H, Hkv, D, T, kc, e, density)


# the density-mode plan never refuses a T: Qwen2.5-0.5B's spawn, zamba2's,
# qwen3-8b's and qwen1.5-110b's heads, up to the reference's long key sets
DENSITY_SHAPES = [(24, 14, 2, 64), (6, 32, 32, 64), (1, 32, 8, 128), (1, 64, 8, 128)]


def test_landmark_density_plan_sweeps_twice_where_logits_do_not_fit():
    """32 query heads of one kv head at T = 32,768: a range of 2048 keys
    holds 256 KB of f32 logits, more than shared memory; the plan sweeps
    the keys twice. With 8 kv heads, a group a kv head keeps them."""
    p = ls_plan(1, 32768, 32, 1, 64, 0, 2, density=True)
    assert p.head_groups == 1 and not p.keep and p.sweeps == 2 and p.smem <= SMEM_LIMIT
    p = ls_plan(1, 32768, 64, 8, 128, 0, 2, density=True)
    assert p.head_groups == 8 and p.keep and p.sweeps == 1


@pytest.mark.parametrize("T", [1, 33, 1024, 5248, 32768])
@pytest.mark.parametrize("shape", DENSITY_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_landmark_density_plan_takes_every_T(shape, T):
    B, H, Hkv, D = shape
    for e in ELEM_BYTES:
        p = ls_plan(B, T, H, Hkv, D, 0, e, density=True)
        _check_landmark_plan(p, B, H, Hkv, D, T, 0, e, True)
        assert p.keep or p.sweeps == 2


def test_plans_at_the_main_path_shapes():
    # spawn: 24 layers x 1 lane, bf16: 8 ranges of 128 keys a lane (192 CTAs,
    # two an SM on part of the card), each range one 32 KB tile; in density
    # mode a lane's 8 CTAs are a cluster and each keeps its 14 x 128 logits
    # in shared memory
    for density in (False, True):
        p = ls_plan(24, 1024, 14, 2, 64, 0, 2, density=density)
        assert p.ranges_per_lane == 8 and p.grid == (8, 1, 24) and p.chunk_keys == 128 and p.stages == 1
        assert p.cluster == (8 if density else 1) and p.keep == density and p.smem <= ls.TWO_PER_SM
        assert p.head_groups == 1  # two groups would take 384 CTAs, more than one wave
    # one lane at T = 4096, Hkv = 8, D = 128, f32: density mode takes 16
    # ranges of 256 keys (the cluster) and a group a kv head (128 CTAs), a
    # tile 64 keys of one kv head (32 KB); logits mode 64 ranges, all kv heads
    # of a 16-key tile (64 KB)
    p = ls_plan(1, 4096, 32, 8, 128, 0, 4, density=True)
    assert p.ranges_per_lane == 16 and p.head_groups == 8 and p.parts and p.chunk_keys == 64 and p.keep
    p = ls_plan(1, 4096, 32, 8, 128, 0, 4)
    assert p.ranges_per_lane == 64 and p.head_groups == 1 and p.chunk_keys == 16 and p.stage_bytes == 65536
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
    # D = 64. Density mode: 16 ranges of 64 keys a lane (the cluster) and two
    # groups of 16 kv heads, 192 CTAs; a 16-key tile of 16 kv heads is 32
    # KB, three in flight. Logits mode: 32 ranges, all 32 kv heads, 192 CTAs,
    # a 64 KB tile each (f32: 128 KB)
    p = ls_plan(6, 1024, 32, 32, 64, 0, 2, density=True)
    assert p.ranges_per_lane == 16 and p.head_groups == 2 and p.grid == (16, 2, 6) and p.chunk_keys == 16
    assert p.stage_bytes == 32768 and p.stages == 3 and p.n_chunks == 4 and p.keep
    p = ls_plan(6, 1024, 32, 32, 64, 0, 2)
    assert p.ranges_per_lane == 32 and p.grid == (32, 1, 6) and p.stages == 1 and p.smem <= ls.TWO_PER_SM
    assert ls_plan(6, 1024, 32, 32, 64, 0, 4, density=True).stages == 1
    # zamba2's side decode: T = K + W + J = 136; 8 lanes x 32 kv heads are
    # 256 CTAs, all the card holds: one range each, G = 1 (one 8-row group
    # of which one row is real), p.V over 4 tiles of 16 columns in 2 slices
    p = sa_plan(8, 136, 32, 32, 64, 2)
    assert p.cluster == 1 and p.grid == (1, 32, 8) and p.slices == 2 and p.n_chunks == 1
    assert sa_plan(8, 136, 32, 32, 64, 4).n_chunks == 2
    # qwen3-moe's spawn: 48 lanes, 4 ranges of 256 keys each (192 CTAs)
    p = ls_plan(48, 1024, 32, 4, 128, 0, 2, density=True)
    assert p.ranges_per_lane == 4 and p.chunk_keys == 32 and p.keep
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
    lambda D, e: ls_plan(1, 8, 4, 2, D, 0, e),
    lambda D, e: ls_plan(1, 8, 4, 2, D, 3, e, density=True),
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
        ls_plan(1, 8, 1024, 2, 64, 0, 4)  # 1024 query rows alone


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


def _split_density(q, k, valid, plan, scale, skip=True):
    """landmark_score's density mode in torch over the plan's CTAs: per
    (lane, key range) a running max m and sum s per head, tile by tile, the
    keys of a tile with no valid key (not loaded where ``skip``) counted at
    NEG_INF before the first tile; per lane M = max_r m_r and S = sum_r
    s_r e^(m_r - M) in range order; per key sum_h e^(l - M_h) / S_h, an
    invalid key's l at NEG_INF, over each kv-head group's heads and then
    over the plan's groups in order."""
    B, H, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    logits = torch.einsum("bkgd,btkd->bkgt", q.reshape(B, Hkv, G, D), k).reshape(B, H, T) * scale
    logits = torch.where(valid[:, None], logits, torch.full_like(logits, ref.NEG_INF))
    ck = plan.chunk_keys
    density = torch.empty((B, T))
    for b in range(B):
        stats = []
        for a, e in plan.ranges:
            tiles = [(t0, min(e, t0 + ck)) for t0 in range(a, e, ck)]
            live = [(t0, t1) for t0, t1 in tiles if not skip or bool(valid[b, t0:t1].any())]
            m = torch.full((H,), ref.NEG_INF)
            s = torch.full((H,), float(sum(t1 - t0 for t0, t1 in tiles) - sum(t1 - t0 for t0, t1 in live)))
            for t0, t1 in live:
                tile = logits[b, :, t0:t1]
                m_new = torch.maximum(m, tile.amax(-1))
                s = s * torch.exp(m - m_new) + torch.exp(tile - m_new[:, None]).sum(-1)
                m = m_new
            stats.append((m, s))
        M = stats[0][0]
        for m, _ in stats[1:]:
            M = torch.maximum(M, m)
        S = torch.zeros(H)
        for m, s in stats:
            S = S + s * torch.exp(m - M)
        # each kv-head group's heads, then the groups' parts in group order
        p = (torch.exp(logits[b] - M[:, None]) / S[:, None]).reshape(plan.head_groups, -1, T)
        density[b] = p.sum(1).sum(0)
    return density


# (B, H, Hkv, D, T): Qwen2.5-0.5B's and zamba2's spawns (two lanes), qwen3-8b's
# heads at long_500k's key set, a ragged G = 3 group, and qwen1.5-110b's heads
# at T = 32,768 (the second sweep)
COMBINE_SHAPES = [(2, 14, 2, 64, 1024), (2, 32, 32, 64, 1024), (1, 32, 8, 128, 5248), (2, 9, 3, 64, 321),
                  (1, 64, 8, 128, 32768)]


def density_case(shape, mask, seed):
    """q, keys (f32, from numpy) and a mask: "prefix" (a river's first
    slots), "random" (about 70 % valid, not a prefix), "invalid_range" (a
    random mask with lane 0's last range of the bf16 density plan all
    invalid), "invalid_lane" (lane 0 with no valid key)."""
    B, H, Hkv, D, T = shape
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.standard_normal((B, H, D), dtype=np.float32))
    k = torch.from_numpy(rng.standard_normal((B, T, Hkv, D), dtype=np.float32))
    if mask == "prefix":
        valid = torch.arange(T)[None, :] < torch.tensor([max(1, T // 5), T // 2 + 3][:B])[:, None]
    else:
        valid = torch.from_numpy(rng.random((B, T)) < 0.7)
        valid[:, 0] = True
    if mask == "invalid_range":
        a, b = ls_plan(B, T, H, Hkv, D, 0, 2, density=True).ranges[-1]
        valid[0, a:b] = False
    elif mask == "invalid_lane":
        valid[0] = False
    return q, k, valid


@pytest.mark.parametrize("mask", ["prefix", "random", "invalid_range", "invalid_lane"])
@pytest.mark.parametrize("shape", COMBINE_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_landmark_density_combine_matches_plain(shape, mask):
    B, H, Hkv, D, T = shape
    q, k, valid = density_case(shape, mask, sum(shape))
    plan = ls_plan(B, T, H, Hkv, D, 0, 2, density=True)
    assert len(plan.ranges) > 1
    scale = 1.0 / D ** 0.5
    got = _split_density(q, k, valid, plan, scale)
    want, _ = ref.landmark_density_ref(q, k, valid, scale=scale)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    if mask == "invalid_range":
        a, b = plan.ranges[-1]
        assert float(got[0, a:b].abs().max()) == 0.0
    if mask == "invalid_lane":
        torch.testing.assert_close(got[0], torch.full((T,), H / T), rtol=1e-6, atol=1e-7)
    else:
        assert float(got[~valid].abs().max()) == 0.0
