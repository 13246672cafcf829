"""The CUDA kernels' launch plans and the cluster's split softmax, on the
CPU.

``landmark_score.launch_plan`` and ``synapse_attention.launch_plan`` are the
pure-Python geometry that the wrappers hand to the card: these tests hold
the same numbers the kernels launch with. The split-softmax test runs the
``synapse_attention`` kernel's arithmetic in torch over the plan's key
ranges (per-range max, sum and partial p.V, combined in rank order)
against the plain version.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import landmark_score as ls
from repro_torch.kernels import ref
from repro_torch.kernels import synapse_attention as sa

SMEM_LIMIT = 232_448
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


def _synapse_shapes(T):
    """SHAPES, and the family shapes where the H x range f32 scores fit
    beside the queries (not H = 64 at T = 4096; see the long-T test)."""
    return SHAPES + [s for s in FAMILY_SHAPES if s[1] * -(-T // 8) < 32 * 1024]


@pytest.mark.parametrize("T", T_VALUES)
def test_synapse_attention_plan(T):
    for B, H, Hkv, D in _synapse_shapes(T):
        for e in ELEM_BYTES:
            p = sa.launch_plan(B, T, H, Hkv, D, e)
            assert p.cluster == min(8, -(-T // 32)) and 1 <= p.cluster <= 8
            assert len(p.ranges) == p.cluster and p.grid == (p.cluster, B)
            _assert_partition(p.ranges, T)
            assert p.n_max == max(b - a for a, b in p.ranges) == -(-T // p.cluster)
            assert 1 <= p.chunk_keys <= p.n_max and p.n_chunks * p.chunk_keys >= p.n_max
            assert (p.n_chunks - 1) * p.chunk_keys < p.n_max
            assert 1 <= p.slices <= 8 and p.slices * Hkv * (D * e // 16) <= max(256, Hkv * (D * e // 16))
            assert p.smem <= SMEM_LIMIT
            assert not p.spill  # these ranges' scores fit in shared memory


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
    # side decode: 8 lanes, T = 144: clusters of 5 CTAs, 40 CTAs, one chunk
    p = sa.launch_plan(8, 144, 14, 2, 64, 2)
    assert p.cluster == 5 and p.grid == (5, 8) and p.n_chunks == 1
    assert p.ranges == ((0, 28), (28, 57), (57, 86), (86, 115), (115, 144))
    # T = 4096, Hkv = 8, D = 128, f32: the ranges stream through the ring
    assert sa.launch_plan(1, 4096, 32, 8, 128, 4).n_chunks > 1


def test_plans_at_the_family_shapes():
    # zamba2's spawn: 6 invocations x 1 parent lane, T = 1024, H = Hkv = 32,
    # D = 64: a key row of 32 kv heads is 4 KB in bf16, so a tile is 32 keys
    # (16 in f32), one bulk copy shorter than the 32-key part; G = 1, so a
    # thread takes one row and the block loops over 1024 (key, kv head)
    # units with 256 threads
    p = ls.launch_plan(6, 1024, 32, 32, 64, 0, 2)
    assert p.block_t == 32 and p.rows == 1 and p.threads == 256 and p.grid == (32, 6)
    assert ls.launch_plan(6, 1024, 32, 32, 64, 0, 4).block_t == 16
    # zamba2's side decode: T = K + W + J = 136; 32 kv heads x 8 chunks fill
    # the 256 threads, so p.V takes one key slice, and the K/V of a range
    # stream through the ring in two chunks
    p = sa.launch_plan(8, 136, 32, 32, 64, 2)
    assert p.cluster == 5 and p.slices == 1 and p.n_chunks == 2 and p.chunk_keys == 24
    assert sa.launch_plan(8, 136, 32, 32, 64, 4).slices == 1
    # qwen3-moe: G = 8, 16-byte chunks of a 256-byte bf16 row: 8 rows a pass
    p = ls.launch_plan(48, 1024, 32, 4, 128, 0, 2)
    assert p.rows == 8 and p.block_t == 64
    assert sa.launch_plan(8, 136, 32, 4, 128, 2).slices == 4
    # qwen2-vl / qwen1.5: H = 64 fits at the side decode's T
    assert sa.launch_plan(8, 136, 64, 8, 128, 4).n_chunks == 3
    # ... and at T = 4096 its 64 heads x 512 keys of f32 scores (128 KB)
    # spill to device memory: the K/V stream through the ring in 26-key chunks
    p = sa.launch_plan(8, 4096, 64, 8, 128, 2)
    assert p.spill and p.cluster == 8 and p.n_max == 512 and p.slices == 1
    assert p.chunk_keys == 26 and p.n_chunks == 20 and p.smem <= SMEM_LIMIT


@pytest.mark.parametrize("plan", [
    lambda D, e: sa.launch_plan(1, 8, 4, 2, D, e),
    lambda D, e: ls.launch_plan(1, 8, 4, 2, D, 0, e),
    lambda D, e: ls.launch_plan(1, 8, 4, 2, D, 3, e),
], ids=["synapse_attention", "landmark_score", "landmark_score_coverage"])
@pytest.mark.parametrize("D,e", [(6, 4), (4, 2), (12, 2)])
def test_plans_refuse_misaligned_rows(plan, D, e):
    with pytest.raises(ValueError, match="not a multiple of 16"):
        plan(D, e)


def test_landmark_plan_refuses_query_rows_that_do_not_fit():
    with pytest.raises(ValueError, match="shared-memory limit"):
        ls.launch_plan(1, 8, 1024, 2, 64, 0, 4)  # 1024 query rows alone


# (B, H, Hkv, D, T) whose ranges' scores do not fit beside the queries: the
# two largest head shapes of the families at long key sets, and the shape
# that the plan refused before the scores could spill
LONG_T = [(8, 64, 8, 128, 4096), (1, 32, 2, 64, 16384), (1, 64, 8, 128, 32768)]


@pytest.mark.parametrize("shape", LONG_T)
@pytest.mark.parametrize("e", ELEM_BYTES)
def test_synapse_plan_spills_long_ranges(shape, e):
    """A range whose H x n_max f32 scores leave no room for K/V takes the
    spilled plan: the same cluster and ranges, scores in a [B, C, H, n_max]
    workspace, and shared memory for the queries, p.V sums and the ring."""
    B, H, Hkv, D, T = shape
    p = sa.launch_plan(B, T, H, Hkv, D, e)
    assert p.spill and p.cluster == 8 and p.grid == (8, B)
    _assert_partition(p.ranges, T)
    assert p.n_max == -(-T // 8) and 1 <= p.chunk_keys <= p.n_max
    assert p.n_chunks * p.chunk_keys >= p.n_max > (p.n_chunks - 1) * p.chunk_keys
    assert p.smem <= SMEM_LIMIT
    # with the scores resident the queries, sums and one key would not fit
    assert p.smem - 2 * p.chunk_keys * Hkv * D * e + H * p.n_max * 4 + 2 * Hkv * D * e > SMEM_LIMIT


def _split_attention(q, k, v, valid, ranges, scale):
    """The kernel's arithmetic over the cluster's ranges, in torch: each
    CTA's m_r, p~ = e^(s - m_r), l_r and o_r = p~ . V; the combine in rank
    order, w_r = e^(m_r - M) / L."""
    B, H, D = q.shape
    Hkv = k.shape[2]
    qg = q.reshape(B, Hkv, H // Hkv, D)
    parts = []
    for a, b in ranges:
        s = torch.einsum("bkgd,btkd->bkgt", qg, k[:, a:b]) * scale
        s = torch.where(valid[:, None, None, a:b], s, torch.full_like(s, ref.NEG_INF))
        m = s.amax(-1)
        p = torch.exp(s - m[..., None])
        parts.append((m, p, p.sum(-1), torch.einsum("bkgt,btkd->bkgd", p, v[:, a:b])))
    M = torch.stack([m for m, _, _, _ in parts]).amax(0)
    L = torch.zeros_like(M)
    for m, _, l, _ in parts:
        L = L + l * torch.exp(m - M)
    out, mass = torch.zeros((B, Hkv, H // Hkv, D)), []
    for m, p, _, o in parts:
        w = torch.exp(m - M) / L
        out = out + o * w[..., None]
        mass.append((p * w[..., None]).sum(dim=(1, 2)))
    return out.reshape(B, H, D), torch.cat(mass, dim=1)


@pytest.mark.parametrize("shape", [(8, 14, 2, 64, 144), (2, 9, 3, 64, 321), (2, 40, 2, 64, 96), (2, 8, 2, 64, 33),
                                   (2, 32, 32, 64, 136), (2, 32, 4, 128, 136), (2, 64, 8, 128, 136),
                                   (1, 64, 8, 128, 4096)])  # the last one's scores spill
@pytest.mark.parametrize("mask", ["random", "invalid_range", "invalid_lane"])
def test_split_softmax_matches_plain(shape, mask):
    B, H, Hkv, D, T = shape
    rng = np.random.default_rng(sum(shape))
    q, k, v = (torch.from_numpy(rng.standard_normal(s, dtype=np.float32))
               for s in ((B, H, D), (B, T, Hkv, D), (B, T, Hkv, D)))
    valid = torch.from_numpy(rng.random((B, T)) < 0.7)
    valid[:, 0] = True
    ranges = sa.launch_plan(B, T, H, Hkv, D, 4).ranges
    if mask == "invalid_range":  # one CTA sees no valid key of lane 0
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
