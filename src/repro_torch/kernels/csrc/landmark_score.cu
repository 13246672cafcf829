// Hybrid landmark scoring sweep over a KV cache (paper section 3.3).
//
// Replaces the TPU kernel src/repro/kernels/landmark_score.py:_kernel
// (grid (B, T/block_t)) and, in density mode, the valid-masked softmax over
// T and the sum over heads that the reference's wrapper runs after it in
// XLA (src/repro/kernels/ops.py:landmark_score).
//
// What it computes, per lane b, in one of two modes that read the keys once:
// - logits: the per-head density logits q_h . k_t * scale as [B, H, T] f32,
//   head h reading kv head h // G;
// - density: density[b, t] = sum_h softmax over the lane's T of those
//   logits, invalid keys (valid[b, t] false) at the finite NEG_INF = -1e30
//   as in the reference: an invalid key of a lane with a valid key gets
//   exactly 0, a lane with no valid key gets H / T at every key. No
//   [B, H, T] tensor is written.
// In both, when landmarks are given, the coverage distance
//     min_j || mean_kv(k_t) - lm_j || / sqrt(true_d)
// through ||a||^2 + ||b||^2 - 2 a.b clamped at 0, as the TPU kernel does.
//
// What bounds it on the H100: bytes. At a spawn (B = 24 layers x 1 parent
// lane, T = 1024, Hkv = 2, D = 64, bf16) it reads 6.3 MB of keys for ~44
// MFLOP, some 7 flops per byte; logits mode writes 1.4 MB more, density
// mode 98 KB. The phase stamps of the CUDA-core kernel this replaces
// showed the keys' arrival, and then the FMAs after it, taking the time:
// the design keeps bytes in flight from the start and makes the products
// short. What is left after the last tile lands is a first pass through
// the product code, fetched cold after a flushed L2 (the phase stamps in PERF.md): one
// instantiation per dtype and mode keeps the code each launch runs small.
//
// Grid (C, HG, B): one CTA of THREADS threads per (key range r, kv-head
// group, lane b), the lane's T split into C ranges (a power of two: up to
// 16 in density mode, where the C CTAs of a (lane, group) form a
// thread-block cluster, non-portable above 8; up to 64 in logits mode, no
// cluster), its Hkv kv heads into HG groups of hg (HG = 1 in logits mode
// and with landmarks, whose coverage pools all kv heads of a key). The
// launch plan (landmark_score.py:launch_plan) picks C as the most ranges of
// at least 32 keys whose grid the card holds in one wave
// (cudaOccupancyMaxActiveClusters, read once per card), then, in density
// mode, the most groups that still fit it: a lane's softmax needs its
// ranges in one cluster, but each head's softmax is its own, so a lane
// with few ranges (one lane of a long prompt, zamba2's 32 kv heads) still
// fills the card.
//
// Loads: thread 0 issues the queries first (one bulk copy), then a ring
// of tiles of ck keys on mbarriers, each tile one tensor-map box per
// 64 columns (all of D in f32) holding every kv head of the ck keys, from a
// 4-D map (D, T, Hkv, B) whose kv-head axis is outermost in the box: a
// head's keys land as consecutive rows, so with the 128-byte swizzle each
// ldmatrix of 8 consecutive keys is conflict-free. (A box per kv head, or
// one in the cache's own (D, Hkv, T) order, was slower: at zamba2's 32 kv
// heads the first issued 32 boxes a tile, the second put 8 keys of a head
// a multiple of 8 rows apart, one bank group.) The descriptor is
// prefetched first. `stages` tiles are in flight and the next is issued as
// soon as one is consumed, so a tile's loads overlap the previous tile's
// products. A tile is always ck keys: rows past the range are the lane's
// next keys and are not used, rows past its T are the map's zero fill,
// never another lane's rows, so a non-finite key of one lane stays out of
// another. With a mask and no landmarks, a tile with no valid key is not
// loaded at all (early in a river most slots are empty).
//
// bf16 logits on tensor cores (mma.sync.m16n8k16, f32 accumulate): keys
// are M (16 a tile, ldmatrix.x4 from the swizzled tile), a kv head's G
// query rows are N (8 a tile; rows past G read one zero row), D is K in
// steps of 16. bf16 x bf16 products are exact in f32, so only the order of
// summation differs from the reference. f32 logits stay exact FMAs on CUDA
// cores, no TF32 (the kv_tile.cuh loop, NR query rows a thread). Logits
// mode stores each product to device memory from its registers.
//
// The softmax across CTAs (density mode), in a fixed order, no atomics:
// each CTA reduces its keys to (m_h, s_h) per head, max and sum of
// e^(l - m_h), an invalid or unloaded key at NEG_INF; the CTAs of the lane
// push them to each other over distributed shared memory; each combines
// M_h = max_r m_rh and S_h = sum_r s_rh e^(m_rh - M_h) in range order and
// writes sum_h e^(l_ht - M_h) / S_h over its heads for its own keys, `ways`
// threads a key splitting the heads. With kv-head groups each CTA writes
// its group's part to a [B, HG, T] workspace; the CTA of (b, r) that draws
// the last ticket from a counter the wrapper owns sums them in group order
// and resets the counter (the ticket picks who sums, never the order).
// Where the range's [H, n] f32 logits fit in
// shared memory beside the ring (`keep`), they stay there between the two
// steps; else (long key sets) the CTA folds them tile by tile into running
// (m_h, s_h) and a second sweep loads its tiles again and recomputes them,
// so no T the reference computes is refused for its logits. Calls repeat
// bitwise.
#include <type_traits>

#include "hopper.cuh"

#define NR 4           // f32 query rows a thread takes per pass over a key row
#define NL 4           // landmarks a thread takes per pass over a key row
#define MAX_STAGES 8   // ring stages
#define MAX_C 16       // ranges per lane in density mode: the cluster, non-portable above 8
#define MAX_RANGES 64  // ranges per lane in logits mode (no cluster)
#define BAR_BYTES 128  // the mbarriers: one per ring stage, then the queries'

// bytes of one kv head's key in a stage: bf16 in 64-column boxes of 128 bytes, f32 as is
__host__ __device__ __forceinline__ int key_line(int D, int elem) { return elem == 2 ? (D + 63) / 64 * 128 : D * 4; }
// floats between two heads' logits in shared memory: n rounded up to 32, plus 4, so that the
// tensor-core scatter of 8 keys x 4 query rows meets 32 banks
__host__ __device__ __forceinline__ int logit_pitch(int n) { return (n + 31) / 32 * 32 + 4; }

// 16-byte chunk c (of D / VEC) of key `key` of kv head h (of the CTA's hg)
// in a stage of ck keys: one tensor-map box per 64 columns, [hg, ck] rows of
// 128 bytes whose chunks the 128-byte swizzle stores at chunk ^ (key % 8)
// (bf16); one box of [hg, ck] rows of D values (f32).
template <typename T>
__device__ __forceinline__ const unsigned char* chunk_at(const unsigned char* tile, int ck, int hg, int key, int h,
                                                         int c, int D) {
    if constexpr (std::is_same<T, __nv_bfloat16>::value)
        return tile + ((size_t)((c >> 3) * hg + h) * ck + key) * 128 + (((c & 7) ^ (key & 7)) << 4);
    else
        return tile + ((size_t)(h * ck + key) * D + c * 4) * 4;
}

// One instantiation per dtype and mode (logits or density, with or
// without landmarks): each carries only its own path, so that the code a
// launch runs, fetched cold at each spawn, stays small.
template <typename T, bool DENS, bool DIST>
__global__ void __launch_bounds__(THREADS, 2) landmark_score_kernel(
    const __grid_constant__ CUtensorMap tmk,  // keys [B, T, Hkv, D] as 4-D (D, T, Hkv, B), boxes (64 or D, ck, hg, 1)
    const T* __restrict__ q,                  // [B, H, D]
    const T* __restrict__ lm,                 // [B, Kc, D] or null
    const uint8_t* __restrict__ valid,        // [B, T] (density mode) or null: every key valid
    float* __restrict__ logits,               // [B, H, T] in logits mode, else null
    float* __restrict__ density,              // [B, T] in density mode, else null
    float* __restrict__ dist,                 // [B, T] with landmarks, else null
    float* __restrict__ parts,                // [B, HG, T] density of each kv-head group, HG > 1; else null
    int* __restrict__ tickets,                // [B, C], zero between launches, HG > 1; else null
    int Tn, int Hkv, int G, int D, int Kc, int n_max, int ck, int stages, int keep, float scale, float true_d) {
    constexpr bool TC = std::is_same<T, __nv_bfloat16>::value;
    constexpr int VEC = Chunk<T>::VEC;
    extern __shared__ __align__(128) unsigned char smem[];
    // this CTA: key range `rank` of lane b, kv heads [grp hg, (grp + 1) hg), query heads [hq0, hq0 + H)
    const int C = gridDim.x, HG = gridDim.y, rank = blockIdx.x, grp = blockIdx.y, b = blockIdx.z;
    const int hg = Hkv / HG, H = hg * G, hq0 = grp * H, NT = (G + 7) / 8, NC = D / VEC, NW = THREADS / 32;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    constexpr bool dens = DENS, with_dist = DIST;
    const bool masked = DENS && valid != nullptr;  // logits mode takes no mask
    const bool skip = masked && !with_dist;  // tiles with no valid key are not loaded
    const int r0 = (int)((long)rank * Tn / C), n = (int)((long)(rank + 1) * Tn / C) - r0;
    const int nk = (n + ck - 1) / ck, nk_max = (n_max + ck - 1) / ck;
    const int head_bytes = D * (int)sizeof(T), kbox = TC ? (D + 63) / 64 : 1;
    const int P = logit_pitch(keep ? n_max : ck);
    const size_t box_bytes = (size_t)ck * (TC ? 128 : D * 4), stage_bytes = kbox * hg * box_bytes;

    // layout; launch_plan in landmark_score.py computes the same bytes
    unsigned char* ring = smem + ((1024 - (smem_u32(smem) & 1023)) & 1023);  // stages x [kbox, hg, ck, 128 or 4 D], 1 KB aligned
    unsigned char* rest = ring + stages * stage_bytes;
    uint64_t* bars = reinterpret_cast<uint64_t*>(rest);                        // ring stages, then q
    unsigned char* qt = rest + BAR_BYTES;  // [H, D] as copied; bf16: then a row of zeros
    const size_t q_bytes = (size_t)(H + TC) * head_bytes;
    float* lmf = reinterpret_cast<float*>(qt + align16(q_bytes));              // [Kc, D] landmarks in f32
    float* l2 = lmf + (size_t)Kc * D;                                          // [Kc] their squared norms
    float* sc = lmf + align16((size_t)Kc * (D + 1) * 4) / 4;                   // [H, P] logits of the range or tile
    float* ml = sc + align16((size_t)H * P * 4) / 4;                           // [2, H] this range's max and sum
    float* xs = ml + 2 * H;                                                    // [C, 2, H] the ranges' max and sum (density)
    const int Cx = dens ? C : 1;                                               // slots of xs
    float* fin = xs + 2 * Cx * H;                                              // [2, H] the lane's max and 1 / sum
    uint8_t* vs = reinterpret_cast<uint8_t*>(ml + align16((size_t)(4 + 2 * Cx) * H * 4) / 4);  // [n_max] valid
    int* live = reinterpret_cast<int*>(vs + align16((size_t)n_max));  // [nk_max] tiles loaded; n_live, keys skipped, last

    // thread 0: load j of the ring, tile live[j % n_live] (a second sweep
    // takes them again) into stage j % stages, one box per 64 columns
    auto issue = [&](int j, int nl) {
        const int st = j % stages, t0 = r0 + live[j % nl] * ck;
        mbar_expect(&bars[st], (uint32_t)stage_bytes);
        for (int x = 0; x < kbox; ++x)
            tma_load_4d(ring + st * stage_bytes + x * hg * box_bytes, &tmk, x * 64, t0, grp * hg, b, &bars[st]);
    };
    // thread 0: the tiles to load, in order (skipped: those with no valid
    // key), then the first loads
    auto start_loads = [&]() {
        int nl = 0, skipped = 0;
        for (int i = 0; i < nk; ++i) {
            if (!skip || live[i]) live[nl++] = i;
            else skipped += min(ck, n - i * ck);
        }
        live[nk_max] = nl;
        live[nk_max + 1] = skipped;
        for (int j = 0; j < min(stages, nl * (dens && !keep ? 2 : 1)); ++j) issue(j, nl);
    };

    // the logits of keys [0, len) of a loaded tile whose first key is k0 of
    // the range, into dst[(h * G + g) * stride + key]; in density mode an
    // invalid key's at NEG_INF
    auto tile_logits = [&](const unsigned char* tile, int k0, int len, float* dst, size_t stride) {
        if constexpr (TC) {
            // warp unit (16-key tile m, kv head h, 8-row group nt)
            const int mt = (len + 15) / 16;
            const size_t box = (size_t)hg * ck * 128;  // bytes between two 64-column boxes of the stage
            for (int u = warp; u < mt * hg * NT; u += NW) {
                const int m = u % mt, h = (u / mt) % hg, nt = u / (mt * hg);
                // even and odd 16-column steps into two sums: half the dependent chain
                float acc[4] = {0.f, 0.f, 0.f, 0.f}, acc1[4] = {0.f, 0.f, 0.f, 0.f};
                // this lane's ldmatrix rows: key akey of head h (the A tile), query row g (B)
                const int akey = m * 16 + (lane & 7) + ((lane >> 3) & 1) * 8, ac = (lane >> 4) & 1, sw = akey & 7;
                const unsigned char* arow = tile + ((size_t)h * ck + akey) * 128;
                const int g = nt * 8 + (lane & 7);
                const unsigned char* brow = qt + (size_t)(g < G ? h * G + g : H) * head_bytes + ((lane >> 3) & 1) * 16;
                auto a_at = [&](int c) { return arow + (c >> 3) * box + (((c & 7) ^ sw) << 4); };
                int ks = 0;
                for (; ks + 1 < D / 16; ks += 2) {
                    uint32_t a[4], a1[4], bq[2], bq1[2];
                    ldsm_x4(a, a_at(2 * ks + ac));
                    ldsm_x2(bq, brow + ks * 32);
                    ldsm_x4(a1, a_at(2 * ks + 2 + ac));
                    ldsm_x2(bq1, brow + ks * 32 + 32);
                    mma_bf16(acc, a, bq[0], bq[1]);
                    mma_bf16(acc1, a1, bq1[0], bq1[1]);
                }
                if (ks < D / 16) {
                    uint32_t a[4], bq[2];
                    ldsm_x4(a, a_at(2 * ks + ac));
                    ldsm_x2(bq, brow + ks * 32);
                    mma_bf16(acc, a, bq[0], bq[1]);
                }
                // this lane's outputs: keys key0 and key0 + 8, query rows g0 and g0 + 1
                const int key0 = m * 16 + (lane >> 2), g0 = nt * 8 + 2 * (lane & 3);
                float* out = dst + (size_t)(h * G + g0) * stride + key0;
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const int key = key0 + (e >> 1) * 8;
                    if (key < len && g0 + (e & 1) < G)
                        out[(e & 1) * stride + (e >> 1) * 8] =
                            masked && !vs[k0 + key] ? NEG_INF : (acc[e] + acc1[e]) * scale;
                }
            }
        } else {
            // thread unit (key, kv head, NR query rows)
            const float* qs = reinterpret_cast<const float*>(qt);
            const int groups = (G + NR - 1) / NR;
            for (int p = tid; p < len * hg * groups; p += THREADS) {
                const int tl = p % len, h = (p / len) % hg, g0 = (p / (len * hg)) * NR;
                float acc[NR];
                dot_rows<T, NR>(chunk_at<T>(tile, ck, hg, tl, h, 0, D), qs, D, h * G + g0, h * G + G - 1, lane, acc);
                const bool ok = !masked || vs[k0 + tl];
#pragma unroll
                for (int g = 0; g < NR; ++g)
                    if (g0 + g < G) dst[(size_t)(h * G + g0 + g) * stride + tl] = ok ? acc[g] * scale : NEG_INF;
            }
        }
    };

    // coverage: one thread per key, the key pooled over its kv heads (with
    // landmarks a CTA holds all Hkv) chunk by chunk against NL landmarks at a time
    auto coverage = [&](const unsigned char* tile, int k0, int len) {
        for (int tl = tid; tl < len; tl += THREADS) {
            float best = 3.402823466e38f;
            for (int j0 = 0; j0 < Kc; j0 += NL) {
                float cross[NL], k2 = 0.f;
                const float* lr[NL];
#pragma unroll
                for (int g = 0; g < NL; ++g) {
                    cross[g] = 0.f;
                    lr[g] = lmf + (size_t)min(j0 + g, Kc - 1) * D;
                }
                int c = tl % NC;
                for (int i = 0; i < NC; ++i) {
                    float pk[VEC], kv[VEC];
#pragma unroll
                    for (int e = 0; e < VEC; ++e) pk[e] = 0.f;
                    for (int h = 0; h < hg; ++h) {
                        unpack(*reinterpret_cast<const uint4*>(chunk_at<T>(tile, ck, hg, tl, h, c, D)), kv);
#pragma unroll
                        for (int e = 0; e < VEC; ++e) pk[e] += kv[e];
                    }
#pragma unroll
                    for (int e = 0; e < VEC; ++e) {
                        pk[e] = pk[e] / (float)hg;
                        k2 += pk[e] * pk[e];
                    }
#pragma unroll
                    for (int g = 0; g < NL; ++g) dot_chunk<VEC>(lr[g] + c * VEC, pk, cross[g]);
                    if (++c == NC) c = 0;
                }
#pragma unroll
                for (int g = 0; g < NL; ++g)
                    if (j0 + g < Kc) best = fminf(best, fmaxf(k2 + l2[j0 + g] - 2.f * cross[g], 0.f));
            }
            dist[(size_t)b * Tn + r0 + k0 + tl] = sqrtf(best / true_d);
        }
    };

    // the CTA's density of the range's keys: its own with one kv-head
    // group, else its group's part, summed over the groups at the end
    float* dout = HG > 1 ? parts + ((size_t)b * HG + grp) * Tn + r0 : density + (size_t)b * Tn + r0;
    // density of keys [k0, k0 + len) of the range from their logits at
    // src[h * P + key - k0]: sum_h e^(l - M_h) / S_h, an invalid key's l at
    // NEG_INF; `ways` threads a key split the heads and meet by shuffles in
    // a fixed order. Without `all`, the invalid keys are left alone.
    auto put_density = [&](const float* src, int k0, int len, bool all) {
        int ways = 1;
        while (ways < 8 && 2 * ways * len <= THREADS) ways *= 2;
        for (int base = 0; base < len * ways; base += THREADS) {
            const int x = (base + tid) / ways, w = (base + tid) % ways;
            const bool ok = x < len && (!masked || vs[k0 + x]);
            float d = 0.f;
            if (x < len)
                for (int h = w; h < H; h += ways)
                    d += expf((ok ? src[(size_t)h * P + x] : NEG_INF) - fin[h]) * fin[H + h];
            for (int o = ways / 2; o > 0; o >>= 1) d += __shfl_down_sync(0xffffffffu, d, o);
            if (x < len && w == 0 && (ok || all)) dout[k0 + x] = d;
        }
    };

    PHASE_MARK(0);
    if constexpr (DENS) cluster_arrive_relaxed();  // waited for before the first push to a peer
    if (tid == 0) {  // the queries first (one bulk copy), then (without a mask to read first) the key tiles
        prefetch_tensormap(&tmk);
        for (int i = 0; i <= stages; ++i) mbar_init(&bars[i], 1);
        fence_mbar_init();
        bulk_load(qt, q + ((size_t)b * Hkv * G + hq0) * D, (uint32_t)(H * head_bytes), &bars[stages]);
        if (!skip) start_loads();
    }
    if constexpr (TC)  // the zero row the query rows past G of a group read
        for (int i = tid; i < head_bytes / 16; i += THREADS)
            *reinterpret_cast<uint4*>(qt + (size_t)H * head_bytes + i * 16) = make_uint4(0, 0, 0, 0);
    if (masked)
        for (int j = tid; j < n; j += THREADS) vs[j] = valid[(size_t)b * Tn + r0 + j];
    if constexpr (DIST) to_f32<T>(lm + (size_t)b * Kc * D, Kc * D, lmf);
    __syncthreads();
    if (skip) {  // which tiles hold a valid key (warp w takes tiles w, w + NW, ...); then the loads
        for (int i = warp; i < nk; i += NW) {
            bool any = false;
            for (int j = i * ck + lane; j < min(n, (i + 1) * ck); j += 32) any |= vs[j] != 0;
            any = __any_sync(0xffffffffu, any);
            if (lane == 0) live[i] = any;
        }
        __syncthreads();
        if (tid == 0) start_loads();
    }
    if constexpr (DIST) {
        for (int j = tid; j < Kc; j += THREADS) {
            float s = 0.f;
            for (int d = 0; d < D; ++d) s += lmf[(size_t)j * D + d] * lmf[(size_t)j * D + d];
            l2[j] = s;
        }
    }
    __syncthreads();
    const int nl = live[nk_max], total = nl * (dens && !keep ? 2 : 1);
    for (int h = tid; h < H; h += THREADS) {  // the keys not loaded count at NEG_INF
        ml[h] = NEG_INF;
        ml[H + h] = (float)live[nk_max + 1];
    }
    PHASE_MARK(1);
    mbar_wait(&bars[stages], 0);
    PHASE_ONLY(for (int j = 0; j < min(stages, total); ++j) mbar_wait(&bars[j], 0));

    PHASE_MARK(2);
    // 1. the first sweep: logits (and coverage) of every loaded tile, to
    //    device memory (logits mode), kept, or folded tile by tile into a
    //    running max and sum per head (a second sweep to come)
    for (int j = 0; j < nl; ++j) {
        mbar_wait(&bars[j % stages], (j / stages) & 1);
        const unsigned char* tile = ring + (j % stages) * stage_bytes;
        const int k0 = live[j] * ck, len = min(ck, n - k0);
        if constexpr (DENS)
            tile_logits(tile, k0, len, sc + (keep ? k0 : 0), P);
        else
            tile_logits(tile, k0, len, logits + ((size_t)b * Hkv * G + hq0) * Tn + r0 + k0, Tn);
        if constexpr (DIST) coverage(tile, k0, len);
        __syncthreads();  // the stage is consumed
        if (tid == 0 && j + stages < total) issue(j + stages, nl);
        if (dens && !keep) {
            for (int h = warp; h < H; h += NW) {  // one warp a head, the same warp every tile
                const float* s = sc + (size_t)h * P;
                float mt = NEG_INF;
                for (int x = lane; x < len; x += 32) mt = fmaxf(mt, s[x]);
                mt = warp_max(mt);
                const float m_old = ml[h], m_new = fmaxf(m_old, mt);
                float sum = 0.f;
                for (int x = lane; x < len; x += 32) sum += expf(s[x] - m_new);
                sum = warp_sum(sum);
                if (lane == 0) {
                    ml[H + h] = ml[H + h] * expf(m_old - m_new) + sum;
                    ml[h] = m_new;
                }
            }
            __syncthreads();  // read before the next tile's logits land
        }
    }
    if (dens && keep) {  // the max and sum per head over the kept logits, a key not loaded at NEG_INF
        for (int h = warp; h < H; h += NW) {
            const float* s = sc + (size_t)h * P;
            float m = NEG_INF;
            for (int x = lane; x < n; x += 32) m = fmaxf(m, masked && !vs[x] ? NEG_INF : s[x]);
            m = warp_max(m);
            float sum = 0.f;
            for (int x = lane; x < n; x += 32) sum += expf((masked && !vs[x] ? NEG_INF : s[x]) - m);
            sum = warp_sum(sum);
            if (lane == 0) {
                ml[h] = m;
                ml[H + h] = sum;
            }
        }
        __syncthreads();
    }

    PHASE_MARK(3);
    // 2. the exchange: (m_h, s_h) to slot `rank` of every CTA of the lane;
    //    then each combines M_h and S_h from its own shared memory in range order
    if constexpr (DENS) {
        cg::cluster_group cluster = cg::this_cluster();
        cluster_wait();  // every peer has started
        for (int x = tid; x < C * 2 * H; x += THREADS)
            cluster.map_shared_rank(xs, x / (2 * H))[(size_t)rank * 2 * H + x % (2 * H)] = ml[x % (2 * H)];
        cluster_arrive();
        cluster_wait();
        for (int h = tid; h < H; h += THREADS) {
            float M = NEG_INF, S = 0.f;
            for (int r = 0; r < C; ++r) M = fmaxf(M, xs[r * 2 * H + h]);
            for (int r = 0; r < C; ++r) S += xs[r * 2 * H + H + h] * expf(xs[r * 2 * H + h] - M);
            fin[h] = M;
            fin[H + h] = 1.f / S;
        }
        __syncthreads();
    }

    PHASE_MARK(4);
    // 3. density of the range's keys: from the kept logits, or from a second
    //    sweep over the loaded tiles (the invalid keys first, loaded or not)
    if constexpr (DENS) {
        if (keep) {
            put_density(sc, 0, n, true);
        } else {
            if (masked) {
                float d = 0.f;
                for (int h = 0; h < H; ++h) d += expf(NEG_INF - fin[h]) * fin[H + h];
                for (int x = tid; x < n; x += THREADS)
                    if (!vs[x]) dout[x] = d;
            }
            for (int j = nl; j < total; ++j) {
                mbar_wait(&bars[j % stages], (j / stages) & 1);
                const int k0 = live[j - nl] * ck, len = min(ck, n - k0);
                tile_logits(ring + (j % stages) * stage_bytes, k0, len, sc, P);
                __syncthreads();
                if (tid == 0 && j + stages < total) issue(j + stages, nl);
                put_density(sc, k0, len, false);
                __syncthreads();
            }
        }
    }
    // 4. the kv-head groups' parts summed in group order, by the CTA of
    //    (b, r) that draws the last ticket
    if (DENS && HG > 1) {
        __syncthreads();  // the block's parts, then thread 0's release (cumulative over the block)
        if (tid == 0) live[nk_max + 2] = ticket(&tickets[b * C + rank]) == HG - 1;
        __syncthreads();  // thread 0's acquire, then every thread's reads
        if (live[nk_max + 2]) {
            const float* pb = parts + (size_t)b * HG * Tn + r0;
            for (int x = tid; x < n; x += THREADS) {
                float d = 0.f;
                for (int g = 0; g < HG; ++g) d += __ldcg(pb + (size_t)g * Tn + x);
                density[(size_t)b * Tn + r0 + x] = d;
            }
            if (tid == 0) tickets[b * C + rank] = 0;
        }
    }
    PHASE_MARK(5);
}

// Shared-memory bytes of one CTA; the wrapper's launch plan
// (landmark_score.py:launch_plan) computes the same sum.
// H and hg: the query and kv heads of one CTA.
static size_t smem_bytes(int C, int H, int hg, int D, int Kc, int n_max, int ck, int stages, int keep, bool dens,
                         int elem) {
    const int nk_max = (n_max + ck - 1) / ck;
    const size_t q_bytes = (size_t)(H + (elem == 2)) * D * elem;
    return 1024 + (size_t)stages * ck * hg * key_line(D, elem) + BAR_BYTES + align16(q_bytes) +
           align16((size_t)Kc * (D + 1) * 4) + align16((size_t)H * logit_pitch(keep ? n_max : ck) * 4) +
           align16((size_t)(4 + 2 * (dens ? C : 1)) * H * 4) + align16((size_t)n_max) + align16((size_t)(nk_max + 3) * 4);
}

template <typename T>
static int launch(const void* q, const void* k, const void* lm, const void* valid, void* logits, void* density,
                  void* dist, void* parts, void* tickets, int B, int Tn, int Hkv, int G, int D, int Kc, int C, int HG,
                  int n_max, int ck, int stages,
                  int keep, int smem, float scale, float true_d, cudaStream_t stream) {
    static bool allowed[4][64] = {};  // per mode and device
    constexpr bool TC = std::is_same<T, __nv_bfloat16>::value;
    const bool dens = density != nullptr;
    if ((logits == nullptr) == (density == nullptr) || (lm == nullptr) != (dist == nullptr) ||
        (lm ? Kc < 1 : Kc != 0) || (!dens && (valid != nullptr || keep)) || keep < 0 || keep > 1 ||
        D % (TC ? 16 : 4) || (!TC && D > 256) || Hkv < 1 || Hkv > 256 || G < 1 || B < 1 || B > 65535 ||
        HG < 1 || Hkv % HG || (HG > 1 && (!dens || lm || !parts || !tickets)) ||
        C < 1 || C > (dens ? MAX_C : MAX_RANGES) || Tn < C || n_max != (Tn + C - 1) / C || ck < 16 || ck > 256 || ck % 16 ||
        ck > (n_max + 15) / 16 * 16 || stages < 1 || stages > MAX_STAGES || smem > MAX_SMEM ||
        (size_t)smem != smem_bytes(C, Hkv / HG * G, Hkv / HG, D, Kc, n_max, ck, stages, keep, dens, (int)sizeof(T)))
        return (int)cudaErrorInvalidValue;
    CUtensorMap tmk;
    if (!cache_map(&tmk, k, TC, B, Tn, Hkv, D, ck, Hkv / HG, false)) return (int)cudaErrorInvalidValue;
    auto kern = dens ? (lm ? landmark_score_kernel<T, true, true> : landmark_score_kernel<T, true, false>)
                     : (lm ? landmark_score_kernel<T, false, true> : landmark_score_kernel<T, false, false>);
    cudaError_t e = allow_kernel(kern, allowed[2 * dens + (lm != nullptr)]);
    if (e != cudaSuccess) return (int)e;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(C, HG, B);
    cfg.blockDim = dim3(THREADS);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;  // density mode: the ranges of a lane are one cluster
    attr[0].val.clusterDim.x = C;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = dens ? 1 : 0;  // logits mode: no cluster
    e = cudaLaunchKernelEx(&cfg, kern, tmk, (const T*)q, (const T*)lm, (const uint8_t*)valid, (float*)logits,
                           (float*)density, (float*)dist, (float*)parts, (int*)tickets, Tn, Hkv, G, D, Kc, n_max, ck,
                           stages, keep, scale, true_d);
    if (e != cudaSuccess) return (int)e;
    return (int)cudaGetLastError();
}

// Exactly one of logits ([B, H, T] f32: logits mode) and density ([B, T]
// f32: density mode) is given; lm and dist are both null for the
// density-only sweep; valid ([B, T] bool) only in density mode, null for
// every key valid. C (ranges per lane), HG (kv-head groups per lane),
// n_max, ck (keys per tile), stages, keep (the range's logits stay in
// shared memory) and smem come from the wrapper's launch plan; parts ([B,
// HG, T] f32) and tickets ([B, C] int32, zero) are the wrapper's where HG >
// 1, and null otherwise. dtype: 0 = float32, 1 = bfloat16. Returns the
// launch's error code.
extern "C" int landmark_score_launch(
    const void* q, const void* k, const void* lm, const void* valid, void* logits, void* density, void* dist,
    void* parts, void* tickets, int B, int Tn, int Hkv, int G, int D, int Kc, int C, int HG, int n_max, int ck,
    int stages, int keep, int smem, float scale, float true_d, int dtype, void* stream) {
    if (dtype == 0)
        return launch<float>(q, k, lm, valid, logits, density, dist, parts, tickets, B, Tn, Hkv, G, D, Kc, C, HG,
                             n_max, ck, stages, keep, smem, scale, true_d, (cudaStream_t)stream);
    if (dtype == 1)
        return launch<__nv_bfloat16>(q, k, lm, valid, logits, density, dist, parts, tickets, B, Tn, Hkv, G, D, Kc, C,
                                     HG, n_max, ck, stages, keep, smem, scale, true_d, (cudaStream_t)stream);
    return (int)cudaErrorInvalidValue;
}

// How many clusters of C CTAs of `smem` bytes each the current device holds
// at once (cudaOccupancyMaxActiveClusters, for the density-only sweep's
// instantiation), into *n: what the wrapper's
// launch plan sizes its grid by (landmark_score.py:resident_ctas). Returns
// the error code.
extern "C" int landmark_score_resident_clusters(int C, int smem, int dtype, int* n) {
    static bool allowed[2][64] = {};
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(C, 1, 1);
    cfg.blockDim = dim3(THREADS);
    cfg.dynamicSmemBytes = smem;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = C;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    cudaError_t e;
    if (dtype == 0) {
        e = allow_kernel(landmark_score_kernel<float, true, false>, allowed[0]);
        if (e == cudaSuccess) e = cudaOccupancyMaxActiveClusters(n, landmark_score_kernel<float, true, false>, &cfg);
    } else {
        e = allow_kernel(landmark_score_kernel<__nv_bfloat16, true, false>, allowed[1]);
        if (e == cudaSuccess)
            e = cudaOccupancyMaxActiveClusters(n, landmark_score_kernel<__nv_bfloat16, true, false>, &cfg);
    }
    return (int)e;
}
