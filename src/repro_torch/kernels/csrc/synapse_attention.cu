// Decode attention over a synapse token set, with the per-key attention mass.
//
// Replaces the TPU kernel src/repro/kernels/synapse_attention.py:_kernel
// (grid (B, Hkv)) and its one-program variant :_kernel_batched; one launch
// here covers every lane and kv head.
//
// What it computes, per lane b and kv head h: the G = H / Hkv query rows of
// that kv head against its T keys. Scores q.k are f32, times `scale`;
// invalid keys take the finite NEG_INF = -1e30 (kept in f32), so an
// all-invalid lane gives uniform weights and no NaN. Softmax over T,
// out = p.V in q's dtype, and the mass sum_h p per key in mass [B, T] f32.
//
// What bounds it on the H100: bytes. Every K and V row is read once and
// used for G query rows, about 2 G flops per byte: 8 at G = 8, far below
// the ~295 at which the tensor cores would bound it. So the design has to
// keep HBM busy: enough CTAs, enough bytes in flight in each, and nothing
// but K and V crossing device memory in quantity.
//
// Grid (C, Hkv, B): one CTA per (key range r, kv head h, lane b), as the
// reference's grid (B, Hkv) with the key axis split C ways. The C CTAs of
// one (b, h) form a thread-block cluster (non-portable above 8; see 2.
// below for the kv heads joining it). The launch
// plan (synapse_attention.py:launch_plan) picks C, a power of two up to 16,
// as the most ranges of at least 32 keys whose grid the card holds in one
// wave (cudaOccupancyMaxActiveClusters, read once per card): a CTA streams
// its range at a rate its own loop bounds, so a second wave, or a range
// twice as long, costs its whole time again. Where a range's scores and
// ring would not fit in shared memory at that C, it doubles C and takes
// the second wave.
//
// Loads: the Tensor Memory Accelerator. A CTA's keys of one kv head lie
// Hkv * D * e bytes apart in [B, T, Hkv, D]; a 4-D tensor map (D, Hkv, T, B)
// copies a chunk of ck of them (a whole 32 KB stage) with one instruction
// per 64 columns, in bf16 with the 128-byte swizzle, so that each ldmatrix
// of 8 rows is conflict-free. Thread 0 issues the queries first, then the
// stages of a ring of up to eight on mbarriers: K chunks, then V chunks,
// the next load as soon as a stage is consumed, so V arrives while the
// scores and the softmax run. A chunk is always ck rows: the rows past the
// range are the lane's next keys or, past its T, the map's zero fill, and
// get p = 0; a chunk never reads another lane, so a non-finite value there
// (a diverged request) stays out of this lane's p.V. (A bulk copy or
// 16-byte cp.async per row, tried first, kept far fewer bytes in flight
// per SM than one tile per chunk does.)
//
// bf16 on tensor cores (mma.sync.m16n8k16, f32 accumulate). Scores: the
// keys are M (16 a tile, ldmatrix.x4 from the K tile), the G query rows are
// N (8 a tile, zero-padded; ldmatrix.x2), D is K. bf16 x bf16 products are
// exact in f32, so only the summation order differs from the reference.
// p.V: out^T = V^T . p^T, V by ldmatrix.x4.trans, and p, which the
// reference keeps in f32, split as p_hi = bf16(p) and p_lo = bf16(p - p_hi)
// in two products (relative error <= 2^-16). Each warp keeps its (16 d x 8
// g) accumulators in registers over all V chunks; where there are fewer
// such tiles than warps, the warps split the keys into slices, summed in
// slice order at the end. f32 stays on CUDA cores throughout (TF32 would
// not meet the 1e-5 check): the score loop of kv_tile.cuh, 4 query rows a
// thread, and p.V by (16-byte column, key slice) units.
//
// A CTA keeps its G x n_max f32 scores in shared memory (8 x 2048 x 4 = 64
// KB at 8 lanes of H = 64, Hkv = 8, T = 4096, and at one lane of T =
// 32,768; 128 KB at 8 lanes of T = 16,384, 4 ranges), never in device
// memory; the plan refuses a range whose scores and ring do not fit at 16
// ranges (G = 8, D = 128: T above 74,240 in bf16). Per row: m_r = max,
// p~ = e^(s - m_r) in place, l_r = sum p~.
//
// Two reductions across CTAs, each in a fixed order:
// 1. Per (b, h), the softmax over the C ranges, through distributed shared
//    memory: each CTA pushes (m_r, l_r) to slot r of every peer, and slice
//    j of its partial o_r to slot r of CTA j; one cluster barrier (the one
//    that makes sure every peer has started is split: arrive on entry, wait
//    before the first push); then each CTA combines from its own shared
//    memory: M = max m_r, L = sum_r l_r e^(m_r - M), w_r = e^(m_r - M) / L,
//    its slice of out = sum_r w_r o_r, and its keys' mass over its G rows,
//    sum_g p~ w_r. A range with no valid key has w_r = e^(-1e30 - M) = 0; a
//    lane with none at all gets uniform weights.
// 2. Per (b, key), the mass over the Hkv kv heads. Where the plan puts the
//    kv heads of a lane in the cluster too (a cluster of C x Hkv CTAs, at
//    short ranges: the main side decode), each CTA pushes its part to CTA
//    (r, kv head 0), which sums them in kv-head order after a second
//    cluster barrier. Otherwise through a [B, Hkv, T]
//    f32 workspace that the wrapper allocates: each CTA writes its part and,
//    after a block barrier, thread 0 takes a ticket (a fetch-and-add with
//    release and acquire) from a wrapper-owned counter per (b, r);
//    the CTA that draws the last ticket sums the Hkv parts in kv-head order,
//    writes mass and resets the counter. The ticket decides only who sums,
//    never the order, so results are bitwise repeatable. With Hkv = 1 the
//    CTA writes mass directly.
#include <type_traits>

#include "hopper.cuh"

#define NR 4          // query rows per thread in the f32 score loop
#define NR_PV 8       // query rows per thread in the f32 p.V
#define UPW 4         // bf16 p.V: (16 d x 8 g) tiles a warp holds at most
#define MAX_STAGES 8  // ring stages
#define MAX_C 16      // ranges per (b, h): the cluster, non-portable above 8
#define BAR_BYTES 128 // mbarriers (q, then one per ring stage) and, at byte 112, the ticket flag

// Byte address of element (row r, column d) of a bf16 stage: boxes of 64
// columns, ck rows of 128 bytes each, whose 16-byte chunks the tensor map's
// 128-byte swizzle stores at chunk ^ (r % 8).
__device__ __forceinline__ const unsigned char* swz(const unsigned char* tile, int ck, int r, int d) {
    return tile + (size_t)(d >> 6) * ck * 128 + r * 128 + ((((d & 63) >> 3) ^ (r & 7)) << 4);
}
__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 v) { return *reinterpret_cast<uint32_t*>(&v); }

// p = (x, y) as bf16 pairs: hi = bf16(p), lo = bf16(p - hi)
__device__ __forceinline__ void split_hi_lo(float x, float y, uint32_t& hi, uint32_t& lo) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
    const float2 hf = __bfloat1622float2(h);
    hi = bf16x2_bits(h);
    lo = bf16x2_bits(__floats2bfloat162_rn(x - hf.x, y - hf.y));
}

__host__ __device__ __forceinline__ int score_pitch(int n_max) { return (n_max + 31) / 32 * 32 + 8; }
// bytes of one key in a ring stage: bf16 in 64-column boxes of 128 bytes, f32 as is
__host__ __device__ __forceinline__ int stage_row(int D, int elem) { return elem == 2 ? (D + 63) / 64 * 128 : D * 4; }

template <typename T>
__global__ void __launch_bounds__(THREADS, 2) synapse_attention_kernel(
    const __grid_constant__ CUtensorMap tmk,  // keys [B, T, Hkv, D] as 4-D (D, Hkv, T, B), boxes (64 or D, 1, ck, 1)
    const __grid_constant__ CUtensorMap tmv,  // values, the same
    const T* __restrict__ q,            // [B, H, D]
    const uint8_t* __restrict__ valid,  // [B, T]
    T* __restrict__ out,                // [B, H, D]
    float* __restrict__ mass,           // [B, T]
    float* __restrict__ parts,          // [B, Hkv, T] mass per kv head, Hkv > 1; else null
    int* __restrict__ tickets,          // [B, C], zero between launches, Hkv > 1; else null
    int Tn, int Hkv, int G, int D, int n_max, int ck, int nk, int stages, int S, float scale) {
    constexpr bool TC = std::is_same<T, __nv_bfloat16>::value;
    constexpr int VEC = Chunk<T>::VEC, NSUB = VEC / 4;
    extern __shared__ __align__(128) unsigned char smem[];
    cg::cluster_group cluster = cg::this_cluster();
    // the cluster: the C ranges of this (b, h), times HC kv heads (1, or all Hkv)
    const int C = (int)cluster.dim_blocks().x, HC = (int)cluster.dim_blocks().y, rank = blockIdx.x;
    const int yc = blockIdx.y % HC, peer0 = yc * C;  // CTA (r, h)'s cluster rank is r + peer0
    const int h = blockIdx.y, b = blockIdx.z, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int NW = THREADS / 32;
    const int r0 = (int)((long)rank * Tn / C), n = (int)((long)(rank + 1) * Tn / C) - r0;
    const int head_bytes = D * (int)sizeof(T), P = score_pitch(n_max);
    const int qpitch = TC ? head_bytes + 16 : head_bytes;  // bf16 query rows padded: conflict-free ldmatrix
    const int srow = stage_row(D, (int)sizeof(T)), kbox = TC ? (D + 63) / 64 : 1;
    const int NT = (G + 7) / 8, GD = G * D, slice = (GD + C - 1) / C;

    // layout; launch_plan in synapse_attention.py computes the same bytes
    const size_t stage_bytes = (size_t)ck * srow;
    unsigned char* ring = smem + ((1024 - (smem_u32(smem) & 1023)) & 1023);    // stages x [ck, srow], 1 KB aligned
    unsigned char* rest = ring + stages * stage_bytes;
    uint64_t* bars = reinterpret_cast<uint64_t*>(rest);                          // q, ring stages
    int* last = reinterpret_cast<int*>(rest + 112);                              // this CTA sums the mass
    unsigned char* qt = rest + BAR_BYTES;            // bf16: [8 NT, qpitch] rows zero-padded; f32: [G, D]
    const size_t q_bytes = TC ? (size_t)8 * NT * qpitch : (size_t)GD * 4;
    float* sc = reinterpret_cast<float*>(qt + align16(q_bytes));                 // [G, P] scores, then p~
    float* red = sc + align16((size_t)G * P * 4) / 4;                            // [S, G, D] p~.V slices
    float* ml = red + (size_t)S * GD;                                            // [2, G] m_r, l_r
    float* xs = ml + 2 * G;                                                      // [C, 2, G] peers' m, l
    float* w = xs + 2 * C * G;                                                   // [C, G] combine weights
    float* xo = ml + align16((size_t)(2 + 3 * C) * G * 4) / 4;                   // [C, slice] peers' o_r
    uint8_t* vs = reinterpret_cast<uint8_t*>(xo + align16((size_t)C * slice * 4) / 4);  // [n_max] valid
    float* mslot = reinterpret_cast<float*>(vs + align16(n_max));                // HC > 1: [HC, n_max] kv heads' mass

    // load i of 2 nk: K chunks 0..nk-1, then V chunks; stage i % stages. A
    // chunk is always ck rows: rows past the range hold the lane's next keys
    // or, past its T, the map's zero fill (never another lane's), and p is 0
    // there
    auto chunk_len = [&](int i) { return max(0, min(ck, n - (i % nk) * ck)); };
    auto issue = [&](int i) {  // thread 0
        const int st = i % stages;
        unsigned char* dst = ring + st * stage_bytes;
        mbar_expect(&bars[1 + st], (uint32_t)stage_bytes);
        for (int x = 0; x < kbox; ++x)
            tma_load_4d(dst + (size_t)x * ck * 128, i < nk ? &tmk : &tmv, x * 64, h, r0 + (i % nk) * ck, b,
                        &bars[1 + st]);
    };

    PHASE_MARK(0);
    cluster_arrive_relaxed();  // waited for before the first store to a peer
    if (tid == 0) {  // the queries first: the scores wait for them, and for the first K chunk
        for (int i = 0; i <= stages; ++i) mbar_init(&bars[i], 1);
        fence_mbar_init();
        const unsigned char* qg = reinterpret_cast<const unsigned char*>(q + ((size_t)b * Hkv + h) * GD);
        mbar_expect(&bars[0], (uint32_t)GD * sizeof(T));
        if constexpr (TC) {
            for (int g = 0; g < G; ++g) bulk_copy(qt + (size_t)g * qpitch, qg + (size_t)g * head_bytes, head_bytes, &bars[0]);
        } else {
            bulk_copy(qt, qg, (uint32_t)GD * sizeof(T), &bars[0]);
        }
        for (int i = 0; i < stages; ++i) issue(i);
    }
    for (int j = tid; j < n; j += THREADS) vs[j] = valid[(size_t)b * Tn + r0 + j];
    if constexpr (TC) {  // the query rows past G: zeros, so the padded columns of the scores stay finite
        const int nc = head_bytes / 16;
        for (int i = tid; i < (8 * NT - G) * nc; i += THREADS)
            *reinterpret_cast<uint4*>(qt + (size_t)(G + i / nc) * qpitch + (i % nc) * 16) = make_uint4(0, 0, 0, 0);
    }
    __syncthreads();
    mbar_wait(&bars[0], 0);

    PHASE_MARK(1);
    // 1. scores of the range
    for (int i = 0; i < nk; ++i) {
        mbar_wait(&bars[1 + i % stages], (i / stages) & 1);
        const unsigned char* tile = ring + (i % stages) * stage_bytes;
        const int k0 = i * ck, len = chunk_len(i);
        if constexpr (TC) {
            // warp unit (16-key tile m, 8-row group nt): keys as M, query rows as N
            const int mt = (len + 15) / 16;
            for (int u = warp; u < mt * NT; u += NW) {
                const int m = u % mt, nt = u / mt;
                // even and odd 16-column steps into two sums: half the dependent chain
                float acc[4] = {0.f, 0.f, 0.f, 0.f}, acc1[4] = {0.f, 0.f, 0.f, 0.f};
                const int ar = m * 16 + (lane & 7) + ((lane >> 3) & 1) * 8, ad = ((lane >> 4) & 1) * 8;
                const unsigned char* brow = qt + (size_t)(nt * 8 + (lane & 7)) * qpitch + ((lane >> 3) & 1) * 16;
                int ks = 0;
                for (; ks + 1 < D / 16; ks += 2) {
                    uint32_t a[4], a1[4], bq[2], bq1[2];
                    ldsm_x4(a, swz(tile, ck, ar, ks * 16 + ad));
                    ldsm_x2(bq, brow + ks * 32);
                    ldsm_x4(a1, swz(tile, ck, ar, ks * 16 + 16 + ad));
                    ldsm_x2(bq1, brow + ks * 32 + 32);
                    mma_bf16(acc, a, bq[0], bq[1]);
                    mma_bf16(acc1, a1, bq1[0], bq1[1]);
                }
                if (ks < D / 16) {
                    uint32_t a[4], bq[2];
                    ldsm_x4(a, swz(tile, ck, ar, ks * 16 + ad));
                    ldsm_x2(bq, brow + ks * 32);
                    mma_bf16(acc, a, bq[0], bq[1]);
                }
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const int key = m * 16 + (lane >> 2) + (e >> 1) * 8, g = nt * 8 + 2 * (lane & 3) + (e & 1);
                    if (key < len && g < G)
                        sc[(size_t)g * P + k0 + key] = vs[k0 + key] ? (acc[e] + acc1[e]) * scale : NEG_INF;
                }
            }
        } else {
            // thread unit (key, NR query rows)
            const float* qs = reinterpret_cast<const float*>(qt);
            const int row_groups = (G + NR - 1) / NR;
            for (int p = tid; p < len * row_groups; p += THREADS) {
                const int tl = p % len, g0 = (p / len) * NR;
                float acc[NR];
                dot_rows<T, NR>(tile + (size_t)tl * srow, qs, D, g0, G - 1, lane, acc);
                const bool ok = vs[k0 + tl] != 0;
#pragma unroll
                for (int g = 0; g < NR; ++g)
                    if (g0 + g < G) sc[(size_t)(g0 + g) * P + k0 + tl] = ok ? acc[g] * scale : NEG_INF;
            }
        }
        __syncthreads();
        if (tid == 0 && i + stages < 2 * nk) issue(i + stages);
    }

    PHASE_MARK(2);
    // 2. per query row: m_r, p~ = e^(s - m_r) in place, l_r = sum p~
    for (int g = warp; g < G; g += NW) {
        float* s = sc + (size_t)g * P;
        float m = NEG_INF;
        for (int j = lane; j < n; j += 32) m = fmaxf(m, s[j]);
        m = warp_max(m);
        float l = 0.f;
        for (int j = lane; j < n; j += 32) {
            const float e = expf(s[j] - m);
            s[j] = e;
            l += e;
        }
        l = warp_sum(l);
        if (lane == 0) {
            ml[g] = m;
            ml[G + g] = l;
        }
    }
    __syncthreads();

    PHASE_MARK(3);
    // 3. o_r = p~ . V
    if constexpr (TC) {
        // warp unit (16-column tile dt of d, 8-row group nt), accumulated over
        // every V chunk; with fewer units than warps, S warps share a unit and
        // split its 16-key steps
        const int MT = D / 16, U = MT * NT, sl = U >= NW ? 0 : warp / U;
        float acc[UPW][4], acl[UPW][4];  // the p_hi and the p_lo products, summed at the end
#pragma unroll
        for (int x = 0; x < UPW; ++x)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[x][e] = acl[x][e] = 0.f;
        for (int i = nk; i < 2 * nk; ++i) {
            mbar_wait(&bars[1 + i % stages], (i / stages) & 1);
            const unsigned char* tile = ring + (i % stages) * stage_bytes;
            const int k0 = (i - nk) * ck, len = chunk_len(i), kst = (len + 15) / 16;
#pragma unroll
            for (int x = 0; x < UPW; ++x) {
                const int u = U >= NW ? warp + x * NW : (x == 0 && warp < U * S ? warp % U : U);
                if (u >= U) continue;
                const int dt = u % MT, nt = u / MT, g = nt * 8 + (lane >> 2);
                const float* pr = sc + (size_t)min(g, G - 1) * P;
                const int ar = (lane & 7) + ((lane >> 4) & 1) * 8, ad = dt * 16 + ((lane >> 3) & 1) * 8;
                for (int ks = sl; ks < kst; ks += S) {
                    uint32_t a[4];
                    ldsm_x4_trans(a, swz(tile, ck, ks * 16 + ar, ad));
                    const int kk = k0 + ks * 16 + 2 * (lane & 3);
                    float2 p0 = *reinterpret_cast<const float2*>(pr + kk);
                    float2 p1 = *reinterpret_cast<const float2*>(pr + kk + 8);
                    if (g >= G) p0 = p1 = make_float2(0.f, 0.f);
                    if (kk >= n) p0.x = 0.f;
                    if (kk + 1 >= n) p0.y = 0.f;
                    if (kk + 8 >= n) p1.x = 0.f;
                    if (kk + 9 >= n) p1.y = 0.f;
                    uint32_t h0, l0, h1, l1;
                    split_hi_lo(p0.x, p0.y, h0, l0);
                    split_hi_lo(p1.x, p1.y, h1, l1);
                    mma_bf16(acc[x], a, h0, h1);
                    mma_bf16(acl[x], a, l0, l1);
                }
            }
            __syncthreads();
            if (tid == 0 && i + stages < 2 * nk) issue(i + stages);
        }
#pragma unroll
        for (int x = 0; x < UPW; ++x) {
            const int u = U >= NW ? warp + x * NW : (x == 0 && warp < U * S ? warp % U : U);
            if (u >= U) continue;
            const int dt = u % MT, nt = u / MT;
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int d = dt * 16 + (lane >> 2) + (e >> 1) * 8, g = nt * 8 + 2 * (lane & 3) + (e & 1);
                if (g < G) red[((size_t)sl * G + g) * D + d] = acc[x][e] + acl[x][e];
            }
        }
    } else {
        // thread unit (16-byte column c, key slice s), NR_PV rows at a time
        const int NC = D / VEC, units = NC * S;
        for (int i = nk; i < 2 * nk; ++i) {
            mbar_wait(&bars[1 + i % stages], (i / stages) & 1);
            const unsigned char* tile = ring + (i % stages) * stage_bytes;
            const int k0 = (i - nk) * ck, len = chunk_len(i);
            for (int u = tid; u < units; u += THREADS) {
                const int c = u % NC, s = u / NC;
                for (int g0 = 0; g0 < G; g0 += NR_PV) {
                    const int ng = min(NR_PV, G - g0);
                    float acc[NR_PV][VEC];
                    const float* pr[NR_PV];
                    float* dst = red + ((size_t)s * G + g0) * D + c * VEC;
#pragma unroll
                    for (int g = 0; g < NR_PV; ++g) {
                        pr[g] = sc + (size_t)min(g0 + g, G - 1) * P + k0;
#pragma unroll
                        for (int e = 0; e < VEC; ++e) acc[g][e] = (i > nk && g < ng) ? dst[(size_t)g * D + e] : 0.f;
                    }
                    for (int j = s; j < len; j += S) {
                        float vf[VEC];
                        unpack(*reinterpret_cast<const uint4*>(tile + (size_t)j * srow + c * 16), vf);
#pragma unroll
                        for (int g = 0; g < NR_PV; ++g) {
                            const float p = pr[g][j];
#pragma unroll
                            for (int e = 0; e < VEC; ++e) acc[g][e] = fmaf(p, vf[e], acc[g][e]);
                        }
                    }
#pragma unroll
                    for (int g = 0; g < NR_PV; ++g) {
                        if (g < ng) {
#pragma unroll
                            for (int e = 0; e < NSUB; ++e)
                                reinterpret_cast<float4*>(dst + (size_t)g * D)[e] = make_float4(
                                    acc[g][4 * e], acc[g][4 * e + 1], acc[g][4 * e + 2], acc[g][4 * e + 3]);
                        }
                    }
                }
            }
            __syncthreads();
            if (tid == 0 && i + stages < 2 * nk) issue(i + stages);
        }
    }
    __syncthreads();

    PHASE_MARK(4);
    // 4. the exchange: slice j of o_r (the slices' sums, in slice order) to
    //    slot `rank` of CTA j, and (m_r, l_r) to slot `rank` of every CTA
    cluster_wait();  // every peer has started
    for (int idx = tid; idx < GD; idx += THREADS) {
        float o = red[idx];
        for (int s = 1; s < S; ++s) o += red[(size_t)s * GD + idx];
        const int j = idx / slice;
        cluster.map_shared_rank(xo, peer0 + j)[(size_t)rank * slice + idx - j * slice] = o;
    }
    for (int i = tid; i < C * 2 * G; i += THREADS)
        cluster.map_shared_rank(xs, peer0 + i / (2 * G))[(size_t)rank * 2 * G + i % (2 * G)] = ml[i % (2 * G)];
    cluster_arrive();
    cluster_wait();

    PHASE_MARK(5);
    // 5. combine from this CTA's own shared memory, in a fixed order: one
    //    warp per query row, lane r holding CTA r's (m_r, l_r)
    for (int g = warp; g < G; g += NW) {
        const float m = lane < C ? xs[lane * 2 * G + g] : NEG_INF;
        const float M = warp_max(m);  // every lane takes part in the shuffles
        const float e = lane < C ? expf(m - M) : 0.f;
        const float L = warp_sum(lane < C ? xs[lane * 2 * G + G + g] * e : 0.f);
        if (lane < C) w[lane * G + g] = e / L;
    }
    __syncthreads();
    const int lo = rank * slice, hi = min(GD, lo + slice);
    T* ob = out + ((size_t)b * Hkv + h) * GD;
    for (int idx = lo + tid; idx < hi; idx += THREADS) {
        const int g = idx / D;
        float o = 0.f;
        for (int r = 0; r < C; ++r) o = fmaf(xo[(size_t)r * slice + idx - lo], w[r * G + g], o);
        ob[idx] = from_f<T>(o);
    }
    // this kv head's mass of the range: to slot yc of CTA (r, 0) of the
    // cluster, or to the workspace, or (Hkv = 1) to mass itself
    float* dst = HC > 1    ? cluster.map_shared_rank(mslot, rank) + (size_t)yc * n_max
                 : Hkv > 1 ? parts + ((size_t)b * Hkv + h) * Tn + r0
                           : mass + (size_t)b * Tn + r0;
    for (int j = tid; j < n; j += THREADS) {
        float m = 0.f;
        for (int g = 0; g < G; ++g) m = fmaf(sc[(size_t)g * P + j], w[rank * G + g], m);
        dst[j] = m;
    }

    PHASE_MARK(6);
    // 6. the mass over kv heads, summed in kv-head order: with the kv heads
    //    in the cluster by CTA (r, 0) from its slots after a cluster barrier;
    //    else by the CTA that draws the last ticket of (b, r)
    if (HC > 1) {
        cluster_arrive();
        cluster_wait();
        if (yc == 0) {
            for (int j = tid; j < n; j += THREADS) {
                float m = 0.f;
                for (int hh = 0; hh < HC; ++hh) m += mslot[(size_t)hh * n_max + j];
                mass[(size_t)b * Tn + r0 + j] = m;
            }
        }
    } else if (Hkv > 1) {
        __syncthreads();  // the block's parts, then thread 0's release (cumulative over the block)
        if (tid == 0) *last = ticket(&tickets[b * C + rank]) == Hkv - 1;
        __syncthreads();  // thread 0's acquire, then every thread's reads
        if (*last) {
            const float* pb = parts + (size_t)b * Hkv * Tn + r0;
            for (int j = tid; j < n; j += THREADS) {
                float m = 0.f;
                for (int hh = 0; hh < Hkv; ++hh) m += __ldcg(pb + (size_t)hh * Tn + j);
                mass[(size_t)b * Tn + r0 + j] = m;
            }
            if (tid == 0) tickets[b * C + rank] = 0;
        }
    }
    PHASE_MARK(7);
}

// Shared-memory bytes of one CTA; the wrapper's launch plan
// (synapse_attention.py:launch_plan) computes the same sum.
static size_t smem_bytes(int C, int HC, int G, int D, int n_max, int ck, int stages, int S, int elem) {
    const size_t GD = (size_t)G * D, slice = (GD + C - 1) / C;
    const size_t q_bytes = elem == 2 ? (size_t)8 * ((G + 7) / 8) * (D * 2 + 16) : GD * 4;
    return 1024 + (size_t)stages * ck * stage_row(D, elem) + BAR_BYTES + align16(q_bytes) +
           align16((size_t)G * score_pitch(n_max) * 4) + S * GD * 4 + align16((size_t)(2 + 3 * C) * G * 4) +
           align16(C * slice * 4) + align16((size_t)n_max) + (HC > 1 ? align16((size_t)HC * n_max * 4) : 0);
}

template <typename T>
static int launch(const void* q, const void* k, const void* v, const void* valid, void* out, void* mass,
                  void* parts, void* tickets, int B, int Tn, int Hkv, int G, int D, int C, int HC, int n_max,
                  int ck, int nk, int stages, int S, int smem, float scale, cudaStream_t stream) {
    static bool allowed[64] = {};
    constexpr bool TC = std::is_same<T, __nv_bfloat16>::value;
    const int MT = D / 16, U = MT * ((G + 7) / 8);
    if (D % (TC ? 16 : Chunk<T>::VEC) || (!TC && D > 256) || ck > 256 || G < 1 || C < 1 || C > MAX_C || Tn < C || n_max != (Tn + C - 1) / C ||
        ck < 1 || (TC && ck % 16) || (long)nk * ck < n_max || (long)(nk - 1) * ck >= n_max || stages < 1 ||
        stages > MAX_STAGES || stages > 2 * nk || S < 1 || (TC && (U > UPW * THREADS / 32 || S != (U >= THREADS / 32 ? 1 : THREADS / 32 / U))) ||
        (HC != 1 && HC != Hkv) || C * HC > MAX_C || (Hkv > 1 && HC == 1 && (!parts || !tickets)) ||
        smem > MAX_SMEM || (size_t)smem != smem_bytes(C, HC, G, D, n_max, ck, stages, S, (int)sizeof(T)))
        return (int)cudaErrorInvalidValue;
    CUtensorMap tmk, tmv;
    if (!cache_map(&tmk, k, TC, B, Tn, Hkv, D, ck, 1, true) || !cache_map(&tmv, v, TC, B, Tn, Hkv, D, ck, 1, true))
        return (int)cudaErrorInvalidValue;
    auto kern = synapse_attention_kernel<T>;
    cudaError_t e = allow_kernel(kern, allowed);
    if (e != cudaSuccess) return (int)e;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(C, Hkv, B);
    cfg.blockDim = dim3(THREADS);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = C;
    attr[0].val.clusterDim.y = HC;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    e = cudaLaunchKernelEx(&cfg, kern, tmk, tmv, (const T*)q, (const uint8_t*)valid, (T*)out,
                           (float*)mass, (float*)parts, (int*)tickets, Tn, Hkv, G, D, n_max, ck, nk, stages, S,
                           scale);
    if (e != cudaSuccess) return (int)e;
    return (int)cudaGetLastError();
}

// C (ranges per (b, h)), HC (kv heads per cluster: 1 or Hkv), n_max, ck
// (keys per ring stage), nk (chunks per pass), stages, S (key slices of
// p.V) and smem come from the wrapper's launch plan; parts ([B, Hkv, T]
// f32) and tickets ([B, C] int32, zero) are the wrapper's where Hkv > 1
// and HC = 1, and null otherwise.
// dtype: 0 = float32, 1 = bfloat16. Returns the launch's error code.
extern "C" int synapse_attention_launch(
    const void* q, const void* k, const void* v, const void* valid, void* out, void* mass, void* parts,
    void* tickets, int B, int Tn, int Hkv, int G, int D, int C, int HC, int n_max, int ck, int nk, int stages,
    int S, int smem, float scale, int dtype, void* stream) {
    if (dtype == 0)
        return launch<float>(q, k, v, valid, out, mass, parts, tickets, B, Tn, Hkv, G, D, C, HC, n_max, ck, nk,
                             stages, S, smem, scale, (cudaStream_t)stream);
    if (dtype == 1)
        return launch<__nv_bfloat16>(q, k, v, valid, out, mass, parts, tickets, B, Tn, Hkv, G, D, C, HC, n_max, ck,
                                     nk, stages, S, smem, scale, (cudaStream_t)stream);
    return (int)cudaErrorInvalidValue;
}


// How many clusters of C x HC CTAs of `smem` bytes each the current device
// holds at once (cudaOccupancyMaxActiveClusters), into *n: what the
// wrapper's launch plan sizes its grid by (synapse_attention.py:
// resident_ctas). Returns the error code.
extern "C" int synapse_attention_resident_clusters(int C, int HC, int smem, int dtype, int* n) {
    static bool allowed[2][64] = {};
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(C, HC, 1);
    cfg.blockDim = dim3(THREADS);
    cfg.dynamicSmemBytes = smem;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = C;
    attr[0].val.clusterDim.y = HC;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    cudaError_t e;
    if (dtype == 0) {
        e = allow_kernel(synapse_attention_kernel<float>, allowed[0]);
        if (e == cudaSuccess) e = cudaOccupancyMaxActiveClusters(n, synapse_attention_kernel<float>, &cfg);
    } else {
        e = allow_kernel(synapse_attention_kernel<__nv_bfloat16>, allowed[1]);
        if (e == cudaSuccess) e = cudaOccupancyMaxActiveClusters(n, synapse_attention_kernel<__nv_bfloat16>, &cfg);
    }
    return (int)e;
}
