// Decode attention over a synapse token set, with the per-key attention mass.
//
// Replaces the TPU kernel src/repro/kernels/synapse_attention.py:_kernel
// (grid (B, Hkv)) and its one-program variant :_kernel_batched; one launch
// here covers every lane and kv head.
//
// What it computes, per lane b: the H query rows against T keys. Scores
// q.k are f32, times `scale`; invalid keys take the finite NEG_INF = -1e30
// (kept in f32), so an all-invalid lane gives uniform weights and no NaN.
// Softmax over T, out = p.V in q's dtype, and the mass sum_h p per key,
// written straight into mass [B, T] f32.
//
// What bounds it on the H100: bytes, and at the engine's shapes (B = side
// lanes <= 8, H = 14, Hkv = 2, D = 64, T = 144 in bf16: ~74 KB of K/V per
// lane, ~4 flops per byte) the latency of getting them on chip.
//
// Design: B is small, so the parallelism comes from T. A thread-block
// cluster of C CTAs (grid (C, B), C <= 8 so clusters stay portable) serves
// one lane; CTA r owns the contiguous key range [r*T/C, (r+1)*T/C) for ALL
// H heads, so the mass sum over heads is local. On entry one thread issues
// bulk async copies of q and of the range's K and V slabs (contiguous,
// since keys/values are [B, T, Hkv, D]); K and V pass through a two-stage
// ring on two mbarriers: with the whole range in one chunk, V arrives while
// the scores and the softmax run; a range too big for shared memory streams
// through the ring in chunks, a K pass then a V pass, its scores (H x range
// f32) staying resident. The score loop is landmark_score's (kv_tile.cuh),
// 4 query rows a thread. Each CTA then takes its range's per-head max m_r,
// p~ = e^(s - m_r) in place, l_r = sum p~, and its partial o_r = p~ . V:
// each thread owns (kv head, 16-byte column, key slice) and the slices'
// sums are added in slice order. One exchange through distributed shared
// memory, pushed so that no CTA waits on a remote load: (m_r, l_r) to slot
// r of every peer, and slice j of o_r to slot r of CTA j; one cluster
// barrier; then each CTA combines from its own shared memory, in a fixed
// order: M = max m_r, L = sum_r l_r e^(m_r - M), w_r = e^(m_r - M) / L,
// its slice of out = sum_r w_r o_r, and the mass of its own keys,
// sum_h p~ w_r. A range with no valid key has w_r = e^(-1e30 - M) = 0;
// a lane with none at all gets uniform weights. After that barrier no CTA
// touches a peer's shared memory, so none has to outlive another; the
// barrier that makes sure every peer has started is split, arrive on entry
// and wait before the first push. No atomics and fixed summation orders,
// so results are bitwise repeatable.
//
// Long key sets. A range's scores (H x n_max f32) live in shared memory
// beside the queries while they fit; where they do not (H = 64 heads of
// 128 wide from T ~ 3,300 in bf16, H = 32 of 64 from T ~ 10,000), the
// SPILL instantiation keeps them in a workspace in device memory that the
// wrapper allocates, [B, C, H, n_max] f32, one slab per CTA: the first
// pass writes them there, the softmax rewrites them in place as p~, and
// p.V and the mass read them back, mostly from L2 (the slab is the CTA's
// own; __syncthreads orders a block's global accesses as it does its
// shared ones). The cluster, the ranges, the ring and the combine are the
// same, so the results are as repeatable. Plans whose scores fit do not
// change.
#include <cooperative_groups.h>

#include "kv_tile.cuh"

namespace cg = cooperative_groups;

#define NR 4      // query rows per thread in the score loop
#define NR_PV 8   // query rows per thread in p.V

__device__ __forceinline__ void cluster_arrive_relaxed() {
    asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive() {
    asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
    asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

template <typename T, bool SPILL>
__global__ void __launch_bounds__(THREADS) synapse_attention_kernel(
    const T* __restrict__ q,            // [B, H, D]
    const T* __restrict__ k,            // [B, T, Hkv, D]
    const T* __restrict__ v,            // [B, T, Hkv, D]
    const uint8_t* __restrict__ valid,  // [B, T]
    T* __restrict__ out,                // [B, H, D]
    float* __restrict__ mass,           // [B, T]
    float* __restrict__ ws,             // SPILL: [B, C, H, n_max] scores; else unused
    int Tn, int Hkv, int G, int D, int n_max, int ck, int nk, int S, float scale) {
    constexpr int VEC = Chunk<T>::VEC, NSUB = VEC / 4;
    extern __shared__ __align__(128) unsigned char smem[];
    cg::cluster_group cluster = cg::this_cluster();
    const int C = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
    const int H = Hkv * G, NC = D / VEC, HD = H * D;
    const int head_bytes = D * (int)sizeof(T), row_bytes = Hkv * head_bytes;
    const int b = blockIdx.y, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int r0 = (int)((long)rank * Tn / C), n = (int)((long)(rank + 1) * Tn / C) - r0;
    const int slice = (HD + C - 1) / C;  // outputs each CTA writes

    // layout; launch_plan in synapse_attention.py computes the same bytes
    uint64_t* bars = reinterpret_cast<uint64_t*>(smem);                          // q, ring stage 0, 1
    T* qraw = reinterpret_cast<T*>(smem + 32);                                   // [H, D] as copied
    float* qs = reinterpret_cast<float*>(qraw + HD);                             // [H, D] f32
    // [H, n_max] scores, then p~: here, or this CTA's slab of the workspace
    float* sc = SPILL ? ws + ((size_t)b * C + rank) * H * n_max : qs + HD;
    float* red = qs + HD + (SPILL ? 0 : align16((size_t)H * n_max * 4) / 4);     // [S, H, D] p~.V sums
    float* ml = red + (size_t)S * HD;                                            // [2, H] m_r, l_r
    float* xs = ml + 2 * H;                                                      // [C, 2, H] peers' m, l
    float* w = xs + 2 * C * H;                                                   // [C, H] combine weights
    float* xo = ml + align16((size_t)(2 + 3 * C) * H * 4) / 4;                   // [C, slice] peers' o_r
    uint8_t* vs = reinterpret_cast<uint8_t*>(xo + align16((size_t)C * slice * 4) / 4);  // [n_max] valid
    unsigned char* ring = vs + align16(n_max);                                   // 2 x [ck, Hkv, D]
    const size_t stage_bytes = (size_t)ck * row_bytes;

    const unsigned char* kb = reinterpret_cast<const unsigned char*>(k) + ((size_t)b * Tn + r0) * row_bytes;
    const unsigned char* vb = reinterpret_cast<const unsigned char*>(v) + ((size_t)b * Tn + r0) * row_bytes;
    // load i of 2*nk: K chunks 0..nk-1, then V chunks; stage i & 1
    auto chunk_len = [&](int i) { return max(0, min(ck, n - (i % nk) * ck)); };
    auto issue = [&](int i) {
        const int s = i & 1, len = chunk_len(i);
        if (len > 0)
            bulk_load(ring + s * stage_bytes, (i < nk ? kb : vb) + (size_t)(i % nk) * ck * row_bytes,
                      (uint32_t)len * row_bytes, &bars[1 + s]);
        else
            mbar_arrive(&bars[1 + s]);
    };

    PHASE_MARK(0);
    cluster_arrive_relaxed();  // waited for before the first store to a peer
    if (tid == 0) {
        for (int i = 0; i < 3; ++i) mbar_init(&bars[i], 1);
        fence_mbar_init();
        bulk_load(qraw, q + (size_t)b * HD, (uint32_t)H * head_bytes, &bars[0]);
        issue(0);
        issue(1);
    }
    for (int j = tid; j < n; j += blockDim.x) vs[j] = valid[(size_t)b * Tn + r0 + j];
    __syncthreads();
    mbar_wait(&bars[0], 0);
    to_f32<T>(qraw, HD, qs);
    __syncthreads();

    PHASE_MARK(1);
    // 1. scores of the range: one thread per (key, kv head, NR query rows)
    const int row_groups = (G + NR - 1) / NR;
    for (int i = 0; i < nk; ++i) {
        mbar_wait(&bars[1 + (i & 1)], (i >> 1) & 1);
        const unsigned char* tile = ring + (i & 1) * stage_bytes;
        const int k0 = i * ck, len = chunk_len(i);
        for (int p = tid; p < len * Hkv * row_groups; p += blockDim.x) {
            const int tl = p % len, h = (p / len) % Hkv, g0 = (p / (len * Hkv)) * NR;
            float acc[NR];
            dot_rows<T, NR>(tile + (size_t)tl * row_bytes + (size_t)h * head_bytes, qs, D, h * G + g0,
                            h * G + G - 1, lane, acc);
            const bool ok = vs[k0 + tl] != 0;
#pragma unroll
            for (int g = 0; g < NR; ++g)
                if (g0 + g < G) sc[(size_t)(h * G + g0 + g) * n_max + k0 + tl] = ok ? acc[g] * scale : NEG_INF;
        }
        __syncthreads();
        if (tid == 0 && i + 2 < 2 * nk) issue(i + 2);
    }

    PHASE_MARK(2);
    // 2. per head: m_r, p~ = e^(s - m_r) in place, l_r = sum p~
    for (int row = warp; row < H; row += blockDim.x / 32) {
        float* s = sc + (size_t)row * n_max;
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
            ml[row] = m;
            ml[H + row] = l;
        }
    }
    __syncthreads();

    PHASE_MARK(3);
    // 3. o_r = p~ . V: thread unit (16-byte column c, kv head h, key slice s)
    const int units = NC * Hkv * S;
    for (int i = nk; i < 2 * nk; ++i) {
        mbar_wait(&bars[1 + (i & 1)], (i >> 1) & 1);
        const unsigned char* tile = ring + (i & 1) * stage_bytes;
        const int k0 = (i - nk) * ck, len = chunk_len(i);
        for (int u = tid; u < units; u += blockDim.x) {
            const int c = u % NC, h = (u / NC) % Hkv, s = u / (NC * Hkv);
            for (int g0 = 0; g0 < G; g0 += NR_PV) {
                const int ng = min(NR_PV, G - g0);
                float acc[NR_PV][VEC];
                const float* pr[NR_PV];
                float* dst = red + ((size_t)s * H + h * G + g0) * D + c * VEC;
#pragma unroll
                for (int g = 0; g < NR_PV; ++g) {
                    pr[g] = sc + (size_t)(h * G + min(g0 + g, G - 1)) * n_max + k0;
#pragma unroll
                    for (int e = 0; e < VEC; ++e) acc[g][e] = (i > nk && g < ng) ? dst[(size_t)g * D + e] : 0.f;
                }
                for (int j = s; j < len; j += S) {
                    float vf[VEC];
                    unpack(*reinterpret_cast<const uint4*>(tile + (size_t)j * row_bytes + (size_t)h * head_bytes + c * 16), vf);
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
        if (tid == 0 && i + 2 < 2 * nk) issue(i + 2);
    }

    PHASE_MARK(4);
    // 4. the exchange: slice j of o_r (the slices' sums, in slice order) to
    //    slot `rank` of CTA j, and (m_r, l_r) to slot `rank` of every CTA
    cluster_wait();  // every peer has started
    for (int idx = tid; idx < HD; idx += blockDim.x) {
        float o = red[idx];
#pragma unroll 4
        for (int s = 1; s < S; ++s) o += red[(size_t)s * HD + idx];
        const int j = idx / slice;
        cluster.map_shared_rank(xo, j)[(size_t)rank * slice + idx - j * slice] = o;
    }
    for (int i = tid; i < C * 2 * H; i += blockDim.x)
        cluster.map_shared_rank(xs, i / (2 * H))[(size_t)rank * 2 * H + i % (2 * H)] = ml[i % (2 * H)];
    cluster_arrive();
    cluster_wait();

    PHASE_MARK(5);
    // 5. combine from this CTA's own shared memory, in a fixed order: one
    //    warp per head, lane r holding CTA r's (m_r, l_r)
    for (int row = warp; row < H; row += blockDim.x / 32) {
        const float m = lane < C ? xs[lane * 2 * H + row] : NEG_INF;
        const float M = warp_max(m);  // every lane takes part in the shuffles
        const float e = lane < C ? expf(m - M) : 0.f;
        const float L = warp_sum(lane < C ? xs[lane * 2 * H + H + row] * e : 0.f);
        if (lane < C) w[lane * H + row] = e / L;
    }
    __syncthreads();
    const int lo = rank * slice, hi = min(HD, lo + slice);
    for (int idx = lo + tid; idx < hi; idx += blockDim.x) {
        const int row = idx / D;
        float o = 0.f;
#pragma unroll 8
        for (int r = 0; r < C; ++r) o = fmaf(xo[(size_t)r * slice + idx - lo], w[r * H + row], o);
        out[(size_t)b * HD + idx] = from_f<T>(o);
    }
    for (int j = tid; j < n; j += blockDim.x) {
        float m = 0.f;
#pragma unroll 8
        for (int row = 0; row < H; ++row) m = fmaf(sc[(size_t)row * n_max + j], w[rank * H + row], m);
        mass[(size_t)b * Tn + r0 + j] = m;
    }
    PHASE_MARK(6);
}

// Shared-memory bytes of one CTA; the wrapper's launch plan
// (synapse_attention.py:launch_plan) computes the same sum.
static size_t smem_bytes(int C, int H, int Hkv, int D, int n_max, int ck, int S, int elem, bool spill) {
    const size_t HD = (size_t)H * D, slice = (HD + C - 1) / C;
    return 32 + HD * (elem + 4) + (spill ? 0 : align16((size_t)H * n_max * 4)) + S * HD * 4 +
           align16((size_t)(2 + 3 * C) * H * 4) +
           align16(C * slice * 4) + align16((size_t)n_max) + 2 * (size_t)ck * Hkv * D * elem;
}

template <typename T, bool SPILL>
static int launch(const void* q, const void* k, const void* v, const void* valid, void* out, void* mass,
                  void* ws, int B, int Tn, int Hkv, int G, int D, int C, int n_max, int ck, int nk, int S,
                  int smem, float scale, cudaStream_t stream) {
    static bool smem_set[64] = {};
    if (D % Chunk<T>::VEC || C < 1 || C > 8 || Tn < C || n_max != (Tn + C - 1) / C || ck < 1 || S < 1 ||
        (long)nk * ck < n_max || smem > MAX_SMEM ||
        (size_t)smem != smem_bytes(C, Hkv * G, Hkv, D, n_max, ck, S, (int)sizeof(T), SPILL))
        return (int)cudaErrorInvalidValue;
    auto kern = synapse_attention_kernel<T, SPILL>;
    cudaError_t e = allow_max_smem(kern, smem_set);
    if (e != cudaSuccess) return (int)e;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(C, B);
    cfg.blockDim = dim3(THREADS);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = C;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    e = cudaLaunchKernelEx(&cfg, kern, (const T*)q, (const T*)k, (const T*)v, (const uint8_t*)valid,
                           (T*)out, (float*)mass, (float*)ws, Tn, Hkv, G, D, n_max, ck, nk, S, scale);
    if (e != cudaSuccess) return (int)e;
    return (int)cudaGetLastError();
}

// C (cluster size), n_max, ck (keys per ring chunk), nk (chunks per pass),
// S (key slices of p.V) and smem come from the wrapper's launch plan; ws is
// the plan's [B, C, H, n_max] f32 score workspace where the scores spill,
// and null where they sit in shared memory.
// dtype: 0 = float32, 1 = bfloat16. Returns the launch's error code.
template <typename T>
static int launch_dtype(const void* q, const void* k, const void* v, const void* valid, void* out, void* mass,
                        void* ws, int B, int Tn, int Hkv, int G, int D, int C, int n_max, int ck, int nk, int S,
                        int smem, float scale, cudaStream_t stream) {
    if (ws)
        return launch<T, true>(q, k, v, valid, out, mass, ws, B, Tn, Hkv, G, D, C, n_max, ck, nk, S, smem, scale,
                               stream);
    return launch<T, false>(q, k, v, valid, out, mass, ws, B, Tn, Hkv, G, D, C, n_max, ck, nk, S, smem, scale,
                            stream);
}

extern "C" int synapse_attention_launch(
    const void* q, const void* k, const void* v, const void* valid, void* out, void* mass, void* ws,
    int B, int Tn, int Hkv, int G, int D, int C, int n_max, int ck, int nk, int S, int smem,
    float scale, int dtype, void* stream) {
    if (dtype == 0)
        return launch_dtype<float>(q, k, v, valid, out, mass, ws, B, Tn, Hkv, G, D, C, n_max, ck, nk, S, smem,
                                   scale, (cudaStream_t)stream);
    if (dtype == 1)
        return launch_dtype<__nv_bfloat16>(q, k, v, valid, out, mass, ws, B, Tn, Hkv, G, D, C, n_max, ck, nk, S,
                                           smem, scale, (cudaStream_t)stream);
    return (int)cudaErrorInvalidValue;
}
