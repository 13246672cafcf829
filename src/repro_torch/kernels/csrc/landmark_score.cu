// Hybrid landmark scoring sweep over a KV cache (paper section 3.3).
//
// Replaces the TPU kernel src/repro/kernels/landmark_score.py:_kernel
// (grid (B, T/block_t)).
//
// What it computes, per key tile: the per-head density logits
// q_h . k_t * scale as [H, blk_t] f32, head h reading kv head h // G; and,
// when landmarks are given, the coverage distance
//     min_j || mean_kv(k_t) - lm_j || / sqrt(true_d)
// through ||a||^2 + ||b||^2 - 2 a.b clamped at 0, as the TPU kernel does.
// Without landmarks the coverage pass is skipped. The valid-masked softmax
// over T and the sum over heads stay in the wrapper.
//
// What bounds it on the H100: bytes. At a spawn (B = 24 layers x 1 parent
// lane, T = 1024, Hkv = 2, D = 64, bf16) it reads ~6.3 MB of keys and
// writes ~1.4 MB of logits for ~44 MFLOP, some 6 flops per byte.
//
// Design: one block per (tile of blk_t keys, b), one thread per (key, kv
// head, NR query rows) up to 256; blk_t = 64 (the wrapper's launch plan
// takes fewer where a tile would not fit). One thread issues every copy as
// soon as the mbarriers exist: q (and the landmarks) first, then the tile
// keys[b, t0:t0+blk_t] -- one contiguous slab -- as bulk copies of 32-key
// parts on their own mbarriers (the ragged last tile copies only its
// rows); each warp waits only for the part that holds its keys. 32
// consecutive keys of one kv head share a warp: a thread reads its key row
// with the staggered, rotated chunk loop of kv_tile.cuh, and the q rows it
// reads are broadcasts across the warp. NR, the query rows a thread takes
// per pass, comes from the launch plan (1, 2, 4, 7 or 8: no more rows than
// G needs, 8 at a time beyond), so no row is computed twice at the main
// shape (G = 7). The time goes on the keys' arrival and
// on the FMAs after it: small 64-key tiles and one key per thread keep the
// work that is left once the last part lands short. For each g the warp
// stores 32 consecutive logits, one coalesced 128-byte row. The coverage
// pass takes one thread per key and pools over Hkv from the same tile.
// Fixed summation order, no atomics.
#include "kv_tile.cuh"

#define PART 32        // keys per bulk copy and mbarrier
#define BAR_BYTES 80   // the mbarriers: q and landmarks, then one per part of blk_t <= 8 * PART
#define MAX_NR 8       // query rows (or landmarks) a thread takes per pass, at most

template <typename T, int NR>
__global__ void __launch_bounds__(THREADS) landmark_score_kernel(
    const T* __restrict__ q,      // [B, H, D]
    const T* __restrict__ k,      // [B, T, Hkv, D]
    const T* __restrict__ lm,     // [B, Kc, D] or null
    float* __restrict__ logits,   // [B, H, T]
    float* __restrict__ dist,     // [B, T] or null
    int Tn, int Hkv, int G, int D, int Kc, int blk_t, float scale, float true_d) {
    constexpr int VEC = Chunk<T>::VEC;
    extern __shared__ __align__(128) unsigned char smem[];
    const int H = Hkv * G, NC = D / VEC;
    const int head_bytes = D * (int)sizeof(T), row_bytes = Hkv * head_bytes;
    uint64_t* bars = reinterpret_cast<uint64_t*>(smem);                      // [0]: q, landmarks; [1 + i]: part i
    unsigned char* tile = smem + BAR_BYTES;                                   // [blk_t, Hkv, D] input dtype
    T* qraw = reinterpret_cast<T*>(tile + (size_t)blk_t * row_bytes);        // [H, D] as copied
    T* lraw = qraw + (size_t)H * D;                                           // [Kc, D] as copied
    float* qs = reinterpret_cast<float*>(lraw + (size_t)Kc * D);             // [H, D] f32
    float* ls = qs + (size_t)H * D;                                           // [Kc, D] f32
    float* l2 = ls + (size_t)Kc * D;                                          // [Kc]

    const int b = blockIdx.y, t0 = blockIdx.x * blk_t;
    const int tid = threadIdx.x, lane = tid & 31;
    const int nt = min(blk_t, Tn - t0), nparts = (nt + PART - 1) / PART;
    const bool with_dist = lm != nullptr;

    PHASE_MARK(0);
    if (tid == 0) {
        for (int i = 0; i <= nparts; ++i) mbar_init(&bars[i], 1);
        fence_mbar_init();
        mbar_expect(&bars[0], (uint32_t)(H + Kc) * head_bytes);
        bulk_copy(qraw, q + (size_t)b * H * D, (uint32_t)H * head_bytes, &bars[0]);
        if (with_dist) bulk_copy(lraw, lm + (size_t)b * Kc * D, (uint32_t)Kc * head_bytes, &bars[0]);
        const unsigned char* src = reinterpret_cast<const unsigned char*>(k) + ((size_t)b * Tn + t0) * row_bytes;
        for (int i = 0; i < nparts; ++i)
            bulk_load(tile + (size_t)i * PART * row_bytes, src + (size_t)i * PART * row_bytes,
                      (uint32_t)min(PART, nt - i * PART) * row_bytes, &bars[1 + i]);
    }
    __syncthreads();
    mbar_wait(&bars[0], 0);
    to_f32<T>(qraw, (H + Kc) * D, qs);  // q and the landmarks lie back to back in both
    __syncthreads();
    if (with_dist) {
        for (int j = tid; j < Kc; j += blockDim.x) {
            float s = 0.f;
            for (int d = 0; d < D; ++d) s += ls[(size_t)j * D + d] * ls[(size_t)j * D + d];
            l2[j] = s;
        }
    }

    PHASE_MARK(1);
    PHASE_ONLY(for (int i = 0; i < nparts; ++i) mbar_wait(&bars[1 + i], 0));
    PHASE_MARK(2);
    // density logits: one thread per (key, kv head, NR query rows)
    for (int p = tid; p < blk_t * Hkv * ((G + NR - 1) / NR); p += blockDim.x) {
        const int tl = p % blk_t, h = (p / blk_t) % Hkv, g0 = (p / (blk_t * Hkv)) * NR;
        if (tl >= nt) continue;
        mbar_wait(&bars[1 + tl / PART], 0);
        float acc[NR];
        dot_rows<T, NR>(tile + (size_t)tl * row_bytes + (size_t)h * head_bytes, qs, D, h * G + g0, h * G + G - 1,
                        lane, acc);
        float* out = logits + ((size_t)b * H + h * G + g0) * Tn + t0 + tl;
#pragma unroll
        for (int g = 0; g < NR; ++g)
            if (g0 + g < G) out[(size_t)g * Tn] = acc[g] * scale;
    }
    PHASE_MARK(3);
    if (!with_dist) return;
    __syncthreads();  // l2 is ready

    // coverage: one thread per key, the pooled key rebuilt chunk by chunk
    for (int tl = tid; tl < nt; tl += blockDim.x) {
        mbar_wait(&bars[1 + tl / PART], 0);
        const unsigned char* krow = tile + (size_t)tl * row_bytes;
        float best = 3.402823466e38f;
        for (int j0 = 0; j0 < Kc; j0 += NR) {
            float cross[NR], k2 = 0.f;
            const float* lr[NR];
#pragma unroll
            for (int g = 0; g < NR; ++g) {
                cross[g] = 0.f;
                lr[g] = ls + (size_t)min(j0 + g, Kc - 1) * D;
            }
            int c = lane % NC;
            for (int i = 0; i < NC; ++i) {
                float pk[VEC], kv[VEC];
#pragma unroll
                for (int e = 0; e < VEC; ++e) pk[e] = 0.f;
                for (int h = 0; h < Hkv; ++h) {
                    unpack(*reinterpret_cast<const uint4*>(krow + h * head_bytes + c * 16), kv);
#pragma unroll
                    for (int e = 0; e < VEC; ++e) pk[e] += kv[e];
                }
#pragma unroll
                for (int e = 0; e < VEC; ++e) {
                    pk[e] = pk[e] / (float)Hkv;
                    k2 += pk[e] * pk[e];
                }
#pragma unroll
                for (int g = 0; g < NR; ++g) dot_chunk<VEC>(lr[g] + c * VEC, pk, cross[g]);
                if (++c == NC) c = 0;
            }
#pragma unroll
            for (int g = 0; g < NR; ++g)
                if (j0 + g < Kc) best = fminf(best, fmaxf(k2 + l2[j0 + g] - 2.f * cross[g], 0.f));
        }
        dist[(size_t)b * Tn + t0 + tl] = sqrtf(best / true_d);
    }
}

// Shared-memory bytes of one block; the wrapper's launch plan
// (landmark_score.py:launch_plan) computes the same sum.
static size_t smem_bytes(int H, int Hkv, int D, int Kc, int blk_t, int elem) {
    return BAR_BYTES + (size_t)blk_t * Hkv * D * elem + (size_t)(H + Kc) * D * (elem + 4) + align16((size_t)Kc * 4);
}

template <typename T>
static int launch(const void* q, const void* k, const void* lm, void* logits, void* dist,
                  int B, int Tn, int Hkv, int G, int D, int Kc, int blk_t, int nr, int threads, int smem,
                  float scale, float true_d, cudaStream_t stream) {
    static bool smem_set[MAX_NR + 1][64] = {};  // per instantiation and device
    const int kc = lm ? Kc : 0;
    if (D % Chunk<T>::VEC || blk_t < 1 || blk_t > 8 * PART || Tn < 1 || smem > MAX_SMEM ||
        threads < 32 || threads > THREADS || threads % 32 ||
        (size_t)smem != smem_bytes(Hkv * G, Hkv, D, kc, blk_t, (int)sizeof(T)))
        return (int)cudaErrorInvalidValue;
    auto kern = nr == 1 ? landmark_score_kernel<T, 1> : nr == 2 ? landmark_score_kernel<T, 2>
              : nr == 4 ? landmark_score_kernel<T, 4> : nr == 7 ? landmark_score_kernel<T, 7>
              : nr == MAX_NR ? landmark_score_kernel<T, MAX_NR> : nullptr;
    if (kern == nullptr) return (int)cudaErrorInvalidValue;
    cudaError_t e = allow_max_smem(kern, smem_set[nr]);
    if (e != cudaSuccess) return (int)e;
    dim3 grid((Tn + blk_t - 1) / blk_t, B);
    kern<<<grid, threads, smem, stream>>>(
        (const T*)q, (const T*)k, (const T*)lm, (float*)logits, (float*)dist,
        Tn, Hkv, G, D, kc, blk_t, scale, true_d);
    return (int)cudaGetLastError();
}

// lm and dist are null for the density-only sweep. blk_t, nr, threads and
// smem come from the wrapper's launch plan. dtype: 0 = float32, 1 = bfloat16. Returns
// cudaGetLastError() of the launch.
extern "C" int landmark_score_launch(
    const void* q, const void* k, const void* lm, void* logits, void* dist,
    int B, int Tn, int Hkv, int G, int D, int Kc, int blk_t, int nr, int threads, int smem,
    float scale, float true_d, int dtype, void* stream) {
    if ((lm == nullptr) != (dist == nullptr)) return (int)cudaErrorInvalidValue;
    if (dtype == 0)
        return launch<float>(q, k, lm, logits, dist, B, Tn, Hkv, G, D, Kc, blk_t, nr, threads, smem, scale, true_d,
                             (cudaStream_t)stream);
    if (dtype == 1)
        return launch<__nv_bfloat16>(q, k, lm, logits, dist, B, Tn, Hkv, G, D, Kc, blk_t, nr, threads, smem, scale, true_d,
                                     (cudaStream_t)stream);
    return (int)cudaErrorInvalidValue;
}
