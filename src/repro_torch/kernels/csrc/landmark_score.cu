// Hybrid landmark scoring sweep over a KV cache (paper section 3.3).
//
// Replaces the TPU kernel src/repro/kernels/landmark_score.py:_kernel
// (grid (B, T/block_t)).
//
// What it computes, per key block: the per-head density logits
// q_h . k_t * scale as [H, blkT] f32, head h reading kv head h // G; and,
// when landmarks are given, the coverage distance
//     min_j || mean_kv(k_t) - lm_j || / sqrt(true_d)
// through ||a||^2 + ||b||^2 - 2 a.b clamped at 0, as the TPU kernel does.
// Without landmarks the coverage block is skipped. The valid-masked softmax
// over T and the sum over heads stay in the wrapper.
//
// What bounds it on the H100: bytes. At a spawn (B = 24 layers x 1 parent
// lane, T = 1024, Hkv = 2, D = 64, bf16) it reads ~6.3 MB of keys and
// writes ~1.4 MB of logits for ~44 MFLOP, some 6 flops per byte.
//
// Design: one block per (b, block of 64 keys); the grid spreads the T axis
// over the SMs, since B is small at a spawn. The queries (and landmarks)
// are staged once per block in shared memory as f32. One warp per (key,
// kv head) pair reads that key's D contiguous values (coalesced, D masked)
// and reduces the G dot products with shuffles; the coverage pass takes one
// warp per key. Sums run in a fixed order; no atomics.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#define MAX_G 16  // query rows held in registers at a time; G is any
#define BLK_T 64
#define THREADS 256

template <typename T> __device__ __forceinline__ float to_f(T x);
template <> __device__ __forceinline__ float to_f<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    return v;
}

template <typename T>
__global__ void __launch_bounds__(THREADS) landmark_score_kernel(
    const T* __restrict__ q,      // [B, H, D]
    const T* __restrict__ k,      // [B, T, Hkv, D]
    const T* __restrict__ lm,     // [B, Kc, D] or null
    float* __restrict__ logits,   // [B, H, T]
    float* __restrict__ dist,     // [B, T] or null
    int Tn, int Hkv, int G, int D, int Kc, float scale, float true_d) {
    extern __shared__ float smem[];
    const int H = Hkv * G;
    float* qs = smem;                 // [H, D]
    float* ls = smem + H * D;         // [Kc, D]
    float* l2 = ls + Kc * D;          // [Kc]

    const int b = blockIdx.y, t0 = blockIdx.x * BLK_T;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int nwarps = blockDim.x >> 5;
    const bool with_dist = lm != nullptr;
    const long kv_row = (long)Hkv * D;
    const T* kb = k + (long)b * Tn * kv_row;

    for (int i = tid; i < H * D; i += blockDim.x) qs[i] = to_f(q[(long)b * H * D + i]);
    if (with_dist) {
        for (int i = tid; i < Kc * D; i += blockDim.x) ls[i] = to_f(lm[(long)b * Kc * D + i]);
    }
    __syncthreads();
    if (with_dist) {
        for (int j = warp; j < Kc; j += nwarps) {
            float s = 0.f;
            for (int d = lane; d < D; d += 32) s += ls[j * D + d] * ls[j * D + d];
            s = warp_sum(s);
            if (lane == 0) l2[j] = s;
        }
    }

    // density logits: one warp per (key, kv head)
    const int nt = min(BLK_T, Tn - t0);
    for (int p = warp; p < nt * Hkv; p += nwarps) {
        const int t = t0 + p / Hkv, h = p % Hkv;
        const T* kr = kb + (long)t * kv_row + (long)h * D;
        for (int g0 = 0; g0 < G; g0 += MAX_G) {
            float acc[MAX_G];
#pragma unroll
            for (int g = 0; g < MAX_G; ++g) acc[g] = 0.f;
            for (int d = lane; d < D; d += 32) {
                const float kd = to_f(kr[d]);
#pragma unroll
                for (int g = 0; g < MAX_G; ++g)
                    if (g0 + g < G) acc[g] += qs[(h * G + g0 + g) * D + d] * kd;
            }
#pragma unroll
            for (int g = 0; g < MAX_G; ++g) {
                if (g0 + g < G) {
                    const float s = warp_sum(acc[g]);
                    if (lane == 0) logits[((long)b * H + h * G + g0 + g) * Tn + t] = s * scale;
                }
            }
        }
    }
    if (!with_dist) return;
    __syncthreads();  // l2 is ready

    // coverage: one warp per key; pooled key held spread over the lanes
    for (int i = warp; i < nt; i += nwarps) {
        const int t = t0 + i;
        const T* kr = kb + (long)t * kv_row;
        float k2 = 0.f;
        for (int d = lane; d < D; d += 32) {
            float s = 0.f;
            for (int h = 0; h < Hkv; ++h) s += to_f(kr[(long)h * D + d]);
            const float pd = s / (float)Hkv;
            k2 += pd * pd;
        }
        k2 = warp_sum(k2);
        float best = 3.402823466e38f;
        for (int j = 0; j < Kc; ++j) {
            float cross = 0.f;
            for (int d = lane; d < D; d += 32) {
                float s = 0.f;
                for (int h = 0; h < Hkv; ++h) s += to_f(kr[(long)h * D + d]);
                cross += (s / (float)Hkv) * ls[j * D + d];
            }
            cross = warp_sum(cross);
            best = fminf(best, fmaxf(k2 + l2[j] - 2.f * cross, 0.f));
        }
        if (lane == 0) dist[(long)b * Tn + t] = sqrtf(best / true_d);
    }
}

template <typename T>
static int launch(const void* q, const void* k, const void* lm, void* logits, void* dist,
                  int B, int Tn, int Hkv, int G, int D, int Kc, float scale, float true_d,
                  cudaStream_t stream) {
    const int H = Hkv * G;
    const size_t smem = sizeof(float) * ((size_t)H * D + (lm ? (size_t)Kc * (D + 1) : 0));
    auto kern = landmark_score_kernel<T>;
    if (smem > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    dim3 grid((Tn + BLK_T - 1) / BLK_T, B);
    kern<<<grid, THREADS, smem, stream>>>(
        (const T*)q, (const T*)k, (const T*)lm, (float*)logits, (float*)dist,
        Tn, Hkv, G, D, lm ? Kc : 0, scale, true_d);
    return (int)cudaGetLastError();
}

// lm and dist are null for the density-only sweep. dtype: 0 = float32,
// 1 = bfloat16. Returns cudaGetLastError() of the launch.
extern "C" int landmark_score_launch(
    const void* q, const void* k, const void* lm, void* logits, void* dist,
    int B, int Tn, int Hkv, int G, int D, int Kc, float scale, float true_d, int dtype, void* stream) {
    if ((lm == nullptr) != (dist == nullptr)) return (int)cudaErrorInvalidValue;
    if (dtype == 0)
        return launch<float>(q, k, lm, logits, dist, B, Tn, Hkv, G, D, Kc, scale, true_d, (cudaStream_t)stream);
    if (dtype == 1)
        return launch<__nv_bfloat16>(q, k, lm, logits, dist, B, Tn, Hkv, G, D, Kc, scale, true_d, (cudaStream_t)stream);
    return (int)cudaErrorInvalidValue;
}
