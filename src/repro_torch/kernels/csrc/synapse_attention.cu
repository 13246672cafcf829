// Decode attention over a synapse token set, with the per-key attention mass.
//
// Replaces the TPU kernel src/repro/kernels/synapse_attention.py:_kernel
// (grid (B, Hkv)) and its one-program variant :_kernel_batched; one launch
// here covers all B*Hkv pairs.
//
// What it computes, per (b, kv head): the G = H/Hkv query rows against T
// keys. Scores q.k are f32, times `scale`; invalid keys take the finite
// NEG_INF = -1e30 (kept in f32), so an all-invalid row gives uniform weights
// and no NaN. Softmax over T, out = p.V, and the mass sum_g p per key, which
// goes to a [B, Hkv, T] f32 scratch that the wrapper sums over Hkv. No
// atomics, so results are bitwise repeatable from run to run.
//
// What bounds it on the H100: bytes. At the engine's shapes (B = side lanes,
// H = 14, Hkv = 2, D = 64, T = 144 in bf16) a launch reads ~74 KB of K/V per
// lane and does ~4 flops per byte, far below the ~295 flop/byte ridge; at
// these sizes the launch itself dominates.
//
// Design: one block per (b, kv head). Each warp takes whole keys, lanes
// striding the head dimension (coalesced 2- or 4-byte loads, D masked, so
// D = 80 works), and reduces the G dot products with shuffles, 16 rows at a
// time in registers (so any G). The G x T scores live in shared memory (the
// wrapper refuses T that does not fit); one warp per row takes the max and
// the sum; p overwrites the scores; for p.V each warp takes a share of the
// keys and the lanes 32 columns, and the warps' partial sums are added in
// shared memory. All sums run in a fixed order. Split-T across blocks, wgmma
// and TMA are left to later work.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#define NEG_INF (-1e30f)
#define MAX_G 16  // query rows held in registers at a time; G is any
#define THREADS 256

template <typename T> __device__ __forceinline__ float to_f(T x);
template <> __device__ __forceinline__ float to_f<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) { return __float2bfloat16(x); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
    return v;
}

template <typename T>
__global__ void __launch_bounds__(THREADS) synapse_attention_kernel(
    const T* __restrict__ q,        // [B, H, D]
    const T* __restrict__ k,        // [B, T, Hkv, D]
    const T* __restrict__ v,        // [B, T, Hkv, D]
    const uint8_t* __restrict__ valid,  // [B, T]
    T* __restrict__ out,            // [B, H, D]
    float* __restrict__ mass,       // [B, Hkv, T]
    int Tn, int Hkv, int G, int D, float scale) {
    extern __shared__ float smem[];
    float* qs = smem;              // [G, D]
    float* ps = smem + G * D;      // [G, T] scores, then probabilities
    float* red = ps + G * Tn;      // [THREADS / 32, MAX_G, 32] partial p.V sums

    const int h = blockIdx.x, b = blockIdx.y;
    const int H = Hkv * G;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int nwarps = blockDim.x >> 5;
    const long kv_row = (long)Hkv * D;  // stride between keys
    const T* kb = k + (long)b * Tn * kv_row + (long)h * D;
    const T* vb = v + (long)b * Tn * kv_row + (long)h * D;

    for (int i = tid; i < G * D; i += blockDim.x) {
        const int g = i / D, d = i % D;
        qs[i] = to_f(q[((long)b * H + h * G + g) * D + d]);
    }
    __syncthreads();

    // 1. scores: one warp per key, lanes over d, MAX_G rows at a time
    for (int t = warp; t < Tn; t += nwarps) {
        const T* kr = kb + (long)t * kv_row;
        const bool ok = valid[(long)b * Tn + t] != 0;
        for (int g0 = 0; g0 < G; g0 += MAX_G) {
            float acc[MAX_G];
#pragma unroll
            for (int g = 0; g < MAX_G; ++g) acc[g] = 0.f;
            for (int d = lane; d < D; d += 32) {
                const float kd = to_f(kr[d]);
#pragma unroll
                for (int g = 0; g < MAX_G; ++g)
                    if (g0 + g < G) acc[g] += qs[(g0 + g) * D + d] * kd;
            }
#pragma unroll
            for (int g = 0; g < MAX_G; ++g) {
                if (g0 + g < G) {
                    const float s = warp_sum(acc[g]);
                    if (lane == 0) ps[(g0 + g) * Tn + t] = ok ? s * scale : NEG_INF;
                }
            }
        }
    }
    __syncthreads();

    // 2. softmax per row: one warp per row
    for (int g = warp; g < G; g += nwarps) {
        float* row = ps + g * Tn;
        float m = NEG_INF;
        for (int t = lane; t < Tn; t += 32) m = fmaxf(m, row[t]);
        m = warp_max(m);
        float sum = 0.f;
        for (int t = lane; t < Tn; t += 32) {
            const float e = expf(row[t] - m);
            row[t] = e;
            sum += e;
        }
        sum = warp_sum(sum);
        for (int t = lane; t < Tn; t += 32) row[t] = row[t] / sum;
    }
    __syncthreads();

    // 3. per-key mass over the group rows
    float* mb = mass + ((long)b * Hkv + h) * Tn;
    for (int t = tid; t < Tn; t += blockDim.x) {
        float s = 0.f;
        for (int g = 0; g < G; ++g) s += ps[g * Tn + t];
        mb[t] = s;
    }

    // 4. out = p.V: each warp takes every nwarps-th key, lanes 32 columns at
    //    a time; the warps' partial sums meet in shared memory and are added
    //    in warp order (a fixed order)
    for (int d0 = 0; d0 < D; d0 += 32) {
        const int d = d0 + lane;
        for (int g0 = 0; g0 < G; g0 += MAX_G) {
            float acc[MAX_G];
#pragma unroll
            for (int g = 0; g < MAX_G; ++g) acc[g] = 0.f;
            if (d < D) {
                for (int t = warp; t < Tn; t += nwarps) {
                    const float vd = to_f(vb[(long)t * kv_row + d]);
#pragma unroll
                    for (int g = 0; g < MAX_G; ++g)
                        if (g0 + g < G) acc[g] += ps[(g0 + g) * Tn + t] * vd;
                }
            }
#pragma unroll
            for (int g = 0; g < MAX_G; ++g) red[(warp * MAX_G + g) * 32 + lane] = acc[g];
            __syncthreads();
            for (int i = tid; i < MAX_G * 32; i += blockDim.x) {
                const int g = i / 32, c = i % 32;
                if (g0 + g < G && d0 + c < D) {
                    float sum = 0.f;
                    for (int w = 0; w < nwarps; ++w) sum += red[(w * MAX_G + g) * 32 + c];
                    out[((long)b * H + h * G + g0 + g) * D + d0 + c] = from_f<T>(sum);
                }
            }
            __syncthreads();
        }
    }
}

template <typename T>
static int launch(const void* q, const void* k, const void* v, const void* valid, void* out,
                  void* mass, int B, int Tn, int Hkv, int G, int D, float scale, cudaStream_t stream) {
    const size_t smem = sizeof(float) * ((size_t)G * (size_t)(D + Tn) + (THREADS / 32) * MAX_G * 32);
    auto kern = synapse_attention_kernel<T>;
    if (smem > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    dim3 grid(Hkv, B);
    kern<<<grid, THREADS, smem, stream>>>(
        (const T*)q, (const T*)k, (const T*)v, (const uint8_t*)valid, (T*)out, (float*)mass,
        Tn, Hkv, G, D, scale);
    return (int)cudaGetLastError();
}

// dtype: 0 = float32, 1 = bfloat16. Returns cudaGetLastError() of the launch.
extern "C" int synapse_attention_launch(
    const void* q, const void* k, const void* v, const void* valid, void* out, void* mass,
    int B, int Tn, int Hkv, int G, int D, float scale, int dtype, void* stream) {
    if (dtype == 0)
        return launch<float>(q, k, v, valid, out, mass, B, Tn, Hkv, G, D, scale, (cudaStream_t)stream);
    if (dtype == 1)
        return launch<__nv_bfloat16>(q, k, v, valid, out, mass, B, Tn, Hkv, G, D, scale, (cudaStream_t)stream);
    return (int)cudaErrorInvalidValue;
}
