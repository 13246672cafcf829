// Pieces shared by the port's CUDA kernels (landmark_score.cu,
// synapse_attention.cu): dtype traits, 16-byte chunk loads, query staging,
// the per-(key, kv head) dot-product loop, and the mbarrier / bulk-copy
// helpers for sm_90.
//
// A row of D values is NC = D / VEC chunks of 16 bytes in the input dtype
// (VEC = 8 bf16 or 4 f32 values). Query rows are staged as f32, row-major.
//
// Staggered chunks. A bulk copy cannot pad rows, so key rows in shared
// memory lie a multiple of 128 bytes apart at the main shapes, and lanes
// reading the same chunk of consecutive rows would all hit one bank. So a
// lane reads the 8 chunks of each 128-byte group starting at chunk
// lane % 8 (conflict-free), and rotates them into place in registers; its
// query reads, the same address in every lane that shares the rows, are
// then broadcasts.
#pragma once
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#define NEG_INF (-1e30f)
#define THREADS 256
#define MAX_SMEM 232448  // dynamic shared memory a block may use on sm_90

// Phase marks: tools/kernel_phases.py builds a copy of a kernel in which
// each PHASE_MARK(i) is a block barrier and a clock stamp, and PHASE_ONLY's
// statements run. In the kernels as built, both are empty.
#ifndef PHASE_MARK
#define PHASE_MARK(i)
#define PHASE_ONLY(...)
#endif

template <typename T> struct Chunk;
template <> struct Chunk<float> { static constexpr int VEC = 4; };
template <> struct Chunk<__nv_bfloat16> { static constexpr int VEC = 8; };

__host__ __device__ __forceinline__ size_t align16(size_t x) { return (x + 15) & ~(size_t)15; }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) { return __float2bfloat16(x); }

__device__ __forceinline__ void unpack(const uint4& u, float (&f)[4]) {
    f[0] = __uint_as_float(u.x); f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z); f[3] = __uint_as_float(u.w);
}

__device__ __forceinline__ void unpack(const uint4& u, float (&f)[8]) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const float2 v = __bfloat1622float2(h[i]);
        f[2 * i] = v.x;
        f[2 * i + 1] = v.y;
    }
}

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

// n values of src (shared or global, 16-byte aligned, n a multiple of VEC)
// -> f32 at dst, consecutive threads on consecutive 16-byte chunks.
template <typename T>
__device__ __forceinline__ void to_f32(const T* __restrict__ src, int n, float* dst) {
    constexpr int VEC = Chunk<T>::VEC;
    const uint4* s = reinterpret_cast<const uint4*>(src);
    for (int i = threadIdx.x; i < n / VEC; i += blockDim.x) {
        float f[VEC];
        unpack(s[i], f);
        float4* d = reinterpret_cast<float4*>(dst + (size_t)i * VEC);
#pragma unroll
        for (int e = 0; e < VEC / 4; ++e) d[e] = make_float4(f[4 * e], f[4 * e + 1], f[4 * e + 2], f[4 * e + 3]);
    }
}

// acc += q[0:VEC] . k[0:VEC], in order
template <int VEC>
__device__ __forceinline__ void dot_chunk(const float* q, const float (&k)[VEC], float& acc) {
#pragma unroll
    for (int e = 0; e < VEC; e += 4) {
        const float4 qv = *reinterpret_cast<const float4*>(q + e);
        acc = fmaf(qv.x, k[e], acc);
        acc = fmaf(qv.y, k[e + 1], acc);
        acc = fmaf(qv.z, k[e + 2], acc);
        acc = fmaf(qv.w, k[e + 3], acc);
    }
}

// acc[g] = sum_d krow[d] * q[min(row0 + g, row_last)][d] for g < NR: one key
// row of one kv head in shared memory (input dtype) against NR staged f32
// query rows (row-major, D values each). Rows past row_last repeat it, so
// the code is straight-line and the loads can be hoisted; the caller drops
// those sums. Sums run over d in order.
template <typename T, int NR>
__device__ __forceinline__ void dot_rows(const unsigned char* krow, const float* q, int D, int row0, int row_last,
                                         int lane, float (&acc)[NR]) {
    constexpr int VEC = Chunk<T>::VEC;
    const int NC = D / VEC, r = lane & 7;
    const float* qr[NR];
#pragma unroll
    for (int g = 0; g < NR; ++g) {
        qr[g] = q + (size_t)min(row0 + g, row_last) * D;
        acc[g] = 0.f;
    }
    int c0 = 0;
    for (; c0 + 8 <= NC; c0 += 8) {
        uint4 kr[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) kr[i] = *reinterpret_cast<const uint4*>(krow + (c0 + ((i + r) & 7)) * 16);
        // kr[i] holds chunk c0 + (i + r) % 8: rotate by r so that kr[j] holds chunk c0 + j
#pragma unroll
        for (int s = 1; s < 8; s <<= 1) {
            uint4 x[8];
#pragma unroll
            for (int j = 0; j < 8; ++j) x[j] = (r & s) ? kr[(j - s) & 7] : kr[j];
#pragma unroll
            for (int j = 0; j < 8; ++j) kr[j] = x[j];
        }
        // the query values of chunk j + 1 are loaded while chunk j is
        // multiplied: with two register sets, no FMA waits on the load just
        // before it
        float4 qv[2][NR][VEC / 4];
#pragma unroll
        for (int g = 0; g < NR; ++g)
#pragma unroll
            for (int e = 0; e < VEC / 4; ++e) qv[0][g][e] = reinterpret_cast<const float4*>(qr[g] + c0 * VEC)[e];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
            if (j + 1 < 8) {
#pragma unroll
                for (int g = 0; g < NR; ++g)
#pragma unroll
                    for (int e = 0; e < VEC / 4; ++e)
                        qv[(j + 1) & 1][g][e] = reinterpret_cast<const float4*>(qr[g] + (c0 + j + 1) * VEC)[e];
            }
            float k[VEC];
            unpack(kr[j], k);
#pragma unroll
            for (int g = 0; g < NR; ++g) {
#pragma unroll
                for (int e = 0; e < VEC / 4; ++e) {
                    const float4 q4 = qv[j & 1][g][e];
                    acc[g] = fmaf(q4.x, k[4 * e], acc[g]);
                    acc[g] = fmaf(q4.y, k[4 * e + 1], acc[g]);
                    acc[g] = fmaf(q4.z, k[4 * e + 2], acc[g]);
                    acc[g] = fmaf(q4.w, k[4 * e + 3], acc[g]);
                }
            }
        }
    }
    for (; c0 < NC; ++c0) {  // rows whose bytes are no multiple of 128: the rest chunk by chunk
        float k[VEC];
        unpack(*reinterpret_cast<const uint4*>(krow + c0 * 16), k);
#pragma unroll
        for (int g = 0; g < NR; ++g) dot_chunk<VEC>(qr[g] + c0 * VEC, k, acc[g]);
    }
}

// ---- mbarrier and bulk async copy (sm_90) ---------------------------------
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void fence_mbar_init() {
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// The one arrival on `bar` (arrival count 1), announcing `bytes` of bulk
// copies that complete on it.
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

// `bytes` (a multiple of 16, both addresses 16-byte aligned) from global
// src into shared dst, completing on `bar`.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes, uint64_t* bar) {
    asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
                 :: "r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar)) : "memory");
}

// One thread: one bulk copy that is all `bar` waits for.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes, uint64_t* bar) {
    mbar_expect(bar, bytes);
    bulk_copy(dst, src, bytes, bar);
}

// Wait until the barrier has completed the phase of the given parity.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
    asm volatile(
        "{\n"
        ".reg .pred P1;\n"
        "LAB_WAIT:\n"
        "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
        "@P1 bra DONE;\n"
        "bra LAB_WAIT;\n"
        "DONE:\n"
        "}\n" :: "r"(smem_u32(bar)), "r"(parity) : "memory");
}
