// Hopper pieces shared by the port's CUDA kernels (landmark_score.cu,
// synapse_attention.cu): cluster barriers, ldmatrix and the bf16
// mma.sync.m16n8k16 with f32 accumulation, the 4-D tensor-map load of a
// key tile, the ticket that picks the CTA which sums parts in a fixed
// order, and on the host the tensor-map encoder and the kernel attributes
// (largest dynamic shared memory, clusters above 8 CTAs).
#pragma once
#include <cooperative_groups.h>
#include <cuda.h>  // CUtensorMap and the encoder's prototype (called through the runtime's driver entry point)

#include "kv_tile.cuh"

namespace cg = cooperative_groups;

__device__ __forceinline__ void cluster_arrive_relaxed() {
    asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive() {
    asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
    asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], const void* p) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
                 : "=r"(r[0]), "=r"(r[1]) : "r"(smem_u32(p)));
}
// c += a . b, a 16 x 16 bf16 (row), b 16 x 8 bf16 (col), c f32
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
    asm volatile("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
                 "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
                 : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// One tile of a 4-D tensor map (coordinates innermost first) into shared
// memory, completing on `bar`.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, int c0, int c1, int c2, int c3,
                                            uint64_t* bar) {
    asm volatile("cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
                 "[%0], [%1, {%2, %3, %4, %5}], [%6];\n"
                 :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3),
                    "r"(smem_u32(bar)) : "memory");
}

// The ticket: fetch-and-add 1 with release and acquire at GPU scope, so the
// writes that precede it (and, through the block barrier before it, the
// block's) are visible to whoever draws a later ticket, and the drawer sees
// all writes before the earlier ones.
__device__ __forceinline__ int ticket(int* counter) {
    int t;
    asm volatile("atom.add.acq_rel.gpu.global.s32 %0, [%1], 1;\n" : "=r"(t) : "l"(counter) : "memory");
    return t;
}
// Start fetching a tensor map's descriptor (a kernel parameter), so that
// the first copy through it does not wait for the fetch.
__device__ __forceinline__ void prefetch_tensormap(const CUtensorMap* map) {
    asm volatile("prefetch.tensormap [%0];\n" :: "l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

// The largest dynamic shared memory and clusters above 8 CTAs, allowed once
// per kernel and device (`done` is the caller's flag per device).
template <typename K>
static cudaError_t allow_kernel(K kern, bool (&done)[64]) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return e;
    if (dev < 64 && done[dev]) return cudaSuccess;
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
    if (e == cudaSuccess)
        e = cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout, cudaSharedmemCarveoutMaxShared);
    if (e == cudaSuccess) e = cudaFuncSetAttribute(kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e == cudaSuccess && dev < 64) done[dev] = true;
    return e;
}

// cuTensorMapEncodeTiled, from the driver through the runtime (the library
// links no libcuda); null if the driver has none.
using EncodeTiled = decltype(&cuTensorMapEncodeTiled);
static EncodeTiled encoder() {
    static EncodeTiled fn = nullptr;
    if (!fn) {
        void* p = nullptr;
        cudaDriverEntryPointQueryResult found;
        if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) == cudaSuccess &&
            found == cudaDriverEntryPointSuccess)
            fn = reinterpret_cast<EncodeTiled>(p);
    }
    return fn;
}

// keys or values [B, T, Hkv, D] as a 4-D tensor, innermost first: (D, Hkv,
// T, B) where `heads_inner` (a box is hg kv heads of ck keys, landing as
// [ck, hg, columns]), else (D, T, Hkv, B) (landing as [hg, ck, columns]: the
// keys of one kv head are consecutive rows). A box spans one lane and 64
// columns (bf16, 128-byte swizzle) or all D (f32, no swizzle). Rows past a
// lane's T read as zeros, not as the next lane's keys.
static bool cache_map(CUtensorMap* map, const void* base, bool bf16, int B, int Tn, int Hkv, int D, int ck, int hg,
                      bool heads_inner) {
    const EncodeTiled encode = encoder();
    if (!encode) return false;
    const cuuint64_t e = bf16 ? 2 : 4;
    const cuuint64_t head = D * e, key = (cuuint64_t)Hkv * D * e, lane = (cuuint64_t)Tn * Hkv * D * e;
    const cuuint32_t cols = bf16 ? 64 : D;
    const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)(heads_inner ? Hkv : Tn),
                                (cuuint64_t)(heads_inner ? Tn : Hkv), (cuuint64_t)B};
    const cuuint64_t strides[3] = {heads_inner ? head : key, heads_inner ? key : head, lane};
    const cuuint32_t box[4] = {cols, (cuuint32_t)(heads_inner ? hg : ck), (cuuint32_t)(heads_inner ? ck : hg), 1};
    const cuuint32_t unit[4] = {1, 1, 1, 1};
    return encode(map, bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4,
                  const_cast<void*>(base), dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                  bf16 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}
