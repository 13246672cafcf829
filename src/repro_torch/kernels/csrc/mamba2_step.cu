// One Mamba2 decode step of B lanes, each lane's state updated in place.
//
// Replaces no TPU kernel: the JAX package's step
// (src/repro/models/mamba2.py:mamba2_decode) is plain jnp that XLA fuses.
// The port's plain version (models/mamba2.py:_decode_core, then the copy of
// the new state into the cache) runs some thirty PyTorch operations a
// layer, six of which pass over the whole f32 SSM state (16 KB a head at
// the published widths): about eleven state-sized reads and writes a
// step. The reference is pure and returns a new state; the port writes
// the cache's own tensors, so that each byte of state is read once and
// written once.
//
// What bounds it on the H100: bytes. At the council's side decode of
// Zamba2-7B (B = 96 lanes, 112 heads of 64 x 64) the state is 176 MB,
// read and written: 352 MB, ~0.105 ms at 3.35 TB/s, for ~5 flops a state
// element; the conv tails, the in-projected row and the outputs add ~9 MB.
//
// Three launches on the caller's stream; no allocation (the wrapper hands
// in the scratch and outputs) and no synchronisation, so a CUDA graph
// captures the step as it is:
// 1. mamba2_conv_dt: one thread a (channel, lane). The depthwise conv of
//    the channel over its W - 1 tail rows and the new raw row, plus the bias,
//    then silu, in f32, into the f32 scratch row of the lane; then the
//    tail rolls in place by one row and takes the new raw row last. A
//    thread reads its channel's tail before it writes it and no other
//    thread touches that channel, so the roll does not race with the conv.
//    The threads past the channels compute each head's
//    dt = softplus(dt + dt_bias) and decay a = exp(dt * -exp(a_log)).
//    The B and C channels of a group, which every head of the group reads,
//    are complete when the next launch starts.
// 2. mamba2_state: one CTA a (head, lane), instantiated for each head
//    width dh and state size ds in {16, 32, 64}: ds / 4 threads a state row
//    of ds floats, min(128, dh ds / 4) threads, so each thread holds
//    dh ds / 4 / threads float4 (eight at the published dh = ds = 64: a warp
//    on two consecutive 256-byte rows). Each thread loads its float4 of the
//    head's state first (16 bytes a thread, streaming: the state does not
//    fit in L2), then H <- a H + (dt x) (x) B_g and stores it back where it
//    was; y = H C_g is summed over the ds / 4 threads of a row by
//    shuffles, plus D_h x, rounded to the working type as the plain path
//    rounds it, and multiplied by silu(z) in the working type; the head's
//    sum of the products' squares (f32) goes to the scratch row.
// 3. mamba2_gated_norm: one thread a (channel, lane): the group's mean
//    square from its heads' sums, in head order, then the norm's weight,
//    cast back. The group's statistic needs every head of the group, so
//    it waits for the launch before; split by head, it spreads over the
//    card at any lane count.
//
// The plain path's separate roundings are kept (__fmul_rn / __fadd_rn:
// no contraction into an FMA where it rounds twice), so the state follows
// it to the order of the conv's four-term sum; y's sum over the state's
// columns runs in another order than the plain einsum's.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int MAX_W = 4;             // conv width at most
constexpr int CONV_THREADS = 256;
constexpr int NORM_THREADS = 256;

// the state pass's layout for a head of dh rows and a state of ds columns
template <int DH, int DS>
struct StateShape {
    static constexpr int PER_ROW = DS / 4;                                  // threads a row, a float4 each
    static constexpr int THREADS = DH * DS / 4 < 128 ? DH * DS / 4 : 128;
    static constexpr int ROWS = THREADS / PER_ROW;                          // rows at once
    static constexpr int ITERS = DH / ROWS;                                 // float4 of state a thread
    static_assert(PER_ROW <= 32 && 32 % PER_ROW == 0 && THREADS % 32 == 0 && DH % ROWS == 0, "state layout");
};
constexpr float SOFTPLUS_THRESHOLD = 20.f;  // PyTorch's: above it softplus is the identity

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) { return __float2bfloat16_rn(v); }
// v rounded to the working type and back
template <typename T> __device__ __forceinline__ float round_to(float v) { return to_f(from_f<T>(v)); }

__device__ __forceinline__ float silu(float v) { return __fdiv_rn(v, __fadd_rn(1.f, expf(-v))); }

// scratch row of a lane (f32, `S` wide): [silu(conv) of the ch channels | dt of the nh heads | a of the nh
// heads | each head's sum of its gated products' squares]
template <typename T>
__global__ void __launch_bounds__(CONV_THREADS)
mamba2_conv_dt(const T* __restrict__ zx, T* __restrict__ conv, const T* __restrict__ conv_w,
               const T* __restrict__ conv_b, const T* __restrict__ dt_bias, const T* __restrict__ a_log,
               float* __restrict__ scratch, int nh, int di, int ch, int W, int N, int S) {
    const int c = blockIdx.x * CONV_THREADS + threadIdx.x, b = blockIdx.y;
    float* row = scratch + (size_t)b * S;
    if (c < ch) {
        T* tail = conv + (size_t)b * (W - 1) * ch + c;
        T old[MAX_W - 1];
#pragma unroll
        for (int w = 0; w < MAX_W - 1; ++w)
            if (w < W - 1) old[w] = tail[(size_t)w * ch];
        const T fresh = zx[(size_t)b * N + di + c];
        float acc = 0.f;
#pragma unroll
        for (int w = 0; w < MAX_W - 1; ++w)
            if (w < W - 1) acc = fmaf(to_f(old[w]), to_f(conv_w[w * ch + c]), acc);
        acc = fmaf(to_f(fresh), to_f(conv_w[(W - 1) * ch + c]), acc);
        row[c] = silu(__fadd_rn(acc, to_f(conv_b[c])));
#pragma unroll
        for (int w = 0; w < MAX_W - 2; ++w)
            if (w < W - 2) tail[(size_t)w * ch] = old[w + 1];
        tail[(size_t)(W - 2) * ch] = fresh;
    } else if (c < ch + nh) {
        const int h = c - ch;
        const float v = __fadd_rn(to_f(zx[(size_t)b * N + di + ch + h]), to_f(dt_bias[h]));
        const float dt = v > SOFTPLUS_THRESHOLD ? v : log1pf(expf(v));
        // exp(a_log) in the working type, as the plain path computes it
        const float ea = round_to<T>(expf(to_f(a_log[h])));
        row[ch + h] = dt;
        row[ch + nh + h] = expf(__fmul_rn(dt, -ea));
    }
}

// y * silu(z) in the working type, as the plain path rounds it
template <typename T>
__device__ __forceinline__ float gated(float y, T z) {
    return round_to<T>(__fmul_rn(round_to<T>(y), round_to<T>(silu(to_f(z)))));
}

template <typename T, int DH, int DS>
__global__ void __launch_bounds__(StateShape<DH, DS>::THREADS)
mamba2_state(float* __restrict__ ssm, float* __restrict__ scratch, const T* __restrict__ zx,
             const T* __restrict__ d_skip, T* __restrict__ p, int nh, int G, int ch, int N, int S) {
    using L = StateShape<DH, DS>;
    __shared__ float warp_ss[L::THREADS / 32];
    const int h = blockIdx.x, b = blockIdx.y, t = threadIdx.x;
    const int di = nh * DH, g = h / (nh / G);
    const int j = t % L::PER_ROW;   // state columns 4j .. 4j + 3
    const int r0 = t / L::PER_ROW;  // state rows r0 + ROWS k
    float4* st = reinterpret_cast<float4*>(ssm + ((size_t)b * nh + h) * DH * DS) + r0 * L::PER_ROW + j;
    float4 H[L::ITERS];
#pragma unroll
    for (int k = 0; k < L::ITERS; ++k) H[k] = __ldcs(st + k * L::ROWS * L::PER_ROW);
    float* row = scratch + (size_t)b * S;
    const float dt = row[ch + h], a = row[ch + nh + h];
    const float4 Bv = *reinterpret_cast<const float4*>(row + di + g * DS + 4 * j);
    const float4 Cv = *reinterpret_cast<const float4*>(row + di + (G + g) * DS + 4 * j);
    const float D = to_f(d_skip[h]);
    float xs[L::ITERS], part[L::ITERS];
#pragma unroll
    for (int k = 0; k < L::ITERS; ++k) {
        xs[k] = row[h * DH + r0 + L::ROWS * k];
        const float X = __fmul_rn(xs[k], dt);
        float4 n;
        n.x = __fadd_rn(__fmul_rn(H[k].x, a), __fmul_rn(X, Bv.x));
        n.y = __fadd_rn(__fmul_rn(H[k].y, a), __fmul_rn(X, Bv.y));
        n.z = __fadd_rn(__fmul_rn(H[k].z, a), __fmul_rn(X, Bv.z));
        n.w = __fadd_rn(__fmul_rn(H[k].w, a), __fmul_rn(X, Bv.w));
        __stcs(st + k * L::ROWS * L::PER_ROW, n);
        part[k] = fmaf(n.w, Cv.w, fmaf(n.z, Cv.z, fmaf(n.y, Cv.y, n.x * Cv.x)));
    }
#pragma unroll
    for (int off = L::PER_ROW / 2; off >= 1; off >>= 1)
#pragma unroll
        for (int k = 0; k < L::ITERS; ++k) part[k] += __shfl_xor_sync(0xffffffffu, part[k], off);
    // the first thread of each row: y, its gated product and the product's
    // square, summed over the head's rows in a fixed order
    float ss = 0.f;
    if (j == 0) {
        const size_t c = (size_t)b * di + h * DH + r0;
        const T* z = zx + (size_t)b * N + h * DH + r0;  // z: the row's first di columns
#pragma unroll
        for (int k = 0; k < L::ITERS; ++k) {
            const float v = gated(__fadd_rn(part[k], __fmul_rn(xs[k], D)), z[L::ROWS * k]);
            p[c + L::ROWS * k] = from_f<T>(v);
            ss = fmaf(v, v, ss);
        }
    }
    // the warp's rows: its first threads of a row are PER_ROW apart
#pragma unroll
    for (int off = L::PER_ROW; off < 32; off <<= 1) ss += __shfl_xor_sync(0xffffffffu, ss, off);
    if ((t & 31) == 0) warp_ss[t >> 5] = ss;
    __syncthreads();
    if (t == 0) {
        float sum = 0.f;
#pragma unroll
        for (int w = 0; w < L::THREADS / 32; ++w) sum += warp_ss[w];
        row[ch + 2 * nh + h] = sum;
    }
}

template <typename T, int DH, int DS>
void launch_state(float* ssm, float* scratch, const T* zx, const T* d_skip, T* p, int B, int nh, int G, int ch,
                  int N, int S, cudaStream_t stream) {
    mamba2_state<T, DH, DS><<<dim3(nh, B), StateShape<DH, DS>::THREADS, 0, stream>>>(ssm, scratch, zx, d_skip, p,
                                                                                    nh, G, ch, N, S);
}

template <typename T>
using StateLaunch = void (*)(float*, float*, const T*, const T*, T*, int, int, int, int, int, int, cudaStream_t);

template <typename T, int DH>
StateLaunch<T> state_for_ds(int ds) {
    switch (ds) {
        case 16: return launch_state<T, DH, 16>;
        case 32: return launch_state<T, DH, 32>;
        case 64: return launch_state<T, DH, 64>;
        default: return nullptr;
    }
}

// the state pass instantiated for (dh, ds), or null where there is none
template <typename T>
StateLaunch<T> state_for(int dh, int ds) {
    switch (dh) {
        case 16: return state_for_ds<T, 16>(ds);
        case 32: return state_for_ds<T, 32>(ds);
        case 64: return state_for_ds<T, 64>(ds);
        default: return nullptr;
    }
}

// out = p * rsqrt(mean of p^2 over the group + eps) * weight: one thread a
// (channel, lane), the group's sum from its heads' sums in head order
template <typename T>
__global__ void __launch_bounds__(NORM_THREADS)
mamba2_gated_norm(const T* __restrict__ p, const float* __restrict__ scratch, const T* __restrict__ gate_w,
                  T* __restrict__ out, int nh, int dh, int G, int ch, int S, float eps) {
    const int c = blockIdx.x * NORM_THREADS + threadIdx.x, b = blockIdx.y;
    const int di = nh * dh, hg = nh / G;
    if (c >= di) return;
    const float* sums = scratch + (size_t)b * S + ch + 2 * nh + (c / dh) / hg * hg;
    float ss = 0.f;
    for (int i = 0; i < hg; ++i) ss += sums[i];
    const float r = rsqrtf(__fadd_rn(__fdiv_rn(ss, (float)(hg * dh)), eps));
    const size_t i = (size_t)b * di + c;
    out[i] = from_f<T>(__fmul_rn(__fmul_rn(to_f(p[i]), r), to_f(gate_w[c])));
}

template <typename T>
cudaError_t launch_all(const void* zx, void* conv, float* ssm, const void* conv_w, const void* conv_b,
                       const void* dt_bias, const void* a_log, const void* d_skip, const void* gate_w, float* scratch,
                       void* p, void* out, int B, int nh, int dh, int ds, int G, int W, int S, float eps,
                       cudaStream_t stream) {
    const StateLaunch<T> state = state_for<T>(dh, ds);
    if (state == nullptr) return cudaErrorInvalidValue;
    const int di = nh * dh, ch = di + 2 * G * ds, N = di + ch + nh;
    const auto in = [](const void* q) { return static_cast<const T*>(q); };
    mamba2_conv_dt<T><<<dim3((ch + nh + CONV_THREADS - 1) / CONV_THREADS, B), CONV_THREADS, 0, stream>>>(
        in(zx), static_cast<T*>(conv), in(conv_w), in(conv_b), in(dt_bias), in(a_log), scratch, nh, di, ch, W, N, S);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    state(ssm, scratch, in(zx), in(d_skip), static_cast<T*>(p), B, nh, G, ch, N, S, stream);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    mamba2_gated_norm<T><<<dim3((di + NORM_THREADS - 1) / NORM_THREADS, B), NORM_THREADS, 0, stream>>>(
        in(p), scratch, in(gate_w), static_cast<T*>(out), nh, dh, G, ch, S, eps);
    return cudaGetLastError();
}

}  // namespace

// zx [B, N = 2 di + 2 G ds + nh] (z | xBC | dt), conv [B, W - 1, ch = di + 2 G ds] and ssm [B, nh, dh, ds] f32
// (both written in place; di = nh dh; dh and ds each 16, 32 or 64), conv_w [W, ch], conv_b [ch], dt_bias /
// a_log / d_skip [nh], gate_w [di]; scratch
// [B, S] f32 (S >= ch + 3 nh, a multiple of 4), p and out [B, di] (p: the gated product; out: the step's
// output before the out-projection). Every operand but ssm and scratch is in the working type: bf16 where
// `bf16`, else f32. Returns the first launch's error, or 0.
extern "C" int mamba2_step_launch(const void* zx, void* conv, float* ssm, const void* conv_w, const void* conv_b,
                                  const void* dt_bias, const void* a_log, const void* d_skip, const void* gate_w,
                                  float* scratch, void* p, void* out, int B, int nh, int dh, int ds, int G, int W,
                                  int S, int bf16, float eps, cudaStream_t stream) {
    if (W < 2 || W > MAX_W || G < 1 || nh % G) return (int)cudaErrorInvalidValue;
    auto run = bf16 ? launch_all<__nv_bfloat16> : launch_all<float>;
    return (int)run(zx, conv, ssm, conv_w, conv_b, dt_bias, a_log, d_skip, gate_w, scratch, p, out, B, nh, dh, ds, G,
                    W, S, eps, stream);
}
