// Paged decode attention for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the TPU Pallas kernel paged_decode_attention_v2
// (dynamo_tpu/ops/paged_attention.py:124, kernel body _decode_kernel_v2 :40),
// which the JAX engine runs for every multistep tail step
// (step.py _decode_once -> attention.py decode_attention_dispatch, group=8).
//
// Function: one query token per lane attends to the lane's kv_len cached
// positions, read through its page table row; GQA (n_rep query heads per KV
// head), optional sliding window (keys >= kv_len - window), f32 scores and
// online softmax, output in the input dtype.  Lanes with kv_len == 0 write
// zeros.  The table and layer index are clipped like the Pallas kernel's.
//
// What bounds it on an H100: bytes.  Each step reads every live K/V row once
// (2 * kv_len * D * 2 bytes per lane and KV head in bf16) for ~4 * n_rep
// flops per byte -- far below the ~295 flop/byte where the tensor cores
// would become the limit.  The design therefore spends nothing on matrix
// units and everything on reading each page once:
//   * one CTA per (lane, KV head) serves all n_rep query heads of the GQA
//     group, so a K/V row is fetched once per group, not once per head;
//   * the CTA walks only the live positions [lo, kv_len) -- never the padded
//     table width -- with 8 warps, each keeping UNROLL tokens' K and V rows
//     in flight (16-byte vector loads per lane) before it computes on them;
//   * each warp keeps its own f32 running max / sum / accumulator in
//     registers, and the warps merge once through shared memory at the end.
// The TPU kernel's grid walked pages in order and carried the softmax state
// from one grid step to the next; here the sequential walk is the loop inside
// the CTA, and the cross-warp merge replaces the carried scratch.
// Split-K over positions (for few lanes x long caches) is later work.

#include <math.h>

#include "common.cuh"

namespace {

using namespace dyn;

constexpr int WARPS = 8;
constexpr int UNROLL = 4;

template <typename T, int D, int NREP>
__global__ void __launch_bounds__(WARPS * 32)
paged_decode_kernel(const T* __restrict__ q,          // [B, Hq, D]
                    const T* __restrict__ pool,       // [L, 2, N, page, Hkv, D]
                    const int* __restrict__ table,    // [B, P]
                    const int* __restrict__ kv_lens,  // [B]
                    T* __restrict__ out,              // [B, Hq, D]
                    int Hkv, int N, int page, int P, int layer, int window,
                    float scale) {
    constexpr int EPL = D / 32;  // elements of a row each lane holds
    const int g = blockIdx.x;    // KV head
    const int b = blockIdx.y;    // lane
    const int Hq = Hkv * NREP;
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;

    __shared__ float sm_m[WARPS][NREP];
    __shared__ float sm_l[WARPS][NREP];
    __shared__ float sm_acc[WARPS][NREP][D];

    float qf[NREP][EPL];
#pragma unroll
    for (int h = 0; h < NREP; ++h) {
        load_vec<T, EPL>(q + ((size_t)b * Hq + g * NREP + h) * D + lane * EPL, qf[h]);
#pragma unroll
        for (int i = 0; i < EPL; ++i) qf[h][i] *= scale;
    }

    float m[NREP], l[NREP], acc[NREP][EPL];
#pragma unroll
    for (int h = 0; h < NREP; ++h) {
        m[h] = dyn::NEG;
        l[h] = 0.f;
#pragma unroll
        for (int i = 0; i < EPL; ++i) acc[h][i] = 0.f;
    }

    const int kv_len = kv_lens[b];
    // positions past the table width are unreachable (the Pallas grid
    // never visits them)
    const int hi = min(kv_len, P * page);
    const int lo = window > 0 ? max(0, kv_len - window) : 0;
    const size_t row_stride = (size_t)Hkv * D;
    const size_t page_stride = (size_t)page * row_stride;
    const size_t kv_stride = (size_t)N * page_stride;  // K -> V
    const T* kbase = pool + (size_t)layer * 2 * kv_stride + (size_t)g * D + lane * EPL;
    const int* trow = table + (size_t)b * P;

    for (int t0 = lo + warp * UNROLL; t0 < hi; t0 += WARPS * UNROLL) {
        float kf[UNROLL][EPL], vf[UNROLL][EPL];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
            const int t = t0 + u;
            if (t < hi) {
                const int pid = dyn::clampi(trow[t / page], 0, N - 1);
                const T* kp = kbase + (size_t)pid * page_stride + (size_t)(t % page) * row_stride;
                load_vec<T, EPL>(kp, kf[u]);
                load_vec<T, EPL>(kp + kv_stride, vf[u]);
            }
        }
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
            if (t0 + u >= hi) break;  // warp-uniform
#pragma unroll
            for (int h = 0; h < NREP; ++h) {
                float s = 0.f;
#pragma unroll
                for (int i = 0; i < EPL; ++i) s = fmaf(qf[h][i], kf[u][i], s);
                s = dyn::warp_sum(s);
                const float m_new = fmaxf(m[h], s);
                const float alpha = __expf(m[h] - m_new);
                const float p = __expf(s - m_new);
                l[h] = l[h] * alpha + p;
#pragma unroll
                for (int i = 0; i < EPL; ++i) acc[h][i] = fmaf(p, vf[u][i], acc[h][i] * alpha);
                m[h] = m_new;
            }
        }
    }

    if (lane == 0) {
#pragma unroll
        for (int h = 0; h < NREP; ++h) {
            sm_m[warp][h] = m[h];
            sm_l[warp][h] = l[h];
        }
    }
#pragma unroll
    for (int h = 0; h < NREP; ++h)
#pragma unroll
        for (int i = 0; i < EPL; ++i) sm_acc[warp][h][lane * EPL + i] = acc[h][i];
    __syncthreads();

    for (int idx = threadIdx.x; idx < NREP * D; idx += blockDim.x) {
        const int h = idx / D;
        const int d = idx % D;
        float M = dyn::NEG;
#pragma unroll
        for (int w = 0; w < WARPS; ++w) M = fmaxf(M, sm_m[w][h]);
        float L = 0.f, O = 0.f;
#pragma unroll
        for (int w = 0; w < WARPS; ++w) {
            const float f = __expf(sm_m[w][h] - M);
            L += sm_l[w][h] * f;
            O += sm_acc[w][h][d] * f;
        }
        out[((size_t)b * Hq + g * NREP + h) * D + d] = dyn::from_float<T>(L > 0.f ? O / L : 0.f);
    }
}

template <typename T, int D, int NREP>
cudaError_t launch(const void* q, const void* pool, const int* table, const int* kv_lens,
                   void* out, int B, int Hkv, int N, int page, int P, int layer,
                   int window, cudaStream_t stream) {
    dim3 grid(Hkv, B);
    paged_decode_kernel<T, D, NREP><<<grid, WARPS * 32, 0, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(pool), table, kv_lens,
        static_cast<T*>(out), Hkv, N, page, P, layer, window, 1.0f / sqrtf((float)D));
    return cudaGetLastError();
}

template <typename T, int D>
cudaError_t by_rep(int n_rep, const void* q, const void* pool, const int* table,
                   const int* kv_lens, void* out, int B, int Hkv, int N, int page,
                   int P, int layer, int window, cudaStream_t s) {
    // the GQA groups of the port's configs: 2 (ModelConfig.tiny), 4
    // (Llama-3-8B); another group is refused
    switch (n_rep) {
        case 2: return launch<T, D, 2>(q, pool, table, kv_lens, out, B, Hkv, N, page, P, layer, window, s);
        case 4: return launch<T, D, 4>(q, pool, table, kv_lens, out, B, Hkv, N, page, P, layer, window, s);
        default: return cudaErrorInvalidValue;
    }
}

template <typename T>
cudaError_t by_dim(int D, int n_rep, const void* q, const void* pool, const int* table,
                   const int* kv_lens, void* out, int B, int Hkv, int N, int page, int P,
                   int layer, int window, cudaStream_t s) {
    switch (D) {
        case 64: return by_rep<T, 64>(n_rep, q, pool, table, kv_lens, out, B, Hkv, N, page, P, layer, window, s);
        case 128: return by_rep<T, 128>(n_rep, q, pool, table, kv_lens, out, B, Hkv, N, page, P, layer, window, s);
        default: return cudaErrorInvalidValue;
    }
}

}  // namespace

// Plain C entry (bound with ctypes).  Returns cudaGetLastError() after the
// launch, or cudaErrorInvalidValue for a shape the kernel does not take.
extern "C" int paged_decode_attention(const void* q, const void* pool, const void* table,
                                      const void* kv_lens, void* out, int dtype, int B,
                                      int Hq, int Hkv, int D, int L, int N, int page, int P,
                                      int layer, int window, void* stream) {
    if (B <= 0) return 0;
    if (Hkv <= 0 || Hq % Hkv || N <= 0 || page <= 0 || P <= 0 || L <= 0) {
        return (int)cudaErrorInvalidValue;
    }
    layer = dyn::clampi(layer, 0, L - 1);
    const int n_rep = Hq / Hkv;
    const int* tab = static_cast<const int*>(table);
    const int* lens = static_cast<const int*>(kv_lens);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (dtype == dyn::DTYPE_BF16) {
        return (int)by_dim<__nv_bfloat16>(D, n_rep, q, pool, tab, lens, out, B, Hkv, N, page, P, layer, window, s);
    }
    if (dtype == dyn::DTYPE_F32) {
        return (int)by_dim<float>(D, n_rep, q, pool, tab, lens, out, B, Hkv, N, page, P, layer, window, s);
    }
    return (int)cudaErrorInvalidValue;
}
