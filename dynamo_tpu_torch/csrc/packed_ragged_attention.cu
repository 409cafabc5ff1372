// Packed ragged paged attention for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the dense-pool branch of the TPU Pallas kernel
// packed_ragged_attention (dynamo_tpu/ops/ragged_attention.py:527, kernel
// body _packed_kernel :376), which the JAX engine runs at step 0 of every
// unified dispatch (step.py _packed_unified_step -> attention.py
// packed_ragged_attention_dispatch).  The int8 (kv_scales) branch is not
// ported; the wrapper refuses it.
//
// Function: the dispatch's fresh tokens lie on one flat axis [Np]; lane b's
// q_len rows start at seg_off[b] and sit at absolute positions base[b] + r.
// Row r attends to (a) the lane's resident prefix, positions < base, read
// through its page table row, and (b) the lane's own fresh rows j <= r
// (causal per token); with a window, only keys with qpos - kpos < window.
// Both phases share one f32 online softmax.  Rows past q_len, pad rows and
// idle lanes are not written: the wrapper hands in a zeroed output.
//
// The TPU kernel let each lane write its whole s_max window, spilling into
// the next lanes' rows, and relied on the grid running lanes in ascending
// order so later lanes overwrote the spill.  CUDA blocks run in no order, so
// here a CTA writes only its own rows < q_len.
//
// What bounds it on an H100: bytes for decode rows (a q_len = 1 row reads the
// whole prefix for n_rep query heads), operations for long prefill chunks
// (each key tile serves 64 query vectors).  This first version runs every
// product on the CUDA cores in f32 (no wgmma / mma yet):
//   * one CTA per (lane, KV head, tile of TQ = 64 / n_rep query rows); CTAs
//     whose tile starts past q_len exit at once, so decode lanes cost one
//     CTA per KV head;
//   * the CTA's 64 query vectors (rows x GQA heads) sit pre-scaled in shared
//     memory; keys stream through shared memory 32 at a time, prefix keys
//     gathered from the pool through the page table and fresh keys from the
//     packed K/V, with 16-byte vector loads, so every K/V row is fetched once
//     per CTA and shared by all n_rep heads of the group;
//   * each warp owns 16 query vectors: lane j scores key j, the warp takes
//     the tile max / sum by shuffles, and each lane accumulates D / 32 output
//     dims of every vector in registers.
// Tensor-core products (mma / wgmma), TMA staging and split-K are later work.

#include <math.h>

#include "common.cuh"

namespace {

using namespace dyn;

constexpr int RW = 4;    // warps per CTA
constexpr int QV = 64;   // query vectors (row x GQA head) per CTA
constexpr int KT = 32;   // keys per shared-memory tile

template <int D>
constexpr size_t smem_bytes() {
    return sizeof(float) * ((size_t)QV * D + (size_t)KT * (D + 1) + (size_t)KT * D);
}

template <typename T, int D, int NREP>
__global__ void __launch_bounds__(RW * 32)
packed_ragged_kernel(const T* __restrict__ q,          // [Np, Hq, D]
                     const T* __restrict__ fk,         // [Np, Hkv, D]
                     const T* __restrict__ fv,         // [Np, Hkv, D]
                     const T* __restrict__ pool,       // [L, 2, N, page, Hkv, D]
                     const int* __restrict__ table,    // [B, P]
                     const int* __restrict__ base_arr, // [B]
                     const int* __restrict__ seg_off,  // [B]
                     const int* __restrict__ q_lens,   // [B]
                     T* __restrict__ out,              // [Np, Hq, D], zeroed
                     int Hkv, int N, int page, int P, int layer, int window,
                     float scale) {
    constexpr int TQ = QV / NREP;   // query rows per CTA
    constexpr int VPW = QV / RW;    // query vectors per warp
    constexpr int EPL = D / 32;     // output dims per lane
    constexpr int VEC = 16 / (int)sizeof(T);  // elements per 16-byte load
    constexpr int CPR = D / VEC;    // 16-byte chunks per row

    const int b = blockIdx.z;
    const int g = blockIdx.y;
    const int r0 = blockIdx.x * TQ;
    const int q_len = q_lens[b];
    if (r0 >= q_len) return;
    const int rows = min(TQ, q_len - r0);
    const int base = base_arr[b];
    const int off = seg_off[b];
    const int Hq = Hkv * NREP;
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;

    extern __shared__ float smem[];
    float* sq = smem;                   // [QV][D]
    float* sk = sq + QV * D;            // [KT][D + 1] (padded: lane j reads row j)
    float* sv = sk + KT * (D + 1);      // [KT][D]

    // vector qi = r * NREP + h: row r0 + r, query head g * NREP + h
    for (int c = threadIdx.x; c < QV * CPR; c += blockDim.x) {
        const int qi = c / CPR;
        const int d0 = (c % CPR) * VEC;
        const int r = qi / NREP;
        const int h = qi % NREP;
        float x[VEC];
        if (r < rows) {
            load_vec<T, VEC>(q + ((size_t)(off + r0 + r) * Hq + g * NREP + h) * D + d0, x);
        } else {
#pragma unroll
            for (int i = 0; i < VEC; ++i) x[i] = 0.f;
        }
#pragma unroll
        for (int i = 0; i < VEC; ++i) sq[qi * D + d0 + i] = x[i] * scale;
    }

    float m[VPW], l[VPW], acc[VPW][EPL];
#pragma unroll
    for (int j = 0; j < VPW; ++j) {
        m[j] = NEG;
        l[j] = 0.f;
#pragma unroll
        for (int i = 0; i < EPL; ++i) acc[j][i] = 0.f;
    }

    // keys run over absolute positions [lo, hi): positions < base come from
    // the pool, positions >= base are the lane's fresh rows (j = pos - base).
    // One mask serves both phases: kpos <= qpos and, with a window,
    // qpos - kpos < window (prefix keys are < base <= qpos by construction).
    const int hi = base + r0 + rows;
    const int lo = window > 0 ? max(0, base + r0 - window + 1) : 0;
    const int reach = P * page;  // prefix positions past the table are unreachable
    const size_t row_stride = (size_t)Hkv * D;
    const size_t page_stride = (size_t)page * row_stride;
    const size_t kv_stride = (size_t)N * page_stride;
    const T* pk = pool + (size_t)layer * 2 * kv_stride + (size_t)g * D;
    const int* trow = table + (size_t)b * P;

    for (int t0 = lo; t0 < hi; t0 += KT) {
        __syncthreads();  // previous tile fully consumed (and sq written)
        for (int c = threadIdx.x; c < KT * CPR; c += blockDim.x) {
            const int j = c / CPR;
            const int d0 = (c % CPR) * VEC;
            const int kpos = t0 + j;
            float kx[VEC], vx[VEC];
            const T* ks = nullptr;
            const T* vs = nullptr;
            if (kpos < hi) {
                if (kpos >= base) {
                    const size_t o = ((size_t)(off + kpos - base) * Hkv + g) * D + d0;
                    ks = fk + o;
                    vs = fv + o;
                } else if (kpos < reach) {
                    const int pid = clampi(trow[kpos / page], 0, N - 1);
                    ks = pk + (size_t)pid * page_stride + (size_t)(kpos % page) * row_stride + d0;
                    vs = ks + kv_stride;
                }
            }
            if (ks != nullptr) {
                load_vec<T, VEC>(ks, kx);
                load_vec<T, VEC>(vs, vx);
            } else {
#pragma unroll
                for (int i = 0; i < VEC; ++i) kx[i] = vx[i] = 0.f;
            }
#pragma unroll
            for (int i = 0; i < VEC; ++i) {
                sk[j * (D + 1) + d0 + i] = kx[i];
                sv[j * D + d0 + i] = vx[i];
            }
        }
        __syncthreads();

        const int kpos = t0 + lane;
        const bool in_range = kpos < hi && (kpos >= base || kpos < reach);
#pragma unroll
        for (int jv = 0; jv < VPW; ++jv) {
            const int qi = warp + RW * jv;
            const int r = qi / NREP;
            if (r >= rows) continue;  // warp-uniform
            const int qpos = base + r0 + r;
            const bool valid = in_range && kpos <= qpos &&
                               (window <= 0 || qpos - kpos < window);
            float s = NEG;
            if (valid) {
                s = 0.f;
                const float* qrow = sq + qi * D;
                const float* krow = sk + lane * (D + 1);
#pragma unroll 16
                for (int d = 0; d < D; ++d) s = fmaf(qrow[d], krow[d], s);
            }
            const float mt = warp_max(s);
            if (mt == NEG) continue;  // no valid key of this tile for the row
            const float m_new = fmaxf(m[jv], mt);
            const float alpha = __expf(m[jv] - m_new);
            const float p = valid ? __expf(s - m_new) : 0.f;
            l[jv] = l[jv] * alpha + warp_sum(p);
#pragma unroll
            for (int i = 0; i < EPL; ++i) acc[jv][i] *= alpha;
#pragma unroll 8
            for (int kk = 0; kk < KT; ++kk) {
                const float pk_ = __shfl_sync(0xffffffffu, p, kk);
                const float* vrow = sv + kk * D + lane;
#pragma unroll
                for (int i = 0; i < EPL; ++i) acc[jv][i] = fmaf(pk_, vrow[32 * i], acc[jv][i]);
            }
            m[jv] = m_new;
        }
    }

#pragma unroll
    for (int jv = 0; jv < VPW; ++jv) {
        const int qi = warp + RW * jv;
        const int r = qi / NREP;
        if (r >= rows) continue;
        const int h = qi % NREP;
        const float inv = l[jv] > 0.f ? 1.f / l[jv] : 0.f;
        T* o = out + ((size_t)(off + r0 + r) * Hq + g * NREP + h) * D + lane;
#pragma unroll
        for (int i = 0; i < EPL; ++i) o[32 * i] = from_float<T>(acc[jv][i] * inv);
    }
}

template <typename T, int D, int NREP>
cudaError_t launch(const void* q, const void* k, const void* v, const void* pool,
                   const int* table, const int* base, const int* seg_off,
                   const int* q_lens, void* out, int B, int Hkv, int N, int page,
                   int P, int layer, int window, int s_max, cudaStream_t stream) {
    constexpr int TQ = QV / NREP;
    constexpr size_t smem = smem_bytes<D>();
    auto kern = packed_ragged_kernel<T, D, NREP>;
    static bool attr_set = false;  // once per instantiation
    if (!attr_set) {
        cudaError_t e = cudaFuncSetAttribute(
            kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return e;
        attr_set = true;
    }
    dim3 grid((s_max + TQ - 1) / TQ, Hkv, B);
    kern<<<grid, RW * 32, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<const T*>(pool), table, base, seg_off, q_lens, static_cast<T*>(out),
        Hkv, N, page, P, layer, window, 1.0f / sqrtf((float)D));
    return cudaGetLastError();
}

template <typename T, int D>
cudaError_t by_rep(int n_rep, const void* q, const void* k, const void* v, const void* pool,
                   const int* table, const int* base, const int* seg_off, const int* q_lens,
                   void* out, int B, int Hkv, int N, int page, int P, int layer, int window,
                   int s_max, cudaStream_t s) {
    // the GQA groups of the port's configs: 2 (ModelConfig.tiny), 4
    // (Llama-3-8B); another group is refused
    switch (n_rep) {
        case 2: return launch<T, D, 2>(q, k, v, pool, table, base, seg_off, q_lens, out, B, Hkv, N, page, P, layer, window, s_max, s);
        case 4: return launch<T, D, 4>(q, k, v, pool, table, base, seg_off, q_lens, out, B, Hkv, N, page, P, layer, window, s_max, s);
        default: return cudaErrorInvalidValue;
    }
}

template <typename T>
cudaError_t by_dim(int D, int n_rep, const void* q, const void* k, const void* v,
                   const void* pool, const int* table, const int* base, const int* seg_off,
                   const int* q_lens, void* out, int B, int Hkv, int N, int page, int P,
                   int layer, int window, int s_max, cudaStream_t s) {
    switch (D) {
        case 64: return by_rep<T, 64>(n_rep, q, k, v, pool, table, base, seg_off, q_lens, out, B, Hkv, N, page, P, layer, window, s_max, s);
        case 128: return by_rep<T, 128>(n_rep, q, k, v, pool, table, base, seg_off, q_lens, out, B, Hkv, N, page, P, layer, window, s_max, s);
        default: return cudaErrorInvalidValue;
    }
}

}  // namespace

// Plain C entry (bound with ctypes).  Returns cudaGetLastError() after the
// launch, or cudaErrorInvalidValue for a shape the kernel does not take.
extern "C" int packed_ragged_attention(const void* q, const void* k, const void* v,
                                       const void* pool, const void* table, const void* base,
                                       const void* seg_off, const void* q_lens, void* out,
                                       int dtype, int B, int Hq, int Hkv, int D, int L, int N,
                                       int page, int P, int layer, int window, int s_max,
                                       void* stream) {
    if (B <= 0 || s_max <= 0) return 0;
    if (Hkv <= 0 || Hq % Hkv || N <= 0 || page <= 0 || P <= 0 || L <= 0) {
        return (int)cudaErrorInvalidValue;
    }
    layer = dyn::clampi(layer, 0, L - 1);
    const int n_rep = Hq / Hkv;
    const int* tab = static_cast<const int*>(table);
    const int* bs = static_cast<const int*>(base);
    const int* so = static_cast<const int*>(seg_off);
    const int* ql = static_cast<const int*>(q_lens);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (dtype == dyn::DTYPE_BF16) {
        return (int)by_dim<__nv_bfloat16>(D, n_rep, q, k, v, pool, tab, bs, so, ql, out, B, Hkv, N, page, P, layer, window, s_max, s);
    }
    if (dtype == dyn::DTYPE_F32) {
        return (int)by_dim<float>(D, n_rep, q, k, v, pool, tab, bs, so, ql, out, B, Hkv, N, page, P, layer, window, s_max, s);
    }
    return (int)cudaErrorInvalidValue;
}
