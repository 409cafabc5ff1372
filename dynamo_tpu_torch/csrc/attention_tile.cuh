// The CTA routine shared by the port's ragged causal attention kernels
// (sm_90a): packed_ragged_attention and ragged_paged_attention
// (packed_ragged_attention.cu), flash_prefill_attention and
// flash_prefix_prefill_attention (flash_prefill.cu).
//
// The four TPU kernels they replace compute one function over different
// operand layouts.  A lane's fresh query rows sit at absolute positions
// base + r and attend, under one f32 online softmax, to
//   (a) a resident prefix, positions p < base, wherever the layout keeps it
//       (the paged pool, dense or int8 with row scales, through a page
//       table, or a gathered contiguous span), and only while the prefix
//       source reaches p;
//   (b) the lane's own fresh rows j <= r (position base + j);
// with a window, only to keys with qpos - kpos < window.  A full prefill is
// the case base = 0 with no prefix.
//
// One CTA serves TILE_QV = 64 query vectors: TQ = 64 / NREP consecutive rows
// times the NREP query heads of one KV head, so every K/V row it loads
// serves the whole GQA group.  The query vectors sit pre-scaled in shared
// memory; keys stream through shared memory TILE_KT = 32 at a time as f32,
// with 16-byte vector loads of the compute type (an int8 prefix row loads
// the same elements in 4 or 8 bytes and dequantizes on the way in); each
// warp owns 16 query vectors: lane j scores key
// j, the warp takes the tile max / sum by shuffles, and each lane
// accumulates D / 32 output dims of every vector in registers.  Every
// product runs on the CUDA cores in f32.
//
// Dead key tiles are never loaded: the walk covers absolute positions
// [lo, hi) with hi = the CTA's newest query + 1 (nothing in the causal
// future, nothing past the lane's valid rows, which bound the tile) and,
// with a window, lo = the oldest query's window floor.  This is the dead
// block rule of the Pallas index maps (flash_prefill.py:163-170, :352-367).
#pragma once

#include "common.cuh"

namespace dyn {

constexpr int TILE_WARPS = 4;  // warps per CTA
constexpr int TILE_QV = 64;    // query vectors (row x GQA head) per CTA
constexpr int TILE_KT = 32;    // keys per shared-memory tile

template <int D>
constexpr size_t tile_smem_bytes() {
    return sizeof(float) *
           ((size_t)TILE_QV * D + (size_t)TILE_KT * (D + 1) + (size_t)TILE_KT * D);
}

// A prefix source says which positions it reaches and how their K and V
// rows come in.  A source of rows in the compute type T (kRows) hands out
// row pointers, and attend_tile loads them through the same load site as
// the fresh rows: nvcc then batches a tile's loads (on an H100 the dense
// packed entry runs 1.61 ms so, 1.84 ms with a load call per source; see
// PERF.md).  Any other source (the int8 pool) loads W elements (dims d0 ..
// d0 + W) of a reachable position's K and V rows into f32 registers itself.
//
// Prefix source: the paged pool through one lane's page-table row.  Table
// ids are clamped into the pool, and positions past the table are
// unreachable (the Pallas kernels' clamping).
template <typename T>
struct PagedPrefix {
    const T* k;          // pool[layer, 0] at KV head g
    const int* table;    // the lane's page-table row
    size_t kv_stride;    // elements from a K row to its V row
    size_t page_stride;  // elements per page
    size_t row_stride;   // elements per position (Hkv * D)
    int page, N, reach;  // page size, pool pages, positions the table covers

    static constexpr bool kRows = true;
    __device__ __forceinline__ bool reachable(int p) const { return p < reach; }
    __device__ __forceinline__ void rows(int p, const T*& ks, const T*& vs) const {
        const int pid = clampi(table[p / page], 0, N - 1);
        ks = k + (size_t)pid * page_stride + (size_t)(p % page) * row_stride;
        vs = ks + kv_stride;
    }
};

// Prefix source: the int8 pool through one lane's page-table row, each row
// dequantized by its f32 scale (load_dequant: rounded to T, as the JAX
// package's _dequant_block does).  Clamping as in PagedPrefix.
template <typename T>
struct QuantPagedPrefix {
    const int8_t* k;     // int8 pool[layer, 0] at KV head g
    const float* s;      // scales[layer, 0], one per (page, slot)
    const int* table;    // the lane's page-table row
    size_t kv_stride;    // elements from a K row to its V row
    size_t row_stride;   // elements per position (Hkv * D)
    size_t s_kv_stride;  // scales from a K row's to its V row's (N * page)
    int page, N, reach;

    static constexpr bool kRows = false;
    __device__ __forceinline__ bool reachable(int p) const { return p < reach; }
    template <int W>
    __device__ __forceinline__ void load(int p, int d0, float (&kx)[W], float (&vx)[W]) const {
        const int pid = clampi(table[p / page], 0, N - 1);
        const size_t row = (size_t)pid * page + (size_t)(p % page);
        const int8_t* ks = k + row * row_stride + d0;
        load_dequant<T, W>(ks, s[row], kx);
        load_dequant<T, W>(ks + kv_stride, s[row + s_kv_stride], vx);
    }
};

// Prefix source: positions [0, reach) of contiguous K and V spans.
template <typename T>
struct ContiguousPrefix {
    const T* k;         // span row 0 at KV head g
    const T* v;
    size_t row_stride;  // elements per position (Hkv * D)
    int reach;

    static constexpr bool kRows = true;
    __device__ __forceinline__ bool reachable(int p) const { return p < reach; }
    __device__ __forceinline__ void rows(int p, const T*& ks, const T*& vs) const {
        ks = k + (size_t)p * row_stride;
        vs = v + (size_t)p * row_stride;
    }
};

// One CTA: query rows r < rows at absolute positions qpos0 + r (row r reads
// q + r * q_stride + h * D for GQA head h of the group and writes out at the
// same offset); fresh key row j (position base + j) at fk/fv + j * f_stride.
// Launch with TILE_WARPS * 32 threads and tile_smem_bytes<D>() of dynamic
// shared memory.
template <typename T, int D, int NREP, typename Prefix>
__device__ __forceinline__ void attend_tile(const T* __restrict__ q, T* __restrict__ out,
                                            size_t q_stride, const T* __restrict__ fk,
                                            const T* __restrict__ fv, size_t f_stride,
                                            const Prefix& prefix, int rows, int qpos0,
                                            int base, int window, float scale) {
    constexpr int VPW = TILE_QV / TILE_WARPS;  // query vectors per warp
    constexpr int EPL = D / 32;                // output dims per lane
    constexpr int VEC = 16 / (int)sizeof(T);   // elements per 16-byte load
    constexpr int CPR = D / VEC;               // 16-byte chunks per row
    static_assert(TILE_QV % NREP == 0, "the GQA group must tile the CTA");

    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;

    extern __shared__ float smem[];
    float* sq = smem;                     // [QV][D]
    float* sk = sq + TILE_QV * D;         // [KT][D + 1] (padded: lane j reads row j)
    float* sv = sk + TILE_KT * (D + 1);   // [KT][D]

    // vector qi = r * NREP + h: row r, query head h of the group
    for (int c = threadIdx.x; c < TILE_QV * CPR; c += blockDim.x) {
        const int qi = c / CPR;
        const int d0 = (c % CPR) * VEC;
        const int r = qi / NREP;
        const int h = qi % NREP;
        float x[VEC];
        if (r < rows) {
            load_vec<T, VEC>(q + (size_t)r * q_stride + (size_t)h * D + d0, x);
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

    // keys over absolute positions [lo, hi): p < base from the prefix
    // source, p >= base the fresh row p - base.  One mask serves both:
    // p <= qpos and, with a window, qpos - p < window (prefix positions are
    // < base <= qpos by construction).
    const int hi = qpos0 + rows;
    const int lo = window > 0 ? max(0, qpos0 - window + 1) : 0;

    for (int t0 = lo; t0 < hi; t0 += TILE_KT) {
        __syncthreads();  // previous tile fully consumed (and sq written)
        for (int c = threadIdx.x; c < TILE_KT * CPR; c += blockDim.x) {
            const int j = c / CPR;
            const int d0 = (c % CPR) * VEC;
            const int kpos = t0 + j;
            float kx[VEC], vx[VEC];
            if constexpr (Prefix::kRows) {
                const T* ks = nullptr;
                const T* vs = nullptr;
                if (kpos < hi) {
                    if (kpos >= base) {
                        ks = fk + (size_t)(kpos - base) * f_stride;
                        vs = fv + (size_t)(kpos - base) * f_stride;
                    } else if (prefix.reachable(kpos)) {
                        prefix.rows(kpos, ks, vs);
                    }
                }
                if (ks != nullptr) {
                    load_vec<T, VEC>(ks + d0, kx);
                    load_vec<T, VEC>(vs + d0, vx);
                } else {
#pragma unroll
                    for (int i = 0; i < VEC; ++i) kx[i] = vx[i] = 0.f;
                }
            } else {
                bool loaded = false;
                if (kpos < hi) {
                    if (kpos >= base) {
                        const size_t at = (size_t)(kpos - base) * f_stride + d0;
                        load_vec<T, VEC>(fk + at, kx);
                        load_vec<T, VEC>(fv + at, vx);
                        loaded = true;
                    } else if (prefix.reachable(kpos)) {
                        prefix.load(kpos, d0, kx, vx);
                        loaded = true;
                    }
                }
                if (!loaded) {
#pragma unroll
                    for (int i = 0; i < VEC; ++i) kx[i] = vx[i] = 0.f;
                }
            }
#pragma unroll
            for (int i = 0; i < VEC; ++i) {
                sk[j * (D + 1) + d0 + i] = kx[i];
                sv[j * D + d0 + i] = vx[i];
            }
        }
        __syncthreads();

        const int kpos = t0 + lane;
        const bool in_range = kpos < hi && (kpos >= base || prefix.reachable(kpos));
#pragma unroll
        for (int jv = 0; jv < VPW; ++jv) {
            const int qi = warp + TILE_WARPS * jv;
            const int r = qi / NREP;
            if (r >= rows) continue;  // warp-uniform
            const int qpos = qpos0 + r;
            const bool valid = in_range && kpos <= qpos && (window <= 0 || qpos - kpos < window);
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
            for (int kk = 0; kk < TILE_KT; ++kk) {
                const float pk = __shfl_sync(0xffffffffu, p, kk);
                const float* vrow = sv + kk * D + lane;
#pragma unroll
                for (int i = 0; i < EPL; ++i) acc[jv][i] = fmaf(pk, vrow[32 * i], acc[jv][i]);
            }
            m[jv] = m_new;
        }
    }

#pragma unroll
    for (int jv = 0; jv < VPW; ++jv) {
        const int qi = warp + TILE_WARPS * jv;
        const int r = qi / NREP;
        if (r >= rows) continue;
        const int h = qi % NREP;
        const float inv = l[jv] > 0.f ? 1.f / l[jv] : 0.f;
        T* o = out + (size_t)r * q_stride + (size_t)h * D + lane;
#pragma unroll
        for (int i = 0; i < EPL; ++i) o[32 * i] = from_float<T>(acc[jv][i] * inv);
    }
}

// Runs f.template launch<T, D, NREP>() for the runtime dtype, head dim and
// GQA group.  The instantiations are those of the port's configs: f32 and
// bf16, D 64 and 128, groups 2 (ModelConfig.tiny) and 4 (Llama-3-8B);
// another geometry is refused.
template <typename T, int D, typename F>
cudaError_t by_group(int n_rep, F& f) {
    switch (n_rep) {
        case 2: return f.template launch<T, D, 2>();
        case 4: return f.template launch<T, D, 4>();
        default: return cudaErrorInvalidValue;
    }
}

template <typename T, typename F>
cudaError_t by_head_dim(int D, int n_rep, F& f) {
    switch (D) {
        case 64: return by_group<T, 64>(n_rep, f);
        case 128: return by_group<T, 128>(n_rep, f);
        default: return cudaErrorInvalidValue;
    }
}

template <typename F>
cudaError_t by_geometry(int dtype, int D, int n_rep, F& f) {
    if (dtype == DTYPE_BF16) return by_head_dim<__nv_bfloat16>(D, n_rep, f);
    if (dtype == DTYPE_F32) return by_head_dim<float>(D, n_rep, f);
    return cudaErrorInvalidValue;
}

// Lifts a kernel's dynamic shared-memory cap to ``bytes`` (above 48 KB a
// kernel must opt in before its launch).  ``done`` is the caller's flag, a
// static of the launching template, so each instantiation asks once.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes, bool& done) {
    if (done) return cudaSuccess;
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)bytes);
    if (e == cudaSuccess) done = true;
    return e;
}

}  // namespace dyn
