// Ragged paged attention for Hopper (sm_90a), hand-written CUDA C++: two C
// entries over one kernel.
//
//   packed_ragged_attention replaces the dense-pool branch of the TPU Pallas
//     kernel packed_ragged_attention (dynamo_tpu/ops/ragged_attention.py:527,
//     kernel body _packed_kernel :376), which the JAX engine runs at step 0
//     of every unified dispatch of the packed layout;
//   ragged_paged_attention replaces the dense-pool branch of the TPU Pallas
//     kernel ragged_paged_attention (ragged_attention.py:205, kernel body
//     _ragged_kernel :74), the same function over the [B, S] rectangle
//     (--no-packed-ragged): a rectangle is a packed axis with seg_off[b] =
//     b * S and s_max = S.
// The int8 (kv_scales) branches are not ported; the wrappers refuse them.
//
// Function: lane b's q_len rows start at seg_off[b] (b * S in the rectangle)
// and sit at absolute positions base[b] + r.  Row r attends to (a) the
// lane's resident prefix, positions < base, read through its page table row,
// and (b) the lane's own fresh rows j <= r; with a window, only keys with
// qpos - kpos < window (attention_tile.cuh).  Rows past q_len, pad rows and
// idle lanes are not written: the wrapper hands in a zeroed output.
//
// The TPU kernels let each lane write its whole s_max (or S) window; the
// packed one spills into the next lanes' rows and relies on the grid running
// lanes in ascending order so later lanes overwrite the spill.  CUDA blocks
// run in no order, so here a CTA writes only its own rows < q_len.
//
// What bounds it on an H100: bytes for decode rows (a q_len = 1 row reads
// the whole prefix for n_rep query heads), operations for long prefill
// chunks (each key tile serves 64 query vectors).  This first version runs
// every product on the CUDA cores in f32 (no wgmma / mma yet): one CTA per
// (lane, KV head, tile of 64 / n_rep query rows); CTAs whose tile starts
// past q_len exit at once, so decode lanes cost one CTA per KV head.
// Tensor-core products (mma / wgmma), TMA staging and split-K are later work.

#include <math.h>

#include "attention_tile.cuh"

namespace {

using namespace dyn;

template <typename T, int D, int NREP>
__global__ void __launch_bounds__(TILE_WARPS * 32)
ragged_kernel(const T* __restrict__ q,          // [Np, Hq, D] (rectangle: [B * S, Hq, D])
              const T* __restrict__ fk,         // [Np, Hkv, D]
              const T* __restrict__ fv,         // [Np, Hkv, D]
              const T* __restrict__ pool,       // [L, 2, N, page, Hkv, D]
              const int* __restrict__ table,    // [B, P]
              const int* __restrict__ base_arr, // [B]
              const int* __restrict__ seg_off,  // [B], or null: the rectangle, b * S
              const int* __restrict__ q_lens,   // [B]
              T* __restrict__ out,              // [Np, Hq, D], zeroed
              int Hkv, int N, int page, int P, int layer, int window, int S,
              float scale) {
    constexpr int TQ = TILE_QV / NREP;  // query rows per CTA
    const int b = blockIdx.z;
    const int g = blockIdx.y;
    const int r0 = blockIdx.x * TQ;
    const int q_len = min(q_lens[b], S);  // a lane owns at most S rows
    if (r0 >= q_len) return;
    const int base = base_arr[b];
    const int off = seg_off != nullptr ? seg_off[b] : b * S;
    const int Hq = Hkv * NREP;
    const size_t row_stride = (size_t)Hkv * D;
    const size_t page_stride = (size_t)page * row_stride;
    const size_t kv_stride = (size_t)N * page_stride;
    const PagedPrefix<T> prefix{
        pool + (size_t)layer * 2 * kv_stride + (size_t)g * D,
        table + (size_t)b * P, kv_stride, page_stride, row_stride,
        page, N, P * page,  // prefix positions past the table are unreachable
    };
    const size_t q_at = ((size_t)(off + r0) * Hq + (size_t)g * NREP) * D;
    const size_t f_at = (size_t)off * row_stride + (size_t)g * D;
    attend_tile<T, D, NREP>(q + q_at, out + q_at, (size_t)Hq * D, fk + f_at, fv + f_at,
                            row_stride, prefix, min(TQ, q_len - r0), base + r0, base,
                            window, scale);
}

struct RaggedLaunch {
    const void *q, *k, *v, *pool;
    const int *table, *base, *seg_off, *q_lens;
    void* out;
    int B, Hkv, N, page, P, layer, window, S;
    cudaStream_t stream;

    template <typename T, int D, int NREP>
    cudaError_t launch() {
        static bool smem_ok = false;
        auto kern = ragged_kernel<T, D, NREP>;
        cudaError_t e = allow_smem(kern, tile_smem_bytes<D>(), smem_ok);
        if (e != cudaSuccess) return e;
        constexpr int TQ = TILE_QV / NREP;
        dim3 grid((S + TQ - 1) / TQ, Hkv, B);
        kern<<<grid, TILE_WARPS * 32, tile_smem_bytes<D>(), stream>>>(
            static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
            static_cast<const T*>(pool), table, base, seg_off, q_lens, static_cast<T*>(out),
            Hkv, N, page, P, layer, window, S, 1.0f / sqrtf((float)D));
        return cudaGetLastError();
    }
};

int run(RaggedLaunch& r, int dtype, int Hq, int D, int L) {
    if (r.B <= 0 || r.S <= 0) return 0;
    if (r.Hkv <= 0 || Hq % r.Hkv || r.N <= 0 || r.page <= 0 || r.P <= 0 || L <= 0) {
        return (int)cudaErrorInvalidValue;
    }
    r.layer = clampi(r.layer, 0, L - 1);
    return (int)by_geometry(dtype, D, Hq / r.Hkv, r);
}

}  // namespace

// Plain C entries (bound with ctypes).  Each returns cudaGetLastError()
// after its launch, or cudaErrorInvalidValue for a shape it does not take.
extern "C" int packed_ragged_attention(const void* q, const void* k, const void* v,
                                       const void* pool, const void* table, const void* base,
                                       const void* seg_off, const void* q_lens, void* out,
                                       int dtype, int B, int Hq, int Hkv, int D, int L, int N,
                                       int page, int P, int layer, int window, int s_max,
                                       void* stream) {
    RaggedLaunch r{q, k, v, pool,
                   static_cast<const int*>(table), static_cast<const int*>(base),
                   static_cast<const int*>(seg_off), static_cast<const int*>(q_lens),
                   out, B, Hkv, N, page, P, layer, window, s_max,
                   static_cast<cudaStream_t>(stream)};
    if (seg_off == nullptr) return (int)cudaErrorInvalidValue;
    return run(r, dtype, Hq, D, L);
}

extern "C" int ragged_paged_attention(const void* q, const void* k, const void* v,
                                      const void* pool, const void* table, const void* base,
                                      const void* q_lens, void* out, int dtype, int B, int S,
                                      int Hq, int Hkv, int D, int L, int N, int page, int P,
                                      int layer, int window, void* stream) {
    RaggedLaunch r{q, k, v, pool,
                   static_cast<const int*>(table), static_cast<const int*>(base),
                   nullptr, static_cast<const int*>(q_lens),
                   out, B, Hkv, N, page, P, layer, window, S,
                   static_cast<cudaStream_t>(stream)};
    return run(r, dtype, Hq, D, L);
}
