// Flash prefill attention for Hopper (sm_90a), hand-written CUDA C++: two C
// entries over one kernel.
//
//   flash_prefill_attention replaces the TPU Pallas kernel
//     flash_prefill_attention (dynamo_tpu/ops/flash_prefill.py:125, kernel
//     body _flash_kernel :44): causal prefill from position 0 over a
//     bucket-padded prompt batch, q [B, T, Hq, D], k/v [B, T, Hkv, D];
//   flash_prefix_prefill_attention replaces flash_prefix_prefill_attention
//     (flash_prefill.py:311, kernel body _flash_prefix_kernel :200): suffix
//     queries at offset + i over [gathered prefix | fresh suffix], k_cat /
//     v_cat [B, Kp + T, Hkv, D]; prefix keys valid while kpos < offset.
// The JAX engine runs them in the classic path's prefill_step and
// prefill_suffix_and_sample (prefix-cache restarts and chunked prefill).
//
// Function (attention_tile.cuh, with base = offset, or 0 for a full prefill):
// query row i sits at absolute position base + i and attends to prefix
// positions p < base that the gathered span holds (p < Kp) and to fresh
// rows j <= i; with a window, only keys with qpos - kpos < window, on
// absolute positions.  Rows at i >= seq_len (suffix_len) are not written:
// the wrapper hands in a zeroed output, so they come out as zeros.  The
// Pallas kernel computes them (they attend to the valid keys); nothing reads
// them.  The Pallas prefix kernel asks for Kp to be a multiple of its key
// tile; this one walks absolute positions and takes any Kp.
//
// What bounds it on an H100: operations (each key tile serves 64 query
// vectors of one KV head; a T-token prompt needs ~T^2 / 2 * Hq * D * 4
// flops).  This first version runs every product on the CUDA cores in f32:
// one CTA per (lane, KV head, tile of 64 / n_rep query rows), CTAs whose
// tile starts past the lane's valid rows exit at once, and key tiles wholly
// in the causal future or behind the window are never loaded (the Pallas
// index maps' dead-block rule).  Tensor-core tiles (mma / wgmma) and TMA
// staging are later work.

#include <math.h>

#include "attention_tile.cuh"

namespace {

using namespace dyn;

template <typename T, int D, int NREP>
__global__ void __launch_bounds__(TILE_WARPS * 32)
flash_kernel(const T* __restrict__ q,         // [B, T, Hq, D]
             const T* __restrict__ k,         // [B, Kp + T, Hkv, D]
             const T* __restrict__ v,         // [B, Kp + T, Hkv, D]
             const int* __restrict__ offset,  // [B] prefix length, or null: 0
             const int* __restrict__ lens,    // [B] valid query rows
             T* __restrict__ out,             // [B, T, Hq, D], zeroed
             int T_, int Kp, int Hkv, int window, float scale) {
    constexpr int TQ = TILE_QV / NREP;  // query rows per CTA
    const int b = blockIdx.z;
    const int g = blockIdx.y;
    const int r0 = blockIdx.x * TQ;
    const int len = min(lens[b], T_);
    if (r0 >= len) return;
    const int base = offset != nullptr ? max(offset[b], 0) : 0;
    const int Hq = Hkv * NREP;
    const size_t row_stride = (size_t)Hkv * D;
    const size_t lane_at = (size_t)b * (Kp + T_) * row_stride + (size_t)g * D;
    const ContiguousPrefix<T> prefix{k + lane_at, v + lane_at, row_stride, min(base, Kp)};
    const size_t f_at = lane_at + (size_t)Kp * row_stride;
    const size_t q_at = (((size_t)b * T_ + r0) * Hq + (size_t)g * NREP) * D;
    attend_tile<T, D, NREP>(q + q_at, out + q_at, (size_t)Hq * D, k + f_at, v + f_at,
                            row_stride, prefix, min(TQ, len - r0), base + r0, base, window,
                            scale);
}

struct FlashLaunch {
    const void *q, *k, *v;
    const int *offset, *lens;
    void* out;
    int B, T, Kp, Hkv, window;
    cudaStream_t stream;

    template <typename T_, int D, int NREP>
    cudaError_t launch() {
        static bool smem_ok = false;
        auto kern = flash_kernel<T_, D, NREP>;
        cudaError_t e = allow_smem(kern, tile_smem_bytes<D>(), smem_ok);
        if (e != cudaSuccess) return e;
        constexpr int TQ = TILE_QV / NREP;
        dim3 grid((T + TQ - 1) / TQ, Hkv, B);
        kern<<<grid, TILE_WARPS * 32, tile_smem_bytes<D>(), stream>>>(
            static_cast<const T_*>(q), static_cast<const T_*>(k), static_cast<const T_*>(v),
            offset, lens, static_cast<T_*>(out), T, Kp, Hkv, window, 1.0f / sqrtf((float)D));
        return cudaGetLastError();
    }
};

int run(FlashLaunch& f, int dtype, int Hq, int D) {
    if (f.B <= 0 || f.T <= 0) return 0;
    if (f.Hkv <= 0 || Hq % f.Hkv || f.Kp < 0) return (int)cudaErrorInvalidValue;
    return (int)by_geometry(dtype, D, Hq / f.Hkv, f);
}

}  // namespace

// Plain C entries (bound with ctypes).  Each returns cudaGetLastError()
// after its launch, or cudaErrorInvalidValue for a shape it does not take.
extern "C" int flash_prefill_attention(const void* q, const void* k, const void* v,
                                       const void* seq_lens, void* out, int dtype, int B,
                                       int T, int Hq, int Hkv, int D, int window,
                                       void* stream) {
    FlashLaunch f{q, k, v, nullptr, static_cast<const int*>(seq_lens), out,
                  B, T, 0, Hkv, window, static_cast<cudaStream_t>(stream)};
    return run(f, dtype, Hq, D);
}

extern "C" int flash_prefix_prefill_attention(const void* q, const void* k_cat,
                                              const void* v_cat, const void* offset,
                                              const void* suffix_lens, void* out, int dtype,
                                              int B, int T, int Kp, int Hq, int Hkv, int D,
                                              int window, void* stream) {
    FlashLaunch f{q, k_cat, v_cat, static_cast<const int*>(offset),
                  static_cast<const int*>(suffix_lens), out,
                  B, T, Kp, Hkv, window, static_cast<cudaStream_t>(stream)};
    if (offset == nullptr) return (int)cudaErrorInvalidValue;
    return run(f, dtype, Hq, D);
}
