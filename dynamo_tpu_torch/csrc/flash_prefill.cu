// Flash prefill attention for Hopper (sm_90a), hand-written CUDA C++: two C
// entries over two kernels, one for each dtype.
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
// Function (with base = offset, or 0 for a full prefill): query row i sits
// at absolute position base + i and attends to prefix positions p < base
// that the gathered span holds (p < Kp) and to fresh rows j <= i; with a
// window, only keys with qpos - kpos < window, on absolute positions.  Rows
// at i >= seq_len (suffix_len) are written as zeros by the kernels
// themselves (the wrappers hand in an uninitialised output).  The Pallas
// kernel computes them (they attend to the valid keys); nothing reads them.
// The Pallas prefix kernel asks for Kp to be a multiple of its key tile;
// these walk absolute positions and take any Kp.
//
// What bounds them on an H100: operations (a T-token prompt needs ~T^2 / 2
// * Hq * D * 4 flops over some T * (Hq + 2 Hkv) * D * 2 bytes).  The entries
// dispatch on the dtype between two hand-written kernels; neither is a
// fallback of the other:
//   bf16 (the serving dtype): flash_tc_kernel (flash_prefill_tc.cuh), every
//     product on the bf16 tensor cores (wgmma), Q and K/V staged by TMA into
//     an mbarrier ring; its note says how the design meets the bound.  The
//     entry encodes the kernel's three tensor maps on the host per launch.
//   f32 (the card-equals-CPU reference dtype of chip_smoke.py and the card
//     tests): flash_kernel over the CUDA-core routine attend_tile
//     (attention_tile.cuh), every product in f32 on the CUDA cores.  The
//     tensor cores take f32 only as TF32, which keeps about three decimal
//     digits, far outside the f32 checks' 5e-5.  One CTA per (lane, KV
//     head, tile of 64 / n_rep query rows, rounded down); dead key tiles are
//     never loaded.
// Both take every GQA group from 1 to 8 at run time and head dims 64, 96,
// 128 and 256 (attention_tile.cuh by_geometry).

#include <math.h>

#include <type_traits>

#include "attention_tile.cuh"
#include "flash_prefill_tc.cuh"

namespace {

using namespace dyn;

template <typename T, int D>
__global__ void __launch_bounds__(TILE_WARPS * 32)
flash_kernel(const T* __restrict__ q,         // [B, T, Hq, D]
             const T* __restrict__ k,         // [B, Kp + T, Hkv, D]
             const T* __restrict__ v,         // [B, Kp + T, Hkv, D]
             const int* __restrict__ offset,  // [B] prefix length, or null: 0
             const int* __restrict__ lens,    // [B] valid query rows
             T* __restrict__ out,             // [B, T, Hq, D]
             int T_, int Kp, int Hkv, int nrep, int window, float scale) {
    const int TQ = TILE_QV / nrep;  // query rows per CTA
    const int b = blockIdx.z;
    const int g = blockIdx.y;
    const int r0 = blockIdx.x * TQ;
    const int len = min(lens[b], T_);
    const int Hq = Hkv * nrep;
    {  // the tile's rows at or past len: zeros over the group's heads
        const int z0 = max(r0, len);
        const int z1 = min(r0 + TQ, T_);
        if (z1 > z0)
            zero_rows(out + (((size_t)b * T_ + z0) * Hq + (size_t)g * nrep) * D, (size_t)Hq * D,
                      z1 - z0, nrep * D);
    }
    if (r0 >= len) return;
    const int base = offset != nullptr ? max(offset[b], 0) : 0;
    const size_t row_stride = (size_t)Hkv * D;
    const size_t lane_at = (size_t)b * (Kp + T_) * row_stride + (size_t)g * D;
    const ContiguousPrefix<T> prefix{k + lane_at, v + lane_at, row_stride, min(base, Kp)};
    const size_t f_at = lane_at + (size_t)Kp * row_stride;
    const size_t q_at = (((size_t)b * T_ + r0) * Hq + (size_t)g * nrep) * D;
    attend_tile<T, D>(q + q_at, out + q_at, (size_t)Hq * D, k + f_at, v + f_at, row_stride,
                      prefix, min(TQ, len - r0), base + r0, base, window, scale, nrep);
}

// cuTensorMapEncodeTiled, looked up at first use through the runtime's
// entry-point query (the library links no -lcuda)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
    static EncodeTiled fn = nullptr;
    if (fn == nullptr) {
        void* p = nullptr;
        cudaDriverEntryPointQueryResult res;
#if CUDART_VERSION >= 12050
        cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                         cudaEnableDefault, &res);
#else
        cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                                &res);
#endif
        if (e == cudaSuccess && res == cudaDriverEntryPointSuccess)
            fn = reinterpret_cast<EncodeTiled>(p);
    }
    return fn;
}

// a bf16 [rows, H, D] tensor read in boxes of 64 rows x 1 head x 64
// elements, 128-byte swizzled
bool tile_map(CUtensorMap* m, const void* base, int D, int H, long long rows) {
    EncodeTiled fn = encode_tiled();
    if (fn == nullptr) return false;
    cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)rows};
    cuuint64_t strides[2] = {(cuuint64_t)D * 2, (cuuint64_t)H * D * 2};
    cuuint32_t box[3] = {64, 1, 64};
    cuuint32_t unit[3] = {1, 1, 1};
    return fn(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims, strides,
              box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
              CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

struct FlashLaunch {
    const void *q, *k, *v;
    const int *offset, *lens;
    void* out;
    int B, T, Kp, Hkv, window;
    cudaStream_t stream;
    int n_rep = 0;  // the GQA group, set by run()

    template <typename T_, int D>
    cudaError_t launch() {
        static bool smem_ok = false;
        if constexpr (std::is_same_v<T_, __nv_bfloat16>) {
            auto kern = flash_tc_kernel<D>;
            cudaError_t e = allow_smem(kern, tc_smem_bytes<D>(), smem_ok);
            if (e != cudaSuccess) return e;
            const int Hq = Hkv * n_rep;
            CUtensorMap qm, km, vm;
            if (!tile_map(&qm, q, D, Hq, (long long)B * T) ||
                !tile_map(&km, k, D, Hkv, (long long)B * (Kp + T)) ||
                !tile_map(&vm, v, D, Hkv, (long long)B * (Kp + T)))
                return cudaErrorInvalidValue;
            dim3 grid(Hq, (T + TC_BM - 1) / TC_BM, B);
            kern<<<grid, 128, tc_smem_bytes<D>(), stream>>>(
                qm, km, vm, offset, lens, static_cast<T_*>(out), T, Kp, Hq, n_rep, window,
                1.4426950408889634f / sqrtf((float)D));
            return cudaGetLastError();
        } else {
            auto kern = flash_kernel<T_, D>;
            cudaError_t e = allow_smem(kern, tile_smem_bytes<D>(), smem_ok);
            if (e != cudaSuccess) return e;
            const int TQ = TILE_QV / n_rep;
            dim3 grid((T + TQ - 1) / TQ, Hkv, B);
            kern<<<grid, TILE_WARPS * 32, tile_smem_bytes<D>(), stream>>>(
                static_cast<const T_*>(q), static_cast<const T_*>(k), static_cast<const T_*>(v),
                offset, lens, static_cast<T_*>(out), T, Kp, Hkv, n_rep, window,
                1.0f / sqrtf((float)D));
            return cudaGetLastError();
        }
    }
};

int run(FlashLaunch& f, int dtype, int Hq, int D) {
    if (f.B <= 0 || f.T <= 0) return 0;
    if (f.Hkv <= 0 || Hq % f.Hkv || f.Kp < 0) return (int)cudaErrorInvalidValue;
    f.n_rep = Hq / f.Hkv;
    return (int)by_geometry(dtype, D, f.n_rep, f);
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
