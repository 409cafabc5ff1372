// Shared helpers of the port's hand-written attention kernels (sm_90a).
//
// Every kernel here reads the JAX package's pool layout unchanged:
//   pool [L, 2, num_pages, page, Hkv, D]   (K at index 0, V at index 1)
// so one (layer, k|v, page, slot, kv head) row of D elements is contiguous.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace dyn {

// dtype codes shared with the Python wrappers (ops/build.py DTYPE_CODES)
constexpr int DTYPE_F32 = 0;
constexpr int DTYPE_BF16 = 1;

// the GQA groups (Hq / Hkv) every attention entry takes: 1 to MAX_GROUP
constexpr int MAX_GROUP = 8;

// score of a masked key before any valid one was seen; exp(NEG - m) == 0
// for any real m, and a row whose every key is masked keeps l == 0 and
// writes zeros (the Pallas kernels' convention for dead rows)
constexpr float NEG = -1e30f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
    return __float2bfloat16(x);
}

template <int BYTES> struct VecType;
template <> struct VecType<16> { using type = uint4; };
template <> struct VecType<8> { using type = uint2; };
template <> struct VecType<4> { using type = unsigned int; };

// N contiguous elements (N * sizeof(T) bytes, 4, 8, 16 or a multiple of
// 16) into f32 registers with vector loads; the caller guarantees
// alignment.  Another width under 16 bytes (a lane's 3 f32 elements of a
// D = 96 row) loads element by element.
template <typename T, int N>
__device__ __forceinline__ void load_vec(const T* __restrict__ p, float (&out)[N]) {
    constexpr int BYTES = N * (int)sizeof(T);
    if constexpr (BYTES != 4 && BYTES != 8 && BYTES < 16) {
#pragma unroll
        for (int i = 0; i < N; ++i) out[i] = to_float(p[i]);
    } else if constexpr (BYTES <= 16) {
        using V = typename VecType<BYTES>::type;
        V raw = *reinterpret_cast<const V*>(p);
        const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
        for (int i = 0; i < N; ++i) out[i] = to_float(e[i]);
    } else {
        constexpr int PER = 16 / (int)sizeof(T);
        static_assert(N % PER == 0, "vector width must tile 16-byte loads");
#pragma unroll
        for (int c = 0; c < N / PER; ++c) {
            uint4 raw = *reinterpret_cast<const uint4*>(p + c * PER);
            const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
            for (int i = 0; i < PER; ++i) out[c * PER + i] = to_float(e[i]);
        }
    }
}

// N contiguous int8 elements (N = 4, 8 or 16 bytes, aligned) of a row whose
// scale is ``scale``, dequantized to f32 by the int8 pool's rule: the product
// float(q) * scale rounds to the compute type T, as the JAX package's
// dequant does (_dequant_block, gather_layer_kv), before it widens again
template <typename T, int N>
__device__ __forceinline__ void load_dequant(const int8_t* __restrict__ p, float scale,
                                             float (&out)[N]) {
    using V = typename VecType<N>::type;
    V raw = *reinterpret_cast<const V*>(p);
    const int8_t* e = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
    for (int i = 0; i < N; ++i) out[i] = to_float(from_float<T>((float)e[i] * scale));
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
    return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
    return x;
}

__host__ __device__ __forceinline__ int clampi(int x, int lo, int hi) {
    return x < lo ? lo : (x > hi ? hi : x);
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
