// Primitives of the port's bf16 tensor-core attention kernels (sm_90a):
// flash_tc_kernel (flash_prefill_tc.cuh), ragged_tc_kernel (ragged_tc.cuh)
// and paged_decode_tc_kernel (decode_tc.cuh).  They keep query vectors
// against 64-key tiles in shared memory, in boxes of [64 rows][64 elements]
// laid out in the 128-byte swizzle that TMA writes and wgmma descriptors
// read (16-byte chunk c of box row r at chunk c ^ (r & 7)), and run the
// same online softmax in the m16n8 accumulator layout.  Here: the swizzle,
// the key walk, the softmax and P's fragments, the merge of warps that
// split a key tile, the output store, the mbarrier / TMA / cp.async copies,
// and the wgmma and mma.sync products.
#pragma once

#include <cuda.h>
#include <math.h>

#include "common.cuh"

namespace dyn {

constexpr int TC_BN = 64;  // keys per tile

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
}

// element offset of 16-byte chunk ``c`` of row ``r`` in a [rows][D] tile
// whose chunks are XOR-swizzled by row (c ^ (r & 7): conflict-free for a
// warp writing 4-byte pairs of 8 rows and reading 16-byte chunks)
template <int D>
__device__ __forceinline__ int swz(int r, int c) {
    return r * D + ((c ^ (r & 7)) << 3);
}

// element offset of 16-byte chunk ``c`` (of D / 8) of row ``r`` in a
// [D / 64][64][64] tile of 128-byte-swizzled boxes
__device__ __forceinline__ int box_at(int r, int c) {
    return (c >> 3) * 64 * 64 + r * 64 + (((c & 7) ^ (r & 7)) << 3);
}

// Writes zeros over ``rows`` rows of ``elems`` contiguous elements, row i
// at ``p + i * stride`` (elems * sizeof(T) a multiple of 16, 16-byte
// aligned rows), with the CTA's threads.
template <typename T>
__device__ __forceinline__ void zero_rows(T* p, size_t stride, int rows, int elems) {
    constexpr int VEC = 16 / (int)sizeof(T);
    const int per_row = elems / VEC;
    for (int c = threadIdx.x; c < rows * per_row; c += blockDim.x) {
        *reinterpret_cast<uint4*>(p + (size_t)(c / per_row) * stride + (c % per_row) * VEC) =
            make_uint4(0u, 0u, 0u, 0u);
    }
}

// The CTA's key walk: prefix positions [p_lo, p_hi), then fresh rows
// [f_lo, f_hi) (position base + j, memory row Kp + j), each run in 64-key
// tiles aligned to multiples of 64 of its own positions, so that only the
// last fresh tile crosses the causal diagonal.
struct KeyWalk {
    int base, Kp, p_lo, p_hi, n_pre, f_lo, f_hi, n_tiles;

    __device__ KeyWalk(int base_, int Kp_, int r0, int rows, int window) : base(base_), Kp(Kp_) {
        const int q_lo = base + r0;
        const int floor_pos = window > 0 ? max(0, q_lo - window + 1) : 0;
        p_hi = min(base, Kp);
        p_lo = (floor_pos / TC_BN) * TC_BN;
        n_pre = p_hi > p_lo ? (p_hi - p_lo + TC_BN - 1) / TC_BN : 0;
        f_hi = r0 + rows;
        f_lo = (max(0, floor_pos - base) / TC_BN) * TC_BN;
        n_tiles = n_pre + (f_hi > f_lo ? (f_hi - f_lo + TC_BN - 1) / TC_BN : 0);
    }

    // tile t: its first memory row, first absolute position, valid keys
    __device__ __forceinline__ void at(int t, int& mem0, int& pos0, int& nv) const {
        if (t < n_pre) {
            pos0 = p_lo + t * TC_BN;
            mem0 = pos0;
            nv = min(TC_BN, p_hi - pos0);
        } else {
            const int j0 = f_lo + (t - n_pre) * TC_BN;
            mem0 = Kp + j0;
            pos0 = base + j0;
            nv = min(TC_BN, f_hi - j0);
        }
    }
};

// The online softmax over one tile of 8 NT keys (64, or 16 for a warp's
// share of a key tile) of a warp's 16 rows in the accumulator layout of
// wgmma (and mma.sync) m16n8 tiles: this thread holds rows g and g + 8 (g =
// lane / 4), columns 8 nt + 2 tq + {0, 1}, whose queries sit at positions
// qpos0 and qpos1.  Scales S to the log2 domain, masks it where the tile
// crosses an edge, turns it into P in place and returns the factors that
// rescale the rows' output.
struct RowSoftmax {
    float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

    template <int NT>
    __device__ __forceinline__ void step(float (&s)[NT][4], float& a0, float& a1, bool edge,
                                         int pos0, int nv, int qpos0, int qpos1, int window,
                                         float scale_log2, int tq) {
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                float x = s[nt][e] * scale_log2;
                if (edge) {
                    const int c = nt * 8 + 2 * tq + (e & 1);
                    const int kpos = pos0 + c;
                    const int qpos = e < 2 ? qpos0 : qpos1;
                    const bool keep =
                        c < nv && kpos <= qpos && (window <= 0 || qpos - kpos < window);
                    if (!keep) x = -INFINITY;
                }
                s[nt][e] = x;
            }
        }
        float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
            mx0 = fmaxf(mx0, fmaxf(s[nt][0], s[nt][1]));
            mx1 = fmaxf(mx1, fmaxf(s[nt][2], s[nt][3]));
        }
#pragma unroll
        for (int o = 1; o < 4; o <<= 1) {
            mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, o));
            mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, o));
        }
        const float mn0 = fmaxf(m0, mx0);
        const float mn1 = fmaxf(m1, mx1);
        // a row with no visible key so far subtracts 0: its P stays 0
        const float mu0 = mn0 == -INFINITY ? 0.f : mn0;
        const float mu1 = mn1 == -INFINITY ? 0.f : mn1;
        a0 = exp2f(m0 - mu0);
        a1 = exp2f(m1 - mu1);
        m0 = mn0;
        m1 = mn1;
        float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
            s[nt][0] = exp2f(s[nt][0] - mu0);
            s[nt][1] = exp2f(s[nt][1] - mu0);
            s[nt][2] = exp2f(s[nt][2] - mu1);
            s[nt][3] = exp2f(s[nt][3] - mu1);
            rs0 += s[nt][0] + s[nt][1];
            rs1 += s[nt][2] + s[nt][3];
        }
        l0 = l0 * a0 + rs0;  // this thread's columns; summed over the quad at the end
        l1 = l1 * a1 + rs1;
    }
};

// P (in s) as the A fragments of its NT / 2 16-key steps
template <int NT>
__device__ __forceinline__ void p_fragments(const float (&s)[NT][4], uint32_t (&pa)[NT / 2][4]) {
#pragma unroll
    for (int kk = 0; kk < NT / 2; ++kk) {
        pa[kk][0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
        pa[kk][1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
        pa[kk][2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
        pa[kk][3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
    }
}

// Merges the (m, l, O) of four warps that split every key tile of the same
// 16 query vectors, each under its own RowSoftmax ``sm`` with its O in
// ``o`` (m16n8 layout: rows g and g + 8), through ``scratch``: free shared
// memory of 4 * 16 * (D + 2) floats, which the caller has synced.  Warp 0
// ends with the merged O in ``o``, the merged maxima in ``sm.m0`` and
// ``sm.m1``, and the merged row sums on the quad's first thread (zero on the
// others: store_rows sums l over the quad).
template <int D>
__device__ __forceinline__ void merge_warps(float (&o)[D / 8][4], RowSoftmax& sm,
                                            float* scratch) {
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const int g = lane >> 2;
    const int tq = lane & 3;
    float* part = scratch;          // [4 warps][16 rows][D]
    float* ml = part + 4 * 16 * D;  // [4 warps][16 rows][m, l]
    float l0 = sm.l0, l1 = sm.l1;
    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
    float* pw = part + warp * 16 * D;
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
        *reinterpret_cast<float2*>(pw + g * D + 8 * i + 2 * tq) = make_float2(o[i][0], o[i][1]);
        *reinterpret_cast<float2*>(pw + (g + 8) * D + 8 * i + 2 * tq) =
            make_float2(o[i][2], o[i][3]);
    }
    if (tq == 0) {
        ml[(warp * 16 + g) * 2] = sm.m0;
        ml[(warp * 16 + g) * 2 + 1] = l0;
        ml[(warp * 16 + g + 8) * 2] = sm.m1;
        ml[(warp * 16 + g + 8) * 2 + 1] = l1;
    }
    __syncthreads();
    if (warp != 0) return;
    float f0[4], f1[4];
    float m0 = -INFINITY, m1 = -INFINITY;
#pragma unroll
    for (int w = 0; w < 4; ++w) {
        m0 = fmaxf(m0, ml[(w * 16 + g) * 2]);
        m1 = fmaxf(m1, ml[(w * 16 + g + 8) * 2]);
    }
    const float mu0 = m0 == -INFINITY ? 0.f : m0;
    const float mu1 = m1 == -INFINITY ? 0.f : m1;
    float L0 = 0.f, L1 = 0.f;
#pragma unroll
    for (int w = 0; w < 4; ++w) {
        f0[w] = exp2f(ml[(w * 16 + g) * 2] - mu0);
        f1[w] = exp2f(ml[(w * 16 + g + 8) * 2] - mu1);
        L0 += ml[(w * 16 + g) * 2 + 1] * f0[w];
        L1 += ml[(w * 16 + g + 8) * 2 + 1] * f1[w];
    }
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
        float x0 = 0.f, x1 = 0.f, y0 = 0.f, y1 = 0.f;
#pragma unroll
        for (int w = 0; w < 4; ++w) {
            const float2 a =
                *reinterpret_cast<const float2*>(part + (w * 16 + g) * D + 8 * i + 2 * tq);
            const float2 b =
                *reinterpret_cast<const float2*>(part + (w * 16 + g + 8) * D + 8 * i + 2 * tq);
            x0 += a.x * f0[w];
            x1 += a.y * f0[w];
            y0 += b.x * f1[w];
            y1 += b.y * f1[w];
        }
        o[i][0] = x0;
        o[i][1] = x1;
        o[i][2] = y0;
        o[i][3] = y1;
    }
    sm.m0 = m0;
    sm.m1 = m1;
    sm.l0 = tq == 0 ? L0 : 0.f;
    sm.l1 = tq == 0 ? L1 : 0.f;
}

// Normalises a warp's 16 output rows (this thread's share in the m16n8
// layout), stages them in rows wr .. wr + 15 of the swizzled tile ``stage``
// (rows only this warp uses), and writes them with 16-byte stores.  Tile
// row i is query head i % NREP of query row i / NREP, at ``o_tile + (i /
// NREP) * q_stride + (i % NREP) * D``; query rows below ``rows`` get their
// values, rows from ``rows`` to ``zero_to`` zeros, later rows nothing.
template <int D, int NREP>
__device__ __forceinline__ void store_rows(const float (&o)[D / 8][4], const RowSoftmax& sm,
                                           __nv_bfloat16* stage, int wr, int rows, int zero_to,
                                           __nv_bfloat16* o_tile, size_t q_stride) {
    constexpr int CPR = D / 8;
    const int lane = threadIdx.x & 31;
    const int g = lane >> 2;
    const int tq = lane & 3;
    float l0 = sm.l0, l1 = sm.l1;
    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
    const float inv0 = l0 > 0.f ? 1.f / l0 : 0.f;
    const float inv1 = l1 > 0.f ? 1.f / l1 : 0.f;
    __syncwarp();
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {  // 8-column tile i is 16-byte chunk i
        *reinterpret_cast<uint32_t*>(stage + swz<D>(wr + g, i) + 2 * tq) =
            pack_bf16(o[i][0] * inv0, o[i][1] * inv0);
        *reinterpret_cast<uint32_t*>(stage + swz<D>(wr + g + 8, i) + 2 * tq) =
            pack_bf16(o[i][2] * inv1, o[i][3] * inv1);
    }
    __syncwarp();
#pragma unroll
    for (int i = 0; i < 16 * CPR / 32; ++i) {
        const int c = lane + i * 32;
        const int v = wr + c / CPR;
        const int r = v / NREP;
        const int ch = c % CPR;
        if (r >= zero_to) break;
        uint4 val = make_uint4(0u, 0u, 0u, 0u);
        if (r < rows) val = *reinterpret_cast<const uint4*>(stage + swz<D>(v, ch));
        *reinterpret_cast<uint4*>(o_tile + (size_t)r * q_stride + (v % NREP) * D + ch * 8) = val;
    }
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
                 "r"(bytes)
                 : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
    uint32_t done = 0;
    do {
        asm volatile(
            "{\n.reg .pred p;\n"
            "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
            "selp.u32 %0, 1, 0, p;\n}\n"
            : "=r"(done)
            : "r"(bar), "r"(parity)
            : "memory");
    } while (!done);
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2) {
    asm volatile(
        "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
        "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
        : "memory");
}

// wgmma descriptor of a 128-byte-swizzled [rows][64] box at ``p`` (1024-byte
// aligned): 8-row groups 1024 bytes apart
__device__ __forceinline__ uint64_t sw128_desc(const void* p) {
    return (uint64_t)((smem_addr(p) & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
           ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
    asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving reads or writes of an accumulator across
// the asynchronous wgmma that owns it
__device__ __forceinline__ void fence_acc(float (&d)[8][4]) {
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[i][e])::"memory");
}

#define DYN_ACC32(d)                                                                          \
    "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]), \
        "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]),            \
        "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),            \
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]), "+f"(d[5][0]),            \
        "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]), "+f"(d[6][0]), "+f"(d[6][1]),            \
        "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])

#define DYN_D32                                                                      \
    "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, " \
    "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"

// d (64 x 64) (+)= A (64 x 16, K-major in shared memory) * B (16 x 64, K-major)
__device__ __forceinline__ void wgmma_ss(float (&d)[8][4], uint64_t da, uint64_t db,
                                         int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " DYN_D32
        ", %32, %33, p, 1, 1, 0, 0;\n}\n"
        : DYN_ACC32(d)
        : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 64) += A (64 x 16, registers) * B (16 x 64, MN-major in shared memory)
__device__ __forceinline__ void wgmma_rs(float (&d)[8][4], const uint32_t (&a)[4], uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " DYN_D32
        ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : DYN_ACC32(d)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}


// 16 bytes from global to shared memory without a register round trip;
// ``valid`` false fills the 16 bytes with zeros and reads nothing
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
                 "r"(valid ? 16 : 0)
                 : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// waits until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// orders this thread's generic-proxy writes to shared memory (stores and
// cp.async) before later reads by the async proxy (wgmma)
__device__ __forceinline__ void fence_proxy_async() {
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// four 8 x 8 bf16 matrices from shared memory, lane l giving the address of
// row l % 8 of matrix l / 8; .trans hands out their transposes
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(addr));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(addr));
}

// d (16 x 8) += a (16 x 16, row-major fragments) * b (16 x 8, col-major)
__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

}  // namespace dyn
