// The bf16 flash prefill kernel on Hopper's tensor cores (sm_90a), behind
// the two C entries of flash_prefill.cu.  It computes the function of
// attention_tile.cuh for a contiguous prefix source (see flash_prefill.cu):
// query row i of lane b sits at absolute position base + i (base = offset[b]
// for the prefix entry, 0 for a full prefill) and attends to prefix
// positions p < min(base, Kp) and to fresh rows j <= i with j < len[b]; with
// a window, only to keys with qpos - kpos < window.  Rows at or past len[b]
// are written as zeros here (the wrappers hand in an uninitialised output).
//
// What bounds it on an H100: operations.  A 1200-token prompt at Llama-3-8B
// width needs 11.8 GFLOP of causal products against 25 MB of q, k, v and
// output, far above the card's 295 flops per byte.  So every product runs
// on the bf16 tensor cores through wgmma, and the design keeps them fed:
//
// - One CTA, one warpgroup (128 threads), per (lane, query head, 64-row
//   query tile): the flash mapping, so the causal mask follows the row
//   index, and the grid at the check shape (19 live tiles x 32 heads) fills
//   132 SMs several times over.  The newest (heaviest) tiles launch first.
//   The GQA group's query heads read one KV head's tiles through L2 (a
//   lane's K and V at that shape are 4.9 MB of the 50 MB L2).
// - S = Q K^T is wgmma m64n64k16 with Q and K from shared memory; O += P V
//   is the register-A form, P straight from the S accumulators (the two
//   share one register layout), V from shared memory through the
//   descriptor's transpose bit.  bf16 x bf16 products are exact in f32, as
//   the Pallas kernel's f32 product of the widened operands.  Scores are
//   scaled in f32 after the product, with log2(e) folded into the scale for
//   exp2f; P is rounded to bf16 for the product with V, as the Pallas
//   kernel's probs.astype(v.dtype); the row sum l stays f32, from the f32 P.
// - Q and 64-key K/V tiles come in by TMA (tensor maps encoded per launch
//   by the entry) as boxes of [64 rows][64 elements] in the 128-byte swizzle
//   that the wgmma descriptors read, into a ring of three stages, each with
//   its mbarrier.  Tile t + 2 loads while tile t computes.  Shared memory:
//   Q plus three stages of K and V, 112 KB at D = 128, two CTAs a SM.
// - Within the warpgroup the tensor cores and the softmax overlap: tile t's
//   S = Q K^T and tile t - 1's P V are issued together, and the softmax of
//   tile t runs while the P V product is in flight.
// - Key tiles wholly in the causal future, past len, or behind the window
//   floor are never loaded (the Pallas index maps' dead-block rule).  The
//   prefix rows [0, min(base, Kp)) and the fresh rows [Kp, Kp + len) are
//   walked as two runs of tiles under one online softmax, so no tile
//   straddles the padding between them; masks are applied only on tiles
//   that cross the diagonal, the window floor or a length edge.  A box is
//   loaded whole (past the tensor's end TMA fills zeros), so the rows beyond
//   a tile's valid span are read and masked: their V rows meet zero weights,
//   as in the Pallas kernel, which multiplies whole blocks.
#pragma once

#include <cuda.h>
#include <math.h>

#include "common.cuh"

namespace dyn {

constexpr int TC_BM = 64;     // query rows per CTA
constexpr int TC_BN = 64;     // keys per tile
constexpr int TC_STAGES = 3;  // K/V ring

// Q plus the K/V ring, then the mbarriers (Q, one per stage)
template <int D>
constexpr size_t tc_smem_bytes() {
    return sizeof(__nv_bfloat16) * (size_t)(TC_BM + 2 * TC_STAGES * TC_BN) * D + 64;
}

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

// The online softmax over one 64-key tile of a warp's 16 rows in the
// accumulator layout of wgmma (and mma.sync) m16n8 tiles: this thread holds
// rows g and g + 8 (g = lane / 4), columns 8 nt + 2 tq + {0, 1}.  Scales S
// to the log2 domain, masks it where the tile crosses an edge, turns it
// into P in place and returns the factors that rescale the rows' output.
struct RowSoftmax {
    float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

    __device__ __forceinline__ void step(float (&s)[8][4], float& a0, float& a1, bool edge,
                                         int pos0, int nv, int qpos0, int window,
                                         float scale_log2, int tq) {
        const int qpos1 = qpos0 + 8;
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
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
        for (int nt = 0; nt < 8; ++nt) {
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
        for (int nt = 0; nt < 8; ++nt) {
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

// P (in s) as the A fragments of its four 16-key steps
__device__ __forceinline__ void p_fragments(const float (&s)[8][4], uint32_t (&pa)[4][4]) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
        pa[kk][0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
        pa[kk][1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
        pa[kk][2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
        pa[kk][3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
    }
}

// Normalises a warp's 16 output rows (this thread's share in the m16n8
// layout), stages them in rows wr .. wr + 15 of the swizzled tile ``stage``
// (rows only this warp uses), and writes them with 16-byte stores: rows at
// or past the CTA's ``rows`` valid ones as zeros, rows at or past T not at
// all.
template <int D>
__device__ __forceinline__ void store_rows(const float (&o)[D / 8][4], const RowSoftmax& sm,
                                           __nv_bfloat16* stage, int wr, int rows, int r0,
                                           int T_, __nv_bfloat16* o_lane, size_t q_stride) {
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
        const int r = wr + c / CPR;
        const int ch = c % CPR;
        if (r0 + r >= T_) break;
        uint4 val = make_uint4(0u, 0u, 0u, 0u);
        if (r < rows) val = *reinterpret_cast<const uint4*>(stage + swz<D>(r, ch));
        *reinterpret_cast<uint4*>(o_lane + (size_t)(r0 + r) * q_stride + ch * 8) = val;
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

// Launch with 128 threads and tc_smem_bytes<D>() of dynamic shared memory;
// the kernel declares no static shared memory, so the dynamic block starts
// 1024-byte aligned, as the 128-byte swizzle needs (checked: a misaligned
// block traps).
template <int D>
__global__ void __launch_bounds__(128)
flash_tc_kernel(const __grid_constant__ CUtensorMap q_map,  // q as [B T, Hq, D]
                const __grid_constant__ CUtensorMap k_map,  // k as [B (Kp + T), Hkv, D]
                const __grid_constant__ CUtensorMap v_map,  // v as k
                const int* __restrict__ offset,             // [B] prefix length, or null: 0
                const int* __restrict__ lens,               // [B] valid query rows
                __nv_bfloat16* __restrict__ out,            // [B, T, Hq, D]
                int T_, int Kp, int Hq, int n_rep, int window, float scale_log2) {
    using bf16 = __nv_bfloat16;
    constexpr int HALVES = D / 64;  // 64-column boxes of a row
    constexpr int BOX = 64 * 64;    // elements of one box
    constexpr uint32_t BOX_BYTES = BOX * 2;

    const int h = blockIdx.x;
    const int r0 = (gridDim.y - 1 - blockIdx.y) * TC_BM;  // newest tiles first
    const int b = blockIdx.z;
    const int len = min(lens[b], T_);
    const size_t q_stride = (size_t)Hq * D;
    bf16* o_lane = out + (size_t)b * T_ * q_stride + (size_t)h * D;
    if (r0 >= len) {
        zero_rows(o_lane + (size_t)r0 * q_stride, q_stride, min(TC_BM, T_ - r0), D);
        return;
    }
    const int rows = min(TC_BM, len - r0);  // valid query rows of this CTA
    const int base = offset != nullptr ? max(offset[b], 0) : 0;
    const int kvh = h / n_rep;
    const KeyWalk walk(base, Kp, r0, rows, window);
    const int kv_row0 = b * (Kp + T_);

    extern __shared__ __align__(1024) unsigned char smem_raw[];
    if (smem_addr(smem_raw) & 1023) __trap();
    bf16* sQ = reinterpret_cast<bf16*>(smem_raw);  // [HALVES][64][64]
    bf16* sK = sQ + HALVES * BOX;                   // [STAGES][HALVES][64][64]
    bf16* sV = sK + TC_STAGES * HALVES * BOX;
    uint64_t* bars = reinterpret_cast<uint64_t*>(sV + TC_STAGES * HALVES * BOX);
    const uint32_t q_bar = smem_addr(bars);

    const int tid = threadIdx.x;
    if (tid == 0) {
        for (int i = 0; i <= TC_STAGES; ++i) mbar_init(smem_addr(bars + i), 1);
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();

    auto issue_kv = [&](int t, int stage) {
        int mem0, pos0, nv;
        walk.at(t, mem0, pos0, nv);
        const uint32_t bar = smem_addr(bars + 1 + stage);
        mbar_expect_tx(bar, 2 * HALVES * BOX_BYTES);
#pragma unroll
        for (int hd = 0; hd < HALVES; ++hd) {
            tma_load_3d(smem_addr(sK + (stage * HALVES + hd) * BOX), &k_map, bar, 64 * hd, kvh,
                        kv_row0 + mem0);
            tma_load_3d(smem_addr(sV + (stage * HALVES + hd) * BOX), &v_map, bar, 64 * hd, kvh,
                        kv_row0 + mem0);
        }
    };
    if (tid == 0) {
        mbar_expect_tx(q_bar, HALVES * BOX_BYTES);
#pragma unroll
        for (int hd = 0; hd < HALVES; ++hd)
            tma_load_3d(smem_addr(sQ + hd * BOX), &q_map, q_bar, 64 * hd, h, b * T_ + r0);
        for (int t = 0; t < TC_STAGES - 1 && t < walk.n_tiles; ++t) issue_kv(t, t);
    }

    const int warp = tid >> 5;
    const int lane = tid & 31;
    const int tq = lane & 3;
    const int wr = warp * 16;          // the warp's first row in the CTA tile
    const int wq_lo = base + r0 + wr;  // positions of the warp's oldest and
    const int wq_hi = wq_lo + 15;      // newest rows
    const int qpos0 = wq_lo + (lane >> 2);

    float o[HALVES][8][4];
#pragma unroll
    for (int hd = 0; hd < HALVES; ++hd)
#pragma unroll
        for (int i = 0; i < 8; ++i) o[hd][i][0] = o[hd][i][1] = o[hd][i][2] = o[hd][i][3] = 0.f;
    RowSoftmax sm;
    float s[8][4];       // S of tile t, then its P
    uint32_t pa[4][4];   // P of the previous tile as A fragments

    // O += P V for the tile whose P is in pa and whose V sits in ``stage``
    auto issue_pv = [&](int stage) {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
            for (int hd = 0; hd < HALVES; ++hd)  // 16 key rows (2048 bytes) a step
                wgmma_rs(o[hd], pa[kk], sw128_desc(sV + (stage * HALVES + hd) * BOX) + 128 * kk);
    };

    mbar_wait(q_bar, 0);
    int stage = 0;
    for (int t = 0; t < walk.n_tiles; ++t) {
        mbar_wait(smem_addr(bars + 1 + stage), (t / TC_STAGES) & 1);
        int mem0, pos0, nv;
        walk.at(t, mem0, pos0, nv);
        const int prev = stage == 0 ? TC_STAGES - 1 : stage - 1;
        p_fragments(s, pa);  // P(t - 1), before S(t) overwrites s
        fence_acc(s);
#pragma unroll
        for (int hd = 0; hd < HALVES; ++hd) fence_acc(o[hd]);
        wgmma_fence();
        // S(t) = Q K(t)^T, issued together with O += P(t - 1) V(t - 1)
#pragma unroll
        for (int hd = 0; hd < HALVES; ++hd) {
            const uint64_t dq = sw128_desc(sQ + hd * BOX);
            const uint64_t dk = sw128_desc(sK + (stage * HALVES + hd) * BOX);
#pragma unroll
            for (int kd = 0; kd < 4; ++kd)  // 16 columns (32 bytes) a step
                wgmma_ss(s, dq + 2 * kd, dk + 2 * kd, hd | kd);
        }
        wgmma_commit();
        if (t > 0) issue_pv(prev);
        wgmma_commit();
        wgmma_wait<1>();  // S(t) is done; P V may still run
        fence_acc(s);
        const bool edge = nv < TC_BN || pos0 + TC_BN - 1 > wq_lo ||
                          (window > 0 && wq_hi - pos0 >= window);
        float a0, a1;
        sm.step(s, a0, a1, edge, pos0, nv, qpos0, window, scale_log2, tq);
        wgmma_wait<0>();
#pragma unroll
        for (int hd = 0; hd < HALVES; ++hd) {
            fence_acc(o[hd]);
#pragma unroll
            for (int i = 0; i < 8; ++i) {
                o[hd][i][0] *= a0;
                o[hd][i][1] *= a0;
                o[hd][i][2] *= a1;
                o[hd][i][3] *= a1;
            }
        }
        __syncthreads();  // stage prev (tile t - 1) is free for tile t + 2
        if (tid == 0 && t + TC_STAGES - 1 < walk.n_tiles) issue_kv(t + TC_STAGES - 1, prev);
        stage = stage == TC_STAGES - 1 ? 0 : stage + 1;
    }
    if (walk.n_tiles > 0) {  // P V of the last tile
        p_fragments(s, pa);
#pragma unroll
        for (int hd = 0; hd < HALVES; ++hd) fence_acc(o[hd]);
        wgmma_fence();
        issue_pv(stage == 0 ? TC_STAGES - 1 : stage - 1);
        wgmma_commit();
        wgmma_wait<0>();
#pragma unroll
        for (int hd = 0; hd < HALVES; ++hd) fence_acc(o[hd]);
    }

    float of[D / 8][4];
#pragma unroll
    for (int hd = 0; hd < HALVES; ++hd)
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int e = 0; e < 4; ++e) of[hd * 8 + i][e] = o[hd][i][e];
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();  // every warp is done with sQ
    store_rows<D>(of, sm, sQ, wr, rows, r0, T_, o_lane, q_stride);
}

}  // namespace dyn
