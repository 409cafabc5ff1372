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
//
// - Head dims 64, 96, 128 and 256, any GQA group (a CTA serves one query
//   head; the group only maps it to its KV head).  A row is tc_width<D>()
//   / 64 boxes wide; at D 96 the second box's last 32 columns lie past the
//   tensor's row, and TMA fills them with zeros.  S = Q K^T steps over the
//   real columns only; the P V product of the last box fills pad output
//   columns that the store skips.  At D 256 the O accumulators take 128
//   registers a thread, S 32 and P 16; the three-stage ring takes 224 KB,
//   one CTA a SM.
//
// The swizzle, the key walk, the softmax, the store and the wgmma and TMA
// primitives live in tc_common.cuh, shared with the ragged kernel.
#pragma once

#include "tc_common.cuh"

namespace dyn {

constexpr int TC_BM = 64;     // query rows per CTA
constexpr int TC_STAGES = 3;  // K/V ring

// Q plus the K/V ring, in rows of tc_width<D>() elements, then the
// mbarriers (Q, one per stage)
template <int D>
constexpr size_t tc_smem_bytes() {
    return sizeof(__nv_bfloat16) * (size_t)(TC_BM + 2 * TC_STAGES * TC_BN) * tc_width<D>() + 64;
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
    constexpr int DP = tc_width<D>();
    constexpr int HALVES = DP / 64;  // 64-column boxes of a row
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
                if (64 * hd + 16 * kd < D) wgmma_ss(s, dq + 2 * kd, dk + 2 * kd, hd | kd);
        }
        wgmma_commit();
        if (t > 0) issue_pv(prev);
        wgmma_commit();
        wgmma_wait<1>();  // S(t) is done; P V may still run
        fence_acc(s);
        const bool edge = nv < TC_BN || pos0 + TC_BN - 1 > wq_lo ||
                          (window > 0 && wq_hi - pos0 >= window);
        float a0, a1;
        sm.step(s, a0, a1, edge, pos0, nv, qpos0, qpos0 + 8, window, scale_log2, tq);
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

    float of[D / 8][4];  // the real columns' accumulators
#pragma unroll
    for (int i = 0; i < D / 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) of[i][e] = o[i / 8][i % 8][e];
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();  // every warp is done with sQ
    store_rows<D, DP>(of, sm, sQ, wr, rows, T_ - r0, GroupDiv(1),
                      o_lane + (size_t)r0 * q_stride, q_stride);
}

}  // namespace dyn
