// The bf16 ragged paged attention kernel on Hopper's tensor cores (sm_90a),
// behind the four C entries of packed_ragged_attention.cu: the dense pool's
// and the int8 pool's, over the packed axis and the rectangle.  It computes
// the function of attention_tile.cuh for a paged prefix source: lane b's
// rows r < q_len sit at absolute positions base + r and attend to the
// lane's resident prefix (positions p < base that its page-table row
// reaches, p < P * page) and to its own fresh rows j <= r; with a window,
// only to keys with qpos - kpos < window.  It writes rows r < q_len only.
//
// What bounds it on an H100: operations for a prefill chunk (each staged
// key serves 64 query vectors: 4 * keys * Hq * D flops against 2 * Hkv * D
// bytes of K/V per key, far above 295 flops per byte), bytes for decode rows
// (a q_len = 1 lane reads its whole prefix for nrep query vectors).  So the
// products run on the bf16 tensor cores, and the K/V rows stream through
// shared memory behind them:
//
// - One CTA of four warps per (lane, KV head, 64 query vectors): TQ = 64 /
//   nrep (rounded down) query rows times the nrep query heads of the KV
//   head, vector i = row i / nrep, head i % nrep.  Every staged K/V tile
//   serves the whole GQA group from shared memory.  The causal mask and the
//   window follow the row, i / nrep.  A group that does not divide 64 (3,
//   5, 6, 7) leaves the vectors from TQ * nrep on as zero query rows whose
//   outputs nothing stores.  The group is a runtime argument (1 to 8), as
//   in the decode and flash kernels, divided by as a multiply and a shift
//   (GroupDiv, tc_common.cuh): the kernel is instantiated by head dim and
//   pool alone.  CTAs whose first row is at or past q_len exit at once.
// - S = Q K^T in bf16 with f32 accumulators, scaled in f32 after the
//   product (log2(e) folded in for exp2f), the online softmax in f32, P
//   rounded to bf16 for P V, as the Pallas kernel's probs.astype(v.dtype);
//   the row sum l from the f32 P.  A CTA with live vectors past its first
//   16 runs its products as one warpgroup on wgmma m64n64k16: Q and K from
//   shared memory, P from registers, V through the descriptor's transpose
//   bit, P V right after the softmax, so a tile's stage is free when its
//   products are.  (A form on mma.sync m16n8k16, each warp its 16 query
//   vectors, ran 21% slower on an H100; PERF.md has both times.)
// - A CTA whose live vectors all sit in its first 16 (a decode lane's nrep
//   vectors; rows * nrep <= 16) splits every key tile over its warps
//   instead: warp w takes keys 16 w .. 16 w + 15 of each tile for those 16
//   vectors (mma.sync), under its own online softmax, and the four partial
//   (m, l, O) merge in shared memory at the end.  One warp walking the
//   whole prefix alone waits on its own serial chain of products and
//   softmax for every tile (about 2 us a tile on an H100, see PERF.md);
//   split four ways, the chain is a quarter as long and the copies of
//   later tiles run beside it.
// - K/V staging by cp.async, gathered through the page table: tiles of 64
//   keys in a ring of three stages, [64 rows][64 elements] boxes in the
//   128-byte swizzle (tc_common.cuh).  A prefix tile spans 64 / page pages;
//   every 16-byte chunk comes from the row the lane's table gives (ids
//   clamped into [0, N - 1], PagedPrefix's rule), fresh rows from fk / fv at
//   stride Hkv * D; chunks past the tile's valid keys are zero-filled.  A
//   thread copies one chunk column of every 8th (16th) row and finds their
//   pool rows with one division a tile, its table reads all issued before
//   its copies.  Tiles t + 1 and t + 2 load while tile t computes.  Shared
//   memory: Q plus three K + V stages, 112 KB at D = 128, two CTAs a SM.
// - The int8 pool (QUANT): a prefix tile's raw int8 rows (D bytes each)
//   come by cp.async into the upper half of the stage's bf16 K and V areas,
//   and each thread prefetches the f32 scale of the row it will dequantize
//   when the tile is issued.  Once the stage has landed, thread i reads row
//   i % 64 of side i / 64 into registers, the CTA syncs, and the thread
//   writes float(q) * scale rounded to bf16 (_dequant_block's rule, as
//   load_dequant in common.cuh) over the stage in the swizzled layout; the
//   CTA syncs and the products read it.  The dequant of a tile runs before
//   that tile's products and is not overlapped with them inside the CTA:
//   the other CTA on the SM keeps the tensor cores busy meanwhile.  The
//   int8 bytes and their scales are the only prefix bytes that cross HBM.
// - Head dims 64, 96, 128 and 256 (tc_common.cuh tc_width): rows of
//   tc_width<D>() elements, copies of the D / 8 real chunks of a row, S
//   over the real columns (mma.sync steps, or the wgmma steps of the real
//   boxes' columns); the wgmma P V fills pad output columns of the last
//   box that the store skips.  An int8 row's raw bytes sit in the upper
//   half of the stage in rows of tc_width<D>() bytes.  At D 256 the O
//   accumulators take 128 registers a thread and the ring 224 KB, one CTA a
//   SM; the dequant reads a row's raw chunks in two halves (the first
//   half's bf16 lands below the raw area, so it needs no barrier), so no
//   thread holds a whole 256-byte row in registers.
// - The key walk (KeyWalk, tc_common.cuh): the prefix run [lo, min(base,
//   P * page)), then the fresh run [base, base + r0 + rows), each in 64-key
//   tiles aligned within the run; key tiles in the causal future, past
//   q_len or behind the window floor are never loaded, and element masks
//   apply only on tiles that cross the diagonal, the window floor, the
//   prefix's reach or a length edge.
#pragma once

#include "tc_common.cuh"

namespace dyn {

constexpr int RT_STAGES = 3;  // K/V ring

// Q plus the K/V ring, in rows of tc_width<D>() elements
template <int D>
constexpr size_t ragged_tc_smem_bytes() {
    return sizeof(__nv_bfloat16) * (size_t)(64 + 2 * RT_STAGES * TC_BN) * tc_width<D>();
}

// 16 int8 values dequantized by ``scale`` to bf16 (float(q) * scale, one
// rounding to bf16): the low and high 8 as two 16-byte chunks.  The int8 to
// f32 conversion is exact: 0x4B0000xx is 2^23 + xx, with the bytes biased
// to unsigned by the xor.
__device__ __forceinline__ void dequant16(const uint4& w, float scale, uint4& lo, uint4& hi) {
    const uint32_t* x = reinterpret_cast<const uint32_t*>(&w);
    uint32_t out[8];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
        const uint32_t u = x[k] ^ 0x80808080u;
        float f[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
            f[e] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650 + e)) - 8388736.f;
        out[2 * k] = pack_bf16(f[0] * scale, f[1] * scale);
        out[2 * k + 1] = pack_bf16(f[2] * scale, f[3] * scale);
    }
    lo = make_uint4(out[0], out[1], out[2], out[3]);
    hi = make_uint4(out[4], out[5], out[6], out[7]);
}

// Launch with 128 threads and ragged_tc_smem_bytes<D>() of dynamic shared
// memory; the kernel declares no static shared memory, so the dynamic block
// starts 1024-byte aligned, as the wgmma descriptors of the 128-byte swizzle
// need (checked: a misaligned block traps).
template <int D, bool QUANT>
__global__ void __launch_bounds__(128)
ragged_tc_kernel(const __nv_bfloat16* __restrict__ q,   // [Np, Hq, D] (rectangle [B S, Hq, D])
                 const __nv_bfloat16* __restrict__ fk,  // [Np, Hkv, D]
                 const __nv_bfloat16* __restrict__ fv,  // [Np, Hkv, D]
                 const void* __restrict__ pool,         // [L, 2, N, page, Hkv, D], bf16 or int8
                 const float* __restrict__ scales,      // [L, 2, N, page] (QUANT only)
                 const int* __restrict__ table,         // [B, P]
                 const int* __restrict__ base_arr,      // [B]
                 const int* __restrict__ seg_off,       // [B], or null: the rectangle, b * S
                 const int* __restrict__ q_lens,        // [B]
                 __nv_bfloat16* __restrict__ out,       // [Np, Hq, D], zeroed
                 int Hkv, int nrep, int N, int page, int P, int layer, int window, int S,
                 float scale_log2) {
    using bf16 = __nv_bfloat16;
    constexpr int DP = tc_width<D>();  // shared row width
    constexpr int HALVES = DP / 64;    // 64-column boxes of a row
    constexpr int BOX = 64 * 64;       // elements of one box
    constexpr int AREA = HALVES * BOX;
    constexpr int CPR = DP / 8;        // 16-byte chunks of a shared bf16 row
    constexpr int CR = D / 8;          // real 16-byte chunks of a bf16 row
    constexpr int RCHP = DP / 16;      // 16-byte chunks of a shared int8 row
    constexpr int RCH = D / 16;        // real 16-byte chunks of an int8 row
    const GroupDiv rep(nrep);          // divides by the GQA group
    const int TQ = rep.div(64);        // query rows per CTA

    const int b = blockIdx.z;
    const int g = blockIdx.y;
    const int r0 = blockIdx.x * TQ;
    const int q_len = min(q_lens[b], S);  // a lane owns at most S rows
    if (r0 >= q_len) return;
    const int rows = min(TQ, q_len - r0);  // valid query rows of this CTA
    const int base = base_arr[b];
    const int off = seg_off != nullptr ? seg_off[b] : b * S;
    const size_t row_stride = (size_t)Hkv * D;  // elements per position
    const size_t q_stride = row_stride * nrep;
    const size_t page_rows = (size_t)N * page;  // pool rows of one (layer, k|v)
    const size_t kv_stride = page_rows * row_stride;
    const int* lane_table = table + (size_t)b * P;
    const size_t q_at = ((size_t)(off + r0) * Hkv * nrep + (size_t)g * nrep) * D;
    const bf16* q_tile = q + q_at;  // vector i at (i / nrep) * q_stride + (i % nrep) * D
    bf16* o_tile = out + q_at;
    const size_t f_at = (size_t)off * row_stride + (size_t)g * D;  // fresh row 0
    const size_t pool_at = (size_t)layer * 2 * kv_stride + (size_t)g * D;
    const float* s_k = QUANT ? scales + (size_t)layer * 2 * page_rows : nullptr;
    // prefix positions past the table are unreachable
    const KeyWalk walk(base, P * page, r0, rows, window);

    extern __shared__ __align__(1024) unsigned char smem_raw[];
    if (smem_addr(smem_raw) & 1023) __trap();
    bf16* sQ = reinterpret_cast<bf16*>(smem_raw);  // [HALVES][64][64]
    bf16* sK = sQ + AREA;                           // [STAGES][HALVES][64][64]
    bf16* sV = sK + RT_STAGES * AREA;

    const int tid = threadIdx.x;

    // query vectors past the valid rows are zeros
    for (int i = tid; i < 64 * CR; i += 128) {
        const int v = i / CR;
        const int c = i % CR;
        const int vr = rep.div(v);
        const bool ok = vr < rows;
        const bf16* src = q_tile + (size_t)(ok ? vr : 0) * q_stride + (v - vr * nrep) * D + c * 8;
        cp_async16(smem_addr(sQ + box_at(v, c)), src, ok);
    }

    // Pool rows (page id * page + slot) of prefix positions pos, pos + STEP,
    // ... (K of them), valid ones only (j < nv), without a division each.
    auto slots = [&](int pos, int j, int nv, auto& out) {
        constexpr int K = sizeof(out) / sizeof(out[0]);
        constexpr int STEP = 64 / K;
        int pg = pos / page;
        int sl = pos - pg * page;
#pragma unroll
        for (int k = 0; k < K; ++k) {
            out[k] = j + k * STEP < nv
                         ? (size_t)clampi(lane_table[pg], 0, N - 1) * page + (size_t)sl
                         : 0;
            sl += STEP;
            while (sl >= page) {
                sl -= page;
                ++pg;
            }
        }
    };

    // Starts the copies of tile t into ``stage`` (nothing past the walk);
    // returns the scale of the int8 row this thread dequantizes (row tid %
    // 64 of side tid / 64), 0 where there is none.  Thread tid copies chunk
    // tid % (chunks a shared row) of every (128 / chunks a shared row)-th
    // row, nothing for a pad chunk.
    auto issue = [&](int t, int stage) -> float {
        if (t >= walk.n_tiles) return 0.f;
        int mem0, pos0, nv;
        walk.at(t, mem0, pos0, nv);
        bf16* dk = sK + stage * AREA;
        bf16* dv = sV + stage * AREA;
        if (t >= walk.n_pre || !QUANT) {
            constexpr int ROWS = 64 * CPR / 128;  // rows a thread copies
            const int c = tid % CPR;
            const int j0 = tid / CPR;
            if (c >= CR) return 0.f;
            size_t at[ROWS];
            if (t >= walk.n_pre) {  // fresh rows
#pragma unroll
                for (int k = 0; k < ROWS; ++k) {
                    const int j = j0 + k * (64 / ROWS);
                    at[k] = f_at + (size_t)(pos0 - base + (j < nv ? j : 0)) * row_stride;
                }
            } else {
                slots(pos0 + j0, j0, nv, at);
#pragma unroll
                for (int k = 0; k < ROWS; ++k) at[k] = pool_at + at[k] * row_stride;
            }
            const bf16* src_k = t >= walk.n_pre ? fk : static_cast<const bf16*>(pool);
            const bf16* src_v = t >= walk.n_pre ? fv : src_k + kv_stride;
#pragma unroll
            for (int k = 0; k < ROWS; ++k) {
                const int j = j0 + k * (64 / ROWS);
                const bool ok = j < nv;
                cp_async16(smem_addr(dk + box_at(j, c)), src_k + at[k] + c * 8, ok);
                cp_async16(smem_addr(dv + box_at(j, c)), src_v + at[k] + c * 8, ok);
            }
            return 0.f;
        } else {
            // raw rows in the upper half of the K and V areas, row j's
            // chunk c at byte j * DP + (c ^ (j % RCHP)) * 16
            constexpr int ROWS = 64 * RCHP / 128;
            const int c = tid % RCHP;
            const int j0 = tid / RCHP;
            if (c < RCH) {
                size_t at[ROWS];
                slots(pos0 + j0, j0, nv, at);
                const int8_t* pk = static_cast<const int8_t*>(pool) + pool_at;
                unsigned char* rk = reinterpret_cast<unsigned char*>(dk) + AREA;
                unsigned char* rv = reinterpret_cast<unsigned char*>(dv) + AREA;
#pragma unroll
                for (int k = 0; k < ROWS; ++k) {
                    const int j = j0 + k * (64 / ROWS);
                    const bool ok = j < nv;
                    const int8_t* src = pk + at[k] * row_stride + c * 16;
                    const int to = j * DP + ((c ^ (j & (RCHP - 1))) << 4);
                    cp_async16(smem_addr(rk + to), src, ok);
                    cp_async16(smem_addr(rv + to), src + kv_stride, ok);
                }
            }
            const int j = tid & 63;
            size_t row[1];
            slots(pos0 + j, j, nv, row);
            return j < nv ? s_k[row[0] + (tid >> 6) * page_rows] : 0.f;
        }
    };

    // Dequantizes the landed int8 tile of ``stage`` in place (QUANT prefix
    // tiles); the caller syncs after it.  A thread reads its row's raw
    // chunks into registers before the barrier and writes them after it,
    // over the raw area.  At D 256 a whole row (16 chunks, 64 registers)
    // would spill beside O's 128 accumulators, so there the first half
    // goes first: raw chunks c < RCHP / 2 become bf16 columns below DP / 2,
    // in the lower half of the stage, which holds no raw byte, and are
    // written before the barrier.  (Below D 256 that split read 2 to 3%
    // slower on an H100 in the int8 entries at Llama-3-8B's shapes.)
    auto dequant = [&](int stage, float scale) {
        constexpr int LOW = D > 128 ? RCHP / 2 : 0;
        const int j = tid & 63;
        bf16* dst = (tid < 64 ? sK : sV) + stage * AREA;
        const unsigned char* raw = reinterpret_cast<const unsigned char*>(dst) + AREA;
        auto put = [&](int c, const uint4& w) {
            uint4 lo, hi;
            dequant16(w, scale, lo, hi);
            *reinterpret_cast<uint4*>(dst + box_at(j, 2 * c)) = lo;
            *reinterpret_cast<uint4*>(dst + box_at(j, 2 * c + 1)) = hi;
        };
        auto get = [&](int c) {
            return *reinterpret_cast<const uint4*>(raw + j * DP + ((c ^ (j & (RCHP - 1))) << 4));
        };
#pragma unroll
        for (int c = 0; c < LOW; ++c) put(c, get(c));
        uint4 w[RCH - LOW > 0 ? RCH - LOW : 1];
#pragma unroll
        for (int c = LOW; c < RCH; ++c) w[c - LOW] = get(c);
        __syncthreads();  // every raw row is read before any is overwritten
#pragma unroll
        for (int c = LOW; c < RCH; ++c) put(c, w[c - LOW]);
    };

    // The ring: tiles t + 1 and t + 2 load while ``products(t, stage)`` runs
    // on tile t, which has landed (and is dequantized) in ``stage``.
    auto ring = [&](auto&& products) {
        float sc_a = issue(0, 0);
        cp_async_commit();
        float sc_b = issue(1, 1);
        cp_async_commit();
        for (int t = 0; t < walk.n_tiles; ++t) {
            const int stage = t % RT_STAGES;
            const float sc = sc_a;
            sc_a = sc_b;
            cp_async_wait<1>();
            fence_proxy_async();
            __syncthreads();  // tile t landed; every warp is done with tile t - 1
            sc_b = issue(t + 2, (t + 2) % RT_STAGES);
            cp_async_commit();
            if (QUANT && t < walk.n_pre) {
                dequant(stage, sc);
                fence_proxy_async();
                __syncthreads();
            }
            products(t, stage);
        }
        cp_async_wait<0>();
    };

    const int warp = tid >> 5;
    const int lane = tid & 31;
    const int tq = lane & 3;
    const int qrow0 = base + r0;

    float o[D / 8][4];
#pragma unroll
    for (int i = 0; i < D / 8; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
    RowSoftmax sm;

    // O += P V over the 16 keys of ``v_st`` from row ``k0``, P in ``pa``
    auto pv16 = [&](const bf16* v_st, int k0, const uint32_t (&pa)[4]) {
#pragma unroll
        for (int dp = 0; dp < D / 16; ++dp) {
            uint32_t bv[4];
            const int vr = k0 + (lane & 7) + (((lane >> 3) & 1) << 3);
            ldmatrix_x4_trans(bv, smem_addr(v_st + box_at(vr, 2 * dp + (lane >> 4))));
            mma_16816(o[2 * dp], pa, bv[0], bv[1]);
            mma_16816(o[2 * dp + 1], pa, bv[2], bv[3]);
        }
    };
    // s (query vectors 0 .. 15 x NT 8-key columns from key row ``k0`` of
    // ``k_st``) = Q K^T
    auto qk = [&](auto& s, const bf16* k_st, int k0) {
        constexpr int NT = sizeof(s) / sizeof(s[0]);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
        for (int kd = 0; kd < D / 16; ++kd) {
            uint32_t a[4];
            ldmatrix_x4(a, smem_addr(sQ + box_at(lane & 15, 2 * kd + (lane >> 4))));
#pragma unroll
            for (int np = 0; np < NT / 2; ++np) {
                uint32_t bk[4];
                const int kr = k0 + 16 * np + (lane & 7) + ((lane >> 4) << 3);
                ldmatrix_x4(bk, smem_addr(k_st + box_at(kr, 2 * kd + ((lane >> 3) & 1))));
                mma_16816(s[2 * np], a, bk[0], bk[1]);
                mma_16816(s[2 * np + 1], a, bk[2], bk[3]);
            }
        }
    };

    const int wr = warp * 16;  // the warp's first query vector
    if (rows * nrep <= 16) {
        // Every live query vector sits in warp 0's 16 rows (decode lanes):
        // the warps split each key tile, warp w taking keys 16 w .. 16 w +
        // 15 for vectors 0 .. 15 under its own softmax, and merge at the end.
        const int wq_lo = qrow0;
        const int wq_hi = qrow0 + rep.div(15);
        const int qpos0 = qrow0 + rep.div(lane >> 2);
        const int qpos1 = qrow0 + rep.div((lane >> 2) + 8);
        ring([&](int t, int stage) {
            int mem0, pos0, nv;
            walk.at(t, mem0, pos0, nv);
            const int k0 = 16 * warp;
            if (k0 >= nv) return;  // warp-uniform: no valid key in this quarter
            float s[2][4];
            qk(s, sK + stage * AREA, k0);
            const int kp0 = pos0 + k0;
            const bool edge = nv - k0 < 16 || kp0 + 15 > wq_lo ||
                              (window > 0 && wq_hi - kp0 >= window);
            float a0, a1;
            sm.step(s, a0, a1, edge, kp0, nv - k0, qpos0, qpos1, window, scale_log2, tq);
#pragma unroll
            for (int i = 0; i < D / 8; ++i) {
                o[i][0] *= a0;
                o[i][1] *= a0;
                o[i][2] *= a1;
                o[i][3] *= a1;
            }
            uint32_t pa[1][4];
            p_fragments(s, pa);
            pv16(sV + stage * AREA, k0, pa[0]);
        });
        __syncthreads();  // the ring is drained: its stages hold the partials
        merge_warps<D>(o, sm, reinterpret_cast<float*>(sK));
    } else {
        const int wq_lo = qrow0 + rep.div(wr);
        const int wq_hi = qrow0 + rep.div(wr + 15);
        const int qpos0 = qrow0 + rep.div(wr + (lane >> 2));
        const int qpos1 = qrow0 + rep.div(wr + (lane >> 2) + 8);
        float s[8][4];
        uint32_t pa[4][4];
        float oh[HALVES][8][4];
#pragma unroll
        for (int hd = 0; hd < HALVES; ++hd)
#pragma unroll
            for (int i = 0; i < 8; ++i)
                oh[hd][i][0] = oh[hd][i][1] = oh[hd][i][2] = oh[hd][i][3] = 0.f;
        ring([&](int t, int stage) {
            int mem0, pos0, nv;
            walk.at(t, mem0, pos0, nv);
            fence_acc(s);
            wgmma_fence();
#pragma unroll
            for (int hd = 0; hd < HALVES; ++hd) {
                const uint64_t dq = sw128_desc(sQ + hd * BOX);
                const uint64_t dk = sw128_desc(sK + stage * AREA + hd * BOX);
#pragma unroll
                for (int kd = 0; kd < 4; ++kd)
                    if (64 * hd + 16 * kd < D) wgmma_ss(s, dq + 2 * kd, dk + 2 * kd, hd | kd);
            }
            wgmma_commit();
            wgmma_wait<0>();
            fence_acc(s);
            const bool edge = nv < TC_BN || pos0 + TC_BN - 1 > wq_lo ||
                              (window > 0 && wq_hi - pos0 >= window);
            float a0, a1;
            sm.step(s, a0, a1, edge, pos0, nv, qpos0, qpos1, window, scale_log2, tq);
#pragma unroll
            for (int hd = 0; hd < HALVES; ++hd) {
#pragma unroll
                for (int i = 0; i < 8; ++i) {
                    oh[hd][i][0] *= a0;
                    oh[hd][i][1] *= a0;
                    oh[hd][i][2] *= a1;
                    oh[hd][i][3] *= a1;
                }
                fence_acc(oh[hd]);
            }
            p_fragments(s, pa);
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < 4; ++kk)
#pragma unroll
                for (int hd = 0; hd < HALVES; ++hd)
                    wgmma_rs(oh[hd], pa[kk],
                             sw128_desc(sV + stage * AREA + hd * BOX) + 128 * kk);
            wgmma_commit();
            wgmma_wait<0>();
#pragma unroll
            for (int hd = 0; hd < HALVES; ++hd) fence_acc(oh[hd]);
        });
#pragma unroll
        for (int i = 0; i < D / 8; ++i)  // the real columns
#pragma unroll
            for (int e = 0; e < 4; ++e) o[i][e] = oh[i / 8][i % 8][e];
        fence_proxy_async();
    }
    __syncthreads();  // every warp is done with sQ
    store_rows<D, DP>(o, sm, sQ, wr, rows, rows, rep, o_tile, q_stride);
}

}  // namespace dyn
