// The bf16 paged decode attention kernel on Hopper's tensor cores (sm_90a),
// behind the bf16 entry of paged_decode_attention.cu.  Lane b's one query
// token (the nrep query heads of KV head g) attends to the lane's cached
// positions [lo, hi): hi = min(kv_len, P * page), lo = kv_len - window with
// a window, else 0, read through its page-table row (ids clamped into
// [0, N - 1]).  Scores and the online softmax in f32, P rounded to bf16 for
// P V as the Pallas kernel's probs.astype(v.dtype), the row sum l from the
// f32 P; a lane with no position writes zeros.
//
// What bounds it on an H100: bytes.  Every live K/V row is read once for
// nrep query vectors, 4 * nrep flops a byte against the ~295 where the
// tensor cores would set the limit.  So the work is to keep enough bytes
// in flight on every SM:
//
// - Split-K over positions across CTAs.  The grid is (split, KV head,
//   lane); split s owns positions [s * chunk, (s + 1) * chunk), chunk a
//   multiple of 64.  The wrapper picks the splits from what the host knows
//   (table width, B, Hkv, SM count; never kv_lens, which stay on the card):
//   as many as fill the card's two resident CTAs a SM were every lane as
//   long as the table.  At B = 8, 8 KV heads and a 2048-position table on
//   an H100 that is 4 splits of 512, 256 CTAs, where one CTA per (lane, KV
//   head) gave 64, each walking up to 1 MB alone.  A split past the lane's
//   hi or below its lo exits at once.
// - The body follows the decode lanes of ragged_tc_kernel (ragged_tc.cuh):
//   64-key K/V tiles gathered through the page table by 16-byte cp.async
//   into a ring of three 128-byte-swizzled stages, tiles t + 1 and t + 2
//   in flight while t computes; the group's nrep query vectors in the
//   first rows of an m16 tile (zero rows pad the rest: up to 16 query heads
//   a KV head fit the same design, so the group is a runtime argument and
//   the kernel is instantiated by head dim alone), S = Q K^T and O += P V
//   on mma.sync m16n8k16; each warp takes 16 keys of every tile under its
//   own softmax and the four warps merge (m, l, O) in shared memory
//   (merge_warps).
// - Head dims.  Shared rows are tc_width<D>() wide (D 96 in 128-element
//   rows; tc_common.cuh); the copies move the D / 8 real chunks of a row,
//   and the products step over the real columns only, so the pad columns
//   are never read.  At D <= 128 the query tile's A fragments stay in
//   registers for the whole walk; at D 256 they are read again from shared
//   memory each tile (ldmatrix), since the 128 f32 accumulators of O leave
//   no room for 64 more registers of Q without spilling.  Shared memory
//   (decode_tc_smem_bytes) sets the CTAs a SM holds: one at D 256 (200 KB),
//   two at D 96 and 128, four at D 64; the wrapper's split rule asks the
//   occupancy query for them (paged_decode_tc_ctas_per_sm).
// - The splits' states merge in a second pass.  A lane whose positions
//   fall in one split has that split write its output directly, and a lane
//   with none has split 0 write zeros.  Otherwise each live split writes
//   its merged (m, l) (log2 domain) and unnormalized f32 O to a workspace
//   [B, Hq, splits, D] plus [B, Hq, splits, 2], and
//   paged_decode_merge_kernel (one CTA per lane and query head; not
//   launched for a table within one split) rescales and sums the lane's
//   live splits, which it finds from kv_lens as the split kernel does.
//   Its maximum starts at the finite NEG, so no -inf - -inf appears.
//   (The lane's last split merging behind a counter, in place of the second
//   kernel, and a 5-stage ring at one CTA a SM both ran slower on an H100;
//   PERF.md has the times.)
#pragma once

#include "tc_common.cuh"

namespace dyn {

constexpr int DT_STAGES = 3;  // K/V ring

// Q (16 rows) plus the K/V ring, in rows of tc_width<D>() elements
template <int D>
constexpr size_t decode_tc_smem_bytes() {
    return sizeof(__nv_bfloat16) * (size_t)(16 + 2 * DT_STAGES * TC_BN) * tc_width<D>();
}

// A lane's attended positions [lo, hi) and its live splits [s_lo, s_hi].
struct DecodeSpan {
    int lo, hi, s_lo, s_hi;

    __device__ DecodeSpan(int kv_len, int reach, int window, int chunk) {
        hi = min(kv_len, reach);
        lo = window > 0 ? max(0, kv_len - window) : 0;
        s_lo = lo / chunk;
        s_hi = hi > lo ? (hi - 1) / chunk : s_lo - 1;
    }
    __device__ int live() const { return s_hi - s_lo + 1; }
};

// Launch with grid (splits, Hkv, B), 128 threads and decode_tc_smem_bytes<D>()
// of dynamic shared memory; nrep (the GQA group) is at most 16.
template <int D>
__global__ void __launch_bounds__(128)
paged_decode_tc_kernel(const __nv_bfloat16* __restrict__ q,     // [B, Hq, D]
                       const __nv_bfloat16* __restrict__ pool,  // [L, 2, N, page, Hkv, D]
                       const int* __restrict__ table,           // [B, P]
                       const int* __restrict__ kv_lens,         // [B]
                       float* __restrict__ ws_o,                // [B, Hq, splits, D]
                       float* __restrict__ ws_ml,               // [B, Hq, splits, 2]
                       __nv_bfloat16* __restrict__ out,         // [B, Hq, D]
                       int Hkv, int nrep, int N, int page, int P, int layer, int window,
                       int chunk, float scale_log2) {
    using bf16 = __nv_bfloat16;
    constexpr int DP = tc_width<D>();       // shared row width
    constexpr int HALVES = DP / 64;
    constexpr int AREA = HALVES * 64 * 64;  // elements of one K or V stage
    constexpr int CPR = DP / 8;             // 16-byte chunks of a shared row
    constexpr int CR = D / 8;               // real 16-byte chunks of a row
    constexpr bool Q_REGS = D <= 128;       // Q's A fragments held in registers

    const int split = blockIdx.x;
    const int g = blockIdx.y;
    const int b = blockIdx.z;
    const int splits = gridDim.x;
    const int kv_len = kv_lens[b];
    const DecodeSpan span(kv_len, P * page, window, chunk);
    const int start = max(split * chunk, span.lo);
    const int end = min(split * chunk + chunk, span.hi);
    if (start >= end) {
        if (split == 0 && span.live() == 0) {  // a lane with no position: zeros
            for (int i = threadIdx.x; i < nrep * D; i += blockDim.x)
                out[((size_t)b * Hkv * nrep + (size_t)g * nrep) * D + i] = __float2bfloat16(0.f);
        }
        return;
    }
    const int pos_base = start & ~(TC_BN - 1);  // tiles aligned to 64 positions
    const int n_tiles = (end - pos_base + TC_BN - 1) / TC_BN;

    const int Hq = Hkv * nrep;
    const size_t row_stride = (size_t)Hkv * D;  // elements per pool row
    const size_t kv_stride = (size_t)N * page * row_stride;
    const bf16* pool_k = pool + (size_t)layer * 2 * kv_stride + (size_t)g * D;
    const int* lane_table = table + (size_t)b * P;
    const size_t head0 = (size_t)b * Hq + (size_t)g * nrep;  // the group's first query head

    extern __shared__ __align__(16) unsigned char smem_raw[];
    bf16* sQ = reinterpret_cast<bf16*>(smem_raw);  // [HALVES][16][64]
    bf16* sK = sQ + HALVES * 16 * 64;             // [STAGES][HALVES][64][64]
    bf16* sV = sK + DT_STAGES * AREA;

    const int tid = threadIdx.x;
    const int warp = tid >> 5;
    const int lane = tid & 31;
    const int tq = lane & 3;
    // element offset of chunk c of query row r (a [16][64] box per half)
    auto q_at = [](int r, int c) {
        return (c >> 3) * 16 * 64 + r * 64 + (((c & 7) ^ (r & 7)) << 3);
    };

    // rows nrep .. 15 of the query tile are zeros
    for (int i = tid; i < 16 * CR; i += 128) {
        const int r = i / CR;
        const int c = i % CR;
        const bool ok = r < nrep;
        cp_async16(smem_addr(sQ + q_at(r, c)), q + (head0 + (ok ? r : 0)) * D + c * 8, ok);
    }

    // Starts the copies of tile t into ``stage`` (nothing past the last
    // tile): thread tid copies chunk tid % CPR of every (128 / CPR)-th row
    // (nothing for a pad chunk), zero-filling rows outside [start, end);
    // its table reads come first.
    auto issue = [&](int t, int stage) {
        constexpr int ROWS = 64 * CPR / 128;  // rows a thread copies
        constexpr int STEP = 64 / ROWS;
        const int c = tid % CPR;
        const int j0 = tid / CPR;
        if (t >= n_tiles || c >= CR) return;
        const int pos0 = pos_base + t * TC_BN;
        int pg = (pos0 + j0) / page;
        int sl = pos0 + j0 - pg * page;
        size_t at[ROWS];
#pragma unroll
        for (int k = 0; k < ROWS; ++k) {
            const int pos = pos0 + j0 + k * STEP;
            at[k] = pos >= start && pos < end
                        ? ((size_t)clampi(lane_table[pg], 0, N - 1) * page + sl) * row_stride
                        : 0;
            sl += STEP;
            while (sl >= page) {
                sl -= page;
                ++pg;
            }
        }
        bf16* dk = sK + stage * AREA;
        bf16* dv = sV + stage * AREA;
#pragma unroll
        for (int k = 0; k < ROWS; ++k) {
            const int j = j0 + k * STEP;
            const int pos = pos0 + j;
            const bool ok = pos >= start && pos < end;
            cp_async16(smem_addr(dk + box_at(j, c)), pool_k + at[k] + c * 8, ok);
            cp_async16(smem_addr(dv + box_at(j, c)), pool_k + kv_stride + at[k] + c * 8, ok);
        }
    };

    float o[D / 8][4];
#pragma unroll
    for (int i = 0; i < D / 8; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
    RowSoftmax sm;
    uint32_t qa[Q_REGS ? D / 16 : 1][4];  // the query tile's A fragments (D <= 128)
    const int qpos = kv_len - 1;
    const int k0 = 16 * warp;  // the warp's keys in every tile

    issue(0, 0);
    cp_async_commit();  // Q rides with tile 0
    issue(1, 1);
    cp_async_commit();
    for (int t = 0; t < n_tiles; ++t) {
        const int stage = t % DT_STAGES;
        cp_async_wait<1>();
        __syncthreads();  // tile t landed; every warp is done with tile t - 1
        issue(t + 2, (t + 2) % DT_STAGES);
        cp_async_commit();
        if constexpr (Q_REGS) {
            if (t == 0) {
#pragma unroll
                for (int kd = 0; kd < D / 16; ++kd)
                    ldmatrix_x4(qa[kd], smem_addr(sQ + q_at(lane & 15, 2 * kd + (lane >> 4))));
            }
        }
        const int kp0 = pos_base + t * TC_BN + k0;
        const int nv = end - kp0;  // valid keys from kp0 (window floor aside)
        if (nv <= 0 || kp0 + 16 <= start) continue;  // warp-uniform: none in this quarter
        const bf16* k_st = sK + stage * AREA;
        const bf16* v_st = sV + stage * AREA;
        float s[2][4];
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
        for (int kd = 0; kd < D / 16; ++kd) {
            uint32_t bk[4];
            const int kr = k0 + (lane & 7) + ((lane >> 4) << 3);
            ldmatrix_x4(bk, smem_addr(k_st + box_at(kr, 2 * kd + ((lane >> 3) & 1))));
            if constexpr (Q_REGS) {
                mma_16816(s[0], qa[kd], bk[0], bk[1]);
                mma_16816(s[1], qa[kd], bk[2], bk[3]);
            } else {
                uint32_t a[4];
                ldmatrix_x4(a, smem_addr(sQ + q_at(lane & 15, 2 * kd + (lane >> 4))));
                mma_16816(s[0], a, bk[0], bk[1]);
                mma_16816(s[1], a, bk[2], bk[3]);
            }
        }
        // keys at or past ``end`` by count, keys below the window floor
        // by the window rule (qpos - kpos < window); every key is in the
        // query's past
        const bool edge = nv < 16 || kp0 < start;
        float a0, a1;
        sm.step(s, a0, a1, edge, kp0, nv, qpos, qpos, window, scale_log2, tq);
#pragma unroll
        for (int i = 0; i < D / 8; ++i) {
            o[i][0] *= a0;
            o[i][1] *= a0;
            o[i][2] *= a1;
            o[i][3] *= a1;
        }
        uint32_t pa[1][4];
        p_fragments(s, pa);
#pragma unroll
        for (int dp = 0; dp < D / 16; ++dp) {
            uint32_t bv[4];
            const int vr = k0 + (lane & 7) + (((lane >> 3) & 1) << 3);
            ldmatrix_x4_trans(bv, smem_addr(v_st + box_at(vr, 2 * dp + (lane >> 4))));
            mma_16816(o[2 * dp], pa[0], bv[0], bv[1]);
            mma_16816(o[2 * dp + 1], pa[0], bv[2], bv[3]);
        }
    }
    cp_async_wait<0>();
    __syncthreads();  // the ring is drained: its stages hold the partials
    merge_warps<D>(o, sm, reinterpret_cast<float*>(sK));
    if (warp != 0) return;
    if (span.live() == 1) {
        // the lane's only live split: its output, normalised
        store_rows<D, DP>(o, sm, sQ, 0, 1, 1, GroupDiv(nrep), out + head0 * D, (size_t)Hq * D);
        return;
    }
    const int r = lane >> 2;  // query head r of the group: row r of the tile
    if (r >= nrep) return;
    float* wo = ws_o + ((head0 + r) * splits + split) * D;
#pragma unroll
    for (int i = 0; i < D / 8; ++i)
        *reinterpret_cast<float2*>(wo + 8 * i + 2 * tq) = make_float2(o[i][0], o[i][1]);
    if (tq == 0) {
        float* wml = ws_ml + ((head0 + r) * splits + split) * 2;
        wml[0] = sm.m0;
        wml[1] = sm.l0;
    }
}

// Launch with grid (Hq, B) and D threads: element d of lane b's query head
// h, merged over the lane's live splits where it has more than one (the
// split kernel wrote the others' outputs).
template <int D>
__global__ void __launch_bounds__(D)
paged_decode_merge_kernel(const float* __restrict__ ws_o, const float* __restrict__ ws_ml,
                          const int* __restrict__ kv_lens, __nv_bfloat16* __restrict__ out,
                          int reach, int window, int chunk, int splits) {
    const int h = blockIdx.x;
    const int b = blockIdx.y;
    const int d = threadIdx.x;
    const size_t head = (size_t)b * gridDim.x + h;
    const DecodeSpan span(kv_lens[b], reach, window, chunk);
    if (span.live() <= 1) return;
    const float* ml = ws_ml + head * splits * 2;
    const float* o = ws_o + head * splits * D + d;
    float M = NEG;
    for (int s = span.s_lo; s <= span.s_hi; ++s) M = fmaxf(M, ml[2 * s]);
    float L = 0.f, O = 0.f;
    for (int s = span.s_lo; s <= span.s_hi; ++s) {
        const float f = exp2f(ml[2 * s] - M);
        L += ml[2 * s + 1] * f;
        O += o[(size_t)s * D] * f;
    }
    out[head * D + d] = __float2bfloat16(O / L);
}

}  // namespace dyn
