// K1: causal GQA flash prefill attention plus SnapKV window-score emission,
// for Hopper (sm_90a), bf16 in, fp32 accumulation, with the sliding-window,
// chunk (row_offset) and MInference block-sparse (a-shape, vertical-slash)
// variants and the (m, l) output of a ring-attention hop.
//
// Replaces the Pallas TPU kernel
//   kvcache_factory_tpu/ops/kernels/flash_prefill.py::_flash_kernel
// (dense causal path with score emission, `sliding_window`, chunk mode, the
// sparse patterns: block_selected and the sparse body :222-252, the sparse
// score re-sweep :327-344, the pattern setup :543-568; and `return_ml`,
// :288-297, the per-row (m, l) that ring attention folds across hops).
//
// What it computes, per example b and query head hq (kv head hq / G), for
// q row r at global id R = row_offset[b] + r (row_offset 0 outside chunk
// mode):
//   out[r]   = softmax_c(q[r].k[c] / sqrt(D)) . v  over the visible columns
//              c <= min(R, tl-1, S_k-1) and, with a sliding window SW,
//              c > R - SW
//   scores[c]= sum over window rows r in [tl-W, tl), c <= r, of the final
//              normalized probability exp(s_rc - m_r) / l_r
// With a block mask M [B, Hq, n_blk, n_blk] of pattern block P, row r also
// needs M[b, hq, r / P, c / P] != 0 for column c, and the scores sum that
// sparse softmax.  Scores need whole-sequence queries without a sliding
// window, so W > 0 excludes SW and chunk mode; a block mask excludes chunk
// mode (the wrapper and the host function check).
// With an (m, l) output (the ring-attention hop, K1-ml) each row also writes
// its final online-softmax max m and sum l over the columns it saw in this
// call, fp32 [B, Hq, S_q] each, in natural-log units; a row that saw none
// writes m = -FLT_MAX, l = 0 and a zero output, so the hop combine weighs it
// to nothing (the TPU kernel leaves l at the folded column count there; both
// fold to zero).  A hop's keys are one shard (true_len may exceed S_k), and
// its offset rows can sit so far past the shard that a tile's window starts
// beyond the last key: its list of key tiles is then empty.
// The softmax is online and in fp32; probabilities are rounded to bf16
// before the PV product, as the TPU kernel does.  Rows at or past true_len
// in a CTA that holds no valid row are written as zeros (an inert chunk-pool
// row, true_len 0, comes out all zeros).
//
// What bounds it: the QK and PV products of the visible (row, column) pairs,
// 4 * D FLOP a pair: at S 32768 that is 8.5 ms of dense bf16 at 989 TFLOP/s
// against 0.03 ms of q/k/v/out bytes, so it is bound by the tensor cores,
// and only wgmma reaches their full rate.  A window or a block mask cuts the
// pairs, not the kind of bound.
//
// Design.  One CTA of three warpgroups per (128 q rows, hq, b): warpgroup 2
// is the producer, warpgroups 0 and 1 are consumers of 64 q rows each
// (setmaxnreg moves registers from the producer, 40 a thread, to the
// consumers, 232).  Against the six things that held the earlier kernel
// back (mma.sync m16n8k16, synchronous loads, scalar V fragments, 64-row
// tiles, per-element masks everywhere, ascending tile order):
//  1. Both products are wgmma m64n128k16: S = Q K^T with both operands in
//     shared memory (K-major), O += P V with P from registers and V from
//     shared memory (MN-major, the transpose flag), so V is never repacked.
//  2. One elected producer thread loads Q once and K and V per 128-key tile
//     with TMA into a 2-stage ring of 128-byte-swizzled shared memory, each
//     load completing on a `full` mbarrier; a stage is reused after both
//     consumers arrive on its `empty` mbarrier.  K and V have separate full
//     barriers, so QK^T starts while V is still landing, and the next tile's
//     copies run under this tile's math.  The tensor maps are 3-D over
//     [B*H, S, D] (two 64-column boxes a row), so rows past S_q or S_k come
//     back as zeros and never from the next head.
//  3. The wgmma operand descriptors read the swizzled tiles in place.
//  4. 128 q rows share each 32 KB K or V tile (twice the reuse of 64-row tiles).
//  5. Each consumer decides once per tile whether the tile is wholly
//     visible to its 64 rows (below the diagonal, inside every row's window,
//     below min(true_len, S_k), both 64-column halves selected); only the
//     diagonal, window-edge, length-edge and half-selected tiles take the
//     per-element mask.  The softmax runs in base 2 with scale * log2(e)
//     folded into the logits; (m, l) leave the kernel in natural-log units.
//     Masked logits are -FLT_MAX, never -inf: a row whose first tiles hold
//     no visible column folds them against m = -FLT_MAX and its first
//     visible column rescales that by exp2(-FLT_MAX - m) = 0.
//  6. The grid is (hq, q tile, b) with the q tile reversed, so every head's
//     longest rows start first and the short ones fill the tail.
// Sparse patterns: P is a multiple of 64 (or one block covers the whole
// sequence), so each warpgroup's 64 rows lie in one q block and each
// 64-column half of a key tile in one k block.  The prologue reads the
// block mask once per (warpgroup, half) of every tile in the causal range
// and compacts the tiles that either warpgroup selects into a list in
// shared memory; the producer and the consumers walk that list, and a
// warpgroup skips the products of a listed tile it does not need.
//
// The window scores cannot accumulate across q tiles as the TPU's
// sequential grid lets them (CTAs run concurrently here, and float atomics
// would make the sums depend on the run).  Instead the main kernel stores
// each window row's final (m, l) in a [B, Hq, W, 2] buffer and a second
// small kernel, one CTA per (64-column tile, hq, b), recomputes the W x 64
// window logits, normalizes them with the stored (m, l) and sums over rows
// (with a block mask, only rows whose own q block selects the column's
// block): about W/S of the main work.  No atomics anywhere: two launches on
// the same inputs give bitwise-equal outputs.

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int D = 128;          // head_dim (the wrapper checks)
constexpr int BM = 128;         // q rows per CTA: two consumer warpgroups of 64
constexpr int BN = 128;         // keys per K/V tile
constexpr int HALF = 64;        // columns per TMA box: 128 bytes, the swizzle span
constexpr int STAGES = 2;       // K/V ring depth
constexpr int THREADS = 384;    // consumer warpgroups 0 and 1, producer warpgroup 2
constexpr int BOX_BYTES = 128 * HALF * 2;            // 16 KB: 128 rows x 64 columns
constexpr int TILE_BYTES = 2 * BOX_BYTES;            // 32 KB: 128 rows x D
constexpr int SMEM_K = TILE_BYTES;                   // after Q; stage s at + 2 s TILE_BYTES
constexpr int SMEM_BAR = TILE_BYTES * (1 + 2 * STAGES);  // 160 KB
constexpr int SMEM_CNT = SMEM_BAR + 64;              // per-warp counts of the list build
constexpr int SMEM_LIST = SMEM_BAR + 128;            // the compacted key-tile list
constexpr int SMEM_MAX = 232448;                     // the opt-in limit of a block
constexpr int EMPTY_ARRIVALS = 8;                    // the consumers' warps
constexpr uint32_t ALL_SELECTED = 0xFu;              // (warpgroup, half) bits of a tile
constexpr int WMAX = 64;        // largest observation window
constexpr int SBN = 64;         // columns per CTA of the window-score pass
constexpr int LDS = D + 8;      // its padded shared-memory row stride
constexpr float NEG_INF = -3.4028234663852886e38f;  // float32 finfo.min
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// --- shared memory, mbarriers and TMA --------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(bar) : "memory");
}

// Wait until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n\t.reg .pred P1;\n\t"
      "LAB_WAIT:\n\t"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n\t"
      "@P1 bra DONE;\n\t"
      "bra LAB_WAIT;\n\t"
      "DONE:\n\t}\n" :: "r"(bar), "r"(parity) : "memory");
}

// One box of a 3-D tensor map (columns, rows, head plane) into shared
// memory, completing on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int col, int row, int plane) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(row),
         "r"(plane) : "memory");
}

// --- wgmma --------------------------------------------------------------------

// Shared-memory matrix descriptor of a 128-byte-swizzled operand: start
// address, leading and stride byte offsets (16-byte units), layout B128.
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

// K-major rows of 128 bytes (a 64-column box): 8-row groups 1024 bytes apart.
__device__ __forceinline__ uint64_t desc_kmajor(uint32_t addr) {
  return gmma_desc(addr, 16, 1024);
}

// V as the MN-major B operand: 8-key groups 1024 bytes apart (stride), the
// second 64-column half of D one box further on (leading).
__device__ __forceinline__ uint64_t desc_v(uint32_t addr) {
  return gmma_desc(addr, BOX_BYTES, 1024);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from moving accesses of an accumulator across the
// asynchronous products.
__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

#define KVCF_D64                                                                        \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "  \
  "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "   \
  "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "   \
  "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"
#define KVCF_F8(d, i)                                                                  \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]),          \
      "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define KVCF_F64(d)                                                                    \
  KVCF_F8(d, 0), KVCF_F8(d, 8), KVCF_F8(d, 16), KVCF_F8(d, 24), KVCF_F8(d, 32),        \
      KVCF_F8(d, 40), KVCF_F8(d, 48), KVCF_F8(d, 56)

// d[64 x 128] (+)= A[64 x 16] B[16 x 128], both from shared memory, K-major.
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da, uint64_t db,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " KVCF_D64
      ", %64, %65, p, 1, 1, 0, 0;\n}\n"
      : KVCF_F64(d)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d[64 x 128] += A[64 x 16] B[16 x 128], A from registers (the m16n8k16
// A fragment per warp), B from shared memory, MN-major (transposed).
__device__ __forceinline__ void wgmma_rs(float (&d)[64], uint32_t a0, uint32_t a1,
                                         uint32_t a2, uint32_t a3, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " KVCF_D64
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : KVCF_F64(d)
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
}

__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// --- the main kernel ----------------------------------------------------------

__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap tm_q,
                 const __grid_constant__ CUtensorMap tm_k,
                 const __grid_constant__ CUtensorMap tm_v,
                 const int* __restrict__ true_len, const int* __restrict__ row_offset,
                 const int* __restrict__ block_mask, bf16* __restrict__ out,
                 float* __restrict__ win_ml, float* __restrict__ row_ml, int Hq,
                 int Hkv, int S_q, int S_k, int W, int SW, int P, int n_blk,
                 float scale_log2) {
  extern __shared__ unsigned char smem_raw[];
  // 128-byte swizzling repeats every 1024 bytes: align the tiles to that.
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const uint32_t sbase = smem_u32(smem);
  int* warp_cnt = reinterpret_cast<int*>(smem + SMEM_CNT);
  int* list = reinterpret_cast<int*>(smem + SMEM_LIST);
  const uint32_t bar_q = sbase + SMEM_BAR;
  auto k_full = [&](int s) { return bar_q + 8u * (1 + s); };
  auto v_full = [&](int s) { return bar_q + 8u * (1 + STAGES + s); };
  auto empty = [&](int s) { return bar_q + 8u * (1 + 2 * STAGES + s); };

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int hq = blockIdx.x, b = blockIdx.z;
  const int qt = gridDim.y - 1 - blockIdx.y;                // longest rows first
  const int hkv = hq / (Hq / Hkv);
  const int tl = true_len[b];
  const int lrow0 = qt * BM;                                // first local q row
  const int row0 = lrow0 + (row_offset ? row_offset[b] : 0);  // its global id
  const size_t bh = (size_t)b * Hq + hq;
  bf16* oh = out + bh * S_q * D;
  // (m, l) planes of this (b, hq): m at [0, S_q), l one plane further on.
  const size_t plane = (size_t)gridDim.z * Hq * S_q;
  float* mh = row_ml ? row_ml + bh * S_q : nullptr;

  if (row0 >= tl) {  // no valid row in this CTA (uniform)
    for (int i = tid; i < BM * (D / 8); i += THREADS) {
      const int r = lrow0 + i / (D / 8);
      if (r < S_q)
        *reinterpret_cast<uint4*>(oh + (size_t)r * D + (i % (D / 8)) * 8) = make_uint4(0, 0, 0, 0);
    }
    if (mh)
      for (int r = lrow0 + tid; r < min(lrow0 + BM, S_q); r += THREADS) {
        mh[r] = NEG_INF;
        mh[plane + r] = 0.f;
      }
    return;
  }

  // col > row OR col >= true_len OR col >= S_k collapses to col > min(row,
  // tl - 1, S_k - 1); only a ring hop has tl > S_k.  The key tiles from the
  // first that holds a column inside the first row's window to the causal
  // frontier; the range is empty only for a ring hop whose window starts
  // past the shard.
  const int col_max = min(tl, S_k) - 1;
  const int kv_end = min(min(row0 + BM, tl), S_k);
  const int kt_begin = SW > 0 ? max(row0 - SW + 1, 0) / BN : 0;
  const int kt_end = (kv_end + BN - 1) / BN;
  int n_list = max(kt_end - kt_begin, 0);

  if (tid == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(empty(s), EMPTY_ARRIVALS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (block_mask) {
    // Compact the tiles that either warpgroup selects (whole-sequence
    // queries: row0 is local).  Bit 2 wg + h of an entry says whether
    // warpgroup wg's q block selects the k block of the tile's half h; a
    // block index past the last (one block over the whole sequence) is the
    // last, whose columns or rows are masked anyway.
    const int* mb = block_mask + bh * n_blk * n_blk;
    const int qb0 = min(row0 / P, n_blk - 1), qb1 = min((row0 + HALF) / P, n_blk - 1);
    int base = 0;
    for (int start = kt_begin; start < kt_end; start += THREADS) {
      const int kt = start + tid;
      uint32_t sel = 0;
      if (kt < kt_end) {
        const int kb0 = min(kt * BN / P, n_blk - 1), kb1 = min((kt * BN + HALF) / P, n_blk - 1);
        sel = (mb[qb0 * n_blk + kb0] ? 1u : 0u) | (mb[qb0 * n_blk + kb1] ? 2u : 0u) |
              (mb[qb1 * n_blk + kb0] ? 4u : 0u) | (mb[qb1 * n_blk + kb1] ? 8u : 0u);
      }
      const unsigned bal = __ballot_sync(0xffffffffu, sel != 0);
      if (lane == 0) warp_cnt[warp] = __popc(bal);
      __syncthreads();
      int off = base, total = 0;
      for (int w = 0; w < THREADS / 32; ++w) {
        const int c = warp_cnt[w];
        total += c;
        if (w < warp) off += c;
      }
      if (sel) list[off + __popc(bal & ((1u << lane) - 1u))] = kt | (int)(sel << 24);
      base += total;
      __syncthreads();
    }
    n_list = base;
  }
  __syncthreads();  // barriers initialised, list complete

  if (warp >= 8) {
    // ---- producer warpgroup: one thread issues every copy ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (tid == 256 && n_list > 0) {
      mbar_expect_tx(bar_q, TILE_BYTES);
      tma_load(sbase, &tm_q, bar_q, 0, lrow0, (int)bh);
      tma_load(sbase + BOX_BYTES, &tm_q, bar_q, HALF, lrow0, (int)bh);
      const int plane_kv = b * Hkv + hkv;
      for (int i = 0; i < n_list; ++i) {
        const int s = i % STAGES;
        mbar_wait(empty(s), ((i / STAGES) & 1) ^ 1);  // the first pass finds it free
        const int kt = block_mask ? (list[i] & 0xFFFFFF) : kt_begin + i;
        const uint32_t kd = sbase + SMEM_K + s * 2 * TILE_BYTES, vd = kd + TILE_BYTES;
        mbar_expect_tx(k_full(s), TILE_BYTES);
        tma_load(kd, &tm_k, k_full(s), 0, kt * BN, plane_kv);
        tma_load(kd + BOX_BYTES, &tm_k, k_full(s), HALF, kt * BN, plane_kv);
        mbar_expect_tx(v_full(s), TILE_BYTES);
        tma_load(vd, &tm_v, v_full(s), 0, kt * BN, plane_kv);
        tma_load(vd + BOX_BYTES, &tm_v, v_full(s), HALF, kt * BN, plane_kv);
      }
    }
  } else {
    // ---- consumer warpgroups: 64 q rows each ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int wg = warp >> 2;
    const int g = lane >> 2, t = lane & 3;
    const int Rw0 = row0 + wg * HALF, Rw1 = Rw0 + HALF - 1;  // this warpgroup's rows
    const int ra = wg * HALF + (warp & 3) * 16 + g;          // this thread's first tile row
    const int o_lo = lrow0 + ra, o_hi = o_lo + 8;            // local rows (output)
    const int r_lo = row0 + ra, r_hi = r_lo + 8;             // global ids (masks)
    const int lim_lo = min(r_lo, col_max), lim_hi = min(r_hi, col_max);
    // The window hides col <= row - SW (no window: col <= -1, nothing).
    const int wlo_lo = SW > 0 ? r_lo - SW : -1, wlo_hi = SW > 0 ? r_hi - SW : -1;
    const int diag = min(Rw0, col_max), reach = min(Rw1, col_max);
    // Running max (base-2 logits) and this thread's share of the row sums.
    float m_lo = NEG_INF, m_hi = NEG_INF, l_lo = 0.f, l_hi = 0.f;
    float o[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) o[i] = 0.f;
    const uint32_t qa = sbase + wg * (HALF * 128);  // this warpgroup's 64 rows of Q

    if (n_list > 0) mbar_wait(bar_q, 0);
    for (int i = 0; i < n_list; ++i) {
      const int s = i % STAGES;
      const uint32_t ph = (i / STAGES) & 1;
      const int e = block_mask ? list[i] : (kt_begin + i) | (int)(ALL_SELECTED << 24);
      const int c0 = (e & 0xFFFFFF) * BN;
      const uint32_t sel = ((uint32_t)e >> (24 + 2 * wg)) & 3u;
      const uint32_t kd = sbase + SMEM_K + s * 2 * TILE_BYTES, vd = kd + TILE_BYTES;
      // Uniform over the warpgroup: no column of the tile reaches its rows;
      // or every column reaches every row.
      const bool skip = sel == 0 || c0 > reach || (SW > 0 && c0 + BN - 1 <= Rw0 - SW);
      const bool full = sel == 3u && c0 + BN - 1 <= diag && (SW == 0 || c0 > Rw1 - SW);
      mbar_wait(k_full(s), ph);
      if (!skip) {
        float sc[64];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const uint32_t off = (kk >> 2) * BOX_BYTES + (kk & 3) * 32;
          wgmma_ss(sc, desc_kmajor(qa + off), desc_kmajor(kd + off), kk);
        }
        wgmma_commit();
        wgmma_wait_all();
        fence_acc(sc);

        // Logits in base 2.  sc[4n + e]: row lo (e < 2) or hi, column
        // c0 + 8n + 2t + (e & 1), in half n / 8.
        float mx_lo = m_lo, mx_hi = m_hi;
        if (full) {
#pragma unroll
          for (int j = 0; j < 64; ++j) {
            sc[j] *= scale_log2;
            if ((j & 3) < 2) mx_lo = fmaxf(mx_lo, sc[j]); else mx_hi = fmaxf(mx_hi, sc[j]);
          }
        } else {
#pragma unroll
          for (int j = 0; j < 64; ++j) {
            const int col = c0 + (j >> 2) * 8 + t * 2 + (j & 1);
            const bool lo = (j & 3) < 2;
            const bool vis = col <= (lo ? lim_lo : lim_hi) && col > (lo ? wlo_lo : wlo_hi) &&
                             ((sel >> (j >> 5)) & 1u);
            sc[j] = vis ? sc[j] * scale_log2 : NEG_INF;
            if (lo) mx_lo = fmaxf(mx_lo, sc[j]); else mx_hi = fmaxf(mx_hi, sc[j]);
          }
        }
        // A row's 128 columns live in the 4 threads of one quad.
        mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, 1));
        mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, 2));
        mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, 1));
        mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, 2));
        const float a_lo = exp2f(m_lo - mx_lo), a_hi = exp2f(m_hi - mx_hi);
        m_lo = mx_lo;
        m_hi = mx_hi;
        float sum_lo = 0.f, sum_hi = 0.f;
#pragma unroll
        for (int j = 0; j < 64; ++j) {
          const bool lo = (j & 3) < 2;
          sc[j] = exp2f(sc[j] - (lo ? m_lo : m_hi));
          if (lo) sum_lo += sc[j]; else sum_hi += sc[j];
        }
        l_lo = l_lo * a_lo + sum_lo;
        l_hi = l_hi * a_hi + sum_hi;
        // P as the A fragments of the PV product: the accumulator of
        // columns [16 kk, 16 kk + 16) is the A fragment of k-step kk.
        uint32_t pa[32];
#pragma unroll
        for (int j = 0; j < 32; ++j) pa[j] = pack_f32(sc[2 * j], sc[2 * j + 1]);
#pragma unroll
        for (int j = 0; j < 64; ++j) o[j] *= (j & 3) < 2 ? a_lo : a_hi;

        mbar_wait(v_full(s), ph);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BN / 16; ++kk)
          wgmma_rs(o, pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2], pa[4 * kk + 3],
                   desc_v(vd + kk * 16 * 128));
        wgmma_commit();
        wgmma_wait_all();
        fence_acc(o);
      } else {
        mbar_wait(v_full(s), ph);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty(s));
    }

    l_lo += __shfl_xor_sync(0xffffffffu, l_lo, 1);
    l_lo += __shfl_xor_sync(0xffffffffu, l_lo, 2);
    l_hi += __shfl_xor_sync(0xffffffffu, l_hi, 1);
    l_hi += __shfl_xor_sync(0xffffffffu, l_hi, 2);
    // Natural-log units leave the kernel; an empty row keeps -FLT_MAX exactly.
    const float mn_lo = m_lo == NEG_INF ? NEG_INF : m_lo * LN2;
    const float mn_hi = m_hi == NEG_INF ? NEG_INF : m_hi * LN2;
    if (mh) {
      // A row that saw no column folded only masked logits (each exp2(0) = 1
      // against m = -FLT_MAX): report it as empty, with a zero output.
      if (m_lo == NEG_INF) {
        l_lo = 0.f;
#pragma unroll
        for (int j = 0; j < 64; ++j) if ((j & 3) < 2) o[j] = 0.f;
      }
      if (m_hi == NEG_INF) {
        l_hi = 0.f;
#pragma unroll
        for (int j = 0; j < 64; ++j) if ((j & 3) >= 2) o[j] = 0.f;
      }
      if (t == 0) {
        if (o_lo < S_q) { mh[o_lo] = mn_lo; mh[plane + o_lo] = l_lo; }
        if (o_hi < S_q) { mh[o_hi] = mn_hi; mh[plane + o_hi] = l_hi; }
      }
    }
    const float il_lo = 1.f / (l_lo == 0.f ? 1.f : l_lo);
    const float il_hi = 1.f / (l_hi == 0.f ? 1.f : l_hi);
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      if (o_lo < S_q)
        *reinterpret_cast<uint32_t*>(oh + (size_t)o_lo * D + n * 8 + t * 2) =
            pack_f32(o[4 * n] * il_lo, o[4 * n + 1] * il_lo);
      if (o_hi < S_q)
        *reinterpret_cast<uint32_t*>(oh + (size_t)o_hi * D + n * 8 + t * 2) =
            pack_f32(o[4 * n + 2] * il_hi, o[4 * n + 3] * il_hi);
    }

    // W > 0 only for whole-sequence queries (no offset): r == global id.
    if (W > 0 && t == 0) {  // final (m, l) of the observation-window rows
      const int ws = tl - W;
      float* ml = win_ml + bh * W * 2;
      if (r_lo >= ws && r_lo < tl) { ml[(r_lo - ws) * 2] = mn_lo; ml[(r_lo - ws) * 2 + 1] = l_lo; }
      if (r_hi >= ws && r_hi < tl) { ml[(r_hi - ws) * 2] = mn_hi; ml[(r_hi - ws) * 2 + 1] = l_hi; }
    }
  }
}

// --- the window-score pass ----------------------------------------------------

// Copy rows [row0, row0 + 64) of a [*, D] bf16 matrix into shared memory,
// zero-filling rows at or past `limit`.
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src, int row0, int limit,
                                          int tid) {
#pragma unroll
  for (int i = tid; i < SBN * (D / 8); i += 128) {
    const int r = i / (D / 8), c = i % (D / 8);
    uint4 val = make_uint4(0, 0, 0, 0);
    if (row0 + r < limit)
      val = *reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * D + c * 8);
    *reinterpret_cast<uint4*>(dst + r * LDS + c * 8) = val;
  }
}

// One CTA per (64-column tile, hq, b): scores[c] = sum over window rows r
// with c <= r (and, with a block mask, whose q block selects c's block) of
// exp(q[r].k[c] * scale - m_r) / l_r, with (m, l) in natural-log units.
__global__ void __launch_bounds__(128)
window_scores_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const int* __restrict__ true_len,
                     const int* __restrict__ block_mask,
                     const float* __restrict__ win_ml,
                     float* __restrict__ scores,
                     int Hq, int Hkv, int S, int W, int P, int n_blk, float scale) {
  __shared__ __align__(16) bf16 Ks[SBN * LDS];
  __shared__ __align__(16) bf16 Qw[WMAX * D];
  __shared__ float m_w[WMAX], il_w[WMAX], part[128];
  __shared__ int sel_w[WMAX];

  const int tid = threadIdx.x;
  const int hq = blockIdx.y, b = blockIdx.z;
  const int hkv = hq / (Hq / Hkv);
  const int col0 = blockIdx.x * SBN;
  const int tl = true_len[b];
  const int ws = tl - W;
  float* sc = scores + ((size_t)b * Hq + hq) * S;
  const int col = tid & (SBN - 1), half = tid >> 6;

  if (col0 >= tl) {  // past every window row: no causal column (uniform)
    if (half == 0 && col0 + col < S) sc[col0 + col] = 0.f;
    return;
  }

  load_rows(Ks, k + ((size_t)b * Hkv + hkv) * S * D, col0, S, tid);
  const bf16* qh = q + ((size_t)b * Hq + hq) * S * D;
  for (int i = tid; i < W * (D / 8); i += 128) {
    const int r = i / (D / 8), c = i % (D / 8);
    const int row = ws + r;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (row >= 0) val = *reinterpret_cast<const uint4*>(qh + (size_t)row * D + c * 8);
    *reinterpret_cast<uint4*>(Qw + r * D + c * 8) = val;
  }
  const float* ml = win_ml + ((size_t)b * Hq + hq) * W * 2;
  const int* mh = block_mask ? block_mask + ((size_t)b * Hq + hq) * n_blk * n_blk : nullptr;
  for (int r = tid; r < W; r += 128) {
    if (ws + r >= 0) {
      const float l = ml[r * 2 + 1];
      m_w[r] = ml[r * 2];
      il_w[r] = 1.f / (l == 0.f ? 1.f : l);
      sel_w[r] = mh ? mh[((ws + r) / P) * n_blk + col0 / P] : 1;
    }
  }
  __syncthreads();

  const int c = col0 + col;
  float acc = 0.f;
  for (int r = half; r < W; r += 2) {
    const int row = ws + r;
    if (row < 0 || c > row || !sel_w[r]) continue;
    float dot = 0.f;
#pragma unroll
    for (int d8 = 0; d8 < D / 8; ++d8) {
      const uint4 kr = *reinterpret_cast<const uint4*>(Ks + col * LDS + d8 * 8);
      const uint4 qr = *reinterpret_cast<const uint4*>(Qw + r * D + d8 * 8);
      const bf16* kv8 = reinterpret_cast<const bf16*>(&kr);
      const bf16* qv8 = reinterpret_cast<const bf16*>(&qr);
#pragma unroll
      for (int i = 0; i < 8; ++i)
        dot = fmaf(__bfloat162float(qv8[i]), __bfloat162float(kv8[i]), dot);
    }
    acc += expf(dot * scale - m_w[r]) * il_w[r];
  }
  part[tid] = acc;
  __syncthreads();
  if (half == 0 && c < S) sc[c] = part[col] + part[col + SBN];
}

// --- host side ------------------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime's entry-point query, so the
// library links no libcuda of its own.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                              &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A [planes, rows, D] bf16 tensor as a 3-D map read in boxes of 128 rows x
// 64 columns, 128-byte swizzled; rows past `rows` read as zeros.
bool make_map(EncodeTiled enc, CUtensorMap* map, const void* base, int rows, int planes) {
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)rows, (cuuint64_t)planes};
  const cuuint64_t strides[2] = {(cuuint64_t)D * 2, (cuuint64_t)rows * D * 2};
  const cuuint32_t box[3] = {(cuuint32_t)HALF, (cuuint32_t)BN, 1};
  const cuuint32_t step[3] = {1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims, strides,
             box, step, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace

extern "C" int kvcf_flash_prefill(const void* q, const void* k, const void* v,
                                  const void* true_len, const void* row_offset,
                                  const void* block_mask, void* out, void* win_ml,
                                  void* scores, void* row_ml, int B, int Hq, int Hkv,
                                  int S_q, int S_k, int W, int SW, int P, int n_blk,
                                  float scale, void* stream) {
  // The wrapper's contract: scores only for whole-sequence queries without
  // a window; q and k lengths differ only in chunk mode; a block mask only
  // for whole-sequence queries, with n_blk blocks of P rows covering S_q and
  // P a multiple of 64 (a warpgroup's rows, a tile's half) unless one block
  // covers everything; (m, l) only without scores or a block mask (a
  // dense-attention feature).
  if (W < 0 || W > WMAX || SW < 0 || (W > 0 && (SW > 0 || row_offset)) ||
      (!row_offset && S_q != S_k) || S_q < 1 || S_k < 1 ||
      (row_ml && (W > 0 || block_mask)))
    return (int)cudaErrorInvalidValue;
  if (block_mask && (row_offset || P < 1 || n_blk != (S_q + P - 1) / P ||
                     (n_blk > 1 && P % HALF != 0)))
    return (int)cudaErrorInvalidValue;
  const size_t smem = 1024 + SMEM_LIST + sizeof(int) * (size_t)((S_k + BN - 1) / BN);
  if (smem > (size_t)SMEM_MAX) return (int)cudaErrorInvalidValue;
  EncodeTiled enc = encode_tiled();
  if (!enc) return (int)cudaErrorNotSupported;
  CUtensorMap tq, tk, tv;
  if (!make_map(enc, &tq, q, S_q, B * Hq) || !make_map(enc, &tk, k, S_k, B * Hkv) ||
      !make_map(enc, &tv, v, S_k, B * Hkv))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // Above 48 KB of dynamic shared memory needs an opt-in, once per device
  // (so that a launch under CUDA-graph capture makes no such call).
  static bool smem_set[64] = {false};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  if (!smem_set[dev]) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
    if (err != cudaSuccess) return (int)err;
    smem_set[dev] = true;
  }
  dim3 grid(Hq, (S_q + BM - 1) / BM, B);
  flash_fwd_kernel<<<grid, THREADS, smem, st>>>(
      tq, tk, tv, static_cast<const int*>(true_len), static_cast<const int*>(row_offset),
      static_cast<const int*>(block_mask), static_cast<bf16*>(out),
      static_cast<float*>(win_ml), static_cast<float*>(row_ml), Hq, Hkv, S_q, S_k, W, SW, P,
      n_blk, scale * LOG2E);
  if (W > 0) {
    dim3 g2((S_k + SBN - 1) / SBN, Hq, B);
    window_scores_kernel<<<g2, 128, 0, st>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const int*>(true_len), static_cast<const int*>(block_mask),
        static_cast<const float*>(win_ml), static_cast<float*>(scores), Hq, Hkv, S_k,
        W, P, n_blk, scale);
  }
  return (int)cudaGetLastError();
}
