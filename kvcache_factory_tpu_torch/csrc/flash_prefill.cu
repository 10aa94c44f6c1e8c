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
// The instantiation width D is a template parameter, D in {64, 128, 256,
// 384, 512}; the library exports kvcf_flash_prefill_d<D> for each.  A
// tensor's head_dim hd (any even number up to 512) runs on the narrowest
// instantiation at least as wide: the copies span hd columns, so the
// columns past hd come in as zeros (never the next row's), boxes that
// start at or past hd are not loaded and their k-steps not run, columns
// past hd are never written, and the caller passes hd's 1/sqrt(hd).
// A row of hd bf16 is a whole number of 16-byte pieces only at hd % 8 ==
// 0, and TMA takes only 16-byte row strides.  So the source builds in
// three forms, by KVCF_PIECE, the bytes a row copy moves: 16 (the default:
// TMA, hd % 8 == 0), 8 (hd % 4 == 0) or 4 (any even hd).  At 8 and 4 the
// producer warpgroup's 128 threads copy Q and the K/V tiles in pieces of
// that size with cp.async.ca (the only form that takes 4 and 8 bytes)
// into the same 128-byte-swizzled stages, each piece at its place inside
// its 16-byte chunk; a piece past hd or a row past the tensor is filled
// with zeros through cp.async's source size.  Each thread signals a stage
// on its full mbarrier with cp.async.mbarrier.arrive.noinc, which arrives
// once the thread's copies have landed, so those barriers expect 128
// arrivals; the consumers fence the async proxy after each wait (wgmma
// reads shared memory through it, cp.async writes through the generic
// one).  Nothing else changes: the consumers' wgmma code, the setmaxnreg
// split, the softmax, the sparse tile list and the epilogue, which stores
// pairs of columns and none at or past hd.  Key
// tiles are BN = 128 keys at D 64 and 128 and BN = 64 at D 256, where Q (64
// KB) and a 2-stage ring of 128-key tiles (4 x 64 KB) would pass the 227 KB
// a block may hold: 64-key tiles make it 64 + 2 x (32 + 32) = 192 KB.  QK^T
// is then wgmma m64nBNk16 over D / 16 k-steps and PV m64nDk16 (D / 2 fp32
// accumulators a consumer thread: 32, 64 or 128).
// Above 256 a consumer's O would take D / 2 = 192 or 256 of its 232
// registers, so the CTA splits O's columns instead (Plan::SPLIT): it takes
// 64 q rows, both consumer warpgroups compute the same S = QK^T and the same
// softmax for them (QK^T twice: the work grows by a half), and each owns
// D / 2 columns of O (PV m64n(D/2)k16, 96 or 128 accumulators).  Q (48 or
// 64 KB for 64 rows) and a 2-stage ring of 32-key tiles (24 or 32 KB a K or
// V tile) make 144 or 192 KB.  The numbers below are at D 128.
//
// Design.  One CTA of three warpgroups per (128 q rows, hq, b): warpgroup 2
// is the producer, warpgroups 0 and 1 are consumers of 64 q rows each
// (setmaxnreg moves registers from the producer, 40 a thread, to the
// consumers, 232).  Against the six things that held the earlier kernel
// back (mma.sync m16n8k16, synchronous loads, scalar V fragments, 64-row
// tiles, per-element masks everywhere, ascending tile order):
//  1. Both products are wgmma (m64n128k16 at D 128): S = Q K^T with both operands in
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
// 64-column half of a key tile (a 64-key tile at D 256 is one half) in one
// k block.  The prologue reads the
// block mask once per (warpgroup, half) of every tile in the causal range
// and compacts the tiles that either warpgroup selects into a list in
// shared memory; the producer and the consumers walk that list, and a
// warpgroup skips the products of a listed tile it does not need.
//
// The window scores cannot accumulate across q tiles as the TPU's
// sequential grid lets them (CTAs run concurrently here, and float atomics
// would make the sums depend on the run).  Instead the main kernel stores
// each window row's final (m, l) in a [B, Hq, W, 2] buffer and the
// window-score pass of window_scores.cuh recomputes the window logits on
// the tensor cores, one CTA per (64-key tile, KV head, b) for all the query
// heads of the group, normalizes them with the stored (m, l) and sums over
// rows in an order fixed by W, G and D: about W/S of the main work.  No
// atomics anywhere: two launches on the same inputs give bitwise-equal
// outputs.

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "window_scores.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int HALF = 64;        // columns per TMA box: 128 bytes, the swizzle span
constexpr int STAGES = 2;       // K/V ring depth
constexpr int THREADS = 384;    // consumer warpgroups 0 and 1, producer warpgroup 2
constexpr int SMEM_MAX = 232448;                     // the opt-in limit of a block
constexpr int EMPTY_ARRIVALS = 8;                    // the consumers' warps
constexpr float NEG_INF = -3.4028234663852886e38f;  // float32 finfo.min
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

#ifndef KVCF_PIECE
#define KVCF_PIECE 16
#endif
// Bytes a row copy moves: 16 (TMA), or 8 / 4 (cp.async pieces, for rows
// that are no whole number of 16-byte pieces).
constexpr int PIECE = KVCF_PIECE;
static_assert(PIECE == 16 || PIECE == 8 || PIECE == 4, "row copies of 16, 8 or 4 bytes");
constexpr bool RAGGED = PIECE < 16;
constexpr int PIECE_COLS = PIECE / 2;  // bf16 columns a piece
constexpr int PRODUCERS = 128;         // the producer warpgroup's threads
// Arrivals that complete a full barrier: the elected thread's expect_tx
// (TMA), or one cp.async arrive of every producer thread.
constexpr int FULL_ARRIVALS = RAGGED ? PRODUCERS : 1;

// The register type of one row piece.
template <int BYTES> struct PieceOf;
template <> struct PieceOf<16> { typedef uint4 T; };
template <> struct PieceOf<8> { typedef uint2 T; };
template <> struct PieceOf<4> { typedef uint32_t T; };
typedef PieceOf<PIECE>::T Piece;

// The tile plan of instantiation width D.  Shared memory: Q (NB boxes of
// BM rows x 64 columns), then STAGES x (K tile, V tile), each NB boxes of BN
// rows x 64 columns; then the mbarriers, the list build's per-warp counts
// and the compacted key-tile list.
template <int D>
struct Plan {
  static_assert(D == 64 || D == 128 || D == 256 || D == 384 || D == 512,
                "instantiation width 64, 128, 256, 384 or 512");
  static constexpr bool SPLIT = D > 256;               // consumers split O's columns
  static constexpr int BM = SPLIT ? 64 : 128;          // q rows per CTA
  static constexpr int WG_ROWS = SPLIT ? 0 : HALF;     // first row of warpgroup 1
  static constexpr int DO = SPLIT ? D / 2 : D;         // O columns a consumer owns
  static constexpr int BN = D > 256 ? 32 : D == 256 ? 64 : 128;  // keys per K/V tile
  static constexpr int NB = D / HALF;                  // 64-column boxes a row
  static constexpr int NH = BN > HALF ? BN / HALF : 1; // 64-key halves a tile (or the tile)
  static constexpr int Q_BOX = BM * 128;               // 16 KB (8 KB split)
  static constexpr int KV_BOX = BN * 128;              // 16, 8 or 4 KB
  static constexpr int Q_BYTES = NB * Q_BOX;           // 16, 32, 64, 48 or 64 KB
  static constexpr int TILE_BYTES = NB * KV_BOX;       // one K or V tile: 16, 32, 32, 24 or 32 KB
  static constexpr int SMEM_K = Q_BYTES;               // stage s at + 2 s TILE_BYTES
  static constexpr int SMEM_BAR = Q_BYTES + 2 * STAGES * TILE_BYTES;  // 80-192 KB
  static constexpr int SMEM_CNT = SMEM_BAR + 64;       // per-warp counts of the list build
  static constexpr int SMEM_LIST = SMEM_BAR + 128;     // the compacted key-tile list
  static constexpr uint32_t ALL_SELECTED = (1u << (2 * NH)) - 1;  // (warpgroup, half) bits
};

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

// One PIECE-byte piece from global to shared memory, cache-all (the only
// cp.async form that takes 4 and 8 bytes); `src_bytes` 0 fills zeros.
__device__ __forceinline__ void cp_async_piece(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n"
               :: "r"(dst), "l"(src), "n"(PIECE), "r"(src_bytes) : "memory");
}

// Arrive on `bar` once every cp.async this thread issued has landed,
// without raising the barrier's expected count (it counts the arrival).
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" :: "r"(bar) : "memory");
}

// Orders the generic-proxy writes this thread has observed (cp.async's)
// before its wgmma reads, which go through the async proxy.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Rows [row0, row0 + ROWS) of one [nrows, hd] plane at `src` into the
// 128-byte-swizzled boxes at `dst` (`box` bytes apart, those below nbox),
// laid out as TMA lays them: 16-byte chunk c of box row r at chunk c ^ (r &
// 7), a piece at its offset inside its chunk.  Producer thread pt takes
// piece pt % PPR of every (128 / PPR)-th row, so neighbouring threads read
// neighbouring pieces of a row.  Pieces at or past hd and rows at or past
// nrows are zero-filled.
template <int ROWS>
__device__ __forceinline__ void copy_rows(uint32_t dst, const bf16* src, int row0, int nrows,
                                          int hd, int nbox, uint32_t box, int pt) {
  constexpr int PPR = HALF / PIECE_COLS;   // pieces a box row: 16 or 32
  constexpr int RSTEP = PRODUCERS / PPR;   // rows between a thread's pieces: 8 or 4
  static_assert(ROWS % RSTEP == 0, "whole rounds of pieces");
  // The producer keeps 40 registers (setmaxnreg): one row at a time, the
  // source and destination stepped, not recomputed.
  const int pc = (pt % PPR) * PIECE_COLS;  // the piece's first column inside its box
  const int r0 = pt / PPR;
  const uint32_t chunk = pc >> 3, in_chunk = (pc & 7) * 2;
  const size_t step = (size_t)RSTEP * hd;
  for (int x = 0; x < nbox; ++x) {
    const int col = x * HALF + pc;
    const bool col_ok = col < hd;
    const bf16* from = src + (size_t)(row0 + r0) * hd + col;
    uint32_t to = dst + x * box + r0 * 128 + in_chunk;
    int left = nrows - row0 - r0;          // rows of the tensor from this thread's row on
#pragma unroll 1
    for (int r = r0; r < ROWS; r += RSTEP) {
      const bool ok = col_ok && left > 0;
      cp_async_piece(to + (((chunk ^ r) & 7) << 4), ok ? from : src, ok ? PIECE : 0);
      from += step;
      to += RSTEP * 128;
      left -= RSTEP;
    }
  }
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

// V as the MN-major B operand: 8-key groups 1024 bytes apart (stride), each
// next 64 columns of D one box (`box` bytes) further on (leading).
__device__ __forceinline__ uint64_t desc_v(uint32_t addr, uint32_t box) {
  return gmma_desc(addr, box, 1024);
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
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

#define KVCF_D16                                                                        \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"
#define KVCF_D32                                                                        \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "  \
  "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define KVCF_D64                                                                        \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "  \
  "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "   \
  "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "   \
  "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"
#define KVCF_D96                                                                        \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "  \
  "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "   \
  "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "   \
  "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, "   \
  "%66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, "   \
  "%82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95}"
#define KVCF_D128                                                                       \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "  \
  "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "   \
  "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "   \
  "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, "   \
  "%66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, "   \
  "%82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, "   \
  "%98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, "       \
  "%111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, "     \
  "%124, %125, %126, %127}"
#define KVCF_F8(d, i)                                                                  \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]),          \
      "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define KVCF_F32(d, i) KVCF_F8(d, i), KVCF_F8(d, i + 8), KVCF_F8(d, i + 16), KVCF_F8(d, i + 24)
#define KVCF_F16(d) KVCF_F8(d, 0), KVCF_F8(d, 8)
#define KVCF_F64(d) KVCF_F32(d, 0), KVCF_F32(d, 32)
#define KVCF_F96(d) KVCF_F32(d, 0), KVCF_F32(d, 32), KVCF_F32(d, 64)
#define KVCF_F128(d) KVCF_F32(d, 0), KVCF_F32(d, 32), KVCF_F32(d, 64), KVCF_F32(d, 96)

// d[64 x N] (+)= A[64 x 16] B[16 x N], both from shared memory, K-major;
// N = 32, 64 or 128 (the keys of a tile).
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da, uint64_t db,
                                         int accumulate);
template <>
__device__ __forceinline__ void wgmma_ss<32>(float (&d)[16], uint64_t da, uint64_t db,
                                             int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 " KVCF_D16
      ", %16, %17, p, 1, 1, 0, 0;\n}\n"
      : KVCF_F16(d)
      : "l"(da), "l"(db), "r"(accumulate));
}
template <>
__device__ __forceinline__ void wgmma_ss<64>(float (&d)[32], uint64_t da, uint64_t db,
                                             int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " KVCF_D32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : KVCF_F32(d, 0)
      : "l"(da), "l"(db), "r"(accumulate));
}
template <>
__device__ __forceinline__ void wgmma_ss<128>(float (&d)[64], uint64_t da, uint64_t db,
                                              int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " KVCF_D64
      ", %64, %65, p, 1, 1, 0, 0;\n}\n"
      : KVCF_F64(d)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d[64 x N] += A[64 x 16] B[16 x N], A from registers (the m16n8k16 A
// fragment per warp), B from shared memory, MN-major (transposed); N = the
// O columns a consumer owns.
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], uint32_t a0, uint32_t a1,
                                         uint32_t a2, uint32_t a3, uint64_t db);
template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32], uint32_t a0, uint32_t a1,
                                             uint32_t a2, uint32_t a3, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " KVCF_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : KVCF_F32(d, 0)
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64], uint32_t a0, uint32_t a1,
                                              uint32_t a2, uint32_t a3, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " KVCF_D64
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : KVCF_F64(d)
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_rs<192>(float (&d)[96], uint32_t a0, uint32_t a1,
                                              uint32_t a2, uint32_t a3, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 " KVCF_D96
      ", {%96, %97, %98, %99}, %100, p, 1, 1, 1;\n}\n"
      : KVCF_F96(d)
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_rs<256>(float (&d)[128], uint32_t a0, uint32_t a1,
                                              uint32_t a2, uint32_t a3, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 " KVCF_D128
      ", {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : KVCF_F128(d)
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
}

__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// --- the main kernel ----------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap tm_q,
                 const __grid_constant__ CUtensorMap tm_k,
                 const __grid_constant__ CUtensorMap tm_v,
                 const int* __restrict__ true_len, const int* __restrict__ row_offset,
                 const int* __restrict__ block_mask, bf16* __restrict__ out,
                 float* __restrict__ win_ml, float* __restrict__ row_ml, int Hq,
                 int Hkv, int S_q, int S_k, int W, int SW, int P, int n_blk, int hd,
                 float scale_log2, const bf16* __restrict__ qg,
                 const bf16* __restrict__ kg, const bf16* __restrict__ vg) {
  // qg, kg, vg: the tensors themselves, which the RAGGED producer copies
  // from (last, so that the TMA build's parameters keep their offsets).
  using T = Plan<D>;
  constexpr int BN = T::BN, NH = T::NH, NB = T::NB, BM = T::BM;
  extern __shared__ unsigned char smem_raw[];
  // 128-byte swizzling repeats every 1024 bytes: align the tiles to that.
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const uint32_t sbase = smem_u32(smem);
  int* warp_cnt = reinterpret_cast<int*>(smem + T::SMEM_CNT);
  int* list = reinterpret_cast<int*>(smem + T::SMEM_LIST);
  const uint32_t bar_q = sbase + T::SMEM_BAR;
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
  bf16* oh = out + bh * S_q * hd;
  // The 64-column boxes that hold a column below hd: the others are
  // neither loaded nor multiplied.
  const int nbox = (hd + HALF - 1) / HALF;
  // (m, l) planes of this (b, hq): m at [0, S_q), l one plane further on.
  const size_t plane = (size_t)gridDim.z * Hq * S_q;
  float* mh = row_ml ? row_ml + bh * S_q : nullptr;

  if (row0 >= tl) {  // no valid row in this CTA (uniform)
    for (int i = tid; i < BM * (hd / PIECE_COLS); i += THREADS) {
      const int r = lrow0 + i / (hd / PIECE_COLS);
      if (r < S_q)
        *reinterpret_cast<Piece*>(oh + (size_t)r * hd + (i % (hd / PIECE_COLS)) * PIECE_COLS) =
            Piece{};
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
    mbar_init(bar_q, FULL_ARRIVALS);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(k_full(s), FULL_ARRIVALS);
      mbar_init(v_full(s), FULL_ARRIVALS);
      mbar_init(empty(s), EMPTY_ARRIVALS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (block_mask) {
    // Compact the tiles that either warpgroup selects (whole-sequence
    // queries: row0 is local).  Bit NH wg + h of an entry says whether
    // warpgroup wg's q block selects the k block of the tile's half h (NH
    // halves a tile); a block index past the last (one block over the whole
    // sequence) is the last, whose columns or rows are masked anyway.
    const int* mb = block_mask + bh * n_blk * n_blk;
    const int qb0 = min(row0 / P, n_blk - 1), qb1 = min((row0 + T::WG_ROWS) / P, n_blk - 1);
    int base = 0;
    for (int start = kt_begin; start < kt_end; start += THREADS) {
      const int kt = start + tid;
      uint32_t sel = 0;
      if (kt < kt_end) {
#pragma unroll
        for (int h = 0; h < NH; ++h) {
          const int kb = min((kt * BN + h * HALF) / P, n_blk - 1);
          sel |= (mb[qb0 * n_blk + kb] ? 1u : 0u) << h;
          sel |= (mb[qb1 * n_blk + kb] ? 1u : 0u) << (NH + h);
        }
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
    // ---- producer warpgroup: one thread issues every copy (TMA), or all
    // 128 copy pieces (RAGGED) ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if constexpr (RAGGED) {
      if (n_list > 0) {
        const int pt = tid - 2 * PRODUCERS;
        copy_rows<BM>(sbase, qg + bh * S_q * hd, lrow0, S_q, hd, nbox, T::Q_BOX, pt);
        cp_async_arrive(bar_q);
        const size_t plane_kv = ((size_t)b * Hkv + hkv) * S_k * hd;
        for (int i = 0; i < n_list; ++i) {
          const int s = i % STAGES;
          mbar_wait(empty(s), ((i / STAGES) & 1) ^ 1);  // the first pass finds it free
          const int kt = block_mask ? (list[i] & 0xFFFFFF) : kt_begin + i;
          const uint32_t kd = sbase + T::SMEM_K + s * 2 * T::TILE_BYTES, vd = kd + T::TILE_BYTES;
          copy_rows<BN>(kd, kg + plane_kv, kt * BN, S_k, hd, nbox, T::KV_BOX, pt);
          cp_async_arrive(k_full(s));
          copy_rows<BN>(vd, vg + plane_kv, kt * BN, S_k, hd, nbox, T::KV_BOX, pt);
          cp_async_arrive(v_full(s));
        }
        asm volatile("cp.async.wait_all;\n" ::: "memory");
      }
    } else if (tid == 256 && n_list > 0) {
      mbar_expect_tx(bar_q, nbox * T::Q_BOX);
#pragma unroll
      for (int x = 0; x < NB; ++x)
        if (x < nbox) tma_load(sbase + x * T::Q_BOX, &tm_q, bar_q, x * HALF, lrow0, (int)bh);
      const int plane_kv = b * Hkv + hkv;
      for (int i = 0; i < n_list; ++i) {
        const int s = i % STAGES;
        mbar_wait(empty(s), ((i / STAGES) & 1) ^ 1);  // the first pass finds it free
        const int kt = block_mask ? (list[i] & 0xFFFFFF) : kt_begin + i;
        const uint32_t kd = sbase + T::SMEM_K + s * 2 * T::TILE_BYTES, vd = kd + T::TILE_BYTES;
        mbar_expect_tx(k_full(s), nbox * T::KV_BOX);
#pragma unroll
        for (int x = 0; x < NB; ++x)
          if (x < nbox) tma_load(kd + x * T::KV_BOX, &tm_k, k_full(s), x * HALF, kt * BN, plane_kv);
        mbar_expect_tx(v_full(s), nbox * T::KV_BOX);
#pragma unroll
        for (int x = 0; x < NB; ++x)
          if (x < nbox) tma_load(vd + x * T::KV_BOX, &tm_v, v_full(s), x * HALF, kt * BN, plane_kv);
      }
    }
  } else {
    // ---- consumer warpgroups: 64 q rows each (split: the same 64) ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int wg = warp >> 2;
    const int g = lane >> 2, t = lane & 3;
    const int Rw0 = row0 + wg * T::WG_ROWS, Rw1 = Rw0 + HALF - 1;  // this warpgroup's rows
    const int ra = wg * T::WG_ROWS + (warp & 3) * 16 + g;          // this thread's first tile row
    const int o_lo = lrow0 + ra, o_hi = o_lo + 8;            // local rows (output)
    const int r_lo = row0 + ra, r_hi = r_lo + 8;             // global ids (masks)
    const int lim_lo = min(r_lo, col_max), lim_hi = min(r_hi, col_max);
    // The window hides col <= row - SW (no window: col <= -1, nothing).
    const int wlo_lo = SW > 0 ? r_lo - SW : -1, wlo_hi = SW > 0 ? r_hi - SW : -1;
    const int diag = min(Rw0, col_max), reach = min(Rw1, col_max);
    // Running max (base-2 logits) and this thread's share of the row sums.
    float m_lo = NEG_INF, m_hi = NEG_INF, l_lo = 0.f, l_hi = 0.f;
    float o[T::DO / 2];
#pragma unroll
    for (int i = 0; i < T::DO / 2; ++i) o[i] = 0.f;
    const uint32_t qa = sbase + wg * (T::WG_ROWS * 128);  // this warpgroup's 64 rows of Q
    const int ocol = T::SPLIT ? wg * T::DO : 0;           // its first O column
    // In a split CTA warpgroup 0 alone writes the rows' (m, l): both hold them.
    const bool ml_writer = !T::SPLIT || wg == 0;

    if (n_list > 0) {
      mbar_wait(bar_q, 0);
      if constexpr (RAGGED) fence_proxy_async();
    }
    for (int i = 0; i < n_list; ++i) {
      const int s = i % STAGES;
      const uint32_t ph = (i / STAGES) & 1;
      const int e = block_mask ? list[i] : (kt_begin + i) | (int)(T::ALL_SELECTED << 24);
      const int c0 = (e & 0xFFFFFF) * BN;
      const uint32_t sel = ((uint32_t)e >> (24 + NH * wg)) & ((1u << NH) - 1u);
      const uint32_t kd = sbase + T::SMEM_K + s * 2 * T::TILE_BYTES, vd = kd + T::TILE_BYTES;
      // Uniform over the warpgroup: no column of the tile reaches its rows;
      // or every column reaches every row.
      const bool skip = sel == 0 || c0 > reach || (SW > 0 && c0 + BN - 1 <= Rw0 - SW);
      const bool full =
          sel == (1u << NH) - 1u && c0 + BN - 1 <= diag && (SW == 0 || c0 > Rw1 - SW);
      mbar_wait(k_full(s), ph);
      if constexpr (RAGGED) fence_proxy_async();
      if (!skip) {
        float sc[BN / 2];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          if ((kk >> 2) >= nbox) break;          // a box past hd (uniform)
          const uint32_t in_row = (kk & 3) * 32;  // k-step kk: box kk / 4, 32 bytes each
          wgmma_ss<BN>(sc, desc_kmajor(qa + (kk >> 2) * T::Q_BOX + in_row),
                       desc_kmajor(kd + (kk >> 2) * T::KV_BOX + in_row), kk);
        }
        wgmma_commit();
        wgmma_wait_all();
        fence_acc(sc);

        // Logits in base 2.  sc[4n + e]: row lo (e < 2) or hi, column
        // c0 + 8n + 2t + (e & 1), in half n / 8.
        float mx_lo = m_lo, mx_hi = m_hi;
        if (full) {
#pragma unroll
          for (int j = 0; j < BN / 2; ++j) {
            sc[j] *= scale_log2;
            if ((j & 3) < 2) mx_lo = fmaxf(mx_lo, sc[j]); else mx_hi = fmaxf(mx_hi, sc[j]);
          }
        } else {
#pragma unroll
          for (int j = 0; j < BN / 2; ++j) {
            const int col = c0 + (j >> 2) * 8 + t * 2 + (j & 1);
            const bool lo = (j & 3) < 2;
            const bool vis = col <= (lo ? lim_lo : lim_hi) && col > (lo ? wlo_lo : wlo_hi) &&
                             ((sel >> (j >> 5)) & 1u);
            sc[j] = vis ? sc[j] * scale_log2 : NEG_INF;
            if (lo) mx_lo = fmaxf(mx_lo, sc[j]); else mx_hi = fmaxf(mx_hi, sc[j]);
          }
        }
        // A row's BN columns live in the 4 threads of one quad.
        mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, 1));
        mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, 2));
        mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, 1));
        mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, 2));
        const float a_lo = exp2f(m_lo - mx_lo), a_hi = exp2f(m_hi - mx_hi);
        m_lo = mx_lo;
        m_hi = mx_hi;
        float sum_lo = 0.f, sum_hi = 0.f;
#pragma unroll
        for (int j = 0; j < BN / 2; ++j) {
          const bool lo = (j & 3) < 2;
          sc[j] = exp2f(sc[j] - (lo ? m_lo : m_hi));
          if (lo) sum_lo += sc[j]; else sum_hi += sc[j];
        }
        l_lo = l_lo * a_lo + sum_lo;
        l_hi = l_hi * a_hi + sum_hi;
        // P as the A fragments of the PV product: the accumulator of
        // columns [16 kk, 16 kk + 16) is the A fragment of k-step kk.
        uint32_t pa[BN / 4];
#pragma unroll
        for (int j = 0; j < BN / 4; ++j) pa[j] = pack_f32(sc[2 * j], sc[2 * j + 1]);
#pragma unroll
        for (int j = 0; j < T::DO / 2; ++j) o[j] *= (j & 3) < 2 ? a_lo : a_hi;

        mbar_wait(v_full(s), ph);
        if constexpr (RAGGED) fence_proxy_async();
        wgmma_fence();
        // This warpgroup's O columns start at box ocol / 64 of the V tile.
        // Its boxes past hd were not loaded: the columns they feed are never
        // written, and one O column reads only its own V column.
#pragma unroll
        for (int kk = 0; kk < BN / 16; ++kk)
          wgmma_rs<T::DO>(o, pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2], pa[4 * kk + 3],
                          desc_v(vd + (ocol / HALF) * T::KV_BOX + kk * 16 * 128, T::KV_BOX));
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
        for (int j = 0; j < T::DO / 2; ++j) if ((j & 3) < 2) o[j] = 0.f;
      }
      if (m_hi == NEG_INF) {
        l_hi = 0.f;
#pragma unroll
        for (int j = 0; j < T::DO / 2; ++j) if ((j & 3) >= 2) o[j] = 0.f;
      }
      if (t == 0 && ml_writer) {
        if (o_lo < S_q) { mh[o_lo] = mn_lo; mh[plane + o_lo] = l_lo; }
        if (o_hi < S_q) { mh[o_hi] = mn_hi; mh[plane + o_hi] = l_hi; }
      }
    }
    const float il_lo = 1.f / (l_lo == 0.f ? 1.f : l_lo);
    const float il_hi = 1.f / (l_hi == 0.f ? 1.f : l_hi);
#pragma unroll
    for (int n = 0; n < T::DO / 8; ++n) {
      const int col = ocol + n * 8;  // hd % 8 == 0: a group of 8 columns is in or out
      if (col >= hd) break;
      // RAGGED: hd is even, so each thread's pair of columns is in or out.
      if (RAGGED && col + t * 2 >= hd) continue;
      if (o_lo < S_q)
        *reinterpret_cast<uint32_t*>(oh + (size_t)o_lo * hd + col + t * 2) =
            pack_f32(o[4 * n] * il_lo, o[4 * n + 1] * il_lo);
      if (o_hi < S_q)
        *reinterpret_cast<uint32_t*>(oh + (size_t)o_hi * hd + col + t * 2) =
            pack_f32(o[4 * n + 2] * il_hi, o[4 * n + 3] * il_hi);
    }

    // W > 0 only for whole-sequence queries (no offset): r == global id.
    if (W > 0 && t == 0 && ml_writer) {  // final (m, l) of the observation-window rows
      const int ws = tl - W;
      float* ml = win_ml + bh * W * 2;
      if (r_lo >= ws && r_lo < tl) { ml[(r_lo - ws) * 2] = mn_lo; ml[(r_lo - ws) * 2 + 1] = l_lo; }
      if (r_hi >= ws && r_hi < tl) { ml[(r_hi - ws) * 2] = mn_hi; ml[(r_hi - ws) * 2 + 1] = l_hi; }
    }
  }
}

// --- host side ------------------------------------------------------------------

// The host function of instantiation width D, for tensors of head_dim hd
// (a whole number of PIECE-byte pieces, D - 128 < hd <= D, or hd <= 64 at
// D 64), q, k and v aligned to PIECE bytes.  The wrapper's
// contract: scores only
// for whole-sequence queries without a window; q and k lengths differ only
// in chunk mode; a block mask only for whole-sequence queries, with n_blk
// blocks of P rows covering S_q and P a multiple of 64 (a warpgroup's rows,
// a tile's half) unless one block covers everything; (m, l) only without
// scores or a block mask (a dense-attention feature).
template <int D>
int flash_prefill(const void* q, const void* k, const void* v, const void* true_len,
                  const void* row_offset, const void* block_mask, void* out, void* win_ml,
                  void* scores, void* row_ml, int B, int Hq, int Hkv, int S_q, int S_k,
                  int W, int SW, int P, int n_blk, int hd, float scale, void* stream) {
  using T = Plan<D>;
  if (hd < PIECE_COLS || hd > D || hd % PIECE_COLS != 0) return (int)cudaErrorInvalidValue;
  if (W < 0 || SW < 0 || (W > 0 && (SW > 0 || row_offset)) ||
      (!row_offset && S_q != S_k) || S_q < 1 || S_k < 1 ||
      (row_ml && (W > 0 || block_mask)))
    return (int)cudaErrorInvalidValue;
  if (block_mask && (row_offset || P < 1 || n_blk != (S_q + P - 1) / P ||
                     (n_blk > 1 && P % HALF != 0)))
    return (int)cudaErrorInvalidValue;
  const size_t smem = 1024 + T::SMEM_LIST + sizeof(int) * (size_t)((S_k + T::BN - 1) / T::BN);
  if (smem > (size_t)SMEM_MAX) return (int)cudaErrorInvalidValue;
  CUtensorMap tq{}, tk{}, tv{};  // RAGGED copies by cp.async: no maps
  if constexpr (!RAGGED) {
    ws::EncodeTiled enc = ws::encode_tiled();
    if (!enc) return (int)cudaErrorNotSupported;
    if (!ws::make_map(enc, &tq, q, hd, S_q, B * Hq, T::BM) ||
        !ws::make_map(enc, &tk, k, hd, S_k, B * Hkv, T::BN) ||
        !ws::make_map(enc, &tv, v, hd, S_k, B * Hkv, T::BN))
      return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // Above 48 KB of dynamic shared memory needs an opt-in, once per
  // instantiation and device (so that a launch under CUDA-graph capture
  // makes no such call).
  static bool smem_set[64] = {false};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  if (!smem_set[dev]) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
    if (err != cudaSuccess) return (int)err;
    smem_set[dev] = true;
  }
  dim3 grid(Hq, (S_q + T::BM - 1) / T::BM, B);
  flash_fwd_kernel<D><<<grid, THREADS, smem, st>>>(
      tq, tk, tv, static_cast<const int*>(true_len), static_cast<const int*>(row_offset),
      static_cast<const int*>(block_mask), static_cast<bf16*>(out),
      static_cast<float*>(win_ml), static_cast<float*>(row_ml), Hq, Hkv, S_q, S_k, W, SW, P,
      n_blk, hd, scale * LOG2E, static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v));
  if (W > 0 && cudaPeekAtLastError() == cudaSuccess)  // the window-score pass
    return ws::window_scores<PIECE>(q, k, true_len, block_mask, win_ml, scores, B, Hq, Hkv,
                                    S_k, W, P, n_blk, hd, scale, st);
  return (int)cudaGetLastError();
}

}  // namespace

// One entry point per instantiation width: kvcf_flash_prefill_d64, _d128,
// _d256, _d384, _d512.
#define KVCF_FLASH_PREFILL(DIM)                                                        \
  extern "C" int kvcf_flash_prefill_d##DIM(                                            \
      const void* q, const void* k, const void* v, const void* true_len,               \
      const void* row_offset, const void* block_mask, void* out, void* win_ml,         \
      void* scores, void* row_ml, int B, int Hq, int Hkv, int S_q, int S_k, int W,     \
      int SW, int P, int n_blk, int hd, float scale, void* stream) {                   \
    return flash_prefill<DIM>(q, k, v, true_len, row_offset, block_mask, out, win_ml,  \
                              scores, row_ml, B, Hq, Hkv, S_q, S_k, W, SW, P, n_blk,   \
                              hd, scale, stream);                                      \
  }
KVCF_FLASH_PREFILL(64)
KVCF_FLASH_PREFILL(128)
KVCF_FLASH_PREFILL(256)
KVCF_FLASH_PREFILL(384)
KVCF_FLASH_PREFILL(512)
