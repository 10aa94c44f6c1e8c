// K1's window-score pass: the SnapKV observation-window scores, for Hopper
// (sm_90a), on the tensor cores.  Included by csrc/flash_prefill.cu (head_dim
// up to 512, one row-copy width a build) and csrc/flash_prefill_wide.cu
// (above 512, every copy width); each host function launches it after its
// main pass whenever the window W > 0.
//
// Replaces the score emission of the Pallas TPU kernel
//   kvcache_factory_tpu/ops/kernels/flash_prefill.py::_flash_kernel
// (:299-344: the window rows' logits renormalized with their final (m, l),
// and its re-sweep of K on sparse paths and oversize windows).
//
// What it computes, per example b and query head hq (KV head hq / G):
//   scores[b, hq, c] = sum over window rows r in [tl - W, tl), r >= 0,
//                      c <= r (and, with a block mask M of pattern block P,
//                      M[b, hq, r / P, c / P] != 0) of
//                      exp(q[r].k[c] * scale - m_r) / l_r
// with (m_r, l_r) the main pass's final online-softmax max and sum of row r
// (win_ml [B, Hq, W, 2], natural-log units) and scale the true head_dim's
// 1/sqrt(hd).  Columns past every window row (c >= tl) are 0.
//
// What bounds it: 2 hd FLOP a visible (window row, column) pair, against
// the bytes of K's causal rows once per KV head, the window's q rows and
// the fp32 scores.  At W 8 the bytes bound it (about 4.7 us at B 2, 32 / 8
// heads of 128, S 4096 on an H100), at W 128 the products (7.4 us).  The
// TPU kernel keeps the window rows' logits in VMEM; here a stash would go
// to device memory ([B, Hq, W, S] fp32, 134 MB at W 128 there, written and
// read), so the pass recomputes them, on the tensor cores and reading each
// K tile once for all the query heads of its KV head.
//
// Design.  One CTA of one warpgroup per (64-key column tile, KV head, b,
// head split): its rows are the window rows of its query heads, so a K tile
// is read once for all of them.  Each head's W rows come in chunks of WB =
// min(round_up(W, 8), 256) rows; a row block holds one chunk of each of the
// CTA's hc heads, hc = min(G, max(1, ROWS / WB)), ROWS 128 up to head_dim
// 256 and 256 above (plan(): at W 128 and D 128 blocks of 128 rows took
// 42 us against 50 for 256, and at D 1024 31.6 against 24.9 on an H100,
// tools/time_scores.py).  When the grid would hold fewer than MIN_CTAS
// CTAs, hc is halved again: each (hq, c) stays one CTA's.  Per row block it
// computes S^T [64 keys x N rows] = K_tile . Q_w^T with wgmma m64nNk16 (N =
// 32, 64, 128 or 256, the least that holds the block before the split),
// both operands K-major in 128-byte-swizzled shared memory, accumulating in
// fp32 over hd in 64-channel chunks.  The chunks stream through a ring of 2
// (N 256) or 4 stages of one K box (8 KB) and N q rows (up to 32 KB), so
// shared memory does not grow with hd and one kernel serves every head_dim.
// Rows that are a whole number of 16-byte pieces come by TMA (one elected
// thread, the stage's mbarrier counting the bytes; rows before 0 or past S
// read as zeros through the map); other rows by 8- or 4-byte cp.async
// pieces into the same swizzled layout (zero-filled past hd and outside
// the tensor), each thread arriving on the stage's mbarrier with
// cp.async.mbarrier.arrive.noinc.  The epilogue stays in registers: each
// accumulator becomes exp2(s scale log2(e) - (m_r log2(e) + log2(l_r)))
// by one FFMA and one MUFU.EX2, the offset +inf for a row before 0, past
// the window or whose block does not select the tile's (so it adds 0); the
// causal compare c <= r runs only on the tiles that reach past the first
// window row.  Tried and not kept (tools/time_scores.py on variants, PERF.md
// §6): the window's q rows resident in shared memory with a CTA
// walking 8 key tiles (W 128: 52 against 56 us, W 8 and D 1024 slower), and
// a producer warp issuing the copies (five warps: one CTA an SM at N 256).
//
// The order of every sum is fixed by W, G and hd, never by the grid or the
// head split.  A thread holds keys 16 w + g and 16 w + g + 8 (warp w, lane
// 4 g + t) and rows 8 n + 2 t, 8 n + 2 t + 1 of each row block; it adds a
// head's rows in window-row order, then the quad adds its four partials as
// (t0 + t1) + (t2 + t3), and each head's column sums are carried across
// row blocks in window-row order in shared memory.  No atomics: two
// launches give bitwise-equal scores.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <algorithm>

namespace {
namespace ws {

typedef __nv_bfloat16 bf16;

constexpr int KEYS = 64;        // key columns a CTA: the wgmma's M
constexpr int CH = 64;          // channels a chunk: one 128-byte swizzled row
constexpr int THREADS = 128;    // one warpgroup
constexpr int NMAX = 256;       // rows a block at most: the wgmma's widest N
constexpr int MIN_CTAS = 256;   // the head split stops at this grid (2 CTAs an SM of 132)
constexpr int K_BYTES = KEYS * CH * 2;  // a K box: 8 KB
constexpr float LOG2E = 1.4426950408889634f;

__host__ __device__ constexpr int stages_of(int N) { return N <= 128 ? 4 : 2; }
__host__ __device__ constexpr int stage_bytes(int N) { return K_BYTES + N * CH * 2; }

// Dynamic shared memory: 1 KB of alignment slack, the ring, its mbarriers
// (32 bytes), two row blocks' rows and exponents and the hc heads' column
// sums.
inline size_t smem_bytes(int N, int nst, int hc) {
  return 1024 + (size_t)nst * stage_bytes(N) + 32 + 2 * N * 12 + (size_t)hc * KEYS * 4;
}

// --- shared memory, mbarriers and copies ---------------------------------------

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

// Wait until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n\t.reg .pred P1;\n\t"
      "WS_WAIT:\n\t"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n\t"
      "@P1 bra WS_DONE;\n\t"
      "bra WS_WAIT;\n\t"
      "WS_DONE:\n\t}\n" :: "r"(bar), "r"(parity) : "memory");
}

// One box of a 3-D tensor map (columns, rows, head plane) into shared
// memory, completing on `bar`; coordinates outside the tensor read zeros.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int col, int row, int plane) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(row),
         "r"(plane) : "memory");
}

// One PIECE-byte piece (8 or 4: cp.async.ca, the only form that takes them);
// `src_bytes` 0 fills zeros.
template <int PIECE>
__device__ __forceinline__ void cp_piece(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n"
               :: "r"(dst), "l"(src), "n"(PIECE), "r"(src_bytes) : "memory");
}

// Arrive on `bar` once every cp.async this thread issued has landed.
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" :: "r"(bar) : "memory");
}

// Orders the cp.async writes (generic proxy) before wgmma's reads (async).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// 2^x, one MUFU.EX2 (2^-22 relative); -inf gives +0.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Rows [row0, row0 + rows) x channels [c0, c0 + 64) of a [nrows, hd] plane
// into the 128-byte-swizzled box at `dst`, laid out as TMA lays it (16-byte
// chunk x of box row r at chunk x ^ (r & 7)), in PIECE-byte pieces; pieces
// at or past hd and rows outside [0, nrows) are zero-filled.  hd is a whole
// number of pieces.
template <int PIECE>
__device__ __forceinline__ void copy_box(uint32_t dst, const bf16* src, int row0, int rows,
                                         int nrows, int c0, int hd, int tid) {
  constexpr int PC = PIECE / 2, PPR = CH / PC;  // columns a piece, pieces a row
  for (int i = tid; i < rows * PPR; i += THREADS) {
    const int r = i / PPR, pc = (i % PPR) * PC;
    const int row = row0 + r, col = c0 + pc;
    const bool ok = row >= 0 && row < nrows && col < hd;
    cp_piece<PIECE>(dst + r * 128 + ((((pc >> 3) ^ r) & 7) << 4) + (pc & 7) * 2,
                    ok ? src + (size_t)row * hd + col : src, ok ? PIECE : 0);
  }
}

// --- wgmma --------------------------------------------------------------------

// A K-major operand of 128-byte rows (one 64-channel chunk), 128-byte
// swizzled: 8-row groups 1024 bytes apart.
__device__ __forceinline__ uint64_t desc_kmajor(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)64 << 32) |
         (1ull << 62);
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

#define WS_D16 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"
#define WS_D32 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, " \
  "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define WS_D64 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, " \
  "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, " \
  "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, " \
  "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"
#define WS_D128 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, " \
  "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, " \
  "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, " \
  "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, " \
  "%66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, " \
  "%82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, " \
  "%98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, " \
  "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, " \
  "%125, %126, %127}"
#define WS_F8(d, i)                                                                    \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]),          \
      "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define WS_F32(d, i) WS_F8(d, i), WS_F8(d, i + 8), WS_F8(d, i + 16), WS_F8(d, i + 24)

// d[64 x N] (+)= A[64 x 16] B[16 x N], both from shared memory, K-major.
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da, uint64_t db,
                                         int accumulate);
template <>
__device__ __forceinline__ void wgmma_ss<32>(float (&d)[16], uint64_t da, uint64_t db,
                                             int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 " WS_D16
      ", %16, %17, p, 1, 1, 0, 0;\n}\n"
      : WS_F8(d, 0), WS_F8(d, 8)
      : "l"(da), "l"(db), "r"(accumulate));
}
template <>
__device__ __forceinline__ void wgmma_ss<64>(float (&d)[32], uint64_t da, uint64_t db,
                                             int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WS_D32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : WS_F32(d, 0)
      : "l"(da), "l"(db), "r"(accumulate));
}
template <>
__device__ __forceinline__ void wgmma_ss<128>(float (&d)[64], uint64_t da, uint64_t db,
                                              int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " WS_D64
      ", %64, %65, p, 1, 1, 0, 0;\n}\n"
      : WS_F32(d, 0), WS_F32(d, 32)
      : "l"(da), "l"(db), "r"(accumulate));
}
template <>
__device__ __forceinline__ void wgmma_ss<256>(float (&d)[128], uint64_t da, uint64_t db,
                                              int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 " WS_D128
      ", %128, %129, p, 1, 1, 0, 0;\n}\n"
      : WS_F32(d, 0), WS_F32(d, 32), WS_F32(d, 64), WS_F32(d, 96)
      : "l"(da), "l"(db), "r"(accumulate));
}

#undef WS_D16
#undef WS_D32
#undef WS_D64
#undef WS_D128
#undef WS_F8
#undef WS_F32

// --- the kernel -----------------------------------------------------------------

// CTA (64-key tile, KV head x head split, b); PIECE 16 copies by TMA, 8 and
// 4 by cp.async pieces.  Row block c holds chunk c (window rows [c WB, c WB
// + WB)) of each of the CTA's heads, head h at block rows [h WB, h WB + WB);
// step i loads channels [64 j, 64 j + 64) of block c = i / n_chunk (j = i %
// n_chunk) into stage i % nst.
template <int PIECE, int N>
__global__ void __launch_bounds__(THREADS)
window_scores_tc_kernel(const __grid_constant__ CUtensorMap tm_q,
                        const __grid_constant__ CUtensorMap tm_k,
                        const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const int* __restrict__ true_len, const int* __restrict__ block_mask,
                        const float* __restrict__ win_ml, float* __restrict__ scores,
                        int Hq, int Hkv, int S, int W, int P, int n_blk, int hd, int WB,
                        int hc, int n_split, int nst, float scale_log2) {
  constexpr bool TMA = PIECE == 16;
  constexpr int SB = stage_bytes(N);
  const float INF = __int_as_float(0x7f800000);
  extern __shared__ unsigned char smem_raw[];
  // 128-byte swizzling repeats every 1024 bytes: align the boxes to that.
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const uint32_t sbase = smem_u32(smem);
  const uint32_t bar0 = sbase + nst * SB;
  int* rid_s = reinterpret_cast<int*>(smem + nst * SB + 32);  // [2][N] global row, -1: none
  float* mb_s = reinterpret_cast<float*>(rid_s + 2 * N);     // [2][N] exponent offset
  float* mt_s = mb_s + 2 * N;    // [2][N] the same, +inf where the block is unselected
  float* sums = mt_s + 2 * N;    // [hc][KEYS]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int col0 = blockIdx.x * KEYS, b = blockIdx.z;
  const int hkv = blockIdx.y / n_split, G = Hq / Hkv;
  const int h0 = (blockIdx.y % n_split) * hc, nh = min(hc, G - h0);
  const int hq0 = hkv * G + h0;                      // this CTA's first query head
  const int tl = true_len[b];
  float* sc = scores + ((size_t)b * Hq + hq0) * S;

  if (col0 >= tl) {  // past every window row: no causal column (uniform)
    for (int i = tid; i < nh * KEYS; i += THREADS)
      if (col0 + i % KEYS < S) sc[(size_t)(i / KEYS) * S + col0 + i % KEYS] = 0.f;
    return;
  }
  const int ws0 = tl - W;  // the global row of window row 0 (W > tl: below 0)
  const int n_chunk = (hd + CH - 1) / CH;
  const int n_steps = (W + WB - 1) / WB * n_chunk;
  // Every window row sees every key of the tile: no causal mask needed.
  const bool interior = col0 + KEYS - 1 <= max(ws0, 0);

  if (tid == 0) {
    for (int s = 0; s < nst; ++s) mbar_init(bar0 + 8 * s, TMA ? 1 : THREADS);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int i = tid; i < nh * KEYS; i += THREADS) sums[i] = 0.f;
  __syncthreads();

  auto issue = [&](int i) {
    const int c = i / n_chunk, ch0 = (i % n_chunk) * CH, s = i % nst;
    const uint32_t kd = sbase + s * SB, qd = kd + K_BYTES, bar = bar0 + 8 * s;
    const int row0 = ws0 + c * WB;
    if constexpr (TMA) {
      if (tid == 0) {
        mbar_expect_tx(bar, K_BYTES + nh * WB * CH * 2);
        tma_load(kd, &tm_k, bar, ch0, col0, b * Hkv + hkv);
        for (int h = 0; h < nh; ++h)
          tma_load(qd + h * WB * CH * 2, &tm_q, bar, ch0, row0, b * Hq + hq0 + h);
      }
    } else {
      copy_box<PIECE>(kd, k + ((size_t)b * Hkv + hkv) * S * hd, col0, KEYS, S, ch0, hd, tid);
      for (int h = 0; h < nh; ++h)
        copy_box<PIECE>(qd + h * WB * CH * 2, q + ((size_t)b * Hq + hq0 + h) * S * hd, row0, WB,
                        S, ch0, hd, tid);
      cp_async_arrive(bar);
    }
  };

  // Block c's rows, into the buffer of c's parity: the global row (-1 where
  // the row is before 0, past the window or of no head of this CTA) and the
  // exponent offset m log2(e) + log2(l) (+inf there), so that a probability
  // is exp2(s scale log2(e) - offset); with a block mask, the offset again,
  // +inf where the row's block does not select this tile's.
  auto fill_rows = [&](int c) {
    const int buf = (c & 1) * N;
    for (int x = tid; x < N; x += THREADS) {
      const int h = x / WB, wrow = c * WB + x % WB, r = ws0 + wrow;
      int id = -1;
      float m = INF;
      if (h < nh && wrow < W && r >= 0) {
        const size_t bh = (size_t)b * Hq + hq0 + h;
        const float* ml = win_ml + (bh * W + wrow) * 2;
        id = r;
        m = fmaf(ml[0], LOG2E, log2f(ml[1] == 0.f ? 1.f : ml[1]));
        if (block_mask)
          mt_s[buf + x] = block_mask[(bh * n_blk + min(r / P, n_blk - 1)) * n_blk +
                                     min(col0 / P, n_blk - 1)] ? m : INF;
      } else if (block_mask) {
        mt_s[buf + x] = INF;
      }
      rid_s[buf + x] = id;
      mb_s[buf + x] = m;
    }
  };

  float acc[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;
  const int kA = col0 + warp * 16 + g;  // this thread's keys: kA and kA + 8

  // Head `slot`'s partial sums of the thread's two keys, added across the
  // quad ((t0 + t1) + (t2 + t3)) and onto its running column sums.
  auto flush = [&](int slot, float p0, float p1) {
    p0 += __shfl_xor_sync(0xffffffffu, p0, 1);
    p0 += __shfl_xor_sync(0xffffffffu, p0, 2);
    p1 += __shfl_xor_sync(0xffffffffu, p1, 1);
    p1 += __shfl_xor_sync(0xffffffffu, p1, 2);
    if (t4 == 0) {
      sums[slot * KEYS + warp * 16 + g] += p0;
      sums[slot * KEYS + warp * 16 + g + 8] += p1;
    }
  };

  // Row block c's probabilities, each head's rows summed in window-row order.
  // acc[4 n + e]: key kA + 8 (e >> 1), block row 8 n + 2 t4 + (e & 1).
  auto epilogue = [&](int c) {
    const int* rid = rid_s + (c & 1) * N;
    const float* mb = (block_mask ? mt_s : mb_s) + (c & 1) * N;
    float p0 = 0.f, p1 = 0.f;
    int slot = 0, end = WB;
#pragma unroll
    for (int n = 0; n < N / 8; ++n) {
      if (8 * n >= nh * WB) break;  // uniform
      if (8 * n == end) {           // the next head's rows (uniform)
        flush(slot, p0, p1);
        p0 = p1 = 0.f;
        ++slot;
        end += WB;
      }
      const int r = 8 * n + 2 * t4;
      const float2 m = *reinterpret_cast<const float2*>(mb + r);
      float e0 = ex2(fmaf(acc[4 * n], scale_log2, -m.x));
      float e1 = ex2(fmaf(acc[4 * n + 1], scale_log2, -m.y));
      float e2 = ex2(fmaf(acc[4 * n + 2], scale_log2, -m.x));
      float e3 = ex2(fmaf(acc[4 * n + 3], scale_log2, -m.y));
      if (!interior) {  // uniform
        const int2 id = *reinterpret_cast<const int2*>(rid + r);
        e0 = kA <= id.x ? e0 : 0.f;
        e1 = kA <= id.y ? e1 : 0.f;
        e2 = kA + 8 <= id.x ? e2 : 0.f;
        e3 = kA + 8 <= id.y ? e3 : 0.f;
      }
      p0 += e0;
      p0 += e1;
      p1 += e2;
      p1 += e3;
    }
    flush(slot, p0, p1);
  };

  for (int i = 0; i < min(nst, n_steps); ++i) issue(i);
  for (int i = 0; i < n_steps; ++i) {
    const int c = i / n_chunk, j = i % n_chunk, s = i % nst;
    if (j == 0) fill_rows(c);
    mbar_wait(bar0 + 8 * s, (i / nst) & 1);
    if constexpr (!TMA) fence_proxy_async();
    const uint32_t kd = sbase + s * SB, qd = kd + K_BYTES;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < CH / 16; ++kk)  // k-step kk: 32 bytes into each row
      wgmma_ss<N>(acc, desc_kmajor(kd + kk * 32), desc_kmajor(qd + kk * 32), j > 0 || kk > 0);
    wgmma_commit();
    wgmma_wait_all();
    fence_acc(acc);
    __syncthreads();  // stage s is read; block c's rows are written
    if (i + nst < n_steps) issue(i + nst);
    if (j == n_chunk - 1) epilogue(c);
  }
  __syncthreads();
  for (int i = tid; i < nh * KEYS; i += THREADS)
    if (col0 + i % KEYS < S) sc[(size_t)(i / KEYS) * S + col0 + i % KEYS] = sums[i];
}

// --- host side ------------------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime's entry-point query, so the
// library links no libcuda of its own.
inline EncodeTiled encode_tiled() {
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

// A [planes, rows, hd] bf16 tensor as a 3-D map read in boxes of
// `box_rows` rows x 64 columns, 128-byte swizzled; rows outside [0, rows)
// and columns past hd read as zeros (hd % 8 == 0: 16-byte row strides).
inline bool make_map(EncodeTiled enc, CUtensorMap* map, const void* base, int hd, int rows,
                     int planes, int box_rows) {
  const cuuint64_t dims[3] = {(cuuint64_t)hd, (cuuint64_t)rows, (cuuint64_t)planes};
  const cuuint64_t strides[2] = {(cuuint64_t)hd * 2, (cuuint64_t)rows * hd * 2};
  const cuuint32_t box[3] = {(cuuint32_t)CH, (cuuint32_t)box_rows, 1};
  const cuuint32_t step[3] = {1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims, strides,
             box, step, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The largest dynamic shared memory an instantiation asks for: its full
// ring and 32 heads' sums (hc <= NMAX / 8).
template <int N>
constexpr int smem_max() {
  return 1024 + stages_of(N) * stage_bytes(N) + 32 + 2 * N * 12 + NMAX / 8 * KEYS * 4;
}

// Once per device, for every instantiation of this copy width (so that a
// launch under CUDA-graph capture makes no such call).
template <int PIECE>
int allow_smem() {
  static bool set[64] = {false};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  if (!set[dev]) {
    cudaError_t err = cudaFuncSetAttribute(window_scores_tc_kernel<PIECE, 32>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           smem_max<32>());
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(window_scores_tc_kernel<PIECE, 64>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, smem_max<64>());
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(window_scores_tc_kernel<PIECE, 128>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, smem_max<128>());
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(window_scores_tc_kernel<PIECE, 256>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, smem_max<256>());
    if (err != cudaSuccess) return (int)err;
    set[dev] = true;
  }
  return 0;
}

// A launch's layout of the work, from the shapes alone.
struct Plan {
  int WB, hc, n_split, nst, N;
  dim3 grid;
};

// The row-block rule: WB = min(round_up(W, 8), 256) rows a head's chunk; a
// block of the chunks of min(G, max(1, ROWS / WB)) heads, ROWS = 128 up to
// head_dim 256 (a CTA's loop is two chunks long: more CTAs an SM hide its
// latency) and 256 above (each K chunk feeds twice the rows); N the least
// of 32, 64, 128 and 256 that holds the block (from G, W and hd alone); hc
// heads a CTA, halved while the grid holds fewer than MIN_CTAS CTAs.
inline Plan plan(int B, int Hq, int Hkv, int S, int W, int hd) {
  Plan p;
  const int G = Hq / Hkv, tiles = (S + KEYS - 1) / KEYS;
  p.WB = std::min((W + 7) / 8 * 8, NMAX);
  p.hc = std::min(G, std::max(1, (hd <= 256 ? 128 : NMAX) / p.WB));
  const int rows = p.hc * p.WB;
  p.N = rows <= 32 ? 32 : rows <= 64 ? 64 : rows <= 128 ? 128 : 256;
  while (p.hc > 1 && (long long)tiles * B * Hkv * ((G + p.hc - 1) / p.hc) < MIN_CTAS)
    p.hc = (p.hc + 1) / 2;
  p.n_split = (G + p.hc - 1) / p.hc;
  p.nst = std::min(stages_of(p.N), (W + p.WB - 1) / p.WB * ((hd + CH - 1) / CH));
  p.grid = dim3(tiles, Hkv * p.n_split, B);
  return p;
}

template <int PIECE, int N>
int launch(const Plan& p, const CUtensorMap& tq, const CUtensorMap& tk, const void* q,
           const void* k, const void* true_len, const void* block_mask, const void* win_ml,
           void* scores, int Hq, int Hkv, int S, int W, int P, int n_blk, int hd, float scale,
           cudaStream_t st) {
  window_scores_tc_kernel<PIECE, N><<<p.grid, THREADS, smem_bytes(N, p.nst, p.hc), st>>>(
      tq, tk, static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const int*>(true_len), static_cast<const int*>(block_mask),
      static_cast<const float*>(win_ml), static_cast<float*>(scores), Hq, Hkv, S, W, P, n_blk,
      hd, p.WB, p.hc, p.n_split, p.nst, scale * LOG2E);
  return (int)cudaGetLastError();
}

// The window scores [B, Hq, S] fp32 of whole-sequence queries (S_q == S_k
// == S) from the main pass's win_ml, W >= 1, rows of hd bf16 copied in
// PIECE-byte pieces (q and k aligned to them).
template <int PIECE>
int window_scores(const void* q, const void* k, const void* true_len, const void* block_mask,
                  const void* win_ml, void* scores, int B, int Hq, int Hkv, int S, int W, int P,
                  int n_blk, int hd, float scale, cudaStream_t st) {
  if (W < 1 || Hkv < 1 || Hq % Hkv != 0 || hd < 2) return (int)cudaErrorInvalidValue;
  const Plan p = plan(B, Hq, Hkv, S, W, hd);
  CUtensorMap tq{}, tk{};  // 8- and 4-byte pieces copy by cp.async: no maps
  if constexpr (PIECE == 16) {
    EncodeTiled enc = encode_tiled();
    if (!enc) return (int)cudaErrorNotSupported;
    if (!make_map(enc, &tq, q, hd, S, B * Hq, p.WB) ||
        !make_map(enc, &tk, k, hd, S, B * Hkv, KEYS))
      return (int)cudaErrorInvalidValue;
  }
  if (int err = allow_smem<PIECE>()) return err;
  auto go = [&](auto run) {
    return run(p, tq, tk, q, k, true_len, block_mask, win_ml, scores, Hq, Hkv, S, W, P, n_blk,
               hd, scale, st);
  };
  if (p.N == 32) return go(launch<PIECE, 32>);
  if (p.N == 64) return go(launch<PIECE, 64>);
  if (p.N == 128) return go(launch<PIECE, 128>);
  return go(launch<PIECE, 256>);
}

}  // namespace ws
}  // namespace
