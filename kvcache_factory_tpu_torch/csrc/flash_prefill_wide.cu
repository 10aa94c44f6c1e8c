// K1 above head_dim 512: causal GQA flash prefill attention plus SnapKV
// window-score emission, for Hopper (sm_90a), bf16 in, fp32 accumulation,
// with every variant of csrc/flash_prefill.cu (sliding window, chunk
// row_offset, the a-shape and vertical-slash block masks, the (m, l) output
// of a ring-attention hop) at any even head_dim.
//
// Replaces the Pallas TPU kernel
//   kvcache_factory_tpu/ops/kernels/flash_prefill.py::_flash_kernel
// at the head_dims above 512 that it takes (any D % 128 == 0: nothing caps
// D there); the port runs every even head_dim above 512 here.  What it
// computes is flash_prefill.cu's function, to the bit of its contract: per
// example b and query head hq (kv head hq / G), q row r at global id R =
// row_offset[b] + r attends the columns c <= min(R, tl-1, S_k-1) (c > R - SW
// under a sliding window, and only the blocks its own block selects under a
// block mask) with logits scaled by the caller's 1/sqrt(hd); the window
// scores sum the final normalized probabilities over the observation rows
// [tl - W, tl); a ring hop's (m, l) leave in natural-log units, a row that
// saw no column as (-FLT_MAX, 0) with a zero output.  Rows at or past
// true_len in a CTA that holds no valid row are written as zeros.
//
// What bounds it: the QK and PV products, 4 hd FLOP a visible (row,
// column) pair, as at the narrower widths: the tensor cores.  What limits
// the design is shared memory: flash_prefill.cu keeps a CTA's Q tile and a
// ring of whole K/V rows resident, 144 / 192 KB at 384 / 512, so above 512
// one 32-key stage alone no longer fits beside Q.  Here nothing in shared
// memory grows with hd:
//  1. O's columns are split over a grid dimension of column slices of DV =
//     256: CTA (hq, q tile x slice, b) owns 64 q rows and DV columns of O
//     (16 x 256 fp32 accumulators a warp, 128 a thread).
//  2. S = Q K^T is accumulated over hd in chunks of DC = 64 channels: each
//     chunk's 64 q rows and 64 keys pass through a 2-buffer cp.async ring
//     (18 KB each), the next chunk's copies in flight under this one's
//     products.  A tile's V slice (64 keys x 256 columns, 33 KB) is copied
//     at the start of the tile, under the QK^T chunks.  71 KB a CTA.
//  3. Every slice CTA of a q tile computes S with the same instructions in
//     the same order, so the softmax's (m, l) agree bitwise across slices;
//     the slices recompute S (the work is (n_slice + 1) / 2 times a single
//     pass's).  The (m, l) of a ring hop and of the observation-window rows
//     are written once, by slice 0.
//  4. Both products run on the tensor cores with mma.sync m16n8k16 (bf16
//     in, fp32 accumulate): Q and K by ldmatrix, V by ldmatrix.trans, P from
//     the S accumulator rounded to bf16 (as every K1 build and the plain
//     version do).  Each warp owns 16 q rows; the online softmax runs in
//     base 2 with scale * log2(e) folded into the logits, one rescale a
//     64-key tile; a masked logit is -FLT_MAX and weighs exactly 0.
//  5. Rows are copied in pieces of PIECE bytes (16, or 8 / 4 for rows that
//     are no whole number of 16-byte pieces), each piece wholly inside or
//     past hd: pieces past hd and rows past the tensor are zero-filled
//     through cp.async's source size, never read.  The host function picks
//     PIECE from hd.
//  6. A block mask is read once per 64-key tile: the pattern block P is a
//     multiple of 64 (or one block covers everything), so a q tile and a
//     key tile each lie in one block, and a tile that the q tile's block
//     does not select is skipped whole.
// The window scores (W > 0) come from a second kernel, as at the narrower
// widths: one CTA per (64 columns, hq, b) recomputes the W x 64 window
// logits over hd in 64-channel chunks (thread (column, half) keeps the dots
// of rows half, half + 2, ... of a 64-row window block in registers),
// normalizes them with the stored (m, 1/l) and sums over rows in a fixed
// order.  No atomics anywhere: two launches give bitwise-equal outputs.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int BM = 64;          // q rows a CTA: 4 warps of 16
constexpr int BN = 64;          // keys a tile
constexpr int DC = 64;          // channels a QK^T chunk
constexpr int DV = 256;         // O columns a CTA: one column slice
constexpr int THREADS = 128;
constexpr int LDC = DC + 8;     // a chunk row in shared memory: 144 bytes
constexpr int LDV = DV + 8;     // a V slice row: 528 bytes
constexpr int CHUNK = BM * LDC; // elements of one Q or K chunk buffer (BN == BM)
constexpr int SMEM_BYTES = (4 * CHUNK + BN * LDV) * 2;  // 70,656
constexpr int WBLOCK = 64;      // window rows the score pass holds at a time
constexpr int SBN = 64;         // columns a CTA of the score pass
constexpr float NEG_INF = -3.4028234663852886e38f;  // float32 finfo.min
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
static_assert(BN == BM, "one chunk buffer size for Q and K");

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// One PIECE-byte piece from global to shared memory; `ok` false fills zeros
// (nothing is read).  16-byte pieces bypass L1 (.cg); 8 and 4 take .ca, the
// only form for them.
template <int PIECE>
__device__ __forceinline__ void cp_piece(uint32_t dst, const void* src, bool ok) {
  if constexpr (PIECE == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(dst), "l"(src), "r"(ok ? 16 : 0) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n"
                 :: "r"(dst), "l"(src), "n"(PIECE), "r"(ok ? PIECE : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Rows [row0, row0 + ROWS) x channels [c0, c0 + NC) of a [nrows, hd] bf16
// plane into shared memory rows `ld` elements apart, in PIECE-byte pieces;
// pieces at or past hd and rows at or past nrows are zero-filled.  hd is a
// whole number of pieces and c0 a multiple of NC, so a piece is wholly
// inside or past hd.
template <int PIECE, int ROWS, int NC>
__device__ __forceinline__ void copy_tile(bf16* dst, int ld, const bf16* src, int row0,
                                          int nrows, int c0, int hd, int tid) {
  constexpr int PC = PIECE / 2, PPR = NC / PC;
  const uint32_t base = smem_u32(dst);
#pragma unroll 4
  for (int i = tid; i < ROWS * PPR; i += THREADS) {
    const int r = i / PPR, c = (i % PPR) * PC;
    const bool ok = row0 + r < nrows && c0 + c < hd;
    cp_piece<PIECE>(base + (uint32_t)(r * ld + c) * 2,
                    ok ? src + (size_t)(row0 + r) * hd + c0 + c : src, ok);
  }
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

// d += a . b, m16n8k16, bf16 in, fp32 accumulate.
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// CTA (hq, q tile x slice, b): 64 q rows, O columns [DV slice, DV slice +
// DV).  Warp w owns q rows 16 w .. 16 w + 15 of the tile; lane (gid, tig)
// holds rows gid and gid + 8 of them (the mma's C layout).
template <int PIECE>
__global__ void __launch_bounds__(THREADS)
flash_wide_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, const int* __restrict__ true_len,
                  const int* __restrict__ row_offset, const int* __restrict__ block_mask,
                  bf16* __restrict__ out, float* __restrict__ win_ml,
                  float* __restrict__ row_ml, int Hq, int Hkv, int S_q, int S_k, int W,
                  int SW, int P, int n_blk, int hd, int n_slice, float scale_log2) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);  // [2][BM][LDC]
  bf16* sK = sQ + 2 * CHUNK;                 // [2][BN][LDC]
  bf16* sV = sK + 2 * CHUNK;                 // [BN][LDV]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int hq = blockIdx.x, b = blockIdx.z;
  const int slice = blockIdx.y % n_slice;
  const int qt = gridDim.y / n_slice - 1 - blockIdx.y / n_slice;  // longest rows first
  const int c_lo = slice * DV;                                      // first O column
  const int ncols = min(DV, hd - c_lo);                             // even: hd is
  const bool writer = slice == 0;  // writes (m, l) and the window's (m, l)
  const int hkv = hq / (Hq / Hkv);
  const int tl = true_len[b];
  const int lrow0 = qt * BM;
  const int row0 = lrow0 + (row_offset ? row_offset[b] : 0);
  const size_t bh = (size_t)b * Hq + hq;
  bf16* oh = out + bh * S_q * hd;
  const size_t plane = (size_t)gridDim.z * Hq * S_q;
  float* mh = row_ml ? row_ml + bh * S_q : nullptr;

  if (row0 >= tl) {  // no valid row in this CTA (uniform): zeros, empty (m, l)
    for (int i = tid; i < BM * (ncols / 2); i += THREADS) {
      const int r = lrow0 + i / (ncols / 2);
      if (r < S_q)
        *reinterpret_cast<uint32_t*>(oh + (size_t)r * hd + c_lo + (i % (ncols / 2)) * 2) = 0u;
    }
    if (mh && writer)
      for (int r = lrow0 + tid; r < min(lrow0 + BM, S_q); r += THREADS) {
        mh[r] = NEG_INF;
        mh[plane + r] = 0.f;
      }
    return;
  }

  // The key tiles from the first holding a column inside the first row's
  // window to the causal frontier (empty only for a ring hop whose window
  // starts past the shard).
  const int col_max = min(tl, S_k) - 1;
  const int kv_end = min(min(row0 + BM, tl), S_k);
  const int kt_begin = SW > 0 ? max(row0 - SW + 1, 0) / BN : 0;
  const int kt_end = (kv_end + BN - 1) / BN;
  // Whole-sequence queries under a block mask: row0 is local; the tile's
  // rows lie in one q block (a block index past the last is the last).
  const int* mb = block_mask ? block_mask + bh * n_blk * n_blk : nullptr;
  const int qblk = mb ? min(lrow0 / P, n_blk - 1) : 0;

  const int r_lo = row0 + warp * 16 + gid, r_hi = r_lo + 8;  // global ids
  const int lim_lo = min(r_lo, col_max), lim_hi = min(r_hi, col_max);
  const int win_lo = SW > 0 ? r_lo - SW : -1, win_hi = SW > 0 ? r_hi - SW : -1;

  const bf16* qh = q + bh * S_q * hd;
  const size_t kv_plane = ((size_t)b * Hkv + hkv) * S_k * hd;
  const bf16* kh = k + kv_plane;
  const bf16* vh = v + kv_plane;
  const int n_chunks = (hd + DC - 1) / DC;

  // ldmatrix row addresses.  A (Q, 16 rows x 16 channels): row lane & 15,
  // channel 8 (lane >> 4).  B (K, 16 keys x 16 channels, two n-tiles): key
  // (lane & 7) + 8 (lane >> 4), channel 8 ((lane >> 3) & 1).  V^T by .trans
  // (16 keys x 16 columns, two n-tiles): key lane & 15, column 8 (lane >> 4).
  const uint32_t q_addr = (uint32_t)((warp * 16 + (lane & 15)) * LDC + 8 * (lane >> 4)) * 2;
  const uint32_t k_addr = (uint32_t)(((lane & 7) + 8 * (lane >> 4)) * LDC +
                                     8 * ((lane >> 3) & 1)) * 2;
  const uint32_t v_addr = smem_u32(sV) + (uint32_t)((lane & 15) * LDV + 8 * (lane >> 4)) * 2;

  float o[DV / 8][4];
#pragma unroll
  for (int n = 0; n < DV / 8; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) o[n][i] = 0.f;
  float m_lo = NEG_INF, m_hi = NEG_INF, l_lo = 0.f, l_hi = 0.f;  // l: this lane's share

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    if (mb && !mb[qblk * n_blk + min(kt * BN / P, n_blk - 1)]) continue;  // uniform
    const int key0 = kt * BN;
    copy_tile<PIECE, BN, DV>(sV, LDV, vh, key0, S_k, c_lo, hd, tid);
    cp_async_commit();
    copy_tile<PIECE, BM, DC>(sQ, LDC, qh, lrow0, S_q, 0, hd, tid);
    copy_tile<PIECE, BN, DC>(sK, LDC, kh, key0, S_k, 0, hd, tid);
    cp_async_commit();

    float s[BN / 8][4];
#pragma unroll
    for (int n = 0; n < BN / 8; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[n][i] = 0.f;
    for (int c = 0; c < n_chunks; ++c) {
      if (c + 1 < n_chunks) {  // the next chunk's copies under this one's products
        const int nb = (c + 1) & 1;
        copy_tile<PIECE, BM, DC>(sQ + nb * CHUNK, LDC, qh, lrow0, S_q, (c + 1) * DC, hd, tid);
        copy_tile<PIECE, BN, DC>(sK + nb * CHUNK, LDC, kh, key0, S_k, (c + 1) * DC, hd, tid);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const uint32_t qc = smem_u32(sQ + (c & 1) * CHUNK) + q_addr;
      const uint32_t kc = smem_u32(sK + (c & 1) * CHUNK) + k_addr;
#pragma unroll
      for (int kk = 0; kk < DC / 16; ++kk) {
        uint32_t a[4];
        ldsm_x4(qc + kk * 32, a);
#pragma unroll
        for (int n2 = 0; n2 < BN / 16; ++n2) {
          uint32_t bk[4];
          ldsm_x4(kc + (uint32_t)(n2 * 16 * LDC) * 2 + kk * 32, bk);
          mma16816(s[2 * n2], a, bk[0], bk[1]);
          mma16816(s[2 * n2 + 1], a, bk[2], bk[3]);
        }
      }
      __syncthreads();  // chunk buffer c & 1 is free for chunk c + 2
    }

    // Mask, then one online-softmax step for the tile (base 2).
    float mx_lo = NEG_INF, mx_hi = NEG_INF;
#pragma unroll
    for (int n = 0; n < BN / 8; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int c = key0 + n * 8 + 2 * tig + (i & 1);
        const bool hi = i >= 2;
        const bool vis = c <= (hi ? lim_hi : lim_lo) && c > (hi ? win_hi : win_lo);
        s[n][i] = vis ? s[n][i] * scale_log2 : NEG_INF;
        if (hi) mx_hi = fmaxf(mx_hi, s[n][i]); else mx_lo = fmaxf(mx_lo, s[n][i]);
      }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, off));
      mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, off));
    }
    const float mn_lo = fmaxf(m_lo, mx_lo), mn_hi = fmaxf(m_hi, mx_hi);
    // A row with no visible column so far keeps m = -FLT_MAX and weighs 0.
    const float a_lo = mn_lo == NEG_INF ? 1.f : exp2f(m_lo - mn_lo);
    const float a_hi = mn_hi == NEG_INF ? 1.f : exp2f(m_hi - mn_hi);
    m_lo = mn_lo;
    m_hi = mn_hi;
    float sum_lo = 0.f, sum_hi = 0.f;
#pragma unroll
    for (int n = 0; n < BN / 8; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const bool hi = i >= 2;
        const float m = hi ? m_hi : m_lo;
        const float p = s[n][i] == NEG_INF ? 0.f : exp2f(s[n][i] - m);
        s[n][i] = p;
        if (hi) sum_hi += p; else sum_lo += p;
      }
    l_lo = l_lo * a_lo + sum_lo;
    l_hi = l_hi * a_hi + sum_hi;
#pragma unroll
    for (int n = 0; n < DV / 8; ++n) {
      o[n][0] *= a_lo; o[n][1] *= a_lo; o[n][2] *= a_hi; o[n][3] *= a_hi;
    }

    // O += P V over this slice's columns (those past hd hold zeros and
    // are never written; the n-tiles wholly past hd are skipped).
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      uint32_t pa[4];
      pa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int n2 = 0; n2 < DV / 16; ++n2) {
        if (n2 * 16 < ncols) {
          uint32_t bv[4];
          ldsm_x4_trans(v_addr + (uint32_t)(kk * 16 * LDV + n2 * 16) * 2, bv);
          mma16816(o[2 * n2], pa, bv[0], bv[1]);
          mma16816(o[2 * n2 + 1], pa, bv[2], bv[3]);
        }
      }
    }
    __syncthreads();  // every warp is done with the V slice and the chunks
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l_lo += __shfl_xor_sync(0xffffffffu, l_lo, off);
    l_hi += __shfl_xor_sync(0xffffffffu, l_hi, off);
  }
  // Natural-log units leave the kernel; an empty row keeps -FLT_MAX exactly.
  const float mn_lo = m_lo == NEG_INF ? NEG_INF : m_lo * LN2;
  const float mn_hi = m_hi == NEG_INF ? NEG_INF : m_hi * LN2;
  const int o_lo = lrow0 + warp * 16 + gid, o_hi = o_lo + 8;  // local rows
  if (mh && writer && tig == 0) {
    if (o_lo < S_q) { mh[o_lo] = mn_lo; mh[plane + o_lo] = l_lo; }
    if (o_hi < S_q) { mh[o_hi] = mn_hi; mh[plane + o_hi] = l_hi; }
  }
  const float il_lo = 1.f / (l_lo == 0.f ? 1.f : l_lo);
  const float il_hi = 1.f / (l_hi == 0.f ? 1.f : l_hi);
#pragma unroll
  for (int n = 0; n < DV / 8; ++n) {
    const int col = n * 8 + 2 * tig;  // hd is even: a pair is in or out
    if (col >= ncols) continue;
    if (o_lo < S_q)
      *reinterpret_cast<uint32_t*>(oh + (size_t)o_lo * hd + c_lo + col) =
          pack_bf16(o[n][0] * il_lo, o[n][1] * il_lo);
    if (o_hi < S_q)
      *reinterpret_cast<uint32_t*>(oh + (size_t)o_hi * hd + c_lo + col) =
          pack_bf16(o[n][2] * il_hi, o[n][3] * il_hi);
  }
  // W > 0 only for whole-sequence queries (no offset): r == global id.
  if (W > 0 && writer && tig == 0) {  // final (m, l) of the observation-window rows
    const int ws = tl - W;
    float* ml = win_ml + bh * W * 2;
    if (r_lo >= ws && r_lo < tl) { ml[(r_lo - ws) * 2] = mn_lo; ml[(r_lo - ws) * 2 + 1] = l_lo; }
    if (r_hi >= ws && r_hi < tl) { ml[(r_hi - ws) * 2] = mn_hi; ml[(r_hi - ws) * 2 + 1] = l_hi; }
  }
}

// One CTA per (64-column tile, hq, b): scores[c] = sum over window rows r
// with c <= r (and, with a block mask, whose q block selects c's block) of
// exp(q[r].k[c] * scale - m_r) / l_r.  Thread (col, half) keeps the dots of
// window rows half, half + 2, ... of the current 64-row block in registers
// while the block's q rows and the tile's keys pass through shared memory
// 64 channels at a time; it adds those rows in order across the blocks.
template <int PIECE>
__global__ void __launch_bounds__(128)
window_scores_wide_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                          const int* __restrict__ true_len, const int* __restrict__ block_mask,
                          const float* __restrict__ win_ml, float* __restrict__ scores,
                          int Hq, int Hkv, int S, int W, int P, int n_blk, int hd,
                          float scale) {
  __shared__ __align__(16) bf16 Ks[SBN * LDC];
  __shared__ __align__(16) bf16 Qw[WBLOCK * LDC];
  __shared__ float m_w[WBLOCK], il_w[WBLOCK], part[128];
  __shared__ int sel_w[WBLOCK];

  const int tid = threadIdx.x;
  const int hq = blockIdx.y, b = blockIdx.z;
  const int hkv = hq / (Hq / Hkv);
  const int col0 = blockIdx.x * SBN;
  const int tl = true_len[b];
  const int ws = tl - W;
  float* sc = scores + ((size_t)b * Hq + hq) * S;
  const int col = tid & (SBN - 1), half = tid >> 6;  // half is uniform in a warp

  if (col0 >= tl) {  // past every window row: no causal column (uniform)
    if (half == 0 && col0 + col < S) sc[col0 + col] = 0.f;
    return;
  }

  const bf16* kh = k + ((size_t)b * Hkv + hkv) * S * hd;
  const bf16* qh = q + ((size_t)b * Hq + hq) * S * hd;
  const float* ml = win_ml + ((size_t)b * Hq + hq) * W * 2;
  const int* mh = block_mask ? block_mask + ((size_t)b * Hq + hq) * n_blk * n_blk : nullptr;
  const int c = col0 + col;
  float acc = 0.f;
  for (int wb = 0; wb < W; wb += WBLOCK) {  // window rows [wb, wb + nw)
    const int nw = min(WBLOCK, W - wb);
    __syncthreads();  // the last block's rows and scalars are no longer read
    for (int r = tid; r < nw; r += 128) {
      const int row = ws + wb + r;
      if (row >= 0) {
        const float l = ml[(wb + r) * 2 + 1];
        m_w[r] = ml[(wb + r) * 2];
        il_w[r] = 1.f / (l == 0.f ? 1.f : l);
        sel_w[r] = mh ? mh[min(row / P, n_blk - 1) * n_blk + min(col0 / P, n_blk - 1)] : 1;
      }
    }
    float dot[WBLOCK / 2];
#pragma unroll
    for (int i = 0; i < WBLOCK / 2; ++i) dot[i] = 0.f;
    for (int d0 = 0; d0 < hd; d0 += DC) {
      __syncthreads();  // the last chunk is no longer read
      copy_tile<PIECE, SBN, DC>(Ks, LDC, kh, col0, S, d0, hd, tid);
      // Window rows ws + wb + r; rows before row 0 or past the block read
      // nothing and hold zeros.
      {
        constexpr int PC = PIECE / 2, PPR = DC / PC;
        const uint32_t base = smem_u32(Qw);
        for (int i = tid; i < WBLOCK * PPR; i += 128) {
          const int r = i / PPR, cc = (i % PPR) * PC;
          const int row = ws + wb + r;
          const bool ok = r < nw && row >= 0 && d0 + cc < hd;
          cp_piece<PIECE>(base + (uint32_t)(r * LDC + cc) * 2,
                          ok ? qh + (size_t)row * hd + d0 + cc : qh, ok);
        }
      }
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
      float kf[DC];
#pragma unroll
      for (int d8 = 0; d8 < DC / 8; ++d8) {
        const uint4 kr = *reinterpret_cast<const uint4*>(Ks + col * LDC + d8 * 8);
        const bf16* k8 = reinterpret_cast<const bf16*>(&kr);
#pragma unroll
        for (int i = 0; i < 8; ++i) kf[d8 * 8 + i] = __bfloat162float(k8[i]);
      }
#pragma unroll
      for (int i = 0; i < WBLOCK / 2; ++i) {
        const int r = half + 2 * i;
        if (r >= nw) break;  // uniform in a warp
        float d = dot[i];
#pragma unroll
        for (int d8 = 0; d8 < DC / 8; ++d8) {
          const uint4 qr = *reinterpret_cast<const uint4*>(Qw + r * LDC + d8 * 8);
          const bf16* q8 = reinterpret_cast<const bf16*>(&qr);
#pragma unroll
          for (int j = 0; j < 8; ++j) d = fmaf(__bfloat162float(q8[j]), kf[d8 * 8 + j], d);
        }
        dot[i] = d;
      }
    }
#pragma unroll
    for (int i = 0; i < WBLOCK / 2; ++i) {
      const int r = half + 2 * i;
      if (r >= nw) break;
      const int row = ws + wb + r;
      if (row < 0 || c > row || !sel_w[r]) continue;
      acc += expf(dot[i] * scale - m_w[r]) * il_w[r];
    }
  }
  part[tid] = acc;
  __syncthreads();
  if (half == 0 && c < S) sc[c] = part[col] + part[col + SBN];
}

// The host function for rows copied in PIECE-byte pieces (hd a whole
// number of them).  The wrapper's contract, as flash_prefill.cu's: scores
// only for whole-sequence queries without a window; q and k lengths differ
// only in chunk mode; a block mask only for whole-sequence queries, with
// n_blk blocks of P rows covering S_q and P a multiple of 64 unless one
// block covers everything; (m, l) only without scores or a block mask.
template <int PIECE>
int flash_wide(const void* q, const void* k, const void* v, const void* true_len,
               const void* row_offset, const void* block_mask, void* out, void* win_ml,
               void* scores, void* row_ml, int B, int Hq, int Hkv, int S_q, int S_k, int W,
               int SW, int P, int n_blk, int n_slice, int hd, float scale, void* stream) {
  if (W < 0 || SW < 0 || (W > 0 && (SW > 0 || row_offset)) ||
      (!row_offset && S_q != S_k) || S_q < 1 || S_k < 1 || Hkv < 1 || Hq % Hkv != 0 ||
      (row_ml && (W > 0 || block_mask)))
    return (int)cudaErrorInvalidValue;
  if (block_mask && (row_offset || P < 1 || n_blk != (S_q + P - 1) / P ||
                     (n_blk > 1 && P % BN != 0)))
    return (int)cudaErrorInvalidValue;
  const int n_qt = (S_q + BM - 1) / BM;
  if ((long long)n_qt * n_slice > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  static bool smem_set[64] = {false};  // once per instantiation and device
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  if (!smem_set[dev]) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_wide_kernel<PIECE>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
    if (err != cudaSuccess) return (int)err;
    smem_set[dev] = true;
  }
  dim3 grid(Hq, n_qt * n_slice, B);
  flash_wide_kernel<PIECE><<<grid, THREADS, SMEM_BYTES, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const int*>(true_len), static_cast<const int*>(row_offset),
      static_cast<const int*>(block_mask), static_cast<bf16*>(out),
      static_cast<float*>(win_ml), static_cast<float*>(row_ml), Hq, Hkv, S_q, S_k, W, SW, P,
      n_blk, hd, n_slice, scale * LOG2E);
  if (W > 0) {
    dim3 g2((S_k + SBN - 1) / SBN, Hq, B);
    window_scores_wide_kernel<PIECE><<<g2, 128, 0, st>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const int*>(true_len), static_cast<const int*>(block_mask),
        static_cast<const float*>(win_ml), static_cast<float*>(scores), Hq, Hkv, S_k, W, P,
        n_blk, hd, scale);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Any even head_dim hd, in n_slice = ceil(hd / 256) column slices (the
// wrapper passes both, and the true 1/sqrt(hd)); rows are copied in the
// widest pieces hd is a whole number of, and q, k and v must be aligned to
// them.
extern "C" int kvcf_flash_prefill_wide(
    const void* q, const void* k, const void* v, const void* true_len, const void* row_offset,
    const void* block_mask, void* out, void* win_ml, void* scores, void* row_ml, int B, int Hq,
    int Hkv, int S_q, int S_k, int W, int SW, int P, int n_blk, int n_slice, int hd,
    float scale, void* stream) {
  if (hd < 2 || hd % 2 != 0 || n_slice != (hd + DV - 1) / DV)
    return (int)cudaErrorInvalidValue;
  if (hd % 8 == 0)
    return flash_wide<16>(q, k, v, true_len, row_offset, block_mask, out, win_ml, scores,
                          row_ml, B, Hq, Hkv, S_q, S_k, W, SW, P, n_blk, n_slice, hd, scale,
                          stream);
  if (hd % 4 == 0)
    return flash_wide<8>(q, k, v, true_len, row_offset, block_mask, out, win_ml, scores,
                         row_ml, B, Hq, Hkv, S_q, S_k, W, SW, P, n_blk, n_slice, hd, scale,
                         stream);
  return flash_wide<4>(q, k, v, true_len, row_offset, block_mask, out, win_ml, scores, row_ml,
                       B, Hq, Hkv, S_q, S_k, W, SW, P, n_blk, n_slice, hd, scale, stream);
}
