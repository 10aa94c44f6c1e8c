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
// column) pair, as at the narrower widths: the tensor cores, which only
// wgmma drives at their rate.  What limits the design is that no SM holds a
// q tile's whole row: flash_prefill.cu keeps Q and a ring of whole K/V rows
// in shared memory (192 KB at 512) and O's hd columns in registers, and at
// 1024 O alone (64 rows) is 256 KB, an SM's whole register file.  So O's
// columns are split into column slices of DV = 256, one CTA each; what the
// design must then avoid is every slice recomputing S over all of hd
// ((n_slice + 1) / 2 times one pass's products).
//
// The cluster kernel (flash_cluster_kernel, n_slice <= CLUSTER_MAX = 8,
// the portable cluster size: hd <= 2048) computes S once per (q tile, key
// tile) for all slices:
//  1. One thread-block cluster of n_slice CTAs per (hq, 64-row q tile, b);
//     CTA j owns channels [256 j, 256 j + 256) of Q, K and V and the same
//     columns of O.  Each keeps its Q slice (32 KB) resident; a producer
//     warpgroup keeps two K slots and one V slot (32 KB a 64-key tile slice)
//     in flight, K one tile ahead of V: TMA boxes of 64 x 64 (128-byte
//     swizzle) at hd % 8 == 0, else its 128 threads' cp.async pieces of 8 /
//     4 bytes into the same swizzled layout, arriving with
//     cp.async.mbarrier.arrive.noinc (pieces past hd and rows past the
//     tensor zero-filled through the source size).
//  2. Per key tile the consumer warpgroup computes its partial S_j = Q_j K_j^T
//     (wgmma m64n64k16 over its 16 k-steps, a box past hd skipped), stages
//     it and sends each owner its rows: CTA r owns rows [r rp, r rp + rp),
//     rp = ceil(64 / n_slice), and gets them by one bulk copy
//     (cp.async.bulk shared::cta -> shared::cluster) from every CTA,
//     completing on its mbarrier of the tile's parity.
//  3. An owner warpgroup sums each owned row's n_slice partials in slice
//     order 0, 1, ..., n - 1 (every row's S comes from one sum, so every CTA
//     holds the same bits), masks, runs one online-softmax step (base 2,
//     scale * log2(e) folded in, a masked logit -FLT_MAX weighs exactly 0),
//     writes the row's P (bf16, in the 128-byte-swizzled layout wgmma reads)
//     and (alpha, m, l), and bulk-copies them to every other CTA.
//  4. The consumers rescale O by alpha and run O += P V on their V slice
//     (wgmma m64n256k16, P and V from shared memory, 128 fp32 accumulators
//     a thread); P is rounded to bf16 as every K1 build and the plain
//     version do.
//  The partial S of tile i + 1 is computed and sent before the consumers
//  wait for tile i's P, so one exchange is in flight under the other's
//  products; the exchange buffers alternate by the tile's parity, and each
//  reuse is ordered by the exchange itself (a CTA sends tile i + 2's S only
//  after every owner's P of tile i, which each owner sent after reading its
//  tile-i rows).  setmaxnreg gives the consumers 232 registers, the owners
//  160, the producers 40; 219 KB of shared memory, one CTA an SM.  Slice 0
//  writes the ring hop's (m, l) and the window rows' (m, l), which every
//  CTA holds.  A block mask is read once per 64-key tile: the pattern block
//  P is a multiple of 64 (or one block covers everything), so a q tile and
//  a key tile each lie in one block, and a tile that the q tile's block
//  does not select is skipped by the whole cluster.
//
// Above 2048 (more slices than a portable cluster holds) the wrapper runs
// the slice-recomputing kernel (flash_wide_kernel), whose CTAs share
// nothing: each slice
// CTA accumulates S over all of hd in 64-channel chunks through a 2-buffer
// cp.async ring with mma.sync m16n8k16 and the same instructions in the
// same order (bitwise-equal softmaxes), then O += P V over its slice (71 KB
// of shared memory at every hd).
//
// The window scores (W > 0) come from the window-score pass of
// window_scores.cuh, as at the narrower widths: one CTA per (64 keys, KV
// head, b) recomputes the window logits of all the group's query heads on
// the tensor cores over hd in 64-channel chunks, normalizes them with the
// stored (m, l) and sums over rows in a fixed order.  No atomics anywhere:
// two launches give bitwise-equal outputs.

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "window_scores.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int BM = 64;          // q rows a CTA: 4 warps of 16
constexpr int BN = 64;          // keys a tile
constexpr int DC = 64;          // channels a QK^T chunk
constexpr int DV = 256;         // O columns a CTA: one column slice
// The portable cluster size, equal to ops/kernels/flash_prefill.py::CLUSTER_MAX.
constexpr int CLUSTER_MAX = 8;
constexpr int THREADS = 128;
constexpr int LDC = DC + 8;     // a chunk row in shared memory: 144 bytes
constexpr int LDV = DV + 8;     // a V slice row: 528 bytes
constexpr int CHUNK = BM * LDC; // elements of one Q or K chunk buffer (BN == BM)
constexpr int SMEM_BYTES = (4 * CHUNK + BN * LDV) * 2;  // 70,656
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

// The slice-recomputing kernel (hd above 2048).  CTA (hq, q tile x slice,
// b): 64 q rows, O columns [DV slice, DV slice + DV).  Warp w owns q rows
// 16 w .. 16 w + 15 of the tile; lane (gid, tig) holds rows gid and gid + 8
// of them (the mma's C layout).
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

// --- the cluster kernel (n_slice <= CLUSTER_MAX) ---------------------------------

namespace cl {

constexpr int HALF = 64;                   // columns a TMA box: 128 bytes, the swizzle span
constexpr int BOX = 64 * 128;              // a box: 64 rows (or keys) x 64 columns, 8 KB
constexpr int NBOX = DV / HALF;            // boxes a slice row: 4
constexpr int SLICE_BYTES = NBOX * BOX;    // a Q slice, or a K or V tile's slice: 32 KB
constexpr int CTA_THREADS = 384;  // warpgroups: 0 consumers, 1 producer, 2 owners
constexpr int PRODUCERS = 128;
constexpr int RECV_ROWS = 70;     // n ceil(64 / n) at most (n = 7)
constexpr int MAXH = 3;           // rows a half-warp owns at most: ceil(ceil(64 / 3) / 8)
// Shared memory: Q's slice; two K slots and one V slot (K runs a tile
// ahead of V); then two of each exchange buffer, by the parity of the tile:
// P (64 rows x 128 B, swizzled as a TMA box), this CTA's partial S staged
// for the owners, the partial S rows received from every CTA, and each
// row's (alpha, m, l, 0).
constexpr int SMEM_K = SLICE_BYTES;                              // K slot s at + s SLICE_BYTES
constexpr int SMEM_V = SMEM_K + 2 * SLICE_BYTES;
constexpr int SMEM_P = SMEM_V + SLICE_BYTES;                     // 1024-aligned
constexpr int P_BYTES = BM * 128;
constexpr int SMEM_STAGE = SMEM_P + 2 * P_BYTES;
constexpr int STAGE_BYTES = BM * BN * 4;
constexpr int SMEM_RECV = SMEM_STAGE + 2 * STAGE_BYTES;
constexpr int RECV_BYTES = RECV_ROWS * BN * 4;
constexpr int SMEM_STAT = SMEM_RECV + 2 * RECV_BYTES;
constexpr int STAT_BYTES = BM * 16;
constexpr int SMEM_BAR = SMEM_STAT + 2 * STAT_BYTES;
// q; k_full, k_empty (2 each); v_full, v_empty; s_full, p_full (2 each).
constexpr int NBAR = 11;
constexpr int SMEM_CLUSTER = 1024 + SMEM_BAR + 8 * NBAR;         // 1024: alignment slack
static_assert(SMEM_CLUSTER <= 232448, "a block's shared memory");
static_assert(BM == 64 && BN == 64, "one 128-byte row of P a q row, one box of keys a tile");

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

// Wait until the phase of parity `parity` has completed (CTA scope: TMA
// and cp.async data of this CTA).
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n\t.reg .pred P1;\n\t"
      "LAB_WAIT:\n\t"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n\t"
      "@P1 bra DONE;\n\t"
      "bra LAB_WAIT;\n\t"
      "DONE:\n\t}\n" :: "r"(bar), "r"(parity) : "memory");
}

// The same at cluster scope: data the other CTAs of the cluster stored here.
__device__ __forceinline__ void mbar_wait_cluster(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n\t.reg .pred P1;\n\t"
      "LAB_WAIT:\n\t"
      "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 P1, [%0], %1;\n\t"
      "@P1 bra DONE;\n\t"
      "bra LAB_WAIT;\n\t"
      "DONE:\n\t}\n" :: "r"(bar), "r"(parity) : "memory");
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// The address of this CTA's shared-memory location `addr` in CTA `rank` of
// the cluster.
__device__ __forceinline__ uint32_t mapa(uint32_t addr, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}

// `bytes` (a multiple of 16) from this CTA's shared memory to a CTA of the
// cluster, completing them on its mbarrier `bar`.
__device__ __forceinline__ void bulk_copy(uint32_t dst, uint32_t src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(dst), "r"(src), "r"(bytes), "r"(bar) : "memory");
}

// The consumer warpgroup's own barrier, and the owner warps' (the other
// warps run on).
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, 128;\n" ::: "memory");
}
__device__ __forceinline__ void owner_sync() {
  asm volatile("bar.sync 2, 128;\n" ::: "memory");
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

// Arrive on `bar` once every cp.async this thread issued has landed (the
// arrival is counted in the barrier's expected count).
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" :: "r"(bar) : "memory");
}

// Orders the generic-proxy writes this thread has observed before its
// wgmma reads, which go through the async proxy.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Rows [row0, row0 + 64) x columns [c_lo, c_lo + 64 nbox) of a [nrows, hd]
// plane into the 128-byte-swizzled boxes at `dst` (BOX bytes apart), laid
// out as TMA lays them: 16-byte chunk c of box row r at chunk c ^ (r & 7).
// Producer thread pt takes piece pt % PPR of every (128 / PPR)-th row.
// Pieces at or past hd and rows at or past nrows are zero-filled.
template <int PIECE>
__device__ __forceinline__ void copy_rows(uint32_t dst, const bf16* src, int row0, int nrows,
                                          int hd, int c_lo, int nbox, int pt) {
  constexpr int PC = PIECE / 2;          // bf16 columns a piece
  constexpr int PPR = HALF / PC;         // pieces a box row: 16 or 32
  constexpr int RSTEP = PRODUCERS / PPR; // rows between a thread's pieces: 8 or 4
  const int pc = (pt % PPR) * PC;
  const int r0 = pt / PPR;
  const uint32_t chunk = pc >> 3, in_chunk = (pc & 7) * 2;
  for (int x = 0; x < nbox; ++x) {
    const int col = c_lo + x * HALF + pc;
    const bool col_ok = col < hd;
    const bf16* from = src + (size_t)(row0 + r0) * hd + col;
    uint32_t to = dst + x * BOX + r0 * 128 + in_chunk;
    int left = nrows - row0 - r0;
#pragma unroll 1
    for (int r = r0; r < 64; r += RSTEP) {
      const bool ok = col_ok && left > 0;
      cp_piece<PIECE>(to + (((chunk ^ r) & 7) << 4), ok ? from : src, ok);
      from += (size_t)RSTEP * hd;
      to += RSTEP * 128;
      left -= RSTEP;
    }
  }
}

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

// V as the MN-major B operand: 8-key groups 1024 bytes apart, each next 64
// columns one box further on.
__device__ __forceinline__ uint64_t desc_v(uint32_t addr) { return gmma_desc(addr, BOX, 1024); }

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

#define KVCF_D32                                                                        \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "  \
  "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
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
#define KVCF_F128(d) KVCF_F32(d, 0), KVCF_F32(d, 32), KVCF_F32(d, 64), KVCF_F32(d, 96)

// S[64 x 64] (+)= Q[64 x 16] K[64 x 16]^T, both from shared memory, K-major.
__device__ __forceinline__ void wgmma_qk(float (&d)[32], uint64_t da, uint64_t db,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " KVCF_D32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : KVCF_F32(d, 0)
      : "l"(da), "l"(db), "r"(accumulate));
}

// O[64 x 256] += P[64 x 16] V[16 x 256]: P from shared memory (K-major), V
// from shared memory, MN-major (the transpose flag).
__device__ __forceinline__ void wgmma_pv(float (&d)[128], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 " KVCF_D128
      ", %128, %129, p, 1, 1, 0, 1;\n}\n"
      : KVCF_F128(d)
      : "l"(da), "l"(db), "r"(1));
}

#undef KVCF_D32
#undef KVCF_D128
#undef KVCF_F8
#undef KVCF_F32
#undef KVCF_F128

}  // namespace cl

// Cluster (hq, q tile, b) of n = n_slice CTAs; CTA j (its rank in the
// cluster) owns channels [256 j, 256 j + 256) of Q, K and V, and the same
// columns of O, for 64 q rows.  The rows of S are owned too: CTA r owns
// rows [r rp, r rp + rp) of the tile, rp = ceil(64 / n).  Key tile i:
//   1. every CTA computes its partial S_j = Q_j K_j^T (wgmma m64n64k16),
//      stages it and bulk-copies each owner's rows to the owner (counted on
//      its s barrier of the tile's parity);
//   2. each owner sums its rows' n partials in slice order 0, 1, ..., n-1,
//      masks, runs one online-softmax step, writes P (bf16) and each row's
//      (alpha, m, l) and bulk-copies them to every other CTA (p barrier);
//   3. every CTA rescales O by alpha and runs O += P V on its V slice
//      (wgmma m64n256k16, P and V from shared memory).
// Step 1 of tile i + 1 runs before steps 2-3 of tile i, so its exchange
// is in flight under them; the exchange buffers alternate by parity.
// Every CTA holds the same P and (m, l) bits: each comes from one owner.
// Warpgroup 0 runs steps 1 and 3, warpgroup 2 step 2, so an owner's
// softmax of tile i runs under the products of tiles i - 1 and i + 1;
// warpgroup 1 produces: Q's slice once, then K(0), and K(i + 1) before
// V(i), by TMA (PIECE 16) or its 128 threads' cp.async pieces.  setmaxnreg
// gives the consumers 232 registers, the producers 40 and the owners 160.
template <int PIECE>
__global__ void __launch_bounds__(cl::CTA_THREADS, 1)
flash_cluster_kernel(const __grid_constant__ CUtensorMap tm_q,
                     const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v,
                     const bf16* __restrict__ qg, const bf16* __restrict__ kg,
                     const bf16* __restrict__ vg, const int* __restrict__ true_len,
                     const int* __restrict__ row_offset, const int* __restrict__ block_mask,
                     bf16* __restrict__ out, float* __restrict__ win_ml,
                     float* __restrict__ row_ml, int Hq, int Hkv, int S_q, int S_k, int W,
                     int SW, int P, int n_blk, int hd, int n_slice, float scale_log2) {
  using namespace cl;
  constexpr bool RAGGED = PIECE < 16;
  extern __shared__ unsigned char smem_raw[];
  // 128-byte swizzling repeats every 1024 bytes: align the tiles to that.
  // Every CTA of the kernel has the same layout, so an address here names
  // the same place in every CTA of the cluster.
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const uint32_t sbase = smem_u32(smem);
  const uint32_t bar_q = sbase + SMEM_BAR;
  auto k_full = [&](int s) { return bar_q + 8u * (1 + s); };
  auto k_empty = [&](int s) { return bar_q + 8u * (3 + s); };
  const uint32_t v_full = bar_q + 40, v_empty = bar_q + 48;
  auto s_full = [&](int s) { return bar_q + 8u * (7 + s); };
  auto p_full = [&](int s) { return bar_q + 8u * (9 + s); };

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n = n_slice;
  const int rank = (int)cluster_rank();            // the slice: blockIdx.y % n
  const int hq = blockIdx.x, b = blockIdx.z;
  const int qt = gridDim.y / n - 1 - blockIdx.y / n;  // longest rows first
  const int c_lo = rank * DV;                        // first channel of the slice
  const int ncols = min(DV, hd - c_lo);              // even: hd is
  const int nbox = (ncols + HALF - 1) / HALF;        // boxes holding a channel below hd
  const bool writer = rank == 0;  // writes (m, l) and the window's (m, l)
  const int hkv = hq / (Hq / Hkv);
  const int tl = true_len[b];
  const int lrow0 = qt * BM;
  const int row0 = lrow0 + (row_offset ? row_offset[b] : 0);
  const size_t bh = (size_t)b * Hq + hq;
  bf16* oh = out + bh * S_q * hd;
  const size_t plane = (size_t)gridDim.z * Hq * S_q;
  float* mh = row_ml ? row_ml + bh * S_q : nullptr;

  if (row0 >= tl) {  // no valid row in this q tile (uniform over the cluster)
    for (int i = tid; i < BM * (ncols / 2); i += CTA_THREADS) {
      const int r = lrow0 + i / (ncols / 2);
      if (r < S_q)
        *reinterpret_cast<uint32_t*>(oh + (size_t)r * hd + c_lo + (i % (ncols / 2)) * 2) = 0u;
    }
    if (mh && writer)
      for (int r = lrow0 + tid; r < min(lrow0 + BM, S_q); r += CTA_THREADS) {
        mh[r] = NEG_INF;
        mh[plane + r] = 0.f;
      }
    return;
  }

  // The key tiles from the first holding a column inside the first row's
  // window to the causal frontier (empty only for a ring hop whose window
  // starts past the shard); with a block mask, those the tile's q block
  // selects (the same for every CTA of the cluster).
  const int col_max = min(tl, S_k) - 1;
  const int kv_end = min(min(row0 + BM, tl), S_k);
  const int kt_begin = SW > 0 ? max(row0 - SW + 1, 0) / BN : 0;
  const int kt_end = (kv_end + BN - 1) / BN;
  const int* mb = block_mask ? block_mask + bh * n_blk * n_blk : nullptr;
  const int qblk = mb ? min(lrow0 / P, n_blk - 1) : 0;
  // The first selected key tile at or after kt (kt_end: none).
  auto next_tile = [&](int kt) {
    while (kt < kt_end && mb && !mb[qblk * n_blk + min(kt * BN / P, n_blk - 1)]) ++kt;
    return kt;
  };

  if (tid == 0) {
    mbar_init(bar_q, RAGGED ? PRODUCERS : 1);
    for (int s = 0; s < 2; ++s) {
      mbar_init(k_full(s), RAGGED ? PRODUCERS : 1);
      mbar_init(k_empty(s), 4);  // the consumer warps
      mbar_init(s_full(s), 1);   // the owners' expected bytes
      mbar_init(p_full(s), 2);   // the consumers' expected bytes, the owners' own rows
    }
    mbar_init(v_full, RAGGED ? PRODUCERS : 1);
    mbar_init(v_empty, 4);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // Every CTA's barriers exist before any CTA copies into another.
  cluster_sync();

  const int rp = (BM + n - 1) / n;                 // rows a CTA owns (the last fewer)
  const int rows_mine = min(BM, (rank + 1) * rp) - rank * rp;
  const int own0 = rank * rp;                      // the first of them
  const size_t kv_plane = ((size_t)b * Hkv + hkv) * S_k * hd;
  if (warp >= 4 && warp < 8) {
    // ---- producer warpgroup: Q's slice, K(0), then K(i + 1) before V(i) ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    const int pt = tid - PRODUCERS;
    const int pl = b * Hkv + hkv;
    // Rows [row, row + 64) of one of the three planes into `dst` (all 128
    // threads in the ragged builds, one in the TMA build).
    auto load = [&](uint32_t dst, const CUtensorMap* map, const bf16* src, int row, int nrows,
                    int plane_id, uint32_t bar) {
      if constexpr (RAGGED) {
        copy_rows<PIECE>(dst, src, row, nrows, hd, c_lo, nbox, pt);
        cp_async_arrive(bar);
      } else if (pt == 0) {
        mbar_expect_tx(bar, nbox * BOX);
        for (int x = 0; x < nbox; ++x)
          tma_load(dst + x * BOX, map, bar, c_lo + x * HALF, row, plane_id);
      }
    };
    auto load_k = [&](int i, int kt) {
      mbar_wait(k_empty(i & 1), ((i >> 1) & 1) ^ 1);  // the first pass finds it free
      load(sbase + SMEM_K + (i & 1) * SLICE_BYTES, &tm_k, kg + kv_plane, kt * BN, S_k, pl,
           k_full(i & 1));
    };
    int kt = next_tile(kt_begin);
    if (kt < kt_end) {
      load(sbase, &tm_q, qg + bh * S_q * hd, lrow0, S_q, (int)bh, bar_q);
      load_k(0, kt);
    }
    for (int i = 0; kt < kt_end; ++i) {
      const int kt_next = next_tile(kt + 1);
      if (kt_next < kt_end) load_k(i + 1, kt_next);
      mbar_wait(v_empty, (i & 1) ^ 1);
      load(sbase + SMEM_V, &tm_v, vg + kv_plane, kt * BN, S_k, pl, v_full);
      kt = kt_next;
    }
    if constexpr (RAGGED) asm volatile("cp.async.wait_all;\n" ::: "memory");
  } else if (warp >= 8) {
    // ---- owner warpgroup: step 2 of every tile, a tile ahead of the
    // consumers' PV where the exchange allows.  Half-warp hw takes the
    // owned rows hw, hw + 8, ..., lane l the columns 4 (l % 16) .. + 3; the
    // rows' running state (base 2; l the full sum). ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 160;\n" ::: "memory");
    const int hw = (warp - 8) * 2 + (lane >> 4), l16 = lane & 15;
    const bool lead = tid == 256;  // posts the expected bytes, issues the copies
    float m_own[MAXH], l_own[MAXH];
#pragma unroll
    for (int j = 0; j < MAXH; ++j) { m_own[j] = NEG_INF; l_own[j] = 0.f; }
    int kt = next_tile(kt_begin);
    for (int i = 0; kt < kt_end; ++i) {
      const int par = i & 1, key0 = kt * BN;
      const uint32_t pbuf = sbase + SMEM_P + par * P_BYTES;
      const uint32_t stat_a = sbase + SMEM_STAT + par * STAT_BYTES;
      const float4* recv_f = reinterpret_cast<const float4*>(smem + SMEM_RECV + par * RECV_BYTES);
      if (lead) mbar_expect_tx(s_full(par), (uint32_t)(n * rows_mine * BN * 4));
      mbar_wait_cluster(s_full(par), (i >> 1) & 1);
#pragma unroll
      for (int j = 0; j < MAXH; ++j) {
        // The warp's two rows hw (even) and hw + 1, the second past the
        // owned rows when rows_mine is odd: its half-warp runs the steps on
        // the first row's data (the shuffles need every lane) and keeps
        // nothing.
        const int lr_even = (hw & ~1) + 8 * j;
        if (lr_even >= rows_mine) break;  // uniform in a warp
        const bool live = hw + 8 * j < rows_mine;
        const int lr = live ? hw + 8 * j : lr_even;
        const int R = own0 + lr;
        const int k = l16 ^ ((R & 3) << 1);  // the chunk's place in the staged row
        float4 a = recv_f[lr * (BN / 4) + k];
        for (int r = 1; r < n; ++r) {  // the partials in slice order
          const float4 x = recv_f[(r * rp + lr) * (BN / 4) + k];
          a.x += x.x; a.y += x.y; a.z += x.z; a.w += x.w;
        }
        const int rg = row0 + R;  // global id
        const int lim = min(rg, col_max), wlo = SW > 0 ? rg - SW : -1;
        const int c = key0 + 4 * l16;
        float x[4] = {a.x, a.y, a.z, a.w};
        float mx = NEG_INF;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          x[e] = c + e <= lim && c + e > wlo ? x[e] * scale_log2 : NEG_INF;
          mx = fmaxf(mx, x[e]);
        }
#pragma unroll
        for (int off = 8; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        const float mn = fmaxf(m_own[j], mx);
        // A row with no visible column so far keeps m = -FLT_MAX and weighs 0.
        const float alpha = mn == NEG_INF ? 1.f : exp2f(m_own[j] - mn);
        float ps = 0.f;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          x[e] = x[e] == NEG_INF ? 0.f : exp2f(x[e] - mn);
          ps += x[e];
        }
#pragma unroll
        for (int off = 8; off > 0; off >>= 1) ps += __shfl_xor_sync(0xffffffffu, ps, off);
        if (!live) continue;
        l_own[j] = l_own[j] * alpha + ps;
        m_own[j] = mn;
        // Row R of P, columns 4 l .. 4 l + 3: half of chunk l / 2, at its
        // swizzled place.
        const uint32_t pat =
            pbuf + R * 128 + ((((uint32_t)l16 >> 1) ^ (R & 7)) << 4) + (l16 & 1) * 8;
        asm volatile("st.shared.v2.b32 [%0], {%1, %2};\n" :: "r"(pat), "r"(pack_bf16(x[0], x[1])),
                     "r"(pack_bf16(x[2], x[3])) : "memory");
        if (l16 == 0)
          asm volatile("st.shared.v4.f32 [%0], {%1, %2, %3, %4};\n" :: "r"(stat_a + R * 16),
                       "f"(alpha), "f"(mn), "f"(l_own[j]), "f"(0.f) : "memory");
      }
      fence_proxy_async();  // wgmma and the bulk copies read P through the async proxy
      owner_sync();
      if (lead) {
        for (int d = 0; d < n; ++d) {
          if (d == rank) continue;
          bulk_copy(mapa(pbuf + own0 * 128, d), pbuf + own0 * 128, rows_mine * 128,
                    mapa(p_full(par), d));
          bulk_copy(mapa(stat_a + own0 * 16, d), stat_a + own0 * 16, rows_mine * 16,
                    mapa(p_full(par), d));
        }
        mbar_arrive(p_full(par));  // this CTA's own rows are in
      }
      kt = next_tile(kt + 1);
    }
  } else {
    // ---- consumer warpgroup: 64 q rows; lane (g, t) of warp w holds rows
    // 16 w + g and 16 w + g + 8 of the accumulators ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int g = lane >> 2, t = lane & 3;
    const int ra = warp * 16 + g;                    // this thread's first tile row
    // This thread's partial S rows in the staging rows: 16-byte chunk k of
    // row R at k ^ 2 (R & 3), so that a warp's stores meet no bank twice.
    const uint32_t st_lo = sbase + SMEM_STAGE + ra * BN * 4 + (t & 1) * 8;
    const uint32_t st_hi = st_lo + 8 * BN * 4;
    const int swz = (ra & 3) << 1, kt_t = t >> 1;
    // This thread's rows' (m, l), as their owners sent them last.
    float m_lo = NEG_INF, m_hi = NEG_INF, l_lo = 0.f, l_hi = 0.f;
    float o[DV / 2];
#pragma unroll
    for (int i = 0; i < DV / 2; ++i) o[i] = 0.f;

    // Step 1 of tile i (key tile kt): the partial S, staged, each owner's
    // rows copied to it.  Thread 0 also posts the bytes the tile's p
    // barrier expects from the other CTAs.
    auto partial_s = [&](int i, int kt) {
      const int par = i & 1;
      float sc[BN / 2];
      const uint32_t kd = sbase + SMEM_K + par * SLICE_BYTES;
      mbar_wait(k_full(par), (i >> 1) & 1);
      if constexpr (RAGGED) fence_proxy_async();
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DV / 16; ++kk) {
        if ((kk >> 2) >= nbox) break;            // a box past hd (uniform)
        const uint32_t in_row = (kk & 3) * 32;   // k-step kk: box kk / 4, 32 bytes each
        wgmma_qk(sc, desc_kmajor(sbase + (kk >> 2) * BOX + in_row),
                 desc_kmajor(kd + (kk >> 2) * BOX + in_row), kk);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_acc(sc);
      __syncwarp();
      if (lane == 0) mbar_arrive(k_empty(par));
      // sc[4 c + e]: row lo (e < 2) or hi, column 8 c + 2 t + (e & 1): chunk 2 c + t / 2.
      const uint32_t sto = par * STAGE_BYTES;
#pragma unroll
      for (int c = 0; c < BN / 8; ++c) {
        const uint32_t at = sto + (uint32_t)(((2 * c + kt_t) ^ swz) << 4);
        asm volatile("st.shared.v2.f32 [%0], {%1, %2};\n" :: "r"(st_lo + at), "f"(sc[4 * c]),
                     "f"(sc[4 * c + 1]) : "memory");
        asm volatile("st.shared.v2.f32 [%0], {%1, %2};\n" :: "r"(st_hi + at), "f"(sc[4 * c + 2]),
                     "f"(sc[4 * c + 3]) : "memory");
      }
      fence_proxy_async();  // the bulk copies read the staged rows through the async proxy
      consumer_sync();
      if (tid == 0) {
        mbar_expect_tx(p_full(par), (uint32_t)((BM - rows_mine) * (128 + 16)));
        const uint32_t recv = sbase + SMEM_RECV + par * RECV_BYTES + rank * rp * BN * 4;
        const uint32_t stage = sbase + SMEM_STAGE + sto;
        for (int d = 0; d < n; ++d) {
          const int r0 = d * rp, rows = min(BM, r0 + rp) - r0;
          bulk_copy(mapa(recv, d), stage + r0 * BN * 4, rows * BN * 4, mapa(s_full(par), d));
        }
      }
    };

    int kt = next_tile(kt_begin);
    if (kt < kt_end) {
      mbar_wait(bar_q, 0);
      if constexpr (RAGGED) fence_proxy_async();
      partial_s(0, kt);
    }
    for (int i = 0; kt < kt_end; ++i) {
      const int par = i & 1;
      const int kt_next = next_tile(kt + 1);
      if (kt_next < kt_end) partial_s(i + 1, kt_next);  // its exchange runs under this tile's

      // 3. O = alpha O + P V over this slice's columns, once the owners' P
      // of tile i is in (this CTA's and every other's).
      mbar_wait_cluster(p_full(par), (i >> 1) & 1);
      const float4* stat = reinterpret_cast<const float4*>(smem + SMEM_STAT + par * STAT_BYTES);
      const float4 st_lo4 = stat[ra], st_hi4 = stat[ra + 8];
      m_lo = st_lo4.y; l_lo = st_lo4.z;
      m_hi = st_hi4.y; l_hi = st_hi4.z;
#pragma unroll
      for (int j = 0; j < DV / 2; ++j) o[j] *= (j & 3) < 2 ? st_lo4.x : st_hi4.x;
      mbar_wait(v_full, i & 1);
      if constexpr (RAGGED) fence_proxy_async();
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)
        wgmma_pv(o, desc_kmajor(sbase + SMEM_P + par * P_BYTES + kk * 32),
                 desc_v(sbase + SMEM_V + kk * 16 * 128));
      wgmma_commit();
      wgmma_wait_all();
      fence_acc(o);
      __syncwarp();
      if (lane == 0) mbar_arrive(v_empty);
      kt = kt_next;
    }

    // Natural-log units leave the kernel; an empty row keeps -FLT_MAX exactly.
    const float mn_lo = m_lo == NEG_INF ? NEG_INF : m_lo * LN2;
    const float mn_hi = m_hi == NEG_INF ? NEG_INF : m_hi * LN2;
    const int o_lo = lrow0 + ra, o_hi = o_lo + 8;  // local rows
    if (mh && writer && t == 0) {
      if (o_lo < S_q) { mh[o_lo] = mn_lo; mh[plane + o_lo] = l_lo; }
      if (o_hi < S_q) { mh[o_hi] = mn_hi; mh[plane + o_hi] = l_hi; }
    }
    const float il_lo = 1.f / (l_lo == 0.f ? 1.f : l_lo);
    const float il_hi = 1.f / (l_hi == 0.f ? 1.f : l_hi);
#pragma unroll
    for (int c = 0; c < DV / 8; ++c) {
      const int col = c * 8 + 2 * t;  // hd is even: a pair is in or out
      if (col >= ncols) continue;
      if (o_lo < S_q)
        *reinterpret_cast<uint32_t*>(oh + (size_t)o_lo * hd + c_lo + col) =
            pack_bf16(o[4 * c] * il_lo, o[4 * c + 1] * il_lo);
      if (o_hi < S_q)
        *reinterpret_cast<uint32_t*>(oh + (size_t)o_hi * hd + c_lo + col) =
            pack_bf16(o[4 * c + 2] * il_hi, o[4 * c + 3] * il_hi);
    }
    // W > 0 only for whole-sequence queries (no offset): r == global id.
    if (W > 0 && writer && t == 0) {  // final (m, l) of the observation-window rows
      const int ws = tl - W, r_lo = row0 + ra, r_hi = r_lo + 8;
      float* ml = win_ml + bh * W * 2;
      if (r_lo >= ws && r_lo < tl) { ml[(r_lo - ws) * 2] = mn_lo; ml[(r_lo - ws) * 2 + 1] = l_lo; }
      if (r_hi >= ws && r_hi < tl) { ml[(r_hi - ws) * 2] = mn_hi; ml[(r_hi - ws) * 2 + 1] = l_hi; }
    }
  }
  // No CTA leaves while another of its cluster may still address it.
  cluster_sync();
}

// The wrapper's contract, as flash_prefill.cu's: scores only for
// whole-sequence queries without a window; q and k lengths differ only in
// chunk mode; a block mask only for whole-sequence queries, with n_blk
// blocks of P rows covering S_q and P a multiple of 64 unless one block
// covers everything; (m, l) only without scores or a block mask.
bool contract_ok(const void* row_offset, const void* block_mask, const void* row_ml, int Hq,
                 int Hkv, int S_q, int S_k, int W, int SW, int P, int n_blk, int n_slice) {
  if (W < 0 || SW < 0 || (W > 0 && (SW > 0 || row_offset)) ||
      (!row_offset && S_q != S_k) || S_q < 1 || S_k < 1 || Hkv < 1 || Hq % Hkv != 0 ||
      (row_ml && (W > 0 || block_mask)))
    return false;
  if (block_mask && (row_offset || P < 1 || n_blk != (S_q + P - 1) / P ||
                     (n_blk > 1 && P % BN != 0)))
    return false;
  return (long long)((S_q + BM - 1) / BM) * n_slice <= 65535;
}

// Once per (kernel, device): the dynamic shared memory above 48 KB (so that
// a launch under CUDA-graph capture makes no such call).
template <typename Kernel>
int allow_smem(Kernel kernel, int bytes, bool (&set)[64]) {
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  if (!set[dev]) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           bytes);
    if (err != cudaSuccess) return (int)err;
    set[dev] = true;
  }
  return 0;
}

// The host function of the slice-recomputing kernel (any n_slice), for
// rows copied in PIECE-byte pieces (hd a whole number of them).
template <int PIECE>
int flash_wide(const void* q, const void* k, const void* v, const void* true_len,
               const void* row_offset, const void* block_mask, void* out, void* win_ml,
               void* scores, void* row_ml, int B, int Hq, int Hkv, int S_q, int S_k, int W,
               int SW, int P, int n_blk, int n_slice, int hd, float scale, void* stream) {
  if (!contract_ok(row_offset, block_mask, row_ml, Hq, Hkv, S_q, S_k, W, SW, P, n_blk, n_slice))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  static bool smem_set[64] = {false};
  if (int err = allow_smem(flash_wide_kernel<PIECE>, SMEM_BYTES, smem_set)) return err;
  dim3 grid(Hq, (S_q + BM - 1) / BM * n_slice, B);
  flash_wide_kernel<PIECE><<<grid, THREADS, SMEM_BYTES, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const int*>(true_len), static_cast<const int*>(row_offset),
      static_cast<const int*>(block_mask), static_cast<bf16*>(out),
      static_cast<float*>(win_ml), static_cast<float*>(row_ml), Hq, Hkv, S_q, S_k, W, SW, P,
      n_blk, hd, n_slice, scale * LOG2E);
  if (W > 0 && cudaPeekAtLastError() == cudaSuccess)  // the window-score pass
    return ws::window_scores<PIECE>(q, k, true_len, block_mask, win_ml, scores, B, Hq, Hkv,
                                    S_k, W, P, n_blk, hd, scale, st);
  return (int)cudaGetLastError();
}

// The host function of the cluster kernel (n_slice <= CLUSTER_MAX): one
// cluster of n_slice CTAs per (hq, q tile, b), launched with a cluster
// dimension.
template <int PIECE>
int flash_cluster(const void* q, const void* k, const void* v, const void* true_len,
                  const void* row_offset, const void* block_mask, void* out, void* win_ml,
                  void* scores, void* row_ml, int B, int Hq, int Hkv, int S_q, int S_k, int W,
                  int SW, int P, int n_blk, int n_slice, int hd, float scale, void* stream) {
  if (n_slice < 3 || n_slice > CLUSTER_MAX ||
      !contract_ok(row_offset, block_mask, row_ml, Hq, Hkv, S_q, S_k, W, SW, P, n_blk, n_slice))
    return (int)cudaErrorInvalidValue;
  CUtensorMap tq{}, tk{}, tv{};  // 8- and 4-byte pieces copy by cp.async: no maps
  if constexpr (PIECE == 16) {
    ws::EncodeTiled enc = ws::encode_tiled();
    if (!enc) return (int)cudaErrorNotSupported;
    if (!ws::make_map(enc, &tq, q, hd, S_q, B * Hq, 64) ||
        !ws::make_map(enc, &tk, k, hd, S_k, B * Hkv, 64) ||
        !ws::make_map(enc, &tv, v, hd, S_k, B * Hkv, 64))
      return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  static bool smem_set[64] = {false};
  if (int err = allow_smem(flash_cluster_kernel<PIECE>, cl::SMEM_CLUSTER, smem_set)) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(Hq, (S_q + BM - 1) / BM * n_slice, B);
  cfg.blockDim = dim3(cl::CTA_THREADS);
  cfg.dynamicSmemBytes = cl::SMEM_CLUSTER;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = n_slice;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(
      &cfg, flash_cluster_kernel<PIECE>, tq, tk, tv, static_cast<const bf16*>(q),
      static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const int*>(true_len), static_cast<const int*>(row_offset),
      static_cast<const int*>(block_mask), static_cast<bf16*>(out),
      static_cast<float*>(win_ml), static_cast<float*>(row_ml), Hq, Hkv, S_q, S_k, W, SW, P,
      n_blk, hd, n_slice, scale * LOG2E);
  if (err != cudaSuccess) return (int)err;
  if (W > 0 && cudaPeekAtLastError() == cudaSuccess)  // the window-score pass
    return ws::window_scores<PIECE>(q, k, true_len, block_mask, win_ml, scores, B, Hq, Hkv,
                                    S_k, W, P, n_blk, hd, scale, st);
  return (int)cudaGetLastError();
}

}  // namespace

// Any even head_dim hd, in n_slice = ceil(hd / 256) column slices (the
// wrapper passes both, and the true 1/sqrt(hd)); rows are copied in the
// widest pieces hd is a whole number of, and q, k and v must be aligned to
// them.  kvcf_flash_prefill_cluster takes n_slice <= CLUSTER_MAX (hd <=
// 2048), kvcf_flash_prefill_wide any n_slice (the wrapper runs it above).
#define KVCF_FLASH_WIDE_ENTRY(NAME, FN)                                                    \
  extern "C" int NAME(const void* q, const void* k, const void* v, const void* true_len,   \
                      const void* row_offset, const void* block_mask, void* out,           \
                      void* win_ml, void* scores, void* row_ml, int B, int Hq, int Hkv,    \
                      int S_q, int S_k, int W, int SW, int P, int n_blk, int n_slice,      \
                      int hd, float scale, void* stream) {                                 \
    if (hd < 2 || hd % 2 != 0 || n_slice != (hd + DV - 1) / DV)                            \
      return (int)cudaErrorInvalidValue;                                                   \
    if (hd % 8 == 0)                                                                       \
      return FN<16>(q, k, v, true_len, row_offset, block_mask, out, win_ml, scores,        \
                    row_ml, B, Hq, Hkv, S_q, S_k, W, SW, P, n_blk, n_slice, hd, scale,     \
                    stream);                                                               \
    if (hd % 4 == 0)                                                                       \
      return FN<8>(q, k, v, true_len, row_offset, block_mask, out, win_ml, scores, row_ml, \
                   B, Hq, Hkv, S_q, S_k, W, SW, P, n_blk, n_slice, hd, scale, stream);     \
    return FN<4>(q, k, v, true_len, row_offset, block_mask, out, win_ml, scores, row_ml,   \
                 B, Hq, Hkv, S_q, S_k, W, SW, P, n_blk, n_slice, hd, scale, stream);       \
  }
KVCF_FLASH_WIDE_ENTRY(kvcf_flash_prefill_cluster, flash_cluster)
KVCF_FLASH_WIDE_ENTRY(kvcf_flash_prefill_wide, flash_wide)

// The cluster kernel's dynamic shared memory (info[0], bytes) and how many
// clusters of n_slice CTAs the device holds at once (info[1],
// cudaOccupancyMaxActiveClusters), for the 16-byte build.
extern "C" int kvcf_flash_prefill_cluster_info(int n_slice, int* info) {
  if (n_slice < 3 || n_slice > CLUSTER_MAX) return (int)cudaErrorInvalidValue;
  static bool smem_set[64] = {false};
  if (int err = allow_smem(flash_cluster_kernel<16>, cl::SMEM_CLUSTER, smem_set)) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(1, n_slice, 1);
  cfg.blockDim = dim3(cl::CTA_THREADS);
  cfg.dynamicSmemBytes = cl::SMEM_CLUSTER;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = n_slice;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  info[0] = cl::SMEM_CLUSTER;
  return (int)cudaOccupancyMaxActiveClusters(&info[1], flash_cluster_kernel<16>, &cfg);
}
