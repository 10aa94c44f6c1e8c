// K1: causal GQA flash prefill attention plus SnapKV window-score emission,
// for Hopper (sm_90a), bf16 in, fp32 accumulation, with the sliding-window,
// chunk (row_offset) and MInference block-sparse (a-shape, vertical-slash)
// variants.
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
//              c <= min(R, tl-1) and, with a sliding window SW, c > R - SW
//   scores[c]= sum over window rows r in [tl-W, tl), c <= r, of the final
//              normalized probability exp(s_rc - m_r) / l_r
// With a block mask M [B, Hq, n_blk, n_blk] of pattern block P, row r also
// needs M[b, hq, r / P, c / P] != 0 for column c, and the scores sum that
// sparse softmax.  Scores need whole-sequence queries without a sliding
// window, so W > 0 excludes SW and chunk mode; a block mask excludes chunk
// mode (the wrapper and the host function check).
// With an (m, l) output (the ring-attention hop, K1-ml) each row also writes
// its final online-softmax max m and sum l over the columns it saw in this
// call, fp32 [B, Hq, S_q] each; a row that saw none writes m = -FLT_MAX,
// l = 0 and a zero output, so the hop combine weighs it to nothing (the TPU
// kernel leaves l at the folded column count there; both fold to zero).
// A hop's keys are one shard (true_len may exceed S_k, so columns are also
// capped at S_k - 1), and its offset rows can sit so far past the shard that
// a tile's window starts beyond the last key: the key loop is then empty.
// The softmax is online and in fp32; probabilities are rounded to bf16
// before the PV product, as the TPU kernel does.  Rows at or past true_len
// in a tile that holds no valid row are written as zeros: every later mask
// excludes those rows, and zeros keep them finite (an inert chunk-pool row,
// true_len 0, comes out all zeros).
//
// What bounds it: at S=4096 the causal QK and PV products are ~137 GFLOP
// per layer and example against ~50 MB of q/k/v/out, so it is bound by the
// tensor cores (0.139 ms per layer at 989 TFLOP/s of dense bf16).  With a
// window the work is O(S * SW): key tiles wholly below every row's window
// are skipped, so an 8192-token prefill at SW 4096 does 0.75 of the dense
// causal work.  A ring hop does the visible pairs of one K/V shard (at sp 2
// over 32000 tokens: 134, 122 and 256 M pairs per head for the three hops,
// together the dense causal work) under the same bound; its (m, l) planes
// add 8 bytes per row.
//
// Design: one CTA (4 warps) per (q-tile of 64 rows, hq, b).  Each warp owns
// 16 query rows, holds their Q fragments in registers, and walks 64-key K/V
// tiles in shared memory from the window's first tile up to the causal
// frontier with mma.sync m16n8k16 bf16 products; the S accumulator fragment
// is re-used directly as the A operand of the PV product, so probabilities
// never touch shared memory.  In chunk mode q holds S_q rows of a longer
// sequence whose keys fill the S_k-row K/V buffer: the tile bounds come from
// the global ids and K/V loads are clamped to S_k.  A row whose first tiles
// hold no visible column folds them with m = -FLT_MAX; its first visible
// column rescales that garbage by exp(-FLT_MAX - m) = 0.
//
// The window scores cannot accumulate across q-tiles as the TPU's
// sequential grid lets them (q-tiles run concurrently here, and float
// atomics would make the sums depend on the run).  Instead the main kernel
// stores each window row's final (m, l) in a [B, Hq, W, 2] buffer and a
// second small kernel, one CTA per (64-column tile, hq, b), recomputes the
// W x 64 window logits, normalizes them with the stored (m, l) and sums
// over rows: about W/S of the main work, deterministic.
//
// Sparse patterns: P is a multiple of the 64-row tile (or the whole
// sequence, n_blk 1), so a CTA's 64 q rows lie in one pattern q block and
// each 64-key tile in one pattern k block: the key loop reads the CTA's
// mask row once and skips an unselected tile before any load, uniformly
// over the CTA.  The work is then the tensor-core products of the visible
// pairs inside the selected blocks (an a-shape (1, 2, 8) over 32 blocks keeps
// 135 of the 528 causal block pairs), still bound by the tensor cores; the
// skipped tiles cost one mask read each.  The window-score pass reads, per
// window row, whether that row's own q block selects the pass's column
// block: the window rows can straddle two q blocks.  No atomics: the
// outputs do not depend on the run.
//
// A simple kernel first: no TMA, no wgmma, no software pipelining, no
// compacted list of selected tiles (a q block walks every tile up to its
// causal frontier and skips the unselected ones).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int D = 128;        // head_dim (the wrapper checks)
constexpr int BM = 64;        // query rows per CTA
constexpr int BN = 64;        // keys per K/V tile
constexpr int LDS = D + 8;    // padded shared-memory row stride (elements)
constexpr int WMAX = 64;      // largest observation window
constexpr float NEG_INF = -3.4028234663852886e38f;  // float32 finfo.min

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_raw(bf16 lo, bf16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) |
         ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

// D[16x8] += A[16x16] (row) * B[16x8] (col), bf16 in, fp32 accumulate.
__device__ __forceinline__ void mma16816(float c[4], const uint32_t a[4],
                                         const uint32_t b0, const uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Copy rows [row0, row0 + 64) of a [*, D] bf16 matrix into shared memory,
// zero-filling rows at or past `limit`.  16-byte loads, neighbouring threads
// on neighbouring addresses.
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, int row0,
                                          int limit, int tid) {
#pragma unroll
  for (int i = tid; i < 64 * (D / 8); i += 128) {
    const int r = i / (D / 8), c = i % (D / 8);
    uint4 val = make_uint4(0, 0, 0, 0);
    if (row0 + r < limit)
      val = *reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * D + c * 8);
    *reinterpret_cast<uint4*>(dst + r * LDS + c * 8) = val;
  }
}

__global__ void __launch_bounds__(128)
flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const int* __restrict__ true_len,
                 const int* __restrict__ row_offset,
                 const int* __restrict__ block_mask, bf16* __restrict__ out,
                 float* __restrict__ win_ml, float* __restrict__ row_ml, int Hq,
                 int Hkv, int S_q, int S_k, int W, int SW, int P, int n_blk,
                 float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* Ks = Qs + BM * LDS;
  bf16* Vs = Ks + BN * LDS;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int hq = blockIdx.y, b = blockIdx.z;
  const int hkv = hq / (Hq / Hkv);
  const int tl = true_len[b];
  const int lrow0 = blockIdx.x * BM;                        // first local q row
  const int row0 = lrow0 + (row_offset ? row_offset[b] : 0);  // its global id

  const size_t qoff = ((size_t)b * Hq + hq) * S_q * D;
  const bf16* kh = k + ((size_t)b * Hkv + hkv) * S_k * D;
  const bf16* vh = v + ((size_t)b * Hkv + hkv) * S_k * D;
  bf16* oh = out + qoff;

  const int ra = warp * 16 + g;            // this thread's first tile row
  const int o_lo = lrow0 + ra, o_hi = o_lo + 8;  // local rows (output)
  const int r_lo = row0 + ra, r_hi = r_lo + 8;   // global ids (masks)

  // (m, l) planes of this (b, hq): m at [0, S_q), l one plane further on.
  const size_t plane = (size_t)gridDim.z * Hq * S_q;
  float* mh = row_ml ? row_ml + ((size_t)b * Hq + hq) * S_q : nullptr;

  if (row0 >= tl) {  // no valid row in this tile (uniform over the CTA)
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      if (o_lo < S_q) *reinterpret_cast<uint32_t*>(oh + (size_t)o_lo * D + dt * 8 + t * 2) = 0u;
      if (o_hi < S_q) *reinterpret_cast<uint32_t*>(oh + (size_t)o_hi * D + dt * 8 + t * 2) = 0u;
    }
    if (mh && t == 0) {
      if (o_lo < S_q) { mh[o_lo] = NEG_INF; mh[plane + o_lo] = 0.f; }
      if (o_hi < S_q) { mh[o_hi] = NEG_INF; mh[plane + o_hi] = 0.f; }
    }
    return;
  }

  load_tile(Qs, q + qoff, lrow0, S_q, tid);
  __syncthreads();

  uint32_t qf[D / 16][4];
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    const bf16* p = Qs + ra * LDS + ks * 16 + t * 2;
    qf[ks][0] = ld32(p);
    qf[ks][1] = ld32(p + 8 * LDS);
    qf[ks][2] = ld32(p + 8);
    qf[ks][3] = ld32(p + 8 * LDS + 8);
  }

  // col > row OR col >= true_len OR col >= S_k collapses to col > min(row,
  // tl - 1, S_k - 1); the window hides col <= row - SW (no window: col <= -1,
  // nothing).  Only a ring hop has tl > S_k.
  const int col_max = min(tl, S_k) - 1;
  const int lim_lo = min(r_lo, col_max), lim_hi = min(r_hi, col_max);
  const int wlo_lo = SW > 0 ? r_lo - SW : -1, wlo_hi = SW > 0 ? r_hi - SW : -1;
  float m_lo = NEG_INF, m_hi = NEG_INF, l_lo = 0.f, l_hi = 0.f;
  float o[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) o[dt][0] = o[dt][1] = o[dt][2] = o[dt][3] = 0.f;

  // Causal frontier of this tile, and the first key tile that holds a
  // column inside any of its rows' windows.  The range is empty only for a
  // ring hop whose window starts past the shard (kv_begin >= S_k): the loop
  // then runs no iteration and the rows keep m = -FLT_MAX, l = 0.
  const int kv_end = min(min(row0 + BM, tl), S_k);
  const int kv_begin = SW > 0 ? max(row0 - SW + 1, 0) / BN * BN : 0;
  // This CTA's row of the block mask (whole-sequence queries: row0 is local).
  const int* mrow = block_mask ?
      block_mask + (((size_t)b * Hq + hq) * n_blk + row0 / P) * n_blk : nullptr;
  for (int c0 = kv_begin; c0 < kv_end; c0 += BN) {
    if (mrow && !mrow[c0 / P]) continue;  // unselected block: no load, no product
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile(Ks, kh, c0, S_k, tid);
    load_tile(Vs, vh, c0, S_k, tid);
    __syncthreads();

    float s[BN / 8][4];
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks) {
        const bf16* kp = Ks + (nt * 8 + g) * LDS + ks * 16 + t * 2;
        mma16816(s[nt], qf[ks], ld32(kp), ld32(kp + 8));
      }
    }

    float mx_lo = NEG_INF, mx_hi = NEG_INF;
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = c0 + nt * 8 + t * 2 + (e & 1);
        float val = s[nt][e] * scale;
        if (col > (e < 2 ? lim_lo : lim_hi) || col <= (e < 2 ? wlo_lo : wlo_hi))
          val = NEG_INF;
        s[nt][e] = val;
        if (e < 2) mx_lo = fmaxf(mx_lo, val); else mx_hi = fmaxf(mx_hi, val);
      }
    }
    // A row's 64 columns live in the 4 threads of one quad.
    mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, 1));
    mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, 2));
    mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, 1));
    mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, 2));
    const float mn_lo = fmaxf(m_lo, mx_lo), mn_hi = fmaxf(m_hi, mx_hi);

    float sum_lo = 0.f, sum_hi = 0.f;
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(s[nt][e] - (e < 2 ? mn_lo : mn_hi));
        s[nt][e] = p;
        if (e < 2) sum_lo += p; else sum_hi += p;
      }
    }
    sum_lo += __shfl_xor_sync(0xffffffffu, sum_lo, 1);
    sum_lo += __shfl_xor_sync(0xffffffffu, sum_lo, 2);
    sum_hi += __shfl_xor_sync(0xffffffffu, sum_hi, 1);
    sum_hi += __shfl_xor_sync(0xffffffffu, sum_hi, 2);
    const float a_lo = expf(m_lo - mn_lo), a_hi = expf(m_hi - mn_hi);
    l_lo = l_lo * a_lo + sum_lo;
    l_hi = l_hi * a_hi + sum_hi;
    m_lo = mn_lo;
    m_hi = mn_hi;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      o[dt][0] *= a_lo; o[dt][1] *= a_lo;
      o[dt][2] *= a_hi; o[dt][3] *= a_hi;
    }

    // O += P V.  The C fragments of two neighbouring 8-key tiles form the
    // A fragment of one 16-key k-step.
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      const uint32_t a[4] = {pack_f32(s[2 * kk][0], s[2 * kk][1]),
                             pack_f32(s[2 * kk][2], s[2 * kk][3]),
                             pack_f32(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             pack_f32(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt) {
        const bf16* vp = Vs + (kk * 16 + t * 2) * LDS + dt * 8 + g;
        mma16816(o[dt], a, pack_raw(vp[0], vp[LDS]),
                 pack_raw(vp[8 * LDS], vp[9 * LDS]));
      }
    }
  }

  if (mh) {
    // A row that saw no column folded only masked logits (each exp(0) = 1
    // against m = -FLT_MAX): report it as empty, with a zero output.
    if (m_lo == NEG_INF) {
      l_lo = 0.f;
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt) o[dt][0] = o[dt][1] = 0.f;
    }
    if (m_hi == NEG_INF) {
      l_hi = 0.f;
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt) o[dt][2] = o[dt][3] = 0.f;
    }
    if (t == 0) {
      if (o_lo < S_q) { mh[o_lo] = m_lo; mh[plane + o_lo] = l_lo; }
      if (o_hi < S_q) { mh[o_hi] = m_hi; mh[plane + o_hi] = l_hi; }
    }
  }
  const float dl_lo = (l_lo == 0.f) ? 1.f : l_lo;
  const float dl_hi = (l_hi == 0.f) ? 1.f : l_hi;
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    if (o_lo < S_q)
      *reinterpret_cast<uint32_t*>(oh + (size_t)o_lo * D + dt * 8 + t * 2) =
          pack_f32(o[dt][0] / dl_lo, o[dt][1] / dl_lo);
    if (o_hi < S_q)
      *reinterpret_cast<uint32_t*>(oh + (size_t)o_hi * D + dt * 8 + t * 2) =
          pack_f32(o[dt][2] / dl_hi, o[dt][3] / dl_hi);
  }

  // W > 0 only for whole-sequence queries (no offset): r == global id.
  if (W > 0 && t == 0) {  // final (m, l) of the observation-window rows
    const int ws = tl - W;
    float* ml = win_ml + ((size_t)b * Hq + hq) * W * 2;
    if (r_lo >= ws && r_lo < tl) { ml[(r_lo - ws) * 2] = m_lo; ml[(r_lo - ws) * 2 + 1] = l_lo; }
    if (r_hi >= ws && r_hi < tl) { ml[(r_hi - ws) * 2] = m_hi; ml[(r_hi - ws) * 2 + 1] = l_hi; }
  }
}

// One CTA per (64-column tile, hq, b): scores[c] = sum over window rows r
// with c <= r (and, with a block mask, whose q block selects c's block) of
// exp(q[r].k[c] * scale - m_r) / l_r.
__global__ void __launch_bounds__(128)
window_scores_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const int* __restrict__ true_len,
                     const int* __restrict__ block_mask,
                     const float* __restrict__ win_ml,
                     float* __restrict__ scores,
                     int Hq, int Hkv, int S, int W, int P, int n_blk, float scale) {
  __shared__ __align__(16) bf16 Ks[BN * LDS];
  __shared__ __align__(16) bf16 Qw[WMAX * D];
  __shared__ float m_w[WMAX], il_w[WMAX], part[128];
  __shared__ int sel_w[WMAX];

  const int tid = threadIdx.x;
  const int hq = blockIdx.y, b = blockIdx.z;
  const int hkv = hq / (Hq / Hkv);
  const int col0 = blockIdx.x * BN;
  const int tl = true_len[b];
  const int ws = tl - W;
  float* sc = scores + ((size_t)b * Hq + hq) * S;
  const int col = tid & (BN - 1), half = tid >> 6;

  if (col0 >= tl) {  // past every window row: no causal column (uniform)
    if (half == 0 && col0 + col < S) sc[col0 + col] = 0.f;
    return;
  }

  load_tile(Ks, k + ((size_t)b * Hkv + hkv) * S * D, col0, S, tid);
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
  if (half == 0 && c < S) sc[c] = part[col] + part[col + BN];
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
  // P a multiple of the 64-row tile unless one block covers everything;
  // (m, l) only without scores or a block mask (a dense-attention feature).
  if (W < 0 || W > WMAX || SW < 0 || (W > 0 && (SW > 0 || row_offset)) ||
      (!row_offset && S_q != S_k) || S_q < 1 || S_k < 1 ||
      (row_ml && (W > 0 || block_mask)))
    return (int)cudaErrorInvalidValue;
  if (block_mask && (row_offset || P < 1 || n_blk != (S_q + P - 1) / P ||
                     (n_blk > 1 && P % BM != 0)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int smem = 3 * BM * LDS * (int)sizeof(bf16);
  // Above 48 KB of dynamic shared memory needs an opt-in, once per device
  // (so that a launch under CUDA-graph capture makes no such call).
  static bool smem_set[64] = {false};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  if (!smem_set[dev]) {
    cudaFuncSetAttribute(flash_fwd_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    smem_set[dev] = true;
  }
  dim3 grid((S_q + BM - 1) / BM, Hq, B);
  flash_fwd_kernel<<<grid, 128, smem, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const int*>(true_len),
      static_cast<const int*>(row_offset), static_cast<const int*>(block_mask),
      static_cast<bf16*>(out), static_cast<float*>(win_ml), static_cast<float*>(row_ml),
      Hq, Hkv, S_q, S_k, W, SW, P, n_blk, scale);
  if (W > 0) {
    dim3 g2((S_k + BN - 1) / BN, Hq, B);
    window_scores_kernel<<<g2, 128, 0, st>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const int*>(true_len), static_cast<const int*>(block_mask),
        static_cast<const float*>(win_ml), static_cast<float*>(scores), Hq, Hkv, S_k,
        W, P, n_blk, scale);
  }
  return (int)cudaGetLastError();
}
