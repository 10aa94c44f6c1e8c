// K2: one-token decode attention over one layer of the KV cache, with the
// new token's K/V appended in place, for Hopper (sm_90a), bf16 cache.
//
// Replaces the Pallas TPU kernel
//   kvcache_factory_tpu/ops/kernels/decode_attn.py::_decode_kernel
//
// What it computes, per cache head h (q holds G query rows per head):
//   L = min(lengths[h], C - 1)            (a full cache overwrites slot C-1)
//   keys read: lower[h] <= idx < L        (slot L is never read from memory)
//   out = softmax(q.k / sqrt(D)) . v over those keys plus the new token,
//         whose K/V are folded in from registers; fp32 probabilities.
//   k_cache[h, L] = k_new[h]; v_cache[h, L] = v_new[h]
// The caller advances lengths to min(lengths + 1, C).  Any capacity C > 0,
// any G >= 1.  The instantiation width D is a template parameter, D in {64,
// 128, 256, 384, 512} (the library exports kvcf_decode_attn_append_d<D> for
// each); a tensor's head_dim hd (any even number up to 512) runs on the
// narrowest instantiation at least as wide: a row is hd elements in memory
// and D in shared memory, its 16-byte chunks past hd are zero-filled by the
// copies (never read from the next row), q's channels past hd are zero,
// nothing past hd is written, and the caller passes hd's 1/sqrt(hd).  A
// row of hd bf16 is a whole number of 16-byte pieces only at hd % 8 == 0:
// the source builds in three forms, by KVCF_PIECE, the bytes a row copy
// moves, 16 (the default), 8 (hd % 4 == 0) or 4 (any even hd).  At 8 and 4
// each 16-byte chunk of the ring is filled by 2 or 4 cp.async.ca pieces
// (the only form that takes 4 and 8 bytes) at their places inside it, a
// piece past hd zero-filled; q comes in 4-byte pairs of channels (those at
// or past hd zero) or, at 384 / 512, in pieces; the head merge stores
// pieces of at most PIECE bytes, so each lies wholly inside or past hd;
// the append writes the new row's hd elements, one at a time.  The
// numbers below are at D 128; shared memory is 768 D bytes a CTA up to D
// 256, so 4, 2 or 1 CTAs fit an SM at D 64, 128 or 256 and the bytes in
// flight an SM stay the same.  At D 384 and 512 a 16-key stage of K and V
// is 24 or 32 KB a warp: the CTA has 2 warps (3 stages each, 144 or 192 KB,
// one CTA an SM), and q's fragments (64 registers a lane at D 512) come
// from shared memory at each k-step, so that the registers hold O (D / 4
// floats a lane).
//
// What bounds it: reading the valid K/V rows once, 2 * len * D * 2 bytes
// per head (59.3 MB per layer at the main path's 64 heads of 2079 and 1531
// keys: 17.7 us at 3.35 TB/s).  The products are 2 * 2 * D * G FLOP a key,
// G FLOP per byte, far below the ~295 FLOP per byte where bf16 tensor cores
// would bound it: so only bytes in flight and the instructions issued per
// byte can keep it from the bound.
//
// Design.
//  1. One launch per call, grid (H, n_split, QB).  A CTA computes GB =
//     min(G, 8) query rows, the mma's N (point 3): CTA (h, sp, qb) takes
//     rows [8 qb, min(8 qb + 8, G)), so G above 8 runs QB = ceil(G / 8)
//     query blocks, each reading its keys once (K/V QB times in all, from
//     L2 or memory; the rows of a block past G are zero queries whose
//     partials the merge skips).  The host picks n_split from H QB, C and
//     the SM count only (never from lengths: reading them would
//     synchronise the decode step), for about two CTAs per SM in one wave.
//     CTA (h, sp) takes the sp-th of n_split near-equal parts of its head's
//     valid keys [lower, L), so no CTA idles on slots past the length; a
//     head with fewer keys than n_split leaves some CTAs empty, and they
//     still write a partial (m = NEG_INF, l = 0, acc = 0) and arrive.  Each
//     CTA writes its partial (m, l, acc[GB][D]) to fp32 scratch, then raises
//     the head's arrival counter after __threadfence.  The CTA that arrives
//     last (of n_split QB) merges every row's partials in split-index order,
//     so the result
//     does not depend on which CTA came last and two launches are bitwise
//     equal; it folds in the new token, writes out, writes k_new/v_new into
//     slot L and resets the counter to 0.  Every launch leaves the counters
//     at 0, so a replayed CUDA graph finds them so.  Appending in the same
//     launch is race-free because no CTA reads slot L: every range ends
//     below L, and rows outside a CTA's range are zero-filled, never read.
//  2. Each of the 4 warps streams its own 16 keys of every 64-key stage
//     with cp.async (16 bytes a lane, 16 copies a lane a stage, rows past
//     the range zero-filled) into a 3-stage ring of its own in shared
//     memory, K and V 4 KB each a stage: 24 KB a warp, 96 KB a CTA, two
//     CTAs an SM.  A warp waits only for its own copies (cp.async.wait_group
//     and __syncwarp), so the loop has no CTA barrier.  While a warp
//     computes one stage, its next two are in flight: 16 KB a warp, 64 KB a
//     CTA, 128 KB an SM, against the ~25 KB an SM needs to cover ~1 us of
//     loaded latency at its share (25 GB/s) of 3.35 TB/s.  The rows are
//     stored with 16-byte chunk c of row r at chunk c ^ (r & 7), so the 8
//     rows an ldmatrix phase reads fall in 8 distinct chunks of 4 banks:
//     no bank conflict.
//  3. Both products on the tensor cores, mma.sync m16n8k16 (bf16 in, fp32
//     accumulate), with the 16 keys as M and the GB query rows as N = 8, so
//     a block needs no padding to 16 rows:
//       S^T [16 keys, 8] = K [16, D] . q^T   (K by ldmatrix, q in registers)
//       O^T [D, 8]      += V^T [D, 16] . P^T  (V by ldmatrix.trans)
//     P^T comes from the S^T accumulator by movmatrix.trans, which puts
//     each probability where the B operand wants it without shared memory.
//     The plain version keeps fp32 probabilities; bf16 ones alone would put
//     the worst head near the 3e-3 tolerance, so P goes in as bf16 hi + lo
//     (two products on the same V fragments, 2^-17 relative).  This takes
//     the dot products and their shuffles off the ALUs at every G: per 16
//     keys a lane issues about 70 ALU instructions for the softmax, about
//     0.3 lane-instructions per byte, against ~8.6 per byte the card can
//     issue at its memory rate.
//  4. One softmax rescale per 16 keys: the tile max per query column (three
//     shuffles), one exp2f per score with log2(e)/sqrt(D) folded into the
//     scale, one rescale of the accumulator.  The partials leave in natural
//     log units, so the merge and the new token's logit share one unit.
//     Masked logits are NEG_INF (-FLT_MAX), never -inf; a warp skips a
//     stage that holds none of its keys, so every tile it computes has a
//     finite max and a masked key weighs exp2f(NEG_INF - max) = 0.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int KEYS = 16;      // keys a warp a stage: the mma's M
constexpr int STAGES = 3;
constexpr int MERGE_BATCH = 8;                     // splits whose loads the merge issues together
constexpr float NEG_INF = -3.4028234663852886e38f; // float32 finfo.min
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

#ifndef KVCF_PIECE
#define KVCF_PIECE 16
#endif
// Bytes a row copy moves: 16, or 8 / 4 for rows that are no whole number
// of 16-byte pieces.
constexpr int PIECE = KVCF_PIECE;
static_assert(PIECE == 16 || PIECE == 8 || PIECE == 4, "row copies of 16, 8 or 4 bytes");
constexpr bool RAGGED = PIECE < 16;
constexpr int PIECE_CH = PIECE / 2;    // bf16 channels a piece
constexpr int SUB = 16 / PIECE;        // pieces a 16-byte chunk

// The register type of one row piece.
template <int BYTES> struct PieceOf;
template <> struct PieceOf<16> { typedef uint4 T; };
template <> struct PieceOf<8> { typedef uint2 T; };
template <> struct PieceOf<4> { typedef uint32_t T; };
typedef PieceOf<PIECE>::T Piece;

// The ring of instantiation width D (bytes at D 128).
template <int D>
struct Ring {
  static_assert(D == 64 || D == 128 || D == 256 || D == 384 || D == 512,
                "instantiation width 64, 128, 256, 384 or 512");
  static constexpr bool WIDE = D > 256;                // 2 warps, q from shared memory
  static constexpr int WARPS = WIDE ? 2 : 4;
  static constexpr int THREADS = WARPS * 32;
  static constexpr int STAGE_KEYS = WARPS * KEYS;
  static constexpr int ROW_BYTES = D * 2;
  static constexpr int CHUNKS = D / 8;                 // 16-byte chunks a row
  static constexpr int SLOT_BYTES = 2 * KEYS * ROW_BYTES;  // K, then V: 8 KB
  static constexpr int WARP_RING = STAGES * SLOT_BYTES;    // 24 KB
  static constexpr int RING_BYTES = WARPS * WARP_RING;     // 96 KB
  static constexpr int QS = D + 8;                     // q's padded row in shared memory (WIDE)
  static constexpr int SMEM_BYTES = RING_BYTES + (WIDE ? 8 * QS * 2 : 0);
  static constexpr int CTAS_PER_SM = WIDE ? 1 : 256 / D;  // resident CTAs an SM: 4, 2, 1, 1, 1
  static constexpr int O_STRIDE = D + 4;               // padded row of the warp merge
  static constexpr int CPL = D / 32;                   // channels a lane in the head merge
  // The head merge stores a lane's CPL channels in pieces of OUT_VEC: a
  // piece lies at a multiple of itself, and hd is a whole number of
  // PIECE_CH-channel pieces, so a piece of at most PIECE_CH channels is
  // wholly inside or past hd.
  static constexpr int OUT_VEC_ = CPL % 8 == 0 ? 8 : CPL % 4 == 0 ? 4 : 2;
  static constexpr int OUT_VEC = OUT_VEC_ < PIECE_CH ? OUT_VEC_ : PIECE_CH;
  static_assert(WARPS * 8 * O_STRIDE * 4 + 2 * WARPS * 8 * 4 <= RING_BYTES, "warp merge");
};

struct Params {
  const bf16* q;        // [H, G, hd]
  bf16* kc;             // [H, C, hd]
  bf16* vc;             // [H, C, hd]
  const int* lengths;   // [H]
  const int* lower;     // [H] or null
  const bf16* k_new;    // [H, hd]
  const bf16* v_new;    // [H, hd]
  bf16* out;            // [H, G, hd]
  float* part_acc;      // [H, QB, n_split, GB, D]
  float* part_ml;       // [H, QB, n_split, GB, 2]: m (natural log), l
  int* counters;        // [>= H], 0 between launches
  int C, n_split;
  int G, QB;            // query rows a head; query blocks of GB rows
  int hd;               // the tensors' head_dim (PIECE_CH | hd, at most D)
  float scale;          // 1 / sqrt(hd)
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(src_bytes));
}

// One PIECE-byte piece (RAGGED: 8 or 4 bytes), cache-all: .cg takes only 16.
__device__ __forceinline__ void cp_async_piece(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n"
               :: "r"(dst), "l"(src), "n"(PIECE), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
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

// The transpose of the 8x8 bf16 matrix whose fragment the warp holds.
__device__ __forceinline__ uint32_t movmatrix_trans(uint32_t x) {
  uint32_t y;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n" : "=r"(y) : "r"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float2 unpack_bf16(uint32_t x) {
  __nv_bfloat162 v = *reinterpret_cast<__nv_bfloat162*>(&x);
  return __bfloat1622float2(v);
}

// N consecutive fp32 values from global memory, past L1 (N = 2, 4, 8, 12 or 16).
template <int N>
__device__ __forceinline__ void ldcg(const float* src, float (&x)[N]) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 4) {
      const float4 v = __ldcg(reinterpret_cast<const float4*>(src + i));
      x[i] = v.x; x[i + 1] = v.y; x[i + 2] = v.z; x[i + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < N; i += 2) {
      const float2 v = __ldcg(reinterpret_cast<const float2*>(src + i));
      x[i] = v.x; x[i + 1] = v.y;
    }
  }
}

// N values (N even) rounded to bf16 and stored at dst in one vector store
// (N = 2, 4 or 8: 4, 8 or 16 bytes).
template <int N>
__device__ __forceinline__ void store_bf16(bf16* dst, const float (&x)[N]) {
  uint32_t w[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) w[i] = pack_bf16(x[2 * i], x[2 * i + 1]);
  if constexpr (N == 8)
    *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
  else if constexpr (N == 4)
    *reinterpret_cast<uint2*>(dst) = make_uint2(w[0], w[1]);
  else
    *reinterpret_cast<uint32_t*>(dst) = w[0];
}

// The last CTA of head h to arrive: merge the n_split partials of each
// query row in split order, fold in the new token, write out, append, reset
// the counter.  Warp w takes query rows w, w + WARPS, ..., lane l channels
// CPL l .. CPL l + CPL - 1 (CPL = D / 32; those at or past hd are zero in
// the partials and never written); row g's partials are row g % GB of
// query block g / GB.  The splits are merged in batches of MERGE_BATCH: all
// of a batch's loads are issued together, then one rescale of the running
// sums and one exp per split.
template <int D, int GB>
__device__ void merge_head(const Params& p, int h, int L) {
  using R = Ring<D>;
  constexpr int CPL = R::CPL, VEC = R::OUT_VEC;
  const int tid = threadIdx.x, lane = tid & 31, d = lane * CPL;
  const int ns = p.n_split, G = p.G, hd = p.hd;
  for (int g = tid >> 5; g < G; g += R::WARPS) {
    const int qb = g / GB, gb = g - qb * GB;
    const bf16* qg = p.q + ((size_t)h * G + g) * hd + d;
    float s_new = 0.f;  // the new token's logit
#pragma unroll
    for (int i = 0; i < CPL; ++i)
      if (d + i < hd)
        s_new += __bfloat162float(qg[i]) * __bfloat162float(p.k_new[(size_t)h * hd + d + i]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s_new += __shfl_xor_sync(0xffffffffu, s_new, off);
    s_new *= p.scale;

    const size_t row = ((size_t)h * p.QB + qb) * ns * GB + gb;  // split 0's
    const float* ml = p.part_ml + row * 2;
    const float* acc = p.part_acc + row * D + d;
    float M = NEG_INF, Ls = 0.f, a[CPL];
#pragma unroll
    for (int i = 0; i < CPL; ++i) a[i] = 0.f;
    for (int s0 = 0; s0 < ns; s0 += MERGE_BATCH) {
      float2 mls[MERGE_BATCH];
      float x[MERGE_BATCH][CPL];
#pragma unroll
      for (int j = 0; j < MERGE_BATCH; ++j) {
        const size_t s = min(s0 + j, ns - 1);  // past ns: a real split, weighed 0
        mls[j] = __ldcg(reinterpret_cast<const float2*>(ml + s * GB * 2));
        ldcg<CPL>(acc + s * GB * D, x[j]);
      }
      bool live[MERGE_BATCH];  // an empty split (l = 0) adds nothing
      float Mb = M;
#pragma unroll
      for (int j = 0; j < MERGE_BATCH; ++j) {
        live[j] = s0 + j < ns && mls[j].y > 0.f;
        if (live[j]) Mb = fmaxf(Mb, mls[j].x);
      }
      const float alpha = expf(M - Mb);
      Ls *= alpha;
#pragma unroll
      for (int i = 0; i < CPL; ++i) a[i] *= alpha;
#pragma unroll
      for (int j = 0; j < MERGE_BATCH; ++j) {
        const float w = live[j] ? expf(mls[j].x - Mb) : 0.f;
        Ls += w * mls[j].y;
#pragma unroll
        for (int i = 0; i < CPL; ++i) a[i] += w * x[j][i];
      }
      M = Mb;
    }
    const float m_f = fmaxf(M, s_new);
    const float alpha = expf(M - m_f), p_new = expf(s_new - m_f);
    const float inv = 1.f / (Ls * alpha + p_new);
#pragma unroll
    for (int u = 0; u < CPL; u += VEC) {
      if (d + u >= hd) break;
      float o[VEC];
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        const float vn = __bfloat162float(p.v_new[(size_t)h * hd + d + u + i]);
        o[i] = (a[u + i] * alpha + p_new * vn) * inv;
      }
      store_bf16<VEC>(p.out + ((size_t)h * G + g) * hd + d + u, o);
    }
  }
  for (int c = tid; c < hd; c += R::THREADS) {
    p.kc[((size_t)h * p.C + L) * hd + c] = p.k_new[(size_t)h * hd + c];
    p.vc[((size_t)h * p.C + L) * hd + c] = p.v_new[(size_t)h * hd + c];
  }
  if (tid == 0) p.counters[h] = 0;
}

template <int D, int GB>
__global__ void __launch_bounds__(Ring<D>::THREADS, Ring<D>::CTAS_PER_SM)
decode_attn_kernel(const Params p) {
  using R = Ring<D>;
  constexpr int ROW_BYTES = R::ROW_BYTES, CHUNKS = R::CHUNKS, O_STRIDE = R::O_STRIDE;
  constexpr int WARPS = R::WARPS, THREADS = R::THREADS, STAGE_KEYS = R::STAGE_KEYS;
  extern __shared__ __align__(128) uint8_t smem[];
  __shared__ int sm_last;

  const int h = blockIdx.x, sp = blockIdx.y, qb = blockIdx.z;
  const int g0 = qb * GB;  // this CTA's first query row
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int C = p.C, hd = p.hd;
  const int L = min(p.lengths[h], C - 1);
  const int lo = p.lower ? min(max(p.lower[h], 0), L) : 0;
  // This CTA's share of [lo, L): the sp-th of n_split near-equal parts.
  const long long n = L - lo;
  const int start = lo + (int)(n * sp / p.n_split);
  const int end = lo + (int)(n * (sp + 1) / p.n_split);
  const int n_stages = (end - start + STAGE_KEYS - 1) / STAGE_KEYS;

  // q^T as the B operand (k = channel, n = query row g0 + gid; rows past
  // the block or past G, and channels past hd, zero): in registers, or
  // (WIDE) rows of QS in shared memory after the rings, read at each k-step.
  const bool q_row = gid < GB && g0 + gid < p.G;
  const bf16* q_src = p.q + ((size_t)h * p.G + g0 + gid) * hd;
  uint32_t qf[R::WIDE ? 1 : D / 16][2];
  bf16* qs = reinterpret_cast<bf16*>(smem + R::RING_BYTES);
  if constexpr (R::WIDE) {
    for (int i = tid; i < 8 * (D / PIECE_CH); i += THREADS) {  // PIECE-byte pieces of 8 rows
      const int g = i / (D / PIECE_CH), c = (i % (D / PIECE_CH)) * PIECE_CH;
      Piece val{};
      if (g < GB && g0 + g < p.G && c < hd)
        val = *reinterpret_cast<const Piece*>(p.q + ((size_t)h * p.G + g0 + g) * hd + c);
      *reinterpret_cast<Piece*>(qs + g * R::QS + c) = val;
    }
    __syncthreads();
  } else {
    // This lane's pair of channels of a k-step lies inside or past hd: as
    // a group of 8 (hd % 8 == 0), or alone (RAGGED: hd is even).
#pragma unroll
    for (int kc = 0; kc < D / 16; ++kc)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        qf[kc][j] = q_row && kc * 16 + j * 8 + (RAGGED ? 2 * tig : 0) < hd
                        ? *reinterpret_cast<const uint32_t*>(q_src + kc * 16 + j * 8 + 2 * tig)
                        : 0u;
  }
  auto q_frag = [&](int kc, int j) {
    if constexpr (R::WIDE)
      return *reinterpret_cast<const uint32_t*>(qs + gid * R::QS + kc * 16 + j * 8 + 2 * tig);
    else
      return qf[kc][j];
  };

  // This warp's ring; lane l copies 16-byte piece 32 j + l of the stage's
  // KEYS rows of CHUNKS pieces (row (32 j + l) / CHUNKS), of K and of V;
  // pieces past the range or past hd are zero-filled.
  const uint32_t ring = smem_u32(smem) + warp * R::WARP_RING;
  const bf16* kh = p.kc + (size_t)h * C * hd;
  const bf16* vh = p.vc + (size_t)h * C * hd;
  auto load_stage = [&](int i) {
    const int row0 = start + i * STAGE_KEYS + warp * KEYS;
    if (row0 >= end) return;
    const uint32_t slot = ring + (i % STAGES) * R::SLOT_BYTES;
    if constexpr (RAGGED) {
      // Lane l copies piece 32 j + l of the stage's KEYS rows of CHUNKS x
      // SUB pieces: sub-piece u of chunk c lands u PIECE bytes into the
      // chunk's swizzled slot.  A stage has 2 or 4 times the 16-byte
      // build's copies: unrolled by 4 only, which keeps the code, and
      // nvcc's time over the 40 instantiations, near that build's.
#pragma unroll 4
      for (int j = 0; j < KEYS * CHUNKS * SUB / 32; ++j) {
        const int e = 32 * j + lane;
        const int r = e / (CHUNKS * SUB), c = (e / SUB) % CHUNKS, u = e % SUB;
        const int col = c * 8 + u * PIECE_CH;
        const bool valid = row0 + r < end && col < hd;
        const size_t off = valid ? (size_t)(row0 + r) * hd + col : (size_t)start * hd;
        const uint32_t dst = slot + r * ROW_BYTES + ((c ^ (r & 7)) << 4) + u * PIECE;
        cp_async_piece(dst, kh + off, valid ? PIECE : 0);
        cp_async_piece(dst + KEYS * ROW_BYTES, vh + off, valid ? PIECE : 0);
      }
    } else {
#pragma unroll
      for (int j = 0; j < KEYS * CHUNKS / 32; ++j) {
        const int r = (32 * j + lane) / CHUNKS, c = (32 * j + lane) % CHUNKS;
        const bool valid = row0 + r < end && c * 8 < hd;
        const size_t off = valid ? (size_t)(row0 + r) * hd + c * 8 : (size_t)start * hd;
        const uint32_t dst = slot + r * ROW_BYTES + ((c ^ (r & 7)) << 4);
        cp_async16(dst, kh + off, valid ? 16 : 0);
        cp_async16(dst + KEYS * ROW_BYTES, vh + off, valid ? 16 : 0);
      }
    }
  };

  // ldmatrix row addresses: matrix mi = lane >> 3, its row ri = lane & 7.
  // K (A, row = key): key ri + 8 (mi & 1), chunk 2 kc + (mi >> 1).
  // V (A = V^T by .trans): key ri + 8 (mi >> 1), chunk 2 mb + (mi & 1).
  const int mi = lane >> 3, ri = lane & 7;
  const uint32_t k_row = (ri + 8 * (mi & 1)) * ROW_BYTES, k_chunk = mi >> 1;
  const uint32_t v_row = KEYS * ROW_BYTES + (ri + 8 * (mi >> 1)) * ROW_BYTES, v_chunk = mi & 1;

  const float sl2 = p.scale * LOG2E;
  float m0 = NEG_INF, m1 = NEG_INF;  // running max, query columns 2 tig and 2 tig + 1
  float l0 = 0.f, l1 = 0.f;          // this lane's share of the sums
  float o[D / 16][4];                // O^T: channel 16 mb + gid (+8), queries 2 tig (+1)
#pragma unroll
  for (int mb = 0; mb < D / 16; ++mb)
#pragma unroll
    for (int i = 0; i < 4; ++i) o[mb][i] = 0.f;

#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {
    if (i < n_stages) load_stage(i);
    cp_async_commit();
  }
  for (int i = 0; i < n_stages; ++i) {
    cp_async_wait<STAGES - 2>();
    __syncwarp();
    if (i + STAGES - 1 < n_stages) load_stage(i + STAGES - 1);
    cp_async_commit();
    const int row0 = start + i * STAGE_KEYS + warp * KEYS;
    if (row0 >= end) continue;  // warp-uniform: none of this warp's keys
    const uint32_t slot = ring + (i % STAGES) * R::SLOT_BYTES;

    float s[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int kc = 0; kc < D / 16; ++kc) {
      uint32_t a[4];
      ldsm_x4(slot + k_row + (((2 * kc + k_chunk) ^ ri) << 4), a);
      mma16816(s, a, q_frag(kc, 0), q_frag(kc, 1));
    }
    // s: keys row0 + gid (0, 1) and row0 + gid + 8 (2, 3); queries 2 tig, 2 tig + 1.
    const bool in0 = row0 + gid < end, in1 = row0 + gid + 8 < end;
    const float t0 = in0 ? s[0] * sl2 : NEG_INF, t1 = in0 ? s[1] * sl2 : NEG_INF;
    const float t2 = in1 ? s[2] * sl2 : NEG_INF, t3 = in1 ? s[3] * sl2 : NEG_INF;
    float mx0 = fmaxf(t0, t2), mx1 = fmaxf(t1, t3);
#pragma unroll
    for (int off = 4; off < 32; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float a0 = exp2f(m0 - mn0), a1 = exp2f(m1 - mn1);
    const float p0 = exp2f(t0 - mn0), p1 = exp2f(t1 - mn1);
    const float p2 = exp2f(t2 - mn0), p3 = exp2f(t3 - mn1);
    m0 = mn0;
    m1 = mn1;
    l0 = l0 * a0 + (p0 + p2);
    l1 = l1 * a1 + (p1 + p3);
#pragma unroll
    for (int mb = 0; mb < D / 16; ++mb) {
      o[mb][0] *= a0; o[mb][1] *= a1; o[mb][2] *= a0; o[mb][3] *= a1;
    }
    // P^T as B (k = key, n = query): hi and lo bf16 halves, transposed.
    const uint32_t h01 = pack_bf16(p0, p1), h23 = pack_bf16(p2, p3);
    const float2 r01 = unpack_bf16(h01), r23 = unpack_bf16(h23);
    const uint32_t l01 = pack_bf16(p0 - r01.x, p1 - r01.y), l23 = pack_bf16(p2 - r23.x, p3 - r23.y);
    const uint32_t bh0 = movmatrix_trans(h01), bh1 = movmatrix_trans(h23);
    const uint32_t bl0 = movmatrix_trans(l01), bl1 = movmatrix_trans(l23);
#pragma unroll
    for (int mb = 0; mb < D / 16; ++mb) {
      uint32_t a[4];
      ldsm_x4_trans(slot + v_row + (((2 * mb + v_chunk) ^ ri) << 4), a);
      mma16816(o[mb], a, bh0, bh1);
      mma16816(o[mb], a, bl0, bl1);
    }
  }
  cp_async_wait<0>();
#pragma unroll
  for (int off = 4; off < 32; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  __syncthreads();  // every warp is done with its ring: reuse it

  // Merge the 4 warps into the CTA's partial.  sm_o [warp][query][channel].
  float* sm_o = reinterpret_cast<float*>(smem);
  float* sm_m = sm_o + WARPS * 8 * O_STRIDE;
  float* sm_l = sm_m + WARPS * 8;
#pragma unroll
  for (int mb = 0; mb < D / 16; ++mb) {
    float* row0 = sm_o + (warp * 8 + 2 * tig) * O_STRIDE + mb * 16 + gid;
    row0[0] = o[mb][0];
    row0[O_STRIDE] = o[mb][1];
    row0[8] = o[mb][2];
    row0[O_STRIDE + 8] = o[mb][3];
  }
  if (gid == 0) {
    sm_m[warp * 8 + 2 * tig] = m0;
    sm_m[warp * 8 + 2 * tig + 1] = m1;
    sm_l[warp * 8 + 2 * tig] = l0;
    sm_l[warp * 8 + 2 * tig + 1] = l1;
  }
  __syncthreads();
  const size_t pbase = (((size_t)h * p.QB + qb) * p.n_split + sp) * GB;
  for (int d = tid; d < D; d += THREADS) {  // channel d (D 64: threads 0-63)
#pragma unroll
    for (int g = 0; g < GB; ++g) {
      float M = NEG_INF;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) M = fmaxf(M, sm_m[w * 8 + g]);
      float Ls = 0.f, A = 0.f;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) {
        const float wt = exp2f(sm_m[w * 8 + g] - M);
        Ls += sm_l[w * 8 + g] * wt;
        A += sm_o[(w * 8 + g) * O_STRIDE + d] * wt;
      }
      p.part_acc[(pbase + g) * D + d] = A;
      if (d == 0) {
        p.part_ml[(pbase + g) * 2] = Ls > 0.f ? M * LN2 : NEG_INF;
        p.part_ml[(pbase + g) * 2 + 1] = Ls;
      }
    }
  }

  // Arrive; the last CTA of the head (of its n_split QB) merges.
  __threadfence();
  __syncthreads();
  const int arrivals = p.n_split * p.QB;
  if (tid == 0) sm_last = arrivals == 1 || atomicAdd(p.counters + h, 1) == arrivals - 1;
  __syncthreads();
  if (!sm_last) return;
  __threadfence();
  merge_head<D, GB>(p, h, L);
}

template <int D, int GB>
int launch(const Params& p, int H, cudaStream_t st) {
  constexpr int SMEM = Ring<D>::SMEM_BYTES, THREADS = Ring<D>::THREADS;
  static bool configured[64] = {false};  // once per instantiation and device
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev >= 64) return (int)cudaErrorInvalidDevice;
  if (!configured[dev]) {
    cudaError_t err = cudaFuncSetAttribute(decode_attn_kernel<D, GB>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(decode_attn_kernel<D, GB>,
                                 cudaFuncAttributePreferredSharedMemoryCarveout,
                                 cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return (int)err;
    configured[dev] = true;
  }
  decode_attn_kernel<D, GB><<<dim3(H, p.n_split, p.QB), THREADS, SMEM, st>>>(p);
  return (int)cudaGetLastError();
}

template <int D>
int decode_attn_append(const void* q, void* k_cache, void* v_cache, const void* lengths,
                       const void* lower, const void* k_new, const void* v_new, void* out,
                       void* part, void* counters, int H, int G, int C, int n_split,
                       int hd, float scale, void* stream) {
  if (n_split < 1 || G < 1 || hd < PIECE_CH || hd > D || hd % PIECE_CH != 0)
    return (int)cudaErrorInvalidValue;
  const int GB = G < 8 ? G : 8, QB = (G + 7) / 8;
  Params p;
  p.q = static_cast<const bf16*>(q);
  p.kc = static_cast<bf16*>(k_cache);
  p.vc = static_cast<bf16*>(v_cache);
  p.lengths = static_cast<const int*>(lengths);
  p.lower = static_cast<const int*>(lower);
  p.k_new = static_cast<const bf16*>(k_new);
  p.v_new = static_cast<const bf16*>(v_new);
  p.out = static_cast<bf16*>(out);
  p.part_acc = static_cast<float*>(part);
  p.part_ml = p.part_acc + (size_t)H * QB * n_split * GB * D;
  p.counters = static_cast<int*>(counters);
  p.C = C;
  p.n_split = n_split;
  p.G = G;
  p.QB = QB;
  p.hd = hd;
  p.scale = scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (GB) {  // G above 8 runs blocks of 8
    case 1: return launch<D, 1>(p, H, st);
    case 2: return launch<D, 2>(p, H, st);
    case 3: return launch<D, 3>(p, H, st);
    case 4: return launch<D, 4>(p, H, st);
    case 5: return launch<D, 5>(p, H, st);
    case 6: return launch<D, 6>(p, H, st);
    case 7: return launch<D, 7>(p, H, st);
    case 8: return launch<D, 8>(p, H, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// One entry point per instantiation width: kvcf_decode_attn_append_d64,
// _d128, _d256, _d384, _d512.
#define KVCF_DECODE_ATTN(DIM)                                                          \
  extern "C" int kvcf_decode_attn_append_d##DIM(                                       \
      const void* q, void* k_cache, void* v_cache, const void* lengths,                \
      const void* lower, const void* k_new, const void* v_new, void* out, void* part,  \
      void* counters, int H, int G, int C, int n_split, int hd, float scale,           \
      void* stream) {                                                                  \
    return decode_attn_append<DIM>(q, k_cache, v_cache, lengths, lower, k_new, v_new,  \
                                   out, part, counters, H, G, C, n_split, hd, scale,   \
                                   stream);                                            \
  }
KVCF_DECODE_ATTN(64)
KVCF_DECODE_ATTN(128)
KVCF_DECODE_ATTN(256)
KVCF_DECODE_ATTN(384)
KVCF_DECODE_ATTN(512)
