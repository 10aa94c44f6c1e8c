// K2, K3 and K4 above head_dim 512: one-token decode attention over one
// layer of the KV cache, with the new token appended in place, for Hopper
// (sm_90a): the bf16 cache (K2, built as the library decode_attn_wide) and
// the per-token int8 / int4 caches (K3 / K4, the same source built with
// KVCF_WIDE_QUANT as decode_attn_quant_wide).
//
// Replaces the Pallas TPU kernels
//   kvcache_factory_tpu/ops/kernels/decode_attn.py::_decode_kernel
//   kvcache_factory_tpu/ops/kernels/decode_attn_quant.py::_quant_decode_kernel
//   kvcache_factory_tpu/ops/kernels/decode_attn_quant.py::_quant4_decode_kernel
// at the head_dims above 512 that they take (any D % 128 == 0); the port
// runs every even head_dim above 512 here for the bf16 cache, and every
// D % 128 == 0 above 512 for the per-token caches (the only head_dims at
// which they exist).  What it computes is that of csrc/decode_attn.cu and
// csrc/decode_attn_quant.cu, per cache head h with G query rows:
//   L = min(lengths[h], C - 1)            (a full cache overwrites slot C-1)
//   keys read: lower[h] <= idx < L        (slot L is never read from memory)
//   out = softmax(q.k * scale) . v over those keys plus the new token, whose
//         K/V (full precision, from k_new / v_new) are folded in last; fp32
//         probabilities.  A quantized key or value is code * scale + zero
//         with its token's stored bf16 scale and zero, so a logit is
//         k_scale (q . codes) + k_zero sum(q) and the output adds
//         sum_j p_j v_zero_j to sum_j (p_j v_scale_j) codes_j.
//   Then slot L takes the new token: k_new / v_new as they are (bf16), or
//   quantized per token as the plain version does (min and max over D,
//   scale = max(max - min, 1e-8) / 255 or / 15 with IEEE division, codes
//   rintf((x - min) / scale) clamped, the four scalars rounded to bf16).
// The caller advances lengths to min(lengths + 1, C).  Any capacity C > 0,
// any G >= 1 (blocks of 8 query rows).
//
// What bounds it: reading the valid rows once, 2 * len * D * 2 bytes a head
// in bf16 (a half or a quarter of that in codes, plus 8 bytes of scalars a
// key); the products are G FLOP a byte, far below the tensor cores' ridge.
// What limits the design is shared memory and registers, which the
// narrower kernels spend in proportion to D (a whole K/V row a key in the
// ring, O's D columns in registers).  Here neither grows with D:
//  1. O's columns are split over a grid dimension of column slices of DV =
//     256 channels: CTA (h, sp, qb x slice) owns query block qb's rows and
//     DV columns of O, for its split sp of the head's valid keys, split as
//     K2 splits them (the sp-th of n_split near-equal parts of [lower, L),
//     n_split from the shapes and the SM count only).
//  2. The logits need every channel: each warp computes S^T [16 keys, 8
//     query rows] = K . q^T over all of D with mma.sync m16n8k16, reading
//     its 16 key rows and q straight from global memory as fragments, 8
//     channels a lane at a time (16-byte loads, or 8 / 4-byte pieces for
//     bf16 rows that are no whole number of 16-byte pieces).  A lane's 8
//     channels 32 j + 8 tig .. + 7 feed two products (k-step halves), so
//     the logical k order is a fixed permutation of the channels, the same
//     for K and q.  Codes become bf16 exactly (integers below 256).  Every
//     slice CTA computes a logit with the same instructions in the same
//     order: the slices' softmaxes agree bitwise.
//  3. Each 64-key stage: the logits into shared memory, one online-softmax
//     step per query row (a warp a row, two rows a warp), then O += P V over
//     the slice, one channel pair a thread, fp32 FMAs from the stage's V
//     slice, which a 2-stage cp.async ring brings in under the next stage's
//     logits (33 KB a stage in bf16, 16 / 8 KB in codes).  P stays fp32.
//  4. Each CTA writes its partial (m, l, acc[GB][DV]) to fp32 scratch and
//     raises the arrival counter of its (head, query block, slice) after
//     __threadfence; the last of the n_split CTAs merges the partials in
//     split order (bitwise repeatable), folds in the new token (its logit
//     from k_new over all of D, the same instructions in every slice),
//     writes its columns of out and resets the counter to 0.  The merge of
//     query block 0, slice 0 also appends the new token: no CTA reads slot
//     L, so it may at any time.
// Masked logits are NEG_INF (-FLT_MAX) and weigh exactly 0; partials leave
// in natural-log units.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int DV = 256;        // O columns a CTA: one column slice
constexpr int STAGE = 64;      // keys a stage: 16 a warp
constexpr int THREADS = 128;
constexpr float NEG_INF = -3.4028234663852886e38f;  // float32 finfo.min
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
constexpr unsigned FULL = 0xffffffffu;

// The cache's element: NBITS 16 (bf16 values), 8 or 4 (codes).
template <int NBITS>
struct Cache {
  static constexpr bool QUANT = NBITS < 16;
  static constexpr int V_ROW = DV * NBITS / 8;                // a stage's V slice row: 512, 256, 128 B
  static constexpr int V_LD = V_ROW + 16;                     // padded in shared memory
};

struct Params {
  const bf16* q;        // [H, G, hd]
  uint8_t* kc;          // [H, C, hd] bf16, or [H, C, hd * NBITS / 8] codes
  uint8_t* vc;
  bf16* sc;             // [H, C, 4] (k_scale, k_zero, v_scale, v_zero): codes only
  const int* lengths;   // [H]
  const int* lower;     // [H] or null
  const bf16* k_new;    // [H, hd]
  const bf16* v_new;    // [H, hd]
  bf16* out;            // [H, G, hd]
  float* part_acc;      // [H, QB, n_slice, n_split, GB, DV]
  float* part_ml;       // [H, QB, n_slice, n_split, GB, 2]: m (natural log), l
  int* counters;        // [>= H QB n_slice], 0 between launches
  int C, n_split, n_slice, G, QB, hd;
  float scale;          // 1 / sqrt(hd)
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

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

// d += a . b, m16n8k16, bf16 in, fp32 accumulate.
__device__ __forceinline__ void mma16816(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The bf16 in the low / high half of a 32-bit word, as a float (exact).
__device__ __forceinline__ float bf16_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t w) { return __uint_as_float(w & 0xFFFF0000u); }

// Channels [c, c + 8) of a bf16 row as four channel pairs, in pieces of
// PIECE bytes (a piece at or past hd reads as zeros); `ok` false: zeros.
template <int PIECE>
__device__ __forceinline__ uint4 load8_bf16(const bf16* row, int c, int hd, bool ok) {
  uint4 x = make_uint4(0u, 0u, 0u, 0u);
  if (!ok || c >= hd) return x;
  if constexpr (PIECE == 16) {
    x = __ldg(reinterpret_cast<const uint4*>(row + c));
  } else if constexpr (PIECE == 8) {
    const uint2 a = __ldg(reinterpret_cast<const uint2*>(row + c));
    x.x = a.x; x.y = a.y;
    if (c + 4 < hd) {
      const uint2 b = __ldg(reinterpret_cast<const uint2*>(row + c + 4));
      x.z = b.x; x.w = b.y;
    }
  } else {
    const uint32_t* r = reinterpret_cast<const uint32_t*>(row + c);
    x.x = __ldg(r);
    if (c + 2 < hd) x.y = __ldg(r + 1);
    if (c + 4 < hd) x.z = __ldg(r + 2);
    if (c + 6 < hd) x.w = __ldg(r + 3);
  }
  return x;
}

// Channels [c, c + 8) of a code row as four bf16 channel pairs (hd % 128 ==
// 0 for the per-token caches: whole 8-channel groups).
template <int NBITS>
__device__ __forceinline__ uint4 load8_codes(const uint8_t* row, int c, int hd, bool ok) {
  uint4 x = make_uint4(0u, 0u, 0u, 0u);
  if (!ok || c >= hd) return x;
  // Two codes (low byte first / low nibble first) as a bf16 pair: exact.
  auto codes_bf16 = [](uint32_t c0, uint32_t c1) { return pack_bf16((float)c0, (float)c1); };
  if constexpr (NBITS == 8) {
    const uint2 w = __ldg(reinterpret_cast<const uint2*>(row + c));
    x.x = codes_bf16(w.x & 0xFF, (w.x >> 8) & 0xFF);
    x.y = codes_bf16((w.x >> 16) & 0xFF, w.x >> 24);
    x.z = codes_bf16(w.y & 0xFF, (w.y >> 8) & 0xFF);
    x.w = codes_bf16((w.y >> 16) & 0xFF, w.y >> 24);
  } else {  // channel 2i in the low nibble of byte i, 2i + 1 in the high one
    const uint32_t w = __ldg(reinterpret_cast<const uint32_t*>(row + c / 2));
    x.x = codes_bf16(w & 0xF, (w >> 4) & 0xF);
    x.y = codes_bf16((w >> 8) & 0xF, (w >> 12) & 0xF);
    x.z = codes_bf16((w >> 16) & 0xF, (w >> 20) & 0xF);
    x.w = codes_bf16((w >> 24) & 0xF, w >> 28);
  }
  return x;
}

// The fp32 dot of two bf16 rows over hd channels, one warp: lane l adds
// pairs l, l + 32, ... in order, then a butterfly.  The same instructions
// in every CTA, so every slice gets the same bits.
__device__ __forceinline__ float warp_dot(const bf16* a, const bf16* b, int hd, int lane) {
  float s = 0.f;
  for (int c = 2 * lane; c < hd; c += 64) {
    const float2 x = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(a + c));
    const float2 y = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(b + c));
    s = fmaf(x.x, y.x, s);
    s = fmaf(x.y, y.y, s);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(FULL, s, off);
  return s;
}

// The last CTA of (h, qb, slice) to arrive: merge the n_split partials of
// each of its query rows in split order, fold in the new token, write this
// slice's columns of out.  Thread t owns the channel pair 2t, 2t + 1 of the
// slice.
template <int NBITS, int GB>
__device__ __forceinline__ void merge_slice(const Params& p, int h, int qb, int slice,
                                            const float* s_new) {
  const int tid = threadIdx.x, hd = p.hd, ns = p.n_split;
  const int c_lo = slice * DV, ch = c_lo + 2 * tid;
  if (ch >= hd) return;
  const size_t grp = (((size_t)h * p.QB + qb) * p.n_slice + slice) * ns;
  const float2 vn = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(p.v_new + (size_t)h * hd + ch));
#pragma unroll
  for (int g = 0; g < GB; ++g) {
    const int row = qb * GB + g;
    if (row >= p.G) break;
    float M = NEG_INF, Ls = 0.f, a0 = 0.f, a1 = 0.f;
    for (int s = 0; s < ns; ++s) {
      const size_t e = (grp + s) * GB + g;
      const float2 ml = __ldcg(reinterpret_cast<const float2*>(p.part_ml + e * 2));
      if (!(ml.y > 0.f)) continue;  // an empty split adds nothing
      const float2 x = __ldcg(reinterpret_cast<const float2*>(p.part_acc + e * DV + 2 * tid));
      const float Mn = fmaxf(M, ml.x);
      const float alpha = expf(M - Mn), w = expf(ml.x - Mn);
      Ls = Ls * alpha + w * ml.y;
      a0 = a0 * alpha + w * x.x;
      a1 = a1 * alpha + w * x.y;
      M = Mn;
    }
    const float m_f = fmaxf(M, s_new[g]);
    const float alpha = expf(M - m_f), p_new = expf(s_new[g] - m_f);
    // Approximate reciprocal, no subroutine call: the sum is at least 1.
    const float inv = __fdividef(1.f, Ls * alpha + p_new);
    *reinterpret_cast<uint32_t*>(p.out + ((size_t)h * p.G + row) * hd + ch) =
        pack_bf16((a0 * alpha + p_new * vn.x) * inv, (a1 * alpha + p_new * vn.y) * inv);
  }
}

// Write the new token into slot L: bf16 as it is, or quantized per token.
template <int NBITS>
__device__ __forceinline__ void append_token(const Params& p, int h, int L) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, hd = p.hd;
  const bf16* kn = p.k_new + (size_t)h * hd;
  const bf16* vn = p.v_new + (size_t)h * hd;
  const size_t row = (size_t)h * p.C + L;
  if constexpr (NBITS == 16) {
    bf16* kd = reinterpret_cast<bf16*>(p.kc) + row * hd;
    bf16* vd = reinterpret_cast<bf16*>(p.vc) + row * hd;
    for (int c = tid; c < hd; c += THREADS) {
      kd[c] = kn[c];
      vd[c] = vn[c];
    }
  } else {
    __shared__ float ext[THREADS / 32][4];
    float kmn = __bfloat162float(kn[0]), kmx = kmn, vmn = __bfloat162float(vn[0]), vmx = vmn;
    for (int c = tid; c < hd; c += THREADS) {
      const float x = __bfloat162float(kn[c]), y = __bfloat162float(vn[c]);
      kmn = fminf(kmn, x); kmx = fmaxf(kmx, x);
      vmn = fminf(vmn, y); vmx = fmaxf(vmx, y);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      kmn = fminf(kmn, __shfl_xor_sync(FULL, kmn, off));
      kmx = fmaxf(kmx, __shfl_xor_sync(FULL, kmx, off));
      vmn = fminf(vmn, __shfl_xor_sync(FULL, vmn, off));
      vmx = fmaxf(vmx, __shfl_xor_sync(FULL, vmx, off));
    }
    if (lane == 0) {
      ext[warp][0] = kmn; ext[warp][1] = kmx; ext[warp][2] = vmn; ext[warp][3] = vmx;
    }
    __syncthreads();
#pragma unroll
    for (int w = 0; w < THREADS / 32; ++w) {
      kmn = fminf(kmn, ext[w][0]); kmx = fmaxf(kmx, ext[w][1]);
      vmn = fminf(vmn, ext[w][2]); vmx = fmaxf(vmx, ext[w][3]);
    }
    constexpr float QMAX = NBITS == 8 ? 255.f : 15.f;
    const float ks = fmaxf(kmx - kmn, 1e-8f) / QMAX;
    const float vs = fmaxf(vmx - vmn, 1e-8f) / QMAX;
    auto code = [&](float x, float mn, float s) {
      return (uint32_t)fminf(fmaxf(rintf((x - mn) / s), 0.f), QMAX);
    };
    constexpr int RB = NBITS == 8 ? 1 : 2;  // channels a byte
    const int width = hd / RB;
    for (int i = tid; i < width; i += THREADS) {
      uint32_t kq, vq;
      if constexpr (NBITS == 8) {
        kq = code(__bfloat162float(kn[i]), kmn, ks);
        vq = code(__bfloat162float(vn[i]), vmn, vs);
      } else {  // channel 2i in the low nibble, 2i + 1 in the high one
        kq = code(__bfloat162float(kn[2 * i]), kmn, ks) |
             (code(__bfloat162float(kn[2 * i + 1]), kmn, ks) << 4);
        vq = code(__bfloat162float(vn[2 * i]), vmn, vs) |
             (code(__bfloat162float(vn[2 * i + 1]), vmn, vs) << 4);
      }
      p.kc[row * width + i] = (uint8_t)kq;
      p.vc[row * width + i] = (uint8_t)vq;
    }
    if (tid == 0) {
      bf16* s4 = p.sc + row * 4;
      s4[0] = __float2bfloat16(ks);
      s4[1] = __float2bfloat16(kmn);
      s4[2] = __float2bfloat16(vs);
      s4[3] = __float2bfloat16(vmn);
    }
  }
}

// CTA (h, sp, qb x slice): GB query rows of block qb (rows past G are zero
// queries whose partials the merge skips), DV columns of O, keys [start,
// end) of the head.  Lane (gid, tig) of warp w computes the logits of keys
// 16 w + gid and 16 w + gid + 8 of a stage for query rows 2 tig, 2 tig + 1
// (the mma's C layout).
template <int NBITS, int PIECE, int GB>
__global__ void __launch_bounds__(THREADS, 2)
decode_wide_kernel(const Params p) {
  using CA = Cache<NBITS>;
  constexpr int V_LD = CA::V_LD;
  extern __shared__ __align__(16) unsigned char smem[];
  uint8_t* sV = smem;                                              // [2][STAGE][V_LD]
  float* sP = reinterpret_cast<float*>(smem + 2 * STAGE * V_LD);   // [STAGE][8]
  float* sVS = sP + STAGE * 8;                                     // [STAGE] v_scale
  float* sVZ = sVS + STAGE;                                        // [STAGE] v_zero
  __shared__ float sA[8];      // each row's rescale for the stage
  __shared__ float sQsum[8];   // sum(q) of each row (codes)
  __shared__ float stM[8], stL[8], stZ[8];  // each row's running state
  __shared__ float sM[8], sL[8];             // the partial's (m in natural log, l)
  __shared__ float sNew[8];    // the new token's logit of each row
  __shared__ int sm_last;

  const int h = blockIdx.x, sp = blockIdx.y;
  const int qb = blockIdx.z / p.n_slice, slice = blockIdx.z % p.n_slice;
  const int g0 = qb * GB;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int C = p.C, hd = p.hd, G = p.G;
  const int L = min(p.lengths[h], C - 1);
  const int lo = p.lower ? min(max(p.lower[h], 0), L) : 0;
  // 32-bit: the host keeps C n_split below 2^32 (a 64-bit division would
  // be a subroutine call).
  const unsigned n = (unsigned)(L - lo);
  const int start = lo + (int)(n * (unsigned)sp / (unsigned)p.n_split);
  const int end = lo + (int)(n * (unsigned)(sp + 1) / (unsigned)p.n_split);
  const int n_stages = (end - start + STAGE - 1) / STAGE;
  const int c_lo = slice * DV;
  const float sl2 = p.scale * LOG2E;

  // Row bytes of the cache, and this slice's V bytes in a row.
  const int row_bytes = hd * NBITS / 8;
  const int v_off = c_lo * NBITS / 8;
  const int v_bytes = min(DV, hd - c_lo) * NBITS / 8;
  const uint8_t* kh = p.kc + (size_t)h * C * row_bytes;
  const uint8_t* vh = p.vc + (size_t)h * C * row_bytes;
  const bf16* sch = p.sc ? p.sc + (size_t)h * C * 4 : nullptr;

  // sum(q) of each query row (codes) and the new token's logits: warp w
  // takes rows w and w + 4, always in the same order.
  for (int g = warp; g < GB; g += THREADS / 32) {
    const bool real = g0 + g < G;
    const bf16* qg = p.q + ((size_t)h * G + g0 + g) * hd;
    if constexpr (CA::QUANT) {
      float s = 0.f;
      if (real)
        for (int c = 2 * lane; c < hd; c += 64) {
          const float2 x = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(qg + c));
          s += x.x;
          s += x.y;
        }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(FULL, s, off);
      if (lane == 0) sQsum[g] = s;
    }
    const float sn = real ? warp_dot(qg, p.k_new + (size_t)h * hd, hd, lane) * p.scale : 0.f;
    if (lane == 0) sNew[g] = sn;
  }

  // The V slice of stage i into ring slot i & 1, in PIECE-byte pieces (16
  // for codes); rows past the range zero-filled.
  auto load_v = [&](int i) {
    const int row0 = start + i * STAGE;
    const uint32_t base = smem_u32(sV + (i & 1) * STAGE * V_LD);
    constexpr int PB = CA::QUANT ? 16 : PIECE;
    const int ppr = (v_bytes + PB - 1) / PB;
    for (int e = tid; e < STAGE * ppr; e += THREADS) {
      const int r = e / ppr, c = (e % ppr) * PB;
      const bool ok = row0 + r < end;
      cp_piece<PB>(base + r * V_LD + c,
                   ok ? vh + (size_t)(row0 + r) * row_bytes + v_off + c : vh, ok);
    }
  };
  if (n_stages > 0) load_v(0);
  cp_async_commit();

  // This thread's accumulators: query rows 0..GB-1, channels c_lo + 2 tid, + 1.
  float o[GB][2];
#pragma unroll
  for (int g = 0; g < GB; ++g) o[g][0] = o[g][1] = 0.f;
  // Each query row's running max (log2 units), sum and (codes) sum of
  // p * v_zero, kept by the row's warp.
  if (tid < 8) {
    stM[tid] = NEG_INF;
    stL[tid] = 0.f;
    stZ[tid] = 0.f;
  }
  __syncthreads();  // sQsum, sNew, the row state

  const bool q_real = gid < GB && g0 + gid < G;
  const bf16* q_row = p.q + ((size_t)h * G + g0 + gid) * hd;
  for (int i = 0; i < n_stages; ++i) {
    const int key0 = start + i * STAGE;
    // Logits of this warp's 16 keys for the block's 8 query rows.
    const int r0 = key0 + warp * 16 + gid, r1 = r0 + 8;
    const bool in0 = r0 < end, in1 = r1 < end;
    float s[4] = {0.f, 0.f, 0.f, 0.f};
    if (key0 + warp * 16 < end) {  // warp-uniform: a warp past the range idles
      const uint8_t* k0 = kh + (size_t)(in0 ? r0 : start) * row_bytes;
      const uint8_t* k1 = kh + (size_t)(in1 ? r1 : start) * row_bytes;
#pragma unroll 4
      for (int c0 = 0; c0 < hd; c0 += 32) {  // uniform: the mma needs every lane
        const int c = c0 + 8 * tig;          // past hd: zeros
        uint4 ka, kb;
        if constexpr (CA::QUANT) {
          ka = load8_codes<NBITS>(k0, c, hd, in0);
          kb = load8_codes<NBITS>(k1, c, hd, in1);
        } else {
          ka = load8_bf16<PIECE>(reinterpret_cast<const bf16*>(k0), c, hd, in0);
          kb = load8_bf16<PIECE>(reinterpret_cast<const bf16*>(k1), c, hd, in1);
        }
        const uint4 qv = load8_bf16<CA::QUANT ? 16 : PIECE>(q_row, c, hd, q_real);
        mma16816(s, ka.x, kb.x, ka.y, kb.y, qv.x, qv.y);
        mma16816(s, ka.z, kb.z, ka.w, kb.w, qv.z, qv.w);
      }
    }
    // s: keys r0 (0, 1) and r1 (2, 3); query rows 2 tig, 2 tig + 1.
    float t[4];
    if constexpr (CA::QUANT) {
      float k_s0 = 0.f, k_z0 = 0.f, k_s1 = 0.f, k_z1 = 0.f;
      if (in0) {
        const uint2 w = __ldg(reinterpret_cast<const uint2*>(sch + (size_t)r0 * 4));
        k_s0 = bf16_lo(w.x); k_z0 = bf16_hi(w.x);
        if (tig == 0) { sVS[warp * 16 + gid] = bf16_lo(w.y); sVZ[warp * 16 + gid] = bf16_hi(w.y); }
      } else if (tig == 0) {
        sVS[warp * 16 + gid] = 0.f; sVZ[warp * 16 + gid] = 0.f;
      }
      if (in1) {
        const uint2 w = __ldg(reinterpret_cast<const uint2*>(sch + (size_t)r1 * 4));
        k_s1 = bf16_lo(w.x); k_z1 = bf16_hi(w.x);
        if (tig == 0) {
          sVS[warp * 16 + gid + 8] = bf16_lo(w.y);
          sVZ[warp * 16 + gid + 8] = bf16_hi(w.y);
        }
      } else if (tig == 0) {
        sVS[warp * 16 + gid + 8] = 0.f; sVZ[warp * 16 + gid + 8] = 0.f;
      }
      const int qa = min(2 * tig, 7), qc = min(2 * tig + 1, 7);
      const float qs0 = 2 * tig < GB ? sQsum[qa] : 0.f;
      const float qs1 = 2 * tig + 1 < GB ? sQsum[qc] : 0.f;
      t[0] = in0 ? (k_s0 * s[0] + k_z0 * qs0) * sl2 : NEG_INF;
      t[1] = in0 ? (k_s0 * s[1] + k_z0 * qs1) * sl2 : NEG_INF;
      t[2] = in1 ? (k_s1 * s[2] + k_z1 * qs0) * sl2 : NEG_INF;
      t[3] = in1 ? (k_s1 * s[3] + k_z1 * qs1) * sl2 : NEG_INF;
    } else {
      t[0] = in0 ? s[0] * sl2 : NEG_INF;
      t[1] = in0 ? s[1] * sl2 : NEG_INF;
      t[2] = in1 ? s[2] * sl2 : NEG_INF;
      t[3] = in1 ? s[3] * sl2 : NEG_INF;
    }
    {
      float* row = sP + (warp * 16 + gid) * 8 + 2 * tig;
      row[0] = t[0];
      row[1] = t[1];
      row[64] = t[2];  // key + 8: 8 rows of 8 further on
      row[65] = t[3];
    }
    __syncthreads();

    // One online-softmax step per query row: warp w takes rows w and w + 4,
    // lane l keys l and l + 32 of the stage.
    for (int g = warp; g < GB; g += THREADS / 32) {
      const float m_old = stM[g];
      const float x0 = sP[lane * 8 + g], x1 = sP[(lane + 32) * 8 + g];
      float mx = fmaxf(x0, x1);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, off));
      const float mn = fmaxf(m_old, mx);
      const float alpha = mn == NEG_INF ? 1.f : exp2f(m_old - mn);
      const float p0 = x0 == NEG_INF ? 0.f : exp2f(x0 - mn);
      const float p1 = x1 == NEG_INF ? 0.f : exp2f(x1 - mn);
      float ps = p0 + p1;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) ps += __shfl_xor_sync(FULL, ps, off);
      if (lane == 0) {  // every lane has read the row's state (the shuffles)
        stL[g] = stL[g] * alpha + ps;
        stM[g] = mn;
      }
      if constexpr (CA::QUANT) {
        float pz = p0 * sVZ[lane] + p1 * sVZ[lane + 32];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) pz += __shfl_xor_sync(FULL, pz, off);
        if (lane == 0) stZ[g] = stZ[g] * alpha + pz;
        sP[lane * 8 + g] = p0 * sVS[lane];
        sP[(lane + 32) * 8 + g] = p1 * sVS[lane + 32];
      } else {
        sP[lane * 8 + g] = p0;
        sP[(lane + 32) * 8 + g] = p1;
      }
      if (lane == 0) sA[g] = alpha;
    }
    // The next stage's V slice into the other ring slot, whose last reader
    // (this CTA's previous PV) finished before the barrier above.
    if (i + 1 < n_stages) load_v(i + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();

    // O += P V (codes: W = p v_scale times the codes), channel pair 2 tid.
    if (2 * tid < v_bytes * 8 / NBITS) {
      const uint8_t* vs = sV + (i & 1) * STAGE * V_LD;
#pragma unroll
      for (int g = 0; g < GB; ++g) {
        o[g][0] *= sA[g];
        o[g][1] *= sA[g];
      }
      const int nk = min(STAGE, end - key0);
      for (int kk = 0; kk < nk; ++kk) {
        float v0, v1;
        if constexpr (NBITS == 16) {
          const float2 x = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(vs + kk * V_LD + 4 * tid));
          v0 = x.x; v1 = x.y;
        } else if constexpr (NBITS == 8) {
          const uint32_t w = *reinterpret_cast<const uint16_t*>(vs + kk * V_LD + 2 * tid);
          v0 = (float)(w & 0xFF); v1 = (float)(w >> 8);
        } else {
          const uint32_t w = vs[kk * V_LD + tid];
          v0 = (float)(w & 0xF); v1 = (float)(w >> 4);
        }
        const float* pk = sP + kk * 8;  // the stage's probabilities of key kk (broadcast)
#pragma unroll
        for (int g = 0; g < GB; ++g) {
          o[g][0] = fmaf(pk[g], v0, o[g][0]);
          o[g][1] = fmaf(pk[g], v1, o[g][1]);
        }
      }
    }
    __syncthreads();  // sP and this ring slot are read: the next stage may write
  }
  cp_async_wait<0>();

  // This CTA's partial: (m, l) of each row, acc by every thread.
  if (tid < GB) {
    sM[tid] = stL[tid] > 0.f ? stM[tid] * LN2 : NEG_INF;
    sL[tid] = stL[tid];
  }
  __syncthreads();
  const size_t grp = (((size_t)h * p.QB + qb) * p.n_slice + slice) * p.n_split;
  const size_t pbase = (grp + sp) * GB;
  if (2 * tid < DV) {
#pragma unroll
    for (int g = 0; g < GB; ++g) {
      const float z = CA::QUANT ? stZ[g] : 0.f;
      *reinterpret_cast<float2*>(p.part_acc + (pbase + g) * DV + 2 * tid) =
          make_float2(o[g][0] + z, o[g][1] + z);
    }
  }
  if (tid < GB)
    *reinterpret_cast<float2*>(p.part_ml + (pbase + tid) * 2) = make_float2(sM[tid], sL[tid]);

  // Arrive; the last of the group's n_split CTAs merges.
  __threadfence();
  __syncthreads();
  const int cidx = (h * p.QB + qb) * p.n_slice + slice;
  if (tid == 0) sm_last = p.n_split == 1 || atomicAdd(p.counters + cidx, 1) == p.n_split - 1;
  __syncthreads();
  if (!sm_last) return;
  __threadfence();
  merge_slice<NBITS, GB>(p, h, qb, slice, sNew);
  // Slot L read again: nothing keeps it live across the key loop.
  if (qb == 0 && slice == 0) append_token<NBITS>(p, h, min(p.lengths[h], C - 1));
  if (tid == 0) p.counters[cidx] = 0;
}

template <int NBITS, int PIECE, int GB>
int launch(const Params& p, int H, cudaStream_t st) {
  constexpr int SMEM = 2 * STAGE * Cache<NBITS>::V_LD + (STAGE * 8 + 2 * STAGE) * 4;
  static bool configured[64] = {false};  // once per instantiation and device
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  if (!configured[dev]) {
    cudaError_t err = cudaFuncSetAttribute(decode_wide_kernel<NBITS, PIECE, GB>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (err != cudaSuccess) return (int)err;
    configured[dev] = true;
  }
  decode_wide_kernel<NBITS, PIECE, GB>
      <<<dim3(H, p.n_split, p.QB * p.n_slice), THREADS, SMEM, st>>>(p);
  return (int)cudaGetLastError();
}

template <int NBITS, int PIECE>
int dispatch(const Params& p, int H, cudaStream_t st) {
  switch (p.G < 8 ? p.G : 8) {  // G above 8 runs blocks of 8
    case 1: return launch<NBITS, PIECE, 1>(p, H, st);
    case 2: return launch<NBITS, PIECE, 2>(p, H, st);
    case 3: return launch<NBITS, PIECE, 3>(p, H, st);
    case 4: return launch<NBITS, PIECE, 4>(p, H, st);
    case 5: return launch<NBITS, PIECE, 5>(p, H, st);
    case 6: return launch<NBITS, PIECE, 6>(p, H, st);
    case 7: return launch<NBITS, PIECE, 7>(p, H, st);
    case 8: return launch<NBITS, PIECE, 8>(p, H, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

Params make_params(const void* q, void* k_cache, void* v_cache, void* scales,
                   const void* lengths, const void* lower, const void* k_new,
                   const void* v_new, void* out, void* part, void* counters, int H, int G,
                   int C, int n_split, int n_slice, int hd, float scale) {
  const int GB = G < 8 ? G : 8, QB = (G + 7) / 8;
  Params p;
  p.q = static_cast<const bf16*>(q);
  p.kc = static_cast<uint8_t*>(k_cache);
  p.vc = static_cast<uint8_t*>(v_cache);
  p.sc = static_cast<bf16*>(scales);
  p.lengths = static_cast<const int*>(lengths);
  p.lower = static_cast<const int*>(lower);
  p.k_new = static_cast<const bf16*>(k_new);
  p.v_new = static_cast<const bf16*>(v_new);
  p.out = static_cast<bf16*>(out);
  p.part_acc = static_cast<float*>(part);
  p.part_ml = p.part_acc + (size_t)H * QB * n_slice * n_split * GB * DV;
  p.counters = static_cast<int*>(counters);
  p.C = C;
  p.n_split = n_split;
  p.n_slice = n_slice;
  p.G = G;
  p.QB = QB;
  p.hd = hd;
  p.scale = scale;
  return p;
}

bool valid(int H, int G, int C, int n_split, int n_slice, int hd) {
  return H >= 1 && G >= 1 && C >= 1 && n_split >= 1 && hd >= 2 && hd % 2 == 0 &&
         n_slice == (hd + DV - 1) / DV && (long long)((G + 7) / 8) * n_slice <= 65535 &&
         n_split <= 65535 && (long long)C * n_split < (1LL << 32);
}

}  // namespace

#ifndef KVCF_WIDE_QUANT
// K2 at any even head_dim hd, in n_slice = ceil(hd / 256) column slices; the
// scratch holds H ceil(G / 8) n_slice n_split min(G, 8) (256 + 2) floats.
extern "C" int kvcf_decode_attn_append_wide(
    const void* q, void* k_cache, void* v_cache, const void* lengths, const void* lower,
    const void* k_new, const void* v_new, void* out, void* part, void* counters, int H, int G,
    int C, int n_split, int n_slice, int hd, float scale, void* stream) {
  if (!valid(H, G, C, n_split, n_slice, hd)) return (int)cudaErrorInvalidValue;
  const Params p = make_params(q, k_cache, v_cache, nullptr, lengths, lower, k_new, v_new,
                               out, part, counters, H, G, C, n_split, n_slice, hd, scale);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (hd % 8 == 0) return dispatch<16, 16>(p, H, st);
  if (hd % 4 == 0) return dispatch<16, 8>(p, H, st);
  return dispatch<16, 4>(p, H, st);
}
#else
// K3 (nbits 8) and K4 (nbits 4) at any head_dim hd % 128 == 0, in n_slice
// column slices, with the same scratch as K2's.
#define KVCF_QUANT_WIDE(NB)                                                               \
  extern "C" int kvcf_quant##NB##_decode_attn_append_wide(                                \
      const void* q, void* k_codes, void* v_codes, void* scales, const void* lengths,     \
      const void* lower, const void* k_new, const void* v_new, void* out, void* part,     \
      void* counters, int H, int G, int C, int n_split, int n_slice, int hd, float scale, \
      void* stream) {                                                                     \
    if (!valid(H, G, C, n_split, n_slice, hd) || hd % 128 != 0)                           \
      return (int)cudaErrorInvalidValue;                                                  \
    const Params p = make_params(q, k_codes, v_codes, scales, lengths, lower, k_new,      \
                                 v_new, out, part, counters, H, G, C, n_split, n_slice,   \
                                 hd, scale);                                              \
    return dispatch<NB, 16>(p, H, static_cast<cudaStream_t>(stream));                     \
  }
KVCF_QUANT_WIDE(8)
KVCF_QUANT_WIDE(4)
#endif
