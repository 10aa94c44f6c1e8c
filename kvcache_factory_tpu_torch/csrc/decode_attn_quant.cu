// K3 and K4: one-token decode attention over one layer of a per-token
// quantized KV cache (K3 int8, K4 int4), with the dequantization folded into
// the dot products and the new token quantized and appended in place, for
// Hopper (sm_90a).
//
// Replace the Pallas TPU kernels
//   kvcache_factory_tpu/ops/kernels/decode_attn_quant.py::_quant_decode_kernel   (K3)
//   kvcache_factory_tpu/ops/kernels/decode_attn_quant.py::_quant4_decode_kernel  (K4)
//
// Cache layout (kvcache_factory_tpu_torch/cache/quant_cache.py), per head h:
//   codes  [C, D] uint8 (int8), or [C, D/2] uint8 (int4: channel 2i in the low
//          nibble of byte i, channel 2i+1 in the high nibble);
//   scales [C, 4] bf16: (k_scale, k_zero, v_scale, v_zero) of each token;
//   a value is code * scale + zero, with the stored bf16 scale and zero.
//
// What it computes, per cache head h (q holds G query rows per head):
//   L = min(lengths[h], C - 1)            (a full cache overwrites slot C-1)
//   keys read: lower[h] <= idx < L        (slot L is never read from memory)
//   s_j = (q / sqrt(D)) . k_j = ks_j * (q' . c_j) + kz_j * sum(q')
//   out = softmax over those keys plus the new token, whose logit and value
//         come from k_new / v_new in fp32: sum_j p_j (vs_j c_j + vz_j) + p_new v_new;
//         fp32 softmax.
//   Then the new token is quantized per token, as the plain version does:
//   min and max over D, scale = max(max - min, 1e-8) / 255 (or / 15) with
//   IEEE division, codes rintf((x - min) / scale) clamped to [0, 255] (or
//   [0, 15]); its codes and four bf16 scalars are written into slot L.
// The caller advances lengths to min(lengths + 1, C).  Any capacity C > 0.
//
// What bounds it: reading the valid codes and scalars, per valid token-head
// 2 * D bytes of codes (int8) or D (int4) plus 8 bytes of scalars.  At the
// main path's 64 cache heads with 115,520 valid token-heads a layer that is
// 30.5 MB (9.1 us at 3.35 TB/s) for int8 and 15.7 MB (4.7 us) for int4.  The
// arithmetic is about 2 FLOP per code byte (int8) or 4 (int4), far below the
// card's ratio of operations to bytes, so bytes bound it; but an int4 byte
// holds two codes, so the instructions spent per code compete with them: in
// K4 turning codes into bf16 is 45% of the key loop's instructions.
//
// K3 (quant_split_kernel / quant_combine_kernel, NBITS 8; the templates keep
// their NBITS parameter until K3's own redesign): flash-decoding, as K2 was
// first built.  Few heads against 132 SMs, so the C axis is split over
// n_split CTAs per head.  Each lane loads 16 bytes of a code row at a time
// (16 int8 codes): 8 neighbouring lanes cover a row, so 16 rows are in
// flight per CTA step and 64 rows per loop iteration.  Codes become floats
// in registers; K's scale and zero apply to the reduced dot (s = ks * dot +
// kz * sum(q)) and V's zero is summed apart (acc += (p * vs) * c, z += p *
// vz), so each code costs one FMA and no dequantized row is formed.  Each
// key stream keeps an fp32 online softmax; the streams of a warp merge by
// shuffles, the 4 warps in shared memory, and each CTA writes an fp32
// partial (m, l, acc).  A combine kernel, one CTA per head, merges the
// partials, folds in the new token, writes out, and only then quantizes the
// new token and writes it into slot L: the write comes in a later launch
// than every read, so nothing races.
//
// K4 (k4::quant4_decode_kernel), K2's scheme (decode_attn.cu) for int4 codes:
//  1. One launch per call, grid (H, n_split); n_split comes from the shapes
//     and the SM count only (decode_attn.split_count: two CTAs an SM in one
//     wave, as K2).  Three fit (51 KB of shared memory, at most 170
//     registers), so the wave never waits on a slot; filling all three
//     with more splits was slower (more merge work).  CTA (h, sp)
//     takes the sp-th of n_split near-equal parts of its head's valid keys
//     [lower, L) (decode_attn.split_bounds), writes its partial (acc[G][D],
//     m, l) in fp32 and raises the head's arrival counter (K2's per-device
//     workspace) by a device-scope release after a CTA barrier; an empty
//     part still writes a partial and arrives.  The CTA that arrives last
//     copies every partial into shared memory at once (cp.async, one round
//     trip) and merges them in split order, so two launches are bitwise
//     equal; it folds in the new token, writes out and resets the counter to
//     0, so a replayed CUDA graph finds the counters at 0.  CTA 0 of each
//     head quantizes the new token into slot L at its start: no CTA reads
//     slot L, so the append needs no ordering.  The small reads (q, k_new,
//     v_new) go out before the lengths, and the new token's logit is taken
//     then, so the merge's only loads are the partials.
//  2. Each of the 4 warps streams 2 tiles of 16 keys a stage with cp.async
//     (2 KB of K codes, 2 KB of V codes, 256 B of scalars; rows past the
//     range zero-filled) into its own 3-stage ring: 12.75 KB a warp, 51 KB a
//     CTA.  Two stages in flight are 34 KB a CTA, 102 KB an SM at three
//     CTAs, as much as K2's 128 KB within a quarter.  The warps' tiles
//     interleave (tile t of warp w starts at key 64 t + 16 w of the stage),
//     so a short last stage spreads over the warps.  A warp waits only for
//     its own copies: no CTA barrier in the loop.  cp.async, not TMA bulk
//     copies: a token's 8 bytes of scalars start on an 8-byte boundary,
//     which a bulk copy does not take, and the V swizzle below needs the
//     per-chunk placement.  Four tiles a stage at two CTAs an SM, four
//     stages, or four CTAs an SM were no faster (PERF.md, K4's findings).
//  3. No conversion instruction per code.  A code word holds 8 nibbles;
//     shifted by 0, 4, 8 or 12 bits and put through one LOP3 ((x &
//     0x000f000f) | 0x43004300, bf16 128.0 twice) it gives two bf16 values
//     128 + n, exactly.  Both products run on the tensor cores with
//     mma.sync m16n8k16, keys as M and the G query rows as N = 8 (so G 1-8
//     need no padding):
//       S^T [16 keys, 8] = K [16, D] . q^T: a lane's A registers hold
//         channels (c, c + 4), (c + 1, c + 5), ... of one key, so q^T's B
//         fragment is built with the same channel permutation; the offset
//         comes out once per score as dot - 128 sum(q).
//       O^T [D, 8] += V^T [D, 16 keys] . W^T: V^T's A registers pair one
//         channel of two keys; byte_perm lays two keys' bytes side by side
//         before the LOP3, and an exact bf16 subtraction removes the offset
//         (folding it into the sum instead would leave a cancellation of
//         128 sum(w) against the output that the 3e-3 limit cannot carry).
//         W = p * v_scale enters as bf16 hi + lo (2^-17 relative), as in K2:
//         bf16 alone would put the worst head near the 3e-3 tolerance.  The
//         zero points add sum_j p_j vz_j to every channel, kept per column.
//     The SASS holds no I2F/I2FP for codes: the only int-to-float
//     instructions are the reciprocal steps (I2F.*.RP) of the split rule's
//     integer divisions, outside the key loop.  K's codes are read with one
//     16-byte shared load per key row and lane, V's with 8-byte loads whose
//     rows are swizzled (16-byte chunk c of row r at c ^ 2 ((r >> 2) & 1)) so
//     that no two lanes of a half-warp meet in a bank.
//  4. One softmax rescale per stage, and only when a column's max rose: the
//     stage's max per column (three shuffles), ex2.approx with log2(e) /
//     sqrt(D) folded into each key's scale; partials leave in natural-log
//     units.  Masked logits are NEG_INF (-FLT_MAX), never -inf; every tile
//     of a stage that holds one of the warp's keys is computed (a tile past
//     the range is zero-filled and masked), k-chunks outer and tiles inner,
//     so neighbouring mma are independent.
// Built without --use_fast_math, so the divisions of the append are IEEE,
// as in PyTorch and XLA.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int D = 128;             // head_dim (the wrapper checks)
constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int ROWS_PER_ITER = 64;  // key rows loaded per loop iteration
constexpr unsigned FULL = 0xffffffffu;
constexpr float NEG_INF = -3.4028234663852886e38f;  // float32 finfo.min

template <int NBITS>
struct Layout {
  static constexpr int ROW_BYTES = D * NBITS / 8;         // 128 or 64
  static constexpr int LANES = ROW_BYTES / 16;            // lanes per row: 8 or 4
  static constexpr int CPL = D / LANES;                   // channels per lane: 16 or 32
  static constexpr int STREAMS = THREADS / LANES;         // rows per step: 16 or 32
  static constexpr int UNROLL = ROWS_PER_ITER / STREAMS;  // 4 or 2
  static constexpr float QMAX = NBITS == 8 ? 255.f : 15.f;
};

__device__ __forceinline__ void unpack8(const uint4& raw, float f[8]) {
  const bf16* p = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
  for (int i = 0; i < 8; ++i) f[i] = __bfloat162float(p[i]);
}

// 16 bytes of a code row -> the CPL codes they hold, in channel order.
template <int NBITS>
__device__ __forceinline__ void unpack_codes(const uint4& raw, float f[Layout<NBITS>::CPL]) {
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if constexpr (NBITS == 8) {
#pragma unroll
      for (int b = 0; b < 4; ++b) f[i * 4 + b] = (float)((w[i] >> (8 * b)) & 0xffu);
    } else {  // nibble b of word i is channel 8i + b (low nibble first)
#pragma unroll
      for (int b = 0; b < 8; ++b) f[i * 8 + b] = (float)((w[i] >> (4 * b)) & 0xfu);
    }
  }
}

template <int NBITS, int G>
__global__ void __launch_bounds__(THREADS)
quant_split_kernel(const bf16* __restrict__ q, const uint8_t* __restrict__ kc,
                   const uint8_t* __restrict__ vc, const bf16* __restrict__ sc,
                   const int* __restrict__ lengths, const int* __restrict__ lower,
                   float* __restrict__ part_acc, float* __restrict__ part_ml,
                   int C, int n_split, int chunk, float scale) {
  using Lay = Layout<NBITS>;
  constexpr int LANES = Lay::LANES, CPL = Lay::CPL, STREAMS = Lay::STREAMS;
  constexpr int UNROLL = Lay::UNROLL, ROW_BYTES = Lay::ROW_BYTES;
  __shared__ float sm_m[WARPS][G], sm_l[WARPS][G];
  __shared__ float sm_acc[WARPS][G][D];

  const int h = blockIdx.x, sp = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rl = lane % LANES;     // which 16 bytes of a row this lane loads
  const int stream = tid / LANES;  // which row of a step its lane group reads
  const int c0 = rl * CPL;         // the first channel those bytes hold
  const int L = min(lengths[h], C - 1);
  const int lo = lower ? lower[h] : 0;
  const int start = max(sp * chunk, lo);
  const int end = min(sp * chunk + chunk, L);

  // q scaled by 1/sqrt(D) once, for this lane's channels, and its sum over
  // all D channels (the zero-point term of every logit).
  float qv[G][CPL], qsum[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < CPL; i += 8) {
      float f[8];
      unpack8(*reinterpret_cast<const uint4*>(q + ((size_t)h * G + g) * D + c0 + i), f);
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        qv[g][i + k] = f[k] * scale;
        s += qv[g][i + k];
      }
    }
#pragma unroll
    for (int off = LANES / 2; off > 0; off >>= 1) s += __shfl_xor_sync(FULL, s, off);
    qsum[g] = s;
  }

  float m[G], l[G], z[G], acc[G][CPL];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = NEG_INF;
    l[g] = 0.f;
    z[g] = 0.f;
#pragma unroll
    for (int i = 0; i < CPL; ++i) acc[g][i] = 0.f;
  }

  const uint8_t* kh = kc + (size_t)h * C * ROW_BYTES + rl * 16;
  const uint8_t* vh = vc + (size_t)h * C * ROW_BYTES + rl * 16;
  const uint2* sh = reinterpret_cast<const uint2*>(sc) + (size_t)h * C;  // 4 bf16 per token
  // Warp-uniform loop: every lane runs every step, so the shuffles below
  // always have all 32 lanes; rows past `end` are loaded by no one and
  // skipped in the update.
  for (int base = start; base < end; base += ROWS_PER_ITER) {
    uint4 kr[UNROLL], vr[UNROLL];
    uint2 sr[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int j = base + u * STREAMS + stream;
      kr[u] = vr[u] = make_uint4(0, 0, 0, 0);
      sr[u] = make_uint2(0, 0);
      if (j < end) {
        kr[u] = *reinterpret_cast<const uint4*>(kh + (size_t)j * ROW_BYTES);
        vr[u] = *reinterpret_cast<const uint4*>(vh + (size_t)j * ROW_BYTES);
        sr[u] = sh[j];
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const bool valid = base + u * STREAMS + stream < end;
      const bf16* s4 = reinterpret_cast<const bf16*>(&sr[u]);
      const float ks = __bfloat162float(s4[0]), kz = __bfloat162float(s4[1]);
      const float vs = __bfloat162float(s4[2]), vz = __bfloat162float(s4[3]);
      float kf[CPL], vf[CPL];
      unpack_codes<NBITS>(kr[u], kf);
      unpack_codes<NBITS>(vr[u], vf);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float dot = 0.f;
#pragma unroll
        for (int i = 0; i < CPL; ++i) dot = fmaf(qv[g][i], kf[i], dot);
#pragma unroll
        for (int off = LANES / 2; off > 0; off >>= 1) dot += __shfl_xor_sync(FULL, dot, off);
        if (valid) {
          const float s = fmaf(ks, dot, kz * qsum[g]);
          const float mn = fmaxf(m[g], s);
          const float alpha = expf(m[g] - mn);
          const float p = expf(s - mn);
          const float w = p * vs;
          l[g] = l[g] * alpha + p;
#pragma unroll
          for (int i = 0; i < CPL; ++i) acc[g][i] = fmaf(w, vf[i], acc[g][i] * alpha);
          z[g] = fmaf(p, vz, z[g] * alpha);
          m[g] = mn;
        }
      }
    }
  }

  // Fold the zero-point sum in, then merge the streams of this warp: lanes
  // that differ only in the bits above the lane-in-row bits.
#pragma unroll
  for (int g = 0; g < G; ++g) {
#pragma unroll
    for (int i = 0; i < CPL; ++i) acc[g][i] += z[g];
  }
#pragma unroll
  for (int off = LANES; off < 32; off <<= 1) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float mo = __shfl_xor_sync(FULL, m[g], off);
      const float lother = __shfl_xor_sync(FULL, l[g], off);
      const float mn = fmaxf(m[g], mo);
      const float a = expf(m[g] - mn), b = expf(mo - mn);
      l[g] = l[g] * a + lother * b;
#pragma unroll
      for (int i = 0; i < CPL; ++i)
        acc[g][i] = acc[g][i] * a + __shfl_xor_sync(FULL, acc[g][i], off) * b;
      m[g] = mn;
    }
  }
  if (lane < LANES) {  // the warp's first lane group holds its merge
#pragma unroll
    for (int g = 0; g < G; ++g) {
#pragma unroll
      for (int i = 0; i < CPL; ++i) sm_acc[warp][g][c0 + i] = acc[g][i];
      if (lane == 0) { sm_m[warp][g] = m[g]; sm_l[warp][g] = l[g]; }
    }
  }
  __syncthreads();

  const int d = tid;  // 128 threads, one per channel
  for (int g = 0; g < G; ++g) {
    float M = NEG_INF;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) M = fmaxf(M, sm_m[w][g]);
    float Ls = 0.f, A = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float e = expf(sm_m[w][g] - M);
      Ls += sm_l[w][g] * e;
      A += sm_acc[w][g][d] * e;
    }
    const size_t pi = ((size_t)h * n_split + sp) * G + g;
    part_acc[pi * D + d] = A;
    if (d == 0) { part_ml[pi * 2] = M; part_ml[pi * 2 + 1] = Ls; }
  }
}

template <int NBITS, int G>
__global__ void __launch_bounds__(THREADS)
quant_combine_kernel(const bf16* __restrict__ q, uint8_t* __restrict__ kc,
                     uint8_t* __restrict__ vc, bf16* __restrict__ sc,
                     const int* __restrict__ lengths, const bf16* __restrict__ k_new,
                     const bf16* __restrict__ v_new, const float* __restrict__ part_acc,
                     const float* __restrict__ part_ml, bf16* __restrict__ out,
                     int C, int n_split, float scale) {
  using Lay = Layout<NBITS>;
  __shared__ float red[WARPS];
  __shared__ float ext[WARPS][4];
  const int h = blockIdx.x, d = threadIdx.x, lane = d & 31, warp = d >> 5;
  const int L = min(lengths[h], C - 1);
  const float kn = __bfloat162float(k_new[(size_t)h * D + d]);
  const float vn = __bfloat162float(v_new[(size_t)h * D + d]);

  for (int g = 0; g < G; ++g) {
    float prod = __bfloat162float(q[((size_t)h * G + g) * D + d]) * scale * kn;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) prod += __shfl_xor_sync(FULL, prod, off);
    if (lane == 0) red[warp] = prod;
    __syncthreads();
    const float s_new = red[0] + red[1] + red[2] + red[3];
    __syncthreads();  // red is rewritten for the next g

    float M = NEG_INF;
    for (int s = 0; s < n_split; ++s)
      M = fmaxf(M, part_ml[(((size_t)h * n_split + s) * G + g) * 2]);
    float Ls = 0.f, A = 0.f;
    for (int s = 0; s < n_split; ++s) {
      const size_t pi = ((size_t)h * n_split + s) * G + g;
      const float w = expf(part_ml[pi * 2] - M);
      Ls += part_ml[pi * 2 + 1] * w;
      A += part_acc[pi * D + d] * w;
    }
    const float m_f = fmaxf(M, s_new);
    const float alpha = expf(M - m_f);
    const float p_new = expf(s_new - m_f);
    const float l_f = Ls * alpha + p_new;
    const float acc_f = A * alpha + p_new * vn;
    out[((size_t)h * G + g) * D + d] = __float2bfloat16(acc_f / l_f);
  }

  // Quantize the new token: min and max of k_new and v_new over D (a warp
  // reduction, then across the 4 warps), then the per-token affine.
  float kmn = kn, kmx = kn, vmn = vn, vmx = vn;
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
  for (int w = 0; w < WARPS; ++w) {
    kmn = fminf(kmn, ext[w][0]); kmx = fmaxf(kmx, ext[w][1]);
    vmn = fminf(vmn, ext[w][2]); vmx = fmaxf(vmx, ext[w][3]);
  }
  const float ks = fmaxf(kmx - kmn, 1e-8f) / Lay::QMAX;
  const float vs = fmaxf(vmx - vmn, 1e-8f) / Lay::QMAX;
  // rintf rounds half to even, as torch.round and jnp.round do.
  const int kq = (int)fminf(fmaxf(rintf((kn - kmn) / ks), 0.f), Lay::QMAX);
  const int vq = (int)fminf(fmaxf(rintf((vn - vmn) / vs), 0.f), Lay::QMAX);
  const size_t row = (size_t)h * C + L;
  if constexpr (NBITS == 8) {
    kc[row * D + d] = (uint8_t)kq;
    vc[row * D + d] = (uint8_t)vq;
  } else {  // even channel d takes the low nibble, d + 1 the high one
    const int kq_hi = __shfl_down_sync(FULL, kq, 1);
    const int vq_hi = __shfl_down_sync(FULL, vq, 1);
    if ((d & 1) == 0) {
      kc[row * (D / 2) + d / 2] = (uint8_t)(kq | (kq_hi << 4));
      vc[row * (D / 2) + d / 2] = (uint8_t)(vq | (vq_hi << 4));
    }
  }
  if (d == 0) {
    bf16* s4 = sc + row * 4;
    s4[0] = __float2bfloat16(ks);
    s4[1] = __float2bfloat16(kmn);
    s4[2] = __float2bfloat16(vs);
    s4[3] = __float2bfloat16(vmn);
  }
}

template <int NBITS, int G>
int launch(const void* q, void* kc, void* vc, void* sc, const void* lengths,
           const void* lower, const void* k_new, const void* v_new, void* out,
           void* part_acc, void* part_ml, int H, int C, int n_split, int chunk,
           float scale, cudaStream_t st) {
  quant_split_kernel<NBITS, G><<<dim3(H, n_split), THREADS, 0, st>>>(
      static_cast<const bf16*>(q), static_cast<const uint8_t*>(kc),
      static_cast<const uint8_t*>(vc), static_cast<const bf16*>(sc),
      static_cast<const int*>(lengths), static_cast<const int*>(lower),
      static_cast<float*>(part_acc), static_cast<float*>(part_ml), C, n_split, chunk,
      scale);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  quant_combine_kernel<NBITS, G><<<H, THREADS, 0, st>>>(
      static_cast<const bf16*>(q), static_cast<uint8_t*>(kc), static_cast<uint8_t*>(vc),
      static_cast<bf16*>(sc), static_cast<const int*>(lengths),
      static_cast<const bf16*>(k_new), static_cast<const bf16*>(v_new),
      static_cast<const float*>(part_acc), static_cast<const float*>(part_ml),
      static_cast<bf16*>(out), C, n_split, scale);
  return (int)cudaGetLastError();
}

template <int NBITS>
int dispatch(const void* q, void* kc, void* vc, void* sc, const void* lengths,
             const void* lower, const void* k_new, const void* v_new, void* out,
             void* part_acc, void* part_ml, int H, int G, int C, int n_split, int chunk,
             float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (G) {
    case 1: return launch<NBITS, 1>(q, kc, vc, sc, lengths, lower, k_new, v_new, out,
                                    part_acc, part_ml, H, C, n_split, chunk, scale, st);
    case 2: return launch<NBITS, 2>(q, kc, vc, sc, lengths, lower, k_new, v_new, out,
                                    part_acc, part_ml, H, C, n_split, chunk, scale, st);
    case 4: return launch<NBITS, 4>(q, kc, vc, sc, lengths, lower, k_new, v_new, out,
                                    part_acc, part_ml, H, C, n_split, chunk, scale, st);
    case 8: return launch<NBITS, 8>(q, kc, vc, sc, lengths, lower, k_new, v_new, out,
                                    part_acc, part_ml, H, C, n_split, chunk, scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int kvcf_quant8_decode_attn_append(
    const void* q, void* k_codes, void* v_codes, void* scales, const void* lengths,
    const void* lower, const void* k_new, const void* v_new, void* out, void* part_acc,
    void* part_ml, int H, int G, int C, int n_split, int chunk, float scale, void* stream) {
  return dispatch<8>(q, k_codes, v_codes, scales, lengths, lower, k_new, v_new, out,
                     part_acc, part_ml, H, G, C, n_split, chunk, scale, stream);
}

// ---------------------------------------------------------------------------
// K4: the int4 kernel, one launch per call (design in the header above).
// ---------------------------------------------------------------------------

namespace {
namespace k4 {

constexpr int TILE = 16;                          // keys of one mma tile: its M
constexpr int TILES = 2;                          // tiles a warp a stage
constexpr int WARP_KEYS = TILES * TILE;           // 32
constexpr int TILE_STRIDE = WARPS * TILE;         // keys from one of a warp's tiles to the next
constexpr int STAGE_KEYS = WARPS * WARP_KEYS;     // 128 keys a CTA a stage
constexpr int STAGES = 3;
constexpr int CTAS_PER_SM = 3;  // CTAs an SM can hold (launch bounds: at most 170 registers)
constexpr int ROW = D / 2;                        // 64 code bytes a key
constexpr int V_OFF = WARP_KEYS * ROW;            // K codes, then V codes,
constexpr int S_OFF = 2 * WARP_KEYS * ROW;        // then the four scalars
constexpr int SLOT_BYTES = S_OFF + WARP_KEYS * 8;  // 4.25 KB
constexpr int WARP_RING = STAGES * SLOT_BYTES;     // 12.75 KB
constexpr int SMEM_BYTES = WARPS * WARP_RING;      // 51 KB
constexpr int O_STRIDE = D + 4;                    // padded row of the warp merge
constexpr int PART = D + 4;  // floats of one split's partial a query row: acc[D], m, l, 2 unused
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
// A nibble n in bits 0-3 of a bf16 whose other bits are 0x4300 (128.0) is
// 128 + n, exactly (bf16 keeps 7 mantissa bits: bits 4-7 would reach the
// exponent, so the high nibbles are shifted down first).
constexpr uint32_t NIB = 0x000f000fu, MAGIC = 0x43004300u;
constexpr float OFFSET = 128.f;
static_assert(THREADS == D, "one thread per channel in the merges");
static_assert(WARPS * 8 * O_STRIDE * 4 + 3 * WARPS * 8 * 4 <= SMEM_BYTES, "warp merge");
static_assert(SMEM_BYTES >= 8 * PART * 4, "the merge holds at least one split of G = 8");

struct Params {
  const bf16* q;        // [H, G, D]
  uint8_t* kc;          // [H, C, D/2]
  uint8_t* vc;          // [H, C, D/2]
  bf16* sc;             // [H, C, 4]
  const int* lengths;   // [H]
  const int* lower;     // [H] or null
  const bf16* k_new;    // [H, D]
  const bf16* v_new;    // [H, D]
  bf16* out;            // [H, G, D]
  float* part;          // [H, n_split, G, PART]: acc[D], m (natural log), l
  int* counters;        // [>= H], 0 between launches
  int C, n_split;
  float scale;          // 1 / sqrt(D)
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async8(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n"
               :: "r"(dst), "l"(src), "r"(src_bytes));
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

// (x & NIB) | MAGIC: the nibbles in bits 0-3 and 16-19 of x as two bf16
// values 128 + n.  One LOP3 (nvcc splits the C expression into two).
__device__ __forceinline__ uint32_t nib_bf16(uint32_t x) {
  uint32_t r;
  asm("lop3.b32 %0, %1, %2, %3, 0xea;\n" : "=r"(r) : "r"(x), "n"(NIB), "n"(MAGIC));
  return r;
}

// 2^x for x <= 0 (and NEG_INF): one MUFU.EX2 without exp2f's range fix-up.
__device__ __forceinline__ float exp2_neg(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// x - y on two bf16 lanes (exact here: (128 + n) - 128).
__device__ __forceinline__ uint32_t sub_bf16x2(uint32_t x, uint32_t y) {
  __nv_bfloat162 r = __hsub2(*reinterpret_cast<__nv_bfloat162*>(&x),
                             *reinterpret_cast<__nv_bfloat162*>(&y));
  return *reinterpret_cast<uint32_t*>(&r);
}

// Two code words of one key (8 bytes: channels c .. c + 15) and the same two
// of the next key -> the 16 bf16 pairs (this key's code, the next key's
// code) of channels c + k, k = 0..15, exact integers 0..15: per 4 pairs one
// byte_perm, three shifts, four LOP3 and four subtractions.  `lo`/`hi` are
// byte_perm selectors that put this key's bytes 0-1 (2-3) in the low half
// and the next key's in the high half, whichever of the two was loaded
// first.
__device__ __forceinline__ void v_pairs(uint2 first, uint2 second, uint32_t lo, uint32_t hi,
                                        uint32_t (&r)[16]) {
  const uint32_t f[2] = {first.x, first.y}, s[2] = {second.x, second.y};
#pragma unroll
  for (int u = 0; u < 2; ++u) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const uint32_t t = __byte_perm(f[u], s[u], half ? hi : lo);
      const int k = 8 * u + 4 * half;
#pragma unroll
      for (int b = 0; b < 4; ++b) r[k + b] = sub_bf16x2(nib_bf16(t >> (4 * b)), MAGIC);
    }
  }
}

// The last CTA of head h to arrive: merge the n_split partials in split
// order, fold in the new token, write out and reset the counter.  The
// partials come into shared memory (`buf`, the ring's bytes) by cp.async,
// as many splits at a time as fit, all in flight together: one round trip a
// chunk.  Warp w then folds query rows w and w + 4, lane l channels 4l ..
// 4l + 3: the chunk's max, one rescale, one exp per split, the exps of 32
// splits at a time on the 32 lanes.  The new token's
// logits come in `s_new` (query row g's on lane 4g of every warp) and its
// value in `vn`, both read at the start of the launch.
template <int G>
__device__ void merge_head(const Params& p, int h, float s_new_lanes, const float (&vn)[4],
                           uint8_t* buf) {
  constexpr int ROWS = (G + WARPS - 1) / WARPS;          // query rows a warp folds
  constexpr int CHUNK = SMEM_BYTES / (G * PART * 4);     // splits a round trip
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, d = lane * 4;
  const int ns = p.n_split;
  const float* part = p.part + (size_t)h * ns * G * PART;
  const float* sp_buf = reinterpret_cast<const float*>(buf);
  float M[ROWS], Ls[ROWS], a[ROWS][4];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    M[r] = NEG_INF;
    Ls[r] = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) a[r][i] = 0.f;
  }
  for (int s0 = 0; s0 < ns; s0 += CHUNK) {
    const int pieces = min(CHUNK, ns - s0) * G * PART / 4;  // 16-byte pieces
    __syncthreads();  // the ring, or the last chunk, is no longer read
    for (int i = tid; i < pieces; i += THREADS)
      cp_async16(smem_u32(buf) + i * 16, part + (size_t)s0 * G * PART + i * 4, 16);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    const int n = min(CHUNK, ns - s0);
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const int g = warp + r * WARPS;
      if (g >= G) break;
      auto ml_of = [&](int s) {  // (m, l) of split s0 + s, query row g
        return *reinterpret_cast<const float2*>(sp_buf + (s * G + g) * PART + D);
      };
      // The chunk's max over live splits (an empty one, l = 0, adds
      // nothing), the lanes taking the splits in turn.
      float mx = NEG_INF;
      for (int s = lane; s < n; s += 32) {
        const float2 ml = ml_of(s);
        if (ml.y > 0.f) mx = fmaxf(mx, ml.x);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, off));
      const float Mb = fmaxf(M[r], mx), alpha = expf(M[r] - Mb);
      Ls[r] *= alpha;
#pragma unroll
      for (int i = 0; i < 4; ++i) a[r][i] *= alpha;
      // Each lane weighs one split of every 32; the weights go round by
      // shuffles while each lane adds its 4 channels, in split order.
      float lsum = 0.f;
      for (int b = 0; b < n; b += 32) {
        float w = 0.f;
        if (b + lane < n) {
          const float2 ml = ml_of(b + lane);
          w = ml.y > 0.f ? expf(ml.x - Mb) : 0.f;
          lsum += w * ml.y;
        }
        const int cnt = min(32, n - b);
#pragma unroll 8
        for (int j = 0; j < cnt; ++j) {
          const float wj = __shfl_sync(FULL, w, j);
          const float4 x = *reinterpret_cast<const float4*>(sp_buf + ((b + j) * G + g) * PART + d);
          a[r][0] += wj * x.x;
          a[r][1] += wj * x.y;
          a[r][2] += wj * x.z;
          a[r][3] += wj * x.w;
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) lsum += __shfl_xor_sync(FULL, lsum, off);
      Ls[r] += lsum;
      M[r] = Mb;
    }
  }
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const int g = warp + r * WARPS;
    if (g >= G) break;
    const float s_new = __shfl_sync(FULL, s_new_lanes, 4 * g);
    const float m_f = fmaxf(M[r], s_new);
    const float alpha = expf(M[r] - m_f), p_new = expf(s_new - m_f);
    const float inv = 1.f / (Ls[r] * alpha + p_new);
    __align__(8) bf16 o[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) o[i] = __float2bfloat16((a[r][i] * alpha + p_new * vn[i]) * inv);
    *reinterpret_cast<uint2*>(p.out + ((size_t)h * G + g) * D + d) =
        *reinterpret_cast<const uint2*>(o);
  }
  if (tid == 0) p.counters[h] = 0;
}

// Quantize the new token (channel threadIdx.x: kn of k_new, vn of v_new) as
// the plain version does and write it into slot L: min and max over D (a
// warp reduction, then across the 4 warps), scale = max(max - min, 1e-8) /
// 15 with IEEE division, codes rintf((x - min) / scale) clamped to [0, 15]
// (rintf rounds half to even, as torch.round).  One CTA of the head does it;
// no CTA reads slot L, so it may at any time.
__device__ void append_token(const Params& p, int h, int L, float kn, float vn) {
  __shared__ float ext[WARPS][4];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float kmn = kn, kmx = kn, vmn = vn, vmx = vn;
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
  for (int w = 0; w < WARPS; ++w) {
    kmn = fminf(kmn, ext[w][0]); kmx = fmaxf(kmx, ext[w][1]);
    vmn = fminf(vmn, ext[w][2]); vmx = fmaxf(vmx, ext[w][3]);
  }
  const float ks = fmaxf(kmx - kmn, 1e-8f) / 15.f;
  const float vs = fmaxf(vmx - vmn, 1e-8f) / 15.f;
  const int kq = (int)fminf(fmaxf(rintf((kn - kmn) / ks), 0.f), 15.f);
  const int vq = (int)fminf(fmaxf(rintf((vn - vmn) / vs), 0.f), 15.f);
  // Even channel d takes the low nibble of byte d / 2, d + 1 the high one.
  const int kq_hi = __shfl_down_sync(FULL, kq, 1);
  const int vq_hi = __shfl_down_sync(FULL, vq, 1);
  const size_t row = (size_t)h * p.C + L;
  if ((tid & 1) == 0) {
    p.kc[row * ROW + tid / 2] = (uint8_t)(kq | (kq_hi << 4));
    p.vc[row * ROW + tid / 2] = (uint8_t)(vq | (vq_hi << 4));
  }
  if (tid == 0) {
    bf16* s4 = p.sc + row * 4;
    s4[0] = __float2bfloat16(ks);
    s4[1] = __float2bfloat16(kmn);
    s4[2] = __float2bfloat16(vs);
    s4[3] = __float2bfloat16(vmn);
  }
}

template <int G>
__global__ void __launch_bounds__(THREADS, CTAS_PER_SM)
quant4_decode_kernel(const Params p) {
  extern __shared__ __align__(128) uint8_t smem[];
  __shared__ int sm_last;

  const int h = blockIdx.x, sp = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int C = p.C;
  // The small reads go out before the lengths, so that they neither wait
  // for them nor queue behind the codes: this lane's 32 channels of q row
  // gid and of k_new (the new token's logit), the 4 channels of v_new the
  // merge writes, and channel tid of k_new and v_new for the append.  Then
  // the first stage's copies; the rest of the ring is issued once q is in
  // registers, so each SM's first stages are served first.
  uint4 q_raw[4], kn_raw[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    q_raw[i] = gid < G ? *reinterpret_cast<const uint4*>(
                             p.q + ((size_t)h * G + gid) * D + 32 * tig + 8 * i)
                       : make_uint4(0, 0, 0, 0);
    kn_raw[i] = *reinterpret_cast<const uint4*>(p.k_new + (size_t)h * D + 32 * tig + 8 * i);
  }
  const uint2 vn_raw = *reinterpret_cast<const uint2*>(p.v_new + (size_t)h * D + 4 * lane);
  const float kn_own = __bfloat162float(p.k_new[(size_t)h * D + tid]);
  const float vn_own = __bfloat162float(p.v_new[(size_t)h * D + tid]);
  const int L = min(p.lengths[h], C - 1);
  const int lo = p.lower ? min(max(p.lower[h], 0), L) : 0;
  // This CTA's share of [lo, L): the sp-th of n_split near-equal parts.
  const long long n = L - lo;
  const int start = lo + (int)(n * sp / p.n_split);
  const int end = lo + (int)(n * (sp + 1) / p.n_split);
  const int n_stages = (end - start + STAGE_KEYS - 1) / STAGE_KEYS;

  // Stage i holds keys start + STAGE_KEYS i + 64 t + 16 warp + r of tile t,
  // row r.  Each lane copies 16-byte chunk (lane & 3) of K and V rows
  // (lane >> 2) + 8 j, and the scalars of rows lane + 32 j; rows past the
  // range are zero-filled.  V's 16-byte chunk c of row r lands at chunk
  // c ^ (2 ((r >> 2) & 1)), so the 8-byte reads below meet no bank conflict.
  const uint32_t ring = smem_u32(smem) + warp * WARP_RING;
  const uint8_t* kh = p.kc + (size_t)h * C * ROW;
  const uint8_t* vh = p.vc + (size_t)h * C * ROW;
  const bf16* sh = p.sc + (size_t)h * C * 4;
  const int cp_chunk = lane & 3, cp_row = lane >> 2;
  auto key_of = [&](int base, int rr) {
    return base + TILE_STRIDE * (rr / TILE) + TILE * warp + rr % TILE;
  };
  auto load_stage = [&](int i) {
    const int base = start + i * STAGE_KEYS;
    if (base + TILE * warp >= end) return;  // none of this warp's keys
    const uint32_t slot = ring + (i % STAGES) * SLOT_BYTES;
#pragma unroll
    for (int j = 0; j < WARP_KEYS / 8; ++j) {
      const int rr = cp_row + 8 * j, key = key_of(base, rr);
      const bool valid = key < end;
      const size_t off = (size_t)(valid ? key : start) * ROW + cp_chunk * 16;
      const int vchunk = cp_chunk ^ (2 * ((rr >> 2) & 1));
      cp_async16(slot + rr * ROW + cp_chunk * 16, kh + off, valid ? 16 : 0);
      cp_async16(slot + V_OFF + rr * ROW + vchunk * 16, vh + off, valid ? 16 : 0);
    }
#pragma unroll
    for (int j = 0; j < WARP_KEYS / 32; ++j) {
      const int rr = lane + 32 * j, key = key_of(base, rr);
      const bool valid = key < end;
      cp_async8(slot + S_OFF + rr * 8, sh + (size_t)(valid ? key : start) * 4, valid ? 8 : 0);
    }
  };

  if (n_stages > 0) load_stage(0);
  cp_async_commit();

  // q^T as the B operand of S^T = K q^T.  Lane (gid, tig) holds query row
  // gid (zero past G) at channels 32 tig .. 32 tig + 31, the channels whose
  // codes it reads from each key.  The channels of the contraction are
  // permuted to match the A fragments the nibble unpacking gives (below):
  // k-chunk 2j + e, positions 2tig, 2tig + 1, 2tig + 8, 2tig + 9 hold
  // channels c + 2e, c + 2e + 4, c + 2e + 1, c + 2e + 5 with c = 32 tig + 8 j.
  uint32_t qf[D / 16][2];
  float qs = 0.f, s_new = 0.f;  // sum of q over the channels; q . k_new
  {
    const uint16_t* qv = reinterpret_cast<const uint16_t*>(q_raw);
    const uint16_t* kv = reinterpret_cast<const uint16_t*>(kn_raw);
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 8 * j + 2 * e;
        qf[2 * j + e][0] = qv[c] | ((uint32_t)qv[c + 4] << 16);
        qf[2 * j + e][1] = qv[c + 1] | ((uint32_t)qv[c + 5] << 16);
      }
#pragma unroll
    for (int k = 0; k < 32; ++k) {
      const float x = __bfloat162float(__ushort_as_bfloat16(qv[k]));
      qs += x;
      s_new = fmaf(x, __bfloat162float(__ushort_as_bfloat16(kv[k])), s_new);
    }
  }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    qs += __shfl_xor_sync(FULL, qs, off);
    s_new += __shfl_xor_sync(FULL, s_new, off);
  }
  s_new *= p.scale;  // query row gid's new logit, on each of its 4 lanes
#pragma unroll
  for (int i = 1; i < STAGES - 1; ++i) {
    if (i < n_stages) load_stage(i);
    cp_async_commit();
  }
  if (sp == 0) append_token(p, h, L, kn_own, vn_own);  // CTA-uniform
  // This lane's accumulator columns are query rows 2 tig and 2 tig + 1.
  const float qs0 = __shfl_sync(FULL, qs, 8 * tig), qs1 = __shfl_sync(FULL, qs, 8 * tig + 4);
  const float qo0 = OFFSET * qs0, qo1 = OFFSET * qs1;  // what the codes' offset adds to a dot
  const float sl2 = p.scale * LOG2E;  // logits in log2 units
  const float ql0 = qs0 * sl2, ql1 = qs1 * sl2;

  // V reads: rows 2 tig and 2 tig + 1 (+ 8), the odd lanes' first read the
  // odd row, 8-byte chunk gid at its swizzled place.
  const int odd = tig & 1;
  const uint32_t sel_lo = odd ? 0x1054u : 0x5410u, sel_hi = odd ? 0x3276u : 0x7632u;
  const int v_first = 2 * tig + odd, v_second = 2 * tig + 1 - odd;
  auto v_addr = [&](int r) {  // byte offset of row r's chunk gid in a tile
    return r * ROW + (((gid >> 1) ^ (2 * ((r >> 2) & 1))) << 4) + (gid & 1) * 8;
  };
  const int va0 = v_addr(v_first), vb0 = v_addr(v_second);
  const int va1 = v_addr(v_first + 8), vb1 = v_addr(v_second + 8);

  float m0 = NEG_INF, m1 = NEG_INF;  // running max (log2 units), columns 2 tig, 2 tig + 1
  float l0 = 0.f, l1 = 0.f;          // this lane's share of the sums of p
  float z0 = 0.f, z1 = 0.f;          // and of p * v_zero
  float o[D / 16][4];                // O^T: channels 16 gid + 2 mb (+1), columns 2 tig (+1)
#pragma unroll
  for (int mb = 0; mb < D / 16; ++mb)
#pragma unroll
    for (int i = 0; i < 4; ++i) o[mb][i] = 0.f;

  for (int i = 0; i < n_stages; ++i) {
    cp_async_wait<STAGES - 2>();
    __syncwarp();
    if (i + STAGES - 1 < n_stages) load_stage(i + STAGES - 1);
    cp_async_commit();
    const int base = start + i * STAGE_KEYS + TILE * warp;
    if (base >= end) continue;  // warp-uniform: none of this warp's keys
    const uint8_t* slot = smem + warp * WARP_RING + (i % STAGES) * SLOT_BYTES;

    // S^T for each tile: keys as M, the q columns as N.  A code word holds
    // channels c .. c + 7 of a key, one nibble each; the word shifted by 0,
    // 4, 8 and 12 bits, masked and ORed under the magic exponent, gives the
    // bf16 pairs 128 + n of channels (c, c + 4), (c + 1, c + 5), (c + 2,
    // c + 6), (c + 3, c + 7): the A operand, with no conversion instruction.
    // Every tile is computed (a tile past the range is zero-filled and its
    // keys masked), k-chunks outer and tiles inner, so that neighbouring
    // mma are independent.
    uint4 ra[TILES], rb[TILES];
#pragma unroll
    for (int ti = 0; ti < TILES; ++ti) {
      const uint8_t* kt = slot + ti * TILE * ROW + tig * 16;
      ra[ti] = *reinterpret_cast<const uint4*>(kt + gid * ROW);
      rb[ti] = *reinterpret_cast<const uint4*>(kt + (gid + 8) * ROW);
    }
    float s[TILES][4];
#pragma unroll
    for (int ti = 0; ti < TILES; ++ti)
#pragma unroll
      for (int k = 0; k < 4; ++k) s[ti][k] = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e)
#pragma unroll
        for (int ti = 0; ti < TILES; ++ti) {
          const uint32_t wa = (&ra[ti].x)[j], wb = (&rb[ti].x)[j];
          const int sh = 8 * e;  // k-chunk 2j + e: nibbles at bits sh and sh + 4
          mma16816(s[ti], nib_bf16(wa >> sh), nib_bf16(wb >> sh), nib_bf16(wa >> (sh + 4)),
                   nib_bf16(wb >> (sh + 4)), qf[2 * j + e][0], qf[2 * j + e][1]);
        }
    // Keys gid (s 0, 1) and gid + 8 (s 2, 3) of each tile: logit = (ks (dot
    // - 128 qs) + kz qs) / sqrt(D), here in log2 units, NEG_INF past the range.
    float t[TILES][4];
#pragma unroll
    for (int ti = 0; ti < TILES; ++ti) {
      const int row0 = base + ti * TILE_STRIDE;
      const float2 kza = unpack_bf16(*reinterpret_cast<const uint32_t*>(
          slot + S_OFF + (ti * TILE + gid) * 8));
      const float2 kzb = unpack_bf16(*reinterpret_cast<const uint32_t*>(
          slot + S_OFF + (ti * TILE + gid + 8) * 8));
      const bool in0 = row0 + gid < end, in1 = row0 + gid + 8 < end;
      const float ksa = kza.x * sl2, ksb = kzb.x * sl2;
      t[ti][0] = in0 ? fmaf(ksa, s[ti][0] - qo0, kza.y * ql0) : NEG_INF;
      t[ti][1] = in0 ? fmaf(ksa, s[ti][1] - qo1, kza.y * ql1) : NEG_INF;
      t[ti][2] = in1 ? fmaf(ksb, s[ti][2] - qo0, kzb.y * ql0) : NEG_INF;
      t[ti][3] = in1 ? fmaf(ksb, s[ti][3] - qo1, kzb.y * ql1) : NEG_INF;
    }

    // One rescale per stage: the max over its keys per column (tile 0 holds
    // at least one, so the max is finite).
    float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
    for (int ti = 0; ti < TILES; ++ti) {
      mx0 = fmaxf(mx0, fmaxf(t[ti][0], t[ti][2]));
      mx1 = fmaxf(mx1, fmaxf(t[ti][1], t[ti][3]));
    }
#pragma unroll
    for (int off = 4; off < 32; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(FULL, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(FULL, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    if (__any_sync(FULL, mn0 > m0 || mn1 > m1)) {  // else every alpha is 1
      const float a0 = exp2_neg(m0 - mn0), a1 = exp2_neg(m1 - mn1);
      m0 = mn0;
      m1 = mn1;
      l0 *= a0; l1 *= a1; z0 *= a0; z1 *= a1;
#pragma unroll
      for (int mb = 0; mb < D / 16; ++mb) {
        o[mb][0] *= a0; o[mb][1] *= a1; o[mb][2] *= a0; o[mb][3] *= a1;
      }
    }

    // O^T += V^T W^T per tile, W = p * v_scale as bf16 hi + lo, transposed
    // from the S^T layout by movmatrix; V^T's A operand pairs two keys of
    // one channel, built from the two keys' code words by v_pairs.  The hi
    // products of all channel blocks go before the lo ones, so neighbouring
    // mma are independent.
#pragma unroll
    for (int ti = 0; ti < TILES; ++ti) {
      const float2 va = unpack_bf16(*reinterpret_cast<const uint32_t*>(
          slot + S_OFF + (ti * TILE + gid) * 8 + 4));
      const float2 vb = unpack_bf16(*reinterpret_cast<const uint32_t*>(
          slot + S_OFF + (ti * TILE + gid + 8) * 8 + 4));
      const float p0 = exp2_neg(t[ti][0] - m0), p1 = exp2_neg(t[ti][1] - m1);
      const float p2 = exp2_neg(t[ti][2] - m0), p3 = exp2_neg(t[ti][3] - m1);
      l0 += p0 + p2;
      l1 += p1 + p3;
      z0 = fmaf(p0, va.y, fmaf(p2, vb.y, z0));
      z1 = fmaf(p1, va.y, fmaf(p3, vb.y, z1));
      const float w0 = p0 * va.x, w1 = p1 * va.x, w2 = p2 * vb.x, w3 = p3 * vb.x;
      const uint32_t h01 = pack_bf16(w0, w1), h23 = pack_bf16(w2, w3);
      const float2 r01 = unpack_bf16(h01), r23 = unpack_bf16(h23);
      const uint32_t l01 = pack_bf16(w0 - r01.x, w1 - r01.y);
      const uint32_t l23 = pack_bf16(w2 - r23.x, w3 - r23.y);
      const uint32_t bh0 = movmatrix_trans(h01), bh1 = movmatrix_trans(h23);
      const uint32_t bl0 = movmatrix_trans(l01), bl1 = movmatrix_trans(l23);

      const uint8_t* vt = slot + V_OFF + ti * TILE * ROW;
      uint32_t pa[16], pb[16];  // keys (2 tig, 2 tig + 1) and (+ 8), channels 16 gid + k
      v_pairs(*reinterpret_cast<const uint2*>(vt + va0), *reinterpret_cast<const uint2*>(vt + vb0),
              sel_lo, sel_hi, pa);
      v_pairs(*reinterpret_cast<const uint2*>(vt + va1), *reinterpret_cast<const uint2*>(vt + vb1),
              sel_lo, sel_hi, pb);
#pragma unroll
      for (int mb = 0; mb < D / 16; ++mb)
        mma16816(o[mb], pa[2 * mb], pa[2 * mb + 1], pb[2 * mb], pb[2 * mb + 1], bh0, bh1);
#pragma unroll
      for (int mb = 0; mb < D / 16; ++mb)
        mma16816(o[mb], pa[2 * mb], pa[2 * mb + 1], pb[2 * mb], pb[2 * mb + 1], bl0, bl1);
    }
  }
  cp_async_wait<0>();
#pragma unroll
  for (int off = 4; off < 32; off <<= 1) {
    l0 += __shfl_xor_sync(FULL, l0, off);
    l1 += __shfl_xor_sync(FULL, l1, off);
    z0 += __shfl_xor_sync(FULL, z0, off);
    z1 += __shfl_xor_sync(FULL, z1, off);
  }
  __syncthreads();  // every warp is done with its ring: reuse it

  // Merge the 4 warps into the CTA's partial, v_zero's sum folded in.
  // sm_o [warp][column][channel].
  float* sm_o = reinterpret_cast<float*>(smem);
  float* sm_m = sm_o + WARPS * 8 * O_STRIDE;
  float* sm_l = sm_m + WARPS * 8;
#pragma unroll
  for (int mb = 0; mb < D / 16; ++mb) {
    float* c0 = sm_o + (warp * 8 + 2 * tig) * O_STRIDE + 16 * gid + 2 * mb;
    *reinterpret_cast<float2*>(c0) = make_float2(o[mb][0] + z0, o[mb][2] + z0);
    *reinterpret_cast<float2*>(c0 + O_STRIDE) = make_float2(o[mb][1] + z1, o[mb][3] + z1);
  }
  if (gid == 0) {
    sm_m[warp * 8 + 2 * tig] = m0;
    sm_m[warp * 8 + 2 * tig + 1] = m1;
    sm_l[warp * 8 + 2 * tig] = l0;
    sm_l[warp * 8 + 2 * tig + 1] = l1;
  }
  __syncthreads();
  const int d = tid;
  const size_t pbase = ((size_t)h * p.n_split + sp) * G;
#pragma unroll
  for (int g = 0; g < G; ++g) {
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
    float* out = p.part + (pbase + g) * PART;
    out[d] = A;
    if (d == 0) *reinterpret_cast<float2*>(out + D) = make_float2(Ls > 0.f ? M * LN2 : NEG_INF, Ls);
  }

  // Arrive; the last CTA of the head merges.  The barrier orders every
  // thread's partial before thread 0's release at device scope; its acquire
  // and the barrier after it order the last CTA's reads after every
  // partial (as CUTLASS's grid barriers do).
  __syncthreads();
  if (tid == 0) {
    int before = 0;
    if (p.n_split > 1)
      asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], 1;\n"
                   : "=r"(before) : "l"(p.counters + h) : "memory");
    sm_last = before == p.n_split - 1;
  }
  __syncthreads();
  if (!sm_last) return;
  const float2 vlo = unpack_bf16(vn_raw.x), vhi = unpack_bf16(vn_raw.y);
  const float vn4[4] = {vlo.x, vlo.y, vhi.x, vhi.y};
  merge_head<G>(p, h, s_new, vn4, smem);
}

template <int G>
int launch(const Params& p, int H, cudaStream_t st) {
  static bool configured[64] = {false};  // once per instantiation and device
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev >= 64) return (int)cudaErrorInvalidDevice;
  if (!configured[dev]) {
    cudaError_t err = cudaFuncSetAttribute(quant4_decode_kernel<G>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           SMEM_BYTES);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(quant4_decode_kernel<G>,
                                 cudaFuncAttributePreferredSharedMemoryCarveout,
                                 cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return (int)err;
    configured[dev] = true;
  }
  quant4_decode_kernel<G><<<dim3(H, p.n_split), THREADS, SMEM_BYTES, st>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace k4
}  // namespace

extern "C" int kvcf_quant4_decode_attn_append(
    const void* q, void* k_codes, void* v_codes, void* scales, const void* lengths,
    const void* lower, const void* k_new, const void* v_new, void* out, void* part,
    void* counters, int H, int G, int C, int n_split, float scale, void* stream) {
  if (n_split < 1) return (int)cudaErrorInvalidValue;
  k4::Params p;
  p.q = static_cast<const bf16*>(q);
  p.kc = static_cast<uint8_t*>(k_codes);
  p.vc = static_cast<uint8_t*>(v_codes);
  p.sc = static_cast<bf16*>(scales);
  p.lengths = static_cast<const int*>(lengths);
  p.lower = static_cast<const int*>(lower);
  p.k_new = static_cast<const bf16*>(k_new);
  p.v_new = static_cast<const bf16*>(v_new);
  p.out = static_cast<bf16*>(out);
  p.part = static_cast<float*>(part);
  p.counters = static_cast<int*>(counters);
  p.C = C;
  p.n_split = n_split;
  p.scale = scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (G) {
    case 1: return k4::launch<1>(p, H, st);
    case 2: return k4::launch<2>(p, H, st);
    case 3: return k4::launch<3>(p, H, st);
    case 4: return k4::launch<4>(p, H, st);
    case 5: return k4::launch<5>(p, H, st);
    case 6: return k4::launch<6>(p, H, st);
    case 7: return k4::launch<7>(p, H, st);
    case 8: return k4::launch<8>(p, H, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
