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
// card's ratio of operations to bytes, so bytes bound it.
//
// Design (flash-decoding, as K2 in decode_attn.cu): few heads against 132
// SMs, so the C axis is split over n_split CTAs per head.  Each lane loads 16
// bytes of a code row at a time (16 int8 codes or 32 nibbles): 8 (int8) or 4
// (int4) neighbouring lanes cover a row, so 16 or 32 rows are in flight per
// CTA step and 64 rows per loop iteration.  Codes become floats in
// registers; K's scale and zero apply to the reduced dot (s = ks * dot +
// kz * sum(q)) and V's zero is summed apart (acc += (p * vs) * c, z += p *
// vz), so each code costs one FMA and no dequantized row is formed.  Each
// key stream keeps an fp32 online softmax; the streams of a warp merge by
// shuffles, the 4 warps in shared memory, and each CTA writes an fp32
// partial (m, l, acc).  A combine kernel, one CTA per head, merges the
// partials, folds in the new token, writes out, and only then quantizes the
// new token and writes it into slot L: the write comes in a later launch
// than every read, so nothing races.  Built without --use_fast_math, so the
// divisions of the append are IEEE, as in PyTorch and XLA.

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

extern "C" int kvcf_quant4_decode_attn_append(
    const void* q, void* k_codes, void* v_codes, void* scales, const void* lengths,
    const void* lower, const void* k_new, const void* v_new, void* out, void* part_acc,
    void* part_ml, int H, int G, int C, int n_split, int chunk, float scale, void* stream) {
  return dispatch<4>(q, k_codes, v_codes, scales, lengths, lower, k_new, v_new, out,
                     part_acc, part_ml, H, G, C, n_split, chunk, scale, stream);
}
