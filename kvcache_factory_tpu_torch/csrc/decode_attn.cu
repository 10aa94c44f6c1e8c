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
// The caller advances lengths to min(lengths + 1, C).  Any capacity C > 0.
//
// What bounds it: reading the valid K/V rows, 2 * len * D * 2 bytes per
// head (34.6 MB per layer at 32 heads and C = 2113, 10.3 us at 3.35 TB/s);
// the arithmetic is ~1 FLOP per byte.
//
// Design (flash-decoding): at batch 1 there are only 32 heads against 132
// SMs, so the C axis is split over n_split CTAs per head.  Each CTA streams
// its key range with 16-byte loads (16 lanes per 256-byte row, neighbouring
// lanes on neighbouring addresses, 8 rows in flight per step and 4 steps
// unrolled), keeps an fp32 online softmax per key stream, merges its 8
// streams in shared memory and writes a partial (m, l, acc) to scratch the
// wrapper allocates.  A combine kernel, one CTA per head, merges the
// partials, folds in the new token, writes out, and only then writes the
// new K/V into slot L: the write comes in a later launch than every read,
// so nothing races.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int D = 128;        // head_dim (the wrapper checks)
constexpr int STREAMS = 8;    // key rows in flight per CTA step (4 warps x 2)
constexpr int UNROLL = 4;
constexpr float NEG_INF = -3.4028234663852886e38f;  // float32 finfo.min

__device__ __forceinline__ void unpack8(const uint4& raw, float f[8]) {
  const bf16* p = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
  for (int i = 0; i < 8; ++i) f[i] = __bfloat162float(p[i]);
}

template <int G>
__global__ void __launch_bounds__(128)
decode_split_kernel(const bf16* __restrict__ q, const bf16* __restrict__ kc,
                    const bf16* __restrict__ vc, const int* __restrict__ lengths,
                    const int* __restrict__ lower, float* __restrict__ part_acc,
                    float* __restrict__ part_ml, int C, int n_split, int chunk,
                    float scale) {
  __shared__ float sm_m[STREAMS][G], sm_l[STREAMS][G];
  __shared__ float sm_acc[STREAMS][G][D];

  const int h = blockIdx.x, sp = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int hl = lane & 15;                    // 16 lanes share one key row
  const int stream = warp * 2 + (lane >> 4);
  const int d0 = hl * 8;
  const int L = min(lengths[h], C - 1);
  const int lo = lower ? lower[h] : 0;
  const int start = max(sp * chunk, lo);
  const int end = min(sp * chunk + chunk, L);

  float qv[G][8];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    unpack8(*reinterpret_cast<const uint4*>(q + ((size_t)h * G + g) * D + d0), qv[g]);
#pragma unroll
    for (int i = 0; i < 8; ++i) qv[g][i] *= scale;  // fold 1/sqrt(D) into q once
  }
  float m[G], l[G], acc[G][8];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = NEG_INF;
    l[g] = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[g][i] = 0.f;
  }

  const bf16* kh = kc + (size_t)h * C * D + d0;
  const bf16* vh = vc + (size_t)h * C * D + d0;
  // Warp-uniform loop: every lane runs every step, so the shuffles below
  // always have all 32 lanes; rows past `end` are loaded by no one and
  // skipped in the update.
  for (int base = start; base < end; base += STREAMS * UNROLL) {
    uint4 kr[UNROLL], vr[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int j = base + u * STREAMS + stream;
      kr[u] = vr[u] = make_uint4(0, 0, 0, 0);
      if (j < end) {
        kr[u] = *reinterpret_cast<const uint4*>(kh + (size_t)j * D);
        vr[u] = *reinterpret_cast<const uint4*>(vh + (size_t)j * D);
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const bool valid = base + u * STREAMS + stream < end;
      float kf[8], vf[8];
      unpack8(kr[u], kf);
      unpack8(vr[u], vf);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float s = 0.f;
#pragma unroll
        for (int i = 0; i < 8; ++i) s = fmaf(qv[g][i], kf[i], s);
        s += __shfl_xor_sync(0xffffffffu, s, 8);
        s += __shfl_xor_sync(0xffffffffu, s, 4);
        s += __shfl_xor_sync(0xffffffffu, s, 2);
        s += __shfl_xor_sync(0xffffffffu, s, 1);
        if (valid) {
          const float mn = fmaxf(m[g], s);
          const float alpha = expf(m[g] - mn);
          const float p = expf(s - mn);
          l[g] = l[g] * alpha + p;
#pragma unroll
          for (int i = 0; i < 8; ++i) acc[g][i] = fmaf(p, vf[i], acc[g][i] * alpha);
          m[g] = mn;
        }
      }
    }
  }

#pragma unroll
  for (int g = 0; g < G; ++g) {
#pragma unroll
    for (int i = 0; i < 8; ++i) sm_acc[stream][g][d0 + i] = acc[g][i];
    if (hl == 0) { sm_m[stream][g] = m[g]; sm_l[stream][g] = l[g]; }
  }
  __syncthreads();

  const int d = tid;  // 128 threads, one per channel
  for (int g = 0; g < G; ++g) {
    float M = NEG_INF;
#pragma unroll
    for (int s = 0; s < STREAMS; ++s) M = fmaxf(M, sm_m[s][g]);
    float Ls = 0.f, A = 0.f;
#pragma unroll
    for (int s = 0; s < STREAMS; ++s) {
      const float w = expf(sm_m[s][g] - M);
      Ls += sm_l[s][g] * w;
      A += sm_acc[s][g][d] * w;
    }
    const size_t pi = ((size_t)h * n_split + sp) * G + g;
    part_acc[pi * D + d] = A;
    if (d == 0) { part_ml[pi * 2] = M; part_ml[pi * 2 + 1] = Ls; }
  }
}

template <int G>
__global__ void __launch_bounds__(128)
decode_combine_kernel(const bf16* __restrict__ q, bf16* __restrict__ kc,
                      bf16* __restrict__ vc, const int* __restrict__ lengths,
                      const bf16* __restrict__ k_new, const bf16* __restrict__ v_new,
                      const float* __restrict__ part_acc,
                      const float* __restrict__ part_ml, bf16* __restrict__ out,
                      int C, int n_split, float scale) {
  __shared__ float red[4];
  const int h = blockIdx.x, d = threadIdx.x, lane = d & 31, warp = d >> 5;
  const int L = min(lengths[h], C - 1);
  const bf16 kn_b = k_new[(size_t)h * D + d], vn_b = v_new[(size_t)h * D + d];
  const float kn = __bfloat162float(kn_b), vn = __bfloat162float(vn_b);

  for (int g = 0; g < G; ++g) {
    float prod = __bfloat162float(q[((size_t)h * G + g) * D + d]) * scale * kn;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) prod += __shfl_xor_sync(0xffffffffu, prod, off);
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
  kc[((size_t)h * C + L) * D + d] = kn_b;
  vc[((size_t)h * C + L) * D + d] = vn_b;
}

template <int G>
int launch(const void* q, void* kc, void* vc, const void* lengths,
           const void* lower, const void* k_new, const void* v_new, void* out,
           void* part_acc, void* part_ml, int H, int C, int n_split, int chunk,
           float scale, cudaStream_t st) {
  decode_split_kernel<G><<<dim3(H, n_split), 128, 0, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(kc),
      static_cast<const bf16*>(vc), static_cast<const int*>(lengths),
      static_cast<const int*>(lower), static_cast<float*>(part_acc),
      static_cast<float*>(part_ml), C, n_split, chunk, scale);
  decode_combine_kernel<G><<<H, 128, 0, st>>>(
      static_cast<const bf16*>(q), static_cast<bf16*>(kc), static_cast<bf16*>(vc),
      static_cast<const int*>(lengths), static_cast<const bf16*>(k_new),
      static_cast<const bf16*>(v_new), static_cast<const float*>(part_acc),
      static_cast<const float*>(part_ml), static_cast<bf16*>(out), C, n_split,
      scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int kvcf_decode_attn_append(const void* q, void* k_cache, void* v_cache,
                                       const void* lengths, const void* lower,
                                       const void* k_new, const void* v_new,
                                       void* out, void* part_acc, void* part_ml,
                                       int H, int G, int C, int n_split, int chunk,
                                       float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (G) {
    case 1: return launch<1>(q, k_cache, v_cache, lengths, lower, k_new, v_new, out,
                             part_acc, part_ml, H, C, n_split, chunk, scale, st);
    case 2: return launch<2>(q, k_cache, v_cache, lengths, lower, k_new, v_new, out,
                             part_acc, part_ml, H, C, n_split, chunk, scale, st);
    case 4: return launch<4>(q, k_cache, v_cache, lengths, lower, k_new, v_new, out,
                             part_acc, part_ml, H, C, n_split, chunk, scale, st);
    case 8: return launch<8>(q, k_cache, v_cache, lengths, lower, k_new, v_new, out,
                             part_acc, part_ml, H, C, n_split, chunk, scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
