// K3 above head_dim 512, up to 2048: one-token decode attention over one
// layer of the per-token int8 KV cache, with the dequantization folded into
// the dot products and the new token quantized and appended in place, for
// Hopper (sm_90a).  One cluster of CTAs shares each logit.
//
// Replaces the Pallas TPU kernel
//   kvcache_factory_tpu/ops/kernels/decode_attn_quant.py::_quant_decode_kernel
// at head_dims D % 128 == 0 from 640 to 2048 (n_slice = ceil(D / 256) <= 8,
// the portable cluster size); wider ones run csrc/decode_attn_wide.cu's
// kernel (the wrapper routes by D).  What it computes is that of
// csrc/decode_attn_quant.cu, per cache head h with G query rows:
//   L = min(lengths[h], C - 1)            (a full cache overwrites slot C-1)
//   keys read: lower[h] <= idx < L        (slot L is never read from memory)
//   s_j = ks_j (q . c_j) / sqrt(D) + kz_j sum(q) / sqrt(D)
//   out = softmax over those keys plus the new token (its logit and value
//         from k_new / v_new in fp32) of sum_j p_j (vs_j c_j + vz_j); fp32
//         softmax.
//   Then the new token is quantized per token as the plain version does
//   (min and max over D, scale = max(max - min, 1e-8) / 255 with IEEE
//   division, codes rintf((x - min) / scale) clamped, the four scalars
//   rounded to bf16) and written into slot L.
// The caller advances lengths to min(lengths + 1, C).  Any capacity C > 0,
// any G >= 1 (blocks of 8 query rows).
//
// What bounds it: reading the valid codes and scalars once, 2 D + 8 bytes a
// valid token-head; the products are about 2 FLOP a code byte, far below
// the tensor cores' ridge.  What limits the design is that a CTA cannot
// hold a whole row's work above 512: O's D columns in registers, and a
// stage of whole K / V rows in shared memory.  The slice kernel of
// csrc/decode_attn_wide.cu (run above 2048) splits O's columns over slice
// CTAs that each read all of K for the logits (K read n_slice times),
// turns every code into a float with an I2F and runs PV as scalar fp32
// FMAs.  Here:
//  1. A cluster of n_slice CTAs per (head, split, query block): CTA j (its
//     rank) owns channels [256 j, 256 j + 256) of K, V and O and reads only
//     those codes, so each code is read once.  Within a CTA everything is
//     csrc/decode_attn_quant.cu's K3 at D 256: each of the 4 warps streams
//     16 keys a stage through its own 2-stage cp.async ring (K slice, V
//     slice, the keys' four scalars), bytes to fp16 by one PRMT a pair
//     (codes n 2^-24, no I2F), q scaled per row by a power of two into
//     [2^14, 2^15), S^T = K q^T and O^T += V^T W^T on mma.sync m16n8k16
//     f16, W = p v_scale as fp16 hi + lo under a per-warp power of two.
//  2. The logits need every channel: each warp's partial S^T [16 keys x 8
//     rows] (its channels only) goes to the same warp of every CTA of the
//     cluster by st.async (16 bytes a lane, counted on that warp's mbarrier
//     of the stage's slot); each warp sums the n partials in slice order 0,
//     1, ..., n-1 and only then applies k_scale, k_zero sum(q) and the
//     logit scale, so every CTA holds the same logits, softmax and W bits.
//     sum(q), q's power of two and the new token's logit are taken over all
//     of D by every CTA with the same instructions.  Two slots a warp: a
//     CTA pushes stage i + 2 only after every CTA pushed stage i + 1, which
//     each did after reading stage i.
//  3. The 4 warps merge into the CTA's partial (acc[GB][256], m, l in
//     fp32, v_zero's sum folded in), written per (head, query block, slice,
//     split) as csrc/decode_attn_wide.cu writes it; the last of a (head,
//     query block, slice)'s n_split CTAs to raise its counter merges them
//     in split order (bitwise repeatable), folds in the new token, writes
//     its columns of out and resets the counter to 0.  The merge of query
//     block 0, slice 0 appends the new token (no CTA reads slot L).
// Masked logits are NEG_INF (-FLT_MAX) and weigh exactly 0; partials leave
// in natural-log units.  Built without --use_fast_math (IEEE division in
// the append).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;
constexpr float NEG_INF = -3.4028234663852886e38f;  // float32 finfo.min
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
constexpr int DV = 256;            // channels a CTA: one column slice
// The portable cluster size, equal to ops/kernels/flash_prefill.py::CLUSTER_MAX.
constexpr int CLUSTER_MAX = 8;
constexpr int SEG = 128;           // channels a segment (a slice: two)
constexpr int NSEG = DV / SEG;
constexpr int TILE = 16;           // keys a warp a stage: the mma's M
constexpr int STAGE_KEYS = WARPS * TILE;
constexpr int STAGES = 2;
constexpr int ROW = DV;            // code bytes of a slice row
constexpr int CHUNKS = ROW / 16;
constexpr int V_OFF = TILE * ROW;
constexpr int S_OFF = 2 * TILE * ROW;
constexpr int SLOT_BYTES = S_OFF + TILE * 8;      // 8,320
constexpr int WARP_RING = STAGES * SLOT_BYTES;
constexpr int RING_BYTES = WARPS * WARP_RING;     // 66,560
constexpr int PUSH = 32 * 16;                     // a warp's partial: 16 bytes a lane
constexpr int O_STRIDE = DV + 4;                  // padded row of the warp merge
// Shared memory: the rings, then the partial logits received, [slot][warp][rank][lane].
constexpr int smem_bytes(int n) { return RING_BYTES + STAGES * WARPS * n * PUSH; }
static_assert(WARPS * 8 * O_STRIDE * 4 + 2 * WARPS * 8 * 4 <= RING_BYTES, "warp merge");

// K3's codes as fp16: the byte n under a zero high byte is the fp16
// subnormal n 2^-24, exact (csrc/decode_attn_quant.cu, CODE_UNIT).
constexpr float CODE_UNIT = 1.f / 16777216.f;

struct Params {
  const bf16* q;        // [H, G, hd]
  uint8_t* kc;          // [H, C, hd] codes
  uint8_t* vc;
  bf16* sc;             // [H, C, 4] (k_scale, k_zero, v_scale, v_zero)
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

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

// Wait until the phase of parity `parity` has completed, acquiring what
// the other CTAs of the cluster stored here.
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

// The address of this CTA's shared-memory location `addr` in CTA `rank`.
__device__ __forceinline__ uint32_t mapa(uint32_t addr, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}

// 16 bytes into a CTA of the cluster, completing them on its mbarrier.
__device__ __forceinline__ void st_async_v4(uint32_t addr, float a, float b, float c, float d,
                                            uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 [%0], {%1, %2, %3, %4}, [%5];\n"
      :: "r"(addr), "f"(a), "f"(b), "f"(c), "f"(d), "r"(bar) : "memory");
}

// d += a . b, m16n8k16, fp16 in, fp32 accumulate.
__device__ __forceinline__ void mma16816(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// The transpose of the 8x8 16-bit matrix whose fragment the warp holds.
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

__device__ __forceinline__ uint32_t pack_f16(float lo, float hi) {
  __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float2 unpack_f16(uint32_t x) {
  return __half22float2(*reinterpret_cast<__half2*>(&x));
}

// Bytes 0 and 1 (sel 0x4140) or 2 and 3 (sel 0x4342) of x as two fp16
// codes n 2^-24: one PRMT.
__device__ __forceinline__ uint32_t byte_f16(uint32_t x, uint32_t sel) {
  return __byte_perm(x, 0u, sel);
}

// 2^x for x <= 0 (and NEG_INF): one MUFU.EX2 without exp2f's range fix-up.
__device__ __forceinline__ float exp2_neg(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The power of two 2^(14 - e) for x in [2^e, 2^(e+1)), so that x times it
// lies in [2^14, 2^15); clamped to [2^-126, 2^127] (x = 0 gives 2^127).
__device__ __forceinline__ float pow2_to_2e14(float x) {
  const int e = (__float_as_uint(x) >> 23) & 0xff;
  return __uint_as_float((uint32_t)min(max(268 - e, 1), 254) << 23);
}

// 16 code bytes of key a (channels c .. c + 15) and the same of key b ->
// the 16 fp16 pairs (a's code, b's code) of channels c + k: per 4 pairs two
// PRMT that interleave the keys' bytes, then one PRMT a pair.
__device__ __forceinline__ void v_pairs8(uint4 a, uint4 b, uint32_t (&r)[16]) {
  const uint32_t wa[4] = {a.x, a.y, a.z, a.w}, wb[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const uint32_t t0 = __byte_perm(wa[u], wb[u], 0x5140);  // a0 b0 a1 b1
    const uint32_t t1 = __byte_perm(wa[u], wb[u], 0x7362);  // a2 b2 a3 b3
    r[4 * u] = byte_f16(t0, 0x4140);
    r[4 * u + 1] = byte_f16(t0, 0x4342);
    r[4 * u + 2] = byte_f16(t1, 0x4140);
    r[4 * u + 3] = byte_f16(t1, 0x4342);
  }
}

// Chunk c of key row r of a slot, XOR-swizzled so that no two lanes of a
// load phase meet in a bank (csrc/decode_attn_quant.cu's K3 at D 256).
__device__ __forceinline__ int k_chunk(int c, int r) { return c ^ (r & 1); }
__device__ __forceinline__ int v_chunk(int c, int r) { return c ^ (((r >> 1) & 3) << 1); }

// The last CTA of (h, qb, slice) to arrive: merge the n_split partials of
// each of its query rows in split order, fold in the new token, write this
// slice's columns of out.  Thread t owns the channel pair 2t, 2t + 1 of the
// slice.
template <int GB>
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
    const float inv = __fdividef(1.f, Ls * alpha + p_new);  // the sum is at least 1
    *reinterpret_cast<uint32_t*>(p.out + ((size_t)h * p.G + row) * hd + ch) =
        pack_bf16((a0 * alpha + p_new * vn.x) * inv, (a1 * alpha + p_new * vn.y) * inv);
  }
}

// Quantize the new token per token (min and max over hd, IEEE division,
// rintf rounds half to even as torch.round) and write it into slot L.
__device__ __forceinline__ void append_token(const Params& p, int h, int L) {
  __shared__ float ext[WARPS][4];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, hd = p.hd;
  const bf16* kn = p.k_new + (size_t)h * hd;
  const bf16* vn = p.v_new + (size_t)h * hd;
  const size_t row = (size_t)h * p.C + L;
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
  for (int w = 0; w < WARPS; ++w) {
    kmn = fminf(kmn, ext[w][0]); kmx = fmaxf(kmx, ext[w][1]);
    vmn = fminf(vmn, ext[w][2]); vmx = fmaxf(vmx, ext[w][3]);
  }
  const float ks = fmaxf(kmx - kmn, 1e-8f) / 255.f;
  const float vs = fmaxf(vmx - vmn, 1e-8f) / 255.f;
  auto code = [](float x, float mn, float s) {
    return (uint8_t)fminf(fmaxf(rintf((x - mn) / s), 0.f), 255.f);
  };
  for (int c = tid; c < hd; c += THREADS) {
    p.kc[row * hd + c] = code(__bfloat162float(kn[c]), kmn, ks);
    p.vc[row * hd + c] = code(__bfloat162float(vn[c]), vmn, vs);
  }
  if (tid == 0) {
    bf16* s4 = p.sc + row * 4;
    s4[0] = __float2bfloat16(ks);
    s4[1] = __float2bfloat16(kmn);
    s4[2] = __float2bfloat16(vs);
    s4[3] = __float2bfloat16(vmn);
  }
}

// Cluster (h, sp, qb) of n_slice CTAs; CTA (rank) `slice` takes channels
// [256 slice, 256 slice + 256) of query rows [GB qb, GB qb + GB) over its
// split's keys.  Lane (gid, tig) of warp w computes keys 16 w + gid and
// 16 w + gid + 8 of a stage for query rows 2 tig, 2 tig + 1 (the mma's C
// layout of S^T).
template <int GB>
__global__ void __launch_bounds__(THREADS, 2)
quant8_cluster_kernel(const Params p) {
  extern __shared__ __align__(128) uint8_t smem[];
  __shared__ __align__(8) uint64_t bars[STAGES][WARPS];  // partials received, by slot
  __shared__ float sQs[8], sQsc[8], sNew[8];  // sum(q), q's power of two, new logit
  __shared__ int sm_last;

  const int n = p.n_slice;
  const int h = blockIdx.x, sp = blockIdx.y;
  const int qb = blockIdx.z / n, slice = (int)cluster_rank();
  const int g0 = qb * GB;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int C = p.C, hd = p.hd, G = p.G;
  const int c_lo = slice * DV;
  const int L = min(p.lengths[h], C - 1);
  const int lo = p.lower ? min(max(p.lower[h], 0), L) : 0;
  // 32-bit: the host keeps C n_split below 2^32.
  const unsigned nk = (unsigned)(L - lo);
  const int start = lo + (int)(nk * (unsigned)sp / (unsigned)p.n_split);
  const int end = lo + (int)(nk * (unsigned)(sp + 1) / (unsigned)p.n_split);
  const int n_stages = (end - start + STAGE_KEYS - 1) / STAGE_KEYS;

  if (tid == 0) {
    for (int b = 0; b < STAGES * WARPS; ++b) mbar_init(smem_u32(&bars[0][0]) + 8 * b, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }

  // This warp's ring: stage i holds keys start + 64 i + 16 warp + r, row r;
  // lane copies 16-byte chunk (32 j + lane) % 16 of row (32 j + lane) / 16
  // of the slice's K and V codes, and the scalars of row lane; rows past the
  // range and chunks past hd are zero-filled.
  const uint32_t ring = smem_u32(smem) + warp * WARP_RING;
  const uint8_t* kh = p.kc + (size_t)h * C * hd + c_lo;
  const uint8_t* vh = p.vc + (size_t)h * C * hd + c_lo;
  const bf16* sh = p.sc + (size_t)h * C * 4;
  auto load_stage = [&](int i) {
    const int base = start + i * STAGE_KEYS + TILE * warp;
    if (base >= end) return;  // none of this warp's keys
    const uint32_t slot = ring + (i % STAGES) * SLOT_BYTES;
#pragma unroll
    for (int j = 0; j < TILE * CHUNKS / 32; ++j) {
      const int rr = (32 * j + lane) / CHUNKS, ck = (32 * j + lane) % CHUNKS;
      const int key = base + rr;
      const bool valid = key < end && c_lo + ck * 16 < hd;
      const size_t off = valid ? (size_t)key * hd + ck * 16 : 0;
      cp_async16(slot + rr * ROW + k_chunk(ck, rr) * 16, kh + off, valid ? 16 : 0);
      cp_async16(slot + V_OFF + rr * ROW + v_chunk(ck, rr) * 16, vh + off, valid ? 16 : 0);
    }
    if (lane < TILE) {
      const int key = base + lane;
      const bool valid = key < end;
      cp_async8(slot + S_OFF + lane * 8, sh + (size_t)(valid ? key : start) * 4, valid ? 8 : 0);
    }
  };
  if (n_stages > 0) load_stage(0);
  cp_async_commit();

  // Over all of hd, the same in every CTA: each row's sum(q), its largest
  // |q| (q's power of two) and its new-token logit; warp w takes rows w and
  // w + 4, lane l the pairs 2 l, 2 l + 64, ... in order, then a butterfly.
  if (tid < 8) { sQs[tid] = 0.f; sQsc[tid] = pow2_to_2e14(0.f); sNew[tid] = 0.f; }
  __syncthreads();
  for (int g = warp; g < GB; g += WARPS) {
    if (g0 + g >= G) continue;  // a zero query (uniform in the warp)
    const bf16* qg = p.q + ((size_t)h * G + g0 + g) * hd;
    const bf16* kn = p.k_new + (size_t)h * hd;
    float s = 0.f, amax = 0.f, dot = 0.f;
    for (int c = 2 * lane; c < hd; c += 64) {
      const float2 x = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(qg + c));
      const float2 y = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(kn + c));
      s += x.x;
      s += x.y;
      amax = fmaxf(amax, fmaxf(fabsf(x.x), fabsf(x.y)));
      dot = fmaf(x.x, y.x, dot);
      dot = fmaf(x.y, y.y, dot);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      s += __shfl_xor_sync(FULL, s, off);
      amax = fmaxf(amax, __shfl_xor_sync(FULL, amax, off));
      dot += __shfl_xor_sync(FULL, dot, off);
    }
    if (lane == 0) { sQs[g] = s; sQsc[g] = pow2_to_2e14(amax); sNew[g] = dot * p.scale; }
  }
  // Every CTA's barriers exist before any pushes; the row sums are in.
  cluster_sync();

  // q^T as the B operand of S^T = K q^T: lane (gid, tig) holds query row
  // g0 + gid (zero past the block, G or hd) at channels c_lo + 128 s + 32
  // tig .. + 31 of each segment s, the channels whose codes it reads; k-chunk
  // 8 s + j holds channels c, c + 1, c + 2, c + 3 with c = c_lo + 128 s + 32
  // tig + 4 j, as fp16 times the row's power of two.
  uint32_t qf[DV / 16][2];
  {
    const bool q_row = gid < GB && g0 + gid < G;
    const float qsc = sQsc[gid < GB ? gid : 0];
#pragma unroll
    for (int sg = 0; sg < NSEG; ++sg) {
      uint4 raw[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int c = c_lo + SEG * sg + 32 * tig + 8 * i;
        raw[i] = q_row && c < hd ? *reinterpret_cast<const uint4*>(
                                       p.q + ((size_t)h * G + g0 + gid) * hd + c)
                                 : make_uint4(0, 0, 0, 0);
      }
      const uint16_t* qv = reinterpret_cast<const uint16_t*>(raw);
      auto qx = [&](int k) { return __bfloat162float(__ushort_as_bfloat16(qv[k])) * qsc; };
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        qf[8 * sg + j][0] = pack_f16(qx(4 * j), qx(4 * j + 1));
        qf[8 * sg + j][1] = pack_f16(qx(4 * j + 2), qx(4 * j + 3));
      }
    }
  }
  if (n_stages > 1) load_stage(1);
  cp_async_commit();

  // A score is ks kf dot + kz ql: kf turns the product's units into log2
  // units of (q . k) / sqrt(D).  Columns 2 tig and 2 tig + 1 are rows of
  // the block (zero queries past it).
  const float sl2 = p.scale * LOG2E;
  const int ca = min(2 * tig, 7), cb = min(2 * tig + 1, 7);
  const float ql0 = sQs[ca] * sl2, ql1 = sQs[cb] * sl2;
  const float kf0 = sl2 / (CODE_UNIT * sQsc[ca]), kf1 = sl2 / (CODE_UNIT * sQsc[cb]);

  // K reads: rows gid and gid + 8, chunks 8 s + 2 tig and 8 s + 2 tig + 1 of
  // segment s; V reads: rows 2 tig, 2 tig + 1, 2 tig + 8, 2 tig + 9, chunk
  // 8 s + gid; at their swizzled places.
  int ko0[NSEG], ko1[NSEG], va0[NSEG], vb0[NSEG], va1[NSEG], vb1[NSEG];
#pragma unroll
  for (int sg = 0; sg < NSEG; ++sg) {
    ko0[sg] = gid * ROW + (k_chunk(8 * sg + 2 * tig, gid) << 4);
    ko1[sg] = gid * ROW + (k_chunk(8 * sg + 2 * tig + 1, gid) << 4);
    auto v_addr = [&](int r) { return r * ROW + (v_chunk(8 * sg + gid, r) << 4); };
    va0[sg] = v_addr(2 * tig);
    vb0[sg] = v_addr(2 * tig + 1);
    va1[sg] = v_addr(2 * tig + 8);
    vb1[sg] = v_addr(2 * tig + 9);
  }
  // Where this lane's partial goes in every CTA: [slot][warp][rank][lane].
  const uint32_t recv = smem_u32(smem) + RING_BYTES;
  const uint32_t push_at = recv + ((warp * n + slice) * 32 + lane) * 16;
  const float4* recv_f = reinterpret_cast<const float4*>(smem + RING_BYTES);

  float m0 = NEG_INF, m1 = NEG_INF;  // running max (log2 units), columns 2 tig, 2 tig + 1
  float l0 = 0.f, l1 = 0.f;          // this lane's share of the sums of p
  float z0 = 0.f, z1 = 0.f;          // and of p * v_zero
  float vsc = 1.7014118346046923e38f;  // W's power of two (2^127 until the first key)
  // O^T: m-tile 8 s + mb holds channels c_lo + 128 s + 16 gid + 2 mb (+1),
  // columns 2 tig (+1).
  float o[DV / 16][4];
#pragma unroll
  for (int mb = 0; mb < DV / 16; ++mb)
#pragma unroll
    for (int i = 0; i < 4; ++i) o[mb][i] = 0.f;

  for (int i = 0; i < n_stages; ++i) {
    cp_async_wait<STAGES - 1>();
    __syncwarp();
    const int base = start + i * STAGE_KEYS + TILE * warp;
    const int sl = i % STAGES;
    const uint8_t* slot = smem + warp * WARP_RING + sl * SLOT_BYTES;
    if (base < end) {  // warp-uniform, and the same in every CTA of the cluster
      auto scalars = [&](int r) {  // (k_scale, k_zero) in .x, (v_scale, v_zero) in .y
        return *reinterpret_cast<const uint2*>(slot + S_OFF + r * 8);
      };
      // This CTA's part of S^T: its channels, k-chunks in order.
      float s[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int sg = 0; sg < NSEG; ++sg) {
        uint4 ka[2], kb[2];
        ka[0] = *reinterpret_cast<const uint4*>(slot + ko0[sg]);
        ka[1] = *reinterpret_cast<const uint4*>(slot + ko1[sg]);
        kb[0] = *reinterpret_cast<const uint4*>(slot + 8 * ROW + ko0[sg]);
        kb[1] = *reinterpret_cast<const uint4*>(slot + 8 * ROW + ko1[sg]);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const uint32_t wa = (&ka[j >> 2].x)[j & 3], wb = (&kb[j >> 2].x)[j & 3];
          mma16816(s, byte_f16(wa, 0x4140), byte_f16(wb, 0x4140), byte_f16(wa, 0x4342),
                   byte_f16(wb, 0x4342), qf[8 * sg + j][0], qf[8 * sg + j][1]);
        }
      }
      // To the same warp of every CTA; then the n parts, summed in slice
      // order.
      const uint32_t bar = smem_u32(&bars[sl][warp]);
      const uint32_t at = push_at + sl * WARPS * n * PUSH;
      for (int d = 0; d < n; ++d)
        st_async_v4(mapa(at, d), s[0], s[1], s[2], s[3], mapa(bar, d));
      if (lane == 0) mbar_expect_tx(bar, (uint32_t)(n * PUSH));
      mbar_wait_cluster(bar, (i / STAGES) & 1);
      {
        const float4* r = recv_f + (sl * WARPS + warp) * n * 32 + lane;
        float4 a = r[0];
        for (int j = 1; j < n; ++j) {
          const float4 x = r[j * 32];
          a.x += x.x; a.y += x.y; a.z += x.z; a.w += x.w;
        }
        s[0] = a.x; s[1] = a.y; s[2] = a.z; s[3] = a.w;
      }
      __syncwarp();  // every lane has read the slot before any lane moves on

      // Keys gid (s 0, 1) and gid + 8 (s 2, 3): logit = kf ks dot + kz ql,
      // in log2 units, NEG_INF past the range.
      const float2 kza = unpack_bf16(scalars(gid).x), kzb = unpack_bf16(scalars(gid + 8).x);
      const bool in0 = base + gid < end, in1 = base + gid + 8 < end;
      float t[4];
      t[0] = in0 ? fmaf(kza.x * kf0, s[0], kza.y * ql0) : NEG_INF;
      t[1] = in0 ? fmaf(kza.x * kf1, s[1], kza.y * ql1) : NEG_INF;
      t[2] = in1 ? fmaf(kzb.x * kf0, s[2], kzb.y * ql0) : NEG_INF;
      t[3] = in1 ? fmaf(kzb.x * kf1, s[3], kzb.y * ql1) : NEG_INF;

      // One rescale per stage, and only when a column's max rose or W's
      // power of two fell (a v_scale that would take W past 2^15).
      float mx0 = fmaxf(t[0], t[2]), mx1 = fmaxf(t[1], t[3]);
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(FULL, mx0, off));
        mx1 = fmaxf(mx1, __shfl_xor_sync(FULL, mx1, off));
      }
      float vmx = fmaxf(fabsf(unpack_bf16(scalars(gid).y).x),
                        fabsf(unpack_bf16(scalars(gid + 8).y).x));
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) vmx = fmaxf(vmx, __shfl_xor_sync(FULL, vmx, off));
      const bool lower_vsc = vmx * vsc >= 32768.f;  // warp-uniform
      float ratio = 1.f;
      if (lower_vsc) {
        const float nv = pow2_to_2e14(vmx);
        ratio = nv / vsc;  // a power of two: exact
        vsc = nv;
      }
      const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
      if (__any_sync(FULL, mn0 > m0 || mn1 > m1) || lower_vsc) {  // else every alpha is 1
        const float a0 = exp2_neg(m0 - mn0), a1 = exp2_neg(m1 - mn1);
        m0 = mn0;
        m1 = mn1;
        l0 *= a0; l1 *= a1; z0 *= a0; z1 *= a1;
        const float b0 = a0 * ratio, b1 = a1 * ratio;
#pragma unroll
        for (int mb = 0; mb < DV / 16; ++mb) {
          o[mb][0] *= b0; o[mb][1] *= b1; o[mb][2] *= b0; o[mb][3] *= b1;
        }
      }

      // O^T += V^T W^T, W = p v_scale vsc as fp16 hi + lo, transposed from
      // the S^T layout by movmatrix; V^T's A operand pairs two keys of one
      // channel.
      const float2 va = unpack_bf16(scalars(gid).y), vb = unpack_bf16(scalars(gid + 8).y);
      const float p0 = exp2_neg(t[0] - m0), p1 = exp2_neg(t[1] - m1);
      const float p2 = exp2_neg(t[2] - m0), p3 = exp2_neg(t[3] - m1);
      l0 += p0 + p2;
      l1 += p1 + p3;
      z0 = fmaf(p0, va.y, fmaf(p2, vb.y, z0));
      z1 = fmaf(p1, va.y, fmaf(p3, vb.y, z1));
      const float vsa = va.x * vsc, vsb = vb.x * vsc;
      const float w0 = p0 * vsa, w1 = p1 * vsa, w2 = p2 * vsb, w3 = p3 * vsb;
      const uint32_t h01 = pack_f16(w0, w1), h23 = pack_f16(w2, w3);
      const float2 r01 = unpack_f16(h01), r23 = unpack_f16(h23);
      const uint32_t l01 = pack_f16(w0 - r01.x, w1 - r01.y), l23 = pack_f16(w2 - r23.x, w3 - r23.y);
      const uint32_t bh0 = movmatrix_trans(h01), bh1 = movmatrix_trans(h23);
      const uint32_t bl0 = movmatrix_trans(l01), bl1 = movmatrix_trans(l23);
      const uint8_t* vt = slot + V_OFF;
#pragma unroll
      for (int sg = 0; sg < NSEG; ++sg) {
        uint32_t pa[16], pb[16];  // keys (2 tig, 2 tig + 1) and (+ 8), channels 16 gid + k
        v_pairs8(*reinterpret_cast<const uint4*>(vt + va0[sg]),
                 *reinterpret_cast<const uint4*>(vt + vb0[sg]), pa);
        v_pairs8(*reinterpret_cast<const uint4*>(vt + va1[sg]),
                 *reinterpret_cast<const uint4*>(vt + vb1[sg]), pb);
#pragma unroll
        for (int mb = 0; mb < 8; ++mb)
          mma16816(o[8 * sg + mb], pa[2 * mb], pa[2 * mb + 1], pb[2 * mb], pb[2 * mb + 1], bh0,
                   bh1);
#pragma unroll
        for (int mb = 0; mb < 8; ++mb)
          mma16816(o[8 * sg + mb], pa[2 * mb], pa[2 * mb + 1], pb[2 * mb], pb[2 * mb + 1], bl0,
                   bl1);
      }
    }
    __syncwarp();  // the slot is read: the next load may refill it
    if (i + STAGES < n_stages) load_stage(i + STAGES);
    cp_async_commit();
  }
  cp_async_wait<0>();
#pragma unroll
  for (int off = 4; off < 32; off <<= 1) {
    l0 += __shfl_xor_sync(FULL, l0, off);
    l1 += __shfl_xor_sync(FULL, l1, off);
    z0 += __shfl_xor_sync(FULL, z0, off);
    z1 += __shfl_xor_sync(FULL, z1, off);
  }
  // No CTA goes on while another of its cluster may still store into it;
  // every warp is done with its ring.
  cluster_sync();

  // Merge the 4 warps into the CTA's partial, v_zero's sum folded in (the
  // accumulator back from W's power of two and the codes' unit first).
  // sm_o [warp][column][channel].
  float* sm_o = reinterpret_cast<float*>(smem);
  float* sm_m = sm_o + WARPS * 8 * O_STRIDE;
  float* sm_l = sm_m + WARPS * 8;
  const float inv_vsc = 1.f / vsc;
  auto acc = [&](float x, float z) { return fmaf(x * (1.f / CODE_UNIT), inv_vsc, z); };
#pragma unroll
  for (int mb = 0; mb < DV / 16; ++mb) {
    float* c0 = sm_o + (warp * 8 + 2 * tig) * O_STRIDE + SEG * (mb >> 3) + 16 * gid + 2 * (mb & 7);
    *reinterpret_cast<float2*>(c0) = make_float2(acc(o[mb][0], z0), acc(o[mb][2], z0));
    *reinterpret_cast<float2*>(c0 + O_STRIDE) = make_float2(acc(o[mb][1], z1), acc(o[mb][3], z1));
  }
  if (gid == 0) {
    sm_m[warp * 8 + 2 * tig] = m0;
    sm_m[warp * 8 + 2 * tig + 1] = m1;
    sm_l[warp * 8 + 2 * tig] = l0;
    sm_l[warp * 8 + 2 * tig + 1] = l1;
  }
  __syncthreads();
  const size_t grp = (((size_t)h * p.QB + qb) * n + slice) * p.n_split;
  const size_t pbase = (grp + sp) * GB;
#pragma unroll
  for (int g = 0; g < GB; ++g) {
    float M = NEG_INF;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) M = fmaxf(M, sm_m[w * 8 + g]);
    float Ls = 0.f, A[NSEG];
#pragma unroll
    for (int k = 0; k < NSEG; ++k) A[k] = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float wt = exp2f(sm_m[w * 8 + g] - M);
      Ls += sm_l[w * 8 + g] * wt;
#pragma unroll
      for (int k = 0; k < NSEG; ++k) A[k] += sm_o[(w * 8 + g) * O_STRIDE + tid + SEG * k] * wt;
    }
#pragma unroll
    for (int k = 0; k < NSEG; ++k) p.part_acc[(pbase + g) * DV + tid + SEG * k] = A[k];
    if (tid == 0)
      *reinterpret_cast<float2*>(p.part_ml + (pbase + g) * 2) =
          make_float2(Ls > 0.f ? M * LN2 : NEG_INF, Ls);
  }

  // Arrive; the last of the group's n_split CTAs merges.
  __threadfence();
  __syncthreads();
  const int cidx = (h * p.QB + qb) * n + slice;
  if (tid == 0) sm_last = p.n_split == 1 || atomicAdd(p.counters + cidx, 1) == p.n_split - 1;
  __syncthreads();
  if (!sm_last) return;
  __threadfence();
  merge_slice<GB>(p, h, qb, slice, sNew);
  // Slot L read again: nothing keeps it live across the key loop.
  if (qb == 0 && slice == 0) append_token(p, h, min(p.lengths[h], C - 1));
  if (tid == 0) p.counters[cidx] = 0;
}

template <int GB>
int launch(const Params& p, int H, cudaStream_t st) {
  static bool configured[64] = {false};  // once per instantiation and device
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  if (!configured[dev]) {
    cudaError_t err = cudaFuncSetAttribute(quant8_cluster_kernel<GB>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           smem_bytes(CLUSTER_MAX));
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(quant8_cluster_kernel<GB>,
                                 cudaFuncAttributePreferredSharedMemoryCarveout,
                                 cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return (int)err;
    configured[dev] = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(H, p.n_split, p.QB * p.n_slice);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem_bytes(p.n_slice);
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = p.n_slice;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(&cfg, quant8_cluster_kernel<GB>, p);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// K3 at head_dim hd % 128 == 0 with n_slice = ceil(hd / 256) <= 8 column
// slices (hd <= 2048), with the scratch of csrc/decode_attn_wide.cu's: H
// ceil(G / 8) n_slice n_split min(G, 8) (256 + 2) floats, and H ceil(G / 8)
// n_slice counters.
extern "C" int kvcf_quant8_decode_attn_append_cluster(
    const void* q, void* k_codes, void* v_codes, void* scales, const void* lengths,
    const void* lower, const void* k_new, const void* v_new, void* out, void* part,
    void* counters, int H, int G, int C, int n_split, int n_slice, int hd, float scale,
    void* stream) {
  if (H < 1 || G < 1 || C < 1 || n_split < 1 || hd < 128 || hd % 128 != 0 ||
      n_slice != (hd + DV - 1) / DV || n_slice > CLUSTER_MAX ||
      (long long)((G + 7) / 8) * n_slice > 65535 || n_split > 65535 ||
      (long long)C * n_split >= (1LL << 32))
    return (int)cudaErrorInvalidValue;
  const int GB = G < 8 ? G : 8, QB = (G + 7) / 8;
  Params p;
  p.q = static_cast<const bf16*>(q);
  p.kc = static_cast<uint8_t*>(k_codes);
  p.vc = static_cast<uint8_t*>(v_codes);
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
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (GB) {  // G above 8 runs blocks of 8
    case 1: return launch<1>(p, H, st);
    case 2: return launch<2>(p, H, st);
    case 3: return launch<3>(p, H, st);
    case 4: return launch<4>(p, H, st);
    case 5: return launch<5>(p, H, st);
    case 6: return launch<6>(p, H, st);
    case 7: return launch<7>(p, H, st);
    case 8: return launch<8>(p, H, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The kernel's dynamic shared memory at n_slice slices (info[0], bytes) and
// how many clusters of n_slice CTAs the device holds at once (info[1],
// cudaOccupancyMaxActiveClusters), at GB 1.
extern "C" int kvcf_quant8_decode_cluster_info(int n_slice, int* info) {
  if (n_slice < 1 || n_slice > CLUSTER_MAX) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(quant8_cluster_kernel<1>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         smem_bytes(CLUSTER_MAX));
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(1, 1, n_slice);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem_bytes(n_slice);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = n_slice;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  info[0] = smem_bytes(n_slice);
  return (int)cudaOccupancyMaxActiveClusters(&info[1], quant8_cluster_kernel<1>, &cfg);
}
