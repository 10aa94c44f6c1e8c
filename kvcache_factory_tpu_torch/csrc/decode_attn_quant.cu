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
//   s_j = (q / sqrt(D)) . k_j = ks_j * (q . c_j) / sqrt(D) + kz_j * sum(q) / sqrt(D)
//   out = softmax over those keys plus the new token, whose logit and value
//         come from k_new / v_new in fp32: sum_j p_j (vs_j c_j + vz_j) + p_new v_new;
//         fp32 softmax.
//   Then the new token is quantized per token, as the plain version does:
//   min and max over D, scale = max(max - min, 1e-8) / 255 (or / 15) with
//   IEEE division, codes rintf((x - min) / scale) clamped to [0, 255] (or
//   [0, 15]); its codes and four bf16 scalars are written into slot L.
// The caller advances lengths to min(lengths + 1, C).  Any capacity C > 0,
// any G >= 1, head_dim D in {128, 256, 384, 512} (a template parameter; the
// per-token cache exists only at D % 128 == 0, as in the JAX package; the
// library exports kvcf_quant8_decode_attn_append_d<D> and _quant4_ for
// each).  Above 128 each lane's channels are NSEG = D / 128 segments of
// 128, each laid out as at D 128; the numbers below are at D 128.  At D 384
// and 512 (Ring::WIDE) the lane's q fragments (64 registers at D 512) would
// not fit beside its O (D / 4 floats): the CTA's warp 0 writes them to
// shared memory once and every warp reads them at each k-step, and a key
// tile's K words are read one segment at a time.  A warp's 3-stage ring is
// then 37-50 KB, one CTA an SM.
//
// What bounds it: reading the valid codes and scalars, per valid token-head
// 2 * D bytes of codes (int8) or D (int4) plus 8 bytes of scalars.  At the
// main path's 64 cache heads with 115,520 valid token-heads a layer that is
// 30.5 MB (9.1 us at 3.35 TB/s) for int8 and 15.7 MB (4.7 us) for int4.  The
// arithmetic is about 2 FLOP per code byte (int8) or 4 (int4), far below the
// card's ratio of operations to bytes, so bytes bound it; but the
// instructions that turn codes into tensor-core operands compete with them
// (in K4 45% of the key loop's instructions; an int8 byte holds half as many
// codes, so K3 spends about half as many per byte).
//
// One kernel template, decode_body<NBITS, D, GB>, is both K3 (quant8_decode_kernel)
// and K4 (quant4_decode_kernel); K2's scheme (decode_attn.cu):
//  1. One launch per call, grid (H, n_split, QB): as in K2, a CTA computes
//     GB = min(G, 8) query rows (the mma's N), so G above 8 runs QB =
//     ceil(G / 8) query blocks of CTAs, each reading its keys; no thread
//     holds more accumulators than at G 8.  n_split comes from the shapes
//     and the SM count only (decode_attn.split_count over H QB CTAs a
//     split: two CTAs an SM in one wave, as K2).  K4 fits three (51 KB of shared memory, at most 170
//     registers), so the wave never waits on a slot; filling all three with
//     more splits was slower (more merge work).  K3 fits two by its launch
//     bounds (49.5 KB, at most 255 registers).  CTA
//     (h, sp, qb) takes the sp-th of n_split near-equal parts of its head's
//     valid keys [lower, L) (decode_attn.split_bounds), writes its partial
//     (acc[GB][D], m, l, and each row's new-token logit) in fp32 and raises
//     the head's arrival counter (K2's per-device workspace) by a
//     device-scope release after a CTA barrier; an empty part still writes
//     a partial and arrives.  The CTA that arrives last (of n_split QB)
//     copies each query block's partials into shared memory at once
//     (cp.async, one round trip) and merges them in split order, so two
//     launches are bitwise equal; it folds in the new token, writes out and
//     resets the counter to 0, so a replayed CUDA graph finds the counters
//     at 0.  CTA (h, 0, 0) quantizes the new token into slot L at its
//     start: no CTA reads slot L, so the append needs no ordering.  The
//     small reads (q, k_new, v_new) go out before the lengths, and the new
//     token's logit is taken then, so the merge's only loads are the
//     partials.
//  2. Each of the 4 warps streams TILES tiles of 16 keys a stage with
//     cp.async (rows past the range zero-filled) into its own 3-stage ring:
//     K codes, V codes, then 8 B of scalars a key.  K4: 2 tiles, 2 KB + 2 KB
//     + 256 B a stage, 12.75 KB a warp, 51 KB a CTA; K3: 1 tile, 2 KB + 2 KB
//     + 128 B, 12.4 KB a warp, 49.5 KB a CTA (2 tiles, 99 KB, were no faster
//     at the main path's shape: PERF.md, PR 10).  The warps' tiles
//     interleave (tile t of warp w starts at key 64 t + 16 w of the stage),
//     so a short last stage spreads over the warps.  A warp waits only for
//     its own copies: no CTA barrier in the loop.  cp.async, not TMA bulk
//     copies: a token's 8 bytes of scalars start on an 8-byte boundary,
//     which a bulk copy does not take, and the swizzles below need the
//     per-chunk placement.  For K4 four tiles a
//     stage at two CTAs an SM, four stages, or four CTAs an SM were no
//     faster (PERF.md, K4's findings).
//  3. No conversion instruction per code; both products on the tensor
//     cores with mma.sync m16n8k16, keys as M and the GB query rows as N = 8
//     (so a block needs no padding):
//       S^T [16 keys, 8] = K [16, D] . q^T
//       O^T [D, 8] += V^T [D, 16 keys] . W^T,  W = p * v_scale
//     The zero points add kz_j sum(q) to each logit and sum_j p_j vz_j to
//     every channel, kept per column.
//     K4 (bf16 operands): a code word holds 8 nibbles; shifted by 0, 4, 8 or
//     12 bits and put through one LOP3 ((x & 0x000f000f) | 0x43004300, bf16
//     128.0 twice) it gives two bf16 values 128 + n, exactly.  A lane's K
//     A registers hold channels (c, c + 4), (c + 1, c + 5), ... of one key,
//     so q^T's B fragment is built with the same channel permutation; the
//     offset comes out once per score as dot - 128 sum(q).  V^T's A
//     registers pair one channel of two keys: byte_perm lays two keys'
//     bytes side by side before the LOP3, and an exact bf16 subtraction
//     removes the offset (folding it into the sum instead would leave a
//     cancellation of 128 sum(w) against the output that the 3e-3 limit
//     cannot carry).  W enters as bf16 hi + lo (2^-17 relative), as in K2.
//     K3 (fp16 operands): bf16 keeps 8 significant bits, too few for 128 + n
//     up to 383, so K3 runs the products in fp16 (11 bits).  One PRMT of a
//     code word against zero gives two fp16 subnormals n * 2^-24, exact
//     (CODE_UNIT below, the choice and why); a lane's K A registers hold
//     channels (c, c + 1), (c + 2, c + 3) of its own 4-byte words, so q's B
//     fragment needs no permutation.  V^T's pairs take one PRMT of two keys' words
//     for every 4 channels, then one PRMT a pair.  fp16's range is the
//     price: each query row of q is scaled by a power of two (exact) that
//     puts its largest entry in [2^14, 2^15), folded back into each column's
//     logit scale with log2(e) / sqrt(D); W = p * v_scale enters as fp16 hi +
//     lo (2^-22 relative) scaled by a power of two that puts the warp's
//     largest v_scale so far in [2^14, 2^15): it is set at the warp's first
//     stage and lowered (the accumulator rescaled with it, exactly) only
//     when a larger v_scale arrives, so W stays below fp16's 65504, and a
//     v_scale small enough that W would underflow fp16 (below 6.1e-5) keeps
//     its bits.  So the kernel holds to the plain version for any bf16 q
//     whose largest entry is below 2^117 and any v_scale.
//     Neither holds an I2F/I2FP for codes: the only int-to-float
//     instructions are the reciprocal steps (I2F.*.RP) of the split rule's
//     integer divisions, outside the key loop.  K's codes are read with
//     16-byte shared loads, V's with 8-byte (K4) or 16-byte (K3) loads, on
//     rows whose 16-byte chunks are XOR-swizzled (Ring below) so that no two
//     lanes of a load phase meet in a bank.
//  4. One softmax rescale per stage, and only when a column's max rose (or,
//     in K3, W's power of two fell): the stage's max per column (three
//     shuffles), ex2.approx with log2(e) / sqrt(D) folded into each key's
//     scale; partials leave in natural-log units.  Masked logits are NEG_INF
//     (-FLT_MAX), never -inf; every tile of a stage that holds one of the
//     warp's keys is computed (a tile past the range is zero-filled and
//     masked), k-chunks outer and tiles inner, so neighbouring mma are
//     independent.
// Built without --use_fast_math, so the divisions of the append are IEEE,
// as in PyTorch and XLA.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

namespace {
namespace kq {

typedef __nv_bfloat16 bf16;

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;
constexpr float NEG_INF = -3.4028234663852886e38f;  // float32 finfo.min
constexpr int TILE = 16;                          // keys of one mma tile: its M
constexpr int TILE_STRIDE = WARPS * TILE;         // keys from one of a warp's tiles to the next
constexpr int STAGES = 3;
constexpr int SEG = 128;                          // channels a segment (D 256: two)
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// K3's codes as fp16: the byte n under a zero high byte is the fp16
// subnormal n * 2^-24, exact, and the tensor cores multiply fp16 subnormals
// exactly (the checks on the card hold K3 to its plain version); the 2^24 is
// folded into the logit scale and W's power of two.  The other choice, the
// byte under 0x64 (1024 + n), needs the offset taken out of every score and
// every V code: 75 more instructions a stage of the key loop and no faster
// (PERF.md, PR 10).
constexpr float CODE_UNIT = 1.f / 16777216.f;  // the value of code 1

// The ring of one warp, by code width and head_dim (bytes at D 128).  A key
// row is ROW bytes of codes (CHUNKS 16-byte chunks); a slot holds a stage:
// K rows, V rows, then each key's four bf16 scalars.  Chunk c of row r lies
// at k_chunk / v_chunk.
template <int NBITS, int D>
struct Ring {
  static_assert(D == 128 || D == 256 || D == 384 || D == 512, "head_dim 128, 256, 384 or 512");
  static constexpr int NSEG = D / SEG;                      // 128-channel segments
  static constexpr bool WIDE = NSEG > 2;                    // q's fragments in shared memory
  static constexpr int TILES = NBITS == 4 ? 2 : 1;          // tiles a warp a stage
  static constexpr int WARP_KEYS = TILES * TILE;            // 32 or 16
  static constexpr int STAGE_KEYS = WARPS * WARP_KEYS;      // keys a CTA a stage
  static constexpr int ROW = D * NBITS / 8;                 // 64 or 128 code bytes a key
  static constexpr int CHUNKS = ROW / 16;
  static constexpr int V_OFF = WARP_KEYS * ROW;
  static constexpr int S_OFF = 2 * WARP_KEYS * ROW;
  static constexpr int SLOT_BYTES = S_OFF + WARP_KEYS * 8;  // 4.25 or 4.125 KB
  static constexpr int WARP_RING = STAGES * SLOT_BYTES;
  static constexpr int SMEM_BYTES = WARPS * WARP_RING;      // 51 or 49.5 KB (D 256: 99, 97.5)
  // WIDE: q's fragments after the rings, D / 16 k-chunks x 32 lanes x 8 bytes.
  static constexpr int Q_BYTES = WIDE ? D * 16 : 0;
  // CTAs an SM can hold (launch bounds: at most 170 or 255 registers); at
  // D 256 the ring is twice as large and two fit, at D 384 and 512 one.
  static constexpr int CTAS_PER_SM = WIDE ? 1 : NBITS == 4 && D == 128 ? 3 : 2;
  static constexpr float QMAX = NBITS == 8 ? 255.f : 15.f;
  static constexpr int O_STRIDE = D + 4;  // padded row of the warp merge
  static constexpr int PART = D + 4;      // floats of one split's partial a query row: acc[D], m, l, s_new, 1 unused
  static constexpr int CPL = D / 32;      // channels a lane in the head merge
  // K4 at D 128 reads K rows whole in 16-byte pieces (no swizzle) and 8-byte
  // pieces of V at chunk c ^ 2 ((r >> 2) & 1).  At D 256 and 512 (rows of a
  // multiple of 128 bytes, as K3's at D 128) it reads chunks 4 s + tig of K
  // rows gid and gid + 8 at chunk c ^ 4 (r & 1), and V at chunk c ^ 2 ((r >>
  // 1) & 3).  At D 384 a row is 12 chunks, which an XOR of 4 would leave:
  // no swizzle (the 192-byte row stride already puts rows gid and gid + 1
  // half a bank sweep apart).  K3 reads chunks 8 s + 2 tig and 8 s + 2 tig +
  // 1 of K rows gid and gid + 8 (rows of one phase alternate) and chunk 8 s
  // + gid of V rows 2 tig (+1, +8, +9), segment s.
  static __device__ __forceinline__ int k_chunk(int c, int r) {
    if constexpr (NBITS == 4) return ROW == 64 || ROW == 192 ? c : c ^ ((r & 1) << 2);
    return c ^ (r & 1);
  }
  static __device__ __forceinline__ int v_chunk(int c, int r) {
    if constexpr (NBITS == 4 && ROW == 64) return c ^ (2 * ((r >> 2) & 1));
    if constexpr (NBITS == 4 && ROW == 192) return c;
    return c ^ (((r >> 1) & 3) << 1);
  }
  static_assert(WARPS * 8 * O_STRIDE * 4 + 3 * WARPS * 8 * 4 <= SMEM_BYTES, "warp merge");
  static_assert(SMEM_BYTES >= 8 * PART * 4, "the merge holds at least one split of G = 8");
};

struct Params {
  const bf16* q;        // [H, G, D]
  uint8_t* kc;          // [H, C, D * NBITS / 8]
  uint8_t* vc;          // [H, C, D * NBITS / 8]
  bf16* sc;             // [H, C, 4]
  const int* lengths;   // [H]
  const int* lower;     // [H] or null
  const bf16* k_new;    // [H, D]
  const bf16* v_new;    // [H, D]
  bf16* out;            // [H, G, D]
  float* part;          // [H, QB, n_split, GB, D + 4]: acc[D], m (natural log), l, s_new
  int* counters;        // [>= H], 0 between launches
  int C, n_split;
  int G, QB;            // query rows a head; query blocks of GB rows
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

// d += a . b, m16n8k16, bf16 (F16 false) or fp16 in, fp32 accumulate.
template <bool F16>
__device__ __forceinline__ void mma16816(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  if constexpr (F16)
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
  else
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
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

// (x & NIB) | MAGIC: the nibbles in bits 0-3 and 16-19 of x as two bf16
// values 128 + n.  One LOP3 (nvcc splits the C expression into two).  A
// nibble n in bits 0-3 of a bf16 whose other bits are 0x4300 (128.0) is
// 128 + n, exactly (bf16 keeps 7 mantissa bits: bits 4-7 would reach the
// exponent, so the high nibbles are shifted down first).
constexpr uint32_t NIB = 0x000f000fu, MAGIC = 0x43004300u;
constexpr float OFFSET4 = 128.f;
__device__ __forceinline__ uint32_t nib_bf16(uint32_t x) {
  uint32_t r;
  asm("lop3.b32 %0, %1, %2, %3, 0xea;\n" : "=r"(r) : "r"(x), "n"(NIB), "n"(MAGIC));
  return r;
}

// Bytes 0 and 1 (sel 0x4140) or 2 and 3 (sel 0x4342) of x as two fp16
// codes n * 2^-24: one PRMT.
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

// x - y on two bf16 lanes (exact here: (128 + n) - 128).
__device__ __forceinline__ uint32_t sub_bf16x2(uint32_t x, uint32_t y) {
  __nv_bfloat162 r = __hsub2(*reinterpret_cast<__nv_bfloat162*>(&x),
                             *reinterpret_cast<__nv_bfloat162*>(&y));
  return *reinterpret_cast<uint32_t*>(&r);
}

// K4: two code words of one key (8 bytes: channels c .. c + 15) and the same
// two of the next key -> the 16 bf16 pairs (this key's code, the next key's
// code) of channels c + k, k = 0..15, exact integers 0..15: per 4 pairs one
// byte_perm, three shifts, four LOP3 and four subtractions.  `lo`/`hi` are
// byte_perm selectors that put this key's bytes 0-1 (2-3) in the low half
// and the next key's in the high half, whichever of the two was loaded
// first.
__device__ __forceinline__ void v_pairs4(uint2 first, uint2 second, uint32_t lo, uint32_t hi,
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

// K3: 16 code bytes of key a (channels c .. c + 15) and the same of key b
// -> the 16 fp16 pairs (a's code, b's code) of channels c + k: per 4 pairs
// two PRMT that interleave the keys' bytes, then one PRMT a pair.
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

// The last CTA of head h to arrive: merge the n_split partials of each
// query row in split order, fold in the new token, write out and reset the
// counter.  One query block of GB rows at a time: its partials come into
// shared memory (`buf`, the ring's BUF bytes) by cp.async, as many splits
// at a time as fit, all in flight together: one round trip a chunk.  Warp
// w then folds the block's rows w and w + 4, lane l channels CPL l .. CPL l
// + CPL - 1 (CPL = D / 32): the chunk's max, one rescale, one exp per
// split, the exps of 32 splits at a time on the 32 lanes.  The new token's
// logit of each row comes with its partials (every split of a block holds
// the same; split 0's is read) and its value in `vn`, read at the start of
// the launch.
template <int D, int GB, int BUF>
__device__ void merge_head(const Params& p, int h, const float (&vn)[D / 32], uint8_t* buf) {
  constexpr int PART = D + 4, CPL = D / 32;
  constexpr int ROWS = (GB + WARPS - 1) / WARPS;         // query rows a warp folds
  constexpr int CHUNK = BUF / (GB * PART * 4);           // splits a round trip
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, d = lane * CPL;
  const int ns = p.n_split;
  const float* sp_buf = reinterpret_cast<const float*>(buf);
  for (int qb = 0; qb < p.QB; ++qb) {
    const int g0 = qb * GB;
    const float* part = p.part + ((size_t)h * p.QB + qb) * ns * GB * PART;
    float M[ROWS], Ls[ROWS], a[ROWS][CPL], sn[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      M[r] = NEG_INF;
      Ls[r] = 0.f;
      sn[r] = 0.f;
#pragma unroll
      for (int i = 0; i < CPL; ++i) a[r][i] = 0.f;
    }
    for (int s0 = 0; s0 < ns; s0 += CHUNK) {
      const int pieces = min(CHUNK, ns - s0) * GB * PART / 4;  // 16-byte pieces
      __syncthreads();  // the ring, or the last chunk, is no longer read
      for (int i = tid; i < pieces; i += THREADS)
        cp_async16(smem_u32(buf) + i * 16, part + (size_t)s0 * GB * PART + i * 4, 16);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
      const int n = min(CHUNK, ns - s0);
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const int g = warp + r * WARPS;
        if (g >= GB) break;
        if (s0 == 0) sn[r] = sp_buf[g * PART + D + 2];
        auto ml_of = [&](int s) {  // (m, l) of split s0 + s, query row g
          return *reinterpret_cast<const float2*>(sp_buf + (s * GB + g) * PART + D);
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
        for (int i = 0; i < CPL; ++i) a[r][i] *= alpha;
        // Each lane weighs one split of every 32; the weights go round by
        // shuffles while each lane adds its CPL channels, in split order.
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
#pragma unroll
            for (int i = 0; i < CPL; i += 4) {
              const float4 x =
                  *reinterpret_cast<const float4*>(sp_buf + ((b + j) * GB + g) * PART + d + i);
              a[r][i] += wj * x.x;
              a[r][i + 1] += wj * x.y;
              a[r][i + 2] += wj * x.z;
              a[r][i + 3] += wj * x.w;
            }
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
      if (g >= GB || g0 + g >= p.G) break;  // a short last block's rows past G
      const float s_new = sn[r];
      const float m_f = fmaxf(M[r], s_new);
      const float alpha = expf(M[r] - m_f), p_new = expf(s_new - m_f);
      const float inv = 1.f / (Ls[r] * alpha + p_new);
      __align__(16) bf16 o[CPL];
#pragma unroll
      for (int i = 0; i < CPL; ++i) o[i] = __float2bfloat16((a[r][i] * alpha + p_new * vn[i]) * inv);
#pragma unroll
      for (int i = 0; i < CPL; i += 4)
        *reinterpret_cast<uint2*>(p.out + ((size_t)h * p.G + g0 + g) * D + d + i) =
            *reinterpret_cast<const uint2*>(o + i);
    }
  }
  if (tid == 0) p.counters[h] = 0;
}

// Quantize the new token (channels threadIdx.x + 128 i: kn of k_new, vn of
// v_new) as the plain version does and write it into slot L: min and max
// over D (a warp reduction, then across the 4 warps), scale = max(max -
// min, 1e-8) / QMAX with IEEE division, codes rintf((x - min) / scale)
// clamped to [0, QMAX] (rintf rounds half to even, as torch.round).  One
// CTA of the head does it; no CTA reads slot L, so it may at any time.
template <int NBITS, int D>
__device__ void append_token(const Params& p, int h, int L, const float (&kn)[D / SEG],
                             const float (&vn)[D / SEG]) {
  __shared__ float ext[WARPS][4];
  constexpr int NSEG = D / SEG;
  constexpr float QMAX = Ring<NBITS, D>::QMAX;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float kmn = kn[0], kmx = kn[0], vmn = vn[0], vmx = vn[0];
#pragma unroll
  for (int i = 1; i < NSEG; ++i) {
    kmn = fminf(kmn, kn[i]); kmx = fmaxf(kmx, kn[i]);
    vmn = fminf(vmn, vn[i]); vmx = fmaxf(vmx, vn[i]);
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
  const float ks = fmaxf(kmx - kmn, 1e-8f) / QMAX;
  const float vs = fmaxf(vmx - vmn, 1e-8f) / QMAX;
  const size_t row = (size_t)h * p.C + L;
  constexpr int ROW = Ring<NBITS, D>::ROW;
#pragma unroll
  for (int i = 0; i < NSEG; ++i) {
    const int c = tid + SEG * i;  // this channel
    const int kq = (int)fminf(fmaxf(rintf((kn[i] - kmn) / ks), 0.f), QMAX);
    const int vq = (int)fminf(fmaxf(rintf((vn[i] - vmn) / vs), 0.f), QMAX);
    if constexpr (NBITS == 8) {
      p.kc[row * ROW + c] = (uint8_t)kq;
      p.vc[row * ROW + c] = (uint8_t)vq;
    } else {  // even channel c takes the low nibble of byte c / 2, c + 1 the high one
      const int kq_hi = __shfl_down_sync(FULL, kq, 1);
      const int vq_hi = __shfl_down_sync(FULL, vq, 1);
      if ((tid & 1) == 0) {
        p.kc[row * ROW + c / 2] = (uint8_t)(kq | (kq_hi << 4));
        p.vc[row * ROW + c / 2] = (uint8_t)(vq | (vq_hi << 4));
      }
    }
  }
  if (tid == 0) {
    bf16* s4 = p.sc + row * 4;
    s4[0] = __float2bfloat16(ks);
    s4[1] = __float2bfloat16(kmn);
    s4[2] = __float2bfloat16(vs);
    s4[3] = __float2bfloat16(vmn);
  }
}

// One CTA (h, sp, qb) of K3 (NBITS 8) or K4 (NBITS 4) at head_dim D: its
// share of the head's keys for query rows [GB qb, GB qb + GB), its partial,
// the arrival, and the merge if it arrives last.
template <int NBITS, int D, int GB>
__device__ __forceinline__ void decode_body(const Params& p, uint8_t* smem, int* sm_last) {
  using R = Ring<NBITS, D>;
  constexpr int ROW = R::ROW, CHUNKS = R::CHUNKS, NSEG = R::NSEG, CPL = R::CPL;
  constexpr int O_STRIDE = R::O_STRIDE, PART = R::PART;
  constexpr bool F16 = NBITS == 8;
  const int h = blockIdx.x, sp = blockIdx.y, qb = blockIdx.z;
  const int g0 = qb * GB;  // this CTA's first query row
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int C = p.C;
  // The small reads go out before the lengths, so that they neither wait
  // for them nor queue behind the codes: this lane's 32 channels of each
  // segment of q row g0 + gid and of k_new (the new token's logit), the CPL
  // channels of v_new the merge writes, and channels tid + 128 i of k_new
  // and v_new for the append.  Then the first stage's copies; the rest of
  // the ring is issued once q is in registers, so each SM's first stages
  // are served first.
  const bool q_row = gid < GB && g0 + gid < p.G;  // else a zero query
  // WIDE: one segment of q and k_new at a time (QSEG of NSEG held at once).
  constexpr int QSEG = R::WIDE ? 1 : NSEG;
  uint4 q_raw[4 * QSEG], kn_raw[4 * QSEG];
  auto load_q_seg = [&](int sg, int at) {  // segment sg into slots [4 at, 4 at + 4)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int c = SEG * sg + 32 * tig + 8 * i;
      q_raw[4 * at + i] = q_row ? *reinterpret_cast<const uint4*>(
                                      p.q + ((size_t)h * p.G + g0 + gid) * D + c)
                                : make_uint4(0, 0, 0, 0);
      kn_raw[4 * at + i] = *reinterpret_cast<const uint4*>(p.k_new + (size_t)h * D + c);
    }
  };
  if constexpr (!R::WIDE) {
#pragma unroll
    for (int sg = 0; sg < NSEG; ++sg) load_q_seg(sg, sg);
  }
  uint2 vn_raw[CPL / 4];
#pragma unroll
  for (int i = 0; i < CPL / 4; ++i)
    vn_raw[i] = *reinterpret_cast<const uint2*>(p.v_new + (size_t)h * D + CPL * lane + 4 * i);
  float kn_own[NSEG], vn_own[NSEG];
#pragma unroll
  for (int i = 0; i < NSEG; ++i) {
    kn_own[i] = __bfloat162float(p.k_new[(size_t)h * D + tid + SEG * i]);
    vn_own[i] = __bfloat162float(p.v_new[(size_t)h * D + tid + SEG * i]);
  }
  const int L = min(p.lengths[h], C - 1);
  const int lo = p.lower ? min(max(p.lower[h], 0), L) : 0;
  // This CTA's share of [lo, L): the sp-th of n_split near-equal parts.
  const long long n = L - lo;
  const int start = lo + (int)(n * sp / p.n_split);
  const int end = lo + (int)(n * (sp + 1) / p.n_split);
  const int n_stages = (end - start + R::STAGE_KEYS - 1) / R::STAGE_KEYS;

  // Stage i holds keys start + STAGE_KEYS i + 64 t + 16 warp + r of tile t,
  // row r.  Each lane copies piece 32 j + lane of the stage's K and V rows
  // of CHUNKS 16-byte pieces (row (32 j + lane) / CHUNKS: at D 128 chunk
  // lane % CHUNKS of rows lane / CHUNKS + (32 / CHUNKS) j; a row of 24 or 12
  // pieces at D 384 spans lanes), and the scalars of rows lane + 32 j; rows
  // past the range are zero-filled.
  const uint32_t ring = smem_u32(smem) + warp * R::WARP_RING;
  const uint8_t* kh = p.kc + (size_t)h * C * ROW;
  const uint8_t* vh = p.vc + (size_t)h * C * ROW;
  const bf16* sh = p.sc + (size_t)h * C * 4;
  auto key_of = [&](int base, int rr) {
    return base + TILE_STRIDE * (rr / TILE) + TILE * warp + rr % TILE;
  };
  auto load_stage = [&](int i) {
    const int base = start + i * R::STAGE_KEYS;
    if (base + TILE * warp >= end) return;  // none of this warp's keys
    const uint32_t slot = ring + (i % STAGES) * R::SLOT_BYTES;
#pragma unroll
    for (int j = 0; j < R::WARP_KEYS * CHUNKS / 32; ++j) {
      const int rr = (32 * j + lane) / CHUNKS, cp_chunk = (32 * j + lane) % CHUNKS;
      const int key = key_of(base, rr);
      const bool valid = key < end;
      const size_t off = (size_t)(valid ? key : start) * ROW + cp_chunk * 16;
      cp_async16(slot + rr * ROW + R::k_chunk(cp_chunk, rr) * 16, kh + off, valid ? 16 : 0);
      cp_async16(slot + R::V_OFF + rr * ROW + R::v_chunk(cp_chunk, rr) * 16, vh + off,
                 valid ? 16 : 0);
    }
#pragma unroll
    for (int rr = lane; rr < R::WARP_KEYS; rr += 32) {
      const int key = key_of(base, rr);
      const bool valid = key < end;
      cp_async8(slot + R::S_OFF + rr * 8, sh + (size_t)(valid ? key : start) * 4, valid ? 8 : 0);
    }
  };

  if (n_stages > 0) load_stage(0);
  cp_async_commit();

  // q^T as the B operand of S^T = K q^T.  Lane (gid, tig) holds query row
  // g0 + gid (zero past the block or G) at channels 128 s + 32 tig .. 128 s + 32 tig + 31 of
  // each segment s, the channels whose codes it reads from each key; the
  // k-chunks of segment s are 8 s .. 8 s + 7.  K4: the channels of the
  // contraction are permuted to match the A fragments the nibble unpacking
  // gives: k-chunk 8 s + 2j + e, positions 2tig, 2tig + 1, 2tig + 8, 2tig + 9
  // hold channels c + 2e, c + 2e + 4, c + 2e + 1, c + 2e + 5 with c = 128 s +
  // 32 tig + 8 j.  K3: k-chunk 8 s + j, the same positions hold channels c,
  // c + 1, c + 2, c + 3 with c = 128 s + 32 tig + 4 j, as fp16 times the
  // row's power of two qsc.
  uint32_t qf[R::WIDE ? 1 : D / 16][2];
  float qs = 0.f, s_new = 0.f;  // sum of q over the channels; q . k_new
  float qsc = 1.f;              // K3: q's power of two
  uint2* qsm = reinterpret_cast<uint2*>(smem + R::SMEM_BYTES);  // WIDE: [D / 16][32] fragments
  if constexpr (R::WIDE) {
    // The same fragments as below, a segment at a time: K3's power of two
    // needs the row's largest entry first (a pass over q), then each
    // segment's k-chunks go to shared memory (warp 0 writes, every warp
    // holds the same), and qs and s_new add the channels in the same order.
    const uint16_t* qv = reinterpret_cast<const uint16_t*>(q_raw);
    const uint16_t* kv = reinterpret_cast<const uint16_t*>(kn_raw);
    auto qx = [&](int k) { return __bfloat162float(__ushort_as_bfloat16(qv[k])); };
    if constexpr (NBITS == 8) {
      float amax = 0.f;
#pragma unroll
      for (int sg = 0; sg < NSEG; ++sg) {
        load_q_seg(sg, 0);
#pragma unroll
        for (int k = 0; k < 32; ++k) amax = fmaxf(amax, fabsf(qx(k)));
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) amax = fmaxf(amax, __shfl_xor_sync(FULL, amax, off));
      qsc = pow2_to_2e14(amax);
    }
#pragma unroll
    for (int sg = 0; sg < NSEG; ++sg) {
      load_q_seg(sg, 0);
      uint32_t f[8][2];
      if constexpr (NBITS == 4) {
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int c = 8 * j + 2 * e;
            f[2 * j + e][0] = qv[c] | ((uint32_t)qv[c + 4] << 16);
            f[2 * j + e][1] = qv[c + 1] | ((uint32_t)qv[c + 5] << 16);
          }
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          f[j][0] = pack_f16(qx(4 * j) * qsc, qx(4 * j + 1) * qsc);
          f[j][1] = pack_f16(qx(4 * j + 2) * qsc, qx(4 * j + 3) * qsc);
        }
      }
      if (warp == 0)
#pragma unroll
        for (int j = 0; j < 8; ++j) qsm[(8 * sg + j) * 32 + lane] = make_uint2(f[j][0], f[j][1]);
#pragma unroll
      for (int k = 0; k < 32; ++k) {
        const float x = qx(k);
        qs += x;
        s_new = fmaf(x, __bfloat162float(__ushort_as_bfloat16(kv[k])), s_new);
      }
    }
  } else {
    const uint16_t* qv = reinterpret_cast<const uint16_t*>(q_raw);
    const uint16_t* kv = reinterpret_cast<const uint16_t*>(kn_raw);
    auto qx = [&](int k) { return __bfloat162float(__ushort_as_bfloat16(qv[k])); };
    if constexpr (NBITS == 4) {
#pragma unroll
      for (int sg = 0; sg < NSEG; ++sg)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int c = 32 * sg + 8 * j + 2 * e;
            qf[8 * sg + 2 * j + e][0] = qv[c] | ((uint32_t)qv[c + 4] << 16);
            qf[8 * sg + 2 * j + e][1] = qv[c + 1] | ((uint32_t)qv[c + 5] << 16);
          }
    } else {
      float amax = 0.f;
#pragma unroll
      for (int k = 0; k < 32 * NSEG; ++k) amax = fmaxf(amax, fabsf(qx(k)));
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) amax = fmaxf(amax, __shfl_xor_sync(FULL, amax, off));
      qsc = pow2_to_2e14(amax);
#pragma unroll
      for (int j = 0; j < 8 * NSEG; ++j) {
        qf[j][0] = pack_f16(qx(4 * j) * qsc, qx(4 * j + 1) * qsc);
        qf[j][1] = pack_f16(qx(4 * j + 2) * qsc, qx(4 * j + 3) * qsc);
      }
    }
#pragma unroll
    for (int k = 0; k < 32 * NSEG; ++k) {
      const float x = qx(k);
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
  if (sp == 0 && qb == 0) append_token<NBITS, D>(p, h, L, kn_own, vn_own);  // CTA-uniform
  if constexpr (R::WIDE) __syncthreads();  // q's fragments are in shared memory
  // k-chunk kc's B fragment of this lane.
  auto q_frag = [&](int kc) {
    if constexpr (R::WIDE)
      return qsm[kc * 32 + lane];
    else
      return make_uint2(qf[kc][0], qf[kc][1]);
  };
  // This lane's accumulator columns are query rows 2 tig and 2 tig + 1.
  // A score is ks kf (dot - qo) + kz ql: kf turns the product's units into
  // log2 units of (q . k) / sqrt(D), qo is what K4's code offset adds to the
  // dot.
  const float qs0 = __shfl_sync(FULL, qs, 8 * tig), qs1 = __shfl_sync(FULL, qs, 8 * tig + 4);
  const float sl2 = p.scale * LOG2E;  // logits in log2 units
  const float ql0 = qs0 * sl2, ql1 = qs1 * sl2;
  float qo0 = 0.f, qo1 = 0.f, kf0 = sl2, kf1 = sl2;
  if constexpr (NBITS == 4) {
    qo0 = OFFSET4 * qs0;
    qo1 = OFFSET4 * qs1;
  } else {
    const float qsc0 = __shfl_sync(FULL, qsc, 8 * tig), qsc1 = __shfl_sync(FULL, qsc, 8 * tig + 4);
    kf0 = sl2 / (CODE_UNIT * qsc0);
    kf1 = sl2 / (CODE_UNIT * qsc1);
  }

  // K reads, segment s.  K4: rows gid and gid + 8, chunk 4 s + tig (8
  // nibble words).  K3: the same rows, chunks 8 s + 2 tig and 8 s + 2 tig + 1,
  // at their swizzled places.
  int ko0[NSEG], ko1[NSEG];
#pragma unroll
  for (int sg = 0; sg < NSEG; ++sg) {
    ko0[sg] = gid * ROW + (R::k_chunk(NBITS == 4 ? 4 * sg + tig : 8 * sg + 2 * tig, gid) << 4);
    ko1[sg] = gid * ROW + (R::k_chunk(8 * sg + 2 * tig + 1, gid) << 4);
  }
  // V reads, segment s.  K4: rows 2 tig and 2 tig + 1 (+ 8), the odd lanes'
  // first read the odd row, 8-byte piece gid of the segment's 64 bytes at
  // its swizzled place.  K3: rows 2 tig, 2 tig + 1, 2 tig + 8, 2 tig + 9,
  // 16-byte chunk 8 s + gid.
  const int odd = NBITS == 4 ? tig & 1 : 0;
  const uint32_t sel_lo = odd ? 0x1054u : 0x5410u, sel_hi = odd ? 0x3276u : 0x7632u;
  const int v_first = 2 * tig + odd, v_second = 2 * tig + 1 - odd;
  auto v_addr = [&](int r, int sg) {  // byte offset of row r's piece gid of segment sg
    if constexpr (NBITS == 4)
      return r * ROW + (R::v_chunk(4 * sg + (gid >> 1), r) << 4) + (gid & 1) * 8;
    else
      return r * ROW + (R::v_chunk(8 * sg + gid, r) << 4);
  };
  int va0[NSEG], vb0[NSEG], va1[NSEG], vb1[NSEG];
#pragma unroll
  for (int sg = 0; sg < NSEG; ++sg) {
    va0[sg] = v_addr(v_first, sg);
    vb0[sg] = v_addr(v_second, sg);
    va1[sg] = v_addr(v_first + 8, sg);
    vb1[sg] = v_addr(v_second + 8, sg);
  }

  float m0 = NEG_INF, m1 = NEG_INF;  // running max (log2 units), columns 2 tig, 2 tig + 1
  float l0 = 0.f, l1 = 0.f;          // this lane's share of the sums of p
  float z0 = 0.f, z1 = 0.f;          // and of p * v_zero
  float vsc = 1.7014118346046923e38f;  // K3: W's power of two (2^127 until the first key)
  // O^T: m-tile 8 s + mb holds channels 128 s + 16 gid + 2 mb (+1), columns
  // 2 tig (+1).
  float o[D / 16][4];
#pragma unroll
  for (int mb = 0; mb < D / 16; ++mb)
#pragma unroll
    for (int i = 0; i < 4; ++i) o[mb][i] = 0.f;

  for (int i = 0; i < n_stages; ++i) {
    cp_async_wait<STAGES - 2>();
    __syncwarp();
    if (i + STAGES - 1 < n_stages) load_stage(i + STAGES - 1);
    cp_async_commit();
    const int base = start + i * R::STAGE_KEYS + TILE * warp;
    if (base >= end) continue;  // warp-uniform: none of this warp's keys
    const uint8_t* slot = smem + warp * R::WARP_RING + (i % STAGES) * R::SLOT_BYTES;
    auto scalars = [&](int ti, int r) {  // (scale, zero) of K (half 0) or V (half 1)
      return *reinterpret_cast<const uint2*>(slot + R::S_OFF + (ti * TILE + r) * 8);
    };

    // S^T for each tile: keys as M, the q columns as N.  Every tile is
    // computed (a tile past the range is zero-filled and its keys masked),
    // k-chunks outer and tiles inner, so that neighbouring mma are
    // independent.
    float s[R::TILES][4];
#pragma unroll
    for (int ti = 0; ti < R::TILES; ++ti)
#pragma unroll
      for (int k = 0; k < 4; ++k) s[ti][k] = 0.f;
    if constexpr (NBITS == 4) {
      // A code word holds channels c .. c + 7 of a key, one nibble each; the
      // word shifted by 0, 4, 8 and 12 bits, masked and ORed under the magic
      // exponent, gives the bf16 pairs 128 + n of channels (c, c + 4),
      // (c + 1, c + 5), (c + 2, c + 6), (c + 3, c + 7): the A operand.
      // The words of KSEG segments at a time (all of them below WIDE).
      constexpr int KSEG = R::WIDE ? 1 : NSEG;
#pragma unroll
      for (int s0 = 0; s0 < NSEG; s0 += KSEG) {
        uint4 ra[R::TILES][KSEG], rb[R::TILES][KSEG];
#pragma unroll
        for (int ti = 0; ti < R::TILES; ++ti)
#pragma unroll
          for (int u = 0; u < KSEG; ++u) {
            const uint8_t* kt = slot + ti * TILE * ROW;
            ra[ti][u] = *reinterpret_cast<const uint4*>(kt + ko0[s0 + u]);
            rb[ti][u] = *reinterpret_cast<const uint4*>(kt + 8 * ROW + ko0[s0 + u]);
          }
#pragma unroll
        for (int u = 0; u < KSEG; ++u)
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int sh = 8 * e;  // k-chunk 8 s + 2j + e: nibbles at bits sh and sh + 4
              const uint2 qb = q_frag(8 * (s0 + u) + 2 * j + e);
#pragma unroll
              for (int ti = 0; ti < R::TILES; ++ti) {
                const uint32_t wa = (&ra[ti][u].x)[j], wb = (&rb[ti][u].x)[j];
                mma16816<F16>(s[ti], nib_bf16(wa >> sh), nib_bf16(wb >> sh),
                              nib_bf16(wa >> (sh + 4)), nib_bf16(wb >> (sh + 4)), qb.x, qb.y);
              }
            }
      }
    } else {
      // Word j of a lane's 32 bytes of a key (a segment's) holds channels c
      // .. c + 3; one PRMT gives the fp16 pair of channels (c, c + 1),
      // another (c + 2, c + 3): the A operand of k-chunk 8 s + j.
      constexpr int KSEG = R::WIDE ? 1 : NSEG;  // segments whose words are held at once
#pragma unroll
      for (int s0 = 0; s0 < NSEG; s0 += KSEG) {
        uint4 ka[R::TILES][KSEG][2], kb[R::TILES][KSEG][2];
#pragma unroll
        for (int ti = 0; ti < R::TILES; ++ti)
#pragma unroll
          for (int u = 0; u < KSEG; ++u) {
            const uint8_t* kt = slot + ti * TILE * ROW;
            ka[ti][u][0] = *reinterpret_cast<const uint4*>(kt + ko0[s0 + u]);
            ka[ti][u][1] = *reinterpret_cast<const uint4*>(kt + ko1[s0 + u]);
            kb[ti][u][0] = *reinterpret_cast<const uint4*>(kt + 8 * ROW + ko0[s0 + u]);
            kb[ti][u][1] = *reinterpret_cast<const uint4*>(kt + 8 * ROW + ko1[s0 + u]);
          }
#pragma unroll
        for (int u = 0; u < KSEG; ++u)
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const uint2 qb = q_frag(8 * (s0 + u) + j);
#pragma unroll
            for (int ti = 0; ti < R::TILES; ++ti) {
              const uint32_t wa = (&ka[ti][u][j >> 2].x)[j & 3];
              const uint32_t wb = (&kb[ti][u][j >> 2].x)[j & 3];
              mma16816<F16>(s[ti], byte_f16(wa, 0x4140), byte_f16(wb, 0x4140),
                            byte_f16(wa, 0x4342), byte_f16(wb, 0x4342), qb.x, qb.y);
            }
          }
      }
    }
    // Keys gid (s 0, 1) and gid + 8 (s 2, 3) of each tile: logit = kf (ks
    // (dot - qo) + kz qs), here in log2 units, NEG_INF past the range.
    float t[R::TILES][4];
#pragma unroll
    for (int ti = 0; ti < R::TILES; ++ti) {
      const int row0 = base + ti * TILE_STRIDE;
      const float2 kza = unpack_bf16(scalars(ti, gid).x);
      const float2 kzb = unpack_bf16(scalars(ti, gid + 8).x);
      const bool in0 = row0 + gid < end, in1 = row0 + gid + 8 < end;
      const float ksa0 = kza.x * kf0, ksa1 = kza.x * kf1;
      const float ksb0 = kzb.x * kf0, ksb1 = kzb.x * kf1;
      t[ti][0] = in0 ? fmaf(ksa0, s[ti][0] - qo0, kza.y * ql0) : NEG_INF;
      t[ti][1] = in0 ? fmaf(ksa1, s[ti][1] - qo1, kza.y * ql1) : NEG_INF;
      t[ti][2] = in1 ? fmaf(ksb0, s[ti][2] - qo0, kzb.y * ql0) : NEG_INF;
      t[ti][3] = in1 ? fmaf(ksb1, s[ti][3] - qo1, kzb.y * ql1) : NEG_INF;
    }

    // One rescale per stage: the max over its keys per column (tile 0 holds
    // at least one, so the max is finite).  K3 also lowers W's power of two
    // when this stage brings a v_scale that would take W past 2^15.
    float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
    for (int ti = 0; ti < R::TILES; ++ti) {
      mx0 = fmaxf(mx0, fmaxf(t[ti][0], t[ti][2]));
      mx1 = fmaxf(mx1, fmaxf(t[ti][1], t[ti][3]));
    }
#pragma unroll
    for (int off = 4; off < 32; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(FULL, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(FULL, mx1, off));
    }
    bool lower_vsc = false;
    float ratio = 1.f;
    if constexpr (NBITS == 8) {
      float vmx = 0.f;
#pragma unroll
      for (int ti = 0; ti < R::TILES; ++ti)
        vmx = fmaxf(vmx, fmaxf(fabsf(unpack_bf16(scalars(ti, gid).y).x),
                               fabsf(unpack_bf16(scalars(ti, gid + 8).y).x)));
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) vmx = fmaxf(vmx, __shfl_xor_sync(FULL, vmx, off));
      lower_vsc = vmx * vsc >= 32768.f;  // warp-uniform
      if (lower_vsc) {
        const float nv = pow2_to_2e14(vmx);
        ratio = nv / vsc;  // a power of two: exact
        vsc = nv;
      }
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    if (__any_sync(FULL, mn0 > m0 || mn1 > m1) || lower_vsc) {  // else every alpha is 1
      const float a0 = exp2_neg(m0 - mn0), a1 = exp2_neg(m1 - mn1);
      m0 = mn0;
      m1 = mn1;
      l0 *= a0; l1 *= a1; z0 *= a0; z1 *= a1;
      const float b0 = a0 * ratio, b1 = a1 * ratio;
#pragma unroll
      for (int mb = 0; mb < D / 16; ++mb) {
        o[mb][0] *= b0; o[mb][1] *= b1; o[mb][2] *= b0; o[mb][3] *= b1;
      }
    }

    // O^T += V^T W^T per tile, W = p * v_scale (K3: times vsc) as hi + lo,
    // transposed from the S^T layout by movmatrix; V^T's A operand pairs
    // two keys of one channel, built from the two keys' code words.  The hi
    // products of all of a segment's channel blocks go before the lo ones,
    // so neighbouring mma are independent.
#pragma unroll
    for (int ti = 0; ti < R::TILES; ++ti) {
      const float2 va = unpack_bf16(scalars(ti, gid).y);
      const float2 vb = unpack_bf16(scalars(ti, gid + 8).y);
      const float p0 = exp2_neg(t[ti][0] - m0), p1 = exp2_neg(t[ti][1] - m1);
      const float p2 = exp2_neg(t[ti][2] - m0), p3 = exp2_neg(t[ti][3] - m1);
      l0 += p0 + p2;
      l1 += p1 + p3;
      z0 = fmaf(p0, va.y, fmaf(p2, vb.y, z0));
      z1 = fmaf(p1, va.y, fmaf(p3, vb.y, z1));
      const float vsa = F16 ? va.x * vsc : va.x, vsb = F16 ? vb.x * vsc : vb.x;
      const float w0 = p0 * vsa, w1 = p1 * vsa, w2 = p2 * vsb, w3 = p3 * vsb;
      uint32_t h01, h23, l01, l23;
      if constexpr (F16) {
        h01 = pack_f16(w0, w1);
        h23 = pack_f16(w2, w3);
        const float2 r01 = unpack_f16(h01), r23 = unpack_f16(h23);
        l01 = pack_f16(w0 - r01.x, w1 - r01.y);
        l23 = pack_f16(w2 - r23.x, w3 - r23.y);
      } else {
        h01 = pack_bf16(w0, w1);
        h23 = pack_bf16(w2, w3);
        const float2 r01 = unpack_bf16(h01), r23 = unpack_bf16(h23);
        l01 = pack_bf16(w0 - r01.x, w1 - r01.y);
        l23 = pack_bf16(w2 - r23.x, w3 - r23.y);
      }
      const uint32_t bh0 = movmatrix_trans(h01), bh1 = movmatrix_trans(h23);
      const uint32_t bl0 = movmatrix_trans(l01), bl1 = movmatrix_trans(l23);

      const uint8_t* vt = slot + R::V_OFF + ti * TILE * ROW;
#pragma unroll
      for (int sg = 0; sg < NSEG; ++sg) {
        uint32_t pa[16], pb[16];  // keys (2 tig, 2 tig + 1) and (+ 8), channels 16 gid + k
        if constexpr (NBITS == 4) {
          v_pairs4(*reinterpret_cast<const uint2*>(vt + va0[sg]),
                   *reinterpret_cast<const uint2*>(vt + vb0[sg]), sel_lo, sel_hi, pa);
          v_pairs4(*reinterpret_cast<const uint2*>(vt + va1[sg]),
                   *reinterpret_cast<const uint2*>(vt + vb1[sg]), sel_lo, sel_hi, pb);
        } else {
          v_pairs8(*reinterpret_cast<const uint4*>(vt + va0[sg]),
                   *reinterpret_cast<const uint4*>(vt + vb0[sg]), pa);
          v_pairs8(*reinterpret_cast<const uint4*>(vt + va1[sg]),
                   *reinterpret_cast<const uint4*>(vt + vb1[sg]), pb);
        }
#pragma unroll
        for (int mb = 0; mb < 8; ++mb)
          mma16816<F16>(o[8 * sg + mb], pa[2 * mb], pa[2 * mb + 1], pb[2 * mb], pb[2 * mb + 1],
                        bh0, bh1);
#pragma unroll
        for (int mb = 0; mb < 8; ++mb)
          mma16816<F16>(o[8 * sg + mb], pa[2 * mb], pa[2 * mb + 1], pb[2 * mb], pb[2 * mb + 1],
                        bl0, bl1);
      }
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

  // Merge the 4 warps into the CTA's partial, v_zero's sum folded in (K3:
  // the accumulator back from W's power of two and the codes' unit first).
  // sm_o [warp][column][channel].
  float* sm_o = reinterpret_cast<float*>(smem);
  float* sm_m = sm_o + WARPS * 8 * O_STRIDE;
  float* sm_l = sm_m + WARPS * 8;
  const float inv_vsc = 1.f / vsc;
  auto acc = [&](float x, float z) {
    if constexpr (F16)
      return fmaf(x * (1.f / CODE_UNIT), inv_vsc, z);
    else
      return x + z;
  };
#pragma unroll
  for (int mb = 0; mb < D / 16; ++mb) {
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
  const size_t pbase = (((size_t)h * p.QB + qb) * p.n_split + sp) * GB;
#pragma unroll
  for (int g = 0; g < GB; ++g) {
    const float sn = __shfl_sync(FULL, s_new, 4 * g);  // row g's new logit
    float M = NEG_INF;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) M = fmaxf(M, sm_m[w * 8 + g]);
    float Ls = 0.f, A[NSEG];
#pragma unroll
    for (int i = 0; i < NSEG; ++i) A[i] = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float wt = exp2f(sm_m[w * 8 + g] - M);
      Ls += sm_l[w * 8 + g] * wt;
#pragma unroll
      for (int i = 0; i < NSEG; ++i) A[i] += sm_o[(w * 8 + g) * O_STRIDE + tid + SEG * i] * wt;
    }
    float* out = p.part + (pbase + g) * PART;
#pragma unroll
    for (int i = 0; i < NSEG; ++i) out[tid + SEG * i] = A[i];
    if (tid == 0)
      *reinterpret_cast<float4*>(out + D) = make_float4(Ls > 0.f ? M * LN2 : NEG_INF, Ls, sn, 0.f);
  }

  // Arrive; the last CTA of the head merges.  The barrier orders every
  // thread's partial before thread 0's release at device scope; its acquire
  // and the barrier after it order the last CTA's reads after every
  // partial (as CUTLASS's grid barriers do).
  __syncthreads();
  const int arrivals = p.n_split * p.QB;
  if (tid == 0) {
    int before = 0;
    if (arrivals > 1)
      asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], 1;\n"
                   : "=r"(before) : "l"(p.counters + h) : "memory");
    *sm_last = before == arrivals - 1;
  }
  __syncthreads();
  if (!*sm_last) return;
  float vn[CPL];
#pragma unroll
  for (int i = 0; i < CPL / 4; ++i) {
    const float2 vlo = unpack_bf16(vn_raw[i].x), vhi = unpack_bf16(vn_raw[i].y);
    vn[4 * i] = vlo.x;
    vn[4 * i + 1] = vlo.y;
    vn[4 * i + 2] = vhi.x;
    vn[4 * i + 3] = vhi.y;
  }
  merge_head<D, GB, R::SMEM_BYTES>(p, h, vn, smem);
}

template <int D, int GB>
__global__ void __launch_bounds__(THREADS, Ring<8, D>::CTAS_PER_SM)
quant8_decode_kernel(const Params p) {
  extern __shared__ __align__(128) uint8_t smem[];
  __shared__ int sm_last;
  decode_body<8, D, GB>(p, smem, &sm_last);
}

template <int D, int GB>
__global__ void __launch_bounds__(THREADS, Ring<4, D>::CTAS_PER_SM)
quant4_decode_kernel(const Params p) {
  extern __shared__ __align__(128) uint8_t smem[];
  __shared__ int sm_last;
  decode_body<4, D, GB>(p, smem, &sm_last);
}

template <int NBITS, int D, int GB>
int launch(const Params& p, int H, cudaStream_t st) {
  constexpr int SMEM = Ring<NBITS, D>::SMEM_BYTES + Ring<NBITS, D>::Q_BYTES;
  const auto kernel = NBITS == 8 ? quant8_decode_kernel<D, GB> : quant4_decode_kernel<D, GB>;
  static bool configured[64] = {false};  // once per instantiation and device
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev >= 64) return (int)cudaErrorInvalidDevice;
  if (!configured[dev]) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           SMEM);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                 cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return (int)err;
    configured[dev] = true;
  }
  kernel<<<dim3(H, p.n_split, p.QB), THREADS, SMEM, st>>>(p);
  return (int)cudaGetLastError();
}

template <int NBITS, int D>
int entry(const void* q, void* k_codes, void* v_codes, void* scales, const void* lengths,
          const void* lower, const void* k_new, const void* v_new, void* out, void* part,
          void* counters, int H, int G, int C, int n_split, float scale, void* stream) {
  if (n_split < 1 || G < 1) return (int)cudaErrorInvalidValue;
  const int GB = G < 8 ? G : 8;
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
  p.part = static_cast<float*>(part);
  p.counters = static_cast<int*>(counters);
  p.C = C;
  p.n_split = n_split;
  p.G = G;
  p.QB = (G + 7) / 8;
  p.scale = scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (GB) {  // G above 8 runs blocks of 8
    case 1: return launch<NBITS, D, 1>(p, H, st);
    case 2: return launch<NBITS, D, 2>(p, H, st);
    case 3: return launch<NBITS, D, 3>(p, H, st);
    case 4: return launch<NBITS, D, 4>(p, H, st);
    case 5: return launch<NBITS, D, 5>(p, H, st);
    case 6: return launch<NBITS, D, 6>(p, H, st);
    case 7: return launch<NBITS, D, 7>(p, H, st);
    case 8: return launch<NBITS, D, 8>(p, H, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace kq
}  // namespace

// One entry point per code width and head_dim:
// kvcf_quant8_decode_attn_append_d128, _d256, _d384, _d512 (K3) and
// kvcf_quant4_... (K4).  Head_dims 384 and 512 each compile in a library of
// their own (-DKVCF_QUANT_D=384 or 512, ops/kernels/_build.py::VARIANTS), so
// that their nvcc runs beside the one of 128 and 256.
#define KVCF_QUANT_DECODE(NB, DIM)                                                     \
  extern "C" int kvcf_quant##NB##_decode_attn_append_d##DIM(                           \
      const void* q, void* k_codes, void* v_codes, void* scales, const void* lengths,  \
      const void* lower, const void* k_new, const void* v_new, void* out, void* part,  \
      void* counters, int H, int G, int C, int n_split, float scale, void* stream) {   \
    return kq::entry<NB, DIM>(q, k_codes, v_codes, scales, lengths, lower, k_new,      \
                              v_new, out, part, counters, H, G, C, n_split, scale,     \
                              stream);                                                 \
  }
#ifndef KVCF_QUANT_D
KVCF_QUANT_DECODE(8, 128)
KVCF_QUANT_DECODE(8, 256)
KVCF_QUANT_DECODE(4, 128)
KVCF_QUANT_DECODE(4, 256)
#else
#define KVCF_QUANT_DECODE_AT(NB, DIM) KVCF_QUANT_DECODE(NB, DIM)  // expands DIM first
KVCF_QUANT_DECODE_AT(8, KVCF_QUANT_D)
KVCF_QUANT_DECODE_AT(4, KVCF_QUANT_D)
#endif
