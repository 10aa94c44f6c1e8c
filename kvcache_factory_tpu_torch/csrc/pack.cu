// K5: row gather out[h, c, :] = kv[h, idx[h, c], :], for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   tools/bench_select.py::_pack_kernel (entry pallas_pack)
// which gathered the selected K/V rows as one-hot [CB, SB] x [SB, D2]
// products on the MXU, because Mosaic lowers no dynamic row gather.  An id
// outside [0, S) hits no one-hot column and gives a zero row; so here.  The
// TPU kernel needed C % CB == 0 and S % SB == 0; this one takes any C and S.
//
// What bounds it: it moves bytes and computes nothing.  Each selected row is
// read once and written once (at H 32, C 2048, D2 256 bf16: 33.6 MB each
// way, 20 us at 3.35 TB/s); the one-hot product's S/SB passes over the
// source rows have no counterpart here.
//
// Design: one warp per output row; each lane moves 16 bytes per step, the
// lanes of a warp on neighbouring addresses of one row (a 512-byte bf16 row
// of 256 channels is one step).  The id is read once per warp.  Nothing is
// accumulated, so the copy is bitwise and no two warps touch one output.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;  // output rows per CTA

__global__ void __launch_bounds__(WARPS * 32)
pack_rows_kernel(const uint4* __restrict__ kv, const int* __restrict__ idx,
                 uint4* __restrict__ out, int H, int S, int C, int vecs) {
  const long long row = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= (long long)H * C) return;
  const int h = (int)(row / C);
  const int id = idx[row];
  uint4* dst = out + row * vecs;
  if (id < 0 || id >= S) {  // no one-hot hit: a zero row
    for (int i = lane; i < vecs; i += 32) dst[i] = make_uint4(0, 0, 0, 0);
    return;
  }
  const uint4* src = kv + ((long long)h * S + id) * vecs;
  for (int i = lane; i < vecs; i += 32) dst[i] = src[i];
}

}  // namespace

// kv [H, S, row_bytes], idx [H, C] int32, out [H, C, row_bytes]; vecs is the
// row's length in 16-byte vectors.
extern "C" int kvcf_pack_rows(const void* kv, const void* idx, void* out, int H, int S,
                              int C, int vecs, void* stream) {
  if (H < 1 || S < 1 || C < 1 || vecs < 1) return (int)cudaErrorInvalidValue;
  const long long rows = (long long)H * C;
  const unsigned blocks = (unsigned)((rows + WARPS - 1) / WARPS);
  pack_rows_kernel<<<blocks, WARPS * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(kv), static_cast<const int*>(idx), static_cast<uint4*>(out),
      H, S, C, vecs);
  return (int)cudaGetLastError();
}
