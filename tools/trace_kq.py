#!/usr/bin/env python3
"""Where one K3 or K4 launch spends its time, CTA by CTA, on one NVIDIA H100.

    mkdir -p build/trace && cp -r kvcache_factory_tpu_torch chip_smoke.py build/trace/
    python3 tools/trace_kq.py build/trace [--nbits 8|4]

It edits the copy's ``csrc/decode_attn_quant.cu`` (never the repository's
own, which it refuses) so that thread 0 of every K3 or K4 CTA records
``%globaltimer`` at each phase: start, first stage's copies issued, q and
the new token's logit ready, each of the first four stages' data ready and
computed, loop end, partial written and arrived, merge done (the head's
last CTA).  Then it builds that copy, runs one eager call of the kernel
``--nbits`` names (4 by default) at each shape (64 cache heads at 2079 /
1531 keys; 8 heads of G 4 at 32031 keys; 64 heads at 0 and at 1024 keys)
after flushing the L2, and prints, for each
phase, the earliest, median and latest CTA in microseconds from the first
CTA's start, and the median time of each step.  The marks cost time
themselves: read the phases against each other, and the kernel's time
from ``tools/time_kq.py``.  Imports only torch, numpy and the copy.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import sys
from pathlib import Path

MARKS = {0: "start", 1: "copies issued", 2: "q ready", 3: "stage0 data", 4: "stage0 done",
         5: "stage1 data", 6: "stage1 done", 7: "stage2 data", 8: "stage2 done",
         9: "stage3 data", 10: "stage3 done", 11: "loop end", 12: "arrived", 13: "merge done"}
STEPS = ((3, 4, "stage0 compute"), (5, 6, "stage1 compute"), (7, 8, "stage2 compute"),
         (11, 12, "partial + arrive"), (12, 13, "merge (last CTA)"))

# (anchor in the source, text put after it)
EDITS = (
    ("namespace kq {\n",
     "__device__ unsigned long long trace_buf[4096 * 16];\n"
     "#define MARK(k) do { if (threadIdx.x == 0) { unsigned long long t_; "
     "asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t_)); "
     "trace_buf[(blockIdx.x * gridDim.y + blockIdx.y) * 16 + (k)] = t_; } } while (0)\n"),
    ("  const int C = p.C;\n", "  MARK(0);\n"),
    ("  if (n_stages > 0) load_stage(0);\n  cp_async_commit();\n", "  MARK(1);\n"),
    ("  s_new *= p.scale;  // query row gid's new logit, on each of its 4 lanes\n", "  MARK(2);\n"),
    ("    cp_async_wait<STAGES - 2>();\n    __syncwarp();\n", "    if (i < 4) MARK(3 + 2 * i);\n"),
    ("                        bl0, bl1);\n      }\n    }\n",
     # reading the accumulator makes the mark wait for the stage's products
     "    if (i < 4 && o[0][0] + o[7][3] != 12345.f) MARK(4 + 2 * i);\n"),
    ("  __syncthreads();  // every warp is done with its ring: reuse it\n", "  MARK(11);\n"),
    ("    *sm_last = before == p.n_split - 1;\n  }\n  __syncthreads();\n",
     "  MARK(12);\n  if (threadIdx.x == 0) "
     "trace_buf[(blockIdx.x * gridDim.y + blockIdx.y) * 16 + 14] = n_stages;\n"),
    ("  merge_head<D, G, R::SMEM_BYTES>(p, h, s_new, vn, smem);\n",
     "  __syncthreads();\n  MARK(13);\n"),
)
READER = """
extern "C" int kq_trace_read(void* dst, int n) {
  return (int)cudaMemcpyFromSymbol(dst, kq::trace_buf, (size_t)n * 8);
}
extern "C" int kq_trace_clear() {
  void* buf = nullptr;
  const cudaError_t err = cudaGetSymbolAddress(&buf, kq::trace_buf);
  return (int)(err == cudaSuccess ? cudaMemset(buf, 0, sizeof(kq::trace_buf)) : err);
}
"""


def instrument(src: Path) -> None:
    text = src.read_text()
    if "kq_trace_read" in text:
        return
    for anchor, add in EDITS:
        if text.count(anchor) != 1:
            raise SystemExit(f"trace_kq: the source no longer holds one {anchor!r}; "
                             "update EDITS to the kernel")
        text = text.replace(anchor, anchor + add)
    src.write_text(text + READER)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("copy", help="a copy of kvcache_factory_tpu_torch/ and chip_smoke.py")
    ap.add_argument("--nbits", type=int, choices=(8, 4), default=4)
    args = ap.parse_args()
    copy = Path(args.copy).resolve()
    if copy == Path(__file__).resolve().parents[1]:
        raise SystemExit("trace_kq: give a copy of the package, not the repository itself")
    instrument(copy / "kvcache_factory_tpu_torch" / "csrc" / "decode_attn_quant.cu")
    os.chdir(copy)
    sys.path.insert(0, str(copy))
    import numpy as np
    import torch

    import chip_smoke as cs
    from kvcache_factory_tpu_torch.ops.kernels import _build, decode_attn, decode_attn_quant

    if not torch.cuda.is_available():
        raise SystemExit("trace_kq: no CUDA device")
    lib = _build.load("decode_attn_quant")
    lib.kq_trace_read.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.kq_trace_clear.argtypes = []
    kernel = (decode_attn_quant.quant_decode_attention_append if args.nbits == 8
              else decode_attn_quant.quant4_decode_attention_append)
    C_main = 2176 if args.nbits == 8 else 2304
    rng = np.random.default_rng(0)
    flush = torch.empty(300_000_000, dtype=torch.uint8, device="cuda")
    sm = decode_attn._sm_count(torch.device("cuda"))
    for label, H, G, C, keys in (("64h", 64, 1, C_main, [2079] * 32 + [1531] * 32),
                                 ("32k", 8, 4, 32801, [32031] * 8),
                                 ("0 keys", 64, 1, C_main, [0] * 64),
                                 ("1024 keys", 64, 1, C_main, [1024] * 64)):
        q, kc, vc, sc, kn, vn = cs.kq_inputs(rng, args.nbits, H, G, C)
        lens = torch.tensor(keys, dtype=torch.int32, device="cuda")
        n_ctas = H * decode_attn.split_count(H, C, sm)
        buf = np.zeros(4096 * 16, np.uint64)
        for _ in range(3):  # the last of three calls, each after an L2 flush
            flush.add_(1)
            if lib.kq_trace_clear() != 0:
                raise SystemExit("trace_kq: could not clear the timestamps")
            kernel(q, kc, vc, sc, lens, kn, vn)
            torch.cuda.synchronize()
        if lib.kq_trace_read(buf.ctypes.data, n_ctas * 16) != 0:
            raise SystemExit("trace_kq: could not read the timestamps")
        t = buf[:n_ctas * 16].reshape(n_ctas, 16).astype(np.int64)
        t0 = t[:, 0].min()
        print(f"== {label}: {n_ctas} CTAs, stages a CTA {np.unique(t[:, 14]).tolist()}")
        for k, name in MARKS.items():
            v = t[:, k][t[:, k] > 0] - t0
            if len(v):
                print(f"  {name:14s} n={len(v):4d}  first {v.min() / 1e3:6.2f}  median "
                      f"{np.median(v) / 1e3:6.2f}  last {v.max() / 1e3:6.2f} us")
        for a, b, name in STEPS:
            d = (t[:, b] - t[:, a])[(t[:, a] > 0) & (t[:, b] > 0)]
            if len(d):
                print(f"  {name:16s} median {np.median(d) / 1e3:.2f}  longest {d.max() / 1e3:.2f} us")


if __name__ == "__main__":
    main()
