#!/usr/bin/env python3
"""The rate of warp-level mma.sync tensor-core products on one NVIDIA GPU.

Builds a small CUDA probe in which every warp issues rounds of independent
m16n8k8 TF32 (or m16n8k16 bf16) products on register operands, launches it
on one block an SM with 4, 8 and 16 warps, and prints the TFLOP/s of each
(CUDA events around the second of two launches). The fp32 flash kernels'
3xTF32 products run on this instruction: its rate, not the wgmma peak, is
what they can reach.

Run from the repository root on the machine with the card:
``python3 scripts/torch_mma_rate.py``.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import tempfile

SOURCE = r'''
#include <cuda_runtime.h>
#include <stdint.h>
template <int ILP, bool BF16>
__global__ void probe(float* out, int iters, uint32_t seed) {
  uint32_t a0 = seed ^ threadIdx.x, a1 = a0 * 3u, a2 = a0 * 5u, a3 = a0 * 7u, b0 = a0 * 11u,
           b1 = a0 * 13u;
  float c[ILP][4];
  for (int i = 0; i < ILP; ++i) for (int e = 0; e < 4; ++e) c[i][e] = 0.f;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int i = 0; i < ILP; ++i) {
      if (BF16)
        asm volatile("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
                     "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
                     : "+f"(c[i][0]), "+f"(c[i][1]), "+f"(c[i][2]), "+f"(c[i][3])
                     : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
      else
        asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
                     "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
                     : "+f"(c[i][0]), "+f"(c[i][1]), "+f"(c[i][2]), "+f"(c[i][3])
                     : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
    }
  }
  float s = 0.f;
  for (int i = 0; i < ILP; ++i) for (int e = 0; e < 4; ++e) s += c[i][e];
  if (s == 12345.f) out[threadIdx.x] = s;  // keeps the products live
}
template <int ILP, bool BF16>
float run(int sms, int warps, int iters) {
  float* out;
  cudaMalloc(&out, 4096);
  cudaEvent_t a, b;
  cudaEventCreate(&a);
  cudaEventCreate(&b);
  probe<ILP, BF16><<<sms, 32 * warps>>>(out, iters, 1);
  cudaEventRecord(a);
  probe<ILP, BF16><<<sms, 32 * warps>>>(out, iters, 1);
  cudaEventRecord(b);
  cudaEventSynchronize(b);
  float ms;
  cudaEventElapsedTime(&ms, a, b);
  cudaFree(out);
  const double flops = (double)sms * warps * iters * ILP * (BF16 ? 4096.0 : 2048.0);
  return (float)(flops / (ms * 1e-3) / 1e12);
}
// TFLOP/s at 4, 8 and 16 warps an SM: tf32 with 4, 8, 16 independent
// accumulators a warp, then bf16 with 8
extern "C" void probe_all(int sms, float* res) {
  int k = 0;
  for (int w : {4, 8, 16}) {
    res[k++] = run<4, false>(sms, w, 20000);
    res[k++] = run<8, false>(sms, w, 20000);
    res[k++] = run<16, false>(sms, w, 10000);
    res[k++] = run<8, true>(sms, w, 20000);
  }
}
'''


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_mma_rate: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    work = tempfile.mkdtemp(prefix="mma_rate_")
    src, lib = os.path.join(work, "probe.cu"), os.path.join(work, "probe.so")
    with open(src, "w") as f:
        f.write(SOURCE)
    subprocess.run(["/usr/local/cuda/bin/nvcc", "-gencode", "arch=compute_90a,code=sm_90a",
                    "-O3", "-shared", "-Xcompiler", "-fPIC", "-o", lib, src], check=True)
    res = (ctypes.c_float * 12)()
    probe = ctypes.CDLL(lib).probe_all
    probe.argtypes = [ctypes.c_int, ctypes.c_void_p]
    probe(torch.cuda.get_device_properties(0).multi_processor_count, ctypes.addressof(res))
    names = ("tf32, 4 accumulators a warp", "tf32, 8", "tf32, 16", "bf16, 8")
    for i, warps in enumerate((4, 8, 16)):
        for j, name in enumerate(names):
            print(f"  {warps:2d} warps an SM, {name}: {res[4 * i + j]:.1f} TFLOP/s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
