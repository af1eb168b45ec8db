#!/usr/bin/env python3
"""Hold the GRU forward's branch-free sigmoid against common.cuh's sigmoidf over every float.

    python3 tools/gru_fwd_sigmoid_check.py

Compiles a small program that includes ``csrc/bigru_scan.cu`` and runs
``sigmoid_n`` (the tensor-core route's sigmoid: the division's fast path,
taken when a whole warp's 1 + exp(-x) is below 2^126) and
``kern::sigmoidf`` (1 / (1 + expf(-x)) with the compiler's division) on
all 2^32 bit patterns of a float, a warp's 32 lanes on 32 consecutive
patterns, four values a lane, and prints how many results differ in any
bit (NaN against NaN counts as equal) and how many warps took the fast
path.  Exits 1 when any differs or without nvcc.  Needs a CUDA device.
"""

import os
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

SOURCE = r'''
#include <cstdio>
#include "bigru_scan.cu"

__global__ void check(unsigned long long* bad, unsigned long long* fast_warps) {
  const unsigned long long n = 1ull << 32;
  const unsigned long long stride = 4ull * gridDim.x * blockDim.x;
  unsigned long long nbad = 0, nfast = 0;
  for (unsigned long long base = 4ull * (blockIdx.x * blockDim.x + (threadIdx.x & ~31u));
       base < n; base += stride) {
    float v[4], ref[4];
    bool in_range = true;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const unsigned bits = unsigned(base + 32ull * i + (threadIdx.x & 31u));
      v[i] = __uint_as_float(bits);
      ref[i] = kern::sigmoidf(v[i]);
      in_range &= 1.f + expf(-v[i]) < 0x1p126f;
    }
    sigmoid_n<4>(v);
    nfast += __all_sync(0xffffffffu, in_range) && (threadIdx.x & 31u) == 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const bool same = __float_as_uint(v[i]) == __float_as_uint(ref[i])
                        || (v[i] != v[i] && ref[i] != ref[i]);
      nbad += !same;
    }
  }
  atomicAdd(bad, nbad);
  atomicAdd(fast_warps, nfast);
}

int main() {
  unsigned long long *d, h[2];
  cudaMalloc(&d, 2 * sizeof(unsigned long long));
  cudaMemset(d, 0, 2 * sizeof(unsigned long long));
  check<<<1056, 256>>>(d, d + 1);
  cudaError_t err = cudaDeviceSynchronize();
  cudaMemcpy(h, d, sizeof(h), cudaMemcpyDeviceToHost);
  std::printf("%s: %llu of 4294967296 floats differ from sigmoidf; %llu of 33554432 "
              "warp groups took the fast path\n", cudaGetErrorString(err), h[0], h[1]);
  return err != cudaSuccess || h[0] != 0;
}
'''


def main() -> int:
    from tacotron_multispeaker_torch.ops import cuda_build
    d = tempfile.mkdtemp()
    src = os.path.join(d, "check.cu")
    with open(src, "w") as f:
        f.write(SOURCE)
    exe = os.path.join(d, "check")
    flags = [a for a in cuda_build.NVCC_FLAGS if a not in ("-shared", "-Xcompiler", "-fPIC")]
    proc = subprocess.run([cuda_build.nvcc_path(), *flags, "-I", str(cuda_build.CSRC), "-o",
                           exe, src], capture_output=True, text=True)
    if proc.returncode:
        print(proc.stderr[-3000:], file=sys.stderr)
        return 1
    return subprocess.run([exe]).returncode


if __name__ == "__main__":
    sys.exit(main())
