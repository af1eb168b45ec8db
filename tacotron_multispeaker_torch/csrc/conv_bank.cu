// The CBHG conv bank as one product kernel for Hopper (sm_90a).
//
// Replaces tacotron_multispeaker_tpu/ops/conv_bank.py conv_bank_pallas:
//   y[b, t, o] = relu(sum_{j<K} sum_{d<D} x[b, t + j - (K-1)/2, d] * w[j, d, o] + bias[o])
// (x zero outside [0, T)), the width-1..K bank folded into one masked
// width-K convolution.  x [B, T, D], w [K, D, O] (pre-masked), bias [O] and
// y [B, T, O] are all in the compute type T (bf16 or f32); the sums are f32,
// the bias (already rounded to T) is added in f32, then ReLU and one
// rounding to T, as the Pallas kernel does.
//
// Design: an implicit-im2col product.  The rows are the B*T output frames,
// the columns the O channels, the depth the K*D (tap, input channel) pairs:
// A[(b, t), (j, d)] = x[b, t + j - pad, d] is read straight from x by the
// tile's loader (no im2col buffer; 8 channels of one tap are one 16-byte
// piece) and B = w viewed as [K*D, O].  Each block computes one output tile
// with the shared tile of mma_common.cuh (128 x 64 on the tensor cores for
// bf16, double-buffered cp.async loads; 64 x 64 FMAs for f32) and applies
// bias + ReLU in its epilogue.  Unlike the Pallas kernel, which holds a
// whole [T, D] slab per (batch, channel tile), a block never holds more
// than its tile: its rows may span two batch rows, the loader resolves each.
//
// Bound on this card: the tensor cores at the encoder's and post-net's
// shapes (2*B*T*K*D*O operations, about 51 and 42 GFLOP at B=32, against
// tens of MB of operands); the WMMA tile reaches a part of that rate.  The
// bank's mask zeroes about half of w, which the product still multiplies,
// as the Pallas kernel and cuDNN do.
//
// Limits (the Python wrapper raises outside them): every tensor below 2^31
// elements; for bf16, D and O multiples of 8 and 16-byte aligned tensors.

#include "common.cuh"
#include "mma_common.cuh"

namespace {

template <typename T>
__global__ void __launch_bounds__(kern::Tile<T>::NT)
conv_bank_kernel(const T* __restrict__ x, const T* __restrict__ w,
                 const T* __restrict__ bias, T* __restrict__ y,
                 int B, int Tn, int D, int K, int O) {
  using Tile = kern::Tile<T>;
  __shared__ typename Tile::Smem s;
  const int M = B * Tn;
  const int row0 = blockIdx.x * Tile::BM, o0 = blockIdx.y * Tile::BN;
  const int pad = (K - 1) / 2;
  auto pa = [&](int r, int k) -> const T* {
    const int row = row0 + r;
    if (row >= M) return nullptr;
    const int b = row / Tn, t = row - b * Tn;
    const int j = k / D, d = k - j * D;
    const int ts = t + j - pad;
    return (ts < 0 || ts >= Tn) ? nullptr : x + ((size_t)b * Tn + ts) * D + d;
  };
  auto pb = [&](int k, int c) -> const T* {
    const int o = o0 + c;
    return o < O ? w + (size_t)k * O + o : nullptr;
  };
  Tile::run(s, K * D, pa, pb);
  const float* C = Tile::out(s);
  for (int i = threadIdx.x; i < Tile::BM * Tile::BN; i += Tile::NT) {
    const int r = i / Tile::BN, c = i % Tile::BN;
    const int row = row0 + r, o = o0 + c;
    if (row < M && o < O) {
      const float v = C[r * Tile::LDC + c] + kern::to_f(bias[o]);
      y[(size_t)row * O + o] = kern::from_f<T>(fmaxf(v, 0.f));
    }
  }
}

template <typename T>
int launch(const void* x, const void* w, const void* bias, void* y, int B, int T_, int D,
           int K, int O, cudaStream_t s) {
  using Tile = kern::Tile<T>;
  const long long rows = (long long)B * T_;
  const dim3 grid((unsigned)((rows + Tile::BM - 1) / Tile::BM),
                  (unsigned)((O + Tile::BN - 1) / Tile::BN));
  if (grid.y > 65535) return int(cudaErrorInvalidValue);
  conv_bank_kernel<T><<<grid, Tile::NT, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<const T*>(bias),
      static_cast<T*>(y), B, T_, D, K, O);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

// x, w, bias, y: device pointers in the compute type (is_bf16 ? bf16 : f32).
// Returns the CUDA error code of the launch.
int conv_bank_launch(const void* x, const void* w, const void* bias, void* y, int B, int T,
                     int D, int K, int O, int is_bf16, void* stream) {
  if ((long long)B * T <= 0 || O <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch<__nv_bfloat16>(x, w, bias, y, B, T, D, K, O, s)
                 : launch<float>(x, w, bias, y, B, T, D, K, O, s);
}

}  // extern "C"
