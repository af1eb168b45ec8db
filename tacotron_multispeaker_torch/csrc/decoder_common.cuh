// Device helpers shared by the per-batch-row decoder kernels
// (decoder_loop.cu, teacher_decoder_fwd.cu, teacher_decoder_bwd.cu).
//
// Each of those kernels runs one block of NTHREADS threads per batch row and
// keeps its carries in shared memory.  A matrix-vector product reads its
// weights ([K, N] row-major, compute type T) from global memory with 16-byte
// loads, splits K over thread groups and meets the partial sums in shared
// memory.  Every product rounds its input vector to T (the cast the JAX
// package makes before each dot) and sums in f32.

#pragma once

#include "common.cuh"

namespace dec {

using namespace kern;

constexpr int NTHREADS = 512;
constexpr int NWARPS = NTHREADS / 32;

template <typename T> struct Vec;
template <> struct Vec<float> {
  static constexpr int N = 4;
  static __device__ __forceinline__ void load(const float* p, float* w) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(p));
    w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
  }
};
template <> struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  static __device__ __forceinline__ void load(const __nv_bfloat16* p, float* w) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      w[2 * i] = f.x;
      w[2 * i + 1] = f.y;
    }
  }
};

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Block-wide reduction of one value per thread; every thread gets the result.
template <bool kMax>
__device__ float block_reduce(float v, float* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = kMax ? warp_max(v) : warp_sum(v);
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  if (warp == 0) {
    float w = lane < NWARPS ? scratch[lane] : (kMax ? -INFINITY : 0.f);
    w = kMax ? warp_max(w) : warp_sum(w);
    if (lane == 0) scratch[NWARPS] = w;
  }
  __syncthreads();
  const float r = scratch[NWARPS];
  __syncthreads();
  return r;
}

// out[j] (+)= sum_k round(x[k]) * W[k, j] (+ bias[j]) for j < N.  W is
// [K, N] row-major in T.  Ends with a barrier, so out is ready for all.
// ``red`` holds NTHREADS * Vec<T>::N floats.
template <typename T>
__device__ void matvec(const float* __restrict__ x, const T* __restrict__ W, int K, int N,
                       float* __restrict__ out, const float* __restrict__ bias,
                       bool accumulate, float* __restrict__ red) {
  constexpr int VEC = Vec<T>::N;
  const int ncg = N / VEC;              // 16-byte column groups
  const int kg = NTHREADS / ncg;        // K split
  const int tid = threadIdx.x;
  if (tid < ncg * kg) {
    const int cg = tid % ncg, kk = tid / ncg;
    float acc[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[i] = 0.f;
    const T* wp = W + size_t(cg) * VEC;
#pragma unroll 4
    for (int k = kk; k < K; k += kg) {
      const float xk = rnd<T>(x[k]);
      float w[VEC];
      Vec<T>::load(wp + size_t(k) * N, w);
#pragma unroll
      for (int i = 0; i < VEC; ++i) acc[i] = fmaf(xk, w[i], acc[i]);
    }
    float* r = red + kk * N + cg * VEC;
#pragma unroll
    for (int i = 0; i < VEC; ++i) r[i] = acc[i];
  }
  __syncthreads();
  for (int j = tid; j < N; j += NTHREADS) {
    float s = 0.f;
    for (int kk = 0; kk < kg; ++kk) s += red[kk * N + j];
    if (bias != nullptr) s += bias[j];
    out[j] = accumulate ? out[j] + s : s;
  }
  __syncthreads();
}

// Legacy-TF GRU step on the state h (f32, shared memory); gx [2H] and cx [H]
// hold the input-side sums (bias included) and are consumed.
template <typename T>
__device__ void gru_step(float* h, float* gx, float* cx, const T* whg, const T* whc, int H,
                         float* rh, float* u, float* red) {
  matvec<T>(h, whg, H, 2 * H, gx, nullptr, true, red);
  for (int j = threadIdx.x; j < H; j += NTHREADS) {
    const float r = sigmoidf(gx[j]);
    u[j] = sigmoidf(gx[H + j]);
    rh[j] = r * h[j];
  }
  __syncthreads();
  matvec<T>(rh, whc, H, H, cx, nullptr, true, red);
  for (int j = threadIdx.x; j < H; j += NTHREADS) {
    const float c = tanhf(cx[j]);
    h[j] = u[j] * h[j] + (1.f - u[j]) * c;
  }
  __syncthreads();
}

// Bahdanau energies for one row: e[l] = sum_a tanh(keys[l, a] + q[a]) * v[a]
// (f32), -1e9 where mask[l] is 0; one warp per position.  Then the masked
// softmax in place: e[l] = exp(e[l] - max) * mask / max(sum, 1e-9), also
// written to ``align`` (the row's alignment output).  The -1e9 fill stays
// f32.  Ends with a barrier.  Kept out of line: inlined into
// decoder_loop_kernel<bf16> it made ptxas spill and the kernel slower.
template <typename T>
__device__ __noinline__ void attention_softmax(const T* __restrict__ keys,
                                               const uint8_t* __restrict__ mask,
                                               const float* q, const float* vv, int L, int A,
                                               float* e, float* __restrict__ align,
                                               float* scratch) {
  constexpr int VEC = Vec<T>::N;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int l = warp; l < L; l += NWARPS) {
    const T* kr = keys + size_t(l) * A;
    float s = 0.f;
    for (int a0 = lane * VEC; a0 < A; a0 += 32 * VEC) {
      float kv[VEC];
      Vec<T>::load(kr + a0, kv);
#pragma unroll
      for (int i = 0; i < VEC; ++i) s = fmaf(tanhf(kv[i] + q[a0 + i]), vv[a0 + i], s);
    }
    s = warp_sum(s);
    if (lane == 0) e[l] = mask[l] ? s : -1e9f;
  }
  __syncthreads();
  float m = -INFINITY;
  for (int l = tid; l < L; l += NTHREADS) m = fmaxf(m, e[l]);
  m = block_reduce<true>(m, scratch);
  float s = 0.f;
  for (int l = tid; l < L; l += NTHREADS) {
    const float p = mask[l] ? expf(e[l] - m) : 0.f;
    e[l] = p;
    s += p;
  }
  s = fmaxf(block_reduce<false>(s, scratch), 1e-9f);
  for (int l = tid; l < L; l += NTHREADS) {
    const float p = e[l] / s;
    e[l] = p;
    align[l] = p;
  }
  __syncthreads();
}

}  // namespace dec
