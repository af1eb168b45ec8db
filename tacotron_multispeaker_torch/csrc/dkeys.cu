// Attention-key gradient of the teacher-forced decoder, for Hopper (sm_90a).
//
// Replaces: tacotron_multispeaker_tpu/ops/teacher_decoder.py _dkeys_pallas
// (and the dv sum the Pallas _bwd_kernel carries, folded in here because
// this kernel computes the same activations anyway):
//   act          = tanh(keys[b,l,a] + q[t,b,a])
//   dkeys[b,l,a] = sum_t de[t,b,l] * v[a] * (1 - act^2)
//   dv[a]        = sum_{t,b,l} de[t,b,l] * act
// keys and v in the compute type (bf16 or f32), q and de f32, sums f32.
//
// Design: parallel over (b, l, a), serial over t.  Grid = (ceil(L/LB), B);
// a block of A threads (one per attention column, rounded up to a warp)
// holds LB = 8 encoder positions of keys and their LB dkeys accumulators in
// registers, and walks t in chunks of TC steps staged in shared memory (q
// rows [TC, A], de [TC, LB]).  Each t adds in the same order as the Pallas
// kernel.  dv: each block writes its column sums to a partial buffer
// [B * ceil(L/LB), A]; a second small kernel adds those in block order, so
// the result does not change from run to run (no atomics).
//
// Bound on this card: the S*B*L*A tanh (3.1e8 at full width) on the
// special-function and FMA pipes; the bytes (keys and dkeys once, q and de
// once per block) are far fewer.
//
// Limits (the Python wrapper raises outside them): A <= 1024 threads;
// B <= 65535.

#include "common.cuh"

namespace {

using namespace kern;

constexpr int LB = 8;     // encoder positions per block
constexpr int TC = 16;    // time steps staged per iteration

template <typename T>
__global__ void __launch_bounds__(1024)
dkeys_kernel(const T* __restrict__ keys, const float* __restrict__ q,
             const float* __restrict__ de, const T* __restrict__ v,
             float* __restrict__ dkeys, float* __restrict__ part, int S, int B, int L, int A) {
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                   // [TC, A]
  float* ds = qs + TC * A;            // [TC, LB]
  const int lb = blockIdx.x, b = blockIdx.y;
  const int l0 = lb * LB;
  const int c = threadIdx.x;
  const bool on = c < A;

  float kv[LB], acc[LB];
  const float va = on ? to_f(v[c]) : 0.f;
#pragma unroll
  for (int i = 0; i < LB; ++i) {
    acc[i] = 0.f;
    kv[i] = (on && l0 + i < L) ? to_f(keys[(size_t(b) * L + l0 + i) * A + c]) : 0.f;
  }
  float dv = 0.f;

  for (int t0 = 0; t0 < S; t0 += TC) {
    const int n = min(TC, S - t0);
    for (int k = threadIdx.x; k < n * A; k += blockDim.x) {
      const int tt = k / A, cc = k % A;
      qs[tt * A + cc] = q[(size_t(t0 + tt) * B + b) * A + cc];
    }
    for (int k = threadIdx.x; k < n * LB; k += blockDim.x) {
      const int tt = k / LB, i = k % LB;
      ds[tt * LB + i] = l0 + i < L ? de[(size_t(t0 + tt) * B + b) * L + l0 + i] : 0.f;
    }
    __syncthreads();
    if (on) {
      for (int tt = 0; tt < n; ++tt) {
        const float qa = qs[tt * A + c];
#pragma unroll
        for (int i = 0; i < LB; ++i) {
          const float act = tanhf(kv[i] + qa);
          const float d = ds[tt * LB + i];
          acc[i] += d * va * (1.f - act * act);
          dv = fmaf(d, act, dv);
        }
      }
    }
    __syncthreads();
  }
  if (on) {
#pragma unroll
    for (int i = 0; i < LB; ++i)
      if (l0 + i < L) dkeys[(size_t(b) * L + l0 + i) * A + c] = acc[i];
    part[(size_t(b) * gridDim.x + lb) * A + c] = dv;
  }
}

__global__ void dv_reduce_kernel(const float* __restrict__ part, float* __restrict__ dv,
                                 int n_parts, int A) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= A) return;
  float s = 0.f;
  for (int k = 0; k < n_parts; ++k) s += part[size_t(k) * A + c];
  dv[c] = s;
}

int l_blocks(int L) { return (L + LB - 1) / LB; }

template <typename T>
int launch(const void* keys, const float* q, const float* de, const void* v, float* dk,
           float* dv, float* part, int S, int B, int L, int A, cudaStream_t stream) {
  const size_t smem = (size_t(TC) * A + TC * LB) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(dkeys_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         int(smem));
  if (err != cudaSuccess) return int(err);
  const int threads = ((A + 31) / 32) * 32;
  dim3 grid(l_blocks(L), B);
  dkeys_kernel<T><<<grid, threads, smem, stream>>>(
      static_cast<const T*>(keys), q, de, static_cast<const T*>(v), dk, part, S, B, L, A);
  err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  dv_reduce_kernel<<<(A + 255) / 256, 256, 0, stream>>>(part, dv, B * l_blocks(L), A);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

// Encoder-position blocks of the grid (rows of the dv partial buffer per b).
int dkeys_l_blocks(int L) { return l_blocks(L); }

// keys [B,L,A] and v [A] in T (f32 or bf16), q [S,B,A] and de [S,B,L] f32 ->
// dkeys [B,L,A] and dv [A] f32; part is scratch [B * dkeys_l_blocks(L), A]
// f32.  Returns the CUDA error code.
int dkeys_launch(const void* keys, const void* q, const void* de, const void* v, void* dkeys,
                 void* dv, void* part, int S, int B, int L, int A, int is_bf16,
                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* qf = static_cast<const float*>(q);
  const float* df = static_cast<const float*>(de);
  float* dk = static_cast<float*>(dkeys);
  float* dvf = static_cast<float*>(dv);
  float* pf = static_cast<float*>(part);
  if (is_bf16) return launch<__nv_bfloat16>(keys, qf, df, v, dk, dvf, pf, S, B, L, A, s);
  return launch<float>(keys, qf, df, v, dk, dvf, pf, S, B, L, A, s);
}

}  // extern "C"
