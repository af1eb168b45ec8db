// One additive-attention step for Hopper (sm_90a): the normalised step
// (kernel 9) and the per-shard partial of the distributed softmax (kernel 10).
//
// attention_step_launch replaces tacotron_multispeaker_tpu/ops/attention_step.py
// attention_step_pallas, with its rounding: in the compute type T (bf16 or
// f32)
//   act[l, a] = tanh((keys[l, a] + q[a]) + loc[l, a])   (each step rounded to T)
//   e[l]      = sum_a act[l, a] * v[a]                  (f32)
//   p         = masked softmax of e (-1e9 at masked l, exp(e - max) * mask,
//               the sum floored at 1e-9), f32, written as the alignments
//   ctx[d]    = sum_l round_T(p[l]) * memory[l, d]      (f32)
// keys/loc [B, L, A], q [B, A], v [A], memory [B, L, D] in T, mask [B, L]
// bool; ctx [B, D] and align [B, L] f32.  Without a location term the loc
// add is compiled out (template flag), so no zero [B, L, A] tensor is read.
//
// Design: one block per batch row, launched once per decoder step.  Eight
// warps take the L positions in turn; a warp streams one position's A keys
// (and location terms) with its 32 lanes side by side, so each row of keys
// is read once, straight from device memory, and never staged: a row's
// keys, location terms and memory are ~0.3 MB at L=192, A=256, D=320 in
// bf16, more than a block's shared memory.  Shared memory holds q, v and
// the L energies; the softmax runs over them with block reductions; then
// each thread owns context columns and walks the L positions with
// neighbouring threads on neighbouring columns of memory.
//
// Bound on this card: device memory (each key, location term and memory
// element is read once and used for a few operations).  With one block per
// row, B=32 blocks occupy 32 of the 132 SMs, so a single launch cannot draw
// the card's full bandwidth; at B=1 the launch latency dominates.
//
// attention_step_partial_launch replaces attention_step_partial (the
// per-shard half of ops/sharded_attention.py) with the same row layout: no
// location term and no normalisation; it writes
//   p_u[l] = exp(e[l] - m) * mask[l]    (the unnormalised weights, f32)
//   m      = max_l e[l]                 (-1e9 when the shard is fully masked)
//   s      = sum_l p_u[l]
//   ctx_u  = sum_l round_T(p_u[l]) * memory[l, :]   (f32)
// A fully masked shard (a row whose text ends in an earlier shard) gives
// exactly m = -1e9, s = 0, p_u = 0 and ctx_u = 0, which the combine across
// shards relies on (its scale exp(-1e9 - m) is 0).  On the sequence-sharded
// path the inputs are f32 [B, L/M, A] and [B, L/M, D] shards (48 x 256 and
// 48 x 384 at full width on a 4-way model axis): ~1 MB a launch at B=8, a
// bound of ~0.3 us, so the launch latency is what it costs.
//
// Limits of both (the Python wrappers raise outside them): (2A + L) * 4
// bytes of shared memory at most 227 KB; every tensor below 2^31 elements
// (int offsets).

#include "common.cuh"

namespace {

constexpr int NT = 256;
constexpr int NW = NT / 32;

__device__ __forceinline__ float block_reduce(float v, float* red, bool is_max) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float u = __shfl_xor_sync(0xffffffffu, v, o);
    v = is_max ? fmaxf(v, u) : v + u;
  }
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float r = red[0];
  for (int i = 1; i < NW; ++i) r = is_max ? fmaxf(r, red[i]) : r + red[i];
  __syncthreads();
  return r;
}

// PARTIAL: kernel 10 (align gets p_u, m/s the local max and sum); else
// kernel 9 (align gets the normalised weights, m/s unused).
template <typename T, bool LOC, bool PARTIAL>
__global__ void __launch_bounds__(NT)
attention_step_kernel(const T* __restrict__ keys, const T* __restrict__ q,
                      const T* __restrict__ v, const T* __restrict__ mem,
                      const uint8_t* __restrict__ mask, const T* __restrict__ loc,
                      float* __restrict__ ctx, float* __restrict__ align,
                      float* __restrict__ mout, float* __restrict__ sout, int L, int A,
                      int D) {
  extern __shared__ float sm[];
  float* qs = sm;            // [A]
  float* vs = sm + A;        // [A]
  float* e = sm + 2 * A;     // [L] energies, then probabilities
  __shared__ float red[NW];
  const int b = blockIdx.x;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  for (int a = threadIdx.x; a < A; a += NT) {
    qs[a] = kern::to_f(q[(size_t)b * A + a]);
    vs[a] = kern::to_f(v[a]);
  }
  __syncthreads();

  const uint8_t* mrow = mask + (size_t)b * L;
  for (int l = warp; l < L; l += NW) {
    const size_t base = ((size_t)b * L + l) * A;
    float s = 0.f;
    for (int a = lane; a < A; a += 32) {
      float x = kern::rnd<T>(kern::to_f(keys[base + a]) + qs[a]);
      if constexpr (LOC) x = kern::rnd<T>(x + kern::to_f(loc[base + a]));
      s += kern::rnd<T>(tanhf(x)) * vs[a];
    }
    s = kern::warp_sum(s);
    if (lane == 0) e[l] = mrow[l] ? s : -1e9f;
  }
  __syncthreads();

  float m = -INFINITY;
  for (int l = threadIdx.x; l < L; l += NT) m = fmaxf(m, e[l]);
  m = block_reduce(m, red, true);
  float sum = 0.f;
  for (int l = threadIdx.x; l < L; l += NT) {
    const float p = expf(e[l] - m) * (mrow[l] ? 1.f : 0.f);
    e[l] = p;
    sum += p;
  }
  sum = block_reduce(sum, red, false);
  if constexpr (PARTIAL) {
    if (threadIdx.x == 0) {
      mout[b] = m;
      sout[b] = sum;
    }
    for (int l = threadIdx.x; l < L; l += NT) align[(size_t)b * L + l] = e[l];
  } else {
    const float den = fmaxf(sum, 1e-9f);
    for (int l = threadIdx.x; l < L; l += NT) {
      const float p = e[l] / den;
      e[l] = p;
      align[(size_t)b * L + l] = p;
    }
    __syncthreads();
  }

  const T* mb = mem + (size_t)b * L * D;
  for (int d = threadIdx.x; d < D; d += NT) {
    float c = 0.f;
    for (int l = 0; l < L; ++l) c += kern::rnd<T>(e[l]) * kern::to_f(mb[(size_t)l * D + d]);
    ctx[(size_t)b * D + d] = c;
  }
}

template <typename T, bool LOC, bool PARTIAL = false>
int launch(const void* keys, const void* q, const void* v, const void* mem,
           const void* mask, const void* loc, void* ctx, void* align, int B, int L, int A,
           int D, cudaStream_t s, void* mout = nullptr, void* sout = nullptr) {
  const size_t smem = sizeof(float) * (2 * (size_t)A + L);
  auto kernel = attention_step_kernel<T, LOC, PARTIAL>;
  if (smem > 48 * 1024) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return int(err);
  }
  kernel<<<B, NT, smem, s>>>(static_cast<const T*>(keys), static_cast<const T*>(q),
                             static_cast<const T*>(v), static_cast<const T*>(mem),
                             static_cast<const uint8_t*>(mask), static_cast<const T*>(loc),
                             static_cast<float*>(ctx), static_cast<float*>(align),
                             static_cast<float*>(mout), static_cast<float*>(sout), L, A, D);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

// keys, q, v, memory (compute type), mask (bool bytes), loc (compute type,
// or null for no location term), ctx and align (f32).  Returns the CUDA
// error code of the launch.
int attention_step_launch(const void* keys, const void* q, const void* v, const void* mem,
                          const void* mask, const void* loc, void* ctx, void* align, int B,
                          int L, int A, int D, int is_bf16, void* stream) {
  if (B <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return loc ? launch<__nv_bfloat16, true>(keys, q, v, mem, mask, loc, ctx, align, B, L, A,
                                             D, s)
               : launch<__nv_bfloat16, false>(keys, q, v, mem, mask, loc, ctx, align, B, L,
                                              A, D, s);
  return loc ? launch<float, true>(keys, q, v, mem, mask, loc, ctx, align, B, L, A, D, s)
             : launch<float, false>(keys, q, v, mem, mask, loc, ctx, align, B, L, A, D, s);
}

// Kernel 10: keys, q, v, memory (compute type), mask (bool bytes); ctx_u
// [B, D], p_u [B, L], m [B], s [B] (f32).  Returns the CUDA error code of the
// launch.
int attention_step_partial_launch(const void* keys, const void* q, const void* v,
                                  const void* mem, const void* mask, void* ctx, void* p,
                                  void* m, void* sum, int B, int L, int A, int D,
                                  int is_bf16, void* stream) {
  if (B <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16, false, true>(keys, q, v, mem, mask, nullptr, ctx, p, B, L,
                                              A, D, s, m, sum);
  return launch<float, false, true>(keys, q, v, mem, mask, nullptr, ctx, p, B, L, A, D, s, m,
                                    sum);
}

}  // extern "C"
