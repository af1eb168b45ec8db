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
// holds LB = 16 encoder positions of keys and their LB dkeys accumulators in
// registers (at L = 192, B = 32: 384 blocks of 77 registers a thread, one
// wave of three an SM; 24 positions took 179 registers, one block an SM,
// and 6 % more time: tools/dkeys_variants.py), and
// walks t in chunks of TC steps: each chunk's q (a thread its own column)
// and de [TC, LB] arrive in shared memory by cp.async into one of two
// buffers while the chunk before is summed, one barrier a chunk.  Each t
// adds in the same order as the Pallas kernel.  dv: each block writes its
// column sums to a partial buffer [B * ceil(L/LB), A]; a second small
// kernel adds those in block order, so the result does not change from run
// to run (no atomics).
//
// No tanhf on the unguarded elements: with E_k = exp(2k) and E_q = exp(2q),
// e^{2(k+q)} = E_k E_q, so
//   r = 1 / (1 + E_k E_q),   act = 1 - 2r,   (1 - act^2) / 4 = r - r^2.
// E_k is made once per (b, l, a) and kept in a register over the whole t
// loop (k itself is read again only for a guarded element), E_q once per
// (t, b, a) in a block, shared by its LB positions; an element then costs
// one FMA, one approximate reciprocal (the special-function unit) and four
// FMAs.  dkeys accumulates de * (r - r^2) and is scaled by 4 v[a] at the
// end (exact: a power of two and one product).  Guard: where |k| > 20 or
// |q| > 20 the product could overflow f32 (e^{2x} overflows past x ~ 44, and
// a huge E_k times a vanishing E_q is 0 * inf), so such an element takes
// tanhf.  k's test is a bit mask held over the loop; q's is E_q = -1, made
// once a step; a warp takes the guarded loop for a step only when one of
// its lanes needs it.  The results differ from tanhf's by a few ulp.
//
// Bound on this card: the S*B*L*A activations (3.1e8 at full width), now
// one reciprocal each on the special-function unit (16 a clock an SM:
// ~0.08 ms at full width) and five FMA-pipe instructions; the bytes (keys
// and dkeys once, q and de once per block) are far fewer.
//
// Limits (the Python wrapper raises outside them): A <= 1024 threads;
// B <= 65535.

#include "common.cuh"

namespace {

using namespace kern;

constexpr int LB = 16;        // encoder positions per block
constexpr int TC = 16;        // time steps a chunk
constexpr float GUARD = 20.f; // |k| or |q| past it: the element takes tanhf

__device__ __forceinline__ float rcp_approx(float x) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

// 4 bytes from global to shared memory without the registers (cp.async);
// zeros where ok is false
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool ok) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(ok ? 4 : 0)
               : "memory");
}

// MAXT: the block's largest size (256 for A <= 256, whose registers then
// hold LB positions without spilling; 1024 otherwise)
template <typename T, int MAXT>
__global__ void __launch_bounds__(MAXT)
dkeys_kernel(const T* __restrict__ keys, const float* __restrict__ q,
             const float* __restrict__ de, const T* __restrict__ v,
             float* __restrict__ dkeys, float* __restrict__ part, int S, int B, int L, int A) {
  extern __shared__ __align__(16) float smem[];
  const int AP = blockDim.x;          // A rounded up to a warp
  float* qs = smem;                   // [2][TC][AP]: q of a chunk, two chunks
  float* ds = qs + 2 * TC * AP;       // [2][TC][LB]: de of a chunk
  const int lb = blockIdx.x, b = blockIdx.y;
  const int l0 = lb * LB;
  const int c = threadIdx.x;
  const bool on = c < A;

  // chunk ch of q (this thread's column) and de into buffer ch % 2
  auto fetch = [&](int ch) {
    const int t0 = ch * TC, buf = ch & 1;
#pragma unroll
    for (int tt = 0; tt < TC; ++tt) {
      const bool ok = on && t0 + tt < S;
      cp_async4(qs + (buf * TC + tt) * AP + c, q + (size_t(ok ? t0 + tt : 0) * B + b) * A +
                                                   (ok ? c : 0), ok);
    }
    for (int k = threadIdx.x; k < TC * LB; k += blockDim.x) {
      const int tt = k / LB, i = k % LB;
      const bool ok = t0 + tt < S && l0 + i < L;
      cp_async4(ds + buf * TC * LB + k,
                de + (size_t(ok ? t0 + tt : 0) * B + b) * L + (ok ? l0 + i : 0), ok);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };
  const int n_chunks = (S + TC - 1) / TC;
  if (n_chunks > 0) fetch(0);

  // E_k in registers; k itself is read again only for a guarded element
  const T* krow = keys + (size_t(b) * L + l0) * A + c;
  float ek[LB], acc[LB];
  uint32_t kbig = 0;                  // bit i: |k_i| > GUARD
  const float va = on ? to_f(v[c]) : 0.f;
#pragma unroll
  for (int i = 0; i < LB; ++i) {
    acc[i] = 0.f;
    const float k = (on && l0 + i < L) ? to_f(krow[size_t(i) * A]) : 0.f;
    ek[i] = __expf(2.f * k);
    if (fabsf(k) > GUARD) kbig |= 1u << i;
  }
  float dv = 0.f;

  for (int ch = 0; ch < n_chunks; ++ch) {
    // chunk ch has landed, and every thread is done with chunk ch - 1: its
    // buffer takes chunk ch + 1 while this one is summed
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();
    if (ch + 1 < n_chunks) fetch(ch + 1);
    const int buf = ch & 1, n = min(TC, S - ch * TC);
    for (int tt = 0; tt < n; ++tt) {
      const float qa = qs[(buf * TC + tt) * AP + c];
      const float eq = fabsf(qa) > GUARD ? -1.f : __expf(2.f * qa);
      const float* drow = ds + (buf * TC + tt) * LB;
      if (__any_sync(0xffffffffu, kbig != 0 || eq < 0.f)) {
#pragma unroll
        for (int i = 0; i < LB; ++i) {
          const float d = drow[i];
          float act, h;               // h = (1 - act^2) / 4
          if (((kbig >> i) & 1u) || eq < 0.f) {
            act = tanhf((on && l0 + i < L ? to_f(krow[size_t(i) * A]) : 0.f) + qa);
            h = 0.25f * (1.f - act * act);
          } else {
            const float r = rcp_approx(fmaf(ek[i], eq, 1.f));
            act = fmaf(-2.f, r, 1.f);
            h = fmaf(-r, r, r);
          }
          acc[i] = fmaf(d, h, acc[i]);
          dv = fmaf(d, act, dv);
        }
      } else {
#pragma unroll
        for (int i = 0; i < LB; i += 4) {
          const float4 d4 = *reinterpret_cast<const float4*>(drow + i);
          const float d[4] = {d4.x, d4.y, d4.z, d4.w};
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const float r = rcp_approx(fmaf(ek[i + u], eq, 1.f));
            acc[i + u] = fmaf(d[u], fmaf(-r, r, r), acc[i + u]);
            dv = fmaf(d[u], fmaf(-2.f, r, 1.f), dv);
          }
        }
      }
    }
  }
  if (on) {
    const float v4 = 4.f * va;
#pragma unroll
    for (int i = 0; i < LB; ++i)
      if (l0 + i < L) dkeys[(size_t(b) * L + l0 + i) * A + c] = v4 * acc[i];
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

size_t smem_bytes(int threads) { return size_t(2) * TC * (threads + LB) * sizeof(float); }

template <typename T>
int launch(const void* keys, const float* q, const float* de, const void* v, float* dk,
           float* dv, float* part, int S, int B, int L, int A, cudaStream_t stream) {
  const int threads = ((A + 31) / 32) * 32;
  const size_t smem = smem_bytes(threads);
  auto kernel = threads <= 256 ? dkeys_kernel<T, 256> : dkeys_kernel<T, 1024>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         int(smem));
  if (err != cudaSuccess) return int(err);
  dim3 grid(l_blocks(L), B);
  kernel<<<grid, threads, smem, stream>>>(static_cast<const T*>(keys), q, de,
                                          static_cast<const T*>(v), dk, part, S, B, L, A);
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
