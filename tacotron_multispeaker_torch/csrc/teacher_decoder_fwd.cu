// The teacher-forced decoder scan, forward, in one launch for Hopper (sm_90a).
//
// Replaces: tacotron_multispeaker_tpu/ops/teacher_decoder.py
// _teacher_decoder_fwd_pallas (Tacotron.teacher_mel in the train step).
//
// Per step t, for one batch row (same math as teacher_decoder_fwd_reference
// in ops/teacher_decoder.py):
//   attention GRU with input sums png[t] + cb[H:3H], pnc[t] + cb[3H:4H]
//   (cb = the previous step's context block, zero at t = 0)
//   -> Bahdanau attention: q = ha @ wq, e_l = sum_a tanh(keys_la + q_a) v_a
//      (f32), masked softmax, ctx = p @ memory
//   -> cb = ctx @ w_ctx ([dec_in ctx | attn xg ctx | attn xc ctx], 4H)
//   -> x = ha @ wd_h + cb[:H] + d_b -> residual GRU stack (x += h_i)
// Streams out xs[t] = x, align[t] = p and the states the backward
// rematerialises from, ha[t] and hd_i[t] (all f32).  Every product rounds its
// input vector and reads its weights in the compute type T (bf16 or f32),
// sums in f32; the carries stay f32.  The initial states are rounded to T,
// as the Pallas kernel receives them.
//
// Design: decoder_loop.cu's step without the prenet and the frame projection
// (device helpers shared through decoder_common.cuh): one block of 512
// threads per batch row loops all S steps; carries in shared memory; the
// ~1.4 M weights (2.9 MB bf16 at full width) read from global memory every
// step, where they stay resident in the 50 MB L2, with 16-byte loads and K
// split over thread groups.  Energies: one warp per encoder position, any L.
//
// Bound on this card: the serial chain of ~14 dependent matrix-vector
// products per step, each waiting on L2 reads of its weights; the bytes the
// launch must move take far less time.
//
// Limits (the Python wrapper raises outside them): N <= 4 layers; H, 2H, 3H,
// 4H, A and D multiples of 16/sizeof(T) and at most 512*16/sizeof(T);
// weights and rows 16-byte aligned; shared memory
// (4*(NTHREADS*16/sizeof(T) + 64 + (12+N)H + 2A + D + L) bytes) <= 227 KB.

#include "decoder_common.cuh"

namespace {

using namespace dec;

constexpr int MAX_LAYERS = 4;

template <typename T>
struct Args {
  const T* png;             // [S, B, 2H]
  const T* pnc;             // [S, B, H]
  const T* keys;            // [B, L, A]
  const T* memory;          // [B, L, D]
  const uint8_t* mask;      // [B, L]
  const float* h0a;         // [B, H]
  const float* h0d;         // [N, B, H]
  const T* a_hg; const T* a_hc; const T* wq; const T* v;
  const T* w_ctx; const T* wd_h; const float* d_b;
  float* xs;                // [S, B, H]
  float* align;             // [S, B, L]
  float* ha;                // [S, B, H]
  const T* w_r[MAX_LAYERS]; const float* b_r[MAX_LAYERS];
  const T* hg[MAX_LAYERS]; const T* hc[MAX_LAYERS];
  float* hd[MAX_LAYERS];    // N x [S, B, H]
  int S, B, L, A, D, H, N;
};

template <typename T>
__global__ void __launch_bounds__(NTHREADS) teacher_fwd_kernel(const Args<T> a) {
  extern __shared__ __align__(16) float smem[];
  constexpr int VEC = Vec<T>::N;
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int B = a.B, L = a.L, A = a.A, D = a.D, H = a.H, NL = a.N;

  float* red = smem;                          // NTHREADS * VEC
  float* scratch = red + NTHREADS * VEC;      // 64
  float* h_a = scratch + 64;                  // H
  float* h_d = h_a + H;                       // NL * H
  float* cb = h_d + NL * H;                   // 4H
  float* gx = cb + 4 * H;                     // 3H (gate sums | candidate sums)
  float* rh = gx + 3 * H;                     // H
  float* u = rh + H;                          // H
  float* x = u + H;                           // H
  float* q = x + H;                           // A
  float* vv = q + A;                          // A
  float* ctx = vv + A;                        // D
  float* e = ctx + D;                         // L

  for (int j = tid; j < H; j += NTHREADS) h_a[j] = rnd<T>(a.h0a[size_t(b) * H + j]);
  for (int j = tid; j < NL * H; j += NTHREADS) {
    const int i = j / H, c = j % H;
    h_d[j] = rnd<T>(a.h0d[(size_t(i) * B + b) * H + c]);
  }
  for (int j = tid; j < 4 * H; j += NTHREADS) cb[j] = 0.f;
  for (int j = tid; j < A; j += NTHREADS) vv[j] = to_f(a.v[j]);
  __syncthreads();

  const T* keys = a.keys + size_t(b) * L * A;
  const T* mem = a.memory + size_t(b) * L * D;
  const uint8_t* mask = a.mask + size_t(b) * L;

  for (int t = 0; t < a.S; ++t) {
    const size_t row = size_t(t) * B + b;
    // ---- attention GRU: input sums from the prenet and the carried block --
    for (int j = tid; j < 2 * H; j += NTHREADS)
      gx[j] = to_f(a.png[row * 2 * H + j]) + cb[H + j];
    for (int j = tid; j < H; j += NTHREADS)
      gx[2 * H + j] = to_f(a.pnc[row * H + j]) + cb[3 * H + j];
    __syncthreads();
    gru_step<T>(h_a, gx, gx + 2 * H, a.a_hg, a.a_hc, H, rh, u, red);
    for (int j = tid; j < H; j += NTHREADS) a.ha[row * H + j] = h_a[j];

    // ---- Bahdanau attention, context, context block ----------------------
    matvec<T>(h_a, a.wq, H, A, q, nullptr, false, red);
    attention_softmax<T>(keys, mask, q, vv, L, A, e, a.align + row * L, scratch);
    matvec<T>(e, mem, L, D, ctx, nullptr, false, red);
    matvec<T>(ctx, a.w_ctx, D, 4 * H, cb, nullptr, false, red);

    // ---- dec_in + residual GRU stack --------------------------------------
    matvec<T>(h_a, a.wd_h, H, H, x, nullptr, false, red);
    for (int j = tid; j < H; j += NTHREADS) x[j] = x[j] + cb[j] + a.d_b[j];
    __syncthreads();
    for (int i = 0; i < NL; ++i) {
      matvec<T>(x, a.w_r[i], H, 3 * H, gx, a.b_r[i], false, red);
      float* hi = h_d + i * H;
      gru_step<T>(hi, gx, gx + 2 * H, a.hg[i], a.hc[i], H, rh, u, red);
      for (int j = tid; j < H; j += NTHREADS) {
        a.hd[i][row * H + j] = hi[j];
        x[j] += hi[j];
      }
      __syncthreads();
    }
    for (int j = tid; j < H; j += NTHREADS) a.xs[row * H + j] = x[j];
  }
}

size_t smem_floats(const int* d) {
  // d: S, B, L, A, D, H, N, is_bf16
  const size_t L = d[2], A = d[3], D = d[4], H = d[5], NL = d[6];
  const size_t vec = d[7] ? 8 : 4;
  return size_t(NTHREADS) * vec + 64 + H * (1 + NL) + 4 * H + 3 * H + 3 * H + 2 * A + D + L;
}

template <typename T>
int launch(const void* const* p, const int* d, cudaStream_t stream) {
  Args<T> a;
  int i = 0;
  a.png = static_cast<const T*>(p[i++]);
  a.pnc = static_cast<const T*>(p[i++]);
  a.keys = static_cast<const T*>(p[i++]);
  a.memory = static_cast<const T*>(p[i++]);
  a.mask = static_cast<const uint8_t*>(p[i++]);
  a.h0a = static_cast<const float*>(p[i++]);
  a.h0d = static_cast<const float*>(p[i++]);
  a.a_hg = static_cast<const T*>(p[i++]);
  a.a_hc = static_cast<const T*>(p[i++]);
  a.wq = static_cast<const T*>(p[i++]);
  a.v = static_cast<const T*>(p[i++]);
  a.w_ctx = static_cast<const T*>(p[i++]);
  a.wd_h = static_cast<const T*>(p[i++]);
  a.d_b = static_cast<const float*>(p[i++]);
  a.xs = static_cast<float*>(const_cast<void*>(p[i++]));
  a.align = static_cast<float*>(const_cast<void*>(p[i++]));
  a.ha = static_cast<float*>(const_cast<void*>(p[i++]));
  a.S = d[0]; a.B = d[1]; a.L = d[2]; a.A = d[3]; a.D = d[4]; a.H = d[5]; a.N = d[6];
  if (a.N > MAX_LAYERS) return int(cudaErrorInvalidValue);
  for (int l = 0; l < MAX_LAYERS; ++l) {
    const bool on = l < a.N;
    a.w_r[l] = on ? static_cast<const T*>(p[i++]) : nullptr;
    a.b_r[l] = on ? static_cast<const float*>(p[i++]) : nullptr;
    a.hg[l] = on ? static_cast<const T*>(p[i++]) : nullptr;
    a.hc[l] = on ? static_cast<const T*>(p[i++]) : nullptr;
    a.hd[l] = on ? static_cast<float*>(const_cast<void*>(p[i++])) : nullptr;
  }
  const size_t smem = smem_floats(d) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(teacher_fwd_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         int(smem));
  if (err != cudaSuccess) return int(err);
  teacher_fwd_kernel<T><<<a.B, NTHREADS, smem, stream>>>(a);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

// Bytes of shared memory the kernel needs for the dims d (see launch).
size_t teacher_decoder_fwd_smem_bytes(const int* d) { return smem_floats(d) * sizeof(float); }

// ptrs: png, pnc, keys, memory, mask, h0a, h0d, a_hg, a_hc, wq, v, w_ctx, wd_h,
// d_b, xs, align, ha, then per layer w_r, b_r, hg, hc, hd.
// dims: S, B, L, A, D, H, N, is_bf16.  Returns the CUDA error code.
int teacher_decoder_fwd_launch(const void* const* ptrs, const int* dims, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dims[7] ? launch<__nv_bfloat16>(ptrs, dims, s) : launch<float>(ptrs, dims, s);
}

}  // extern "C"
