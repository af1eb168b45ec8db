// The whole autoregressive Tacotron decode in one launch, for Hopper (sm_90a).
//
// Replaces: tacotron_multispeaker_tpu/ops/decoder_loop.py decoder_loop_pallas.
//
// Per step, for one batch row (same math as decoder_loop_reference there):
//   prenet on the fed-back frame (streamed dropout masks dm1/dm2)
//   -> attention GRU over [prenet, context]
//   -> Bahdanau attention: q = h @ wq, e_l = sum_a tanh(keys_la + q_a) v_a
//      (f32), masked softmax, context = p @ memory
//   -> dec_in Dense over [attn_h, context] -> residual GRU stack
//   -> r*M frame projection; the last of the r frames is fed back.
// Every matrix product rounds its input vector and reads its weights in the
// compute type T (bf16 or f32) and sums in f32; the carries stay f32.
//
// Design: one block of 512 threads per batch row, all n_steps looped inside
// the block (device helpers in decoder_common.cuh).  Batch rows are
// independent once the encoder has run, so no padding and no cross-block
// traffic.  The carries (attention and decoder
// GRU states, context, fed-back frame, prenet activations, energies) live
// in shared memory.  The weights (~1.7 M parameters at full width, 3.4 MB
// in bf16) do not fit in one SM's shared memory; every step reads them from
// global memory, where they stay resident in the 50 MB L2.  Each
// matrix-vector product splits K over thread groups: a thread loads 16 bytes
// (8 bf16 / 4 f32 columns) of a weight row per iteration, partial sums meet
// in shared memory.  Energies: one warp per encoder position.
//
// Bound on this card: the serial chain of ~17 dependent matrix-vector
// products per step, each waiting on L2 reads of its weights; the bytes the
// launch must move (weights once, keys/memory once, outputs) take far less
// time.  Clusters with distributed shared memory (weights split over
// several SMs) or wgmma over a tile of rows are later work.
//
// Limits (the Python wrapper raises outside them): n_layers <= 4; every
// output width (P1, P2, H, 2H, A, D, r*M) a multiple of 16/sizeof(T) and at
// most 512 * 16/sizeof(T); weights and rows 16-byte aligned; shared memory
// (about 4*(8H + 2A + D + P1 + P2 + M + r*M + L + 4096) bytes) <= 227 KB.

#include "decoder_common.cuh"

namespace {

using namespace dec;

constexpr int MAX_LAYERS = 4;

template <typename T>
struct Args {
  const T* keys;            // [B, L, A]
  const T* memory;          // [B, L, D]
  const uint8_t* mask;      // [B, L] (bool)
  const float* dm1;         // [S, B, P1]
  const float* dm2;         // [S, B, P2]
  const float* attn_h0;     // [B, H]
  const float* dec_h0;      // [N, B, H]
  const T* w1; const float* b1;
  const T* w2; const float* b2;
  const T* a_xg_pn; const T* a_xg_ctx; const float* a_bg;
  const T* a_xc_pn; const T* a_xc_ctx; const float* a_bc;
  const T* a_hg; const T* a_hc;
  const T* wq; const T* v;
  const T* d_h; const T* d_ctx; const float* d_b;
  const T* wf; const float* bf;
  float* frames;            // [S, B, RM]
  float* align;             // [S, B, L]
  const T* l_xg[MAX_LAYERS]; const float* l_bg[MAX_LAYERS];
  const T* l_xc[MAX_LAYERS]; const float* l_bc[MAX_LAYERS];
  const T* l_hg[MAX_LAYERS]; const T* l_hc[MAX_LAYERS];
  int B, L, A, D, H, M, P1, P2, RM, n_layers, n_steps;
};

template <typename T>
__global__ void __launch_bounds__(NTHREADS) decoder_loop_kernel(const Args<T> a) {
  extern __shared__ __align__(16) float smem[];
  constexpr int VEC = Vec<T>::N;
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int B = a.B, L = a.L, A = a.A, D = a.D, H = a.H, M = a.M;
  const int P1 = a.P1, P2 = a.P2, RM = a.RM, NL = a.n_layers;

  float* red = smem;                          // NTHREADS * VEC
  float* scratch = red + NTHREADS * VEC;      // 64
  float* prev = scratch + 64;                 // M
  float* p1 = prev + M;                       // P1
  float* pn = p1 + P1;                        // P2
  float* ctx = pn + P2;                       // D
  float* attn_h = ctx + D;                    // H
  float* dec_h = attn_h + H;                  // NL * H
  float* gx = dec_h + NL * H;                 // 2H
  float* cx = gx + 2 * H;                     // H
  float* rh = cx + H;                         // H
  float* u = rh + H;                          // H
  float* x = u + H;                           // H
  float* q = x + H;                           // A
  float* vv = q + A;                          // A
  float* fr = vv + A;                         // RM
  float* e = fr + RM;                         // L

  for (int j = tid; j < H; j += NTHREADS) attn_h[j] = a.attn_h0[size_t(b) * H + j];
  for (int j = tid; j < NL * H; j += NTHREADS) {
    const int i = j / H, c = j % H;
    dec_h[j] = a.dec_h0[(size_t(i) * B + b) * H + c];
  }
  for (int j = tid; j < D; j += NTHREADS) ctx[j] = 0.f;
  for (int j = tid; j < M; j += NTHREADS) prev[j] = 0.f;
  for (int j = tid; j < A; j += NTHREADS) vv[j] = to_f(a.v[j]);
  __syncthreads();

  const T* keys = a.keys + size_t(b) * L * A;
  const T* mem = a.memory + size_t(b) * L * D;
  const uint8_t* mask = a.mask + size_t(b) * L;

  for (int t = 0; t < a.n_steps; ++t) {
    const size_t row = size_t(t) * B + b;
    // ---- prenet on the fed-back frame ------------------------------------
    matvec<T>(prev, a.w1, M, P1, p1, a.b1, false, red);
    for (int j = tid; j < P1; j += NTHREADS) p1[j] = fmaxf(p1[j], 0.f) * a.dm1[row * P1 + j];
    __syncthreads();
    matvec<T>(p1, a.w2, P1, P2, pn, a.b2, false, red);
    for (int j = tid; j < P2; j += NTHREADS) pn[j] = fmaxf(pn[j], 0.f) * a.dm2[row * P2 + j];
    __syncthreads();

    // ---- attention GRU over [prenet, context] -----------------------------
    matvec<T>(pn, a.a_xg_pn, P2, 2 * H, gx, nullptr, false, red);
    matvec<T>(ctx, a.a_xg_ctx, D, 2 * H, gx, a.a_bg, true, red);
    matvec<T>(pn, a.a_xc_pn, P2, H, cx, nullptr, false, red);
    matvec<T>(ctx, a.a_xc_ctx, D, H, cx, a.a_bc, true, red);
    gru_step<T>(attn_h, gx, cx, a.a_hg, a.a_hc, H, rh, u, red);

    // ---- Bahdanau attention: f32 energies, masked softmax, context --------
    matvec<T>(attn_h, a.wq, H, A, q, nullptr, false, red);
    attention_softmax<T>(keys, mask, q, vv, L, A, e, a.align + row * L, scratch);
    matvec<T>(e, mem, L, D, ctx, nullptr, false, red);

    // ---- dec_in Dense over [attn_h, context] + residual GRU stack ---------
    matvec<T>(attn_h, a.d_h, H, H, x, nullptr, false, red);
    matvec<T>(ctx, a.d_ctx, D, H, x, a.d_b, true, red);
    for (int i = 0; i < NL; ++i) {
      matvec<T>(x, a.l_xg[i], H, 2 * H, gx, a.l_bg[i], false, red);
      matvec<T>(x, a.l_xc[i], H, H, cx, a.l_bc[i], false, red);
      float* hi = dec_h + i * H;
      gru_step<T>(hi, gx, cx, a.l_hg[i], a.l_hc[i], H, rh, u, red);
      for (int j = tid; j < H; j += NTHREADS) x[j] += hi[j];
      __syncthreads();
    }

    // ---- r-frame projection; the last frame is fed back -------------------
    matvec<T>(x, a.wf, H, RM, fr, a.bf, false, red);
    float* fo = a.frames + row * RM;
    for (int j = tid; j < RM; j += NTHREADS) {
      const float f = fr[j];
      fo[j] = f;
      if (j >= RM - M) prev[j - (RM - M)] = f;
    }
    __syncthreads();
  }
}

size_t smem_floats(const int* d, int vec) {
  // d: B, L, A, D, H, M, P1, P2, RM, n_layers, n_steps
  const size_t L = d[1], A = d[2], D = d[3], H = d[4], M = d[5], P1 = d[6], P2 = d[7],
               RM = d[8], NL = d[9];
  return size_t(NTHREADS) * vec + 64 + M + P1 + P2 + D + H * (1 + NL) + 2 * H + 4 * H +
         2 * A + RM + L;
}

template <typename T>
int launch(const void* const* p, const int* d, cudaStream_t stream) {
  Args<T> a;
  int i = 0;
  a.keys = static_cast<const T*>(p[i++]);
  a.memory = static_cast<const T*>(p[i++]);
  a.mask = static_cast<const uint8_t*>(p[i++]);
  a.dm1 = static_cast<const float*>(p[i++]);
  a.dm2 = static_cast<const float*>(p[i++]);
  a.attn_h0 = static_cast<const float*>(p[i++]);
  a.dec_h0 = static_cast<const float*>(p[i++]);
  a.w1 = static_cast<const T*>(p[i++]);
  a.b1 = static_cast<const float*>(p[i++]);
  a.w2 = static_cast<const T*>(p[i++]);
  a.b2 = static_cast<const float*>(p[i++]);
  a.a_xg_pn = static_cast<const T*>(p[i++]);
  a.a_xg_ctx = static_cast<const T*>(p[i++]);
  a.a_bg = static_cast<const float*>(p[i++]);
  a.a_xc_pn = static_cast<const T*>(p[i++]);
  a.a_xc_ctx = static_cast<const T*>(p[i++]);
  a.a_bc = static_cast<const float*>(p[i++]);
  a.a_hg = static_cast<const T*>(p[i++]);
  a.a_hc = static_cast<const T*>(p[i++]);
  a.wq = static_cast<const T*>(p[i++]);
  a.v = static_cast<const T*>(p[i++]);
  a.d_h = static_cast<const T*>(p[i++]);
  a.d_ctx = static_cast<const T*>(p[i++]);
  a.d_b = static_cast<const float*>(p[i++]);
  a.wf = static_cast<const T*>(p[i++]);
  a.bf = static_cast<const float*>(p[i++]);
  a.frames = static_cast<float*>(const_cast<void*>(p[i++]));
  a.align = static_cast<float*>(const_cast<void*>(p[i++]));
  a.B = d[0]; a.L = d[1]; a.A = d[2]; a.D = d[3]; a.H = d[4]; a.M = d[5];
  a.P1 = d[6]; a.P2 = d[7]; a.RM = d[8]; a.n_layers = d[9]; a.n_steps = d[10];
  if (a.n_layers > MAX_LAYERS) return int(cudaErrorInvalidValue);
  for (int l = 0; l < MAX_LAYERS; ++l) {
    const bool on = l < a.n_layers;
    a.l_xg[l] = on ? static_cast<const T*>(p[i++]) : nullptr;
    a.l_bg[l] = on ? static_cast<const float*>(p[i++]) : nullptr;
    a.l_xc[l] = on ? static_cast<const T*>(p[i++]) : nullptr;
    a.l_bc[l] = on ? static_cast<const float*>(p[i++]) : nullptr;
    a.l_hg[l] = on ? static_cast<const T*>(p[i++]) : nullptr;
    a.l_hc[l] = on ? static_cast<const T*>(p[i++]) : nullptr;
  }
  const size_t smem = smem_floats(d, Vec<T>::N) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(decoder_loop_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         int(smem));
  if (err != cudaSuccess) return int(err);
  decoder_loop_kernel<T><<<a.B, NTHREADS, smem, stream>>>(a);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

// Bytes of shared memory the kernel needs for the dims d (see launch).
size_t decoder_loop_smem_bytes(const int* d, int is_bf16) {
  return smem_floats(d, is_bf16 ? 8 : 4) * sizeof(float);
}

// ptrs: keys, memory, mask, dm1, dm2, attn_h0, dec_h0, w1, b1, w2, b2,
// a_xg_pn, a_xg_ctx, a_bg, a_xc_pn, a_xc_ctx, a_bc, a_hg, a_hc, wq, v, d_h,
// d_ctx, d_b, wf, bf, frames, align, then per layer l_xg, l_bg, l_xc, l_bc,
// l_hg, l_hc.  dims: B, L, A, D, H, M, P1, P2, RM, n_layers, n_steps.
// Returns the CUDA error code.
int decoder_loop_launch(const void* const* ptrs, const int* dims, int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch<__nv_bfloat16>(ptrs, dims, s) : launch<float>(ptrs, dims, s);
}

}  // extern "C"
