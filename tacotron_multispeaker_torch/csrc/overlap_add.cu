// Windowed overlap-add of the iSTFT for Hopper (sm_90a).
//
// Replaces tacotron_multispeaker_tpu/ops/overlap_add.py overlap_add_pallas:
//   out[b, s] = sum_f win[s - f*hop] * frames[b, f, s - f*hop] / norm[s]
//   norm[s]   = max(sum_f win[s - f*hop]^2, 1e-10)
// over the frames f whose n_fft samples cover s; frames [B, F, n_fft] in
// f32 or bf16, window [n_fft] f32, out [B, n_fft + hop*(F-1)] f32; the
// window, the sums and the division are f32 whatever the frames' type.
//
// Design: one thread per output sample, summing the at most
// m = ceil(n_fft/hop) frames that cover it in increasing f (the Pallas
// kernel's order), with the window-square norm summed beside it (no norm
// buffer).  Neighbouring threads read neighbouring samples of each frame,
// so the loads coalesce; no scatter, no atomics.
//
// Bound on this card: device memory.  Each frame sample is read once and
// each output written once, about two operations per byte.
//
// Limits (the Python wrapper raises outside them): B*F*n_fft and
// B*out_len below 2^31.

#include "common.cuh"

namespace {

constexpr int NT = 256;

template <typename T>
__global__ void __launch_bounds__(NT)
overlap_add_kernel(const T* __restrict__ frames, const float* __restrict__ win,
                   float* __restrict__ out, int B, int F, int n_fft, int hop, int out_len) {
  const long long idx = (long long)blockIdx.x * NT + threadIdx.x;
  if (idx >= (long long)B * out_len) return;
  const int b = (int)(idx / out_len), s = (int)(idx - (long long)b * out_len);
  const int f_lo = s >= n_fft ? (s - n_fft) / hop + 1 : 0;
  const int f_hi = min(F - 1, s / hop);
  const T* fb = frames + (size_t)b * F * n_fft;
  float acc = 0.f, nrm = 0.f;
  for (int f = f_lo; f <= f_hi; ++f) {
    const int i = s - f * hop;
    const float w = win[i];
    acc += kern::to_f(fb[(size_t)f * n_fft + i]) * w;
    nrm += w * w;
  }
  out[idx] = acc / fmaxf(nrm, 1e-10f);
}

}  // namespace

extern "C" {

// frames (is_bf16 ? bf16 : f32), win and out f32.  Returns the CUDA error
// code of the launch.
int overlap_add_launch(const void* frames, const void* win, void* out, int B, int F,
                       int n_fft, int hop, int is_bf16, void* stream) {
  const int out_len = n_fft + hop * (F - 1);
  const long long n = (long long)B * out_len;
  if (n <= 0) return 0;
  const unsigned blocks = (unsigned)((n + NT - 1) / NT);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    overlap_add_kernel<__nv_bfloat16><<<blocks, NT, 0, s>>>(
        static_cast<const __nv_bfloat16*>(frames), static_cast<const float*>(win),
        static_cast<float*>(out), B, F, n_fft, hop, out_len);
  else
    overlap_add_kernel<float><<<blocks, NT, 0, s>>>(
        static_cast<const float*>(frames), static_cast<const float*>(win),
        static_cast<float*>(out), B, F, n_fft, hop, out_len);
  return int(cudaGetLastError());
}

}  // extern "C"
