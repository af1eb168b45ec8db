// Fast Griffin-Lim iterations for Hopper (sm_90a).
//
// Replaces tacotron_multispeaker_tpu/ops/gl_iteration.py
// gl_fast_iterations_pallas.  Per iteration, over all G = B*F frames at once
// (frames wf [G, n_fft] in the compute type T, bf16 or f32):
//   1. gl_fwd_kernel: [re | im] = wf @ [C | S] (f32 sums); its epilogue does
//      the momentum extrapolation a = (re, im) - mom * (pre, pim), the
//      magnitude projection s = a * mag / max(|a|, 1e-8) and (pre, pim) =
//      (re, im), writing s (sre, sim) and the state in f32, and s rounded to
//      T into st [G, 2*bp] (sre at 0, sim at bp = bins rounded up to 8);
//   2. gl_inv_kernel: fr = st @ [iC; iS] (zero rows at the pads), one
//      product of depth 2*bp, fr in f32;
//   3. gl_ola_kernel: the overlap-add and re-framing as one banded operator,
//      wf[g, i] = round_T(N[g, i] * sum_d S[d, i] * fr[g - d, i + d*hop]),
//      d = -(m-1) .. m-1 in that order, f32 sums.
// The last iteration stops after step 1 (its frames would not be read).
// One host call launches all 3*n_iters - 2 kernels on the stream.
//
// Design for this card: the TPU kernel keeps one batch row's [F, n_fft]
// frames and all four DFT matrices in VMEM for every iteration.  Here a
// row's frames alone are 4 MB in bf16 (F=1000, n_fft=2048) against 227 KB
// of shared memory, so the iteration is split at its two products and the
// frames, spectra and fr go through device memory (and the 50 MB L2)
// between the three kernels.  The products run on the shared tile of
// mma_common.cuh (128 x 64 on the tensor cores for bf16 with double-
// buffered cp.async loads; 64 x 64 FMAs for f32) over all B*F frames, so
// even a B=1 request has F/128 row tiles x 33 column tiles of work; the
// forward matrix interleaves 32 cosine and 32 sine columns per 64-wide
// tile so that one block's epilogue sees re and im of the same bins.  The
// banded pass reads each fr element 2m-1 times (15 at n_fft 2048, hop
// 275), mostly from L2.
//
// Bound on this card: the tensor cores (8*n_fft*bins operations per frame
// and iteration, ~0.54 TFLOP per iteration at B=32, F=1000, n_fft=2048,
// against ~0.5 GB of traffic); the WMMA tile reaches a part of that rate
// and each kernel round-trips its operands through device memory.  One
// persistent kernel per iteration with a wgmma tile is later work.
//
// Limits (the Python wrapper raises outside them): n_fft a multiple of 8,
// G*n_fft and G*2*bp below 2^31; grid.y = ceil(bins/32) and ceil(n_fft/64)
// at most 65535.

#include "common.cuh"
#include "mma_common.cuh"

namespace {

constexpr int BIN_TILE = 32;   // bins per forward output tile (re | im in 64 columns)

template <typename T>
__global__ void __launch_bounds__(kern::Tile<T>::NT)
gl_fwd_kernel(const T* __restrict__ wf, const T* __restrict__ cf, const float* __restrict__ mag,
              float* __restrict__ sre, float* __restrict__ sim, float* __restrict__ pre,
              float* __restrict__ pim, T* __restrict__ st, int G, int n_fft, int bins, int bp,
              int ncol, float mom) {
  using Tile = kern::Tile<T>;
  static_assert(Tile::BN == 2 * BIN_TILE, "re | im per tile");
  __shared__ typename Tile::Smem s;
  const int row0 = blockIdx.x * Tile::BM, c0 = blockIdx.y * Tile::BN;
  auto pa = [&](int r, int k) -> const T* {
    const int row = row0 + r;
    return row < G ? wf + (size_t)row * n_fft + k : nullptr;
  };
  auto pb = [&](int k, int c) -> const T* { return cf + (size_t)k * ncol + c0 + c; };
  Tile::run(s, n_fft, pa, pb);
  const float* C = Tile::out(s);
  // The epilogue is a stream of dependent device-memory reads (pre, pim,
  // mag) at the tile's low occupancy; one element at a time it took ~70%
  // of the kernel.  Each thread issues the reads of EPI elements before it
  // uses any of them.
  constexpr int EPI = 8, PER = Tile::BM * BIN_TILE / Tile::NT;
  static_assert(PER % EPI == 0, "epilogue batches");
  for (int e0 = 0; e0 < PER; e0 += EPI) {
    float vp[EPI], vi[EPI], vm[EPI];
#pragma unroll
    for (int u = 0; u < EPI; ++u) {
      const int i = threadIdx.x + (e0 + u) * Tile::NT;
      const int row = row0 + i / BIN_TILE, bin = blockIdx.y * BIN_TILE + i % BIN_TILE;
      const size_t o = (size_t)row * bins + bin;
      const bool ok = row < G && bin < bins;
      vp[u] = ok ? pre[o] : 0.f;
      vi[u] = ok ? pim[o] : 0.f;
      vm[u] = ok ? mag[o] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < EPI; ++u) {
      const int i = threadIdx.x + (e0 + u) * Tile::NT;
      const int r = i / BIN_TILE, j = i % BIN_TILE;
      const int row = row0 + r, bin = blockIdx.y * BIN_TILE + j;
      if (row >= G || bin >= bins) continue;
      const float re = C[r * Tile::LDC + j];
      const float im = C[r * Tile::LDC + BIN_TILE + j];
      const size_t o = (size_t)row * bins + bin;
      const float are = re - mom * vp[u];
      const float aim = im - mom * vi[u];
      pre[o] = re;
      pim[o] = im;
      const float scale = vm[u] / fmaxf(sqrtf(are * are + aim * aim), 1e-8f);
      const float xr = are * scale, xi = aim * scale;
      sre[o] = xr;
      sim[o] = xi;
      st[(size_t)row * 2 * bp + bin] = kern::from_f<T>(xr);
      st[(size_t)row * 2 * bp + bp + bin] = kern::from_f<T>(xi);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kern::Tile<T>::NT)
gl_inv_kernel(const T* __restrict__ st, const T* __restrict__ ci, float* __restrict__ fr,
              int G, int n_fft, int bp) {
  using Tile = kern::Tile<T>;
  __shared__ typename Tile::Smem s;
  const int row0 = blockIdx.x * Tile::BM, c0 = blockIdx.y * Tile::BN;
  auto pa = [&](int r, int k) -> const T* {
    const int row = row0 + r;
    return row < G ? st + (size_t)row * 2 * bp + k : nullptr;
  };
  auto pb = [&](int k, int c) -> const T* {
    const int col = c0 + c;
    return col < n_fft ? ci + (size_t)k * n_fft + col : nullptr;
  };
  Tile::run(s, 2 * bp, pa, pb);
  const float* C = Tile::out(s);
  for (int i = threadIdx.x; i < Tile::BM * Tile::BN; i += Tile::NT) {
    const int r = i / Tile::BN, c = i % Tile::BN;
    const int row = row0 + r, col = c0 + c;
    if (row < G && col < n_fft) fr[(size_t)row * n_fft + col] = C[r * Tile::LDC + c];
  }
}

template <typename T>
__global__ void __launch_bounds__(256)
gl_ola_kernel(const float* __restrict__ fr, const float* __restrict__ nrm,
              const float* __restrict__ shift, T* __restrict__ wf, int B, int F, int n_fft,
              int hop, int m) {
  const long long idx = (long long)blockIdx.x * 256 + threadIdx.x;
  if (idx >= (long long)B * F * n_fft) return;
  const int i = (int)(idx % n_fft);
  const long long bg = idx / n_fft;
  const int g = (int)(bg % F);
  const float* frb = fr + (bg - g) * n_fft;       // batch row's first frame
  float acc = 0.f;
  for (int d = -(m - 1); d <= m - 1; ++d) {
    const int gs = g - d, is = i + d * hop;
    if (gs < 0 || gs >= F || is < 0 || is >= n_fft) continue;
    acc += frb[(size_t)gs * n_fft + is] * shift[(size_t)(d + m - 1) * n_fft + i];
  }
  wf[idx] = kern::from_f<T>(acc * nrm[(size_t)g * n_fft + i]);
}

template <typename T>
int launch_all(void* wf, const void* mag, const void* fwd, const void* inv, const void* nrm,
               const void* shift, void* fr, void* st, void* sre, void* sim, void* pre,
               void* pim, int B, int F, int n_fft, int hop, int n_iters, float mom,
               cudaStream_t s) {
  using Tile = kern::Tile<T>;
  const int G = B * F, bins = n_fft / 2 + 1, bp = (bins + 7) / 8 * 8;
  const int tiles = (bins + BIN_TILE - 1) / BIN_TILE, ncol = tiles * Tile::BN;
  const int m = (n_fft + hop - 1) / hop;
  const dim3 fwd_grid((G + Tile::BM - 1) / Tile::BM, tiles);
  const dim3 inv_grid((G + Tile::BM - 1) / Tile::BM, (n_fft + Tile::BN - 1) / Tile::BN);
  const long long n = (long long)G * n_fft;
  const unsigned ola_blocks = (unsigned)((n + 255) / 256);
  if (fwd_grid.y > 65535 || inv_grid.y > 65535) return int(cudaErrorInvalidValue);
  T* wft = static_cast<T*>(wf);
  T* stt = static_cast<T*>(st);
  float* frf = static_cast<float*>(fr);
  for (int it = 0; it < n_iters; ++it) {
    gl_fwd_kernel<T><<<fwd_grid, Tile::NT, 0, s>>>(
        wft, static_cast<const T*>(fwd), static_cast<const float*>(mag),
        static_cast<float*>(sre), static_cast<float*>(sim), static_cast<float*>(pre),
        static_cast<float*>(pim), stt, G, n_fft, bins, bp, ncol, mom);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess || it + 1 == n_iters) return int(err);
    gl_inv_kernel<T><<<inv_grid, Tile::NT, 0, s>>>(stt, static_cast<const T*>(inv), frf, G,
                                                   n_fft, bp);
    gl_ola_kernel<T><<<ola_blocks, 256, 0, s>>>(frf, static_cast<const float*>(nrm),
                                                static_cast<const float*>(shift), wft, B, F,
                                                n_fft, hop, m);
    err = cudaGetLastError();
    if (err != cudaSuccess) return int(err);
  }
  return 0;
}

}  // namespace

extern "C" {

// wf [B*F, n_fft] (compute type; updated in place), mag [B*F, bins] f32,
// fwd [n_fft, ceil(bins/32)*64] and inv [2*bp, n_fft] (compute type; bp =
// bins rounded up to 8, zero rows at the pads), nrm [F, n_fft] and shift
// [2m-1, n_fft] f32, fr [B*F, n_fft] f32 and st [B*F, 2*bp] (compute type,
// zeroed by the caller) scratch, sre/sim/pre/pim [B*F, bins] f32 (pre and
// pim zeroed by the caller).  Returns the CUDA error code of the first
// failed launch, or 0.
int gl_iterations_launch(void* wf, const void* mag, const void* fwd, const void* inv,
                         const void* nrm, const void* shift, void* fr, void* st, void* sre,
                         void* sim, void* pre, void* pim, int B, int F, int n_fft, int hop,
                         int n_iters, float mom, int is_bf16, void* stream) {
  if (B <= 0 || F <= 0 || n_iters <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch_all<__nv_bfloat16>(wf, mag, fwd, inv, nrm, shift, fr, st, sre, sim, pre,
                                     pim, B, F, n_fft, hop, n_iters, mom, s);
  return launch_all<float>(wf, mag, fwd, inv, nrm, shift, fr, st, sre, sim, pre, pim, B, F,
                           n_fft, hop, n_iters, mom, s);
}

}  // extern "C"
