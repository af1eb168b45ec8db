// Overlap-add of the iSTFT, divided by the window-square norm, for Hopper
// (sm_90a).
//
// Replaces tacotron_multispeaker_tpu/ops/overlap_add.py overlap_add_pallas:
//   out[b, s] = sum_f win[s - f*hop] * frames[b, f, s - f*hop] / norm[s]
//   norm[s]   = max(sum_f win[s - f*hop]^2, 1e-10)
// over the frames f whose Wn samples cover s; frames [B, F, Wn] in f32 or
// bf16, window [Wn] f32, out [B, Wn + hop*(F-1)] f32; the window, the sums
// and the division are f32 whatever the frames' type.  With `prewindowed`
// the window is already in the frames (the window-support layout of
// Griffin-Lim folds it into the inverse DFT matrices): the multiply is
// skipped and only the norm reads the window.
//
// Bound on this card: device memory.  Each frame sample is read once and
// each output written once, a few operations a byte.  Design:
// - persistent blocks, as many as the card holds at once: each stages the
//   window in shared memory once (read there by the multiply and the norm)
//   and then takes items grid-stride, an item being TILE = NT*K
//   consecutive output samples of one batch row;
// - a thread takes K samples NT apart, so every load and store of a warp
//   is 32 neighbouring samples of a frame or of the output;
// - the frame loop is unrolled to the compile-time frame count
//   M = ceil(Wn/hop) (5 for Griffin-Lim's 1102-sample support at hop 275,
//   8 for its 2048-sample frames; any other M up to 8 has its own build,
//   larger M a loop), and all K*M predicated frame loads of a thread are
//   issued before the first add;
// - one 32-bit division a thread an item: (q, r) = divmod(s, hop) of its
//   first sample, then stepped by divmod(NT, hop).
// A frame row is Wn*4 (or *2) bytes, not a multiple of 16 at Wn = 1102, so
// the loads are scalar: a warp's 128 bytes straddle two lines, whose other
// part the neighbouring warp reads.  Loads with the evict-first hint
// (`ld.global.cs`) lost that part and ran at 2.3 TB/s; plain loads, and
// K = 2 over K = 4 and 8, 256 over 128 threads, a next-item prefetch and a
// block an item are the choices timed on the card (PERF.md §6, kernel 12).
// Each sample sums its frames in decreasing f from 0, with products that are
// not fused into the adds (__fmul_rn), as the plain version
// (ops/overlap_add.py overlap_add_reference) does: the f32 result is the
// plain version's bit for bit.
//
// Limits (the Python wrapper raises outside them): B*F*Wn and B*out_len
// below 2^31; the window in shared memory, Wn <= 58112 (227 KB).

#include "common.cuh"

namespace {

constexpr int NT = 256;           // threads a block
constexpr int K = 2;              // samples a thread, NT apart
constexpr int TILE = NT * K;      // output samples an item
constexpr int MAX_UNROLL = 8;     // frame counts with a build of their own

// frame f = q - j covers sample s = q*hop + r at i = r + j*hop
__device__ __forceinline__ bool covers(unsigned q, unsigned r, unsigned j, unsigned F,
                                       unsigned Wn, unsigned hop) {
  return q >= j && q - j < F && r + j * hop < Wn;
}

template <bool PREWIN>
__device__ __forceinline__ void accumulate(float x, float w, float& acc, float& nrm) {
  acc += PREWIN ? x : __fmul_rn(x, w);
  nrm += __fmul_rn(w, w);
}

// M > 0: exactly M = ceil(Wn/hop) frames a sample, unrolled; M = 0: a loop
// over m of them
template <typename T, bool PREWIN, int M>
__global__ void __launch_bounds__(NT)
overlap_add_kernel(const T* __restrict__ frames, const float* __restrict__ win,
                   float* __restrict__ out, int B, unsigned F, unsigned Wn, unsigned hop,
                   unsigned m, unsigned out_len) {
  extern __shared__ float w_s[];
  for (unsigned i = threadIdx.x; i < Wn; i += NT) w_s[i] = __ldg(win + i);
  __syncthreads();
  const unsigned dq = NT / hop, dr = NT - dq * hop;
  const unsigned tiles = (out_len + TILE - 1) / TILE;
  const unsigned items = tiles * unsigned(B);
  for (unsigned it = blockIdx.x; it < items; it += gridDim.x) {
    const unsigned b = it / tiles;
    const unsigned s0 = (it - b * tiles) * TILE + threadIdx.x;
    const T* fb = frames + (size_t)b * F * Wn;
    float* ob = out + (size_t)b * out_len;
    unsigned q = s0 / hop, r = s0 - q * hop;
    if constexpr (M > 0) {
      float x[K][M];
      unsigned qk[K], rk[K];
#pragma unroll
      for (int k = 0; k < K; ++k) {
#pragma unroll
        for (int j = 0; j < M; ++j)
          x[k][j] = covers(q, r, j, F, Wn, hop) ? kern::to_f(fb[(q - j) * Wn + r + j * hop])
                                                : 0.f;
        qk[k] = q;
        rk[k] = r;
        q += dq;
        r += dr;
        if (r >= hop) { r -= hop; ++q; }
      }
#pragma unroll
      for (int k = 0; k < K; ++k) {
        float acc = 0.f, nrm = 0.f;
#pragma unroll
        for (int j = 0; j < M; ++j) {
          const bool ok = covers(qk[k], rk[k], j, F, Wn, hop);
          accumulate<PREWIN>(x[k][j], ok ? w_s[rk[k] + j * hop] : 0.f, acc, nrm);
        }
        const unsigned s = s0 + k * NT;
        if (s < out_len) ob[s] = acc / fmaxf(nrm, 1e-10f);
      }
    } else {
#pragma unroll
      for (int k = 0; k < K; ++k) {
        float acc = 0.f, nrm = 0.f;
        for (unsigned j = 0; j < m && j <= q; ++j) {
          const unsigned i = r + j * hop;
          if (i >= Wn) break;
          if (q - j < F) accumulate<PREWIN>(kern::to_f(fb[(q - j) * Wn + i]), w_s[i], acc, nrm);
        }
        const unsigned s = s0 + k * NT;
        if (s < out_len) ob[s] = acc / fmaxf(nrm, 1e-10f);
        q += dq;
        r += dr;
        if (r >= hop) { r -= hop; ++q; }
      }
    }
  }
}

template <typename T, bool PREWIN, int M>
cudaError_t launch(const void* frames, const float* win, float* out, int B, unsigned F,
                   unsigned Wn, unsigned hop, unsigned m, unsigned out_len,
                   cudaStream_t stream) {
  const size_t smem = size_t(Wn) * sizeof(float);
  auto kernel = overlap_add_kernel<T, PREWIN, M>;
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (e != cudaSuccess) return e;
  }
  // persistent blocks: as many as the card holds at once, each staging the
  // window once and then taking (row, tile) items grid-stride.  The
  // occupancy query is kept for the last window size of this build.
  static size_t occ_smem = 0;
  static int occ_per_sm = 0;
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess && (occ_per_sm == 0 || occ_smem != smem)) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ_per_sm, kernel, NT, smem);
    occ_smem = smem;
  }
  if (e != cudaSuccess) return e;
  const int per_sm = occ_per_sm;
  const long long items = (long long)((out_len + TILE - 1) / TILE) * B;
  const long long cap = (long long)sms * (per_sm > 0 ? per_sm : 1);
  const unsigned grid = unsigned(items < cap ? items : cap);
  kernel<<<grid, NT, smem, stream>>>(static_cast<const T*>(frames), win, out, B, F, Wn, hop,
                                     m, out_len);
  return cudaGetLastError();
}

template <typename T, bool PREWIN>
cudaError_t dispatch(const void* frames, const float* win, float* out, int B, unsigned F,
                     unsigned Wn, unsigned hop, unsigned m, unsigned out_len,
                     cudaStream_t s) {
  static_assert(MAX_UNROLL == 8, "one case a frame count");
  switch (m) {
    case 1: return launch<T, PREWIN, 1>(frames, win, out, B, F, Wn, hop, m, out_len, s);
    case 2: return launch<T, PREWIN, 2>(frames, win, out, B, F, Wn, hop, m, out_len, s);
    case 3: return launch<T, PREWIN, 3>(frames, win, out, B, F, Wn, hop, m, out_len, s);
    case 4: return launch<T, PREWIN, 4>(frames, win, out, B, F, Wn, hop, m, out_len, s);
    case 5: return launch<T, PREWIN, 5>(frames, win, out, B, F, Wn, hop, m, out_len, s);
    case 6: return launch<T, PREWIN, 6>(frames, win, out, B, F, Wn, hop, m, out_len, s);
    case 7: return launch<T, PREWIN, 7>(frames, win, out, B, F, Wn, hop, m, out_len, s);
    case 8: return launch<T, PREWIN, 8>(frames, win, out, B, F, Wn, hop, m, out_len, s);
    default: return launch<T, PREWIN, 0>(frames, win, out, B, F, Wn, hop, m, out_len, s);
  }
}

}  // namespace

extern "C" {

// frames (is_bf16 ? bf16 : f32) [B, F, Wn], win [Wn] and out [B, Wn +
// hop*(F-1)] f32.  Returns the CUDA error code of the launch.
int overlap_add_launch(const void* frames, const void* win, void* out, int B, int F, int Wn,
                       int hop, int is_bf16, int prewindowed, void* stream) {
  if (B <= 0) return 0;
  if (F < 1 || Wn < 1 || hop < 1) return int(cudaErrorInvalidValue);
  const long long out_len = Wn + (long long)hop * (F - 1);
  if (out_len * B > 0x7fffffffLL || (long long)B * F * Wn > 0x7fffffffLL)
    return int(cudaErrorInvalidValue);
  // one frame: hop is unused; taking Wn keeps r + j*hop below 2^32
  const unsigned h = F == 1 ? unsigned(Wn) : unsigned(hop);
  const unsigned m = (unsigned(Wn) + h - 1) / h;
  const float* w = static_cast<const float*>(win);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned n = unsigned(out_len);
  cudaError_t e;
  if (is_bf16)
    e = prewindowed ? dispatch<__nv_bfloat16, true>(frames, w, o, B, F, Wn, h, m, n, s)
                    : dispatch<__nv_bfloat16, false>(frames, w, o, B, F, Wn, h, m, n, s);
  else
    e = prewindowed ? dispatch<float, true>(frames, w, o, B, F, Wn, h, m, n, s)
                    : dispatch<float, false>(frames, w, o, B, F, Wn, h, m, n, s);
  return int(e);
}

// the largest window (Wn) the kernel stages in shared memory
int overlap_add_max_window() { return 232448 / int(sizeof(float)); }

}  // extern "C"
