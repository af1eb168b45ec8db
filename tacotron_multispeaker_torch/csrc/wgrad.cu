// Grouped weight-gradient reduction for Hopper (sm_90a).
//
// Part of the port of tacotron_multispeaker_tpu/ops/gru_scan.py
// _bigru_scan_bwd_pallas and ops/teacher_decoder.py
// _teacher_decoder_bwd_pallas: those kernels add every step's weight
// gradient dot_tn(a_t, g_t) into VMEM accumulators inside their body.  Here
// the sequential backward kernels stream the per-step factors out and this
// kernel reduces them over all rows m (steps x batch rows) at once:
//   C[k, n]  = sum_m round(A[m, k]) * round(G[m, n])      (f32 sums)
//   bias[n]  = sum_m G[m, n]                              (unrounded, f32)
// round() is a cast to the compute type (bf16 or f32), as dot_tn makes it.
// Row m = (o, i) with o = m / m_inner reads A at o*a_so + i*a_si (elements),
// so a direction or a column slice of a stream is read in place.
//
// Design: one launch for a whole backward (up to MAX_PROBLEMS products);
// grid.x walks the 64x64 output tiles of every problem and grid.y splits the
// rows into P ranges, so that a backward with few tiles and many rows (the
// BiGRU's: 24 tiles, 32,000 rows) still fills the card.  A block of 256
// threads stages 32 rows of A and G (rounded, f32) in shared memory and each
// thread accumulates a 4x4 tile of C in registers.  With P > 1 each block
// writes its partial tile to a scratch buffer and a second kernel adds the P
// partials in order; rows are summed in one fixed order either way, so the
// result does not change from run to run (no atomics).  Blocks of the first
// column of tiles also sum G for the bias.
//
// Bound on this card: arithmetic on the f32 pipes (the products are
// 2*M*K*N operations against ~M*(K+N) bytes read); wgmma on bf16 tiles is
// later work.
//
// Limits (the Python wrapper raises outside them): at most MAX_PROBLEMS
// problems per launch; sizes below 2^31; at most 65535 row ranges.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int MAX_PROBLEMS = 24;
constexpr int TILE = 64;      // output tile (K and N)
constexpr int BM = 32;        // rows staged per iteration
constexpr int NT = 256;       // threads per block

struct Problem {
  const void* a;
  const void* g;
  float* c;
  float* bias;
  long long a_so, a_si, g_so, g_si;
  int m_outer, m_inner, K, N, a_bf16, g_bf16;
};

struct Batch {
  Problem p[MAX_PROBLEMS];
  int tile_start[MAX_PROBLEMS + 1];
  long long part_start[MAX_PROBLEMS + 1];  // offset of each problem's partials
  float* part;                             // P * sum(K*N + N) floats, or null
  int n;
  int splits;
  int round_bf16;
};

__device__ __forceinline__ float load(const void* base, long long off, int is_bf16) {
  return is_bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(base)[off])
                 : static_cast<const float*>(base)[off];
}

__device__ __forceinline__ float round_to(float v, int is_bf16) {
  return is_bf16 ? __bfloat162float(__float2bfloat16(v)) : v;
}

__global__ void __launch_bounds__(NT) wgrad_kernel(const Batch bt) {
  __shared__ __align__(16) float As[BM][TILE + 4];
  __shared__ __align__(16) float Gs[BM][TILE + 4];
  __shared__ float bred[NT / TILE][TILE];

  int pi = 0;
  while (pi + 1 < bt.n && int(blockIdx.x) >= bt.tile_start[pi + 1]) ++pi;
  const Problem& P = bt.p[pi];
  const int tile = blockIdx.x - bt.tile_start[pi];
  const int tiles_n = (P.N + TILE - 1) / TILE;
  const int k0 = (tile / tiles_n) * TILE, n0 = (tile % tiles_n) * TILE;
  const bool do_bias = P.bias != nullptr && k0 == 0;
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;        // 4x4 outputs each
  const int lc = tid % TILE, lr = tid / TILE;     // loader column, first row
  const long long M_all = (long long)P.m_outer * P.m_inner;
  const long long per = ((M_all + bt.splits - 1) / bt.splits + BM - 1) / BM * BM;
  const long long m_first = per * blockIdx.y;
  const long long M = M_all < m_first + per ? M_all : m_first + per;
  const int rb = bt.round_bf16;
  // partial results of split blockIdx.y: [K, N] then [N] in the scratch
  float* c_out = P.c;
  float* b_out = P.bias;
  if (bt.part != nullptr) {
    float* base = bt.part + bt.part_start[pi] * bt.splits
                  + (long long)blockIdx.y * ((long long)P.K * P.N + P.N);
    c_out = base;
    b_out = base + (long long)P.K * P.N;
  }

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  float bsum = 0.f;

  for (long long m0 = m_first; m0 < M; m0 += BM) {
#pragma unroll
    for (int rr = 0; rr < BM; rr += NT / TILE) {
      const int r = lr + rr;
      const long long m = m0 + r;
      float av = 0.f, gv = 0.f;
      if (m < M) {
        const long long o = m / P.m_inner, i = m % P.m_inner;
        if (k0 + lc < P.K) av = load(P.a, o * P.a_so + i * P.a_si + k0 + lc, P.a_bf16);
        if (n0 + lc < P.N) gv = load(P.g, o * P.g_so + i * P.g_si + n0 + lc, P.g_bf16);
      }
      As[r][lc] = round_to(av, rb);
      Gs[r][lc] = round_to(gv, rb);
      bsum += gv;
    }
    __syncthreads();
#pragma unroll 4
    for (int r = 0; r < BM; ++r) {
      const float4 a4 = *reinterpret_cast<const float4*>(&As[r][ty * 4]);
      const float4 g4 = *reinterpret_cast<const float4*>(&Gs[r][tx * 4]);
      const float av[4] = {a4.x, a4.y, a4.z, a4.w};
      const float gv[4] = {g4.x, g4.y, g4.z, g4.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], gv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int k = k0 + ty * 4 + i;
    if (k >= P.K) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n < P.N) c_out[(long long)k * P.N + n] = acc[i][j];
    }
  }
  if (do_bias) {
    bred[lr][lc] = bsum;
    __syncthreads();
    if (tid < TILE && n0 + tid < P.N) {
      float s = 0.f;
      for (int q = 0; q < NT / TILE; ++q) s += bred[q][tid];
      b_out[n0 + tid] = s;
    }
  }
}

// C (and bias) = sum over the P splits of their partials, in split order.
__global__ void wgrad_reduce_kernel(const Batch bt) {
  const long long total = bt.part_start[bt.n];
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x; e < total;
       e += (long long)gridDim.x * blockDim.x) {
    int pi = 0;
    while (pi + 1 < bt.n && e >= bt.part_start[pi + 1]) ++pi;
    const Problem& P = bt.p[pi];
    const long long local = e - bt.part_start[pi];
    const long long kn = (long long)P.K * P.N;
    const long long stride = kn + P.N;
    if (local >= kn && P.bias == nullptr) continue;
    const float* src = bt.part + bt.part_start[pi] * bt.splits + local;
    float s = 0.f;
    for (int q = 0; q < bt.splits; ++q) s += src[q * stride];
    if (local < kn) P.c[local] = s;
    else P.bias[local - kn] = s;
  }
}

}  // namespace

extern "C" {

// Floats of scratch a launch with `splits` row ranges needs (0 for one).
long long wgrad_scratch_floats(const void* probs, int n, int splits) {
  if (splits <= 1) return 0;
  long long total = 0;
  for (int i = 0; i < n; ++i) {
    const Problem& P = static_cast<const Problem*>(probs)[i];
    total += (long long)P.K * P.N + P.N;
  }
  return total * splits;
}

// probs: n problem descriptors (layout of struct Problem above); the rows
// of every problem split into `splits` ranges, whose partials go to
// `scratch` (wgrad_scratch_floats of them; unused for one split).  Writes
// every C (and bias where given).  Returns the CUDA error code.
int wgrad_launch(const void* probs, int n, int splits, void* scratch, int round_bf16,
                 void* stream) {
  if (n <= 0) return 0;
  if (n > MAX_PROBLEMS || splits < 1 || splits > 65535) return int(cudaErrorInvalidValue);
  Batch bt;
  bt.n = n;
  bt.splits = splits;
  bt.round_bf16 = round_bf16;
  bt.part = splits > 1 ? static_cast<float*>(scratch) : nullptr;
  int tiles = 0;
  long long part = 0;
  for (int i = 0; i < n; ++i) {
    bt.p[i] = static_cast<const Problem*>(probs)[i];
    bt.tile_start[i] = tiles;
    bt.part_start[i] = part;
    const Problem& P = bt.p[i];
    tiles += ((P.K + TILE - 1) / TILE) * ((P.N + TILE - 1) / TILE);
    part += (long long)P.K * P.N + P.N;
  }
  bt.tile_start[n] = tiles;
  bt.part_start[n] = part;
  if (tiles == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  wgrad_kernel<<<dim3(tiles, splits), NT, 0, s>>>(bt);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return int(err);
  const long long blocks = (part + NT - 1) / NT;
  wgrad_reduce_kernel<<<int(blocks < 4096 ? blocks : 4096), NT, 0, s>>>(bt);
  return int(cudaGetLastError());
}

}  // extern "C"
