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
// One launch reduces a whole backward (up to MAX_PROBLEMS products): the
// grid's x walks the output tiles of every problem, its y splits the rows
// into P ranges.  Blocks are issued with x fastest, so the blocks of one row
// range run together and re-read the range's rows from L2, not from device
// memory.  With P > 1 each block writes its partial tile to a scratch
// buffer and a second kernel adds the P partials in range order; rows are
// summed in one fixed order either way (no atomics), so two launches on the
// same inputs give the same bits.  Blocks of the first row of tiles (k0 = 0)
// also sum G for the bias.
//
// Bound on this card: bytes.  A launch reads ~M*(K+N) factor elements for
// 2*M*K*N operations (K, N <= 1024 here), under the bf16 tensor cores'
// ~295 operations a byte; most factors arrive in f32.
//
// Two routes, chosen by the wrapper (ops/wgrad.py route) by one rule and
// refused here outside it:
//
// * Tensor cores (wgrad_tc_launch): compute type bf16, and every factor's
//   rows start on 16-byte boundaries and are whole 16-byte vectors wide
//   (base address, both row strides and the width multiples of 16 bytes).
//   A block of 512 threads takes a 128 x 128 output tile.  Eight producer
//   warps (four for A's 128 columns, four for G's) load 64 rows a stage with
//   16-byte loads, f32 or bf16 as the factor comes (TMA cannot feed the
//   tensor cores here: the f32 factors must be rounded first, and a row
//   range of (o, i) rows is no box of a tensor map), round them to bf16
//   with __float2bfloat16's round-to-nearest (the plain .to(torch.bfloat16)),
//   write them into a ring of four stages of 128-byte-swizzled tiles, and
//   sum the unrounded G columns for the bias on the way.  Each thread keeps
//   16 loads (256 bytes) in flight a stage; the wait for a free stage comes
//   after the loads are issued.  Two consumer warpgroups run wgmma
//   m64n128k16 with f32 sums: C = A^T G reduces over the rows, so both
//   operands lie MN-major in shared memory (64 rows of 128 bytes a box, one
//   row a reduction step), A through wgmma's transpose bit for A, G through
//   the one for B, as csrc/sm90_common.cuh's kblock already reads B.  wgmma
//   rather than mma.sync with ldmatrix.trans: the producers write the same
//   layout either way, and wgmma reads it straight from the ring without a
//   register round trip.  The tensor cores idle most of a stage (64 rows
//   are 2 MFLOP against 64 KB of f32 loads): loads and L2 set the pace (a
//   tile re-reads its rows' A for each tile along N and G for each along
//   K, from L2; the teacher backward's launch moves ~600 MB that way).
//   What a stage waits for is its loads: three other designs were slower
//   on the card (PERF.md §6, tools/wgrad_variants.py): a staging ring fed
//   by one bulk copy (cp.async.bulk) a row and rounded by separate warps
//   (2.6x the time), loads of one 512-byte row a warp instruction (+11 %),
//   and 128 x 256 tiles (a quarter less L2 traffic, but the registers of
//   two m64n256 accumulators leave 128 producer threads: +40 %).
// * FMA (wgrad_launch): everything else (f32 compute type, and bf16 factors
//   that break the alignment rule).  The first design: 256 threads stage 32
//   rows of A and G (rounded, f32) in shared memory and each sums a 4 x 4
//   piece of a 64 x 64 tile on the f32 pipes, in f32 arithmetic (TF32 would
//   change the f32 sums).
//
// Limits (the Python wrapper raises outside them): at most MAX_PROBLEMS
// problems per launch; sizes below 2^31; at most 65535 row ranges.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "sm90_common.cuh"

namespace {

constexpr int MAX_PROBLEMS = 24;
constexpr int TILE = 64;      // FMA route: output tile (K and N)
constexpr int BM = 32;        // FMA route: rows staged per iteration
constexpr int NT = 256;       // FMA route: threads per block

// tensor-core route
constexpr int TC_TILE = 128;                    // output tile (K and N)
constexpr int TC_BM = 64;                       // rows a stage: four 16-deep wgmma steps
constexpr int TC_STAGES = 4;
constexpr int TC_BOX = TC_BM * 128;             // 64 columns x TC_BM rows of bf16: 8 KB
constexpr int TC_OPERAND = 2 * TC_BOX;          // 128 columns
constexpr int TC_STAGE = 2 * TC_OPERAND;        // A then G: 32 KB
constexpr int TC_CONSUMERS = 256;               // two warpgroups: k rows [0, 64), [64, 128)
constexpr int TC_PRODUCERS = 256;               // warps 0-3 load A, 4-7 load G
constexpr int TC_THREADS = TC_CONSUMERS + TC_PRODUCERS;
constexpr int TC_ROWS_A_THREAD = TC_BM / 8;     // rows a producer thread loads a stage
constexpr size_t TC_SMEM = 1024 + size_t(TC_STAGES) * TC_STAGE + 8 * TC_TILE * sizeof(float) +
                           2 * TC_STAGES * sizeof(uint64_t);

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

// The block's work: problem, output tile, row range and where its sums go
// (the outputs, or its range's partials [K, N] then [N] in the scratch).
struct Item {
  int pi, k0, n0;
  long long m_first, m_end;
  float* c_out;
  float* b_out;
  bool do_bias;
};

__device__ __forceinline__ Item item_of(const Batch& bt, int tile_edge, int bm) {
  Item it;
  int pi = 0;
  while (pi + 1 < bt.n && int(blockIdx.x) >= bt.tile_start[pi + 1]) ++pi;
  const Problem& P = bt.p[pi];
  const int tile = blockIdx.x - bt.tile_start[pi];
  const int tiles_n = (P.N + tile_edge - 1) / tile_edge;
  it.pi = pi;
  it.k0 = (tile / tiles_n) * tile_edge;
  it.n0 = (tile % tiles_n) * tile_edge;
  const long long M_all = (long long)P.m_outer * P.m_inner;
  const long long per = ((M_all + bt.splits - 1) / bt.splits + bm - 1) / bm * bm;
  it.m_first = per * blockIdx.y;
  it.m_end = M_all < it.m_first + per ? M_all : it.m_first + per;
  it.do_bias = P.bias != nullptr && it.k0 == 0;
  it.c_out = P.c;
  it.b_out = P.bias;
  if (bt.part != nullptr) {
    float* base = bt.part + bt.part_start[pi] * bt.splits +
                  (long long)blockIdx.y * ((long long)P.K * P.N + P.N);
    it.c_out = base;
    it.b_out = base + (long long)P.K * P.N;
  }
  return it;
}

// ------------------------------------------------------------ FMA route

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

  const Item it = item_of(bt, TILE, BM);
  const Problem& P = bt.p[it.pi];
  const int k0 = it.k0, n0 = it.n0;
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;        // 4x4 outputs each
  const int lc = tid % TILE, lr = tid / TILE;     // loader column, first row
  const long long M = it.m_end;
  const int rb = bt.round_bf16;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  float bsum = 0.f;

  for (long long m0 = it.m_first; m0 < M; m0 += BM) {
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
      if (n < P.N) it.c_out[(long long)k * P.N + n] = acc[i][j];
    }
  }
  if (it.do_bias) {
    bred[lr][lc] = bsum;
    __syncthreads();
    if (tid < TILE && n0 + tid < P.N) {
      float s = 0.f;
      for (int q = 0; q < NT / TILE; ++q) s += bred[q][tid];
      it.b_out[n0 + tid] = s;
    }
  }
}

// ---------------------------------------------------- tensor-core route

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

__device__ __forceinline__ float2 unpack_bf16(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}

// One producer thread's share of a stage: rows rsub + 8 j (j < 8) of the
// stage, columns [col, col + 8) of one factor (width W, f32 or bf16), as 8
// bf16 in one 16-byte chunk of the row's 128-byte swizzled line (dst: the
// thread's chunk in row rsub of the factor's box).  Rows past m_end and
// columns past W arrive as zeros.  The loads go first, then the wait for
// the stage to be free; bsum (the bias columns) adds the unrounded values.
template <bool F32>
__device__ __forceinline__ void produce(const void* base, long long so, long long si, int mi,
                                        int W, int col, long long m0, long long m_end,
                                        unsigned char* dst, uint64_t* empty, int wait_parity,
                                        bool sum, float (&bsum)[8]) {
  constexpr int V = F32 ? 2 : 1;     // 16-byte loads a chunk
  uint4 v[TC_ROWS_A_THREAD][V];
#pragma unroll
  for (int j = 0; j < TC_ROWS_A_THREAD; ++j) {
    const long long m = m0 + 8 * j;
    const int o = int(m) / mi, i = int(m) - o * mi;     // rows < 2^31 (the wrapper's limit)
    const long long off = o * so + i * si + col;
#pragma unroll
    for (int h = 0; h < V; ++h) {
      v[j][h] = make_uint4(0u, 0u, 0u, 0u);
      if (m < m_end && col + 4 * h < W) {
        const uint4* p = F32 ? reinterpret_cast<const uint4*>(static_cast<const float*>(base) + off + 4 * h)
                             : reinterpret_cast<const uint4*>(static_cast<const __nv_bfloat16*>(base) + off);
        v[j][h] = __ldg(p);
      }
    }
  }
  if (wait_parity >= 0) sm90::mbar_wait(empty, uint32_t(wait_parity));
#pragma unroll
  for (int j = 0; j < TC_ROWS_A_THREAD; ++j) {
    float x[8];
    uint4 out;
    if (F32) {
      const float* f = reinterpret_cast<const float*>(&v[j][0]);
#pragma unroll
      for (int q = 0; q < 8; ++q) x[q] = f[q];
      out = make_uint4(pack_bf16(x[0], x[1]), pack_bf16(x[2], x[3]), pack_bf16(x[4], x[5]),
                       pack_bf16(x[6], x[7]));
    } else {
      out = v[j][0];
      const uint32_t w[4] = {out.x, out.y, out.z, out.w};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float2 f = unpack_bf16(w[q]);
        x[2 * q] = f.x;
        x[2 * q + 1] = f.y;
      }
    }
    if (sum) {
#pragma unroll
      for (int q = 0; q < 8; ++q) bsum[q] += x[q];
    }
    *reinterpret_cast<uint4*>(dst + j * 8 * 128) = out;
  }
}

__global__ void __launch_bounds__(TC_THREADS, 1) wgrad_tc_kernel(const Batch bt) {
  extern __shared__ unsigned char smem_raw[];
  // swizzled tiles need 1024-byte alignment
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* ring = smem;
  float* bred = reinterpret_cast<float*>(ring + TC_STAGES * TC_STAGE);   // [8][TC_TILE]
  uint64_t* full = reinterpret_cast<uint64_t*>(bred + 8 * TC_TILE);
  uint64_t* empty = full + TC_STAGES;

  const Item it = item_of(bt, TC_TILE, TC_BM);
  const Problem& P = bt.p[it.pi];
  const int n_stages = int((it.m_end - it.m_first + TC_BM - 1) / TC_BM);
  if (threadIdx.x == 0) {
    for (int s = 0; s < TC_STAGES; ++s) {
      sm90::mbar_init(&full[s], TC_PRODUCERS);
      sm90::mbar_init(&empty[s], TC_CONSUMERS / 128);
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= TC_CONSUMERS) {
    // producers: warp pw loads factor pw / 4; lane l the 8 columns
    // 8 (l % 16) of the tile in rows rsub + 8 j of each stage
    const int pt = threadIdx.x - TC_CONSUMERS, pw = pt / 32, lane = pt % 32;
    const bool is_g = pw >= 4;
    const int rsub = (pw % 4) * 2 + lane / 16, chunk = lane % 16;
    const int col = (is_g ? it.n0 : it.k0) + chunk * 8;
    const int W = is_g ? P.N : P.K;
    const void* base = is_g ? P.g : P.a;
    const long long so = is_g ? P.g_so : P.a_so, si = is_g ? P.g_si : P.a_si;
    const bool f32 = !(is_g ? P.g_bf16 : P.a_bf16);
    const bool sum = is_g && it.do_bias;
    // the thread's chunk in row rsub: box chunk / 8, 16-byte slot (chunk % 8) ^ rsub
    const int off = (is_g ? TC_OPERAND : 0) + (chunk / 8) * TC_BOX + rsub * 128 +
                    (((chunk % 8) ^ rsub) << 4);
    float bsum[8];
#pragma unroll
    for (int q = 0; q < 8; ++q) bsum[q] = 0.f;
    for (int g = 0; g < n_stages; ++g) {
      const int st = g % TC_STAGES;
      const int parity = g >= TC_STAGES ? (g / TC_STAGES - 1) & 1 : -1;
      const long long m0 = it.m_first + (long long)g * TC_BM + rsub;
      unsigned char* dst = ring + st * TC_STAGE + off;
      if (f32)
        produce<true>(base, so, si, P.m_inner, W, col, m0, it.m_end, dst, &empty[st], parity,
                      sum, bsum);
      else
        produce<false>(base, so, si, P.m_inner, W, col, m0, it.m_end, dst, &empty[st], parity,
                       sum, bsum);
      sm90::fence_proxy_async();
      sm90::mbar_arrive(&full[st]);
    }
    if (it.do_bias && is_g) {
      // the eight row classes' sums of each column, added in class order
      const int gt = pt - 128;
#pragma unroll
      for (int q = 0; q < 8; ++q) bred[rsub * TC_TILE + chunk * 8 + q] = bsum[q];
      asm volatile("bar.sync 1, 128;\n" ::: "memory");
      if (it.n0 + gt < P.N) {
        float s = 0.f;
#pragma unroll
        for (int r = 0; r < 8; ++r) s += bred[r * TC_TILE + gt];
        it.b_out[it.n0 + gt] = s;
      }
    }
    return;
  }

  // consumers: warpgroup wg sums the tile's k rows [64 wg, 64 wg + 64)
  const int tid = threadIdx.x, wg = tid / 128, t = tid % 128;
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  for (int g = 0; g < n_stages; ++g) {
    const int st = g % TC_STAGES;
    const unsigned char* stage = ring + st * TC_STAGE;
    sm90::mbar_wait(&full[st], (g / TC_STAGES) & 1);
    sm90::fence_operands(acc);
    sm90::wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < TC_BM / 16; ++ks) {
      // 16 rows a step: 2 KB on within a box; 8-row groups 1024 bytes apart.
      // A: the warpgroup's 64-column box (M = 64, one swizzle width);
      // G: both boxes, TC_BOX apart
      const uint64_t da = sm90::smem_desc(stage + wg * TC_BOX + ks * 16 * 128, TC_BOX, 1024,
                                          sm90::kSwizzle128B);
      const uint64_t db = sm90::smem_desc(stage + TC_OPERAND + ks * 16 * 128, TC_BOX, 1024,
                                          sm90::kSwizzle128B);
      sm90::wgmma_m64n128k16<1>(acc, da, db);
    }
    sm90::wgmma_commit();
    sm90::wgmma_wait<1>();
    sm90::fence_operands(acc);
    // the stage before is read: the producers may refill it
    if (g > 0 && t == 0) sm90::mbar_arrive(&empty[(g - 1) % TC_STAGES]);
  }
  sm90::wgmma_wait<0>();
  sm90::fence_operands(acc);
  // thread t holds D[16 (t/32) + (t%32)/4 + 8 ((i/2)%2), 8 (i/4) + 2 (t%4) + i%2]
  const int warp = t / 32, lane = t % 32;
#pragma unroll
  for (int i = 0; i < 64; i += 2) {
    const int k = it.k0 + 64 * wg + 16 * warp + lane / 4 + 8 * ((i / 2) % 2);
    const int n = it.n0 + 8 * (i / 4) + 2 * (lane % 4);
    if (k < P.K && n < P.N)
      *reinterpret_cast<float2*>(it.c_out + (long long)k * P.N + n) =
          make_float2(acc[i], acc[i + 1]);
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

// The launch's batch; returns its number of tiles (edge ``tile``).
int fill(Batch& bt, const void* probs, int n, int splits, void* scratch, int round_bf16,
         int tile) {
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
    tiles += ((P.K + tile - 1) / tile) * ((P.N + tile - 1) / tile);
    part += (long long)P.K * P.N + P.N;
  }
  bt.tile_start[n] = tiles;
  bt.part_start[n] = part;
  return tiles;
}

int reduce(const Batch& bt, cudaStream_t s) {
  const long long blocks = (bt.part_start[bt.n] + NT - 1) / NT;
  wgrad_reduce_kernel<<<int(blocks < 4096 ? blocks : 4096), NT, 0, s>>>(bt);
  return int(cudaGetLastError());
}

// The tensor-core route's rule for one factor: rows on 16-byte boundaries,
// whole 16-byte vectors wide.
bool tc_aligned(const void* p, long long so, long long si, int width, int is_bf16) {
  const long long es = is_bf16 ? 2 : 4;
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && (so * es) % 16 == 0 &&
         (si * es) % 16 == 0 && (width * es) % 16 == 0;
}

}  // namespace

extern "C" {

// FMA route.  probs: n problem descriptors (layout of struct Problem
// above); the rows of every problem split into `splits` ranges, whose
// partials go to `scratch` (splits * sum(K*N + N) floats, [K, N] then [N]
// a problem and range; unused for one split).  Writes every C (and bias
// where given).  Returns the CUDA error code.
int wgrad_launch(const void* probs, int n, int splits, void* scratch, int round_bf16,
                 void* stream) {
  if (n <= 0) return 0;
  if (n > MAX_PROBLEMS || splits < 1 || splits > 65535) return int(cudaErrorInvalidValue);
  Batch bt;
  const int tiles = fill(bt, probs, n, splits, scratch, round_bf16, TILE);
  if (tiles == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  wgrad_kernel<<<dim3(tiles, splits), NT, 0, s>>>(bt);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return int(err);
  return reduce(bt, s);
}

// Tensor-core route (bf16 rounding): the same arguments; refuses
// (cudaErrorInvalidValue) a factor outside the route's alignment rule.
int wgrad_tc_launch(const void* probs, int n, int splits, void* scratch, void* stream) {
  if (n <= 0) return 0;
  if (n > MAX_PROBLEMS || splits < 1 || splits > 65535) return int(cudaErrorInvalidValue);
  for (int i = 0; i < n; ++i) {
    const Problem& P = static_cast<const Problem*>(probs)[i];
    if (!tc_aligned(P.a, P.a_so, P.a_si, P.K, P.a_bf16) ||
        !tc_aligned(P.g, P.g_so, P.g_si, P.N, P.g_bf16))
      return int(cudaErrorInvalidValue);
  }
  Batch bt;
  const int tiles = fill(bt, probs, n, splits, scratch, 1, TC_TILE);
  if (tiles == 0) return 0;
  // the opt-in belongs to the current device's context: set it every call
  const cudaError_t e = cudaFuncSetAttribute(
      wgrad_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(TC_SMEM));
  if (e != cudaSuccess) return int(e);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  wgrad_tc_kernel<<<dim3(tiles, splits), TC_THREADS, TC_SMEM, s>>>(bt);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return int(err);
  return reduce(bt, s);
}

// The tensor-core kernel's shared memory (bytes) and blocks an SM.
long long wgrad_tc_smem_bytes() { return (long long)TC_SMEM; }

int wgrad_tc_blocks_per_sm() {
  int blocks = 0;
  if (cudaFuncSetAttribute(wgrad_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           int(TC_SMEM)) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, wgrad_tc_kernel, TC_THREADS,
                                                    TC_SMEM) != cudaSuccess)
    return -1;
  return blocks;
}

}  // extern "C"
