// Fast Griffin-Lim iterations for Hopper (sm_90a).
//
// Replaces tacotron_multispeaker_tpu/ops/gl_iteration.py
// gl_fast_iterations_pallas.  Per iteration, over all G = B*F frames at once
// (frames wf [G, n_fft] in the compute type T, bf16 or f32):
//   1. forward product: (re, im) of every bin = wf @ fwd (f32 sums); its
//      epilogue does the momentum extrapolation a = (re, im) - mom * (pre,
//      pim), the magnitude projection s = a * mag / max(|a|, 1e-8) and
//      (pre, pim) = (re, im), keeping the state in f32 and writing s rounded
//      to T into st;
//   2. inverse product: fr = st @ inv, fr in f32;
//   3. gl_ola_kernel: the overlap-add and re-framing as one banded operator,
//      wf[g, i] = round_T(N[g, i] * sum_d S[d, i] * fr[g - d, i + d*hop]),
//      d increasing, f32 sums (N = win / norm, S[d, i] = win[i + d*hop]).
// The last iteration stops after step 1 and writes (sre, sim, pre, pim);
// the others keep (pre, pim) interleaved in an f32 state buffer and write
// only st.  One host call launches all 3*n_iters - 2 kernels on the stream.
//
// Layouts (ops/gl_iteration.py _kernel_matrices builds the operands):
//   fwd [n_fft, ncol]: column 2j the cosine of bin j, 2j+1 its sine (ncol =
//     2 * bins rounded up to 128), so an accumulator fragment holds re and
//     im of one (frame, bin) in adjacent registers;
//   st [G, KI]: (re, im) of bin j at 2j, 2j+1 (KI = 2 * bins rounded up to
//     8, pad columns zeroed by the caller); inv [KI, n_fft]: rows 2j, 2j+1
//     are iC[j], iS[j] (zero rows at the pads), so the inverse sums re and
//     im terms of each bin in turn;
//   state [G, bins] float2 (pre, pim).
//
// The window's support [lo, hi) (ops/gl_iteration.py window_support: the
// hull of its nonzero samples, rounded out to the 64-sample k-block) bounds
// the work from the second iteration on.  Outside it N = 0, so the frames
// the OLA makes are 0 there; S[d, i] = win[i + d*hop] = 0 for source
// columns outside it.  So iterations 2.. run the forward product over k in
// [lo, hi), the inverse product only for fr columns [lo, hi), and the OLA
// only for outputs in [lo, hi) summing only sources in [lo, hi): every
// dropped term is a product with an exact zero, and the kept terms keep
// their order.  Iteration 1 reads the whole frame: wf0 is the caller's.
// At the serving window (hann 1102 in 2048) the support is [448, 1600),
// 56 % of the frame.
//
// Design for this card: the TPU kernel keeps one batch row's [F, n_fft]
// frames and all four DFT matrices in VMEM for every iteration.  Here a
// row's frames alone are 4 MB in bf16 (F=1000, n_fft=2048) against 227 KB
// of shared memory, so the iteration is split at its two products and the
// frames, spectra and fr go through device memory (and the 50 MB L2)
// between the three kernels.
// * bf16 (the serving precision): both products on wgmma (sm90_common.cuh).
//   A block computes a (64 NWG) x 128 tile, NWG consumer warpgroups of 64
//   rows (m64n128k16, f32 accumulators in registers), from a ring of 64-deep
//   k-blocks in dynamic shared memory that one producer thread fills with
//   TMA loads: A (frames or st) K-major with 128-byte swizzle, B (fwd or
//   inv) N-major as two 64-column boxes read with wgmma's transpose bit.
//   Zero fill of the tensor maps covers the ragged G and K.  The forward
//   product takes 256 rows (NWG = 4, 4 stages of 48 KB, one block an SM),
//   the inverse 128 (NWG = 2, 3 stages of 32 KB, two blocks an SM).  Blocks
//   walk the column tiles of one row tile in turn, so A comes from device
//   memory once and the B matrix (4.7-8.9 MB) stays in L2.
//   Both epilogues stage the f32 tile in the ring (free after the last
//   product).  The forward one then projects with consecutive threads on
//   consecutive bins of a frame: the state (one 8-byte access a pair),
//   magnitude and st (one 4-byte store a pair) accesses are coalesced, and
//   each thread issues 16 pairs' reads before it uses any.  The inverse one
//   stores whole 16-byte pieces of fr rows.  bins = 1025 gives 17 forward
//   column tiles; the 17th carries one bin (a full-width tile: 6 % of the
//   forward products, kept for one code path).
//   Measured on an H100 (12 launches of the forward, 11 of the inverse, at
//   B=32): projecting straight from the accumulator registers (each thread
//   holds re and im of 2 frames x 16 bins) left 8 rows x 32 bytes a warp
//   access and, at the 96-register limit of two blocks an SM, 4 pairs in
//   flight: 9.8 against 7.0 ms.  The 256-row forward tile loads 25 % fewer
//   operand bytes a product than the 128-row one: 6.4 against 6.9 ms.  A
//   256-row inverse took 3.3 against 3.7 ms at B=32 but 0.38 against 0.28
//   ms at B=1, whose 128-row tiles already leave most SMs idle.
// * f32 (the check path): the same three steps and layouts on the FMA tile
//   of mma_common.cuh (64 x 64, CUDA cores) with the same support ranges.
// The banded pass reads fr from L2 (15 shifts at n_fft 2048, hop 275, at
// most 5 of them inside the serving window's support for an output).  A
// thread sums one output column for 8 frames and reads each coefficient
// S[d, i] once for them (11 launches at B=32: 2.1 ms, against 5.6 ms with
// one output a thread).
//
// Bound on this card, per launch at B=32, F=1000, n_fft 2048 (bins 1025,
// support 1152 samples, 989 TFLOP/s bf16, 3.35 TB/s): a forward product
// over the support, 4*G*1152*bins = 151 GFLOP, 0.153 ms (0.272 ms over the
// whole frame), against its epilogue's 0.79 GB of state, magnitude and st
// traffic, 0.235 ms: the forward launch is bound by its bytes; an inverse,
// 151 GFLOP, 0.153 ms (its fr, 0.15 GB, 0.044 ms); the OLA moves fr once
// and the frames, ~0.22 GB, 0.066 ms.
//
// Limits (the Python wrapper raises outside them): n_fft a multiple of 8,
// G*n_fft and G*KI below 2^31, 16-byte aligned operands; the bf16 path's
// grid (row tiles x column tiles) below 2^31 blocks.

#include "common.cuh"
#include "mma_common.cuh"
#include "sm90_common.cuh"

namespace {

// ------------------------------------------------------------------ shared

// where the forward epilogue reads and writes
struct Proj {
  const float* mag;       // [G, bins]
  float2* state;          // [G, bins] (pre, pim) between iterations
  float *sre, *sim, *pre, *pim;   // [G, bins] each, written by the last iteration
  void* st;               // [G, KI] compute type
  int G, bins, KI;
  float mom;
  int first, last;        // iteration 1 (state 0) / the last (writes the outputs)
};

template <typename T> __device__ __forceinline__ void store_pair(T* p, float a, float b);
template <> __device__ __forceinline__ void store_pair<float>(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
template <> __device__ __forceinline__ void store_pair<__nv_bfloat16>(__nv_bfloat16* p, float a,
                                                                      float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// The projection of N (frame, bin) pairs of the forward product: pos(u)
// gives pair u's (frame, bin), val(u) its (re, im).  The state and
// magnitude reads of all N are issued before any is used: one pair at a
// time, the epilogue would wait on device memory N times.  pos is called
// again for the stores rather than keeping N indices live.
template <typename T, int N, class Pos, class Val>
__device__ __forceinline__ void project(const Proj& o, Pos pos, Val val) {
  float2 p[N];
  float mg[N];
#pragma unroll
  for (int u = 0; u < N; ++u) {
    const int2 rb = pos(u);
    const bool ok = rb.x < o.G && rb.y < o.bins;
    const size_t i = (size_t)rb.x * o.bins + rb.y;
    p[u] = ok && !o.first ? o.state[i] : make_float2(0.f, 0.f);
    mg[u] = ok ? o.mag[i] : 0.f;
  }
#pragma unroll
  for (int u = 0; u < N; ++u) {
    const int2 rb = pos(u);
    if (rb.x >= o.G || rb.y >= o.bins) continue;
    const size_t i = (size_t)rb.x * o.bins + rb.y;
    const float2 v = val(u);
    const float are = v.x - o.mom * p[u].x;
    const float aim = v.y - o.mom * p[u].y;
    const float scale = mg[u] / fmaxf(sqrtf(are * are + aim * aim), 1e-8f);
    const float xr = are * scale, xi = aim * scale;
    if (o.last) {
      o.sre[i] = xr;
      o.sim[i] = xi;
      o.pre[i] = v.x;
      o.pim[i] = v.y;
    } else {
      o.state[i] = v;
      store_pair(static_cast<T*>(o.st) + (size_t)rb.x * o.KI + 2 * rb.y, xr, xi);
    }
  }
}

// One thread: output column i in [lo, hi) of OLA_FG consecutive frames of
// one batch row.  The coefficients S[d, i] are read once for the group; for
// each d (increasing) every frame's sum takes its term, so each output sums
// in the order of increasing d.
constexpr int OLA_FG = 8;

template <typename T>
__global__ void __launch_bounds__(256)
gl_ola_kernel(const float* __restrict__ fr, const float* __restrict__ nrm,
              const float* __restrict__ shift, T* __restrict__ wf, int B, int F, int n_fft,
              int hop, int m, int lo, int hi) {
  const int W = hi - lo, n_groups = (F + OLA_FG - 1) / OLA_FG;
  const long long idx = (long long)blockIdx.x * 256 + threadIdx.x;
  if (idx >= (long long)B * n_groups * W) return;
  const int i = lo + (int)(idx % W);
  const long long bq = idx / W;
  const int g0 = (int)(bq % n_groups) * OLA_FG;
  const long long row0 = bq / n_groups * F;       // the batch row's first frame
  float acc[OLA_FG];
#pragma unroll
  for (int u = 0; u < OLA_FG; ++u) acc[u] = 0.f;
  for (int d = -(m - 1); d <= m - 1; ++d) {
    // the source column i + d*hop in [lo, hi) and frame g - d in [0, F):
    // the other terms are products with S[d, i] = win[i + d*hop] = 0
    const int is = i + d * hop;
    if (is < lo || is >= hi) continue;
    const float sd = shift[(size_t)(d + m - 1) * n_fft + i];
#pragma unroll
    for (int u = 0; u < OLA_FG; ++u) {
      const int gs = g0 + u - d;
      if (gs >= 0 && gs < F) acc[u] += fr[(size_t)(row0 + gs) * n_fft + is] * sd;
    }
  }
#pragma unroll
  for (int u = 0; u < OLA_FG; ++u) {
    const int g = g0 + u;
    if (g < F)
      wf[(size_t)(row0 + g) * n_fft + i] = kern::from_f<T>(acc[u] * nrm[(size_t)g * n_fft + i]);
  }
}

// ---------------------------------------------------------------- f32 path

using FTile = kern::TileF32;

// forward product over k in [k_lo, k_hi); a 64-column tile is 32 bins
__global__ void __launch_bounds__(FTile::NT)
gl_fwd_f32_kernel(const float* __restrict__ wf, const float* __restrict__ cf, const Proj o,
                  int n_fft, int ncol, int k_lo, int k_hi) {
  __shared__ FTile::Smem s;
  const int row0 = blockIdx.x * FTile::BM, c0 = blockIdx.y * FTile::BN;
  auto pa = [&](int r, int k) -> const float* {
    const int row = row0 + r;
    return row < o.G ? wf + (size_t)row * n_fft + k_lo + k : nullptr;
  };
  auto pb = [&](int k, int c) -> const float* { return cf + (size_t)(k_lo + k) * ncol + c0 + c; };
  FTile::run(s, k_hi - k_lo, pa, pb);
  const float* C = FTile::out(s);
  constexpr int HB = FTile::BN / 2, EPI = 8, PER = FTile::BM * HB / FTile::NT;
  static_assert(PER % EPI == 0, "epilogue batches");
  for (int e0 = 0; e0 < PER; e0 += EPI) {
    const int i0 = threadIdx.x + e0 * FTile::NT;
    auto pos = [&](int u) {
      const int i = i0 + u * FTile::NT;
      return make_int2(row0 + i / HB, blockIdx.y * HB + i % HB);
    };
    auto val = [&](int u) {
      const int i = i0 + u * FTile::NT, r = i / HB, j = i % HB;
      return make_float2(C[r * FTile::LDC + 2 * j], C[r * FTile::LDC + 2 * j + 1]);
    };
    project<float, EPI>(o, pos, val);
  }
}

// inverse product, fr columns [lo, hi)
__global__ void __launch_bounds__(FTile::NT)
gl_inv_f32_kernel(const float* __restrict__ st, const float* __restrict__ ci,
                  float* __restrict__ fr, int G, int n_fft, int KI, int lo, int hi) {
  __shared__ FTile::Smem s;
  const int row0 = blockIdx.x * FTile::BM, c0 = lo + blockIdx.y * FTile::BN;
  auto pa = [&](int r, int k) -> const float* {
    const int row = row0 + r;
    return row < G ? st + (size_t)row * KI + k : nullptr;
  };
  auto pb = [&](int k, int c) -> const float* {
    const int col = c0 + c;
    return col < hi ? ci + (size_t)k * n_fft + col : nullptr;
  };
  FTile::run(s, KI, pa, pb);
  const float* C = FTile::out(s);
  for (int i = threadIdx.x; i < FTile::BM * FTile::BN; i += FTile::NT) {
    const int r = i / FTile::BN, c = i % FTile::BN;
    const int row = row0 + r, col = c0 + c;
    if (row < G && col < hi) fr[(size_t)row * n_fft + col] = C[r * FTile::LDC + c];
  }
}

// --------------------------------------------------------------- bf16 path

constexpr int BN = 128, BK = 64;
constexpr int B_BYTES = BK * BN * 2;
constexpr int LDS = BN + 8;                      // a staged f32 tile row (floats)
constexpr int SMEM_FIXED = 1024 + 16 * 8;        // alignment slack, barriers

// The ring of a tile of BM = 64 * NWG rows (NWG consumer warpgroups and one
// producer warp): as many 64-deep stages as fit in the shared memory of two
// blocks an SM (NWG = 2) or one (NWG = 4), and at least the staged tile.
template <int NWG>
struct Ring {
  static constexpr int BM = 64 * NWG, NTHREADS = NWG * 128 + 32;
  static constexpr int A_BYTES = BM * BK * 2, STAGE_BYTES = A_BYTES + B_BYTES;
  static constexpr int STAGES = ((NWG == 2 ? 115712 : 232448) - SMEM_FIXED) / STAGE_BYTES;
  static constexpr int SMEM_BYTES = 1024 + STAGES * STAGE_BYTES + 2 * STAGES * 8;
  static_assert(STAGES >= 2 && STAGES * STAGE_BYTES >= BM * LDS * 4, "ring");
};

// The k-blocks of one BM x BN tile through the TMA ring: A rows [arow, arow
// + BM) at k = ak0 + 64 kb, B columns [bcol, bcol + BN) at k = bk0 + 64 kb,
// kb < nkb; the last k-block runs its first last_ks 16-deep steps (the rest
// is zero fill).  The producer warp returns false; each consumer warpgroup
// returns true with its 64 rows' sums in acc.
template <int NWG>
__device__ __forceinline__ bool tile_product(unsigned char* smem, const CUtensorMap* amap,
                                             const CUtensorMap* bmap, int arow, int ak0,
                                             int bcol, int bk0, int nkb, int last_ks,
                                             float (&acc)[64]) {
  using R = Ring<NWG>;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + R::STAGES * R::STAGE_BYTES);
  uint64_t* empty = full + R::STAGES;
  if (threadIdx.x == 0) {
    for (int s = 0; s < R::STAGES; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], NWG);
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();
  if (threadIdx.x >= NWG * 128) {
    if (threadIdx.x == NWG * 128) {
      for (int kb = 0; kb < nkb; ++kb) {
        const int s = kb % R::STAGES;
        if (kb >= R::STAGES) sm90::mbar_wait(&empty[s], (kb / R::STAGES - 1) & 1);
        sm90::mbar_expect_tx(&full[s], R::STAGE_BYTES);
        unsigned char* a = smem + s * R::STAGE_BYTES;
        sm90::tma_load_3d(a, amap, &full[s], ak0 + kb * BK, arow, 0);
        for (int c = 0; c < BN / 64; ++c)
          sm90::tma_load_3d(a + R::A_BYTES + c * BK * 128, bmap, &full[s], bcol + 64 * c,
                            bk0 + kb * BK, 0);
      }
    }
    return false;
  }
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  constexpr uint32_t b_lbo = BK * 128;   // the second 64-column box
  for (int kb = 0; kb < nkb; ++kb) {
    const int s = kb % R::STAGES;
    sm90::mbar_wait(&full[s], (kb / R::STAGES) & 1);
    const unsigned char* a = smem + s * R::STAGE_BYTES + wg * 64 * BK * 2;
    const unsigned char* bt = smem + s * R::STAGE_BYTES + R::A_BYTES;
    sm90::fence_operands(acc);
    sm90::wgmma_fence();
    switch (kb + 1 < nkb ? 4 : last_ks) {
      case 1: sm90::kblock<1, BK, R::BM>(acc, a, bt, b_lbo); break;
      case 2: sm90::kblock<2, BK, R::BM>(acc, a, bt, b_lbo); break;
      case 3: sm90::kblock<3, BK, R::BM>(acc, a, bt, b_lbo); break;
      default: sm90::kblock<4, BK, R::BM>(acc, a, bt, b_lbo); break;
    }
    sm90::wgmma_commit();
    sm90::wgmma_wait<1>();
    sm90::fence_operands(acc);
    // the products of k-block kb - 1 are done: its stage may be refilled
    if (kb > 0 && tid == 0) sm90::mbar_arrive(&empty[(kb - 1) % R::STAGES]);
  }
  sm90::wgmma_wait<0>();
  sm90::fence_operands(acc);
  return true;
}

// a consumer warpgroup's 64 x 128 f32 sums into the staged tile (rows of
// LDS floats; 8-byte stores, two wavefronts a warp)
__device__ __forceinline__ void stage_tile(float* stg, const float (&acc)[64]) {
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  const int r0 = (threadIdx.x / 128) * 64 + warp * 16 + lane / 4;
#pragma unroll
  for (int i = 0; i < 64; i += 2) {
    const int r = r0 + 8 * ((i / 2) % 2), c = 8 * (i / 4) + 2 * (lane % 4);
    *reinterpret_cast<float2*>(stg + r * LDS + c) = make_float2(acc[i], acc[i + 1]);
  }
}

__device__ __forceinline__ unsigned char* aligned_smem() {
  extern __shared__ unsigned char smem_raw[];
  // swizzled TMA tiles need 1024-byte aligned stages
  return reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
}

// forward product over k in [k_lo, k_lo + 64 nkb); tiles numbered column
// tile fastest (n_ct = ncol / 128 of them, 64 bins each)
template <int NWG>
__global__ void __launch_bounds__(Ring<NWG>::NTHREADS, NWG == 2 ? 2 : 1)
gl_fwd_bf16_kernel(const __grid_constant__ CUtensorMap wmap,
                   const __grid_constant__ CUtensorMap fmap, const Proj o, int n_ct, int k_lo,
                   int nkb, int last_ks) {
  constexpr int BM = Ring<NWG>::BM;
  unsigned char* smem = aligned_smem();
  const int n_tile = (int)(blockIdx.x % n_ct), row0 = (int)(blockIdx.x / n_ct) * BM;
  float acc[64];
  if (!tile_product<NWG>(smem, &wmap, &fmap, row0, k_lo, n_tile * BN, k_lo, nkb, last_ks, acc))
    return;
  // (re, im) through the ring (free once every consumer is past its last
  // product), then the projection with consecutive threads on consecutive
  // bins of a frame: coalesced state, magnitude and st accesses, and 8
  // pairs' reads in flight a thread
  asm volatile("bar.sync 1, %0;\n" ::"n"(NWG * 128) : "memory");
  float* stg = reinterpret_cast<float*>(smem);
  stage_tile(stg, acc);
  asm volatile("bar.sync 1, %0;\n" ::"n"(NWG * 128) : "memory");
  constexpr int HB = BN / 2, EPI = 16, PER = BM * HB / (NWG * 128);
#pragma unroll 1
  for (int e0 = 0; e0 < PER; e0 += EPI) {
    const int i0 = threadIdx.x + e0 * (NWG * 128);
    auto pos = [&](int u) {
      const int i = i0 + u * (NWG * 128);
      return make_int2(row0 + i / HB, n_tile * HB + i % HB);
    };
    auto val = [&](int u) {
      const int i = i0 + u * (NWG * 128);
      return *reinterpret_cast<const float2*>(stg + (i / HB) * LDS + 2 * (i % HB));
    };
    project<__nv_bfloat16, EPI>(o, pos, val);
  }
}

// inverse product, fr columns [lo, lo + 128 n_ct) clipped at hi
template <int NWG>
__global__ void __launch_bounds__(Ring<NWG>::NTHREADS, NWG == 2 ? 2 : 1)
gl_inv_bf16_kernel(const __grid_constant__ CUtensorMap smap,
                   const __grid_constant__ CUtensorMap imap, float* __restrict__ fr, int G,
                   int n_fft, int lo, int hi, int n_ct, int nkb, int last_ks) {
  constexpr int BM = Ring<NWG>::BM;
  unsigned char* smem = aligned_smem();
  const int n_tile = (int)(blockIdx.x % n_ct), row0 = (int)(blockIdx.x / n_ct) * BM;
  const int col0 = lo + n_tile * BN;
  float acc[64];
  if (!tile_product<NWG>(smem, &smap, &imap, row0, 0, col0, 0, nkb, last_ks, acc)) return;
  // every consumer is past its last product before the ring is reused
  asm volatile("bar.sync 1, %0;\n" ::"n"(NWG * 128) : "memory");
  float* stg = reinterpret_cast<float*>(smem);
  stage_tile(stg, acc);
  asm volatile("bar.sync 1, %0;\n" ::"n"(NWG * 128) : "memory");
  for (int i = threadIdx.x; i < BM * (BN / 4); i += NWG * 128) {
    const int r = i / (BN / 4), c = (i % (BN / 4)) * 4;
    const int row = row0 + r, col = col0 + c;
    if (row < G && col < hi)
      *reinterpret_cast<float4*>(fr + (size_t)row * n_fft + col) =
          *reinterpret_cast<const float4*>(stg + r * LDS + c);
  }
}

// the k-blocks of a depth and the 16-deep steps of the last one
void k_blocks(int depth, int& nkb, int& last_ks) {
  nkb = (depth + BK - 1) / BK;
  last_ks = (depth - (nkb - 1) * BK + 15) / 16;
}

// --------------------------------------------------------------- launchers

struct Buffers {
  void *wf, *fr, *st, *state, *sre, *sim, *pre, *pim;
  const void *mag, *fwd, *inv, *nrm, *shift;
};

struct Geo {
  int B, F, n_fft, hop, lo, hi, G, bins, KI, ncol, m;
};

Geo geometry(int B, int F, int n_fft, int hop, int lo, int hi) {
  Geo g{B, F, n_fft, hop, lo, hi, B * F, n_fft / 2 + 1, 0, 0, (n_fft + hop - 1) / hop};
  g.KI = (2 * g.bins + 7) / 8 * 8;
  g.ncol = (g.bins + BN / 2 - 1) / (BN / 2) * BN;
  return g;
}

Proj proj(const Buffers& b, const Geo& g, float mom, int it, int n_iters) {
  return Proj{static_cast<const float*>(b.mag), static_cast<float2*>(b.state),
              static_cast<float*>(b.sre), static_cast<float*>(b.sim),
              static_cast<float*>(b.pre), static_cast<float*>(b.pim), b.st, g.G, g.bins,
              g.KI, mom, it == 0, it + 1 == n_iters};
}

template <typename T>
int launch_ola(const Buffers& b, const Geo& g, cudaStream_t s) {
  const long long n = (long long)g.B * ((g.F + OLA_FG - 1) / OLA_FG) * (g.hi - g.lo);
  gl_ola_kernel<T><<<(unsigned)((n + 255) / 256), 256, 0, s>>>(
      static_cast<const float*>(b.fr), static_cast<const float*>(b.nrm),
      static_cast<const float*>(b.shift), static_cast<T*>(b.wf), g.B, g.F, g.n_fft, g.hop, g.m,
      g.lo, g.hi);
  return int(cudaGetLastError());
}

int launch_f32(const Buffers& b, const Geo& g, int n_iters, float mom, cudaStream_t s) {
  const unsigned rows = (g.G + FTile::BM - 1) / FTile::BM;
  const dim3 fwd_grid(rows, g.ncol / FTile::BN);
  const dim3 inv_grid(rows, (g.hi - g.lo + FTile::BN - 1) / FTile::BN);
  for (int it = 0; it < n_iters; ++it) {
    gl_fwd_f32_kernel<<<fwd_grid, FTile::NT, 0, s>>>(
        static_cast<const float*>(b.wf), static_cast<const float*>(b.fwd),
        proj(b, g, mom, it, n_iters), g.n_fft, g.ncol, it ? g.lo : 0, it ? g.hi : g.n_fft);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess || it + 1 == n_iters) return int(err);
    gl_inv_f32_kernel<<<inv_grid, FTile::NT, 0, s>>>(
        static_cast<const float*>(b.st), static_cast<const float*>(b.inv),
        static_cast<float*>(b.fr), g.G, g.n_fft, g.KI, g.lo, g.hi);
    const int e = launch_ola<float>(b, g, s);
    if (e) return e;
  }
  return 0;
}

// consumer warpgroups of the two bf16 products' tiles
constexpr int FWD_NWG = 4, INV_NWG = 2;

template <class Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

int launch_bf16(const Buffers& b, const Geo& g, int n_iters, float mom, cudaStream_t s) {
  using RF = Ring<FWD_NWG>;
  using RI = Ring<INV_NWG>;
  CUtensorMap wmap, fmap, smap, imap;
  if (!sm90::make_map(&wmap, b.wf, g.n_fft, g.G, 1, BK, RF::BM, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !sm90::make_map(&fmap, b.fwd, g.ncol, g.n_fft, 1, 64, BK, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !sm90::make_map(&smap, b.st, g.KI, g.G, 1, BK, RI::BM, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !sm90::make_map(&imap, b.inv, g.n_fft, g.KI, 1, 64, BK, CU_TENSOR_MAP_SWIZZLE_128B))
    return int(cudaErrorInvalidValue);
  static bool configured = false;   // once: allow the rings' dynamic shared memory
  if (!configured) {
    cudaError_t e = allow_smem(gl_fwd_bf16_kernel<FWD_NWG>, RF::SMEM_BYTES);
    if (e == cudaSuccess) e = allow_smem(gl_inv_bf16_kernel<INV_NWG>, RI::SMEM_BYTES);
    if (e != cudaSuccess) return int(e);
    configured = true;
  }
  const long long fwd_blocks = (long long)(g.G + RF::BM - 1) / RF::BM * (g.ncol / BN);
  const int inv_ct = (g.hi - g.lo + BN - 1) / BN;
  const long long inv_blocks = (long long)(g.G + RI::BM - 1) / RI::BM * inv_ct;
  if (fwd_blocks > 0x7fffffffLL || inv_blocks > 0x7fffffffLL) return int(cudaErrorInvalidValue);
  int inv_nkb, inv_ks;
  k_blocks(g.KI, inv_nkb, inv_ks);
  for (int it = 0; it < n_iters; ++it) {
    const int k_lo = it ? g.lo : 0, k_hi = it ? g.hi : g.n_fft;
    int nkb, last_ks;
    k_blocks(k_hi - k_lo, nkb, last_ks);
    gl_fwd_bf16_kernel<FWD_NWG><<<(unsigned)fwd_blocks, RF::NTHREADS, RF::SMEM_BYTES, s>>>(
        wmap, fmap, proj(b, g, mom, it, n_iters), g.ncol / BN, k_lo, nkb, last_ks);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess || it + 1 == n_iters) return int(err);
    gl_inv_bf16_kernel<INV_NWG><<<(unsigned)inv_blocks, RI::NTHREADS, RI::SMEM_BYTES, s>>>(
        smap, imap, static_cast<float*>(b.fr), g.G, g.n_fft, g.lo, g.hi, inv_ct, inv_nkb,
        inv_ks);
    const int e = launch_ola<__nv_bfloat16>(b, g, s);
    if (e) return e;
  }
  return 0;
}

}  // namespace

extern "C" {

// wf [B*F, n_fft] (compute type; updated in place), mag [B*F, bins] f32,
// fwd [n_fft, ncol] and inv [KI, n_fft] (compute type; ncol = 2*bins
// rounded up to 128, KI = 2*bins rounded up to 8), nrm [F, n_fft] and
// shift [2m-1, n_fft] f32; scratch: fr [B*F, n_fft] f32, st [B*F, KI]
// (compute type, pad columns zeroed by the caller), state [B*F, bins] f32
// pairs; outputs sre/sim/pre/pim [B*F, bins] f32.  [lo, hi): the window's
// support.  Returns the CUDA error code of the first failed launch, or 0.
int gl_iterations_launch(void* wf, const void* mag, const void* fwd, const void* inv,
                         const void* nrm, const void* shift, void* fr, void* st, void* state,
                         void* sre, void* sim, void* pre, void* pim, int B, int F, int n_fft,
                         int hop, int lo, int hi, int n_iters, float mom, int is_bf16,
                         void* stream) {
  if (B <= 0 || F <= 0 || n_iters <= 0) return 0;
  if (lo < 0 || hi > n_fft || lo >= hi) return int(cudaErrorInvalidValue);
  const Buffers b{wf, fr, st, state, sre, sim, pre, pim, mag, fwd, inv, nrm, shift};
  const Geo g = geometry(B, F, n_fft, hop, lo, hi);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch_bf16(b, g, n_iters, mom, s) : launch_f32(b, g, n_iters, mom, s);
}

// The bf16 launch: out = {tile rows, consumer warpgroups, ring stages,
// dynamic shared memory bytes} of the forward product, then of the inverse
// (both tiles 128 columns wide, 64-deep k-blocks).
void gl_iterations_plan(int* out) {
  const int plan[8] = {Ring<FWD_NWG>::BM, FWD_NWG, Ring<FWD_NWG>::STAGES,
                       Ring<FWD_NWG>::SMEM_BYTES, Ring<INV_NWG>::BM, INV_NWG,
                       Ring<INV_NWG>::STAGES, Ring<INV_NWG>::SMEM_BYTES};
  for (int i = 0; i < 8; ++i) out[i] = plan[i];
}

}  // extern "C"
