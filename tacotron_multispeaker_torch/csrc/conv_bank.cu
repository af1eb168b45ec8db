// The CBHG conv bank as one product kernel for Hopper (sm_90a).
//
// Replaces tacotron_multispeaker_tpu/ops/conv_bank.py conv_bank_pallas:
//   y[b, t, o] = relu(sum_{j<K} sum_{d<D} x[b, t + j - (K-1)/2, d] * w[j, d, o] + bias[o])
// (x zero outside [0, T)), the width-1..K bank folded into one masked
// width-K convolution.  x [B, T, D], w [K, D, O], bias [O] and y [B, T, O]
// are all in the compute type (bf16 or f32); the sums are f32, the bias
// (already rounded) is added in f32, then ReLU and one rounding, as the
// Pallas kernel does.  Given the bank's group width C (0: none), column o
// belongs to width group g = o / C, whose taps are [c0 - g/2, c0 - g/2 + g
// + 1) with c0 = (K-1)/2 (models/modules.py _bank_mask); the other taps of
// w are zeros the kernel does not multiply.
//
// Design: an implicit-im2col product.  The rows are output frames, the
// columns the O channels, the depth the (tap, input channel) pairs.  A
// block computes one BM x BN output tile and runs only the taps its
// columns need: the tap ranges of the groups nest, so a tile's taps are
// those of its last column's group (the widest).  Tiles are numbered so
// that the widest groups launch first and the 1-tap tiles fill the tail.
// With BN = 128 = C (both banks of every preset) a tile holds one group,
// so the products are the mask's nonzeros: 53 % (encoder, K=16) and 56 %
// (post-net, K=8) of the full masked product.
//
// bf16 (the serving precision) runs on Hopper's own units (sm90_common.cuh):
// * A block owns BM = 64 * NWG frames of one batch row b (NWG = 2 or 3
//   consumer warpgroups, chosen per T to waste the fewest rows: T=192 takes
//   192, T=1000 takes 128, 2.4 % extra) and BN = 128 columns.
// * A k-block is one tap j and a run of input channels.  Its A operand is
//   x[b, t0 + j - pad + m, d], brought by TMA from a 3-D tensor map over
//   x [B, T, D] at (d0, t0 + j - pad, b): the signed coordinates with zero
//   fill give the SAME padding and any ragged d >= D, so there is no im2col
//   buffer and no address arithmetic per element.  Its B operand, w[j, d,
//   o0 + n], comes from a 3-D map over w [K, D, O] as two 64-column boxes
//   with 128-byte swizzle; it is N-major, read with wgmma's transpose bit,
//   so w is used as the caller holds it (no K-major copy).
// * A layouts: "wide" (D a multiple of 64, or D > 128): 64-channel boxes,
//   128-byte swizzle, k-block = 64 channels of a tap.  "narrow" (the post-
//   net's D = 80): DC = D rounded up to 16 channels in 16-channel boxes with
//   32-byte swizzle, k-block = a whole tap, no products on zero fill; wide
//   would fill 80 to 128, 60 % more products.  The launcher's choice is
//   ops/conv_bank.py a_layout; chip_smoke.py times both at D = 80.
// * A ring of S stages in dynamic shared memory (S from a shared-memory
//   budget: two blocks an SM for NWG = 2, one for NWG = 3).  One producer
//   thread (the warp after the consumers) issues the TMA loads against a
//   "full" mbarrier per stage and waits on an "empty" one before reusing
//   it.  Each consumer warpgroup runs wgmma m64n128k16 on its 64 rows with
//   f32 accumulators in registers, keeps one k-block of products in flight
//   and releases the stage before it.
// * Epilogue: f32 bias, ReLU, one rounding to bf16 into shared memory (the
//   ring, free by then), then 16-byte stores of whole rows, clipped at T
//   and O.
//
// f32 (the check path) keeps the FMA tile of mma_common.cuh (64 x 64, CUDA
// cores: the tensor cores have no full-f32 mode) with the same tap ranges,
// and skips the masked taps per column, so it is exact for any w.
//
// Bound on this card: the tensor cores.  At the B=32 shapes the nonzero
// taps are 27.4 (encoder) + 23.6 (post-net) GFLOP, 0.0515 ms at 989
// TFLOP/s; the bytes (x, w, bias once, y once; y is 65.5 MB) take 0.032 ms.
// Measured by chip_smoke.py on an H100 SXM (700 W): 0.066 + 0.086 ms of
// device time, about 40 % and 27 % of that bound.  Each tile reads its A
// and B tiles from L2 once per tap and has no next tile to load during its
// epilogue; in trials on the card, two blocks an SM (the post-net's tiles)
// beat one.  Two variants tried on the card ran slower and were not kept:
// loading each tile's x rows once and shifting the A descriptor by the tap
// (correct with no base offset: the hardware swizzles by address) read less
// but made the encoder's one block an SM wait for the whole window;
// persistent blocks storing straight from the accumulators lost more to the
// fragment's 4-byte stores than the overlap won.  Persistence with a
// staging buffer of its own (or a TMA store) is the next lever.
//
// Limits (the Python wrapper raises outside them): every tensor below 2^31
// elements; for bf16, D and O multiples of 8 and 16-byte aligned x and w
// (TMA strides and addresses), and w masked wherever a tile's columns span
// several groups (the wrapper masks it when C is not a multiple of 128).

#include "common.cuh"
#include "mma_common.cuh"
#include "sm90_common.cuh"

namespace {

// Taps [lo, hi) that output column o needs: its width group's with a bank
// mask, all K without one (C == 0).
__host__ __device__ __forceinline__ void col_taps(int o, int K, int C, int& lo, int& hi) {
  if (C <= 0) { lo = 0; hi = K; return; }
  const int g = o / C;
  lo = (K - 1) / 2 - g / 2;
  hi = lo + g + 1;
}

// ---------------------------------------------------------------- f32 path

__global__ void __launch_bounds__(kern::TileF32::NT)
conv_bank_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                     const float* __restrict__ bias, float* __restrict__ y,
                     int B, int Tn, int D, int K, int O, int C) {
  using Tile = kern::TileF32;
  __shared__ Tile::Smem s;
  const int M = B * Tn;
  // the widest groups (the last column tiles) first
  const int nm = (M + Tile::BM - 1) / Tile::BM, nn = (O + Tile::BN - 1) / Tile::BN;
  const int row0 = (blockIdx.x % nm) * Tile::BM;
  const int o0 = (nn - 1 - (int)blockIdx.x / nm) * Tile::BN;
  const int pad = (K - 1) / 2;
  int j0, j1;
  col_taps(min(o0 + Tile::BN, O) - 1, K, C, j0, j1);
  auto pa = [&](int r, int k) -> const float* {
    const int row = row0 + r;
    if (row >= M) return nullptr;
    const int b = row / Tn, t = row - b * Tn;
    const int ts = t + j0 + k / D - pad;
    return (ts < 0 || ts >= Tn) ? nullptr : x + ((size_t)b * Tn + ts) * D + k % D;
  };
  auto pb = [&](int k, int c) -> const float* {
    const int o = o0 + c, j = j0 + k / D;
    int lo, hi;
    col_taps(o, K, C, lo, hi);
    return (o >= O || j < lo || j >= hi) ? nullptr : w + ((size_t)j * D + k % D) * O + o;
  };
  Tile::run(s, (j1 - j0) * D, pa, pb);
  const float* Cs = Tile::out(s);
  for (int i = threadIdx.x; i < Tile::BM * Tile::BN; i += Tile::NT) {
    const int r = i / Tile::BN, c = i % Tile::BN;
    const int row = row0 + r, o = o0 + c;
    if (row < M && o < O) y[(size_t)row * O + o] = fmaxf(Cs[r * Tile::LDC + c] + bias[o], 0.f);
  }
}

// --------------------------------------------------------------- bf16 path

constexpr int BN = 128;          // output columns of a tile (two 64-column B boxes)
constexpr int LDS = BN + 8;      // staged output row (elements): 16-byte aligned rows

struct Geometry {
  int B, T, D, K, O, C, pad;
  int nt;      // row tiles per batch row
  int nn;      // column tiles
  int dc;      // input channels of a k-block
  int nch;     // k-blocks of a tap
  int stages;
};

template <int NWG, int AW>
__global__ void __launch_bounds__(NWG * 128 + 32, NWG == 2 ? 2 : 1)
conv_bank_bf16_kernel(const __grid_constant__ CUtensorMap xmap,
                      const __grid_constant__ CUtensorMap wmap,
                      const __nv_bfloat16* __restrict__ bias, __nv_bfloat16* __restrict__ y,
                      const Geometry g) {
  constexpr int BM = 64 * NWG;
  extern __shared__ unsigned char smem_raw[];
  // swizzled TMA tiles need 1024-byte aligned stages
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int a_bytes = BM * g.dc * 2, b_bytes = BN * g.dc * 2;
  const int stage_bytes = a_bytes + b_bytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + g.stages * stage_bytes);
  uint64_t* empty = full + g.stages;

  // tile: widest groups first, then batch row, then row tile
  const int per_col = g.B * g.nt;
  const int n_tile = g.nn - 1 - (int)blockIdx.x / per_col;
  const int rest = (int)blockIdx.x % per_col;
  const int b = rest / g.nt, t0 = (rest % g.nt) * BM, o0 = n_tile * BN;
  int j0, j1;
  col_taps(min(o0 + BN, g.O) - 1, g.K, g.C, j0, j1);
  const int nkb = (j1 - j0) * g.nch;

  if (threadIdx.x == 0) {
    for (int s = 0; s < g.stages; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], NWG);
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= NWG * 128) {
    // producer: one thread keeps the ring full
    if (threadIdx.x == NWG * 128) {
      for (int kb = 0; kb < nkb; ++kb) {
        const int s = kb % g.stages;
        if (kb >= g.stages) sm90::mbar_wait(&empty[s], (kb / g.stages - 1) & 1);
        sm90::mbar_expect_tx(&full[s], stage_bytes);
        const int j = j0 + kb / g.nch, d0 = (kb % g.nch) * g.dc;
        unsigned char* a = smem + s * stage_bytes;
        for (int i = 0; i < g.dc / AW; ++i)
          sm90::tma_load_3d(a + i * BM * AW * 2, &xmap, &full[s], d0 + i * AW,
                            t0 + j - g.pad, b);
        for (int c = 0; c < BN / 64; ++c)
          sm90::tma_load_3d(a + a_bytes + c * g.dc * 128, &wmap, &full[s], o0 + 64 * c, d0, j);
      }
    }
    return;
  }

  // consumers: warpgroup wg owns rows [64 wg, 64 wg + 64) of the tile
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  // B: the second 64-column box is dc * 128 bytes on
  const uint32_t b_lbo = g.dc * 128;
  const int nks = g.dc / 16;
  for (int kb = 0; kb < nkb; ++kb) {
    const int s = kb % g.stages;
    sm90::mbar_wait(&full[s], (kb / g.stages) & 1);
    const unsigned char* a = smem + s * stage_bytes + wg * 64 * AW * 2;
    const unsigned char* bt = smem + s * stage_bytes + a_bytes;
    sm90::fence_operands(acc);
    sm90::wgmma_fence();
    // the k-block's 16-channel steps, unrolled (4 wide, DC/16 narrow)
    if constexpr (AW == 64) {
      sm90::kblock<4, AW, BM>(acc, a, bt, b_lbo);
    } else {
      switch (nks) {
        case 1: sm90::kblock<1, AW, BM>(acc, a, bt, b_lbo); break;
        case 2: sm90::kblock<2, AW, BM>(acc, a, bt, b_lbo); break;
        case 3: sm90::kblock<3, AW, BM>(acc, a, bt, b_lbo); break;
        case 4: sm90::kblock<4, AW, BM>(acc, a, bt, b_lbo); break;
        case 5: sm90::kblock<5, AW, BM>(acc, a, bt, b_lbo); break;
        case 6: sm90::kblock<6, AW, BM>(acc, a, bt, b_lbo); break;
        case 7: sm90::kblock<7, AW, BM>(acc, a, bt, b_lbo); break;
        default: sm90::kblock<8, AW, BM>(acc, a, bt, b_lbo); break;
      }
    }
    sm90::wgmma_commit();
    sm90::wgmma_wait<1>();
    sm90::fence_operands(acc);
    // the products of k-block kb - 1 are done: its stage may be refilled
    if (kb > 0 && tid == 0) sm90::mbar_arrive(&empty[(kb - 1) % g.stages]);
  }
  sm90::wgmma_wait<0>();
  sm90::fence_operands(acc);
  // every consumer is past its last product before the ring is reused
  asm volatile("bar.sync 1, %0;\n" ::"n"(NWG * 128) : "memory");

  __nv_bfloat16* st = reinterpret_cast<__nv_bfloat16*>(smem);
  const int warp = tid / 32, lane = tid % 32;
  const int r0 = wg * 64 + warp * 16 + lane / 4;
#pragma unroll
  for (int i = 0; i < 64; i += 2) {
    const int r = r0 + 8 * ((i / 2) % 2), c = 8 * (i / 4) + 2 * (lane % 4);
    const int o = min(o0 + c, g.O - 2);   // columns past O are never stored
    const float b0 = __bfloat162float(bias[o]), b1 = __bfloat162float(bias[o + 1]);
    *reinterpret_cast<__nv_bfloat162*>(st + r * LDS + c) =
        __floats2bfloat162_rn(fmaxf(acc[i] + b0, 0.f), fmaxf(acc[i + 1] + b1, 0.f));
  }
  asm volatile("bar.sync 1, %0;\n" ::"n"(NWG * 128) : "memory");
  for (int i = threadIdx.x; i < BM * (BN / 8); i += NWG * 128) {
    const int r = i / (BN / 8), c = (i % (BN / 8)) * 8;
    const int t = t0 + r, o = o0 + c;
    if (t < g.T && o < g.O)
      *reinterpret_cast<uint4*>(y + ((size_t)b * g.T + t) * g.O + o) =
          *reinterpret_cast<const uint4*>(st + r * LDS + c);
  }
}

// The bf16 launch's shape: warpgroups, row tiles, stages; the dynamic
// shared memory in bytes, or -1 outside the kernel's limits.
int plan(Geometry& g, int nwg) {
  const int bm = 64 * nwg;
  g.nt = (g.T + bm - 1) / bm;
  const int stage_bytes = (bm + BN) * g.dc * 2;
  // two blocks an SM with two consumer warpgroups where two stages fit in
  // half an SM's shared memory, else one (227 KB)
  const int fixed = 1024 + 16 * 8;   // alignment slack, barriers
  const int budget = nwg == 2 && 2 * stage_bytes <= 115712 - fixed ? 115712 : 232448;
  g.stages = (budget - fixed) / stage_bytes;
  if (g.stages > 8) g.stages = 8;
  if (g.stages < 2 || g.stages * stage_bytes < bm * LDS * 2) return -1;
  return 1024 + g.stages * stage_bytes + 2 * g.stages * 8;
}

// The geometry of a bf16 launch and its warpgroups (the fewest computed
// rows, ties to two); false outside the kernel's limits.
bool geometry(int B, int T, int D, int K, int O, int C, int a_box, Geometry& g, int& nwg) {
  if (D % 8 || O % 8 || (a_box != 64 && a_box != 16)) return false;
  g = Geometry{B, T, D, K, O, C, (K - 1) / 2, 0, (O + BN - 1) / BN, 0, 0, 0};
  g.dc = a_box == 64 ? 64 : (D + 15) / 16 * 16;
  g.nch = a_box == 64 ? (D + 63) / 64 : 1;
  nwg = (T + 191) / 192 * 192 < (T + 127) / 128 * 128 ? 3 : 2;
  return g.dc <= 128;   // a narrow stage stays within 64 KB of operands
}

template <int NWG, int AW>
int launch_bf16(const void* x, const void* w, const void* bias, void* y, Geometry g,
                cudaStream_t s) {
  const int smem = plan(g, NWG);
  if (smem < 0) return int(cudaErrorInvalidValue);
  CUtensorMap xmap, wmap;
  if (!sm90::make_map(&xmap, x, g.D, g.T, g.B, AW, 64 * NWG,
                AW == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_32B) ||
      !sm90::make_map(&wmap, w, g.O, g.D, g.K, 64, g.dc, CU_TENSOR_MAP_SWIZZLE_128B))
    return int(cudaErrorInvalidValue);
  auto kernel = conv_bank_bf16_kernel<NWG, AW>;
  static bool configured = false;   // once per instantiation: allow 227 KB
  if (!configured) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, 232448);
    if (e != cudaSuccess) return int(e);
    configured = true;
  }
  const long long blocks = (long long)g.nn * g.B * g.nt;
  if (blocks > 0x7fffffffLL) return int(cudaErrorInvalidValue);
  kernel<<<(unsigned)blocks, NWG * 128 + 32, smem, s>>>(
      xmap, wmap, static_cast<const __nv_bfloat16*>(bias), static_cast<__nv_bfloat16*>(y), g);
  return int(cudaGetLastError());
}

int launch_f32(const void* x, const void* w, const void* bias, void* y, int B, int T, int D,
               int K, int O, int C, cudaStream_t s) {
  using Tile = kern::TileF32;
  const long long rows = (long long)B * T;
  const long long blocks = ((rows + Tile::BM - 1) / Tile::BM) * ((O + Tile::BN - 1) / Tile::BN);
  if (blocks > 0x7fffffffLL) return int(cudaErrorInvalidValue);
  conv_bank_f32_kernel<<<(unsigned)blocks, Tile::NT, 0, s>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<const float*>(bias), static_cast<float*>(y), B, T, D, K, O, C);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

// x, w, bias, y: device pointers in the compute type (is_bf16 ? bf16 : f32).
// C: the bank's group width (0: no mask).  a_box: the bf16 A layout, 64
// (wide) or 16 (narrow).  Returns the CUDA error code of the launch.
int conv_bank_launch(const void* x, const void* w, const void* bias, void* y, int B, int T,
                     int D, int K, int O, int C, int is_bf16, int a_box, void* stream) {
  if ((long long)B * T <= 0 || O <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!is_bf16) return launch_f32(x, w, bias, y, B, T, D, K, O, C, s);
  Geometry g;
  int nwg;
  if (!geometry(B, T, D, K, O, C, a_box, g, nwg)) return int(cudaErrorInvalidValue);
  if (a_box == 64)
    return nwg == 3 ? launch_bf16<3, 64>(x, w, bias, y, g, s)
                    : launch_bf16<2, 64>(x, w, bias, y, g, s);
  return nwg == 3 ? launch_bf16<3, 16>(x, w, bias, y, g, s)
                  : launch_bf16<2, 16>(x, w, bias, y, g, s);
}

// The bf16 launch conv_bank_launch would make: out = {consumer warpgroups,
// ring stages, dynamic shared memory bytes}.  Returns 0, or an error code
// outside the kernel's limits.
int conv_bank_plan(int B, int T, int D, int K, int O, int a_box, int* out) {
  Geometry g;
  int nwg;
  if (!geometry(B, T, D, K, O, 0, a_box, g, nwg)) return int(cudaErrorInvalidValue);
  const int smem = plan(g, nwg);
  if (smem < 0) return int(cudaErrorInvalidValue);
  out[0] = nwg;
  out[1] = g.stages;
  out[2] = smem;
  return 0;
}

}  // extern "C"
