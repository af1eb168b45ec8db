// Backward of the GRU scan, fused over directions, in two launches for
// Hopper (sm_90a): a carry-free prologue over every row (t, b) of each
// direction (remat), then the reverse-time scan of the gradient chain alone
// (scan).
//
// Replaces: tacotron_multispeaker_tpu/ops/gru_scan.py _bigru_scan_bwd_pallas
// (the reverse-time kernel behind the bigru_scan custom VJP; both CBHG
// BiGRUs of the train step), and _gru_scan_bwd_pallas (behind the
// one-direction gru_scan custom VJP, models/modules.GRU with use_pallas
// under autograd): one pair of launchers, gru_scan_bwd_remat_launch and
// gru_scan_bwd_launch, with n_dirs = D = 2 or 1 (streams [T, D, B, .]).
//
// The Pallas kernel rematerialises the forward's gates inside its scan,
// because VMEM is scarce on a TPU.  None of them depends on the reverse-time
// carry dh: hprev, xg and xc are inputs of the backward.  On this card they
// would put two products and three exposed global loads on the serial chain
// for nothing, so they are computed first, in parallel over all rows.
//
// remat (bigru_bwd_remat_{bf16,f32}_kernel), for every row (t, d, b), with
// h = hprev[t,d,b] (the forward's state before step t; direction 1's
// streams are time-reversed by the caller, as in the forward):
//   [r | u] = sigmoid(xg + round(h) @ whg[d]),  rh = r*h
//   c = tanh(xc + round(rh) @ whc[d])
// and writes ruc = [r | u | c] (f32) and rh (compute type T: the candidate
// product's A rows, and the stream from which csrc/wgrad.cu reduces dwhc).
// It writes r, u, c rather than the scan's five carry-free factors
// ((1-u)(1-c^2), (h-c)u(1-u), h r(1-r), u, r): 12F bytes a row against 20F,
// and the scan then does the plain backward's own arithmetic in its order
// (ops/gru_scan.py bigru_bwd_remat_reference / bigru_bwd_scan_reference).
// A tile is 64 consecutive rows (t, b) of one direction (the directions
// have different weights), so both products are [64, F] x [F, N] products
// with one matrix, N = 2F and then F:
//   bf16: wgmma m64n128k16 (sm90_common.cuh).  One producer warp streams
//   the weight k-blocks (64 rows x 128 columns, two 128-byte-swizzled TMA
//   boxes; zeros outside the tensor, so F = 32's 64 columns are a partial
//   chunk) through a ring of 3 stages; one consumer warpgroup copies the A
//   rows (hprev, then the rh it wrote itself, both already in bf16) into
//   the layout of a 128-byte-swizzled box.  The sums go through shared
//   memory to an epilogue of coalesced loads and stores.
//   f32: the FMA tile of mma_common.cuh (64 x 64, CUDA cores), same order.
//
// scan (bigru_bwd_scan_kernel): one block of 4F threads per (direction,
// row) runs all T steps in reverse, with whc[d] and whg[d] in shared memory
// (96 KB in bf16 at F = 128), row-major with 16 bytes of padding a row.  A
// step's inputs (r, u, c, hprev, dys) arrive in a ring of three shared
// step buffers by cp.async two steps ahead, so their latency overlaps the
// steps before.  A step:
//   dht = dh + dys;  dac = dht(1-u)(1-c^2);  dgu = dht(h-c)u(1-u)
//     (dxc, dxg[F:] stored; round(dac), round(dgu) to shared memory)
//   barrier
//   phase 1: drh[k] = round(dac) . whc[k, :],  s_u[k] = round(dgu) . whg[k, F:]
//     then dgr = drh h r(1-r) (dxg[:F]) and dht u + drh r
//   barrier
//   phase 2: dh = dht u + drh r + s_u + round(dgr) . whg[k, :F]
// Two barriers and two dependent F-deep products a step (the Pallas step
// rematerialised first: four products and five barriers).  Each product
// is dot products over weight rows, a row's 16-byte chunks shared by 2
// (phase 1) or 4 (phase 2) lanes of a warp and summed by shuffles; a
// quarter-warp reads one chunk of 8 consecutive rows, in distinct banks by
// the padding; the vector is a broadcast.  The lane that sums row j in
// phase 2 owns element j: it keeps dh in a register.  Products round their
// input vector to T and sum in f32.
//
// Bound on this card: the scan's serial chain.  A step waits at least two
// dependent phases, each a barrier plus a shared-memory round trip, plus
// the 3F^2 * sizeof(T) bytes of weights it reads from shared memory over
// one SM's shared-memory bandwidth (chip_smoke.py _gru_bwd_latency_bound_ms,
// from csrc/latency_probe.cu).  The prologue is ~6 GFLOP of tensor-core
// products and ~0.2 GB of streams at T = 1000, B = 32, F = 128: bytes
// bound it at tens of microseconds.
//
// Limits (ops/gru_scan.py bwd_check_limits raises outside them; its shared
// memory counts mirror bigru_scan_bwd_{remat_,}smem_bytes below): F a
// multiple of 8 (16-byte rows), 4F <= 768 threads, B <= 65535 (grid y of
// the scan), T*B < 2^31 - 64 rows a direction.  Shared memory <= 227 KB:
// the scan's F(3F + 2*16/sizeof(T)) * sizeof(T) bytes of weights + 24F
// bytes of vectors + three step buffers of 12F + 2F*sizeof(T) bytes
// (bf16: F <= 184, f32: F <= 128; 109 KB and 206 KB at F = 128); the bf16
// prologue's 8 KB per 64 columns of F + 48 KB of ring + 33 KB of staged
// sums (98 KB at F = 128, two blocks an SM); the f32 prologue's tile has a
// fixed 35 KB.  Every preset's widths (F = 128, tiny's F = 32) and
// batches (B <= 256) fit.

#include <string.h>

#include "mma_common.cuh"
#include "sm90_common.cuh"

namespace {

using namespace kern;
using bf16 = __nv_bfloat16;

// ------------------------------------------------------------------ remat

constexpr int RT_BM = 64;                     // rows (t, b) of one direction a tile
constexpr int RT_BN = 128;                    // bf16 columns a chunk
constexpr int RT_BK = 64;                     // k-block
constexpr int RT_STAGES = 3;                  // bf16 weight ring
constexpr int RT_SLOT = RT_BM * RT_BK * 2;    // one bf16 A k-block: 8 KB
constexpr int RT_STAGE = RT_BK * RT_BN * 2;   // one weight k-block: 16 KB
constexpr int RT_THREADS = 128 + 32;          // consumer warpgroup + producer warp
constexpr int RT_LDS = RT_BN + 4;             // staged sums: floats a row
constexpr int RT_U = 4;                       // iterations whose loads go before their stores

enum { MAP_WG = 0, MAP_WC, N_MAPS };
struct RematMaps { CUtensorMap m[N_MAPS]; };

template <typename T>
struct RematArgs {
  const T* xg;     // [T, D, B, 2F]
  const T* xc;     // [T, D, B, F]
  const T* hprev;  // [T, D, B, F]
  const T* whg;    // [D, F, 2F]
  const T* whc;    // [D, F, F]
  float* ruc;      // [T, D, B, 3F]: r | u | c
  T* rh;           // [T, D, B, F]: r * hprev
  int M, D, B, F;  // M = T * B rows a direction
};

__host__ __device__ __forceinline__ int kblocks(int F) { return (F + RT_BK - 1) / RT_BK; }

// the row of the [T, D, B, .] streams that is row m = t B + b of direction d
__device__ __forceinline__ size_t stream_row(int m, int d, int D, int B) {
  return (size_t(m / B) * D + d) * B + m % B;
}

__device__ __forceinline__ float4 ld4(const float* p) { return *reinterpret_cast<const float4*>(p); }
__device__ __forceinline__ float4 ld4(const bf16* p) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}
__device__ __forceinline__ void st4(float* p, float4 v) { *reinterpret_cast<float4*>(p) = v; }
__device__ __forceinline__ void st4(bf16* p, float4 v) {
  __nv_bfloat162 h[2] = {__floats2bfloat162_rn(v.x, v.y), __floats2bfloat162_rn(v.z, v.w)};
  *reinterpret_cast<uint2*>(p) = *reinterpret_cast<const uint2*>(h);
}

// The epilogue of columns [n0, n0 + BNC) of the gates (cand false: N = 2F)
// or the candidate (cand true: N = F) from their sums, staged as RT_BM rows
// of ``ld`` floats: 4 columns a thread an iteration (F is a multiple of 8),
// coalesced loads and stores.
template <typename T, int BNC>
__device__ void remat_epilogue(const RematArgs<T>& a, bool cand, const float* stg, int ld,
                               int n0, int m0, int d, int tid, int nthreads) {
  constexpr int G = BNC / 4;
  const int F = a.F, N = cand ? F : 2 * F;
  for (int e0 = tid; e0 < RT_BM * G; e0 += nthreads * RT_U) {
    float4 v[RT_U], x[RT_U], hp[RT_U];
    size_t row[RT_U];
    int col[RT_U];
    bool ok[RT_U];
#pragma unroll
    for (int u = 0; u < RT_U; ++u) {
      const int e = e0 + u * nthreads, r = e / G, m = m0 + r;
      col[u] = n0 + (e % G) * 4;
      ok[u] = e < RT_BM * G && m < a.M && col[u] < N;
      row[u] = ok[u] ? stream_row(m, d, a.D, a.B) : 0;
      if (ok[u]) {
        v[u] = *reinterpret_cast<const float4*>(stg + r * ld + (e % G) * 4);
        x[u] = cand ? ld4(a.xc + row[u] * F + col[u]) : ld4(a.xg + row[u] * 2 * F + col[u]);
        if (!cand && col[u] < F) hp[u] = ld4(a.hprev + row[u] * F + col[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < RT_U; ++u) {
      if (!ok[u]) continue;
      float* out = a.ruc + row[u] * 3 * F;
      if (cand) {
        st4(out + 2 * F + col[u],
            make_float4(tanhf(x[u].x + v[u].x), tanhf(x[u].y + v[u].y),
                        tanhf(x[u].z + v[u].z), tanhf(x[u].w + v[u].w)));
      } else {
        const float4 g = make_float4(sigmoidf(x[u].x + v[u].x), sigmoidf(x[u].y + v[u].y),
                                     sigmoidf(x[u].z + v[u].z), sigmoidf(x[u].w + v[u].w));
        st4(out + col[u], g);
        if (col[u] < F)
          st4(a.rh + row[u] * F + col[u],
              make_float4(g.x * hp[u].x, g.y * hp[u].y, g.z * hp[u].z, g.w * hp[u].w));
      }
    }
  }
}

__device__ __forceinline__ void consumer_sync() {
  __threadfence_block();
  asm volatile("bar.sync 1, 128;\n" ::: "memory");
}

// A product's A rows (src [.., F] in bf16: hprev, or the rh this block
// wrote) into kblocks(F) slots: 128-byte rows, 16-byte chunk ch of row r
// at chunk ch ^ (r % 8), the layout of a TMA box with 128-byte swizzle;
// zeros past F and past the last row.  Plain loads: rh was written by this
// block a moment before.
__device__ void load_a(unsigned char* atile, const bf16* src, const RematArgs<bf16>& a, int m0,
                       int d, int tid) {
  const int n = kblocks(a.F) * RT_BM * 8;
  for (int e0 = tid; e0 < n; e0 += 128 * RT_U) {
    uint4 v[RT_U];
#pragma unroll
    for (int u = 0; u < RT_U; ++u) {
      const int e = e0 + u * 128;
      const int k = (e / (RT_BM * 8)) * RT_BK + (e % 8) * 8, m = m0 + (e / 8) % RT_BM;
      v[u] = make_uint4(0u, 0u, 0u, 0u);
      if (e < n && m < a.M && k < a.F)
        v[u] = *reinterpret_cast<const uint4*>(src + stream_row(m, d, a.D, a.B) * a.F + k);
    }
#pragma unroll
    for (int u = 0; u < RT_U; ++u) {
      const int e = e0 + u * 128;
      if (e >= n) break;
      const int kb = e / (RT_BM * 8), r = (e / 8) % RT_BM, ch = e % 8;
      *reinterpret_cast<uint4*>(atile + kb * RT_SLOT + r * 128 + ((ch ^ (r & 7)) << 4)) = v[u];
    }
  }
}

__global__ void __launch_bounds__(RT_THREADS)
bigru_bwd_remat_bf16_kernel(const __grid_constant__ RematMaps maps, const RematArgs<bf16> a) {
  extern __shared__ unsigned char smem_raw[];
  // swizzled tiles need 1024-byte alignment
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int F = a.F, nkb = kblocks(F);
  unsigned char* atile = smem;                       // nkb A k-blocks (hprev, then rh)
  unsigned char* ring = smem + nkb * RT_SLOT;
  float* stg = reinterpret_cast<float*>(ring + RT_STAGES * RT_STAGE);   // RT_BM x RT_LDS
  uint64_t* full = reinterpret_cast<uint64_t*>(stg + RT_BM * RT_LDS);
  uint64_t* empty = full + RT_STAGES;
  const int d = blockIdx.y, m0 = blockIdx.x * RT_BM;
  if (threadIdx.x == 0) {
    for (int s = 0; s < RT_STAGES; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], 1);
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= 128) {
    // producer: one thread streams the weight k-blocks of both products
    if (threadIdx.x == 128) {
      int g = 0;
      for (int p = 0; p < 2; ++p) {
        const int N = p == 0 ? 2 * F : F;
        const CUtensorMap* m = &maps.m[p == 0 ? MAP_WG : MAP_WC];
        for (int n0 = 0; n0 < N; n0 += RT_BN)
          for (int k0 = 0; k0 < F; k0 += RT_BK, ++g) {
            const int st = g % RT_STAGES;
            if (g >= RT_STAGES) sm90::mbar_wait(&empty[st], (g / RT_STAGES - 1) & 1);
            sm90::mbar_expect_tx(&full[st], RT_STAGE);
            unsigned char* dst = ring + st * RT_STAGE;
            sm90::tma_load_3d(dst, m, &full[st], n0, k0, d);
            sm90::tma_load_3d(dst + RT_STAGE / 2, m, &full[st], n0 + 64, k0, d);
          }
      }
    }
    return;
  }

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  int g = 0;
  for (int p = 0; p < 2; ++p) {
    // the gates' A rows are hprev; the candidate's the rh their epilogue
    // wrote (the gates' products are complete: the slots may be refilled)
    load_a(atile, p == 0 ? a.hprev : a.rh, a, m0, d, tid);
    sm90::fence_proxy_async();
    consumer_sync();
    const int N = p == 0 ? 2 * F : F;
    for (int n0 = 0; n0 < N; n0 += RT_BN) {
      float acc[64];
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] = 0.f;
      for (int kb = 0; kb < nkb; ++kb, ++g) {
        const int st = g % RT_STAGES;
        sm90::mbar_wait(&full[st], (g / RT_STAGES) & 1);
        sm90::fence_operands(acc);
        sm90::wgmma_fence();
        sm90::kblock<4, RT_BK, RT_BM>(acc, atile + kb * RT_SLOT, ring + st * RT_STAGE,
                                      RT_STAGE / 2);
        sm90::wgmma_commit();
        sm90::wgmma_wait<1>();
        sm90::fence_operands(acc);
        // the products of the k-block before are done: its stage may be refilled
        if (kb > 0 && tid == 0) sm90::mbar_arrive(&empty[(g - 1) % RT_STAGES]);
      }
      sm90::wgmma_wait<0>();
      sm90::fence_operands(acc);
      if (tid == 0) sm90::mbar_arrive(&empty[(g - 1) % RT_STAGES]);
      // the sums through shared memory (the last chunk's epilogue is done)
      consumer_sync();
#pragma unroll
      for (int i = 0; i < 64; i += 2) {
        const int r = warp * 16 + lane / 4 + 8 * ((i / 2) % 2);
        const int c = 8 * (i / 4) + 2 * (lane % 4);
        *reinterpret_cast<float2*>(stg + r * RT_LDS + c) = make_float2(acc[i], acc[i + 1]);
      }
      consumer_sync();
      remat_epilogue<bf16, RT_BN>(a, p == 1, stg, RT_LDS, n0, m0, d, tid, 128);
    }
    // the epilogue's rh rows are the next product's A rows
    consumer_sync();
  }
}

__global__ void __launch_bounds__(kern::TileF32::NT)
bigru_bwd_remat_f32_kernel(const RematArgs<float> a) {
  using Tile = kern::TileF32;
  __shared__ Tile::Smem s;
  const int d = blockIdx.y, m0 = blockIdx.x * RT_BM, F = a.F;
  for (int p = 0; p < 2; ++p) {
    const int N = p == 0 ? 2 * F : F;
    const float* src = p == 0 ? a.hprev : a.rh;
    const float* w = p == 0 ? a.whg + size_t(d) * F * 2 * F : a.whc + size_t(d) * F * F;
    for (int n0 = 0; n0 < N; n0 += Tile::BN) {
      auto pa = [&](int r, int k) -> const float* {
        const int m = m0 + r;
        return m < a.M ? src + stream_row(m, d, a.D, a.B) * F + k : nullptr;
      };
      auto pb = [&](int k, int c) -> const float* {
        return n0 + c < N ? w + size_t(k) * N + n0 + c : nullptr;
      };
      Tile::run(s, F, pa, pb);
      remat_epilogue<float, Tile::BN>(a, p == 1, Tile::out(s), Tile::LDC, n0, m0, d,
                                      threadIdx.x, Tile::NT);
      __threadfence_block();
      __syncthreads();
    }
  }
}

size_t remat_smem_bytes(int F, int is_bf16) {
  if (!is_bf16) return sizeof(kern::TileF32::Smem);
  return 1024 + size_t(kblocks(F)) * RT_SLOT + RT_STAGES * RT_STAGE +
         RT_BM * RT_LDS * sizeof(float) + 2 * RT_STAGES * 8;
}

template <typename T>
RematArgs<T> remat_args(const void* xg, const void* xc, const void* hprev, const void* whg,
                        const void* whc, void* ruc, void* rh, int n_steps, int D, int B, int F) {
  RematArgs<T> a;
  a.xg = static_cast<const T*>(xg);
  a.xc = static_cast<const T*>(xc);
  a.hprev = static_cast<const T*>(hprev);
  a.whg = static_cast<const T*>(whg);
  a.whc = static_cast<const T*>(whc);
  a.ruc = static_cast<float*>(ruc);
  a.rh = static_cast<T*>(rh);
  a.M = n_steps * B;
  a.D = D;
  a.B = B;
  a.F = F;
  return a;
}

int launch_remat(const void* xg, const void* xc, const void* hprev, const void* whg,
                 const void* whc, void* ruc, void* rh, int n_steps, int D, int B, int F,
                 int is_bf16, cudaStream_t stream) {
  const long long tiles = ((long long)n_steps * B + RT_BM - 1) / RT_BM;
  if (tiles <= 0 || tiles > 0x7fffffffLL || F % 8) return int(cudaErrorInvalidValue);
  const dim3 grid = dim3(unsigned(tiles), unsigned(D));
  if (!is_bf16) {
    const RematArgs<float> a =
        remat_args<float>(xg, xc, hprev, whg, whc, ruc, rh, n_steps, D, B, F);
    bigru_bwd_remat_f32_kernel<<<grid, kern::TileF32::NT, 0, stream>>>(a);
    return int(cudaGetLastError());
  }
  const RematArgs<bf16> a = remat_args<bf16>(xg, xc, hprev, whg, whc, ruc, rh, n_steps, D, B, F);
  RematMaps maps;   // copied into the launch's parameters
  memset(&maps, 0, sizeof(maps));
  // the weights as [D][F rows][N columns]: 64-column x 64-row boxes, 128-byte swizzle
  if (!sm90::make_map(&maps.m[MAP_WG], whg, 2 * F, F, D, 64, RT_BK,
                      CU_TENSOR_MAP_SWIZZLE_128B) ||
      !sm90::make_map(&maps.m[MAP_WC], whc, F, F, D, 64, RT_BK, CU_TENSOR_MAP_SWIZZLE_128B))
    return int(cudaErrorInvalidValue);
  const size_t smem = remat_smem_bytes(F, 1);
  cudaError_t err = cudaFuncSetAttribute(bigru_bwd_remat_bf16_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  bigru_bwd_remat_bf16_kernel<<<grid, RT_THREADS, smem, stream>>>(maps, a);
  return int(cudaGetLastError());
}

// ------------------------------------------------------------------- scan

constexpr int SC_P1 = 2;              // threads that share a phase-1 dot product
constexpr int SC_P2 = 4;              // threads that share a phase-2 dot product
constexpr int SC_RING = 3;            // step buffers: inputs arrive two steps ahead
constexpr int SC_MAX_THREADS = 768;   // 4F threads (the limits cap F at 184)

// 16 bytes of T from shared memory, as floats
template <typename T> struct SVec;
template <> struct SVec<float> {
  static constexpr int N = 4;
  static __device__ __forceinline__ void load(const float* p, float* w) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
  }
};
template <> struct SVec<bf16> {
  static constexpr int N = 8;
  static __device__ __forceinline__ void load(const bf16* p, float* w) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      w[2 * i] = f.x;
      w[2 * i + 1] = f.y;
    }
  }
};

// row strides (elements) of the weight copies: 16 bytes of padding a row
template <typename T>
__host__ __device__ __forceinline__ int scan_ldc(int F) { return F + 16 / int(sizeof(T)); }
template <typename T>
__host__ __device__ __forceinline__ int scan_ldg(int F) { return 2 * F + 16 / int(sizeof(T)); }

// floats of one step buffer: r | u | c (3F f32), then hprev and dys (F of T each)
template <typename T>
__host__ __device__ __forceinline__ int step_floats(int F) {
  return 3 * F + int(align16(size_t(2) * F * sizeof(T)) / sizeof(float));
}

__host__ __device__ __forceinline__ int scan_threads(int F) { return 32 * ((F + 7) / 8); }

template <typename T>
size_t scan_smem_bytes(int F) {
  return align16(size_t(F) * (scan_ldc<T>(F) + scan_ldg<T>(F)) * sizeof(T)) +
         (size_t(6) * F + size_t(SC_RING) * step_floats<T>(F)) * sizeof(float);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(sm90::smem_u32(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The inputs of the step in stream row ``row`` (r | u | c, hprev, dys) into a
// step buffer, 16-byte copies spread over the block; one commit group.
template <typename T>
__device__ void prefetch_step(float* buf, const float* ruc, const T* hprev, const T* dys,
                              size_t row, int F) {
  constexpr int E = 16 / sizeof(T);
  const int n_ruc = 3 * F / 4, n_h = F / E;
  T* sh = reinterpret_cast<T*>(buf + 3 * F);
  for (int i = threadIdx.x; i < n_ruc + 2 * n_h; i += blockDim.x) {
    if (i < n_ruc) {
      cp_async16(buf + 4 * i, ruc + row * 3 * F + 4 * i);
    } else {
      const int k = i - n_ruc, h = k / n_h, o = (k % n_h) * E;
      cp_async16(sh + h * F + o, (h ? dys : hprev) + row * F + o);
    }
  }
  cp_async_commit();
}

// This thread's part of the dot product of x (f32, shared memory) with a
// weight row w (T, shared memory) of K elements: the 16-byte chunks part,
// part + S, ...  (K = KT when KT > 0)
template <typename T, int S, int KT>
__device__ __forceinline__ float dot_part(const T* w, const float* x, int Kr, int part) {
  constexpr int VEC = SVec<T>::N;
  const int nc = (KT ? KT : Kr) / VEC;
  float acc[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) acc[i] = 0.f;
#pragma unroll 8
  for (int i = 0; i < (nc + S - 1) / S; ++i) {
    const int k = (part + i * S) * VEC;
    if (k >= nc * VEC) break;
    float wv[VEC];
    SVec<T>::load(w + k, wv);
#pragma unroll
    for (int q = 0; q < VEC; q += 4) {
      const float4 xv = *reinterpret_cast<const float4*>(x + k + q);
      acc[q] = fmaf(xv.x, wv[q], acc[q]);
      acc[q + 1] = fmaf(xv.y, wv[q + 1], acc[q + 1]);
      acc[q + 2] = fmaf(xv.z, wv[q + 2], acc[q + 2]);
      acc[q + 3] = fmaf(xv.w, wv[q + 3], acc[q + 3]);
    }
  }
#pragma unroll
  for (int s = VEC / 2; s > 0; s /= 2)
#pragma unroll
    for (int i = 0; i < s; ++i) acc[i] += acc[i + s];
  return acc[0];
}

template <typename T, int FT>
__global__ void __launch_bounds__(SC_MAX_THREADS)
bigru_bwd_scan_kernel(const float* __restrict__ ruc, const T* __restrict__ hprev,
                      const T* __restrict__ dys, const T* __restrict__ whg,
                      const T* __restrict__ whc, float* __restrict__ dxg,
                      float* __restrict__ dxc, float* __restrict__ dh0, int n_steps, int D,
                      int B, int Fr) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int VEC = SVec<T>::N;
  const int F = FT ? FT : Fr;
  const int d = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int LC = scan_ldc<T>(F), LG = scan_ldg<T>(F), SF = step_floats<T>(F);
  T* Wc = reinterpret_cast<T*>(smem);                       // [F][LC]: whc[d]'s rows
  T* Wg = Wc + size_t(F) * LC;                              // [F][LG]: whg[d]'s rows
  float* v1 = reinterpret_cast<float*>(smem + align16(size_t(F) * (LC + LG) * sizeof(T)));
  float* vr = v1 + 2 * F;   // round(dgr)      (v1: [round(dac) | round(dgu)])
  float* su = vr + F;       // round(dgu) @ whg[:, F:]^T
  float* dhs = su + F;      // dht
  float* pt = dhs + F;      // dht u + drh r
  float* ring = pt + F;     // SC_RING step buffers

  const size_t rstride = size_t(D) * B;   // stream rows between steps t and t - 1
  size_t row = (size_t(n_steps - 1) * D + d) * B + b;
  prefetch_step(ring + ((n_steps - 1) % SC_RING) * SF, ruc, hprev, dys, row, F);
  if (n_steps > 1)
    prefetch_step(ring + ((n_steps - 2) % SC_RING) * SF, ruc, hprev, dys, row - rstride, F);
  else
    cp_async_commit();
  const T* wc_src = whc + size_t(d) * F * F;
  const T* wg_src = whg + size_t(d) * F * 2 * F;
  for (int i = tid; i < F * (F / VEC); i += blockDim.x) {
    const int k = i / (F / VEC), c = (i % (F / VEC)) * VEC;
    *reinterpret_cast<uint4*>(Wc + k * LC + c) =
        *reinterpret_cast<const uint4*>(wc_src + size_t(k) * F + c);
  }
  for (int i = tid; i < F * (2 * F / VEC); i += blockDim.x) {
    const int k = i / (2 * F / VEC), c = (i % (2 * F / VEC)) * VEC;
    *reinterpret_cast<uint4*>(Wg + k * LG + c) =
        *reinterpret_cast<const uint4*>(wg_src + size_t(k) * 2 * F + c);
  }
  cp_async_wait<1>();
  __syncthreads();

  // A warp's lanes l, l + 16 share phase-1 row warp*16 + l%16 (drh rows
  // < F, s_u rows F..2F); lanes l, l + 8, l + 16, l + 24 share phase-2 row
  // warp*8 + l%8, whose lane l < 8 owns that element of every per-step
  // vector (dh in a register).  A quarter-warp reads 8 rows at one chunk:
  // distinct banks, by the padding.
  const int o1 = warp * 16 + (lane & 15), part1 = lane >> 4;
  const int k2 = warp * 8 + (lane & 7), part2 = lane >> 3;
  const bool own = lane < 8 && k2 < F;
  float dh = 0.f;
  for (int t = n_steps - 1; t >= 0; --t, row -= rstride) {
    const float* sb = ring + (t % SC_RING) * SF;
    const T* shp = reinterpret_cast<const T*>(sb + 3 * F);
    const T* sdy = shp + F;
    if (own) {
      const int j = k2;
      const float u = sb[F + j], c = sb[2 * F + j], hp = to_f(shp[j]);
      const float dht = dh + to_f(sdy[j]);
      const float dc = dht * (1.f - u);
      const float du = dht * (hp - c);
      const float dac = dc * (1.f - c * c);
      const float dgu = du * u * (1.f - u);
      dxc[row * F + j] = dac;
      dxg[row * 2 * F + F + j] = dgu;
      v1[j] = rnd<T>(dac);
      v1[F + j] = rnd<T>(dgu);
      dhs[j] = dht;
    }
    __syncthreads();
    // step t - 2's inputs: its buffer's last readers were step t + 1's,
    // before the barrier that ended its phase 1
    if (t >= 2)
      prefetch_step(ring + ((t - 2) % SC_RING) * SF, ruc, hprev, dys, row - 2 * rstride, F);
    else
      cp_async_commit();
    // ---- phase 1: drh = round(dac) @ whc^T, s_u = round(dgu) @ whg[:, F:]^T --
    float s1 = 0.f;
    if (o1 < 2 * F)
      s1 = o1 < F ? dot_part<T, SC_P1, FT>(Wc + o1 * LC, v1, F, part1)
                  : dot_part<T, SC_P1, FT>(Wg + (o1 - F) * LG + F, v1 + F, F, part1);
    s1 += __shfl_xor_sync(0xffffffffu, s1, 16);
    if (lane < 16 && o1 < F) {
      const float r = sb[o1], u = sb[F + o1], hp = to_f(shp[o1]);
      const float dr = s1 * hp;
      const float dgr = dr * r * (1.f - r);
      dxg[row * 2 * F + o1] = dgr;
      vr[o1] = rnd<T>(dgr);
      pt[o1] = dhs[o1] * u + s1 * r;
    } else if (lane < 16 && o1 < 2 * F) {
      su[o1 - F] = s1;
    }
    // step t - 1's inputs have landed (t - 2's may still be in flight)
    cp_async_wait<1>();
    __syncthreads();
    // ---- phase 2: dh = dht u + drh r + s_u + round(dgr) @ whg[:, :F]^T -------
    float s2 = 0.f;
    if (k2 < F) s2 = dot_part<T, SC_P2, FT>(Wg + k2 * LG, vr, F, part2);
    s2 += __shfl_xor_sync(0xffffffffu, s2, 8);
    s2 += __shfl_xor_sync(0xffffffffu, s2, 16);
    if (own) dh = pt[k2] + su[k2] + s2;
  }
  if (own) dh0[(size_t(d) * B + b) * F + k2] = dh;
}

template <typename T, int FT>
int launch_scan_f(const void* ruc, const void* hprev, const void* dys, const void* whg,
                  const void* whc, float* dxg, float* dxc, float* dh0, int n_steps, int D,
                  int B, int F, cudaStream_t stream) {
  const size_t smem = scan_smem_bytes<T>(F);
  cudaError_t err = cudaFuncSetAttribute(bigru_bwd_scan_kernel<T, FT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         int(smem));
  if (err != cudaSuccess) return int(err);
  bigru_bwd_scan_kernel<T, FT><<<dim3(D, B), scan_threads(F), smem, stream>>>(
      static_cast<const float*>(ruc), static_cast<const T*>(hprev), static_cast<const T*>(dys),
      static_cast<const T*>(whg), static_cast<const T*>(whc), dxg, dxc, dh0, n_steps, D, B, F);
  return int(cudaGetLastError());
}

// the presets' widths (128, and tiny's 32) with their loops' trip counts fixed
template <typename T>
int launch_scan(const void* ruc, const void* hprev, const void* dys, const void* whg,
                const void* whc, float* dxg, float* dxc, float* dh0, int n_steps, int D, int B,
                int F, cudaStream_t stream) {
  if (F % 8 || scan_threads(F) > SC_MAX_THREADS) return int(cudaErrorInvalidValue);
  auto go = [&](auto fn) {
    return fn(ruc, hprev, dys, whg, whc, dxg, dxc, dh0, n_steps, D, B, F, stream);
  };
  if (F == 128) return go(launch_scan_f<T, 128>);
  if (F == 32) return go(launch_scan_f<T, 32>);
  return go(launch_scan_f<T, 0>);
}

}  // namespace

extern "C" {

// Shared memory of the scan kernel, so the wrapper can check it before launch.
size_t bigru_scan_bwd_smem_bytes(int F, int is_bf16) {
  return is_bf16 ? scan_smem_bytes<__nv_bfloat16>(F) : scan_smem_bytes<float>(F);
}

// Shared memory of a prologue block.
size_t bigru_scan_bwd_remat_smem_bytes(int F, int is_bf16) { return remat_smem_bytes(F, is_bf16); }

// The carry-free prologue.  n_dirs = D: xg [T,D,B,2F], xc/hprev [T,D,B,F],
// whg [D,F,2F], whc [D,F,F] in T (f32 or bf16) -> ruc [T,D,B,3F] f32
// (r | u | c) and rh [T,D,B,F] in T (D = 1: streams [T,B,.] and weights
// [F,.] have the same layout).  Returns the CUDA error code.
int gru_scan_bwd_remat_launch(const void* xg, const void* xc, const void* hprev,
                              const void* whg, const void* whc, void* ruc, void* rh,
                              int n_steps, int n_dirs, int B, int F, int is_bf16,
                              void* stream) {
  return launch_remat(xg, xc, hprev, whg, whc, ruc, rh, n_steps, n_dirs, B, F, is_bf16,
                      static_cast<cudaStream_t>(stream));
}

// The reverse-time scan from the prologue's ruc: hprev/dys [T,D,B,F] and the
// weights in T -> dxg [T,D,B,2F], dxc [T,D,B,F], dh0 [D,B,F] f32.  Returns
// the CUDA error code.
int gru_scan_bwd_launch(const void* ruc, const void* hprev, const void* dys, const void* whg,
                        const void* whc, void* dxg, void* dxc, void* dh0, int n_steps,
                        int n_dirs, int B, int F, int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* gx = static_cast<float*>(dxg);
  float* cx = static_cast<float*>(dxc);
  float* h = static_cast<float*>(dh0);
  if (is_bf16)
    return launch_scan<__nv_bfloat16>(ruc, hprev, dys, whg, whc, gx, cx, h, n_steps, n_dirs, B,
                                      F, s);
  return launch_scan<float>(ruc, hprev, dys, whg, whc, gx, cx, h, n_steps, n_dirs, B, F, s);
}

}  // extern "C"
