// The teacher-forced decoder scan, backward, in two launches for Hopper
// (sm_90a): a carry-free prologue over all S*B rows (remat), then the
// reverse-time scan of the gradient chain alone (scan).
//
// Replaces: tacotron_multispeaker_tpu/ops/teacher_decoder.py
// _teacher_decoder_bwd_pallas (its sequential kernel _bwd_kernel; d_keys is
// csrc/dkeys.cu and the weight-gradient sums csrc/wgrad.cu).
//
// The Pallas kernel rematerialises the forward's values inside its scan,
// because VMEM is scarce on a TPU.  None of them depends on a reverse-time
// carry: each layer's input x_{i-1} = x_i - h_i and h_prev are inputs of
// the backward.  On this card they would sit on the serial chain for
// nothing, so they are computed first, in parallel over every row.
//
// remat (teacher_bwd_remat_{bf16,f32}_kernel), for every row (t, b), the
// decoder layers last to first, then the attention GRU (same math as
// teacher_bwd_remat_reference in ops/teacher_decoder.py):
//   x_{i-1} = x_i - h_i  (x_N = xs)                              -> xin[i]
//   [r | u] = sigmoid(x_{i-1} @ w_r[i][:, :2H] + h_prev @ hg[i] + b_r[i][:2H])
//   rh = r * h_prev                                               -> rh[i]
//   c = tanh(x_{i-1} @ w_r[i][:, 2H:] + rh @ hc[i] + b_r[i][2H:])
//   [r | u | c]                                                   -> ruc[i]
//   ctx = p_t @ memory_b                                          -> ctx
//   ctx_prev = pp_t @ memory_b (pp as given: it need not be p shifted)
//   [r | u] = sigmoid(ctx_prev @ w_ctx[:, H:3H] + h_prev @ a_hg + png)
//   rh = r * h_prev                                               -> rh_a
//   c = tanh(ctx_prev @ w_ctx[:, 3H:] + rh @ a_hc + pnc)           -> ruc[N]
//   q = ha @ wq                                                   -> q
// A block takes 64 consecutive steps of one batch row, so every product,
// p_t @ memory_b included, is a real [64, K] x [K, N] product with one
// matrix; it runs 2N + 5 of them in order, two K segments each where a
// gate's two input sums share one accumulator, each followed by an
// elementwise epilogue.  Intermediates (xin, rh, rh_a, ctx_prev) go to
// global memory and come back as the next product's A rows (L2-resident,
// written and read by the same block).
//   bf16: wgmma m64n128k16 (sm90_common.cuh).  One producer warp streams
//   the weight k-blocks (64 rows x 128 columns, two 128-byte-swizzled TMA
//   boxes) through a ring of 4 stages, running ahead across products; one
//   consumer warpgroup loads the A rows (f32 streams) itself, rounds them
//   to bf16 and stores them in the layout a 128-byte-swizzled TMA box has.
//   Rounding in the loader, not in a separate pass that writes bf16 copies
//   for TMA, because half the A operands are produced inside the block a
//   product earlier, and not through wgmma's register-A form, because the
//   rounded tile is read by every 128-column chunk of the product.  Each
//   chunk's sums go through shared memory to an epilogue of coalesced
//   16-byte loads and stores; every elementwise loop loads four
//   iterations' operands before it stores (on the card this took the
//   prologue from 0.95 to 0.32 ms at full width: its loops had waited for
//   one L2 load at a time).
//   f32: the FMA tile of mma_common.cuh (64 x 64, CUDA cores), same order.
//
// scan (teacher_bwd_scan_kernel), reverse time, one block of 512 threads a
// batch row, with the carries dha, dhd_i and dctx_c (the part of the next
// dctx from the attention GRU's gradient) in shared memory:
//   per layer, last first: dht = dx + dhd_i; from r, u, c and h_prev:
//     da_c, dg_u;  drh = da_c @ hc^T;  dg_r = drh * h_prev * r (1 - r)
//     [dx' | dh_prev'] = dg @ [w_r^T | (hg^T; 0)];  dx += dx';
//     dhd_i = dht*u + drh*r + dh_prev'
//   [dha_loc | dctx_x] = dx @ [wd_h^T | w_ctx^T[0:H]];  dctx = dctx_x + dctx_c
//   dp = dctx @ memory^T + dalign;  de = p * (dp - sum(dp * p))
//   dq = sum_l de_l * v * (1 - tanh^2(keys_l + q))  (L split over the block)
//   dha_loc += dq @ wq^T;  attention GRU as a layer, with dht = dha_loc +
//     dha and [dh_prev | dctx_c] = [dg_pre | da_c] @ [(a_hg^T; 0) |
//     w_ctx^T[H:4H]]
// 2N + 7 dependent phases a step (11 at N = 2; 6N + 14 = 26 before the
// prologue took the carry-free products).  Each product is
// decoder_common.cuh's coalesced matvec over a transposed or concatenated
// weight copy the wrapper makes once per call.  A step's inputs (r|u|c of
// every GRU, h_prev, q, p, dalign, dxs) are copied into shared memory with
// cp.async one step ahead, so their latency overlaps the previous step.
// Products round their input vector to the compute type T and sum in f32.
//
// Outputs dpng, dpnc, de, dctx, dh0a, dh0d (f32).  The weight gradients are
// sums over all S steps and B rows; the launches stream out their per-step
// factors instead (xin, rh, rh_a, ctx from remat; dgc, dcb, dq from scan)
// and csrc/wgrad.cu reduces them.
//
// Bound on this card: the scan's serial chain.  A step's phases each wait
// for L2 loads of their weight rows (one row streams ~3.5 MB of bf16
// weights, keys and memory a step at full width, against ~6.1 MB when it
// also rematerialised), so per step it takes at least (2N + 7) L2 round
// trips plus those bytes over one SM's L2 bandwidth
// (chip_smoke.py _teacher_bwd_latency_bound_ms).  The matvecs reach about a
// quarter of that bandwidth; more loads in flight a thread did not help,
// and weights read from L1 instead (a wrong-result trial) took the scan
// from 22.4 to 13.6 ms, so their L2 stream and then their FMA
// instructions set its pace (PERF.md).  The prologue is a few GFLOP of
// tensor-core products and ~0.2 GB of streams.
//
// Limits (the Python wrapper raises outside them): N <= 4 layers; H, 2H,
// 3H, 4H, A, D and H + D multiples of 16/sizeof(T) and at most
// 512*16/sizeof(T) (matvec widths: N = H, 2H, H + D; K = H, 3H, A);
// weights and rows 16-byte aligned.  Shared memory <= 227 KB: the scan's
// is scan_smem_floats (the matvec partials, carries, work vectors and two
// step buffers of 2H + NH + 3(N+1)H + A + 2L floats; 69 KB at full width in
// bf16), the bf16 remat's 1024 + 8 KB per A k-block (max(2 ceil(H/64),
// ceil(D/64) + ceil(H/64), ceil(L/64)) of them) + 64 KB of ring + 33 KB of
// staged sums (170 KB).  So the bf16 backward takes L <= 1024 (16 k-blocks,
// 226 KB): the products over L, p_t @ memory_b and pp_t @ memory_b, hold
// all their A k-blocks at once.  The f32 prologue's tile has a fixed size;
// the scan's 5L floats cap L near 8,300 at full width.  Training inputs
// are cut at train.max_input_length (192 in every preset but tiny's 64).

#include <string.h>

#include "decoder_common.cuh"
#include "mma_common.cuh"
#include "sm90_common.cuh"

namespace {

using namespace dec;
using bf16 = __nv_bfloat16;

constexpr int MAX_LAYERS = 4;

// ------------------------------------------------------------------ remat

constexpr int RT_BM = 64;                     // steps of one batch row a tile
constexpr int RT_BN = 128;                    // bf16 columns a chunk
constexpr int RT_BK = 64;                     // k-block
constexpr int RT_STAGES = 4;                  // bf16 weight ring
constexpr int RT_SLOT = RT_BM * RT_BK * 2;    // one bf16 A k-block: 8 KB
constexpr int RT_STAGE = RT_BK * RT_BN * 2;   // one weight k-block: 16 KB
constexpr int RT_THREADS = 128 + 32;          // consumer warpgroup + producer warp
constexpr int RT_LDS = RT_BN + 4;             // staged sums: floats a row

enum { kStore, kGates, kCand };
enum { MAP_W_R = 0, MAP_HG = MAX_LAYERS, MAP_HC = 2 * MAX_LAYERS, MAP_W_CTX = 3 * MAX_LAYERS,
       MAP_A_HG, MAP_A_HC, MAP_WQ, MAP_MEM, N_MAPS };

template <typename T>
struct RematArgs {
  const T* png; const T* pnc;                          // [S,B,2H], [S,B,H]
  const float* ha; const float* hap; const float* xs;  // [S,B,H]
  const float* p; const float* pp;                     // [S,B,L]
  const T* memory;                                     // [B,L,D]
  const T* a_hg; const T* a_hc; const T* wq; const T* w_ctx;
  float* rh_a; float* ctx; float* ctxp; float* q;      // [S,B,H/D/D/A]
  const float* hd[MAX_LAYERS]; const float* hdp[MAX_LAYERS];
  const T* w_r[MAX_LAYERS]; const float* b_r[MAX_LAYERS];
  const T* hg[MAX_LAYERS]; const T* hc[MAX_LAYERS];
  float* xin[MAX_LAYERS]; float* rh[MAX_LAYERS];       // [S,B,H]
  float* ruc[MAX_LAYERS + 1];                          // [S,B,3H]: r | u | c
  int S, B, L, A, D, H, N;
};

struct RematMaps { CUtensorMap m[N_MAPS]; };

// One K segment of a product: A rows from an f32 stream [S, B, lda] (row
// (t, b) at (t B + b) lda), the weight's rows [K, ldw] from column col.
template <typename T>
struct Seg {
  const float* a;
  int lda, K;
  const T* w;
  int ldw, col, map;
};

template <typename T>
struct Prod {
  Seg<T> seg[2];
  int nseg, N, kind;
  const float* bias;     // per column (b_r), or null
  const T* bias_rows;    // per row [.., N] (png, pnc)
  const float* hp;       // kGates: h_prev rows [.., H]
  float* out;            // kStore: rows [.., N]; kGates, kCand: r|u|c rows [.., 3H]
  float* rh;             // kGates: r * h_prev rows [.., H]
};

__host__ __device__ __forceinline__ int remat_products(int n_layers) { return 2 * n_layers + 5; }

// The p-th product of batch row b's tiles: each layer's gates and
// candidate (last layer first), then ctx, ctx_prev, the attention GRU's
// gates and candidate, q.
template <typename T>
__device__ Prod<T> remat_prod(const RematArgs<T>& a, int p, int b) {
  const int H = a.H, D = a.D, L = a.L, NL = a.N;
  Prod<T> pr;
  pr.seg[1] = Seg<T>{nullptr, 0, 0, nullptr, 0, 0, 0};
  pr.nseg = 2;
  pr.bias = nullptr;
  pr.bias_rows = nullptr;
  pr.hp = nullptr;
  pr.rh = nullptr;
  if (p < 2 * NL) {
    const int i = NL - 1 - p / 2;
    pr.out = a.ruc[i];
    if (p % 2 == 0) {
      pr.seg[0] = Seg<T>{a.xin[i], H, H, a.w_r[i], 3 * H, 0, MAP_W_R + i};
      pr.seg[1] = Seg<T>{a.hdp[i], H, H, a.hg[i], 2 * H, 0, MAP_HG + i};
      pr.N = 2 * H;
      pr.kind = kGates;
      pr.bias = a.b_r[i];
      pr.hp = a.hdp[i];
      pr.rh = a.rh[i];
    } else {
      pr.seg[0] = Seg<T>{a.xin[i], H, H, a.w_r[i], 3 * H, 2 * H, MAP_W_R + i};
      pr.seg[1] = Seg<T>{a.rh[i], H, H, a.hc[i], H, 0, MAP_HC + i};
      pr.N = H;
      pr.kind = kCand;
      pr.bias = a.b_r[i] + 2 * H;
    }
    return pr;
  }
  const int k = p - 2 * NL;
  if (k <= 1) {
    const T* mem = a.memory + size_t(b) * L * D;
    pr.seg[0] = Seg<T>{k == 0 ? a.p : a.pp, L, L, mem, D, 0, MAP_MEM};
    pr.nseg = 1;
    pr.N = D;
    pr.kind = kStore;
    pr.out = k == 0 ? a.ctx : a.ctxp;
  } else if (k == 2) {
    pr.seg[0] = Seg<T>{a.ctxp, D, D, a.w_ctx, 4 * H, H, MAP_W_CTX};
    pr.seg[1] = Seg<T>{a.hap, H, H, a.a_hg, 2 * H, 0, MAP_A_HG};
    pr.N = 2 * H;
    pr.kind = kGates;
    pr.bias_rows = a.png;
    pr.hp = a.hap;
    pr.out = a.ruc[NL];
    pr.rh = a.rh_a;
  } else if (k == 3) {
    pr.seg[0] = Seg<T>{a.ctxp, D, D, a.w_ctx, 4 * H, 3 * H, MAP_W_CTX};
    pr.seg[1] = Seg<T>{a.rh_a, H, H, a.a_hc, H, 0, MAP_A_HC};
    pr.N = H;
    pr.kind = kCand;
    pr.bias_rows = a.pnc;
    pr.out = a.ruc[NL];
  } else {
    pr.seg[0] = Seg<T>{a.ha, H, H, a.wq, a.A, 0, MAP_WQ};
    pr.nseg = 1;
    pr.N = a.A;
    pr.kind = kStore;
    pr.out = a.q;
  }
  return pr;
}

// Loops over a tile's elements load RT_U iterations' operands before they
// store anything: the stores may alias the next loads as far as the
// compiler knows, so it would not hoist those loads itself.
constexpr int RT_U = 4;

// x_{i-1} = x_i - h_i over the tile's rows (the layer's A rows), 4 floats a
// thread an iteration (H is a multiple of 4)
template <typename T>
__device__ void remat_x(const RematArgs<T>& a, int i, int b, int t0, int tid, int nthreads) {
  const float* src = i == a.N - 1 ? a.xs : a.xin[i + 1];
  const int H4 = a.H / 4, n = RT_BM * H4;
  for (int e0 = tid; e0 < n; e0 += nthreads * RT_U) {
    float4 x[RT_U], h[RT_U];
    size_t idx[RT_U];
    bool ok[RT_U];
#pragma unroll
    for (int u = 0; u < RT_U; ++u) {
      const int e = e0 + u * nthreads, t = t0 + e / H4;
      ok[u] = e < n && t < a.S;
      idx[u] = (size_t(t) * a.B + b) * a.H + (e % H4) * 4;
      if (ok[u]) {
        x[u] = *reinterpret_cast<const float4*>(src + idx[u]);
        h[u] = *reinterpret_cast<const float4*>(a.hd[i] + idx[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < RT_U; ++u)
      if (ok[u])
        *reinterpret_cast<float4*>(a.xin[i] + idx[u]) =
            make_float4(x[u].x - h[u].x, x[u].y - h[u].y, x[u].z - h[u].z, x[u].w - h[u].w);
  }
}

__device__ __forceinline__ float4 ld4(const float* p) { return *reinterpret_cast<const float4*>(p); }
__device__ __forceinline__ float4 ld4(const bf16* p) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

// The epilogue of columns [n0, n0 + BNC) of product pr from their sums,
// staged as RT_BM rows of ``ld`` floats: 4 columns a thread an iteration
// (every width is a multiple of 4), coalesced loads and stores.
template <typename T, int BNC>
__device__ void remat_epilogue(const Prod<T>& pr, const float* stg, int ld, int n0, int t0,
                               int b, int S, int B, int H, int tid, int nthreads) {
  constexpr int G = BNC / 4;
  for (int e0 = tid; e0 < RT_BM * G; e0 += nthreads * RT_U) {
    float4 v[RT_U], bias[RT_U], hp[RT_U];
    size_t row[RT_U];
    int col[RT_U];
    bool ok[RT_U];
#pragma unroll
    for (int u = 0; u < RT_U; ++u) {
      const int e = e0 + u * nthreads, r = e / G, t = t0 + r;
      col[u] = n0 + (e % G) * 4;
      row[u] = size_t(t) * B + b;
      ok[u] = e < RT_BM * G && t < S && col[u] < pr.N;
      if (ok[u]) {
        v[u] = *reinterpret_cast<const float4*>(stg + r * ld + (e % G) * 4);
        if (pr.kind != kStore)
          bias[u] = pr.bias ? ld4(pr.bias + col[u]) : ld4(pr.bias_rows + row[u] * pr.N + col[u]);
        if (pr.kind == kGates && col[u] < H) hp[u] = ld4(pr.hp + row[u] * H + col[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < RT_U; ++u) {
      if (!ok[u]) continue;
      const int c = col[u];
      if (pr.kind == kStore) {
        *reinterpret_cast<float4*>(pr.out + row[u] * pr.N + c) = v[u];
      } else if (pr.kind == kGates) {
        const float4 g = make_float4(sigmoidf(v[u].x + bias[u].x), sigmoidf(v[u].y + bias[u].y),
                                     sigmoidf(v[u].z + bias[u].z), sigmoidf(v[u].w + bias[u].w));
        *reinterpret_cast<float4*>(pr.out + row[u] * 3 * H + c) = g;
        if (c < H)
          *reinterpret_cast<float4*>(pr.rh + row[u] * H + c) =
              make_float4(g.x * hp[u].x, g.y * hp[u].y, g.z * hp[u].z, g.w * hp[u].w);
      } else {
        *reinterpret_cast<float4*>(pr.out + row[u] * 3 * H + 2 * H + c) =
            make_float4(tanhf(v[u].x + bias[u].x), tanhf(v[u].y + bias[u].y),
                        tanhf(v[u].z + bias[u].z), tanhf(v[u].w + bias[u].w));
      }
    }
  }
}

__device__ __forceinline__ void consumer_sync() {
  __threadfence_block();
  asm volatile("bar.sync 1, 128;\n" ::: "memory");
}

// The product's A rows rounded to bf16 into its k-block slots (segment 0's
// k-blocks, then segment 1's): 128-byte rows, 16-byte chunk ch of row r at
// chunk ch ^ (r % 8), the layout of a TMA box with 128-byte swizzle; zeros
// past each segment's K and past S.  8 values a thread an iteration.
__device__ void load_a(unsigned char* atile, const Prod<bf16>& pr, int b, int t0, int S, int B,
                       int tid) {
  int slot0 = 0;
  for (int s = 0; s < pr.nseg; ++s) {
    const Seg<bf16>& sg = pr.seg[s];
    const int nkb = (sg.K + RT_BK - 1) / RT_BK, n = nkb * RT_BM * 8;
    const bool vec = (sg.lda % 4 == 0) && (reinterpret_cast<uintptr_t>(sg.a) % 16 == 0);
    for (int e0 = tid; e0 < n; e0 += 128 * RT_U) {
      float f[RT_U][8];
#pragma unroll
      for (int u = 0; u < RT_U; ++u) {
        const int e = e0 + u * 128;
        const int k = (e / (RT_BM * 8)) * RT_BK + (e % 8) * 8, t = t0 + (e / 8) % RT_BM;
        const float* src = sg.a + (size_t(t) * B + b) * sg.lda + k;
        if (e < n && t < S && vec && k + 8 <= sg.K) {
          const float4 x = *reinterpret_cast<const float4*>(src);
          const float4 y = *reinterpret_cast<const float4*>(src + 4);
          f[u][0] = x.x; f[u][1] = x.y; f[u][2] = x.z; f[u][3] = x.w;
          f[u][4] = y.x; f[u][5] = y.y; f[u][6] = y.z; f[u][7] = y.w;
        } else {
#pragma unroll
          for (int j = 0; j < 8; ++j) f[u][j] = e < n && t < S && k + j < sg.K ? src[j] : 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < RT_U; ++u) {
        const int e = e0 + u * 128;
        if (e >= n) break;
        const int kb = e / (RT_BM * 8), r = (e / 8) % RT_BM, ch = e % 8;
        uint4 packed;
        __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&packed);
#pragma unroll
        for (int j = 0; j < 4; ++j) h[j] = __floats2bfloat162_rn(f[u][2 * j], f[u][2 * j + 1]);
        *reinterpret_cast<uint4*>(atile + (slot0 + kb) * RT_SLOT + r * 128 +
                                  ((ch ^ (r & 7)) << 4)) = packed;
      }
    }
    slot0 += nkb;
  }
}

__global__ void __launch_bounds__(RT_THREADS)
teacher_bwd_remat_bf16_kernel(const __grid_constant__ RematMaps maps, const RematArgs<bf16> a,
                              int slots) {
  extern __shared__ unsigned char smem_raw[];
  // swizzled tiles need 1024-byte alignment
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* atile = smem;
  unsigned char* ring = smem + slots * RT_SLOT;
  float* stg = reinterpret_cast<float*>(ring + RT_STAGES * RT_STAGE);   // RT_BM x RT_LDS
  uint64_t* full = reinterpret_cast<uint64_t*>(stg + RT_BM * RT_LDS);
  uint64_t* empty = full + RT_STAGES;
  const int nt = (a.S + RT_BM - 1) / RT_BM;
  const int b = blockIdx.x / nt, t0 = (blockIdx.x % nt) * RT_BM;
  const int nprod = remat_products(a.N);
  if (threadIdx.x == 0) {
    for (int s = 0; s < RT_STAGES; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], 1);
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= 128) {
    // producer: one thread streams every weight k-block of every product
    if (threadIdx.x == 128) {
      int g = 0;
      for (int p = 0; p < nprod; ++p) {
        const Prod<bf16> pr = remat_prod(a, p, b);
        for (int n0 = 0; n0 < pr.N; n0 += RT_BN)
          for (int s = 0; s < pr.nseg; ++s)
            for (int k0 = 0; k0 < pr.seg[s].K; k0 += RT_BK, ++g) {
              const int st = g % RT_STAGES;
              if (g >= RT_STAGES) sm90::mbar_wait(&empty[st], (g / RT_STAGES - 1) & 1);
              sm90::mbar_expect_tx(&full[st], RT_STAGE);
              const CUtensorMap* m = &maps.m[pr.seg[s].map];
              const int z = pr.seg[s].map == MAP_MEM ? b : 0;
              unsigned char* dst = ring + st * RT_STAGE;
              sm90::tma_load_3d(dst, m, &full[st], pr.seg[s].col + n0, k0, z);
              sm90::tma_load_3d(dst + RT_STAGE / 2, m, &full[st], pr.seg[s].col + n0 + 64, k0,
                                z);
            }
      }
    }
    return;
  }

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  int g = 0;
  for (int p = 0; p < nprod; ++p) {
    if (p < 2 * a.N && p % 2 == 0) {
      remat_x(a, a.N - 1 - p / 2, b, t0, tid, 128);
      consumer_sync();
    }
    const Prod<bf16> pr = remat_prod(a, p, b);
    load_a(atile, pr, b, t0, a.S, a.B, tid);
    sm90::fence_proxy_async();
    consumer_sync();
    for (int n0 = 0; n0 < pr.N; n0 += RT_BN) {
      float acc[64];
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] = 0.f;
      int kb = 0;
      for (int s = 0; s < pr.nseg; ++s)
        for (int k0 = 0; k0 < pr.seg[s].K; k0 += RT_BK, ++kb, ++g) {
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
      remat_epilogue<bf16, RT_BN>(pr, stg, RT_LDS, n0, t0, b, a.S, a.B, a.H, tid, 128);
    }
    // the epilogue's rows are the next product's A rows
    consumer_sync();
  }
}

__global__ void __launch_bounds__(kern::TileF32::NT)
teacher_bwd_remat_f32_kernel(const RematArgs<float> a) {
  using Tile = kern::TileF32;
  __shared__ Tile::Smem s;
  const int nt = (a.S + RT_BM - 1) / RT_BM;
  const int b = blockIdx.x / nt, t0 = (blockIdx.x % nt) * RT_BM;
  for (int p = 0; p < remat_products(a.N); ++p) {
    if (p < 2 * a.N && p % 2 == 0) {
      remat_x(a, a.N - 1 - p / 2, b, t0, threadIdx.x, Tile::NT);
      __threadfence_block();
      __syncthreads();
    }
    const Prod<float> pr = remat_prod(a, p, b);
    const int K0 = pr.seg[0].K, Kd = K0 + (pr.nseg > 1 ? pr.seg[1].K : 0);
    for (int n0 = 0; n0 < pr.N; n0 += Tile::BN) {
      auto pa = [&](int r, int k) -> const float* {
        const int t = t0 + r;
        if (t >= a.S) return nullptr;
        const Seg<float>& sg = pr.seg[k < K0 ? 0 : 1];
        return sg.a + (size_t(t) * a.B + b) * sg.lda + (k < K0 ? k : k - K0);
      };
      auto pb = [&](int k, int c) -> const float* {
        if (n0 + c >= pr.N) return nullptr;
        const Seg<float>& sg = pr.seg[k < K0 ? 0 : 1];
        return sg.w + size_t(k < K0 ? k : k - K0) * sg.ldw + sg.col + n0 + c;
      };
      Tile::run(s, Kd, pa, pb);
      remat_epilogue<float, Tile::BN>(pr, Tile::out(s), Tile::LDC, n0, t0, b, a.S, a.B, a.H,
                                      threadIdx.x, Tile::NT);
      __threadfence_block();
      __syncthreads();
    }
  }
}

// A k-block slots the bf16 remat needs: its widest product's
int remat_slots(const int* d) {
  const int L = d[2], D = d[4], H = d[5];
  const int kh = (H + RT_BK - 1) / RT_BK, kd = (D + RT_BK - 1) / RT_BK,
            kl = (L + RT_BK - 1) / RT_BK;
  int s = 2 * kh;
  if (kd + kh > s) s = kd + kh;
  if (kl > s) s = kl;
  return s;
}

size_t remat_smem_bytes(const int* d) {
  if (!d[7]) return sizeof(kern::TileF32::Smem);
  return 1024 + size_t(remat_slots(d)) * RT_SLOT + RT_STAGES * RT_STAGE +
         RT_BM * RT_LDS * sizeof(float) + 2 * RT_STAGES * 8;
}

template <typename T>
void parse_remat(const void* const* p, const int* d, RematArgs<T>& a) {
  int i = 0;
  auto cT = [&]() { return static_cast<const T*>(p[i++]); };
  auto cF = [&]() { return static_cast<const float*>(p[i++]); };
  auto oF = [&]() { return static_cast<float*>(const_cast<void*>(p[i++])); };
  a.png = cT(); a.pnc = cT();
  a.ha = cF(); a.hap = cF(); a.xs = cF(); a.p = cF(); a.pp = cF();
  a.memory = cT(); a.a_hg = cT(); a.a_hc = cT(); a.wq = cT(); a.w_ctx = cT();
  a.rh_a = oF(); a.ctx = oF(); a.ctxp = oF(); a.q = oF();
  a.S = d[0]; a.B = d[1]; a.L = d[2]; a.A = d[3]; a.D = d[4]; a.H = d[5]; a.N = d[6];
  a.ruc[a.N] = oF();
  for (int l = 0; l < MAX_LAYERS; ++l) {
    if (l < a.N) {
      a.hd[l] = cF(); a.hdp[l] = cF(); a.w_r[l] = cT(); a.b_r[l] = cF();
      a.hg[l] = cT(); a.hc[l] = cT(); a.xin[l] = oF(); a.rh[l] = oF(); a.ruc[l] = oF();
    } else {
      a.hd[l] = a.hdp[l] = nullptr; a.w_r[l] = nullptr; a.b_r[l] = nullptr;
      a.hg[l] = a.hc[l] = nullptr; a.xin[l] = a.rh[l] = nullptr;
      if (l > a.N) a.ruc[l] = nullptr;
    }
  }
}

// the weight (and memory) tensor maps: 64-column x 64-row boxes, 128-byte swizzle
bool remat_maps(RematMaps& mp, const RematArgs<bf16>& a) {
  const int H = a.H;
  auto w2d = [](CUtensorMap* m, const void* base, int cols, int rows) {
    return sm90::make_map(m, base, cols, rows, 1, 64, RT_BK, CU_TENSOR_MAP_SWIZZLE_128B);
  };
  bool ok = true;
  for (int l = 0; l < a.N; ++l) {
    ok = ok && w2d(&mp.m[MAP_W_R + l], a.w_r[l], 3 * H, H) &&
         w2d(&mp.m[MAP_HG + l], a.hg[l], 2 * H, H) && w2d(&mp.m[MAP_HC + l], a.hc[l], H, H);
  }
  ok = ok && w2d(&mp.m[MAP_W_CTX], a.w_ctx, 4 * H, a.D) && w2d(&mp.m[MAP_A_HG], a.a_hg, 2 * H, H) &&
       w2d(&mp.m[MAP_A_HC], a.a_hc, H, H) && w2d(&mp.m[MAP_WQ], a.wq, a.A, H) &&
       sm90::make_map(&mp.m[MAP_MEM], a.memory, a.D, a.L, a.B, 64, RT_BK,
                      CU_TENSOR_MAP_SWIZZLE_128B);
  return ok;
}

int launch_remat(const void* const* p, const int* d, cudaStream_t stream) {
  if (d[6] > MAX_LAYERS) return int(cudaErrorInvalidValue);
  const long long blocks = (long long)d[1] * ((d[0] + RT_BM - 1) / RT_BM);
  if (blocks <= 0 || blocks > 0x7fffffffLL) return int(cudaErrorInvalidValue);
  if (!d[7]) {
    RematArgs<float> a;
    parse_remat(p, d, a);
    teacher_bwd_remat_f32_kernel<<<unsigned(blocks), kern::TileF32::NT, 0, stream>>>(a);
    return int(cudaGetLastError());
  }
  RematArgs<bf16> a;
  parse_remat(p, d, a);
  RematMaps maps;   // copied into the launch's parameters
  memset(&maps, 0, sizeof(maps));
  if (!remat_maps(maps, a)) return int(cudaErrorInvalidValue);
  const size_t smem = remat_smem_bytes(d);
  cudaError_t err = cudaFuncSetAttribute(teacher_bwd_remat_bf16_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  teacher_bwd_remat_bf16_kernel<<<unsigned(blocks), RT_THREADS, smem, stream>>>(maps, a,
                                                                                remat_slots(d));
  return int(cudaGetLastError());
}

// ------------------------------------------------------------------- scan

template <typename T>
struct ScanArgs {
  const float* dxs; const float* dal; const float* p;  // [S,B,H], [S,B,L], [S,B,L]
  const float* hap; const float* q;                    // [S,B,H], [S,B,A]
  const T* keys; const T* memory; const T* v;
  const T* w1;    // [H, H+D]  [wd_h^T | w_ctx^T[0:H]]
  const T* wqT;   // [A, H]
  const T* a_hcT; // [H, H]
  const T* w2;    // [3H, H+D] [(a_hg^T; 0) | w_ctx^T[H:4H]]
  float* dpng; float* dpnc; float* de; float* dctx;    // [S,B,2H/H/L/D]
  float* dh0a; float* dh0d;                            // [B,H], [N,B,H]
  float* dcb; float* dq;                               // [S,B,4H/A]
  const float* ruc[MAX_LAYERS + 1];                    // [S,B,3H]
  const float* hdp[MAX_LAYERS];                        // [S,B,H]
  const T* hcT[MAX_LAYERS];                            // [H, H]
  const T* wcat[MAX_LAYERS];                           // [3H, 2H] [w_r^T | (hg^T; 0)]
  float* dgc[MAX_LAYERS];                              // [S,B,3H]
  int S, B, L, A, D, H, N;
};

__host__ __device__ __forceinline__ int up4(int n) { return (n + 3) & ~3; }

// one step's inputs in shared memory (each width rounded up to 4 floats)
struct StepBuf { float *dxs, *hap, *hdp, *ruc, *q, *p, *dal; };

__host__ __device__ __forceinline__ int step_floats(int H, int NL, int A, int L) {
  return 2 * H + NL * H + 3 * (NL + 1) * H + up4(A) + 2 * up4(L);
}

__device__ __forceinline__ StepBuf step_buf(float* base, int H, int NL, int A, int L) {
  StepBuf s;
  s.dxs = base;
  s.hap = s.dxs + H;
  s.hdp = s.hap + H;
  s.ruc = s.hdp + NL * H;
  s.q = s.ruc + 3 * (NL + 1) * H;
  s.p = s.q + up4(A);
  s.dal = s.p + up4(L);
  return s;
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(sm90::smem_u32(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(sm90::smem_u32(dst)), "l"(src)
               : "memory");
}

// n floats from global src to shared dst, 16 bytes a copy where src allows
__device__ __forceinline__ void prefetch_row(float* dst, const float* src, int n) {
  if (n % 4 == 0 && reinterpret_cast<uintptr_t>(src) % 16 == 0) {
    for (int i = threadIdx.x * 4; i < n; i += NTHREADS * 4) cp_async16(dst + i, src + i);
  } else {
    for (int i = threadIdx.x; i < n; i += NTHREADS) cp_async4(dst + i, src + i);
  }
}

template <typename T>
__device__ void prefetch_step(const ScanArgs<T>& a, const StepBuf& s, size_t row) {
  const int H = a.H, NL = a.N;
  prefetch_row(s.dxs, a.dxs + row * H, H);
  prefetch_row(s.hap, a.hap + row * H, H);
  for (int i = 0; i < NL; ++i) prefetch_row(s.hdp + i * H, a.hdp[i] + row * H, H);
  for (int g = 0; g <= NL; ++g) prefetch_row(s.ruc + g * 3 * H, a.ruc[g] + row * 3 * H, 3 * H);
  prefetch_row(s.q, a.q + row * a.A, a.A);
  prefetch_row(s.p, a.p + row * a.L, a.L);
  prefetch_row(s.dal, a.dal + row * a.L, a.L);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// A GRU's backward from its forward values r|u|c and h_prev: dg = [dg_r |
// dg_u | da_c] and drh; dht is kept in dtot.  Ends with a barrier.
template <typename T>
__device__ void gru_grads(const float* ruc, const float* hp, const T* hcT, int H, float* dtot,
                          float* dg, float* drh, float* red) {
  const int tid = threadIdx.x;
  for (int j = tid; j < H; j += NTHREADS) {
    const float u = ruc[H + j], c = ruc[2 * H + j], d = dtot[j];
    const float dc = d * (1.f - u);
    const float du = d * (hp[j] - c);
    dg[2 * H + j] = dc * (1.f - c * c);
    dg[H + j] = du * u * (1.f - u);
  }
  __syncthreads();
  matvec<T>(dg + 2 * H, hcT, H, H, drh, nullptr, false, red);
  for (int j = tid; j < H; j += NTHREADS) {
    const float r = ruc[j];
    dg[j] = drh[j] * hp[j] * r * (1.f - r);
  }
  __syncthreads();
}

template <typename T>
__global__ void __launch_bounds__(NTHREADS) teacher_bwd_scan_kernel(const ScanArgs<T> a) {
  extern __shared__ __align__(16) float smem[];
  constexpr int VEC = Vec<T>::N;
  const int b = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int B = a.B, L = a.L, A = a.A, D = a.D, H = a.H, NL = a.N;
  const int D4 = up4(D), wide = 2 * H > H + D4 ? 2 * H : H + D4;

  float* red = smem;                          // NTHREADS * VEC
  float* scratch = red + NTHREADS * VEC;      // 64
  float* dha = scratch + 64;                  // H
  float* dhd = dha + H;                       // NL * H
  float* dcb = dhd + NL * H;                  // 4H: [dx | dcbg | dcbc]
  float* dctxc = dcb + 4 * H;                 // D4: dctx's part from [dcbg | dcbc]
  float* dtot = dctxc + D4;                   // H
  float* dg = dtot + H;                       // 3H
  float* drh = dg + 3 * H;                    // H
  float* lc = drh + H;                        // H + D4: [dha_loc | dctx]
  float* tmp = lc + H + D4;                   // wide
  float* dq = tmp + wide;                     // up4(A)
  float* vv = dq + up4(A);                    // up4(A)
  float* dp = vv + up4(A);                    // up4(L) (then de)
  float* bufs = dp + up4(L);                  // two step buffers
  const int sf = step_floats(H, NL, A, L);
  float* dx = dcb;
  float* dctx = lc + H;

  for (int j = tid; j < H; j += NTHREADS) dha[j] = 0.f;
  for (int j = tid; j < NL * H; j += NTHREADS) dhd[j] = 0.f;
  for (int j = tid; j < 4 * H; j += NTHREADS) dcb[j] = 0.f;
  for (int j = tid; j < D; j += NTHREADS) dctxc[j] = 0.f;
  for (int j = tid; j < A; j += NTHREADS) vv[j] = to_f(a.v[j]);
  auto buf = [&](int k) { return step_buf(bufs + k * sf, H, NL, A, L); };
  prefetch_step(a, buf(0), size_t(a.S - 1) * B + b);

  const T* keys = a.keys + size_t(b) * L * A;
  const T* mem = a.memory + size_t(b) * L * D;
  // dq: G groups of A columns, each over its slice of L
  const int G = A <= NTHREADS ? NTHREADS / A : 1;
  const int lper = (L + G - 1) / G;

  for (int t = a.S - 1; t >= 0; --t) {
    const size_t row = size_t(t) * B + b;
    const int cur = (a.S - 1 - t) & 1;
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();
    // the next step's inputs load while this step runs (its buffer's last
    // reader was the step before, which ended with a barrier)
    if (t > 0) prefetch_step(a, buf(cur ^ 1), row - B);
    const StepBuf s = buf(cur);
    for (int j = tid; j < H; j += NTHREADS) dx[j] = s.dxs[j];
    __syncthreads();
    // ---- residual GRU stack, last layer first ------------------------------
    for (int i = NL - 1; i >= 0; --i) {
      const float* ruc = s.ruc + i * 3 * H;
      const float* hp = s.hdp + i * H;
      for (int j = tid; j < H; j += NTHREADS) dtot[j] = dx[j] + dhd[i * H + j];
      __syncthreads();
      gru_grads<T>(ruc, hp, a.hcT[i], H, dtot, dg, drh, red);
      for (int j = tid; j < 3 * H; j += NTHREADS) a.dgc[i][row * 3 * H + j] = dg[j];
      matvec<T>(dg, a.wcat[i], 3 * H, 2 * H, tmp, nullptr, false, red);
      for (int j = tid; j < H; j += NTHREADS) {
        dx[j] += tmp[j];
        dhd[i * H + j] = (dtot[j] * ruc[H + j] + drh[j] * ruc[j]) + tmp[H + j];
      }
      __syncthreads();
    }
    // ---- dec_in and the context block: [dha_loc | dctx] ---------------------
    for (int j = tid; j < 4 * H; j += NTHREADS) a.dcb[row * 4 * H + j] = dcb[j];
    matvec<T>(dx, a.w1, H, H + D, lc, nullptr, false, red);
    for (int j = tid; j < D; j += NTHREADS) {
      const float v = dctx[j] + dctxc[j];
      dctx[j] = v;
      a.dctx[row * D + j] = v;
    }
    __syncthreads();
    // ---- attention backward: dp, de (softmax), dq ---------------------------
    for (int l = warp; l < L; l += NWARPS) {
      const T* mr = mem + size_t(l) * D;
      float sum = 0.f;
      for (int d0 = lane * VEC; d0 < D; d0 += 32 * VEC) {
        float mv[VEC];
        Vec<T>::load(mr + d0, mv);
#pragma unroll
        for (int k = 0; k < VEC; ++k) sum = fmaf(rnd<T>(dctx[d0 + k]), mv[k], sum);
      }
      sum = warp_sum(sum);
      if (lane == 0) dp[l] = sum + s.dal[l];
    }
    __syncthreads();
    float sp = 0.f;
    for (int l = tid; l < L; l += NTHREADS) sp += dp[l] * s.p[l];
    sp = block_reduce<false>(sp, scratch);
    for (int l = tid; l < L; l += NTHREADS) {
      const float de = s.p[l] * (dp[l] - sp);
      dp[l] = de;
      a.de[row * L + l] = de;
    }
    __syncthreads();
    for (int idx = tid; idx < G * A; idx += NTHREADS) {
      const int c = idx % A, l0 = (idx / A) * lper;
      const int l1 = l0 + lper < L ? l0 + lper : L;
      const float qa = s.q[c], va = vv[c];
      float sum = 0.f;
      for (int l = l0; l < l1; ++l) {
        const float act = tanhf(to_f(keys[size_t(l) * A + c]) + qa);
        sum += dp[l] * va * (1.f - act * act);
      }
      red[idx] = sum;
    }
    __syncthreads();
    for (int c = tid; c < A; c += NTHREADS) {
      float sum = 0.f;
      for (int k = 0; k < G; ++k) sum += red[k * A + c];
      dq[c] = sum;
      a.dq[row * A + c] = sum;
    }
    __syncthreads();
    matvec<T>(dq, a.wqT, A, H, lc, nullptr, true, red);
    // ---- attention GRU backward ---------------------------------------------
    const float* ruc = s.ruc + NL * 3 * H;
    for (int j = tid; j < H; j += NTHREADS) dtot[j] = lc[j] + dha[j];
    __syncthreads();
    gru_grads<T>(ruc, s.hap, a.a_hcT, H, dtot, dg, drh, red);
    matvec<T>(dg, a.w2, 3 * H, H + D, tmp, nullptr, false, red);
    for (int j = tid; j < H; j += NTHREADS)
      dha[j] = (dtot[j] * ruc[H + j] + drh[j] * ruc[j]) + tmp[j];
    for (int j = tid; j < D; j += NTHREADS) dctxc[j] = tmp[H + j];
    for (int j = tid; j < 2 * H; j += NTHREADS) {
      a.dpng[row * 2 * H + j] = dg[j];
      dcb[H + j] = dg[j];
    }
    for (int j = tid; j < H; j += NTHREADS) {
      a.dpnc[row * H + j] = dg[2 * H + j];
      dcb[3 * H + j] = dg[2 * H + j];
    }
    __syncthreads();
  }
  for (int j = tid; j < H; j += NTHREADS) a.dh0a[size_t(b) * H + j] = dha[j];
  for (int j = tid; j < NL * H; j += NTHREADS) {
    const int i = j / H, c = j % H;
    a.dh0d[(size_t(i) * B + b) * H + c] = dhd[j];
  }
}

size_t scan_smem_floats(const int* d) {
  // d: S, B, L, A, D, H, N, is_bf16
  const int L = d[2], A = d[3], D = d[4], H = d[5], NL = d[6];
  const size_t vec = d[7] ? 8 : 4;
  const int D4 = up4(D), wide = 2 * H > H + D4 ? 2 * H : H + D4;
  return size_t(NTHREADS) * vec + 64 + H + size_t(NL) * H + 4 * H + D4 + H + 3 * H + H +
         (H + D4) + wide + 2 * up4(A) + up4(L) + 2 * size_t(step_floats(H, NL, A, L));
}

template <typename T>
int launch_scan(const void* const* p, const int* d, cudaStream_t stream) {
  ScanArgs<T> a;
  int i = 0;
  auto cT = [&]() { return static_cast<const T*>(p[i++]); };
  auto cF = [&]() { return static_cast<const float*>(p[i++]); };
  auto oF = [&]() { return static_cast<float*>(const_cast<void*>(p[i++])); };
  a.dxs = cF(); a.dal = cF(); a.p = cF(); a.hap = cF(); a.q = cF();
  a.keys = cT(); a.memory = cT(); a.v = cT();
  a.w1 = cT(); a.wqT = cT(); a.a_hcT = cT(); a.w2 = cT();
  a.S = d[0]; a.B = d[1]; a.L = d[2]; a.A = d[3]; a.D = d[4]; a.H = d[5]; a.N = d[6];
  if (a.N > MAX_LAYERS) return int(cudaErrorInvalidValue);
  a.ruc[a.N] = cF();
  a.dpng = oF(); a.dpnc = oF(); a.de = oF(); a.dctx = oF(); a.dh0a = oF(); a.dh0d = oF();
  a.dcb = oF(); a.dq = oF();
  for (int l = 0; l < MAX_LAYERS; ++l) {
    if (l < a.N) {
      a.ruc[l] = cF(); a.hdp[l] = cF(); a.hcT[l] = cT(); a.wcat[l] = cT(); a.dgc[l] = oF();
    } else {
      if (l > a.N) a.ruc[l] = nullptr;
      a.hdp[l] = nullptr; a.hcT[l] = a.wcat[l] = nullptr; a.dgc[l] = nullptr;
    }
  }
  const size_t smem = scan_smem_floats(d) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(teacher_bwd_scan_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         int(smem));
  if (err != cudaSuccess) return int(err);
  teacher_bwd_scan_kernel<T><<<a.B, NTHREADS, smem, stream>>>(a);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

// Bytes of shared memory the scan kernel needs for the dims d (see launch).
size_t teacher_decoder_bwd_smem_bytes(const int* d) { return scan_smem_floats(d) * sizeof(float); }

// Bytes of shared memory a remat block needs for the dims d.
size_t teacher_decoder_bwd_remat_smem_bytes(const int* d) { return remat_smem_bytes(d); }

// The carry-free prologue.  ptrs: png, pnc, ha, hap, xs, p, pp, memory,
// a_hg, a_hc, wq, w_ctx, rh_a, ctx, ctx_prev (scratch), q, ruc[N] (the
// attention GRU's), then per layer hd, hdp, w_r, b_r, hg, hc, xin, rh, ruc.
// dims: S, B, L, A, D, H, N, is_bf16.  Returns the CUDA error code.
int teacher_decoder_bwd_remat_launch(const void* const* ptrs, const int* dims, void* stream) {
  return launch_remat(ptrs, dims, static_cast<cudaStream_t>(stream));
}

// The reverse-time scan.  ptrs: dxs, dalign, p, hap, q, keys, memory, v,
// [wd_h^T | w_ctx^T[0:H]], wq^T, a_hc^T, [(a_hg^T; 0) | w_ctx^T[H:4H]],
// ruc[N], dpng, dpnc, de, dctx, dh0a, dh0d, dcb, dq, then per layer ruc,
// hdp, hc^T, [w_r^T | (hg^T; 0)], dgc.  dims as above.  Returns the CUDA
// error code.
int teacher_decoder_bwd_launch(const void* const* ptrs, const int* dims, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dims[7] ? launch_scan<__nv_bfloat16>(ptrs, dims, s) : launch_scan<float>(ptrs, dims, s);
}

}  // extern "C"
