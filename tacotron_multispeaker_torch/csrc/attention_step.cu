// One additive-attention step for Hopper (sm_90a): the normalised step
// (kernel 9) and the per-shard partial of the distributed softmax (kernel 10),
// one cluster kernel with two uses.
//
// Kernel 9 replaces tacotron_multispeaker_tpu/ops/attention_step.py
// attention_step_pallas, with its rounding: in the compute type T (bf16 or
// f32)
//   act[l, a] = tanh((keys[l, a] + q[a]) + loc[l, a])   (each step rounded to T)
//   e[l]      = sum_a act[l, a] * v[a]                  (f32)
//   p         = masked softmax of e (-1e9 at masked l, exp(e - max) * mask,
//               the sum floored at 1e-9), f32, written as the alignments
//   ctx[d]    = sum_l round_T(p[l]) * memory[l, d]      (f32)
// keys/loc [B, L, A], q [B, A], v [A], memory [B, L, D] in T, mask [B, L]
// bool; ctx [B, D] and align [B, L] f32.  Without a location term the loc
// add is compiled out (template flag), so no zero [B, L, A] tensor is read.
//
// Kernel 10 replaces attention_step_partial (the per-shard half of
// ops/sharded_attention.py): no location term and no normalisation; it
// writes
//   p_u[l] = exp(e[l] - m) * mask[l]    (the unnormalised weights, f32)
//   m      = max_l e[l]                 (-1e9 when the shard is fully masked)
//   s      = sum_l p_u[l]
//   ctx_u  = sum_l round_T(p_u[l]) * memory[l, :]   (f32)
// A fully masked shard (a row whose text ends in an earlier shard) gives
// exactly m = -1e9, s = 0, p_u = 0 and ctx_u = 0, which the combine across
// shards relies on (its scale exp(-1e9 - m) is 0).
//
// Bound on this card: the bytes of keys, location term and memory, each
// read once (kernel 9 at B=32 L=192 A=256 D=320 bf16: ~10 MB, 3 us at
// 3.35 TB/s); at the serving shapes a launch takes longer than that, held
// by its dependent round trips and cluster exchanges (chip_smoke.py's
// latency bound).
//
// Design: one batch row on a thread-block cluster of C CTAs (C in 1, 2, 4,
// 8, 16, at most L; the wrapper picks it from the card's co-resident cluster
// counts, this file only checks it), split along L: CTA k takes positions
// [l0, l0 + nl) = clu::split(L, C, k).
// 1. Its slabs of keys, location term and memory (contiguous ranges of the
//    [B, L, X] rows) are requested at once at kernel start as 1-D bulk
//    copies (cp.async.bulk) into shared memory, each slab in NCHUNK pieces,
//    each piece issued by a warp of its own against an mbarrier of its own
//    (one thread's bulk copies issue one after another), so that the
//    energies start when the first piece of keys lands and the memory
//    arrives while they are computed.  q and v are loaded meanwhile.
// 2. Energies: a warp takes a position, each lane 16 bytes (8 bf16 or 4
//    f32) of a row at a time from shared memory.  Masked positions are
//    skipped: their energy is -1e9 whatever their keys hold.
// 3. Softmax: warp 0 of each CTA forms its local max m_k and s_k = sum
//    exp(e - m_k) * mask and stores (m_k, s_k) into every CTA's shared
//    memory (DSMEM) by st.async, which also completes bytes of the
//    receiver's mbarrier (armed at kernel start with the bytes it will
//    receive, before the one cluster barrier, at the start, that every CTA
//    passes before its first remote store); each CTA waits on its own
//    mbarrier (at C = 1, warp 0 stores into its own CTA and a CTA barrier
//    passes it on), then forms the row's m = max_k m_k and s = sum_k s_k
//    exp(m_k - m), a butterfly sum over the ranks in a warp's lanes (a
//    fixed order: the same value in every CTA, whatever the timing), and
//    p = exp(e - m) * mask (/ max(s, 1e-9) for kernel 9), written over the
//    energies.  A fully masked chunk gives m_k = -1e9, s_k = 0 and adds
//    nothing; a fully masked row gives m = -1e9 and s = 0 exactly.
// 4. Context, a reduce-scatter over the cluster: each CTA sums round_T(p) *
//    memory over its positions for all D columns (threads over positions
//    and 16-byte column groups), and stores each column's partial by
//    st.async into the CTA that owns the column (clu::split(D, C, r); row k
//    of its [C, ceil(D/C)] receive buffer, against its second mbarrier);
//    once its mbarrier has counted every partial, each CTA sums its
//    columns' C partials in rank order and writes them.  Nothing reaches a
//    CTA's shared memory after that, so it may exit.
// Memory rows of masked positions are still read and multiplied by 0, as
// the plain version does (a non-finite padding shows).
//
// Two routes, one template flag (STAGED), picked by the wrapper from the
// shape: the staged route above needs rows of keys and memory that are
// 16-byte multiples (A and D times the element size), 16-byte aligned
// tensors, and a CTA's slabs within shared memory; the direct route takes
// every other shape with the same cluster split, softmax and reduction, but
// reads keys, location term and memory element by element from device
// memory (the first design's loads).  At C = 1 the direct route needs only
// (2A + L) floats of shared memory: every shape the first design took.
//
// Shared memory of a CTA (bytes, 16-byte aligned pieces; layout() below,
// mirrored by ops/attention_step.py smem_bytes): mbarriers (the slabs' when
// staged, the exchanges' when C > 1), q and v [A] f32, the energies
// [ceil(L/C)] f32, the exchanged (m_k, s_k) [2 * 16] (C > 1; at C = 1 in
// q's place) and the context's receive buffer [C, ceil(D/C)] (C > 1), then (staged) the context's
// per-slice rows [R, D] f32 and the slabs.

#include "cluster_common.cuh"
#include "sm90_common.cuh"

namespace {

using clu::cluster_arrive;
using clu::cluster_rank;
using clu::cluster_wait;
using kern::rnd;
using kern::to_f;

constexpr int NT = 256;            // threads of a CTA
constexpr int NW = NT / 32;
constexpr int MAX_C = 16;
constexpr int NCHUNK = 4;          // pieces of each slab, one mbarrier and one warp each
static_assert(2 * NCHUNK <= NW, "a warp issues each piece's copies");
constexpr int SMEM_LIMIT = 232448;

struct Layout {
  size_t bars, xbars, q, v, e, slots, part, cred, keys, loc, mem, total;
};

// Position slices of the staged context: NT / G threads for each of the
// G = D * esize / 16 column groups of a memory row, at least one.
__host__ __device__ inline int ctx_slices(int D, int esize) {
  const int G = D * esize / 16;
  return G >= NT ? 1 : NT / G;
}

__host__ __device__ inline Layout layout(int L, int A, int D, int C, int esize, bool loc,
                                         bool staged) {
  const size_t nl = size_t((L + C - 1) / C);
  Layout s;
  size_t o = 0;
  s.bars = o;
  o += staged ? 8 * 2 * NCHUNK : 0;
  s.xbars = o;
  o += C > 1 ? 8 * 2 : 0;
  o = kern::align16(o);
  s.q = o;
  o += 4 * size_t(A);
  s.v = o;
  o += 4 * size_t(A);
  s.e = o;
  o += 4 * nl;
  // at C = 1 the (m, s) slot is q's first two floats (q and v are read no
  // more once the energies are summed): the first design's shared memory
  s.slots = C > 1 ? o : s.q;
  o += C > 1 ? 4 * 2 * MAX_C : 0;
  s.part = o;
  o += C > 1 ? 4 * size_t(C) * ((D + C - 1) / C) : 0;
  s.cred = s.keys = s.loc = s.mem = o;
  if (staged) {
    o = kern::align16(o);
    s.cred = o;
    o += 4 * size_t(ctx_slices(D, esize)) * D;
    o = kern::align16(o);
    s.keys = o;
    o += nl * A * esize;
    s.loc = o;
    o += loc ? nl * A * esize : 0;
    s.mem = o;
    o += nl * D * esize;
  }
  s.total = o;
  return s;
}

struct Args {
  const void* keys;
  const void* q;
  const void* v;
  const void* mem;
  const uint8_t* mask;
  const void* loc;
  float* ctx;
  float* align;
  float* mout;
  float* sout;
  int L, A, D;
};

// v into the shared memory of cluster CTA ``rank`` at p (this CTA's address
// of the same variable), completing 4 bytes of the transaction count of that
// CTA's mbarrier at bar (st.async: the store and its signal travel together;
// the receiver waits on its own mbarrier, no cluster barrier)
__device__ __forceinline__ void st_async(float* p, uint64_t* bar, unsigned rank, float v) {
  uint32_t ra, rb;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(ra) : "r"(sm90::smem_u32(p)), "r"(rank));
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(rb) : "r"(sm90::smem_u32(bar)), "r"(rank));
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, [%2];\n"
               ::"r"(ra), "r"(__float_as_uint(v)), "r"(rb) : "memory");
}

__device__ __forceinline__ uint4 lds16(const void* p) {
  return *reinterpret_cast<const uint4*>(p);
}

// The chunk of position j of n positions split in nch pieces (clu::split).
__device__ __forceinline__ int chunk_of(int j, int n, int nch) {
  return ((j + 1) * nch - 1) / n;
}

template <typename T, bool LOC, bool PARTIAL, bool STAGED>
__global__ void __launch_bounds__(NT) attention_step_kernel(Args a) {
  constexpr int VEC = dec::Vec<T>::N;      // elements of 16 bytes
  extern __shared__ __align__(16) unsigned char smem[];
  const int L = a.L, A = a.A, D = a.D;
  const unsigned C = clu::cluster_size(), k = cluster_rank();
  const int b = blockIdx.x / int(C);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int l0, nl;
  clu::split(L, int(C), int(k), &l0, &nl);
  const Layout lay = layout(L, A, D, int(C), int(sizeof(T)), LOC, STAGED);
  float* qs = reinterpret_cast<float*>(smem + lay.q);
  float* vs = reinterpret_cast<float*>(smem + lay.v);
  float* e = reinterpret_cast<float*>(smem + lay.e);
  float* slots = reinterpret_cast<float*>(smem + lay.slots);
  float* part = reinterpret_cast<float*>(smem + lay.part);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + lay.bars);
  // the two exchanges' mbarriers: (m_k, s_k) from every CTA, and the
  // context partials of this CTA's columns from every CTA
  uint64_t* xbars = reinterpret_cast<uint64_t*>(smem + lay.xbars);
  const int W = (D + int(C) - 1) / int(C);
  int d0, nd;
  clu::split(D, int(C), int(k), &d0, &nd);
  const T* keys_s = reinterpret_cast<const T*>(smem + lay.keys);
  const T* loc_s = reinterpret_cast<const T*>(smem + lay.loc);
  const T* mem_s = reinterpret_cast<const T*>(smem + lay.mem);
  const size_t row0 = size_t(b) * L + l0;     // this CTA's first position of the batch
  const T* keys_g = static_cast<const T*>(a.keys) + row0 * A;
  const T* loc_g = LOC ? static_cast<const T*>(a.loc) + row0 * A : nullptr;
  const T* mem_g = static_cast<const T*>(a.mem) + row0 * D;
  const uint8_t* mrow = a.mask + row0;
  const int nch = nl < NCHUNK ? nl : NCHUNK;

  // the start barrier's first half: this CTA has started and armed its
  // exchange mbarriers with the bytes it will receive (its peers wait for
  // it before their first remote store)
  if (C > 1 && tid == 0) {
    sm90::mbar_init(xbars, 1);
    sm90::mbar_init(xbars + 1, 1);
    sm90::fence_barrier_init();
    sm90::mbar_expect_tx(xbars, 8 * C);
    sm90::mbar_expect_tx(xbars + 1, 4 * C * uint32_t(nd));
  }
  __syncwarp();
  if (C > 1) cluster_arrive();
  // the mask of positions lane and tid (the first a warp and a thread
  // reads below), q and v to shared memory (f32): their loads are in
  // flight while the bulk copies are issued
  const bool mlane = lane < nl && mrow[lane];
  const bool mtid = tid < nl && mrow[tid];
  const T* qg = static_cast<const T*>(a.q) + size_t(b) * A;
  const T* vg = static_cast<const T*>(a.v);
  for (int i = tid; i < A; i += NT) {
    qs[i] = to_f(qg[i]);
    vs[i] = to_f(vg[i]);
  }
  // 1. every slab in flight at once (staged route): lane 0 of warp c < nch
  // copies piece c of the keys (and location term), lane 0 of warp
  // NCHUNK + c piece c of the memory, each against an mbarrier of its own
  // (a thread issues its bulk copies one after another: spread over warps
  // they start together)
  if constexpr (STAGED) {
    const int c = warp % NCHUNK;
    if (lane == 0 && warp < 2 * NCHUNK && c < nch) {
      const bool mem_piece = warp >= NCHUNK;
      const size_t row = size_t(mem_piece ? D : A) * sizeof(T);
      int j0, nj;
      clu::split(nl, nch, c, &j0, &nj);
      const uint32_t bytes = uint32_t(nj * row);
      uint64_t* bar = bars + warp;
      sm90::mbar_init(bar, 1);
      sm90::fence_barrier_init();
      if (mem_piece) {
        sm90::mbar_expect_tx(bar, bytes);
        sm90::bulk_load(smem + lay.mem + j0 * row, mem_g + size_t(j0) * D, bytes, bar);
      } else {
        sm90::mbar_expect_tx(bar, LOC ? 2 * bytes : bytes);
        sm90::bulk_load(smem + lay.keys + j0 * row, keys_g + size_t(j0) * A, bytes, bar);
        if constexpr (LOC)
          sm90::bulk_load(smem + lay.loc + j0 * row, loc_g + size_t(j0) * A, bytes, bar);
      }
    }
  }
  __syncthreads();

  // 2. energies of this CTA's positions, a warp a position
  for (int j = warp; j < nl; j += NW) {
    if (!(j < 32 ? __shfl_sync(0xffffffffu, int(mlane), j) : mrow[j])) {  // uniform
      if (lane == 0) e[j] = -1e9f;
      continue;
    }
    float s = 0.f;
    if constexpr (STAGED) {
      sm90::mbar_wait(bars + chunk_of(j, nl, nch), 0);
      const T* kr = keys_s + size_t(j) * A;
      const T* lr = loc_s + size_t(j) * A;
      for (int g = lane; g < A / VEC; g += 32) {
        float kv[VEC], lv[VEC], qv[VEC], vv[VEC];
        clu::unpack16<T>(lds16(kr + g * VEC), kv);
        if constexpr (LOC) clu::unpack16<T>(lds16(lr + g * VEC), lv);
#pragma unroll
        for (int i = 0; i < VEC; i += 4) {
          *reinterpret_cast<float4*>(qv + i) = *reinterpret_cast<const float4*>(qs + g * VEC + i);
          *reinterpret_cast<float4*>(vv + i) = *reinterpret_cast<const float4*>(vs + g * VEC + i);
        }
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          float x = rnd<T>(kv[i] + qv[i]);
          if constexpr (LOC) x = rnd<T>(x + lv[i]);
          s = fmaf(rnd<T>(tanhf(x)), vv[i], s);
        }
      }
    } else {
      const T* kr = keys_g + size_t(j) * A;
      const T* lr = loc_g + size_t(j) * A;
      for (int i = lane; i < A; i += 32) {
        float x = rnd<T>(to_f(kr[i]) + qs[i]);
        if constexpr (LOC) x = rnd<T>(x + to_f(lr[i]));
        s = fmaf(rnd<T>(tanhf(x)), vs[i], s);
      }
    }
    s = kern::warp_sum(s);
    if (lane == 0) e[j] = s;
  }
  __syncthreads();

  // 3. the softmax: warp 0 alone forms the local (m_k, s_k) and stores it
  // into rank k's slot of every CTA (its own CTA's at C = 1); the other
  // warps read no energy until the slots are full, so the p loop below may
  // overwrite the energies.  Lane r then holds rank r's (m_r, s_r): the
  // row's m is their warp max, s the butterfly sum of s_r exp(m_r - m) over
  // the lanes (a fixed order: the same value in every lane, warp and CTA;
  // at C = 1, m_0 and s_0 exactly)
  if (warp == 0) {
    float m = -INFINITY;
    for (int j = lane; j < nl; j += 32) m = fmaxf(m, e[j]);
    m = dec::warp_max(m);
    float s = 0.f;
    for (int j = lane; j < nl; j += 32) s += (j < 32 ? mlane : mrow[j]) ? expf(e[j] - m) : 0.f;
    s = kern::warp_sum(s);
    if (C > 1) {
      cluster_wait();                     // every peer has started
      if (lane < int(C)) {
        st_async(slots + 2 * k, xbars, unsigned(lane), m);
        st_async(slots + 2 * k + 1, xbars, unsigned(lane), s);
      }
    } else if (lane == 0) {
      slots[0] = m;
      slots[1] = s;
    }
  } else if (C > 1) {
    cluster_wait();
  }
  if (C > 1)
    sm90::mbar_wait(xbars, 0);            // every CTA's (m_k, s_k) is here, this one's too
  else
    __syncthreads();
  const float mr = lane < int(C) ? slots[2 * lane] : -INFINITY;
  const float sr = lane < int(C) ? slots[2 * lane + 1] : 0.f;
  const float m = dec::warp_max(mr);
  const float s = kern::warp_sum(lane < int(C) ? sr * expf(mr - m) : 0.f);
  const float den = fmaxf(s, 1e-9f);
  float* arow = a.align + row0;
  for (int j = tid; j < nl; j += NT) {
    float p = (j == tid ? mtid : mrow[j]) ? expf(e[j] - m) : 0.f;
    if constexpr (!PARTIAL) p = p / den;
    e[j] = p;
    arow[j] = p;
  }
  if constexpr (PARTIAL) {
    if (k == 0 && tid == 0) {
      a.mout[b] = m;
      a.sout[b] = s;
    }
  }
  if constexpr (STAGED) {
    // the memory slab, and every piece of the keys (a piece of masked
    // positions only was not waited for: no copy may outlive the CTA),
    // one thread a piece; the barrier below passes them on
    if (tid < 2 * NCHUNK && tid % NCHUNK < nch) sm90::mbar_wait(bars + tid, 0);
  }
  __syncthreads();

  // 4. the context: this CTA's positions for every column, each column's
  // sum stored straight into the part of the CTA that owns the column
  // (clu::split(D, C, r); row k of its [C, W] receive buffer)
  const auto put = [&](int d, float c) {
    if (C == 1) {
      a.ctx[size_t(b) * D + d] = c;
      return;
    }
    const int owner = ((d + 1) * int(C) - 1) / D;
    st_async(part + int(k) * W + (d - owner * D / int(C)), xbars + 1, unsigned(owner), c);
  };
  if constexpr (STAGED) {
    float* cred = reinterpret_cast<float*>(smem + lay.cred);
    const int G = D / VEC, R = ctx_slices(D, int(sizeof(T)));
    for (int t = tid; t < R * G; t += NT) {
      const int r = t / G, g = t - r * G;
      float acc[VEC];
#pragma unroll
      for (int i = 0; i < VEC; ++i) acc[i] = 0.f;
      for (int j = r; j < nl; j += R) {
        const float p = rnd<T>(e[j]);
        float w[VEC];
        clu::unpack16<T>(lds16(mem_s + size_t(j) * D + g * VEC), w);
#pragma unroll
        for (int i = 0; i < VEC; ++i) acc[i] = fmaf(p, w[i], acc[i]);
      }
#pragma unroll
      for (int i = 0; i < VEC; i += 4)
        *reinterpret_cast<float4*>(cred + size_t(r) * D + g * VEC + i) =
            make_float4(acc[i], acc[i + 1], acc[i + 2], acc[i + 3]);
    }
    __syncthreads();
    for (int d = tid; d < D; d += NT) {
      float c = 0.f;
      for (int r = 0; r < R; ++r) c += cred[size_t(r) * D + d];
      put(d, c);
    }
  } else {
    for (int d = tid; d < D; d += NT) {
      float c = 0.f;
      for (int j = 0; j < nl; ++j) c = fmaf(rnd<T>(e[j]), to_f(mem_g[size_t(j) * D + d]), c);
      put(d, c);
    }
  }
  if (C > 1) {
    // every partial of this CTA's columns has arrived (no peer writes here
    // after that, so the CTA may exit once it has summed them)
    sm90::mbar_wait(xbars + 1, 0);
    float* crow = a.ctx + size_t(b) * D + d0;
    for (int i = tid; i < nd; i += NT) {
      float pr[MAX_C];
#pragma unroll
      for (int r = 0; r < MAX_C; ++r) pr[r] = r < int(C) ? part[r * W + i] : 0.f;
      float c = 0.f;
#pragma unroll
      for (int r = 0; r < MAX_C; ++r)
        if (r < int(C)) c += pr[r];
      crow[i] = c;
    }
  }
}

using Kernel = void (*)(Args);

template <typename T, bool STAGED>
Kernel pick(bool loc, bool partial) {
  if (partial) return attention_step_kernel<T, false, true, STAGED>;
  return loc ? attention_step_kernel<T, true, false, STAGED>
             : attention_step_kernel<T, false, false, STAGED>;
}

// dims: B, L, A, D, C, is_bf16, has_loc, partial, staged
struct Dims {
  int B, L, A, D, C, bf16, loc, partial, staged;
};

Dims read_dims(const int* d) {
  return Dims{d[0], d[1], d[2], d[3], d[4], d[5], d[6], d[7], d[8]};
}

size_t smem_of(const Dims& d) {
  return layout(d.L, d.A, d.D, d.C, d.bf16 ? 2 : 4, d.loc != 0, d.staged != 0).total;
}

// The launch's checks (the wrapper picks C and the route; this only refuses
// what the kernel cannot take) and its configuration.
cudaError_t prepare(const Dims& d, Kernel* fn, cudaLaunchConfig_t* cfg,
                    cudaLaunchAttribute* attr, cudaStream_t stream) {
  const int esize = d.bf16 ? 2 : 4;
  const bool pow2 = d.C == 1 || d.C == 2 || d.C == 4 || d.C == 8 || d.C == 16;
  if (!pow2 || d.C > d.L || d.L < 1 || d.A < 1 || d.D < 1 || (d.partial && d.loc))
    return cudaErrorInvalidValue;
  if (d.staged && ((d.A * esize) % 16 || (d.D * esize) % 16)) return cudaErrorInvalidValue;
  const size_t smem = smem_of(d);
  if (smem > size_t(SMEM_LIMIT)) return cudaErrorInvalidValue;
  *fn = d.bf16 ? (d.staged ? pick<__nv_bfloat16, true>(d.loc, d.partial)
                           : pick<__nv_bfloat16, false>(d.loc, d.partial))
               : (d.staged ? pick<float, true>(d.loc, d.partial)
                           : pick<float, false>(d.loc, d.partial));
  cudaError_t err =
      cudaFuncSetAttribute(*fn, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  if (d.C > 8) {
    err = cudaFuncSetAttribute(*fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
  }
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(unsigned(d.B > 0 ? d.B : 1) * unsigned(d.C), 1, 1);
  cfg->blockDim = dim3(NT, 1, 1);
  cfg->dynamicSmemBytes = smem;
  cfg->stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = unsigned(d.C);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaSuccess;
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

extern "C" {

// ptrs: keys, q, v, memory (compute type), mask (bool bytes), loc (compute
// type, or null), ctx [B, D] and align [B, L] (f32), m and s [B] (f32,
// kernel 10; else null).  dims: B, L, A, D, C (cluster size), is_bf16,
// has_loc, partial (kernel 10), staged (the bulk-copy route).  Returns the
// CUDA error code of the launch (cudaErrorInvalidValue for a C or route the
// kernel does not take).
int attention_step_launch(const void* const* ptrs, const int* dims, void* stream) {
  const Dims d = read_dims(dims);
  if (d.B <= 0) return 0;
  if (d.staged && !(aligned16(ptrs[0]) && aligned16(ptrs[3]) && (!d.loc || aligned16(ptrs[5]))))
    return int(cudaErrorInvalidValue);
  if (d.loc != (ptrs[5] != nullptr)) return int(cudaErrorInvalidValue);
  Kernel fn;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  cudaError_t err = prepare(d, &fn, &cfg, attr, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return int(err);
  Args a;
  a.keys = ptrs[0];
  a.q = ptrs[1];
  a.v = ptrs[2];
  a.mem = ptrs[3];
  a.mask = static_cast<const uint8_t*>(ptrs[4]);
  a.loc = ptrs[5];
  a.ctx = static_cast<float*>(const_cast<void*>(ptrs[6]));
  a.align = static_cast<float*>(const_cast<void*>(ptrs[7]));
  a.mout = static_cast<float*>(const_cast<void*>(ptrs[8]));
  a.sout = static_cast<float*>(const_cast<void*>(ptrs[9]));
  a.L = d.L;
  a.A = d.A;
  a.D = d.D;
  err = cudaLaunchKernelEx(&cfg, fn, a);
  if (err != cudaSuccess) return int(err);
  return int(cudaGetLastError());
}

// Clusters of dims' C CTAs the card holds at once for the kernel at dims
// (cudaOccupancyMaxActiveClusters).
int attention_step_max_clusters(const int* dims, int* out) {
  const Dims d = read_dims(dims);
  Kernel fn;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  *out = 0;
  cudaError_t err = prepare(d, &fn, &cfg, attr, nullptr);
  if (err != cudaSuccess) return int(err);
  return int(cudaOccupancyMaxActiveClusters(out, fn, &cfg));
}

// Dynamic shared memory of one CTA at dims (the Python mirror's check).
long long attention_step_smem_bytes(const int* dims) {
  return (long long)smem_of(read_dims(dims));
}

}  // extern "C"
