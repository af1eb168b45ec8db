// Thread-block-cluster helpers for the per-batch-row decoder kernels
// (decoder_loop.cu, teacher_decoder_fwd.cu): one batch row's step spread
// over the C CTAs (blocks) of a cluster.
//
// Each CTA owns a slice of every product's output columns, reads only its
// slice of the weights (from L2), and writes its output slice into every
// CTA's copy of the vector through distributed shared memory (DSMEM).  One
// cluster barrier (arrive.release / wait.acquire) then makes the whole
// vector visible to all.  A phase is a group of products that read vectors
// already known (``Job``s run together by ``run_jobs``), so the number of
// cluster barriers a step takes is the number of dependent phases.
//
// Rules that keep a cluster kernel safe:
// - every thread of every CTA reaches every cluster barrier (no early
//   return; a CTA with no columns in a phase still arrives);
// - a remote write of a vector in phase p must not meet a read of that
//   vector's other slices in phase p (reads of phase p - 1 end at the
//   barrier before p; reads of phase p + 1 start after the barrier after p);
// - new values are staged locally and then broadcast, so a thread never
//   reads a value another thread of its CTA has already replaced;
// - the kernel starts with a cluster barrier (every CTA has started before
//   any remote write) and ends with one (no CTA exits while a peer may still
//   write into its shared memory).

#pragma once

#include "decoder_common.cuh"

namespace clu {

using namespace dec;

// Threads of a CTA of a cluster kernel.  The phases of decoder_loop.cu are
// bound by instruction issue more than by loads at C = 16: 384 threads were
// 4 % faster there than 512 and as fast at C = 1 and 2; 256 were slower at
// C <= 2 (a thread's rows no longer in one batch).
constexpr int CTHREADS = 384;
constexpr int CWARPS = CTHREADS / 32;

// CTA-wide reduction of one value per thread; every thread gets the result.
// ``scratch`` holds CWARPS + 1 floats.
template <bool kMax>
__device__ __forceinline__ float cta_reduce(float v, float* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = kMax ? warp_max(v) : warp_sum(v);
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  if (warp == 0) {
    float w = lane < CWARPS ? scratch[lane] : (kMax ? -INFINITY : 0.f);
    w = kMax ? warp_max(w) : warp_sum(w);
    if (lane == 0) scratch[CWARPS] = w;
  }
  __syncthreads();
  const float r = scratch[CWARPS];
  __syncthreads();
  return r;
}

__device__ __forceinline__ unsigned cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ unsigned cluster_size() {
  unsigned n;
  asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(n));
  return n;
}

// The cluster barrier in its two halves: every thread of every CTA arrives
// (releasing its shared-memory writes, local and remote) and later waits
// (acquiring everyone's).  Between the two a thread may do work that reads
// no exchanged vector, such as loading weights.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_sync() {
  cluster_arrive();
  cluster_wait();
}

// *p = v in the shared memory of cluster CTA ``rank`` (p is this CTA's
// address of the same variable).
__device__ __forceinline__ void st_remote(float* p, unsigned rank, float v) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  uint32_t ra;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(ra) : "r"(a), "r"(rank));
  asm volatile("st.shared::cluster.f32 [%0], %1;\n" ::"r"(ra), "f"(v) : "memory");
}

// dst[i] = src[i] (i < n) in every CTA of the cluster (src local, dst this
// CTA's address of the replicated vector).
__device__ __forceinline__ void broadcast(float* dst, const float* src, int n, unsigned C) {
  for (int i = threadIdx.x; i < n * int(C); i += CTHREADS) {
    const int r = i / n, j = i - r * n;
    st_remote(dst + j, unsigned(r), src[j]);
  }
}

// CTA k's share of ng items split over C: [*g0, *g0 + *n).
__host__ __device__ __forceinline__ void split(int ng, int C, int k, int* g0, int* n) {
  *g0 = int((long long)k * ng / C);
  *n = int((long long)(k + 1) * ng / C) - *g0;
}

// The kernel's dynamic shared memory.  The phase helpers address their
// vectors as float offsets into it, so that their loads and stores are
// shared-memory instructions (a pointer passed to an out-of-line function
// would be generic).
__device__ __forceinline__ float* dyn_smem() {
  extern __shared__ __align__(16) float smem_dyn[];
  return smem_dyn;
}

// One input segment of a product: sum_k round(x[k]) * W[k, col]; x is a
// float offset into the dynamic shared memory.
template <typename T>
struct Seg {
  const T* W;
  int x, K;
};

// One product slice: out[i] = sum over segments + bias[col(i)], over this
// CTA's columns of the [K, N] matrices: ng[0] 16-byte column groups from
// column c0[0], then ng[1] from c0[1] (a GRU gate matrix [., 2H]: the r
// columns of the CTA's units, then their u columns).  ``out`` and ``bias``
// (a copy of the [N] bias, or -1 for none) are float offsets into the
// dynamic shared memory; out holds (ng[0] + ng[1]) * Vec<T>::N floats.
template <typename T>
struct Job {
  Seg<T> s[3];
  int nseg, N, out, bias;
  int c0[2], ng[2];
};

// What run_jobs needs of one phase that is the same for every thread,
// computed once (make_plan): jobs[j0 .. j0 + nj) of the table, G column
// groups, kg threads a group, n_out = G * VEC outputs summed by 2^lg_tpo
// lanes each, partial rows of stride S at float offset ``red``.
struct Plan {
  int j0, nj, G, kg, n_out, lg_tpo, S, red;
  float rcp_G;               // 1/G (see quot)
};

// 16 bytes of weights: one read-only load, then 4 f32 or 8 bf16 to f32.
__device__ __forceinline__ uint4 ld16(const void* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}
template <typename T> __device__ __forceinline__ void unpack16(const uint4& r, float* w);
template <> __device__ __forceinline__ void unpack16<float>(const uint4& r, float* w) {
  w[0] = __uint_as_float(r.x); w[1] = __uint_as_float(r.y);
  w[2] = __uint_as_float(r.z); w[3] = __uint_as_float(r.w);
}
template <> __device__ __forceinline__ void unpack16<__nv_bfloat16>(const uint4& r, float* w) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    w[2 * i] = f.x;
    w[2 * i + 1] = f.y;
  }
}

// Loads a thread keeps in flight: its rows are read in batches of LOADS
// unconditional 16-byte loads (a row past the thread's last is read again
// from its first and weighted 0), so one batch waits one L2 round trip.
// At C = 16 a thread has 1-3 rows a phase and the spare loads cost issue
// slots: 2 was faster than 4 and 8 on the card at C = 16, as fast at C = 2.
constexpr int LOADS = 2;

// Floats of run_jobs' ``red``: CTHREADS partial rows of at most VEC
// columns each, every row padded by up to 31 floats (see run_jobs).
template <typename T>
__host__ __device__ constexpr int red_floats() { return CTHREADS * (Vec<T>::N + 32); }

// q / d for 0 <= q < 2^12 and 1 <= d <= CTHREADS from r = 1/d: the
// quotient's fraction is at least 1/(2d) from an integer, far beyond the
// float error of (q + 0.5) * r.
__device__ __forceinline__ int quot(int q, float r) { return int((float(q) + 0.5f) * r); }

// The plan of the phase jobs[j0 .. j0 + nj) (see Plan and run_jobs).
template <typename T>
__device__ void make_plan(Plan& p, const Job<T>* jobs, int j0, int nj, int red) {
  constexpr int VEC = Vec<T>::N;
  int G = 0;
  for (int j = j0; j < j0 + nj; ++j) G += jobs[j].ng[0] + jobs[j].ng[1];
  p.j0 = j0;
  p.nj = nj;
  p.G = G;
  p.kg = G > 0 ? CTHREADS / G : 0;
  p.n_out = G * VEC;
  int tpo = 1, lg = 0;                       // lanes that sum one output
  while (tpo < 32 && 2 * tpo * p.n_out <= CTHREADS && 2 * tpo <= p.kg) tpo *= 2, ++lg;
  p.lg_tpo = lg;
  const int W = 32 / tpo;                    // outputs a warp sums at once
  p.S = p.n_out + ((W - p.n_out % 32) % 32 + 32) % 32;
  p.red = red;
  p.rcp_G = G > 0 ? 1.f / float(G) : 0.f;
}

// Runs one phase (the Plan at float offset ``plan_at``; the job table at
// ``jobs_at``).  With ``wait`` the phase begins with the second half of a
// cluster barrier whose first half the caller has passed: each thread's
// first batch of weight loads is issued before it, so the L2 round trip
// overlaps the barrier.  Every 16-byte column group of every job is given kg =
// CTHREADS / G threads that split its K rows (all segments as one range),
// so all weight loads of the phase are in flight together.  Partial sums
// meet in ``red`` (red_floats<T>() floats) as kg rows of n_out outputs,
// output (i, g) at i * G + g, each row padded to a stride S = W (mod 32),
// so that the tpo lanes summing one output (W outputs a warp) and the
// writers (consecutive g) meet no bank conflict.  Ends with a barrier of the
// CTA.  Needs G (the column groups of the phase's jobs) <= CTHREADS and at
// most two jobs.
template <typename T>
__device__ __noinline__ void run_jobs(int jobs_at, int plan_at, bool wait) {
  constexpr int VEC = Vec<T>::N;
  float* sm = dyn_smem();
  const Plan& P = *reinterpret_cast<const Plan*>(sm + plan_at);
  const Job<T>* jobs = reinterpret_cast<const Job<T>*>(sm + jobs_at) + P.j0;
  const int G = P.G, kg = P.kg, n_out = P.n_out, S = P.S, lg_tpo = P.lg_tpo;
  if (G == 0) {                              // uniform over the CTA
    if (wait) cluster_wait();
    return;
  }
  float* red = sm + P.red;
  const int ng0 = jobs[0].ng[0] + jobs[0].ng[1];
  const int tid = threadIdx.x;
  const bool active = tid < G * kg;
  const int kk = quot(tid, P.rcp_G), g = tid - kk * G;
  // this thread's column group and its rows: the segments as one range
  // [0, K0 + K1 + K2)
  const bool second = g >= ng0;
  const Job<T>& J = jobs[second ? 1 : 0];
  const int lg = second ? g - ng0 : g;
  const int col = lg < J.ng[0] ? J.c0[0] + lg * VEC : J.c0[1] + (lg - J.ng[0]) * VEC;
  const size_t N = size_t(J.N);
  const int K0 = J.s[0].K, K1 = J.nseg > 1 ? J.s[1].K : 0, K2 = J.nseg > 2 ? J.s[2].K : 0;
  const int e0 = K0, e1 = K0 + K1, Kt = e1 + K2;
  const int x0 = J.s[0].x;
  const int x1 = K1 ? J.s[1].x - e0 : x0;
  const int x2 = K2 ? J.s[2].x - e1 : x0;
  const T* w0 = J.s[0].W + col;
  const T* w1 = K1 ? J.s[1].W + col - size_t(e0) * N : w0;
  const T* w2 = K2 ? J.s[2].W + col - size_t(e1) * N : w0;
  const int n_it = active && kk < Kt ? (Kt - 1 - kk) / kg + 1 : 0;
  float acc[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) acc[i] = 0.f;
  // a batch: LOADS unconditional loads (rows past the last read row kk
  // again), then their products with the rounded inputs (weight 0 there)
  const auto load = [&](int it, uint4* raw) {
#pragma unroll
    for (int u = 0; u < LOADS; ++u) {
      const int v = it + u < n_it ? kk + (it + u) * kg : kk;
      raw[u] = ld16((v < e0 ? w0 : v < e1 ? w1 : w2) + size_t(v) * N);
    }
  };
  const auto madd = [&](int it, const uint4* raw) {
#pragma unroll
    for (int u = 0; u < LOADS; ++u) {
      const int v = kk + (it + u) * kg;
      const float xk = it + u < n_it ? rnd<T>(sm[(v < e0 ? x0 : v < e1 ? x1 : x2) + v]) : 0.f;
      float w[VEC];
      unpack16<T>(raw[u], w);
#pragma unroll
      for (int i = 0; i < VEC; ++i) acc[i] = fmaf(xk, w[i], acc[i]);
    }
  };
  uint4 first[LOADS];
  if (n_it > 0) load(0, first);
  if (wait) cluster_wait();
  if (n_it > 0) madd(0, first);
  for (int it = LOADS; it < n_it; it += LOADS) {
    uint4 raw[LOADS];
    load(it, raw);
    madd(it, raw);
  }
  if (active) {
    float* r = red + kk * S + g;
#pragma unroll
    for (int i = 0; i < VEC; ++i) r[i * G] = acc[i];
  }
  __syncthreads();
  const int tpo = 1 << lg_tpo, W = 32 >> lg_tpo;
  const int span = (n_out + W - 1) / W * 32;
  for (int base = 0; base < span; base += CTHREADS) {   // same trip count for all
    const int idx = base + tid, lane = idx & 31;
    const int o = (idx >> 5) * W + (lane & (W - 1)), sub = lane >> (5 - lg_tpo);
    float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
    if (o < n_out) {
      int kk = sub;
      for (; kk + 3 * tpo < kg; kk += 4 * tpo) {        // four loads in flight
        s0 += red[kk * S + o];
        s1 += red[(kk + tpo) * S + o];
        s2 += red[(kk + 2 * tpo) * S + o];
        s3 += red[(kk + 3 * tpo) * S + o];
      }
      for (; kk < kg; kk += tpo) s0 += red[kk * S + o];
    }
    float s = (s0 + s1) + (s2 + s3);
    for (int off = 16; off >= W; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
    if (o < n_out && sub == 0) {
      const int i = quot(o, P.rcp_G), g = o - i * G;
      const bool second = g >= ng0;
      const Job<T>& J = jobs[second ? 1 : 0];
      const int lg = second ? g - ng0 : g;
      const int col = (lg < J.ng[0] ? J.c0[0] + lg * VEC : J.c0[1] + (lg - J.ng[0]) * VEC) + i;
      sm[J.out + lg * VEC + i] = J.bias >= 0 ? s + sm[J.bias + col] : s;
    }
  }
  __syncthreads();
}

// A job's head, its segments added by add_seg: bias (-1: none), out and each
// segment's x are float offsets into the dynamic shared memory.
template <typename T>
__device__ void set_job(Job<T>& j, int N, int c0, int ng, int c1, int ng1, int bias,
                        int out) {
  j.nseg = 0;
  j.N = N;
  j.c0[0] = c0; j.ng[0] = ng;
  j.c0[1] = c1; j.ng[1] = ng1;
  j.bias = bias;
  j.out = out;
}

template <typename T>
__device__ void add_seg(Job<T>& j, int x, const T* W, int K) {
  j.s[j.nseg].x = x;
  j.s[j.nseg].W = W;
  j.s[j.nseg].K = K;
  ++j.nseg;
}

// Each position's energy over this CTA's A columns [a0, a0 + na):
// out[l] = sum_a tanh(keys[l, a] + q[a - a0]) * vv[a] (f32; 0 when na = 0).
// tpl lanes share a position.  q, vv, out: float offsets into the dynamic
// shared memory.  Ends with a barrier of the CTA.
template <typename T>
__device__ __noinline__ void energy_partials(const T* __restrict__ keys, int q_at, int vv_at,
                                             int a0, int na, int L, int A, int out_at) {
  constexpr int VEC = Vec<T>::N;
  float* sm = dyn_smem();
  const float* q = sm + q_at;
  const float* vv = sm + vv_at;
  float* out = sm + out_at;
  const int tid = threadIdx.x, nag = na / VEC;
  int tpl = 1;
  while (tpl < 32 && 2 * tpl * L <= CTHREADS) tpl *= 2;
  const int span = L * tpl;
  for (int base = 0; base < span; base += CTHREADS) {   // same trip count for all
    const int idx = base + tid, l = idx / tpl, sub = idx % tpl;
    const int n_it = l < L && sub < nag ? (nag - 1 - sub) / tpl + 1 : 0;
    const T* kr = keys + size_t(l < L ? l : 0) * A + a0;
    float s = 0.f;
    for (int it = 0; it < n_it; it += 4) {        // four 16-byte loads in flight
      uint4 raw[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) raw[u] = ld16(kr + (sub + (it + u < n_it ? it + u : 0) * tpl) * VEC);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (it + u < n_it) {
          const int c = (sub + (it + u) * tpl) * VEC;
          float kv[VEC];
          unpack16<T>(raw[u], kv);
#pragma unroll
          for (int i = 0; i < VEC; ++i) s = fmaf(tanhf(kv[i] + q[c + i]), vv[a0 + c + i], s);
        }
      }
    }
    for (int off = tpl >> 1; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
    if (l < L && sub == 0) out[l] = s;
  }
  __syncthreads();
}

// e[l] = the C partial energies summed (in rank order, so every CTA gets the
// same value), -1e9 where the mask is 0; then the masked softmax in place,
// e[l] = exp(e[l] - max) * mask / max(sum, 1e-9); positions [l0, l0 + nl)
// also go to ``align``.  epart, mk, e, scratch: float offsets into the
// dynamic shared memory.  Ends with a barrier of the CTA.
__device__ __noinline__ void cluster_softmax(int epart_at, int mk_at, int L, int C, int e_at,
                                             float* __restrict__ align, int l0, int nl,
                                             int scratch_at) {
  float* sm = dyn_smem();
  const float* epart = sm + epart_at;
  const float* mk = sm + mk_at;
  float* e = sm + e_at;
  float* scratch = sm + scratch_at;
  const int tid = threadIdx.x;
  float m = -INFINITY;
  for (int l = tid; l < L; l += CTHREADS) {
    float s = 0.f;
    for (int r = 0; r < C; ++r) s += epart[r * L + l];
    s = mk[l] != 0.f ? s : -1e9f;
    e[l] = s;
    m = fmaxf(m, s);
  }
  m = cta_reduce<true>(m, scratch);
  float s = 0.f;
  for (int l = tid; l < L; l += CTHREADS) {
    const float p = mk[l] != 0.f ? expf(e[l] - m) : 0.f;
    e[l] = p;
    s += p;
  }
  s = fmaxf(cta_reduce<false>(s, scratch), 1e-9f);
  for (int l = tid; l < L; l += CTHREADS) {
    const float p = e[l] / s;
    e[l] = p;
    if (l >= l0 && l < l0 + nl) align[l] = p;
  }
  __syncthreads();
}

// 16 bytes from global to this CTA's shared memory without passing through
// registers (cp.async): the copy runs while the thread goes on; a later
// cp_async_wait_all (then a barrier of the CTA, for the other threads) makes
// it visible.  Both addresses 16-byte aligned.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

}  // namespace clu
