// The teacher-forced decoder scan, forward, in one launch for Hopper (sm_90a).
//
// Replaces: tacotron_multispeaker_tpu/ops/teacher_decoder.py
// _teacher_decoder_fwd_pallas (Tacotron.teacher_mel in the train step).
//
// Per step t, for one batch row (same math as teacher_decoder_fwd_reference
// in ops/teacher_decoder.py):
//   attention GRU with input sums png[t] + cb[H:3H], pnc[t] + cb[3H:4H]
//   (cb = the previous step's context block, zero at t = 0)
//   -> Bahdanau attention: q = ha @ wq, e_l = sum_a tanh(keys_la + q_a) v_a
//      (f32), masked softmax, ctx = p @ memory
//   -> cb = ctx @ w_ctx ([dec_in ctx | attn xg ctx | attn xc ctx], 4H)
//   -> x = ha @ wd_h + cb[:H] + d_b -> residual GRU stack (x += h_i)
// Streams out xs[t] = x, align[t] = p and the states the backward
// rematerialises from, ha[t] and hd_i[t] (all f32).  Every product rounds its
// input vector and reads its weights in the compute type T (bf16 or f32),
// sums in f32; the carries stay f32.  The initial states are rounded to T,
// as the Pallas kernel receives them.
//
// Design: decoder_loop.cu's partition on its helpers
// (cluster_common.cuh): one thread-block cluster of C CTAs (CTHREADS threads
// each) runs one batch row through all S steps; the wrapper picks C (the
// largest of 16, 8, 4, 2 whose B clusters the card holds at once, else 1).
// CTA k owns a slice of the H hidden units of the attention GRU and of every
// decoder layer (their r, u and candidate columns, the matching columns of
// each H block of w_ctx and of wd_h), of the A columns of wq and the
// energies, of the D columns of the context and of the L positions of the
// align row.  It reads only its slice of the weights (from L2, where they
// stay resident) and writes its slices of ha[t], hd_i[t], xs[t] and align[t]
// straight to global memory; each vector the other CTAs read goes into
// every CTA's copy through distributed shared memory, then the cluster
// meets at one barrier.  cb's attention columns stay with the CTA that
// owns those units, so cb is never exchanged.  A step takes 5 + 2N cluster
// barriers (9 at two layers; kernel 5 takes 12):
//   1 attention-GRU gates, png[t] + cb + round(h_a) @ a_hg (own units);
//   2 its candidate, pnc[t] + cb + round(r*h_a) @ a_hc -> new h_a;
//   3 q = round(h_a) @ wq (own A columns) with each position's partial
//     energy over them, and x_pre = round(h_a) @ wd_h (own H columns);
//   4 the C partial energies summed in rank order (every CTA the same bits),
//     masked softmax in every CTA, the context's own D columns;
//   5 cb = round(ctx) @ w_ctx (own columns of the four H blocks), x = x_pre
//     + cb[:H] + d_b;
//   per layer: gates with the candidate's x-side (round(x) @ w_r + b_r and
//   round(h_i) @ hg); the candidate -> h_i, x += h_i.
// A phase's first weight loads are issued before the wait half of the
// barrier, and png[t+1] and pnc[t+1] (the CTA's own columns) are copied into
// shared memory with cp.async one step ahead.  The masked softmax's -1e9
// fill stays f32.
//
// Bounds on this card: the bytes the launch must move take ~0.03 ms at the
// train batch's shape; the serial chain does not shrink with them.  Per step
// and cluster the latency bound is (5 + 2N) * (one L2 round trip + one DSMEM
// store and cluster barrier) + the step's weight, key and memory bytes / C
// / one SM's L2 bandwidth (or, when larger, all running rows' bytes / the
// card's L2 bandwidth); chip_smoke.py phase_teacher computes it from the
// probe of csrc/latency_probe.cu.
//
// Limits (the Python wrapper raises outside them): N <= 4 layers; H, A and D
// multiples of VEC = 16/sizeof(T) (a CTA's share is a run of 16-byte column
// groups, split as evenly as they go, so H/C, A/C and D/C need not be
// multiples of VEC); at C = 1 every phase fits one 16-byte column group a
// thread: 4H (the context block), A + H and D each <= CTHREADS * VEC; weights
// and rows 16-byte aligned; shared memory (4*(CTHREADS*(VEC + 32) + 64 + 15H
// + 4NH + 3H*sizeof(T)/4 + 2A + D + max(H, D) + (C + 2)L) bytes + the job and
// plan tables) <= 227 KB: at the presets' widths (D <= 384) about 96 KB
// (bf16, C = 1) to 108 KB (C = 16) at L = 192; C = 16 fits up to L ~ 1,900.

#include "cluster_common.cuh"

namespace {

using namespace clu;

constexpr int MAX_LAYERS = 4;
// job table: attention GRU 2, q, x_pre, context, cb 2, 3 per layer
constexpr int J_AG = 0, J_AC = 1, J_Q = 2, J_XP = 3, J_CTX = 4, J_CB = 5, J_L0 = 7;
constexpr int NJOBS = J_L0 + 3 * MAX_LAYERS;
// phases of a step that run products: attention GRU 2, q and x_pre,
// context, cb, 2 per layer
constexpr int P_AG = 0, P_AC = 1, P_QX = 2, P_CTX = 3, P_CB = 4, P_L0 = 5;
constexpr int NPLANS = P_L0 + 2 * MAX_LAYERS;
// floats of the job and plan tables, at the start of the dynamic shared
// memory
constexpr int HEAD_FLOATS =
    int((NJOBS * sizeof(Job<float>) + NPLANS * sizeof(Plan) + 15) / 16 * 4);

template <typename T>
struct Args {
  const T* png;             // [S, B, 2H]
  const T* pnc;             // [S, B, H]
  const T* keys;            // [B, L, A]
  const T* memory;          // [B, L, D]
  const uint8_t* mask;      // [B, L]
  const float* h0a;         // [B, H]
  const float* h0d;         // [N, B, H]
  const T* a_hg; const T* a_hc; const T* wq; const T* v;
  const T* w_ctx; const T* wd_h; const float* d_b;
  float* xs;                // [S, B, H]
  float* align;             // [S, B, L]
  float* ha;                // [S, B, H]
  // per layer: w_r's gate and candidate columns ([H, 2H], [H, H]), b_r [3H]
  const T* w_xg[MAX_LAYERS]; const T* w_xc[MAX_LAYERS]; const float* b_r[MAX_LAYERS];
  const T* hg[MAX_LAYERS]; const T* hc[MAX_LAYERS];
  float* hd[MAX_LAYERS];    // N x [S, B, H]
  int S, B, L, A, D, H, N, C;
};

// floats of the png/pnc staging: 3H values of T (a CTA uses 3 of its share)
__host__ __device__ __forceinline__ size_t stage_floats(size_t H, size_t esize) {
  return 3 * H * esize / 4;
}

size_t smem_floats(const int* d) {
  // d: S, B, L, A, D, H, N, is_bf16, C
  const size_t L = d[2], A = d[3], D = d[4], H = d[5], NL = d[6], C = d[8];
  const size_t vec = d[7] ? 8 : 4, esize = d[7] ? 2 : 4;
  return HEAD_FLOATS + stage_floats(H, esize) + size_t(CTHREADS) * (vec + 32) + 64 +
         3 * H * NL + H                                   // b_r, d_b
         + H * (3 + NL) + D + C * L                       // h_a, h_d, rh, x, ctx, epart
         + 2 * A + 2 * L + 11 * H + (H > D ? H : D);      // vv, q, e, mk, local vectors
}

template <typename T>
__global__ void __launch_bounds__(CTHREADS) teacher_fwd_kernel(const Args<T> a) {
  extern __shared__ __align__(16) float smem[];
  Job<T>* jobs = reinterpret_cast<Job<T>*>(smem);
  Plan* plans = reinterpret_cast<Plan*>(jobs + NJOBS);
  constexpr int VEC = Vec<T>::N;
  const int C = a.C;
  const int k = int(cluster_rank());
  const int b = blockIdx.x / C;
  const int tid = threadIdx.x;
  const int B = a.B, L = a.L, A = a.A, D = a.D, H = a.H, NL = a.N;

  T* stage = reinterpret_cast<T*>(smem + HEAD_FLOATS);   // own png r, u; pnc
  float* red = smem + HEAD_FLOATS + stage_floats(H, sizeof(T));   // red_floats<T>()
  float* scratch = red + red_floats<T>();     // 64
  float* lb = scratch + 64;                   // NL * 3H (b_r per layer)
  float* d_b = lb + NL * 3 * H;               // H
  // replicated in every CTA of the cluster
  float* h_a = d_b + H;                       // H
  float* h_d = h_a + H;                       // NL * H
  float* rh = h_d + NL * H;                   // H
  float* x = rh + H;                          // H
  float* ctx = x + H;                         // D
  float* epart = ctx + D;                     // C * L (partial energies by rank)
  // local to this CTA
  float* vv = epart + C * L;                  // A
  float* q = vv + A;                          // A (own columns first)
  float* e = q + A;                           // L
  float* mk = e + L;                          // L
  float* go = mk + L;                         // 2H (own r sums, then own u sums)
  float* co = go + 2 * H;                     // H (candidate x-side)
  float* uo = co + H;                         // H (update gate)
  float* xp = uo + H;                         // H (own x_pre)
  float* cbo = xp + H;                        // 4H (own columns of cb's four blocks)
  float* tmp = cbo + 4 * H;                   // 2H (staged values to broadcast)
  float* wo = tmp + 2 * H;                    // max(H, D) (a job's output)

  // this CTA's slices (16-byte column groups; positions for the alignment)
  int g, n;
  split(H / VEC, C, k, &g, &n);
  const int j0 = g * VEC, nh = n * VEC, nhg = n;
  split(A / VEC, C, k, &g, &n);
  const int a0 = g * VEC, na = n * VEC, nag = n;
  split(D / VEC, C, k, &g, &n);
  const int d0 = g * VEC, nd = n * VEC, ndg = n;
  int l0, nl;
  split(L, C, k, &l0, &nl);

  const T* keys = a.keys + size_t(b) * L * A;
  const T* mem = a.memory + size_t(b) * L * D;
  const uint8_t* mask = a.mask + size_t(b) * L;

  // step t's own png r and u columns and pnc columns -> stage, in flight
  // until the next cp_async_wait_all
  const auto prefetch = [&](int t) {
    const size_t row = size_t(t) * B + b;
    for (int c = tid; c < 3 * nhg; c += CTHREADS) {
      const int part = c / nhg, gg = c - part * nhg;
      const T* src = part < 2 ? a.png + row * 2 * H + part * H + j0 + gg * VEC
                              : a.pnc + row * H + j0 + gg * VEC;
      cp_async16(stage + part * nh + gg * VEC, src);
    }
  };
  prefetch(0);

  for (int j = tid; j < H; j += CTHREADS) h_a[j] = rnd<T>(a.h0a[size_t(b) * H + j]);
  for (int j = tid; j < NL * H; j += CTHREADS) {
    const int i = j / H, c = j % H;
    h_d[j] = rnd<T>(a.h0d[(size_t(i) * B + b) * H + c]);
    lb[i * 3 * H + c] = a.b_r[i][c];
    lb[i * 3 * H + H + c] = a.b_r[i][H + c];
    lb[i * 3 * H + 2 * H + c] = a.b_r[i][2 * H + c];
  }
  for (int j = tid; j < H; j += CTHREADS) d_b[j] = a.d_b[j];
  for (int j = tid; j < 4 * H; j += CTHREADS) cbo[j] = 0.f;   // cb = 0 before step 0
  for (int j = tid; j < A; j += CTHREADS) vv[j] = to_f(a.v[j]);
  for (int j = tid; j < L; j += CTHREADS) mk[j] = mask[j] ? 1.f : 0.f;
  const auto at = [&](const float* p) { return int(p - smem); };
  const auto plan = [&](int i) { return int(reinterpret_cast<float*>(plans + i) - smem); };
  if (tid == 0) {
    set_job(jobs[J_AG], 2 * H, j0, nhg, H + j0, nhg, -1, at(go));
    add_seg(jobs[J_AG], at(h_a), a.a_hg, H);
    set_job(jobs[J_AC], H, j0, nhg, 0, 0, -1, at(wo));
    add_seg(jobs[J_AC], at(rh), a.a_hc, H);
    set_job(jobs[J_Q], A, a0, nag, 0, 0, -1, at(q));
    add_seg(jobs[J_Q], at(h_a), a.wq, H);
    set_job(jobs[J_XP], H, j0, nhg, 0, 0, -1, at(xp));
    add_seg(jobs[J_XP], at(h_a), a.wd_h, H);
    set_job(jobs[J_CTX], D, d0, ndg, 0, 0, -1, at(wo));
    add_seg(jobs[J_CTX], at(e), mem, L);
    // cb's four H blocks, own columns: [dec_in | attn r | attn u | attn c]
    set_job(jobs[J_CB], 4 * H, j0, nhg, H + j0, nhg, -1, at(cbo));
    add_seg(jobs[J_CB], at(ctx), a.w_ctx, D);
    set_job(jobs[J_CB + 1], 4 * H, 2 * H + j0, nhg, 3 * H + j0, nhg, -1, at(cbo) + 2 * nh);
    add_seg(jobs[J_CB + 1], at(ctx), a.w_ctx, D);
    for (int i = 0; i < NL; ++i) {
      Job<T>* lj = jobs + J_L0 + 3 * i;
      set_job(lj[0], 2 * H, j0, nhg, H + j0, nhg, at(lb + i * 3 * H), at(go));
      add_seg(lj[0], at(x), a.w_xg[i], H);
      add_seg(lj[0], at(h_d + i * H), a.hg[i], H);
      set_job(lj[1], H, j0, nhg, 0, 0, at(lb + i * 3 * H + 2 * H), at(co));
      add_seg(lj[1], at(x), a.w_xc[i], H);
      set_job(lj[2], H, j0, nhg, 0, 0, -1, at(wo));
      add_seg(lj[2], at(rh), a.hc[i], H);
    }
    const int r = at(red);
    make_plan(plans[P_AG], jobs, J_AG, 1, r);
    make_plan(plans[P_AC], jobs, J_AC, 1, r);
    make_plan(plans[P_QX], jobs, J_Q, 2, r);            // q + x_pre
    make_plan(plans[P_CTX], jobs, J_CTX, 1, r);
    make_plan(plans[P_CB], jobs, J_CB, 2, r);
    for (int i = 0; i < NL; ++i) {
      make_plan(plans[P_L0 + 2 * i], jobs, J_L0 + 3 * i, 2, r);   // gates + candidate x-side
      make_plan(plans[P_L0 + 2 * i + 1], jobs, J_L0 + 3 * i + 2, 1, r);
    }
  }
  __syncthreads();
  cluster_arrive();               // waited for by the first phase: every CTA has
                                  // started before any remote write

  for (int t = 0; t < a.S; ++t) {
    const size_t row = size_t(t) * B + b;
    cp_async_wait_all();          // this thread's copies of step t (run_jobs' barrier
                                  // shows them to the others)
    // 1-2 ---- attention GRU ---------------------------------------------------
    run_jobs<T>(0, plan(P_AG), true);
    for (int i = tid; i < nh; i += CTHREADS) {
      const float gr = go[i] + (to_f(stage[i]) + cbo[nh + i]);
      const float gu = go[nh + i] + (to_f(stage[nh + i]) + cbo[2 * nh + i]);
      uo[i] = sigmoidf(gu);
      tmp[i] = sigmoidf(gr) * h_a[j0 + i];
    }
    __syncthreads();
    broadcast(rh + j0, tmp, nh, C);
    cluster_arrive();
    run_jobs<T>(0, plan(P_AC), true);
    for (int i = tid; i < nh; i += CTHREADS) {
      const float c = tanhf(wo[i] + (to_f(stage[2 * nh + i]) + cbo[3 * nh + i]));
      const float h = uo[i] * h_a[j0 + i] + (1.f - uo[i]) * c;
      tmp[i] = h;
      a.ha[row * H + j0 + i] = h;
    }
    __syncthreads();              // the stage is read: the next step's copies may land
    if (t + 1 < a.S) prefetch(t + 1);
    broadcast(h_a + j0, tmp, nh, C);
    cluster_arrive();

    // 3-4 ---- Bahdanau attention: f32 energies, masked softmax, context ------
    run_jobs<T>(0, plan(P_QX), true);                 // q + x_pre
    energy_partials<T>(keys, at(q), at(vv), a0, na, L, A, at(e));
    broadcast(epart + k * L, e, L, C);
    cluster_sync();                                    // the softmax reads them at once
    cluster_softmax(at(epart), at(mk), L, C, at(e), a.align + row * L, l0, nl, at(scratch));
    run_jobs<T>(0, plan(P_CTX), false);
    broadcast(ctx + d0, wo, nd, C);
    cluster_arrive();

    // 5 ---- context block and dec_in ---------------------------------------
    run_jobs<T>(0, plan(P_CB), true);
    for (int i = tid; i < nh; i += CTHREADS) {
      tmp[i] = (xp[i] + cbo[i]) + d_b[j0 + i];
      if (NL == 0) a.xs[row * H + j0 + i] = tmp[i];
    }
    __syncthreads();
    broadcast(x + j0, tmp, nh, C);
    cluster_arrive();

    // ---- residual GRU stack: two phases a layer ------------------------------
    for (int i = 0; i < NL; ++i) {
      float* hi = h_d + i * H;
      run_jobs<T>(0, plan(P_L0 + 2 * i), true);
      for (int u = tid; u < nh; u += CTHREADS) {
        uo[u] = sigmoidf(go[nh + u]);
        tmp[u] = sigmoidf(go[u]) * hi[j0 + u];
      }
      __syncthreads();
      broadcast(rh + j0, tmp, nh, C);
      cluster_arrive();
      run_jobs<T>(0, plan(P_L0 + 2 * i + 1), true);
      for (int u = tid; u < nh; u += CTHREADS) {
        const float h = uo[u] * hi[j0 + u] + (1.f - uo[u]) * tanhf(co[u] + wo[u]);
        const float xn = x[j0 + u] + h;
        tmp[u] = h;
        tmp[nh + u] = xn;
        a.hd[i][row * H + j0 + u] = h;
        if (i == NL - 1) a.xs[row * H + j0 + u] = xn;
      }
      __syncthreads();
      broadcast(hi + j0, tmp, nh, C);
      broadcast(x + j0, tmp + nh, nh, C);
      cluster_arrive();
    }
  }
  cluster_wait();                 // no CTA exits while a peer may still write to it
}

size_t smem_dynamic(const int* d) { return smem_floats(d) * sizeof(float); }

// Kernel attributes for a launch (or an occupancy query) of a cluster of C.
template <typename T>
cudaError_t prepare(const int* d, cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr,
                    cudaStream_t stream) {
  const int C = d[8];
  const size_t smem = smem_dynamic(d);
  cudaError_t err = cudaFuncSetAttribute(teacher_fwd_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         int(smem));
  if (err != cudaSuccess) return err;
  if (C > 8) {
    err = cudaFuncSetAttribute(teacher_fwd_kernel<T>,
                               cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
  }
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(unsigned(d[1]) * unsigned(C), 1, 1);
  cfg->blockDim = dim3(CTHREADS, 1, 1);
  cfg->dynamicSmemBytes = smem;
  cfg->stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = unsigned(C);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaSuccess;
}

template <typename T>
int launch(const void* const* p, const int* d, cudaStream_t stream) {
  Args<T> a;
  int i = 0;
  a.png = static_cast<const T*>(p[i++]);
  a.pnc = static_cast<const T*>(p[i++]);
  a.keys = static_cast<const T*>(p[i++]);
  a.memory = static_cast<const T*>(p[i++]);
  a.mask = static_cast<const uint8_t*>(p[i++]);
  a.h0a = static_cast<const float*>(p[i++]);
  a.h0d = static_cast<const float*>(p[i++]);
  a.a_hg = static_cast<const T*>(p[i++]);
  a.a_hc = static_cast<const T*>(p[i++]);
  a.wq = static_cast<const T*>(p[i++]);
  a.v = static_cast<const T*>(p[i++]);
  a.w_ctx = static_cast<const T*>(p[i++]);
  a.wd_h = static_cast<const T*>(p[i++]);
  a.d_b = static_cast<const float*>(p[i++]);
  a.xs = static_cast<float*>(const_cast<void*>(p[i++]));
  a.align = static_cast<float*>(const_cast<void*>(p[i++]));
  a.ha = static_cast<float*>(const_cast<void*>(p[i++]));
  a.S = d[0]; a.B = d[1]; a.L = d[2]; a.A = d[3]; a.D = d[4]; a.H = d[5]; a.N = d[6];
  a.C = d[8];
  if (a.N > MAX_LAYERS || a.C < 1 || a.C > 16) return int(cudaErrorInvalidValue);
  for (int l = 0; l < MAX_LAYERS; ++l) {
    const bool on = l < a.N;
    a.w_xg[l] = on ? static_cast<const T*>(p[i++]) : nullptr;
    a.w_xc[l] = on ? static_cast<const T*>(p[i++]) : nullptr;
    a.b_r[l] = on ? static_cast<const float*>(p[i++]) : nullptr;
    a.hg[l] = on ? static_cast<const T*>(p[i++]) : nullptr;
    a.hc[l] = on ? static_cast<const T*>(p[i++]) : nullptr;
    a.hd[l] = on ? static_cast<float*>(const_cast<void*>(p[i++])) : nullptr;
  }
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  cudaError_t err = prepare<T>(d, &cfg, attr, stream);
  if (err != cudaSuccess) return int(err);
  err = cudaLaunchKernelEx(&cfg, teacher_fwd_kernel<T>, a);
  if (err != cudaSuccess) return int(err);
  return int(cudaGetLastError());
}

template <typename T>
int max_clusters(const int* d, int* out) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  cudaError_t err = prepare<T>(d, &cfg, attr, nullptr);
  if (err != cudaSuccess) return int(err);
  return int(cudaOccupancyMaxActiveClusters(out, teacher_fwd_kernel<T>, &cfg));
}

}  // namespace

extern "C" {

// dims: S, B, L, A, D, H, N, is_bf16, C (cluster size).

// Bytes of shared memory a CTA needs.
size_t teacher_decoder_fwd_smem_bytes(const int* dims) { return smem_dynamic(dims); }

// How many clusters of dims[8] CTAs the card can hold at once
// (cudaOccupancyMaxActiveClusters) -> *out.  Returns the CUDA error code.
int teacher_decoder_fwd_max_clusters(const int* dims, int* out) {
  *out = 0;
  return dims[7] ? max_clusters<__nv_bfloat16>(dims, out) : max_clusters<float>(dims, out);
}

// ptrs: png, pnc, keys, memory, mask, h0a, h0d, a_hg, a_hc, wq, v, w_ctx,
// wd_h, d_b, xs, align, ha, then per layer w_xg (w_r[:, :2H]), w_xc
// (w_r[:, 2H:]), b_r, hg, hc, hd.  Launches B clusters of C CTAs.  Returns
// the CUDA error code.
int teacher_decoder_fwd_launch(const void* const* ptrs, const int* dims, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dims[7] ? launch<__nv_bfloat16>(ptrs, dims, s) : launch<float>(ptrs, dims, s);
}

}  // extern "C"
