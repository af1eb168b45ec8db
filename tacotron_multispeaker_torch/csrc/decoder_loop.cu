// The whole autoregressive Tacotron decode in one launch, for Hopper (sm_90a).
//
// Replaces: tacotron_multispeaker_tpu/ops/decoder_loop.py decoder_loop_pallas.
//
// Per step, for one batch row (same math as decoder_loop_reference there):
//   prenet on the fed-back frame (streamed dropout masks dm1/dm2)
//   -> attention GRU over [prenet, context]
//   -> Bahdanau attention: q = h @ wq, e_l = sum_a tanh(keys_la + q_a) v_a
//      (f32), masked softmax, context = p @ memory
//   -> dec_in Dense over [attn_h, context] -> residual GRU stack
//   -> r*M frame projection; the last of the r frames is fed back.
// Every matrix product rounds its input vector and reads its weights in the
// compute type T (bf16 or f32) and sums in f32; the carries stay f32.
//
// Design: one thread-block cluster of C CTAs (CTHREADS = 384 threads each)
// decodes one batch row; all n_steps are looped inside the cluster.  The
// launcher takes C as a parameter (the wrapper picks it: the largest of 16,
// 8, 4, 2 whose clusters the card can hold all B of at once, else 1).  CTA k
// owns a slice of the H hidden units of every GRU (its r, u and candidate
// columns, so the gate nonlinearities and the state update stay local), of
// the prenet, wq, dec_in and frame-projection columns, of the A columns of
// the energies, of the D columns of the context and of the L positions of
// the alignment row it writes.  It reads only its slice of the weights
// (from L2, where they stay resident), and writes each output slice into
// every CTA's copy of the vector through distributed shared memory; then
// the cluster meets at one barrier (helpers, and the rules that keep this
// safe: cluster_common.cuh).  Every CTA keeps full copies of the carries it
// reads (prenet activations, context, attention and decoder states, x, the
// fed-back frame) and of the biases.  Products that read the same known
// vectors run as one phase, so a step takes 8 + 2 * n_layers cluster
// barriers (12 at two layers; the per-CTA kernel of before took about 21
// dependent products):
//   1 prenet dense 0;  2 prenet dense 1;
//   3 attention-GRU gates over [prenet, context, h] with its candidate's
//     x-side;  4 its candidate (r*h) -> new h;
//   5 q (own A columns) and each position's partial energy over them;
//   6 the C partials summed, masked softmax (in every CTA, identically),
//     the context's own D columns;
//   7 dec_in over [attn_h, context];
//   per layer: gates with the candidate's x-side; the candidate -> h, x;
//   last: the frame projection, the fed-back frame.
// A phase that starts with products issues its first weight loads before
// the wait half of the barrier, so the L2 round trip overlaps it.  The
// masked softmax's -1e9 fill stays f32.  The phase helpers are kept out of
// line (inlined, the softmax once made ptxas spill).
//
// Bounds on this card: the bytes the launch must move (weights once,
// keys/memory once, outputs) take ~0.04 ms; the serial chain does not
// shrink with them.  Per step and cluster, the latency bound is
//   (8 + 2N) * (one L2 round trip + one DSMEM store and cluster barrier)
//   + the step's weight, key and memory bytes / C / one SM's L2 bandwidth
//     (or, when larger, all running rows' bytes / the card's L2 bandwidth),
// times the waves of clusters (ceil(B / co-resident clusters));
// chip_smoke.py phase_decoder measures the latencies and computes it.  On
// an H100 the kernel takes about 3x it: a phase's instructions (the
// thread's share of the job, the partial-sum reduction, the exchange) are
// issued by every warp of the CTA and take longer than its loads at C = 16.
// Weight slices kept resident in shared memory and rows on the tensor cores
// (B > 1) are later work.
//
// Limits (the Python wrapper raises outside them): n_layers <= 4; every
// width (P1, P2, H, A, D, r*M) a multiple of VEC = 16/sizeof(T); at C = 1
// every phase fits one 16-byte column group a thread: 3H (a GRU's gates and
// candidate) and P1, P2, A, D, r*M each <= CTHREADS * VEC; weights and rows
// 16-byte aligned; shared memory (4*(CTHREADS*(VEC + 32) + 64 + 2*(P1 + P2)
// + 4H + 3*NL*H + r*M + M + D + (NL + 7)*H + 2A + (C + 2)*L + 2*max(P1, P2,
// 2H, A, D, r*M)) bytes + the job and plan tables) <= 227 KB.

#include "cluster_common.cuh"

namespace {

using namespace clu;

constexpr int MAX_LAYERS = 4;
// job table: prenet 2, attention GRU 3, q, context, dec_in, 3 per layer, frame
constexpr int J_PRE1 = 0, J_PRE2 = 1, J_AG = 2, J_AXC = 3, J_AC = 4, J_Q = 5, J_CTX = 6,
              J_DIN = 7, J_L0 = 8;
constexpr int NJOBS = J_L0 + 3 * MAX_LAYERS + 1;
// phases of a step that run products: prenet 2, attention GRU 2, q,
// context, dec_in, 2 per layer, frame
constexpr int P_PRE1 = 0, P_PRE2 = 1, P_AG = 2, P_AC = 3, P_Q = 4, P_CTX = 5, P_DIN = 6,
              P_L0 = 7;
constexpr int NPLANS = P_L0 + 2 * MAX_LAYERS + 1;
// floats of the job and plan tables, at the start of the dynamic shared
// memory
constexpr int HEAD_FLOATS =
    int((NJOBS * sizeof(Job<float>) + NPLANS * sizeof(Plan) + 15) / 16 * 4);

template <typename T>
struct Args {
  const T* keys;            // [B, L, A]
  const T* memory;          // [B, L, D]
  const uint8_t* mask;      // [B, L] (bool)
  const float* dm1;         // [S, B, P1]
  const float* dm2;         // [S, B, P2]
  const float* attn_h0;     // [B, H]
  const float* dec_h0;      // [N, B, H]
  const T* w1; const float* b1;
  const T* w2; const float* b2;
  const T* a_xg_pn; const T* a_xg_ctx; const float* a_bg;
  const T* a_xc_pn; const T* a_xc_ctx; const float* a_bc;
  const T* a_hg; const T* a_hc;
  const T* wq; const T* v;
  const T* d_h; const T* d_ctx; const float* d_b;
  const T* wf; const float* bf;
  float* frames;            // [S, B, RM]
  float* align;             // [S, B, L]
  const T* l_xg[MAX_LAYERS]; const float* l_bg[MAX_LAYERS];
  const T* l_xc[MAX_LAYERS]; const float* l_bc[MAX_LAYERS];
  const T* l_hg[MAX_LAYERS]; const T* l_hc[MAX_LAYERS];
  int B, L, A, D, H, M, P1, P2, RM, n_layers, n_steps, C;
};

// Floats of the scratch vectors wo and tmp: the widest job output or
// staged broadcast (P1, P2, 2H, A, D, r*M).
__host__ __device__ __forceinline__ int out_max(int P1, int P2, int H, int A, int D, int RM) {
  const int w[6] = {P1, P2, 2 * H, A, D, RM};
  int m = 0;
  for (int i = 0; i < 6; ++i) m = w[i] > m ? w[i] : m;
  return m;
}

size_t smem_floats(const int* d, int vec) {
  // d: B, L, A, D, H, M, P1, P2, RM, n_layers, n_steps, C
  const size_t L = d[1], A = d[2], D = d[3], H = d[4], M = d[5], P1 = d[6], P2 = d[7],
               RM = d[8], NL = d[9], C = d[11];
  return HEAD_FLOATS + size_t(CTHREADS) * (vec + 32) + 64 + (P1 + P2 + 4 * H + 3 * NL * H + RM) +
         M + P1 + P2 + D + H * (NL + 7) + 2 * A +
         (C + 2) * L + 2 * size_t(out_max(int(P1), int(P2), int(H), int(A), int(D), int(RM)));
}

template <typename T>
__global__ void __launch_bounds__(CTHREADS) decoder_loop_kernel(const Args<T> a) {
  extern __shared__ __align__(16) float smem[];
  Job<T>* jobs = reinterpret_cast<Job<T>*>(smem);
  Plan* plans = reinterpret_cast<Plan*>(jobs + NJOBS);
  constexpr int VEC = Vec<T>::N;
  const int C = a.C;
  const int k = int(cluster_rank());
  const int b = blockIdx.x / C;
  const int tid = threadIdx.x;
  const int B = a.B, L = a.L, A = a.A, D = a.D, H = a.H, M = a.M;
  const int P1 = a.P1, P2 = a.P2, RM = a.RM, NL = a.n_layers;
  const int wmax = out_max(P1, P2, H, A, D, RM);

  // replicated in every CTA of the cluster
  float* red = smem + HEAD_FLOATS;            // red_floats<T>()
  float* scratch = red + red_floats<T>();     // 64
  float* bias = scratch + 64;                 // the biases, copied in order:
  float* b1 = bias;                           //   P1
  float* b2 = b1 + P1;                        //   P2
  float* a_bg = b2 + P2;                      //   2H
  float* a_bc = a_bg + 2 * H;                 //   H
  float* d_b = a_bc + H;                      //   H
  float* l_bg = d_b + H;                      //   NL * 2H
  float* l_bc = l_bg + NL * 2 * H;            //   NL * H
  float* bf = l_bc + NL * H;                  //   RM
  float* prev = bf + RM;                      // M
  float* p1 = prev + M;                       // P1
  float* pn = p1 + P1;                        // P2
  float* ctx = pn + P2;                       // D
  float* attn_h = ctx + D;                    // H
  float* dec_h = attn_h + H;                  // NL * H
  float* rh = dec_h + NL * H;                 // H
  float* x = rh + H;                          // H
  float* vv = x + H;                          // A
  float* epart = vv + A;                      // C * L (partial energies by rank)
  // local to this CTA
  float* e = epart + C * L;                   // L
  float* mk = e + L;                          // L
  float* q = mk + L;                          // A (own columns first)
  float* go = q + A;                          // 2H (own r sums, then own u sums)
  float* co = go + 2 * H;                     // H (candidate x-side)
  float* uo = co + H;                         // H (update gate)
  float* wo = uo + H;                         // wmax (a job's output)
  float* tmp = wo + wmax;                     // wmax (staged values to broadcast)

  // this CTA's slices (16-byte column groups; positions for the alignment)
  int g, n;
  split(H / VEC, C, k, &g, &n);
  const int j0 = g * VEC, nh = n * VEC, nhg = n;
  split(P1 / VEC, C, k, &g, &n);
  const int q10 = g * VEC, n1 = n * VEC, n1g = n;
  split(P2 / VEC, C, k, &g, &n);
  const int q20 = g * VEC, n2 = n * VEC, n2g = n;
  split(A / VEC, C, k, &g, &n);
  const int a0 = g * VEC, na = n * VEC, nag = n;
  split(D / VEC, C, k, &g, &n);
  const int d0 = g * VEC, nd = n * VEC, ndg = n;
  split(RM / VEC, C, k, &g, &n);
  const int f0 = g * VEC, nf = n * VEC, nfg = n;
  int l0, nl;
  split(L, C, k, &l0, &nl);

  const T* keys = a.keys + size_t(b) * L * A;
  const T* mem = a.memory + size_t(b) * L * D;
  const uint8_t* mask = a.mask + size_t(b) * L;

  for (int j = tid; j < H; j += CTHREADS) attn_h[j] = a.attn_h0[size_t(b) * H + j];
  for (int j = tid; j < NL * H; j += CTHREADS) {
    const int i = j / H, c = j % H;
    dec_h[j] = a.dec_h0[(size_t(i) * B + b) * H + c];
  }
  for (int j = tid; j < D; j += CTHREADS) ctx[j] = 0.f;
  for (int j = tid; j < M; j += CTHREADS) prev[j] = 0.f;
  for (int j = tid; j < A; j += CTHREADS) vv[j] = to_f(a.v[j]);
  for (int j = tid; j < L; j += CTHREADS) mk[j] = mask[j] ? 1.f : 0.f;
  for (int j = tid; j < P1; j += CTHREADS) b1[j] = a.b1[j];
  for (int j = tid; j < P2; j += CTHREADS) b2[j] = a.b2[j];
  for (int j = tid; j < 2 * H; j += CTHREADS) a_bg[j] = a.a_bg[j];
  for (int j = tid; j < H; j += CTHREADS) {
    a_bc[j] = a.a_bc[j];
    d_b[j] = a.d_b[j];
  }
  for (int j = tid; j < NL * H; j += CTHREADS) {
    const int i = j / H, c = j % H;
    l_bg[i * 2 * H + c] = a.l_bg[i][c];
    l_bg[i * 2 * H + H + c] = a.l_bg[i][H + c];
    l_bc[j] = a.l_bc[i][c];
  }
  for (int j = tid; j < RM; j += CTHREADS) bf[j] = a.bf[j];
  const auto at = [&](const float* p) { return int(p - smem); };
  const auto plan = [&](int i) { return int(reinterpret_cast<float*>(plans + i) - smem); };
  if (tid == 0) {
    set_job(jobs[J_PRE1], P1, q10, n1g, 0, 0, at(b1), at(wo));
    add_seg(jobs[J_PRE1], at(prev), a.w1, M);
    set_job(jobs[J_PRE2], P2, q20, n2g, 0, 0, at(b2), at(wo));
    add_seg(jobs[J_PRE2], at(p1), a.w2, P1);
    set_job(jobs[J_AG], 2 * H, j0, nhg, H + j0, nhg, at(a_bg), at(go));
    add_seg(jobs[J_AG], at(pn), a.a_xg_pn, P2);
    add_seg(jobs[J_AG], at(ctx), a.a_xg_ctx, D);
    add_seg(jobs[J_AG], at(attn_h), a.a_hg, H);
    set_job(jobs[J_AXC], H, j0, nhg, 0, 0, at(a_bc), at(co));
    add_seg(jobs[J_AXC], at(pn), a.a_xc_pn, P2);
    add_seg(jobs[J_AXC], at(ctx), a.a_xc_ctx, D);
    set_job(jobs[J_AC], H, j0, nhg, 0, 0, -1, at(wo));
    add_seg(jobs[J_AC], at(rh), a.a_hc, H);
    set_job(jobs[J_Q], A, a0, nag, 0, 0, -1, at(q));
    add_seg(jobs[J_Q], at(attn_h), a.wq, H);
    set_job(jobs[J_CTX], D, d0, ndg, 0, 0, -1, at(wo));
    add_seg(jobs[J_CTX], at(e), mem, L);
    set_job(jobs[J_DIN], H, j0, nhg, 0, 0, at(d_b), at(wo));
    add_seg(jobs[J_DIN], at(attn_h), a.d_h, H);
    add_seg(jobs[J_DIN], at(ctx), a.d_ctx, D);
    for (int i = 0; i < NL; ++i) {
      Job<T>* lj = jobs + J_L0 + 3 * i;
      set_job(lj[0], 2 * H, j0, nhg, H + j0, nhg, at(l_bg + i * 2 * H), at(go));
      add_seg(lj[0], at(x), a.l_xg[i], H);
      add_seg(lj[0], at(dec_h + i * H), a.l_hg[i], H);
      set_job(lj[1], H, j0, nhg, 0, 0, at(l_bc + i * H), at(co));
      add_seg(lj[1], at(x), a.l_xc[i], H);
      set_job(lj[2], H, j0, nhg, 0, 0, -1, at(wo));
      add_seg(lj[2], at(rh), a.l_hc[i], H);
    }
    Job<T>& fj = jobs[J_L0 + 3 * NL];
    set_job(fj, RM, f0, nfg, 0, 0, at(bf), at(wo));
    add_seg(fj, at(x), a.wf, H);
    const int r = at(red);
    make_plan(plans[P_PRE1], jobs, J_PRE1, 1, r);
    make_plan(plans[P_PRE2], jobs, J_PRE2, 1, r);
    make_plan(plans[P_AG], jobs, J_AG, 2, r);           // gates + candidate x-side
    make_plan(plans[P_AC], jobs, J_AC, 1, r);
    make_plan(plans[P_Q], jobs, J_Q, 1, r);
    make_plan(plans[P_CTX], jobs, J_CTX, 1, r);
    make_plan(plans[P_DIN], jobs, J_DIN, 1, r);
    for (int i = 0; i < NL; ++i) {
      make_plan(plans[P_L0 + 2 * i], jobs, J_L0 + 3 * i, 2, r);
      make_plan(plans[P_L0 + 2 * i + 1], jobs, J_L0 + 3 * i + 2, 1, r);
    }
    make_plan(plans[P_L0 + 2 * NL], jobs, J_L0 + 3 * NL, 1, r);
  }
  __syncthreads();
  cluster_arrive();               // waited for by the first phase: every CTA has
                                  // started before any remote write

  for (int t = 0; t < a.n_steps; ++t) {
    const size_t row = size_t(t) * B + b;
    // 1-2 ---- prenet on the fed-back frame -----------------------------------
    run_jobs<T>(0, plan(P_PRE1), true);
    for (int i = tid; i < n1; i += CTHREADS)
      tmp[i] = fmaxf(wo[i], 0.f) * a.dm1[row * P1 + q10 + i];
    __syncthreads();
    broadcast(p1 + q10, tmp, n1, C);
    cluster_arrive();
    run_jobs<T>(0, plan(P_PRE2), true);
    for (int i = tid; i < n2; i += CTHREADS)
      tmp[i] = fmaxf(wo[i], 0.f) * a.dm2[row * P2 + q20 + i];
    __syncthreads();
    broadcast(pn + q20, tmp, n2, C);
    cluster_arrive();

    // 3-4 ---- attention GRU over [prenet, context] ---------------------------
    run_jobs<T>(0, plan(P_AG), true);                 // gates + candidate x-side
    for (int i = tid; i < nh; i += CTHREADS) {
      uo[i] = sigmoidf(go[nh + i]);
      tmp[i] = sigmoidf(go[i]) * attn_h[j0 + i];
    }
    __syncthreads();
    broadcast(rh + j0, tmp, nh, C);
    cluster_arrive();
    run_jobs<T>(0, plan(P_AC), true);
    for (int i = tid; i < nh; i += CTHREADS)
      tmp[i] = uo[i] * attn_h[j0 + i] + (1.f - uo[i]) * tanhf(co[i] + wo[i]);
    __syncthreads();
    broadcast(attn_h + j0, tmp, nh, C);
    cluster_arrive();

    // 5-6 ---- Bahdanau attention: f32 energies, masked softmax, context ------
    run_jobs<T>(0, plan(P_Q), true);
    energy_partials<T>(keys, at(q), at(vv), a0, na, L, A, at(e));
    broadcast(epart + k * L, e, L, C);
    cluster_sync();                                    // the softmax reads them at once
    cluster_softmax(at(epart), at(mk), L, C, at(e), a.align + row * L, l0, nl, at(scratch));
    run_jobs<T>(0, plan(P_CTX), false);
    broadcast(ctx + d0, wo, nd, C);
    cluster_arrive();

    // 7 ---- dec_in Dense over [attn_h, context] ------------------------------
    run_jobs<T>(0, plan(P_DIN), true);
    broadcast(x + j0, wo, nh, C);
    cluster_arrive();

    // ---- residual GRU stack: two phases a layer ------------------------------
    for (int i = 0; i < NL; ++i) {
      float* hi = dec_h + i * H;
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
        tmp[u] = h;
        tmp[nh + u] = x[j0 + u] + h;
      }
      __syncthreads();
      broadcast(hi + j0, tmp, nh, C);
      broadcast(x + j0, tmp + nh, nh, C);
      cluster_arrive();
    }

    // last ---- r-frame projection; the last frame is fed back ---------------
    run_jobs<T>(0, plan(P_L0 + 2 * NL), true);
    float* fo = a.frames + row * RM + f0;
    for (int i = tid; i < nf; i += CTHREADS) fo[i] = wo[i];
    const int fb = f0 > RM - M ? f0 : RM - M;         // own columns fed back
    if (f0 + nf > fb) broadcast(prev + (fb - (RM - M)), wo + (fb - f0), f0 + nf - fb, C);
    cluster_arrive();
  }
  cluster_wait();                 // no CTA exits while a peer may still write to it
}

size_t smem_dynamic(const int* d) {
  return smem_floats(d, d[12] ? 8 : 4) * sizeof(float);
}

// Kernel attributes for a launch (or an occupancy query) of a cluster of C.
template <typename T>
cudaError_t prepare(const int* d, cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr,
                    cudaStream_t stream) {
  const int C = d[11];
  const size_t smem = smem_dynamic(d);
  cudaError_t err = cudaFuncSetAttribute(decoder_loop_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         int(smem));
  if (err != cudaSuccess) return err;
  if (C > 8) {
    err = cudaFuncSetAttribute(decoder_loop_kernel<T>,
                               cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
  }
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(unsigned(d[0]) * unsigned(C), 1, 1);
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
  a.keys = static_cast<const T*>(p[i++]);
  a.memory = static_cast<const T*>(p[i++]);
  a.mask = static_cast<const uint8_t*>(p[i++]);
  a.dm1 = static_cast<const float*>(p[i++]);
  a.dm2 = static_cast<const float*>(p[i++]);
  a.attn_h0 = static_cast<const float*>(p[i++]);
  a.dec_h0 = static_cast<const float*>(p[i++]);
  a.w1 = static_cast<const T*>(p[i++]);
  a.b1 = static_cast<const float*>(p[i++]);
  a.w2 = static_cast<const T*>(p[i++]);
  a.b2 = static_cast<const float*>(p[i++]);
  a.a_xg_pn = static_cast<const T*>(p[i++]);
  a.a_xg_ctx = static_cast<const T*>(p[i++]);
  a.a_bg = static_cast<const float*>(p[i++]);
  a.a_xc_pn = static_cast<const T*>(p[i++]);
  a.a_xc_ctx = static_cast<const T*>(p[i++]);
  a.a_bc = static_cast<const float*>(p[i++]);
  a.a_hg = static_cast<const T*>(p[i++]);
  a.a_hc = static_cast<const T*>(p[i++]);
  a.wq = static_cast<const T*>(p[i++]);
  a.v = static_cast<const T*>(p[i++]);
  a.d_h = static_cast<const T*>(p[i++]);
  a.d_ctx = static_cast<const T*>(p[i++]);
  a.d_b = static_cast<const float*>(p[i++]);
  a.wf = static_cast<const T*>(p[i++]);
  a.bf = static_cast<const float*>(p[i++]);
  a.frames = static_cast<float*>(const_cast<void*>(p[i++]));
  a.align = static_cast<float*>(const_cast<void*>(p[i++]));
  a.B = d[0]; a.L = d[1]; a.A = d[2]; a.D = d[3]; a.H = d[4]; a.M = d[5];
  a.P1 = d[6]; a.P2 = d[7]; a.RM = d[8]; a.n_layers = d[9]; a.n_steps = d[10];
  a.C = d[11];
  if (a.n_layers > MAX_LAYERS || a.C < 1 || a.C > 16) return int(cudaErrorInvalidValue);
  for (int l = 0; l < MAX_LAYERS; ++l) {
    const bool on = l < a.n_layers;
    a.l_xg[l] = on ? static_cast<const T*>(p[i++]) : nullptr;
    a.l_bg[l] = on ? static_cast<const float*>(p[i++]) : nullptr;
    a.l_xc[l] = on ? static_cast<const T*>(p[i++]) : nullptr;
    a.l_bc[l] = on ? static_cast<const float*>(p[i++]) : nullptr;
    a.l_hg[l] = on ? static_cast<const T*>(p[i++]) : nullptr;
    a.l_hc[l] = on ? static_cast<const T*>(p[i++]) : nullptr;
  }
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  cudaError_t err = prepare<T>(d, &cfg, attr, stream);
  if (err != cudaSuccess) return int(err);
  err = cudaLaunchKernelEx(&cfg, decoder_loop_kernel<T>, a);
  if (err != cudaSuccess) return int(err);
  return int(cudaGetLastError());
}

template <typename T>
int max_clusters(const int* d, int* out) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  cudaError_t err = prepare<T>(d, &cfg, attr, nullptr);
  if (err != cudaSuccess) return int(err);
  return int(cudaOccupancyMaxActiveClusters(out, decoder_loop_kernel<T>, &cfg));
}

}  // namespace

extern "C" {

// dims: B, L, A, D, H, M, P1, P2, RM, n_layers, n_steps, C (cluster size),
// is_bf16.

// Bytes of shared memory a CTA needs.
size_t decoder_loop_smem_bytes(const int* dims) { return smem_dynamic(dims); }

// How many clusters of dims[11] CTAs the card can hold at once
// (cudaOccupancyMaxActiveClusters) -> *out.  Returns the CUDA error code.
int decoder_loop_max_clusters(const int* dims, int* out) {
  *out = 0;
  return dims[12] ? max_clusters<__nv_bfloat16>(dims, out) : max_clusters<float>(dims, out);
}

// ptrs: keys, memory, mask, dm1, dm2, attn_h0, dec_h0, w1, b1, w2, b2,
// a_xg_pn, a_xg_ctx, a_bg, a_xc_pn, a_xc_ctx, a_bc, a_hg, a_hc, wq, v, d_h,
// d_ctx, d_b, wf, bf, frames, align, then per layer l_xg, l_bg, l_xc, l_bc,
// l_hg, l_hc.  Launches B clusters of C CTAs.  Returns the CUDA error code.
int decoder_loop_launch(const void* const* ptrs, const int* dims, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dims[12] ? launch<__nv_bfloat16>(ptrs, dims, s) : launch<float>(ptrs, dims, s);
}

}  // extern "C"
