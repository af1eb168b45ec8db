// The teacher-forced decoder scan, backward, in one launch for Hopper (sm_90a).
//
// Replaces: tacotron_multispeaker_tpu/ops/teacher_decoder.py
// _teacher_decoder_bwd_pallas (its sequential kernel _bwd_kernel; d_keys is
// csrc/dkeys.cu and the weight-gradient sums csrc/wgrad.cu).
//
// Reverse time, for one batch row, with the carries dha, dhd_i and the
// context-block gradient [dcbg | dcbc] (same math as
// teacher_decoder_bwd_reference in ops/teacher_decoder.py):
//   residual GRU stack from the last layer down: x_{i-1} = x_i - h_i,
//     xgc = x_{i-1} @ w_r[i] + b_r[i] (rematerialised), GRU backward with
//     dht = dx + dhd_i, dx += [dg_pre | da_c] @ w_r[i]^T
//   dha_loc = dx @ wd_h^T;  dcb = [dx | dcbg | dcbc];  dctx = dcb @ w_ctx^T
//   dp = dctx @ memory^T + dalign;  de = p * (dp - sum(dp * p))  (0 where
//     masked, since p is)
//   q = ha @ wq;  dq = sum_l de_l * v * (1 - tanh^2(keys_l + q))  (act
//     rematerialised over [L, A]);  dha_loc += dq @ wq^T
//   attention GRU backward with dht = dha_loc + dha, its input sums rebuilt
//     from png/pnc and the previous step's context block (zero at t = 0)
// Products round their input vector to the compute type T and sum in f32.
//
// Outputs dpng, dpnc, de, dctx, dh0a, dh0d (f32).  The weight gradients are
// sums over all S steps and B rows (~1.4 M f32 values at full width, 5.8 MB:
// no block holds them, and an atomic add per row and step would be ~9e9
// atomics in a run-dependent order).  So the kernel streams out each
// step's factors instead: x_{i-1}, [dg_pre | da_c] and r*h_prev per layer,
// r*h_prev of the attention GRU, dcb, ctx and dq; csrc/wgrad.cu reduces them
// (with hap, hdps, ha, dpng and dpnc, which are inputs or outputs already).
//
// Design: one block of 512 threads per batch row loops all S steps in
// reverse; carries and per-step vectors in shared memory; weights read from
// global memory (L2-resident), the transposed products v @ W^T through
// transposed copies the wrapper makes once per call, so every product is
// decoder_common.cuh's coalesced matvec.  dp takes one warp per encoder
// position, dq one thread per attention column.
//
// Bound on this card: the serial chain of ~26 dependent matrix-vector
// products per step plus the [L, A] tanh rematerialisation; the bytes the
// launch must move take far less time.
//
// Limits (the Python wrapper raises outside them): N <= 4 layers; H, 2H, 3H,
// 4H, A and D multiples of 16/sizeof(T) and at most 512*16/sizeof(T);
// weights and rows 16-byte aligned; shared memory
// (4*(NTHREADS*16/sizeof(T) + 64 + (27+N)H + 3A + 3D + 3L) bytes) <= 227 KB.

#include "decoder_common.cuh"

namespace {

using namespace dec;

constexpr int MAX_LAYERS = 4;

template <typename T>
struct Args {
  const T* png; const T* pnc;                          // [S,B,2H], [S,B,H]
  const float* ha; const float* hap; const float* xs;  // [S,B,H]
  const float* p; const float* pp;                     // [S,B,L]
  const float* dxs; const float* dal;                  // [S,B,H], [S,B,L]
  const T* keys; const T* memory; const uint8_t* mask;
  const T* a_hg; const T* a_hc; const T* wq; const T* v; const T* w_ctx;
  const T* a_hgT; const T* a_hcT; const T* wqT; const T* w_ctxT; const T* wd_hT;
  float* dpng; float* dpnc; float* de; float* dctx;    // [S,B,2H/H/L/D]
  float* dh0a; float* dh0d;                            // [B,H], [N,B,H]
  float* rh_a; float* dcb; float* ctx; float* dq;      // [S,B,H/4H/D/A]
  const float* hd[MAX_LAYERS]; const float* hdp[MAX_LAYERS];
  const T* w_r[MAX_LAYERS]; const float* b_r[MAX_LAYERS];
  const T* hg[MAX_LAYERS]; const T* hc[MAX_LAYERS];
  const T* w_rT[MAX_LAYERS]; const T* hgT[MAX_LAYERS]; const T* hcT[MAX_LAYERS];
  float* xin[MAX_LAYERS]; float* rh[MAX_LAYERS]; float* dgc[MAX_LAYERS];
  int S, B, L, A, D, H, N;
};

// Rematerialise a legacy-GRU step from h_prev ``hp`` and its input sums gx
// [2H] / cx [H] (consumed), then back-propagate dht: dg [3H] = [dg_pre |
// da_c], rh = r*h_prev, dh_prev = dht*u + drh*r + dg_pre @ whg^T.
template <typename T>
__device__ void gru_bwd(const float* dht, float* gx, float* cx, const float* hp,
                        const T* whg, const T* whc, const T* whgT, const T* whcT, int H,
                        float* r, float* u, float* rh, float* dg, float* drh, float* dh_prev,
                        float* red) {
  const int tid = threadIdx.x;
  matvec<T>(hp, whg, H, 2 * H, gx, nullptr, true, red);
  for (int j = tid; j < H; j += NTHREADS) {
    const float rr = sigmoidf(gx[j]);
    r[j] = rr;
    u[j] = sigmoidf(gx[H + j]);
    rh[j] = rr * hp[j];
  }
  __syncthreads();
  matvec<T>(rh, whc, H, H, cx, nullptr, true, red);
  for (int j = tid; j < H; j += NTHREADS) {
    const float c = tanhf(cx[j]);
    const float uu = u[j], d = dht[j];
    const float dc = d * (1.f - uu);
    const float du = d * (hp[j] - c);
    dg[2 * H + j] = dc * (1.f - c * c);
    dg[H + j] = du * uu * (1.f - uu);
  }
  __syncthreads();
  matvec<T>(dg + 2 * H, whcT, H, H, drh, nullptr, false, red);
  for (int j = tid; j < H; j += NTHREADS) {
    const float rr = r[j];
    dg[j] = drh[j] * hp[j] * rr * (1.f - rr);
  }
  __syncthreads();
  matvec<T>(dg, whgT, 2 * H, H, dh_prev, nullptr, false, red);
  for (int j = tid; j < H; j += NTHREADS)
    dh_prev[j] = (dht[j] * u[j] + drh[j] * r[j]) + dh_prev[j];
  __syncthreads();
}

template <typename T>
__global__ void __launch_bounds__(NTHREADS) teacher_bwd_kernel(const Args<T> a) {
  extern __shared__ __align__(16) float smem[];
  constexpr int VEC = Vec<T>::N;
  const int b = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int B = a.B, L = a.L, A = a.A, D = a.D, H = a.H, NL = a.N;

  float* red = smem;                          // NTHREADS * VEC
  float* scratch = red + NTHREADS * VEC;      // 64
  float* dha = scratch + 64;                  // H
  float* dhd = dha + H;                       // NL * H
  float* dcb = dhd + NL * H;                  // 4H: [dx0 | dcbg | dcbc]
  float* dx = dcb + 4 * H;                    // H
  float* xcur = dx + H;                       // H
  float* xim1 = xcur + H;                     // H
  float* hp = xim1 + H;                       // H
  float* gx = hp + H;                         // 3H
  float* r = gx + 3 * H;                      // H
  float* u = r + H;                           // H
  float* rh = u + H;                          // H
  float* dg = rh + H;                         // 3H
  float* drh = dg + 3 * H;                    // H
  float* dtot = drh + H;                      // H
  float* dloc = dtot + H;                     // H
  float* ha_t = dloc + H;                     // H
  float* cbp = ha_t + H;                      // 4H
  float* ctx = cbp + 4 * H;                   // D
  float* dctx = ctx + D;                      // D
  float* ctxp = dctx + D;                     // D
  float* q = ctxp + D;                        // A
  float* dq = q + A;                          // A
  float* vv = dq + A;                         // A
  float* pv = vv + A;                         // L
  float* ppv = pv + L;                        // L
  float* dp = ppv + L;                        // L (then de)

  for (int j = tid; j < H; j += NTHREADS) dha[j] = 0.f;
  for (int j = tid; j < NL * H; j += NTHREADS) dhd[j] = 0.f;
  for (int j = tid; j < 4 * H; j += NTHREADS) dcb[j] = 0.f;
  for (int j = tid; j < A; j += NTHREADS) vv[j] = to_f(a.v[j]);
  __syncthreads();

  const T* keys = a.keys + size_t(b) * L * A;
  const T* mem = a.memory + size_t(b) * L * D;

  for (int t = a.S - 1; t >= 0; --t) {
    const size_t row = size_t(t) * B + b;
    for (int j = tid; j < H; j += NTHREADS) {
      dx[j] = a.dxs[row * H + j];
      xcur[j] = a.xs[row * H + j];
    }
    __syncthreads();
    // ---- residual GRU stack, last layer first ------------------------------
    for (int i = NL - 1; i >= 0; --i) {
      for (int j = tid; j < H; j += NTHREADS) {
        const float xm = xcur[j] - a.hd[i][row * H + j];
        xim1[j] = xm;
        a.xin[i][row * H + j] = xm;
        hp[j] = a.hdp[i][row * H + j];
        dtot[j] = dx[j] + dhd[i * H + j];
      }
      __syncthreads();
      matvec<T>(xim1, a.w_r[i], H, 3 * H, gx, a.b_r[i], false, red);
      gru_bwd<T>(dtot, gx, gx + 2 * H, hp, a.hg[i], a.hc[i], a.hgT[i], a.hcT[i], H,
                 r, u, rh, dg, drh, dhd + i * H, red);
      for (int j = tid; j < 3 * H; j += NTHREADS) a.dgc[i][row * 3 * H + j] = dg[j];
      for (int j = tid; j < H; j += NTHREADS) a.rh[i][row * H + j] = rh[j];
      matvec<T>(dg, a.w_rT[i], 3 * H, H, dx, nullptr, true, red);
      for (int j = tid; j < H; j += NTHREADS) xcur[j] = xim1[j];
      __syncthreads();
    }
    // ---- dec_in, context block, context ------------------------------------
    for (int j = tid; j < H; j += NTHREADS) {
      dcb[j] = dx[j];
      ha_t[j] = a.ha[row * H + j];
    }
    for (int l = tid; l < L; l += NTHREADS) {
      pv[l] = a.p[row * L + l];
      ppv[l] = a.pp[row * L + l];
    }
    __syncthreads();
    for (int j = tid; j < 4 * H; j += NTHREADS) a.dcb[row * 4 * H + j] = dcb[j];
    matvec<T>(dx, a.wd_hT, H, H, dloc, nullptr, false, red);
    matvec<T>(pv, mem, L, D, ctx, nullptr, false, red);
    for (int j = tid; j < D; j += NTHREADS) a.ctx[row * D + j] = ctx[j];
    matvec<T>(dcb, a.w_ctxT, 4 * H, D, dctx, nullptr, false, red);
    for (int j = tid; j < D; j += NTHREADS) a.dctx[row * D + j] = dctx[j];
    // ---- attention backward: dp, de (softmax), dq ---------------------------
    for (int l = warp; l < L; l += NWARPS) {
      const T* mr = mem + size_t(l) * D;
      float s = 0.f;
      for (int d0 = lane * VEC; d0 < D; d0 += 32 * VEC) {
        float mv[VEC];
        Vec<T>::load(mr + d0, mv);
#pragma unroll
        for (int k = 0; k < VEC; ++k) s = fmaf(rnd<T>(dctx[d0 + k]), mv[k], s);
      }
      s = warp_sum(s);
      if (lane == 0) dp[l] = s + a.dal[row * L + l];
    }
    __syncthreads();
    float sp = 0.f;
    for (int l = tid; l < L; l += NTHREADS) sp += dp[l] * pv[l];
    sp = block_reduce<false>(sp, scratch);
    for (int l = tid; l < L; l += NTHREADS) {
      const float de = pv[l] * (dp[l] - sp);
      dp[l] = de;
      a.de[row * L + l] = de;
    }
    __syncthreads();
    matvec<T>(ha_t, a.wq, H, A, q, nullptr, false, red);
    for (int c = tid; c < A; c += NTHREADS) {
      const float qa = q[c], va = vv[c];
      float s = 0.f;
      for (int l = 0; l < L; ++l) {
        const float act = tanhf(to_f(keys[size_t(l) * A + c]) + qa);
        s += dp[l] * va * (1.f - act * act);
      }
      dq[c] = s;
      a.dq[row * A + c] = s;
    }
    __syncthreads();
    matvec<T>(dq, a.wqT, A, H, dloc, nullptr, true, red);
    // ---- attention GRU backward ---------------------------------------------
    if (t > 0) {
      matvec<T>(ppv, mem, L, D, ctxp, nullptr, false, red);
      matvec<T>(ctxp, a.w_ctx, D, 4 * H, cbp, nullptr, false, red);
    } else {
      for (int j = tid; j < 4 * H; j += NTHREADS) cbp[j] = 0.f;
      __syncthreads();
    }
    for (int j = tid; j < 2 * H; j += NTHREADS)
      gx[j] = to_f(a.png[row * 2 * H + j]) + cbp[H + j];
    for (int j = tid; j < H; j += NTHREADS) {
      gx[2 * H + j] = to_f(a.pnc[row * H + j]) + cbp[3 * H + j];
      hp[j] = a.hap[row * H + j];
      dtot[j] = dloc[j] + dha[j];
    }
    __syncthreads();
    gru_bwd<T>(dtot, gx, gx + 2 * H, hp, a.a_hg, a.a_hc, a.a_hgT, a.a_hcT, H,
               r, u, rh, dg, drh, dha, red);
    for (int j = tid; j < 2 * H; j += NTHREADS) {
      a.dpng[row * 2 * H + j] = dg[j];
      dcb[H + j] = dg[j];
    }
    for (int j = tid; j < H; j += NTHREADS) {
      a.dpnc[row * H + j] = dg[2 * H + j];
      dcb[3 * H + j] = dg[2 * H + j];
      a.rh_a[row * H + j] = rh[j];
    }
    __syncthreads();
  }
  for (int j = tid; j < H; j += NTHREADS) a.dh0a[size_t(b) * H + j] = dha[j];
  for (int j = tid; j < NL * H; j += NTHREADS) {
    const int i = j / H, c = j % H;
    a.dh0d[(size_t(i) * B + b) * H + c] = dhd[j];
  }
}

size_t smem_floats(const int* d) {
  // d: S, B, L, A, D, H, N, is_bf16
  const size_t L = d[2], A = d[3], D = d[4], H = d[5], NL = d[6];
  const size_t vec = d[7] ? 8 : 4;
  return size_t(NTHREADS) * vec + 64 + (27 + NL) * H + 3 * A + 3 * D + 3 * L;
}

template <typename T>
int launch(const void* const* p, const int* d, cudaStream_t stream) {
  Args<T> a;
  int i = 0;
  auto cT = [&]() { return static_cast<const T*>(p[i++]); };
  auto cF = [&]() { return static_cast<const float*>(p[i++]); };
  auto oF = [&]() { return static_cast<float*>(const_cast<void*>(p[i++])); };
  a.png = cT(); a.pnc = cT();
  a.ha = cF(); a.hap = cF(); a.xs = cF(); a.p = cF(); a.pp = cF(); a.dxs = cF(); a.dal = cF();
  a.keys = cT(); a.memory = cT(); a.mask = static_cast<const uint8_t*>(p[i++]);
  a.a_hg = cT(); a.a_hc = cT(); a.wq = cT(); a.v = cT(); a.w_ctx = cT();
  a.a_hgT = cT(); a.a_hcT = cT(); a.wqT = cT(); a.w_ctxT = cT(); a.wd_hT = cT();
  a.dpng = oF(); a.dpnc = oF(); a.de = oF(); a.dctx = oF(); a.dh0a = oF(); a.dh0d = oF();
  a.rh_a = oF(); a.dcb = oF(); a.ctx = oF(); a.dq = oF();
  a.S = d[0]; a.B = d[1]; a.L = d[2]; a.A = d[3]; a.D = d[4]; a.H = d[5]; a.N = d[6];
  if (a.N > MAX_LAYERS) return int(cudaErrorInvalidValue);
  for (int l = 0; l < MAX_LAYERS; ++l) {
    if (l < a.N) {
      a.hd[l] = cF(); a.hdp[l] = cF(); a.w_r[l] = cT(); a.b_r[l] = cF();
      a.hg[l] = cT(); a.hc[l] = cT(); a.w_rT[l] = cT(); a.hgT[l] = cT(); a.hcT[l] = cT();
      a.xin[l] = oF(); a.rh[l] = oF(); a.dgc[l] = oF();
    } else {
      a.hd[l] = a.hdp[l] = nullptr; a.w_r[l] = nullptr; a.b_r[l] = nullptr;
      a.hg[l] = a.hc[l] = a.w_rT[l] = a.hgT[l] = a.hcT[l] = nullptr;
      a.xin[l] = a.rh[l] = a.dgc[l] = nullptr;
    }
  }
  const size_t smem = smem_floats(d) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(teacher_bwd_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         int(smem));
  if (err != cudaSuccess) return int(err);
  teacher_bwd_kernel<T><<<a.B, NTHREADS, smem, stream>>>(a);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

// Bytes of shared memory the kernel needs for the dims d (see launch).
size_t teacher_decoder_bwd_smem_bytes(const int* d) { return smem_floats(d) * sizeof(float); }

// ptrs: png, pnc, ha, hap, xs, p, pp, dxs, dalign, keys, memory, mask, a_hg,
// a_hc, wq, v, w_ctx, a_hg^T, a_hc^T, wq^T, w_ctx^T, wd_h^T, dpng, dpnc, de,
// dctx, dh0a, dh0d, rh_a, dcb, ctx, dq, then per layer hd, hdp, w_r, b_r, hg,
// hc, w_r^T, hg^T, hc^T, xin, rh, dgc.  dims: S, B, L, A, D, H, N, is_bf16.
// Returns the CUDA error code.
int teacher_decoder_bwd_launch(const void* const* ptrs, const int* dims, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dims[7] ? launch<__nv_bfloat16>(ptrs, dims, s) : launch<float>(ptrs, dims, s);
}

}  // extern "C"
