// Backward of the fused two-direction GRU scan, for Hopper (sm_90a).
//
// Replaces: tacotron_multispeaker_tpu/ops/gru_scan.py _bigru_scan_bwd_pallas
// (the reverse-time kernel behind the bigru_scan custom VJP; both CBHG
// BiGRUs of the train step).
//
// For each direction d and time step t, from the last step down (direction
// 1's streams are time-reversed by the caller, as in the forward), with
// h = hprev[t,d] (the forward's state before step t) and the carried dh:
//   g = sigmoid(xg + round(h) @ whg),  r = g[:F], u = g[F:]   (rematerialised)
//   rh = r*h,  c = tanh(xc + round(rh) @ whc)
//   dht = dh + dys[t,d]
//   dac = dht*(1-u)*(1-c^2),  dgu = dht*(h-c)*u*(1-u)
//   drh = round(dac) @ whc^T,  dgr = drh*h*r*(1-r)
//   dh  = dht*u + drh*r + round([dgr|dgu]) @ whg^T
// Outputs dxg = [dgr|dgu], dxc = dac (f32), dh0 = the final dh, and the
// stream rh (compute type) from which csrc/wgrad.cu reduces
// dwhc = sum round(rh)^T round(dac); dwhg = sum round(h)^T round(dxg) reads
// hprev and dxg in place.  The Pallas kernel adds these per step in VMEM;
// over T*B rows that sum fits no block here, hence the split.
//
// Design: the forward's layout.  Grid = (2 directions, B rows), one block per
// (direction, row) running all T steps in reverse; whg and whc in shared
// memory (3F^2 elements: 96 KB bf16 / 192 KB f32 at F=128), every per-step
// vector in shared memory too.  The forward products (gates, candidate) take
// one column per thread; the transposed products (v @ W^T) take one warp per
// row of W, reading W's rows along the lanes (no bank conflicts, no
// transposed copy).  Five barriers per step.
//
// Bound on this card: the serial dependency chain (T steps of four dependent
// F-deep products each); the bytes streamed (~10F elements per row and step)
// take far less time.
//
// Limits (the Python wrapper raises outside them): 2F <= 1024 threads and
// 3F^2*sizeof(T) + 12*F*4 bytes of shared memory <= 227 KB
// (bf16: F <= 190, f32: F <= 134).

#include "common.cuh"

namespace {

using namespace kern;

constexpr int N_VECS = 12;   // f32 vectors of F in shared memory (dg_r counts twice)

template <typename T>
size_t smem_bytes(int F) {
  return align16(size_t(3) * F * F * sizeof(T)) + size_t(N_VECS) * F * sizeof(float);
}

template <typename T>
__global__ void __launch_bounds__(1024)
bigru_scan_bwd_kernel(const T* __restrict__ xg, const T* __restrict__ xc,
                      const T* __restrict__ hprev, const T* __restrict__ dys,
                      const T* __restrict__ whg, const T* __restrict__ whc,
                      float* __restrict__ dxg, float* __restrict__ dxc, T* __restrict__ rh_out,
                      float* __restrict__ dh0, int n_steps, int B, int F) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int dir = blockIdx.x;
  const int b = blockIdx.y;
  const int F2 = 2 * F;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;

  T* Wg = reinterpret_cast<T*>(smem);                      // [F, 2F]
  T* Wc = Wg + size_t(F) * F2;                             // [F, F]
  float* hp = reinterpret_cast<float*>(smem + align16(size_t(3) * F * F * sizeof(T)));
  float* hpr = hp + F;        // round(h)
  float* r = hpr + F;         // reset gate
  float* u = r + F;           // update gate
  float* rhr = u + F;         // round(r * h)
  float* dacr = rhr + F;      // round(dac)
  float* dgr = dacr + F;      // round([dgr | dgu]), 2F
  float* dh = dgr + F2;       // carried dh
  float* part = dh + F;       // dht*u + drh*r
  float* drh = part + F;      // round(dac) @ whc^T
  float* dht = drh + F;       // dh + dys (kept for the second half)

  const T* wg_src = whg + size_t(dir) * F * F2;
  const T* wc_src = whc + size_t(dir) * F * F;
  for (int i = tid; i < F * F2; i += blockDim.x) Wg[i] = wg_src[i];
  for (int i = tid; i < F * F; i += blockDim.x) Wc[i] = wc_src[i];
  for (int j = tid; j < F; j += blockDim.x) dh[j] = 0.f;
  __syncthreads();

  for (int t = n_steps - 1; t >= 0; --t) {
    const size_t row = (size_t(t) * 2 + dir) * B + b;     // row of [T, 2, B, .]
    for (int j = tid; j < F; j += blockDim.x) {
      const float v = to_f(hprev[row * F + j]);
      hp[j] = v;
      hpr[j] = rnd<T>(v);
    }
    __syncthreads();
    // ---- rematerialise the gates: column tid of [r | u] --------------------
    if (tid < F2) {
      const float xv = to_f(xg[row * F2 + tid]);
      float acc = 0.f;
#pragma unroll 8
      for (int k = 0; k < F; ++k) acc = fmaf(hpr[k], to_f(Wg[k * F2 + tid]), acc);
      const float g = sigmoidf(xv + acc);
      if (tid < F) {
        r[tid] = g;
        const float rhv = g * hp[tid];
        rhr[tid] = rnd<T>(rhv);
        rh_out[row * F + tid] = from_f<T>(rhv);
      } else {
        u[tid - F] = g;
      }
    }
    __syncthreads();
    // ---- candidate and the elementwise backward: column tid < F -------------
    if (tid < F) {
      const float xv = to_f(xc[row * F + tid]);
      float acc = 0.f;
#pragma unroll 8
      for (int k = 0; k < F; ++k) acc = fmaf(rhr[k], to_f(Wc[k * F + tid]), acc);
      const float c = tanhf(xv + acc);
      const float d = dh[tid] + to_f(dys[row * F + tid]);
      const float uu = u[tid];
      const float dc = d * (1.f - uu);
      const float du = d * (hp[tid] - c);
      const float dac = dc * (1.f - c * c);
      const float dgu = du * uu * (1.f - uu);
      dxc[row * F + tid] = dac;
      dxg[row * F2 + F + tid] = dgu;
      dacr[tid] = rnd<T>(dac);
      dgr[F + tid] = rnd<T>(dgu);
      dht[tid] = d;
    }
    __syncthreads();
    // ---- drh = round(dac) @ whc^T: one warp per row k of whc -----------------
    for (int k = warp; k < F; k += nwarps) {
      const T* wr = Wc + size_t(k) * F;
      float s = 0.f;
      for (int j = lane; j < F; j += 32) s = fmaf(dacr[j], to_f(wr[j]), s);
      s = warp_sum(s);
      if (lane == 0) drh[k] = s;
    }
    __syncthreads();
    if (tid < F) {
      const float rr = r[tid];
      const float dr = drh[tid] * hp[tid];
      const float g = dr * rr * (1.f - rr);
      dxg[row * F2 + tid] = g;
      dgr[tid] = rnd<T>(g);
      part[tid] = dht[tid] * u[tid] + drh[tid] * rr;
    }
    __syncthreads();
    // ---- dh = part + round(dg) @ whg^T: one warp per row k of whg -------------
    for (int k = warp; k < F; k += nwarps) {
      const T* wr = Wg + size_t(k) * F2;
      float s = 0.f;
      for (int j = lane; j < F2; j += 32) s = fmaf(dgr[j], to_f(wr[j]), s);
      s = warp_sum(s);
      if (lane == 0) dh[k] = part[k] + s;
    }
    __syncthreads();
  }
  for (int j = tid; j < F; j += blockDim.x) dh0[(size_t(dir) * B + b) * F + j] = dh[j];
}

template <typename T>
int launch(const void* xg, const void* xc, const void* hprev, const void* dys,
           const void* whg, const void* whc, float* dxg, float* dxc, void* rh, float* dh0,
           int n_steps, int B, int F, cudaStream_t stream) {
  const size_t smem = smem_bytes<T>(F);
  cudaError_t err = cudaFuncSetAttribute(bigru_scan_bwd_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         int(smem));
  if (err != cudaSuccess) return int(err);
  const int threads = ((2 * F + 31) / 32) * 32;
  dim3 grid(2, B);
  bigru_scan_bwd_kernel<T><<<grid, threads, smem, stream>>>(
      static_cast<const T*>(xg), static_cast<const T*>(xc), static_cast<const T*>(hprev),
      static_cast<const T*>(dys), static_cast<const T*>(whg), static_cast<const T*>(whc),
      dxg, dxc, static_cast<T*>(rh), dh0, n_steps, B, F);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

// Shared memory the kernel needs, so the wrapper can check it before launch.
size_t bigru_scan_bwd_smem_bytes(int F, int is_bf16) {
  return is_bf16 ? smem_bytes<__nv_bfloat16>(F) : smem_bytes<float>(F);
}

// xg [T,2,B,2F], xc/hprev/dys [T,2,B,F], whg [2,F,2F], whc [2,F,F] in T (f32
// or bf16) -> dxg [T,2,B,2F], dxc [T,2,B,F], dh0 [2,B,F] f32 and rh
// [T,2,B,F] in T.  Returns the CUDA error code.
int bigru_scan_bwd_launch(const void* xg, const void* xc, const void* hprev, const void* dys,
                          const void* whg, const void* whc, void* dxg, void* dxc, void* rh,
                          void* dh0, int n_steps, int B, int F, int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* gx = static_cast<float*>(dxg);
  float* cx = static_cast<float*>(dxc);
  float* h = static_cast<float*>(dh0);
  if (is_bf16)
    return launch<__nv_bfloat16>(xg, xc, hprev, dys, whg, whc, gx, cx, rh, h, n_steps, B, F, s);
  return launch<float>(xg, xc, hprev, dys, whg, whc, gx, cx, rh, h, n_steps, B, F, s);
}

}  // extern "C"
