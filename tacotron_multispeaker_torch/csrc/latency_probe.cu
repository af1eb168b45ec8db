// Latency probes behind the per-step bounds of the scans (not a kernel of
// the model): chip_smoke.py times each launch with CUDA events and divides
// by its count of dependent operations.
//
// - probe_l2_chase: one thread follows a chain of indices through a buffer
//   that sits in L2 (loads bypass L1: ld.global.cg), one dependent load a
//   hop -> one L2 round trip.
// - probe_cluster_sync: one cluster of C CTAs of CTHREADS threads; an iteration
//   stores one float into a peer's shared memory (DSMEM) and meets at a
//   cluster barrier (arrive.release / wait.acquire), as the decoder's
//   exchange does -> one exchange + barrier.
// - probe_l2_stream: each of ``blocks`` CTAs of 1024 threads reads an
//   L2-resident buffer with 16-byte loads, eight in flight a thread -> one
//   SM's L2 bandwidth (1 block) and the card's (one block an SM).
// - probe_block_exchange: one block of ``threads`` threads; an iteration
//   stores one float to shared memory, meets at __syncthreads and reads a
//   neighbour's -> one dependent phase of a block that runs a step on its
//   own SM (the GRU backward's scan): a barrier plus a shared-memory round
//   trip.
// - probe_smem_stream: one block of 1024 threads reads a 32 KB shared
//   buffer with 16-byte loads -> one SM's shared-memory bandwidth.
// - probe_mma_chain: one warp runs mma.sync.m16n8k16 bf16 products with
//   f32 sums, each adding into the sum of the one before -> one dependent
//   tensor-core product of the GRU forward's chain (csrc/bigru_scan.cu).

#include "cluster_common.cuh"

namespace {

using namespace clu;

__global__ void l2_chase_kernel(const int* __restrict__ next, int hops, int* sink) {
  int i = 0;
  for (int h = 0; h < hops; ++h) i = __ldcg(next + i);
  *sink = i;
}

__global__ void __launch_bounds__(CTHREADS) cluster_sync_kernel(int iters, float* sink) {
  __shared__ float slot[CTHREADS];
  const unsigned C = cluster_size(), k = cluster_rank();
  slot[threadIdx.x] = 0.f;
  cluster_sync();
  for (int it = 0; it < iters; ++it) {
    st_remote(slot + threadIdx.x, (k + 1 + unsigned(it)) % C, float(it));
    cluster_sync();
  }
  if (threadIdx.x == 0 && k == 0) *sink = slot[0];
}

constexpr int STREAM_THREADS = 1024;

__global__ void __launch_bounds__(STREAM_THREADS) l2_stream_kernel(const uint4* __restrict__ buf,
                                                             size_t n16, int reps,
                                                             float* sink) {
  // eight independent 16-byte loads in flight a thread (n16 a multiple of
  // 8 * STREAM_THREADS)
  uint32_t acc = 0;
  for (int r = 0; r < reps; ++r) {
    for (size_t i = threadIdx.x; i < n16; i += 8 * STREAM_THREADS) {
      uint4 v[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) v[u] = __ldcg(buf + i + u * STREAM_THREADS);
#pragma unroll
      for (int u = 0; u < 8; ++u) acc ^= v[u].x ^ v[u].y ^ v[u].z ^ v[u].w;
    }
  }
  if (acc == 0x12345678u) *sink = float(acc);   // keeps the loads
}

__global__ void __launch_bounds__(1024) block_exchange_kernel(int iters, float* sink) {
  __shared__ float slot[2][1024];   // two, so that one barrier an iteration suffices
  const int n = blockDim.x, i = threadIdx.x;
  float v = float(i);
  for (int it = 0; it < iters; ++it) {
    slot[it & 1][i] = v;
    __syncthreads();
    v = slot[it & 1][(i + 1) % n] + 1.f;
  }
  if (i == 0) *sink = v;
}

constexpr int SMEM_STREAM_SLOTS = 2048;   // 16-byte slots: 32 KB

__global__ void __launch_bounds__(STREAM_THREADS) smem_stream_kernel(int reps, float* sink) {
  __shared__ uint4 buf[SMEM_STREAM_SLOTS];
  for (int i = threadIdx.x; i < SMEM_STREAM_SLOTS; i += STREAM_THREADS)
    buf[i] = make_uint4(i, i + 1, i + 2, i + 3);
  __syncthreads();
  uint32_t acc = 0;
  for (int r = 0; r < reps; ++r) {
    // two 16-byte loads a thread: the whole buffer once a rep, conflict-free
    const int i = (threadIdx.x + r * 64) & (SMEM_STREAM_SLOTS - 1);
    const uint4 a = buf[i], b = buf[i ^ STREAM_THREADS];
    acc ^= a.x ^ a.y ^ a.z ^ a.w ^ b.x ^ b.y ^ b.z ^ b.w;
  }
  if (acc == 0x12345678u) *sink = float(acc);   // keeps the loads
}

__global__ void __launch_bounds__(32) mma_chain_kernel(int iters, float* sink) {
  // bf16 A and B values near 2^-8 from the lane number, so the sums stay
  // finite and the compiler cannot fold the chain
  const uint32_t v = 0x3b803b80u + (threadIdx.x & 7);
  float d[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 8
  for (int it = 0; it < iters; ++it)
    asm volatile("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
                 "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
                 : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
                 : "r"(v), "r"(v), "r"(v), "r"(v), "r"(v), "r"(v));
  if (threadIdx.x == 0) *sink = d[0] + d[1] + d[2] + d[3];
}

}  // namespace

extern "C" {

int probe_l2_chase(const void* next, int hops, void* sink, void* stream) {
  l2_chase_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(next), hops, static_cast<int*>(sink));
  return int(cudaGetLastError());
}

int probe_cluster_sync(int C, int iters, void* sink, void* stream) {
  if (C > 8) {
    const cudaError_t err = cudaFuncSetAttribute(
        cluster_sync_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return int(err);
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(unsigned(C), 1, 1);
  cfg.blockDim = dim3(CTHREADS, 1, 1);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = unsigned(C);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, cluster_sync_kernel, iters,
                                             static_cast<float*>(sink));
  if (err != cudaSuccess) return int(err);
  return int(cudaGetLastError());
}

int probe_l2_stream(const void* buf, size_t n16, int reps, int blocks, void* sink,
                    void* stream) {
  l2_stream_kernel<<<blocks, STREAM_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(buf), n16, reps, static_cast<float*>(sink));
  return int(cudaGetLastError());
}

// One barrier + shared-memory exchange of a block of ``threads`` threads, ``iters`` times.
int probe_block_exchange(int threads, int iters, void* sink, void* stream) {
  block_exchange_kernel<<<1, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      iters, static_cast<float*>(sink));
  return int(cudaGetLastError());
}

// One block reading 32 KB of shared memory ``reps`` times (bytes: reps * 32768).
int probe_smem_stream(int reps, void* sink, void* stream) {
  smem_stream_kernel<<<1, STREAM_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      reps, static_cast<float*>(sink));
  return int(cudaGetLastError());
}

// One warp's chain of ``iters`` dependent mma.sync.m16n8k16 bf16 products.
int probe_mma_chain(int iters, void* sink, void* stream) {
  mma_chain_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      iters, static_cast<float*>(sink));
  return int(cudaGetLastError());
}

}  // extern "C"
