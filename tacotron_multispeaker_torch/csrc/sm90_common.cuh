// Hopper (sm_90a) building blocks: mbarriers, TMA tile loads, shared-memory
// matrix descriptors and the bf16 warpgroup product (wgmma) with f32 sums.
//
// * fence_proxy_async: shared-memory tiles that threads wrote become
//   visible to wgmma.
// * mbarriers: mbar_init / mbar_expect_tx / mbar_arrive / mbar_wait (phase
//   parity as PTX defines it: wait(p) returns once the phase of parity p
//   has completed; a wait of seconds traps).
// * tma_load_3d: one thread copies a box of a 3-D tensor map into shared
//   memory and the copy completes the transaction count of an mbarrier.
//   Coordinates are signed; elements outside the tensor arrive as zeros.
// * bulk_load: the same for one contiguous 1-D range (cp.async.bulk), no
//   tensor map.
// * smem_desc: the 64-bit wgmma descriptor of a tile in shared memory
//   (start >> 4, leading and stride byte offsets >> 4, swizzle mode).
//   K-major with swizzle: rows of the swizzle width, the stride byte offset
//   steps over 8 rows, the leading offset is unused.  MN-major with swizzle:
//   the leading byte offset steps over a swizzle-width chunk of M or N, the
//   stride byte offset over 8 rows of K.
// * wgmma_m64n128k16: D[64 x 128] += A[64 x 16] * B[16 x 128] for one
//   warpgroup, B N-major (wgmma's transpose bit for B); A K-major, or
//   M-major with TRANS_A = 1 (the same 128-byte rows as B, one per k:
//   csrc/wgrad.cu, whose products reduce over the rows of both factors).
//   Thread t of the warpgroup holds d[i] = D[16 (t/32) + (t%32)/4 + 8 ((i/2)%2),
//   8 (i/4) + 2 (t%4) + i%2].
// * kblock: KS 16-deep wgmma steps over one stage of a TMA ring (A K-major,
//   B N-major as two 64-column boxes with 128-byte swizzle).
// * Host side: make_map, a 3-D bf16 TMA tensor map (cuTensorMapEncodeTiled,
//   fetched through the runtime, so a library needs no -lcuda).
//
// csrc/conv_bank.cu, csrc/gl_iteration.cu (their bf16 paths),
// csrc/teacher_decoder_bwd.cu and csrc/bigru_scan_bwd.cu (their bf16
// prologues), csrc/wgrad.cu (its tensor-core route) and
// csrc/attention_step.cu (its slabs, by bulk_load) include it.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace sm90 {

enum Swizzle : uint32_t { kSwizzle128B = 1, kSwizzle32B = 3 };

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}
// makes the initialised barriers visible to the async (TMA) proxy
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
// A wait that outlasts ~2^26 polls (seconds) traps: a lost transaction
// becomes a launch error instead of a hung card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done, polls = 0;
  do {
    if (++polls == (1u << 26)) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// One thread copies ``bytes`` contiguous bytes of global memory into this
// CTA's shared memory; the copy completes that many bytes of an mbarrier's
// transaction count.  Both addresses and the size are multiples of 16.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ uint64_t smem_desc(const void* p, uint32_t lbo_bytes,
                                              uint32_t sbo_bytes, Swizzle swizzle) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo_bytes >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo_bytes >> 4) & 0x3FFF) << 32) | ((uint64_t)swizzle << 62);
}

// orders this thread's generic-proxy writes to shared memory before later
// async-proxy reads of it (wgmma operands that threads, not TMA, wrote)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from moving accumulator reads or writes across the
// asynchronous products
__device__ __forceinline__ void fence_operands(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int TRANS_A = 0>
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t desc_a,
                                                 uint64_t desc_b) {
  // scale-d is a predicate: set, the product adds to D; then the scales of
  // A and B, A's transpose bit (TRANS_A) and B's (always 1: N-major)
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, %67, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(1), "n"(TRANS_A));
}

// KS 16-deep steps of one k-block for a consumer warpgroup.  a: the stage's
// A tile at the warpgroup's first row, K-major rows of AW elements (AW * 2
// bytes, 8-row groups 8 * AW * 2 bytes apart; a 64-wide box holds four steps
// 32 bytes apart, a 16-wide box one, the boxes BM rows apart).  bt: the B
// tile, N-major 128-byte rows of 64 columns, one per k, 8-row groups 1024
// bytes apart, the second 64-column box b_lbo bytes on.
template <int KS, int AW, int BM>
__device__ __forceinline__ void kblock(float (&acc)[64], const unsigned char* a,
                                       const unsigned char* bt, uint32_t b_lbo) {
  constexpr Swizzle a_swz = AW == 64 ? kSwizzle128B : kSwizzle32B;
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    const unsigned char* pa = a + (ks / (AW / 16)) * BM * AW * 2 + (ks % (AW / 16)) * 32;
    const uint64_t da = smem_desc(pa, 16, 8 * AW * 2, a_swz);
    const uint64_t db = smem_desc(bt + ks * 16 * 128, b_lbo, 1024, kSwizzle128B);
    wgmma_m64n128k16(acc, da, db);
  }
}

// ------------------------------------------------------------------- host

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled is a driver-API call: fetched through the runtime,
// so the library needs no -lcuda
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) ==
            cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a 3-D bf16 tensor map over a contiguous [d2, d1, d0] array, boxes of
// [1, b1, b0] elements; elements outside the array arrive as zeros
inline bool make_map(CUtensorMap* map, const void* base, uint64_t d0, uint64_t d1, uint64_t d2,
                     uint32_t b0, uint32_t b1, CUtensorMapSwizzle swizzle) {
  EncodeTiled encode = encode_tiled();
  if (!encode) return false;
  const cuuint64_t dims[3] = {d0, d1, d2};
  const cuuint64_t strides[2] = {d0 * 2, d0 * d1 * 2};
  const cuuint32_t box[3] = {b0, b1, 1}, estr[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims,
                strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace sm90
