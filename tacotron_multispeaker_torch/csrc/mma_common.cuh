// Block-level product tiles shared by the conv-bank and Griffin-Lim kernels.
//
// One block computes a BM x BN tile of C = A[BM, Kd] * B[Kd, BN] with f32
// sums and leaves it in shared memory (Tile::out(s)[r * LDC + c], f32) for
// the caller's epilogue.  The caller gives two pointer functors:
//   pa(r, k) -> const T*   where A[r][k] is, or nullptr for a zero
//   pb(k, c) -> const T*   where B[k][c] is, or nullptr for a zero
// (k < Kd is guaranteed; the tile zero-fills k >= Kd itself).
//
// kern::Tile<T> picks the tile for the compute type:
//
// * bf16 (TileWmma, 128 x 64, four warps of 64 x 32): the products run on
//   the tensor cores through WMMA 16x16x16 fragments (mma.sync
//   underneath).  A and B are staged in 16-byte pieces (8 elements) with
//   cp.async into two shared-memory buffers, so the next BK-slice loads
//   while this one multiplies.  pa(r, k) for k a multiple of 8 must point
//   at 8 contiguous, 16-byte aligned elements of row r (the same for pb(k,
//   c) along c), and Kd must be a multiple of 8; the wrappers check this.
// * f32 (TileFma, 64 x 64): the tensor cores have no full-f32 mode, so each
//   thread accumulates an 8 x 4 block with FMAs on the CUDA cores, from
//   operands staged element by element.  It is the kernels' f32 check path.
//
// Bound: the bf16 tile reaches a part of the tensor cores' rate (WMMA
// rather than wgmma, two buffers rather than a deeper TMA ring); a wgmma
// tile is later work.

#pragma once

#include <mma.h>
#include <type_traits>

#include "common.cuh"

namespace kern {

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

template <int BM_, int BN_, int BK_, int NT_>
struct TileWmma {
  static constexpr int BM = BM_, BN = BN_, BK = BK_, NT = NT_;
  static constexpr int LDA = BK + 8;   // padded leading dims (elements): every
  static constexpr int LDB = BN + 8;   // row and WMMA fragment stays 32-byte
  static constexpr int LDC = BN + 4;   // aligned
  static constexpr int WN = NT / 64, TM = BM / 2, TN = BN / WN;
  static constexpr int FM = TM / 16, FN = TN / 16;
  static_assert(NT % 64 == 0 && TM % 16 == 0 && TN % 16 == 0 && BK % 16 == 0, "tile shape");
  static constexpr int A_ELEMS = BM * LDA, B_ELEMS = BK * LDB;
  static constexpr int AB_BYTES = 2 * (A_ELEMS + B_ELEMS) * 2, C_BYTES = BM * LDC * 4;
  // the two A/B buffers, then (after the last product) the f32 result
  struct Smem {
    alignas(128) unsigned char raw[AB_BYTES > C_BYTES ? AB_BYTES : C_BYTES];
  };
  using T = __nv_bfloat16;

  __device__ static T* abuf(Smem& s, int i) { return reinterpret_cast<T*>(s.raw) + i * A_ELEMS; }
  __device__ static T* bbuf(Smem& s, int i) {
    return reinterpret_cast<T*>(s.raw) + 2 * A_ELEMS + i * B_ELEMS;
  }
  __device__ static float* out(Smem& s) { return reinterpret_cast<float*>(s.raw); }

  template <class PA, class PB>
  __device__ static void load(Smem& s, int buf, int k0, int Kd, PA& pa, PB& pb) {
    const uint4 zero = make_uint4(0, 0, 0, 0);
    T* a = abuf(s, buf);
    for (int i = threadIdx.x; i < BM * BK / 8; i += NT) {
      const int r = i / (BK / 8), k = (i % (BK / 8)) * 8;
      const T* src = k0 + k < Kd ? pa(r, k0 + k) : nullptr;
      if (src) cp_async16(a + r * LDA + k, src);
      else *reinterpret_cast<uint4*>(a + r * LDA + k) = zero;
    }
    T* b = bbuf(s, buf);
    for (int i = threadIdx.x; i < BK * BN / 8; i += NT) {
      const int k = i / (BN / 8), c = (i % (BN / 8)) * 8;
      const T* src = k0 + k < Kd ? pb(k0 + k, c) : nullptr;
      if (src) cp_async16(b + k * LDB + c, src);
      else *reinterpret_cast<uint4*>(b + k * LDB + c) = zero;
    }
  }

  template <class PA, class PB>
  __device__ static void run(Smem& s, int Kd, PA pa, PB pb) {
    using namespace nvcuda;
    const int warp = threadIdx.x / 32, wm = warp / WN, wn = warp % WN;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[FM][FN];
#pragma unroll
    for (int i = 0; i < FM; ++i)
#pragma unroll
      for (int j = 0; j < FN; ++j) wmma::fill_fragment(acc[i][j], 0.f);
    const int nk = (Kd + BK - 1) / BK;
    load(s, 0, 0, Kd, pa, pb);
    cp_async_commit();
    for (int kt = 0; kt < nk; ++kt) {
      // the other buffer was last read in step kt-1, before its closing barrier
      if (kt + 1 < nk) load(s, (kt + 1) & 1, (kt + 1) * BK, Kd, pa, pb);
      cp_async_commit();
      cp_async_wait<1>();              // step kt's copies have landed
      __syncthreads();
      const T* a = abuf(s, kt & 1);
      const T* b = bbuf(s, kt & 1);
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> fa[FM];
        wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::row_major> fb[FN];
#pragma unroll
        for (int i = 0; i < FM; ++i)
          wmma::load_matrix_sync(fa[i], a + (wm * TM + i * 16) * LDA + kk, LDA);
#pragma unroll
        for (int j = 0; j < FN; ++j)
          wmma::load_matrix_sync(fb[j], b + kk * LDB + wn * TN + j * 16, LDB);
#pragma unroll
        for (int i = 0; i < FM; ++i)
#pragma unroll
          for (int j = 0; j < FN; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
      }
      __syncthreads();
    }
    cp_async_wait<0>();
    float* c = out(s);                 // aliases the buffers: every read is done
#pragma unroll
    for (int i = 0; i < FM; ++i)
#pragma unroll
      for (int j = 0; j < FN; ++j)
        wmma::store_matrix_sync(c + (wm * TM + i * 16) * LDC + wn * TN + j * 16, acc[i][j],
                                LDC, wmma::mem_row_major);
    __syncthreads();
  }
};

template <int BM_, int BN_, int BK_, int NT_>
struct TileFma {
  static constexpr int BM = BM_, BN = BN_, BK = BK_, NT = NT_;
  static constexpr int LDA = BK + 4, LDB = BN + 4, LDC = BN + 4;
  static constexpr int RN = 4, TX = BN / RN, TY = NT / TX, RM = BM / TY;
  static_assert(NT % TX == 0 && BM % TY == 0, "thread tile");
  struct Smem {
    float a[BM * LDA];
    float b[BK * LDB];
    float c[BM * LDC];
  };
  __device__ static float* out(Smem& s) { return s.c; }

  template <class PA, class PB>
  __device__ static void run(Smem& s, int Kd, PA pa, PB pb) {
    const int ty = threadIdx.x / TX, tx = threadIdx.x % TX;
    float acc[RM][RN];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < RN; ++j) acc[i][j] = 0.f;
    for (int k0 = 0; k0 < Kd; k0 += BK) {
      for (int i = threadIdx.x; i < BM * BK; i += NT) {
        const int r = i / BK, k = i % BK;
        const float* p = k0 + k < Kd ? pa(r, k0 + k) : nullptr;
        s.a[r * LDA + k] = p ? *p : 0.f;
      }
      for (int i = threadIdx.x; i < BK * BN; i += NT) {
        const int k = i / BN, c = i % BN;
        const float* p = k0 + k < Kd ? pb(k0 + k, c) : nullptr;
        s.b[k * LDB + c] = p ? *p : 0.f;
      }
      __syncthreads();
#pragma unroll 4
      for (int kk = 0; kk < BK; ++kk) {
        float av[RM], bv[RN];
#pragma unroll
        for (int i = 0; i < RM; ++i) av[i] = s.a[(ty * RM + i) * LDA + kk];
#pragma unroll
        for (int j = 0; j < RN; ++j) bv[j] = s.b[kk * LDB + tx * RN + j];
#pragma unroll
        for (int i = 0; i < RM; ++i)
#pragma unroll
          for (int j = 0; j < RN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < RN; ++j) s.c[(ty * RM + i) * LDC + tx * RN + j] = acc[i][j];
    __syncthreads();
  }
};

// the tile of a compute type: WMMA for bf16, FMAs for f32 (both 128 threads
// and 64 columns; the bf16 tile has 128 rows, the f32 tile 64)
template <typename T>
using Tile = typename std::conditional<std::is_same<T, __nv_bfloat16>::value,
                                       TileWmma<128, 64, 32, 128>,
                                       TileFma<64, 64, 32, 128>>::type;

}  // namespace kern
