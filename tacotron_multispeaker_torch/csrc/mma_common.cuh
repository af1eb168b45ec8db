// The f32 block-level product tile of the conv-bank and Griffin-Lim kernels
// (their check path; their bf16 products run on wgmma, sm90_common.cuh).
//
// One block computes a BM x BN tile of C = A[BM, Kd] * B[Kd, BN] with f32
// sums and leaves it in shared memory (Tile::out(s)[r * LDC + c], f32) for
// the caller's epilogue.  The caller gives two pointer functors:
//   pa(r, k) -> const float*   where A[r][k] is, or nullptr for a zero
//   pb(k, c) -> const float*   where B[k][c] is, or nullptr for a zero
// (k < Kd is guaranteed; the tile zero-fills k >= Kd itself).
//
// TileFma (kern::TileF32: 64 x 64, 128 threads): the tensor cores have no
// full-f32 mode, so each thread accumulates an 8 x 4 block with FMAs on the
// CUDA cores, from operands staged element by element.

#pragma once

#include "common.cuh"

namespace kern {

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

using TileF32 = TileFma<64, 64, 32, 128>;

}  // namespace kern
