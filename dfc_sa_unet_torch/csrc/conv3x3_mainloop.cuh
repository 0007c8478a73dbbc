// The SIMT 3x3 conv mainloop of the port's f32 conv kernels, for Hopper
// (sm_90a).
//
// An implicit GEMM: a block owns M pixels x NT output channels, gathers the
// nine taps straight from NHWC x (every image edge masked, so no padded copy
// of x and any H and W), streams the HWIO weight in BK-deep chunks through
// shared memory and accumulates in f32 registers on the SIMT units (each warp
// TM pixel rows, each lane the channels lane + 32*j), exact to f32 for the
// 1e-5 parity mode (wgmma has no f32 path; TF32 would break it).  Operands
// are staged with no overlap of loads and math.
//
// It carries the f32 paths: conv3x3_bias_stats (conv_bn_stats.cu) and
// conv3x3_bn_relu and the tail (dfc_tail.cu).  Every bf16 conv runs on wgmma
// (conv3x3_wgmma.cuh).  Each includer is its own translation unit, so
// everything here sits in an unnamed namespace.
#pragma once

#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;  // 8 warps
constexpr int kPad = 8;        // row padding of shared operands

// ---------------------------------------------------------------- the tiling
// SimtTile maps the block's M x NT output tile onto the 256 threads: each
// thread holds ACC accumulators, element e at (row(e), col(e)) of the tile;
// warp w owns rows w*TM.., lane l columns l + 32*j.  sw holds a weight chunk
// of BK rows (k) x NT columns (n).
template <typename T, int M, int NT>
struct SimtTile {
  static constexpr int TM = M / 8, TN = NT / 32, ACC = TM * TN;
  static constexpr int BK = sizeof(T) == 4 ? 8 : 16;
  static constexpr int SW_ELEMS = BK * NT;  // sw is [BK][NT]

  __device__ static int row(int e) { return (threadIdx.x / 32) * TM + e / TN; }
  __device__ static int col(int e) { return threadIdx.x % 32 + 32 * (e % TN); }

  // rows [k0, k0+BK) x columns [n0, n0+NT) of row-major w [K][ldw], zero
  // outside; cout and ldw are multiples of 8 (the wrappers check), so 16-byte loads
  __device__ static void load_w(T* sw, const T* __restrict__ w, int k0, int K, int n0, int cout,
                                int ldw) {
    constexpr int VEC = 16 / sizeof(T), NV = NT / VEC;
    for (int e = threadIdx.x; e < BK * NV; e += kThreads) {
      const int kk = e / NV, n = n0 + (e - kk * NV) * VEC;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (k0 + kk < K && n < cout) v = *reinterpret_cast<const uint4*>(w + (size_t)(k0 + kk) * ldw + n);
      *reinterpret_cast<uint4*>(sw + kk * NT + n - n0) = v;
    }
  }

  // acc += sa[:, 0:BK] . sw ; sa rows of stride lda
  __device__ static void mma(float (&acc)[ACC], const T* sa, int lda, const T* sw) {
    const T* arow = sa + (threadIdx.x / 32) * TM * lda;
    const int lane = threadIdx.x % 32;
    for (int kk = 0; kk < BK; ++kk) {
      float av[TM], bv[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) av[i] = dfc::to_f(arow[i * lda + kk]);
#pragma unroll
      for (int j = 0; j < TN; ++j) bv[j] = dfc::to_f(sw[kk * NT + lane + 32 * j]);
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i * TN + j] = fmaf(av[i], bv[j], acc[i * TN + j]);
    }
  }
};

template <int N>
__device__ __forceinline__ void zero(float (&acc)[N]) {
#pragma unroll
  for (int e = 0; e < N; ++e) acc[e] = 0.f;
}

// The pixels of a block's M-row tile as seen by one thread when it stages
// [M][BK] activation chunks with 16-byte loads: a thread's rows do not
// change from chunk to chunk, so their (pixel, h, w) are computed once.
// With halo rows (Halo = dfc::HaloRows<T>, row sharding) a tap that reaches
// row -1 or H reads the halo row at the pixel's image and column instead of
// zero.
template <typename T, int M, int BK, class Halo = dfc::NoHalo>
struct RowSlots {
  static constexpr int VEC = 16 / sizeof(T), VPR = BK / VEC, LDA = BK + kPad;
  static constexpr int SLOTS = (M * VPR + kThreads - 1) / kThreads;
  int pm[SLOTS], ph[SLOTS], pw[SLOTS];  // pixel index (-1: none), its h and w
  Halo halo;

  __device__ RowSlots(int m0, int P, int H, int W, Halo halo_rows = {}) : halo(halo_rows) {
#pragma unroll
    for (int s = 0; s < SLOTS; ++s) {
      const int slot = threadIdx.x + s * kThreads, m = m0 + slot / VPR;
      pm[s] = (slot < M * VPR && m < P) ? m : -1;
      pw[s] = m % W;
      ph[s] = (m / W) % H;
    }
  }

  // columns [k0, k0+BK) of the 3x3 taps, K = 9*cin, cin % VEC == 0
  __device__ void taps(T* sa, const T* __restrict__ x, int k0, int cin, int H, int W) const {
#pragma unroll
    for (int s = 0; s < SLOTS; ++s) {
      const int slot = threadIdx.x + s * kThreads;
      if (slot >= M * VPR) break;
      const int r = slot / VPR, kidx = k0 + (slot % VPR) * VEC;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (pm[s] >= 0 && kidx < 9 * cin) {
        const int tap = kidx / cin, ci = kidx - tap * cin;
        const int dy = tap / 3 - 1, dx = tap - 3 * (tap / 3) - 1;
        const int hh = ph[s] + dy, ww = pw[s] + dx;
        if (hh >= 0 && hh < H && ww >= 0 && ww < W)
          v = *reinterpret_cast<const uint4*>(x + (size_t)(pm[s] + dy * W + dx) * cin + ci);
        if constexpr (Halo::kOn) {
          const T* row = halo.row(hh);
          if ((hh < 0 || hh >= H) && ww >= 0 && ww < W && row != nullptr)
            v = *reinterpret_cast<const uint4*>(row + ((size_t)(pm[s] / W / H) * W + ww) * cin + ci);
        }
      }
      *reinterpret_cast<uint4*>(sa + r * LDA + (slot % VPR) * VEC) = v;
    }
  }

  // columns [k0, k0+BK) of the pixels themselves, cin % VEC == 0
  __device__ void centre(T* sa, const T* __restrict__ x, int k0, int cin) const {
#pragma unroll
    for (int s = 0; s < SLOTS; ++s) {
      const int slot = threadIdx.x + s * kThreads;
      if (slot >= M * VPR) break;
      const int r = slot / VPR, kidx = k0 + (slot % VPR) * VEC;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (pm[s] >= 0 && kidx < cin) v = *reinterpret_cast<const uint4*>(x + (size_t)pm[s] * cin + kidx);
      *reinterpret_cast<uint4*>(sa + r * LDA + (slot % VPR) * VEC) = v;
    }
  }
};

// Implicit-GEMM 3x3 conv, zero padding 1: acc += taps(x)[m0.., :] . w[:, n0..]
// Pixel m of [0, P) is (b, h, w) in row-major order; taps outside the image
// read as zero (rows -1 and H: the halo rows of rows.halo, where it has them).
// sa holds an [M][BK + kPad] tap chunk, sw a weight chunk.
template <typename T, typename Tile, int M, int NT, class Halo = dfc::NoHalo>
__device__ void conv3x3_mainloop(float (&acc)[Tile::ACC], const T* __restrict__ x,
                                 const T* __restrict__ w, const RowSlots<T, M, Tile::BK, Halo>& rows,
                                 int m0, int n0, int P, int H, int W, int cin, int cout, T* sa,
                                 T* sw) {
  constexpr int BK = Tile::BK, LDA = BK + kPad;
  const int K = 9 * cin;
  const bool vec = cin % RowSlots<T, M, BK>::VEC == 0;
  for (int k0 = 0; k0 < K; k0 += BK) {
    if (vec) {
      rows.taps(sa, x, k0, cin, H, W);
    } else {  // e.g. Cin = 3: element loads
      for (int e = threadIdx.x; e < M * BK; e += kThreads) {
        const int r = e / BK, kk = e - r * BK;
        const int m = m0 + r, kidx = k0 + kk;
        T val = dfc::from_f<T>(0.f);
        if (m < P && kidx < K) {
          const int tap = kidx / cin, ci = kidx - tap * cin;
          const int wq = m % W, t = m / W;
          const int hq = t % H, bq = t / H;
          const int hh = hq + tap / 3 - 1, ww = wq + tap % 3 - 1;
          if (hh >= 0 && hh < H && ww >= 0 && ww < W)
            val = x[(((size_t)bq * H + hh) * W + ww) * cin + ci];
          if constexpr (Halo::kOn) {
            const T* row = rows.halo.row(hh);
            if ((hh < 0 || hh >= H) && ww >= 0 && ww < W && row != nullptr)
              val = row[((size_t)bq * W + ww) * cin + ci];
          }
        }
        sa[r * LDA + kk] = val;
      }
    }
    Tile::load_w(sw, w, k0, K, n0, cout, cout);
    __syncthreads();
    Tile::mma(acc, sa, LDA, sw);
    __syncthreads();
  }
}

// acc += s_op[:, 0:depth] . w[0:depth, 0:NT]; s_op rows of stride lda, the
// weight streamed in BK-row chunks (depth is a multiple of BK)
template <typename T, typename Tile, int NT>
__device__ void gemm_from_smem(float (&acc)[Tile::ACC], const T* s_op, int lda, int depth,
                               const T* __restrict__ w, T* sw) {
  for (int k0 = 0; k0 < depth; k0 += Tile::BK) {
    Tile::load_w(sw, w, k0, depth, 0, NT, NT);
    __syncthreads();
    Tile::mma(acc, s_op + k0, lda, sw);
    __syncthreads();
  }
}

}  // namespace
