// The mma.sync / SIMT 3x3 conv mainloop of the port's older conv kernels, for
// Hopper (sm_90a).
//
// An implicit GEMM: a block owns M pixels x NT output channels, gathers the
// nine taps straight from NHWC x (every image edge masked, so no padded copy
// of x and any H and W), streams the HWIO weight in BK-deep chunks through
// shared memory and accumulates in f32 registers.  bf16 runs on the tensor
// cores (mma.sync m16n8k16; 8 warps as 2 x 4 over the M x N tile); f32 runs
// on the SIMT units (each warp TM pixel rows, each lane the channels
// lane + 32*j), exact to f32.  Operands are staged with no overlap of loads
// and math.
//
// It carries conv3x3_bias_stats (conv_bn_stats.cu, bf16 and f32) and the f32
// paths of dfc_tail.cu (conv3x3_bn_relu and the tail).  The bf16
// conv3x3_bn_relu, the bf16 tail and the matrix-unit probes run on wgmma
// (conv3x3_wgmma.cuh).  Each includer is its own translation unit, so
// everything here sits in an unnamed namespace.
#pragma once

#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;  // 8 warps
constexpr int kPad = 8;        // row padding of shared operands: conflict-free mma loads

// ---------------------------------------------------------------- tilings
// A tiling maps the block's M x NT output tile onto the 256 threads: each
// thread holds ACC accumulators, element e at (row(e), col(e)) of the tile.
// sw holds a weight chunk of BK rows (k) x NT columns (n).

// f32 (any T): SIMT FMAs; warp w owns rows w*TM.., lane l columns l + 32*j
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

// bf16: tensor cores.  Warps 2 (rows) x 4 (columns); a warp's WM x WN tile
// is MT x NTT mma tiles of 16 x 8; element e = ((mt*NTT + nt)*4 + r) is the
// fragment register r of tile (mt, nt) (PTX ISA, mma.m16n8k16 layouts).
template <int M, int NT>
struct MmaTile {
  static constexpr int WM = M / 2, WN = NT / 4, MT = WM / 16, NTT = WN / 8;
  static constexpr int ACC = MT * NTT * 4;
  static constexpr int BK = 32;
  static constexpr int LDW = BK + kPad;
  static constexpr int SW_ELEMS = NT * LDW;  // sw is [NT][LDW]: k contiguous per column
  static_assert(WM % 16 == 0 && WN % 8 == 0, "tile too small for mma.m16n8k16");

  __device__ static int row(int e) {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    return (warp / 4) * WM + (e / (4 * NTT)) * 16 + lane / 4 + ((e & 2) ? 8 : 0);
  }
  __device__ static int col(int e) {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    return (warp % 4) * WN + ((e / 4) % NTT) * 8 + (lane % 4) * 2 + (e & 1);
  }

  // sw[n][k] <- w[k0+k][n0+n], two k rows packed per 32-bit word; cout and
  // ldw are multiples of 8 (the wrappers check), so 16-byte loads of 8 columns
  __device__ static void load_w(__nv_bfloat16* sw, const __nv_bfloat16* __restrict__ w, int k0,
                                int K, int n0, int cout, int ldw) {
    for (int e = threadIdx.x; e < (BK / 2) * (NT / 8); e += kThreads) {
      const int kp = e % (BK / 2), nn = (e / (BK / 2)) * 8;
      const int kidx = k0 + 2 * kp, n = n0 + nn;
      uint4 r0 = make_uint4(0, 0, 0, 0), r1 = r0;
      if (n < cout) {
        if (kidx < K) r0 = *reinterpret_cast<const uint4*>(w + (size_t)kidx * ldw + n);
        if (kidx + 1 < K) r1 = *reinterpret_cast<const uint4*>(w + (size_t)(kidx + 1) * ldw + n);
      }
      const __nv_bfloat16* v0 = reinterpret_cast<const __nv_bfloat16*>(&r0);
      const __nv_bfloat16* v1 = reinterpret_cast<const __nv_bfloat16*>(&r1);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        __nv_bfloat162 pair;
        pair.x = v0[j];
        pair.y = v1[j];
        *reinterpret_cast<__nv_bfloat162*>(sw + (nn + j) * LDW + 2 * kp) = pair;
      }
    }
  }

  __device__ static uint32_t ld2(const __nv_bfloat16* p) {
    return *reinterpret_cast<const uint32_t*>(p);
  }

  __device__ static void mma(float (&acc)[ACC], const __nv_bfloat16* sa, int lda,
                             const __nv_bfloat16* sw) {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int g = lane / 4, t = lane % 4;
    const __nv_bfloat16* abase = sa + ((warp / 4) * WM + g) * lda + 2 * t;
    const __nv_bfloat16* bbase = sw + ((warp % 4) * WN + g) * LDW + 2 * t;
#pragma unroll
    for (int ks = 0; ks < BK; ks += 16) {
      uint32_t a[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const __nv_bfloat16* p = abase + mt * 16 * lda + ks;
        a[mt][0] = ld2(p);
        a[mt][1] = ld2(p + 8 * lda);
        a[mt][2] = ld2(p + 8);
        a[mt][3] = ld2(p + 8 * lda + 8);
      }
#pragma unroll
      for (int nt = 0; nt < NTT; ++nt) {
        const __nv_bfloat16* p = bbase + nt * 8 * LDW + ks;
        const uint32_t b0 = ld2(p), b1 = ld2(p + 8);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          float* c = acc + (mt * NTT + nt) * 4;
          asm volatile(
              "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
              "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
              : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
              : "r"(a[mt][0]), "r"(a[mt][1]), "r"(a[mt][2]), "r"(a[mt][3]), "r"(b0), "r"(b1));
        }
      }
    }
  }
};

template <typename T, int M, int NT>
struct TileFor {
  using type = SimtTile<T, M, NT>;
};
template <int M, int NT>
struct TileFor<__nv_bfloat16, M, NT> {
  using type = MmaTile<M, NT>;
};

template <int N>
__device__ __forceinline__ void zero(float (&acc)[N]) {
#pragma unroll
  for (int e = 0; e < N; ++e) acc[e] = 0.f;
}

// The pixels of a block's M-row tile as seen by one thread when it stages
// [M][BK] activation chunks with 16-byte loads: a thread's rows do not
// change from chunk to chunk, so their (pixel, h, w) are computed once.
template <typename T, int M, int BK>
struct RowSlots {
  static constexpr int VEC = 16 / sizeof(T), VPR = BK / VEC, LDA = BK + kPad;
  static constexpr int SLOTS = (M * VPR + kThreads - 1) / kThreads;
  int pm[SLOTS], ph[SLOTS], pw[SLOTS];  // pixel index (-1: none), its h and w

  __device__ RowSlots(int m0, int P, int H, int W) {
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
// read as zero.  sa holds an [M][BK + kPad] tap chunk, sw a weight chunk.
template <typename T, typename Tile, int M, int NT>
__device__ void conv3x3_mainloop(float (&acc)[Tile::ACC], const T* __restrict__ x,
                                 const T* __restrict__ w, const RowSlots<T, M, Tile::BK>& rows,
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
