// conv3x3 + bias with a BatchNorm-statistics epilogue, for Hopper (sm_90a).
//
// Replaces the TPU kernel of scripts/bench_bn_stats.py (make_pallas, body
// _kernel): the training probe that asks whether a conv3x3 which also emits
// the sums BatchNorm needs can beat a conv followed by separate reductions.
//
//   acc  = conv3x3(x) + b                          f32, padding 1, no ReLU
//   y    = acc rounded to x's type                 written once
//   S[j] = sum over a tile's pixels of acc         f32, per channel, unrounded
//   Q[j] = sum over a tile's pixels of acc^2
//
// One [C] row of S and of Q is written per tile of pixels into [tiles, C]
// partials; the wrapper sums the rows and divides by N*H*W.  Activations
// NHWC, the bias f32.
//
// What bounds it on the H100: in bf16 it does 18*Cin operations per output
// value and moves 2*(Cin + Cout) bytes per pixel, so the tensor cores bound
// it from Cin = 64 up and memory (822 MB of y at 224x224 x 64, B=128) bounds
// the Cin = 3 level.  The kernel's point is the epilogue: y is never read
// back from device memory for the statistics.  The TPU kernel's row tiling,
// halo windows and padded copy of x are not carried over.
//
// bf16 runs on the wgmma kernels of conv3x3_wgmma.cuh with the BiasStats
// epilogue, K walked flat (the weight [9 * Cin8][Cout], ops/dfc_tail.py::
// pack_conv_taps), at the tiling ops/conv_bn_stats.py::stats_tiling gives
// (the wrapper passes it; conv_tiling's with three stages at NB = 128):
//   - Cin > 8 or Cout > 64 (down2..down4): the ring, wgconv::conv3x3_wgmma, 128
//     pixels x NB channels a block, weight tiles by TMA; one partial row per
//     128-pixel tile (blockIdx.x), columns n0 .. n0 + NB;
//   - Cin 3 or 8 at Cout <= 64 (down1): the persistent one-warpgroup kernel,
//     wgconv::conv3x3_wgmma_narrow, which reads RGB as it is and stores y by
//     TMA; one partial row per 64-pixel tile t.
// f32 runs on the SIMT mainloop of conv3x3_mainloop.cuh (exact to f32), one
// partial row per block of kM pixels.
//
// The reductions use no atomics, and a row belongs to a tile of pixels, never
// to a block of a grid sized from the card, so the same inputs give the same
// bits run to run.  Rows past the last pixel are counted as zero: they gather
// zero taps, so their acc is the bias, which their y (clipped) never shows.

#include <cuda.h>
#include <stdint.h>

#include "common.cuh"
#include "conv3x3_mainloop.cuh"
#include "conv3x3_wgmma.cuh"

namespace {

// ---------------------------------------------------------------- f32, SIMT

constexpr int kM = 64;       // pixels per block
constexpr int kRedPad = 8;   // row padding of the reduction tile

template <int NT>
constexpr size_t stats_smem_bytes() {
  using Tile = SimtTile<float, kM, NT>;
  const size_t mainloop = sizeof(float) * (kM * (Tile::BK + kPad) + Tile::SW_ELEMS);
  const size_t reduce = sizeof(float) * kM * (NT + kRedPad);
  return mainloop > reduce ? mainloop : reduce;
}

// Each thread stores its accumulators (bias added, rows past the last pixel as zero) into an
// [M][NT + 8] f32 tile in shared memory, then thread n sums column n over the M rows in a fixed
// order and writes S and Q.
template <int NT>
__global__ void __launch_bounds__(kThreads)
conv3x3_bias_stats_kernel(const float* __restrict__ x, const float* __restrict__ w,
                          const float* __restrict__ bias, float* __restrict__ out,
                          float* __restrict__ psum, float* __restrict__ psq, int P, int H, int W,
                          int cin, int cout) {
  using Tile = SimtTile<float, kM, NT>;
  constexpr int LDR = NT + kRedPad;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sa = reinterpret_cast<float*>(smem_raw);
  float* sw = sa + kM * (Tile::BK + kPad);
  float* red = reinterpret_cast<float*>(smem_raw);  // reused once the mainloop is done
  const int m0 = blockIdx.x * kM, n0 = blockIdx.y * NT;
  const RowSlots<float, kM, Tile::BK> rows(m0, P, H, W);
  float acc[Tile::ACC];
  zero(acc);
  // ends on a __syncthreads(): sa and sw are free afterwards
  conv3x3_mainloop<float, Tile, kM, NT>(acc, x, w, rows, m0, n0, P, H, W, cin, cout, sa, sw);
#pragma unroll
  for (int e = 0; e < Tile::ACC; ++e) {
    const int r = Tile::row(e), c = Tile::col(e);
    const int m = m0 + r, n = n0 + c;
    float v = 0.f;
    if (m < P && n < cout) {
      v = acc[e] + bias[n];
      out[(size_t)m * cout + n] = v;
    }
    red[r * LDR + c] = v;
  }
  __syncthreads();
  for (int c = threadIdx.x; c < NT; c += kThreads) {
    const int n = n0 + c;
    if (n >= cout) continue;
    float s = 0.f, q = 0.f;
    for (int r = 0; r < kM; ++r) {
      const float v = red[r * LDR + c];
      s += v;
      q = fmaf(v, v, q);
    }
    psum[(size_t)blockIdx.x * cout + n] = s;
    psq[(size_t)blockIdx.x * cout + n] = q;
  }
}

template <int NT>
int launch_stats_f32(const void* x, const void* w, const void* b, void* out, void* psum, void* psq, int P, int H,
                     int W, int cin, int cout, cudaStream_t stream) {
  constexpr size_t smem = stats_smem_bytes<NT>();
  cudaFuncSetAttribute(conv3x3_bias_stats_kernel<NT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  const dim3 grid(dfc::ceil_div(P, kM), dfc::ceil_div(cout, NT));
  conv3x3_bias_stats_kernel<NT><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(w), static_cast<const float*>(b),
      static_cast<float*>(out), static_cast<float*>(psum), static_cast<float*>(psq), P, H, W, cin, cout);
  return static_cast<int>(cudaGetLastError());
}

int stats_dispatch_f32(const void* x, const void* w, const void* b, void* out, void* psum, void* psq, int P, int H,
                       int W, int cin, int cout, cudaStream_t s) {
  if (cout <= 32) return launch_stats_f32<32>(x, w, b, out, psum, psq, P, H, W, cin, cout, s);
  if (cout <= 64) return launch_stats_f32<64>(x, w, b, out, psum, psq, P, H, W, cin, cout, s);
  if (cout <= 128) return launch_stats_f32<128>(x, w, b, out, psum, psq, P, H, W, cin, cout, s);
  return launch_stats_f32<256>(x, w, b, out, psum, psq, P, H, W, cin, cout, s);
}

// ---------------------------------------------------------------- bf16, wgmma

using bf16 = __nv_bfloat16;

// the ring: w [9 * cin][cout] read by TMA through wmap; row blockIdx.x of psum and psq
template <int NB, int STAGES>
__global__ void __launch_bounds__(wgconv::kThreads, wgconv::conv_blocks(wgconv::conv_smem_bytes<NB, STAGES, true>()))
conv3x3_bias_stats_wgmma_kernel(const bf16* __restrict__ x, const float* __restrict__ bias, bf16* __restrict__ out,
                                float* __restrict__ psum, float* __restrict__ psq, int P, int H, int W, int cin,
                                int cout, const __grid_constant__ CUtensorMap wmap) {
  wgconv::conv3x3_wgmma<NB, STAGES, true>(x, nullptr, &wmap, out, P, H, W, cin, cout,
                                          wgconv::BiasStats{bias, cout, psum, psq});
}

template <int NB, int STAGES>
int launch_stats_wgmma(const void* x, const void* w, const void* b, void* out, void* psum, void* psq, int P, int H,
                       int W, int cin, int cout, cudaStream_t stream) {
  constexpr int smem = wgconv::conv_smem_bytes<NB, STAGES, true>();
  CUtensorMap wmap;
  if (!wgconv::encode_tiled()) return static_cast<int>(cudaErrorNotSupported);
  if (!wgconv::tile_map(&wmap, w, cout, 9 * (uint64_t)cin, 1, 64)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = cudaFuncSetAttribute(conv3x3_bias_stats_wgmma_kernel<NB, STAGES>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(dfc::ceil_div(P, wgconv::kBM), dfc::ceil_div(cout, NB));
  conv3x3_bias_stats_wgmma_kernel<NB, STAGES><<<grid, wgconv::kThreads, smem, stream>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(b), static_cast<bf16*>(out), static_cast<float*>(psum),
      static_cast<float*>(psq), P, H, W, cin, cout, wmap);
  return static_cast<int>(cudaGetLastError());
}

// Cin 3 or 8 at Cout <= 64 (down1): the persistent kernel, x [P][CIN] read as it is, w [72][cout],
// y by TMA through omap; row t of psum and psq for tile t.  Three blocks an SM, not conv3x3_bn_relu's
// four: at 128 registers the reduction spilled 4-20 bytes and down1 read 0.59-0.60 ms, at three
// blocks (165-168 registers, no spill) 0.57 (H100 80GB HBM3, 700 W, scripts/bench_torch_bn_stats.py).
template <int CIN>
__global__ void __launch_bounds__(wgconv::kNarrowThreads, 3)
conv3x3_bias_stats_narrow_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                                 const float* __restrict__ bias, float* __restrict__ psum, float* __restrict__ psq,
                                 int P, int H, int W, int cout, const __grid_constant__ CUtensorMap omap) {
  wgconv::conv3x3_wgmma_narrow<CIN>(x, w, &omap, P, H, W, cout, wgconv::BiasStats{bias, cout, psum, psq});
}

template <int CIN>
int launch_stats_narrow(const void* x, const void* w, const void* b, void* out, void* psum, void* psq, int P, int H,
                        int W, int cout, cudaStream_t stream) {
  constexpr int smem = wgconv::kNarrowSmemBytes + wgconv::kNarrowStatsBytes;
  if (cout > 64) return static_cast<int>(cudaErrorInvalidValue);
  if (!wgconv::encode_tiled()) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap omap;
  if (!wgconv::tile_map(&omap, out, cout, P, 1, 64)) return static_cast<int>(cudaErrorInvalidValue);
  int blocks = 0;
  const cudaError_t err = wgconv::persistent_blocks(conv3x3_bias_stats_narrow_kernel<CIN>, wgconv::kNarrowThreads,
                                                    smem, dfc::ceil_div(P, wgconv::kNarrowBM), &blocks);
  if (err != cudaSuccess) return static_cast<int>(err);
  conv3x3_bias_stats_narrow_kernel<CIN><<<blocks, wgconv::kNarrowThreads, smem, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w), static_cast<const float*>(b),
      static_cast<float*>(psum), static_cast<float*>(psq), P, H, W, cout, omap);
  return static_cast<int>(cudaGetLastError());
}

// the tilings ops/conv_bn_stats.py::stats_tiling gives: (B tile width, ring stages; 0: the persistent
// kernel, which reads x's cin = 3 or 8 channels)
int stats_dispatch_bf16(const void* x, const void* w, const void* b, void* out, void* psum, void* psq, int P, int H,
                        int W, int cin, int cout, int nb, int stages, cudaStream_t s) {
  if (cout % 8) return static_cast<int>(cudaErrorInvalidValue);  // 16-byte rows of w and out
  if (nb == 64 && stages == 0 && cin == 3) return launch_stats_narrow<3>(x, w, b, out, psum, psq, P, H, W, cout, s);
  if (nb == 64 && stages == 0 && cin == 8) return launch_stats_narrow<8>(x, w, b, out, psum, psq, P, H, W, cout, s);
  if (cin % 8) return static_cast<int>(cudaErrorInvalidValue);  // 16-byte rows of x
  if (nb == 64 && stages == 4) return launch_stats_wgmma<64, 4>(x, w, b, out, psum, psq, P, H, W, cin, cout, s);
  if (nb == 128 && stages == 3) return launch_stats_wgmma<128, 3>(x, w, b, out, psum, psq, P, H, W, cin, cout, s);
  if (nb == 256 && stages == 4) return launch_stats_wgmma<256, 4>(x, w, b, out, psum, psq, P, H, W, cin, cout, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// w: HWIO [3,3,cin,cout]; psum, psq: [ceil(P / 64), cout] f32, one row per block of 64 pixels
extern "C" int conv3x3_bias_stats_f32(const void* x, const void* w, const void* b, void* out,
                                      void* psum, void* psq, int P, int H, int W, int cin,
                                      int cout, void* stream) {
  return stats_dispatch_f32(x, w, b, out, psum, psq, P, H, W, cin, cout, static_cast<cudaStream_t>(stream));
}

// w: [9 * cin8][cout] (ops/dfc_tail.py::pack_conv_taps); nb, stages: conv_tiling's; psum, psq:
// [ceil(P / bm), cout] f32, one row per tile of conv_tiling's bm pixels (128 on the ring, 64 on the
// persistent kernel)
extern "C" int conv3x3_bias_stats_bf16(const void* x, const void* w, const void* b, void* out,
                                       void* psum, void* psq, int P, int H, int W, int cin,
                                       int cout, int nb, int stages, void* stream) {
  return stats_dispatch_bf16(x, w, b, out, psum, psq, P, H, W, cin, cout, nb, stages,
                             static_cast<cudaStream_t>(stream));
}
