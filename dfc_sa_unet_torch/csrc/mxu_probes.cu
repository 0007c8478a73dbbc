// Matrix-unit probes, for Hopper (sm_90a): a hand-written matrix product and a
// hand-written 3x3 conv in two weight layouts, to be timed beside cuBLAS and
// cuDNN by scripts/bench_torch_mxu.py.
//
// Replaces the TPU kernels of scripts/bench_mxu.py: pl_matmul (body
// _mm_kernel), pl_conv_cat (_conv_cat_kernel) and pl_conv_9dot
// (_conv_9dot_kernel), all through _pl_conv.  bf16 in and out, f32
// accumulation, rounded once.
//
//   probe_matmul     out[M,N]       = x[M,K] . w[K,N]
//   probe_conv_cat   out[B,H,W,Co]  = SAME conv3x3 of NHWC x, no bias; the
//                    weight is [3][3*Cin][Co]: for each row offset dy the three
//                    dx taps of a pixel side by side against w[dy]
//   probe_conv_9dot  the same conv; the weight is [9][Cin][Co]: one product per
//                    tap against w[dy*3 + dx]
//
// What the probes ask on this card: how close a product written by hand gets to
// the library's, and whether the tap schedule of a conv mainloop matters.
//
// The conv probes run on the pipelined wgmma mainloop of conv3x3_wgmma.cuh
// (128 pixels x 256 output channels a block, a 4-stage cp.async ring, one
// step's products in flight while the next step's copies land).  On the TPU the
// two schedules are different matrix shapes (three products of depth 3*Cin, or
// nine of depth Cin).  Here both become the same stream of (tap, 64-channel)
// steps, and the template parameter NDX (taps per row of the weight) only says
// where a step's weight rows lie in its layout; the two layouts put them at the
// same addresses.  So the probe now asks whether the schedule matters once
// loads overlap math, and on this card the answer is the stream's, not the
// layout's.
//
// probe_matmul keeps the mma.sync mainloop of conv3x3_mainloop.cuh (128 x 128
// tiles, 32-deep chunks, no overlap of loads and math), the one the port's
// dfc_tail, conv3x3_bn_relu and conv3x3_bias_stats kernels run on.
//
// What bounds them on the H100 at the probe's shape (B = 128, 56x56, 128 ->
// 256): the matmul at K = 384 does 2*K*N / (2*(K + N)) = 154 operations per
// byte, below the ~295 the card needs, so the bytes bound it; the conv does
// 9 times the operations on a third of the input bytes, so the tensor cores
// do.

#include <stdint.h>

#include "common.cuh"
#include "conv3x3_mainloop.cuh"
#include "conv3x3_wgmma.cuh"

namespace {

using bf16 = __nv_bfloat16;
constexpr int kM = 128;   // rows (pixels) per block
constexpr int kNT = 128;  // output columns per block
using Tile = MmaTile<kM, kNT>;

// out[m0.., n0..] <- acc rounded to bf16, two adjacent columns per store
__device__ void store_tile(const float (&acc)[Tile::ACC], bf16* __restrict__ out, int m0, int n0,
                           int rows, int cout) {
#pragma unroll
  for (int e = 0; e < Tile::ACC; e += 2) {
    const int m = m0 + Tile::row(e), n = n0 + Tile::col(e);  // n is even, cout a multiple of 8
    if (m < rows && n < cout)
      *reinterpret_cast<__nv_bfloat162*>(out + (size_t)m * cout + n) =
          __floats2bfloat162_rn(acc[e], acc[e + 1]);
  }
}

__global__ void __launch_bounds__(kThreads)
probe_matmul_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w, bf16* __restrict__ out,
                    int M, int K, int N) {
  constexpr int LDA = Tile::BK + kPad;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sa = reinterpret_cast<bf16*>(smem_raw);
  bf16* sw = sa + kM * LDA;
  const int n0 = blockIdx.x * kNT, m0 = blockIdx.y * kM;
  const RowSlots<bf16, kM, Tile::BK> rows(m0, M, 1, 1);
  float acc[Tile::ACC];
  zero(acc);
  for (int k0 = 0; k0 < K; k0 += Tile::BK) {
    rows.centre(sa, x, k0, K);
    Tile::load_w(sw, w, k0, K, n0, N, N);
    __syncthreads();
    Tile::mma(acc, sa, LDA, sw);
    __syncthreads();
  }
  store_tile(acc, out, m0, n0, M, N);
}

// NDX taps per row of the weight: 3 (cat, w3 [3][3*Cin][Cout]) or 1 (9dot, w9
// [9][Cin][Cout]).  Tap t, channel c lies in row (t % NDX)*Cin + c of block t / NDX.
template <int NDX>
__global__ void __launch_bounds__(wgconv::kThreads, 1)
probe_conv_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w, bf16* __restrict__ out,
                  int P, int H, int W, int cin, int cout) {
  wgconv::conv3x3_wgmma(x, w, out, P, H, W, cin, cout, [cin](int tap, int c) {
    return (size_t)(tap / NDX) * NDX * cin + (size_t)(tap % NDX) * cin + c;
  });
}

template <int NDX>
int launch_conv(const void* x, const void* w, void* out, int P, int H, int W, int cin, int cout,
                void* stream) {
  const cudaError_t err = cudaFuncSetAttribute(probe_conv_kernel<NDX>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, wgconv::kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(dfc::ceil_div(cout, wgconv::kBN), dfc::ceil_div(P, wgconv::kBM));
  probe_conv_kernel<NDX><<<grid, wgconv::kThreads, wgconv::kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w), static_cast<bf16*>(out), P, H, W,
      cin, cout);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int probe_matmul_bf16(const void* x, const void* w, void* out, int M, int K, int N,
                                 void* stream) {
  const size_t smem = sizeof(bf16) * ((size_t)kM * (Tile::BK + kPad) + Tile::SW_ELEMS);
  const dim3 grid(dfc::ceil_div(N, kNT), dfc::ceil_div(M, kM));
  probe_matmul_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w), static_cast<bf16*>(out), M, K, N);
  return static_cast<int>(cudaGetLastError());
}

// w3: [3][3*Cin][Cout]
extern "C" int probe_conv_cat_bf16(const void* x, const void* w3, void* out, int P, int H, int W,
                                   int cin, int cout, void* stream) {
  return launch_conv<3>(x, w3, out, P, H, W, cin, cout, stream);
}

// w9: [9][Cin][Cout]
extern "C" int probe_conv_9dot_bf16(const void* x, const void* w9, void* out, int P, int H, int W,
                                    int cin, int cout, void* stream) {
  return launch_conv<1>(x, w9, out, P, H, W, cin, cout, stream);
}
