// conv3x3 + bias with a BatchNorm-statistics epilogue, for Hopper (sm_90a).
//
// Replaces the TPU kernel of scripts/bench_bn_stats.py (make_pallas, body
// _kernel): the training probe that asks whether a conv3x3 which also emits
// the sums BatchNorm needs can beat a conv followed by separate reductions.
//
//   acc  = conv3x3(x) + b                      f32, padding 1, no ReLU
//   y    = acc rounded to x's type             written once
//   S[j] = sum over the block's pixels of acc  f32, per channel, unrounded
//   Q[j] = sum over the block's pixels of acc^2
//
// One [C] row of S and of Q is written per block of M pixels into
// [num_blocks, C] partials; the wrapper sums the rows and divides by N*H*W.
// Activations NHWC, the weight HWIO [3,3,Cin,Cout], the bias f32.
//
// What bounds it on the H100: in bf16 it does 18*Cin operations per output
// value and moves 2*(Cin + Cout) bytes per pixel, so the tensor cores bound
// it from Cin = 64 up and memory bounds the Cin = 3 level.  The kernel's
// point is the epilogue: y is never read back from device memory for the
// statistics.  The TPU kernel's row tiling, halo windows and padded copy of
// x are not carried over: the shared mainloop (conv3x3_mainloop.cuh) gathers
// the taps from x and masks the image edges.
//
// The reduction uses no atomics, so the result is the same run to run: each
// thread stores its accumulators (bias added, rows past the last pixel as
// zero) into an [M][NT + 8] f32 tile in shared memory, then thread n sums
// column n over the M rows in a fixed order and writes S and Q.

#include <stdint.h>

#include "common.cuh"
#include "conv3x3_mainloop.cuh"

namespace {

constexpr int kM = 64;       // pixels per block
constexpr int kRedPad = 8;   // row padding of the reduction tile

template <typename T, int NT>
constexpr size_t stats_smem_bytes() {
  using Tile = typename TileFor<T, kM, NT>::type;
  const size_t mainloop = sizeof(T) * (kM * (Tile::BK + kPad) + Tile::SW_ELEMS);
  const size_t reduce = sizeof(float) * kM * (NT + kRedPad);
  return mainloop > reduce ? mainloop : reduce;
}

template <typename T, int NT>
__global__ void __launch_bounds__(kThreads)
conv3x3_bias_stats_kernel(const T* __restrict__ x, const T* __restrict__ w,
                          const float* __restrict__ bias, T* __restrict__ out,
                          float* __restrict__ psum, float* __restrict__ psq, int P, int H, int W,
                          int cin, int cout) {
  using Tile = typename TileFor<T, kM, NT>::type;
  constexpr int LDR = NT + kRedPad;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sa = reinterpret_cast<T*>(smem_raw);
  T* sw = sa + kM * (Tile::BK + kPad);
  float* red = reinterpret_cast<float*>(smem_raw);  // reused once the mainloop is done
  const int m0 = blockIdx.x * kM, n0 = blockIdx.y * NT;
  const RowSlots<T, kM, Tile::BK> rows(m0, P, H, W);
  float acc[Tile::ACC];
  zero(acc);
  // ends on a __syncthreads(): sa and sw are free afterwards
  conv3x3_mainloop<T, Tile, kM, NT>(acc, x, w, rows, m0, n0, P, H, W, cin, cout, sa, sw);
#pragma unroll
  for (int e = 0; e < Tile::ACC; ++e) {
    const int r = Tile::row(e), c = Tile::col(e);
    const int m = m0 + r, n = n0 + c;
    float v = 0.f;
    if (m < P && n < cout) {
      v = acc[e] + bias[n];
      out[(size_t)m * cout + n] = dfc::from_f<T>(v);
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

template <typename T, int NT>
int launch_stats(const void* x, const void* w, const void* b, void* out, void* psum, void* psq,
                 int P, int H, int W, int cin, int cout, cudaStream_t stream) {
  constexpr size_t smem = stats_smem_bytes<T, NT>();
  cudaFuncSetAttribute(conv3x3_bias_stats_kernel<T, NT>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  const dim3 grid(dfc::ceil_div(P, kM), dfc::ceil_div(cout, NT));
  conv3x3_bias_stats_kernel<T, NT><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<const float*>(b),
      static_cast<T*>(out), static_cast<float*>(psum), static_cast<float*>(psq), P, H, W, cin,
      cout);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int stats_dispatch(const void* x, const void* w, const void* b, void* out, void* psum, void* psq,
                   int P, int H, int W, int cin, int cout, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cout <= 32) return launch_stats<T, 32>(x, w, b, out, psum, psq, P, H, W, cin, cout, s);
  if (cout <= 64) return launch_stats<T, 64>(x, w, b, out, psum, psq, P, H, W, cin, cout, s);
  if (cout <= 128) return launch_stats<T, 128>(x, w, b, out, psum, psq, P, H, W, cin, cout, s);
  return launch_stats<T, 256>(x, w, b, out, psum, psq, P, H, W, cin, cout, s);
}

}  // namespace

// psum, psq: [ceil(P / 64), cout] f32, one row per block of 64 pixels
extern "C" int conv3x3_bias_stats_f32(const void* x, const void* w, const void* b, void* out,
                                      void* psum, void* psq, int P, int H, int W, int cin,
                                      int cout, void* stream) {
  return stats_dispatch<float>(x, w, b, out, psum, psq, P, H, W, cin, cout, stream);
}

extern "C" int conv3x3_bias_stats_bf16(const void* x, const void* w, const void* b, void* out,
                                       void* psum, void* psq, int P, int H, int W, int cin,
                                       int cout, void* stream) {
  return stats_dispatch<__nv_bfloat16>(x, w, b, out, psum, psq, P, H, W, cin, cout, stream);
}
