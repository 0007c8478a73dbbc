// Matrix-unit probes, for Hopper (sm_90a): a hand-written matrix product and a
// hand-written 3x3 conv in two tap schedules, to be timed beside cuBLAS and
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
//                    dx taps of a pixel are laid side by side in shared memory
//                    and ONE accumulation pass of depth 3*Cin runs against w[dy]
//   probe_conv_9dot  the same conv; the weight is [9][Cin][Co]: NINE passes of
//                    depth Cin, one per tap, against w[dy*3 + dx]
//
// What the probes ask on this card: how close a product written by hand (the
// mma.sync mainloop shared by the port's conv kernels) gets to the library's,
// and whether a conv mainloop should stage few deep operands or many shallow
// ones.  The two conv kernels are one template and differ only in that: how
// many taps are staged per pass, and so how deep a pass is and how many
// staging phases (each ending in a barrier) a block runs.
//
// What bounds them on the H100 at the probe's shape (B = 128, 56x56, 128 ->
// 256): the matmul at K = 384 does 2*K*N / (2*(K + N)) = 154 operations per
// byte, below the ~295 the card needs, so the bytes bound it; the conv does
// 9 times the operations on a third of the input bytes, so the tensor cores
// do.  The TPU kernels' 2048-row tile, 28-row image blocks and padded copy of
// x were sized for VMEM and are not carried over: a block owns 128 rows (or
// pixels) x 128 output channels, the taps are gathered from x with every
// image edge masked, and the weight streams through shared memory in 32-row
// chunks.  Column tiles are the fast grid index, so the blocks that share a
// row tile of x run together and the second one reads it from L2.
//
// No overlap of loads and math yet (wgmma / TMA pipelining is later work).

#include <stdint.h>

#include "common.cuh"
#include "conv3x3_mainloop.cuh"

namespace {

using bf16 = __nv_bfloat16;
constexpr int kM = 128;   // rows (pixels) per block
constexpr int kNT = 128;  // output columns per block
using Tile = MmaTile<kM, kNT>;

// acc += s_op[:, 0:depth] . w[0:depth, n0:n0+kNT]; s_op rows of stride lda
// hold the whole depth, padded with zeros to a multiple of Tile::BK; weight
// rows past depth read as zero.  Starts and ends on a barrier.
__device__ void gemm_pass(float (&acc)[Tile::ACC], const bf16* s_op, int lda, int depth,
                          const bf16* __restrict__ w, int n0, int cout, bf16* sw) {
  for (int k0 = 0; k0 < depth; k0 += Tile::BK) {
    Tile::load_w(sw, w, k0, depth, n0, cout, cout);
    __syncthreads();
    Tile::mma(acc, s_op + k0, lda, sw);
    __syncthreads();
  }
}

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

// s_op[r][t*cin + ci] <- x at pixel (m0 + r) shifted by (dy, dx_first + t), for
// t in [0, ndx); zero outside the image, past the last pixel and in the
// padding columns up to depth_pad.  16-byte loads: cin is a multiple of 8.
__device__ void stage_taps(bf16* s_op, int lda, const bf16* __restrict__ x, int m0, int P, int H,
                           int W, int cin, int dy, int dx_first, int ndx, int depth_pad) {
  const int vpr = depth_pad / 8;
  for (int e = threadIdx.x; e < kM * vpr; e += kThreads) {
    const int r = e / vpr, kv = (e - r * vpr) * 8;
    const int m = m0 + r;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (m < P && kv < ndx * cin) {
      const int t = kv / cin, ci = kv - t * cin;
      const int dx = dx_first + t;
      const int ww = m % W + dx, hh = (m / W) % H + dy;
      if (hh >= 0 && hh < H && ww >= 0 && ww < W)
        val = *reinterpret_cast<const uint4*>(x + (size_t)(m + dy * W + dx) * cin + ci);
    }
    *reinterpret_cast<uint4*>(s_op + r * lda + kv) = val;
  }
}

// NDX taps per accumulation pass: 3 (cat: three passes of depth 3*Cin) or
// 1 (9dot: nine passes of depth Cin).  w is [9/NDX][NDX*Cin][Cout].
template <int NDX>
__global__ void __launch_bounds__(kThreads)
probe_conv_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w, bf16* __restrict__ out,
                  int P, int H, int W, int cin, int cout) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int depth = NDX * cin;
  const int depth_pad = (depth + Tile::BK - 1) / Tile::BK * Tile::BK;
  const int lda = depth_pad + kPad;
  bf16* s_op = reinterpret_cast<bf16*>(smem_raw);
  bf16* sw = s_op + kM * lda;
  const int n0 = blockIdx.x * kNT, m0 = blockIdx.y * kM;
  float acc[Tile::ACC];
  zero(acc);
  int pass = 0;
  for (int dy = -1; dy <= 1; ++dy)
    for (int dx = -1; dx <= 1; dx += NDX, ++pass) {
      stage_taps(s_op, lda, x, m0, P, H, W, cin, dy, dx, NDX, depth_pad);
      gemm_pass(acc, s_op, lda, depth, w + (size_t)pass * depth * cout, n0, cout, sw);
    }
  store_tile(acc, out, m0, n0, P, cout);
}

template <int NDX>
int launch_conv(const void* x, const void* w, void* out, int P, int H, int W, int cin, int cout,
                void* stream) {
  const int depth_pad = (NDX * cin + Tile::BK - 1) / Tile::BK * Tile::BK;
  const size_t smem = sizeof(bf16) * ((size_t)kM * (depth_pad + kPad) + Tile::SW_ELEMS);
  cudaFuncSetAttribute(probe_conv_kernel<NDX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  const dim3 grid(dfc::ceil_div(cout, kNT), dfc::ceil_div(P, kM));
  probe_conv_kernel<NDX><<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
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
