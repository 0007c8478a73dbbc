// The DFC block tail and its 3x3 conv mainloop, for Hopper (sm_90a).
//
// Replaces two TPU kernels of dfc_sa_unet_tpu/ops/pallas_conv.py:
//
//   conv3x3_bn_relu (_conv3x3_kernel)   out = ReLU(conv3x3(x) + b)
//   dfc_tail_from_x (_dfc_tail_kernel)  local = ReLU(conv3x3(x) + bc)
//                                       g     = sigmoid([local|a] wg + bg)
//                                       fused = g*local + (1-g)*a
//                                       out   = ReLU([fused|local|a] wf + bf) + x wr
//
// BatchNorm is folded into the weights by the caller (infer/engine.py);
// res_scale is folded into wr.  Activations are NHWC, weights in the JAX
// layout: wc [3,3,Cin,C] (HWIO), wg [2C,C] in the order [local|a], wf [3C,C]
// in the order [fused|local|a], wr [Cin,C]; biases f32.  All sums are f32.
// Mixed precision as the TPU kernel: the gate and fusion products read
// `local` rounded to the activation type, the fusion itself reads `local`
// in f32 (pallas_conv.py:173-188).
//
// What bounds it on the H100: the tail does 2*(9*Cin + 5*C + Cin)*C
// operations per pixel on (Cin + 2*C) activations of 2 bytes in bf16, over
// 1000 operations per byte at the flagship levels: the tensor cores' rate
// bounds it, not memory.  The TPU kernel's point, which this keeps, is that
// `local` and `a` each feed four consumers (gate, fusion, two products)
// without a round trip through device memory: one block owns M pixels x
// all C channels and keeps local (f32 in registers, rounded in shared
// memory), a and fused in shared memory from the conv to the store.  The
// 3x3 conv is an implicit GEMM that gathers its taps straight from x and
// masks every image edge, so no padded copy of x is made (the TPU kernel
// pads rows in HBM, pallas_conv.py:136,220) and any H and W work.
//
// Products: bf16 runs on the tensor cores (mma.sync m16n8k16, f32
// accumulate; 8 warps as 2 x 4 over the M x N tile); f32 runs on the SIMT
// units (each warp TM pixel rows, each lane the channels lane + 32*j), exact
// to f32.  Both stage operands through shared memory in BK-deep chunks with
// no overlap of loads and math; wgmma/TMA pipelining is later work.

#include <stdint.h>

#include "common.cuh"
#include "conv3x3_mainloop.cuh"

namespace {

// ---------------------------------------------------------------- conv3x3

template <typename T, int NT>
__global__ void __launch_bounds__(kThreads)
conv3x3_bn_relu_kernel(const T* __restrict__ x, const T* __restrict__ w,
                       const float* __restrict__ bias, T* __restrict__ out, int P, int H, int W,
                       int cin, int cout) {
  constexpr int M = 64;
  using Tile = typename TileFor<T, M, NT>::type;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sa = reinterpret_cast<T*>(smem_raw);
  T* sw = sa + M * (Tile::BK + kPad);
  const int m0 = blockIdx.x * M, n0 = blockIdx.y * NT;
  const RowSlots<T, M, Tile::BK> rows(m0, P, H, W);
  float acc[Tile::ACC];
  zero(acc);
  conv3x3_mainloop<T, Tile, M, NT>(acc, x, w, rows, m0, n0, P, H, W, cin, cout, sa, sw);
#pragma unroll
  for (int e = 0; e < Tile::ACC; ++e) {
    const int m = m0 + Tile::row(e), n = n0 + Tile::col(e);
    if (m < P && n < cout) out[(size_t)m * cout + n] = dfc::from_f<T>(fmaxf(acc[e] + bias[n], 0.f));
  }
}

// ---------------------------------------------------------------- DFC tail

template <typename T, int M, int C>
__global__ void __launch_bounds__(kThreads, 1)
dfc_tail_kernel(const T* __restrict__ x, const T* __restrict__ a, const T* __restrict__ wc,
                const float* __restrict__ bc, const T* __restrict__ wg,
                const float* __restrict__ bg, const T* __restrict__ wf,
                const float* __restrict__ bf, const T* __restrict__ wr, T* __restrict__ out,
                int P, int H, int W, int cin) {
  using Tile = typename TileFor<T, M, C>::type;
  constexpr int LD = C + kPad, BK = Tile::BK, LDA = BK + kPad, ACC = Tile::ACC;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* s_local = reinterpret_cast<T*>(smem_raw);  // [M][LD] local, rounded
  T* s_a = s_local + M * LD;                    // [M][LD] attention branch
  T* s_fused = s_a + M * LD;                    // [M][LD] fused; x staging before
  T* sw = s_fused + M * LD;                     // weight chunk
  const int m0 = blockIdx.x * M;

  const RowSlots<T, M, BK> rows(m0, P, H, W);
  float acc[ACC];
  zero(acc);
  // 1. local = ReLU(conv3x3(x) + bc); taps staged in s_fused
  conv3x3_mainloop<T, Tile, M, C>(acc, x, wc, rows, m0, 0, P, H, W, cin, C, s_fused, sw);
  float lf[ACC];
#pragma unroll
  for (int e = 0; e < ACC; ++e) {
    const int n = Tile::col(e);
    lf[e] = fmaxf(acc[e] + bc[n], 0.f);
    s_local[Tile::row(e) * LD + n] = dfc::from_f<T>(lf[e]);
  }
  constexpr int VEC = 16 / sizeof(T);  // C % 32 == 0: rows of a in 16-byte loads
  for (int e = threadIdx.x; e < M * C / VEC; e += kThreads) {
    const int r = e / (C / VEC), n = (e - r * (C / VEC)) * VEC;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (m0 + r < P) v = *reinterpret_cast<const uint4*>(a + (size_t)(m0 + r) * C + n);
    *reinterpret_cast<uint4*>(s_a + r * LD + n) = v;
  }
  __syncthreads();

  // 2. g = sigmoid([local|a] wg + bg); fused = g*local_f32 + (1-g)*a
  zero(acc);
  gemm_from_smem<T, Tile, C>(acc, s_local, LD, C, wg, sw);
  gemm_from_smem<T, Tile, C>(acc, s_a, LD, C, wg + (size_t)C * C, sw);
#pragma unroll
  for (int e = 0; e < ACC; ++e) {
    const int n = Tile::col(e), at = Tile::row(e) * LD + n;
    const float g = 1.f / (1.f + expf(-(acc[e] + bg[n])));
    s_fused[at] = dfc::from_f<T>(g * lf[e] + (1.f - g) * dfc::to_f(s_a[at]));
  }
  __syncthreads();

  // 3. out = ReLU([fused|local|a] wf + bf)
  zero(acc);
  gemm_from_smem<T, Tile, C>(acc, s_fused, LD, C, wf, sw);
  gemm_from_smem<T, Tile, C>(acc, s_local, LD, C, wf + (size_t)C * C, sw);
  gemm_from_smem<T, Tile, C>(acc, s_a, LD, C, wf + (size_t)2 * C * C, sw);
#pragma unroll
  for (int e = 0; e < ACC; ++e) acc[e] = fmaxf(acc[e] + bf[Tile::col(e)], 0.f);

  // 4. out += x wr, x's centre pixels staged in s_fused
  const bool vec = cin % VEC == 0;
  for (int k0 = 0; k0 < cin; k0 += BK) {
    if (vec) {
      rows.centre(s_fused, x, k0, cin);
    } else {
      for (int e = threadIdx.x; e < M * BK; e += kThreads) {
        const int r = e / BK, kk = e - r * BK;
        const int m = m0 + r, ci = k0 + kk;
        s_fused[r * LDA + kk] = (m < P && ci < cin) ? x[(size_t)m * cin + ci] : dfc::from_f<T>(0.f);
      }
    }
    Tile::load_w(sw, wr, k0, cin, 0, C, C);
    __syncthreads();
    Tile::mma(acc, s_fused, LDA, sw);
    __syncthreads();
  }

#pragma unroll
  for (int e = 0; e < ACC; ++e) {
    const int m = m0 + Tile::row(e);
    if (m < P) out[(size_t)m * C + Tile::col(e)] = dfc::from_f<T>(acc[e]);
  }
}

template <typename T, int NT>
int launch_conv(const void* x, const void* w, const void* b, void* out, int P, int H, int W,
                int cin, int cout, cudaStream_t stream) {
  constexpr int M = 64;
  using Tile = typename TileFor<T, M, NT>::type;
  const size_t smem = sizeof(T) * (M * (Tile::BK + kPad) + Tile::SW_ELEMS);
  cudaFuncSetAttribute(conv3x3_bn_relu_kernel<T, NT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  const dim3 grid(dfc::ceil_div(P, M), dfc::ceil_div(cout, NT));
  conv3x3_bn_relu_kernel<T, NT><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<const float*>(b),
      static_cast<T*>(out), P, H, W, cin, cout);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int conv_dispatch(const void* x, const void* w, const void* b, void* out, int P, int H, int W,
                  int cin, int cout, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cout <= 32) return launch_conv<T, 32>(x, w, b, out, P, H, W, cin, cout, s);
  if (cout <= 64) return launch_conv<T, 64>(x, w, b, out, P, H, W, cin, cout, s);
  if (cout <= 128) return launch_conv<T, 128>(x, w, b, out, P, H, W, cin, cout, s);
  return launch_conv<T, 256>(x, w, b, out, P, H, W, cin, cout, s);
}

// M per C: about 64 accumulators a thread; three M x (C + 8) operands and a
// weight chunk within the 227 KB of shared memory in f32 (M = 32 at C = 512)
template <typename T, int C>
int launch_tail(const void* x, const void* a, const void* wc, const void* bc, const void* wg,
                const void* bg, const void* wf, const void* bf, const void* wr, void* out, int P,
                int H, int W, int cin, cudaStream_t stream) {
  constexpr int M = C >= 512 ? 32 : C >= 256 ? 64 : 128;
  using Tile = typename TileFor<T, M, C>::type;
  const size_t smem = sizeof(T) * (3 * M * (C + kPad) + Tile::SW_ELEMS);
  cudaFuncSetAttribute(dfc_tail_kernel<T, M, C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  dfc_tail_kernel<T, M, C><<<dfc::ceil_div(P, M), kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(a), static_cast<const T*>(wc),
      static_cast<const float*>(bc), static_cast<const T*>(wg), static_cast<const float*>(bg),
      static_cast<const T*>(wf), static_cast<const float*>(bf), static_cast<const T*>(wr),
      static_cast<T*>(out), P, H, W, cin);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int tail_dispatch(const void* x, const void* a, const void* wc, const void* bc, const void* wg,
                  const void* bg, const void* wf, const void* bf, const void* wr, void* out,
                  int P, int H, int W, int cin, int c, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (c) {
    case 32: return launch_tail<T, 32>(x, a, wc, bc, wg, bg, wf, bf, wr, out, P, H, W, cin, s);
    case 64: return launch_tail<T, 64>(x, a, wc, bc, wg, bg, wf, bf, wr, out, P, H, W, cin, s);
    case 128: return launch_tail<T, 128>(x, a, wc, bc, wg, bg, wf, bf, wr, out, P, H, W, cin, s);
    case 256: return launch_tail<T, 256>(x, a, wc, bc, wg, bg, wf, bf, wr, out, P, H, W, cin, s);
    case 512: return launch_tail<T, 512>(x, a, wc, bc, wg, bg, wf, bf, wr, out, P, H, W, cin, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" int conv3x3_bn_relu_f32(const void* x, const void* w, const void* b, void* out, int P,
                                   int H, int W, int cin, int cout, void* stream) {
  return conv_dispatch<float>(x, w, b, out, P, H, W, cin, cout, stream);
}

extern "C" int conv3x3_bn_relu_bf16(const void* x, const void* w, const void* b, void* out, int P,
                                    int H, int W, int cin, int cout, void* stream) {
  return conv_dispatch<__nv_bfloat16>(x, w, b, out, P, H, W, cin, cout, stream);
}

extern "C" int dfc_tail_f32(const void* x, const void* a, const void* wc, const void* bc,
                            const void* wg, const void* bg, const void* wf, const void* bf,
                            const void* wr, void* out, int P, int H, int W, int cin, int c,
                            void* stream) {
  return tail_dispatch<float>(x, a, wc, bc, wg, bg, wf, bf, wr, out, P, H, W, cin, c, stream);
}

extern "C" int dfc_tail_bf16(const void* x, const void* a, const void* wc, const void* bc,
                             const void* wg, const void* bg, const void* wf, const void* bf,
                             const void* wr, void* out, int P, int H, int W, int cin, int c,
                             void* stream) {
  return tail_dispatch<__nv_bfloat16>(x, a, wc, bc, wg, bg, wf, bf, wr, out, P, H, W, cin, c,
                                      stream);
}
