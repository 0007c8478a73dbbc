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
// without a round trip through device memory: one block owns BM pixels x
// all C channels from the conv to the store.  The 3x3 conv is an implicit
// GEMM that gathers its taps straight from x and masks every image edge, so
// no padded copy of x is made (the TPU kernel pads rows in HBM,
// pallas_conv.py:136,220) and any H and W work.  What a block cannot keep
// on chip is the level's weights: every block streams all of them from L2,
// so the weight traffic is the pixel count / BM times the weights' bytes.
//
// bf16 (dfc_tail_wgmma_kernel): the four products run as one stream of
// 64-deep steps through the pipelined wgmma ring of conv3x3_wgmma.cuh (two
// warpgroups of wgmma.m64nNk16, a 2- to 4-stage ring in the 128-byte
// swizzle, A tiles by cp.async and the weights' B tiles by TMA, the copies
// of the next steps, across the products' boundaries, in flight during the
// current one's products).  A and B come
// from shared memory in the layouts the descriptors name: `local` and
// `fused` are written there by the epilogues in the K-major swizzled layout
// and read in place; `a` and x's centre pixels stream through the ring as A
// tiles.  BM = 128 pixels for C <= 128, 64 for C >= 256 (where local in
// f32 and the output's accumulators fill the registers); per C the tiling
// and its register and shared-memory budget are TailTiling's.
// f32 (dfc_tail_kernel, conv3x3_mainloop.cuh): the SIMT units, each warp TM
// pixel rows, each lane the channels lane + 32*j, exact to f32 for the 1e-5
// parity mode (wgmma has no f32 path; TF32 would break it).
//
// conv3x3_bn_relu, bf16, on wgmma, with the bias and the ReLU applied to the
// f32 accumulators before the one rounding.  K is walked flat, 64 rows of w
// [9 * Cin8][Cout] (Cin zero-padded to 8) a step.  At the bottleneck (512 ->
// 1024, 14x14, bound by the tensor cores; conv3x3_bn_relu_wgmma_kernel:
// wgconv::conv3x3_wgmma, 128 pixels x NB channels a block, two warpgroups of
// wgmma.m64nNBk16, weight tiles by TMA) a step lies in one tap, 72 steps
// through a ring of four stages.  At down1 (Cin = 3, 224x224 -> 64, bound by
// its 822 MB of output; conv3x3_bn_relu_narrow_kernel:
// wgconv::conv3x3_wgmma_narrow) a step packs eight taps, so its 27-deep product
// takes two steps instead of nine; a persistent block keeps the weight resident,
// gathers the 3-channel pixels straight from x one tile ahead (no padded copy of
// x) and stores by TMA, so loads and stores stay in flight.  The tiling (the
// kernel, NB from Cout) is ops/dfc_tail.py::conv_tiling's; the wrapper passes
// it.  conv3x3_bn_relu in f32 runs on the SIMT units of conv3x3_mainloop.cuh.

#include <cuda.h>
#include <stdint.h>

#include <type_traits>

#include "common.cuh"
#include "conv3x3_mainloop.cuh"
#include "conv3x3_wgmma.cuh"

namespace {

// ---------------------------------------------------------------- conv3x3

// f32 (SIMT, exact); the bf16 conv is on wgmma below
template <int NT>
__global__ void __launch_bounds__(kThreads)
conv3x3_bn_relu_kernel(const float* __restrict__ x, const float* __restrict__ w,
                       const float* __restrict__ bias, float* __restrict__ out, int P, int H, int W,
                       int cin, int cout) {
  using T = float;
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

// f32 only: the bf16 tail is dfc_tail_wgmma_kernel below
template <int M, int C>
__global__ void __launch_bounds__(kThreads, 1)
dfc_tail_kernel(const float* __restrict__ x, const float* __restrict__ a, const float* __restrict__ wc,
                const float* __restrict__ bc, const float* __restrict__ wg,
                const float* __restrict__ bg, const float* __restrict__ wf,
                const float* __restrict__ bf, const float* __restrict__ wr, float* __restrict__ out,
                int P, int H, int W, int cin) {
  using T = float;
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

template <int NT>
int launch_conv_f32(const void* x, const void* w, const void* b, void* out, int P, int H, int W,
                    int cin, int cout, cudaStream_t stream) {
  constexpr int M = 64;
  using Tile = typename TileFor<float, M, NT>::type;
  const size_t smem = sizeof(float) * (M * (Tile::BK + kPad) + Tile::SW_ELEMS);
  cudaFuncSetAttribute(conv3x3_bn_relu_kernel<NT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  const dim3 grid(dfc::ceil_div(P, M), dfc::ceil_div(cout, NT));
  conv3x3_bn_relu_kernel<NT><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(w), static_cast<const float*>(b),
      static_cast<float*>(out), P, H, W, cin, cout);
  return static_cast<int>(cudaGetLastError());
}

// blocks an SM of the bf16 conv: as many rings as shared memory holds, at most three (the registers
// of 768 threads)
constexpr int conv_blocks(int smem) { return 232448 / smem < 3 ? 232448 / smem : 3; }

// bf16: ReLU(conv3x3(x) + b) on the wgmma ring; w is [9 * cin][cout] (HWIO with cin a multiple
// of 8), read by TMA through wmap
template <int NB, int STAGES>
__global__ void __launch_bounds__(wgconv::kThreads, conv_blocks(wgconv::conv_smem_bytes<NB, STAGES, true>()))
conv3x3_bn_relu_wgmma_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ bias,
                             __nv_bfloat16* __restrict__ out, int P, int H, int W, int cin, int cout,
                             const __grid_constant__ CUtensorMap wmap) {
  wgconv::conv3x3_wgmma<NB, STAGES, true>(x, nullptr, &wmap, out, P, H, W, cin, cout, wgconv::BiasRelu{bias, cout});
}

template <int NB, int STAGES>
int launch_conv_wgmma(const void* x, const void* w, const void* b, void* out, int P, int H, int W, int cin,
                      int cout, cudaStream_t stream) {
  constexpr int smem = wgconv::conv_smem_bytes<NB, STAGES, true>();
  CUtensorMap wmap;
  if (!wgconv::encode_tiled()) return static_cast<int>(cudaErrorNotSupported);
  if (!wgconv::tile_map(&wmap, w, cout, 9 * (uint64_t)cin, 1, 64)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err =
      cudaFuncSetAttribute(conv3x3_bn_relu_wgmma_kernel<NB, STAGES>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(dfc::ceil_div(P, wgconv::kBM), dfc::ceil_div(cout, NB));
  conv3x3_bn_relu_wgmma_kernel<NB, STAGES><<<grid, wgconv::kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(b), static_cast<__nv_bfloat16*>(out), P, H, W,
      cin, cout, wmap);
  return static_cast<int>(cudaGetLastError());
}

// bf16 at Cin = 3 or 8 and Cout <= 64 (down1): the persistent kernel, x [P][CIN] read as it is,
// w [72][cout], out by TMA through omap
template <int CIN>
__global__ void __launch_bounds__(wgconv::kNarrowThreads, 4)
conv3x3_bn_relu_narrow_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
                              const float* __restrict__ bias, int P, int H, int W, int cout,
                              const __grid_constant__ CUtensorMap omap) {
  wgconv::conv3x3_wgmma_narrow<CIN>(x, w, &omap, P, H, W, cout, wgconv::BiasRelu{bias, cout});
}

template <int CIN>
int launch_conv_narrow(const void* x, const void* w, const void* b, void* out, int P, int H, int W, int cout,
                       cudaStream_t stream) {
  constexpr int smem = wgconv::kNarrowSmemBytes;
  if (cout > 64) return static_cast<int>(cudaErrorInvalidValue);
  if (!wgconv::encode_tiled()) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap omap;
  if (!wgconv::tile_map(&omap, out, cout, P, 1, 64)) return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(conv3x3_bn_relu_narrow_kernel<CIN>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, conv3x3_bn_relu_narrow_kernel<CIN>,
                                                        wgconv::kNarrowThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = dfc::ceil_div(P, wgconv::kNarrowBM), blocks = per_sm * sms;
  conv3x3_bn_relu_narrow_kernel<CIN><<<tiles < blocks ? tiles : blocks, wgconv::kNarrowThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w), static_cast<const float*>(b), P, H,
      W, cout, omap);
  return static_cast<int>(cudaGetLastError());
}

// the tilings ops/dfc_tail.py::conv_tiling gives: (B tile width, ring stages; 0: the persistent
// kernel, which reads x's cin = 3 or 8 channels)
int conv_wgmma_dispatch(const void* x, const void* w, const void* b, void* out, int P, int H, int W, int cin,
                        int cout, int nb, int stages, cudaStream_t s) {
  if (cout % 8) return static_cast<int>(cudaErrorInvalidValue);  // 16-byte rows of w and out
  if (nb == 64 && stages == 0 && cin == 3) return launch_conv_narrow<3>(x, w, b, out, P, H, W, cout, s);
  if (nb == 64 && stages == 0 && cin == 8) return launch_conv_narrow<8>(x, w, b, out, P, H, W, cout, s);
  if (cin % 8) return static_cast<int>(cudaErrorInvalidValue);  // 16-byte rows of x
  if (nb == 64 && stages == 4) return launch_conv_wgmma<64, 4>(x, w, b, out, P, H, W, cin, cout, s);
  if (nb == 128 && stages == 4) return launch_conv_wgmma<128, 4>(x, w, b, out, P, H, W, cin, cout, s);
  if (nb == 256 && stages == 4) return launch_conv_wgmma<256, 4>(x, w, b, out, P, H, W, cin, cout, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// f32: the SIMT mainloop, NT output channels a block
int conv_dispatch_f32(const void* x, const void* w, const void* b, void* out, int P, int H, int W, int cin, int cout,
                      cudaStream_t s) {
  if (cout <= 32) return launch_conv_f32<32>(x, w, b, out, P, H, W, cin, cout, s);
  if (cout <= 64) return launch_conv_f32<64>(x, w, b, out, P, H, W, cin, cout, s);
  if (cout <= 128) return launch_conv_f32<128>(x, w, b, out, P, H, W, cin, cout, s);
  return launch_conv_f32<256>(x, w, b, out, P, H, W, cin, cout, s);
}

// M per C: about 64 accumulators a thread; three M x (C + 8) operands and a
// weight chunk within the 227 KB of shared memory in f32 (M = 32 at C = 512)
template <int C>
int launch_tail_f32(const void* x, const void* a, const void* wc, const void* bc, const void* wg,
                    const void* bg, const void* wf, const void* bf, const void* wr, void* out, int P,
                    int H, int W, int cin, cudaStream_t stream) {
  constexpr int M = C >= 512 ? 32 : C >= 256 ? 64 : 128;
  using Tile = typename TileFor<float, M, C>::type;
  const size_t smem = sizeof(float) * (3 * M * (C + kPad) + Tile::SW_ELEMS);
  cudaFuncSetAttribute(dfc_tail_kernel<M, C>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  dfc_tail_kernel<M, C><<<dfc::ceil_div(P, M), kThreads, smem, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(a), static_cast<const float*>(wc),
      static_cast<const float*>(bc), static_cast<const float*>(wg), static_cast<const float*>(bg),
      static_cast<const float*>(wf), static_cast<const float*>(bf), static_cast<const float*>(wr),
      static_cast<float*>(out), P, H, W, cin);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------------- DFC tail, bf16: wgmma

using bf16 = __nv_bfloat16;

// The block's tiling at C output channels: BM pixels, two warpgroups as WM (rows of 64
// pixels) x WN (column groups of CW channels), the gate in chunks of GW columns, a ring
// of STAGES buffers.  C = 32 is padded to 64 columns (zero weights, zero local).
//   C <= 128: 128 pixels, each warpgroup 64 x C; C <= 64 two blocks an SM.
//   C = 256:  64 pixels, each warpgroup 64 x 128: local in f32 (64 a thread) and the
//             gate's 64 fit the registers.  128 pixels x 256 a warpgroup spilled and ran
//             slower on the card than 64 pixels, despite twice the weight traffic.
//   C = 512:  64 pixels, each warpgroup 64 x 256: local in f32 (128 a thread) and a
//             64-column gate chunk (32), then the output's 128.
// Shared memory: local and fused in bf16 (BM x C each) and the ring; at C = 512 fused
// does not fit beside a ring of two 72 KB stages, so it waits in registers (bf16 pairs,
// CW/4 = 64 a thread) until local's products are done and then takes local's place.
// The weight tiles come by TMA (wgconv::Ring): no thread spends registers or instructions
// on their copies (with cp.async copies 360 bytes spilled at C = 512 and every level took
// 8-55% longer; two-block clusters sharing each tile by TMA multicast read slower: PERF.md).
template <int C>
struct TailTiling {
  static constexpr int BM = C >= 256 ? 64 : 128;
  static constexpr int WM = BM / 64, WN = 2 / WM;
  static constexpr int CW = (C < 64 ? 64 : C) / WN;
  static constexpr int GW = CW <= 128 ? CW : 64;
  static constexpr int NB = CW * WN;  // width of the B tile of the conv and output products
  static constexpr int KC = (C + 63) / 64;  // 64-channel chunks of local, a and fused
  static constexpr bool kFusedSmem = C <= 256;
  static constexpr int STAGES = C >= 512 ? 2 : C <= 64 ? 3 : 4;
  static constexpr int kMinBlocks = C <= 64 ? 2 : 1;
  using R = wgconv::Ring<BM, 2, NB, STAGES, true>;
  static constexpr int kLocalBytes = KC * BM * 128;
  static constexpr int kSmemBytes = 1024 + (kFusedSmem ? 2 : 1) * kLocalBytes + R::kBytes + R::kBarBytes;
  static_assert(kSmemBytes <= 232448, "shared memory of one block");
  static_assert(BM * (NB + 8) * 2 <= R::kBytes, "the output tile reuses the ring");
};

// TMA maps of the four weights, as 3-D tensors [z][rows][C] in 64 x 64 boxes (the 128-byte
// swizzle of the ring's B tiles; rows and columns past a tensor's end read zero): wc
// [9][Cin][C] (z the tap), wg [2][C][C] (z: local, a), wf [3][C][C] (z: fused, local, a),
// wr [1][Cin][C].
struct TailMaps {
  CUtensorMap wc, wg, wf, wr;
};

// One block owns BM pixels x all C channels through the four products of the tail, which
// run one after another as ONE stream of 64-deep steps through one ring (so the copies of
// a product's first steps overlap the previous product's last steps and epilogue):
//   conv    9 * ceil(Cin/64) steps: A = x's taps (gathered), B = wc;
//           -> local = ReLU(acc + bc): f32 in registers, bf16 into shared memory;
//   gate    per chunk of GW columns, 2 * KC steps: A = local (resident) then a (gathered
//           rows), B = wg's columns of the chunk;
//           -> g = sigmoid(acc + bg), fused = g * local_f32 + (1 - g) * a in bf16, into
//              shared memory (at C = 512 into registers); local_f32 of the chunk dies here;
//   out     2 * KC steps: A = local, then a; B = wf's rows C..3C (z = 1, 2 of its map);
//           (at C = 512: -> fused replaces local in shared memory)
//           KC steps: A = fused, B = wf's rows 0..C (z = 0);  -> ReLU(acc + bf);
//   res     ceil(Cin/64) steps: A = x's centre pixels, B = wr;  -> + x wr.
// The output leaves through the ring in coalesced 16-byte stores.
template <int C>
__global__ void __launch_bounds__(256, TailTiling<C>::kMinBlocks)
dfc_tail_wgmma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ a, const float* __restrict__ bc,
                      const float* __restrict__ bg, const float* __restrict__ bf, bf16* __restrict__ out,
                      int P, int H, int W, int cin, const __grid_constant__ TailMaps maps) {
  using T = TailTiling<C>;
  using R = typename T::R;
  constexpr int BM = T::BM, CW = T::CW, GW = T::GW, NB = T::NB, KC = T::KC, WM = T::WM;
  constexpr int NG = CW / GW, ACC = CW / 2, GACC = GW / 2;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = dfc::smem_u32(smem_raw);
  const uint32_t local = (raw + 1023u) & ~1023u;  // [KC][BM][64], K-major
  const uint32_t fused = T::kFusedSmem ? local + T::kLocalBytes : local;  // the same layout
  const R ring{local + (T::kFusedSmem ? 2 : 1) * T::kLocalBytes};
  const int m0 = blockIdx.x * BM;
  const int wgi = threadIdx.x / 128, wm = wgi % WM, wn = wgi / WM;
  const int lane = threadIdx.x % 32, t = lane % 4;
  const int row = wm * 64 + ((threadIdx.x % 128) / 32) * 16 + lane / 4;  // and row + 8
  const int col0 = wn * CW + 2 * t;  // + 8j: this thread's columns of accumulator group j
  const wgconv::PixelSlots<BM, 256> px(m0, P, H, W);

  // the stream of steps
  const int kx = (cin + 63) / 64;
  const int s_gate = 9 * kx, s_out = s_gate + NG * 2 * KC, s_fused = s_out + 2 * KC, s_res = s_fused + KC;
  const int steps = s_res + kx;
  auto all = [](int n) { return n; };
  // step s's B tile: the boxes at (col(64 n), r0, z) of a weight's map
  auto issue = [&](int s) {
    const uint32_t sa = ring.a(s);
    if (s < s_gate) {  // conv: tap, channels c0..
      const int tap = s / kx, c0 = (s - tap * kx) * 64;
      px.gather(sa, x, cin, c0, tap / 3 - 1, tap % 3 - 1, H, W);
      wgconv::tma_weight_tile<R, NB>(ring, s, &maps.wc, c0, tap, all);
    } else if (s < s_out) {  // gate chunk j: wg [local | a], the chunk's columns of each group
      const int j = (s - s_gate) / (2 * KC), k = (s - s_gate) % (2 * KC), c0 = (k % KC) * 64;
      if (k >= KC) px.gather(sa, a, C, c0, 0, 0, H, W);
      wgconv::tma_weight_tile<R, GW * T::WN>(ring, s, &maps.wg, c0, k / KC,
                                             [j](int n) { return (n / GW) * CW + j * GW + n % GW; });
    } else if (s < s_fused) {  // wf [local | a]
      const int k = s - s_out, c0 = (k % KC) * 64;
      if (k >= KC) px.gather(sa, a, C, c0, 0, 0, H, W);
      wgconv::tma_weight_tile<R, NB>(ring, s, &maps.wf, c0, 1 + k / KC, all);
    } else if (s < s_res) {  // wf [fused]
      wgconv::tma_weight_tile<R, NB>(ring, s, &maps.wf, (s - s_fused) * 64, 0, all);
    } else {  // x's centre pixels . wr
      const int c0 = (s - s_res) * 64;
      px.gather(sa, x, cin, c0, 0, 0, H, W);
      wgconv::tma_weight_tile<R, NB>(ring, s, &maps.wr, c0, 0, all);
    }
  };
  // the products of one step: A from the ring or a chunk of the resident buffer, this
  // warpgroup's 64 rows, against its block of columns of the B tile
  auto mma_into = [&](auto& acc, uint32_t sa, uint32_t sb, int block) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      dfc::wgmma_ss(acc, wgconv::a_desc(sa + wm * 64 * 128, kk), wgconv::b_desc(sb, block, kk));
  };
  auto resident = [&](uint32_t buffer, int chunk) { return buffer + chunk * BM * 128; };
  // byte offset in the resident buffer of (row r, column c), c even
  auto at = [&](int r, int c) { return (c / 64) * BM * 128 + dfc::swizzle128(r * 128 + (c % 64) * 2); };
  unsigned char* sl = smem_raw + (local - raw);

  wgconv::ring_init(ring);
  wgconv::ring_prologue<R>(steps, issue);
  int s = 0;

  // conv -> local
  float lf[ACC];
#pragma unroll
  for (int i = 0; i < ACC; ++i) lf[i] = 0.f;
  for (; s < s_gate; ++s)
    wgconv::ring_step(ring, s, steps, issue, [&](int i) { mma_into(lf, ring.a(i), ring.b(i), wn * (CW / 64)); }, lf);
  dfc::wgmma_wait<0>();
  dfc::fence_regs(lf);
#pragma unroll
  for (int j = 0; j < ACC / 4; ++j) {
    const int c = col0 + 8 * j;
    const float b0 = c < C ? bc[c] : 0.f, b1 = c < C ? bc[c + 1] : 0.f;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      lf[4 * j + 2 * h] = fmaxf(lf[4 * j + 2 * h] + b0, 0.f);
      lf[4 * j + 2 * h + 1] = fmaxf(lf[4 * j + 2 * h + 1] + b1, 0.f);
      *reinterpret_cast<__nv_bfloat162*>(sl + at(row + 8 * h, c)) =
          __floats2bfloat162_rn(lf[4 * j + 2 * h], lf[4 * j + 2 * h + 1]);
    }
  }

  // gate, chunk by chunk -> fused
  uint32_t fk[T::kFusedSmem ? 1 : ACC / 2];  // fused in bf16 pairs, where it waits in registers
#pragma unroll
  for (int j = 0; j < NG; ++j) {
    float ga[GACC];
#pragma unroll
    for (int i = 0; i < GACC; ++i) ga[i] = 0.f;
    for (const int end = s + 2 * KC; s < end; ++s)
      wgconv::ring_step(ring, s, steps, issue, [&](int i) {
        const int k = (i - s_gate) % (2 * KC);
        mma_into(ga, k < KC ? resident(local, k) : ring.a(i), ring.b(i), wn * (GW / 64));
      }, ga);
    dfc::wgmma_wait<0>();
    dfc::fence_regs(ga);
#pragma unroll
    for (int jj = 0; jj < GACC / 4; ++jj) {
      const int c = col0 + j * GW + 8 * jj, e = 4 * (j * GW / 8 + jj);
      const float b0 = c < C ? bg[c] : 0.f, b1 = c < C ? bg[c + 1] : 0.f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + row + 8 * h;
        float a0 = 0.f, a1 = 0.f;
        if (m < P && c < C) {
          const __nv_bfloat162 av = *reinterpret_cast<const __nv_bfloat162*>(a + (size_t)m * C + c);
          a0 = __low2float(av);
          a1 = __high2float(av);
        }
        const float g0 = 1.f / (1.f + expf(-(ga[4 * jj + 2 * h] + b0)));
        const float g1 = 1.f / (1.f + expf(-(ga[4 * jj + 2 * h + 1] + b1)));
        const uint32_t f = dfc::pack2(g0 * lf[e + 2 * h] + (1.f - g0) * a0, g1 * lf[e + 2 * h + 1] + (1.f - g1) * a1);
        if constexpr (T::kFusedSmem)
          *reinterpret_cast<uint32_t*>(sl + (fused - local) + at(row + 8 * h, c)) = f;
        else
          fk[e / 2 + h] = f;
      }
    }
  }

  // out = [local | a] wf[C:3C]
  float acc[ACC];
#pragma unroll
  for (int i = 0; i < ACC; ++i) acc[i] = 0.f;
  for (; s < s_fused; ++s)
    wgconv::ring_step(ring, s, steps, issue, [&](int i) {
      const int k = i - s_out;
      mma_into(acc, k < KC ? resident(local, k) : ring.a(i), ring.b(i), wn * (CW / 64));
    }, acc);
  if constexpr (!T::kFusedSmem) {
    dfc::wgmma_wait<0>();
    dfc::fence_regs(acc);
    __syncthreads();  // both warpgroups' products have read local: fused takes its place
#pragma unroll
    for (int j = 0; j < ACC / 4; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<uint32_t*>(sl + at(row + 8 * h, col0 + 8 * j)) = fk[2 * j + h];
  }

  // out += fused wf[0:C]; ReLU(out + bf)
  for (; s < s_res; ++s)
    wgconv::ring_step(ring, s, steps, issue,
                         [&](int i) { mma_into(acc, resident(fused, i - s_fused), ring.b(i), wn * (CW / 64)); },
                         acc);
  dfc::wgmma_wait<0>();
  dfc::fence_regs(acc);
#pragma unroll
  for (int j = 0; j < ACC / 4; ++j) {
    const int c = col0 + 8 * j;
    const float b0 = c < C ? bf[c] : 0.f, b1 = c < C ? bf[c + 1] : 0.f;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      acc[4 * j + 2 * h] = fmaxf(acc[4 * j + 2 * h] + b0, 0.f);
      acc[4 * j + 2 * h + 1] = fmaxf(acc[4 * j + 2 * h + 1] + b1, 0.f);
    }
  }

  // out += x wr
  for (; s < steps; ++s)
    wgconv::ring_step(ring, s, steps, issue, [&](int i) { mma_into(acc, ring.a(i), ring.b(i), wn * (CW / 64)); }, acc);
  dfc::wgmma_wait<0>();
  dfc::fence_regs(acc);
  dfc::cp_async_wait<0>();
  __syncthreads();  // the ring is free: it holds the output tile now

  constexpr int LD = NB + 8;  // elements
  bf16* so = reinterpret_cast<bf16*>(smem_raw + (ring.base - raw));
#pragma unroll
  for (int j = 0; j < ACC / 4; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<__nv_bfloat162*>(so + (row + 8 * h) * LD + col0 + 8 * j) =
          __floats2bfloat162_rn(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
  __syncthreads();
  for (int e = threadIdx.x; e < BM * (C / 8); e += 256) {
    const int r = e / (C / 8), c = (e % (C / 8)) * 8;
    if (m0 + r < P)
      *reinterpret_cast<uint4*>(out + (size_t)(m0 + r) * C + c) = *reinterpret_cast<const uint4*>(so + r * LD + c);
  }
}

template <int C>
int launch_tail_bf16(const void* x, const void* a, const void* wc, const void* bc, const void* wg,
                     const void* bg, const void* wf, const void* bf, const void* wr, void* out, int P,
                     int H, int W, int cin, cudaStream_t stream) {
  using T = TailTiling<C>;
  if (cin % 8) return static_cast<int>(cudaErrorInvalidValue);  // 16-byte rows of x
  if (!wgconv::encode_tiled()) return static_cast<int>(cudaErrorNotSupported);
  TailMaps maps;
  if (!wgconv::tile_map(&maps.wc, wc, C, cin, 9, 64) || !wgconv::tile_map(&maps.wg, wg, C, C, 2, 64) ||
      !wgconv::tile_map(&maps.wf, wf, C, C, 3, 64) || !wgconv::tile_map(&maps.wr, wr, C, cin, 1, 64))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaFuncSetAttribute(dfc_tail_wgmma_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmemBytes);
  dfc_tail_wgmma_kernel<C><<<dfc::ceil_div(P, T::BM), 256, T::kSmemBytes, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(a), static_cast<const float*>(bc),
      static_cast<const float*>(bg), static_cast<const float*>(bf), static_cast<bf16*>(out), P, H, W, cin, maps);
  return static_cast<int>(cudaGetLastError());
}

// launch(std::integral_constant<int, C>{}) at the tail's C
template <class Launch>
int tail_dispatch(int c, Launch&& launch) {
  switch (c) {
    case 32: return launch(std::integral_constant<int, 32>{});
    case 64: return launch(std::integral_constant<int, 64>{});
    case 128: return launch(std::integral_constant<int, 128>{});
    case 256: return launch(std::integral_constant<int, 256>{});
    case 512: return launch(std::integral_constant<int, 512>{});
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" int conv3x3_bn_relu_f32(const void* x, const void* w, const void* b, void* out, int P,
                                   int H, int W, int cin, int cout, void* stream) {
  return conv_dispatch_f32(x, w, b, out, P, H, W, cin, cout, static_cast<cudaStream_t>(stream));
}

// w: [9 * cin8][cout], cin8 = cin zero-padded to a multiple of 8 (ops/dfc_tail.py::pack_conv_taps);
// nb, stages: conv_tiling's (the ring's kernel needs cin a multiple of 8, the wrapper pads x for it)
extern "C" int conv3x3_bn_relu_bf16(const void* x, const void* w, const void* b, void* out, int P,
                                    int H, int W, int cin, int cout, int nb, int stages, void* stream) {
  return conv_wgmma_dispatch(x, w, b, out, P, H, W, cin, cout, nb, stages, static_cast<cudaStream_t>(stream));
}

extern "C" int dfc_tail_f32(const void* x, const void* a, const void* wc, const void* bc,
                            const void* wg, const void* bg, const void* wf, const void* bf,
                            const void* wr, void* out, int P, int H, int W, int cin, int c,
                            void* stream) {
  return tail_dispatch(c, [&](auto C) {
    return launch_tail_f32<decltype(C)::value>(x, a, wc, bc, wg, bg, wf, bf, wr, out, P, H, W, cin,
                                               static_cast<cudaStream_t>(stream));
  });
}

extern "C" int dfc_tail_bf16(const void* x, const void* a, const void* wc, const void* bc,
                             const void* wg, const void* bg, const void* wf, const void* bf,
                             const void* wr, void* out, int P, int H, int W, int cin, int c,
                             void* stream) {
  return tail_dispatch(c, [&](auto C) {
    return launch_tail_bf16<decltype(C)::value>(x, a, wc, bc, wg, bg, wf, bf, wr, out, P, H, W, cin,
                                                static_cast<cudaStream_t>(stream));
  });
}
