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
// The conv probes run on wgconv::conv3x3_wgmma of conv3x3_wgmma.cuh (128
// pixels x 256 output channels a block, a 4-stage cp.async ring, one step's
// products in flight while the next step's copies land, no epilogue).  On the
// TPU the two schedules are different matrix shapes (three products of depth
// 3*Cin, or nine of depth Cin).  Here both layouts are the same matrix
// [9*Cin][Cout], walked as one stream of 64-row steps, so the two exports launch
// one kernel: the probe now asks whether the schedule matters once loads overlap
// math, and on this card the answer is the stream's, not the layout's.
//
// probe_matmul (probe_matmul_kernel) is a persistent GEMM fed by TMA: one block
// an SM walks 128 x 256 output tiles; a producer warpgroup (one thread issuing,
// 40 registers after setmaxnreg) keeps a ring of three 48 KB stages full, each
// stage a 128 x 64 box of x and four 64 x 64 boxes of w in the 128-byte swizzle
// the wgmma descriptors name; two consumer warpgroups (232 registers) run
// wgmma.m64n256k16 on 64 rows each, one step's products in flight, and free a
// stage on its `empty` barrier.  A tile's bf16 output goes through shared memory
// in the same swizzle and leaves by TMA stores, so the next tile's loads and
// products run during its epilogue.  TMA zero-fills past M, K and N and clips
// the stores, so ragged shapes need no masking.
//
// What bounds them on the H100 at the probe's shape (B = 128, 56x56, 128 ->
// 256): the matmul at K = 384 does 2*K*N / (2*(K + N)) = 154 operations per
// byte, below the ~295 the card needs, so the bytes bound it (205 MB of its
// 514 MB are the output); the conv does 9 times the operations on a third of
// the input bytes, so the tensor cores do.

#include <stdint.h>

#include "common.cuh"
#include "conv3x3_wgmma.cuh"

namespace {

using bf16 = __nv_bfloat16;

// ---------------------------------------------------------------- probe_matmul

constexpr int kGemmBM = 128;        // rows of a tile: two consumer warpgroups of 64
constexpr int kGemmBN = 256;        // columns of a tile: wgmma.m64n256k16
constexpr int kGemmStages = 3;      // 48 KB each, beside the 64 KB output tile
constexpr int kGemmConsumers = 2;   // warpgroups
constexpr int kGemmThreads = 128 * (kGemmConsumers + 1);  // + the producer warpgroup
using GemmRing = wgconv::Ring<kGemmBM, kGemmConsumers, kGemmBN, kGemmStages, true>;
constexpr int kGemmOutBytes = kGemmBM * kGemmBN * 2;
// output tile, ring, its `full` barriers, the `empty` barriers, 1 KB of alignment slack
constexpr int kGemmSmemBytes = 1024 + kGemmOutBytes + GemmRing::kBytes + 2 * GemmRing::kBarBytes;
static_assert(kGemmSmemBytes <= 232448, "shared memory of one block");

// x [M][K] in 64 x 128 boxes (a tile's A: K-major), w [K][N] and out [M][N] in 64 x 64 boxes
struct GemmMaps {
  CUtensorMap x, w, out;
};

__global__ void __launch_bounds__(kGemmThreads, 1)
probe_matmul_kernel(int M, int K, int N, const __grid_constant__ GemmMaps maps) {
  using R = GemmRing;
  constexpr int S = kGemmStages;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = dfc::smem_u32(smem_raw);
  const uint32_t otile = (raw + 1023u) & ~1023u;  // [2 warpgroups][4 column blocks][64 rows][128 bytes]
  const R ring{otile + kGemmOutBytes};
  auto empty = [&](int g) { return ring.full(0) + R::kBarBytes + 8 * (g % S); };
  const int tiles_n = (N + kGemmBN - 1) / kGemmBN;
  const int tiles = ((M + kGemmBM - 1) / kGemmBM) * tiles_n, steps = (K + wgconv::kBK - 1) / wgconv::kBK;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      wgconv::mbar_init(ring.full(s), 1);
      wgconv::mbar_init(empty(s), 128 * kGemmConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == kGemmConsumers) {  // the producer: one thread issues every copy
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x % 128 == 0) {
      int g = 0;  // steps issued, over all of this block's tiles
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int m0 = (t / tiles_n) * kGemmBM, n0 = (t % tiles_n) * kGemmBN;
        // w's 64-column boxes that start inside N (the others would only feed columns never stored)
        const int blocks = min(kGemmBN / 64, (N - n0 + 63) / 64);
        for (int k = 0; k < steps; ++k, ++g) {
          if (g >= S) wgconv::mbar_wait(empty(g), ((g / S) & 1) ^ 1);  // step g - S has freed the stage
          wgconv::mbar_expect_tx(ring.full(g), R::kABytes + blocks * wgconv::kBlock);
          wgconv::tma_load(ring.a(g), &maps.x, ring.full(g), k * wgconv::kBK, m0, 0);
          for (int blk = 0; blk < blocks; ++blk)
            wgconv::tma_load(ring.b(g) + blk * wgconv::kBlock, &maps.w, ring.full(g), n0 + 64 * blk,
                             k * wgconv::kBK, 0);
        }
      }
    }
  } else {  // the consumers: 64 rows each
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int lane = threadIdx.x % 32, lr = ((threadIdx.x % 128) / 32) * 16 + lane / 4;
    const uint32_t mine = otile + wg * (kGemmOutBytes / kGemmConsumers);
    unsigned char* const so = smem_raw + (mine - raw);
    float acc[kGemmBN / 2];
#pragma unroll
    for (int i = 0; i < kGemmBN / 2; ++i) acc[i] = 0.f;
    int g = 0;  // steps consumed
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const int m0 = (t / tiles_n) * kGemmBM, n0 = (t % tiles_n) * kGemmBN;
      for (int k = 0; k < steps; ++k, ++g) {
        wgconv::mbar_wait(ring.full(g), (g / S) & 1);
        dfc::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < wgconv::kBK / 16; ++kk)  // the tile's first product overwrites acc
          dfc::wgmma_ss(acc, wgconv::a_desc(ring.a(g) + wg * (64 * 128), kk), wgconv::b_desc(ring.b(g), 0, kk),
                        k > 0 || kk > 0);
        dfc::wgmma_commit();
        dfc::wgmma_wait<1>();
        dfc::fence_regs(acc);
        if (k > 0) wgconv::mbar_arrive(empty(g - 1));  // step g - 1's products are done
      }
      dfc::wgmma_wait<0>();
      dfc::fence_regs(acc);
      wgconv::mbar_arrive(empty(g - 1));

      // epilogue: bf16 into this warpgroup's half of the output tile (the 128-byte swizzle of 64-column
      // blocks), once the previous tile's stores have read it; then four TMA stores
      if (threadIdx.x % 128 == 0) wgconv::bulk_wait_all<true>();
      wgconv::named_sync(1 + wg, 128);
#pragma unroll
      for (int j = 0; j < kGemmBN / 8; ++j) {
        const int blk = j / 8, cb = (j % 8) * 16 + (lane % 4) * 4;  // byte of the column pair in its block's row
#pragma unroll
        for (int h = 0; h < 2; ++h)
          *reinterpret_cast<uint32_t*>(so + blk * wgconv::kBlock + dfc::swizzle128((lr + 8 * h) * 128 + cb)) =
              dfc::pack2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      wgconv::named_sync(1 + wg, 128);
      if (threadIdx.x % 128 == 0) {  // the boxes that start inside the output
        for (int blk = 0; blk < kGemmBN / 64 && n0 + 64 * blk < N && m0 + 64 * wg < M; ++blk)
          wgconv::tma_store(&maps.out, mine + blk * wgconv::kBlock, n0 + 64 * blk, m0 + 64 * wg, 0);
        wgconv::bulk_commit();
      }
    }
    if (threadIdx.x % 128 == 0) wgconv::bulk_wait_all<false>();
  }
}

// ---------------------------------------------------------------- the conv probes

__global__ void __launch_bounds__(wgconv::kThreads, 1)
probe_conv_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w, bf16* __restrict__ out, int P, int H,
                  int W, int cin, int cout) {
  wgconv::conv3x3_wgmma<wgconv::kBN, wgconv::kStages, false>(x, w, nullptr, out, P, H, W, cin, cout,
                                                             wgconv::NoEpilogue{});
}

// w: [9 * Cin][Cout] in either layout (w3 [3][3*Cin][Cout] and w9 [9][Cin][Cout] are that matrix)
int launch_conv(const void* x, const void* w, void* out, int P, int H, int W, int cin, int cout, void* stream) {
  constexpr int smem = wgconv::conv_smem_bytes<wgconv::kBN, wgconv::kStages, false>();
  const cudaError_t err = cudaFuncSetAttribute(probe_conv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(dfc::ceil_div(P, wgconv::kBM), dfc::ceil_div(cout, wgconv::kBN));
  probe_conv_kernel<<<grid, wgconv::kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w), static_cast<bf16*>(out), P, H, W, cin, cout);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x [M][K], w [K][N], out [M][N]; K and N multiples of 8 (TMA's 16-byte strides), all 16-byte aligned
extern "C" int probe_matmul_bf16(const void* x, const void* w, void* out, int M, int K, int N,
                                 void* stream) {
  if (!wgconv::encode_tiled()) return static_cast<int>(cudaErrorNotSupported);
  GemmMaps maps;
  if (!wgconv::tile_map(&maps.x, x, K, M, 1, kGemmBM) || !wgconv::tile_map(&maps.w, w, N, K, 1, 64) ||
      !wgconv::tile_map(&maps.out, out, N, M, 1, 64))
    return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(probe_matmul_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kGemmSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long tiles = (long long)dfc::ceil_div(M, kGemmBM) * dfc::ceil_div(N, kGemmBN);
  const int grid = static_cast<int>(tiles < sms ? tiles : sms);
  probe_matmul_kernel<<<grid, kGemmThreads, kGemmSmemBytes, static_cast<cudaStream_t>(stream)>>>(M, K, N, maps);
  return static_cast<int>(cudaGetLastError());
}

// w3: [3][3*Cin][Cout]
extern "C" int probe_conv_cat_bf16(const void* x, const void* w3, void* out, int P, int H, int W,
                                   int cin, int cout, void* stream) {
  return launch_conv(x, w3, out, P, H, W, cin, cout, stream);
}

// w9: [9][Cin][Cout]
extern "C" int probe_conv_9dot_bf16(const void* x, const void* w9, void* out, int P, int H, int W,
                                    int cin, int cout, void* stream) {
  return launch_conv(x, w9, out, P, H, W, cin, cout, stream);
}
