// A pipelined mainloop on Hopper's warpgroup MMA (wgmma) for 3x3 convs and the
// products around them, for sm_90a.
//
// An implicit GEMM, out[P, Cout] = taps(x)[P, 9*Cin] . w[9*Cin, Cout], with no
// padded copy of x: a block owns BM pixels (any H, W and batch, flat in
// row-major (b, h, w) order, every image edge masked) and its warpgroups own
// 64-row x N-column tiles of the output, with f32 accumulators in registers.
//
// The K dimension is walked in steps of 64 channels (128 bytes of bf16), each
// inside one tap and zero-padded past Cin: step (tap, c0) gathers the tap's
// shifted pixels x[p + dy*W + dx][c0..c0+64) (the A tile, BM x 64:
// PixelSlots::gather) and the weight rows of that tap and those channels (the
// B tile, 64 x NB).  The A tile is copied by 16-byte cp.async (zero-fill
// outside the image and past Cin), the B tile by cp.async too
// (copy_weight_tile) or by TMA from a tensor map (tma_weight_tile), into a
// ring of STAGES buffers, written in the 128-byte swizzle that the wgmma
// shared-memory descriptors name: A K-major (a pixel's 64 channels are one
// 128-byte row), B MN-major (the weight is [K][Cout] row-major, so wgmma reads
// it with its transpose flag).  ring_step runs one step: the copies of step
// i + AHEAD are issued before the products of step i, and with three stages
// or more one step's wgmma stays in flight (commit_group / wait_group 1) while
// the next is issued: loads overlap math.
//
// Ring<BM, WGS, NB, STAGES, TMA> is templated on the pixels, the warpgroups, the
// B tile's width, the depth of the ring and how the B tiles come; with
// PixelSlots, tma_weight_tile and ring_step it carries the bf16 DFC tail of
// csrc/dfc_tail.cu, which walks one stream of steps through four products on
// the same ring.  conv3x3_wgmma below (the probes of csrc/mxu_probes.cu: 128
// pixels x 256 channels, two warpgroups of wgmma.m64n256k16, four stages,
// cp.async for both tiles) writes its step loop out: built on ring_step,
// ptxas serialized its products
// (C7515: non-wgmma instructions defining their accumulators inside a pipeline
// stage) and the probe ran slower on the card, where the tail's loops compile
// without it.
#pragma once

#include <stdint.h>

#include "common.cuh"
#include "wgmma.cuh"

namespace {
namespace wgconv {

using bf16 = __nv_bfloat16;
using dfc::fence_regs;
using dfc::smem_desc;
using dfc::swizzle128;
using dfc::wgmma_commit;
using dfc::wgmma_fence;
using dfc::wgmma_wait;

constexpr int kBK = 64;            // channels per step: one 128-byte swizzle row
constexpr uint32_t kBlock = kBK * 128;  // bytes of a 64-column block of a B tile (its LBO)

// A ring of STAGES buffers, each an A tile [BM][64] (K-major) and a B tile
// [NB / 64][64][64] (MN-major), from a 1 KB-aligned base.  With three stages or
// more one step's products stay in flight, and the copies run AHEAD = STAGES - 2
// steps ahead; with two, the products of a step end with it and the copies run
// one step ahead.
//
// TMA: the B tiles (the weights) come by TMA from tensor maps, thread 0 issuing a
// tile's 64 x 64 boxes, so no thread holds their addresses; each stage then has an
// mbarrier after the ring, `full`, on which the tile's bytes land.
template <int BM, int WGS, int NB, int STAGES, bool TMA = false>
struct Ring {
  static constexpr int kThreads = 128 * WGS;
  static constexpr int kStages = STAGES;
  static constexpr bool kTma = TMA;
  static constexpr int kABytes = BM * 128;
  static constexpr int kStageBytes = kABytes + NB * 128;
  static constexpr int kBytes = STAGES * kStageBytes;
  static constexpr int kBarBytes = TMA ? 8 * STAGES : 0;  // after the ring
  static constexpr int kInFlight = STAGES >= 3 ? 1 : 0;
  static constexpr int kAhead = STAGES - 1 - kInFlight;
  static_assert(BM % 64 == 0 && NB % 64 == 0 && kAhead >= 1, "tile shape");
  uint32_t base;
  __device__ __forceinline__ uint32_t a(int step) const { return base + (step % STAGES) * kStageBytes; }
  __device__ __forceinline__ uint32_t b(int step) const { return a(step) + kABytes; }
  __device__ __forceinline__ uint32_t full(int step) const { return base + kBytes + (step % STAGES) * 8; }
};

// ------------------------------------------------ mbarriers and TMA

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes) : "memory");
}
// wait until the phase of parity `parity` of the barrier has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred done;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}
// one 64 x 64 box of a 3-D tensor map at (c0, c1, c2) into dst, its bytes landing on bar
__device__ __forceinline__ void tma_load(uint32_t dst, const void* map, uint32_t bar, int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(map), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// Before the first step: a TMA ring's barriers, seen by every thread.  Every thread.
template <class R>
__device__ __forceinline__ void ring_init(const R& ring) {
  if constexpr (R::kTma) {
    if (threadIdx.x == 0) {
      for (int s = 0; s < R::kStages; ++s) mbar_init(ring.full(s), 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
  }
}

// Step s's B tile by TMA, from thread 0: box n of the tile (NB / 64 of them) is the 64 x 64
// box at (col(64 n), r0, z) of the 3-D tensor map `map` (rows past the tensor's end read
// zero), and the stage's `full` barrier expects the whole tile.
template <class R, int NB, class Col>
__device__ __forceinline__ void tma_weight_tile(const R& ring, int s, const void* map, int r0, int z, Col col) {
  if (threadIdx.x != 0) return;
  mbar_expect_tx(ring.full(s), NB * 128);
#pragma unroll
  for (int blk = 0; blk < NB / 64; ++blk) tma_load(ring.b(s) + blk * kBlock, map, ring.full(s), col(blk * 64), r0, z);
}

// The pixels of a BM-pixel tile whose copies this thread makes: rows tid/8 + (THREADS/8) i
// of the tile, the 16-byte chunk tid % 8 of their 64 channels.
template <int BM, int THREADS>
struct PixelSlots {
  static constexpr int N = BM * 8 / THREADS;
  int pix[N], ph[N], pw[N];
  __device__ __forceinline__ PixelSlots(int m0, int P, int H, int W) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int m = m0 + threadIdx.x / 8 + (THREADS / 8) * i;
      pix[i] = m < P ? m : -1;
      pw[i] = m % W;
      ph[i] = (m / W) % H;
    }
  }
  // the A tile at sa: channels c0..c0+64 of the tile's pixels shifted by (dy, dx), from
  // src [P][ch]; zero outside the image and past ch
  __device__ __forceinline__ void gather(uint32_t sa, const bf16* __restrict__ src, int ch, int c0, int dy,
                                         int dx, int H, int W) const {
    const int q = threadIdx.x % 8, ci = c0 + q * 8;
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int hh = ph[i] + dy, ww = pw[i] + dx;
      const bool ok = pix[i] >= 0 && ci < ch && hh >= 0 && hh < H && ww >= 0 && ww < W;
      const bf16* p = ok ? src + (size_t)(pix[i] + dy * W + dx) * ch + ci : src;
      dfc::cp_async16(sa + swizzle128((threadIdx.x / 8 + (THREADS / 8) * i) * 128 + q * 16), p, ok);
    }
  }
};

// The B tile at sb, 64 x NB: tile row kk is row r0 + kk of the row-major weight w [*][ld]
// (zero for kk >= rows), tile column n its column col(n) (zero where that is >= cols).
template <int NB, int THREADS, typename Col>
__device__ __forceinline__ void copy_weight_tile(uint32_t sb, const bf16* __restrict__ w, int r0, int rows,
                                                 int ld, int cols, Col col) {
  static_assert(kBK * NB / 8 % THREADS == 0, "whole rounds of copies");
#pragma unroll
  for (int j = 0; j < kBK * NB / 8 / THREADS; ++j) {
    const int i = threadIdx.x + j * THREADS;
    const int kk = i / (NB / 8), n = (i % (NB / 8)) * 8, gc = col(n);
    const bool ok = kk < rows && gc < cols;
    const bf16* p = ok ? w + (size_t)(r0 + kk) * ld + gc : w;
    dfc::cp_async16(sb + swizzle128((n / 64) * kBlock + kk * 128 + (n % 64) * 2), p, ok);
  }
}

// descriptors of k-step kk (16 deep) of a K-major A tile at a (from its row 0) and of the
// n-th 64-column block of an MN-major B tile at b
__device__ __forceinline__ uint64_t a_desc(uint32_t a, int kk) { return dfc::kmajor_desc(a + kk * 32); }
__device__ __forceinline__ uint64_t b_desc(uint32_t b, int block, int kk) {
  return smem_desc(b + block * kBlock + kk * 16 * 128, kBlock, 1024);
}

// The copies of the first AHEAD steps: each issue(step) is one commit group.
template <class R, class Issue>
__device__ __forceinline__ void ring_prologue(int steps, Issue&& issue) {
#pragma unroll
  for (int s = 0; s < R::kAhead; ++s) {
    if (s < steps) issue(s);
    dfc::cp_async_commit();
  }
}

// Step i of `steps`: wait for its copies and make them visible to wgmma, issue the
// copies of step i + AHEAD (its buffer's products are done), then mma(i), the products
// into acc, between a wgmma fence and commit, leaving kInFlight groups of products in
// flight.  acc is fenced after the wait, so that no access to it moves across one (ptxas
// would serialize the products if it did).  Writes a thread made to shared memory before
// the call (an epilogue's) are visible to the products of step i.  With TMA, step i's B
// tile is awaited on its `full` barrier.
template <class R, class Issue, class Mma, int N>
__device__ __forceinline__ void ring_step(const R& ring, int i, int steps, Issue&& issue, Mma&& mma,
                                          float (&acc)[N]) {
  if constexpr (R::kTma) mbar_wait(ring.full(i), (i / R::kStages) & 1);
  dfc::cp_async_wait<R::kAhead - 1>();
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  if (i + R::kAhead < steps) issue(i + R::kAhead);
  dfc::cp_async_commit();
  wgmma_fence();
  mma(i);
  wgmma_commit();
  wgmma_wait<R::kInFlight>();
  fence_regs(acc);
}

// ------------------------------------------------ the probes' plain conv

constexpr int kWarpgroups = 2;
constexpr int kThreads = 128 * kWarpgroups;
constexpr int kBM = 64 * kWarpgroups;  // pixels per block
constexpr int kBN = 256;               // output channels per block
constexpr int kStages = 4;
using ProbeRing = Ring<kBM, kWarpgroups, kBN, kStages>;
constexpr int kSmemBytes = ProbeRing::kBytes + 1024;  // + slack to align the ring to 1 KB
constexpr int kOutLd = kBN + 8;                       // epilogue row stride, elements
static_assert(kBM * kOutLd * 2 <= ProbeRing::kBytes, "the epilogue tile reuses the ring");

// out[P, Cout] = the 3x3 conv (zero padding 1) of NHWC x [P, Cin] with the weight
// rows that row(tap, c) gives: the row of tap (dy+1)*3 + (dx+1), channel c.
// cin and cout are multiples of 8; x, w and out 16-byte aligned.
template <typename WeightRow>
__device__ __forceinline__ void conv3x3_wgmma(const bf16* __restrict__ x, const bf16* __restrict__ w,
                                              bf16* __restrict__ out, int P, int H, int W, int cin,
                                              int cout, WeightRow row) {
  using R = ProbeRing;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = dfc::smem_u32(smem_raw);
  const R ring{(raw + 1023u) & ~1023u};
  const int tid = threadIdx.x, wg = tid / 128;
  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * kBM;
  const int kchunks = (cin + kBK - 1) / kBK, steps = 9 * kchunks;
  const PixelSlots<kBM, kThreads> px(m0, P, H, W);

  auto issue = [&](int step) {
    if (step < steps) {
      const int tap = step / kchunks, c0 = (step - tap * kchunks) * kBK;
      px.gather(ring.a(step), x, cin, c0, tap / 3 - 1, tap % 3 - 1, H, W);
      copy_weight_tile<kBN, kThreads>(ring.b(step), w, (int)row(tap, c0), cin - c0, cout, cout,
                                      [n0](int n) { return n0 + n; });
    }
    dfc::cp_async_commit();
  };

  // the step loop written out (on ring_step ptxas serialized these products, C7515)
  float acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.f;
  for (int s = 0; s < R::kAhead; ++s) issue(s);
  for (int i = 0; i < steps; ++i) {
    dfc::cp_async_wait<R::kAhead - 1>();
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    issue(i + R::kAhead);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
      dfc::wgmma_ss(acc, a_desc(ring.a(i) + wg * (64 * 128), kk), b_desc(ring.b(i), 0, kk));
    wgmma_commit();
    wgmma_wait<R::kInFlight>();
    fence_regs(acc);
  }
  wgmma_wait<0>();
  fence_regs(acc);
  dfc::cp_async_wait<0>();
  __syncthreads();

  bf16* so = reinterpret_cast<bf16*>(smem_raw + (ring.base - raw));
  const int lane = tid % 32, r = wg * 64 + ((tid % 128) / 32) * 16 + lane / 4;
#pragma unroll
  for (int j = 0; j < kBN / 8; ++j) {
    const int col = 8 * j + 2 * (lane % 4);
    *reinterpret_cast<__nv_bfloat162*>(so + r * kOutLd + col) = __floats2bfloat162_rn(acc[4 * j], acc[4 * j + 1]);
    *reinterpret_cast<__nv_bfloat162*>(so + (r + 8) * kOutLd + col) =
        __floats2bfloat162_rn(acc[4 * j + 2], acc[4 * j + 3]);
  }
  __syncthreads();
  for (int e = tid; e < kBM * (kBN / 8); e += kThreads) {
    const int rr = e / (kBN / 8), cc = (e % (kBN / 8)) * 8;
    const int m = m0 + rr, n = n0 + cc;
    if (m < P && n < cout)
      *reinterpret_cast<uint4*>(out + (size_t)m * cout + n) = *reinterpret_cast<const uint4*>(so + rr * kOutLd + cc);
  }
}

}  // namespace wgconv
}  // namespace
