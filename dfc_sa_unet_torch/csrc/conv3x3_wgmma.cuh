// A pipelined mainloop on Hopper's warpgroup MMA (wgmma) for 3x3 convs and the
// products around them, for sm_90a.
//
// An implicit GEMM, out[P, Cout] = taps(x)[P, 9*Cin] . w[9*Cin, Cout], with no
// padded copy of x: a block owns BM pixels (any H, W and batch, flat in
// row-major (b, h, w) order, every image edge masked) and its warpgroups own
// 64-row x N-column tiles of the output, with f32 accumulators in registers.
//
// The K dimension is walked in steps of 64 (128 bytes of bf16).  The tail's
// steps lie inside one tap and are zero-padded past Cin: step (tap, c0) gathers
// the tap's shifted pixels x[p + dy*W + dx][c0..c0+64) (the A tile, BM x 64:
// PixelSlots::gather) and the weight rows of that tap and those channels (the
// B tile, 64 x NB).  conv3x3_wgmma below walks K flat instead: step s holds
// rows 64 s .. 64 s + 63 of w [9 * Cin][Cout], so where Cin (a multiple of 8)
// does not fill 64 channels a step packs several taps (gather_taps), each
// 16-byte chunk of a pixel's row masked at the image edge on its own.  The A
// tile is copied by 16-byte cp.async (zero-fill outside the image and past
// the taps), the B tile by cp.async too (copy_weight_tile) or by TMA from a
// tensor map (tma_weight_tile), into a ring of STAGES buffers, written in the
// 128-byte swizzle that the wgmma shared-memory descriptors name: A K-major (a
// pixel's 64 channels are one 128-byte row), B MN-major (the weight is
// [K][Cout] row-major, so wgmma reads it with its transpose flag).  ring_step
// runs one step: the copies of step i + AHEAD are issued before the products
// of step i, and with three stages or more one step's wgmma stays in flight
// (commit_group / wait_group 1) while the next is issued: loads overlap math.
//
// Ring<BM, WGS, NB, STAGES, TMA> is templated on the pixels, the warpgroups, the
// B tile's width, the depth of the ring and how the B tiles come; with
// PixelSlots, tma_weight_tile and ring_step it carries the bf16 DFC tail of
// csrc/dfc_tail.cu, which walks one stream of steps through four products on
// the same ring, and its stage layout and barriers carry the TMA-fed GEMM of
// csrc/mxu_probes.cu (probe_matmul).  conv3x3_wgmma below (128 pixels x NB
// channels, two warpgroups of wgmma.m64nNBk16, an epilogue functor on the f32
// accumulators) carries conv3x3_bn_relu in bf16 (csrc/dfc_tail.cu: bias and
// ReLU, TMA weight tiles) and the two conv probes (csrc/mxu_probes.cu: no
// epilogue, cp.async weight tiles).  It writes its step loop out: built on
// ring_step, ptxas serialized the probes' products (C7515: non-wgmma
// instructions defining their accumulators inside a pipeline stage) and the
// probe ran slower on the card, where the tail's loops compile without it.
// conv3x3_wgmma_narrow (Cin 3 or 8, Cout <= 64: down1) runs the same flat walk
// without a ring: a persistent block of one warpgroup, the weight resident,
// x's pixels gathered into registers a tile ahead, the output stored by TMA.
//
// The host half (encode_tiled, tile_map) encodes the tensor maps through
// cudaGetDriverEntryPointByVersion, so no library links to libcuda.
#pragma once

#include <cuda.h>
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
// one box of a 3-D tensor map at (c0, c1, c2) into dst, its bytes landing on bar
__device__ __forceinline__ void tma_load(uint32_t dst, const void* map, uint32_t bar, int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(map), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
// one box of a 3-D tensor map at (c0, c1, c2) from src (rows and columns past the tensor's
// end are not written), in this thread's bulk group
__device__ __forceinline__ void tma_store(const void* map, uint32_t src, int c0, int c1, int c2) {
  asm volatile("cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];\n" ::"l"(map),
               "r"(src), "r"(c0), "r"(c1), "r"(c2)
               : "memory");
}
__device__ __forceinline__ void bulk_commit() { asm volatile("cp.async.bulk.commit_group;\n" ::: "memory"); }
// until this thread's bulk stores have read their shared memory (READ) or are done
template <bool READ>
__device__ __forceinline__ void bulk_wait_all() {
  if constexpr (READ)
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  else
    asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}
// a barrier of the `threads` threads (whole warps) that name barrier `id` (1..15; 0 is __syncthreads)
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
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
  // a step of a conv's flat K walk (conv3x3_wgmma) that starts at K row tap0 * cin + c0: chunk q =
  // tid % 8 of every row of the A tile at sa is channels c..c+8 of tap t of src [P][cin] at the
  // pixel shifted by tap t, t * cin + c = tap0 * cin + c0 + 8 q (cin a multiple of 8, so a chunk
  // never straddles two taps); zero past the ninth tap and outside the image.  A thread's chunk is
  // the same for all its rows: one tap a step.
  __device__ __forceinline__ void gather_taps(uint32_t sa, const bf16* __restrict__ src, int cin, int tap0, int c0,
                                              int H, int W) const {
    const int q = threadIdx.x % 8;
    int tap = tap0, c = c0 + 8 * q;
    for (; c >= cin; c -= cin) ++tap;
    const int dy = tap / 3 - 1, dx = tap % 3 - 1;
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int hh = ph[i] + dy, ww = pw[i] + dx;
      const bool ok = pix[i] >= 0 && tap < 9 && hh >= 0 && hh < H && ww >= 0 && ww < W;
      const bf16* p = ok ? src + (size_t)(pix[i] + dy * W + dx) * cin + c : src;
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

// ------------------------------------------------ the 3x3 conv on the ring

constexpr int kWarpgroups = 2;
constexpr int kThreads = 128 * kWarpgroups;
constexpr int kBM = 64 * kWarpgroups;  // pixels per block
constexpr int kBN = 256;               // output channels per block of the probes
constexpr int kStages = 4;             // the probes' ring
template <int NB, int STAGES, bool TMA>
using ConvRing = Ring<kBM, kWarpgroups, NB, STAGES, TMA>;
// dynamic shared memory of a conv3x3_wgmma block: the ring, its barriers, 1 KB of slack to align it
template <int NB, int STAGES, bool TMA>
constexpr int conv_smem_bytes() {
  return 1024 + ConvRing<NB, STAGES, TMA>::kBytes + ConvRing<NB, STAGES, TMA>::kBarBytes;
}

// epilogues of the convs: epi(acc, epi.term(n)) is output column n's value from its f32 accumulator,
// before the one rounding to bf16 (a kernel that walks many tiles loads its columns' terms once)
struct NoEpilogue {
  __device__ __forceinline__ float term(int) const { return 0.f; }
  __device__ __forceinline__ float operator()(float v, float) const { return v; }
};
struct BiasRelu {  // ReLU(acc + b), b [cout] f32
  const float* __restrict__ b;
  int cout;
  __device__ __forceinline__ float term(int n) const { return n < cout ? b[n] : 0.f; }
  __device__ __forceinline__ float operator()(float v, float bias) const { return fmaxf(v + bias, 0.f); }
};

// out[P, Cout] = epi(the 3x3 conv (zero padding 1) of NHWC x [P, cin] with w [9 * cin][Cout], row
// tap * cin + c for tap (dy+1)*3 + (dx+1), channel c), rounded once to bf16.  K is walked flat in
// 9 * cin / 64 steps: at a multiple of 64 a step lies in one tap (PixelSlots::gather, the tap's
// shift uniform across the block), at cin = 8 a step packs eight taps (gather_taps).  The block owns pixels blockIdx.x * 128.. and output channels
// blockIdx.y * NB..; two warpgroups of wgmma.m64nNBk16, a ring of STAGES stages.  The weight
// tiles come by TMA from wmap (a [1][9 * cin][Cout] map in 64 x 64 boxes) or by cp.async from
// w.  cin and cout are multiples of 8; x, w and out 16-byte aligned.  The output leaves through
// the ring in coalesced 16-byte stores.
template <int NB, int STAGES, bool TMA, class Epi>
__device__ __forceinline__ void conv3x3_wgmma(const bf16* __restrict__ x, const bf16* __restrict__ w,
                                              const CUtensorMap* wmap, bf16* __restrict__ out, int P, int H,
                                              int W, int cin, int cout, Epi epi) {
  using R = ConvRing<NB, STAGES, TMA>;
  static_assert(kBM * (NB + 8) * 2 <= R::kBytes, "the staging tile of the output reuses the ring");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = dfc::smem_u32(smem_raw);
  const R ring{(raw + 1023u) & ~1023u};
  const int tid = threadIdx.x, wg = tid / 128;
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * NB;
  const int krows = 9 * cin, steps = (krows + kBK - 1) / kBK;
  const PixelSlots<kBM, kThreads> px(m0, P, H, W);
  auto col = [n0](int n) { return n0 + n; };
  // the next step issued (steps are issued in order) starts at K row 64 step = tap * cin + c0
  int tap = 0, c0 = 0;

  auto issue = [&](int step) {
    if (step < steps) {
      if (c0 + kBK <= cin)  // the step lies in one tap (every step where cin is a multiple of 64)
        px.gather(ring.a(step), x, cin, c0, tap / 3 - 1, tap % 3 - 1, H, W);
      else
        px.gather_taps(ring.a(step), x, cin, tap, c0, H, W);
      if constexpr (TMA)
        tma_weight_tile<R, NB>(ring, step, wmap, step * kBK, 0, col);
      else
        copy_weight_tile<NB, kThreads>(ring.b(step), w, step * kBK, krows - step * kBK, cout, cout, col);
      for (c0 += kBK; c0 >= cin; c0 -= cin) ++tap;
    }
    dfc::cp_async_commit();
  };

  // the step loop written out (on ring_step ptxas serialized these products, C7515)
  ring_init(ring);
  float acc[NB / 2];
#pragma unroll
  for (int i = 0; i < NB / 2; ++i) acc[i] = 0.f;
  for (int s = 0; s < R::kAhead; ++s) issue(s);
  for (int i = 0; i < steps; ++i) {
    if constexpr (TMA) mbar_wait(ring.full(i), (i / STAGES) & 1);
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

  // epi in f32, one rounding, the staging tile (kBM rows of NB + 8 bf16), coalesced 16-byte stores
  constexpr int LD = NB + 8;
  bf16* so = reinterpret_cast<bf16*>(smem_raw + (ring.base - raw));
  const int lane = tid % 32, r = wg * 64 + ((tid % 128) / 32) * 16 + lane / 4;
#pragma unroll
  for (int j = 0; j < NB / 8; ++j) {
    const int c = 8 * j + 2 * (lane % 4);
    const float t0 = epi.term(n0 + c), t1 = epi.term(n0 + c + 1);
#pragma unroll
    for (int e = 0; e < 2; ++e)
      *reinterpret_cast<__nv_bfloat162*>(so + (r + 8 * e) * LD + c) =
          __floats2bfloat162_rn(epi(acc[4 * j + 2 * e], t0), epi(acc[4 * j + 2 * e + 1], t1));
  }
  __syncthreads();
  for (int e = tid; e < kBM * (NB / 8); e += kThreads) {
    const int rr = e / (NB / 8), cc = (e % (NB / 8)) * 8;
    const int m = m0 + rr, n = n0 + cc;
    if (m < P && n < cout)
      *reinterpret_cast<uint4*>(out + (size_t)m * cout + n) = *reinterpret_cast<const uint4*>(so + rr * LD + cc);
  }
}

// ------------------------------------------------ the 3x3 conv at Cin = 3 or 8 (down1)

constexpr int kNarrowBM = 64;        // pixels a tile: one warpgroup a block
constexpr int kNarrowThreads = 128;
constexpr int kNarrowTap = 8;        // K rows of a tap in the weight [72][Cout]: Cin zero-padded to 8
// dynamic shared memory of conv3x3_wgmma_narrow: two A tiles (taps 0..7; tap 8), two 64 x 64 B tiles,
// the output tile (64 rows of 64 bf16, the 128-byte swizzle) and 1 KB of alignment slack
constexpr int kNarrowSmemBytes = 1024 + 3 * kNarrowBM * 128 + 2 * static_cast<int>(kBlock);

// One pixel's five 16-byte chunks of an A tile (eight channels of one tap each, zero past CIN), as
// loaded from src [P][CIN]: the loads stay in flight until pack() reads them.
template <int CIN>
struct PixelChunks {
  static_assert(CIN == 3 || CIN == 8, "RGB as it is, or eight channels");
  static constexpr int R = CIN == 8 ? 4 : CIN;  // registers a chunk
  uint32_t v[5][R];
  __device__ __forceinline__ void load(int j, const bf16* __restrict__ src, long long p, bool ok) {
    if constexpr (CIN == 8) {
      const uint4 q = ok ? __ldg(reinterpret_cast<const uint4*>(src) + p) : make_uint4(0, 0, 0, 0);
      v[j][0] = q.x, v[j][1] = q.y, v[j][2] = q.z, v[j][3] = q.w;
    } else {
      const unsigned short* s = reinterpret_cast<const unsigned short*>(src) + p * CIN;
#pragma unroll
      for (int c = 0; c < CIN; ++c) v[j][c] = ok ? __ldg(s + c) : 0u;
    }
  }
  __device__ __forceinline__ uint4 pack(int j) const {
    if constexpr (CIN == 8) return make_uint4(v[j][0], v[j][1], v[j][2], v[j][3]);
    uint32_t h[8] = {};
#pragma unroll
    for (int c = 0; c < CIN; ++c) h[c] = v[j][c];
    return make_uint4(h[0] | h[1] << 16, h[2] | h[3] << 16, h[4] | h[5] << 16, h[6] | h[7] << 16);
  }
};

// out = epi(the 3x3 conv of NHWC x [P, CIN] with w [72][cout], CIN 3 or 8, cout <= 64; w is HWIO with
// Cin zero-padded to 8, so K is nine 8-row taps: the flat walk's two steps, of which the second holds
// only tap 8), rounded once to bf16; out leaves by TMA through omap ([1][P][cout] in 64 x 64 boxes).
// Down1 (RGB, 3 -> 64) is bound by its output, 64 bf16 a pixel against 3 read, so this kernel keeps
// loads and stores in flight instead of running a ring: a persistent block of one warpgroup walks
// 64-pixel tiles (blockIdx.x, += gridDim.x) with the weight resident in shared memory (two B tiles,
// copied once) and the bias terms in registers; a thread gathers one pixel's taps 4 h .. 4 h + 3 (h =
// tid % 2) and, for h = 0, tap 8, straight from x (no padded copy at CIN = 3), one tile ahead: the
// next tile's loads are in flight during this tile's five products of depth 16 (taps 0..7, then
// tap 8 beside 8 zero rows) and its epilogue, which writes the output tile in the 128-byte swizzle
// for one TMA store.  Blocks share nothing after the weight copy, so several an SM run unsynchronised.
template <int CIN, class Epi>
__device__ __forceinline__ void conv3x3_wgmma_narrow(const bf16* __restrict__ x, const bf16* __restrict__ w,
                                                     const CUtensorMap* omap, int P, int H, int W, int cout, Epi epi) {
  constexpr int NB = 64, BM = kNarrowBM;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = dfc::smem_u32(smem_raw);
  const uint32_t a0 = (raw + 1023u) & ~1023u, a1 = a0 + BM * 128, b0 = a1 + BM * 128, b1 = b0 + kBlock;
  const uint32_t otile = b1 + kBlock;
  unsigned char* const base = smem_raw - raw;  // base + a shared address = its generic pointer
  const int tid = threadIdx.x, r = tid / 2, h = tid % 2;
  const int tiles = (P + BM - 1) / BM, stride = static_cast<int>(gridDim.x) * BM;
  auto all = [](int n) { return n; };
  copy_weight_tile<NB, kNarrowThreads>(b0, w, 0, 9 * kNarrowTap, cout, cout, all);
  copy_weight_tile<NB, kNarrowThreads>(b1, w, kBK, 9 * kNarrowTap - kBK, cout, cout, all);
  dfc::cp_async_commit();
  // a1: tap 8 in chunk 0 of every row; its other chunks (taps 9..15, none) stay zero
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (4 * h + j) *reinterpret_cast<uint4*>(base + a1 + swizzle128(r * 128 + (4 * h + j) * 16)) = make_uint4(0, 0, 0, 0);
  const int lane = tid % 32, lr = (tid / 32) * 16 + lane / 4;  // this thread's accumulator rows lr, lr + 8
  float term[NB / 4];  // the epilogue's terms of this thread's columns 8 j + 2 (lane % 4) (+ 1)
#pragma unroll
  for (int j = 0; j < NB / 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) term[2 * j + e] = epi.term(8 * j + 2 * (lane % 4) + e);

  // this thread's pixel m of the next tile, its column and row, advanced by `stride` pixels a tile
  int m = blockIdx.x * BM + r, ww = m % W, hh = (m / W) % H;
  const int dw = stride % W, dh = (stride / W) % H;
  PixelChunks<CIN> px;
  auto gather = [&]() {
#pragma unroll
    for (int j = 0; j < 5; ++j) {
      const int tap = j < 4 ? 4 * h + j : 8, dy = tap / 3 - 1, dx = tap % 3 - 1;
      const bool ok = m < P && (j < 4 || h == 0) && hh + dy >= 0 && hh + dy < H && ww + dx >= 0 && ww + dx < W;
      px.load(j, x, (long long)m + dy * W + dx, ok);
    }
  };
  float acc[NB / 2];
#pragma unroll
  for (int i = 0; i < NB / 2; ++i) acc[i] = 0.f;
  if (blockIdx.x < tiles) gather();
  dfc::cp_async_wait<0>();
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    if (tid == 0) bulk_wait_all<true>();  // the previous tile's store has read the output tile
    __syncthreads();                      // and its products the A tiles
#pragma unroll
    for (int j = 0; j < 4; ++j) *reinterpret_cast<uint4*>(base + a0 + swizzle128(r * 128 + (4 * h + j) * 16)) = px.pack(j);
    if (h == 0) *reinterpret_cast<uint4*>(base + a1 + swizzle128(r * 128)) = px.pack(4);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    m += stride, ww += dw, hh += dh;
    if (ww >= W) ww -= W, ++hh;
    if (hh >= H) hh -= H;
    if (t + static_cast<int>(gridDim.x) < tiles) gather();  // in flight until the next tile's pack()
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)  // the tile's first product overwrites acc
      dfc::wgmma_ss(acc, a_desc(a0, kk), b_desc(b0, 0, kk), kk > 0);
    dfc::wgmma_ss(acc, a_desc(a1, 0), b_desc(b1, 0, 0));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
#pragma unroll
    for (int j = 0; j < NB / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        *reinterpret_cast<uint32_t*>(base + otile + swizzle128((lr + 8 * e) * 128 + 16 * j + 4 * (lane % 4))) =
            dfc::pack2(epi(acc[4 * j + 2 * e], term[2 * j]), epi(acc[4 * j + 2 * e + 1], term[2 * j + 1]));
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    if (tid == 0) {
      tma_store(omap, otile, 0, t * BM, 0);
      bulk_commit();
    }
  }
  if (tid == 0) bulk_wait_all<false>();
}

// ------------------------------------------------ tensor maps (host)

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, fetched through the runtime (no link to libcuda); null if missing
inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found) !=
            cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      p = nullptr;
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// a map of the bf16 tensor [z][rows][cols] at t in boxes of 64 columns (128 bytes, the 128-byte
// swizzle) x box_rows rows x 1; boxes read zero past the tensor's end and are clipped there when
// stored.  cols is a multiple of 8 (16-byte strides), t 16-byte aligned.
inline bool tile_map(CUtensorMap* map, const void* t, uint64_t cols, uint64_t rows, uint64_t z, uint32_t box_rows) {
  const cuuint64_t dims[3] = {cols, rows, z}, strides[2] = {cols * 2, cols * rows * 2};
  const cuuint32_t box[3] = {64, box_rows, 1}, unit[3] = {1, 1, 1};
  return encode_tiled()(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(t), dims, strides, box, unit,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}
}  // namespace wgconv
}  // namespace
