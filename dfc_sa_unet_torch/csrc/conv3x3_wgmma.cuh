// A 3x3 conv mainloop on Hopper's warpgroup MMA (wgmma), for sm_90a.
//
// An implicit GEMM, out[P, Cout] = taps(x)[P, 9*Cin] . w[9*Cin, Cout], with no
// padded copy of x: a block owns kBM = 128 pixels (any H, W and batch, flat in
// row-major (b, h, w) order, every image edge masked) x kBN = 256 output
// channels.  Its two warpgroups each own 64 pixel rows and run
// wgmma.mma_async.m64n256k16 with f32 accumulators in registers (128 a thread).
//
// The K dimension is walked in steps of kBK = 64 channels (128 bytes of bf16),
// each inside one tap and zero-padded past Cin: step (tap, c0) gathers the
// tap's shifted pixels x[p + dy*W + dx][c0..c0+64) (the A tile, 128 x 64) and
// the weight rows of that tap and those channels (the B tile, 64 x 256).
// Both tiles are copied by 16-byte cp.async (zero-fill outside the image and
// past Cin or Cout) into a ring of kStages = 4 buffers of 48 KB, written in
// the 128-byte swizzle that the wgmma shared-memory descriptors name: A
// K-major (a pixel's 64 channels are one 128-byte row), B MN-major (the
// weight is [K][Cout] row-major, so wgmma reads it with its transpose flag).
// The copies of step i + 2 are issued before the products of step i, and one
// step's wgmma stays in flight (commit_group / wait_group 1) while the next
// is issued: loads overlap math.  The epilogue rounds to bf16 and stores
// through shared memory, 16 bytes a thread, coalesced.
//
// Its user is csrc/mxu_probes.cu (probe_conv_cat, probe_conv_9dot).  The
// port's other conv kernels still run on the mma.sync mainloop of
// conv3x3_mainloop.cuh.
#pragma once

#include <stdint.h>

#include "common.cuh"

namespace {
namespace wgconv {

using bf16 = __nv_bfloat16;

constexpr int kWarpgroups = 2;
constexpr int kThreads = 128 * kWarpgroups;
constexpr int kBM = 64 * kWarpgroups;  // pixels per block
constexpr int kBN = 256;               // output channels per block
constexpr int kBK = 64;                // channels per step: one 128-byte swizzle row
constexpr int kStages = 4;
constexpr int kATile = kBM * kBK * 2;  // 16 KB: [kBM][kBK], K-major
constexpr int kBTile = kBK * kBN * 2;  // 32 KB: [kBN / 64][kBK][64], MN-major
constexpr int kStageBytes = kATile + kBTile;
constexpr int kSmemBytes = kStages * kStageBytes + 1024;  // + slack to align the ring to 1 KB
constexpr int kOutLd = kBN + 8;                             // epilogue row stride, elements
static_assert(kBM * kOutLd * 2 <= kStages * kStageBytes, "the epilogue tile reuses the ring");

// wgmma descriptor strides (bytes).  A, K-major: 8-row groups of 128-byte rows lie
// 1024 bytes apart; the leading offset is unused with the 128-byte swizzle.  B,
// MN-major: the 64-column blocks (kBK rows of 128 bytes each) lie kBK * 128 bytes
// apart, the 8-row groups of k 1024 bytes apart.
constexpr uint32_t kALbo = 16, kASbo = 1024;
constexpr uint32_t kBLbo = kBK * 128, kBSbo = 1024;

// the 128-byte swizzle (Swizzle<3,4,3>): the 16-byte chunk index (bits 4-6) is XORed
// with the row within an 8-row, 1 KB atom (bits 7-9); offsets from a 1 KB-aligned base
__device__ __forceinline__ uint32_t swizzle128(uint32_t off) { return off ^ (((off >> 7) & 7) << 4); }

__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);  // layout type 1: 128-byte swizzle
}

// d += A . B for a 64 x 256 x 16 product: A K-major and B MN-major (transpose flag 1),
// both in shared memory.  d[4j + r] is row 16*warp + lane/4 (+8 for r >= 2), column
// 8j + 2*(lane%4) + (r & 1) of the warpgroup's tile.
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128], uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{" 
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keep the compiler from moving accumulator reads or writes across a wgmma wait
__device__ __forceinline__ void fence_acc(float (&d)[128]) {
#pragma unroll
  for (int i = 0; i < 128; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// out[P, Cout] = the 3x3 conv (zero padding 1) of NHWC x [P, Cin] with the weight
// rows that row(tap, c) gives: the row of tap (dy+1)*3 + (dx+1), channel c.
// cin and cout are multiples of 8; x, w and out 16-byte aligned.
template <typename WeightRow>
__device__ __forceinline__ void conv3x3_wgmma(const bf16* __restrict__ x, const bf16* __restrict__ w,
                                              bf16* __restrict__ out, int P, int H, int W, int cin,
                                              int cout, WeightRow row) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = dfc::smem_u32(smem_raw);
  const uint32_t ring = (raw + 1023u) & ~1023u;
  const int tid = threadIdx.x, wg = tid / 128;
  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * kBM;
  const int kchunks = (cin + kBK - 1) / kBK, steps = 9 * kchunks;

  // this thread's copies: A rows tid/8 + 32i (i < 4), chunk tid%8; B rows tid/32 + 8i
  // (i < 8), columns 8*(tid%32)..+8
  constexpr int ASLOTS = kBM * 8 / kThreads, BSLOTS = kBK * (kBN / 8) / kThreads;
  const int aq = tid % 8;
  int apix[ASLOTS], ah[ASLOTS], aw[ASLOTS];
#pragma unroll
  for (int i = 0; i < ASLOTS; ++i) {
    const int m = m0 + tid / 8 + 32 * i;
    apix[i] = m < P ? m : -1;
    aw[i] = m % W;
    ah[i] = (m / W) % H;
  }
  const int bn = (tid % 32) * 8;
  const bool bcol = n0 + bn < cout;
  const uint32_t boff = (bn / 64) * (kBK * 128) + (bn % 64) * 2;

  auto issue = [&](int step) {  // the copies of one step into its ring buffer, one commit group
    if (step < steps) {
      const int tap = step / kchunks, c0 = (step - tap * kchunks) * kBK;
      const int dy = tap / 3 - 1, dx = tap % 3 - 1;
      const uint32_t sa = ring + (step % kStages) * kStageBytes, sb = sa + kATile;
      const int ci = c0 + aq * 8;
#pragma unroll
      for (int i = 0; i < ASLOTS; ++i) {
        const int hh = ah[i] + dy, ww = aw[i] + dx;
        const bool ok = apix[i] >= 0 && ci < cin && hh >= 0 && hh < H && ww >= 0 && ww < W;
        const bf16* src = ok ? x + (size_t)(apix[i] + dy * W + dx) * cin + ci : x;
        dfc::cp_async16(sa + swizzle128((tid / 8 + 32 * i) * 128 + aq * 16), src, ok);
      }
      const size_t r0 = row(tap, c0);
#pragma unroll
      for (int i = 0; i < BSLOTS; ++i) {
        const int kk = tid / 32 + 8 * i;
        const bool ok = bcol && c0 + kk < cin;
        const bf16* src = ok ? w + (r0 + kk) * cout + n0 + bn : w;
        dfc::cp_async16(sb + swizzle128(boff + kk * 128), src, ok);
      }
    }
    dfc::cp_async_commit();
  };

  float acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.f;
  for (int s = 0; s < kStages - 2; ++s) issue(s);
  for (int i = 0; i < steps; ++i) {
    dfc::cp_async_wait<kStages - 3>();  // this thread's copies of step i have landed
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // visible to wgmma
    __syncthreads();  // everyone's have; both warpgroups finished the products of step i - 2
    issue(i + kStages - 2);
    const uint32_t sa = ring + (i % kStages) * kStageBytes + wg * (64 * 128), sb = ring + (i % kStages) * kStageBytes + kATile;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
      wgmma_m64n256k16(acc, smem_desc(sa + kk * 32, kALbo, kASbo), smem_desc(sb + kk * 16 * 128, kBLbo, kBSbo));
    wgmma_commit();
    wgmma_wait<1>();  // step i - 1's products are done: its buffer may be refilled after the next barrier
    fence_acc(acc);
  }
  wgmma_wait<0>();
  fence_acc(acc);
  dfc::cp_async_wait<0>();
  __syncthreads();  // the ring is free: it holds the output tile now

  bf16* so = reinterpret_cast<bf16*>(smem_raw + (ring - raw));  // [kBM][kOutLd]
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
