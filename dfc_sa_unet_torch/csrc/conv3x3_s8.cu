// The int8 3x3 conv of the int8 serving engine, for Hopper (sm_90a).
//
// No Pallas counterpart: the JAX int8 engine runs its quantized 3x3 convs as
// s8 x s8 -> s32 XLA convolutions with the dequant epilogue after them
// (dfc_sa_unet_tpu/infer/quant.py:240-246, _conv_s8 and Int8DFCEngine._block).
// PyTorch has no int8 convolution on CUDA, so this kernel computes both:
//
//   out[p, n] = ReLU(f32(sum over taps and channels of x8 . w8, in s32) * scale[n] + b[n])
//
// rounded once to the output type (bf16, or f32 for an f32 engine).  x8 is s8
// NHWC [P][Cin] (padding 1, every image edge masked), w8 s8 [Cout][9 * Cin]
// (K-major: column tap * Cin + c for tap (dy+1)*3 + (dx+1), channel c), scale =
// f32(sx) * s_w and b f32 [Cout].  Cin is a multiple of 16 and Cout of 8 (the
// wrapper, ops/conv_s8.py, zero-pads Cin).
//
// What bounds it on the H100: 2 * 9 * Cin * Cout operations a pixel on Cin + Cout
// (bf16 out: 2 Cout) bytes, over 1000 operations a byte at the int8 engine's
// "auto" levels (down4, bottleneck, up_conv4, up_conv3: Cin 256 to 1024): the
// tensor cores' 1979 TOP/s of dense s8, twice their bf16 rate.
//
// Design: the implicit GEMM of conv3x3_wgmma.cuh.  A block owns 128 pixels and
// NB output channels, two warpgroups of wgmma.m64nNBk32.s32.s8.s8 with s32
// accumulators (the register layout of the f32 ones), a ring of four stages in
// the 128-byte swizzle whose A tiles PixelSlots gathers by cp.async straight
// from x, zero at the image edges and past the ninth tap (no padded copy of x).
// 8-bit wgmma takes no transpose flags, so both operands are K-major: the weight
// is stored [Cout][9 Cin] and a B tile is NB rows of 128 K-bytes, copied by
// cp.async in the same swizzle as an A tile (copy_weight_rows).  A step is 128
// channels, 128 bytes a pixel: the bytes of a bf16 step of 64 channels, so the
// bf16 gathers move it unchanged with x seen as 2-byte units (Cin / 2 of them);
// at Cin 256 to 1024 every step lies inside one tap.  The epilogue is
// __fadd_rn(__fmul_rn(__int2float_rn(acc), scale), b), then ReLU and one
// rounding: with the _rn intrinsics no multiply-add is contracted, so the kernel
// equals its plain version (ops/conv_s8.py::conv3x3_s8_plain) bit for bit.  The
// output leaves through the ring in coalesced 16-byte stores.
//
// Row sharding (parallel/rows.py): conv3x3_s8_halo_kernel is the same body with
// dfc::HaloRows, whose taps in rows -1 and H read the halo rows top and bot
// ([B][W][Cin] s8 each, Cin zero-padded as x is, null at the image's edge) as
// PixelSlots reads x, in 2-byte units; conv3x3_s8_kernel keeps dfc::NoHalo and
// its code.

#include <cuda.h>
#include <stdint.h>

#include "common.cuh"
#include "conv3x3_wgmma.cuh"
#include "wgmma.cuh"

namespace {

using bf16 = __nv_bfloat16;
using wgconv::kBM;
using wgconv::kThreads;

constexpr int kStepBytes = 128;  // K-bytes a step: 128 channels of s8, one swizzle row
constexpr int kStages = 4;
template <int NB>
using S8Ring = wgconv::Ring<kBM, wgconv::kWarpgroups, NB, kStages, false>;
// dynamic shared memory of a block: the ring and 1 KB of slack to align it
template <int NB>
constexpr int s8_smem_bytes() {
  return 1024 + S8Ring<NB>::kBytes;
}

// keep the compiler from moving accumulator reads or writes across a wgmma fence or wait
template <int R>
__device__ __forceinline__ void fence_acc(int (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// d += A . B for a 64 x N x 32 product of s8 with s32 sums, N = 2 R, both operands K-major in
// shared memory (8-bit wgmma has no transpose flags).  d[4j + r] is row 16*warp + lane/4 (+8 for
// r >= 2), column 8j + 2*(lane%4) + (r & 1) of the warpgroup's 64 x N tile, as for wgmma_ss.
template <int R>
__device__ __forceinline__ void wgmma_s8(int (&d)[R], uint64_t desc_a, uint64_t desc_b, int accumulate = 1) {
  static_assert(R == 32 || R == 64 || R == 128, "N is 64, 128 or 256");
  if constexpr (R == 32) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
        : "l"(desc_a), "l"(desc_b), "r"(accumulate));
  } else if constexpr (R == 64) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
        : "l"(desc_a), "l"(desc_b), "r"(accumulate));
  } else if constexpr (R == 128) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
        "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
        "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
        "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
        "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
        "%128, %129, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
        "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]),
        "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
        "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]),
        "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]), "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]),
        "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
        : "l"(desc_a), "l"(desc_b), "r"(accumulate));
  }
}

// The B tile of a step at sb, NB x 128 bytes K-major: row n is K-bytes k0 .. k0 + 127 of weight row
// n0 + n of w [cout][krow], zero past krow and past cout (krow a multiple of 16, so a 16-byte chunk
// lies wholly inside or outside).  Eight neighbouring threads copy one row's 128 bytes.
template <int NB>
__device__ __forceinline__ void copy_weight_rows(uint32_t sb, const int8_t* __restrict__ w, int n0, int cout,
                                                 int krow, int k0) {
  static_assert(NB * 8 % kThreads == 0, "whole rounds of copies");
#pragma unroll
  for (int j = 0; j < NB * 8 / kThreads; ++j) {
    const int i = threadIdx.x + j * kThreads, n = i / 8, q = i % 8, k = k0 + 16 * q;
    const bool ok = n0 + n < cout && k < krow;
    const int8_t* p = ok ? w + (size_t)(n0 + n) * krow + k : w;
    dfc::cp_async16(sb + dfc::swizzle128(n * 128 + q * 16), p, ok);
  }
}

__device__ __forceinline__ float dequant_relu(int acc, float scale, float bias) {
  return fmaxf(__fadd_rn(__fmul_rn(__int2float_rn(acc), scale), bias), 0.f);
}

// two neighbouring columns of one row of the staging tile, rounded once to OutT
__device__ __forceinline__ void store_pair(bf16* p, float v0, float v1) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
}
__device__ __forceinline__ void store_pair(float* p, float v0, float v1) {
  *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
}

// out [P][cout] = ReLU(conv3x3(x, w) * scale + bias) (see the file's head).  The block owns pixels
// blockIdx.x * 128.. and output channels blockIdx.y * NB..; K = 9 * cin bytes is walked flat in
// 128-byte steps, one tap a step where cin is a multiple of 128 (PixelSlots::gather, the tap's shift
// uniform across the block), several taps or a step across a tap's end otherwise (gather_taps).
// Halo: dfc::NoHalo, or dfc::HaloRows<bf16> over the s8 halo rows seen as 2-byte units.
template <int NB, typename OutT, class Halo>
__device__ __forceinline__ void conv3x3_s8_body(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                                                const float* __restrict__ scale, const float* __restrict__ bias,
                                                OutT* __restrict__ out, int P, int H, int W, int cin, int cout,
                                                Halo halo) {
  using R = S8Ring<NB>;
  constexpr int LD = NB + 16 / static_cast<int>(sizeof(OutT));  // staging row: NB values and 16 bytes
  static_assert(kBM * LD * static_cast<int>(sizeof(OutT)) <= R::kBytes, "the staging tile reuses the ring");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = dfc::smem_u32(smem_raw);
  const R ring{(raw + 1023u) & ~1023u};
  const int tid = threadIdx.x, wg = tid / 128;
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * NB;
  const int units = cin / 2, krow = 9 * cin, steps = (krow + kStepBytes - 1) / kStepBytes;
  const bf16* xu = reinterpret_cast<const bf16*>(x);  // x as 2-byte units: the bf16 gathers' chunks
  const wgconv::PixelSlots<kBM, kThreads, Halo> px(m0, P, H, W, halo);
  // the next step issued (steps are issued in order) starts at unit row tap * units + c0
  int tap = 0, c0 = 0;

  auto issue = [&](int step) {
    if (step < steps) {
      if (c0 + wgconv::kBK <= units)  // the step lies in one tap
        px.gather(ring.a(step), xu, units, c0, tap / 3 - 1, tap % 3 - 1, H, W);
      else
        px.gather_taps(ring.a(step), xu, units, tap, c0, H, W);
      copy_weight_rows<NB>(ring.b(step), w, n0, cout, krow, step * kStepBytes);
      for (c0 += wgconv::kBK; c0 >= units; c0 -= units) ++tap;
    }
    dfc::cp_async_commit();
  };

  int acc[NB / 2];
#pragma unroll
  for (int i = 0; i < NB / 2; ++i) acc[i] = 0;
  for (int s = 0; s < R::kAhead; ++s) issue(s);
  for (int i = 0; i < steps; ++i) {
    dfc::cp_async_wait<R::kAhead - 1>();
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    issue(i + R::kAhead);
    dfc::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kStepBytes / 32; ++kk)
      wgmma_s8(acc, wgconv::a_desc(ring.a(i) + wg * (64 * 128), kk), dfc::kmajor_desc(ring.b(i) + kk * 32));
    dfc::wgmma_commit();
    dfc::wgmma_wait<R::kInFlight>();
    fence_acc(acc);
  }
  dfc::wgmma_wait<0>();
  fence_acc(acc);
  dfc::cp_async_wait<0>();
  __syncthreads();

  // the epilogue in f32, one rounding, the staging tile (kBM rows of LD), coalesced 16-byte stores
  OutT* so = reinterpret_cast<OutT*>(smem_raw + (ring.base - raw));
  const int lane = tid % 32, r = wg * 64 + ((tid % 128) / 32) * 16 + lane / 4;
#pragma unroll
  for (int j = 0; j < NB / 8; ++j) {
    const int c = 8 * j + 2 * (lane % 4), n = n0 + c;
    const float s0 = n < cout ? scale[n] : 0.f, s1 = n + 1 < cout ? scale[n + 1] : 0.f;
    const float b0 = n < cout ? bias[n] : 0.f, b1 = n + 1 < cout ? bias[n + 1] : 0.f;
#pragma unroll
    for (int e = 0; e < 2; ++e)
      store_pair(so + (r + 8 * e) * LD + c, dequant_relu(acc[4 * j + 2 * e], s0, b0),
                 dequant_relu(acc[4 * j + 2 * e + 1], s1, b1));
  }
  __syncthreads();
  constexpr int CH = 16 / static_cast<int>(sizeof(OutT));  // values in a 16-byte chunk
  for (int e = tid; e < kBM * (NB / CH); e += kThreads) {
    const int rr = e / (NB / CH), cc = (e % (NB / CH)) * CH;
    const int m = m0 + rr, n = n0 + cc;
    if (m < P && n < cout)
      *reinterpret_cast<uint4*>(out + (size_t)m * cout + n) = *reinterpret_cast<const uint4*>(so + rr * LD + cc);
  }
}

template <int NB, typename OutT>
__global__ void __launch_bounds__(kThreads, wgconv::conv_blocks(s8_smem_bytes<NB>()))
conv3x3_s8_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w, const float* __restrict__ scale,
                  const float* __restrict__ bias, OutT* __restrict__ out, int P, int H, int W, int cin, int cout) {
  conv3x3_s8_body<NB, OutT>(x, w, scale, bias, out, P, H, W, cin, cout, dfc::NoHalo{});
}

// the same reading the halo rows top and bot ([B][W][cin] s8 each, null at the image's edge)
template <int NB, typename OutT>
__global__ void __launch_bounds__(kThreads, wgconv::conv_blocks(s8_smem_bytes<NB>()))
conv3x3_s8_halo_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w, const float* __restrict__ scale,
                       const float* __restrict__ bias, const int8_t* __restrict__ top, const int8_t* __restrict__ bot,
                       OutT* __restrict__ out, int P, int H, int W, int cin, int cout) {
  conv3x3_s8_body<NB, OutT>(x, w, scale, bias, out, P, H, W, cin, cout,
                            dfc::HaloRows<bf16>{reinterpret_cast<const bf16*>(top), reinterpret_cast<const bf16*>(bot)});
}

// with a halo row (top or bot non-null), the kernel that reads them
template <int NB, typename OutT>
int launch(const void* x, const void* w, const void* scale, const void* b, const void* top, const void* bot, void* out,
           int P, int H, int W, int cin, int cout, cudaStream_t stream) {
  constexpr int smem = s8_smem_bytes<NB>();
  const dim3 grid(dfc::ceil_div(P, kBM), dfc::ceil_div(cout, NB));
  const auto* x8 = static_cast<const int8_t*>(x);
  const auto* w8 = static_cast<const int8_t*>(w);
  const auto* sc = static_cast<const float*>(scale);
  const auto* bias = static_cast<const float*>(b);
  if (top != nullptr || bot != nullptr) {
    const cudaError_t err =
        cudaFuncSetAttribute(conv3x3_s8_halo_kernel<NB, OutT>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    conv3x3_s8_halo_kernel<NB, OutT><<<grid, kThreads, smem, stream>>>(
        x8, w8, sc, bias, static_cast<const int8_t*>(top), static_cast<const int8_t*>(bot), static_cast<OutT*>(out),
        P, H, W, cin, cout);
  } else {
    const cudaError_t err =
        cudaFuncSetAttribute(conv3x3_s8_kernel<NB, OutT>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    conv3x3_s8_kernel<NB, OutT><<<grid, kThreads, smem, stream>>>(x8, w8, sc, bias, static_cast<OutT*>(out), P, H,
                                                                   W, cin, cout);
  }
  return static_cast<int>(cudaGetLastError());
}

// nb: the B tile's width, ops/conv_s8.py::s8_tiling's (64, 128 or 256 from Cout)
template <typename OutT>
int dispatch(const void* x, const void* w, const void* scale, const void* b, const void* top, const void* bot,
             void* out, int P, int H, int W, int cin, int cout, int nb, cudaStream_t s) {
  if (cin % 16 || cout % 8) return static_cast<int>(cudaErrorInvalidValue);  // 16-byte chunks of x, w and out
  if (nb == 64) return launch<64, OutT>(x, w, scale, b, top, bot, out, P, H, W, cin, cout, s);
  if (nb == 128) return launch<128, OutT>(x, w, scale, b, top, bot, out, P, H, W, cin, cout, s);
  if (nb == 256) return launch<256, OutT>(x, w, scale, b, top, bot, out, P, H, W, cin, cout, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// x: s8 [P][cin]; w: s8 [cout][9 * cin]; scale, b: f32 [cout]; out: [P][cout] bf16 or f32
extern "C" int conv3x3_s8_bf16(const void* x, const void* w, const void* scale, const void* b, void* out, int P,
                               int H, int W, int cin, int cout, int nb, void* stream) {
  return dispatch<bf16>(x, w, scale, b, nullptr, nullptr, out, P, H, W, cin, cout, nb,
                        static_cast<cudaStream_t>(stream));
}

extern "C" int conv3x3_s8_f32(const void* x, const void* w, const void* scale, const void* b, void* out, int P,
                              int H, int W, int cin, int cout, int nb, void* stream) {
  return dispatch<float>(x, w, scale, b, nullptr, nullptr, out, P, H, W, cin, cout, nb,
                         static_cast<cudaStream_t>(stream));
}

// the same with the halo rows top and bot of a band of rows: s8 [B][W][cin] each (cin as x's), null
// at the image's edge
extern "C" int conv3x3_s8_halo_bf16(const void* x, const void* w, const void* scale, const void* b, const void* top,
                                    const void* bot, void* out, int P, int H, int W, int cin, int cout, int nb,
                                    void* stream) {
  return dispatch<bf16>(x, w, scale, b, top, bot, out, P, H, W, cin, cout, nb, static_cast<cudaStream_t>(stream));
}

extern "C" int conv3x3_s8_halo_f32(const void* x, const void* w, const void* scale, const void* b, const void* top,
                                   const void* bot, void* out, int P, int H, int W, int cin, int cout, int nb,
                                   void* stream) {
  return dispatch<float>(x, w, scale, b, top, bot, out, P, H, W, cin, cout, nb, static_cast<cudaStream_t>(stream));
}
