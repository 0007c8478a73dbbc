// The pooled attention's epilogue in one pass, for Hopper (sm_90a).
//
// Replaces no TPU kernel: on the TPU, XLA fuses the upsample, the scale and
// the residual add of dfc_sa_unet_tpu/models/blocks.py::LightSelfAttention
// into the ops around them.  In the port's engine (infer/engine.py::_lsa)
// the same chain was six passes of torch kernels over tensors of a's size:
// the bilinear upsample of the p x p attention output to H x W, its cast to
// f32, the product with gamma, a's cast, the add and the cast back.  This
// kernel computes, per element of a [B,H,W,C] (NHWC),
//
//   up  = rounded to a's type(bilinear(o))     o: [B,p,q,C], align_corners False
//   out = rounded to a's type(gamma * up + a)  f32 product, then f32 sum
//
// with the arithmetic of torch's CUDA upsample: the scale in / out as a
// float, the source index (i + 0.5) * scale - 0.5 clamped at 0, the upper tap
// clamped to in - 1, and h0 * (w0 * v00 + w1 * v01) + h1 * (w0 * v10 + w1 *
// v11) in f32.  torch's build contracts that expression into FMAs, and not
// the same way in all its instantiations.  Measured on the H100 against
// torch 2.11: fma(scale, i + 0.5, -0.5) for the source index; for the first
// row's sum fma(w1, v01, w0 * v00) in the f32 NHWC kernel (which torch runs
// on a channels_last input of 16 channels or more) and fma(w0, v00, w1 *
// v01) in the others (bf16, and the NCHW kernel below 16 channels); in all,
// fma(w0, v10, w1 * v11) for the second row's and fma(h0, t0, h1 * t1) for
// the rows' blend.  This kernel spells each rounding out with the
// intrinsics, in the order of the instantiation torch would run at that
// type and C, so that no contraction of its own can differ.  gamma's product and the sum are two roundings (__fmul_rn,
// __fadd_rn), as the two torch kernels were.  The result is the plain
// chain's, bit for bit, in bf16 and in f32.
//
// Over a band of an image's rows (parallel/rows.py) the kernel's rows are
// rows row0 .. row0 + H - 1 of an image of `height` rows, whose resize taps
// they take; without a band height = H and row0 = 0.
//
// What bounds it on the H100: memory.  It reads a and writes out once (4
// bytes an element in bf16) and does about 10 operations an element; o is at
// most a few MB and is read from L1 and L2.  At the flagship's nine levels
// and B=128 that is 6.32 GB, 1.89 ms at 3.35 TB/s.  The design is a plain
// streaming pass: one block a row of the output (b, y), whose two source rows
// of o and their weights it computes once; each thread moves 16 bytes of
// channels of one pixel at a time (8 bf16 or 4 f32; 1 element where C or a
// pointer does not allow it), two such vectors in flight before either is
// computed, a read with the evict-first hint (a is dead after this pass) and
// o's taps through the read-only cache.  W * C is 14336 at every flagship
// level, 7 x 256 vectors of bf16: a row is a whole number of passes of the
// block.

#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <int BYTES> struct RawOf;
template <> struct RawOf<16> { using type = uint4; };
template <> struct RawOf<4> { using type = unsigned int; };
template <> struct RawOf<2> { using type = unsigned short; };

// an element type's bits, their value in f32, and an f32 rounded to the type
template <typename T> struct Elem;
template <> struct Elem<__nv_bfloat16> {
  using Bits = unsigned short;
  __device__ __forceinline__ static float to_float(Bits b) { return __uint_as_float(static_cast<unsigned>(b) << 16); }
  __device__ __forceinline__ static Bits round(float x) { return __bfloat16_as_ushort(__float2bfloat16_rn(x)); }
};
template <> struct Elem<float> {
  using Bits = unsigned int;
  __device__ __forceinline__ static float to_float(Bits b) { return __uint_as_float(b); }
  __device__ __forceinline__ static Bits round(float x) { return __float_as_uint(x); }
};

// V consecutive elements, moved as one load or store
template <typename T, int V>
struct Pack {
  using Bits = typename Elem<T>::Bits;
  using Raw = typename RawOf<sizeof(Bits) * V>::type;
  union {
    Raw raw;
    Bits v[V];
  };
};

// torch's area_pixel_compute_source_index (align_corners False): the source index of output i
__device__ __forceinline__ float source_index(float scale, int i) {
  const float src = __fmaf_rn(scale, __fadd_rn(static_cast<float>(i), 0.5f), -0.5f);
  return src < 0.f ? 0.f : src;
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
lsa_epilogue_kernel(const T* __restrict__ a, const T* __restrict__ o, const float* __restrict__ gamma,
                    T* __restrict__ out, int H, int W, int C, int p, int q, int row0, float rh, float rw,
                    bool swap_first) {
  using E = Elem<T>;
  using P = Pack<T, V>;
  const int row = blockIdx.x;  // b * H + the band's row
  const int b = row / H;
  const int y = row - b * H + row0;  // the image's row
  const float h1r = source_index(rh, y);
  const int h1 = h1r;
  const int h1p = (h1 < p - 1) ? 1 : 0;
  const float h1l = __fsub_rn(h1r, static_cast<float>(h1));
  const float h0l = __fsub_rn(1.f, h1l);
  const T* o0 = o + (static_cast<size_t>(b) * p + h1) * q * C;
  const T* o1 = o0 + static_cast<size_t>(h1p) * q * C;
  const size_t base = static_cast<size_t>(row) * W * C;
  const T* arow = a + base;
  T* orow = out + base;
  const float g = __ldg(gamma);
  const int cv = C / V;   // vectors a pixel
  const int nv = W * cv;  // vectors a row

  auto finish = [&](int v, const P& av) {
    const int x = v / cv;
    const int c = (v - x * cv) * V;
    const float w1r = source_index(rw, x);
    const int w1 = w1r;
    const int w1p = (w1 < q - 1) ? 1 : 0;
    const float w1l = __fsub_rn(w1r, static_cast<float>(w1));
    const float w0l = __fsub_rn(1.f, w1l);
    const size_t c0 = static_cast<size_t>(w1) * C + c;
    const size_t c1 = c0 + static_cast<size_t>(w1p) * C;
    // the first row's sum is fma(wa, va, wb * vb): (w0, v00, w1, v01), or swapped (see the top of this file)
    const float wa = swap_first ? w1l : w0l;
    const float wb = swap_first ? w0l : w1l;
    P ta, tb, t10, t11, res;
    ta.raw = __ldg(reinterpret_cast<const typename P::Raw*>(o0 + (swap_first ? c1 : c0)));
    tb.raw = __ldg(reinterpret_cast<const typename P::Raw*>(o0 + (swap_first ? c0 : c1)));
    t10.raw = __ldg(reinterpret_cast<const typename P::Raw*>(o1 + c0));
    t11.raw = __ldg(reinterpret_cast<const typename P::Raw*>(o1 + c1));
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const float va = E::to_float(ta.v[i]), vb = E::to_float(tb.v[i]);
      const float v10 = E::to_float(t10.v[i]), v11 = E::to_float(t11.v[i]);
      const float t0 = __fmaf_rn(wa, va, __fmul_rn(wb, vb));
      const float t1 = __fmaf_rn(w0l, v10, __fmul_rn(w1l, v11));
      const float val = __fmaf_rn(h0l, t0, __fmul_rn(h1l, t1));
      const float up = E::to_float(E::round(val));
      res.v[i] = E::round(__fadd_rn(__fmul_rn(g, up), E::to_float(av.v[i])));
    }
    *reinterpret_cast<typename P::Raw*>(orow + static_cast<size_t>(v) * V) = res.raw;
  };

  for (int v = threadIdx.x; v < nv; v += 2 * kThreads) {
    const int v2 = v + kThreads;
    P a1, a2;
    a1.raw = __ldcs(reinterpret_cast<const typename P::Raw*>(arow + static_cast<size_t>(v) * V));
    if (v2 < nv) a2.raw = __ldcs(reinterpret_cast<const typename P::Raw*>(arow + static_cast<size_t>(v2) * V));
    finish(v, a1);
    if (v2 < nv) finish(v2, a2);
  }
}

template <typename T>
int launch(const void* a, const void* o, const void* gamma, void* out, int B, int H, int W, int C, int p, int q,
           int height, int row0, cudaStream_t stream) {
  // the scales as torch computes them on the host: float(in) / float(out)
  const float rh = static_cast<float>(p) / static_cast<float>(height);
  const float rw = static_cast<float>(q) / static_cast<float>(W);
  constexpr int kVec = 16 / sizeof(T);
  const bool aligned = ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(o) |
                         reinterpret_cast<uintptr_t>(out)) % 16) == 0;
  const dim3 grid(static_cast<unsigned>(B) * static_cast<unsigned>(H));
  auto ta = static_cast<const T*>(a);
  auto to = static_cast<const T*>(o);
  auto tg = static_cast<const float*>(gamma);
  auto tout = static_cast<T*>(out);
  const bool swap_first = sizeof(T) == 4 && C >= 16;  // torch's f32 NHWC kernel (see the top of this file)
  if (aligned && C % kVec == 0) {
    lsa_epilogue_kernel<T, kVec><<<grid, kThreads, 0, stream>>>(ta, to, tg, tout, H, W, C, p, q, row0, rh, rw,
                                                                 swap_first);
  } else {
    lsa_epilogue_kernel<T, 1><<<grid, kThreads, 0, stream>>>(ta, to, tg, tout, H, W, C, p, q, row0, rh, rw,
                                                             swap_first);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// a, out: [B][H][W][C]; o: [B][p][q][C], all of one type; gamma: one f32; the rows are rows
// row0 .. row0 + H - 1 of an image of `height` rows (height = H, row0 = 0 without a band)
extern "C" int lsa_epilogue_f32(const void* a, const void* o, const void* gamma, void* out, int B, int H, int W,
                                int C, int p, int q, int height, int row0, void* stream) {
  return launch<float>(a, o, gamma, out, B, H, W, C, p, q, height, row0, static_cast<cudaStream_t>(stream));
}

extern "C" int lsa_epilogue_bf16(const void* a, const void* o, const void* gamma, void* out, int B, int H, int W,
                                 int C, int p, int q, int height, int row0, void* stream) {
  return launch<__nv_bfloat16>(a, o, gamma, out, B, H, W, C, p, q, height, row0,
                               static_cast<cudaStream_t>(stream));
}
