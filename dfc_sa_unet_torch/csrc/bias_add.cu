// The f32 bias of a product added in place, for Hopper (sm_90a).
//
// Replaces no TPU kernel: on the TPU, XLA fuses the bias add of every Dense
// and conv of dfc_sa_unet_tpu/nn/layers.py into the ops around it.  The
// port's layers (nn/layers.py::add_bias_) run the product in the compute
// type and then add the layer's f32 bias in place, where torch's
// y.add_(bias) on a bf16 y and an f32 bias runs its generic mixed-type,
// broadcasting loop: not vectorised, an index computed for every element.
// This kernel computes, per element of y,
//
//   y = rounded to y's type(float(y) + bias[c])
//
// one f32 sum (__fadd_rn: nothing for the compiler to contract) and one
// rounding to nearest even: torch's add_ with alpha 1 in its f32 arithmetic,
// so the result is the same bits.  y is bf16 or f32.
//
// Two layouts, given as y's n elements in memory where element i takes
// bias[(i / inner) % C]:
//   inner = 1: the channel is the innermost index (a Dense output [..., C],
//              a channels_last conv output);
//   inner > 1: the channel is the outer index of contiguous planes (an
//              NCHW-contiguous conv output, or one bias value for all of y,
//              C = 1).
// Where y is 16-byte aligned and C (inner = 1) or inner (inner > 1) is a
// multiple of the 16-byte vector, the vector path below runs; any other
// dense y, an odd C or plane or a y that starts inside a vector, takes the
// scalar path: one element at a time, its channel one division.
//
// What bounds it on the H100: memory.  Each element is read and written once
// (4 bytes in bf16, 8 in f32) for one add.  The design is a plain streaming
// pass: 16-byte loads and stores (8 bf16 or 4 f32), four vectors in flight a
// thread before any is summed, a grid of a few blocks an SM walking the
// tensor.  With the channel innermost, the stride of a thread's walk is a
// whole number of rows, so each thread keeps one group of channels: it loads
// their bias into registers once and divides no element's index.  Over
// planes a vector's plane is one division and its bias one cached load.
// Stores are plain, so a small y stays in L2 for the op that reads it next.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;       // vectors in flight a thread
constexpr int kBlocksPerSM = 4;  // 1024 threads an SM, at most 64 registers each

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

// 16 bytes of consecutive elements, moved as one load or store
template <typename T>
struct Pack {
  static constexpr int V = 16 / sizeof(T);
  using Bits = typename Elem<T>::Bits;
  union {
    uint4 raw;
    Bits v[V];
  };
};

// y: nv vectors.  PLANES false: `per` vectors a row of C channels, and `stride` a multiple of it;
// PLANES true: `per` vectors a plane, plane p taking bias[p % C]
template <typename T, bool PLANES>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
bias_add_kernel(T* __restrict__ y, const float* __restrict__ bias, long long nv, long long per, int C,
                long long stride) {
  using E = Elem<T>;
  using P = Pack<T>;
  constexpr int V = P::V;
  const long long tid = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (tid >= stride) return;
  float b[V];
  if (!PLANES) {  // this thread's channels, the same in every row it visits
    const int c0 = static_cast<int>(tid % per) * V;
#pragma unroll
    for (int i = 0; i < V; ++i) b[i] = __ldg(bias + c0 + i);
  }
  uint4* vy = reinterpret_cast<uint4*>(y);
  for (long long v = tid; v < nv; v += kUnroll * stride) {
    P r[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long vu = v + u * stride;
      if (vu < nv) r[u].raw = vy[vu];
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long vu = v + u * stride;
      if (vu < nv) {
        if (PLANES) {
          const float bp = __ldg(bias + (vu / per) % C);
#pragma unroll
          for (int i = 0; i < V; ++i) b[i] = bp;
        }
#pragma unroll
        for (int i = 0; i < V; ++i) r[u].v[i] = E::round(__fadd_rn(E::to_float(r[u].v[i]), b[i]));
        vy[vu] = r[u].raw;
      }
    }
  }
}

// any dense y: element i of n takes bias[(i / inner) % C]
template <typename T>
__global__ void __launch_bounds__(kThreads)
bias_add_scalar_kernel(T* __restrict__ y, const float* __restrict__ bias, long long n, int C, long long inner) {
  using E = Elem<T>;
  auto ey = reinterpret_cast<typename E::Bits*>(y);
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x; i < n; i += stride)
    ey[i] = E::round(__fadd_rn(E::to_float(ey[i]), __ldg(bias + (i / inner) % C)));
}

int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  return sms;
}

template <typename T>
int launch(void* y, const void* bias, long long n, int C, long long inner, cudaStream_t stream) {
  constexpr int V = Pack<T>::V;
  const long long max_blocks = static_cast<long long>(kBlocksPerSM) * sm_count();
  auto ty = static_cast<T*>(y);
  auto tb = static_cast<const float*>(bias);
  if (n == 0) return static_cast<int>(cudaGetLastError());
  if (reinterpret_cast<uintptr_t>(y) % 16 || (inner == 1 ? C : inner) % V) {
    long long blocks = (n + kThreads - 1) / kThreads;
    if (blocks > max_blocks) blocks = max_blocks;
    bias_add_scalar_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(ty, tb, n, C, inner);
    return static_cast<int>(cudaGetLastError());
  }
  const long long nv = n / V;
  const long long per_block = static_cast<long long>(kThreads) * kUnroll;
  long long blocks = (nv + per_block - 1) / per_block;
  if (blocks > max_blocks) blocks = max_blocks;
  if (inner == 1) {
    const long long cv = C / V;  // vectors a row
    if (blocks * kThreads < cv) blocks = (cv + kThreads - 1) / kThreads;
    const long long stride = blocks * kThreads / cv * cv;  // threads that walk: whole rows of them
    bias_add_kernel<T, false><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(ty, tb, nv, cv, C, stride);
  } else {
    bias_add_kernel<T, true><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(ty, tb, nv, inner / V, C,
                                                                                    blocks * kThreads);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// y: n dense elements of one type, added in place; element i takes bias[(i / inner) % C] (f32, C values)
extern "C" int bias_add_bf16(void* y, const void* bias, long long n, int C, long long inner, void* stream) {
  return launch<__nv_bfloat16>(y, bias, n, C, inner, static_cast<cudaStream_t>(stream));
}

extern "C" int bias_add_f32(void* y, const void* bias, long long n, int C, long long inner, void* stream) {
  return launch<float>(y, bias, n, C, inner, static_cast<cudaStream_t>(stream));
}
