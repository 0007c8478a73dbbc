// LayerNorm over the last dimension of bf16 or f32 rows, for Hopper (sm_90a).
//
// Replaces no TPU kernel: on the TPU, XLA fuses the LayerNorm of
// dfc_sa_unet_tpu/nn/layers.py (mean and variance in f32, then the scale and
// shift) into the ops around it.  The port's layer (nn/layers.py::LayerNorm)
// ran it as three passes of torch kernels: x cast to f32, torch's f32
// layer_norm, the cast back, 20 bytes moved an element of bf16.  This kernel
// computes, per row of C elements,
//
//   mean = (sum of x) / C                          f32, from the input values
//   var  = (sum of (x - mean)^2) / C               f32, biased
//   rstd = rsqrtf(var + eps)                       as torch's CUDA kernel
//   y    = rounded to x's type(fma(gamma, rstd * (x - mean), beta))
//
// gamma and beta f32, one rounding to x's type at the end: torch's formula
// for y, each rounding spelled with the intrinsics so that no contraction of
// the compiler's can differ.  torch takes mean and var by Welford's update,
// in another order, so they may differ from this kernel's in the last place
// of f32, and y where that moves it across a rounding of bf16: within one
// ulp of the plain chain, in a small share of the elements.
//
// What bounds it on the H100: memory.  Each element is read and written once
// (4 bytes in bf16) for a few operations.  The design: a group of G lanes (8,
// 16 or 32, within a warp) holds a row in registers, lane l its 16-byte
// vectors l, l + G, ..., l + (V - 1) G, V at most 8 (the wrapper picks the
// smallest G at which V fits, from C); both sums are taken from the registers
// and reduced by shuffles within the group, and the row is normalised from
// the same registers and written once.  Where a lane holds fewer than four
// vectors, a group takes U = 4 / V rows at once, so that every lane keeps
// about four vectors in flight; a warp's loads of one step of its rows are
// consecutive rows, contiguous in memory.  gamma and beta are read into
// shared memory once a block, laid out so that a group's lanes read them
// without bank conflicts (an element of x reads 8 bytes of them there, twice
// what it moves in memory, where U = 1); a grid of as many blocks as are
// resident walks the rows.  Loads and stores are plain: x is read again by the residual add
// after the norm, and y by the product after it, often from L2.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxVectors = 8;                      // 16-byte vectors a lane holds, at most
constexpr int kMaxC = 32 * kMaxVectors * 8;         // the widest bf16 row (f32: half of it)
constexpr size_t kMaxSmem = 2 * kMaxC * sizeof(float);

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
  static constexpr int N = 16 / sizeof(T);
  using Bits = typename Elem<T>::Bits;
  union {
    uint4 raw;
    Bits v[N];
  };
};

// the sum of v over the G lanes of this lane's group (G a power of two, groups aligned in the warp)
__device__ __forceinline__ float group_sum(float v, int G) {
  for (int o = G >> 1; o > 0; o >>= 1) v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// x, y: rows x nvec 16-byte vectors; a group of G lanes a row, lane l holding vectors l + j G (j < V)
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
layer_norm_kernel(const T* __restrict__ x, const float* __restrict__ gamma, const float* __restrict__ beta,
                  T* __restrict__ y, long long rows, int nvec, int G, float eps) {
  using E = Elem<T>;
  using P = Pack<T>;
  constexpr int N = P::N;
  constexpr int U = V >= 4 ? 1 : 4 / V;  // rows a group holds at once
  constexpr int H = N / 4;               // float4s of gamma a vector of x
  // gamma, then beta, each as H planes of nvec float4s: plane h holds elements 4h .. 4h + 3 of every
  // vector, so that the lanes of a group, which hold consecutive vectors, read consecutive float4s
  extern __shared__ float4 smem[];
  const int C = nvec * N;
  for (int i = threadIdx.x; i < C; i += kThreads) {
    const int at = 4 * ((i % N) / 4 * nvec + i / N) + i % 4;
    reinterpret_cast<float*>(smem)[at] = gamma[i];
    reinterpret_cast<float*>(smem + H * nvec)[at] = beta[i];
  }
  __syncthreads();
  const float4* sg = smem;
  const float4* sb = smem + H * nvec;

  const int lane = threadIdx.x & 31, g = lane / G, l = lane % G;
  const int gpw = 32 / G;                // groups a warp
  const long long per_warp = static_cast<long long>(U) * gpw;  // rows a warp a step
  const long long warp = (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) >> 5;
  const long long warps = static_cast<long long>(gridDim.x) * (kThreads / 32);
  const uint4* vx = reinterpret_cast<const uint4*>(x);
  uint4* vy = reinterpret_cast<uint4*>(y);

  // the loop is uniform over the warp (its shuffles take every lane); rows past the end are masked
  for (long long base = warp * per_warp; base < rows; base += warps * per_warp) {
    P p[U][V];
    bool live[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long long row = base + static_cast<long long>(u) * gpw + g;  // a step's rows are consecutive
      live[u] = row < rows;
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const int v = j * G + l;
        p[u][j].raw = make_uint4(0u, 0u, 0u, 0u);
        if (live[u] && v < nvec) p[u][j].raw = vx[row * nvec + v];
      }
    }
    float mean[U], rstd[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float s = 0.0f;
#pragma unroll
      for (int j = 0; j < V; ++j)
#pragma unroll
        for (int i = 0; i < N; ++i) s = __fadd_rn(s, E::to_float(p[u][j].v[i]));  // zeros past the row add nothing
      mean[u] = __fdiv_rn(group_sum(s, G), static_cast<float>(C));
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float q = 0.0f;
#pragma unroll
      for (int j = 0; j < V; ++j) {
        if (j * G + l < nvec) {
#pragma unroll
          for (int i = 0; i < N; ++i) {
            const float d = __fsub_rn(E::to_float(p[u][j].v[i]), mean[u]);
            q = __fmaf_rn(d, d, q);
          }
        }
      }
      rstd[u] = rsqrtf(__fadd_rn(__fdiv_rn(group_sum(q, G), static_cast<float>(C)), eps));
    }
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const int v = j * G + l;
      if (v >= nvec) continue;
      float gv[N], bv[N];
#pragma unroll
      for (int h = 0; h < H; ++h) {
        const float4 a = sg[h * nvec + v], b = sb[h * nvec + v];
        gv[4 * h] = a.x, gv[4 * h + 1] = a.y, gv[4 * h + 2] = a.z, gv[4 * h + 3] = a.w;
        bv[4 * h] = b.x, bv[4 * h + 1] = b.y, bv[4 * h + 2] = b.z, bv[4 * h + 3] = b.w;
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (!live[u]) continue;
        P o;
#pragma unroll
        for (int i = 0; i < N; ++i) {
          const float d = __fsub_rn(E::to_float(p[u][j].v[i]), mean[u]);
          o.v[i] = E::round(__fmaf_rn(gv[i], __fmul_rn(rstd[u], d), bv[i]));
        }
        vy[(base + static_cast<long long>(u) * gpw + g) * nvec + v] = o.raw;
      }
    }
  }
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

template <typename T, int V>
int launch_v(const void* x, const void* gamma, const void* beta, void* y, long long rows, int nvec, int G,
             float eps, cudaStream_t stream) {
  static int resident = 0;  // blocks an SM, for this instantiation
  if (resident == 0) {
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident, layer_norm_kernel<T, V>, kThreads, kMaxSmem);
    if (resident < 1) resident = 1;
  }
  constexpr int U = V >= 4 ? 1 : 4 / V;
  const long long per_block = static_cast<long long>(kThreads / 32) * U * (32 / G);
  long long blocks = (rows + per_block - 1) / per_block;
  const long long most = static_cast<long long>(resident) * sm_count();
  if (blocks > most) blocks = most;
  const size_t smem = 2 * static_cast<size_t>(nvec) * Pack<T>::N * sizeof(float);
  layer_norm_kernel<T, V><<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(gamma), static_cast<const float*>(beta),
      static_cast<T*>(y), rows, nvec, G, eps);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* x, const void* gamma, const void* beta, void* y, long long rows, int C, int G, int V,
           float eps, cudaStream_t stream) {
  constexpr int N = Pack<T>::N;
  const int nvec = C / N;
  if (C <= 0 || C % N || (G != 8 && G != 16 && G != 32) || V < 1 || V > kMaxVectors || (nvec + G - 1) / G != V ||
      reinterpret_cast<uintptr_t>(x) % 16 || reinterpret_cast<uintptr_t>(y) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  if (rows <= 0) return static_cast<int>(cudaGetLastError());
  switch (V) {
    case 1: return launch_v<T, 1>(x, gamma, beta, y, rows, nvec, G, eps, stream);
    case 2: return launch_v<T, 2>(x, gamma, beta, y, rows, nvec, G, eps, stream);
    case 3: return launch_v<T, 3>(x, gamma, beta, y, rows, nvec, G, eps, stream);
    case 4: return launch_v<T, 4>(x, gamma, beta, y, rows, nvec, G, eps, stream);
    case 5: return launch_v<T, 5>(x, gamma, beta, y, rows, nvec, G, eps, stream);
    case 6: return launch_v<T, 6>(x, gamma, beta, y, rows, nvec, G, eps, stream);
    case 7: return launch_v<T, 7>(x, gamma, beta, y, rows, nvec, G, eps, stream);
    default: return launch_v<T, 8>(x, gamma, beta, y, rows, nvec, G, eps, stream);
  }
}

}  // namespace

// x, y: rows x C dense elements of one type (16-byte aligned); gamma, beta: C f32; G lanes a row holding V
// 16-byte vectors each (V = ceil(C / 16 bytes' elements / G), at most 8; G 8, 16 or 32)
extern "C" int layer_norm_bf16(const void* x, const void* gamma, const void* beta, void* y, long long rows, int C,
                               int G, int V, float eps, void* stream) {
  return launch<__nv_bfloat16>(x, gamma, beta, y, rows, C, G, V, eps, static_cast<cudaStream_t>(stream));
}

extern "C" int layer_norm_f32(const void* x, const void* gamma, const void* beta, void* y, long long rows, int C,
                              int G, int V, float eps, void* stream) {
  return launch<float>(x, gamma, beta, y, rows, C, G, V, eps, static_cast<cudaStream_t>(stream));
}
