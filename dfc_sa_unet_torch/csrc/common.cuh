// Shared helpers for the port's hand-written Hopper kernels.
//
// Every kernel of this directory is built by nvcc into its own shared
// library with a plain C interface (no PyTorch headers) and loaded with
// ctypes by dfc_sa_unet_torch/ops/_build.py.  Each exported function
// launches on the stream it is given and returns cudaGetLastError(), so a
// launch the CUDA runtime refuses (too much shared memory, a bad grid) reaches
// Python as a non-zero code instead of passing silently.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace dfc {

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as torch's .to(bfloat16)
}

inline int ceil_div(long long a, long long b) { return static_cast<int>((a + b - 1) / b); }

}  // namespace dfc
