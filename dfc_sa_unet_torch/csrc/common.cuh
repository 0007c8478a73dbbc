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
#include <stdint.h>

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

// ------------------------------------------------------- tensor-core helpers

// c += a b for one m16n8k16 tile (PTX ISA fragment layouts; g = lane / 4, t = lane % 4:
// a0..a3 = A[g][2t..], A[g+8][2t..], A[g][2t+8..], A[g+8][2t+8..]; b0, b1 = B[2t..][g],
// B[2t+8..][g]; c0..c3 = C[g][2t], C[g][2t+1], C[g+8][2t], C[g+8][2t+1])
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats rounded to bf16 (nearest even); lo in the low half, as the mma fragments want
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  __nv_bfloat162 pair = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&pair);
}

// exp((x - m) * scale) as 2^(x * c - mc) with c = scale * log2(e) and mc = m * c: one
// multiply-add and the hardware's exp2 (relative error 2^-22, far inside the 2^-9 of a
// rounding to bf16); 0 for x = -inf
__device__ __forceinline__ float exp2_scaled(float x, float c, float mc) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(fmaf(x, c, -mc)));
  return y;
}

// reductions over the four lanes (t = 0..3) that share a row of an mma fragment
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// four 8x8 bf16 matrices from shared memory; lane l gives the address of row l % 8 of
// matrix l / 8, and register i receives matrix i in the mma fragment layout (row g,
// columns 2t, 2t+1), or its transpose with .trans
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// ------------------------------------------------------- asynchronous copies

// 16 bytes from device to shared memory, or 16 zero bytes when !valid (src-size 0:
// nothing is read, but src must still be a mapped address)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

}  // namespace dfc
