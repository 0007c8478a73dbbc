// Pooled self-attention core of LightSelfAttention, for Hopper (sm_90a).
//
// Replaces the TPU kernel dfc_sa_unet_tpu/ops/pallas_attention.py::
// fused_pooled_attention (body _attn_kernel): for each batch element
//
//     out = softmax(q k^T) v        q, k: [N, Cq], v: [N, C], N = p*p
//
// with no 1/sqrt(Cq) scale (the reference model has none), energies and the
// max-subtracted softmax in f32, P rounded to v's dtype before the AV
// product, and f32 accumulation.  Types: f32 or bf16, inputs and output
// alike.
//
// What bounds it on the H100: the arithmetic intensity is about N/sizeof(T)
// operations per byte (32 at the flagship N = 64 in bf16), far below the
// ~295 the card needs before its tensor cores limit, so the bound is the
// bytes of q, k, v and out.  The TPU kernel's point is that the N x N
// energies never reach device memory; here they live in shared memory
// (16 query rows x N keys in f32, 64 KB at N = 1024), so device memory sees
// q, k, v once per block and out once.
//
// Design: a block owns (batch element, 16 query rows, 128 channels of v).
// It computes its 16 x N energy rows from K staged through shared memory in
// 32-key steps, takes the softmax with one warp per row, then streams V in
// 32-key steps for the AV product.  The cheap q k^T (depth Cq <= 256) is
// recomputed by each channel tile.  SIMT f32 arithmetic throughout: simple
// and exact first; the tensor-core (wgmma) version is later work.

#include <math.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;  // 8 warps
constexpr int kRows = 16;      // query rows per block (2 per warp)
constexpr int kCols = 128;     // v channels per block (4 per lane)
constexpr int kKeys = 32;      // keys staged per step

template <typename T>
__global__ void __launch_bounds__(kThreads)
pooled_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, T* __restrict__ out, int n, int cq, int c) {
  extern __shared__ float smem[];
  const int cqp = cq + 1;  // padded row stride: no bank conflicts in q.k
  float* s_e = smem;                   // [kRows][n] energies, then P
  float* s_q = s_e + kRows * n;        // [kRows][cqp]
  float* s_kv = s_q + kRows * cqp;     // [kKeys][cqp] keys, or [kKeys][kCols] values

  const int b = blockIdx.z;
  const int row0 = blockIdx.x * kRows;
  const int col0 = blockIdx.y * kCols;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int rows = min(kRows, n - row0);
  const T* qb = q + (size_t)b * n * cq;
  const T* kb = k + (size_t)b * n * cq;
  const T* vb = v + (size_t)b * n * c;

  for (int i = tid; i < kRows * cq; i += kThreads) {
    const int r = i / cq, ch = i - r * cq;
    s_q[r * cqp + ch] = r < rows ? dfc::to_f(qb[(size_t)(row0 + r) * cq + ch]) : 0.f;
  }

  // energies e[r][j] = q[r] . k[j]
  for (int j0 = 0; j0 < n; j0 += kKeys) {
    const int keys = min(kKeys, n - j0);
    __syncthreads();
    for (int i = tid; i < keys * cq; i += kThreads) {
      const int j = i / cq, ch = i - j * cq;
      s_kv[j * cqp + ch] = dfc::to_f(kb[(size_t)(j0 + j) * cq + ch]);
    }
    __syncthreads();
    for (int i = tid; i < kRows * keys; i += kThreads) {
      const int r = i / keys, j = i - r * keys;
      const float* qr = s_q + r * cqp;
      const float* kr = s_kv + j * cqp;
      float acc = 0.f;
      for (int ch = 0; ch < cq; ++ch) acc = fmaf(qr[ch], kr[ch], acc);
      s_e[r * n + j0 + j] = acc;
    }
  }
  __syncthreads();

  // row softmax in f32, one warp per row; P rounded to v's dtype
  for (int r = warp; r < kRows; r += kThreads / 32) {
    float* er = s_e + r * n;
    float mx = -INFINITY;
    for (int j = lane; j < n; j += 32) mx = fmaxf(mx, er[j]);
    for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    float sum = 0.f;
    for (int j = lane; j < n; j += 32) {
      const float p = expf(er[j] - mx);
      er[j] = p;
      sum += p;
    }
    for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    for (int j = lane; j < n; j += 32) er[j] = dfc::to_f(dfc::from_f<T>(er[j] / sum));
  }

  // out[r][col] = sum_j P[r][j] v[j][col]; warp owns rows 2w, 2w+1, lane owns
  // columns lane + 32*jj
  float acc[2][4] = {};
  for (int j0 = 0; j0 < n; j0 += kKeys) {
    const int keys = min(kKeys, n - j0);
    __syncthreads();
    for (int i = tid; i < keys * kCols; i += kThreads) {
      const int j = i / kCols, cc = i - j * kCols;
      const int ch = col0 + cc;
      s_kv[i] = ch < c ? dfc::to_f(vb[(size_t)(j0 + j) * c + ch]) : 0.f;
    }
    __syncthreads();
    const float* p0 = s_e + (2 * warp) * n + j0;
    const float* p1 = p0 + n;
    for (int j = 0; j < keys; ++j) {
      const float a0 = p0[j], a1 = p1[j];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float vv = s_kv[j * kCols + lane + 32 * jj];
        acc[0][jj] = fmaf(a0, vv, acc[0][jj]);
        acc[1][jj] = fmaf(a1, vv, acc[1][jj]);
      }
    }
  }
#pragma unroll
  for (int ii = 0; ii < 2; ++ii) {
    const int r = 2 * warp + ii;
    if (r >= rows) continue;
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int ch = col0 + lane + 32 * jj;
      if (ch < c) out[((size_t)b * n + row0 + r) * c + ch] = dfc::from_f<T>(acc[ii][jj]);
    }
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, int b, int n, int cq, int c,
           void* stream) {
  const int cqp = cq + 1;
  const int kv = kKeys * (cqp > kCols ? cqp : kCols);
  const size_t smem = sizeof(float) * ((size_t)kRows * n + (size_t)kRows * cqp + kv);
  cudaFuncSetAttribute(pooled_attention_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  const dim3 grid(dfc::ceil_div(n, kRows), dfc::ceil_div(c, kCols), b);
  pooled_attention_kernel<T><<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), n, cq, c);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int pooled_attention_f32(const void* q, const void* k, const void* v, void* out, int b,
                                    int n, int cq, int c, void* stream) {
  return launch<float>(q, k, v, out, b, n, cq, c, stream);
}

extern "C" int pooled_attention_bf16(const void* q, const void* k, const void* v, void* out, int b,
                                     int n, int cq, int c, void* stream) {
  return launch<__nv_bfloat16>(q, k, v, out, b, n, cq, c, stream);
}
