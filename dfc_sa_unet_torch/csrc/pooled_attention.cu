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
// Which kernel runs is the wrapper's choice (ops/pooled_attention.py picks by
// N); the first takes N <= 1024, the second any N.
//
// Design, small N (pooled_attention_kernel): a block owns (batch element,
// 16 query rows, 128 channels of v).  It computes its 16 x N energy rows from
// K staged through shared memory in 32-key steps, takes the softmax with one
// warp per row, then streams V in 32-key steps for the AV product.  The cheap
// q k^T (depth Cq <= 256) is recomputed by each channel tile.
//
// Design, larger N up to 4096 (pooled_attention_long_kernel), the
// full-resolution attention of a 64x64 image: 16 rows of N f32 energies no
// longer fit an SM's shared memory, and the shapes that get here are narrow
// (Cq = 8, C = 64 at the model's first level), so the energies are nearly
// free to compute twice.  A block owns (batch element, 64 query rows, 64
// channels of v) and goes over the keys twice in chunks of 64, K and V
// streamed through shared memory: pass one keeps each row's running max and
// the sum of exp(e - max) in registers; pass two recomputes the chunk's
// energies, normalises with the final max and sum, rounds the probabilities
// to v's dtype (the same values the short kernel rounds) and accumulates
// P V in f32 registers.  The operations bound it there (N = 4096, C = 64:
// 2*N*(Cq + C) operations per output row against 2*(2*Cq + 2*C) bytes).
//
// SIMT f32 arithmetic throughout: simple and exact first; the tensor-core
// (wgmma) version is later work.

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

// ------------------------------------------------------------------ long N
constexpr int kLRows = 64;  // query rows per block
constexpr int kLKeys = 64;  // keys per chunk
constexpr int kLCols = 64;  // v channels per block
constexpr int kLdp = kLKeys + 1;

// Thread (ty, tx) of the 16 x 16 layout owns query rows ty*4 + i; in the
// energy tile keys tx + 16*jj, in the output tile channels tx*4 + jj.  The 16
// threads of a row group are half a warp, so row reductions are shuffles.
__device__ __forceinline__ void chunk_energies(float (&e)[4][4], const float* s_q, const float* s_k,
                                               int cq, int cqp, int ty, int tx, int keys) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) e[i][jj] = 0.f;
  const float* qr = s_q + ty * 4 * cqp;
  const float* kr = s_k + tx * cqp;
  for (int ch = 0; ch < cq; ++ch) {
    float qv[4], kv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) qv[i] = qr[i * cqp + ch];
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) kv[jj] = kr[16 * jj * cqp + ch];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) e[i][jj] = fmaf(qv[i], kv[jj], e[i][jj]);
  }
#pragma unroll
  for (int jj = 0; jj < 4; ++jj)
    if (tx + 16 * jj >= keys) {  // past the last key: no weight in the softmax
#pragma unroll
      for (int i = 0; i < 4; ++i) e[i][jj] = -INFINITY;
    }
}

template <typename T>
__device__ __forceinline__ void stage_keys(float* s_k, const T* __restrict__ kb, int j0, int keys,
                                           int cq, int cqp) {
  for (int i = threadIdx.x; i < kLKeys * cq; i += kThreads) {
    const int j = i / cq, ch = i - j * cq;
    s_k[j * cqp + ch] = j < keys ? dfc::to_f(kb[(size_t)(j0 + j) * cq + ch]) : 0.f;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
pooled_attention_long_kernel(const T* __restrict__ q, const T* __restrict__ k,
                             const T* __restrict__ v, T* __restrict__ out, int n, int cq, int c) {
  extern __shared__ __align__(16) float smem_long[];
  const int cqp = cq + 1;  // padded row stride: no bank conflicts in q.k
  float* s_v = smem_long;                      // [kLKeys][kLCols]
  float* s_p = s_v + kLKeys * kLCols;     // [kLRows][kLdp] rounded probabilities of a chunk
  float* s_q = s_p + kLRows * kLdp;       // [kLRows][cqp]
  float* s_k = s_q + kLRows * cqp;        // [kLKeys][cqp]

  const int b = blockIdx.z;
  const int row0 = blockIdx.x * kLRows;
  const int col0 = blockIdx.y * kLCols;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const T* qb = q + (size_t)b * n * cq;
  const T* kb = k + (size_t)b * n * cq;
  const T* vb = v + (size_t)b * n * c;

  for (int i = tid; i < kLRows * cq; i += kThreads) {
    const int r = i / cq, ch = i - r * cq;
    s_q[r * cqp + ch] = row0 + r < n ? dfc::to_f(qb[(size_t)(row0 + r) * cq + ch]) : 0.f;
  }

  // pass one: per row the running max m and l = sum exp(e - m)
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
  }
  float e[4][4];
  for (int j0 = 0; j0 < n; j0 += kLKeys) {
    const int keys = min(kLKeys, n - j0);
    __syncthreads();
    stage_keys(s_k, kb, j0, keys, cq, cqp);
    __syncthreads();
    chunk_energies(e, s_q, s_k, cq, cqp, ty, tx, keys);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float cm = fmaxf(fmaxf(e[i][0], e[i][1]), fmaxf(e[i][2], e[i][3]));
      for (int o = 8; o > 0; o >>= 1) cm = fmaxf(cm, __shfl_xor_sync(0xffffffffu, cm, o));
      const float mn = fmaxf(m[i], cm);  // finite: key j0 is always a real key
      float s = 0.f;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) s += expf(e[i][jj] - mn);
      for (int o = 8; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
      l[i] = l[i] * expf(m[i] - mn) + s;
      m[i] = mn;
    }
  }

  // pass two: P = exp(e - m) / l rounded to T, out += P V
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) acc[i][jj] = 0.f;
  for (int j0 = 0; j0 < n; j0 += kLKeys) {
    const int keys = min(kLKeys, n - j0);
    __syncthreads();
    stage_keys(s_k, kb, j0, keys, cq, cqp);
    for (int i = tid; i < kLKeys * kLCols; i += kThreads) {
      const int j = i / kLCols, ch = col0 + i - j * kLCols;
      s_v[i] = (j < keys && ch < c) ? dfc::to_f(vb[(size_t)(j0 + j) * c + ch]) : 0.f;
    }
    __syncthreads();
    chunk_energies(e, s_q, s_k, cq, cqp, ty, tx, keys);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
        s_p[(ty * 4 + i) * kLdp + tx + 16 * jj] =
            dfc::to_f(dfc::from_f<T>(expf(e[i][jj] - m[i]) / l[i]));  // exp(-inf) = 0 past the end
    __syncthreads();
    const float* pr = s_p + ty * 4 * kLdp;
    for (int j = 0; j < kLKeys; ++j) {
      const float4 vv = *reinterpret_cast<const float4*>(s_v + j * kLCols + tx * 4);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float a = pr[i * kLdp + j];
        acc[i][0] = fmaf(a, vv.x, acc[i][0]);
        acc[i][1] = fmaf(a, vv.y, acc[i][1]);
        acc[i][2] = fmaf(a, vv.z, acc[i][2]);
        acc[i][3] = fmaf(a, vv.w, acc[i][3]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + ty * 4 + i;
    if (r >= n) continue;
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int ch = col0 + tx * 4 + jj;
      if (ch < c) out[((size_t)b * n + r) * c + ch] = dfc::from_f<T>(acc[i][jj]);
    }
  }
}

template <typename T>
int launch_long(const void* q, const void* k, const void* v, void* out, int b, int n, int cq, int c,
                void* stream) {
  const size_t smem =
      sizeof(float) * ((size_t)kLKeys * kLCols + kLRows * kLdp + (size_t)(kLRows + kLKeys) * (cq + 1));
  cudaFuncSetAttribute(pooled_attention_long_kernel<T>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  const dim3 grid(dfc::ceil_div(n, kLRows), dfc::ceil_div(c, kLCols), b);
  pooled_attention_long_kernel<T><<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), n, cq, c);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int pooled_attention_long_f32(const void* q, const void* k, const void* v, void* out,
                                         int b, int n, int cq, int c, void* stream) {
  return launch_long<float>(q, k, v, out, b, n, cq, c, stream);
}

extern "C" int pooled_attention_long_bf16(const void* q, const void* k, const void* v, void* out,
                                          int b, int n, int cq, int c, void* stream) {
  return launch_long<__nv_bfloat16>(q, k, v, out, b, n, cq, c, stream);
}

extern "C" int pooled_attention_f32(const void* q, const void* k, const void* v, void* out, int b,
                                    int n, int cq, int c, void* stream) {
  return launch<float>(q, k, v, out, b, n, cq, c, stream);
}

extern "C" int pooled_attention_bf16(const void* q, const void* k, const void* v, void* out, int b,
                                     int n, int cq, int c, void* stream) {
  return launch<__nv_bfloat16>(q, k, v, out, b, n, cq, c, stream);
}
