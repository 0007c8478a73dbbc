// Pooled self-attention core of LightSelfAttention, for Hopper (sm_90a).
//
// Replaces the TPU kernel dfc_sa_unet_tpu/ops/pallas_attention.py::
// fused_pooled_attention (body _attn_kernel, :32-43): for each batch element
//
//     out = softmax(q k^T) v        q: [Nq, Cq], k: [Nk, Cq], v: [Nk, C], Nk = p*p <= 4096
//
// Nq = Nk but under row sharding, where the full-resolution attention takes a
// band's queries against the whole image's keys (parallel/rows.py): the grid
// and the row masks walk the Nq queries, the key loops the Nk keys.
//
// with no 1/sqrt(Cq) scale (the reference model has none), energies and the
// softmax in f32, f32 accumulation, and the output rounded to v's dtype.  The
// TPU kernel's point is that the N x N energies never reach device memory;
// none of the kernels here writes them either.
//
// bf16: pooled_attention_mma_kernel, one kernel for every N, on the tensor
// cores (mma.sync with ldmatrix, f32 accumulators).  A block owns one image x a
// tile of query rows x a tile of 64 or 128 channels of v; each warp owns one or
// two tiles of 16 query rows (the launch configurations are at the end of the
// file).  K and V go through shared memory as bf16 in chunks of 64 or 128 keys,
// copied by cp.async into a ring of three stages, so the copies of the next
// chunks overlap the math of this one; Cq is zero-padded to a multiple of 16 and
// rows are padded by 16 bytes, so ldmatrix (.trans for V) reads without bank
// conflicts.  The query-row tiles are the fast grid index: the blocks of one
// image run together and re-read its K and V from L2 (576 KB at N = 4096,
// C = 64).  Two passes over the keys:
//   1. q k^T and the row maximum m, with no exponential; a step of this pass
//      fills a whole ring buffer with keys (only K is needed), several chunks;
//   2. q k^T again, p = 2^(e log2(e) - m log2(e)) (one ex2.approx each), the
//      unrounded p summed into the f32 row sum l, p rounded to bf16 and used as
//      the A fragment of the p v product straight from the q k^T accumulator
//      registers (P never goes to shared memory); out = acc / l at the end.
// At N <= 64 the one chunk is loaded once and q k^T computed once.  The extra
// q k^T costs Cq / (Cq + C) = 1/9 more products at the port's Cq = C/8, and
// buys one exponential per energy with no rescaled accumulator.  For Cq <= 32
// the q fragments stay in registers, and for Cq <= 8 q k^T runs on m16n8k8
// (the padding to 16 channels would double it).  A warp loads the fragments of
// several 16-key groups before their products, and a group's value fragments
// before its exponentials, so the loads' latency is paid once per round.
//
// Rounding point: the reference rounds the normalised p / l to bf16 before
// the p v product (pallas_attention.py:42); this kernel rounds p and divides
// the f32 sum by l once.  The two differ by bf16 roundings of p only
// (tests/test_torch_attention_emulation.py holds an emulation of this order
// to the JAX kernel far inside the 2e-2 that chip_smoke.py allows).
//
// What bounds it on the H100: at the full-resolution model's first level (N =
// 4096, Cq = 8, C = 64) the exponentials, not the products or the bytes: B*N^2
// of them at 16 a clock per SM (132 SMs, about 0.5 ms a launch at B = 128),
// against 2*B*N^2*(Cq + C) operations (0.31 ms at the tensor-core peak).  At
// the flagship's N = 64 the bytes of q, k, v and out bound it.
//
// f32 (the parity path, exact to 1e-5; TF32 would break it): two SIMT kernels,
// picked by the wrapper (ops/pooled_attention.py) by N.
//
// * N <= 1024 (pooled_attention_kernel): a block owns (batch element, 16
//   query rows, 128 channels of v).  It computes its 16 x N energy rows from K
//   staged through shared memory in 32-key steps, takes the softmax with one
//   warp per row, then streams V in 32-key steps for the AV product.
// * N up to 4096 (pooled_attention_long_kernel): a block owns (batch element,
//   64 query rows, 64 channels of v) and goes over the keys twice in chunks of
//   64: pass one keeps each row's running max and the sum of exp(e - max) in
//   registers; pass two recomputes the chunk's energies, normalises with the
//   final max and sum and accumulates P V in f32 registers.

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
                        const T* __restrict__ v, T* __restrict__ out, int nq, int n, int cq, int c) {
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
  const int rows = min(kRows, nq - row0);
  const T* qb = q + (size_t)b * nq * cq;
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
      if (ch < c) out[((size_t)b * nq + row0 + r) * c + ch] = dfc::from_f<T>(acc[ii][jj]);
    }
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, int b, int nq, int n, int cq, int c,
           void* stream) {
  const int cqp = cq + 1;
  const int kv = kKeys * (cqp > kCols ? cqp : kCols);
  const size_t smem = sizeof(float) * ((size_t)kRows * n + (size_t)kRows * cqp + kv);
  cudaFuncSetAttribute(pooled_attention_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  const dim3 grid(dfc::ceil_div(nq, kRows), dfc::ceil_div(c, kCols), b);
  pooled_attention_kernel<T><<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), nq, n, cq, c);
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
                             const T* __restrict__ v, T* __restrict__ out, int nq, int n, int cq, int c) {
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
  const T* qb = q + (size_t)b * nq * cq;
  const T* kb = k + (size_t)b * n * cq;
  const T* vb = v + (size_t)b * n * c;

  for (int i = tid; i < kLRows * cq; i += kThreads) {
    const int r = i / cq, ch = i - r * cq;
    s_q[r * cqp + ch] = row0 + r < nq ? dfc::to_f(qb[(size_t)(row0 + r) * cq + ch]) : 0.f;
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
    if (r >= nq) continue;
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int ch = col0 + tx * 4 + jj;
      if (ch < c) out[((size_t)b * nq + r) * c + ch] = dfc::from_f<T>(acc[i][jj]);
    }
  }
}

template <typename T>
int launch_long(const void* q, const void* k, const void* v, void* out, int b, int nq, int n, int cq, int c,
                void* stream) {
  const size_t smem =
      sizeof(float) * ((size_t)kLKeys * kLCols + kLRows * kLdp + (size_t)(kLRows + kLKeys) * (cq + 1));
  cudaFuncSetAttribute(pooled_attention_long_kernel<T>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  const dim3 grid(dfc::ceil_div(nq, kLRows), dfc::ceil_div(c, kLCols), b);
  pooled_attention_long_kernel<T><<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), nq, n, cq, c);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------------- bf16: tensor cores
using bf16 = __nv_bfloat16;

constexpr int kMPad = 8;       // row padding (elements): 16 bytes, conflict-free ldmatrix
constexpr int kMStages = 3;    // ring of chunk buffers in shared memory
constexpr float kLog2e = 1.4426950408889634f;

// s[r][0..cols) <- g[row0 + r][0..cols) (row stride ldg) for r < rows; zero past row
// nrows and column ncols.  vec: 16-byte cp.async copies (cols, ldg and g 16-byte
// multiples), VPR = cols / 8 when known at compile time (the value tiles), else 0;
// else element loads and stores, for rows that are not 16-byte aligned.
template <int THREADS, int VPR>
__device__ __forceinline__ void load_rows(bf16* s, int lds, const bf16* __restrict__ g, int ldg,
                                          int row0, int rows, int nrows, int cols, int ncols,
                                          bool vec) {
  if (vec) {
    const int vpr = VPR ? VPR : cols / 8;
    const int shift = vpr == 1 ? 0 : vpr == 2 ? 1 : -1;  // the key and query rows: Cq = 8 or 16
    for (int e = threadIdx.x; e < rows * vpr; e += THREADS) {
      const int r = VPR ? e / (VPR ? VPR : 1) : shift >= 0 ? e >> shift : e / vpr;
      const int cc = (e - r * vpr) * 8;
      const bool ok = row0 + r < nrows && cc < ncols;
      dfc::cp_async16(dfc::smem_u32(s + r * lds + cc), ok ? g + (size_t)(row0 + r) * ldg + cc : g, ok);
    }
  } else {
    for (int e = threadIdx.x; e < rows * cols; e += THREADS) {
      const int r = e / cols, cc = e - r * cols;
      s[r * lds + cc] = row0 + r < nrows && cc < ncols ? g[(size_t)(row0 + r) * ldg + cc]
                                                       : __float2bfloat16(0.f);
    }
  }
}

// c += a b for one m16n8k8 tile: a0, a1 = A[g][2t..], A[g+8][2t..]; b0 = B[2t..][g]
__device__ __forceinline__ void mma1688(float (&c)[4], uint32_t a0, uint32_t a1, uint32_t b0) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5}, {%6}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(b0));
}

// e[gi][i] = q k^T of the warp's row tile i (16 query rows) and the 16 keys of group gi,
// whose rows start at k_addr + gi * group_bytes (two n-tiles); keys from valid - 16 * gi on
// read -inf.  For cqp <= 32 the q fragments are qa (registers) and every key fragment of
// the G groups is loaded before the first product, so the loads' latency is paid once;
// else q is read from shared memory at q_addr + i * tile_bytes.
template <int RT, int G>
__device__ __forceinline__ void energies(float (&e)[G][RT][2][4], const uint32_t (&qa)[RT][2][4],
                                         uint32_t q_addr, int tile_bytes, uint32_t k_addr,
                                         int group_bytes, int cq, int cqp, int valid, int t) {
#pragma unroll
  for (int gi = 0; gi < G; ++gi)
#pragma unroll
    for (int i = 0; i < RT; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) e[gi][i][h][0] = e[gi][i][h][1] = e[gi][i][h][2] = e[gi][i][h][3] = 0.f;
  if (cq > 0 && cq <= 8) {  // one k-step of 8: the channels 8..15 of the padded q and k are zero
    uint32_t bk[G][4];
#pragma unroll
    for (int gi = 0; gi < G; ++gi) dfc::ldmatrix_x4(bk[gi], k_addr + gi * group_bytes);
#pragma unroll
    for (int gi = 0; gi < G; ++gi)
#pragma unroll
      for (int i = 0; i < RT; ++i) {
        mma1688(e[gi][i][0], qa[i][0][0], qa[i][0][1], bk[gi][0]);
        mma1688(e[gi][i][1], qa[i][0][0], qa[i][0][1], bk[gi][2]);
      }
  } else if (cqp <= 32) {
    const int ks_n = cqp / 16;
    uint32_t bk[G][2][4];
#pragma unroll
    for (int gi = 0; gi < G; ++gi)
#pragma unroll
      for (int ks = 0; ks < 2; ++ks)
        if (ks < ks_n) dfc::ldmatrix_x4(bk[gi][ks], k_addr + gi * group_bytes + ks * 32);
#pragma unroll
    for (int gi = 0; gi < G; ++gi)
#pragma unroll
      for (int ks = 0; ks < 2; ++ks)
        if (ks < ks_n) {
#pragma unroll
          for (int i = 0; i < RT; ++i) {
            dfc::mma16816(e[gi][i][0], qa[i][ks], bk[gi][ks][0], bk[gi][ks][1]);
            dfc::mma16816(e[gi][i][1], qa[i][ks], bk[gi][ks][2], bk[gi][ks][3]);
          }
        }
  } else {
#pragma unroll
    for (int gi = 0; gi < G; ++gi)
      for (int ks = 0; ks < cqp; ks += 16) {
        uint32_t bk[4];
        dfc::ldmatrix_x4(bk, k_addr + gi * group_bytes + ks * 2);
#pragma unroll
        for (int i = 0; i < RT; ++i) {
          uint32_t a[4];
          dfc::ldmatrix_x4(a, q_addr + i * tile_bytes + ks * 2);
          dfc::mma16816(e[gi][i][0], a, bk[0], bk[1]);
          dfc::mma16816(e[gi][i][1], a, bk[2], bk[3]);
        }
      }
  }
  if (valid < 16 * G) {
#pragma unroll
    for (int gi = 0; gi < G; ++gi)
#pragma unroll
      for (int i = 0; i < RT; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int key = gi * 16 + h * 8 + 2 * t;
          if (key >= valid) e[gi][i][h][0] = e[gi][i][h][2] = -INFINITY;
          if (key + 1 >= valid) e[gi][i][h][1] = e[gi][i][h][3] = -INFINITY;
        }
  }
}

// Shared memory of a launch: q [16 * WARPS * RT][cqp + kMPad], then one ring buffer (N <= KEYS,
// one chunk) or kMStages of [KEYS][cqp + kMPad] keys and [KEYS][CT + kMPad] values.
template <int WARPS, int RT, int CT, int KEYS>
size_t mma_smem_bytes(int n, int cqp) {
  const size_t stage = (size_t)KEYS * (cqp + kMPad + CT + kMPad);
  return sizeof(bf16) * ((size_t)16 * WARPS * RT * (cqp + kMPad) + (n <= KEYS ? 1 : kMStages) * stage);
}

// WARPS warps of RT tiles of 16 query rows; CT channels of v per block; MINB blocks an SM
// (caps the registers); G groups of 16 keys per round of products and exponentials, for
// instruction-level parallelism; KEYS keys per chunk.  cqp = Cq rounded up to 16.
template <int WARPS, int RT, int CT, int MINB, int G, int KEYS>
__global__ void __launch_bounds__(WARPS * 32, MINB)
pooled_attention_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                            const bf16* __restrict__ v, bf16* __restrict__ out, int nq, int n, int cq,
                            int c, int cqp, int vec) {
  constexpr int THREADS = WARPS * 32, ROWS = 16 * WARPS * RT, LDV = CT + kMPad;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ldk = cqp + kMPad;
  // a ring buffer holds, in pass two, one chunk of keys [KEYS][ldk] and its values
  // [KEYS][LDV]; in pass one, kpb chunks of keys back to back
  const int stage = KEYS * (ldk + LDV), kpb = stage / (KEYS * ldk);
  bf16* s_q = reinterpret_cast<bf16*>(smem_raw);  // [ROWS][ldk]
  bf16* s_ring = s_q + ROWS * ldk;

  const int b = blockIdx.z, row0 = blockIdx.x * ROWS, col0 = blockIdx.y * CT;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const bf16* qb = q + (size_t)b * nq * cq;
  const bf16* kb = k + (size_t)b * n * cq;
  const bf16* vb = v + (size_t)b * n * c + col0;
  const int chunks = (n + KEYS - 1) / KEYS;
  const bool single = chunks == 1;  // one step and one buffer: the chunk's keys and values, both passes
  const int p1 = single ? 1 : (chunks + kpb - 1) / kpb;  // steps of pass one
  const int steps = single ? 1 : p1 + chunks;
  const int nbuf = single ? 1 : kMStages;

  // columns [cq, cqp) of q and of every key row a buffer can hold are zero, and no copy of
  // keys writes there; the barrier orders these stores before the copies of values that
  // land in the same buffers
  if (cqp > cq) {
    const int pad = cqp - cq, krows = stage / ldk;
    for (int e = threadIdx.x; e < (ROWS + nbuf * krows) * pad; e += THREADS) {
      const int r = e / pad, cc = cq + e - r * pad, rr = r - ROWS;
      (r < ROWS ? s_q + r * ldk : s_ring + (rr / krows) * stage + (rr % krows) * ldk)[cc] = __float2bfloat16(0.f);
    }
    __syncthreads();
  }

  auto issue = [&](int step) {  // the copies of one step into its ring buffer, one commit group
    if (step < steps) {
      bf16* sk = s_ring + (step % kMStages) * stage;
      if (step < p1) {
        const int j0 = step * kpb * KEYS;
        load_rows<THREADS, 0>(sk, ldk, kb, cq, j0, min(kpb * KEYS, n - j0), n, cq, cq, vec);
      }
      if (single || step >= p1) {
        const int j0 = (step - (single ? 0 : p1)) * KEYS;
        if (!single) load_rows<THREADS, 0>(sk, ldk, kb, cq, j0, KEYS, n, cq, cq, vec);
        load_rows<THREADS, CT / 8>(sk + KEYS * ldk, LDV, vb, c, j0, KEYS, n, CT, c - col0, vec);
      }
    }
    dfc::cp_async_commit();
  };
  load_rows<THREADS, 0>(s_q, ldk, qb, cq, row0, ROWS, nq, cq, cq, vec);  // joins step 0's group
  for (int s = 0; s < kMStages - 1; ++s) issue(s);

  // ldmatrix row addresses of this lane: q as A (rows r, r+8 x channels c, c+8), k as B
  // (keys j, j+8 of an n-tile pair x channels c, c+8), v as B through .trans (keys
  // j, j+8 x channels c, c+8 of an n-tile pair)
  const int mi = lane / 8, mr = lane % 8;
  const int tile_bytes = 16 * ldk * 2;
  const uint32_t q_addr = dfc::smem_u32(s_q + (warp * 16 * RT + mr + (mi % 2) * 8) * ldk + (mi / 2) * 8);
  const int k_off = (mr + (mi / 2) * 8) * ldk + (mi % 2) * 8;
  const int v_off = (mr + (mi % 2) * 8) * LDV + (mi / 2) * 8;

  uint32_t qa[RT][2][4];                  // q fragments when cqp <= 32
  float m[RT][2], l[RT][2];               // rows g and g + 8 of each row tile
  float o[RT][CT / 8][4];
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    m[i][0] = m[i][1] = -INFINITY;
    l[i][0] = l[i][1] = 0.f;
#pragma unroll
    for (int nt = 0; nt < CT / 8; ++nt) o[i][nt][0] = o[i][nt][1] = o[i][nt][2] = o[i][nt][3] = 0.f;
  }

  for (int s = 0; s < steps; ++s) {
    dfc::cp_async_wait<kMStages - 2>();  // this thread's copies of step s have landed
    __syncthreads();                     // everyone's have, and step s - 1's buffer is free
    issue(s + kMStages - 1);
    if (s == 0 && cqp <= 32) {
#pragma unroll
      for (int i = 0; i < RT; ++i)
#pragma unroll
        for (int ks = 0; ks < 2; ++ks)
          if (ks * 16 < cqp) dfc::ldmatrix_x4(qa[i][ks], q_addr + i * tile_bytes + ks * 32);
    }
    const bf16* sk = s_ring + (s % kMStages) * stage;
    const uint32_t k_addr = dfc::smem_u32(sk + k_off);
    if (s < p1) {  // pass one: the row maximum over up to kpb chunks of keys
      const int j0 = s * kpb * KEYS, keys = min(kpb * KEYS, n - j0);
      for (int j = 0; j < keys; j += 16 * G) {
        float e[G][RT][2][4];
        energies<RT, G>(e, qa, q_addr, tile_bytes, k_addr + j * ldk * 2, 16 * ldk * 2, cq, cqp, keys - j, t);
#pragma unroll
        for (int gi = 0; gi < G; ++gi)
#pragma unroll
          for (int i = 0; i < RT; ++i) {
            m[i][0] = fmaxf(m[i][0], fmaxf(fmaxf(e[gi][i][0][0], e[gi][i][0][1]), fmaxf(e[gi][i][1][0], e[gi][i][1][1])));
            m[i][1] = fmaxf(m[i][1], fmaxf(fmaxf(e[gi][i][0][2], e[gi][i][0][3]), fmaxf(e[gi][i][1][2], e[gi][i][1][3])));
          }
      }
      if (s == p1 - 1) {  // finite: key 0 is a real key
#pragma unroll
        for (int i = 0; i < RT; ++i) {
          m[i][0] = dfc::quad_max(m[i][0]);
          m[i][1] = dfc::quad_max(m[i][1]);
        }
      }
    }
    if (single || s >= p1) {  // pass two: p = exp(e - m), l += p, out += bf16(p) v
      const int j0 = (s - (single ? 0 : p1)) * KEYS;
      const uint32_t v_addr = dfc::smem_u32(sk + KEYS * ldk + v_off);
#pragma unroll
      for (int kg = 0; kg < KEYS / 16; kg += G) {  // G groups of 16 keys
        if (j0 + kg * 16 >= n) break;
        float e[G][RT][2][4];
        energies<RT, G>(e, qa, q_addr, tile_bytes, k_addr + kg * 16 * ldk * 2, 16 * ldk * 2, cq, cqp,
                        n - j0 - kg * 16, t);
#pragma unroll
        for (int gi = 0; gi < G; ++gi) {
          uint32_t bv[CT / 16][4];  // the group's value fragments, loaded before its exponentials
#pragma unroll
          for (int np = 0; np < CT / 16; ++np)
            dfc::ldmatrix_x4_trans(bv[np], v_addr + ((kg + gi) * 16 * LDV + np * 16) * 2);
          uint32_t a[RT][4];
#pragma unroll
          for (int i = 0; i < RT; ++i) {
            const float d0 = m[i][0] * kLog2e, d1 = m[i][1] * kLog2e;
            float (&x)[2][4] = e[gi][i];
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              x[h][0] = dfc::exp2_scaled(x[h][0], kLog2e, d0);
              x[h][1] = dfc::exp2_scaled(x[h][1], kLog2e, d0);
              x[h][2] = dfc::exp2_scaled(x[h][2], kLog2e, d1);
              x[h][3] = dfc::exp2_scaled(x[h][3], kLog2e, d1);
              l[i][0] += x[h][0] + x[h][1];
              l[i][1] += x[h][2] + x[h][3];
            }
            a[i][0] = dfc::pack2(x[0][0], x[0][1]);
            a[i][1] = dfc::pack2(x[0][2], x[0][3]);
            a[i][2] = dfc::pack2(x[1][0], x[1][1]);
            a[i][3] = dfc::pack2(x[1][2], x[1][3]);
          }
#pragma unroll
          for (int np = 0; np < CT / 16; ++np)
#pragma unroll
            for (int i = 0; i < RT; ++i) {
              dfc::mma16816(o[i][2 * np], a[i], bv[np][0], bv[np][1]);
              dfc::mma16816(o[i][2 * np + 1], a[i], bv[np][2], bv[np][3]);
            }
        }
      }
    }
  }
  dfc::cp_async_wait<0>();

  bf16* ob = out + (size_t)b * nq * c;
  const bool pairs = c % 2 == 0;  // bf16x2 stores stay 4-byte aligned
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    const float rl[2] = {1.f / dfc::quad_sum(l[i][0]), 1.f / dfc::quad_sum(l[i][1])};
    const int ra = row0 + (warp * RT + i) * 16 + g;
#pragma unroll
    for (int nt = 0; nt < CT / 8; ++nt) {
      const int ch = col0 + nt * 8 + 2 * t;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = ra + 8 * h;
        if (r >= nq || ch >= c) continue;
        bf16* dst = ob + (size_t)r * c + ch;
        if (pairs) {
          *reinterpret_cast<__nv_bfloat162*>(dst) =
              __floats2bfloat162_rn(o[i][nt][2 * h] * rl[h], o[i][nt][2 * h + 1] * rl[h]);
        } else {
          dst[0] = __float2bfloat16(o[i][nt][2 * h] * rl[h]);
          if (ch + 1 < c) dst[1] = __float2bfloat16(o[i][nt][2 * h + 1] * rl[h]);
        }
      }
    }
  }
}

template <int WARPS, int RT, int CT, int MINB, int G, int KEYS>
int launch_mma_t(const void* q, const void* k, const void* v, void* out, int b, int nq, int n, int cq,
                 int c, void* stream) {
  const int cqp = (cq + 15) / 16 * 16;
  const bool vec = cq % 8 == 0 && c % 8 == 0 &&
                   ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                     reinterpret_cast<uintptr_t>(v)) % 16) == 0;
  const size_t smem = mma_smem_bytes<WARPS, RT, CT, KEYS>(n, cqp);
  const cudaError_t err = cudaFuncSetAttribute(pooled_attention_mma_kernel<WARPS, RT, CT, MINB, G, KEYS>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(dfc::ceil_div(nq, 16 * WARPS * RT), dfc::ceil_div(c, CT), b);
  pooled_attention_mma_kernel<WARPS, RT, CT, MINB, G, KEYS><<<grid, WARPS * 32, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(out), nq, n, cq, c, cqp, vec ? 1 : 0);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// every entry point: q [b][nq][cq], k [b][n][cq], v [b][n][c], out [b][nq][c]; nq <= n
extern "C" int pooled_attention_long_f32(const void* q, const void* k, const void* v, void* out,
                                         int b, int nq, int n, int cq, int c, void* stream) {
  return launch_long<float>(q, k, v, out, b, nq, n, cq, c, stream);
}

extern "C" int pooled_attention_f32(const void* q, const void* k, const void* v, void* out, int b,
                                    int nq, int n, int cq, int c, void* stream) {
  return launch<float>(q, k, v, out, b, nq, n, cq, c, stream);
}

// bf16, any N = nk <= 4096 and Cq <= 256 (the configuration goes by the keys).  A block of 4 warps owns a whole image of N <= 64 (64
// query rows, one chunk).  For larger N and Cq <= 32 (the full-resolution model's N >= 256),
// 128-key chunks and 256 query rows a block (8 warps of two row tiles) at C <= 64, 128 rows at
// larger C (whose 128 channels of accumulators fill the registers): each image's K and V are
// read from L2 by fewer blocks.  Wider q and k take 64-key chunks and 128 rows, which keep the
// ring inside an SM's shared memory up to Cq = 256.
extern "C" int pooled_attention_mma_bf16(const void* q, const void* k, const void* v, void* out,
                                         int b, int nq, int n, int cq, int c, void* stream) {
  if (n <= 64) {
    return c <= 64 ? launch_mma_t<4, 1, 64, 4, 2, 64>(q, k, v, out, b, nq, n, cq, c, stream)
                   : launch_mma_t<4, 1, 128, 2, 2, 64>(q, k, v, out, b, nq, n, cq, c, stream);
  }
  if (cq > 32) return launch_mma_t<8, 1, 128, 1, 2, 64>(q, k, v, out, b, nq, n, cq, c, stream);
  return c <= 64 ? launch_mma_t<8, 2, 64, 1, 4, 128>(q, k, v, out, b, nq, n, cq, c, stream)
                 : launch_mma_t<8, 1, 128, 1, 4, 128>(q, k, v, out, b, nq, n, cq, c, stream);
}
