// Pooled self-attention core of LightSelfAttention, for Hopper (sm_90a).
//
// Replaces the TPU kernel dfc_sa_unet_tpu/ops/pallas_attention.py::
// fused_pooled_attention (body _attn_kernel, :32-43): for each batch element
//
//     out = softmax(q k^T) v        q: [Nq, Cq], k: [Nk, Cq], v: [Nk, C], Nk = p*p <= 4096
//
// Nq = Nk but under row sharding, where the full-resolution attention takes a
// band's queries against the whole image's keys (parallel/rows.py): the tiles
// and the row masks walk the Nq queries, the key loops the Nk keys.
//
// with no 1/sqrt(Cq) scale (the reference model has none), energies and the
// softmax in f32, f32 accumulation, and the output rounded to v's dtype.  The
// TPU kernel's point is that the N x N energies never reach device memory;
// none of the kernels here writes them either.
//
// bf16: pooled_attention_wgmma_kernel.  What bounds it on the H100: at the
// full-resolution model's first level (N = 4096, Cq = 8, C = 64, B = 128) the
// exponentials, B*N^2 = 2.1e9 of them at 16 a clock per SM (0.51 ms), against
// 2*B*N^2*(16 + C) tensor-core operations with Cq padded to 16 (0.35 ms at the
// peak) and 19 MB of q, k, v and out; at its N = 1024 level (Cq 16, C 128) the
// exponentials and products alike; at the flagship's N = 64 (nine levels, Cq =
// C/8, C 64..1024) and the pool-4 bottleneck (N = 16) the bytes of q, k, v and
// out.  The design, for the exponentials to run while the products do:
//   * one persistent block an SM, three warpgroups or four: a producer (one
//     thread, 40 or 24 registers after setmaxnreg) keeps a ring of chunks of
//     keys and values and two q slots full by TMA (tensor maps encoded on the
//     host, 64-channel boxes in the 128-byte swizzle that the wgmma
//     descriptors name; zero fill past nk, Cq, C, nq and the last image), each
//     behind a `full` mbarrier and freed on an `empty` one;
//   * two or three consumer warpgroups of 64 query rows each.  q's fragments
//     go to registers once a tile.  Per chunk of keys one issue puts on the
//     tensor cores e = q k^T (wgmma, q the register A operand, k K-major) and
//     o += p v of the chunk before (p the register A operand, straight from
//     the accumulators of e rounded to bf16; v MN-major, the transpose flag):
//     the chunk's maxima and exponentials run while that p v does, and while
//     the other warpgroups' products do;
//   * up to 64 keys (the flagship, the pool-4 bottleneck; so nq <= 64) each
//     consumer takes an image of its own, the two in turns on the tensor cores
//     (named barriers 1 and 2, FA3's ping-pong).  Over more keys the consumers
//     share one image's rows (two warpgroups of 128 channels of v, or three of
//     64 where C <= 64 and Cq <= 16: a tile of 192 rows, so each image's k and
//     v come from L2 a third as often as with 64) and run free: the turns made
//     the small products wait on each other's exponentials, and the timings of
//     scripts/bench_torch_pooled_attention.py --configs chose both (PERF.md
//     §6).  Chunks of 128 keys where the registers hold them (Cq <= 64), else
//     64.
// Order of arithmetic (tests/test_torch_attention_emulation.py emulates it and
// holds it to the JAX kernel and the plain version): one pass over the keys
// in chunks, in key order, per row a reference d (starting at -inf); per chunk
// e in f32 (Cq zero-padded to 16), keys past nk at -inf, dc = (chunk row max)
// * log2(e) in f32; where dc - d > 8 (the first chunk always) alpha = 2^(d -
// dc) and d = dc, else alpha = 1 and d stays, so that p = 2^(fma(e, log2(e),
// -d)) (ex2.approx) stays below 2^8 and o is rescaled a few times a row, not
// every chunk; l = l alpha + (sum of the unrounded p); o = o alpha + bf16(p) v
// (f32 accumulation); out = bf16(o * (1 / l)).  The reference rounds the
// normalised p / l to bf16 instead (pallas_attention.py:42): the two differ by
// bf16 roundings of p, far inside the 2e-2 chip_smoke.py allows.  The chunk
// goes by Nk, Cq and C alone, so a query row's result is the same bits
// whatever Nq and tile it falls in (phase 17(a) holds a band to the whole map).
// TMA reads rows of 16-byte multiples: the wrapper zero-pads Cq and C to
// multiples of 8 (ops/pooled_attention.py::tma_rows) rather than keeping a
// cp.async path here; no main-path shape needs it.
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

#include <atomic>

#include "common.cuh"
#include "conv3x3_wgmma.cuh"
#include "wgmma.cuh"

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

using bf16 = __nv_bfloat16;

constexpr float kLog2e = 1.4426950408889634f;

// ------------------------------------------- bf16: wgmma, TMA, consumer warpgroups
namespace wg {

using wgconv::mbar_arrive;
using wgconv::mbar_expect_tx;
using wgconv::mbar_init;
using wgconv::mbar_wait;
using wgconv::named_sync;
using wgconv::tma_load;

constexpr int kQSlots = 2;          // q tiles in flight: the next tile's lands during this one
constexpr int kMaxStages = 8;
constexpr int kSmemLimit = 232448;  // dynamic shared memory of one block
constexpr int kTile = 64 * 128;     // a box of 64 rows x 128 bytes, one 1 KB-aligned swizzle tile (of q)
// a row's reference maximum moves only when a chunk's maximum passes it by more than 2^kSlack in p
// (log2 units): p stays below 256, and o and l are rescaled a few times a row instead of every chunk
constexpr float kSlack = 8.f;

// CQP: q's and k's channels padded to a power of two >= 16 (the depth of a bf16 wgmma); CT: channels of v
// a tile; NC: consumer warpgroups, each owning 64 query rows; SPLIT: the consumers take an image each
// (nq <= 64), in turns on the tensor cores (named barriers), instead of sharing one image's keys and
// running free; CH: keys a chunk (64 or 128), the N of the energies' wgmma and one stage of the ring.
// A q slot holds every consumer's row tile, a stage one chunk of keys and values (of each
// consumer's image when SPLIT), each as [blocks of 64 channels][rows][128 bytes] in the 128-byte swizzle.
template <int CQP, int CT, int NC, bool SPLIT, int CH>
struct Shape {
  static constexpr int KB = (CQP + 63) / 64, VB = CT / 64, SUB = SPLIT ? NC : 1, KS = CQP / 16;
  static constexpr int kThreads = 128 * (NC + 1);  // and the producer warpgroup
  // registers a thread after setmaxnreg, the producer's and the consumers': within what the block was
  // given at launch (kThreads x 65536 / kThreads, rounded down to 8)
  static constexpr int kProducerRegs = NC == 2 ? 40 : 24, kConsumerRegs = NC == 2 ? 232 : 160;
  static constexpr int kQBytes = NC * KB * kTile;
  static constexpr int kBlock = CH * 128;  // a chunk's 64 channels of k or v
  static constexpr int kKBytes = SUB * KB * kBlock;
  static constexpr int kStageBytes = kKBytes + SUB * VB * kBlock;
  static constexpr int kBarBytes = 8 * 2 * (kMaxStages + kQSlots);
  static constexpr int kFit = (kSmemLimit - 1024 - kQSlots * kQBytes - kBarBytes) / kStageBytes;
  static constexpr int kStages = kFit < kMaxStages ? kFit : kMaxStages;
  static constexpr int kSmem = 1024 + kQSlots * kQBytes + kStages * kStageBytes + kBarBytes;
  static constexpr int kRows = SPLIT ? 64 : NC * 64;  // query rows of a tile (of each image, SPLIT)
  static_assert(kStages >= 2 && kSmem <= kSmemLimit, "a chunk's keys are read while the last one's values are");
  static_assert((CT == 64 || CT == 128) && (CH == 64 || CH == 128), "the wgmma widths");
  static_assert((NC == 2 || NC == 3) && NC * kConsumerRegs + kProducerRegs <= 65536 / kThreads / 8 * 8 * (NC + 1),
                "registers");
};

struct Maps {
  CUtensorMap q, k, v;
};

__device__ __forceinline__ void named_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// d = A . B (accumulate = 0) or d += A . B for a 64 x N x 16 product, N = 2 R keys: A, 16 channels of q,
// in registers (the m16n8k16 fragment layout, wgmma.cuh's wgmma_rs), B the keys K-major in shared memory
template <int R>
__device__ __forceinline__ void energies_wgmma(float (&d)[R], const uint32_t (&a)[4], uint64_t desc_b,
                                               int accumulate) {
  static_assert(R == 32 || R == 64, "64 or 128 keys");
  if constexpr (R == 32) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate));
  }
}

// 2^(x - y): ex2.approx of one subtraction (both operands already scaled by log2(e)); 0 for x = -inf
__device__ __forceinline__ float exp2_diff(float x, float y) { return dfc::exp2_scaled(x, 1.f, y); }

// One persistent block an SM walks tiles (column tile fastest, then row tile, then image or image group).
// The last warpgroup, the producer (one thread), keeps the q slots and a ring of kStages chunks full by
// TMA, each behind a `full` mbarrier, and reuses one when every consumer warp has arrived on its `empty`
// one.  The NC consumer warpgroups each own 64 query rows: q's fragments come from the slot into
// registers once a tile, then per chunk j
//   * e = q k_j^T by wgmma and, issued with it, o += p_{j-1} v_{j-1} (SPLIT: in the warpgroup's turn,
//     named barriers 1..NC taken round-robin);
//   * while those products run, and the other warpgroups': the chunk's masked row maxima times log2(e),
//     dc, where dc passes the row's reference d by more than kSlack alpha = 2^(d - dc) and d = dc (else
//     alpha = 1), p = 2^(e log2(e) - d) (one ex2.approx each), l = l alpha + sum p;
//   * once their p v is done: the chunk j - 1 stage freed, o *= alpha (skipped where a warp's alphas are
//     all 1), p rounded to bf16 into the A fragments of the next p v (the accumulator layout of e is that
//     fragment's layout).
// After the last chunk one more issue adds p v; out = o / l, rounded to bf16, stored from registers.
template <int CQP, int CT, int NC, bool SPLIT, int CH>
__global__ void __launch_bounds__(128 * (NC + 1), 1)
pooled_attention_wgmma_kernel(const __grid_constant__ Maps maps, bf16* __restrict__ out, int b, int nq, int nk,
                              int c) {
  using S = Shape<CQP, CT, NC, SPLIT, CH>;
  constexpr int ST = S::kStages, OR = CT / 2, ER = CH / 2, KK = CH / 16;  // registers of o and e; k-steps of p v
  extern __shared__ __align__(16) unsigned char smem_wg[];
  const uint32_t base = (dfc::smem_u32(smem_wg) + 1023u) & ~1023u;
  const uint32_t ring = base + kQSlots * S::kQBytes;
  const uint32_t bars = ring + ST * S::kStageBytes;
  auto q_slot = [&](int i) { return base + (i % kQSlots) * S::kQBytes; };
  auto stage = [&](int g) { return ring + (g % ST) * S::kStageBytes; };
  auto full = [&](int g) { return bars + 8 * (g % ST); };
  auto empty = [&](int g) { return bars + 8 * (kMaxStages + g % ST); };
  auto q_full = [&](int i) { return bars + 8 * (2 * kMaxStages + i % kQSlots); };
  auto q_empty = [&](int i) { return bars + 8 * (2 * kMaxStages + kQSlots + i % kQSlots); };

  const int chunks = (nk + CH - 1) / CH, ctiles = (c + CT - 1) / CT;
  const int rtiles = SPLIT ? 1 : (nq + S::kRows - 1) / S::kRows;
  const int tiles = (SPLIT ? (b + NC - 1) / NC : b) * rtiles * ctiles;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 4 * NC);  // one arrival a consumer warp
    }
    for (int i = 0; i < kQSlots; ++i) {
      mbar_init(q_full(i), 1);
      mbar_init(q_empty(i), 4 * NC);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == NC) {  // the producer: one thread issues every copy
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(S::kProducerRegs));
    if (threadIdx.x % 128 == 0) {
      int g = 0;  // chunks issued, over all of this block's tiles
      for (int t = blockIdx.x, i = 0; t < tiles; t += gridDim.x, ++i) {
        const int col0 = (t % ctiles) * CT, row0 = (t / ctiles % rtiles) * S::kRows, img = t / (ctiles * rtiles);
        if (i >= kQSlots) mbar_wait(q_empty(i), ((i / kQSlots) & 1) ^ 1);  // tile i - 2 has read its q
        mbar_expect_tx(q_full(i), S::kQBytes);
        for (int w = 0; w < NC; ++w)
          for (int kb = 0; kb < S::KB; ++kb)  // rows past nq, and images past b, read zero
            tma_load(q_slot(i) + (w * S::KB + kb) * kTile, &maps.q, q_full(i), 64 * kb, SPLIT ? 0 : row0 + w * 64,
                     SPLIT ? NC * img + w : img);
        for (int j = 0; j < chunks; ++j, ++g) {
          if (g >= ST) mbar_wait(empty(g), ((g / ST) & 1) ^ 1);  // chunk g - ST has freed the stage
          mbar_expect_tx(full(g), S::kStageBytes);
          for (int s = 0; s < S::SUB; ++s) {  // keys past nk and channels past cq or c read zero
            const int z = SPLIT ? NC * img + s : img;
            for (int kb = 0; kb < S::KB; ++kb)
              tma_load(stage(g) + (s * S::KB + kb) * S::kBlock, &maps.k, full(g), 64 * kb, j * CH, z);
            for (int vb = 0; vb < S::VB; ++vb)
              tma_load(stage(g) + S::kKBytes + (s * S::VB + vb) * S::kBlock, &maps.v, full(g), col0 + 64 * vb,
                       j * CH, z);
          }
        }
      }
    }
  } else {  // the consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(S::kConsumerRegs));
    const int cw = wg, warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32, t4 = lane % 4;
    const int mine = 1 + cw, next = 1 + (cw + 1) % NC;  // the named barriers of this turn and the next
    const int lm = lane / 8, lr = warp * 16 + 8 * (lm & 1) + lane % 8;  // ldmatrix: this lane's row of q
    if (SPLIT && cw == NC - 1) named_arrive(1, 256);  // warpgroup 0 takes the first turn
    float e[ER], o[OR], d[2] = {}, l[2] = {}, alpha[2];
    uint32_t qa[S::KS][4], pa[KK][4];
#pragma unroll
    for (int x = 0; x < ER; ++x) e[x] = 0.f;

    // q k^T of chunk gg into e, issued and committed
    auto energies = [&](int gg) {
      const uint32_t ks0 = stage(gg) + (SPLIT ? cw * S::KB * S::kBlock : 0);
#pragma unroll
      for (int ks = 0; ks < S::KS; ++ks)
        energies_wgmma(e, qa[ks], dfc::kmajor_desc(ks0 + (ks / 4) * S::kBlock + (ks % 4) * 32), ks > 0);
      dfc::wgmma_commit();
    };
    // o += p v of chunk gg (the p fragments of chunk gg), issued and committed
    auto pv = [&](int gg) {
      const uint32_t vs0 = stage(gg) + S::kKBytes + (SPLIT ? cw * S::VB * S::kBlock : 0);
#pragma unroll
      for (int kk = 0; kk < KK; ++kk) dfc::wgmma_rs<1>(o, pa[kk], dfc::smem_desc(vs0 + kk * 2048, S::kBlock, 1024));
      dfc::wgmma_commit();
    };
    // after the wait for chunk gg's p v: this warp's part has finished, o and p are free, and the stage too
    // once every consumer warp has arrived
    auto pv_done = [&](int gg) {
      dfc::fence_regs(o);
#pragma unroll
      for (int kk = 0; kk < KK; ++kk) dfc::fence_regs(pa[kk]);
      if (lane == 0) mbar_arrive(empty(gg));
    };
    // chunk j's energies in e -> its p (f32, in place), the reference and l updated; whether a reference moved.
    // e[4x + y]: row 16 warp + lane/4 (+8 for y >= 2), key CH j + 8x + 2 t4 + (y & 1)
    auto softmax = [&](int j) {
      if (j == chunks - 1 && nk % CH) {
#pragma unroll
        for (int x = 0; x < ER; ++x)
          if (j * CH + 8 * (x / 4) + 2 * t4 + (x & 1) >= nk) e[x] = -INFINITY;
      }
      float c0 = -INFINITY, c1 = -INFINITY;
#pragma unroll
      for (int x = 0; x < ER / 4; ++x) {
        c0 = fmaxf(c0, fmaxf(e[4 * x], e[4 * x + 1]));
        c1 = fmaxf(c1, fmaxf(e[4 * x + 2], e[4 * x + 3]));
      }
      // the chunk's row maxima times log2(e), finite (every chunk holds a key below nk); the first chunk
      // always moves the reference (-inf), which sets alpha to 0
      const float dc0 = dfc::quad_max(c0) * kLog2e, dc1 = dfc::quad_max(c1) * kLog2e;
      const bool up0 = dc0 - d[0] > kSlack, up1 = dc1 - d[1] > kSlack;
      alpha[0] = up0 ? exp2_diff(d[0], dc0) : 1.f;
      alpha[1] = up1 ? exp2_diff(d[1], dc1) : 1.f;
      d[0] = up0 ? dc0 : d[0];
      d[1] = up1 ? dc1 : d[1];
      float s0 = 0.f, s1 = 0.f;
#pragma unroll
      for (int x = 0; x < ER / 4; ++x) {
        e[4 * x] = dfc::exp2_scaled(e[4 * x], kLog2e, d[0]);
        e[4 * x + 1] = dfc::exp2_scaled(e[4 * x + 1], kLog2e, d[0]);
        e[4 * x + 2] = dfc::exp2_scaled(e[4 * x + 2], kLog2e, d[1]);
        e[4 * x + 3] = dfc::exp2_scaled(e[4 * x + 3], kLog2e, d[1]);
        s0 += e[4 * x] + e[4 * x + 1];
        s1 += e[4 * x + 2] + e[4 * x + 3];
      }
      l[0] = l[0] * alpha[0] + s0;
      l[1] = l[1] * alpha[1] + s1;
      return up0 || up1;
    };
    auto rescale = [&](bool moved) {  // o *= alpha; a factor of 1 leaves o as it is
      if (__any_sync(0xffffffffu, moved)) {
#pragma unroll
        for (int x = 0; x < OR; ++x) o[x] *= alpha[(x >> 1) & 1];
      }
    };
    auto pack = [&]() {  // p rounded to bf16: the A fragments of the k-steps of p v
#pragma unroll
      for (int kk = 0; kk < KK; ++kk) {
        pa[kk][0] = dfc::pack2(e[8 * kk], e[8 * kk + 1]);
        pa[kk][1] = dfc::pack2(e[8 * kk + 2], e[8 * kk + 3]);
        pa[kk][2] = dfc::pack2(e[8 * kk + 4], e[8 * kk + 5]);
        pa[kk][3] = dfc::pack2(e[8 * kk + 6], e[8 * kk + 7]);
      }
    };

    int g = 0;  // chunks consumed
    for (int t = blockIdx.x, i = 0; t < tiles; t += gridDim.x, ++i) {
      const int col0 = (t % ctiles) * CT, row0 = (t / ctiles % rtiles) * S::kRows, img = t / (ctiles * rtiles);
      mbar_wait(q_full(i), (i / kQSlots) & 1);
#pragma unroll
      for (int ks = 0; ks < S::KS; ++ks)
        dfc::ldmatrix_x4(qa[ks], q_slot(i) + (cw * S::KB + ks / 4) * kTile +
                                     dfc::swizzle128(lr * 128 + (2 * (ks % 4) + (lm >> 1)) * 16));
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncwarp();
      if (lane == 0) mbar_arrive(q_empty(i));
      d[0] = d[1] = -INFINITY;
      l[0] = l[1] = 0.f;
#pragma unroll
      for (int x = 0; x < OR; ++x) o[x] = 0.f;

      for (int j = 0; j < chunks; ++j, ++g) {
        mbar_wait(full(g), (g / ST) & 1);
        if (SPLIT) named_sync(mine, 256);
        dfc::wgmma_fence();
        energies(g);
        if (j > 0) pv(g - 1);
        if (SPLIT) named_arrive(next, 256);
        if (j > 0)
          dfc::wgmma_wait<1>();  // the energies are done, p v may still run
        else
          dfc::wgmma_wait<0>();
        dfc::fence_regs(e);
        const bool moved = softmax(j);
        if (j > 0) {
          dfc::wgmma_wait<0>();
          pv_done(g - 1);
          rescale(moved);
        }
        pack();
      }
      // the last chunk's p v
      if (SPLIT) named_sync(mine, 256);
      dfc::wgmma_fence();
      pv(g - 1);
      if (SPLIT) named_arrive(next, 256);
      dfc::wgmma_wait<0>();
      pv_done(g - 1);

      // o[4x + y]: row 16 warp + lane/4 (+8 for y >= 2), column 8x + 2 t4 + (y & 1) of the tile
      const int image = SPLIT ? NC * img + cw : img;
      if (image < b) {
        const float rl[2] = {1.f / dfc::quad_sum(l[0]), 1.f / dfc::quad_sum(l[1])};
        const int ra = (SPLIT ? 0 : row0 + cw * 64) + warp * 16 + lane / 4;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if (ra + 8 * h >= nq) continue;
          bf16* dst = out + ((size_t)image * nq + ra + 8 * h) * c + col0 + 2 * t4;
#pragma unroll
          for (int x = 0; x < OR / 4; ++x)  // c is a multiple of 8: a pair is inside or past c whole
            if (col0 + 8 * x < c)
              *reinterpret_cast<__nv_bfloat162*>(dst + 8 * x) =
                  __floats2bfloat162_rn(o[4 * x + 2 * h] * rl[h], o[4 * x + 2 * h + 1] * rl[h]);
        }
      }
    }
    if (SPLIT && cw == 0) named_sync(1, 256);  // the last warpgroup's arrival after its last turn
  }
}

}  // namespace wg

constexpr int kMaxDevices = 64;

template <int CQP, int CT, int NC, bool SPLIT, int CH>
int launch_wg(const void* q, const void* k, const void* v, void* out, int b, int nq, int nk, int cq, int c,
              void* stream) {
  using S = wg::Shape<CQP, CT, NC, SPLIT, CH>;
  wg::Maps maps;  // [b][rows][channels], boxes of 64 channels x 64 rows
  if (!wgconv::tile_map(&maps.q, q, cq, nq, b, 64) || !wgconv::tile_map(&maps.k, k, cq, nk, b, CH) ||
      !wgconv::tile_map(&maps.v, v, c, nk, b, CH))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long tiles = (long long)(SPLIT ? (b + NC - 1) / NC : b) * (SPLIT ? 1 : dfc::ceil_div(nq, S::kRows)) *
                          dfc::ceil_div(c, CT);
  // the SM count and the shared-memory attribute, once a device for this instantiation (0: not yet)
  static std::atomic<int> sms_of[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  int sms = sms_of[dev].load(std::memory_order_acquire);
  if (sms == 0) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(wg::pooled_attention_wgmma_kernel<CQP, CT, NC, SPLIT, CH>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, S::kSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    sms_of[dev].store(sms, std::memory_order_release);
  }
  const int grid = static_cast<int>(tiles < sms ? tiles : sms);
  wg::pooled_attention_wgmma_kernel<CQP, CT, NC, SPLIT, CH><<<grid, S::kThreads, S::kSmem,
                                                              static_cast<cudaStream_t>(stream)>>>(
      maps, static_cast<bf16*>(out), b, nq, nk, c);
  return static_cast<int>(cudaGetLastError());
}

// the instantiation for cqp among CQ..., or cudaErrorInvalidValue
template <int CT, int NC, bool SPLIT, int CH, int... CQ>
int launch_wg_cq(int cqp, const void* q, const void* k, const void* v, void* out, int b, int nq, int nk, int cq,
                 int c, void* stream) {
  int err = static_cast<int>(cudaErrorInvalidValue);
  ((cqp == CQ ? (err = launch_wg<CQ, CT, NC, SPLIT, CH>(q, k, v, out, b, nq, nk, cq, c, stream)) : 0), ...);
  return err;
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

// bf16 on wgmma with TMA-fed q, keys and values: any nq <= n = nk <= 4096, cq <= 256 and c, both multiples
// of 8 (TMA's 16-byte row strides: the wrapper zero-pads other widths), every pointer 16-byte aligned.
extern "C" int pooled_attention_wgmma_bf16(const void* q, const void* k, const void* v, void* out, int b, int nq,
                                           int n, int cq, int c, void* stream) {
  const uintptr_t ptrs = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                         reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(out);
  if (b < 1 || nq < 1 || nq > n || cq < 1 || cq > 256 || cq % 8 || c < 1 || c % 8 || ptrs % 16 ||
      !wgconv::encode_tiled())
    return static_cast<int>(cudaErrorInvalidValue);
  const int cqp = cq <= 16 ? 16 : cq <= 32 ? 32 : cq <= 64 ? 64 : cq <= 128 ? 128 : 256;
  // 64 channels of v a tile where c <= 64 and cq <= 16, else 128.  Up to 64 keys (so nq <= 64): two
  // warpgroups take an image each, in turns on the tensor cores.  Else one image's rows are shared by free-
  // running warpgroups, in chunks of 128 keys where their registers hold them (cq <= 64), else 64: three
  // warpgroups at 64 channels, two at 128.  The chunk goes by nk, cq and c alone, never by nq.
  const bool narrow = c <= 64 && cqp == 16;
  if (n <= 64 && cqp <= 128)
    return narrow ? launch_wg_cq<64, 2, true, 64, 16>(cqp, q, k, v, out, b, nq, n, cq, c, stream)
                  : launch_wg_cq<128, 2, true, 64, 16, 32, 64, 128>(cqp, q, k, v, out, b, nq, n, cq, c, stream);
  if (cqp <= 64)
    return narrow ? launch_wg_cq<64, 3, false, 128, 16>(cqp, q, k, v, out, b, nq, n, cq, c, stream)
                  : launch_wg_cq<128, 2, false, 128, 16, 32, 64>(cqp, q, k, v, out, b, nq, n, cq, c, stream);
  return launch_wg_cq<128, 2, false, 64, 128, 256>(cqp, q, k, v, out, b, nq, n, cq, c, stream);
}
