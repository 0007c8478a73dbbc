// Multi-head self-attention core of the transformer zoo, for Hopper (sm_90a).
//
// Replaces two TPU kernels of dfc_sa_unet_tpu/ops/pallas_attention.py with one:
// fused_mha (body _mha_kernel, packed qkv [B,N,3E]) and fused_mha_sep (body
// _mha_kernel_sep, separate q, k, v [B,N,E]).  The math is _heads_attention's:
// for each image b and head h, on the columns h*hd..(h+1)*hd of q, k and v,
//
//     s = (q k^T) * (1/sqrt(hd))         f32, the scale multiplies the product
//     p = exp(s - rowmax(s)) / rowsum    f32, then rounded to v's dtype
//     out[:, h*hd:(h+1)*hd] = p v        f32 accumulation, rounded to the dtype
//
// Inputs are three base pointers and one row stride, so the packed tensor is
// (base, base + E, base + 2E) with stride 3E and the separate ones have
// stride E.  The output is the merged [B,N,E] tensor: no head split or merge
// transpose exists on either side, and the N x N scores never reach device
// memory.  That is what the TPU kernels were written for.
//
// What bounds it on the H100: per token and head the two products are
// 4*N*hd operations on 4*hd*sizeof(T) bytes of q, k, v and out, which is
// N/sizeof(T) operations per byte: 98 in bf16 at ViT-B's N = 196, below the
// ~295 the card needs before its tensor cores limit.  The bound is the bytes
// of q, k, v and out.
//
// Design.  The TPU kernel gives one program a whole image and unrolls the
// heads, since VMEM holds [N,3E].  Here a head's q, k and v go through shared
// memory, in one of three kernels (ops/mha.py::entry_point picks by type and N):
//
// * bf16, N <= 256 (mha_wgmma_kernel; every model of the factory: ViT-B/16 at
//   224x224 has N = 196): one block, one warpgroup, per (head, image) stages
//   the head's k and v once and q one 64-row tile ahead (16-byte cp.async into
//   the 128-byte swizzle; 70 KB at N = 196, three blocks an SM), and each
//   64-row tile of queries makes ONE pass over the keys: q k^T by
//   wgmma with q's fragments as the register A operand and k K-major, the
//   64 x NKP tile of scores kept in registers (NKP = N padded to 16: 208 for
//   196, 104 floats a thread), the exact row maximum and sum, p / l rounded to
//   bf16 (the reference's rounding point) straight into the register A operand
//   of the p v wgmma, v read MN-major with the transpose flag (no transposed
//   copy), the output through shared memory in coalesced 16-byte stores.  Two
//   products and one exponential per score; q, k and v read once, the output
//   written once, which is what the bytes bound asks.
// * bf16, N > 256 (mha_mma_kernel, no model of the factory): 8 warps, each
//   owning 16 query rows (its q rows live in registers as mma A fragments),
//   both products on the tensor cores (mma.sync m16n8k16, f32 accumulators),
//   keys staged in 64-key chunks.  The scores are kept nowhere: a first pass
//   over the keys takes each row's maximum and sum, a second pass recomputes
//   the products, forms the final probabilities in registers (the accumulator
//   fragment of q k^T is the A fragment of p v), rounds them to bf16 and
//   accumulates p v.  The scale is folded into the exponential, exp((s - m) *
//   scale) as one multiply-add and the hardware's exp2, and 1/l is one
//   reciprocal per row: both far inside the rounding to bf16 that follows.
// * f32 (mha_simt_kernel): exact f32 arithmetic on the SIMT units, a block
//   owning 16 query rows with their N scores in shared memory, as
//   pooled_attention.cu does.  TF32 would not hold the 1e-5 parity of the
//   f32 serving mode, and wgmma has no f32 path.

#include <math.h>
#include <stdint.h>

#include <utility>

#include "common.cuh"
#include "wgmma.cuh"

namespace {

// ------------------------------------------------------------------ f32: SIMT

constexpr int kThreads = 256;  // 8 warps
constexpr int kRows = 16;      // query rows per block (2 per warp)
constexpr int kKeys = 32;      // keys staged per step
constexpr int kMaxHd = 128;    // head_dim limit: 4 columns per lane

template <typename T>
__global__ void __launch_bounds__(kThreads)
mha_simt_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                T* __restrict__ out, int n, int hd, int ld, int e, float scale) {
  extern __shared__ float smem[];
  const int hdp = hd + 1;  // padded row stride: no bank conflicts in q.k
  float* s_e = smem;                 // [kRows][n] scores, then P
  float* s_q = s_e + kRows * n;      // [kRows][hdp]
  float* s_kv = s_q + kRows * hdp;   // [kKeys][hdp] keys, or [kKeys][hd] values

  const int b = blockIdx.z, h = blockIdx.y;
  const int row0 = blockIdx.x * kRows;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int rows = min(kRows, n - row0);
  const size_t in0 = (size_t)b * n * ld + (size_t)h * hd;
  const T* qb = q + in0;
  const T* kb = k + in0;
  const T* vb = v + in0;
  T* ob = out + (size_t)b * n * e + (size_t)h * hd;

  for (int i = tid; i < kRows * hd; i += kThreads) {
    const int r = i / hd, ch = i - r * hd;
    s_q[r * hdp + ch] = r < rows ? dfc::to_f(qb[(size_t)(row0 + r) * ld + ch]) : 0.f;
  }

  // scores s[r][j] = (q[r] . k[j]) * scale
  for (int j0 = 0; j0 < n; j0 += kKeys) {
    const int keys = min(kKeys, n - j0);
    __syncthreads();
    for (int i = tid; i < keys * hd; i += kThreads) {
      const int j = i / hd, ch = i - j * hd;
      s_kv[j * hdp + ch] = dfc::to_f(kb[(size_t)(j0 + j) * ld + ch]);
    }
    __syncthreads();
    for (int i = tid; i < kRows * keys; i += kThreads) {
      const int r = i / keys, j = i - r * keys;
      const float* qr = s_q + r * hdp;
      const float* kr = s_kv + j * hdp;
      float acc = 0.f;
      for (int ch = 0; ch < hd; ++ch) acc = fmaf(qr[ch], kr[ch], acc);
      s_e[r * n + j0 + j] = acc * scale;
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

  // out[r][c] = sum_j P[r][j] v[j][c]; warp owns rows 2w, 2w+1, lane owns
  // columns lane + 32*jj below hd
  float acc[2][4] = {};
  for (int j0 = 0; j0 < n; j0 += kKeys) {
    const int keys = min(kKeys, n - j0);
    __syncthreads();
    for (int i = tid; i < keys * hd; i += kThreads) {
      const int j = i / hd, ch = i - j * hd;
      s_kv[i] = dfc::to_f(vb[(size_t)(j0 + j) * ld + ch]);
    }
    __syncthreads();
    const float* p0 = s_e + (2 * warp) * n + j0;
    const float* p1 = p0 + n;
    for (int j = 0; j < keys; ++j) {
      const float a0 = p0[j], a1 = p1[j];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int ch = lane + 32 * jj;
        if (ch < hd) {
          const float vv = s_kv[j * hd + ch];
          acc[0][jj] = fmaf(a0, vv, acc[0][jj]);
          acc[1][jj] = fmaf(a1, vv, acc[1][jj]);
        }
      }
    }
  }
#pragma unroll
  for (int ii = 0; ii < 2; ++ii) {
    const int r = 2 * warp + ii;
    if (r >= rows) continue;
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int ch = lane + 32 * jj;
      if (ch < hd) ob[(size_t)(row0 + r) * e + ch] = dfc::from_f<T>(acc[ii][jj]);
    }
  }
}

template <typename T>
int launch_simt(const void* q, const void* k, const void* v, void* out, int b, int n, int nh,
                int hd, int ld, void* stream) {
  const size_t smem = sizeof(float) * ((size_t)kRows * n + (size_t)(kRows + kKeys) * (hd + 1));
  cudaFuncSetAttribute(mha_simt_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  const dim3 grid(dfc::ceil_div(n, kRows), nh, b);
  mha_simt_kernel<T><<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), n, hd, ld, nh * hd, 1.0f / sqrtf((float)hd));
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------- bf16: tensor cores

using bf16 = __nv_bfloat16;

constexpr int kMmaWarps = 8;               // 16 query rows each: 128 per block
constexpr int kMmaThreads = kMmaWarps * 32;
constexpr int kChunk = 64;                 // keys per step of the two passes
constexpr int kPad = 8;                    // row padding of shared operands: conflict-free fragment loads
constexpr int kResidentTokens = 256;       // up to here all of K and V of a head stay in shared memory

__device__ __forceinline__ uint32_t ld2(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

using dfc::exp2_scaled;
using dfc::mma16816;
using dfc::pack2;
using dfc::quad_max;
using dfc::quad_sum;

// s[r][0..HDP) <- g[row0 + r][0..hd) for r < rows, zero beyond row n and column hd.
// Rows are 16-byte aligned: hd, ld and the head offset are multiples of 8.
template <int HDP>
__device__ __forceinline__ void stage_rows(bf16* s, const bf16* __restrict__ g, int row0, int rows,
                                           int n, int hd, int ld) {
  constexpr int LD = HDP + kPad, VEC = HDP / 8;
  for (int i = threadIdx.x; i < rows * VEC; i += kMmaThreads) {
    const int r = i / VEC, c = (i % VEC) * 8;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (row0 + r < n && c < hd) val = *reinterpret_cast<const uint4*>(g + (size_t)(row0 + r) * ld + c);
    *reinterpret_cast<uint4*>(s + r * LD + c) = val;
  }
}

// s[c][0..rows) <- g[row0 + .][c]: the rows transposed (row stride ldv), two keys per
// 32-bit word; rows is even
template <int HDP>
__device__ __forceinline__ void stage_rows_transposed(bf16* s, int ldv, const bf16* __restrict__ g,
                                                      int row0, int rows, int n, int hd, int ld) {
  constexpr int VEC = HDP / 8;
  const int pairs = rows / 2;
  for (int i = threadIdx.x; i < pairs * VEC; i += kMmaThreads) {
    const int kp = i % pairs, c = (i / pairs) * 8;
    const int key = row0 + 2 * kp;
    uint4 lo = make_uint4(0, 0, 0, 0), hi = lo;
    if (c < hd) {
      if (key < n) lo = *reinterpret_cast<const uint4*>(g + (size_t)key * ld + c);
      if (key + 1 < n) hi = *reinterpret_cast<const uint4*>(g + (size_t)(key + 1) * ld + c);
    }
    const bf16* v0 = reinterpret_cast<const bf16*>(&lo);
    const bf16* v1 = reinterpret_cast<const bf16*>(&hi);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      __nv_bfloat162 pair;
      pair.x = v0[j];
      pair.y = v1[j];
      *reinterpret_cast<__nv_bfloat162*>(s + (c + j) * ldv + 2 * kp) = pair;
    }
  }
}

// the warp's 16 x kChunk raw products q.k of the keys j0.. whose rows start at s_k; keys
// beyond n read -inf.  The 1/sqrt(hd) scale is applied with the exponential (exp2_scaled).
template <int KS>
__device__ __forceinline__ void chunk_scores(float (&s)[kChunk / 8][4], const uint32_t (&qa)[KS][4],
                                             const bf16* s_k, int j0, int n, int g, int t) {
  constexpr int LD = 16 * KS + kPad;
#pragma unroll
  for (int nt = 0; nt < kChunk / 8; ++nt) {
    s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
    if (j0 + nt * 8 < n) {
      const bf16* p = s_k + (nt * 8 + g) * LD + 2 * t;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) mma16816(s[nt], qa[ks], ld2(p + ks * 16), ld2(p + ks * 16 + 8));
    }
  }
  if (j0 + kChunk > n) {  // only the last chunk holds keys to mask
#pragma unroll
    for (int nt = 0; nt < kChunk / 8; ++nt) {
      const int key = j0 + nt * 8 + 2 * t;
      if (key >= n) s[nt][0] = s[nt][2] = -INFINITY;
      if (key + 1 >= n) s[nt][1] = s[nt][3] = -INFINITY;
    }
  }
}

// KS = k-steps of 16 over the head dimension, which is zero-padded to HDP = 16 KS.
// span = keys that shared memory holds at a time: all of them, rounded up to 16, when the
// head's K and V are resident (staged once, then no block-wide barrier), else kChunk.
template <int KS>
__global__ void __launch_bounds__(kMmaThreads)
mha_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
               bf16* __restrict__ out, int n, int hd, int ld, int e, float scale, int span) {
  constexpr int HDP = 16 * KS, LD = HDP + kPad, DT = HDP / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* s_k = reinterpret_cast<bf16*>(smem_raw);  // [span][LD]: keys as rows
  bf16* s_vt = s_k + span * LD;                   // [HDP][ldv]: values transposed
  const int ldv = span + kPad;
  const bool resident = span >= n;
  const float sc = scale * 1.4426950408889634f;  // scale * log2(e), for exp2_scaled

  const int b = blockIdx.z, h = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int ra = blockIdx.x * (16 * kMmaWarps) + warp * 16 + g, rb = ra + 8;  // this thread's rows
  const bool active = ra - g < n;  // warp-uniform; a warp without rows only helps staging
  const size_t in0 = (size_t)b * n * ld + (size_t)h * hd;
  const bf16* qb = q + in0;
  const bf16* kb = k + in0;
  const bf16* vb = v + in0;

  // the warp's 16 query rows as A fragments, straight from device memory, kept for both passes
  uint32_t qa[KS][4];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    const int c = ks * 16 + 2 * t;  // even, and hd is a multiple of 8: a pair is in or out
    qa[ks][0] = ra < n && c < hd ? ld2(qb + (size_t)ra * ld + c) : 0u;
    qa[ks][1] = rb < n && c < hd ? ld2(qb + (size_t)rb * ld + c) : 0u;
    qa[ks][2] = ra < n && c + 8 < hd ? ld2(qb + (size_t)ra * ld + c + 8) : 0u;
    qa[ks][3] = rb < n && c + 8 < hd ? ld2(qb + (size_t)rb * ld + c + 8) : 0u;
  }

  // pass 1: maximum m and sum l of exp(s - m) of rows ra (index 0) and rb (index 1)
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  for (int base = 0; base < n; base += span) {
    __syncthreads();
    stage_rows<HDP>(s_k, kb, base, span, n, hd, ld);
    if (resident) stage_rows_transposed<HDP>(s_vt, ldv, vb, base, span, n, hd, ld);
    __syncthreads();
    if (!active) continue;
    for (int j0 = base; j0 < min(n, base + span); j0 += kChunk) {
      float s[kChunk / 8][4];
      chunk_scores<KS>(s, qa, s_k + (j0 - base) * LD, j0, n, g, t);
      float c0 = m0, c1 = m1;
#pragma unroll
      for (int nt = 0; nt < kChunk / 8; ++nt) {
        c0 = fmaxf(c0, fmaxf(s[nt][0], s[nt][1]));
        c1 = fmaxf(c1, fmaxf(s[nt][2], s[nt][3]));
      }
      c0 = quad_max(c0);  // every chunk has a key below n, so c0 and c1 are finite
      c1 = quad_max(c1);
      const float d0 = c0 * sc, d1 = c1 * sc;
      float a0 = 0.f, a1 = 0.f;
#pragma unroll
      for (int nt = 0; nt < kChunk / 8; ++nt) {
        a0 += exp2_scaled(s[nt][0], sc, d0) + exp2_scaled(s[nt][1], sc, d0);
        a1 += exp2_scaled(s[nt][2], sc, d1) + exp2_scaled(s[nt][3], sc, d1);
      }
      l0 = l0 * exp2_scaled(m0, sc, d0) + a0;
      l1 = l1 * exp2_scaled(m1, sc, d1) + a1;
      m0 = c0;
      m1 = c1;
    }
  }
  const float r0 = 1.f / quad_sum(l0), r1 = 1.f / quad_sum(l1);
  const float d0 = m0 * sc, d1 = m1 * sc;

  // pass 2: p = exp((s - m) * scale) / l rounded to bf16, out += p v; 1/l is one reciprocal
  // per row
  float o[DT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt) o[dt][0] = o[dt][1] = o[dt][2] = o[dt][3] = 0.f;
  for (int base = 0; base < n; base += span) {
    if (!resident) {
      __syncthreads();
      stage_rows<HDP>(s_k, kb, base, span, n, hd, ld);
      stage_rows_transposed<HDP>(s_vt, ldv, vb, base, span, n, hd, ld);
      __syncthreads();
    }
    if (!active) continue;
    for (int j0 = base; j0 < min(n, base + span); j0 += kChunk) {
      float s[kChunk / 8][4];
      chunk_scores<KS>(s, qa, s_k + (j0 - base) * LD, j0, n, g, t);
#pragma unroll
      for (int kk = 0; kk < kChunk / 16; ++kk) {
        if (j0 + kk * 16 >= n) break;
        uint32_t pa[4];
        pa[0] = pack2(exp2_scaled(s[2 * kk][0], sc, d0) * r0, exp2_scaled(s[2 * kk][1], sc, d0) * r0);
        pa[1] = pack2(exp2_scaled(s[2 * kk][2], sc, d1) * r1, exp2_scaled(s[2 * kk][3], sc, d1) * r1);
        pa[2] = pack2(exp2_scaled(s[2 * kk + 1][0], sc, d0) * r0, exp2_scaled(s[2 * kk + 1][1], sc, d0) * r0);
        pa[3] = pack2(exp2_scaled(s[2 * kk + 1][2], sc, d1) * r1, exp2_scaled(s[2 * kk + 1][3], sc, d1) * r1);
        const bf16* p = s_vt + g * ldv + (j0 - base) + kk * 16 + 2 * t;
#pragma unroll
        for (int dt = 0; dt < DT; ++dt) mma16816(o[dt], pa, ld2(p + dt * 8 * ldv), ld2(p + dt * 8 * ldv + 8));
      }
    }
  }

  if (!active) return;
  bf16* ob = out + (size_t)b * n * e + (size_t)h * hd;
#pragma unroll
  for (int dt = 0; dt < DT; ++dt) {
    const int c = dt * 8 + 2 * t;
    if (c >= hd) continue;
    if (ra < n) *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)ra * e + c) = __floats2bfloat162_rn(o[dt][0], o[dt][1]);
    if (rb < n) *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)rb * e + c) = __floats2bfloat162_rn(o[dt][2], o[dt][3]);
  }
}

template <int KS>
void launch_mma_ks(const bf16* q, const bf16* k, const bf16* v, bf16* out, int b, int n, int nh,
                   int hd, int ld, cudaStream_t stream) {
  constexpr int HDP = 16 * KS;
  const int span = n <= kResidentTokens ? (n + 15) / 16 * 16 : kChunk;
  const size_t smem = sizeof(bf16) * ((size_t)span * (HDP + kPad) + (size_t)HDP * (span + kPad));
  cudaFuncSetAttribute(mha_mma_kernel<KS>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  const dim3 grid(dfc::ceil_div(n, 16 * kMmaWarps), nh, b);
  mha_mma_kernel<KS><<<grid, kMmaThreads, smem, stream>>>(q, k, v, out, n, hd, ld, nh * hd,
                                                          1.0f / sqrtf((float)hd), span);
}

int launch_mma(const void* q, const void* k, const void* v, void* out, int b, int n, int nh, int hd,
               int ld, void* stream) {
  const bf16* qp = static_cast<const bf16*>(q);
  const bf16* kp = static_cast<const bf16*>(k);
  const bf16* vp = static_cast<const bf16*>(v);
  bf16* op = static_cast<bf16*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (hd <= 16) launch_mma_ks<1>(qp, kp, vp, op, b, n, nh, hd, ld, st);
  else if (hd <= 32) launch_mma_ks<2>(qp, kp, vp, op, b, n, nh, hd, ld, st);
  else if (hd <= 64) launch_mma_ks<4>(qp, kp, vp, op, b, n, nh, hd, ld, st);
  else launch_mma_ks<8>(qp, kp, vp, op, b, n, nh, hd, ld, st);
  return static_cast<int>(cudaGetLastError());
}

bool supported(int b, int n, int nh, int hd) {
  return b >= 1 && b <= 65535 && n >= 1 && nh >= 1 && nh <= 65535 && hd >= 8 && hd <= kMaxHd &&
         hd % 8 == 0;
}

// ------------------------------------------- bf16, N <= 256: one pass on wgmma

constexpr int kWgTokens = 256;   // the one-pass kernel takes N up to here
constexpr int kWgThreads = 128;  // one warpgroup

// s[r][c] of a [rows][64 HB] tile stored as HB column blocks of [rows][64], each row one
// 128-byte swizzle row: byte offset of the 16-byte chunk `chunk` (of 8 columns) of row r
__device__ __forceinline__ uint32_t tile_off(int rows, int r, int chunk) {
  return dfc::swizzle128((chunk / 8) * rows * 128 + r * 128 + (chunk % 8) * 16);
}

// rows [0, rows) x columns [0, 64 HB) of a head's [n, hd] slice of g (row stride ld) into
// shared memory at s, zero past row n and column hd (16-byte cp.async, zero-fill)
template <int HB>
__device__ __forceinline__ void stage_tile(uint32_t s, const bf16* __restrict__ g, int rows, int n, int hd,
                                           int ld) {
  for (int i = threadIdx.x; i < rows * HB * 8; i += kWgThreads) {
    const int r = i / (HB * 8), chunk = i % (HB * 8);
    const bool ok = r < n && chunk * 8 < hd;
    dfc::cp_async16(s + tile_off(rows, r, chunk), ok ? g + (size_t)r * ld + chunk * 8 : g, ok);
  }
}

// Shared memory of a block: two buffers of one 64-row tile of q (and then of the output),
// k and v; and 3 where an SM's 228 KB hold three such blocks (then 170 registers a thread
// let their registers fit too), else 1 (no bound on the registers).
template <int HB, int NKC>
constexpr int wg_smem() { return 1024 + HB * 128 * (2 * 64 + 2 * 16 * NKC); }
template <int HB, int NKC>
constexpr int wg_blocks() { return 233472 / (wg_smem<HB, NKC>() + 1024) >= 3 ? 3 : 1; }

// One block (one warpgroup) per (head, image).  The head's k and v come into shared
// memory once, by 16-byte cp.async in the 128-byte swizzle, the head dimension zero-padded
// to HDP = 64 HB and the keys to NKP = 16 NKC; q comes one 64-row tile at a time, the
// next tile's copies in flight while this one is computed.  For each 64-row tile:
//   * q's fragments (ldmatrix) are the register A operand of wgmma.m64n16k16 against K
//     (K-major: k's rows as they are), one 16-key chunk after another: the tile's scores,
//     64 x NKP, stay in registers (NKC x 8 a thread);
//   * the exact row maximum and sum (quad shuffles), p = 2^(s c - m c) with c =
//     log2(e)/sqrt(hd), keys past n at p = 0; p / l rounded to bf16 is the reference's
//     rounding point, and the accumulator layout of a 16-key chunk is the A fragment of
//     the next product as it stands;
//   * out = p v by wgmma.m64n{HDP}k16 with p in registers and V read MN-major (the
//     transpose flag): no transposed copy of v;
//   * the output rows go through the tile's q buffer (free once its fragments are read),
//     one warp's 16 rows at a time, and leave in coalesced 16-byte stores.
template <int HB, int NKC>
__global__ void __launch_bounds__(kWgThreads, (wg_blocks<HB, NKC>()))
mha_wgmma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
                 bf16* __restrict__ out, int n, int hd, int ld, int e, float sc) {
  constexpr int KS = 4 * HB, NKP = 16 * NKC, OR = 32 * HB, QTILE = HB * 64 * 128;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = dfc::smem_u32(smem_raw);
  const uint32_t sq = (raw + 1023u) & ~1023u;  // 2 x [HB][64][64]: q's row tiles, then the output's
  const uint32_t sk = sq + 2 * QTILE;           // [HB][NKP][64]
  const uint32_t sv = sk + HB * NKP * 128;      // [HB][NKP][64]

  const int h = blockIdx.x, b = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const size_t in0 = (size_t)b * n * ld + (size_t)h * hd;
  stage_tile<HB>(sk, k + in0, NKP, n, hd, ld);
  stage_tile<HB>(sq, q + in0, 64, n, hd, ld);
  dfc::cp_async_commit();  // k and q's first row tile
  stage_tile<HB>(sv, v + in0, NKP, n, hd, ld);
  dfc::cp_async_commit();  // v

  for (int row0 = 0; row0 < n; row0 += 64) {
    const uint32_t sqt = sq + (row0 / 64 % 2) * QTILE;
    if (row0 == 0)
      dfc::cp_async_wait<1>();  // k and q's first tile have landed
    else
      dfc::cp_async_wait<0>();  // this tile of q has
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();  // and every warp has stored the output that the other buffer held
    uint32_t qa[KS][4];
    const int m = lane / 8, qr = warp * 16 + 8 * (m & 1) + lane % 8;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) dfc::ldmatrix_x4(qa[ks], sqt + tile_off(64, qr, 2 * ks + (m >> 1)));
    if (row0 + 64 < n)  // q's next row tile into the other buffer
      stage_tile<HB>(sq + ((row0 / 64 + 1) % 2) * QTILE, q + in0 + (size_t)(row0 + 64) * ld, 64, n - row0 - 64,
                     hd, ld);
    dfc::cp_async_commit();

    float s[NKC][8];
#pragma unroll
    for (int c = 0; c < NKC; ++c)
#pragma unroll
      for (int i = 0; i < 8; ++i) s[c][i] = 0.f;
    dfc::wgmma_fence();
#pragma unroll
    for (int c = 0; c < NKC; ++c)
#pragma unroll
      for (int ks = 0; ks < KS; ++ks)
        dfc::wgmma_rs<0>(s[c], qa[ks], dfc::kmajor_desc(sk + (ks / 4) * NKP * 128 + c * 2048 + (ks % 4) * 32));
    dfc::wgmma_commit();
    dfc::wgmma_wait<0>();
#pragma unroll
    for (int c = 0; c < NKC; ++c) dfc::fence_regs(s[c]);
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) dfc::fence_regs(qa[ks]);  // live until the products are done

    // s[c][4j + r]: key 16c + 8j + 2t + (r & 1) of row g (r < 2) or g + 8 (r >= 2)
    if (NKP > n) {
#pragma unroll
      for (int i = 0; i < 8; ++i)
        if (16 * (NKC - 1) + 8 * (i / 4) + 2 * t + (i & 1) >= n) s[NKC - 1][i] = -INFINITY;
    }
    float m0 = -INFINITY, m1 = -INFINITY;
#pragma unroll
    for (int c = 0; c < NKC; ++c)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        m0 = fmaxf(m0, fmaxf(s[c][4 * j], s[c][4 * j + 1]));
        m1 = fmaxf(m1, fmaxf(s[c][4 * j + 2], s[c][4 * j + 3]));
      }
    const float d0 = dfc::quad_max(m0) * sc, d1 = dfc::quad_max(m1) * sc;
    float l0 = 0.f, l1 = 0.f;
#pragma unroll
    for (int c = 0; c < NKC; ++c)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        s[c][4 * j] = exp2_scaled(s[c][4 * j], sc, d0);
        s[c][4 * j + 1] = exp2_scaled(s[c][4 * j + 1], sc, d0);
        s[c][4 * j + 2] = exp2_scaled(s[c][4 * j + 2], sc, d1);
        s[c][4 * j + 3] = exp2_scaled(s[c][4 * j + 3], sc, d1);
        l0 += s[c][4 * j] + s[c][4 * j + 1];
        l1 += s[c][4 * j + 2] + s[c][4 * j + 3];
      }
    const float r0 = 1.f / quad_sum(l0), r1 = 1.f / quad_sum(l1);
    uint32_t pa[NKC][4];
#pragma unroll
    for (int c = 0; c < NKC; ++c) {
      pa[c][0] = pack2(s[c][0] * r0, s[c][1] * r0);
      pa[c][1] = pack2(s[c][2] * r1, s[c][3] * r1);
      pa[c][2] = pack2(s[c][4] * r0, s[c][5] * r0);
      pa[c][3] = pack2(s[c][6] * r1, s[c][7] * r1);
    }

    float o[OR];
#pragma unroll
    for (int i = 0; i < OR; ++i) o[i] = 0.f;
    if (row0 == 0) {
      dfc::cp_async_wait<1>();  // v has landed (q's next tile may not have)
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncthreads();
    }
    dfc::wgmma_fence();
#pragma unroll
    for (int c = 0; c < NKC; ++c) dfc::wgmma_rs<1>(o, pa[c], dfc::smem_desc(sv + c * 2048, NKP * 128, 1024));
    dfc::wgmma_commit();
    dfc::wgmma_wait<0>();
    dfc::fence_regs(o);
#pragma unroll
    for (int c = 0; c < NKC; ++c) dfc::fence_regs(pa[c]);  // live until the products are done

    // o[4j + r]: row 16 warp + g (+8 for r >= 2), column 8j + 2t + (r & 1); this warp's rows
    // of the tile's q buffer were read by this warp alone
    unsigned char* so = smem_raw + (sqt - raw);
    const int ra = warp * 16 + g;
#pragma unroll
    for (int j = 0; j < OR / 4; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(so + tile_off(64, ra, j) + 4 * t) = __floats2bfloat162_rn(o[4 * j], o[4 * j + 1]);
      *reinterpret_cast<__nv_bfloat162*>(so + tile_off(64, ra + 8, j) + 4 * t) =
          __floats2bfloat162_rn(o[4 * j + 2], o[4 * j + 3]);
    }
    __syncwarp();
    bf16* ob = out + (size_t)b * n * e + (size_t)h * hd;
    for (int i = lane; i < 16 * HB * 8; i += 32) {
      const int r = warp * 16 + i / (HB * 8), chunk = i % (HB * 8);
      if (row0 + r < n && chunk * 8 < hd)
        *reinterpret_cast<uint4*>(ob + (size_t)(row0 + r) * e + chunk * 8) =
            *reinterpret_cast<const uint4*>(so + tile_off(64, r, chunk));
    }
  }
}

template <int HB, int NKC>
int launch_wg(const bf16* q, const bf16* k, const bf16* v, bf16* out, int b, int n, int nh, int hd, int ld,
              cudaStream_t stream) {
  constexpr int smem = wg_smem<HB, NKC>();
  cudaFuncSetAttribute(mha_wgmma_kernel<HB, NKC>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  mha_wgmma_kernel<HB, NKC><<<dim3(nh, b), kWgThreads, smem, stream>>>(
      q, k, v, out, n, hd, ld, nh * hd, 1.4426950408889634f / sqrtf((float)hd));
  return static_cast<int>(cudaGetLastError());
}

template <int HB, int... C>
int launch_wg_keys(std::integer_sequence<int, C...>, const bf16* q, const bf16* k, const bf16* v, bf16* out,
                   int b, int n, int nh, int hd, int ld, cudaStream_t stream) {
  const int nkc = (n + 15) / 16;
  int err = static_cast<int>(cudaErrorInvalidValue);
  ((nkc == C + 1 ? (err = launch_wg<HB, C + 1>(q, k, v, out, b, n, nh, hd, ld, stream)) : 0), ...);
  return err;
}

int launch_wgmma(const void* q, const void* k, const void* v, void* out, int b, int n, int nh, int hd, int ld,
                 void* stream) {
  const auto keys = std::make_integer_sequence<int, kWgTokens / 16>{};
  const bf16* qp = static_cast<const bf16*>(q);
  const bf16* kp = static_cast<const bf16*>(k);
  const bf16* vp = static_cast<const bf16*>(v);
  bf16* op = static_cast<bf16*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (hd <= 64) return launch_wg_keys<1>(keys, qp, kp, vp, op, b, n, nh, hd, ld, st);
  return launch_wg_keys<2>(keys, qp, kp, vp, op, b, n, nh, hd, ld, st);
}

}  // namespace

// q, k, v: base pointers of [B,N,*] tensors with row stride ld (elements), whose
// columns h*hd..(h+1)*hd are head h; out: [B,N,nh*hd], contiguous.  Returns
// cudaGetLastError(), or cudaErrorInvalidValue for sizes the kernels do not take.
extern "C" int mha_f32(const void* q, const void* k, const void* v, void* out, int b, int n, int nh,
                       int hd, int ld, void* stream) {
  if (!supported(b, n, nh, hd)) return static_cast<int>(cudaErrorInvalidValue);
  return launch_simt<float>(q, k, v, out, b, n, nh, hd, ld, stream);
}

// bf16, the two-pass mma.sync kernel: any N (the wrapper sends it N > 256)
extern "C" int mha_bf16(const void* q, const void* k, const void* v, void* out, int b, int n, int nh,
                        int hd, int ld, void* stream) {
  if (!supported(b, n, nh, hd)) return static_cast<int>(cudaErrorInvalidValue);
  return launch_mma(q, k, v, out, b, n, nh, hd, ld, stream);
}

// bf16, the one-pass wgmma kernel: N <= 256
extern "C" int mha_wgmma_bf16(const void* q, const void* k, const void* v, void* out, int b, int n, int nh,
                              int hd, int ld, void* stream) {
  if (!supported(b, n, nh, hd) || n > kWgTokens) return static_cast<int>(cudaErrorInvalidValue);
  return launch_wgmma(q, k, v, out, b, n, nh, hd, ld, stream);
}
