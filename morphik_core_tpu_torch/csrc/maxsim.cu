// MaxSim late-interaction scoring kernels for Hopper (sm_90a).
//
//   score(c) = sum_q max_n <q, d_{c,n}>   over valid doc tokens n
//
// Two kernels, each the Hopper counterpart of one Pallas TPU kernel of
// morphik_core_tpu/ops/maxsim.py:
//
//   K1 maxsim_q8_kernel  replaces _maxsim_kernel_q8 (ops/maxsim.py:248,
//      launched by _maxsim_pallas_q8 :366). int8 doc tokens x int8 query
//      tokens -> exact int32 dot (__dp4a), then f32(s32) * ds * qs in that
//      order, masked to -1e30, max over doc tokens, entries <= -5e29 -> 0,
//      sum over query tokens.
//   K2 maxsim_kernel     replaces _maxsim_kernel (ops/maxsim.py:111,
//      launched by _maxsim_pallas :151). f32 query against f32 or bf16 doc
//      tokens with f32 accumulation; same mask / max / clamp / sum.
//
// Both take an optional int32 row-index vector: candidate c reads doc row
// idx[c] of a larger (rows, Np, D) buffer, so the pooled tier and the
// device candidate cache score gathered rows without materialising a
// (C, Np, D) copy. idx[c] < 0 means "no row": the candidate is fully
// masked and scores 0, as a fully masked candidate does in the Pallas
// kernel. idx[c] >= rows writes NaN instead of reading out of bounds.
//
// What bounds them on an H100: each candidate's doc tokens are read from
// device memory once per query chunk (K1: 256 query rows, K2: 64), so the
// floor is the doc bytes (Np * D bytes per candidate for int8, 2 or 4x
// that for bf16 / f32) over 3.35 TB/s. At the slice's shapes the grid is
// small (32 candidates for the cache rerank, 304 for the pooled stage),
// so in practice the per-block instruction stream (shared-memory loads
// plus one dp4a or FMA per 4 bytes or 1 value) and the launch bound it,
// not HBM.
//
// Design: one thread block owns one whole candidate, so no cross-block
// reduction is needed; a loop over doc-token tiles replaces the TPU grid's
// sequential token axis. A query chunk sits in shared memory with a padded
// row stride (bank-conflict free); doc-token tiles are staged in shared
// memory by the whole block with coalesced loads. Thread t owns query
// token t % QT of the chunk and every G-th token of each tile (G = 256 /
// QT), keeping its running max in a register; the G partial maxima of a
// query token are merged through shared memory, clamped, and summed with
// a warp-shuffle block reduction. wgmma, TMA and persistent blocks are
// later work.
//
// Plain C interface, built with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared -Xcompiler -fPIC
// and loaded through ctypes (morphik_core_tpu_torch/ops/_kernels.py). Each
// launcher returns cudaGetLastError() (or cudaErrorInvalidValue for
// arguments it does not take); the caller raises when it is not 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr float kNegInf = -1.0e30f;  // NEG_INF of ops/maxsim.py
constexpr float kClamp = -5.0e29f;   // NEG_INF * 0.5: fully masked -> 0

constexpr int kQ8QueryChunk = 256;
constexpr int kQ8TokTile = 64;
constexpr int kF32QueryChunk = 64;
constexpr int kF32TokTile = 16;

__device__ __forceinline__ int next_pow2(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

// Sum of one float per thread over the block; the result is valid in
// thread 0. `scratch` holds kThreads / 32 floats.
__device__ __forceinline__ float block_sum(float v, float* scratch) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  float s = 0.f;
  if (threadIdx.x < 32) {
    s = threadIdx.x < kThreads / 32 ? scratch[threadIdx.x] : 0.f;
    for (int o = 16; o > 0; o >>= 1) s += __shfl_down_sync(0xffffffffu, s, o);
  }
  __syncthreads();
  return s;
}

// Max over the G partial maxima of query token t, clamped as the Pallas
// kernel clamps (a fully masked candidate contributes 0).
__device__ __forceinline__ float merge_partials(const float* red, int t, int nqc, int qt,
                                                int groups) {
  if (t >= nqc) return 0.f;
  float mx = kNegInf;
  for (int g = 0; g < groups; ++g) mx = fmaxf(mx, red[g * qt + t]);
  return mx <= kClamp ? 0.f : mx;
}

__global__ void __launch_bounds__(kThreads)
maxsim_q8_kernel(const int8_t* __restrict__ q8, const float* __restrict__ qs,
                 const int8_t* __restrict__ d8, const float* __restrict__ ds,
                 const float* __restrict__ mask, const int32_t* __restrict__ idx,
                 float* __restrict__ out, int n_rows, int np, int nq, int dim) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int dw = dim / 4;  // int32 words (4 int8 lanes) per token
  const int stride = dw + 1;
  int* q_s = reinterpret_cast<int*>(smem);           // [kQ8QueryChunk][stride]
  int* d_s = q_s + kQ8QueryChunk * stride;           // [kQ8TokTile][stride]
  float* ds_s = reinterpret_cast<float*>(d_s + kQ8TokTile * stride);  // [kQ8TokTile]
  float* m_s = ds_s + kQ8TokTile;                    // [kQ8TokTile]
  float* red_s = m_s + kQ8TokTile;                   // [kThreads]
  float* sum_s = red_s + kThreads;                   // [kThreads / 32]

  const int c = blockIdx.x;
  const int t = threadIdx.x;
  const int row = idx ? idx[c] : c;
  if (row >= n_rows) {
    if (t == 0) out[c] = __int_as_float(0x7fc00000);  // NaN: bad row index
    return;
  }
  float total = 0.f;
  if (row >= 0) {
    const int* qw = reinterpret_cast<const int*>(q8);
    const int* dq = reinterpret_cast<const int*>(d8 + (size_t)row * np * dim);
    const float* ds_row = ds + (size_t)row * np;
    const float* m_row = mask + (size_t)row * np;
    for (int q0 = 0; q0 < nq; q0 += kQ8QueryChunk) {
      const int nqc = min(kQ8QueryChunk, nq - q0);
      const int qt = next_pow2(nqc);
      const int groups = kThreads / qt;
      const int j = t % qt;
      const int g = t / qt;
      __syncthreads();
      for (int i = t; i < nqc * dw; i += kThreads) {
        const int r = i / dw;
        q_s[r * stride + (i - r * dw)] = qw[(size_t)q0 * dw + i];
      }
      const float qsj = j < nqc ? qs[q0 + j] : 0.f;
      float acc = kNegInf;
      for (int n0 = 0; n0 < np; n0 += kQ8TokTile) {
        const int ntile = min(kQ8TokTile, np - n0);
        __syncthreads();
        for (int i = t; i < ntile * dw; i += kThreads) {
          const int r = i / dw;
          d_s[r * stride + (i - r * dw)] = dq[(size_t)n0 * dw + i];
        }
        for (int i = t; i < ntile; i += kThreads) {
          ds_s[i] = ds_row[n0 + i];
          m_s[i] = m_row[n0 + i];
        }
        __syncthreads();
        if (j < nqc) {
          const int* qrow = q_s + j * stride;
          for (int n = g; n < ntile; n += groups) {
            if (m_s[n] > 0.f) {
              const int* drow = d_s + n * stride;
              int s = 0;
              for (int w = 0; w < dw; ++w) s = __dp4a(drow[w], qrow[w], s);
              acc = fmaxf(acc, (float)s * ds_s[n] * qsj);
            }
          }
        }
      }
      red_s[t] = acc;
      __syncthreads();
      const float s = block_sum(merge_partials(red_s, t, nqc, qt, groups), sum_s);
      if (t == 0) total += s;
    }
  }
  if (t == 0) out[c] = total;
}

template <typename DocT>
__device__ __forceinline__ float to_f32(DocT v);

template <>
__device__ __forceinline__ float to_f32<float>(float v) {
  return v;
}

template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename DocT>
__global__ void __launch_bounds__(kThreads)
maxsim_kernel(const float* __restrict__ q, const DocT* __restrict__ docs,
              const float* __restrict__ mask, const int32_t* __restrict__ idx,
              float* __restrict__ out, int n_rows, int np, int nq, int dim) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int stride = dim + 1;
  float* q_s = reinterpret_cast<float*>(smem);  // [kF32QueryChunk][stride]
  float* d_s = q_s + kF32QueryChunk * stride;   // [kF32TokTile][stride]
  float* m_s = d_s + kF32TokTile * stride;      // [kF32TokTile]
  float* red_s = m_s + kF32TokTile;             // [kThreads]
  float* sum_s = red_s + kThreads;              // [kThreads / 32]

  const int c = blockIdx.x;
  const int t = threadIdx.x;
  const int row = idx ? idx[c] : c;
  if (row >= n_rows) {
    if (t == 0) out[c] = __int_as_float(0x7fc00000);
    return;
  }
  float total = 0.f;
  if (row >= 0) {
    const DocT* d_row = docs + (size_t)row * np * dim;
    const float* m_row = mask + (size_t)row * np;
    for (int q0 = 0; q0 < nq; q0 += kF32QueryChunk) {
      const int nqc = min(kF32QueryChunk, nq - q0);
      const int qt = next_pow2(nqc);
      const int groups = kThreads / qt;
      const int j = t % qt;
      const int g = t / qt;
      __syncthreads();
      for (int i = t; i < nqc * dim; i += kThreads) {
        const int r = i / dim;
        q_s[r * stride + (i - r * dim)] = q[(size_t)q0 * dim + i];
      }
      float acc = kNegInf;
      for (int n0 = 0; n0 < np; n0 += kF32TokTile) {
        const int ntile = min(kF32TokTile, np - n0);
        __syncthreads();
        for (int i = t; i < ntile * dim; i += kThreads) {
          const int r = i / dim;
          d_s[r * stride + (i - r * dim)] = to_f32(d_row[(size_t)n0 * dim + i]);
        }
        for (int i = t; i < ntile; i += kThreads) m_s[i] = m_row[n0 + i];
        __syncthreads();
        if (j < nqc) {
          const float* qrow = q_s + j * stride;
          for (int n = g; n < ntile; n += groups) {
            if (m_s[n] > 0.f) {
              const float* drow = d_s + n * stride;
              float s = 0.f;
              for (int w = 0; w < dim; ++w) s = fmaf(drow[w], qrow[w], s);
              acc = fmaxf(acc, s);
            }
          }
        }
      }
      red_s[t] = acc;
      __syncthreads();
      const float s = block_sum(merge_partials(red_s, t, nqc, qt, groups), sum_s);
      if (t == 0) total += s;
    }
  }
  if (t == 0) out[c] = total;
}

constexpr size_t kDefaultSmem = 48 * 1024;
constexpr size_t kMaxSmem = 227 * 1024;

template <typename Kernel>
cudaError_t prepare_smem(Kernel kernel, size_t smem) {
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  if (smem > kDefaultSmem)
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  return cudaSuccess;
}

bool bad_sizes(int n_cand, int n_rows, int np, int nq, int dim) {
  return n_cand < 0 || n_rows < 0 || np < 0 || nq < 0 || dim <= 0;
}

}  // namespace

extern "C" int maxsim_q8_launch(const void* q8, const void* qs, const void* d8, const void* ds,
                                const void* mask, const void* idx, void* out, int n_cand,
                                int n_rows, int np, int nq, int dim, void* stream) {
  if (bad_sizes(n_cand, n_rows, np, nq, dim) || dim % 4 != 0) return (int)cudaErrorInvalidValue;
  if (n_cand == 0) return (int)cudaSuccess;
  const int stride = dim / 4 + 1;
  const size_t smem = sizeof(int) * (size_t)(kQ8QueryChunk + kQ8TokTile) * stride +
                      sizeof(float) * (2 * kQ8TokTile + kThreads + kThreads / 32);
  cudaError_t err = prepare_smem(maxsim_q8_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  maxsim_q8_kernel<<<n_cand, kThreads, smem, (cudaStream_t)stream>>>(
      (const int8_t*)q8, (const float*)qs, (const int8_t*)d8, (const float*)ds,
      (const float*)mask, (const int32_t*)idx, (float*)out, n_rows, np, nq, dim);
  return (int)cudaGetLastError();
}

extern "C" int maxsim_launch(const void* q, const void* docs, int docs_bf16, const void* mask,
                             const void* idx, void* out, int n_cand, int n_rows, int np, int nq,
                             int dim, void* stream) {
  if (bad_sizes(n_cand, n_rows, np, nq, dim)) return (int)cudaErrorInvalidValue;
  if (n_cand == 0) return (int)cudaSuccess;
  const size_t smem = sizeof(float) * ((size_t)(kF32QueryChunk + kF32TokTile) * (dim + 1) +
                                       kF32TokTile + kThreads + kThreads / 32);
  cudaError_t err;
  if (docs_bf16) {
    err = prepare_smem(maxsim_kernel<__nv_bfloat16>, smem);
    if (err != cudaSuccess) return (int)err;
    maxsim_kernel<__nv_bfloat16><<<n_cand, kThreads, smem, (cudaStream_t)stream>>>(
        (const float*)q, (const __nv_bfloat16*)docs, (const float*)mask, (const int32_t*)idx,
        (float*)out, n_rows, np, nq, dim);
  } else {
    err = prepare_smem(maxsim_kernel<float>, smem);
    if (err != cudaSuccess) return (int)err;
    maxsim_kernel<float><<<n_cand, kThreads, smem, (cudaStream_t)stream>>>(
        (const float*)q, (const float*)docs, (const float*)mask, (const int32_t*)idx,
        (float*)out, n_rows, np, nq, dim);
  }
  return (int)cudaGetLastError();
}
