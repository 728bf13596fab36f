// Binary (Hamming) MaxSim for Hopper (sm_90a): K4.
//
//   score(c) = sum_q max_{d < ntok[c]} (1 - popcount(q XOR d_{c,d}) / dim)
//
// over MSB-first packed sign bits: query tokens (nq, nb) u8, doc tokens
// (n_rows, nd, nb) u8, each row's valid tokens a prefix of ntok[c]. A row
// without valid tokens scores 0.
//
// It replaces no Pallas kernel: the reference computes this in one fused
// XLA program (morphik_core_tpu/ops/binary.py:65-86, XOR,
// lax.population_count, mask, max, sum), and PyTorch has no popcount op,
// so the plain chain of eager ops writes an XOR tensor and several SWAR
// passes over it (gigabytes for a 64 MiB block of packed rows).
//
// What bounds it on an H100. A doc token is read once (nb bytes), but
// each (query token, doc token) pair costs ceil(nb/4) popcounts, and the
// card completes 16 popcounts per SM per clock (CUDA C++ Programming Guide,
// arithmetic instruction throughput, "population count", compute
// capability 9.0). At the index's resident scan (16,392 rows x 1024
// tokens x 16 bytes, 32 query tokens) that is 2.1 G popcounts, about 6x
// the time the 268 MB take at 3.35 TB/s: the popcount pipe is the bound.
// Measured on one NVIDIA H100 80GB HBM3 (700 W; chip_smoke.py phase 2,
// rows of 64-632 valid tokens): 0.248 ms at 32 query tokens, 70% of the
// popcount bound of the valid tokens; 3.76 ms at 632, 92%. A tensor-core
// redesign (s8 mma.sync over unpacked bits, Hamming = |q| + |d| - 2<q,d>,
// as K1 runs int8) is later work.
//
// The design, simple and right first:
//  1. One block per row. Each thread holds QPT query tokens' words in
//     registers (zero-padded to W = 1, 4 or 8 words: XOR against zero adds
//     nothing), so one shared-memory read of a doc token feeds QPT x W
//     popcounts. Blocks have 32-256 threads, sized so the query fills them.
//  2. The row's valid tokens stream through shared memory in tiles of
//     kTile tokens, as u32 words (little-endian assembly: a popcount of an
//     XOR does not depend on byte order, so the reference's big-endian
//     words need not be copied). Every thread reads the same token at once
//     (a broadcast).
//  3. The minimum distance per query token stays an integer. Each term is
//     converted once, as 1.0f - (float)ham / (float)dim (a divide, as the
//     reference), and the block sums its terms in a fixed order, so two
//     calls are bit-identical; at a power-of-two dim every partial sum is
//     exact in f32.
//
// Plain C interface (ctypes, morphik_core_tpu_torch/ops/_kernels.py). The
// launcher returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for arguments it does not take.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 256;     // doc tokens per shared-memory tile
constexpr int kMaxThreads = 256;
constexpr int kMaxQpt = 4;     // query tokens a thread holds
constexpr int kMaxBytes = 32;  // packed bytes per token: W <= 8 words

template <int W>
__device__ __forceinline__ void load_words(const uint32_t* p, uint32_t (&w)[W]) {
  if constexpr (W % 4 == 0) {
#pragma unroll
    for (int i = 0; i < W; i += 4) {
      const uint4 v = *reinterpret_cast<const uint4*>(p + i);
      w[i] = v.x, w[i + 1] = v.y, w[i + 2] = v.z, w[i + 3] = v.w;
    }
  } else {
    w[0] = p[0];
  }
}

// word `w` of a token of nb packed bytes at `p`, little-endian, zero past nb
__device__ __forceinline__ uint32_t gather_word(const uint8_t* p, int nb, int w) {
  uint32_t v = 0;
#pragma unroll
  for (int b = 0; b < 4; ++b)
    if (4 * w + b < nb) v |= (uint32_t)p[4 * w + b] << (8 * b);
  return v;
}

template <int W, int QPT>
__global__ void __launch_bounds__(kMaxThreads)
    binary_maxsim_kernel(const uint8_t* __restrict__ q, const uint8_t* __restrict__ docs,
                         const int32_t* __restrict__ ntok, float* __restrict__ out, int nd, int nb,
                         int nq, int dim, int words_aligned) {
  __shared__ __align__(16) uint32_t tile[kTile * W];
  __shared__ float partial[kMaxThreads];
  const int row = blockIdx.x;
  const int t = threadIdx.x;
  const int nthreads = blockDim.x;
  const int n_valid = min(max(ntok[row], 0), nd);
  const uint8_t* base = docs + (size_t)row * nd * nb;
  const float dim_f = (float)dim;
  float acc = 0.0f;

  for (int q0 = 0; q0 < nq; q0 += nthreads * QPT) {
    uint32_t qw[QPT][W];
    int mn[QPT];
#pragma unroll
    for (int j = 0; j < QPT; ++j) {
      const int qi = q0 + t + j * nthreads;
#pragma unroll
      for (int w = 0; w < W; ++w) qw[j][w] = qi < nq ? gather_word(q + (size_t)qi * nb, nb, w) : 0u;
      mn[j] = 0x7fffffff;
    }
    for (int t0 = 0; t0 < n_valid; t0 += kTile) {
      const int n = min(kTile, n_valid - t0);
      __syncthreads();  // the previous tile is consumed
      if (words_aligned) {  // nb == 4 W, 4-byte aligned: one u32 load per word
        const uint32_t* src = reinterpret_cast<const uint32_t*>(base + (size_t)t0 * nb);
        for (int i = t; i < n * W; i += nthreads) tile[i] = src[i];
      } else {
        for (int i = t; i < n * W; i += nthreads)
          tile[i] = gather_word(base + (size_t)(t0 + i / W) * nb, nb, i % W);
      }
      __syncthreads();
#pragma unroll 4
      for (int i = 0; i < n; ++i) {
        uint32_t d[W];
        load_words<W>(tile + i * W, d);
#pragma unroll
        for (int j = 0; j < QPT; ++j) {
          int h = 0;
#pragma unroll
          for (int w = 0; w < W; ++w) h += __popc(qw[j][w] ^ d[w]);
          mn[j] = min(mn[j], h);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < QPT; ++j)
      if (q0 + t + j * nthreads < nq && n_valid > 0) acc += 1.0f - (float)mn[j] / dim_f;
  }
  partial[t] = acc;
  __syncthreads();
  if (t == 0) {  // fixed order: thread by thread
    float s = 0.0f;
    for (int i = 0; i < nthreads; ++i) s += partial[i];
    out[row] = s;
  }
}

template <int W, int QPT>
cudaError_t launch(const uint8_t* q, const uint8_t* docs, const int32_t* ntok, float* out,
                   int n_rows, int nd, int nb, int nq, int dim, int threads, int aligned,
                   cudaStream_t stream) {
  binary_maxsim_kernel<W, QPT><<<n_rows, threads, 0, stream>>>(q, docs, ntok, out, nd, nb, nq, dim,
                                                                aligned);
  return cudaGetLastError();
}

template <int W>
cudaError_t launch_w(int qpt, const uint8_t* q, const uint8_t* docs, const int32_t* ntok, float* out,
                     int n_rows, int nd, int nb, int nq, int dim, int threads, int aligned,
                     cudaStream_t stream) {
  switch (qpt) {
    case 1: return launch<W, 1>(q, docs, ntok, out, n_rows, nd, nb, nq, dim, threads, aligned, stream);
    case 2: return launch<W, 2>(q, docs, ntok, out, n_rows, nd, nb, nq, dim, threads, aligned, stream);
    default: return launch<W, 4>(q, docs, ntok, out, n_rows, nd, nb, nq, dim, threads, aligned, stream);
  }
}

}  // namespace

// The block shape of a call: QPT query tokens a thread (1, 2 or 4, so up
// to 1024 query tokens in one pass over the row), and the fewest warps
// that hold ceil(min(nq, 1024) / QPT) of them. Nine instantiations in all
// (W 1, 4, 8 x QPT 1, 2, 4) keep the build short.
extern "C" int binary_maxsim_plan(int nq, int* qpt, int* threads) {
  int k = 1;
  while (k < kMaxQpt && k * kMaxThreads < nq) k *= 2;
  const int chunk = nq < kMaxThreads * kMaxQpt ? nq : kMaxThreads * kMaxQpt;
  int per = (chunk + k - 1) / k;
  per = per < 1 ? 1 : per;
  *qpt = k;
  *threads = (per + 31) / 32 * 32;
  return 0;
}

extern "C" int binary_maxsim_launch(const void* q, const void* docs, const void* ntok, void* out,
                                    int n_rows, int nd, int nb, int nq, int dim, void* stream) {
  if (nb <= 0 || nb > kMaxBytes || dim <= 0 || n_rows <= 0 || nd < 0 || nq < 0)
    return (int)cudaErrorInvalidValue;
  const int words = (nb + 3) / 4;
  const int w = words <= 1 ? 1 : words <= 4 ? 4 : 8;  // words past nb are zero
  const int aligned = (nb == 4 * w) && ((uintptr_t)docs % 4 == 0);
  int qpt, threads;
  binary_maxsim_plan(nq, &qpt, &threads);
  const uint8_t* qp = (const uint8_t*)q;
  const uint8_t* dp = (const uint8_t*)docs;
  const int32_t* np = (const int32_t*)ntok;
  float* op = (float*)out;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e;
  switch (w) {
    case 1: e = launch_w<1>(qpt, qp, dp, np, op, n_rows, nd, nb, nq, dim, threads, aligned, s); break;
    case 4: e = launch_w<4>(qpt, qp, dp, np, op, n_rows, nd, nb, nq, dim, threads, aligned, s); break;
    default: e = launch_w<8>(qpt, qp, dp, np, op, n_rows, nd, nb, nq, dim, threads, aligned, s); break;
  }
  return (int)e;
}
