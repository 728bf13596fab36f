// MaxSim late-interaction scoring kernels for Hopper (sm_90a).
//
//   score(c) = sum_q max_n <q, d_{c,n}>   over valid doc tokens n
//
// Two kernels, each the Hopper counterpart of one Pallas TPU kernel of
// morphik_core_tpu/ops/maxsim.py:
//
//   K1 maxsim_mma_kernel<int8_t>  replaces _maxsim_kernel_q8 (ops/maxsim.py:248,
//      pallas_call :384). int8 doc tokens x int8 query tokens -> exact
//      int32 dot, then f32(s32) * ds * qs in that order.
//   K2 maxsim_mma_kernel<bf16|float>  replaces _maxsim_kernel (ops/maxsim.py:111,
//      pallas_call :165 and :222). f32 query against bf16 or f32 doc tokens
//      with f32 accumulation.
// Both: masked doc tokens score -1e30, the max over doc tokens at or below
// -5e29 becomes 0, the score is the sum over query tokens. An optional
// int32 row-index vector gathers candidate c from row idx[c] of a larger
// (rows, Np, D) buffer; idx[c] < 0 scores exactly 0 and reads nothing,
// idx[c] >= rows writes NaN.
//
// What bounds them on an H100 (3.35 TB/s HBM). The bytes are few: the
// cache rerank reads 32 x 1024 x 128 doc bytes (4.2 MB int8: 1.3 us; 8.4 MB
// bf16: 2.5 us), the cold bf16 rerank 32 x 768 x 128 x 2 (6.3 MB: 1.9 us),
// the pooled stage ~152 live rows x 24 x 128 int8 (0.5 MB: 0.15 us), a
// 640-token query over 13 x 700 f32 tokens 4.7 MB (1.5 us) but 0.75 G
// multiply-adds per product. The first port (one block per candidate,
// scalar dp4a / FMA loops fed from shared memory, doc tiles re-staged per
// query chunk) ran at 50-100x these floors with 32 candidates on 32 of
// the 132 SMs. Measured on one H100 80GB HBM3 (700 W), this design takes
// 4-10 us per call at the path's short-query shapes plus 2 us for the
// finalize pass: there the bound is latency (two launches and each
// block's chain of query load, first doc tile, MMAs, partial write), not
// bytes. At 631-640 query tokens it takes 12-61 us: tensor-core issue
// with 2-4 blocks (8-16 warps) per SM, about a third of the mma.sync rate.
//
//  1. Grid (candidate, doc-token split, query tile). The host plan
//     (ops/maxsim.py::maxsim_plan) splits each candidate's tokens so a
//     small C still launches about two blocks per SM; large C (the pooled
//     stage) keeps one split. A candidate whose index is -1 (or out of
//     range) exits before loading anything. Each block writes its
//     per-(candidate, split, query token) maxima to an f32 scratch;
//     maxsim_finalize_kernel takes the max over splits, clamps, and sums
//     over query tokens in a fixed order (one block per candidate), so two
//     calls are bit-identical.
//  2. Score tiles on the tensor cores with mma.sync. The query (16 tokens
//     per warp x 32 bytes of D) is the row-major A operand: its fragments
//     are loaded once per block (per D chunk) with ldmatrix and stay in
//     registers. The doc tile (8 tokens x 32 bytes, D-contiguous) is the
//     col-major B operand, loaded with ldmatrix from rows padded by 16
//     bytes (conflict-free). K1: m16n8k32 s8 x s8 -> s32, exact. K2:
//     m16n8k16 bf16 x bf16 -> f32. The warps split a 64-token doc tile
//     and a query tile of up to 64 tokens between them (4 x 1 for a long
//     query, 2 x 2 or 1 x 4 for short ones, so no warp idles at NQ <= 32).
//     A lane's running max covers two query rows; shuffles merge the four
//     lanes of a row, shared memory the warps that share the rows.
//  3. The query tile is staged in shared memory once per block (16-byte
//     loads where aligned). Doc tiles stream through a cp.async ring (16
//     bytes per thread, rows gathered by idx; mask and ds by 4-byte
//     cp.async), four stages for int8 and two for bf16 / f32 (a deeper
//     ring cuts K2's blocks per SM from three to two: measured slower).
//     The first tiles are in flight while the query loads. D larger than
//     128 streams in chunks of 128 values; D is padded with zeros to the
//     MMA depth.
//  4. The dynamic shared-memory limit is set once when the library loads
//     (maxsim_init), not per launch.
//
// Numerics of K2. bf16 docs are exact in bf16; the f32 query is split into
// q_hi = bf16(q) and q_lo = bf16(q - q_hi) and each tile runs two MMAs
// (q_hi d + q_lo d) into one f32 accumulator: every product is exact in
// f32 and |q - q_hi - q_lo| <= 2^-17 |q|, so a dot is off by about 2^-17
// sum|d||q| plus f32 accumulation (rounding the query to bf16 once would
// be 2^-9: 2e-3 on a 29-token query at the cache shape, beyond K2's
// atol). f32 docs are split the same way and run three MMAs
// (q_hi d_hi + q_lo d_hi + q_hi d_lo); the dropped q_lo d_lo term is below
// 2^-16 sum|d||q|. The f32 docs are split in registers after an 8-byte
// shared load (ldmatrix moves 16-bit elements). A register-tiled FFMA path
// would need about three times the instruction issue of the three MMAs
// for the same exactness at the long-query shape.
//
// Plain C interface, built with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared -Xcompiler -fPIC
// and loaded through ctypes (morphik_core_tpu_torch/ops/_kernels.py). Each
// launcher returns cudaGetLastError() after each launch (or
// cudaErrorInvalidValue for arguments it does not take); the caller raises
// when it is not 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kTokTile = 64;           // doc tokens per stage
constexpr int kTileNB = kTokTile / 8;  // n-blocks of 8 tokens per doc tile
constexpr int kMaxQTile = 64;          // query tokens per block: 4 m-blocks of 16
constexpr int kMaxChunk = 128;         // D values per stage
constexpr float kNegInf = -1.0e30f;    // NEG_INF of ops/maxsim.py
constexpr float kClamp = -5.0e29f;     // NEG_INF * 0.5: fully masked -> 0
constexpr size_t kMaxSmem = 227 * 1024;

struct Args {
  const void* q;         // K1: int8 (nq, dim); K2: f32 (nq, dim)
  const float* qs;       // K1: (nq,) query scales
  const void* docs;      // (n_rows, np, dim)
  const float* ds;       // K1: (n_rows, np) doc-token scales
  const float* mask;     // (n_rows, np)
  const int32_t* idx;    // (n_cand,) or null
  float* part;           // (n_cand, n_splits, nq) per-split maxima
  int n_rows, np, nq, dim;
  int q_tile, tok_per_split, n_splits;
  int chunk, n_chunks;   // D streams in n_chunks chunks of `chunk` values
  int vec;               // doc rows are 16-byte aligned: cp.async 16
  int qvec;              // query rows take 16-byte loads
};

// Ring depth. K1's int8 stages are small: four of them still let four
// blocks share an SM. A K2 stage is 2-4x larger, and a deeper ring would
// cut the blocks per SM from three to two (measured slower on an H100).
template <typename DocT>
constexpr int kStagesOf = sizeof(DocT) == 1 ? 4 : 2;

// Shared-memory layout, in bytes, of one block.
template <typename DocT>
struct Layout {
  static constexpr bool kQ8 = std::is_same<DocT, int8_t>::value;
  int q_stride, d_stride, q_bytes, d_bytes, total;
  __host__ __device__ Layout(int q_tile, int chunk, int n_chunks) {
    const int dq = chunk * n_chunks;  // padded query width (values)
    q_stride = (kQ8 ? dq : 2 * dq) + 16;                  // int8, or bf16 hi / lo
    d_stride = chunk * (int)sizeof(DocT) + (sizeof(DocT) == 4 ? 32 : 16);
    q_bytes = (kQ8 ? 1 : 2) * q_tile * q_stride;
    d_bytes = kStagesOf<DocT> * kTokTile * d_stride;
    // + mask[stages][tok], ds[stages][tok], qs[qtile], red[warps][qtile]
    total = q_bytes + d_bytes +
            (int)sizeof(float) * (2 * kStagesOf<DocT> * kTokTile + kMaxQTile + kWarps * kMaxQTile);
  }
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_u32(dst)), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma(int (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// (x, y) -> bf16x2 hi = bf16(x, y) and lo = bf16((x, y) - hi); the lower
// k index sits in the low 16 bits, as mma.sync reads it.
__device__ __forceinline__ void split_bf16x2(float x, float y, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x - hf.x, y - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// Block (c, split, query tile): per-query-token max over the split's doc
// tokens, written to a.part. DocT = int8_t is K1, bf16 / float is K2.
template <typename DocT>
__global__ void __launch_bounds__(kThreads) maxsim_mma_kernel(const Args a) {
  constexpr bool kQ8 = std::is_same<DocT, int8_t>::value;
  constexpr bool kF32 = std::is_same<DocT, float>::value;
  using Acc = typename std::conditional<kQ8, int, float>::type;
  constexpr int kEsz = sizeof(DocT);
  constexpr int kDepth = kQ8 ? 32 : 16;  // MMA depth in values
  constexpr int kKSteps = kMaxChunk / kDepth;

  const int c = blockIdx.x;
  const int row = a.idx ? a.idx[c] : c;
  if (row < 0 || row >= a.n_rows) return;  // the finalize pass writes 0 or NaN
  const int split = blockIdx.y;
  const int q0 = blockIdx.z * a.q_tile;
  const int nqt = min(a.q_tile, a.nq - q0);
  const int n_begin = split * a.tok_per_split;
  const int n_end = min(a.np, n_begin + a.tok_per_split);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  constexpr int kStages = kStagesOf<DocT>;
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout<DocT> L(a.q_tile, a.chunk, a.n_chunks);
  unsigned char* q_hi = smem;                                      // [q_tile][q_stride]
  unsigned char* q_lo = smem + (kQ8 ? 0 : a.q_tile * L.q_stride);  // K2: [q_tile][q_stride]
  unsigned char* d_s = smem + L.q_bytes;                           // [kStages][kTokTile][d_stride]
  float* msk_s = reinterpret_cast<float*>(d_s + L.d_bytes);        // [kStages][kTokTile]
  float* ds_s = msk_s + kStages * kTokTile;                        // [kStages][kTokTile]
  float* qs_s = ds_s + kStages * kTokTile;                         // [kMaxQTile]
  float* red_s = qs_s + kMaxQTile;                                 // [kWarps][kMaxQTile]

  // Float docs whose D is not a multiple of the chunk leave chunk columns
  // that no copy writes; zero them before any copy, since the MMA reads
  // them (times a zero query value) and uninitialised bits may be NaN.
  if (!kQ8 && a.dim % a.chunk) {
    const int c0 = (a.dim % a.chunk) * kEsz, w = a.chunk * kEsz - c0;
    for (int i = tid; i < kStages * kTokTile * w; i += kThreads)
      d_s[(i / w) * L.d_stride + c0 + i % w] = 0;
    __syncthreads();
  }

  const size_t row_bytes = (size_t)a.dim * kEsz;
  const unsigned char* doc_row =
      static_cast<const unsigned char*>(a.docs) + (size_t)row * a.np * row_bytes;
  const float* mask_row = a.mask + (size_t)row * a.np;
  const float* ds_row = kQ8 ? a.ds + (size_t)row * a.np : nullptr;
  const int n_tiles = (max(n_end - n_begin, 0) + kTokTile - 1) / kTokTile;
  const int steps = n_tiles * a.n_chunks;

  // Stage step = (doc tile, D chunk), with the tile's mask (and ds), into
  // ring slot step % kStages.
  auto issue = [&](int step) {
    const int t = step / a.n_chunks, kc = step - t * a.n_chunks;
    const int slot = step % kStages;
    const int tok0 = n_begin + t * kTokTile;
    const int rows = min(kTokTile, n_end - tok0);
    unsigned char* dst = d_s + slot * kTokTile * L.d_stride;
    const unsigned char* src = doc_row + (size_t)tok0 * row_bytes + (size_t)kc * a.chunk * kEsz;
    const int cvals = min(a.chunk, a.dim - kc * a.chunk);
    if (a.vec) {
      const int units = cvals * kEsz / 16;
      for (int u = tid; u < rows * units; u += kThreads) {
        const int r = u / units, v = u - r * units;
        cp_async16(dst + r * L.d_stride + 16 * v, src + r * row_bytes + 16 * v);
      }
    } else {
      for (int e = tid; e < rows * cvals; e += kThreads) {
        const int r = e / cvals, k = e - r * cvals;
        reinterpret_cast<DocT*>(dst + r * L.d_stride)[k] =
            reinterpret_cast<const DocT*>(src + r * row_bytes)[k];
      }
    }
    for (int r = tid; r < kTokTile; r += kThreads) {
      if (r < rows) {
        cp_async4(msk_s + slot * kTokTile + r, mask_row + tok0 + r);
        if (kQ8) cp_async4(ds_s + slot * kTokTile + r, ds_row + tok0 + r);
      } else {
        msk_s[slot * kTokTile + r] = 0.f;
      }
    }
  };

  // The first doc tiles are in flight while the query tile loads.
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < steps) issue(st);
    cp_async_commit();
  }

  // The query tile, zero-padded to q_tile rows and dq values.
  const int dq = a.chunk * a.n_chunks;
  if constexpr (kQ8) {
    const int8_t* q8 = static_cast<const int8_t*>(a.q);
    if (a.qvec) {  // dim % 16 == 0
      const int upr = dq / 16;
#pragma unroll 4
      for (int i = tid; i < a.q_tile * upr; i += kThreads) {
        const int r = i / upr, k = 16 * (i - r * upr);
        uint4 v = make_uint4(0, 0, 0, 0);
        if (r < nqt && k < a.dim) v = *reinterpret_cast<const uint4*>(q8 + (size_t)(q0 + r) * a.dim + k);
        *reinterpret_cast<uint4*>(q_hi + r * L.q_stride + k) = v;
      }
    } else {  // dim % 4 == 0
      const int wpr = dq / 4;
      for (int i = tid; i < a.q_tile * wpr; i += kThreads) {
        const int r = i / wpr, k = 4 * (i - r * wpr);
        uint32_t v = 0;
        if (r < nqt && k < a.dim) {
          const int8_t* src = q8 + (size_t)(q0 + r) * a.dim + k;
          v = (uint32_t)(uint8_t)src[0] | (uint32_t)(uint8_t)src[1] << 8 |
              (uint32_t)(uint8_t)src[2] << 16 | (uint32_t)(uint8_t)src[3] << 24;
        }
        *reinterpret_cast<uint32_t*>(q_hi + r * L.q_stride + k) = v;
      }
    }
    for (int r = tid; r < kMaxQTile; r += kThreads) qs_s[r] = r < nqt ? a.qs[q0 + r] : 0.f;
  } else {
    const float* qf = static_cast<const float*>(a.q);
    if (a.qvec) {  // dim % 4 == 0
      const int upr = dq / 4;
#pragma unroll 4
      for (int i = tid; i < a.q_tile * upr; i += kThreads) {
        const int r = i / upr, k = 4 * (i - r * upr);
        float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
        if (r < nqt && k < a.dim) x = *reinterpret_cast<const float4*>(qf + (size_t)(q0 + r) * a.dim + k);
        uint2 hi, lo;
        split_bf16x2(x.x, x.y, hi.x, lo.x);
        split_bf16x2(x.z, x.w, hi.y, lo.y);
        *reinterpret_cast<uint2*>(q_hi + r * L.q_stride + 2 * k) = hi;
        *reinterpret_cast<uint2*>(q_lo + r * L.q_stride + 2 * k) = lo;
      }
    } else {
      const int ppr = dq / 2;
      for (int i = tid; i < a.q_tile * ppr; i += kThreads) {
        const int r = i / ppr, k = 2 * (i - r * ppr);
        float x = 0.f, y = 0.f;
        if (r < nqt) {
          const float* src = qf + (size_t)(q0 + r) * a.dim;
          if (k < a.dim) x = src[k];
          if (k + 1 < a.dim) y = src[k + 1];
        }
        uint32_t hi, lo;
        split_bf16x2(x, y, hi, lo);
        *reinterpret_cast<uint32_t*>(q_hi + r * L.q_stride + 2 * k) = hi;
        *reinterpret_cast<uint32_t*>(q_lo + r * L.q_stride + 2 * k) = lo;
      }
    }
  }

  // Warp layout: wq_n warps along the query tile (16 query rows each, the
  // MMA's A operand, kept in registers), 4 / wq_n along the doc tile (nbw
  // n-blocks of 8 tokens each, the B operand, from shared memory).
  const int wq_n = nqt > 32 ? 4 : nqt > 16 ? 2 : 1;
  const int wq = warp % wq_n, nbw = kTileNB * wq_n / kWarps;
  const int nb0 = (warp / wq_n) * nbw;
  const bool q_active = wq * 16 < nqt;
  const int g = lane >> 2, tq = lane & 3;
  // ldmatrix row addresses: A (16 query rows x 32 bytes), B (16 tokens x 32 bytes)
  const int a_off = (wq * 16 + (lane & 15)) * L.q_stride + (lane >> 4) * 16;
  const int b_off = (((lane >> 4) << 3) + (lane & 7)) * L.d_stride + ((lane >> 3) & 1) * 16;
  const int ksteps = a.chunk / kDepth;

  uint32_t qa[kKSteps][4], ql[kKSteps][4];  // query fragments (K2: bf16 hi, lo) of one chunk
  Acc acc[kTileNB][4];
  float run0 = kNegInf, run1 = kNegInf;  // running max of query rows g and g + 8
#pragma unroll
  for (int j = 0; j < kTileNB; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0;

  for (int i = 0; i < steps; ++i) {
    cp_async_wait<kStages - 2>();  // step i has landed (this thread's copies)
    __syncthreads();               // ... every thread's; slot (i - 1) % kStages is free
    if (i + kStages - 1 < steps) issue(i + kStages - 1);
    cp_async_commit();

    const int t = i / a.n_chunks, kc = i - t * a.n_chunks;
    const int slot = i % kStages;
    const int rows = min(kTokTile, n_end - (n_begin + t * kTokTile));
    if (i == 0 || a.n_chunks > 1) {  // the query is resident: its fragments change only with the chunk
      const int qk = a_off + kc * a.chunk * (kQ8 ? 1 : 2);
#pragma unroll
      for (int ks = 0; ks < kKSteps; ++ks) {
        if (ks < ksteps) {
          ldsm_x4(qa[ks], q_hi + qk + ks * 32);
          if constexpr (!kQ8) ldsm_x4(ql[ks], q_lo + qk + ks * 32);
        }
      }
    }
    if (q_active && nb0 * 8 < rows) {
      const unsigned char* dt = d_s + slot * kTokTile * L.d_stride;
#pragma unroll
      for (int ks = 0; ks < kKSteps; ++ks) {
        if (ks < ksteps) {
#pragma unroll
          for (int p = 0; p < kTileNB / 2; ++p) {
            if (2 * p < nbw) {  // n-blocks 2p, 2p + 1 of the warp: tokens (nb0 + 2p) * 8 + [0, 16)
              const int tok = (nb0 + 2 * p) * 8;
              uint32_t bh[4], bl[4];
              if constexpr (kF32) {
                const float* t0 = reinterpret_cast<const float*>(dt + (tok + g) * L.d_stride) + ks * 16 + 2 * tq;
                const float* t1 = reinterpret_cast<const float*>(dt + (tok + 8 + g) * L.d_stride) + ks * 16 + 2 * tq;
                const float2 x0 = *reinterpret_cast<const float2*>(t0);
                const float2 x1 = *reinterpret_cast<const float2*>(t0 + 8);
                const float2 x2 = *reinterpret_cast<const float2*>(t1);
                const float2 x3 = *reinterpret_cast<const float2*>(t1 + 8);
                split_bf16x2(x0.x, x0.y, bh[0], bl[0]);
                split_bf16x2(x1.x, x1.y, bh[1], bl[1]);
                split_bf16x2(x2.x, x2.y, bh[2], bl[2]);
                split_bf16x2(x3.x, x3.y, bh[3], bl[3]);
              } else {
                ldsm_x4(bh, dt + tok * L.d_stride + b_off + ks * 32);
              }
              mma(acc[2 * p], qa[ks], bh[0], bh[1]);
              mma(acc[2 * p + 1], qa[ks], bh[2], bh[3]);
              if constexpr (!kQ8) {
                mma(acc[2 * p], ql[ks], bh[0], bh[1]);
                mma(acc[2 * p + 1], ql[ks], bh[2], bh[3]);
                if constexpr (kF32) {
                  mma(acc[2 * p], qa[ks], bl[0], bl[1]);
                  mma(acc[2 * p + 1], qa[ks], bl[2], bl[3]);
                }
              }
            }
          }
        }
      }
      if (kc == a.n_chunks - 1) {  // epilogue of the tile: scales, mask, running max
        const float* mk = msk_s + slot * kTokTile;
        const float* dk = ds_s + slot * kTokTile;
        const float s0 = kQ8 ? qs_s[wq * 16 + g] : 1.f, s1 = kQ8 ? qs_s[wq * 16 + g + 8] : 1.f;
#pragma unroll
        for (int j = 0; j < kTileNB; ++j) {
          if (j < nbw) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int col = (nb0 + j) * 8 + 2 * tq + e;  // doc token within the tile
              const bool valid = mk[col] > 0.f;
              float x0, x1;
              if constexpr (kQ8) {
                const float d = dk[col];
                x0 = (float)acc[j][e] * d * s0;
                x1 = (float)acc[j][2 + e] * d * s1;
              } else {
                x0 = acc[j][e];
                x1 = acc[j][2 + e];
              }
              run0 = fmaxf(run0, valid ? x0 : kNegInf);
              run1 = fmaxf(run1, valid ? x1 : kNegInf);
            }
          }
          acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0;
        }
      }
    }
  }

  // Max over the lanes of a row (the tokens of each n-block), then over
  // the warps that share the query rows.
#pragma unroll
  for (int o = 1; o < 4; o <<= 1) {
    run0 = fmaxf(run0, __shfl_xor_sync(0xffffffffu, run0, o));
    run1 = fmaxf(run1, __shfl_xor_sync(0xffffffffu, run1, o));
  }
  if (tq == 0) {
    red_s[(warp / wq_n) * kMaxQTile + wq * 16 + g] = run0;
    red_s[(warp / wq_n) * kMaxQTile + wq * 16 + g + 8] = run1;
  }
  __syncthreads();
  if (tid < nqt) {
    float m = red_s[tid];
    for (int w = 1; w < kWarps / wq_n; ++w) m = fmaxf(m, red_s[w * kMaxQTile + tid]);
    a.part[((size_t)c * a.n_splits + split) * a.nq + q0 + tid] = m;
  }
}

// One block per candidate: max over the splits, clamp, sum over query
// tokens in a fixed order (deterministic).
__global__ void __launch_bounds__(kThreads)
maxsim_finalize_kernel(const float* __restrict__ part, const int32_t* __restrict__ idx,
                       float* __restrict__ out, int n_rows, int n_splits, int nq) {
  __shared__ float warp_sum[kWarps];
  const int c = blockIdx.x;
  const int row = idx ? idx[c] : c;
  if (row < 0 || row >= n_rows) {
    if (threadIdx.x == 0) out[c] = row < 0 ? 0.f : __int_as_float(0x7fc00000);  // NaN: bad row index
    return;
  }
  const float* p = part + (size_t)c * n_splits * nq;
  float sum = 0.f;
#pragma unroll 4
  for (int q = threadIdx.x; q < nq; q += kThreads) {
    float m = p[q];
    for (int s = 1; s < n_splits; ++s) m = fmaxf(m, p[(size_t)s * nq + q]);
    sum += m <= kClamp ? 0.f : m;
  }
  for (int o = 16; o > 0; o >>= 1) sum += __shfl_down_sync(0xffffffffu, sum, o);
  if ((threadIdx.x & 31) == 0) warp_sum[threadIdx.x >> 5] = sum;
  __syncthreads();
  if (threadIdx.x == 0) {
    float total = warp_sum[0];
    for (int w = 1; w < kWarps; ++w) total += warp_sum[w];
    out[c] = total;
  }
}

template <typename DocT>
int launch(Args a, float* out, int n_cand, cudaStream_t stream) {
  constexpr int kDepth = std::is_same<DocT, int8_t>::value ? 32 : 16;
  if (n_cand < 0 || a.n_rows < 0 || a.np < 0 || a.nq < 0 || a.dim <= 0 || a.n_splits < 1 ||
      a.tok_per_split < 1 || (a.q_tile != 16 && a.q_tile != 32 && a.q_tile != 64))
    return (int)cudaErrorInvalidValue;
  // the splits cover the doc tokens exactly once
  if ((long long)a.n_splits * a.tok_per_split < a.np ||
      (long long)(a.n_splits - 1) * a.tok_per_split >= (a.np > 0 ? a.np : 1))
    return (int)cudaErrorInvalidValue;
  const int n_qt = (a.nq + a.q_tile - 1) / a.q_tile;
  if (a.n_splits > 65535 || n_qt > 65535) return (int)cudaErrorInvalidValue;
  if (n_cand == 0) return (int)cudaSuccess;
  const int padded = (a.dim + kDepth - 1) / kDepth * kDepth;
  a.chunk = padded < kMaxChunk ? padded : kMaxChunk;
  a.n_chunks = (a.dim + a.chunk - 1) / a.chunk;
  a.vec = reinterpret_cast<uintptr_t>(a.docs) % 16 == 0 && (a.dim * sizeof(DocT)) % 16 == 0;
  a.qvec = reinterpret_cast<uintptr_t>(a.q) % 16 == 0 && a.dim % (kDepth == 32 ? 16 : 4) == 0;
  const Layout<DocT> L(a.q_tile, a.chunk, a.n_chunks);
  if ((size_t)L.total > kMaxSmem) return (int)cudaErrorInvalidValue;
  if (n_qt > 0) {
    maxsim_mma_kernel<DocT><<<dim3(n_cand, a.n_splits, n_qt), kThreads, L.total, stream>>>(a);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  maxsim_finalize_kernel<<<n_cand, kThreads, 0, stream>>>(a.part, a.idx, out, a.n_rows,
                                                          a.n_splits, a.nq);
  return (int)cudaGetLastError();
}

}  // namespace

// Raise the dynamic shared-memory limit of every instantiation once, when
// the library is loaded (a launch then needs no attribute call).
extern "C" int maxsim_init() {
  const cudaError_t errs[3] = {
      cudaFuncSetAttribute(maxsim_mma_kernel<int8_t>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)kMaxSmem),
      cudaFuncSetAttribute(maxsim_mma_kernel<__nv_bfloat16>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kMaxSmem),
      cudaFuncSetAttribute(maxsim_mma_kernel<float>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)kMaxSmem),
  };
  for (cudaError_t e : errs)
    if (e != cudaSuccess) return (int)e;
  return (int)cudaSuccess;
}

extern "C" int maxsim_q8_launch(const void* q8, const void* qs, const void* d8, const void* ds,
                                const void* mask, const void* idx, void* part, void* out,
                                int n_cand, int n_rows, int np, int nq, int dim, int q_tile,
                                int tok_per_split, int n_splits, void* stream) {
  if (dim % 4 != 0) return (int)cudaErrorInvalidValue;
  Args a{q8, (const float*)qs, d8, (const float*)ds, (const float*)mask, (const int32_t*)idx,
         (float*)part, n_rows, np, nq, dim, q_tile, tok_per_split, n_splits, 0, 0, 0, 0};
  return launch<int8_t>(a, (float*)out, n_cand, (cudaStream_t)stream);
}

extern "C" int maxsim_launch(const void* q, const void* docs, int docs_bf16, const void* mask,
                             const void* idx, void* part, void* out, int n_cand, int n_rows,
                             int np, int nq, int dim, int q_tile, int tok_per_split, int n_splits,
                             void* stream) {
  Args a{q, nullptr, docs, nullptr, (const float*)mask, (const int32_t*)idx, (float*)part,
         n_rows, np, nq, dim, q_tile, tok_per_split, n_splits, 0, 0, 0, 0};
  if (docs_bf16) return launch<__nv_bfloat16>(a, (float*)out, n_cand, (cudaStream_t)stream);
  return launch<float>(a, (float*)out, n_cand, (cudaStream_t)stream);
}
