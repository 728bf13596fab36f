// Windowed self-attention kernels for Hopper (sm_90a).
//
//   K3 replaces _window_attn_kernel (morphik_core_tpu/ops/window_attention.py:57,
//      launcher _window_attention_pallas :91, pallas_call :115). For every
//      window of `window` consecutive rows of q/k/v (T, H, D) and every head:
//        S = Q K^T * D^-1/2      f32 dot, f32 scale (the Pallas kernel's
//                                preferred_element_type=f32; the plain
//                                einsum rounds S to the input dtype first)
//        P = softmax(S) in f32, normalised, then rounded to the input dtype
//            (`jax.nn.softmax(s).astype(v.dtype)`)
//        O = P V accumulated in f32, cast to the input dtype.
//
// The TPU kernel folds heads into 128-wide lanes and masks an (R, R) score
// tile of several windows to its block diagonal because Mosaic wants
// (8, 128) tiles. Here one thread block owns one (window, head) pair, so no
// mask exists and no score outside a window is computed.
//
// What bounds it on an H100 (3.35 TB/s HBM, 989 TFLOP/s bf16). At the
// vision tower's shape (T = 17,920, H = 16, D = 80, window 64, bf16) the
// kernel must read q, k, v and write out once: 4 x 17,920 x 16 x 80 x 2 B
// = 183.5 MB, 54.8 us of HBM. It does 4 T window D H = 5.87 GFLOP on the
// tensor cores (5.9 us) and 18.4 M exps. So it is bound by bytes, and what
// matters is many bytes in flight and whole 16-byte loads and stores. The
// first port (the scalar kernel, kept below for f32) staged q/k/v as f32
// by 2-byte loads and fed scalar FMAs from shared memory: 0.77 ms, about
// 7% of the bound. Measured on one H100 80GB HBM3 (700 W), this design
// takes about 80 us at that shape (68% of the bound), where one elementwise
// pass moving the same bytes (torch.addcmul) takes about 61 us: the bytes
// still bound it, and what is left is the time a block computes with no
// load of its own in flight (5 blocks of 94 registers a thread per SM).
//
// Design of the bf16 kernel (window_attention_mma_kernel):
//  1. Grid: one block of 4 warps per (window, head), heads fastest, so
//     neighbouring blocks read neighbouring 160-byte runs of the same rows.
//  2. Staging: the window's Q and K rows, then its V rows, come in by
//     cp.async in 16-byte chunks (one row of a head is D * 2 contiguous
//     bytes at a stride of H * D * 2) as two commit groups, so V's load
//     overlaps QK^T and the softmax. They land in shared memory as bf16
//     with a row stride of D_pad + 8 values (D_pad = D rounded up to 16):
//     the 8 rows an ldmatrix reads then fall on 8 distinct groups of 4
//     banks. 3 x 64 x 176 B = 33 KB a block at the tower's shape, so the
//     registers (S: 32 f32 a lane, O: 40), not shared memory, cap the blocks
//     per SM.
//  3. QK^T: warp w owns query rows 16w..16w+15 (and 16w + 64.. for a
//     window above 64). mma.sync m16n8k16 bf16 -> f32: A fragments by
//     ldmatrix.x4 from Q, B fragments by ldmatrix.x4 from K's rows (K is
//     already the col-major B operand of QK^T).
//  4. Softmax in registers: a lane holds 2 rows x (2 keys of every 8-key
//     tile); the row max and sum are shuffles over the lane quad (xor 1, 2);
//     expf and an IEEE division, as jax.nn.softmax. P is normalised before
//     it is rounded to bf16. The whole row (<= 128 keys) fits, so no online
//     softmax.
//  5. PV: the rounded P accumulators of two adjacent key tiles are, lane for
//     lane, the A fragment of one k16 step (the FlashAttention-2 layout
//     identity), so P never touches shared memory. V's B fragments come by
//     ldmatrix.x4.trans. O accumulates in f32.
//  6. Epilogue: O is rounded to bf16 into the warp's own rows of the Q
//     buffer (no other warp reads them) and leaves in 16-byte stores.
//  Ragged shapes: D pads with zeros to a multiple of 16 in shared memory;
//  keys past `window` (up to the next 16) get -inf scores and zero V rows;
//  query rows past it are computed on zeros and not stored. Rows whose
//  bytes are not 16-byte aligned (D % 8 != 0, or a buffer that starts off
//  16-byte alignment) are copied element by element.
//  Register arrays are sized at compile time: instantiations for windows up
//  to 64 / 128 keys and D_pad up to 64 / 80 / 128.
//
// The f32 kernel (window_attention_f32_kernel) is the first port's scalar
// kernel, kept as it was: the card runs the tower in bf16, so f32 is off the
// main path, and a bf16 hi/lo split of the tensor-core operands would sit at
// the edge of K3's f32 tolerance (1e-5). It stages rows as f32 with a padded K
// stride, lane l holds keys l, l + 32, ... of two query rows, the rounded
// probabilities go through a per-warp shared buffer, and lane l
// accumulates output features l, l + 32, ....
//
// Limits of both: D <= 128 and window <= 128; the launcher rejects anything
// else. The dynamic shared-memory limits are set once, when the library
// loads (window_attention_init), not per launch.
//
// Plain C interface, built with the flags of morphik_core_tpu_torch/ops/
// _kernels.py and loaded through ctypes; the launcher returns
// cudaGetLastError() (cudaErrorInvalidValue for shapes it does not take).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kMaxWindow = 128;
constexpr int kMaxDim = 128;

// ---------------------------------------------------------------- bf16 ----

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src));
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

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
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

// (x, y) rounded to bf16x2; x sits in the low 16 bits (the lower k or n index).
__device__ __forceinline__ uint32_t pack_bf16x2(float x, float y) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  return *reinterpret_cast<const uint32_t*>(&h);
}

__host__ __device__ constexpr int round16(int x) { return (x + 15) / 16 * 16; }

// Shared memory of one block: Q, K, V of `round16(window)` rows each at a
// stride of round16(dim) + 8 bf16 values.
__host__ __device__ constexpr int mma_smem_bytes(int window, int dim) {
  return 3 * round16(window) * (round16(dim) + 8) * (int)sizeof(bf16);
}

// kKeys: padded window the registers hold (64 or 128); kDim: padded D they
// hold (64, 80 or 128). The runtime shape may be smaller in either.
template <int kKeys, int kDim>
__global__ void __launch_bounds__(kThreads)
window_attention_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                            const bf16* __restrict__ v, bf16* __restrict__ out, int heads,
                            int dim, int window, int vec, float scale) {
  constexpr int kKeyTiles = kKeys / 8;  // n-tiles of S
  constexpr int kDimSteps = kDim / 16;  // k-steps of QK^T, pairs of n-tiles of O
  const int kp = round16(window), dp = round16(dim), ld = dp + 8;
  const int key_tiles = kp / 8, dim_steps = dp / 16;

  extern __shared__ __align__(16) unsigned char smem[];
  bf16* q_s = reinterpret_cast<bf16*>(smem);  // [kp][ld], later O
  bf16* k_s = q_s + kp * ld;                  // [kp][ld]
  bf16* v_s = k_s + kp * ld;                  // [kp][ld]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int head = blockIdx.x % heads, win = blockIdx.x / heads;
  const size_t row_stride = (size_t)heads * dim;
  const size_t base = (size_t)win * window * row_stride + (size_t)head * dim;

  // Zero the padding (columns past D, rows past the window) that the copies
  // below do not write: the MMAs read it.
  if (dp != dim || kp != window) {
    const bf16 zero = __float2bfloat16(0.f);
    for (int i = tid; i < kp * dp; i += kThreads) {
      const int r = i / dp, c = i - r * dp;
      if (r >= window || c >= dim) q_s[r * ld + c] = k_s[r * ld + c] = v_s[r * ld + c] = zero;
    }
  }
  if (vec) {  // D % 8 == 0 and 16-byte aligned tensors: 16-byte chunks
    const int upr = dim / 8;
    for (int i = tid; i < window * upr; i += kThreads) {
      const int r = i / upr, c = 8 * (i - r * upr);
      const size_t g = base + r * row_stride + c;
      cp_async16(q_s + r * ld + c, q + g);
      cp_async16(k_s + r * ld + c, k + g);
    }
    cp_async_commit();
    for (int i = tid; i < window * upr; i += kThreads) {
      const int r = i / upr, c = 8 * (i - r * upr);
      cp_async16(v_s + r * ld + c, v + base + r * row_stride + c);
    }
    cp_async_commit();
  } else {
    for (int i = tid; i < window * dim; i += kThreads) {
      const int r = i / dim, c = i - r * dim;
      const size_t g = base + r * row_stride + c;
      q_s[r * ld + c] = q[g];
      k_s[r * ld + c] = k[g];
      v_s[r * ld + c] = v[g];
    }
  }
  cp_async_wait<1>();  // Q and K have landed (this thread's copies)
  __syncthreads();     // ... and every thread's

  const int g = lane >> 2, tq = lane & 3;
  // ldmatrix row addresses: A of Q and B of V (rows lane & 15, 8 columns
  // on for lanes 16..31); B of K (rows 0-7 / 8-15 for lanes 0-15 / 16-31,
  // 8 columns on for lanes 8-15 and 24-31).
  const int a_row = lane & 15, a_col = (lane >> 4) * 8;
  const int b_row = ((lane >> 4) << 3) + (lane & 7), b_col = ((lane >> 3) & 1) * 8;
  const int n_strips = kp / 16;

  // The same trip count in every warp, so the block can wait for V once.
  for (int it = 0; it * kWarps < n_strips; ++it) {
    const int strip = it * kWarps + warp;
    const bool active = strip < n_strips;
    const int r0 = strip * 16;
    float s[kKeyTiles][4];
    if (active) {
#pragma unroll
      for (int j = 0; j < kKeyTiles; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      // S = Q K^T over D in k-steps of 16
#pragma unroll
      for (int ks = 0; ks < kDimSteps; ++ks) {
        if (ks < dim_steps) {
          uint32_t a[4];
          ldsm_x4(a, q_s + (r0 + a_row) * ld + 16 * ks + a_col);
#pragma unroll
          for (int p = 0; p < kKeyTiles / 2; ++p) {
            if (2 * p < key_tiles) {
              uint32_t b[4];
              ldsm_x4(b, k_s + (16 * p + b_row) * ld + 16 * ks + b_col);
              mma(s[2 * p], a, b[0], b[1]);
              mma(s[2 * p + 1], a, b[2], b[3]);
            }
          }
        }
      }
      // softmax of rows g (s[.][0..1]) and g + 8 (s[.][2..3]), f32
      float m0 = -INFINITY, m1 = -INFINITY;
#pragma unroll
      for (int j = 0; j < kKeyTiles; ++j) {
        if (j < key_tiles) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const bool key_ok = 8 * j + 2 * tq + e < window;
            s[j][e] = key_ok ? s[j][e] * scale : -INFINITY;
            s[j][2 + e] = key_ok ? s[j][2 + e] * scale : -INFINITY;
            m0 = fmaxf(m0, s[j][e]);
            m1 = fmaxf(m1, s[j][2 + e]);
          }
        }
      }
#pragma unroll
      for (int o = 1; o < 4; o <<= 1) {
        m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, o));
        m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, o));
      }
      float l0 = 0.f, l1 = 0.f;
#pragma unroll
      for (int j = 0; j < kKeyTiles; ++j) {
        if (j < key_tiles) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            s[j][e] = expf(s[j][e] - m0);
            s[j][2 + e] = expf(s[j][2 + e] - m1);
            l0 += s[j][e];
            l1 += s[j][2 + e];
          }
        }
      }
#pragma unroll
      for (int o = 1; o < 4; o <<= 1) {
        l0 += __shfl_xor_sync(0xffffffffu, l0, o);
        l1 += __shfl_xor_sync(0xffffffffu, l1, o);
      }
#pragma unroll
      for (int j = 0; j < kKeyTiles; ++j) {
        if (j < key_tiles) {
          s[j][0] /= l0;
          s[j][1] /= l0;
          s[j][2] /= l1;
          s[j][3] /= l1;
        }
      }
    }
    if (it == 0) {
      cp_async_wait<0>();  // V has landed
      __syncthreads();
    }
    if (!active) continue;

    // O = P V: the k16 step kk takes the rounded P of key tiles 2kk, 2kk + 1
    float o[2 * kDimSteps][4];
#pragma unroll
    for (int d = 0; d < 2 * kDimSteps; ++d) o[d][0] = o[d][1] = o[d][2] = o[d][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kKeyTiles / 2; ++kk) {
      if (2 * kk < key_tiles) {
        const uint32_t a[4] = {
            pack_bf16x2(s[2 * kk][0], s[2 * kk][1]), pack_bf16x2(s[2 * kk][2], s[2 * kk][3]),
            pack_bf16x2(s[2 * kk + 1][0], s[2 * kk + 1][1]),
            pack_bf16x2(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
        for (int dd = 0; dd < kDimSteps; ++dd) {
          if (dd < dim_steps) {
            uint32_t b[4];
            ldsm_x4_trans(b, v_s + (16 * kk + a_row) * ld + 16 * dd + a_col);
            mma(o[2 * dd], a, b[0], b[1]);
            mma(o[2 * dd + 1], a, b[2], b[3]);
          }
        }
      }
    }

    // Epilogue: bf16 O into this warp's rows of the Q buffer, then whole
    // 16-byte chunks out.
    bf16* o_s = q_s + r0 * ld;
#pragma unroll
    for (int d = 0; d < 2 * kDimSteps; ++d) {
      if (d < 2 * dim_steps) {
        *reinterpret_cast<uint32_t*>(o_s + g * ld + 8 * d + 2 * tq) = pack_bf16x2(o[d][0], o[d][1]);
        *reinterpret_cast<uint32_t*>(o_s + (g + 8) * ld + 8 * d + 2 * tq) = pack_bf16x2(o[d][2], o[d][3]);
      }
    }
    __syncwarp();
    const int rows = min(16, window - r0);
    bf16* dst = out + base + (size_t)r0 * row_stride;
    if (vec) {
      const int upr = dim / 8;
      for (int i = lane; i < rows * upr; i += 32) {
        const int r = i / upr, c = 8 * (i - r * upr);
        *reinterpret_cast<uint4*>(dst + r * row_stride + c) =
            *reinterpret_cast<const uint4*>(o_s + r * ld + c);
      }
    } else {
      for (int i = lane; i < rows * dim; i += 32) {
        const int r = i / dim, c = i - r * dim;
        dst[r * row_stride + c] = o_s[r * ld + c];
      }
    }
  }
}

// ----------------------------------------------------------------- f32 ----

constexpr int kF32Threads = 256;
constexpr int kF32Warps = kF32Threads / 32;
constexpr int kPerLane = 4;  // kMaxWindow / 32 keys, kMaxDim / 32 features
constexpr int kRows = 2;     // query rows a warp computes together

__host__ __device__ constexpr int f32_smem_bytes(int window, int dim) {
  return (int)sizeof(float) * (window * (3 * dim + 1) + kF32Warps * kRows * window);
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__global__ void __launch_bounds__(kF32Threads)
window_attention_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                            const float* __restrict__ v, float* __restrict__ out, int heads,
                            int dim, int window, float scale) {
  extern __shared__ __align__(16) float smem_f[];
  const int ldk = dim + 1;               // padded: lanes read different key rows
  float* q_s = smem_f;                   // [window][dim]
  float* k_s = q_s + window * dim;       // [window][ldk]
  float* v_s = k_s + window * ldk;       // [window][dim]
  float* p_s = v_s + window * dim;       // [kF32Warps][kRows][window]

  const size_t row_stride = (size_t)heads * dim;
  const size_t base = (size_t)blockIdx.x * window * row_stride + (size_t)blockIdx.y * dim;
  for (int i = threadIdx.x; i < window * dim; i += kF32Threads) {
    const int r = i / dim;
    const int c = i - r * dim;
    const size_t g = base + (size_t)r * row_stride + c;
    q_s[i] = __ldg(q + g);
    k_s[r * ldk + c] = __ldg(k + g);
    v_s[i] = __ldg(v + g);
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float* p_w = p_s + warp * kRows * window;
  for (int r0 = warp * kRows; r0 < window; r0 += kF32Warps * kRows) {
    const int nr = min(kRows, window - r0);
    float s[kRows][kPerLane];
#pragma unroll
    for (int rr = 0; rr < kRows; ++rr)
#pragma unroll
      for (int jj = 0; jj < kPerLane; ++jj) s[rr][jj] = 0.f;
    for (int c = 0; c < dim; ++c) {
      float qv[kRows];
#pragma unroll
      for (int rr = 0; rr < kRows; ++rr) qv[rr] = rr < nr ? q_s[(r0 + rr) * dim + c] : 0.f;
#pragma unroll
      for (int jj = 0; jj < kPerLane; ++jj) {
        const int j = lane + 32 * jj;
        if (j < window) {
          const float kv = k_s[j * ldk + c];
#pragma unroll
          for (int rr = 0; rr < kRows; ++rr) s[rr][jj] = fmaf(qv[rr], kv, s[rr][jj]);
        }
      }
    }
#pragma unroll
    for (int rr = 0; rr < kRows; ++rr) {
      float m = -INFINITY;
#pragma unroll
      for (int jj = 0; jj < kPerLane; ++jj) {
        if (lane + 32 * jj < window) {
          s[rr][jj] *= scale;
          m = fmaxf(m, s[rr][jj]);
        }
      }
      m = warp_max(m);
      float sum = 0.f;
#pragma unroll
      for (int jj = 0; jj < kPerLane; ++jj) {
        if (lane + 32 * jj < window) {
          s[rr][jj] = expf(s[rr][jj] - m);
          sum += s[rr][jj];
        }
      }
      sum = warp_sum(sum);
#pragma unroll
      for (int jj = 0; jj < kPerLane; ++jj) {
        const int j = lane + 32 * jj;
        if (j < window) p_w[rr * window + j] = s[rr][jj] / sum;
      }
    }
    __syncwarp();
    float o[kRows][kPerLane];
#pragma unroll
    for (int rr = 0; rr < kRows; ++rr)
#pragma unroll
      for (int dd = 0; dd < kPerLane; ++dd) o[rr][dd] = 0.f;
    for (int j = 0; j < window; ++j) {
      float p[kRows];
#pragma unroll
      for (int rr = 0; rr < kRows; ++rr) p[rr] = p_w[rr * window + j];
#pragma unroll
      for (int dd = 0; dd < kPerLane; ++dd) {
        const int c = lane + 32 * dd;
        if (c < dim) {
          const float vv = v_s[j * dim + c];
#pragma unroll
          for (int rr = 0; rr < kRows; ++rr) o[rr][dd] = fmaf(p[rr], vv, o[rr][dd]);
        }
      }
    }
#pragma unroll
    for (int rr = 0; rr < kRows; ++rr) {
      if (rr < nr) {
#pragma unroll
        for (int dd = 0; dd < kPerLane; ++dd) {
          const int c = lane + 32 * dd;
          if (c < dim) out[base + (size_t)(r0 + rr) * row_stride + c] = o[rr][dd];
        }
      }
    }
    __syncwarp();  // p_w is rewritten by the next rows
  }
}

// ------------------------------------------------------------- launch ----

// the scale of the reference, d ** -0.5 in double, rounded to f32
float scale_of(int dim) { return (float)pow((double)dim, -0.5); }

template <int kKeys, int kDim>
cudaError_t launch_mma(const void* q, const void* k, const void* v, void* out, int t, int heads,
                       int dim, int window, cudaStream_t stream) {
  const int vec = dim % 8 == 0 && ((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)out) % 16 == 0;
  const long long blocks = (long long)(t / window) * heads;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  window_attention_mma_kernel<kKeys, kDim><<<(unsigned)blocks, kThreads, mma_smem_bytes(window, dim), stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)out, heads, dim, window, vec,
      scale_of(dim));
  return cudaGetLastError();
}

template <int kKeys>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* out, int t, int heads,
                        int dim, int window, cudaStream_t stream) {
  const int dp = round16(dim);
  if (dp <= 64) return launch_mma<kKeys, 64>(q, k, v, out, t, heads, dim, window, stream);
  if (dp <= 80) return launch_mma<kKeys, 80>(q, k, v, out, t, heads, dim, window, stream);
  return launch_mma<kKeys, 128>(q, k, v, out, t, heads, dim, window, stream);
}

template <int kKeys, int kDim>
cudaError_t set_smem_limit() {
  return cudaFuncSetAttribute(window_attention_mma_kernel<kKeys, kDim>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              mma_smem_bytes(kKeys, kDim));
}

}  // namespace

// Raise the dynamic shared-memory limit of every kernel once, when the
// library is loaded (a launch then needs no attribute call).
extern "C" int window_attention_init() {
  const cudaError_t errs[7] = {
      set_smem_limit<64, 64>(),  set_smem_limit<64, 80>(),  set_smem_limit<64, 128>(),
      set_smem_limit<128, 64>(), set_smem_limit<128, 80>(), set_smem_limit<128, 128>(),
      cudaFuncSetAttribute(window_attention_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           f32_smem_bytes(kMaxWindow, kMaxDim)),
  };
  for (cudaError_t e : errs)
    if (e != cudaSuccess) return (int)e;
  return (int)cudaSuccess;
}

extern "C" int window_attention_launch(const void* q, const void* k, const void* v, void* out,
                                       int is_bf16, int t, int heads, int dim, int window,
                                       void* stream) {
  if (t < 0 || heads <= 0 || heads > 65535 || dim <= 0 || dim > kMaxDim || window <= 0 ||
      window > kMaxWindow || t % window != 0)
    return (int)cudaErrorInvalidValue;
  if (t == 0) return (int)cudaSuccess;
  const cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16) {
    return (int)(window <= 64 ? launch_bf16<64>(q, k, v, out, t, heads, dim, window, s)
                              : launch_bf16<128>(q, k, v, out, t, heads, dim, window, s));
  }
  window_attention_f32_kernel<<<dim3(t / window, heads), kF32Threads, f32_smem_bytes(window, dim), s>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)out, heads, dim, window,
      scale_of(dim));
  return (int)cudaGetLastError();
}
