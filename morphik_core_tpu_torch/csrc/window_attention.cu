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
// first port (a scalar kernel, since replaced in both dtypes) staged q/k/v
// as f32 by 2-byte loads and fed scalar FMAs from shared memory: 0.77 ms, about
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
// The f32 kernel (window_attention_tf32_kernel) replaces _window_attn_kernel
// for f32 inputs (the dtype of init_random, from_fixture and an f32
// from_checkpoint): S = Q K^T * D^-1/2, a row softmax in f32 (expf, max
// subtracted), P normalised, O = P V accumulated in f32. At the tower's
// shape in f32 it must move 4 x 17,920 x 16 x 80 x 4 B = 367 MB, 109.553 us
// of HBM, and its 5.87 GFLOP take 11.9 us on the tensor cores in TF32
// (17.6 GFLOP in three passes, 35.6 us): bound by bytes. Design:
//  1. Both products on the tensor cores in 3xTF32: every operand x is
//     split once, as it enters registers, into hi = cvt.rna.tf32(x) and
//     lo = cvt.rna.tf32(x - hi); each k8 step of mma.sync m16n8k8 tf32
//     accumulates lo*hi, then hi*lo, then hi*hi, and leaves out lo*lo.
//     A product is then off by about 2^-21 of |x||y|, the f32 sums'
//     own order of error (K3's f32 tolerance is 1e-5); no hi or lo tile is
//     stored.
//  2. One block of 4 warps per (window, head), heads fastest, as in bf16.
//     K, then V, come in by 16-byte cp.async as two commit groups into
//     f32 rows (K at a stride of 16 mod 32 floats, V at 4 mod 8: the
//     fragment reads below are free of bank conflicts), while each warp
//     loads its 16 query rows straight from global memory into registers
//     (16 contiguous bytes a lane). V's load overlaps QK^T and the
//     softmax. 42 KB of shared memory a block at the tower's shape and 119
//     registers a thread, so 4 blocks (16 warps) stay resident on an SM
//     and one block's products overlap the others' loads.
//  2a. The tower's shape (window 64, D 80) runs an exact instantiation in
//     which every bound is a compile-time constant: the unrolled loops
//     carry no branch between tiles, so the compiler interleaves one
//     tile's loads and splits with another's products. Other shapes run
//     the guarded instantiation (3 blocks an SM).
//  3. QK^T: within each pair of k8 steps the features are taken in the
//     order 4tq, 4tq + 1 | 4tq + 2, 4tq + 3 for Q and K alike (a sum over
//     features does not care), so each B fragment pair is one 16-byte
//     shared load. S stays in registers as C fragments; the softmax uses
//     quad shuffles, as in bf16.
//  4. PV: a lane's accumulators hold keys 2tq, 2tq + 1 of each 8-key
//     tile; read as k slots tq, tq + 4 they are PV's A fragment as they
//     stand, with V's B rows taken at keys 2tq, 2tq + 1. Two n-tiles go
//     together (n slot g = features 2g, 2g + 1), so V comes in 8-byte
//     shared loads and each lane ends with 4 adjacent output features of
//     two rows, stored as 16-byte writes straight from the accumulators.
//  Ragged shapes as in bf16: D pads with zeros to a multiple of 16, keys
//  past the window to the next 8 get -inf scores and zero V rows, query
//  rows past it are computed on zeros and not stored; rows that are not
//  16-byte aligned (D % 4 != 0, or a buffer off 16-byte alignment) are
//  copied, loaded and stored element by element. The same six register
//  shapes as bf16 (keys 64 / 128 x D_pad 64 / 80 / 128), each exact and
//  guarded.
//  Measured on one H100 80GB HBM3 (700 W): 189.6 us at the tower's shape,
//  58% of the bound, where f32 F.scaled_dot_product_attention (its
//  memory-efficient kernel; flash takes no f32) takes 372.8 us. What is
//  left is most likely instruction issue rather than bytes: each of a
//  block's four warps splits every K and V value it reads (a split is
//  seven instructions), so the splits outnumber the products.
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

// Row strides of the f32 K and V tiles (floats) for a D padded to dp (a
// multiple of 16). K is read 16 bytes a lane (keys g, features 4tq..4tq+3):
// a quarter warp touches two rows, whose 64-byte runs miss each other's
// banks when the stride is 16 mod 32. V is read 8 bytes a lane (keys 2tq,
// 2tq + 1, features 2g, 2g + 1): a half warp touches four rows of four
// lanes each, whose 32-byte runs are apart when twice the stride is 8 mod
// 16, i.e. the stride is 4 mod 8. Both are multiples of 4, so every row
// starts 16-byte aligned for cp.async.
__host__ __device__ constexpr int tf32_ldk(int dp) { return dp % 32 == 16 ? dp : dp + 16; }
__host__ __device__ constexpr int tf32_ldv(int dp) { return dp + 4; }

// Shared memory of one f32 block: K and V of round8(window) key rows.
__host__ __device__ constexpr int tf32_smem_bytes(int window, int dim) {
  return (int)sizeof(float) * ((window + 7) / 8 * 8) * (tf32_ldk(round16(dim)) + tf32_ldv(round16(dim)));
}

// x rounded to TF32 (10 mantissa bits), to nearest with ties away from zero.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo + O(2^-22 |x|): hi is x in TF32, lo the remainder in TF32.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One k8 step of an f32 product in three TF32 passes: the small terms
// (lo * hi, hi * lo) first, the large one (hi * hi) last; lo * lo is left out.
__device__ __forceinline__ void mma_3xtf32(float (&c)[4], const uint32_t (&ah)[4], const uint32_t (&al)[4],
                                           float b0, float b1) {
  uint32_t bh0, bl0, bh1, bl1;
  split_tf32(b0, bh0, bl0);
  split_tf32(b1, bh1, bl1);
  mma_tf32(c, al, bh0, bh1);
  mma_tf32(c, ah, bl0, bl1);
  mma_tf32(c, ah, bh0, bh1);
}

// The A fragment of one k8 step from four f32 values (rows g, g + 8 at
// k slots tq, tq + 4: a0 = (g, tq), a1 = (g + 8, tq), a2 = (g, tq + 4),
// a3 = (g + 8, tq + 4)), split once into hi and lo.
__device__ __forceinline__ void split_a(float a0, float a1, float a2, float a3, uint32_t (&hi)[4],
                                        uint32_t (&lo)[4]) {
  split_tf32(a0, hi[0], lo[0]);
  split_tf32(a1, hi[1], lo[1]);
  split_tf32(a2, hi[2], lo[2]);
  split_tf32(a3, hi[3], lo[3]);
}

// kKeys: padded window the registers hold (64 or 128); kDim: padded D they
// hold (64, 80 or 128). The runtime shape may be smaller in either.
template <int kKeys, int kDim, bool kExact>
__global__ void __launch_bounds__(kThreads, kKeys * kDim > 64 * 80 ? 2 : kExact ? 4 : 3)
window_attention_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                             const float* __restrict__ v, float* __restrict__ out, int heads, int dim_arg,
                             int window_arg, int vec, float scale) {
  // kExact: the shape is the instantiation's own (window == kKeys, D ==
  // kDim, as on the tower's path), so every bound below is a compile-time
  // constant and the unrolled loops carry no branches between tiles.
  const int dim = kExact ? kDim : dim_arg, window = kExact ? kKeys : window_arg;
  constexpr int kKeyTiles = kKeys / 8;  // n-tiles of S, k-steps of PV
  constexpr int kPairs = kDim / 16;     // pairs of k-steps of QK^T, pairs of n-tiles of O
  const int dp = round16(dim), ldk = tf32_ldk(dp), ldv = tf32_ldv(dp);
  const int rows_kv = (window + 7) / 8 * 8, key_tiles = rows_kv / 8, pairs = dp / 16;

  extern __shared__ __align__(16) float smem_f[];
  float* k_s = smem_f;               // [rows_kv][ldk]
  float* v_s = k_s + rows_kv * ldk;  // [rows_kv][ldv]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int head = blockIdx.x % heads, win = blockIdx.x / heads;
  const size_t row_stride = (size_t)heads * dim;
  const size_t base = (size_t)win * window * row_stride + (size_t)head * dim;

  // Zero the padding (features past D, keys past the window) that the
  // copies below do not write: Q's padding is zero, so K's must be finite,
  // and P is zero there, so V's must be.
  if (dp != dim || rows_kv != window) {
    for (int i = tid; i < rows_kv * dp; i += kThreads) {
      const int r = i / dp, c = i - r * dp;
      if (r >= window || c >= dim) k_s[r * ldk + c] = v_s[r * ldv + c] = 0.f;
    }
  }
  if (vec) {  // D % 4 == 0 and 16-byte aligned tensors: 16-byte chunks, K then V
    const int upr = dim / 4;
    for (int i = tid; i < window * upr; i += kThreads) {
      const int r = i / upr, c = 4 * (i - r * upr);
      cp_async16(k_s + r * ldk + c, k + base + r * row_stride + c);
    }
    cp_async_commit();
    for (int i = tid; i < window * upr; i += kThreads) {
      const int r = i / upr, c = 4 * (i - r * upr);
      cp_async16(v_s + r * ldv + c, v + base + r * row_stride + c);
    }
    cp_async_commit();
  } else {
    for (int i = tid; i < window * dim; i += kThreads) {
      const int r = i / dim, c = i - r * dim;
      const size_t g = base + r * row_stride + c;
      k_s[r * ldk + c] = k[g];
      v_s[r * ldv + c] = v[g];
    }
  }

  const int g = lane >> 2, tq = lane & 3;
  const int n_strips = (window + 15) / 16;
  // The same trip count in every warp, so the block can wait for K and V once.
  for (int it = 0; it * kWarps < n_strips; ++it) {
    const int strip = it * kWarps + warp;
    const bool active = strip < n_strips;
    const int r0 = strip * 16;

    // Q straight from global memory into registers while K and V land:
    // qa[p][h] = Q[r0 + g + 8h][16p + 4tq .. 16p + 4tq + 3], zero past
    // the window and past D. Within a pair of k-steps the features are
    // taken in the order 4tq, 4tq + 1 (step 2p), 4tq + 2, 4tq + 3 (step
    // 2p + 1) for Q and K alike, so each lane reads 16 contiguous bytes.
    float qa[kPairs][2][4];
#pragma unroll
    for (int p = 0; p < kPairs; ++p) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = r0 + g + 8 * h, c = 16 * p + 4 * tq;
        const float* src = q + base + (size_t)r * row_stride + c;
        if (vec) {
          const float4 x = active && p < pairs && r < window && c < dim
                               ? __ldg(reinterpret_cast<const float4*>(src))
                               : make_float4(0.f, 0.f, 0.f, 0.f);
          qa[p][h][0] = x.x, qa[p][h][1] = x.y, qa[p][h][2] = x.z, qa[p][h][3] = x.w;
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            qa[p][h][e] = active && p < pairs && r < window && c + e < dim ? __ldg(src + e) : 0.f;
        }
      }
    }
    if (it == 0) {
      cp_async_wait<1>();  // K has landed (this thread's copies)
      __syncthreads();     // ... and every thread's
    }

    float s[kKeyTiles][4];
    if (active) {
#pragma unroll
      for (int j = 0; j < kKeyTiles; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      // S = Q K^T in 3xTF32 over D, two k8 steps per 16 features
#pragma unroll
      for (int p = 0; p < kPairs; ++p) {
        if (p < pairs) {
          uint32_t ah0[4], al0[4], ah1[4], al1[4];
          split_a(qa[p][0][0], qa[p][1][0], qa[p][0][1], qa[p][1][1], ah0, al0);
          split_a(qa[p][0][2], qa[p][1][2], qa[p][0][3], qa[p][1][3], ah1, al1);
#pragma unroll
          for (int j = 0; j < kKeyTiles; ++j) {
            if (j < key_tiles) {
              const float4 kb = *reinterpret_cast<const float4*>(k_s + (8 * j + g) * ldk + 16 * p + 4 * tq);
              mma_3xtf32(s[j], ah0, al0, kb.x, kb.y);
              mma_3xtf32(s[j], ah1, al1, kb.z, kb.w);
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

    // O = P V in 3xTF32, one k8 step per key tile. A lane's P accumulators
    // hold keys 2tq, 2tq + 1 of the tile: taken as k slots tq, tq + 4 they
    // are the A fragment as they stand, so V's B fragment reads keys 2tq
    // and 2tq + 1. Two n-tiles go together: n slot g is feature 16p + 2g
    // in the first and 16p + 2g + 1 in the second, so each lane reads V in
    // 8-byte pairs and ends holding features 16p + 4tq .. 16p + 4tq + 3.
    float o[kPairs][2][4];
#pragma unroll
    for (int p = 0; p < kPairs; ++p)
#pragma unroll
      for (int h = 0; h < 2; ++h) o[p][h][0] = o[p][h][1] = o[p][h][2] = o[p][h][3] = 0.f;
#pragma unroll
    for (int j = 0; j < kKeyTiles; ++j) {
      if (j < key_tiles) {
        uint32_t ph[4], pl[4];
        split_a(s[j][0], s[j][2], s[j][1], s[j][3], ph, pl);
        const float* v0 = v_s + (8 * j + 2 * tq) * ldv + 2 * g;  // key 8j + 2tq; key + 1 one row on
#pragma unroll
        for (int p = 0; p < kPairs; ++p) {
          if (p < pairs) {
            const float2 x = *reinterpret_cast<const float2*>(v0 + 16 * p);
            const float2 y = *reinterpret_cast<const float2*>(v0 + ldv + 16 * p);
            mma_3xtf32(o[p][0], ph, pl, x.x, y.x);
            mma_3xtf32(o[p][1], ph, pl, x.y, y.y);
          }
        }
      }
    }

    // Epilogue straight from the accumulators: rows g and g + 8, features
    // 16p + 4tq + (0, 1, 2, 3) = (o[p][0][c], o[p][1][c], o[p][0][c + 1],
    // o[p][1][c + 1]) with c = 0 for row g and 2 for row g + 8.
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + g + 8 * h;
      if (r >= window) continue;
      float* dst = out + base + (size_t)r * row_stride;
#pragma unroll
      for (int p = 0; p < kPairs; ++p) {
        const int c = 16 * p + 4 * tq;
        if (p < pairs && c < dim) {
          const float4 x = make_float4(o[p][0][2 * h], o[p][1][2 * h], o[p][0][2 * h + 1], o[p][1][2 * h + 1]);
          if (vec) {
            *reinterpret_cast<float4*>(dst + c) = x;
          } else {
            dst[c] = x.x;
            if (c + 1 < dim) dst[c + 1] = x.y;
            if (c + 2 < dim) dst[c + 2] = x.z;
            if (c + 3 < dim) dst[c + 3] = x.w;
          }
        }
      }
    }
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

template <int kKeys, int kDim, bool kExact>
cudaError_t launch_tf32_as(const void* q, const void* k, const void* v, void* out, int t, int heads,
                           int dim, int window, cudaStream_t stream) {
  const int vec = dim % 4 == 0 && ((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)out) % 16 == 0;
  const long long blocks = (long long)(t / window) * heads;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  window_attention_tf32_kernel<kKeys, kDim, kExact>
      <<<(unsigned)blocks, kThreads, tf32_smem_bytes(window, dim), stream>>>(
          (const float*)q, (const float*)k, (const float*)v, (float*)out, heads, dim, window, vec, scale_of(dim));
  return cudaGetLastError();
}

template <int kKeys, int kDim>
cudaError_t launch_tf32(const void* q, const void* k, const void* v, void* out, int t, int heads,
                        int dim, int window, cudaStream_t stream) {
  return window == kKeys && dim == kDim
             ? launch_tf32_as<kKeys, kDim, true>(q, k, v, out, t, heads, dim, window, stream)
             : launch_tf32_as<kKeys, kDim, false>(q, k, v, out, t, heads, dim, window, stream);
}

template <int kKeys>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* out, int t, int heads,
                       int dim, int window, cudaStream_t stream) {
  const int dp = round16(dim);
  if (dp <= 64) return launch_tf32<kKeys, 64>(q, k, v, out, t, heads, dim, window, stream);
  if (dp <= 80) return launch_tf32<kKeys, 80>(q, k, v, out, t, heads, dim, window, stream);
  return launch_tf32<kKeys, 128>(q, k, v, out, t, heads, dim, window, stream);
}

template <int kKeys, int kDim, bool kExact>
cudaError_t set_tf32_limit() {
  return cudaFuncSetAttribute(window_attention_tf32_kernel<kKeys, kDim, kExact>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize, tf32_smem_bytes(kKeys, kDim));
}

template <int kKeys, int kDim>
cudaError_t set_smem_limit() {
  cudaError_t e = cudaFuncSetAttribute(window_attention_mma_kernel<kKeys, kDim>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, mma_smem_bytes(kKeys, kDim));
  if (e != cudaSuccess) return e;
  e = set_tf32_limit<kKeys, kDim, true>();
  return e != cudaSuccess ? e : set_tf32_limit<kKeys, kDim, false>();
}

// Blocks of `kernel` resident on one SM at this shape, and its registers a thread.
template <typename Kernel>
cudaError_t occupancy(Kernel kernel, int smem, int* blocks_per_sm, int* regs) {
  cudaFuncAttributes attr;
  cudaError_t e = cudaFuncGetAttributes(&attr, kernel);
  if (e != cudaSuccess) return e;
  *regs = attr.numRegs;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, kernel, kThreads, smem);
}

template <int kKeys, int kDim>
cudaError_t occupancy_of(int is_bf16, int dim, int window, int* blocks_per_sm, int* regs) {
  return is_bf16 ? occupancy(window_attention_mma_kernel<kKeys, kDim>, mma_smem_bytes(window, dim), blocks_per_sm, regs)
         : window == kKeys && dim == kDim
             ? occupancy(window_attention_tf32_kernel<kKeys, kDim, true>, tf32_smem_bytes(window, dim), blocks_per_sm,
                         regs)
             : occupancy(window_attention_tf32_kernel<kKeys, kDim, false>, tf32_smem_bytes(window, dim),
                         blocks_per_sm, regs);
}

bool shape_ok(int t, int heads, int dim, int window) {
  return t >= 0 && heads > 0 && heads <= 65535 && dim > 0 && dim <= kMaxDim && window > 0 &&
         window <= kMaxWindow && t % window == 0;
}

}  // namespace

// Raise the dynamic shared-memory limit of every kernel on the current
// device, once a device before its first launch (a launch then needs no
// attribute call).
extern "C" int window_attention_init() {
  const cudaError_t errs[6] = {
      set_smem_limit<64, 64>(),  set_smem_limit<64, 80>(),  set_smem_limit<64, 128>(),
      set_smem_limit<128, 64>(), set_smem_limit<128, 80>(), set_smem_limit<128, 128>(),
  };
  for (cudaError_t e : errs)
    if (e != cudaSuccess) return (int)e;
  return (int)cudaSuccess;
}

extern "C" int window_attention_launch(const void* q, const void* k, const void* v, void* out,
                                       int is_bf16, int t, int heads, int dim, int window,
                                       void* stream) {
  if (!shape_ok(t, heads, dim, window)) return (int)cudaErrorInvalidValue;
  if (t == 0) return (int)cudaSuccess;
  const cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16) {
    return (int)(window <= 64 ? launch_bf16<64>(q, k, v, out, t, heads, dim, window, s)
                              : launch_bf16<128>(q, k, v, out, t, heads, dim, window, s));
  }
  return (int)(window <= 64 ? launch_f32<64>(q, k, v, out, t, heads, dim, window, s)
                            : launch_f32<128>(q, k, v, out, t, heads, dim, window, s));
}

// The resident blocks per SM and the registers a thread of the kernel that
// window_attention_launch would run at this shape (for reports).
extern "C" int window_attention_occupancy(int is_bf16, int dim, int window, int* blocks_per_sm, int* regs) {
  if (!shape_ok(window, 1, dim, window)) return (int)cudaErrorInvalidValue;
  const int dp = round16(dim);
  const bool small = window <= 64;
  if (dp <= 64) return (int)(small ? occupancy_of<64, 64>(is_bf16, dim, window, blocks_per_sm, regs)
                                   : occupancy_of<128, 64>(is_bf16, dim, window, blocks_per_sm, regs));
  if (dp <= 80) return (int)(small ? occupancy_of<64, 80>(is_bf16, dim, window, blocks_per_sm, regs)
                                   : occupancy_of<128, 80>(is_bf16, dim, window, blocks_per_sm, regs));
  return (int)(small ? occupancy_of<64, 128>(is_bf16, dim, window, blocks_per_sm, regs)
                     : occupancy_of<128, 128>(is_bf16, dim, window, blocks_per_sm, regs));
}
