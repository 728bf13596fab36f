// Windowed self-attention kernel for Hopper (sm_90a).
//
//   K3 window_attention_kernel replaces _window_attn_kernel
//      (morphik_core_tpu/ops/window_attention.py:57, launched by
//      _window_attention_pallas :91). For every window of `window`
//      consecutive rows of q/k/v (T, H, D) and every head:
//        S = Q K^T * D^-1/2      f32 dot, f32 scale (as the Pallas kernel's
//                                preferred_element_type=f32; the plain
//                                einsum rounds S to the input dtype first)
//        P = softmax(S) in f32, rounded to the input dtype (`.astype(v.dtype)`)
//        O = P V accumulated in f32, cast to the input dtype.
//
// The TPU kernel folds heads into 128-wide lanes and masks an (R, R) score
// tile to its block diagonal because Mosaic wants (8, 128) tiles. Here one
// thread block owns one (window, head) pair, so no mask exists and no
// score outside a window is computed.
//
// What bounds it on an H100: at the vision tower's shape (T = 17,920,
// H = 16, D = 80, window 64, bf16) the kernel reads and writes 4 x 2.9 MB
// (~4 us of HBM at 3.35 TB/s) and does 2 x 64 x 64 x 80 FMAs per block,
// 4,480 blocks (1.5 GFLOP in all). With scalar f32 FMAs fed from shared
// memory the shared-memory load stream bounds it (about one load per FMA),
// well above the HBM floor. mma.sync / wgmma tiles are later work.
//
// Design: the block stages its window's Q, K and V rows (strided by H * D
// in (T, H, D)) in shared memory as f32, K with a padded row stride so the
// 32 lanes reading 32 different key rows hit 32 banks. Each warp then owns
// kRows query rows at a time: lane l holds the scores of keys l, l + 32,
// ... for those rows, the row max and sum are warp shuffles, the rounded
// probabilities go through a per-warp shared buffer, and lane l
// accumulates output features l, l + 32, ... over the window's keys.
// Limits: D <= 128 and window <= 128 (4 keys and 4 features a lane);
// the launcher rejects anything else.
//
// Plain C interface, built with the flags of morphik_core_tpu_torch/ops/
// _kernels.py and loaded through ctypes; the launcher returns
// cudaGetLastError() (cudaErrorInvalidValue for shapes it does not take).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxWindow = 128;
constexpr int kMaxDim = 128;
constexpr int kPerLane = 4;  // kMaxWindow / 32 keys, kMaxDim / 32 features
constexpr int kRows = 2;     // query rows a warp computes together

template <typename T>
__device__ __forceinline__ float load_f32(const T* p);

template <>
__device__ __forceinline__ float load_f32<float>(const float* p) {
  return __ldg(p);
}

template <>
__device__ __forceinline__ float load_f32<__nv_bfloat16>(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

// Round to T and back (the reference's `probs.astype(v.dtype)`).
template <typename T>
__device__ __forceinline__ float round_to(float x);

template <>
__device__ __forceinline__ float round_to<float>(float x) {
  return x;
}

template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

template <typename T>
__device__ __forceinline__ void store_from_f32(T* p, float x);

template <>
__device__ __forceinline__ void store_from_f32<float>(float* p, float x) {
  *p = x;
}

template <>
__device__ __forceinline__ void store_from_f32<__nv_bfloat16>(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
window_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, T* __restrict__ out, int heads, int dim,
                        int window, float scale) {
  extern __shared__ __align__(16) float smem[];
  const int ldk = dim + 1;               // padded: lanes read different key rows
  float* q_s = smem;                     // [window][dim]
  float* k_s = q_s + window * dim;       // [window][ldk]
  float* v_s = k_s + window * ldk;       // [window][dim]
  float* p_s = v_s + window * dim;       // [kWarps][kRows][window]

  const size_t row_stride = (size_t)heads * dim;
  const size_t base = (size_t)blockIdx.x * window * row_stride + (size_t)blockIdx.y * dim;
  for (int i = threadIdx.x; i < window * dim; i += kThreads) {
    const int r = i / dim;
    const int c = i - r * dim;
    const size_t g = base + (size_t)r * row_stride + c;
    q_s[i] = load_f32(q + g);
    k_s[r * ldk + c] = load_f32(k + g);
    v_s[i] = load_f32(v + g);
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float* p_w = p_s + warp * kRows * window;
  for (int r0 = warp * kRows; r0 < window; r0 += kWarps * kRows) {
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
        if (j < window) p_w[rr * window + j] = round_to<T>(s[rr][jj] / sum);
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
          if (c < dim) store_from_f32(out + base + (size_t)(r0 + rr) * row_stride + c, o[rr][dd]);
        }
      }
    }
    __syncwarp();  // p_w is rewritten by the next rows
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, int t, int heads,
                   int dim, int window, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * ((size_t)window * (3 * dim + 1) + (size_t)kWarps * kRows * window);
  cudaError_t err = cudaFuncSetAttribute(window_attention_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  // the scale of the reference, d ** -0.5 in double, rounded to f32
  const float scale = (float)pow((double)dim, -0.5);
  const dim3 grid(t / window, heads);
  window_attention_kernel<T><<<grid, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, heads, dim, window, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" int window_attention_launch(const void* q, const void* k, const void* v, void* out,
                                       int is_bf16, int t, int heads, int dim, int window,
                                       void* stream) {
  if (t < 0 || heads <= 0 || heads > 65535 || dim <= 0 || dim > kMaxDim || window <= 0 ||
      window > kMaxWindow || t % window != 0)
    return (int)cudaErrorInvalidValue;
  if (t == 0) return (int)cudaSuccess;
  const cudaError_t err =
      is_bf16 ? launch<__nv_bfloat16>(q, k, v, out, t, heads, dim, window, (cudaStream_t)stream)
              : launch<float>(q, k, v, out, t, heads, dim, window, (cudaStream_t)stream);
  return (int)err;
}
