// Warp primitives of the JPEG 2000 block decoders (K5 j2k_t1.cu, K6 j2k_ht.cu), which run one warp a code
// block. Their serial work (one chain of decisions a block) is written as uniform code that every lane runs
// alike, on the same values; what differs between lanes goes through these helpers, each of which starts and
// ends with the warp synchronised, so the lanes see each other's shared-memory writes.
//
// Compiled as host C++ (no __CUDACC__: `g++ -x c++`), the same sources run with one host thread standing for
// the warp: each helper loops over the 32 lanes, and the decoders' `*_emulate` entry points decode blocks on
// the host (tests/test_torch_j2k_warp.py holds them to the plain Python versions).
#pragma once

#include <stdint.h>

#if defined(__CUDACC__)
#include <cuda_runtime.h>
#else
#include <string.h>
#define __device__
#define __global__
#define __constant__
#define __forceinline__ inline
#define __restrict__
#endif

namespace warp {

constexpr uint32_t kAll = 0xFFFFFFFFu;

#if defined(__CUDACC__)

__device__ __forceinline__ int lane() { return threadIdx.x & 31; }
__device__ __forceinline__ void sync() { __syncwarp(); }
__device__ __forceinline__ int ffs(uint32_t x) { return __ffs(x); }
__device__ __forceinline__ int popc(uint32_t x) { return __popc(x); }
__device__ __forceinline__ int clz(uint32_t x) { return __clz(x); }
__device__ __forceinline__ void atomic_or(uint32_t* p, uint32_t v) { atomicOr(p, v); }

// the lanes whose pred(lane) holds
template <class P>
__device__ __forceinline__ uint32_t ballot(P&& pred) {
  return __ballot_sync(kAll, pred(lane()));
}

// f(lane) on every lane
template <class F>
__device__ __forceinline__ void each(F&& f) {
  __syncwarp();
  f(lane());
  __syncwarp();
}

// f(t) for t in [0, n), lane t % 32 taking t
template <class F>
__device__ __forceinline__ void strided(int n, F&& f) {
  __syncwarp();
  for (int t = lane(); t < n; t += 32) f(t);
  __syncwarp();
}

// x = v(lane) on every lane, then f(lane, x, the sum of x over the lanes below); returns the sum over all lanes
template <class V, class F>
__device__ __forceinline__ int scan(V&& v, F&& f) {
  const int l = lane();
  const int x = v(l);
  int s = x;
  for (int d = 1; d < 32; d <<= 1) {
    const int t = __shfl_up_sync(kAll, s, d);
    if (l >= d) s += t;
  }
  f(l, x, s - x);
  const int total = __shfl_sync(kAll, s, 31);
  __syncwarp();
  return total;
}

// 16 bytes from global to shared memory, asynchronously (both 16-byte aligned); copy_wait() waits for them all
__device__ __forceinline__ void copy16(void* smem, const void* gmem) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem));
}
__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_all;\n" ::);
  __syncwarp();
}

#else  // host C++: one thread stands for the warp

inline int ffs(uint32_t x) { return __builtin_ffs((int)x); }
inline int popc(uint32_t x) { return __builtin_popcount(x); }
inline int clz(uint32_t x) { return x ? __builtin_clz(x) : 32; }
inline void sync() {}
inline void atomic_or(uint32_t* p, uint32_t v) { *p |= v; }

template <class P>
inline uint32_t ballot(P&& pred) {
  uint32_t m = 0;
  for (int l = 0; l < 32; ++l)
    if (pred(l)) m |= 1u << l;
  return m;
}

template <class F>
inline void each(F&& f) {
  for (int l = 0; l < 32; ++l) f(l);
}

template <class F>
inline void strided(int n, F&& f) {
  for (int t = 0; t < n; ++t) f(t);
}

template <class V, class F>
inline int scan(V&& v, F&& f) {
  int x[32], s = 0;
  for (int l = 0; l < 32; ++l) x[l] = v(l);
  for (int l = 0; l < 32; ++l) {
    f(l, x[l], s);
    s += x[l];
  }
  return s;
}

inline void copy16(void* smem, const void* gmem) { memcpy(smem, gmem, 16); }
inline void copy_wait() {}

#endif

}  // namespace warp
