// Shared helpers for the hand-written Hopper kernels (sm_90a).
//
// Every entry point has a plain C interface (loaded with ctypes by
// ops/_build.py), launches on the stream it is given, allocates nothing
// and returns cudaGetLastError() so the Python wrapper can raise on a
// refused launch.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace ivl {

// Large finite "minus infinity" for masked scores: exp(NEG_INF - m) == 0
// and NEG_INF - NEG_INF == 0 (no NaN), as in the Pallas kernels.
constexpr float NEG_INF = -1e30f;

// dtype codes shared with the Python wrappers
constexpr int DTYPE_F32 = 0;
constexpr int DTYPE_BF16 = 1;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// Absolute position of the token in ring slot `slot`, given m0 =
// (n_written - 1) mod cap: the largest n < n_written with n % cap == slot.
// Negative when the slot was never written.
__device__ __forceinline__ int ring_pos(int n_written, int m0, int slot, int cap) {
  int x = m0 - slot;
  if (x < 0) x += cap;
  return n_written - 1 - x;
}

__host__ __device__ __forceinline__ int pos_mod(int a, int m) {
  int r = a % m;
  return r < 0 ? r + m : r;
}

}  // namespace ivl
