// Shared helpers for the hand-written Hopper kernels (sm_90a).
//
// Every entry point has a plain C interface (loaded with ctypes by
// ops/_build.py), launches on the stream it is given, allocates nothing
// and returns cudaGetLastError() so the Python wrapper can raise on a
// refused launch.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

// Tensor-core step D = A B + D of mma.sync m16n8k16 (bf16 operands, fp32
// accumulation). Fragment layout (gid = lane / 4, tig = lane % 4): the
// accumulator c[0..1] is row gid, cols 2*tig + {0,1}; c[2..3] is row
// gid + 8.
__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__host__ __device__ __forceinline__ int pos_mod(int a, int m) {
  int r = a % m;
  return r < 0 ? r + m : r;
}

}  // namespace ivl
