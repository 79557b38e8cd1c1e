// Kernel B: one Gated-DeltaNet decode step, in place on the stacked fp32
// state [L, B, H, K, V], in one launch.
//
// Replaces infinitevl_tpu/ops/delta_pallas.py::delta_step_fused_stacked
// (_delta_step_kernel). Per (b, h), from the raw q, k (bf16 or fp32, as
// the layer computed them) and g, beta (fp32):
//   q, k  = l2norm(q), l2norm(k)       (fp32, rounded back to the input
//                                       dtype as JAX's l2norm does), q scaled
//   kh = k^T S,  qh = q^T S            (reductions over K)
//   verr = beta * (v - e^g kh)
//   S'  = e^g S + k (x) verr
//   o   = e^g qh + (q . k) verr        (in v's dtype)
// Every V column is independent, so the grid is (B*H, V / 32) and no
// reduction crosses blocks.
//   Bound on the H100: state bandwidth. At B = 1 one layer's slab is
//   16 x 128 x 256 x 4 B = 2.1 MB, read once and written once: 1.25 us at
//   3.35 TB/s. Design: the whole prologue (both l2norms, the scale, e^g,
//   the casts) runs inside the kernel, so a decode step launches one kernel
//   a layer where the wrapper used to launch about twenty. Each thread
//   issues its eight 16-byte state loads (eight rows, four columns), and
//   its loads of v, g and beta, before anything else, so a block of 128
//   threads keeps its 16 KB of the slab in flight while two warps normalize
//   q and k; the partial sums over K meet through two warp shuffles and one
//   pass through shared memory; the new state is written from the same
//   registers with 16-byte stores. (128 threads a block measured 2.54 us a
//   call against 2.88 us with 256 and 2.56 with 64, B 1 on an H100:
//   scripts/torch_delta_chunk_variants.py.)
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int B_K = 128;                   // key head dim the kernel is written for
constexpr int B_VT = 32;                   // state columns per block
constexpr int B_THREADS = 128;
constexpr int B_C4 = B_VT / 4;             // float4 columns of a block: 8
constexpr int B_RG = B_THREADS / B_C4;     // row groups: 16
constexpr int B_RPT = B_K / B_RG;          // rows per thread: 8
constexpr int B_WARPS = B_THREADS / 32;

// four consecutive elements of a row, widened to fp32
__device__ __forceinline__ void load4(const float* p, float x[4]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  x[0] = a.x, x[1] = a.y, x[2] = a.z, x[3] = a.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float x[4]) {
  const uint2 a = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&a.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&a.y));
  x[0] = lo.x, x[1] = lo.y, x[2] = hi.x, x[3] = hi.y;
}
__device__ __forceinline__ void store4(float* p, const float x[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float x[4]) {
  *reinterpret_cast<uint2*>(p) =
      make_uint2(ivl::pack_bf16(x[0], x[1]), ivl::pack_bf16(x[2], x[3]));
}
// the value as the input dtype holds it
__device__ __forceinline__ float in_dtype(float x, const float*) { return x; }
__device__ __forceinline__ float in_dtype(float x, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(x));
}

template <typename T>
__global__ void __launch_bounds__(B_THREADS)
delta_step_kernel(const T* __restrict__ q,         // [B, H, K] raw
                  const T* __restrict__ k,         // [B, H, K] raw
                  const T* __restrict__ v,         // [B, H, V]
                  const float* __restrict__ g,     // [B, H] log-decay
                  const float* __restrict__ beta,  // [B, H]
                  float* __restrict__ state,       // [L, B, H, K, V]
                  T* __restrict__ o,               // [B, H, V]
                  int BH, int V, int layer, float scale) {
  __shared__ float qs[B_K];
  __shared__ float ks[B_K];
  __shared__ float red[B_WARPS][B_C4][8];

  const int bh = blockIdx.x;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int c4 = tid % B_C4, rg = tid / B_C4;
  const int col = blockIdx.y * B_VT + 4 * c4;

  // the slab first: rows rg + 16 i, columns col..col+3
  float* S = state + ((size_t)layer * BH + bh) * (size_t)B_K * V + col;
  float4 sreg[B_RPT];
#pragma unroll
  for (int i = 0; i < B_RPT; ++i)
    sreg[i] = __ldcs(reinterpret_cast<const float4*>(S + (size_t)(rg + B_RG * i) * V));
  // and what the update needs, so no load waits after the reduction
  float vv[4];
  load4(v + (size_t)bh * V + col, vv);
  const float gl = g[bh], bt = beta[bh];

  // the prologue: warp 0 normalizes q, warp 1 k (lane l holds dims 4l..4l+3)
  if (warp < 2) {
    float x[4];
    load4((warp == 0 ? q : k) + (size_t)bh * B_K + 4 * lane, x);
    const float ss = x[0] * x[0] + x[1] * x[1] + x[2] * x[2] + x[3] * x[3];
    const float r = rsqrtf(ivl::warp_sum(ss) + 1e-6f);
    float* dst = warp == 0 ? qs : ks;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float xn = in_dtype(x[e] * r, q);
      dst[4 * lane + e] = warp == 0 ? xn * scale : xn;
    }
  }
  __syncthreads();

  // partial reductions over this thread's rows, then over the 4 row groups
  // of a warp (shuffles) and the warps (shared memory)
  float part[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) part[e] = 0.f;
#pragma unroll
  for (int i = 0; i < B_RPT; ++i) {
    const int row = rg + B_RG * i;
    const float qr = qs[row], kr = ks[row];
    const float sv[4] = {sreg[i].x, sreg[i].y, sreg[i].z, sreg[i].w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      part[e] += qr * sv[e];
      part[4 + e] += kr * sv[e];
    }
  }
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    part[e] += __shfl_xor_sync(0xffffffffu, part[e], B_C4);
    part[e] += __shfl_xor_sync(0xffffffffu, part[e], 2 * B_C4);
  }
  if (lane < B_C4) {
#pragma unroll
    for (int e = 0; e < 8; ++e) red[warp][c4][e] = part[e];
  }
  // q . k, in every warp (lane l: dims 4l..4l+3)
  float qk = 0.f;
#pragma unroll
  for (int e = 0; e < 4; ++e) qk += qs[4 * lane + e] * ks[4 * lane + e];
  qk = ivl::warp_sum(qk);
  __syncthreads();

  float qh[4], kh[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) qh[e] = kh[e] = 0.f;
#pragma unroll
  for (int w = 0; w < B_WARPS; ++w)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      qh[e] += red[w][c4][e];
      kh[e] += red[w][c4][4 + e];
    }
  const float eg = expf(gl);
  float verr[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) verr[e] = (vv[e] - eg * kh[e]) * bt;
#pragma unroll
  for (int i = 0; i < B_RPT; ++i) {
    const float kr = ks[rg + B_RG * i];
    const float4 sn = make_float4(eg * sreg[i].x + kr * verr[0], eg * sreg[i].y + kr * verr[1],
                                  eg * sreg[i].z + kr * verr[2], eg * sreg[i].w + kr * verr[3]);
    __stcs(reinterpret_cast<float4*>(S + (size_t)(rg + B_RG * i) * V), sn);
  }
  if (rg == 0) {
    float ov[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) ov[e] = eg * qh[e] + qk * verr[e];
    store4(o + (size_t)bh * V + col, ov);
  }
}

template <typename T>
cudaError_t launch_step(const void* q, const void* k, const void* v, const void* g,
                        const void* beta, float* state, void* o, int BH, int V, int layer,
                        float scale, cudaStream_t stream) {
  dim3 grid(BH, V / B_VT);
  delta_step_kernel<T><<<grid, B_THREADS, 0, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const float*)g, (const float*)beta, state,
      (T*)o, BH, V, layer, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns a cudaError_t code (0 = success). q, k, v and o contiguous in
// `dtype` (fp32 or bf16), g and beta fp32 [B, H], the state fp32
// [L, B, H, 128, V] with V a multiple of 32.
int ivl_delta_step(int dtype, const void* q, const void* k, const void* v, const void* g,
                   const void* beta, void* state, void* o, int B, int H, int K, int V,
                   int layer, float scale, void* stream) {
  const int BH = B * H;
  if (K != B_K || V <= 0 || V % B_VT != 0 || BH <= 0 || V / B_VT > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  float* sf = (float*)state;
  if (dtype == ivl::DTYPE_F32)
    return (int)launch_step<float>(q, k, v, g, beta, sf, o, BH, V, layer, scale, st);
  if (dtype == ivl::DTYPE_BF16)
    return (int)launch_step<__nv_bfloat16>(q, k, v, g, beta, sf, o, BH, V, layer, scale, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
