// Kernel B: one Gated-DeltaNet decode step, in place on the stacked fp32
// state [L, B, H, K, V].
//
// Replaces infinitevl_tpu/ops/delta_pallas.py::delta_step_fused_stacked
// (_delta_step_kernel). Per (b, h), with q, k already l2-normed (q scaled)
// and eg = exp(g) computed by the wrapper:
//   kh = k^T S,  qh = q^T S            (reductions over K)
//   verr = beta * (v - eg * kh)
//   S'  = eg * S + k (x) verr
//   o   = eg * qh + (q . k) * verr
// Every V column is independent, so the grid is (B*H, V / 32) and no
// reduction crosses blocks.
//   Bound on the H100: state bandwidth. At B = 1 the 27-layer state is
//   27 x 16 x 128 x 256 x 4 B = 56.6 MB, read once and written once per
//   decoded token. Design: each thread holds K/8 state values of one
//   column in registers, so the slab is read once, reduced across the 8
//   row groups through shared memory, and written once; a warp touches 32
//   consecutive floats of a row (128-byte coalesced).
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int B_VT = 32;  // state columns per block (one warp wide)
constexpr int B_KG = 8;   // row groups per block (one warp each)
constexpr int B_THREADS = B_VT * B_KG;

template <int RPT>  // rows per thread; K = RPT * B_KG
__global__ void __launch_bounds__(B_THREADS)
delta_step_kernel(const float* __restrict__ q,     // [B, H, K]
                  const float* __restrict__ k,     // [B, H, K]
                  const float* __restrict__ v,     // [B, H, V]
                  const float* __restrict__ eg,    // [B, H]
                  const float* __restrict__ beta,  // [B, H]
                  float* __restrict__ state,       // [L, B, H, K, V]
                  float* __restrict__ o,           // [B, H, V]
                  int BH, int V, int layer) {
  constexpr int K = RPT * B_KG;
  __shared__ float qs[K];
  __shared__ float ks[K];
  __shared__ float red_q[B_KG][B_VT];
  __shared__ float red_k[B_KG][B_VT];

  const int bh = blockIdx.x;
  const int col = threadIdx.x % B_VT;
  const int kg = threadIdx.x / B_VT;
  const int vi = blockIdx.y * B_VT + col;
  const bool ok = vi < V;

  for (int i = threadIdx.x; i < K; i += B_THREADS) {
    qs[i] = q[(size_t)bh * K + i];
    ks[i] = k[(size_t)bh * K + i];
  }
  __syncthreads();

  float* S = state + ((size_t)layer * BH + bh) * (size_t)K * V;
  float sreg[RPT];
  float pq = 0.f, pk = 0.f;
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    const int kr = kg * RPT + r;
    const float sv = ok ? S[(size_t)kr * V + vi] : 0.f;
    sreg[r] = sv;
    pq += qs[kr] * sv;
    pk += ks[kr] * sv;
  }
  red_q[kg][col] = pq;
  red_k[kg][col] = pk;
  __syncthreads();

  float qh = 0.f, kh = 0.f;
#pragma unroll
  for (int i = 0; i < B_KG; ++i) {
    qh += red_q[i][col];
    kh += red_k[i][col];
  }
  const float e = eg[bh];
  const float verr = ok ? beta[bh] * (v[(size_t)bh * V + vi] - e * kh) : 0.f;
  if (ok) {
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      const int kr = kg * RPT + r;
      S[(size_t)kr * V + vi] = e * sreg[r] + ks[kr] * verr;
    }
  }
  if (kg == 0 && ok) {
    float qk = 0.f;
    for (int i = 0; i < K; ++i) qk += qs[i] * ks[i];
    o[(size_t)bh * V + vi] = e * qh + qk * verr;
  }
}

template <int RPT>
cudaError_t launch_step(const float* q, const float* k, const float* v,
                        const float* eg, const float* beta, float* state,
                        float* o, int BH, int V, int layer,
                        cudaStream_t stream) {
  dim3 grid(BH, (V + B_VT - 1) / B_VT);
  delta_step_kernel<RPT><<<grid, B_THREADS, 0, stream>>>(q, k, v, eg, beta,
                                                         state, o, BH, V, layer);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns a cudaError_t code (0 = success). All tensors fp32, contiguous.
int ivl_delta_step(const void* q, const void* k, const void* v,
                   const void* eg, const void* beta, void* state, void* o,
                   int B, int H, int K, int V, int layer, void* stream) {
  const float *qf = (const float*)q, *kf = (const float*)k, *vf = (const float*)v;
  const float *ef = (const float*)eg, *bf = (const float*)beta;
  float *sf = (float*)state, *of = (float*)o;
  cudaStream_t st = (cudaStream_t)stream;
  const int BH = B * H;
  if (K != 128) return (int)cudaErrorInvalidValue;
  return (int)launch_step<16>(qf, kf, vf, ef, bf, sf, of, BH, V, layer, st);
}

}  // extern "C"
