// Kernel H: causal sliding-window flash attention for stateless (training)
// forwards, forward and backward.
//
// Replaces infinitevl_tpu/ops/swa.py::_swa_prefill_splash (the library
// splash kernel with its dq and dkv kernels). Query t of a row attends the
// keys kp of the same row with qp - window < kp <= qp and, when segment ids
// are given (packed sequences), seg[kp] == seg[qp]. GQA: query head hq
// reads KV head hq / (Hq / Hkv) where it lies; K and V are never repeated.
// Layout [B, T, H, 128] in and out; the row log-sum-exp and
// delta = rowsum(dO * O) are fp32 [B, Hq, T]. T needs no multiple: ragged
// tiles are masked. Tiles wholly outside the band (before qp - window or
// after the diagonal) are never visited; a tile inside the band whose
// segment mask is empty is skipped after a block-wide vote.
//
//   Bound on the H100: at B = 1, T = 8192, window >= T the forward's two
//   products are 4 (T^2 / 2) 128 x 16 heads = 275 GFLOP against 38 MB of q,
//   k, v and out: compute-bound; the backward recomputes S and adds three
//   products (2.5 x the forward).
//   Forward: one block per (query tile, q head, batch row), online softmax
//   as in kernel A1. bf16 runs the wgmma + TMA mainloop that it shares with
//   A1 (swa_fwd_wgmma.cuh): a producer warp streams the band's K/V tiles
//   and the keys' segment ids through a ring of stages to a consumer
//   warpgroup of 64 query rows; fp32 is plain FMA from shared memory.
//   Backward, no atomics, so gradients are reproducible:
//   - dQ: one block per (query tile, q head, batch row) loops over its key
//     tiles: S = Q K^T, P = exp(scale S - lse), dP = dO V^T,
//     dS = P (dP - delta) scale, dQ += dS K.
//   - dK/dV: one block per key tile and KV head loops over query tiles of
//     its band with the transposed products (S^T = K Q^T, dP^T = V dO^T):
//     dV += P^T dO, dK += dS^T Q, summed over the query heads of the group.
//   bf16 (Hopper): both are warp-specialised, one producer warp filling a
//   ring of TMA tiles with mbarriers and one consumer warpgroup on wgmma
//   (S and dP from shared memory, the dS / P products with A in
//   registers); dK/dV splits the GQA sum over the query heads into fp32
//   partials added in a fixed order by a reduce pass, so that the
//   causal band's T / 64 x Hkv key tiles become enough blocks for the card.
//   fp32 runs the same loops on plain FMA.
//   P and dS are rounded to bf16 for the bf16 products exactly where the
//   forward rounds P. A row with no visible key (none exists: a token sees
//   itself) would give zeros, never NaN.
#include "swa_fwd_wgmma.cuh"

namespace {

using ivl::NEG_INF;
using ivl::desc_k;
using ivl::desc_mn;
using ivl::from_f;
using ivl::keep;
using ivl::pack_bf16;
using ivl::to_a;
using ivl::to_f;

typedef __nv_bfloat16 bf16;

constexpr int HD = 128;  // head dim the kernels are written for

__device__ __forceinline__ bool visible(int qp, int kp, int window) {
  return kp <= qp && kp > qp - window;
}

// first key tile a query tile starting at q0 can see
__device__ __forceinline__ int first_key(int q0, int window, int tile) {
  const int lo = q0 - window + 1;
  return lo <= 0 ? 0 : lo / tile * tile;
}

// one past the last query that can see a key of the tile starting at k0
__device__ __forceinline__ int query_end(int k0, int tile, int window, int T) {
  return window >= T ? T : min(T, k0 + tile - 1 + window);
}

// ------------------------------------------------------------- delta
// delta[b, h, t] = sum_d dO[b, t, h, d] * O[b, t, h, d]; one warp per row.
template <typename T>
__global__ void __launch_bounds__(128)
swa_train_delta_kernel(const T* __restrict__ o, const T* __restrict__ d_o,
                       float* __restrict__ delta, int B, int Tn, int Hq) {
  const long long row = (long long)blockIdx.x * 4 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= (long long)B * Tn * Hq) return;
  const int h = (int)(row % Hq);
  const long long bt = row / Hq;
  const int t = (int)(bt % Tn);
  const int b = (int)(bt / Tn);
  float acc = 0.f;
#pragma unroll
  for (int i = 0; i < HD / 32; ++i)
    acc += to_f(o[row * HD + lane + 32 * i]) * to_f(d_o[row * HD + lane + 32 * i]);
  acc = ivl::warp_sum(acc);
  if (lane == 0) delta[((size_t)b * Hq + h) * Tn + t] = acc;
}

// ============================================================== fp32
constexpr int F_BR = 32;        // rows owned by a block (4 threads per row)
constexpr int F_BC = 64;        // columns per tile
constexpr int F_THREADS = 128;
constexpr int F_FWD_SMEM =
    (F_BR * (HD + 1) + F_BC * (HD + 1) + F_BC * HD + F_BR * (F_BC + 1)) * 4;
constexpr int F_DQ_SMEM =
    (2 * F_BR * (HD + 1) + 2 * F_BC * (HD + 1) + F_BR * (F_BC + 1)) * 4;
constexpr int F_DKV_SMEM =
    (2 * F_BR * (HD + 1) + 2 * F_BC * (HD + 1) + 2 * F_BR * (F_BC + 1)) * 4;

// load rows [r0, r0 + nrows) of a [B, Tn, H, HD] tensor's head h into
// dst[nrows][ld] as fp32, zeros past Tn
template <typename T>
__device__ __forceinline__ void load_rows_f32(float* dst, int ld, const T* src,
                                              int b, int Tn, int H, int h, int r0,
                                              int nrows) {
  for (int i = threadIdx.x; i < nrows * HD; i += blockDim.x) {
    const int rr = i / HD, d = i % HD;
    const int t = r0 + rr;
    dst[rr * ld + d] =
        t < Tn ? to_f(src[(((size_t)b * Tn + t) * H + h) * HD + d]) : 0.f;
  }
}

template <typename T>
__global__ void __launch_bounds__(F_THREADS)
swa_train_fwd_kernel(const T* __restrict__ q,    // [B, Tn, Hq, HD]
                     const T* __restrict__ k,    // [B, Tn, Hkv, HD]
                     const T* __restrict__ v,
                     const int* __restrict__ seg,  // [B, Tn] or null
                     T* __restrict__ out,          // [B, Tn, Hq, HD]
                     float* __restrict__ lse,      // [B, Hq, Tn]
                     int Tn, int Hq, int Hkv, int window, float scale) {
  extern __shared__ float smem[];
  float* Qs = smem;                    // [BR][HD + 1]
  float* Ks = Qs + F_BR * (HD + 1);    // [BC][HD + 1]
  float* Vs = Ks + F_BC * (HD + 1);    // [BC][HD]
  float* Ps = Vs + F_BC * HD;          // [BR][BC + 1]

  const int b = blockIdx.z, hq = blockIdx.y, hk = hq / (Hq / Hkv);
  const int q0 = blockIdx.x * F_BR;
  const int tid = threadIdx.x;
  const int r_loc = tid >> 2, c4 = tid & 3;
  const int qp = q0 + r_loc;
  const bool row_ok = qp < Tn;
  const int* segb = seg ? seg + (size_t)b * Tn : nullptr;
  const int my_seg = (segb && row_ok) ? segb[qp] : 0;

  load_rows_f32(Qs, HD + 1, q, b, Tn, Hq, hq, q0, F_BR);

  float m_i = NEG_INF, l_i = 0.f;
  float acc[HD / 4];
#pragma unroll
  for (int i = 0; i < HD / 4; ++i) acc[i] = 0.f;

  const int k_end = min(Tn, q0 + F_BR);
  for (int k0 = first_key(q0, window, F_BC); k0 < k_end; k0 += F_BC) {
    unsigned vis = 0;  // bit m: key k0 + c4 + 4m visible to this row
#pragma unroll
    for (int m = 0; m < F_BC / 4; ++m) {
      const int kp = k0 + c4 + 4 * m;
      if (row_ok && kp < Tn && visible(qp, kp, window) &&
          (!segb || segb[kp] == my_seg))
        vis |= 1u << m;
    }
    // also the barrier that retires the previous tile's readers
    if (!__syncthreads_or(vis != 0u)) continue;

    load_rows_f32(Ks, HD + 1, k, b, Tn, Hkv, hk, k0, F_BC);
    load_rows_f32(Vs, HD, v, b, Tn, Hkv, hk, k0, F_BC);
    __syncthreads();

    float s[F_BC / 4];
#pragma unroll
    for (int m = 0; m < F_BC / 4; ++m) s[m] = 0.f;
    for (int d = 0; d < HD; ++d) {
      const float qv = Qs[r_loc * (HD + 1) + d];
#pragma unroll
      for (int m = 0; m < F_BC / 4; ++m) s[m] += qv * Ks[(c4 + 4 * m) * (HD + 1) + d];
    }
    float tile_max = NEG_INF;
#pragma unroll
    for (int m = 0; m < F_BC / 4; ++m) {
      s[m] = (vis >> m & 1u) ? s[m] * scale : NEG_INF;
      tile_max = fmaxf(tile_max, s[m]);
    }
    // the 4 threads of a row are adjacent lanes
    tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, 1));
    tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, 2));
    const float m_new = fmaxf(m_i, tile_max);
    const float alpha = expf(m_i - m_new);
    float psum = 0.f;
#pragma unroll
    for (int m = 0; m < F_BC / 4; ++m) {
      const float p = (vis >> m & 1u) ? expf(s[m] - m_new) : 0.f;
      psum += p;
      Ps[r_loc * (F_BC + 1) + c4 + 4 * m] = p;
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    psum += __shfl_xor_sync(0xffffffffu, psum, 2);
    l_i = l_i * alpha + psum;
    m_i = m_new;
#pragma unroll
    for (int i = 0; i < HD / 4; ++i) acc[i] *= alpha;
    __syncthreads();

    for (int jj = 0; jj < F_BC; ++jj) {
      const float p = Ps[r_loc * (F_BC + 1) + jj];
      const float* vrow = Vs + jj * HD + c4;
#pragma unroll
      for (int i = 0; i < HD / 4; ++i) acc[i] += p * vrow[4 * i];
    }
  }

  if (row_ok) {
    const float inv = l_i > 0.f ? 1.f / l_i : 0.f;
    T* o = out + (((size_t)b * Tn + qp) * Hq + hq) * HD + c4;
#pragma unroll
    for (int i = 0; i < HD / 4; ++i) o[4 * i] = from_f<T>(acc[i] * inv);
    if (c4 == 0)
      lse[((size_t)b * Hq + hq) * Tn + qp] = l_i > 0.f ? m_i + logf(l_i) : 0.f;
  }
}

template <typename T>
__global__ void __launch_bounds__(F_THREADS)
swa_train_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const int* __restrict__ seg,
                    const T* __restrict__ d_o,          // [B, Tn, Hq, HD]
                    const float* __restrict__ lse,      // [B, Hq, Tn]
                    const float* __restrict__ delta,    // [B, Hq, Tn]
                    T* __restrict__ dq,                 // [B, Tn, Hq, HD]
                    int Tn, int Hq, int Hkv, int window, float scale) {
  extern __shared__ float smem[];
  float* Qs = smem;                     // [BR][HD + 1]
  float* Os = Qs + F_BR * (HD + 1);     // [BR][HD + 1]  dO
  float* Ks = Os + F_BR * (HD + 1);     // [BC][HD + 1]
  float* Vs = Ks + F_BC * (HD + 1);     // [BC][HD + 1]
  float* Ps = Vs + F_BC * (HD + 1);     // [BR][BC + 1]  dS

  const int b = blockIdx.z, hq = blockIdx.y, hk = hq / (Hq / Hkv);
  const int q0 = blockIdx.x * F_BR;
  const int tid = threadIdx.x;
  const int r_loc = tid >> 2, c4 = tid & 3;
  const int qp = q0 + r_loc;
  const bool row_ok = qp < Tn;
  const int* segb = seg ? seg + (size_t)b * Tn : nullptr;
  const int my_seg = (segb && row_ok) ? segb[qp] : 0;
  const float my_lse = row_ok ? lse[((size_t)b * Hq + hq) * Tn + qp] : 0.f;
  const float my_delta = row_ok ? delta[((size_t)b * Hq + hq) * Tn + qp] : 0.f;

  load_rows_f32(Qs, HD + 1, q, b, Tn, Hq, hq, q0, F_BR);
  load_rows_f32(Os, HD + 1, d_o, b, Tn, Hq, hq, q0, F_BR);

  float acc[HD / 4];
#pragma unroll
  for (int i = 0; i < HD / 4; ++i) acc[i] = 0.f;

  const int k_end = min(Tn, q0 + F_BR);
  for (int k0 = first_key(q0, window, F_BC); k0 < k_end; k0 += F_BC) {
    unsigned vis = 0;
#pragma unroll
    for (int m = 0; m < F_BC / 4; ++m) {
      const int kp = k0 + c4 + 4 * m;
      if (row_ok && kp < Tn && visible(qp, kp, window) &&
          (!segb || segb[kp] == my_seg))
        vis |= 1u << m;
    }
    if (!__syncthreads_or(vis != 0u)) continue;

    load_rows_f32(Ks, HD + 1, k, b, Tn, Hkv, hk, k0, F_BC);
    load_rows_f32(Vs, HD + 1, v, b, Tn, Hkv, hk, k0, F_BC);
    __syncthreads();

    float s[F_BC / 4], dp[F_BC / 4];
#pragma unroll
    for (int m = 0; m < F_BC / 4; ++m) s[m] = dp[m] = 0.f;
    for (int d = 0; d < HD; ++d) {
      const float qv = Qs[r_loc * (HD + 1) + d];
      const float ov = Os[r_loc * (HD + 1) + d];
#pragma unroll
      for (int m = 0; m < F_BC / 4; ++m) {
        s[m] += qv * Ks[(c4 + 4 * m) * (HD + 1) + d];
        dp[m] += ov * Vs[(c4 + 4 * m) * (HD + 1) + d];
      }
    }
#pragma unroll
    for (int m = 0; m < F_BC / 4; ++m) {
      const float p = (vis >> m & 1u) ? expf(s[m] * scale - my_lse) : 0.f;
      Ps[r_loc * (F_BC + 1) + c4 + 4 * m] = p * (dp[m] - my_delta) * scale;
    }
    __syncthreads();

    for (int jj = 0; jj < F_BC; ++jj) {
      const float ds = Ps[r_loc * (F_BC + 1) + jj];
      const float* krow = Ks + jj * (HD + 1) + c4;
#pragma unroll
      for (int i = 0; i < HD / 4; ++i) acc[i] += ds * krow[4 * i];
    }
  }

  if (row_ok) {
    T* o = dq + (((size_t)b * Tn + qp) * Hq + hq) * HD + c4;
#pragma unroll
    for (int i = 0; i < HD / 4; ++i) o[4 * i] = from_f<T>(acc[i]);
  }
}

template <typename T>
__global__ void __launch_bounds__(F_THREADS)
swa_train_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const int* __restrict__ seg,
                     const T* __restrict__ d_o, const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     T* __restrict__ dk,  // [B, Tn, Hkv, HD]
                     T* __restrict__ dv,
                     int Tn, int Hq, int Hkv, int window, float scale) {
  extern __shared__ float smem[];
  float* Ks = smem;                     // [BR][HD + 1]
  float* Vs = Ks + F_BR * (HD + 1);     // [BR][HD + 1]
  float* Qs = Vs + F_BR * (HD + 1);     // [BC][HD + 1]
  float* Os = Qs + F_BC * (HD + 1);     // [BC][HD + 1]  dO
  float* Ps = Os + F_BC * (HD + 1);     // [BR][BC + 1]  P^T
  float* Ds = Ps + F_BR * (F_BC + 1);   // [BR][BC + 1]  dS^T

  const int G = Hq / Hkv;
  const int b = blockIdx.z, hk = blockIdx.y;
  const int k0 = blockIdx.x * F_BR;
  const int tid = threadIdx.x;
  const int r_loc = tid >> 2, c4 = tid & 3;
  const int kp = k0 + r_loc;
  const bool row_ok = kp < Tn;
  const int* segb = seg ? seg + (size_t)b * Tn : nullptr;
  const int my_seg = (segb && row_ok) ? segb[kp] : 0;

  load_rows_f32(Ks, HD + 1, k, b, Tn, Hkv, hk, k0, F_BR);
  load_rows_f32(Vs, HD + 1, v, b, Tn, Hkv, hk, k0, F_BR);

  float acc_k[HD / 4], acc_v[HD / 4];
#pragma unroll
  for (int i = 0; i < HD / 4; ++i) acc_k[i] = acc_v[i] = 0.f;

  const int q_begin = k0 / F_BC * F_BC;
  const int q_end = query_end(k0, F_BR, window, Tn);
  for (int g = 0; g < G; ++g) {
    const int hq = hk * G + g;
    const float* lse_h = lse + ((size_t)b * Hq + hq) * Tn;
    const float* delta_h = delta + ((size_t)b * Hq + hq) * Tn;
    for (int q0 = q_begin; q0 < q_end; q0 += F_BC) {
      unsigned vis = 0;  // bit m: query q0 + c4 + 4m sees this key
#pragma unroll
      for (int m = 0; m < F_BC / 4; ++m) {
        const int qp = q0 + c4 + 4 * m;
        if (row_ok && qp < Tn && visible(qp, kp, window) &&
            (!segb || segb[qp] == my_seg))
          vis |= 1u << m;
      }
      if (!__syncthreads_or(vis != 0u)) continue;

      load_rows_f32(Qs, HD + 1, q, b, Tn, Hq, hq, q0, F_BC);
      load_rows_f32(Os, HD + 1, d_o, b, Tn, Hq, hq, q0, F_BC);
      __syncthreads();

      float s[F_BC / 4], dp[F_BC / 4];
#pragma unroll
      for (int m = 0; m < F_BC / 4; ++m) s[m] = dp[m] = 0.f;
      for (int d = 0; d < HD; ++d) {
        const float kv = Ks[r_loc * (HD + 1) + d];
        const float vv = Vs[r_loc * (HD + 1) + d];
#pragma unroll
        for (int m = 0; m < F_BC / 4; ++m) {
          s[m] += kv * Qs[(c4 + 4 * m) * (HD + 1) + d];
          dp[m] += vv * Os[(c4 + 4 * m) * (HD + 1) + d];
        }
      }
#pragma unroll
      for (int m = 0; m < F_BC / 4; ++m) {
        float p = 0.f, ds = 0.f;
        if (vis >> m & 1u) {
          const int qp = q0 + c4 + 4 * m;
          p = expf(s[m] * scale - lse_h[qp]);
          ds = p * (dp[m] - delta_h[qp]) * scale;
        }
        Ps[r_loc * (F_BC + 1) + c4 + 4 * m] = p;
        Ds[r_loc * (F_BC + 1) + c4 + 4 * m] = ds;
      }
      __syncthreads();

      for (int jj = 0; jj < F_BC; ++jj) {
        const float p = Ps[r_loc * (F_BC + 1) + jj];
        const float ds = Ds[r_loc * (F_BC + 1) + jj];
        const float* orow = Os + jj * (HD + 1) + c4;
        const float* qrow = Qs + jj * (HD + 1) + c4;
#pragma unroll
        for (int i = 0; i < HD / 4; ++i) {
          acc_v[i] += p * orow[4 * i];
          acc_k[i] += ds * qrow[4 * i];
        }
      }
    }
  }

  if (row_ok) {
    const size_t off = (((size_t)b * Tn + kp) * Hkv + hk) * HD + c4;
#pragma unroll
    for (int i = 0; i < HD / 4; ++i) {
      dk[off + 4 * i] = from_f<T>(acc_k[i]);
      dv[off + 4 * i] = from_f<T>(acc_v[i]);
    }
  }
}

// ------------------------------------------------ bf16 (Hopper) tiles
constexpr int W_T = ivl::FW_T;         // rows of a tile
constexpr int W_HALF = ivl::FW_HALF;   // bytes of one column half
constexpr int W_TILE = ivl::FW_TILE;   // bytes of a 64 x 128 bf16 tile
constexpr int W_THREADS = 160;         // one consumer warpgroup + the producer warp
constexpr int W_STAGE = 2 * W_TILE + 1024;  // two tiles and their row data
constexpr int DKV_STAGES = 3, DQ_STAGES = 2;
constexpr int DKV_SMEM = 2 * W_TILE + DKV_STAGES * W_STAGE + 64 + ivl::SMEM_ALIGN;
constexpr int DQ_SMEM = 2 * W_TILE + DQ_STAGES * W_STAGE + 64 + ivl::SMEM_ALIGN;

// the producer warp's share of a stage: the 64 rows' row data (lse, delta
// and segment ids, or the keys' segment ids), then the tiles by TMA; full
// completes when all 32 lanes arrived and the tiles landed
__device__ __forceinline__ void fill_rows(float* dst, const float* src, int t0, int Tn, int lane) {
#pragma unroll
  for (int r = lane; r < W_T; r += 32) dst[r] = t0 + r < Tn ? src[t0 + r] : 0.f;
}
__device__ __forceinline__ void fill_seg(int* dst, const int* segb, int t0, int Tn, int lane) {
#pragma unroll
  for (int r = lane; r < W_T; r += 32) dst[r] = (segb && t0 + r < Tn) ? segb[t0 + r] : 0;
}

// ====================================================== bf16 forward
// The shared wgmma + TMA mainloop (swa_fwd_wgmma.cuh) with one sequence as
// its key source: a block owns 64 query rows (tokens q0 ..) of one query
// head and walks the key tiles of their band, first_key(q0) to the
// diagonal; each stage brings the 64 keys' segment ids beside K and V.
// Without segment ids a tile that lies inside every row's band is taken
// without a per-element mask; with them a tile whose mask is empty for
// every row skips its products after a vote.
struct TrainSrc {
  static constexpr int D = HD, CWG = 1;
  static constexpr bool FAST = false;
  static constexpr bool VOTE = true;
  struct Row {
    int qp, seg;
    bool ok;
  };
  const CUtensorMap *qmap, *kmap, *vmap;
  const int* segb;
  bf16* out;
  float* lse;
  int b, hq, hk, Tn, Hq, window, q0, kb, n;

  __device__ int count() const { return n; }
  __device__ bool skip(int) const { return false; }  // the band's tiles only are walked
  __device__ void load_q(unsigned char* Qs, uint64_t* bar) const {
    ivl::mbar_arrive_tx(bar, ivl::FW_TILE);
    ivl::tile_load(Qs, qmap, bar, hq, q0, b);
  }
  __device__ void load(int i, unsigned char* st, uint64_t* bar, int lane) const {
    const int k0 = kb + i * ivl::FW_T;
    fill_seg(reinterpret_cast<int*>(st + 2 * ivl::FW_TILE), segb, k0, Tn, lane);
    if (lane == 0) {
      ivl::mbar_arrive_tx(bar, 2 * ivl::FW_TILE);
      ivl::tile_load(st, kmap, bar, hk, k0, b);
      ivl::tile_load(st + ivl::FW_TILE, vmap, bar, hk, k0, b);
    } else {
      ivl::mbar_arrive(bar);
    }
  }
  __device__ Row row(int r) const {
    const int qp = q0 + r;
    const bool ok = qp < Tn;
    return Row{qp, (segb && ok) ? segb[qp] : 0, ok};
  }
  __device__ bool whole(int i) const {
    const int k0 = kb + i * ivl::FW_T, lo = q0, hi = q0 + 63;
    return segb == nullptr && hi < Tn && k0 + ivl::FW_T - 1 <= lo && k0 > hi - window;
  }
  __device__ bool sees(int i, const unsigned char* st, const Row& w, int kl) const {
    const int kp = kb + i * ivl::FW_T + kl;
    return w.ok && kp < Tn && visible(w.qp, kp, window) &&
           reinterpret_cast<const int*>(st + 2 * ivl::FW_TILE)[kl] == w.seg;
  }
  __device__ void store(int r, int tig, const float (&acc)[64], const float (&m)[2],
                        const float (&l)[2]) const {
#pragma unroll
    for (int ii = 0; ii < 2; ++ii) {
      const int t = q0 + r + 8 * ii;
      if (t >= Tn) continue;
      const float inv = l[ii] > 0.f ? 1.f / l[ii] : 0.f;
      bf16* o = out + (((size_t)b * Tn + t) * Hq + hq) * HD + 2 * tig;
#pragma unroll
      for (int j = 0; j < 16; ++j)
        *reinterpret_cast<uint32_t*>(o + 8 * j) =
            pack_bf16(acc[4 * j + 2 * ii] * inv, acc[4 * j + 2 * ii + 1] * inv);
      if (tig == 0)
        lse[((size_t)b * Hq + hq) * Tn + t] =
            l[ii] > 0.f ? m[ii] * 0.6931471805599453f + logf(l[ii]) : 0.f;  // m in log2 units
    }
  }
};

// one block per (query tile, q head, batch row), the last query tiles (the
// longest bands) first
__global__ void __launch_bounds__(ivl::FW_THREADS, 2)
swa_train_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                           const __grid_constant__ CUtensorMap kmap,
                           const __grid_constant__ CUtensorMap vmap,
                           const int* __restrict__ seg, bf16* __restrict__ out,
                           float* __restrict__ lse, int B, int Tn, int Hq, int Hkv, int window,
                           float scale) {
  extern __shared__ unsigned char smem_raw[];
  const int n_tiles = (Tn + ivl::FW_T - 1) / ivl::FW_T;
  const int tile = n_tiles - 1 - (int)(blockIdx.x / (B * Hq));
  const int rest = blockIdx.x % (B * Hq);
  TrainSrc src;
  src.qmap = &qmap;
  src.kmap = &kmap;
  src.vmap = &vmap;
  src.hq = rest % Hq;
  src.b = rest / Hq;
  src.hk = src.hq / (Hq / Hkv);
  src.segb = seg ? seg + (size_t)src.b * Tn : nullptr;
  src.out = out;
  src.lse = lse;
  src.Tn = Tn;
  src.Hq = Hq;
  src.window = window;
  src.q0 = tile * ivl::FW_T;
  src.kb = first_key(src.q0, window, ivl::FW_T);
  src.n = (min(Tn, src.q0 + ivl::FW_T) - src.kb + ivl::FW_T - 1) / ivl::FW_T;
  ivl::fwd_mainloop(src, ivl::aligned_smem(smem_raw), scale);
}

// ------------------------------------------------ bf16 backward (wgmma)
// One consumer warpgroup (64 rows of keys or queries, 16 per warp) and one
// producer warp per block. Tiles are 64 rows x 128 columns, loaded by TMA
// (4-D maps over [B, T, H, 128], so a head is read where it lies: GQA
// never repeats K or V) in the 128-byte swizzle as two column halves of
// [64 rows][128 bytes]. The same tile is a K-major operand (its rows are
// the M or N of S = Q K^T) and an MN-major one (its rows are the K of
// dQ += dS K): nothing is transposed by hand. P and dS go from the fp32
// accumulators to bf16 A fragments in registers.
// dK/dV: one block per (key tile, KV head, batch row, split of the query
// heads); key tiles in order, so the longest bands (the first keys see the
// most queries) start first. The block loops over its query heads and the
// query tiles of its band: S^T = K Q^T and dP^T = V dO^T (wgmma m64n64,
// K and V from shared memory, loaded once), then dV += P^T dO and dK +=
// dS^T Q (m64n128, A from registers). With split > 1 the sums go to fp32
// partials [2][split][B, T, Hkv, 128] added in a fixed order by
// swa_train_reduce_kernel: no atomics, the same bits every run.
__global__ void __launch_bounds__(W_THREADS, 1)
swa_train_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                           const __grid_constant__ CUtensorMap kmap,
                           const __grid_constant__ CUtensorMap vmap,
                           const __grid_constant__ CUtensorMap omap,
                           const int* __restrict__ seg, const float* __restrict__ lse,
                           const float* __restrict__ delta, bf16* __restrict__ dk,
                           bf16* __restrict__ dv, float* __restrict__ partial, int B, int Tn,
                           int Hq, int Hkv, int window, int split, float scale) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = ivl::aligned_smem(smem_raw);
  unsigned char* Ks = sm;
  unsigned char* Vs = sm + W_TILE;
  unsigned char* stages = sm + 2 * W_TILE;
  uint64_t* full = reinterpret_cast<uint64_t*>(stages + DKV_STAGES * W_STAGE);
  uint64_t* empty = full + DKV_STAGES;
  uint64_t* kvbar = empty + DKV_STAGES;

  const int G = Hq / Hkv, per = G / split;
  int rest = blockIdx.x;
  const int tile = rest / (B * Hkv * split);
  rest %= B * Hkv * split;
  const int sp = rest % split;
  rest /= split;
  const int hk = rest % Hkv, b = rest / Hkv;
  const int k0 = tile * W_T;
  const int q_end = query_end(k0, W_T, window, Tn);
  const int n_qt = (q_end - k0 + W_T - 1) / W_T;  // query tiles of the band, from q0 = k0
  const int n_it = per * n_qt;
  const int* segb = seg ? seg + (size_t)b * Tn : nullptr;

  if (threadIdx.x == 0) {
    for (int s = 0; s < DKV_STAGES; ++s) {
      ivl::mbar_init(&full[s], 32);
      ivl::mbar_init(&empty[s], 128);
    }
    ivl::mbar_init(kvbar, 1);
    ivl::mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= 128) {  // ------------------------------ producer warp
    const int lane = threadIdx.x - 128;
    if (lane == 0) {
      ivl::mbar_arrive_tx(kvbar, 2 * W_TILE);
      ivl::tile_load(Ks, &kmap, kvbar, hk, k0, b);
      ivl::tile_load(Vs, &vmap, kvbar, hk, k0, b);
    }
    for (int it = 0; it < n_it; ++it) {
      const int s = it % DKV_STAGES;
      if (it >= DKV_STAGES) ivl::mbar_wait(&empty[s], (it / DKV_STAGES - 1) & 1);
      const int hq = hk * G + sp * per + it / n_qt;
      const int q0 = k0 + (it % n_qt) * W_T;
      unsigned char* st = stages + s * W_STAGE;
      float* rows = reinterpret_cast<float*>(st + 2 * W_TILE);
      const size_t ro = ((size_t)b * Hq + hq) * Tn;
      fill_rows(rows, lse + ro, q0, Tn, lane);
      fill_rows(rows + W_T, delta + ro, q0, Tn, lane);
      fill_seg(reinterpret_cast<int*>(rows + 2 * W_T), segb, q0, Tn, lane);
      if (lane == 0) {
        ivl::mbar_arrive_tx(&full[s], 2 * W_TILE);
        ivl::tile_load(st, &qmap, &full[s], hq, q0, b);
        ivl::tile_load(st + W_TILE, &omap, &full[s], hq, q0, b);
      } else {
        ivl::mbar_arrive(&full[s]);
      }
    }
    return;
  }

  // ---------------------------------------------------------- consumers
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  int kp[2], my_seg[2];
  bool rok[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    kp[i] = k0 + warp * 16 + gid + 8 * i;
    rok[i] = kp[i] < Tn;
    my_seg[i] = (segb && rok[i]) ? segb[kp[i]] : 0;
  }
  float acc_k[64], acc_v[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc_k[i] = acc_v[i] = 0.f;
  ivl::mbar_wait(kvbar, 0);

  for (int it = 0; it < n_it; ++it) {
    const int s = it % DKV_STAGES;
    ivl::mbar_wait(&full[s], (it / DKV_STAGES) & 1);
    const unsigned char* qs = stages + s * W_STAGE;
    const unsigned char* os = qs + W_TILE;
    const float* lse_s = reinterpret_cast<const float*>(qs + 2 * W_TILE);
    const float* delta_s = lse_s + W_T;
    const int* seg_s = reinterpret_cast<const int*>(delta_s + W_T);
    const int q0 = k0 + (it % n_qt) * W_T;

    float st_[32], dp[32];
    ivl::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      ivl::wgmma_ss_n64<0>(st_, desc_k(Ks, kk), desc_k(qs, kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      ivl::wgmma_ss_n64<0>(dp, desc_k(Vs, kk), desc_k(os, kk), kk > 0);
    ivl::wgmma_commit();
    ivl::wgmma_wait0();
    keep(st_);
    keep(dp);

    // P^T in st_, dS^T in dp: rows are keys, columns queries
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int idx = 4 * j + 2 * i + e, ql = 8 * j + 2 * tig + e, qp = q0 + ql;
          const bool vis =
              rok[i] && qp < Tn && visible(qp, kp[i], window) && seg_s[ql] == my_seg[i];
          const float p = vis ? expf(st_[idx] * scale - lse_s[ql]) : 0.f;
          st_[idx] = p;
          dp[idx] = p * (dp[idx] - delta_s[ql]) * scale;
        }
    uint32_t ap[4][4], ad[4][4];
    to_a(ap, st_);
    to_a(ad, dp);
    ivl::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) ivl::wgmma_rs_n128(acc_v, ap[kk], desc_mn(os, kk), 1);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) ivl::wgmma_rs_n128(acc_k, ad[kk], desc_mn(qs, kk), 1);
    ivl::wgmma_commit();
    ivl::wgmma_wait0();
    keep(ap);
    keep(ad);
    keep(acc_k);
    keep(acc_v);
    ivl::mbar_arrive(&empty[s]);
  }

  const size_t n = (size_t)B * Tn * Hkv * HD;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (!rok[i]) continue;
    const size_t off = (((size_t)b * Tn + kp[i]) * Hkv + hk) * HD + 2 * tig;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const float k_0 = acc_k[4 * j + 2 * i], k_1 = acc_k[4 * j + 2 * i + 1];
      const float v_0 = acc_v[4 * j + 2 * i], v_1 = acc_v[4 * j + 2 * i + 1];
      if (split == 1) {
        *reinterpret_cast<uint32_t*>(dk + off + 8 * j) = pack_bf16(k_0, k_1);
        *reinterpret_cast<uint32_t*>(dv + off + 8 * j) = pack_bf16(v_0, v_1);
      } else {
        *reinterpret_cast<float2*>(partial + sp * n + off + 8 * j) = make_float2(k_0, k_1);
        *reinterpret_cast<float2*>(partial + (split + sp) * n + off + 8 * j) =
            make_float2(v_0, v_1);
      }
    }
  }
}

// dk, dv (each n values) = the sum over s = 0 .. split - 1, in that order,
// of partial[0][s] and partial[1][s]; four values per thread
__global__ void swa_train_reduce_kernel(const float* __restrict__ partial, bf16* __restrict__ dk,
                                        bf16* __restrict__ dv, int split, size_t n) {
  const size_t i = ((size_t)blockIdx.x * blockDim.x + threadIdx.x) * 4;
  if (i >= 2 * n) return;
  const int which = i >= n;
  const size_t at = i - which * n;
  const float* src = partial + (size_t)which * split * n + at;
  float4 a = *reinterpret_cast<const float4*>(src);
  for (int s = 1; s < split; ++s) {
    const float4 v = *reinterpret_cast<const float4*>(src + s * n);
    a.x += v.x;
    a.y += v.y;
    a.z += v.z;
    a.w += v.w;
  }
  bf16* dst = (which ? dv : dk) + at;
  *reinterpret_cast<uint2*>(dst) = make_uint2(pack_bf16(a.x, a.y), pack_bf16(a.z, a.w));
}

// dQ: one block per (query tile, q head, batch row), the last query tiles
// (the longest bands) first. K and V tiles of the band come through the
// ring: S = Q K^T and dP = dO V^T (wgmma m64n64 from shared memory, Q and
// dO loaded once), dQ += dS K (m64n128, dS from registers, K MN-major).
__global__ void __launch_bounds__(W_THREADS, 2)
swa_train_dq_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                          const __grid_constant__ CUtensorMap kmap,
                          const __grid_constant__ CUtensorMap vmap,
                          const __grid_constant__ CUtensorMap omap,
                          const int* __restrict__ seg, const float* __restrict__ lse,
                          const float* __restrict__ delta, bf16* __restrict__ dq, int B,
                          int Tn, int Hq, int Hkv, int window, float scale) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = ivl::aligned_smem(smem_raw);
  unsigned char* Qs = sm;
  unsigned char* Os = sm + W_TILE;
  unsigned char* stages = sm + 2 * W_TILE;
  uint64_t* full = reinterpret_cast<uint64_t*>(stages + DQ_STAGES * W_STAGE);
  uint64_t* empty = full + DQ_STAGES;
  uint64_t* qobar = empty + DQ_STAGES;

  const int n_tiles = (Tn + W_T - 1) / W_T;
  const int tile = n_tiles - 1 - (int)(blockIdx.x / (B * Hq));
  const int rest = blockIdx.x % (B * Hq);
  const int hq = rest % Hq, b = rest / Hq, hk = hq / (Hq / Hkv);
  const int q0 = tile * W_T;
  const int kb = first_key(q0, window, W_T);
  const int n_it = (min(Tn, q0 + W_T) - kb + W_T - 1) / W_T;
  const int* segb = seg ? seg + (size_t)b * Tn : nullptr;

  if (threadIdx.x == 0) {
    for (int s = 0; s < DQ_STAGES; ++s) {
      ivl::mbar_init(&full[s], 32);
      ivl::mbar_init(&empty[s], 128);
    }
    ivl::mbar_init(qobar, 1);
    ivl::mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= 128) {  // ------------------------------ producer warp
    const int lane = threadIdx.x - 128;
    if (lane == 0) {
      ivl::mbar_arrive_tx(qobar, 2 * W_TILE);
      ivl::tile_load(Qs, &qmap, qobar, hq, q0, b);
      ivl::tile_load(Os, &omap, qobar, hq, q0, b);
    }
    for (int it = 0; it < n_it; ++it) {
      const int s = it % DQ_STAGES;
      if (it >= DQ_STAGES) ivl::mbar_wait(&empty[s], (it / DQ_STAGES - 1) & 1);
      const int k0 = kb + it * W_T;
      unsigned char* st = stages + s * W_STAGE;
      fill_seg(reinterpret_cast<int*>(st + 2 * W_TILE), segb, k0, Tn, lane);
      if (lane == 0) {
        ivl::mbar_arrive_tx(&full[s], 2 * W_TILE);
        ivl::tile_load(st, &kmap, &full[s], hk, k0, b);
        ivl::tile_load(st + W_TILE, &vmap, &full[s], hk, k0, b);
      } else {
        ivl::mbar_arrive(&full[s]);
      }
    }
    return;
  }

  // ---------------------------------------------------------- consumers
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  int qp[2], my_seg[2];
  bool rok[2];
  float my_lse[2], my_delta[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    qp[i] = q0 + warp * 16 + gid + 8 * i;
    rok[i] = qp[i] < Tn;
    my_seg[i] = (segb && rok[i]) ? segb[qp[i]] : 0;
    const size_t r = ((size_t)b * Hq + hq) * Tn + (rok[i] ? qp[i] : 0);
    my_lse[i] = rok[i] ? lse[r] : 0.f;
    my_delta[i] = rok[i] ? delta[r] : 0.f;
  }
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  ivl::mbar_wait(qobar, 0);

  for (int it = 0; it < n_it; ++it) {
    const int s = it % DQ_STAGES;
    ivl::mbar_wait(&full[s], (it / DQ_STAGES) & 1);
    const unsigned char* ks = stages + s * W_STAGE;
    const unsigned char* vs = ks + W_TILE;
    const int* kseg = reinterpret_cast<const int*>(ks + 2 * W_TILE);
    const int k0 = kb + it * W_T;

    float sc[32], dp[32];
    ivl::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      ivl::wgmma_ss_n64<0>(sc, desc_k(Qs, kk), desc_k(ks, kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      ivl::wgmma_ss_n64<0>(dp, desc_k(Os, kk), desc_k(vs, kk), kk > 0);
    ivl::wgmma_commit();
    ivl::wgmma_wait0();
    keep(sc);
    keep(dp);

    // dS = P (dP - delta) scale in dp: rows are queries, columns keys
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int idx = 4 * j + 2 * i + e, kl = 8 * j + 2 * tig + e, kp = k0 + kl;
          const bool vis =
              rok[i] && kp < Tn && visible(qp[i], kp, window) && kseg[kl] == my_seg[i];
          const float p = vis ? expf(sc[idx] * scale - my_lse[i]) : 0.f;
          dp[idx] = p * (dp[idx] - my_delta[i]) * scale;
        }
    uint32_t ad[4][4];
    to_a(ad, dp);
    ivl::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) ivl::wgmma_rs_n128(acc, ad[kk], desc_mn(ks, kk), 1);
    ivl::wgmma_commit();
    ivl::wgmma_wait0();
    keep(ad);
    keep(acc);
    ivl::mbar_arrive(&empty[s]);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (!rok[i]) continue;
    bf16* orow = dq + (((size_t)b * Tn + qp[i]) * Hq + hq) * HD + 2 * tig;
#pragma unroll
    for (int j = 0; j < 16; ++j)
      *reinterpret_cast<uint32_t*>(orow + 8 * j) =
          pack_bf16(acc[4 * j + 2 * i], acc[4 * j + 2 * i + 1]);
  }
}

// a 4-D map over a [B, Tn, H, 128] bf16 tensor, 64 x 64 boxes (one head)
bool head_map(CUtensorMap* map, const void* base, int B, int Tn, int H) {
  const cuuint64_t dims[4] = {HD, (cuuint64_t)H, (cuuint64_t)Tn, (cuuint64_t)B};
  const cuuint64_t strides[3] = {HD * 2, (cuuint64_t)H * HD * 2, (cuuint64_t)Tn * H * HD * 2};
  const cuuint32_t box[4] = {64, 1, W_T, 1};
  return ivl::make_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, base, dims, strides, box,
                       CU_TENSOR_MAP_SWIZZLE_128B);
}

template <typename K>
cudaError_t allow_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

bool bad_shape(int B, int Tn, int Hq, int Hkv, int D, int window) {
  return D != HD || B <= 0 || Tn <= 0 || Hq <= 0 || Hkv <= 0 || Hq % Hkv ||
         Hq > 65535 || B > 65535 || window <= 0;
}

}  // namespace

extern "C" {

// Kernel H forward. q, out [B, T, Hq, D]; k, v [B, T, Hkv, D]; seg [B, T]
// int32 or null; lse [B, Hq, T] fp32. All contiguous, 16-byte aligned.
// Returns a cudaError_t code (0 = success).
int ivl_swa_train_fwd(int dtype, const void* q, const void* k, const void* v,
                      const void* seg, void* out, void* lse, int B, int T, int Hq,
                      int Hkv, int D, int window, float scale, void* stream) {
  if (bad_shape(B, T, Hq, Hkv, D, window)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == ivl::DTYPE_F32) {
    cudaError_t err = allow_smem(swa_train_fwd_kernel<float>, F_FWD_SMEM);
    if (err != cudaSuccess) return (int)err;
    swa_train_fwd_kernel<float>
        <<<dim3((T + F_BR - 1) / F_BR, Hq, B), F_THREADS, F_FWD_SMEM, st>>>(
            (const float*)q, (const float*)k, (const float*)v, (const int*)seg,
            (float*)out, (float*)lse, T, Hq, Hkv, window, scale);
    return (int)cudaGetLastError();
  }
  if (dtype == ivl::DTYPE_BF16) {
    CUtensorMap qm, km, vm;
    if (!head_map(&qm, q, B, T, Hq) || !head_map(&km, k, B, T, Hkv) ||
        !head_map(&vm, v, B, T, Hkv))
      return (int)cudaErrorInvalidValue;
    cudaError_t err = allow_smem(swa_train_fwd_wgmma_kernel, ivl::FW_SMEM);
    if (err != cudaSuccess) return (int)err;
    const long long blocks = (long long)((T + ivl::FW_T - 1) / ivl::FW_T) * B * Hq;
    swa_train_fwd_wgmma_kernel<<<(unsigned)blocks, ivl::FW_THREADS, ivl::FW_SMEM, st>>>(
        qm, km, vm, (const int*)seg, (bf16*)out, (float*)lse, B, T, Hq, Hkv, window, scale);
    return (int)cudaGetLastError();
  }
  return (int)cudaErrorInvalidValue;
}

// Kernel H backward: delta = rowsum(dO * O) into `delta` [B, Hq, T] fp32
// (scratch), then dq [B, T, Hq, D] and dk, dv [B, T, Hkv, D] from q, k, v,
// the forward's `out` and `lse`, and d_out, on `stream`. bf16: the query
// heads of a KV head are split `split` ways (a divisor of Hq / Hkv) over the
// dK/dV blocks; with split > 1, `partial` is fp32 scratch [2, split, B, T,
// Hkv, D] and a fourth launch adds it up.
int ivl_swa_train_bwd(int dtype, const void* q, const void* k, const void* v,
                      const void* seg, const void* out, const void* d_out,
                      const void* lse, void* delta, void* dq, void* dk, void* dv,
                      void* partial, int B, int T, int Hq, int Hkv, int D, int window,
                      int split, float scale, void* stream) {
  if (bad_shape(B, T, Hq, Hkv, D, window)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const long long rows = (long long)B * T * Hq;
  const unsigned delta_blocks = (unsigned)((rows + 3) / 4);
  cudaError_t err;
  if (dtype == ivl::DTYPE_F32) {
    typedef float F;
    swa_train_delta_kernel<F><<<delta_blocks, 128, 0, st>>>(
        (const F*)out, (const F*)d_out, (float*)delta, B, T, Hq);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    if ((err = allow_smem(swa_train_dq_kernel<F>, F_DQ_SMEM)) != cudaSuccess)
      return (int)err;
    swa_train_dq_kernel<F>
        <<<dim3((T + F_BR - 1) / F_BR, Hq, B), F_THREADS, F_DQ_SMEM, st>>>(
            (const F*)q, (const F*)k, (const F*)v, (const int*)seg, (const F*)d_out,
            (const float*)lse, (const float*)delta, (F*)dq, T, Hq, Hkv, window,
            scale);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    if ((err = allow_smem(swa_train_dkv_kernel<F>, F_DKV_SMEM)) != cudaSuccess)
      return (int)err;
    swa_train_dkv_kernel<F>
        <<<dim3((T + F_BR - 1) / F_BR, Hkv, B), F_THREADS, F_DKV_SMEM, st>>>(
            (const F*)q, (const F*)k, (const F*)v, (const int*)seg, (const F*)d_out,
            (const float*)lse, (const float*)delta, (F*)dk, (F*)dv, T, Hq, Hkv,
            window, scale);
    return (int)cudaGetLastError();
  }
  if (dtype == ivl::DTYPE_BF16) {
    swa_train_delta_kernel<bf16><<<delta_blocks, 128, 0, st>>>(
        (const bf16*)out, (const bf16*)d_out, (float*)delta, B, T, Hq);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    const int G = Hq / Hkv;
    if (split <= 0 || G % split || (split > 1 && partial == nullptr))
      return (int)cudaErrorInvalidValue;
    CUtensorMap qm, km, vm, om;
    if (!head_map(&qm, q, B, T, Hq) || !head_map(&km, k, B, T, Hkv) ||
        !head_map(&vm, v, B, T, Hkv) || !head_map(&om, d_out, B, T, Hq))
      return (int)cudaErrorInvalidValue;
    const long long tiles = (T + W_T - 1) / W_T;
    if ((err = allow_smem(swa_train_dq_wgmma_kernel, DQ_SMEM)) != cudaSuccess) return (int)err;
    swa_train_dq_wgmma_kernel<<<(unsigned)(tiles * B * Hq), W_THREADS, DQ_SMEM, st>>>(
        qm, km, vm, om, (const int*)seg, (const float*)lse, (const float*)delta, (bf16*)dq,
        B, T, Hq, Hkv, window, scale);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    if ((err = allow_smem(swa_train_dkv_wgmma_kernel, DKV_SMEM)) != cudaSuccess)
      return (int)err;
    swa_train_dkv_wgmma_kernel<<<(unsigned)(tiles * B * Hkv * split), W_THREADS, DKV_SMEM,
                                 st>>>(qm, km, vm, om, (const int*)seg, (const float*)lse,
                                       (const float*)delta, (bf16*)dk, (bf16*)dv,
                                       (float*)partial, B, T, Hq, Hkv, window, split, scale);
    if ((err = cudaGetLastError()) != cudaSuccess || split == 1) return (int)err;
    const size_t n = (size_t)B * T * Hkv * HD;
    swa_train_reduce_kernel<<<(unsigned)((2 * n / 4 + 255) / 256), 256, 0, st>>>(
        (const float*)partial, (bf16*)dk, (bf16*)dv, split, n);
    return (int)cudaGetLastError();
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
