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
//   as in kernel A1. bf16 runs on tensor cores (mma.sync m16n8k16, Q
//   fragments in registers, P fed back as the A operand of O += P V); fp32
//   is plain FMA from shared memory.
//   Backward, two kernels and no atomics, so gradients are reproducible:
//   - dQ: one block per (query tile, q head, batch row) loops over its key
//     tiles: S = Q K^T, P = exp(scale S - lse), dP = dO V^T,
//     dS = P (dP - delta) scale, dQ += dS K.
//   - dK/dV: one block per (key tile, KV head, batch row) loops over the
//     query heads of its group and the query tiles of its band with the
//     transposed products (S^T = K Q^T, dP^T = V dO^T), so the GQA sum
//     lands in one set of accumulators: dV += P^T dO, dK += dS^T Q.
//   P and dS are rounded to bf16 for the bf16 products exactly where the
//   forward rounds P. A row with no visible key (none exists: a token sees
//   itself) would give zeros, never NaN.
#include "common.cuh"

namespace {

using ivl::NEG_INF;
using ivl::from_f;
using ivl::ld32;
using ivl::mma_bf16;
using ivl::pack_bf16;
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

// ============================================================== bf16
// Tensor cores through mma.sync m16n8k16; fragment layout: ivl::mma_bf16.
constexpr int M_WARPS = 4;
constexpr int M_BR = 16 * M_WARPS;  // rows owned by a block (16 per warp)
constexpr int M_BK = 64;            // keys per tile (forward, dQ)
constexpr int M_BQ = 32;            // queries per tile (dK/dV)
constexpr int RSTR = HD + 8;        // bf16 per row of a [row][d] tile
constexpr int TSTR = M_BK + 8;      // bf16 per row of a [d][key] tile
constexpr int QSTR = M_BQ + 8;      // bf16 per row of a [d][query] tile
constexpr int M_DQ_SMEM = (3 * M_BK * RSTR + HD * TSTR) * 2;
constexpr int M_DKV_SMEM =
    (2 * M_BR * RSTR + 2 * M_BQ * RSTR + 2 * HD * QSTR) * 2 + 2 * M_BQ * 4;

// Stage rows [r0, r0 + nrows) of head h of a [B, Tn, H, HD] bf16 tensor:
// as [row][d] (row stride RSTR) into `rows`, and/or transposed as [d][row]
// (row stride tstr) into `trans`. Rows past Tn are zeros.
__device__ __forceinline__ void stage_bf16(bf16* rows, bf16* trans, int tstr,
                                           const bf16* src, int b, int Tn, int H,
                                           int h, int r0, int nrows) {
  for (int c = threadIdx.x; c < nrows * HD / 8; c += blockDim.x) {
    const int rr = c / (HD / 8), d0 = (c % (HD / 8)) * 8;
    const int t = r0 + rr;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (t < Tn)
      val = *reinterpret_cast<const uint4*>(
          src + (((size_t)b * Tn + t) * H + h) * HD + d0);
    if (rows) *reinterpret_cast<uint4*>(&rows[rr * RSTR + d0]) = val;
    if (trans) {
      const bf16* e = reinterpret_cast<const bf16*>(&val);
#pragma unroll
      for (int i = 0; i < 8; ++i) trans[(d0 + i) * tstr + rr] = e[i];
    }
  }
}

// A fragment (16 rows x 16 d) of a [row][d] tile at rows r16.., k-step ks
__device__ __forceinline__ void lda(uint32_t a[4], const bf16* tile, int r16, int ks,
                                    int gid, int tig) {
  const bf16* p = tile + (r16 + gid) * RSTR + ks * 16 + 2 * tig;
  a[0] = ld32(p);
  a[1] = ld32(p + 8 * RSTR);
  a[2] = ld32(p + 8);
  a[3] = ld32(p + 8 * RSTR + 8);
}

__global__ void __launch_bounds__(32 * M_WARPS)
swa_train_fwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, const int* __restrict__ seg,
                         bf16* __restrict__ out, float* __restrict__ lse, int Tn,
                         int Hq, int Hkv, int window, float scale) {
  __shared__ __align__(16) bf16 Ks[M_BK * RSTR];
  __shared__ __align__(16) bf16 Vt[HD * TSTR];

  const int b = blockIdx.z, hq = blockIdx.y, hk = hq / (Hq / Hkv);
  const int q0 = blockIdx.x * M_BR;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int* segb = seg ? seg + (size_t)b * Tn : nullptr;

  bool rok[2];
  int qp[2], my_seg[2];
  size_t qoff[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    qp[i] = q0 + warp * 16 + gid + 8 * i;
    rok[i] = qp[i] < Tn;
    my_seg[i] = (segb && rok[i]) ? segb[qp[i]] : 0;
    qoff[i] = (((size_t)b * Tn + (rok[i] ? qp[i] : 0)) * Hq + hq) * HD;
  }
  uint32_t qf[HD / 16][4];
#pragma unroll
  for (int ks = 0; ks < HD / 16; ++ks) {
    const int d = ks * 16 + 2 * tig;
    qf[ks][0] = rok[0] ? ld32(q + qoff[0] + d) : 0u;
    qf[ks][1] = rok[1] ? ld32(q + qoff[1] + d) : 0u;
    qf[ks][2] = rok[0] ? ld32(q + qoff[0] + d + 8) : 0u;
    qf[ks][3] = rok[1] ? ld32(q + qoff[1] + d + 8) : 0u;
  }

  float o[HD / 8][4];
#pragma unroll
  for (int dt = 0; dt < HD / 8; ++dt)
#pragma unroll
    for (int c = 0; c < 4; ++c) o[dt][c] = 0.f;
  float m_r[2] = {NEG_INF, NEG_INF}, l_r[2] = {0.f, 0.f};

  const int k_end = min(Tn, q0 + M_BR);
  for (int k0 = first_key(q0, window, M_BK); k0 < k_end; k0 += M_BK) {
    uint32_t vis = 0;  // bit i*16 + nt*2 + e: row i, key k0 + nt*8 + 2*tig + e
#pragma unroll
    for (int nt = 0; nt < M_BK / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int kp = k0 + nt * 8 + 2 * tig + e;
        if (kp < Tn) {
          const int ks_ = segb ? segb[kp] : 0;
#pragma unroll
          for (int i = 0; i < 2; ++i)
            if (rok[i] && visible(qp[i], kp, window) && ks_ == my_seg[i])
              vis |= 1u << (i * 16 + nt * 2 + e);
        }
      }
    // also the barrier that retires the previous tile's readers
    if (!__syncthreads_or(vis != 0u)) continue;

    stage_bf16(Ks, nullptr, 0, k, b, Tn, Hkv, hk, k0, M_BK);
    stage_bf16(nullptr, Vt, TSTR, v, b, Tn, Hkv, hk, k0, M_BK);
    __syncthreads();

    float s[M_BK / 8][4];
#pragma unroll
    for (int nt = 0; nt < M_BK / 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      const bf16* krow = Ks + (nt * 8 + gid) * RSTR + 2 * tig;
#pragma unroll
      for (int ks = 0; ks < HD / 16; ++ks)
        mma_bf16(s[nt], qf[ks], ld32(krow + ks * 16), ld32(krow + ks * 16 + 8));
    }

    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int nt = 0; nt < M_BK / 8; ++nt)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const bool vb = (vis >> (i * 16 + nt * 2 + e)) & 1u;
          s[nt][2 * i + e] = vb ? s[nt][2 * i + e] * scale : NEG_INF;
          mx[i] = fmaxf(mx[i], s[nt][2 * i + e]);
        }
    float alpha[2], psum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m_r[i], mx[i]);
      alpha[i] = expf(m_r[i] - m_new);
      m_r[i] = m_new;
    }
#pragma unroll
    for (int nt = 0; nt < M_BK / 8; ++nt)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const bool vb = (vis >> (i * 16 + nt * 2 + e)) & 1u;
          const float p = vb ? expf(s[nt][2 * i + e] - m_r[i]) : 0.f;
          s[nt][2 * i + e] = p;
          psum[i] += p;
        }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      psum[i] += __shfl_xor_sync(0xffffffffu, psum[i], 1);
      psum[i] += __shfl_xor_sync(0xffffffffu, psum[i], 2);
      l_r[i] = l_r[i] * alpha[i] + psum[i];
    }
#pragma unroll
    for (int dt = 0; dt < HD / 8; ++dt) {
      o[dt][0] *= alpha[0];
      o[dt][1] *= alpha[0];
      o[dt][2] *= alpha[1];
      o[dt][3] *= alpha[1];
    }
    // O += P V with P (bf16) as the A operand straight from the accumulators
#pragma unroll
    for (int kk = 0; kk < M_BK / 16; ++kk) {
      const uint32_t a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                             pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                             pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dt = 0; dt < HD / 8; ++dt) {
        const bf16* vrow = Vt + (dt * 8 + gid) * TSTR + kk * 16 + 2 * tig;
        mma_bf16(o[dt], a, ld32(vrow), ld32(vrow + 8));
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (!rok[i]) continue;
    const float inv = l_r[i] > 0.f ? 1.f / l_r[i] : 0.f;
    bf16* orow = out + qoff[i] + 2 * tig;
#pragma unroll
    for (int dt = 0; dt < HD / 8; ++dt)
      *reinterpret_cast<uint32_t*>(orow + dt * 8) =
          pack_bf16(o[dt][2 * i] * inv, o[dt][2 * i + 1] * inv);
    if (tig == 0)
      lse[((size_t)b * Hq + hq) * Tn + qp[i]] =
          l_r[i] > 0.f ? m_r[i] + logf(l_r[i]) : 0.f;
  }
}

__global__ void __launch_bounds__(32 * M_WARPS)
swa_train_dq_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, const int* __restrict__ seg,
                        const bf16* __restrict__ d_o, const float* __restrict__ lse,
                        const float* __restrict__ delta, bf16* __restrict__ dq,
                        int Tn, int Hq, int Hkv, int window, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);  // [BK][RSTR]
  bf16* Vs = Ks + M_BK * RSTR;                   // [BK][RSTR]
  bf16* Os = Vs + M_BK * RSTR;                   // [BR][RSTR]  dO
  bf16* Kt = Os + M_BR * RSTR;                   // [HD][TSTR]

  const int b = blockIdx.z, hq = blockIdx.y, hk = hq / (Hq / Hkv);
  const int q0 = blockIdx.x * M_BR;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int* segb = seg ? seg + (size_t)b * Tn : nullptr;

  bool rok[2];
  int qp[2], my_seg[2];
  size_t qoff[2];
  float my_lse[2], my_delta[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    qp[i] = q0 + warp * 16 + gid + 8 * i;
    rok[i] = qp[i] < Tn;
    my_seg[i] = (segb && rok[i]) ? segb[qp[i]] : 0;
    qoff[i] = (((size_t)b * Tn + (rok[i] ? qp[i] : 0)) * Hq + hq) * HD;
    const size_t r = ((size_t)b * Hq + hq) * Tn + (rok[i] ? qp[i] : 0);
    my_lse[i] = rok[i] ? lse[r] : 0.f;
    my_delta[i] = rok[i] ? delta[r] : 0.f;
  }
  uint32_t qf[HD / 16][4];
#pragma unroll
  for (int ks = 0; ks < HD / 16; ++ks) {
    const int d = ks * 16 + 2 * tig;
    qf[ks][0] = rok[0] ? ld32(q + qoff[0] + d) : 0u;
    qf[ks][1] = rok[1] ? ld32(q + qoff[1] + d) : 0u;
    qf[ks][2] = rok[0] ? ld32(q + qoff[0] + d + 8) : 0u;
    qf[ks][3] = rok[1] ? ld32(q + qoff[1] + d + 8) : 0u;
  }
  stage_bf16(Os, nullptr, 0, d_o, b, Tn, Hq, hq, q0, M_BR);

  float acc[HD / 8][4];
#pragma unroll
  for (int dt = 0; dt < HD / 8; ++dt)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[dt][c] = 0.f;

  const int k_end = min(Tn, q0 + M_BR);
  for (int k0 = first_key(q0, window, M_BK); k0 < k_end; k0 += M_BK) {
    uint32_t vis = 0;
#pragma unroll
    for (int nt = 0; nt < M_BK / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int kp = k0 + nt * 8 + 2 * tig + e;
        if (kp < Tn) {
          const int ks_ = segb ? segb[kp] : 0;
#pragma unroll
          for (int i = 0; i < 2; ++i)
            if (rok[i] && visible(qp[i], kp, window) && ks_ == my_seg[i])
              vis |= 1u << (i * 16 + nt * 2 + e);
        }
      }
    // also the barrier that retires the previous tile's readers (and, the
    // first time, publishes the staged dO tile)
    if (!__syncthreads_or(vis != 0u)) continue;

    stage_bf16(Ks, Kt, TSTR, k, b, Tn, Hkv, hk, k0, M_BK);
    stage_bf16(Vs, nullptr, 0, v, b, Tn, Hkv, hk, k0, M_BK);
    __syncthreads();

    float s[M_BK / 8][4], dp[M_BK / 8][4];
#pragma unroll
    for (int nt = 0; nt < M_BK / 8; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[nt][c] = dp[nt][c] = 0.f;
#pragma unroll
    for (int ks = 0; ks < HD / 16; ++ks) {
      uint32_t of[4];
      lda(of, Os, warp * 16, ks, gid, tig);
#pragma unroll
      for (int nt = 0; nt < M_BK / 8; ++nt) {
        const bf16* krow = Ks + (nt * 8 + gid) * RSTR + ks * 16 + 2 * tig;
        const bf16* vrow = Vs + (nt * 8 + gid) * RSTR + ks * 16 + 2 * tig;
        mma_bf16(s[nt], qf[ks], ld32(krow), ld32(krow + 8));
        mma_bf16(dp[nt], of, ld32(vrow), ld32(vrow + 8));
      }
    }
    // dS = P (dP - delta) scale, in place of s
#pragma unroll
    for (int nt = 0; nt < M_BK / 8; ++nt)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const bool vb = (vis >> (i * 16 + nt * 2 + e)) & 1u;
          const float p = vb ? expf(s[nt][2 * i + e] * scale - my_lse[i]) : 0.f;
          s[nt][2 * i + e] = p * (dp[nt][2 * i + e] - my_delta[i]) * scale;
        }
    // dQ += dS K
#pragma unroll
    for (int kk = 0; kk < M_BK / 16; ++kk) {
      const uint32_t a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                             pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                             pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dt = 0; dt < HD / 8; ++dt) {
        const bf16* krow = Kt + (dt * 8 + gid) * TSTR + kk * 16 + 2 * tig;
        mma_bf16(acc[dt], a, ld32(krow), ld32(krow + 8));
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (!rok[i]) continue;
    bf16* orow = dq + qoff[i] + 2 * tig;
#pragma unroll
    for (int dt = 0; dt < HD / 8; ++dt)
      *reinterpret_cast<uint32_t*>(orow + dt * 8) =
          pack_bf16(acc[dt][2 * i], acc[dt][2 * i + 1]);
  }
}

__global__ void __launch_bounds__(32 * M_WARPS)
swa_train_dkv_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, const int* __restrict__ seg,
                         const bf16* __restrict__ d_o, const float* __restrict__ lse,
                         const float* __restrict__ delta, bf16* __restrict__ dk,
                         bf16* __restrict__ dv, int Tn, int Hq, int Hkv, int window,
                         float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);  // [BR][RSTR]
  bf16* Vs = Ks + M_BR * RSTR;                   // [BR][RSTR]
  bf16* Qs = Vs + M_BR * RSTR;                   // [BQ][RSTR]
  bf16* Os = Qs + M_BQ * RSTR;                   // [BQ][RSTR]  dO
  bf16* Qt = Os + M_BQ * RSTR;                   // [HD][QSTR]
  bf16* Ot = Qt + HD * QSTR;                     // [HD][QSTR]  dO transposed
  float* lse_s = reinterpret_cast<float*>(Ot + HD * QSTR);  // [BQ]
  float* delta_s = lse_s + M_BQ;                            // [BQ]

  const int G = Hq / Hkv;
  const int b = blockIdx.z, hk = blockIdx.y;
  const int k0 = blockIdx.x * M_BR;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int* segb = seg ? seg + (size_t)b * Tn : nullptr;

  bool rok[2];
  int kp[2], my_seg[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    kp[i] = k0 + warp * 16 + gid + 8 * i;
    rok[i] = kp[i] < Tn;
    my_seg[i] = (segb && rok[i]) ? segb[kp[i]] : 0;
  }
  stage_bf16(Ks, nullptr, 0, k, b, Tn, Hkv, hk, k0, M_BR);
  stage_bf16(Vs, nullptr, 0, v, b, Tn, Hkv, hk, k0, M_BR);

  float acc_k[HD / 8][4], acc_v[HD / 8][4];
#pragma unroll
  for (int dt = 0; dt < HD / 8; ++dt)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc_k[dt][c] = acc_v[dt][c] = 0.f;

  const int q_begin = k0 / M_BQ * M_BQ;
  const int q_end = query_end(k0, M_BR, window, Tn);
  for (int g = 0; g < G; ++g) {
    const int hq = hk * G + g;
    const float* lse_h = lse + ((size_t)b * Hq + hq) * Tn;
    const float* delta_h = delta + ((size_t)b * Hq + hq) * Tn;
    for (int q0 = q_begin; q0 < q_end; q0 += M_BQ) {
      uint32_t vis = 0;  // bit i*8 + nt*2 + e: key row i, query q0 + nt*8 + 2*tig + e
#pragma unroll
      for (int nt = 0; nt < M_BQ / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int qp = q0 + nt * 8 + 2 * tig + e;
          if (qp < Tn) {
            const int qs_ = segb ? segb[qp] : 0;
#pragma unroll
            for (int i = 0; i < 2; ++i)
              if (rok[i] && visible(qp, kp[i], window) && qs_ == my_seg[i])
                vis |= 1u << (i * 8 + nt * 2 + e);
          }
        }
      // also the barrier that retires the previous tile's readers (and, the
      // first time, publishes the staged K and V tiles)
      if (!__syncthreads_or(vis != 0u)) continue;

      stage_bf16(Qs, Qt, QSTR, q, b, Tn, Hq, hq, q0, M_BQ);
      stage_bf16(Os, Ot, QSTR, d_o, b, Tn, Hq, hq, q0, M_BQ);
      if (threadIdx.x < M_BQ) {
        const int qp = q0 + threadIdx.x;
        lse_s[threadIdx.x] = qp < Tn ? lse_h[qp] : 0.f;
        delta_s[threadIdx.x] = qp < Tn ? delta_h[qp] : 0.f;
      }
      __syncthreads();

      // S^T = K Q^T and dP^T = V dO^T: rows are this warp's 16 keys
      float s[M_BQ / 8][4], dp[M_BQ / 8][4];
#pragma unroll
      for (int nt = 0; nt < M_BQ / 8; ++nt)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[nt][c] = dp[nt][c] = 0.f;
#pragma unroll
      for (int ks = 0; ks < HD / 16; ++ks) {
        uint32_t kf[4], vf[4];
        lda(kf, Ks, warp * 16, ks, gid, tig);
        lda(vf, Vs, warp * 16, ks, gid, tig);
#pragma unroll
        for (int nt = 0; nt < M_BQ / 8; ++nt) {
          const bf16* qrow = Qs + (nt * 8 + gid) * RSTR + ks * 16 + 2 * tig;
          const bf16* orow = Os + (nt * 8 + gid) * RSTR + ks * 16 + 2 * tig;
          mma_bf16(s[nt], kf, ld32(qrow), ld32(qrow + 8));
          mma_bf16(dp[nt], vf, ld32(orow), ld32(orow + 8));
        }
      }
      // P^T in s, dS^T in dp
#pragma unroll
      for (int nt = 0; nt < M_BQ / 8; ++nt)
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const bool vb = (vis >> (i * 8 + nt * 2 + e)) & 1u;
            const int ql = nt * 8 + 2 * tig + e;
            const float p =
                vb ? expf(s[nt][2 * i + e] * scale - lse_s[ql]) : 0.f;
            s[nt][2 * i + e] = p;
            dp[nt][2 * i + e] = p * (dp[nt][2 * i + e] - delta_s[ql]) * scale;
          }
      // dV += P^T dO, dK += dS^T Q
#pragma unroll
      for (int kk = 0; kk < M_BQ / 16; ++kk) {
        const uint32_t ap[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                                pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                                pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                                pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
        const uint32_t ad[4] = {pack_bf16(dp[2 * kk][0], dp[2 * kk][1]),
                                pack_bf16(dp[2 * kk][2], dp[2 * kk][3]),
                                pack_bf16(dp[2 * kk + 1][0], dp[2 * kk + 1][1]),
                                pack_bf16(dp[2 * kk + 1][2], dp[2 * kk + 1][3])};
#pragma unroll
        for (int dt = 0; dt < HD / 8; ++dt) {
          const bf16* orow = Ot + (dt * 8 + gid) * QSTR + kk * 16 + 2 * tig;
          const bf16* qrow = Qt + (dt * 8 + gid) * QSTR + kk * 16 + 2 * tig;
          mma_bf16(acc_v[dt], ap, ld32(orow), ld32(orow + 8));
          mma_bf16(acc_k[dt], ad, ld32(qrow), ld32(qrow + 8));
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (!rok[i]) continue;
    const size_t off = (((size_t)b * Tn + kp[i]) * Hkv + hk) * HD + 2 * tig;
#pragma unroll
    for (int dt = 0; dt < HD / 8; ++dt) {
      *reinterpret_cast<uint32_t*>(dk + off + dt * 8) =
          pack_bf16(acc_k[dt][2 * i], acc_k[dt][2 * i + 1]);
      *reinterpret_cast<uint32_t*>(dv + off + dt * 8) =
          pack_bf16(acc_v[dt][2 * i], acc_v[dt][2 * i + 1]);
    }
  }
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
    swa_train_fwd_mma_kernel<<<dim3((T + M_BR - 1) / M_BR, Hq, B), 32 * M_WARPS, 0,
                               st>>>((const bf16*)q, (const bf16*)k, (const bf16*)v,
                                     (const int*)seg, (bf16*)out, (float*)lse, T, Hq,
                                     Hkv, window, scale);
    return (int)cudaGetLastError();
  }
  return (int)cudaErrorInvalidValue;
}

// Kernel H backward: delta = rowsum(dO * O) into `delta` [B, Hq, T] fp32
// (scratch), then dq [B, T, Hq, D] and dk, dv [B, T, Hkv, D] from q, k, v,
// the forward's `out` and `lse`, and d_out. Three launches on `stream`.
int ivl_swa_train_bwd(int dtype, const void* q, const void* k, const void* v,
                      const void* seg, const void* out, const void* d_out,
                      const void* lse, void* delta, void* dq, void* dk, void* dv,
                      int B, int T, int Hq, int Hkv, int D, int window, float scale,
                      void* stream) {
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
    if ((err = allow_smem(swa_train_dq_mma_kernel, M_DQ_SMEM)) != cudaSuccess)
      return (int)err;
    swa_train_dq_mma_kernel<<<dim3((T + M_BR - 1) / M_BR, Hq, B), 32 * M_WARPS,
                              M_DQ_SMEM, st>>>(
        (const bf16*)q, (const bf16*)k, (const bf16*)v, (const int*)seg,
        (const bf16*)d_out, (const float*)lse, (const float*)delta, (bf16*)dq, T, Hq,
        Hkv, window, scale);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    if ((err = allow_smem(swa_train_dkv_mma_kernel, M_DKV_SMEM)) != cudaSuccess)
      return (int)err;
    swa_train_dkv_mma_kernel<<<dim3((T + M_BR - 1) / M_BR, Hkv, B), 32 * M_WARPS,
                               M_DKV_SMEM, st>>>(
        (const bf16*)q, (const bf16*)k, (const bf16*)v, (const int*)seg,
        (const bf16*)d_out, (const float*)lse, (const float*)delta, (bf16*)dk,
        (bf16*)dv, T, Hq, Hkv, window, scale);
    return (int)cudaGetLastError();
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
