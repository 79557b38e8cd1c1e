// Sliding-window attention over the ring KV buffer: kernels A1 (cached
// prefill) and A2 (stacked single-token decode).
//
// A1 replaces infinitevl_tpu/ops/swa_pallas.py::swa_ring_flash_attention
// (_swa_kernel). Queries of one KV head are rows r = t*G + g at position
// cum_len + t; keys are the ring (slot s holds position
// ring_pos(cum_len, ...), invalid when negative) followed by the T new
// keys at cum_len + j. Visible iff 0 <= kp <= qp and kp > qp - window.
// The block reads the ring and the new keys through two pointers; the
// concatenated copy of the TPU wrapper is a BlockSpec artefact.
//   Bound on the H100: at T = 2048, cap = 8192 a KV head's 16,384 query
//   rows each meet up to 10,240 keys: ~86 GFLOP per head, so the kernel is
//   compute-bound. Two variants share the tiling and the masking:
//   - bf16 (the model's dtype): tensor cores through mma.sync m16n8k16
//     (bf16 operands, fp32 accumulation, as the Pallas kernel's MXU dots).
//     A block of 4 warps owns 64 query rows; each warp keeps its 16 rows'
//     Q fragments in registers, computes S = Q K^T for a 64-key tile staged
//     in shared memory, runs the online softmax on the accumulator
//     fragments, and feeds P back as the A operand of O += P V with no
//     trip through shared memory (V is staged transposed so its B
//     fragments are 32-bit loads).
//   - fp32: plain FMA from shared memory (K/V tiles of 64 keys reused by
//     32 query rows); tensor cores would round fp32 operands.
//   Both skip a tile whose whole mask is empty before loading it (the
//   unwritten ring at cum_len = 0, future keys of early rows).
//
// A2 replaces infinitevl_tpu/ops/swa_pallas.py::swa_ring_flash_decode_stacked
// (_swa_decode_kernel_stacked). The wrapper writes the token's K/V into
// slot cum_len % cap of layer `layer` first (torch, same stream); the
// kernel then attends over that layer's ring alone. Correct only for
// cap >= window: the evicted token n - cap is then never visible.
//   Bound on the H100: reading the layer's ring, 2 x cap x D x 2 bytes per
//   KV head (4 MB per KV head at cap = 8192, bf16). A grid of (B, Hkv)
//   would fill 2 of 132 SMs at B = 1, so the ring is split into chunks of
//   `split_len` keys, one block each (split-KV), and a second kernel
//   combines the partial softmax states.
#include "common.cuh"

namespace {

using ivl::NEG_INF;
using ivl::from_f;
using ivl::ld32;
using ivl::mma_bf16;
using ivl::pack_bf16;
using ivl::to_f;

constexpr int HD = 128;  // head dim the kernels are written for

// ---------------------------------------------------------------- A1
constexpr int A1_BR = 32;       // query rows per block
constexpr int A1_BK = 64;       // keys per tile
constexpr int A1_THREADS = 128; // 4 threads per query row
constexpr int A1_SMEM_FLOATS =
    A1_BR * (HD + 1) + A1_BK * (HD + 1) + A1_BK * HD + A1_BR * (A1_BK + 1);

template <typename T>
__global__ void __launch_bounds__(A1_THREADS)
swa_prefill_kernel(const T* __restrict__ q,       // [B, Tn, Hq, HD]
                   const T* __restrict__ new_k,   // [B, Tn, Hkv, HD]
                   const T* __restrict__ new_v,
                   const T* __restrict__ ring_k,  // [B, Hkv, cap, HD]
                   const T* __restrict__ ring_v,
                   T* __restrict__ out,           // [B, Tn, Hq, HD]
                   int Tn, int Hq, int Hkv, int cap, int cum_len, int window,
                   float scale) {
  extern __shared__ float smem[];
  float* Qs = smem;                     // [BR][HD + 1]
  float* Ks = Qs + A1_BR * (HD + 1);    // [BK][HD + 1]
  float* Vs = Ks + A1_BK * (HD + 1);    // [BK][HD]
  float* Ps = Vs + A1_BK * HD;          // [BR][BK + 1]

  const int G = Hq / Hkv;
  const int b = blockIdx.x / Hkv;
  const int h = blockIdx.x % Hkv;
  const int R = Tn * G;
  const int row0 = blockIdx.y * A1_BR;
  const int tid = threadIdx.x;
  const int r_loc = tid >> 2;  // this thread's query row in the block
  const int c4 = tid & 3;      // column phase: keys c4 + 4m, dims c4 + 4i
  const int row = row0 + r_loc;
  const bool row_ok = row < R;
  const int t = row_ok ? row / G : 0;
  const int g = row_ok ? row % G : 0;
  const int qp = cum_len + t;
  const int m0 = ivl::pos_mod(cum_len - 1, cap);

  for (int i = tid; i < A1_BR * HD; i += A1_THREADS) {
    const int rr = i / HD, d = i % HD;
    const int grow = row0 + rr;
    float val = 0.f;
    if (grow < R) {
      const int tt = grow / G, gg = grow % G;
      val = to_f(q[(((size_t)b * Tn + tt) * Hq + h * G + gg) * HD + d]);
    }
    Qs[rr * (HD + 1) + d] = val;
  }

  float m_i = NEG_INF, l_i = 0.f;
  float acc[HD / 4];
#pragma unroll
  for (int i = 0; i < HD / 4; ++i) acc[i] = 0.f;

  for (int seg = 0; seg < 2; ++seg) {
    // seg 0: ring slots [0, cap); seg 1: the Tn new keys
    const int nkeys = seg == 0 ? cap : Tn;
    const T* kbase = seg == 0 ? ring_k + ((size_t)b * Hkv + h) * cap * HD
                              : new_k + ((size_t)b * Tn * Hkv + h) * HD;
    const T* vbase = seg == 0 ? ring_v + ((size_t)b * Hkv + h) * cap * HD
                              : new_v + ((size_t)b * Tn * Hkv + h) * HD;
    const size_t kstride = seg == 0 ? (size_t)HD : (size_t)Hkv * HD;

    for (int k0 = 0; k0 < nkeys; k0 += A1_BK) {
      unsigned vis = 0;  // bit m: key k0 + c4 + 4m visible to this row
#pragma unroll
      for (int m = 0; m < A1_BK / 4; ++m) {
        const int j = k0 + c4 + 4 * m;
        if (row_ok && j < nkeys) {
          const int kp = seg == 0 ? ivl::ring_pos(cum_len, m0, j, cap) : cum_len + j;
          if (kp >= 0 && kp <= qp && kp > qp - window) vis |= 1u << m;
        }
      }
      // also the barrier that retires the previous tile's readers
      if (!__syncthreads_or(vis != 0u)) continue;

      for (int i = tid; i < A1_BK * HD; i += A1_THREADS) {
        const int jj = i / HD, d = i % HD;
        const int j = k0 + jj;
        float kv = 0.f, vv = 0.f;
        if (j < nkeys) {
          kv = to_f(kbase[(size_t)j * kstride + d]);
          vv = to_f(vbase[(size_t)j * kstride + d]);
        }
        Ks[jj * (HD + 1) + d] = kv;
        Vs[jj * HD + d] = vv;
      }
      __syncthreads();

      float s[A1_BK / 4];
#pragma unroll
      for (int m = 0; m < A1_BK / 4; ++m) s[m] = 0.f;
      for (int d = 0; d < HD; ++d) {
        const float qv = Qs[r_loc * (HD + 1) + d];
#pragma unroll
        for (int m = 0; m < A1_BK / 4; ++m) s[m] += qv * Ks[(c4 + 4 * m) * (HD + 1) + d];
      }

      float tile_max = NEG_INF;
#pragma unroll
      for (int m = 0; m < A1_BK / 4; ++m) {
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
      for (int m = 0; m < A1_BK / 4; ++m) {
        const float p = (vis >> m & 1u) ? expf(s[m] - m_new) : 0.f;
        psum += p;
        Ps[r_loc * (A1_BK + 1) + c4 + 4 * m] = p;
      }
      psum += __shfl_xor_sync(0xffffffffu, psum, 1);
      psum += __shfl_xor_sync(0xffffffffu, psum, 2);
      l_i = l_i * alpha + psum;
      m_i = m_new;
#pragma unroll
      for (int i = 0; i < HD / 4; ++i) acc[i] *= alpha;
      __syncthreads();

      for (int jj = 0; jj < A1_BK; ++jj) {
        const float p = Ps[r_loc * (A1_BK + 1) + jj];
        const float* vrow = Vs + jj * HD + c4;
#pragma unroll
        for (int i = 0; i < HD / 4; ++i) acc[i] += p * vrow[4 * i];
      }
    }
  }

  if (row_ok) {
    const float inv = 1.f / fmaxf(l_i, 1e-30f);
    T* o = out + (((size_t)b * Tn + t) * Hq + h * G + g) * HD + c4;
#pragma unroll
    for (int i = 0; i < HD / 4; ++i) o[4 * i] = from_f<T>(acc[i] * inv);
  }
}

template <typename T>
cudaError_t launch_prefill(const void* q, const void* nk, const void* nv,
                           const void* rk, const void* rv, void* out, int B,
                           int Tn, int Hq, int Hkv, int cap, int cum_len,
                           int window, float scale, cudaStream_t stream) {
  const int smem = A1_SMEM_FLOATS * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      swa_prefill_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int R = Tn * (Hq / Hkv);
  dim3 grid(B * Hkv, (R + A1_BR - 1) / A1_BR);
  swa_prefill_kernel<T><<<grid, A1_THREADS, smem, stream>>>(
      (const T*)q, (const T*)nk, (const T*)nv, (const T*)rk, (const T*)rv,
      (T*)out, Tn, Hq, Hkv, cap, cum_len, window, scale);
  return cudaGetLastError();
}

// A1, bf16 variant on tensor cores
constexpr int M_WARPS = 4;
constexpr int M_BR = 16 * M_WARPS;  // query rows per block
constexpr int M_BK = 64;            // keys per tile
constexpr int KSTR = HD + 8;        // bf16 per row of Ks[key][d] (conflict-free B loads)
constexpr int VSTR = M_BK + 8;      // bf16 per row of Vt[d][key]

// Fragment layout of m16n8k16: see ivl::mma_bf16. Here S accumulators
// s[nt] cover keys nt*8 .. nt*8+7 of the tile.
__global__ void __launch_bounds__(32 * M_WARPS)
swa_prefill_mma_kernel(const __nv_bfloat16* __restrict__ q,      // [B, Tn, Hq, HD]
                       const __nv_bfloat16* __restrict__ new_k,  // [B, Tn, Hkv, HD]
                       const __nv_bfloat16* __restrict__ new_v,
                       const __nv_bfloat16* __restrict__ ring_k, // [B, Hkv, cap, HD]
                       const __nv_bfloat16* __restrict__ ring_v,
                       __nv_bfloat16* __restrict__ out,          // [B, Tn, Hq, HD]
                       int Tn, int Hq, int Hkv, int cap, int cum_len, int window,
                       float scale) {
  __shared__ __align__(16) __nv_bfloat16 Ks[M_BK * KSTR];
  __shared__ __align__(16) __nv_bfloat16 Vt[HD * VSTR];

  const int G = Hq / Hkv;
  const int b = blockIdx.x / Hkv;
  const int h = blockIdx.x % Hkv;
  const int R = Tn * G;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int m0 = ivl::pos_mod(cum_len - 1, cap);

  // this thread's two query rows: gid and gid + 8 of the warp's 16
  bool rok[2];
  int qp[2];
  size_t qoff[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = blockIdx.y * M_BR + warp * 16 + gid + 8 * i;
    rok[i] = row < R;
    const int t = rok[i] ? row / G : 0;
    const int gq = rok[i] ? row % G : 0;
    qp[i] = cum_len + t;
    qoff[i] = (((size_t)b * Tn + t) * Hq + h * G + gq) * HD;
  }
  uint32_t qf[HD / 16][4];  // A fragments of the warp's 16 x HD query tile
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

  for (int seg = 0; seg < 2; ++seg) {
    // seg 0: ring slots [0, cap); seg 1: the Tn new keys
    const int nkeys = seg == 0 ? cap : Tn;
    const __nv_bfloat16* kbase = seg == 0 ? ring_k + ((size_t)b * Hkv + h) * cap * HD
                                          : new_k + ((size_t)b * Tn * Hkv + h) * HD;
    const __nv_bfloat16* vbase = seg == 0 ? ring_v + ((size_t)b * Hkv + h) * cap * HD
                                          : new_v + ((size_t)b * Tn * Hkv + h) * HD;
    const size_t kstride = seg == 0 ? (size_t)HD : (size_t)Hkv * HD;

    for (int k0 = 0; k0 < nkeys; k0 += M_BK) {
      uint32_t vis = 0;  // bit i*16 + nt*2 + e: row i, key k0 + nt*8 + 2*tig + e
#pragma unroll
      for (int nt = 0; nt < M_BK / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int j = k0 + nt * 8 + 2 * tig + e;
          if (j < nkeys) {
            const int kp = seg == 0 ? ivl::ring_pos(cum_len, m0, j, cap) : cum_len + j;
#pragma unroll
            for (int i = 0; i < 2; ++i)
              if (rok[i] && kp >= 0 && kp <= qp[i] && kp > qp[i] - window)
                vis |= 1u << (i * 16 + nt * 2 + e);
          }
        }
      // also the barrier that retires the previous tile's readers
      if (!__syncthreads_or(vis != 0u)) continue;

      for (int c = threadIdx.x; c < M_BK * HD / 8; c += 32 * M_WARPS) {
        const int key = c / (HD / 8), d0 = (c % (HD / 8)) * 8;
        const int j = k0 + key;
        uint4 kv = make_uint4(0u, 0u, 0u, 0u), vv = make_uint4(0u, 0u, 0u, 0u);
        if (j < nkeys) {
          kv = *reinterpret_cast<const uint4*>(kbase + (size_t)j * kstride + d0);
          vv = *reinterpret_cast<const uint4*>(vbase + (size_t)j * kstride + d0);
        }
        *reinterpret_cast<uint4*>(&Ks[key * KSTR + d0]) = kv;
        const __nv_bfloat16* ve = reinterpret_cast<const __nv_bfloat16*>(&vv);
#pragma unroll
        for (int e = 0; e < 8; ++e) Vt[(d0 + e) * VSTR + key] = ve[e];
      }
      __syncthreads();

      float s[M_BK / 8][4];
#pragma unroll
      for (int nt = 0; nt < M_BK / 8; ++nt) {
        s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
        const __nv_bfloat16* krow = Ks + (nt * 8 + gid) * KSTR + 2 * tig;
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
            const bool v = (vis >> (i * 16 + nt * 2 + e)) & 1u;
            s[nt][2 * i + e] = v ? s[nt][2 * i + e] * scale : NEG_INF;
            mx[i] = fmaxf(mx[i], s[nt][2 * i + e]);
          }
      float alpha[2], psum[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        // the 4 lanes of a row group share the row
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
            const bool v = (vis >> (i * 16 + nt * 2 + e)) & 1u;
            const float p = v ? expf(s[nt][2 * i + e] - m_r[i]) : 0.f;
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

      // O += P V: P (bf16, as the Pallas kernel's p.astype(v.dtype)) is the
      // A operand straight from the S accumulators, 16 keys per k-step
#pragma unroll
      for (int kk = 0; kk < M_BK / 16; ++kk) {
        const uint32_t a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                               pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                               pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                               pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
        for (int dt = 0; dt < HD / 8; ++dt) {
          const __nv_bfloat16* vrow = Vt + (dt * 8 + gid) * VSTR + kk * 16 + 2 * tig;
          mma_bf16(o[dt], a, ld32(vrow), ld32(vrow + 8));
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (!rok[i]) continue;
    const float inv = 1.f / fmaxf(l_r[i], 1e-30f);
    __nv_bfloat16* orow = out + qoff[i] + 2 * tig;
#pragma unroll
    for (int dt = 0; dt < HD / 8; ++dt)
      *reinterpret_cast<uint32_t*>(orow + dt * 8) =
          pack_bf16(o[dt][2 * i] * inv, o[dt][2 * i + 1] * inv);
  }
}

cudaError_t launch_prefill_mma(const void* q, const void* nk, const void* nv,
                               const void* rk, const void* rv, void* out, int B,
                               int Tn, int Hq, int Hkv, int cap, int cum_len,
                               int window, float scale, cudaStream_t stream) {
  const int R = Tn * (Hq / Hkv);
  dim3 grid(B * Hkv, (R + M_BR - 1) / M_BR);
  using bf = __nv_bfloat16;
  swa_prefill_mma_kernel<<<grid, 32 * M_WARPS, 0, stream>>>(
      (const bf*)q, (const bf*)nk, (const bf*)nv, (const bf*)rk, (const bf*)rv,
      (bf*)out, Tn, Hq, Hkv, cap, cum_len, window, scale);
  return cudaGetLastError();
}

// ---------------------------------------------------------------- A2
constexpr int A2_BK = 32;        // keys per shared-memory sub-tile (one per lane)
constexpr int A2_THREADS = 128;  // 4 warps; warp w owns query rows w, w+4, ...
constexpr int A2_MAXG = 16;      // query heads per KV head
constexpr int A2_RPW = A2_MAXG / 4;

// Partial softmax state per (b, h, split, g): [m, l, acc[HD]]
template <typename T>
__global__ void __launch_bounds__(A2_THREADS)
swa_decode_split_kernel(const T* __restrict__ q,        // [B, Hq, HD]
                        const T* __restrict__ rings_k,  // [S, B, Hkv, cap, HD]
                        const T* __restrict__ rings_v,
                        float* __restrict__ part,       // [B*Hkv, NS, G, HD + 2]
                        int B, int Hq, int Hkv, int cap, int layer,
                        int n_written, int window, float scale, int split_len,
                        int NS) {
  __shared__ float Qs[A2_MAXG][HD];
  __shared__ float Ks[A2_BK][HD + 1];
  __shared__ float Vs[A2_BK][HD];

  const int G = Hq / Hkv;
  const int bh = blockIdx.x;
  const int b = bh / Hkv, h = bh % Hkv;
  const int split = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const size_t ring_off = (((size_t)layer * B + b) * Hkv + h) * (size_t)cap * HD;
  const T* kb = rings_k + ring_off;
  const T* vb = rings_v + ring_off;

  for (int i = tid; i < G * HD; i += A2_THREADS)
    Qs[i / HD][i % HD] = to_f(q[((size_t)b * Hq + h * G + i / HD) * HD + i % HD]);

  const int qp = n_written - 1;  // the query is the token just written
  const int m0 = ivl::pos_mod(qp, cap);
  float m_r[A2_RPW], l_r[A2_RPW], acc[A2_RPW][HD / 32];
#pragma unroll
  for (int rr = 0; rr < A2_RPW; ++rr) {
    m_r[rr] = NEG_INF;
    l_r[rr] = 0.f;
#pragma unroll
    for (int c = 0; c < HD / 32; ++c) acc[rr][c] = 0.f;
  }

  const int s0 = split * split_len;
  const int s1 = min(s0 + split_len, cap);
  for (int k0 = s0; k0 < s1; k0 += A2_BK) {
    const int j = k0 + lane;
    bool vis = false;
    if (j < s1) {
      const int kp = ivl::ring_pos(n_written, m0, j, cap);
      vis = kp >= 0 && kp <= qp && kp > qp - window;
    }
    // also the barrier that retires the previous sub-tile's readers
    if (!__syncthreads_or(vis)) continue;

    for (int i = tid; i < A2_BK * HD; i += A2_THREADS) {
      const int jj = i / HD, d = i % HD;
      const int js = k0 + jj;
      Ks[jj][d] = js < s1 ? to_f(kb[(size_t)js * HD + d]) : 0.f;
      Vs[jj][d] = js < s1 ? to_f(vb[(size_t)js * HD + d]) : 0.f;
    }
    __syncthreads();

#pragma unroll
    for (int rr = 0; rr < A2_RPW; ++rr) {
      const int g = warp + 4 * rr;
      if (g < G) {  // warp-uniform
        float s = 0.f;
        for (int d = 0; d < HD; ++d) s += Qs[g][d] * Ks[lane][d];
        s = vis ? s * scale : NEG_INF;
        const float m_new = fmaxf(m_r[rr], ivl::warp_max(s));
        const float alpha = expf(m_r[rr] - m_new);
        const float p = vis ? expf(s - m_new) : 0.f;
        l_r[rr] = l_r[rr] * alpha + ivl::warp_sum(p);
        m_r[rr] = m_new;
#pragma unroll
        for (int c = 0; c < HD / 32; ++c) acc[rr][c] *= alpha;
        for (int jj = 0; jj < A2_BK; ++jj) {
          const float pj = __shfl_sync(0xffffffffu, p, jj);
#pragma unroll
          for (int c = 0; c < HD / 32; ++c) acc[rr][c] += pj * Vs[jj][lane + 32 * c];
        }
      }
    }
  }

#pragma unroll
  for (int rr = 0; rr < A2_RPW; ++rr) {
    const int g = warp + 4 * rr;
    if (g < G) {
      float* pp = part + (((size_t)bh * NS + split) * G + g) * (HD + 2);
      if (lane == 0) {
        pp[0] = m_r[rr];
        pp[1] = l_r[rr];
      }
#pragma unroll
      for (int c = 0; c < HD / 32; ++c) pp[2 + lane + 32 * c] = acc[rr][c];
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(HD)
swa_decode_combine_kernel(const float* __restrict__ part, T* __restrict__ out,
                          int Hq, int Hkv, int NS) {
  const int G = Hq / Hkv;
  const int bh = blockIdx.x;
  const int b = bh / Hkv, h = bh % Hkv;
  const int g = blockIdx.y;
  const int d = threadIdx.x;
  float M = NEG_INF;
  for (int s = 0; s < NS; ++s)
    M = fmaxf(M, part[(((size_t)bh * NS + s) * G + g) * (HD + 2)]);
  float L = 0.f, A = 0.f;
  for (int s = 0; s < NS; ++s) {
    const float* pp = part + (((size_t)bh * NS + s) * G + g) * (HD + 2);
    const float w = expf(pp[0] - M);
    L += w * pp[1];
    A += w * pp[2 + d];
  }
  out[((size_t)b * Hq + h * G + g) * HD + d] = from_f<T>(A / fmaxf(L, 1e-30f));
}

template <typename T>
cudaError_t launch_decode(const void* q, const void* rk, const void* rv,
                          void* part, void* out, int B, int Hq, int Hkv,
                          int cap, int layer, int n_written, int window,
                          float scale, int split_len, int NS,
                          cudaStream_t stream) {
  dim3 grid(B * Hkv, NS);
  swa_decode_split_kernel<T><<<grid, A2_THREADS, 0, stream>>>(
      (const T*)q, (const T*)rk, (const T*)rv, (float*)part, B, Hq, Hkv, cap,
      layer, n_written, window, scale, split_len, NS);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  swa_decode_combine_kernel<T><<<dim3(B * Hkv, Hq / Hkv), HD, 0, stream>>>(
      (const float*)part, (T*)out, Hq, Hkv, NS);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// A1. Returns a cudaError_t code (0 = success).
int ivl_swa_prefill(int dtype, const void* q, const void* new_k,
                    const void* new_v, const void* ring_k, const void* ring_v,
                    void* out, int B, int Tn, int Hq, int Hkv, int D, int cap,
                    int cum_len, int window, float scale, void* stream) {
  if (D != HD || Hq % Hkv != 0 || cap <= 0 || Tn <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == ivl::DTYPE_F32)
    return (int)launch_prefill<float>(q, new_k, new_v, ring_k, ring_v, out, B,
                                      Tn, Hq, Hkv, cap, cum_len, window, scale, st);
  if (dtype == ivl::DTYPE_BF16)
    return (int)launch_prefill_mma(q, new_k, new_v, ring_k, ring_v, out, B, Tn,
                                   Hq, Hkv, cap, cum_len, window, scale, st);
  return (int)cudaErrorInvalidValue;
}

// A2 (attention part; the K/V write precedes it on the same stream).
// n_written counts the tokens in the ring INCLUDING the one just written.
int ivl_swa_decode(int dtype, const void* q, const void* rings_k,
                   const void* rings_v, void* part, void* out, int B, int Hq,
                   int Hkv, int D, int cap, int layer, int n_written,
                   int window, float scale, int split_len, int NS,
                   void* stream) {
  if (D != HD || Hq % Hkv != 0 || Hq / Hkv > A2_MAXG || split_len <= 0 ||
      NS * split_len < cap)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == ivl::DTYPE_F32)
    return (int)launch_decode<float>(q, rings_k, rings_v, part, out, B, Hq, Hkv,
                                     cap, layer, n_written, window, scale,
                                     split_len, NS, st);
  if (dtype == ivl::DTYPE_BF16)
    return (int)launch_decode<__nv_bfloat16>(q, rings_k, rings_v, part, out, B,
                                             Hq, Hkv, cap, layer, n_written,
                                             window, scale, split_len, NS, st);
  return (int)cudaErrorInvalidValue;
}

const char* ivl_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
