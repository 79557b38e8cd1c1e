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
//   compute-bound; a 448x448 frame (T = 257) is ~17.5 GFLOP against 8.4 MB
//   of ring, still compute-bound but only 66 query tiles of 64 rows.
//   - bf16 (the model's dtype): the wgmma + TMA mainloop it shares with
//     kernel H's forward (swa_fwd_wgmma.cuh). A block's 64 query rows are
//     8 tokens x the 8 query heads of one KV head (a GQA-packed TMA box),
//     so every K/V stage serves them all. Where the query tiles leave the
//     card short (T = 257: 66 blocks on 132 SMs) the key tiles are split
//     over blocks (split-KV, plan in ops/swa_kernels.prefill_split_plan);
//     each writes a partial (m, l, acc) in fp32 and a combine pass adds
//     them in a fixed order. A ring tile that does not straddle the write
//     point holds 64 consecutive positions: one interval test decides that
//     every (row, key) pair sees it, and only tiles at the window's lower
//     edge, at the write point or on the new keys' diagonal are masked
//     element by element. P is rounded to bf16 before P V, as the Pallas
//     kernel's p.astype(v.dtype).
//   - fp32: plain FMA from shared memory (K/V tiles of 64 keys reused by
//     32 query rows); tensor cores would round fp32 operands.
//   Both skip a tile whose whole mask is empty before loading it (the
//   unwritten ring at cum_len = 0, future keys of early rows, ring slots
//   below every row's window).
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
#include "swa_fwd_wgmma.cuh"

namespace {

using ivl::NEG_INF;
using ivl::from_f;
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

// A1, bf16: the shared wgmma + TMA mainloop (swa_fwd_wgmma.cuh) with the
// ring as its key source. A block owns 64 query rows of one KV head (rows
// r = t G + g: 64 / G tokens x the G query heads, so one K/V stage serves
// them all) and one split of the key tiles: of the
// ring's ceil(cap / 64) tiles, then the new keys' ceil(T / 64), split s
// takes tiles s, s + split, s + 2 split, ... (interleaved, so that the
// skipped tiles of an unfilled ring and the masked diagonal spread over
// the splits). With split > 1 the block writes its partial softmax state
// (m, l, acc) in fp32 and swa_prefill_combine_kernel adds the splits in
// order.
constexpr int A1_PART = HD + 4;  // floats per row of a partial: m, l, 2 unused, acc

struct RingSrc {
  static constexpr int D = HD, CWG = 1;
  static constexpr bool FAST = false;
  static constexpr bool VOTE = false;  // invisible tiles are skipped before their TMA
  struct Row {
    int qp;
    bool ok;
  };
  const CUtensorMap *qmap, *rkmap, *rvmap, *nkmap, *nvmap;
  __nv_bfloat16* out;
  float* part;
  size_t n_rows;  // B Hkv T G: the rows of one split's partials
  int b, h, G, Tn, Hq, Hkv, cap, cum, window, m0, r0, qlo, qhi, nR, n, sp, split;

  __device__ int pos(int slot) const { return ivl::ring_pos(cum, m0, slot, cap); }
  __device__ int count() const { return n; }

  // a tile none of the block's rows can see: the unwritten ring, slots
  // below every row's window, new keys after every row
  __device__ bool skip(int i) const {
    const int gt = sp + i * split;  // the split takes every split-th tile
    if (gt < nR) {
      const int j0 = gt * ivl::FW_T, j1 = min(j0 + ivl::FW_T, cap);
      const int top = pos(j0 <= m0 ? min(j1 - 1, m0) : j1 - 1);  // the tile's newest position
      return top < 0 || top <= qlo - window;
    }
    const int k0 = (gt - nR) * ivl::FW_T;
    return cum + k0 > qhi || cum + min(k0 + ivl::FW_T, Tn) - 1 <= qlo - window;
  }
  __device__ void load_q(unsigned char* Qs, uint64_t* bar) const {
    ivl::mbar_arrive_tx(bar, ivl::FW_TILE);
    ivl::tile_load(Qs, qmap, bar, h * G, r0 / G, b);  // a GQA-packed box: 64 / G tokens x G heads
  }
  __device__ void load(int i, unsigned char* st, uint64_t* bar, int lane) const {
    if (lane != 0) {
      ivl::mbar_arrive(bar);
      return;
    }
    ivl::mbar_arrive_tx(bar, 2 * ivl::FW_TILE);
    const int gt = sp + i * split;  // the split takes every split-th tile
    if (gt < nR) {  // ring slots j0 ..: TMA's zeros past cap
      ivl::tile_load(st, rkmap, bar, gt * ivl::FW_T, h, b);
      ivl::tile_load(st + ivl::FW_TILE, rvmap, bar, gt * ivl::FW_T, h, b);
    } else {  // new keys k0 ..: zeros past T
      ivl::tile_load(st, nkmap, bar, h, (gt - nR) * ivl::FW_T, b);
      ivl::tile_load(st + ivl::FW_TILE, nvmap, bar, h, (gt - nR) * ivl::FW_T, b);
    }
  }
  __device__ Row row(int r) const {
    const int t = (r0 + r) / G;
    return Row{cum + t, t < Tn};
  }
  // the interval test: a ring tile that does not straddle the write point
  // m0 holds 64 consecutive positions, new keys are consecutive anyway
  __device__ bool whole(int i) const {
    if (qhi - qlo != 64 / G - 1) return false;  // ragged rows past T
    const int qa = qlo, qb = qhi;
    const int gt = sp + i * split;  // the split takes every split-th tile
    int lo, hi;
    if (gt < nR) {
      const int j0 = gt * ivl::FW_T;
      if (j0 + ivl::FW_T > cap || (j0 <= m0 && m0 < j0 + ivl::FW_T - 1)) return false;
      lo = pos(j0);
      hi = pos(j0 + ivl::FW_T - 1);
    } else {
      const int k0 = (gt - nR) * ivl::FW_T;
      if (k0 + ivl::FW_T > Tn) return false;
      lo = cum + k0;
      hi = lo + ivl::FW_T - 1;
    }
    return lo >= 0 && hi <= qa && lo > qb - window;
  }
  __device__ bool sees(int i, const unsigned char*, const Row& w, int kl) const {
    const int gt = sp + i * split;  // the split takes every split-th tile
    int kp;
    if (gt < nR) {
      const int slot = gt * ivl::FW_T + kl;
      kp = slot < cap ? pos(slot) : -1;
    } else {
      const int j = (gt - nR) * ivl::FW_T + kl;
      kp = j < Tn ? cum + j : -1;
    }
    return w.ok && kp >= 0 && kp <= w.qp && kp > w.qp - window;
  }
  __device__ void store(int r, int tig, const float (&acc)[64], const float (&m)[2],
                        const float (&l)[2]) const {
#pragma unroll
    for (int ii = 0; ii < 2; ++ii) {
      const int rr = r0 + r + 8 * ii, t = rr / G;
      if (t >= Tn) continue;
      if (split == 1) {
        const float inv = 1.f / fmaxf(l[ii], 1e-30f);
        __nv_bfloat16* o = out + (((size_t)b * Tn + t) * Hq + h * G + rr % G) * HD + 2 * tig;
#pragma unroll
        for (int j = 0; j < 16; ++j)
          *reinterpret_cast<uint32_t*>(o + 8 * j) =
              pack_bf16(acc[4 * j + 2 * ii] * inv, acc[4 * j + 2 * ii + 1] * inv);
      } else {
        float* pp = part + ((size_t)sp * n_rows + ((size_t)b * Hkv + h) * Tn * G + rr) * A1_PART;
        if (tig == 0) {
          pp[0] = m[ii];
          pp[1] = l[ii];
        }
#pragma unroll
        for (int j = 0; j < 16; ++j)
          *reinterpret_cast<float2*>(pp + 4 + 8 * j + 2 * tig) =
              make_float2(acc[4 * j + 2 * ii], acc[4 * j + 2 * ii + 1]);
      }
    }
  }
};

// grid: (query tile, batch row, KV head, split) with the split innermost
__global__ void __launch_bounds__(ivl::FW_THREADS, 2)
swa_prefill_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                         const __grid_constant__ CUtensorMap rkmap,
                         const __grid_constant__ CUtensorMap rvmap,
                         const __grid_constant__ CUtensorMap nkmap,
                         const __grid_constant__ CUtensorMap nvmap,
                         __nv_bfloat16* __restrict__ out, float* __restrict__ part, int B,
                         int Tn, int Hq, int Hkv, int cap, int cum_len, int window, int split,
                         float scale) {
  extern __shared__ unsigned char smem_raw[];
  RingSrc src;
  src.qmap = &qmap;
  src.rkmap = &rkmap;
  src.rvmap = &rvmap;
  src.nkmap = &nkmap;
  src.nvmap = &nvmap;
  src.out = out;
  src.part = part;
  src.G = Hq / Hkv;
  src.Tn = Tn;
  src.Hq = Hq;
  src.Hkv = Hkv;
  src.cap = cap;
  src.cum = cum_len;
  src.window = window;
  src.split = split;
  src.m0 = ivl::pos_mod(cum_len - 1, cap);
  src.n_rows = (size_t)B * Hkv * Tn * src.G;
  int rest = blockIdx.x;
  src.sp = rest % split;
  rest /= split;
  src.h = rest % Hkv;
  rest /= Hkv;
  src.b = rest % B;
  src.r0 = (rest / B) * 64;
  const int t_first = src.r0 / src.G;
  const int t_last = min((src.r0 + 63) / src.G, Tn - 1);
  src.qlo = cum_len + t_first;
  src.qhi = cum_len + t_last;
  src.nR = (cap + ivl::FW_T - 1) / ivl::FW_T;
  const int n_tiles = src.nR + (Tn + ivl::FW_T - 1) / ivl::FW_T;
  src.n = max(0, (n_tiles - src.sp + split - 1) / split);
  ivl::fwd_mainloop(src, ivl::aligned_smem(smem_raw), scale);
}

// out = the splits' partials of each row added in the order s = 0, 1, ...:
// one warp per row (b, h, r = t G + g), four dims a lane (A2's combine
// generalised to many rows)
__global__ void __launch_bounds__(128)
swa_prefill_combine_kernel(const float* __restrict__ part, __nv_bfloat16* __restrict__ out,
                           int B, int Tn, int Hq, int Hkv, int split) {
  const int G = Hq / Hkv, R = Tn * G;
  const size_t n_rows = (size_t)B * Hkv * R;
  const size_t row = (size_t)blockIdx.x * 4 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= n_rows) return;
  float M = NEG_INF;
  for (int s = 0; s < split; ++s) M = fmaxf(M, part[(s * n_rows + row) * A1_PART]);
  float L = 0.f;
  float4 A = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int s = 0; s < split; ++s) {
    const float* pp = part + (s * n_rows + row) * A1_PART;
    const float w = exp2f(pp[0] - M);  // m in units of log2 (swa_fwd_wgmma.cuh)
    const float4 a = *reinterpret_cast<const float4*>(pp + 4 + 4 * lane);
    L += w * pp[1];
    A.x += w * a.x;
    A.y += w * a.y;
    A.z += w * a.z;
    A.w += w * a.w;
  }
  const float inv = 1.f / fmaxf(L, 1e-30f);
  const int bh = (int)(row / R), r = (int)(row % R);
  const int b = bh / Hkv, h = bh % Hkv, t = r / G, g = r % G;
  __nv_bfloat16* o = out + (((size_t)b * Tn + t) * Hq + h * G + g) * HD + 4 * lane;
  *reinterpret_cast<uint2*>(o) = make_uint2(pack_bf16(A.x * inv, A.y * inv),
                                            pack_bf16(A.z * inv, A.w * inv));
}

// a 4-D map over a [B, d2, d1, 128] bf16 tensor (dims innermost first: 128,
// d1, d2, B) with boxes of 64 columns x box1 x box2 x 1
bool map4(CUtensorMap* map, const void* base, int d1, int d2, int B, int box1, int box2) {
  const cuuint64_t dims[4] = {HD, (cuuint64_t)d1, (cuuint64_t)d2, (cuuint64_t)B};
  const cuuint64_t strides[3] = {HD * 2, (cuuint64_t)d1 * HD * 2, (cuuint64_t)d2 * d1 * HD * 2};
  const cuuint32_t box[4] = {64, (cuuint32_t)box1, (cuuint32_t)box2, 1};
  return ivl::make_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, base, dims, strides, box,
                       CU_TENSOR_MAP_SWIZZLE_128B);
}

// A1 in bf16; with split > 1, `part` is fp32 scratch [split, B Hkv T G,
// HD + 4] and a second launch combines it into `out`.
cudaError_t launch_prefill_bf16(const void* q, const void* nk, const void* nv, const void* rk,
                                const void* rv, void* out, void* part, int B, int Tn, int Hq,
                                int Hkv, int cap, int cum_len, int window, int split,
                                float scale, cudaStream_t stream) {
  const int G = Hq / Hkv;
  if (64 % G != 0 || split <= 0 || (split > 1 && part == nullptr)) return cudaErrorInvalidValue;
  CUtensorMap maps[5];
  if (!map4(&maps[0], q, Hq, Tn, B, G, 64 / G) || !map4(&maps[1], rk, cap, Hkv, B, 64, 1) ||
      !map4(&maps[2], rv, cap, Hkv, B, 64, 1) || !map4(&maps[3], nk, Hkv, Tn, B, 1, 64) ||
      !map4(&maps[4], nv, Hkv, Tn, B, 1, 64))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(swa_prefill_wgmma_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, ivl::FW_SMEM);
  if (err != cudaSuccess) return err;
  const long long blocks = ((long long)Tn * G + 63) / 64 * B * Hkv * split;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  swa_prefill_wgmma_kernel<<<(unsigned)blocks, ivl::FW_THREADS, ivl::FW_SMEM, stream>>>(
      maps[0], maps[1], maps[2], maps[3], maps[4], (__nv_bfloat16*)out, (float*)part, B, Tn, Hq,
      Hkv, cap, cum_len, window, split, scale);
  if ((err = cudaGetLastError()) != cudaSuccess || split == 1) return err;
  const size_t n_rows = (size_t)B * Hkv * Tn * G;
  swa_prefill_combine_kernel<<<(unsigned)((n_rows + 3) / 4), 128, 0, stream>>>(
      (const float*)part, (__nv_bfloat16*)out, B, Tn, Hq, Hkv, split);
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
// bf16 takes `split` (the key tiles split over that many blocks; scratch
// `part` when above 1); fp32 ignores it.
int ivl_swa_prefill(int dtype, const void* q, const void* new_k,
                    const void* new_v, const void* ring_k, const void* ring_v,
                    void* out, void* part, int B, int Tn, int Hq, int Hkv, int D, int cap,
                    int cum_len, int window, int split, float scale, void* stream) {
  if (D != HD || Hq % Hkv != 0 || cap <= 0 || Tn <= 0 || B <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == ivl::DTYPE_F32)
    return (int)launch_prefill<float>(q, new_k, new_v, ring_k, ring_v, out, B,
                                      Tn, Hq, Hkv, cap, cum_len, window, scale, st);
  if (dtype == ivl::DTYPE_BF16)
    return (int)launch_prefill_bf16(q, new_k, new_v, ring_k, ring_v, out, part, B, Tn, Hq, Hkv,
                                    cap, cum_len, window, split, scale, st);
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
