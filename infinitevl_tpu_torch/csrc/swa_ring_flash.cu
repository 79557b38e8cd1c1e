// Sliding-window attention over the ring KV buffer: kernels A1 (cached
// prefill), A2 (stacked single-token decode) and D (A2 on one ring).
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
// (_swa_decode_kernel_stacked) and D ::swa_ring_flash_decode (the same body
// on one unstacked ring, passed as a stack of one). One launch writes the
// token's K/V into slot m0 = cum_len % cap of ring `layer` and attends G =
// Hq / Hkv query heads over that ring alone under the window; a second
// combines the splits. Correct only for cap >= window: the evicted token
// cum_len - cap is then never visible.
//   Bound on the H100: bytes. At 3B (Hkv 2, cap 8192), B 1 and a full ring
//   a call reads 8.4 MB of K/V for ~67 MFLOP: 2.5 us at 3.35 TB/s. So the
//   design keeps bytes in flight and reads nothing it does not need:
//   - the walk covers only the tiles of 64 slots that hold a visible key
//     (ceil(min(cum_len + 1, window) / 64), one more where the window's edge
//     falls inside a tile), oldest first; only tiles at the window's lower
//     edge, at the write point or past cap are masked element by element;
//   - the tiles are split over blocks by a plan made from B, Hkv, the walk
//     and the card's SM count (ops/swa_kernels.decode_split_plan: about one
//     block per two SMs), and each block streams its tiles through three
//     32 KB stages by TMA (a tile of one (layer, b, h) is 16 KB of K and 16
//     KB of V, each contiguous), some 6 MB in flight over the card;
//   - the products are tensor-core mma.sync m16n8k16 in the orientation of
//     decode: keys as M and the G = 8 query heads of a KV head as N (S^T =
//     K Q^T), then D as M and keys as K (O^T += V^T P^T), with P^T moved
//     into the B operand in registers (movmatrix); no row of a tile is
//     padding at G = 8. wgmma would want 64 rows, 7/8 of them padding, for
//     a kernel that memory bounds anyway;
//   - the token's write is in the kernel: the split that walks slot m0
//     stores it, and every block takes that slot from new_k / new_v, so no
//     block reads what the writer stores;
//   - the splits' partials (m, l, acc) are added in the fixed order s = 0,
//     1, ... by the combine kernel: two calls on equal inputs agree bit for
//     bit. It is launched early (programmatic dependent launch), so its
//     start-up overlaps the walk. One split (a short walk) writes the output
//     itself: one launch.
//   fp32 (the CPU-against-card checks) keeps an FMA body on the same walk,
//   write and partials.
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
// one warp per row (b, h, r = t G + g), four dims a lane
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

// ---------------------------------------------------------------- A2 / D
// The ring is walked in tiles of DEC_T slots (tile t: slots [t DEC_T,
// (t + 1) DEC_T) below cap). The visible slots form one cyclic interval
// of n_vis = min(cum_len + 1, window) slots ending at m0 = cum_len % cap,
// so the visible tiles are n_tiles consecutive ones (mod n_ring) from
// tile0, the tile of the oldest visible slot; split s of a (b, h) takes
// walk steps [s tps, (s + 1) tps). ops/swa_kernels.decode_split_plan
// chooses tps and the split count and decode_tile_walk is the walk's plain
// twin: the two must agree with DecWalk.
constexpr int DEC_T = 64;          // ring slots per tile
constexpr int DEC_STAGES = 3;      // shared-memory stages of the bf16 body
constexpr int DEC_CWARPS = 4;      // consumer warps; warp w owns keys 16 w .. 16 w + 15 of a tile
constexpr int DEC_THREADS = 32 * (DEC_CWARPS + 1);  // and one producer warp
constexpr int DEC_BOX = DEC_T * 128;                 // bytes of one TMA box: 64 slots x 64 dims
constexpr int DEC_STAGE = 4 * DEC_BOX;               // K and V, two boxes each: 32 KB
constexpr int DEC_SMEM = DEC_STAGES * DEC_STAGE + ivl::SMEM_ALIGN;
constexpr int DEC_MAXG = 16;       // query heads per KV head
constexpr int DEC_PART = HD + 4;   // a split's partial of one head: m (log2 units), l, 2 pad,
                                   // acc[HD] (on 16 bytes)
constexpr float LOG2E = 1.4426950408889634f;

struct DecWalk {
  int cap, n_ring, m0, n_vis, tile0, n_tiles, tps, NS;

  __host__ __device__ static DecWalk make(int cap, int cum_len, int window, int tps, int NS) {
    DecWalk w;
    w.cap = cap;
    w.n_ring = (cap + DEC_T - 1) / DEC_T;
    w.m0 = cum_len % cap;
    w.n_vis = cum_len + 1 < window ? cum_len + 1 : window;
    const int lo = ivl::pos_mod(w.m0 - w.n_vis + 1, cap);
    w.tile0 = lo / DEC_T;
    if (lo <= w.m0) {
      w.n_tiles = w.m0 / DEC_T - w.tile0 + 1;
    } else {  // wraps past slot cap - 1; both ends in one tile: every tile once
      const int n = w.n_ring - w.tile0 + w.m0 / DEC_T + 1;
      w.n_tiles = n < w.n_ring ? n : w.n_ring;
    }
    w.tps = tps;
    w.NS = NS;
    return w;
  }
  __device__ int tile(int i) const { return (tile0 + i) % n_ring; }
  // every slot of tile t visible: no per-element mask
  __device__ bool whole(int t) const {
    const int a = t * DEC_T;
    if (a + DEC_T > cap) return false;                  // a ragged last tile
    if (a <= m0 && m0 < a + DEC_T - 1) return n_vis >= cap;  // holds m0 and m0 + 1
    return ivl::pos_mod(m0 - a, cap) < n_vis;
  }
  __device__ bool sees(int slot) const {
    return slot < cap && ivl::pos_mod(m0 - slot, cap) < n_vis;
  }
  // the split whose walk holds slot m0 (it writes the token into the ring)
  __device__ int writer() const { return ivl::pos_mod(m0 / DEC_T - tile0, n_ring) / tps; }
};

// The output's head g of (b, h) from the partials of the NS splits: warp v
// folds splits [v c, (v + 1) c) in order (c = ceil(NS / 8)), four dims a
// lane, then warp 0 adds the eight in the order v = 0..7; m in log2 units.
// The order is fixed, so equal inputs give equal bits.
constexpr int DEC_C_WARPS = 8;

__device__ __forceinline__ void store4(float* o, float4 v) {
  *reinterpret_cast<float4*>(o) = v;
}
__device__ __forceinline__ void store4(__nv_bfloat16* o, float4 v) {
  *reinterpret_cast<uint2*>(o) = make_uint2(pack_bf16(v.x, v.y), pack_bf16(v.z, v.w));
}

template <typename T>
__global__ void __launch_bounds__(32 * DEC_C_WARPS)
swa_decode_combine_kernel(const float* __restrict__ part, T* __restrict__ out, int Hq,
                          int Hkv, int NS) {
  __shared__ float4 sa[DEC_C_WARPS][32];
  __shared__ float sml[DEC_C_WARPS][2];
  const int G = Hq / Hkv;
  const int bh = blockIdx.x, g = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int per = (NS + DEC_C_WARPS - 1) / DEC_C_WARPS;
  const int s1 = min(NS, (warp + 1) * per);
  const size_t step = (size_t)G * DEC_PART;
  const float* p0 = part + ((size_t)bh * NS * G + g) * DEC_PART;
  float M = NEG_INF, L = 0.f;
  float4 A = make_float4(0.f, 0.f, 0.f, 0.f);
  ivl::grid_dependency_wait();  // launched early (PDL): the split kernel's partials
#pragma unroll 4
  for (int s = warp * per; s < s1; ++s) {
    const float* pp = p0 + s * step;
    const float m = pp[0], l = pp[1];
    const float4 a = *reinterpret_cast<const float4*>(pp + 4 + 4 * lane);
    const float mn = fmaxf(M, m);
    const float r = exp2f(M - mn), e = exp2f(m - mn);
    L = L * r + e * l;
    A = make_float4(A.x * r + e * a.x, A.y * r + e * a.y, A.z * r + e * a.z, A.w * r + e * a.w);
    M = mn;
  }
  if (lane == 0) {
    sml[warp][0] = M;
    sml[warp][1] = L;
  }
  sa[warp][lane] = A;
  __syncthreads();
  if (warp != 0) return;
  float Mt = NEG_INF;
#pragma unroll
  for (int v = 0; v < DEC_C_WARPS; ++v) Mt = fmaxf(Mt, sml[v][0]);
  float Lt = 0.f;
  float4 At = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
  for (int v = 0; v < DEC_C_WARPS; ++v) {
    const float e = exp2f(sml[v][0] - Mt);
    const float4 a = sa[v][lane];
    Lt += e * sml[v][1];
    At = make_float4(At.x + e * a.x, At.y + e * a.y, At.z + e * a.z, At.w + e * a.w);
  }
  const float inv = 1.f / fmaxf(Lt, 1e-30f);
  const int b = bh / Hkv, h = bh % Hkv;
  store4(out + ((size_t)b * Hq + h * G + g) * HD + 4 * lane,
         make_float4(At.x * inv, At.y * inv, At.z * inv, At.w * inv));
}

// One split's result for head g, dim d: the output itself when the walk
// has one split, else its partial.
template <typename T>
__device__ __forceinline__ void dec_store(const DecWalk& w, T* out, float* part, int b, int h,
                                          int s, int G, int Hq, int Hkv, int g, int d, float m,
                                          float l, float a) {
  if (w.NS == 1) {
    out[((size_t)b * Hq + h * G + g) * HD + d] = from_f<T>(a / fmaxf(l, 1e-30f));
    return;
  }
  float* pp = part + (((size_t)(b * Hkv + h) * w.NS + s) * G + g) * DEC_PART;
  if (d == 0) {
    pp[0] = m;
    pp[1] = l;
  }
  pp[4 + d] = a;
}

// bf16 body. grid (B Hkv, NS); warps 0-3 consume, warp 4 produces.
//  - the producer's lane 0 streams the split's tiles through DEC_STAGES
//    stages of 32 KB (full / empty mbarriers): four TMA boxes a tile, K and
//    V as 64 slots x 64 dims in the 128-byte swizzle, from a 3-D map over
//    the rings (dims, slot, ring plane), so a ragged last tile reads zeros;
//    in the writer split its other lanes store the token's K/V into slot m0
//  - consumer warp w takes keys 16 w .. 16 w + 15 of each tile with its own
//    online softmax: S^T = K Q^T (mma.sync m16n8k16, keys as M, the G query
//    heads as N, Q^T in registers for the whole walk), P^T in registers by
//    movmatrix, then O^T += V^T P^T (D as M, V^T by ldmatrix.trans). The warp
//    holding slot m0 first copies the token's K/V row over that slot from
//    new_k / new_v, so no block reads the slot the writer stores to
//  - at the end the four warps' states are added in smem in the order
//    w = 0..3 into the split's partial (or the output, at one split)
// NT: n-tiles of 8 query heads (G <= 8 NT); P is rounded to bf16 for P V.
template <int NT>
__global__ void __launch_bounds__(DEC_THREADS)
swa_decode_bf16_kernel(const __grid_constant__ CUtensorMap kmap,
                       const __grid_constant__ CUtensorMap vmap,
                       const __nv_bfloat16* __restrict__ q,      // [B, Hq, HD]
                       const __nv_bfloat16* __restrict__ new_k,  // [B, Hkv, HD]
                       const __nv_bfloat16* __restrict__ new_v,
                       __nv_bfloat16* __restrict__ rings_k,      // [S, B, Hkv, cap, HD]
                       __nv_bfloat16* __restrict__ rings_v,
                       __nv_bfloat16* __restrict__ out,          // [B, Hq, HD]
                       float* __restrict__ part,                 // [B Hkv, NS, G, DEC_PART]
                       int B, int Hq, int Hkv, int layer, DecWalk w, float scale) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = ivl::aligned_smem(smem_raw);
  __shared__ uint64_t full[DEC_STAGES], empty[DEC_STAGES];
  const int G = Hq / Hkv;
  const int bh = blockIdx.x, s = blockIdx.y;
  const int b = bh / Hkv, h = bh % Hkv;
  const int i0 = s * w.tps, n = min(w.tps, w.n_tiles - i0);
  const int plane = (layer * B + b) * Hkv + h;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  ivl::launch_dependents();  // the combine may be scheduled now (it waits for this grid)
  auto load = [&](int i) {   // walk step i0 + i into stage i % DEC_STAGES: four boxes
    const int st = i % DEC_STAGES;
    const int slot0 = w.tile(i0 + i) * DEC_T;
    unsigned char* dst = smem + st * DEC_STAGE;
    ivl::mbar_arrive_tx(&full[st], DEC_STAGE);
    ivl::tma_load_3d(dst, &kmap, &full[st], 0, slot0, plane);
    ivl::tma_load_3d(dst + DEC_BOX, &kmap, &full[st], 64, slot0, plane);
    ivl::tma_load_3d(dst + 2 * DEC_BOX, &vmap, &full[st], 0, slot0, plane);
    ivl::tma_load_3d(dst + 3 * DEC_BOX, &vmap, &full[st], 64, slot0, plane);
  };
  if (warp == DEC_CWARPS && lane == 0) {  // the first stages' loads go out before the barrier
    ivl::prefetch_tensormap(&kmap);
    ivl::prefetch_tensormap(&vmap);
    for (int st = 0; st < DEC_STAGES; ++st) {
      ivl::mbar_init(&full[st], 1);
      ivl::mbar_init(&empty[st], DEC_CWARPS);
    }
    ivl::mbar_fence_init();
    for (int i = 0; i < min(n, DEC_STAGES); ++i) load(i);
  }
  __syncthreads();

  if (warp == DEC_CWARPS) {  // producer
    if (s == w.writer()) {   // 16 bytes a lane: K's row, then V's
      const size_t row = ((size_t)plane * w.cap + w.m0) * HD + 8 * (lane & 15);
      const size_t src = (size_t)bh * HD + 8 * (lane & 15);
      if (lane < 16)
        *reinterpret_cast<uint4*>(rings_k + row) = *reinterpret_cast<const uint4*>(new_k + src);
      else
        *reinterpret_cast<uint4*>(rings_v + row) = *reinterpret_cast<const uint4*>(new_v + src);
    }
    if (lane == 0)
      for (int i = DEC_STAGES; i < n; ++i) {
        ivl::mbar_wait(&empty[i % DEC_STAGES], (i / DEC_STAGES - 1) & 1);
        load(i);
      }
    return;
  }

  const int gid = lane >> 2, tig = lane & 3;
  const int k0 = 16 * warp;  // this warp's keys within a tile
  uint32_t qb[NT][8][2];     // Q^T: B operand of S^T = K Q^T, k-step kk
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int g = 8 * nt + gid;
    const __nv_bfloat16* qr = q + ((size_t)b * Hq + h * G + min(g, G - 1)) * HD + 2 * tig;
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      qb[nt][kk][0] = g < G ? ivl::ld32(qr + 16 * kk) : 0u;
      qb[nt][kk][1] = g < G ? ivl::ld32(qr + 16 * kk + 8) : 0u;
    }
  }
  float acc[NT][8][4], m[NT][2], l[NT][2];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      m[nt][j] = NEG_INF;
      l[nt][j] = 0.f;
    }
#pragma unroll
    for (int mt = 0; mt < 8; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nt][mt][e] = 0.f;
  }
  const float sc = scale * LOG2E;
  // ldmatrix rows of this lane: K (non-trans, A = K[key][dim]) takes key
  // k0 + 8 ((lane / 8) % 2) + lane % 8 at dim + 8 (lane / 16); V (trans,
  // A = V^T[dim][key]) key k0 + 8 (lane / 16) + lane % 8 at dim + 8 ((lane / 8) % 2)
  const int kkey = k0 + ((lane >> 3) & 1) * 8 + (lane & 7), kdim = (lane >> 4) * 8;
  const int vkey = k0 + (lane >> 4) * 8 + (lane & 7), vdim = ((lane >> 3) & 1) * 8;
  // byte offset of (key, dim) in a stage's K or V half-pair: box dim / 64,
  // row key, 16-byte chunk (dim % 64) / 8 swizzled by key % 8
  auto at = [](int key, int dim) {
    return (dim >> 6) * DEC_BOX + key * 128 + ((((dim & 63) >> 3) ^ (key & 7)) << 4);
  };

  for (int i = 0; i < n; ++i) {
    const int st = i % DEC_STAGES;
    const int t = w.tile(i0 + i);
    ivl::mbar_wait(&full[st], (i / DEC_STAGES) & 1);
    unsigned char* ks = smem + st * DEC_STAGE;
    unsigned char* vs = ks + 2 * DEC_BOX;
    const int rm = w.m0 - t * DEC_T;  // the token's row in this tile, if in [0, DEC_T)
    if (rm >= k0 && rm < k0 + 16) {    // warp-uniform: its row from new_k / new_v
      const int c = lane & 15;
      unsigned char* dst = (lane < 16 ? ks : vs) + at(rm, 8 * c);
      const __nv_bfloat16* src = (lane < 16 ? new_k : new_v) + (size_t)bh * HD + 8 * c;
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
      ivl::fence_async_smem();  // before TMA writes this stage again
      __syncwarp();
    }
    const uint32_t ks32 = ivl::smem_u32(ks), vs32 = ivl::smem_u32(vs);

    float sf[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) sf[nt][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      uint32_t a[4];
      ivl::ldsm_x4(a, ks32 + at(kkey, 16 * kk + kdim));
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) ivl::mma_bf16(sf[nt], a, qb[nt][kk][0], qb[nt][kk][1]);
    }

    // sf[nt]: keys k0 + gid (e = 0, 1) and k0 + gid + 8 (e = 2, 3) x heads
    // 8 nt + 2 tig + (e % 2)
    const bool masked = !w.whole(t);  // block-uniform
    bool vis0 = true, vis1 = true;
    if (masked) {
      vis0 = w.sees(t * DEC_T + k0 + gid);
      vis1 = w.sees(t * DEC_T + k0 + gid + 8);
    }
    uint32_t pb[NT][2];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      float p[2][2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        float s0 = sf[nt][j] * sc, s1 = sf[nt][2 + j] * sc;
        if (masked) {
          s0 = vis0 ? s0 : NEG_INF;
          s1 = vis1 ? s1 : NEG_INF;
        }
        float mx = fmaxf(s0, s1);
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 8));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 16));
        const float m_new = fmaxf(m[nt][j], mx);
        const float alpha = exp2f(m[nt][j] - m_new);
        float p0 = exp2f(s0 - m_new), p1 = exp2f(s1 - m_new);
        if (masked) {  // a head that has seen no key yet has m_new = NEG_INF
          p0 = vis0 ? p0 : 0.f;
          p1 = vis1 ? p1 : 0.f;
        }
        l[nt][j] = l[nt][j] * alpha + p0 + p1;
        m[nt][j] = m_new;
#pragma unroll
        for (int mt = 0; mt < 8; ++mt) {
          acc[nt][mt][j] *= alpha;
          acc[nt][mt][2 + j] *= alpha;
        }
        p[j][0] = p0;
        p[j][1] = p1;
      }
      // rows key gid / gid + 8, cols heads 2 tig, 2 tig + 1 -> transposed:
      // the B operand (k = keys, n = heads) of O^T += V^T P^T
      pb[nt][0] = ivl::movmatrix_trans(pack_bf16(p[0][0], p[1][0]));
      pb[nt][1] = ivl::movmatrix_trans(pack_bf16(p[0][1], p[1][1]));
    }
#pragma unroll
    for (int mt = 0; mt < 8; ++mt) {
      uint32_t a[4];
      ivl::ldsm_x4_trans(a, vs32 + at(vkey, 16 * mt + vdim));
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) ivl::mma_bf16(acc[nt][mt], a, pb[nt][0], pb[nt][1]);
    }
    __syncwarp();
    if (lane == 0) ivl::mbar_arrive(&empty[st]);
  }

  // the four warps' (m, l, O^T) in smem (the stages are free: every TMA
  // of the walk has landed), then added in the order w = 0..3
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      l[nt][j] += __shfl_xor_sync(0xffffffffu, l[nt][j], 4);
      l[nt][j] += __shfl_xor_sync(0xffffffffu, l[nt][j], 8);
      l[nt][j] += __shfl_xor_sync(0xffffffffu, l[nt][j], 16);
    }
  constexpr int NH = 8 * NT;
  float* red = reinterpret_cast<float*>(smem);  // [CWARPS][NH][HD]
  float* red_ml = red + DEC_CWARPS * NH * HD;   // [CWARPS][NH][2]
  ivl::named_sync(1, 32 * DEC_CWARPS);
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
    for (int mt = 0; mt < 8; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        red[(warp * NH + 8 * nt + 2 * tig + (e & 1)) * HD + 16 * mt + gid + 8 * (e >> 1)] =
            acc[nt][mt][e];
    if (gid == 0)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        red_ml[(warp * NH + 8 * nt + 2 * tig + j) * 2] = m[nt][j];
        red_ml[(warp * NH + 8 * nt + 2 * tig + j) * 2 + 1] = l[nt][j];
      }
  }
  ivl::named_sync(1, 32 * DEC_CWARPS);
  const int d = threadIdx.x;  // 128 consumer threads: one dim each
  for (int g = 0; g < G; ++g) {
    float M = NEG_INF;
#pragma unroll
    for (int v = 0; v < DEC_CWARPS; ++v) M = fmaxf(M, red_ml[(v * NH + g) * 2]);
    float L = 0.f, A = 0.f;
#pragma unroll
    for (int v = 0; v < DEC_CWARPS; ++v) {
      const float e = exp2f(red_ml[(v * NH + g) * 2] - M);
      L += e * red_ml[(v * NH + g) * 2 + 1];
      A += e * red[(v * NH + g) * HD + d];
    }
    dec_store(w, out, part, b, h, s, G, Hq, Hkv, g, d, M, L, A);
  }
}

// fp32 body (the CPU-against-card checks): FMA from shared memory, 32 slots
// a sub-tile (one per lane), warp w owns query heads w, w + 4, ...; the
// same walk, ring write and partials as the bf16 body. Tensor cores would
// round fp32 operands.
constexpr int DEC_F_BK = 32;
constexpr int DEC_F_THREADS = 128;
constexpr int DEC_F_RPW = DEC_MAXG / 4;

__global__ void __launch_bounds__(DEC_F_THREADS)
swa_decode_f32_kernel(const float* __restrict__ q,      // [B, Hq, HD]
                      const float* __restrict__ new_k,  // [B, Hkv, HD]
                      const float* __restrict__ new_v,
                      float* __restrict__ rings_k,      // [S, B, Hkv, cap, HD]
                      float* __restrict__ rings_v,
                      float* __restrict__ out,          // [B, Hq, HD]
                      float* __restrict__ part,         // [B Hkv, NS, G, DEC_PART]
                      int B, int Hq, int Hkv, int layer, DecWalk w, float scale) {
  __shared__ float Qs[DEC_MAXG][HD];
  __shared__ float Ks[DEC_F_BK][HD + 1];
  __shared__ float Vs[DEC_F_BK][HD];

  const int G = Hq / Hkv;
  const int bh = blockIdx.x, s = blockIdx.y;
  const int b = bh / Hkv, h = bh % Hkv;
  const int i0 = s * w.tps, n = min(w.tps, w.n_tiles - i0);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const size_t ring_off = (((size_t)layer * B + b) * Hkv + h) * (size_t)w.cap * HD;
  ivl::launch_dependents();
  const float* nk = new_k + (size_t)bh * HD;
  const float* nv = new_v + (size_t)bh * HD;
  if (s == w.writer()) {
    rings_k[ring_off + (size_t)w.m0 * HD + tid] = nk[tid];
    rings_v[ring_off + (size_t)w.m0 * HD + tid] = nv[tid];
  }
  for (int i = tid; i < G * HD; i += DEC_F_THREADS)
    Qs[i / HD][i % HD] = q[((size_t)b * Hq + h * G + i / HD) * HD + i % HD];

  const float sc = scale * LOG2E;
  float m_r[DEC_F_RPW], l_r[DEC_F_RPW], acc[DEC_F_RPW][HD / 32];
#pragma unroll
  for (int rr = 0; rr < DEC_F_RPW; ++rr) {
    m_r[rr] = NEG_INF;
    l_r[rr] = 0.f;
#pragma unroll
    for (int c = 0; c < HD / 32; ++c) acc[rr][c] = 0.f;
  }

  for (int it = 0; it < 2 * n; ++it) {
    const int j0 = w.tile(i0 + it / 2) * DEC_T + (it % 2) * DEC_F_BK;
    const bool vis = w.sees(j0 + lane);
    // also the barrier that retires the previous sub-tile's readers
    if (!__syncthreads_or(vis)) continue;
    for (int x = tid; x < DEC_F_BK * HD; x += DEC_F_THREADS) {
      const int jj = x / HD, dd = x % HD, js = j0 + jj;
      const bool own = js == w.m0, in = js < w.cap;
      Ks[jj][dd] = own ? nk[dd] : in ? rings_k[ring_off + (size_t)js * HD + dd] : 0.f;
      Vs[jj][dd] = own ? nv[dd] : in ? rings_v[ring_off + (size_t)js * HD + dd] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int rr = 0; rr < DEC_F_RPW; ++rr) {
      const int g = warp + 4 * rr;
      if (g < G) {  // warp-uniform
        float sv = 0.f;
        for (int dd = 0; dd < HD; ++dd) sv += Qs[g][dd] * Ks[lane][dd];
        sv = vis ? sv * sc : NEG_INF;
        const float m_new = fmaxf(m_r[rr], ivl::warp_max(sv));
        const float alpha = exp2f(m_r[rr] - m_new);
        const float p = vis ? exp2f(sv - m_new) : 0.f;
        l_r[rr] = l_r[rr] * alpha + ivl::warp_sum(p);
        m_r[rr] = m_new;
#pragma unroll
        for (int c = 0; c < HD / 32; ++c) acc[rr][c] *= alpha;
        for (int jj = 0; jj < DEC_F_BK; ++jj) {
          const float pj = __shfl_sync(0xffffffffu, p, jj);
#pragma unroll
          for (int c = 0; c < HD / 32; ++c) acc[rr][c] += pj * Vs[jj][lane + 32 * c];
        }
      }
    }
  }
#pragma unroll
  for (int rr = 0; rr < DEC_F_RPW; ++rr) {
    const int g = warp + 4 * rr;
    if (g < G)
#pragma unroll
      for (int c = 0; c < HD / 32; ++c)
        dec_store(w, out, part, b, h, s, G, Hq, Hkv, g, lane + 32 * c, m_r[rr], l_r[rr],
                  acc[rr][c]);
  }
}

// a 3-D map over stacked bf16 rings [planes, cap, 128] (dims innermost
// first: 128, cap, planes) with boxes of 64 dims x 64 slots x 1
bool map_rings(CUtensorMap* map, const void* base, int cap, int planes) {
  const cuuint64_t dims[3] = {HD, (cuuint64_t)cap, (cuuint64_t)planes};
  const cuuint64_t strides[2] = {HD * 2, (cuuint64_t)cap * HD * 2};
  const cuuint32_t box[3] = {64, DEC_T, 1};
  return ivl::make_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, base, dims, strides, box,
                       CU_TENSOR_MAP_SWIZZLE_128B);
}

cudaError_t launch_decode(int dtype, const void* q, const void* nk, const void* nv, void* rk,
                          void* rv, void* part, void* out, int B, int Hq, int Hkv, int S,
                          int layer, const DecWalk& w, float scale, cudaStream_t stream) {
  const int G = Hq / Hkv;
  const dim3 grid(B * Hkv, w.NS);
  cudaError_t err;
  if (dtype == ivl::DTYPE_F32) {
    swa_decode_f32_kernel<<<grid, DEC_F_THREADS, 0, stream>>>(
        (const float*)q, (const float*)nk, (const float*)nv, (float*)rk, (float*)rv,
        (float*)out, (float*)part, B, Hq, Hkv, layer, w, scale);
  } else {
    CUtensorMap maps[2];
    if (!map_rings(&maps[0], rk, w.cap, S * B * Hkv) ||
        !map_rings(&maps[1], rv, w.cap, S * B * Hkv))
      return cudaErrorInvalidValue;
    auto kern = G <= 8 ? swa_decode_bf16_kernel<1> : swa_decode_bf16_kernel<2>;
    if ((err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    DEC_SMEM)) != cudaSuccess)
      return err;
    kern<<<grid, DEC_THREADS, DEC_SMEM, stream>>>(
        maps[0], maps[1], (const __nv_bfloat16*)q, (const __nv_bfloat16*)nk,
        (const __nv_bfloat16*)nv, (__nv_bfloat16*)rk, (__nv_bfloat16*)rv, (__nv_bfloat16*)out,
        (float*)part, B, Hq, Hkv, layer, w, scale);
  }
  if ((err = cudaGetLastError()) != cudaSuccess || w.NS == 1) return err;
  // the combine with programmatic dependent launch: scheduled while the
  // split kernel runs, it waits for that grid's memory before it reads
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * Hkv, G);
  cfg.blockDim = dim3(32 * DEC_C_WARPS);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (dtype == ivl::DTYPE_F32)
    return cudaLaunchKernelEx(&cfg, swa_decode_combine_kernel<float>, (const float*)part,
                              (float*)out, Hq, Hkv, w.NS);
  return cudaLaunchKernelEx(&cfg, swa_decode_combine_kernel<__nv_bfloat16>,
                            (const float*)part, (__nv_bfloat16*)out, Hq, Hkv, w.NS);
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

// A2 and D: write the token's K/V ([B, Hkv, HD]) into slot cum_len % cap
// of ring `layer` of the stack [S, B, Hkv, cap, HD] and attend q's G
// query heads of each KV head over that ring, the visible tiles walked in
// NS splits of tps tiles (ops/swa_kernels.decode_split_plan); `part` is
// fp32 scratch [B Hkv, NS, G, HD + 4] when NS > 1. Requires cap >= window.
int ivl_swa_decode(int dtype, const void* q, const void* new_k, const void* new_v,
                   void* rings_k, void* rings_v, void* part, void* out, int B, int Hq,
                   int Hkv, int D, int cap, int S, int layer, int cum_len, int window,
                   int tps, int NS, float scale, void* stream) {
  if (D != HD || B <= 0 || Hkv <= 0 || Hq % Hkv != 0 || Hq / Hkv > DEC_MAXG || cap <= 0 ||
      window < 1 || window > cap || cum_len < 0 || layer < 0 || layer >= S || tps <= 0 ||
      NS <= 0 || (dtype != ivl::DTYPE_F32 && dtype != ivl::DTYPE_BF16))
    return (int)cudaErrorInvalidValue;
  const DecWalk w = DecWalk::make(cap, cum_len, window, tps, NS);
  if ((long long)tps * NS < w.n_tiles || (long long)tps * (NS - 1) >= w.n_tiles ||
      (NS > 1 && part == nullptr))
    return (int)cudaErrorInvalidValue;
  return (int)launch_decode(dtype, q, new_k, new_v, rings_k, rings_v, part, out, B, Hq, Hkv,
                            S, layer, w, scale, (cudaStream_t)stream);
}

const char* ivl_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
