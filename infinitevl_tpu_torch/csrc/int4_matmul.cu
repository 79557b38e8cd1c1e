// Fused int4 unpack-matmul: kernel G.
//
// Replaces infinitevl_tpu/ops/int4_pallas.py::_int4_matmul_2d (_kernel),
// reached through int4_matmul_fused. y = x @ dequant(W) for the nibble-packed
// storage of models/quant.py: packed uint8 [half, d_out] (half = d_in / 2),
// packed row r = original row r in the LOW nibble and row r + half in the
// HIGH nibble, signed nibbles ((v ^ 8) - 8), fp32 scales [G, d_out] over
// contiguous groups of gs = d_in / G input rows that never straddle the half
// split (G = 1: one scale row for both planes; else the low plane's group i
// uses scale row i and the high plane's row G/2 + i).
//
// What is kept from the TPU kernel is what it computes and what it keeps
// out of device memory: each packed byte is read ONCE and feeds both
// planes, products accumulate in fp32, a group's fp32 scale multiplies the
// fp32 partial sum of that group before groups are added, and the output is
// cast once at the end. Its (n_out, n_in) sequential grid, 128-row in-block
// and "d_out multiple of 128" rule are not carried over: a block here loops
// over its packed rows itself and masks ragged columns and rows, so every
// node that quantize_params produces is served (3420-wide ViT MLP included).
//
// Two regimes:
//   - M <= 8 (decode, beams, a speculative verify window): bound by the
//     packed bytes, d_in * d_out / 2. int4_gemv_kernel: a block owns a strip
//     of 128 output columns and a range of packed rows; its 8 warps take
//     interleaved rows, each lane 4 adjacent bytes of a row (one 128-byte
//     line per warp and row), x sits in shared memory as fp32 and every byte
//     feeds 2 x M accumulators. The row range is split across blockIdx.y so
//     that a 2048-wide output still fills 132 SMs; the split's fp32 partial
//     sums are added by int4_reduce_kernel.
//   - M > 8 (a verify window, a frame's 257 tokens, a prefill chunk): bound
//     by the packed bytes up to M ~ 64, by operations above.
//     bf16: int4_wgmma_kernel, warp-specialised for Hopper: a producer warp
//     keeps a ring of 64-packed-row stages in flight (TMA with mbarriers:
//     the x columns of both planes in the 128-byte swizzle, and the packed
//     bytes), the consumer warpgroups dequantise each stage in registers
//     (16-byte vectors, exact for -8..7) into bf16 tiles kept [k][n] as they
//     lie (an MN-major wgmma operand: nothing is transposed) and multiply on
//     wgmma m64n128k16, 64 output rows per warpgroup: one warpgroup for M
//     <= 64, two above. Packed rows are split over blockIdx.z (with the
//     reduce pass) only where the column tiles leave the 132 SMs short.
//     A scale group of whole 64-row stages folds once per stage; a group
//     of a multiple of 16 rows below that folds at every 16-row k-step
//     (its own template instance, so neither k-loop branches). Groups that
//     split a k-step (a multiple of 8 rows or less) take the FMA tiles.
//     The wrapper picks the tile kernel (ops/int4_kernels.tile_kernel)
//     and passes it in as `route`.
//     fp32: int4_fma_kernel, 64 x 64 tiles on plain FMA (tensor cores
//     would round fp32 operands).
#include "common.cuh"

#include <string.h>

namespace {

using ivl::from_f;
using ivl::ld32;
using ivl::mma_bf16;
using ivl::to_f;

// signed value of a nibble v in [0, 15]
__device__ __forceinline__ float nib(uint32_t v) {
  return (float)((int)(v ^ 8u) - 8);
}

// end of the scale group that packed row r lies in (gs rows per group and
// plane; gs = half when G == 1)
__device__ __forceinline__ int group_end(int r, int gs) { return (r / gs + 1) * gs; }

// the low plane's scale row of packed row r (rows past `half` keep the
// last one: their bytes are TMA's zeros)
__device__ __forceinline__ int scale_row(int r, int gs, int G) {
  return G == 1 ? 0 : min(r / gs, G / 2 - 1);
}

// ------------------------------------------------------------ small M
constexpr int GV_THREADS = 256;
constexpr int GV_WARPS = GV_THREADS / 32;
constexpr int GV_COLS = 128;  // output columns per block: 4 per lane

template <typename T, int MT>
__global__ void __launch_bounds__(GV_THREADS)
int4_gemv_kernel(const T* __restrict__ x, long long ldx,
                 const uint8_t* __restrict__ packed,
                 const float* __restrict__ scale, T* __restrict__ out,
                 float* __restrict__ partial, int M, int half, int d_out, int G,
                 int rpb) {
  // xs[2][MT][rpb] while the rows are walked, then red[GV_WARPS][MT][GV_COLS]
  extern __shared__ float sm[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int r0 = blockIdx.y * rpb;
  const int r1 = min(r0 + rpb, half);
  const int nr = r1 - r0;
  const int mbase = blockIdx.z * MT;

  for (int i = tid; i < 2 * MT * rpb; i += GV_THREADS) {
    const int p = i / (MT * rpb);
    const int rem = i - p * (MT * rpb);
    const int m = rem / rpb, r = rem - m * rpb;
    float v = 0.f;
    if (r < nr && mbase + m < M)
      v = to_f(x[(size_t)(mbase + m) * ldx + (size_t)p * half + r0 + r]);
    sm[i] = v;
  }
  __syncthreads();

  const int c0 = blockIdx.x * GV_COLS + lane * 4;
  const int ncol = max(0, min(4, d_out - c0));
  const bool vec = (d_out & 3) == 0;  // then a row's 4-byte words are aligned
  const int gs = G == 1 ? half : half / (G / 2);
  const int hi_base = G == 1 ? 0 : G / 2;

  float acc[MT][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[m][c] = 0.f;

  for (int g0 = r0; g0 < r1;) {
    const int g1 = min(r1, group_end(g0, gs));
    if (ncol > 0) {
      float plo[MT][4], phi[MT][4];
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int c = 0; c < 4; ++c) plo[m][c] = phi[m][c] = 0.f;
#pragma unroll 4
      for (int r = g0 + warp; r < g1; r += GV_WARPS) {
        const uint8_t* src = packed + (size_t)r * d_out + c0;
        uint32_t w;
        if (vec) {
          w = *reinterpret_cast<const uint32_t*>(src);
        } else {
          w = 0u;
          for (int c = 0; c < ncol; ++c) w |= (uint32_t)src[c] << (8 * c);
        }
        float lo[4], hi[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          lo[c] = nib((w >> (8 * c)) & 15u);
          hi[c] = nib((w >> (8 * c + 4)) & 15u);
        }
        const float* xl = sm + (r - r0);
        const float* xh = xl + MT * rpb;
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          const float a = xl[m * rpb], b = xh[m * rpb];
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            plo[m][c] += a * lo[c];
            phi[m][c] += b * hi[c];
          }
        }
      }
      const int srow = G == 1 ? 0 : g0 / gs;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        if (c < ncol) {
          const float sl = scale[(size_t)srow * d_out + c0 + c];
          const float sh = scale[(size_t)(hi_base + srow) * d_out + c0 + c];
#pragma unroll
          for (int m = 0; m < MT; ++m) acc[m][c] += plo[m][c] * sl + phi[m][c] * sh;
        }
      }
    }
    g0 = g1;
  }

  __syncthreads();  // xs is no longer read: reuse the memory
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int c = 0; c < 4; ++c)
      sm[(warp * MT + m) * GV_COLS + lane * 4 + c] = acc[m][c];
  __syncthreads();
  for (int i = tid; i < MT * GV_COLS; i += GV_THREADS) {
    const int m = i / GV_COLS, c = i % GV_COLS;
    const int row = mbase + m, col = blockIdx.x * GV_COLS + c;
    if (row < M && col < d_out) {
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < GV_WARPS; ++w) s += sm[(w * MT + m) * GV_COLS + c];
      if (partial != nullptr)
        partial[((size_t)blockIdx.y * M + row) * d_out + col] = s;
      else
        out[(size_t)row * d_out + col] = from_f<T>(s);
    }
  }
}

// out = sum over the row splits of partial[ks][n]
template <typename T>
__global__ void int4_reduce_kernel(const float* __restrict__ partial,
                                   T* __restrict__ out, int ks, size_t n) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int k = 0; k < ks; ++k) s += partial[(size_t)k * n + i];
  out[i] = from_f<T>(s);
}

// ------------------------------------------------------- large M, bf16
// int4_wgmma_kernel<NWG, KG>: NWG consumer warpgroups (64 output rows
// each) and one producer warpgroup. A ring of STAGES stages of 64 packed
// rows each holds the x columns of both planes ([BM][64] twice, by TMA in
// the 128-byte swizzle), both planes dequantised to bf16 tiles [64 k][128
// n] kept as they lie (an MN-major wgmma operand, written in the same
// swizzle) and the stage's fp32 scale rows: per plane one row for each
// fold of KG k-steps (KG 4: the stage; KG 1: every k-step). The producer warpgroup
// starts the TMA loads (the packed bytes and scale rows PS - 1 stages
// ahead, into a ring of PS slots: M <= 64 is bound by these bytes),
// dequantises in registers (16-byte vectors) and signals full[s];
// the consumers run each plane's k-steps of wgmma m64n128k16 into one fp32
// partial P, KG at a time, and add P x the fold's group scale into the
// total (two accumulator sets). A fold never straddles a scale group
// (KG 4: groups are whole stages; KG 1: groups are whole k-steps), and KG
// is a template argument, so the k-loop has no branch. x's rows past M and
// packed rows past `half` are TMA's zeros (a zero byte unpacks to 0 in
// both planes).
constexpr int WG_BN = 128;  // output columns per block
constexpr int WG_KT = 64;   // packed rows per stage
constexpr int WG_BT = WG_KT * WG_BN * 2;  // bytes of one dequantised plane tile
constexpr int WG_PT = WG_KT * WG_BN;      // bytes of one packed tile

template <int NWG, int KG>
struct WgCfg {
  static constexpr int NF = 4 / KG;                  // folds per plane and stage
  static constexpr int BM = 64 * NWG;
  // the per-k-step scale rows take room: one stage fewer with two warpgroups
  static constexpr int STAGES = NWG == 2 && NF > 1 ? 2 : 3;
  static constexpr int PS = NWG == 1 ? (NF > 1 ? 4 : 6) : 3;  // slots of the packed ring
  static constexpr int XT = BM * WG_KT * 2;          // bytes of one plane's x tile
  static constexpr int SC = 2 * NF * WG_BN * 4;      // bytes of a stage's scale rows
  static constexpr int SLOT = WG_PT + SC;            // a slot of the packed ring
  static constexpr int STAGE = 2 * XT + 2 * WG_BT + SC;
  static constexpr int PK = STAGES * STAGE;          // offset of the packed ring
  static constexpr int BAR = PK + PS * SLOT;         // offset of the barriers
  static constexpr int SMEM = BAR + (2 * STAGES + PS) * 8 + ivl::SMEM_ALIGN;
  static constexpr int NC = 128 * NWG;               // consumer threads
  static constexpr int THREADS = NC + 128;
  static_assert(KG == 1 || KG == 4, "a fold is one k-step or the whole stage");
  static_assert(SMEM <= 232448, "shared memory of one block");
};

// 8 packed bytes -> 8 bf16 of each plane: the nibble u gives (u ^ 8) - 8,
// built exactly as bf16(128 + (u ^ 8)) - 136
__device__ __forceinline__ void unpack8(uint2 w, uint4& lo, uint4& hi) {
  const __nv_bfloat162 off = __floats2bfloat162_rn(136.f, 136.f);
  uint32_t l[4], h[4];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const uint32_t x = (i ? w.y : w.x) ^ 0x88888888u;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const uint32_t t = __byte_perm(x, 0u, j ? 0x4342 : 0x4140);  // bytes 2j, 2j + 1
      uint32_t a = (t & 0x000F000Fu) | 0x43004300u;
      uint32_t b = ((t >> 4) & 0x000F000Fu) | 0x43004300u;
      __nv_bfloat162 fa = __hsub2(*reinterpret_cast<__nv_bfloat162*>(&a), off);
      __nv_bfloat162 fb = __hsub2(*reinterpret_cast<__nv_bfloat162*>(&b), off);
      l[2 * i + j] = *reinterpret_cast<uint32_t*>(&fa);
      h[2 * i + j] = *reinterpret_cast<uint32_t*>(&fb);
    }
  }
  lo = make_uint4(l[0], l[1], l[2], l[3]);
  hi = make_uint4(h[0], h[1], h[2], h[3]);
}

// 8 packed bytes of row r, columns c .. c + 7, read where they lie (zeros
// past the row's end or past `half`): the path for rows that TMA cannot
// address (d_out not a multiple of 16)
__device__ __forceinline__ uint2 load8(const uint8_t* packed, int r, int c, int half,
                                       int d_out) {
  uint32_t w[2] = {0u, 0u};
  if (r < half) {
    const uint8_t* src = packed + (size_t)r * d_out + c;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int ci = c + 4 * i;
      if ((d_out & 3) == 0 && ci + 4 <= d_out) {
        w[i] = *reinterpret_cast<const uint32_t*>(src + 4 * i);
      } else {
        for (int e = 0; e < 4 && ci + e < d_out; ++e) w[i] |= (uint32_t)src[4 * i + e] << (8 * e);
      }
    }
  }
  return make_uint2(w[0], w[1]);
}

template <int NWG, int KG>
__global__ void __launch_bounds__(WgCfg<NWG, KG>::THREADS, 1)
int4_wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
                  const __grid_constant__ CUtensorMap pmap,
                  const __grid_constant__ CUtensorMap smap, int packed_tma, int x_hi,
                  const uint8_t* __restrict__ packed, const float* __restrict__ scale,
                  __nv_bfloat16* __restrict__ out, float* __restrict__ partial, int M,
                  int half, int d_out, int G, int rpb) {
  typedef WgCfg<NWG, KG> C;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = ivl::aligned_smem(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + C::BAR);
  uint64_t* empty = full + C::STAGES;
  uint64_t* pfull = empty + C::STAGES;  // [PS]: the packed ring

  const int n0 = blockIdx.x * WG_BN, m0 = blockIdx.y * C::BM;
  const int r0 = blockIdx.z * rpb;
  const int r1 = min(r0 + rpb, half);
  const int n_it = (r1 - r0 + WG_KT - 1) / WG_KT;
  const int gs = G == 1 ? half : half / (G / 2);
  const int hi_base = G == 1 ? 0 : G / 2;

  if (threadIdx.x == 0) {
    for (int s = 0; s < C::STAGES; ++s) {
      ivl::mbar_init(&full[s], 129);  // the TMA's announcement + 128 producer threads
      ivl::mbar_init(&empty[s], C::NC);
    }
    for (int j = 0; j < C::PS; ++j) ivl::mbar_init(&pfull[j], 1);
    ivl::mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= C::NC) {  // ----------------------- producer warpgroup
    const int t = threadIdx.x - C::NC;
    // the packed bytes and the scale rows of stage j into slot j % PS:
    // [plane][fold][WG_BN], fold f covering k-steps f KG .. f KG + KG - 1
    auto fetch = [&](int j) {
      unsigned char* slot = sm + C::PK + (j % C::PS) * C::SLOT;
      uint64_t* bar = &pfull[j % C::PS];
      const int k = r0 + j * WG_KT;
      ivl::mbar_arrive_tx(bar, C::SLOT);
      ivl::tma_load_2d(slot, &pmap, bar, n0, k);
#pragma unroll
      for (int f = 0; f < C::NF; ++f) {
        const int srow = scale_row(k + 16 * KG * f, gs, G);
        ivl::tma_load_2d(slot + WG_PT + f * WG_BN * 4, &smap, bar, n0, srow);
        ivl::tma_load_2d(slot + WG_PT + (C::NF + f) * WG_BN * 4, &smap, bar, n0,
                         hi_base + srow);
      }
    };
    if (t == 0 && packed_tma)
      for (int j = 0; j < C::PS - 1 && j < n_it; ++j) fetch(j);
    for (int it = 0; it < n_it; ++it) {
      const int s = it % C::STAGES;
      const int k = r0 + it * WG_KT;
      unsigned char* st = sm + s * C::STAGE;
      if (it >= C::STAGES) ivl::mbar_wait(&empty[s], (it / C::STAGES - 1) & 1);
      if (t == 0) {
        ivl::mbar_arrive_tx(&full[s], 2 * C::XT);
        ivl::tma_load_2d(st, &xmap, &full[s], k, m0);
        ivl::tma_load_2d(st + C::XT, &xmap, &full[s], x_hi + k, m0);
        if (packed_tma && it + C::PS - 1 < n_it) fetch(it + C::PS - 1);
      }
      float* sc = reinterpret_cast<float*>(st + 2 * C::XT + 2 * WG_BT);
      const unsigned char* slot = sm + C::PK + (it % C::PS) * C::SLOT;
      if (packed_tma) {
        ivl::mbar_wait(&pfull[it % C::PS], (it / C::PS) & 1);
        const float* ss = reinterpret_cast<const float*>(slot + WG_PT);
#pragma unroll
        for (int i = 0; i < 2 * C::NF; ++i) sc[i * WG_BN + t] = ss[i * WG_BN + t];
      } else {  // the stage's scale rows (one group per plane and fold) where they lie
        const int col = n0 + t;
#pragma unroll
        for (int f = 0; f < C::NF; ++f) {
          const int srow = scale_row(k + 16 * KG * f, gs, G);
          sc[f * WG_BN + t] = col < d_out ? scale[(size_t)srow * d_out + col] : 0.f;
          sc[(C::NF + f) * WG_BN + t] =
              col < d_out ? scale[(size_t)(hi_base + srow) * d_out + col] : 0.f;
        }
      }
      // dequantise: 64 rows x 16 chunks of 8 columns, 8 chunks per thread
      unsigned char* bt = st + 2 * C::XT;
#pragma unroll
      for (int i = 0; i < WG_KT * (WG_BN / 8) / 128; ++i) {
        const int c = t + 128 * i;
        const int row = c >> 4, ch = c & 15;
        const uint2 w = packed_tma
                            ? *reinterpret_cast<const uint2*>(slot + row * WG_BN + ch * 8)
                            : load8(packed, k + row, n0 + ch * 8, half, d_out);
        uint4 lo, hi;
        unpack8(w, lo, hi);
        const int off = (ch >> 3) * (WG_KT * 128) + row * 128 + (((ch & 7) ^ (row & 7)) << 4);
        *reinterpret_cast<uint4*>(bt + off) = lo;
        *reinterpret_cast<uint4*>(bt + WG_BT + off) = hi;
      }
      ivl::fence_async_smem();
      ivl::mbar_arrive(&full[s]);
      ivl::named_sync(2, 128);  // the slot is read: the next TMA may refill it
    }
    return;
  }

  // ------------------------------------------------------------ consumers
  const int tid = threadIdx.x, wg = tid >> 7;
  const int lane = tid & 31, warp = (tid >> 5) & 3;
  const int gid = lane >> 2, tig = lane & 3;
  const bool svec = (d_out & 1) == 0;

  float acc[64], P[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = P[i] = 0.f;

  for (int it = 0; it < n_it; ++it) {
    const int s = it % C::STAGES;
    ivl::mbar_wait(&full[s], (it / C::STAGES) & 1);
    const unsigned char* st = sm + s * C::STAGE;
    const float* sc = reinterpret_cast<const float*>(st + 2 * C::XT + 2 * WG_BT);
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      const unsigned char* xa = st + p * C::XT + wg * 64 * 128;
      const unsigned char* bp = st + 2 * C::XT + p * WG_BT;
#pragma unroll
      for (int f = 0; f < C::NF; ++f) {  // KG k-steps into P, then P x the fold's scale
        ivl::wgmma_fence();
#pragma unroll
        for (int i = 0; i < KG; ++i) {
          const int kk = f * KG + i;
          ivl::wgmma_ss_n128<1>(P, ivl::gmma_desc(xa + kk * 32, 16, 1024),
                                ivl::gmma_desc(bp + kk * 2048, WG_KT * 128, 1024), i > 0);
        }
        ivl::wgmma_commit();
        ivl::wgmma_wait0();
        const float* sf = sc + (p * C::NF + f) * WG_BN;
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const float2 v = *reinterpret_cast<const float2*>(sf + 8 * j + 2 * tig);
          acc[4 * j] += P[4 * j] * v.x;
          acc[4 * j + 1] += P[4 * j + 1] * v.y;
          acc[4 * j + 2] += P[4 * j + 2] * v.x;
          acc[4 * j + 3] += P[4 * j + 3] * v.y;
        }
      }
    }
    ivl::mbar_arrive(&empty[s]);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = m0 + wg * 64 + warp * 16 + gid + 8 * i;
    if (row >= M) continue;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int col = n0 + 8 * j + 2 * tig;
      const float v0 = acc[4 * j + 2 * i], v1 = acc[4 * j + 2 * i + 1];
      if (partial != nullptr) {
        float* dst = partial + ((size_t)blockIdx.z * M + row) * d_out + col;
        if (col < d_out) dst[0] = v0;
        if (col + 1 < d_out) dst[1] = v1;
      } else {
        __nv_bfloat16* dst = out + (size_t)row * d_out + col;
        if (svec && col + 1 < d_out) {
          *reinterpret_cast<uint32_t*>(dst) = ivl::pack_bf16(v0, v1);
        } else {
          if (col < d_out) dst[0] = __float2bfloat16(v0);
          if (col + 1 < d_out) dst[1] = __float2bfloat16(v1);
        }
      }
    }
  }
}

// ------------------------------------------------------- large M, fp32
constexpr int FM_BM = 64;
constexpr int FM_BN = 64;
constexpr int FM_KT = 16;       // packed rows per tile
constexpr int FM_THREADS = 256; // 16 x 16 threads, 4 x 4 outputs each

template <typename T>
__global__ void __launch_bounds__(FM_THREADS)
int4_fma_kernel(const T* __restrict__ x, long long ldx,
                const uint8_t* __restrict__ packed,
                const float* __restrict__ scale, T* __restrict__ out,
                float* __restrict__ partial, int M, int half, int d_out, int G,
                int rpb) {
  __shared__ float Xs[2][FM_KT][FM_BM + 4];  // [plane][k][m]
  __shared__ float Ws[2][FM_KT][FM_BN];      // [plane][k][n]

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int n0 = blockIdx.x * FM_BN, m0 = blockIdx.y * FM_BM;
  const int r0 = blockIdx.z * rpb;
  const int r1 = min(r0 + rpb, half);
  const int gs = G == 1 ? half : half / (G / 2);
  const int hi_base = G == 1 ? 0 : G / 2;

  float acc[4][4], plo[4][4], phi[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = plo[i][j] = phi[i][j] = 0.f;

  for (int k0 = r0; k0 < r1;) {
    const int g1 = min(r1, group_end(k0, gs));
    const int k1 = min(k0 + FM_KT, g1);
    const int kn = k1 - k0;
    __syncthreads();
    for (int i = tid; i < 2 * FM_BM * FM_KT; i += FM_THREADS) {
      const int p = i / (FM_BM * FM_KT);
      const int rem = i % (FM_BM * FM_KT);
      const int row = rem / FM_KT, k = rem % FM_KT;
      float v = 0.f;
      if (m0 + row < M && k < kn)
        v = to_f(x[(size_t)(m0 + row) * ldx + (size_t)p * half + k0 + k]);
      Xs[p][k][row] = v;
    }
    for (int i = tid; i < FM_KT * FM_BN; i += FM_THREADS) {
      const int k = i / FM_BN, n = i % FM_BN;
      uint32_t b = 0u;  // 0 unpacks to 0
      if (k < kn && n0 + n < d_out) b = packed[(size_t)(k0 + k) * d_out + n0 + n];
      Ws[0][k][n] = nib(b & 15u);
      Ws[1][k][n] = nib(b >> 4);
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < FM_KT; ++k) {
      float al[4], ah[4], wl[4], wh[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        al[i] = Xs[0][k][ty * 4 + i];
        ah[i] = Xs[1][k][ty * 4 + i];
        wl[i] = Ws[0][k][tx * 4 + i];
        wh[i] = Ws[1][k][tx * 4 + i];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          plo[i][j] += al[i] * wl[j];
          phi[i][j] += ah[i] * wh[j];
        }
    }
    k0 = k1;
    if (k0 == g1) {
      const int srow = G == 1 ? 0 : (g1 - 1) / gs;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = n0 + tx * 4 + j;
        const float sl = col < d_out ? scale[(size_t)srow * d_out + col] : 0.f;
        const float sh = col < d_out ? scale[(size_t)(hi_base + srow) * d_out + col] : 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][j] += plo[i][j] * sl + phi[i][j] * sh;
          plo[i][j] = phi[i][j] = 0.f;
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + ty * 4 + i;
    if (row >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tx * 4 + j;
      if (col >= d_out) continue;
      if (partial != nullptr)
        partial[((size_t)blockIdx.z * M + row) * d_out + col] = acc[i][j];
      else
        out[(size_t)row * d_out + col] = from_f<T>(acc[i][j]);
    }
  }
}

// ------------------------------------------------------------ launchers
template <typename T, int MT>
cudaError_t launch_gemv_mt(const void* x, long long ldx, const void* packed,
                           const void* scale, void* out, void* partial, int M,
                           int half, int d_out, int G, int rpb, int ks,
                           cudaStream_t st) {
  const int xs_floats = 2 * MT * rpb, red_floats = GV_WARPS * MT * GV_COLS;
  const int floats = xs_floats > red_floats ? xs_floats : red_floats;
  const int smem = floats * (int)sizeof(float);
  if (smem > 48 * 1024) return cudaErrorInvalidValue;
  dim3 grid((d_out + GV_COLS - 1) / GV_COLS, ks, (M + MT - 1) / MT);
  int4_gemv_kernel<T, MT><<<grid, GV_THREADS, smem, st>>>(
      (const T*)x, ldx, (const uint8_t*)packed, (const float*)scale, (T*)out,
      (float*)partial, M, half, d_out, G, rpb);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_gemv(const void* x, long long ldx, const void* packed,
                        const void* scale, void* out, void* partial, int M,
                        int half, int d_out, int G, int rpb, int ks,
                        cudaStream_t st) {
  if (M == 1)
    return launch_gemv_mt<T, 1>(x, ldx, packed, scale, out, partial, M, half, d_out, G, rpb, ks, st);
  if (M == 2)
    return launch_gemv_mt<T, 2>(x, ldx, packed, scale, out, partial, M, half, d_out, G, rpb, ks, st);
  if (M <= 4)
    return launch_gemv_mt<T, 4>(x, ldx, packed, scale, out, partial, M, half, d_out, G, rpb, ks, st);
  return launch_gemv_mt<T, 8>(x, ldx, packed, scale, out, partial, M, half, d_out, G, rpb, ks, st);
}

// The tile kernel that serves M > 8, chosen by the wrapper
// (ops/int4_kernels.tile_kernel) and passed in as `route`.
enum { ROUTE_FMA = 0, ROUTE_WGMMA_STAGE = 1, ROUTE_WGMMA_KSTEP = 2 };

template <typename T>
cudaError_t launch_tiles(const void* x, long long ldx, int x_hi, const void* packed,
                         const void* scale, void* out, void* partial, int M,
                         int half, int d_out, int G, int rpb, int ks, int tile_m,
                         int route, cudaStream_t st);

template <int NWG, int KG>
cudaError_t launch_wgmma(const void* x, long long ldx, int x_hi, const void* packed,
                         const void* scale, void* out, void* partial, int M, int half,
                         int d_out, int G, int rpb, int ks, cudaStream_t st) {
  typedef WgCfg<NWG, KG> C;
  CUtensorMap xmap, pmap;
  const cuuint64_t xd[2] = {(cuuint64_t)(x_hi + half), (cuuint64_t)M};
  const cuuint64_t xs[1] = {(cuuint64_t)ldx * 2};
  const cuuint32_t xb[2] = {WG_KT, (cuuint32_t)C::BM};
  if (!ivl::make_map(&xmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x, xd, xs, xb,
                     CU_TENSOR_MAP_SWIZZLE_128B))
    return cudaErrorInvalidValue;
  const cuuint64_t pd[2] = {(cuuint64_t)d_out, (cuuint64_t)half};
  const cuuint64_t ps[1] = {(cuuint64_t)d_out};
  const cuuint32_t pb[2] = {WG_BN, WG_KT};
  const cuuint64_t sd[2] = {(cuuint64_t)d_out, (cuuint64_t)G};
  const cuuint64_t ss[1] = {(cuuint64_t)d_out * 4};
  const cuuint32_t sb[2] = {WG_BN, 1};
  CUtensorMap smap;
  const int packed_tma = d_out % 16 == 0 &&
                         ivl::make_map(&pmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, packed, pd, ps,
                                       pb, CU_TENSOR_MAP_SWIZZLE_NONE) &&
                         ivl::make_map(&smap, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, scale, sd, ss,
                                       sb, CU_TENSOR_MAP_SWIZZLE_NONE);
  if (!packed_tma) {
    memset(&pmap, 0, sizeof(pmap));
    memset(&smap, 0, sizeof(smap));
  }
  cudaError_t err = cudaFuncSetAttribute(
      int4_wgmma_kernel<NWG, KG>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (err != cudaSuccess) return err;
  dim3 grid((d_out + WG_BN - 1) / WG_BN, (M + C::BM - 1) / C::BM, ks);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  int4_wgmma_kernel<NWG, KG><<<grid, C::THREADS, C::SMEM, st>>>(
      xmap, pmap, smap, packed_tma, x_hi, (const uint8_t*)packed, (const float*)scale,
      (__nv_bfloat16*)out, (float*)partial, M, half, d_out, G, rpb);
  return cudaGetLastError();
}

// bf16 at M > 8, by route: the wgmma kernel with 64-row tiles (tile_m 64)
// or 128-row tiles (tile_m 128), folding the group scales once per stage
// (ROUTE_WGMMA_STAGE: G = 1 or groups of whole 64-row stages) or once per
// 16-row k-step (ROUTE_WGMMA_KSTEP: groups of a multiple of 16 rows), or the
// FMA tiles (ROUTE_FMA: tile_m 64, x as it lies), which fold at any group
// end. A route whose fold would straddle a group is refused. TMA reads x at
// 16-byte boundaries: its base, its row stride and the column x_hi where its
// high plane starts are multiples of 8 elements.
template <>
cudaError_t launch_tiles<__nv_bfloat16>(const void* x, long long ldx, int x_hi,
                                        const void* packed, const void* scale, void* out,
                                        void* partial, int M, int half, int d_out, int G,
                                        int rpb, int ks, int tile_m, int route,
                                        cudaStream_t st) {
  if (route == ROUTE_FMA) {
    if (tile_m != FM_BM || x_hi != half) return cudaErrorInvalidValue;
    dim3 grid((d_out + FM_BN - 1) / FM_BN, (M + FM_BM - 1) / FM_BM, ks);
    if (grid.y > 65535) return cudaErrorInvalidValue;
    int4_fma_kernel<__nv_bfloat16><<<grid, FM_THREADS, 0, st>>>(
        (const __nv_bfloat16*)x, ldx, (const uint8_t*)packed, (const float*)scale,
        (__nv_bfloat16*)out, (float*)partial, M, half, d_out, G, rpb);
    return cudaGetLastError();
  }
  if (route != ROUTE_WGMMA_STAGE && route != ROUTE_WGMMA_KSTEP) return cudaErrorInvalidValue;
  const int gs = G == 1 ? half : half / (G / 2);
  if (G > 1 && gs % (route == ROUTE_WGMMA_STAGE ? WG_KT : 16) != 0)
    return cudaErrorInvalidValue;
  if (ldx % 8 != 0 || x_hi % 8 != 0 || x_hi < half || ldx < x_hi + half ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0 || rpb % WG_KT != 0)
    return cudaErrorInvalidValue;
  const bool stage = route == ROUTE_WGMMA_STAGE;
  if (tile_m == 64)
    return stage ? launch_wgmma<1, 4>(x, ldx, x_hi, packed, scale, out, partial, M, half,
                                      d_out, G, rpb, ks, st)
                 : launch_wgmma<1, 1>(x, ldx, x_hi, packed, scale, out, partial, M, half,
                                      d_out, G, rpb, ks, st);
  if (tile_m == 128)
    return stage ? launch_wgmma<2, 4>(x, ldx, x_hi, packed, scale, out, partial, M, half,
                                      d_out, G, rpb, ks, st)
                 : launch_wgmma<2, 1>(x, ldx, x_hi, packed, scale, out, partial, M, half,
                                      d_out, G, rpb, ks, st);
  return cudaErrorInvalidValue;
}

template <>
cudaError_t launch_tiles<float>(const void* x, long long ldx, int x_hi, const void* packed,
                                const void* scale, void* out, void* partial, int M,
                                int half, int d_out, int G, int rpb, int ks, int tile_m,
                                int route, cudaStream_t st) {
  if (route != ROUTE_FMA || tile_m != FM_BM || x_hi != half) return cudaErrorInvalidValue;
  dim3 grid((d_out + FM_BN - 1) / FM_BN, (M + FM_BM - 1) / FM_BM, ks);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  int4_fma_kernel<float><<<grid, FM_THREADS, 0, st>>>(
      (const float*)x, ldx, (const uint8_t*)packed, (const float*)scale,
      (float*)out, (float*)partial, M, half, d_out, G, rpb);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_int4(const void* x, long long ldx, int x_hi, const void* packed,
                        const void* scale, void* out, void* partial, int M,
                        int half, int d_out, int G, int rpb, int ks, int tile_m,
                        int route, cudaStream_t st) {
  void* part = ks > 1 ? partial : nullptr;
  cudaError_t err =
      tile_m == 0
          ? launch_gemv<T>(x, ldx, packed, scale, out, part, M, half, d_out, G, rpb, ks, st)
          : launch_tiles<T>(x, ldx, x_hi, packed, scale, out, part, M, half, d_out, G, rpb,
                            ks, tile_m, route, st);
  if (err != cudaSuccess || ks == 1) return err;
  const size_t n = (size_t)M * d_out;
  int4_reduce_kernel<T><<<(unsigned)((n + 255) / 256), 256, 0, st>>>(
      (const float*)partial, (T*)out, ks, n);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Kernel G. x [M, d_in] with row stride ldx (elements) and its high plane
// (columns d_in / 2 ..) from column x_hi on (d_in / 2 unless the wrapper
// padded the planes apart for TMA; only the bf16 tile kernel takes another
// value), packed uint8
// [d_in/2, d_out], scale fp32 [G, d_out], out [M, d_out] in x's dtype, all
// but x dense. The packed rows are split into ks ranges of rpb rows; with
// ks > 1 `partial` is fp32 scratch [ks, M, d_out]. `tile_m` 0 selects the
// M <= 8 kernel, else the rows of an output tile (fp32: 64; bf16: 64 or
// 128), and `route` the tile kernel (ROUTE_*; not read when tile_m is 0).
// Returns a cudaError_t code (0 = success).
int ivl_int4_matmul(int dtype, const void* x, long long ldx, int x_hi, const void* packed,
                    const void* scale, void* out, void* partial, int M, int d_in,
                    int d_out, int G, int rpb, int ks, int tile_m, int route,
                    void* stream) {
  if (M <= 0 || d_in <= 0 || d_out <= 0 || d_in % 2 != 0 || G <= 0 || rpb <= 0 ||
      ks <= 0)
    return (int)cudaErrorInvalidValue;
  const int half = d_in / 2;
  if (G != 1 && (G % 2 != 0 || half % (G / 2) != 0)) return (int)cudaErrorInvalidValue;
  if ((long long)ks * rpb < half || (ks > 1 && partial == nullptr) || ks > 65535)
    return (int)cudaErrorInvalidValue;
  if (tile_m == 0 && M > 8 * 65535) return (int)cudaErrorInvalidValue;
  if (tile_m == 0 && x_hi != half) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == ivl::DTYPE_F32)
    return (int)launch_int4<float>(x, ldx, x_hi, packed, scale, out, partial, M, half,
                                   d_out, G, rpb, ks, tile_m, route, st);
  if (dtype == ivl::DTYPE_BF16)
    return (int)launch_int4<__nv_bfloat16>(x, ldx, x_hi, packed, scale, out, partial, M,
                                           half, d_out, G, rpb, ks, tile_m, route, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
