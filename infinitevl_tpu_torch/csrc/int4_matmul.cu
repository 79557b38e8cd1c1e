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
//   - M > 8 (a frame's 257 tokens, a prefill chunk): bound by operations.
//     bf16: int4_mma_kernel dequantises a 32 x 64 packed tile into two bf16
//     tiles in shared memory (small integers are exact in bf16) and
//     multiplies on mma.sync m16n8k16 tensor cores, 64 x 64 outputs per block
//     of 4 warps, the two planes in separate fp32 fragments until the group's
//     scale joins them. fp32: int4_fma_kernel, the same tiling on plain FMA
//     (tensor cores would round fp32 operands).
#include "common.cuh"

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
constexpr int MM_BM = 64;  // output rows per block: 16 per warp
constexpr int MM_BN = 64;  // output columns per block
constexpr int MM_KT = 32;  // packed rows per tile
constexpr int MM_STR = MM_KT + 8;  // bf16 per tile row (conflict-free fragment loads)
constexpr int MM_THREADS = 128;

__global__ void __launch_bounds__(MM_THREADS)
int4_mma_kernel(const __nv_bfloat16* __restrict__ x, long long ldx,
                const uint8_t* __restrict__ packed,
                const float* __restrict__ scale, __nv_bfloat16* __restrict__ out,
                float* __restrict__ partial, int M, int half, int d_out, int G,
                int rpb) {
  __shared__ __align__(16) __nv_bfloat16 Xs[2][MM_BM * MM_STR];  // [plane][m][k]
  __shared__ __align__(16) __nv_bfloat16 Ws[2][MM_BN * MM_STR];  // [plane][n][k]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int n0 = blockIdx.x * MM_BN, m0 = blockIdx.y * MM_BM;
  const int r0 = blockIdx.z * rpb;
  const int r1 = min(r0 + rpb, half);
  const int gs = G == 1 ? half : half / (G / 2);
  const int hi_base = G == 1 ? 0 : G / 2;
  const __nv_bfloat16 zero = __float2bfloat16(0.f);

  float acc[MM_BN / 8][4], plo[MM_BN / 8][4], phi[MM_BN / 8][4];
#pragma unroll
  for (int nt = 0; nt < MM_BN / 8; ++nt)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[nt][c] = plo[nt][c] = phi[nt][c] = 0.f;

  for (int k0 = r0; k0 < r1;) {
    const int g1 = min(r1, group_end(k0, gs));
    const int k1 = min(k0 + MM_KT, g1);  // a tile never straddles a group
    const int kn = k1 - k0;
    __syncthreads();  // the previous tile's readers are done

    // x tiles of both planes: 2 x 64 rows x 32 k, as vectors of 8
    for (int i = tid; i < 2 * MM_BM * (MM_KT / 8); i += MM_THREADS) {
      const int p = i / (MM_BM * (MM_KT / 8));
      const int rem = i % (MM_BM * (MM_KT / 8));
      const int row = rem / (MM_KT / 8), kv = (rem % (MM_KT / 8)) * 8;
      __nv_bfloat16* dst = &Xs[p][row * MM_STR + kv];
      const int grow = m0 + row;
      const __nv_bfloat16* src = x + (size_t)grow * ldx + (size_t)p * half + k0 + kv;
      if (grow < M && kv + 8 <= kn && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
        *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) dst[e] = (grow < M && kv + e < kn) ? src[e] : zero;
      }
    }
    // packed tile 32 k x 64 n -> both planes in bf16, transposed to [n][k]
    {
      const int k = tid >> 2, nn = (tid & 3) * 16;
      __align__(16) uint8_t b[16];
      const uint8_t* src = packed + (size_t)(k0 + k) * d_out + n0 + nn;
      if (k < kn && n0 + nn + 16 <= d_out && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
        *reinterpret_cast<uint4*>(b) = *reinterpret_cast<const uint4*>(src);
      } else {
#pragma unroll
        for (int e = 0; e < 16; ++e)
          b[e] = (k < kn && n0 + nn + e < d_out) ? src[e] : (uint8_t)0;  // 0 unpacks to 0
      }
#pragma unroll
      for (int e = 0; e < 16; ++e) {
        Ws[0][(nn + e) * MM_STR + k] = __float2bfloat16(nib(b[e] & 15u));
        Ws[1][(nn + e) * MM_STR + k] = __float2bfloat16(nib(b[e] >> 4));
      }
    }
    __syncthreads();

#pragma unroll
    for (int ks = 0; ks < MM_KT / 16; ++ks) {
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        const __nv_bfloat16* xr = Xs[p] + (warp * 16 + gid) * MM_STR + ks * 16 + 2 * tig;
        const uint32_t a[4] = {ld32(xr), ld32(xr + 8 * MM_STR), ld32(xr + 8),
                               ld32(xr + 8 * MM_STR + 8)};
#pragma unroll
        for (int nt = 0; nt < MM_BN / 8; ++nt) {
          const __nv_bfloat16* wr = Ws[p] + (nt * 8 + gid) * MM_STR + ks * 16 + 2 * tig;
          mma_bf16(p == 0 ? plo[nt] : phi[nt], a, ld32(wr), ld32(wr + 8));
        }
      }
    }

    k0 = k1;
    if (k0 == g1) {  // the group (or this block's range) ends: its scale joins
      const int srow = G == 1 ? 0 : (g1 - 1) / gs;
#pragma unroll
      for (int nt = 0; nt < MM_BN / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = n0 + nt * 8 + 2 * tig + e;
          const float sl = col < d_out ? scale[(size_t)srow * d_out + col] : 0.f;
          const float sh = col < d_out ? scale[(size_t)(hi_base + srow) * d_out + col] : 0.f;
          acc[nt][e] += plo[nt][e] * sl + phi[nt][e] * sh;
          acc[nt][2 + e] += plo[nt][2 + e] * sl + phi[nt][2 + e] * sh;
          plo[nt][e] = plo[nt][2 + e] = phi[nt][e] = phi[nt][2 + e] = 0.f;
        }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = m0 + warp * 16 + gid + 8 * i;
    if (row >= M) continue;
#pragma unroll
    for (int nt = 0; nt < MM_BN / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = n0 + nt * 8 + 2 * tig + e;
        if (col >= d_out) continue;
        const float v = acc[nt][2 * i + e];
        if (partial != nullptr)
          partial[((size_t)blockIdx.z * M + row) * d_out + col] = v;
        else
          out[(size_t)row * d_out + col] = __float2bfloat16(v);
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

template <typename T>
cudaError_t launch_tiles(const void* x, long long ldx, const void* packed,
                         const void* scale, void* out, void* partial, int M,
                         int half, int d_out, int G, int rpb, int ks,
                         cudaStream_t st);

template <>
cudaError_t launch_tiles<__nv_bfloat16>(const void* x, long long ldx, const void* packed,
                                        const void* scale, void* out, void* partial,
                                        int M, int half, int d_out, int G, int rpb,
                                        int ks, cudaStream_t st) {
  dim3 grid((d_out + MM_BN - 1) / MM_BN, (M + MM_BM - 1) / MM_BM, ks);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  int4_mma_kernel<<<grid, MM_THREADS, 0, st>>>(
      (const __nv_bfloat16*)x, ldx, (const uint8_t*)packed, (const float*)scale,
      (__nv_bfloat16*)out, (float*)partial, M, half, d_out, G, rpb);
  return cudaGetLastError();
}

template <>
cudaError_t launch_tiles<float>(const void* x, long long ldx, const void* packed,
                                const void* scale, void* out, void* partial, int M,
                                int half, int d_out, int G, int rpb, int ks,
                                cudaStream_t st) {
  dim3 grid((d_out + FM_BN - 1) / FM_BN, (M + FM_BM - 1) / FM_BM, ks);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  int4_fma_kernel<float><<<grid, FM_THREADS, 0, st>>>(
      (const float*)x, ldx, (const uint8_t*)packed, (const float*)scale,
      (float*)out, (float*)partial, M, half, d_out, G, rpb);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_int4(const void* x, long long ldx, const void* packed,
                        const void* scale, void* out, void* partial, int M,
                        int half, int d_out, int G, int rpb, int ks, int small,
                        cudaStream_t st) {
  void* part = ks > 1 ? partial : nullptr;
  cudaError_t err =
      small ? launch_gemv<T>(x, ldx, packed, scale, out, part, M, half, d_out, G, rpb, ks, st)
            : launch_tiles<T>(x, ldx, packed, scale, out, part, M, half, d_out, G, rpb, ks, st);
  if (err != cudaSuccess || ks == 1) return err;
  const size_t n = (size_t)M * d_out;
  int4_reduce_kernel<T><<<(unsigned)((n + 255) / 256), 256, 0, st>>>(
      (const float*)partial, (T*)out, ks, n);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Kernel G. x [M, d_in] with row stride ldx (elements), packed uint8
// [d_in/2, d_out], scale fp32 [G, d_out], out [M, d_out] in x's dtype, all
// but x dense. The packed rows are split into ks ranges of rpb rows; with
// ks > 1 `partial` is fp32 scratch [ks, M, d_out]. `small` selects the
// M <= 8 kernel. Returns a cudaError_t code (0 = success).
int ivl_int4_matmul(int dtype, const void* x, long long ldx, const void* packed,
                    const void* scale, void* out, void* partial, int M, int d_in,
                    int d_out, int G, int rpb, int ks, int small, void* stream) {
  if (M <= 0 || d_in <= 0 || d_out <= 0 || d_in % 2 != 0 || G <= 0 || rpb <= 0 ||
      ks <= 0)
    return (int)cudaErrorInvalidValue;
  const int half = d_in / 2;
  if (G != 1 && (G % 2 != 0 || half % (G / 2) != 0)) return (int)cudaErrorInvalidValue;
  if ((long long)ks * rpb < half || (ks > 1 && partial == nullptr) || ks > 65535)
    return (int)cudaErrorInvalidValue;
  if (small && M > 8 * 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == ivl::DTYPE_F32)
    return (int)launch_int4<float>(x, ldx, packed, scale, out, partial, M, half,
                                   d_out, G, rpb, ks, small, st);
  if (dtype == ivl::DTYPE_BF16)
    return (int)launch_int4<__nv_bfloat16>(x, ldx, packed, scale, out, partial, M,
                                           half, d_out, G, rpb, ks, small, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
