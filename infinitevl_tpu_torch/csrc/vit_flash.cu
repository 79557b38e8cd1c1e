// Kernels E and F: non-causal flash attention over the packed ViT sequence,
// masked by segment id (E), and the same on diagonal blocks for the window
// layers (F).
//
// E replaces infinitevl_tpu/ops/vit_flash.py::segment_flash_attention
// (_vit_flash_kernel). For each head, softmax(scale Q K^T masked by
// seg_q == seg_k) V with an online softmax in fp32. Pads carry segment -1
// and attend only each other, so their rows stay finite; l is floored at
// 1e-30. Layout [S, H, D] in and out, D = 80; q, k and v each come with
// their own row stride (elements between tokens), so a slice of the
// [S, 3, H, D] projection is read where it lies. The TPU wrapper's pad of
// D to 128, its [H, S, Dp] transposes and its two replicated segment
// arrays are layout artefacts and have no counterpart here. Keys past S
// (the ragged last tile) get a segment id no query has.
//
//   Bound on the H100: at S = 9216 (one 1344x1344 image), H = 16 the two
//   products are 4 S^2 D H = 435 GFLOP against 94 MB of q, k, v and out,
//   so the kernel is compute-bound. Two variants share tiling and mask:
//   - bf16 (the model's dtype): tensor cores through mma.sync m16n8k16,
//     D = 80 as five k-steps of 16. A block of 4 warps owns 64 query rows
//     of one head; each warp keeps its 16 rows' Q fragments in registers,
//     computes S = Q K^T for a 64-key tile staged in shared memory, runs
//     the online softmax on the accumulator fragments and feeds P back as
//     the A operand of O += P V (V staged transposed).
//   - fp32: plain FMA from shared memory (tiles of 64 keys reused by 32
//     query rows); tensor cores would round fp32 operands.
//   Both skip a key tile that no query row of the block may see (another
//   image's or frame's segment) before loading it.
//
// F replaces infinitevl_tpu/ops/vit_flash.py::window_flash_attention: the
// same kernels entered with win_len > 0. The sequence is in window order,
// window w holding tokens [w * win_len, (w + 1) * win_len) with pads of
// segment -2 - w, and a query sees the keys of its own window that share
// its segment id. A block's key loop covers only the windows its query
// rows lie in (one window when win_len >= the block's rows, else the few
// it straddles), so the work is S * win_len and not S^2: at S = 9216,
// win_len = 256 the products are 12 GFLOP against 94 MB of q, k, v and
// out, which makes F bytes-bound. Any win_len >= 1 is taken; there is no
// upper bound (the TPU kernel's was a scoped-stack limit).
#include <limits.h>

#include "common.cuh"

namespace {

using ivl::NEG_INF;
using ivl::from_f;
using ivl::ld32;
using ivl::mma_bf16;
using ivl::pack_bf16;
using ivl::to_f;

constexpr int VD = 80;            // head dim the kernels are written for
constexpr int SEG_NONE = INT_MIN; // segment of a key past the sequence end

// Keys a block of `rows` query rows starting at row0 has to visit: the
// whole sequence for E (win_len 0), the windows its rows lie in for F.
struct KeyRange {
  int begin, end;
};
__device__ __forceinline__ KeyRange key_range(int row0, int rows, int S, int win_len) {
  KeyRange r;
  r.begin = 0;
  r.end = S;
  if (win_len > 0) {
    const int last = min(row0 + rows, S) - 1;
    r.begin = row0 / win_len * win_len;
    r.end = min(S, (last / win_len + 1) * win_len);
  }
  return r;
}

// ---------------------------------------------------------------- fp32
constexpr int F_BR = 32;        // query rows per block
constexpr int F_BK = 64;        // keys per tile
constexpr int F_THREADS = 128;  // 4 threads per query row
constexpr int F_SMEM_FLOATS =
    F_BR * (VD + 1) + F_BK * (VD + 1) + F_BK * VD + F_BR * (F_BK + 1);

template <typename T>
__global__ void __launch_bounds__(F_THREADS)
vit_flash_kernel(const T* __restrict__ q,  // [S, H, VD], rows sq elements apart
                 const T* __restrict__ k,  // rows sk apart
                 const T* __restrict__ v,  // rows sv apart
                 const int* __restrict__ seg,  // [S]
                 T* __restrict__ out,          // [S, H, VD] contiguous
                 int S, int H, size_t sq, size_t sk, size_t sv, float scale,
                 int win_len) {
  extern __shared__ float smem[];
  float* Qs = smem;                   // [BR][VD + 1]
  float* Ks = Qs + F_BR * (VD + 1);   // [BK][VD + 1]
  float* Vs = Ks + F_BK * (VD + 1);   // [BK][VD]
  float* Ps = Vs + F_BK * VD;         // [BR][BK + 1]

  const int h = blockIdx.y;
  const int row0 = blockIdx.x * F_BR;
  const int tid = threadIdx.x;
  const int r_loc = tid >> 2;  // this thread's query row in the block
  const int c4 = tid & 3;      // column phase: keys c4 + 4m, dims c4 + 4i
  const int row = row0 + r_loc;
  const bool row_ok = row < S;
  const int my_seg = row_ok ? seg[row] : 0;

  for (int i = tid; i < F_BR * VD; i += F_THREADS) {
    const int rr = i / VD, d = i % VD;
    const int grow = row0 + rr;
    Qs[rr * (VD + 1) + d] = grow < S ? to_f(q[(size_t)grow * sq + h * VD + d]) : 0.f;
  }

  float m_i = NEG_INF, l_i = 0.f;
  float acc[VD / 4];
#pragma unroll
  for (int i = 0; i < VD / 4; ++i) acc[i] = 0.f;

  const KeyRange kr = key_range(row0, F_BR, S, win_len);
  const int my_win = win_len > 0 ? row / win_len : 0;
  for (int k0 = kr.begin; k0 < kr.end; k0 += F_BK) {
    unsigned vis = 0;  // bit m: key k0 + c4 + 4m visible to this row
#pragma unroll
    for (int m = 0; m < F_BK / 4; ++m) {
      const int j = k0 + c4 + 4 * m;
      if (row_ok && j < kr.end && seg[j] == my_seg &&
          (win_len <= 0 || j / win_len == my_win))
        vis |= 1u << m;
    }
    // also the barrier that retires the previous tile's readers
    if (!__syncthreads_or(vis != 0u)) continue;

    for (int i = tid; i < F_BK * VD; i += F_THREADS) {
      const int jj = i / VD, d = i % VD;
      const int j = k0 + jj;
      float kv = 0.f, vv = 0.f;
      if (j < S) {
        kv = to_f(k[(size_t)j * sk + h * VD + d]);
        vv = to_f(v[(size_t)j * sv + h * VD + d]);
      }
      Ks[jj * (VD + 1) + d] = kv;
      Vs[jj * VD + d] = vv;
    }
    __syncthreads();

    float s[F_BK / 4];
#pragma unroll
    for (int m = 0; m < F_BK / 4; ++m) s[m] = 0.f;
    for (int d = 0; d < VD; ++d) {
      const float qv = Qs[r_loc * (VD + 1) + d];
#pragma unroll
      for (int m = 0; m < F_BK / 4; ++m) s[m] += qv * Ks[(c4 + 4 * m) * (VD + 1) + d];
    }

    float tile_max = NEG_INF;
#pragma unroll
    for (int m = 0; m < F_BK / 4; ++m) {
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
    for (int m = 0; m < F_BK / 4; ++m) {
      const float p = (vis >> m & 1u) ? expf(s[m] - m_new) : 0.f;
      psum += p;
      Ps[r_loc * (F_BK + 1) + c4 + 4 * m] = p;
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    psum += __shfl_xor_sync(0xffffffffu, psum, 2);
    l_i = l_i * alpha + psum;
    m_i = m_new;
#pragma unroll
    for (int i = 0; i < VD / 4; ++i) acc[i] *= alpha;
    __syncthreads();

    for (int jj = 0; jj < F_BK; ++jj) {
      const float p = Ps[r_loc * (F_BK + 1) + jj];
      const float* vrow = Vs + jj * VD + c4;
#pragma unroll
      for (int i = 0; i < VD / 4; ++i) acc[i] += p * vrow[4 * i];
    }
  }

  if (row_ok) {
    const float inv = 1.f / fmaxf(l_i, 1e-30f);
    T* o = out + ((size_t)row * H + h) * VD + c4;
#pragma unroll
    for (int i = 0; i < VD / 4; ++i) o[4 * i] = from_f<T>(acc[i] * inv);
  }
}

// ---------------------------------------------------------------- bf16
constexpr int M_WARPS = 4;
constexpr int M_BR = 16 * M_WARPS;  // query rows per block
constexpr int M_BK = 64;            // keys per tile
constexpr int KSTR = VD + 8;        // bf16 per row of Ks[key][d] (conflict-free B loads)
constexpr int VSTR = M_BK + 8;      // bf16 per row of Vt[d][key]

// Fragment layout of m16n8k16: see ivl::mma_bf16. The S accumulators s[nt]
// cover keys nt*8 .. nt*8+7 of the tile.
__global__ void __launch_bounds__(32 * M_WARPS)
vit_flash_mma_kernel(const __nv_bfloat16* __restrict__ q,  // [S, H, VD], rows sq apart
                     const __nv_bfloat16* __restrict__ k,  // rows sk apart
                     const __nv_bfloat16* __restrict__ v,  // rows sv apart
                     const int* __restrict__ seg,          // [S]
                     __nv_bfloat16* __restrict__ out,      // [S, H, VD] contiguous
                     int S, int H, size_t sq, size_t sk, size_t sv, float scale,
                     int win_len) {
  __shared__ __align__(16) __nv_bfloat16 Ks[M_BK * KSTR];
  __shared__ __align__(16) __nv_bfloat16 Vt[VD * VSTR];
  __shared__ int segs[M_BK];
  __shared__ int wins[M_BK];

  const int h = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;

  // this thread's two query rows: gid and gid + 8 of the warp's 16
  bool rok[2];
  int my_seg[2], my_win[2];
  size_t qoff[2], ooff[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = blockIdx.x * M_BR + warp * 16 + gid + 8 * i;
    rok[i] = row < S;
    my_seg[i] = rok[i] ? seg[row] : 0;
    my_win[i] = win_len > 0 ? row / win_len : 0;
    qoff[i] = (size_t)(rok[i] ? row : 0) * sq + h * VD;
    ooff[i] = ((size_t)(rok[i] ? row : 0) * H + h) * VD;
  }
  uint32_t qf[VD / 16][4];  // A fragments of the warp's 16 x VD query tile
#pragma unroll
  for (int ks = 0; ks < VD / 16; ++ks) {
    const int d = ks * 16 + 2 * tig;
    qf[ks][0] = rok[0] ? ld32(q + qoff[0] + d) : 0u;
    qf[ks][1] = rok[1] ? ld32(q + qoff[1] + d) : 0u;
    qf[ks][2] = rok[0] ? ld32(q + qoff[0] + d + 8) : 0u;
    qf[ks][3] = rok[1] ? ld32(q + qoff[1] + d + 8) : 0u;
  }

  float o[VD / 8][4];
#pragma unroll
  for (int dt = 0; dt < VD / 8; ++dt)
#pragma unroll
    for (int c = 0; c < 4; ++c) o[dt][c] = 0.f;
  float m_r[2] = {NEG_INF, NEG_INF}, l_r[2] = {0.f, 0.f};

  const KeyRange kr = key_range(blockIdx.x * M_BR, M_BR, S, win_len);
  for (int k0 = kr.begin; k0 < kr.end; k0 += M_BK) {
    __syncthreads();  // the previous tile's readers are done
    if (threadIdx.x < M_BK) {
      const int j = k0 + threadIdx.x;
      segs[threadIdx.x] = j < kr.end ? seg[j] : SEG_NONE;
      wins[threadIdx.x] = win_len > 0 ? j / win_len : 0;
    }
    __syncthreads();
    uint32_t vis = 0;  // bit i*16 + nt*2 + e: row i, key k0 + nt*8 + 2*tig + e
#pragma unroll
    for (int nt = 0; nt < M_BK / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key_seg = segs[nt * 8 + 2 * tig + e];
        const int key_win = wins[nt * 8 + 2 * tig + e];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          if (rok[i] && key_seg == my_seg[i] && key_win == my_win[i])
            vis |= 1u << (i * 16 + nt * 2 + e);
      }
    if (!__syncthreads_or(vis != 0u)) continue;

    for (int c = threadIdx.x; c < M_BK * VD / 8; c += 32 * M_WARPS) {
      const int key = c / (VD / 8), d0 = (c % (VD / 8)) * 8;
      const int j = k0 + key;
      uint4 kv = make_uint4(0u, 0u, 0u, 0u), vv = make_uint4(0u, 0u, 0u, 0u);
      if (j < S) {
        kv = *reinterpret_cast<const uint4*>(k + (size_t)j * sk + h * VD + d0);
        vv = *reinterpret_cast<const uint4*>(v + (size_t)j * sv + h * VD + d0);
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
      for (int ks = 0; ks < VD / 16; ++ks)
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
    for (int dt = 0; dt < VD / 8; ++dt) {
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
      for (int dt = 0; dt < VD / 8; ++dt) {
        const __nv_bfloat16* vrow = Vt + (dt * 8 + gid) * VSTR + kk * 16 + 2 * tig;
        mma_bf16(o[dt], a, ld32(vrow), ld32(vrow + 8));
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (!rok[i]) continue;
    const float inv = 1.f / fmaxf(l_r[i], 1e-30f);
    __nv_bfloat16* orow = out + ooff[i] + 2 * tig;
#pragma unroll
    for (int dt = 0; dt < VD / 8; ++dt)
      *reinterpret_cast<uint32_t*>(orow + dt * 8) =
          pack_bf16(o[dt][2 * i] * inv, o[dt][2 * i + 1] * inv);
  }
}

}  // namespace

extern "C" {

// Kernel E (win_len 0) and kernel F (win_len > 0: attention within windows
// of win_len consecutive tokens). sq, sk, sv: elements between consecutive
// tokens of q, k, v
// (H * D when contiguous); within a token the layout is [H, D]. For bf16
// they must be multiples of 8, and the pointers 16-byte aligned. Returns a
// cudaError_t code (0 = success).
int ivl_vit_flash(int dtype, const void* q, const void* k, const void* v,
                  const void* seg, void* out, int S, int H, int D,
                  long long sq, long long sk, long long sv, float scale,
                  int win_len, void* stream) {
  if (D != VD || S <= 0 || H <= 0 || H > 65535 || sq < H * D || sk < H * D ||
      sv < H * D || win_len < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == ivl::DTYPE_F32) {
    const int smem = F_SMEM_FLOATS * (int)sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(
        vit_flash_kernel<float>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    vit_flash_kernel<float><<<dim3((S + F_BR - 1) / F_BR, H), F_THREADS, smem, st>>>(
        (const float*)q, (const float*)k, (const float*)v, (const int*)seg,
        (float*)out, S, H, (size_t)sq, (size_t)sk, (size_t)sv, scale, win_len);
    return (int)cudaGetLastError();
  }
  if (dtype == ivl::DTYPE_BF16) {
    using bf = __nv_bfloat16;
    if (sq % 8 || sk % 8 || sv % 8 || (uintptr_t)q % 16 || (uintptr_t)k % 16 ||
        (uintptr_t)v % 16)
      return (int)cudaErrorInvalidValue;  // the 16-byte tile loads
    vit_flash_mma_kernel<<<dim3((S + M_BR - 1) / M_BR, H), 32 * M_WARPS, 0, st>>>(
        (const bf*)q, (const bf*)k, (const bf*)v, (const int*)seg, (bf*)out, S, H,
        (size_t)sq, (size_t)sk, (size_t)sv, scale, win_len);
    return (int)cudaGetLastError();
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
