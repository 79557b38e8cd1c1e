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
// (the ragged last tile) are never visible.
//
//   Bound on the H100: at S = 9216 (one 1344x1344 image), H = 16 the two
//   products are 4 S^2 D H = 435 GFLOP against 94 MB of q, k, v and out,
//   so the kernel is compute-bound. Two variants:
//   - bf16 (the model's dtype): the wgmma + TMA mainloop shared with A1
//     and H's forward (swa_fwd_wgmma.cuh) at D = 80, with this file's
//     VitSrc as its key source and mask (below). The tiles are five slabs
//     of 16 columns in the 32-byte swizzle, so S = Q K^T is five k-steps
//     and O += P V one m64n80 product per 16 keys: no column is padded.
//   - fp32: plain FMA from shared memory (tiles of 64 keys reused by 32
//     query rows); tensor cores would round fp32 operands. It skips a key
//     tile that no query row of the block may see before loading it.
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

#include "swa_fwd_wgmma.cuh"

namespace {

using ivl::NEG_INF;
using ivl::from_f;
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
// The shared mainloop at D = 80 with the packed sequence as its key
// source: a block owns 64 CWG query rows (tokens q0 ..) of one head, one
// consumer warpgroup per 64, and walks the key tiles of key_range (every
// tile for E; for F the windows its rows lie in). Where the walk's tiles
// line up with the windows (E, and F when win_len is a multiple of 64) the
// block first takes each walked tile's interval [min, max] of segment ids
// over its real keys into shared memory; the rows' interval is that of the
// block's own tiles, which the walk holds. A tile is then
//   skipped  when its interval and the rows' are disjoint: no key shares a
//            segment with any row (producer and consumers read the same
//            table, so they agree);
//   whole    when both are full tiles of one and the same id and, for F,
//            the block's rows lie in one window (win_len a multiple of
//            64 CWG; the walk is then that window): every pair is
//            visible, so the softmax takes no per-element mask;
//   masked   otherwise: per element, from the keys' ids that the producer
//            stages beside K and V; a key outside the row's window or past
//            S is never seen (TMA's zero fill of K and V is no mask).
// Other win_len (windows that straddle a tile) take the element mask on
// every tile. A masked tile whose mask is empty for every row of a
// warpgroup skips its products there (VOTE). ops/vit_kernels.vit_tile_walk
// is the walk's twin.
//   The kernel streams K and V from L2 once per block (S / 64 tiles of
// 20 KB at E's S 9,216); on an H100 that stream alone took as long as the
// whole kernel with one consumer warpgroup, so E (and F at long windows)
// take CWG 2 or 3 and one load serves 128 or 192 rows. The caller chooses
// CWG (ops/vit_kernels.vit_warpgroups).
using bf16 = __nv_bfloat16;
using VTile = ivl::FwTile<VD>;

// the 64 x 80 tile of head h at tokens t0 ..: five copies of a 64 x 16 slab
// (TMA's zeros past S)
__device__ __forceinline__ void slab_load(unsigned char* dst, const CUtensorMap* map,
                                          uint64_t* bar, int h, int t0) {
#pragma unroll
  for (int g = 0; g < VD / 16; ++g)
    ivl::tma_load_3d(dst + g * VTile::SLAB, map, bar, 16 * g, h, t0);
}

template <int CWG_>
struct VitSrc {
  static constexpr int D = VD, CWG = CWG_, ROWS = ivl::FW_T * CWG_;
  static constexpr bool VOTE = true, FAST = true;
  struct Row {
    int seg, lo, hi;  // the row's segment id; its window's keys [lo, hi)
    bool ok;
  };
  const CUtensorMap *qmap, *kmap, *vmap;
  const int* seg;
  const int2* range;  // shared memory: [min, max] id of each walked tile (ranged walks)
  bf16* out;
  int2 rows;  // [min, max] id of the block's real rows (ranged walks)
  int S, H, h, q0, kb, n, win_len;
  bool ranged;

  __device__ int count() const { return n; }
  __device__ bool skip(int i) const {
    if (!ranged) return false;
    const int2 t = range[i];
    return t.y < rows.x || t.x > rows.y;
  }
  // (for F only where the block's rows lie in one window, which the walk
  // then is: win_len a multiple of ROWS)
  __device__ bool whole(int i) const {
    if (!ranged || win_len % ROWS) return false;
    const int2 t = range[i];
    return q0 + ROWS <= S && kb + (i + 1) * ivl::FW_T <= S && rows.x == rows.y &&
           t.x == t.y && t.x == rows.x;
  }
  __device__ void load_q(unsigned char* Qs, uint64_t* bar) const {
    ivl::mbar_arrive_tx(bar, CWG * VTile::BYTES);
#pragma unroll
    for (int w = 0; w < CWG; ++w)
      slab_load(Qs + w * VTile::BYTES, qmap, bar, h, q0 + w * ivl::FW_T);
  }
  __device__ void load(int i, unsigned char* st, uint64_t* bar, int lane) const {
    const int k0 = kb + i * ivl::FW_T;
    if (!whole(i)) {  // the keys' ids for the element mask
      int* ids = reinterpret_cast<int*>(st + 2 * VTile::BYTES);
#pragma unroll
      for (int r = lane; r < ivl::FW_T; r += 32) ids[r] = k0 + r < S ? seg[k0 + r] : SEG_NONE;
    }
    if (lane == 0) {
      ivl::mbar_arrive_tx(bar, 2 * VTile::BYTES);
      slab_load(st, kmap, bar, h, k0);
      slab_load(st + VTile::BYTES, vmap, bar, h, k0);
    } else {
      ivl::mbar_arrive(bar);
    }
  }
  __device__ Row row(int r) const {
    const int qp = q0 + r;
    const bool ok = qp < S;
    const int lo = win_len > 0 ? qp / win_len * win_len : 0;
    return Row{ok ? seg[qp] : 0, lo, win_len > 0 ? min(lo + win_len, S) : S, ok};
  }
  __device__ bool sees(int i, const unsigned char* st, const Row& w, int kl) const {
    const int kp = kb + i * ivl::FW_T + kl;
    return w.ok && kp >= w.lo && kp < w.hi &&
           reinterpret_cast<const int*>(st + 2 * VTile::BYTES)[kl] == w.seg;
  }
  __device__ void store(int r, int tig, const float (&acc)[VTile::ACC], const float (&)[2],
                        const float (&l)[2]) const {
#pragma unroll
    for (int ii = 0; ii < 2; ++ii) {
      const int qp = q0 + r + 8 * ii;
      if (qp >= S) continue;
      const float inv = 1.f / fmaxf(l[ii], 1e-30f);
      bf16* o = out + ((size_t)qp * H + h) * VD + 2 * tig;
#pragma unroll
      for (int j = 0; j < VD / 8; ++j)
        *reinterpret_cast<uint32_t*>(o + 8 * j) =
            ivl::pack_bf16(acc[4 * j + 2 * ii] * inv, acc[4 * j + 2 * ii + 1] * inv);
    }
  }
};

// intervals a block keeps where the walk's tiles line up with the windows
// (E; F at win_len a multiple of 64): the most tiles a walk of `rows` query
// rows holds (every tile for E; for F the windows the rows may touch), 0
// when the windows straddle tiles
int range_tiles(int S, int win_len, int rows) {
  if (win_len % ivl::FW_T) return 0;
  const int all = (S + ivl::FW_T - 1) / ivl::FW_T;
  if (win_len == 0) return all;
  const long long walk = (long long)((rows - 1) / win_len + 2) * (win_len / ivl::FW_T);
  return walk < all ? (int)walk : all;
}

// grid: (block of 64 CWG query rows, head); one block an SM with two or
// three consumer warpgroups, two with one
template <int CWG>
__global__ void __launch_bounds__(ivl::fw_threads(CWG), CWG == 1 ? 2 : 1)
vit_flash_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                       const __grid_constant__ CUtensorMap kmap,
                       const __grid_constant__ CUtensorMap vmap, const int* __restrict__ seg,
                       bf16* __restrict__ out, int S, int H, int win_len, float scale) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = ivl::aligned_smem(smem_raw);
  int2* range = reinterpret_cast<int2*>(sm + ivl::fw_smem_used<VD, CWG>());
  VitSrc<CWG> src;
  src.qmap = &qmap;
  src.kmap = &kmap;
  src.vmap = &vmap;
  src.seg = seg;
  src.range = range;
  src.out = out;
  src.S = S;
  src.H = H;
  src.h = blockIdx.y;
  src.win_len = win_len;
  src.q0 = blockIdx.x * src.ROWS;
  const KeyRange kr = key_range(src.q0, src.ROWS, S, win_len);
  src.kb = kr.begin;
  src.n = (kr.end - kr.begin + ivl::FW_T - 1) / ivl::FW_T;
  src.ranged = win_len % ivl::FW_T == 0;
  if (src.ranged) {  // block-uniform: each warp takes every (4 CWG + 1)-th tile
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll 4
    for (int i = warp; i < src.n; i += ivl::fw_threads(CWG) / 32) {
      const int k0 = src.kb + i * ivl::FW_T;
      const bool va = k0 + lane < S, vb = k0 + 32 + lane < S;  // key k0 < S is real
      const int a = va ? __ldg(seg + k0 + lane) : 0;
      const int b = vb ? __ldg(seg + k0 + 32 + lane) : 0;
      const int lo = __reduce_min_sync(0xffffffffu, min(va ? a : INT_MAX, vb ? b : INT_MAX));
      const int hi = __reduce_max_sync(0xffffffffu, max(va ? a : INT_MIN, vb ? b : INT_MIN));
      if (lane == 0) range[i] = make_int2(lo, hi);
    }
    __syncthreads();
    // the rows' interval: their tiles in the walk (none past S)
    const int rt = (src.q0 - src.kb) / ivl::FW_T;
    src.rows = range[rt];
#pragma unroll
    for (int w = 1; w < CWG; ++w)
      if (rt + w < src.n)
        src.rows = make_int2(min(src.rows.x, range[rt + w].x), max(src.rows.y, range[rt + w].y));
  }
  ivl::fwd_mainloop(src, sm, scale);
}

template <int CWG>
cudaError_t launch_wgmma(const CUtensorMap* maps, const void* seg, void* out, int S, int H,
                         int win_len, float scale, cudaStream_t st) {
  const int smem = ivl::fw_smem<VD, CWG>() + 8 * range_tiles(S, win_len, ivl::FW_T * CWG);
  cudaError_t err = cudaFuncSetAttribute(vit_flash_wgmma_kernel<CWG>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  constexpr int rows = ivl::FW_T * CWG;
  vit_flash_wgmma_kernel<CWG><<<dim3((S + rows - 1) / rows, H), ivl::fw_threads(CWG), smem, st>>>(
      maps[0], maps[1], maps[2], (const int*)seg, (bf16*)out, S, H, win_len, scale);
  return cudaGetLastError();
}

// a 3-D map over [S, H, 80] bf16 (tokens `stride` elements apart, a token's
// [H, 80] dense) with boxes of 16 columns x 1 head x 64 tokens in the
// 32-byte swizzle
bool vit_map(CUtensorMap* map, const void* base, int S, int H, long long stride) {
  const cuuint64_t dims[3] = {VD, (cuuint64_t)H, (cuuint64_t)S};
  const cuuint64_t strides[2] = {VD * 2, (cuuint64_t)stride * 2};
  const cuuint32_t box[3] = {16, 1, ivl::FW_T};
  return ivl::make_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, base, dims, strides, box,
                       CU_TENSOR_MAP_SWIZZLE_32B);
}

}  // namespace

extern "C" {

// Kernel E (win_len 0) and kernel F (win_len > 0: attention within windows
// of win_len consecutive tokens). sq, sk, sv: elements between consecutive
// tokens of q, k, v
// (H * D when contiguous); within a token the layout is [H, D]. For bf16
// (TMA) they must be multiples of 8, and the pointers 16-byte aligned, and
// cwg (1, 2 or 3) is the consumer warpgroups of a block, 64 query rows
// each; fp32 ignores it. Returns a cudaError_t code (0 = success).
int ivl_vit_flash(int dtype, const void* q, const void* k, const void* v,
                  const void* seg, void* out, int S, int H, int D,
                  long long sq, long long sk, long long sv, float scale,
                  int win_len, int cwg, void* stream) {
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
    // TMA: row strides and base pointers on 16 bytes
    if (sq % 8 || sk % 8 || sv % 8 || (uintptr_t)q % 16 || (uintptr_t)k % 16 ||
        (uintptr_t)v % 16 || cwg < 1 || cwg > 3)
      return (int)cudaErrorInvalidValue;
    CUtensorMap maps[3];
    if (!vit_map(&maps[0], q, S, H, sq) || !vit_map(&maps[1], k, S, H, sk) ||
        !vit_map(&maps[2], v, S, H, sv))
      return (int)cudaErrorInvalidValue;
    switch (cwg) {
      case 1: return (int)launch_wgmma<1>(maps, seg, out, S, H, win_len, scale, st);
      case 2: return (int)launch_wgmma<2>(maps, seg, out, S, H, win_len, scale, st);
      default: return (int)launch_wgmma<3>(maps, seg, out, S, H, win_len, scale, st);
    }
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
