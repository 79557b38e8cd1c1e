// The bf16 flash-attention forward shared by kernel A1 (cached prefill over
// the ring, csrc/swa_ring_flash.cu), kernel H's forward (stateless
// training attention, csrc/swa_train_flash.cu) and kernels E and F (the
// ViT's segment and window attention, csrc/vit_flash.cu): one online-
// softmax mainloop on Hopper's wgmma fed by TMA, with the key source and
// the mask as a policy class that each kernel supplies, and the head dim
// (Src::D: 128 for A1 and H, 80 for E and F) choosing the tile layout.
//
// A block is one producer warp and Src::CWG consumer warpgroups (64 query
// rows each, 16 per warp) that share every stage. A1 and H take one (two
// blocks share an SM, so one block's softmax runs under the other's
// products; two consumer warpgroups measured 3-8% slower on an H100 for
// them); E and F take two or three where the rows allow, since their key
// tiles stream from L2 at a rate that bounds them (one load serves 128 or
// 192 rows). The producer loads the block's query tiles once, then keeps a
// ring of FW_STAGES stages of key tiles in flight: K and V, 64 keys x D
// dims each, by TMA (FwTile<D>: at D 128 in the 128-byte swizzle as two
// column halves of [64 rows][128 bytes], at D 80 in the 32-byte swizzle as
// five slabs of [64 rows][32 bytes]), plus 1 KB of the keys' row data that
// the policy fills (segment ids). Per stage:
//   S = Q K^T      wgmma m64n64k16 (D / 16 k-steps), both operands K-major
//                  in shared memory;
//   online softmax on the accumulators, the mask as 32 bits per thread
//                  (all ones when the policy proves the tile wholly visible
//                  by an interval test, so no per-element test runs);
//   O += P V       wgmma m64nDk16, P rounded to bf16 in registers (the A
//                  operand), V the MN-major B read where it lies: nothing
//                  is transposed by hand.
// Stage s completes on full[s] (the TMA bytes and the producer's 32
// arrivals) and is released on empty[s] (every consumer thread).
//
// The policy `Src` gives D (the head dim), CWG, FAST (online_softmax) and,
// for tile i of the block's walk:
//   count()            tiles in the walk;
//   skip(i)            the tile is never loaded (both sides agree);
//   load_q(Qs, bar)    lane 0 of the producer: the CWG query tiles;
//   load(i, st, bar, lane)  the producer warp's share of stage st;
//   row(r)             per-row data of block row r (a Row);
//   whole(i)           every (row, key) pair of the block is visible;
//   sees(i, st, row, kl)  key kl of the tile is visible to `row`;
//   store(r, tig, acc, m, l)  the epilogue of rows r and r + 8.
// VOTE: a tile whose mask is empty for every row skips its products.
#pragma once

#include "common.cuh"

namespace ivl {

constexpr int FW_T = 64;                      // rows of a tile
constexpr int FW_HALF = FW_T * 128;           // bytes of one 64-column half
constexpr int FW_TILE = 2 * FW_HALF;          // bytes of a 64 x 128 bf16 tile
constexpr int FW_STAGES = 2;

// threads of a block: `cwg` consumer warpgroups and the producer warp
__host__ __device__ constexpr int fw_threads(int cwg) { return 128 * cwg + 32; }
constexpr int FW_THREADS = fw_threads(1);

// a 64 x 128 tile of a 4-D map whose innermost dim is the 128 columns:
// coordinates (c1, c2, c3) of the box's other dims
__device__ __forceinline__ void tile_load(unsigned char* dst, const CUtensorMap* map,
                                          uint64_t* bar, int c1, int c2, int c3) {
  tma_load_4d(dst, map, bar, 0, c1, c2, c3);
  tma_load_4d(dst + FW_HALF, map, bar, 64, c1, c2, c3);
}

// k-step kk (columns 16 kk ..) of a tile as a K-major operand
__device__ __forceinline__ uint64_t desc_k(const unsigned char* tile, int kk) {
  return gmma_desc(tile + (kk >> 2) * FW_HALF + (kk & 3) * 32, 16, 1024);
}

// rows 16 kk .. of a tile as the MN-major B of a product with N = 128
__device__ __forceinline__ uint64_t desc_mn(const unsigned char* tile, int kk) {
  return gmma_desc(tile + kk * 2048, FW_HALF, 1024);
}

// The layout of a 64 x D bf16 tile in shared memory and the two products
// that read it: S = Q K^T in KSTEPS k-steps of 16 columns, and O += P V
// for the 16 keys of k-step kk of P (ACC accumulators of O a thread).
template <int D>
struct FwTile;

// D 128 (A1, H): two 64-column halves in the 128-byte swizzle (tile_load)
template <>
struct FwTile<128> {
  static constexpr int BYTES = FW_TILE, KSTEPS = 8, ACC = 64;
  static __device__ __forceinline__ uint64_t k_desc(const unsigned char* tile, int kk) {
    return desc_k(tile, kk);
  }
  static __device__ __forceinline__ void pv(float (&d)[ACC], const uint32_t (&a)[4],
                                            const unsigned char* v, int kk) {
    wgmma_rs_n128(d, a, desc_mn(v, kk), 1);
  }
};

// D 80 (E, F): five slabs of 16 columns, [64 rows][32 bytes] each, in the
// 32-byte swizzle. A slab is one K-major k-step of S; for P V it is the
// 16-column block j of the MN-major B (lbo: the next slab), so N = 80 is
// exact and no column is padded.
template <>
struct FwTile<80> {
  static constexpr int SLAB = FW_T * 32, BYTES = 5 * SLAB, KSTEPS = 5, ACC = 40;
  static __device__ __forceinline__ uint64_t k_desc(const unsigned char* tile, int kk) {
    return gmma_desc(tile + kk * SLAB, 16, 256, GMMA_SW32);
  }
  static __device__ __forceinline__ void pv(float (&d)[ACC], const uint32_t (&a)[4],
                                            const unsigned char* v, int kk) {
    wgmma_rs_n80(d, a, gmma_desc(v + kk * 16 * 32, SLAB, 256, GMMA_SW32), 1);
  }
};

// bytes of a stage (K, V and the keys' row data) and of a block's shared
// memory (the query tiles, the stages, the barriers; SMEM_ALIGN for the
// alignment), by head dim and consumer warpgroups
template <int D>
__host__ __device__ constexpr int fw_stage() { return 2 * FwTile<D>::BYTES + 1024; }
template <int D, int CWG = 1>
__host__ __device__ constexpr int fw_smem_used() {
  return CWG * FwTile<D>::BYTES + FW_STAGES * fw_stage<D>() + 64;
}
template <int D, int CWG = 1>
__host__ __device__ constexpr int fw_smem() { return fw_smem_used<D, CWG>() + SMEM_ALIGN; }
constexpr int FW_SMEM = fw_smem<128>();

// registers read by an in-flight wgmma stay where they are until the wait
template <int N>
__device__ __forceinline__ void keep(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}
template <int N>
__device__ __forceinline__ void keep(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// accumulator [64 x 64] -> four A fragments (16 columns each), in bf16
__device__ __forceinline__ void to_a(uint32_t (&a)[4][4], const float (&d)[32]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) a[kk][r] = pack_bf16(d[8 * kk + 2 * r], d[8 * kk + 2 * r + 1]);
}

// true on every thread of the calling warpgroup if `x` holds on any of them
// (named barrier `id`, 128 threads)
__device__ __forceinline__ bool wg_any(bool x, int id) {
  uint32_t r;
  asm volatile(
      "{\n.reg .pred p, q;\nsetp.ne.u32 q, %1, 0;\n"
      "bar.red.or.pred p, %2, 128, q;\nselp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(r)
      : "r"((uint32_t)x), "r"(id)
      : "memory");
  return r != 0;
}

// 2^x on the special-function unit alone: flushes results below 2^-126
// to zero, which a softmax's terms exp2(s - max) can spare
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// One tile of the online softmax in base 2 (scores scaled by scale log2 e,
// so every exponential is one exp2): sc [64 x 64] accumulators -> P, the
// rows' running max m and sum l updated, alpha the factor for O. MASK:
// bit 16 ii + 2 j + e of `vis` keeps score (row ii, key 8 j + 2 tig + e).
// FAST: the max is taken over the raw scores and the scale folded into one
// FMA a term, each exp2 is exp2_ftz (fewer instructions a score, where the
// softmax bounds the tile; A1 and H keep the form they were measured with).
template <bool MASK, bool FAST>
__device__ __forceinline__ void online_softmax(float (&sc)[32], uint32_t vis, float scale2,
                                               float (&m_r)[2], float (&l_r)[2],
                                               float (&alpha)[2]) {
  float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int ii = 0; ii < 2; ++ii)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int idx = 4 * j + 2 * ii + e;
        sc[idx] = !MASK || (vis >> (16 * ii + 2 * j + e)) & 1u
                      ? (FAST ? sc[idx] : sc[idx] * scale2)
                      : NEG_INF;
        mx[ii] = fmaxf(mx[ii], sc[idx]);
      }
  float psum[2] = {0.f, 0.f};
#pragma unroll
  for (int ii = 0; ii < 2; ++ii) {
    // the 4 lanes of a row group share the row
    mx[ii] = fmaxf(mx[ii], __shfl_xor_sync(0xffffffffu, mx[ii], 1));
    mx[ii] = fmaxf(mx[ii], __shfl_xor_sync(0xffffffffu, mx[ii], 2));
    const float m_new = fmaxf(m_r[ii], FAST ? mx[ii] * scale2 : mx[ii]);
    alpha[ii] = FAST ? exp2_ftz(m_r[ii] - m_new) : exp2f(m_r[ii] - m_new);
    m_r[ii] = m_new;
  }
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int ii = 0; ii < 2; ++ii)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int idx = 4 * j + 2 * ii + e;
        const float p = !MASK || (vis >> (16 * ii + 2 * j + e)) & 1u
                            ? (FAST ? exp2_ftz(fmaf(sc[idx], scale2, -m_r[ii]))
                                    : exp2f(sc[idx] - m_r[ii]))
                            : 0.f;
        sc[idx] = p;
        psum[ii] += p;
      }
#pragma unroll
  for (int ii = 0; ii < 2; ++ii) {
    psum[ii] += __shfl_xor_sync(0xffffffffu, psum[ii], 1);
    psum[ii] += __shfl_xor_sync(0xffffffffu, psum[ii], 2);
    l_r[ii] = l_r[ii] * alpha[ii] + psum[ii];
  }
}

// The policy's store(r, tig, acc, m, l) receives m in units of log2 (the
// running max of scale log2(e) S): the row's log-sum-exp is m ln 2 + ln l.
template <class Src>
__device__ __forceinline__ void fwd_mainloop(const Src& src, unsigned char* sm, float scale) {
  using L = FwTile<Src::D>;
  constexpr int CWG = Src::CWG;
  constexpr int STAGE = fw_stage<Src::D>();
  const float scale2 = scale * 1.4426950408889634f;  // log2(e)
  unsigned char* Qs = sm;
  unsigned char* stages = sm + CWG * L::BYTES;
  uint64_t* full = reinterpret_cast<uint64_t*>(stages + FW_STAGES * STAGE);
  uint64_t* empty = full + FW_STAGES;
  uint64_t* qbar = empty + FW_STAGES;
  const int n = src.count();

  if (threadIdx.x == 0) {
    for (int s = 0; s < FW_STAGES; ++s) {
      mbar_init(&full[s], 32);
      mbar_init(&empty[s], 128 * CWG);
    }
    mbar_init(qbar, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= 128 * CWG) {  // ------------------------------ producer warp
    const int lane = threadIdx.x & 31;
    if (lane == 0) src.load_q(Qs, qbar);
    for (int i = 0, it = 0; i < n; ++i) {
      if (src.skip(i)) continue;
      const int s = it % FW_STAGES;
      if (it >= FW_STAGES) mbar_wait(&empty[s], (it / FW_STAGES - 1) & 1);
      src.load(i, stages + s * STAGE, &full[s], lane);
      ++it;
    }
    return;
  }

  // ---------------------------------------------------------------- consumers
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int r_base = warp * 16 + gid;  // this thread's rows: r_base, r_base + 8
  // this warpgroup's query tile and its named barrier for the vote
  const unsigned char* Qw = CWG > 1 ? Qs + (warp >> 2) * L::BYTES : Qs;
  const int bar_id = CWG > 1 ? 1 + (warp >> 2) : 1;
  typename Src::Row row[2] = {src.row(r_base), src.row(r_base + 8)};
  float acc[L::ACC];
#pragma unroll
  for (int i = 0; i < L::ACC; ++i) acc[i] = 0.f;
  float m_r[2] = {NEG_INF, NEG_INF}, l_r[2] = {0.f, 0.f};
  mbar_wait(qbar, 0);

  for (int i = 0, it = 0; i < n; ++i) {
    if (src.skip(i)) continue;
    const int s = it % FW_STAGES;
    mbar_wait(&full[s], (it / FW_STAGES) & 1);
    ++it;
    const unsigned char* ks = stages + s * STAGE;

    // bit 16 ii + 2 j + e: row ii, key 8 j + 2 tig + e of the tile
    uint32_t vis = 0xffffffffu;
    if (!src.whole(i)) {  // block-uniform
      vis = 0u;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e)
#pragma unroll
          for (int ii = 0; ii < 2; ++ii)
            if (src.sees(i, ks, row[ii], 8 * j + 2 * tig + e)) vis |= 1u << (16 * ii + 2 * j + e);
      if (Src::VOTE && !wg_any(vis != 0u, bar_id)) {  // this warpgroup's rows
        mbar_arrive(&empty[s]);
        continue;
      }
    }

    float sc[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < L::KSTEPS; ++kk)
      wgmma_ss_n64<0>(sc, L::k_desc(Qw, kk), L::k_desc(ks, kk), kk > 0);
    wgmma_commit();
    wgmma_wait0();
    keep(sc);

    float alpha[2];
    // a warp whose 16 rows see the whole tile takes no per-element selects
    // (warp-uniform: the softmax shuffles between the lanes of a row)
    if (__all_sync(0xffffffffu, vis == 0xffffffffu))
      online_softmax<false, Src::FAST>(sc, vis, scale2, m_r, l_r, alpha);
    else
      online_softmax<true, Src::FAST>(sc, vis, scale2, m_r, l_r, alpha);
    // (FAST: a warp whose rows kept their max multiplies by 1: skipped)
    if (!Src::FAST || __any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
      for (int j = 0; j < L::ACC / 4; ++j) {
        acc[4 * j] *= alpha[0];
        acc[4 * j + 1] *= alpha[0];
        acc[4 * j + 2] *= alpha[1];
        acc[4 * j + 3] *= alpha[1];
      }
    }

    // O += P V, P in bf16 (the Pallas kernels' p.astype(v.dtype))
    uint32_t ap[4][4];
    to_a(ap, sc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) L::pv(acc, ap[kk], ks + L::BYTES, kk);
    wgmma_commit();
    wgmma_wait0();
    keep(ap);
    keep(acc);
    mbar_arrive(&empty[s]);
  }
  src.store(r_base, tig, acc, m_r, l_r);
}

}  // namespace ivl
