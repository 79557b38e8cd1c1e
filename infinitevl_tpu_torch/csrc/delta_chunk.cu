// Kernel C: the chunkwise gated delta rule forward with an initial state
// (DeltaNet prefill), q and k l2-normalized inside.
//
// Replaces infinitevl_tpu/ops/delta_pallas.py::delta_rule_chunk_fused
// (_delta_kernel). Per (batch, head), chunks of C = 64 tokens in sequence,
// with gcs the within-chunk cumulative sum of the log-decay g:
//   A    = beta_i <k_i, k_j> exp(gcs_i - gcs_j)     (j < i, strictly lower)
//   w, u = (I + A)^-1 [k beta e^gcs | v beta]
//   y    = u - w S
//   o    = (q e^gcs) S + tril(q k^T exp(gcs_i - gcs_j)) y
//   S'   = e^{gcs_C} S + (k e^{gcs_C - gcs})^T y
// o in v's dtype, the final state fp32.
//
// Packed rows (segment ids [B, T], optional), as the reference's chunk
// form (infinitevl_tpu/ops/delta_rule.py, _wyut_precompute and the chunk
// scan): everything is local to a chunk except one flag per chunk.
//   pass 1: g is 0 on a segment's first token; the decay ratio (so A and
//     q k^T) is masked to pairs of one segment; k beta e^gcs and q e^gcs
//     are 0 on rows outside the chunk's first segment (the incoming state
//     reaches that segment only), k e^{gcs_C - gcs} on rows outside its
//     last (only the last carries state out); e^{gcs_C} is 0 when the
//     chunk's first and last segments differ; `keep` is 0 when the chunk's
//     first token starts a segment (a boundary at the chunk edge).
//   pass 2: the state is multiplied by `keep` before the chunk.
// Rows past T continue the last segment. Without ids every mask is 1.
//
// The Pallas grid (B, H, N) runs its chunks in order on one core. Here
// the work is split where the math allows it: pass 1, one block per (b, h,
// chunk), does everything that needs no state and writes it to a scratch
// buffer; pass 2, one block per (b, h, value tile), walks the chunks in
// order with its columns of S. Rows past T in the last chunk are loaded as
// zeros with beta = g = 0, which makes them inert, so T needs no padding in
// device memory. Two bodies, by the input dtype:
//
// bf16 inputs: the JAX model path's precision (its delta_rule_chunk,
// infinitevl_tpu/ops/delta_rule.py, for bf16 models): bf16 operands and
// fp32 accumulation on the tensor cores (mma.sync m16n8k16, operands by
// ldmatrix from shared tiles whose rows are padded by 16 bytes, so the
// eight rows of an 8x8 matrix fall in distinct banks). Rounded to bf16, as
// there: l2norm(q), l2norm(k) and q scale; the right-hand sides k e^gcs
// beta and v beta; w, u, q e^gcs, the masked q k^T and k e^{gcs_C - gcs};
// the state where w S and q S read it (its fp32 copy is the accumulator
// across chunks); y; o. The plain twin of both passes, rounding point for
// rounding point, is ops/delta_kernels.delta_chunk_passes.
//   pass 1 (delta_chunk_prep_bf16_kernel, 8 warps, 96.8 KB of shared
//     memory: two blocks an SM): the chunk's q and k rows arrive by cp.async
//     and are normalized in place (one warp a row, fp32, rounded); k k^T and
//     q k^T on the tensor cores (the tiles above the diagonal skipped);
//     (I + A)^-1 formed explicitly in fp32 by forward substitution, one
//     column a thread (two warps, ~130 K FMAs with the zeros above each
//     column's diagonal, against 786 K to solve the 384 right-hand columns),
//     while the other six warps bring the chunk's v rows by cp.async; then w
//     and u as tensor-core products of the inverse rounded to bf16 (JAX's
//     mm(x, rhs) on its bf16 inverse), the blocks above the diagonal
//     skipped, staged in shared memory so the scratch is written 16 bytes a
//     store. The scratch is bf16, 90 KB a chunk and head at V 256 (the fp32
//     body's 180 KB), row-major.
//   pass 2 (delta_chunk_scan_bf16_kernel<BV>): per (b, h, BV value
//     columns), the fp32 slab [128, BV] lives in the registers of the
//     consumer warps as mma accumulators (warp w owns 16 rows); per chunk
//     its bf16 copy goes to shared memory and is the B operand of w S and
//     q S; y is rounded into shared memory and is the B operand of tril(q
//     k^T) y and k^T y; o is written from the registers. A producer warp
//     streams each chunk's operands by TMA into three stages (ScanTile).
//     The wrapper chooses BV (ops/delta_kernels.scan_v_tile): the widest
//     tile whose blocks still fill 3/4 of the SMs, 32 at B 1 and H 16 (128
//     blocks) and 64 at B 2.
//   Measured (NVIDIA H100 80GB HBM3, 700 W; chip_smoke.py phase 3 and
//   scripts/torch_delta_chunk_variants.py), device ms in a CUDA graph at
//   B 1, H 16, V 256 with a state: T 257 0.026 (pass 1 0.015, the scan
//   0.011), T 2,048 0.096 (0.048 and 0.049). What the design answers:
//   pass 1 first held every q, k, v row in registers, and ptxas spilled
//   halves of loaded values (a store that waits for its load), 19.7 us a
//   block; cp.async into shared memory took it to 15 us. The scan first
//   issued its own cp.async copies (3,840 a chunk) from the consumer warps,
//   which stalled them (3,900 cycles a chunk); one bulk copy a row from a
//   producer warp was slower still (320 small copies a chunk: 15,000
//   cycles waiting); eight 2-D boxes a chunk in the 128-byte swizzle (the
//   ldmatrix addresses follow it, swz) take 2,600 cycles a chunk. The
//   scan's V-tile sweep at T 2,048: BV 16 / 32 / 64 0.120 / 0.096 / 0.138
//   at B 1, 0.244 / 0.183 / 0.180 at B 2. The inverse by 16-row blocks with
//   all eight warps (FLA's solve_tril) measured slower than the two-warp
//   substitution (pass 1 0.018 against 0.015 ms at T 257: its seven
//   barriers and short loops). The output inside the scan (option (b)):
//   the scan without it (no q e^gcs or masked q k^T loaded, no products)
//   takes 0.031 ms at T 2,048 and 0.0073 at T 257 against 0.049 and 0.0106
//   with it, so a separate output pass (option (a), FLA's chunk_fwd_o)
//   would have to write and read again the per-chunk states and y (50 MB at
//   T 2,048, >= 0.015 ms at 3.35 TB/s) and move some 80 MB in its own pass
//   (>= 0.024 ms) to save 0.018: it was not built.
// There are no atomics: two calls on equal inputs are bit-equal.
//
// fp32 inputs: all arithmetic in fp32 on the FMA units (the body of the
// first port, kept number for number).
//   pass 1, one block per (b, h, chunk): q, k rows are normalized while
//     they are loaded (one warp per row) and kept transposed in shared
//     memory; k k^T and q k^T are 4x4 register tiles; (I + A)^-1 is never
//     formed: each thread owns one column of [k beta e^gcs | v beta] and
//     solves it by forward substitution against A in shared memory, 16 rows
//     at a time in registers. w, q e^gcs (both transposed), k e^{gcs_C -
//     gcs}, the masked q k^T (transposed), u and e^{gcs_C} go to an fp32
//     scratch buffer.
//   pass 2, one block per (b, h, 64 value columns): the [128, 64] fp32
//     slab of S stays in shared memory across all chunks; the three state
//     products of a chunk are 4x4 (8x4) register tiles; the operands
//     arrive by cp.async in two groups under the previous products.
//
//   Bound on the H100: at T = 2048, B = 1, H = 16 one call reads q, k, v and
//   writes o (54.8 MB in bf16) and does 8.3 GFLOP (per chunk and head the
//   strictly lower half of k k^T, the lower half of q k^T, the inverse and
//   w, u, w S and q S, the masked product and the state update). On the
//   bf16 tensor cores (989 TFLOP/s) that is 0.0084 ms of operations against
//   0.0164 ms of bytes: bytes bound it. In fp32 on the FMA units (67
//   TFLOP/s) the operations bound it: 0.124 ms.
#include "common.cuh"

namespace {

using ivl::ldsm_x2_trans;
using ivl::ldsm_x4;
using ivl::ldsm_x4_trans;
using ivl::mma_bf16;
using ivl::pack_bf16;
using ivl::smem_u32;

constexpr int CK = 128;     // key head dim the kernel is written for
constexpr int CC = 64;      // chunk length
constexpr int FBV = 64;     // value columns per block of the fp32 pass 2
constexpr int TSTR = 68;    // row stride of the transposed [CK][CC] tiles in
                            // the fp32 pass 1 (16-byte aligned rows, spread over banks)
constexpr int KC = CK * CC;  // elements of one [CK][CC] or [CC][CK] tile

constexpr int P1_THREADS = 384;
constexpr int SB = 16;  // rows per block of the forward substitution
constexpr int P1_SMEM_FLOATS = 2 * CK * TSTR + CC * CC + 6 * CC + CC * P1_THREADS;
constexpr int P2_THREADS = 256;
constexpr int P2_SMEM_FLOATS = 3 * KC + CC * CC + 2 * CC * FBV + CK * FBV;

// floats of fp32 scratch per (b, h, chunk): wT, qbT, kout, attnT, u, bend, keep
__host__ __device__ constexpr long long scratch_per_chunk(int V) {
  return 3LL * KC + CC * CC + (long long)CC * V + 2;
}

struct Scratch {
  float* wT;     // [NCH][CK][CC]  w transposed
  float* qbT;    // [NCH][CK][CC]  q scale e^gcs, transposed
  float* kout;   // [NCH][CC][CK]  k e^{gcs_C - gcs}
  float* attnT;  // [NCH][CC][CC]  attnT[j][i] = tril(q k^T ratio)[i][j]
  float* u;      // [NCH][CC][V]
  float* bend;   // [NCH]          e^{gcs_C}
  float* keep;   // [NCH]          0 where the chunk's first token starts a segment
};

__host__ Scratch carve(float* base, long long nch, int V) {
  Scratch s;
  s.wT = base;
  s.qbT = s.wT + nch * KC;
  s.kout = s.qbT + nch * KC;
  s.attnT = s.kout + nch * KC;
  s.u = s.attnT + nch * CC * CC;
  s.bend = s.u + nch * CC * V;
  s.keep = s.bend + nch;
  return s;
}

// ------------------------------------------------------------------ pass 1
__global__ void __launch_bounds__(P1_THREADS)
delta_chunk_prep_kernel(const float* __restrict__ q,         // [B, Tn, H, CK]
                        const float* __restrict__ k,
                        const float* __restrict__ v,         // [B, Tn, H, V]
                        const float* __restrict__ g,     // [B, Tn, H]
                        const float* __restrict__ beta,  // [B, Tn, H]
                        const int* __restrict__ seg,     // [B, Tn] or null
                        Scratch sc, int Tn, int H, int V, int N, float scale) {
  extern __shared__ __align__(16) float smem[];
  float* KT = smem;               // [CK][TSTR]  normalized k, transposed
  float* QT = KT + CK * TSTR;     // [CK][TSTR]  normalized q * scale, transposed
  float* AsT = QT + CK * TSTR;    // [CC][CC]    AsT[j][i] = A[i][j], j < i
  float* gcs = AsT + CC * CC;     // [CC]
  float* bet = gcs + CC;          // [CC]
  float* eg = bet + CC;           // [CC]        e^gcs
  float* fs = eg + CC;            // [CC]        1 in the chunk's first segment, else 0
  float* ls = fs + CC;            // [CC]        1 in the chunk's last segment, else 0
  int* sid = reinterpret_cast<int*>(ls + CC);  // [CC]  segment ids
  float* Wsm = ls + 2 * CC;       // [CC][P1_THREADS]  solved rows, a column a thread

  const long long ch = blockIdx.x;  // (b*H + h)*N + n
  const int n = (int)(ch % N);
  const int bh = (int)(ch / N);
  const int h = bh % H, b = bh / H;
  const int t0 = n * CC;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  if (warp == 0) {
    // segment ids of the chunk's rows (rows past Tn continue the last
    // segment) and of the token before it
    const int* segb = seg ? seg + (size_t)b * Tn : nullptr;
    const int ta = t0 + 2 * lane;
    int s0 = 0, s1 = 0, sp = 0;
    if (segb) {
      s0 = segb[min(ta, Tn - 1)];
      s1 = segb[min(ta + 1, Tn - 1)];
      sp = __shfl_up_sync(0xffffffffu, s1, 1);
      if (lane == 0) sp = t0 > 0 ? segb[t0 - 1] : s0;
    }
    // a token starts a segment iff its id differs from the token before
    const bool start0 = ta > 0 && ta < Tn && s0 != sp;
    const bool start1 = ta + 1 < Tn && s1 != s0;
    // inclusive scan of the chunk's 64 log-decays, two per lane
    float g0 = 0.f, g1 = 0.f, b0 = 0.f, b1 = 0.f;
    if (ta < Tn) {
      g0 = start0 ? 0.f : g[((size_t)b * Tn + ta) * H + h];
      b0 = beta[((size_t)b * Tn + ta) * H + h];
    }
    if (ta + 1 < Tn) {
      g1 = start1 ? 0.f : g[((size_t)b * Tn + ta + 1) * H + h];
      b1 = beta[((size_t)b * Tn + ta + 1) * H + h];
    }
    const int first = __shfl_sync(0xffffffffu, s0, 0);
    const int last = __shfl_sync(0xffffffffu, s1, 31);
    sid[2 * lane] = s0;
    sid[2 * lane + 1] = s1;
    fs[2 * lane] = s0 == first ? 1.f : 0.f;
    fs[2 * lane + 1] = s1 == first ? 1.f : 0.f;
    ls[2 * lane] = s0 == last ? 1.f : 0.f;
    ls[2 * lane + 1] = s1 == last ? 1.f : 0.f;
    if (lane == 0) sc.keep[ch] = start0 ? 0.f : 1.f;
    const float pair = g0 + g1;
    float run = pair;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float up = __shfl_up_sync(0xffffffffu, run, off);
      if (lane >= off) run += up;
    }
    const float before = run - pair;
    gcs[2 * lane] = before + g0;
    gcs[2 * lane + 1] = before + pair;
    eg[2 * lane] = expf(before + g0);
    eg[2 * lane + 1] = expf(before + pair);
    bet[2 * lane] = b0;
    bet[2 * lane + 1] = b1;
  }

  // q, k rows: one warp per row, lane l holds dims l + 32 e
  for (int r = warp; r < CC; r += P1_THREADS / 32) {
    const int t = t0 + r;
    float qv[4] = {0.f, 0.f, 0.f, 0.f}, kv[4] = {0.f, 0.f, 0.f, 0.f};
    if (t < Tn) {
      const size_t off = (((size_t)b * Tn + t) * H + h) * CK + lane;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        qv[e] = q[off + 32 * e];
        kv[e] = k[off + 32 * e];
      }
    }
    float qs = 0.f, ks = 0.f;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      qs += qv[e] * qv[e];
      ks += kv[e] * kv[e];
    }
    const float qn = rsqrtf(ivl::warp_sum(qs) + 1e-6f) * scale;
    const float kn = rsqrtf(ivl::warp_sum(ks) + 1e-6f);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      QT[(lane + 32 * e) * TSTR + r] = qv[e] * qn;
      KT[(lane + 32 * e) * TSTR + r] = kv[e] * kn;
    }
  }
  __syncthreads();

  // k k^T and q k^T: thread (ty, tx) owns rows 4ty.., cols 4tx..; tiles
  // above the diagonal are zero and skip the products
  if (tid < 256) {
    const int ty = tid >> 4, tx = tid & 15;
    float akk[4][4], aqk[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) akk[a][c] = aqk[a][c] = 0.f;
    if (tx <= ty) {
#pragma unroll 4
      for (int d = 0; d < CK; ++d) {
        const float4 ki4 = *reinterpret_cast<const float4*>(&KT[d * TSTR + 4 * ty]);
        const float4 qi4 = *reinterpret_cast<const float4*>(&QT[d * TSTR + 4 * ty]);
        const float4 kj4 = *reinterpret_cast<const float4*>(&KT[d * TSTR + 4 * tx]);
        const float ki[4] = {ki4.x, ki4.y, ki4.z, ki4.w};
        const float qi[4] = {qi4.x, qi4.y, qi4.z, qi4.w};
        const float kj[4] = {kj4.x, kj4.y, kj4.z, kj4.w};
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            akk[a][c] += ki[a] * kj[c];
            aqk[a][c] += qi[a] * kj[c];
          }
      }
    }
    float* at = sc.attnT + ch * (CC * CC);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int j = 4 * tx + c;
      float col[4], acol[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int i = 4 * ty + a;
        // the clamp keeps the masked upper triangle from overflowing; pairs
        // of two segments do not interact
        const float ratio =
            j <= i && sid[i] == sid[j] ? expf(fminf(gcs[i] - gcs[j], 0.f)) : 0.f;
        acol[a] = j < i ? akk[a][c] * ratio * bet[i] : 0.f;
        col[a] = aqk[a][c] * ratio;
      }
      *reinterpret_cast<float4*>(&AsT[j * CC + 4 * ty]) =
          make_float4(acol[0], acol[1], acol[2], acol[3]);
      *reinterpret_cast<float4*>(&at[j * CC + 4 * ty]) =
          make_float4(col[0], col[1], col[2], col[3]);
    }
  }
  __syncthreads();

  // forward substitution (I + A) W = [k beta e^gcs | v beta], one column a
  // thread: SB rows at a time in registers, finished rows in Wsm
  for (int c = tid; c < CK + V; c += P1_THREADS) {
    float* wcol = Wsm + tid;
    for (int r0 = 0; r0 < CC; r0 += SB) {
      float acc[SB];
      if (c < CK) {
#pragma unroll
        for (int r = 0; r < SB; ++r)
          acc[r] = KT[c * TSTR + r0 + r] * eg[r0 + r] * fs[r0 + r] * bet[r0 + r];
      } else {
#pragma unroll
        for (int r = 0; r < SB; ++r) {
          const int t = t0 + r0 + r;
          acc[r] = t < Tn ? v[(((size_t)b * Tn + t) * H + h) * V + (c - CK)] * bet[r0 + r]
                          : 0.f;
        }
      }
      // rows solved in earlier blocks
#pragma unroll 2
      for (int j = 0; j < r0; ++j) {
        const float wj = wcol[j * P1_THREADS];
        const float4* arow = reinterpret_cast<const float4*>(&AsT[j * CC + r0]);
#pragma unroll
        for (int r4 = 0; r4 < SB / 4; ++r4) {
          const float4 a4 = arow[r4];
          acc[4 * r4] -= a4.x * wj;
          acc[4 * r4 + 1] -= a4.y * wj;
          acc[4 * r4 + 2] -= a4.z * wj;
          acc[4 * r4 + 3] -= a4.w * wj;
        }
      }
      // the block's own triangle
#pragma unroll
      for (int j = 0; j < SB - 1; ++j) {
        const float4* arow = reinterpret_cast<const float4*>(&AsT[(r0 + j) * CC + r0]);
#pragma unroll
        for (int r4 = (j + 1) / 4; r4 < SB / 4; ++r4) {
          const float4 a4 = arow[r4];
          const float a[4] = {a4.x, a4.y, a4.z, a4.w};
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (4 * r4 + e > j) acc[4 * r4 + e] -= a[e] * acc[j];
        }
      }
#pragma unroll
      for (int r = 0; r < SB; ++r) wcol[(r0 + r) * P1_THREADS] = acc[r];
      if (c >= CK) {
        float* dst = sc.u + ch * ((long long)CC * V) + (size_t)r0 * V + (c - CK);
#pragma unroll
        for (int r = 0; r < SB; ++r) dst[(size_t)r * V] = acc[r];
      } else {
        float* dst = sc.wT + ch * KC + c * CC + r0;
#pragma unroll
        for (int r = 0; r < SB; r += 4)
          *reinterpret_cast<float4*>(&dst[r]) =
              make_float4(acc[r], acc[r + 1], acc[r + 2], acc[r + 3]);
      }
    }
  }

  float* qb = sc.qbT + ch * KC;
  for (int idx = tid; idx < KC; idx += P1_THREADS) {
    const int d = idx / CC, r = idx % CC;
    qb[idx] = QT[d * TSTR + r] * eg[r] * fs[r];
  }
  const float glast = gcs[CC - 1];
  float* ko = sc.kout + ch * KC;
  for (int idx = tid; idx < KC; idx += P1_THREADS) {
    const int r = idx / CK, d = idx % CK;
    ko[idx] = KT[d * TSTR + r] * expf(glast - gcs[r]) * ls[r];
  }
  if (tid == 0) sc.bend[ch] = sid[0] == sid[CC - 1] ? expf(glast) : 0.f;
}

// ------------------------------------------------------------------ pass 2
__device__ __forceinline__ void store4(float* p, const float x[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
}

__device__ __forceinline__ void cp_async16(void* smem_dst, const void* src) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem_dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>  // wait until at most N of this thread's groups are pending
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// contiguous copy of n_floats (a multiple of 4, 16-byte aligned both sides)
__device__ __forceinline__ void copy_async(float* dst, const float* __restrict__ src,
                                           int n_floats, int tid) {
  for (int i = 4 * tid; i < n_floats; i += 4 * P2_THREADS) cp_async16(dst + i, src + i);
}

__global__ void __launch_bounds__(P2_THREADS)
delta_chunk_scan_kernel(Scratch sc,
                        const float* h0,     // [B, H, CK, V] or null; may be hT
                        float* __restrict__ o,  // [B, Tn, H, V]
                        float* hT,           // [B, H, CK, V]
                        int Tn, int H, int V, int N) {
  extern __shared__ __align__(16) float smem[];
  float* Ws = smem;          // [CK][CC]  w transposed
  float* Qs = Ws + KC;       // [CK][CC]  q e^gcs transposed
  float* Ko = Qs + KC;       // [CC][CK]  k e^{gcs_C - gcs}
  float* At = Ko + KC;       // [CC][CC]  attn transposed
  float* Yb = At + CC * CC;  // 2 x [CC][FBV]  u, then y; chunks alternate
  float* Ss = Yb + 2 * CC * FBV;  // [CK][FBV]  the state slab

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int v0 = blockIdx.y * FBV;
  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;

  // group A of a chunk: w, q e^gcs (transposed) and this block's columns of u
  auto load_a = [&](int n) {
    const long long ch = (long long)bh * N + n;
    copy_async(Ws, sc.wT + ch * KC, KC, tid);
    copy_async(Qs, sc.qbT + ch * KC, KC, tid);
    const float* usrc = sc.u + ch * ((long long)CC * V) + v0;
    float* ydst = Yb + (n & 1) * (CC * FBV);
    for (int idx = tid; idx < CC * (FBV / 4); idx += P2_THREADS) {
      const int r = idx / (FBV / 4), c4 = idx % (FBV / 4);
      cp_async16(ydst + 4 * idx, usrc + (size_t)r * V + 4 * c4);
    }
    cp_async_commit();
  };
  load_a(0);

  for (int idx = tid; idx < CK * (FBV / 4); idx += P2_THREADS) {
    const int kk = idx / (FBV / 4), c4 = idx % (FBV / 4);
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (h0 != nullptr)
      val = *reinterpret_cast<const float4*>(&h0[((size_t)bh * CK + kk) * V + v0 + 4 * c4]);
    reinterpret_cast<float4*>(Ss)[idx] = val;
  }

  for (int n = 0; n < N; ++n) {
    const long long ch = (long long)bh * N + n;
    float* Ys = Yb + (n & 1) * (CC * FBV);
    // group B: the operands of the masked product and of the state update;
    // their buffers were released by the barrier that ended the last chunk
    copy_async(Ko, sc.kout + ch * KC, KC, tid);
    copy_async(At, sc.attnT + ch * (CC * CC), CC * CC, tid);
    cp_async_commit();
    const float be = sc.bend[ch];
    if (sc.keep[ch] == 0.f) {  // a segment starts at the chunk's edge: no state enters
      // (block-uniform; this thread's own elements of S, behind the barrier
      // that ended the last chunk)
#pragma unroll
      for (int e = 0; e < 8; ++e)
        *reinterpret_cast<float4*>(&Ss[(8 * ty + e) * FBV + 4 * tx]) =
            make_float4(0.f, 0.f, 0.f, 0.f);
    }
    cp_async_wait<1>();  // group A of this chunk has landed
    __syncthreads();     // ... for every thread; S is whole

    // w S and (q e^gcs) S: rows 4ty.., cols 4tx..
    float ay[4][4], ao[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) ay[a][c] = ao[a][c] = 0.f;
#pragma unroll 4
    for (int kk = 0; kk < CK; ++kk) {
      const float4 w4 = *reinterpret_cast<const float4*>(&Ws[kk * CC + 4 * ty]);
      const float4 q4 = *reinterpret_cast<const float4*>(&Qs[kk * CC + 4 * ty]);
      const float4 s4 = *reinterpret_cast<const float4*>(&Ss[kk * FBV + 4 * tx]);
      const float w[4] = {w4.x, w4.y, w4.z, w4.w};
      const float qq[4] = {q4.x, q4.y, q4.z, q4.w};
      const float s[4] = {s4.x, s4.y, s4.z, s4.w};
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          ay[a][c] += w[a] * s[c];
          ao[a][c] += qq[a] * s[c];
        }
    }
    // y = u - w S, in place over this thread's own elements of u
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      float* yrow = &Ys[(4 * ty + a) * FBV + 4 * tx];
      const float4 u4 = *reinterpret_cast<const float4*>(yrow);
      *reinterpret_cast<float4*>(yrow) = make_float4(
          u4.x - ay[a][0], u4.y - ay[a][1], u4.z - ay[a][2], u4.w - ay[a][3]);
    }
    cp_async_wait<0>();  // group B has landed
    __syncthreads();     // y is whole; w and q e^gcs are no longer read
    if (n + 1 < N) load_a(n + 1);

    // o += tril(q k^T ratio) y: keys j <= this thread's last row
    for (int j = 0; j <= 4 * ty + 3; ++j) {
      const float4 a4 = *reinterpret_cast<const float4*>(&At[j * CC + 4 * ty]);
      const float4 y4 = *reinterpret_cast<const float4*>(&Ys[j * FBV + 4 * tx]);
      const float aa[4] = {a4.x, a4.y, a4.z, a4.w};
      const float y[4] = {y4.x, y4.y, y4.z, y4.w};
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) ao[a][c] += aa[a] * y[c];
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int t = n * CC + 4 * ty + a;
      if (t < Tn) store4(&o[(((size_t)b * Tn + t) * H + h) * V + v0 + 4 * tx], ao[a]);
    }

    // S' = e^{gcs_C} S + (k e^{gcs_C - gcs})^T y: rows 8ty.., cols 4tx..
    float as[8][4];
#pragma unroll
    for (int e = 0; e < 8; ++e)
#pragma unroll
      for (int c = 0; c < 4; ++c) as[e][c] = 0.f;
#pragma unroll 4
    for (int j = 0; j < CC; ++j) {
      const float4 k0 = *reinterpret_cast<const float4*>(&Ko[j * CK + 8 * ty]);
      const float4 k1 = *reinterpret_cast<const float4*>(&Ko[j * CK + 8 * ty + 4]);
      const float4 y4 = *reinterpret_cast<const float4*>(&Ys[j * FBV + 4 * tx]);
      const float kk[8] = {k0.x, k0.y, k0.z, k0.w, k1.x, k1.y, k1.z, k1.w};
      const float y[4] = {y4.x, y4.y, y4.z, y4.w};
#pragma unroll
      for (int e = 0; e < 8; ++e)
#pragma unroll
        for (int c = 0; c < 4; ++c) as[e][c] += kk[e] * y[c];
    }
    // every read of S by w S / q S is behind the barrier above
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      float* srow = &Ss[(8 * ty + e) * FBV + 4 * tx];
      const float4 s4 = *reinterpret_cast<const float4*>(srow);
      *reinterpret_cast<float4*>(srow) =
          make_float4(be * s4.x + as[e][0], be * s4.y + as[e][1],
                      be * s4.z + as[e][2], be * s4.w + as[e][3]);
    }
    __syncthreads();  // this chunk's readers are done; S is whole
  }

  for (int idx = tid; idx < CK * (FBV / 4); idx += P2_THREADS) {
    const int kk = idx / (FBV / 4), c4 = idx % (FBV / 4);
    *reinterpret_cast<float4*>(&hT[((size_t)bh * CK + kk) * V + v0 + 4 * c4]) =
        reinterpret_cast<const float4*>(Ss)[idx];
  }
}


// ============================================================ bf16 body
using bf16 = __nv_bfloat16;

constexpr int B_THREADS = 256;  // both bf16 passes: eight warps
constexpr int KS = CK + 8;      // bf16 row stride of a [CC][CK] tile in shared memory
constexpr int XS = CC + 8;      // bf16 row stride of a [CC][CC] tile
constexpr int AST = CC + 4;     // fp32 row stride of the transposed A

// bytes of bf16 scratch per (b, h, chunk): w, q e^gcs, k e^{gcs_C - gcs}
// ([CC][CK] each), the masked q k^T [CC][CC], u [CC][V], then e^{gcs_C}
// and keep (fp32)
__host__ __device__ constexpr long long scratch_bytes_bf16(int V) {
  return 2LL * (3LL * KC + CC * CC + (long long)CC * V) + 8;
}

struct ScratchB {
  bf16* w;      // [NCH][CC][CK]
  bf16* qb;     // [NCH][CC][CK]  q scale e^gcs
  bf16* kout;   // [NCH][CC][CK]  k e^{gcs_C - gcs}
  bf16* attn;   // [NCH][CC][CC]  tril(q k^T ratio)
  bf16* u;      // [NCH][CC][V]
  float* bend;  // [NCH]          e^{gcs_C}
  float* keep;  // [NCH]          0 where the chunk's first token starts a segment
};

__host__ ScratchB carve_bf16(void* base, long long nch, int V) {
  ScratchB s;
  s.w = static_cast<bf16*>(base);
  s.qb = s.w + nch * KC;
  s.kout = s.qb + nch * KC;
  s.attn = s.kout + nch * KC;
  s.u = s.attn + nch * CC * CC;
  s.bend = reinterpret_cast<float*>(s.u + nch * CC * V);
  s.keep = s.bend + nch;
  return s;
}

__device__ __forceinline__ float2 unpack_bf16(uint32_t x) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&x));
}
__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}
// a pair of bf16 values times f, rounded to bf16
__device__ __forceinline__ uint32_t scale_pair(uint32_t x, float f) {
  const float2 a = unpack_bf16(x);
  return pack_bf16(a.x * f, a.y * f);
}

constexpr int VMAX_BF16 = 256;  // the bf16 body's largest value dim

// pass 1's shared memory: Kn and Qs (raw q, k, normalized in place; then v,
// scaled in place, over both), Rk, Xb, AsT and Xs (then w and u on their way
// out), the per-row scalars: 96.8 KB, two blocks an SM
__host__ __device__ constexpr int prep_bf16_smem() {
  return 2 * (3 * CC * KS + CC * XS) + 4 * (CC * AST + CC * CC + 5 * CC) + 4 * CC;
}

// rows [0, CC) of a chunk into shared memory rows of `stride` elements by
// cp.async (threads [t_lo, t_hi) of the block), `width` bf16 a row; rows
// past Tn are zeroed
__device__ __forceinline__ void rows_async(bf16* dst, int stride, const bf16* src,
                                           size_t src_stride, int width, int rows_valid,
                                           int t, int t_lo, int t_hi) {
  const int per_row = width / 8;
  for (int i = t - t_lo; i < CC * per_row; i += t_hi - t_lo) {
    const int r = i / per_row, c = (i % per_row) * 8;
    if (r < rows_valid)
      cp_async16(dst + r * stride + c, src + r * src_stride + c);
    else
      *reinterpret_cast<uint4*>(dst + r * stride + c) = make_uint4(0u, 0u, 0u, 0u);
  }
}

// a [CC][ncols] bf16 tile from shared memory (row stride `stride`) to
// global memory (row stride `gstride`), 16 bytes a store
__device__ __forceinline__ void tile_out(bf16* dst, size_t gstride, const bf16* src, int stride,
                                         int ncols, int t) {
  const int per_row = ncols / 8;
  for (int i = t; i < CC * per_row; i += B_THREADS) {
    const int r = i / per_row, c = (i % per_row) * 8;
    *reinterpret_cast<uint4*>(dst + r * gstride + c) =
        *reinterpret_cast<const uint4*>(src + r * stride + c);
  }
}

// ------------------------------------------------------------ bf16 pass 1
__global__ void __launch_bounds__(B_THREADS, 2)
delta_chunk_prep_bf16_kernel(const bf16* __restrict__ q,       // [B, Tn, H, CK]
                             const bf16* __restrict__ k,
                             const bf16* __restrict__ v,       // [B, Tn, H, V]
                             const float* __restrict__ g,      // [B, Tn, H]
                             const float* __restrict__ beta,   // [B, Tn, H]
                             const int* __restrict__ seg,      // [B, Tn] or null
                             ScratchB sc, int Tn, int H, int V, int N, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Kn = reinterpret_cast<bf16*>(smem_raw);  // [CC][KS]  k, then l2norm(k)
  bf16* Qs = Kn + CC * KS;                       // [CC][KS]  q, then l2norm(q) scale
  bf16* Rv = Kn;                                 // [CC][V + 8]  v, then v beta
  bf16* Rk = Qs + CC * KS;                       // [CC][KS]  k e^gcs beta (first segment)
  bf16* Xb = Rk + CC * KS;                       // [CC][XS]  (I + A)^-1, rounded
  float* AsT = reinterpret_cast<float*>(Xb + CC * XS);  // [CC][AST]  AsT[j][i] = A[i][j]
  float* Xs = AsT + CC * AST;    // [CC][CC]  (I + A)^-1 in fp32
  bf16* Out = reinterpret_cast<bf16*>(AsT);  // [CC][KS] w, then [CC][V + 8] u, over AsT, Xs
  float* gcs = Xs + CC * CC;     // [CC]
  float* bet = gcs + CC;         // [CC]
  float* eg = bet + CC;          // [CC]  e^gcs
  float* fs = eg + CC;           // [CC]  1 in the chunk's first segment, else 0
  float* ls = fs + CC;           // [CC]  1 in the chunk's last segment, else 0
  int* sid = reinterpret_cast<int*>(ls + CC);  // [CC]  segment ids

  const long long ch = blockIdx.x;  // (b*H + h)*N + n
  const int n = (int)(ch % N);
  const int bh = (int)(ch / N);
  const int h = bh % H, b = bh / H;
  const int t0 = n * CC;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int valid = min(CC, Tn - t0);  // rows of the chunk inside T
  const size_t row0 = ((size_t)b * Tn + t0) * H + h;  // the chunk's first row of [B, Tn, H]

  // the chunk's q and k rows into Qs and Kn, asynchronously
  rows_async(Qs, KS, q + row0 * CK, (size_t)H * CK, CK, valid, tid, 0, B_THREADS);
  rows_async(Kn, KS, k + row0 * CK, (size_t)H * CK, CK, valid, tid, 0, B_THREADS);
  cp_async_commit();

  if (warp == 0) {
    // segment ids of the chunk's rows (rows past Tn continue the last
    // segment) and of the token before it
    const int* segb = seg ? seg + (size_t)b * Tn : nullptr;
    const int ta = t0 + 2 * lane;
    int s0 = 0, s1 = 0, sp = 0;
    if (segb) {
      s0 = segb[min(ta, Tn - 1)];
      s1 = segb[min(ta + 1, Tn - 1)];
      sp = __shfl_up_sync(0xffffffffu, s1, 1);
      if (lane == 0) sp = t0 > 0 ? segb[t0 - 1] : s0;
    }
    // a token starts a segment iff its id differs from the token before
    const bool start0 = ta > 0 && ta < Tn && s0 != sp;
    const bool start1 = ta + 1 < Tn && s1 != s0;
    // inclusive scan of the chunk's 64 log-decays, two per lane
    float g0 = 0.f, g1 = 0.f, b0 = 0.f, b1 = 0.f;
    if (ta < Tn) {
      g0 = start0 ? 0.f : g[((size_t)b * Tn + ta) * H + h];
      b0 = beta[((size_t)b * Tn + ta) * H + h];
    }
    if (ta + 1 < Tn) {
      g1 = start1 ? 0.f : g[((size_t)b * Tn + ta + 1) * H + h];
      b1 = beta[((size_t)b * Tn + ta + 1) * H + h];
    }
    const int first = __shfl_sync(0xffffffffu, s0, 0);
    const int last = __shfl_sync(0xffffffffu, s1, 31);
    sid[2 * lane] = s0;
    sid[2 * lane + 1] = s1;
    fs[2 * lane] = s0 == first ? 1.f : 0.f;
    fs[2 * lane + 1] = s1 == first ? 1.f : 0.f;
    ls[2 * lane] = s0 == last ? 1.f : 0.f;
    ls[2 * lane + 1] = s1 == last ? 1.f : 0.f;
    if (lane == 0) sc.keep[ch] = start0 ? 0.f : 1.f;
    const float pair = g0 + g1;
    float run = pair;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float up = __shfl_up_sync(0xffffffffu, run, off);
      if (lane >= off) run += up;
    }
    const float before = run - pair;
    gcs[2 * lane] = before + g0;
    gcs[2 * lane + 1] = before + pair;
    eg[2 * lane] = expf(before + g0);
    eg[2 * lane + 1] = expf(before + pair);
    bet[2 * lane] = b0;
    bet[2 * lane + 1] = b1;
  }
  cp_async_wait<0>();
  __syncthreads();

  // l2norm of the q and k rows in fp32, in place, rounded to bf16 (JAX's
  // l2norm returns the input dtype), q then scaled and rounded again: one
  // warp a row, lane l holding dims 4l..4l+3
  for (int r = warp; r < CC; r += B_THREADS / 32) {
    uint2* qp = reinterpret_cast<uint2*>(Qs + r * KS + 4 * lane);
    uint2* kp = reinterpret_cast<uint2*>(Kn + r * KS + 4 * lane);
    const uint2 qr = *qp, kr = *kp;
    const float2 q01 = unpack_bf16(qr.x), q23 = unpack_bf16(qr.y);
    const float2 k01 = unpack_bf16(kr.x), k23 = unpack_bf16(kr.y);
    const float qv[4] = {q01.x, q01.y, q23.x, q23.y};
    const float kv[4] = {k01.x, k01.y, k23.x, k23.y};
    float qss = 0.f, kss = 0.f;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      qss += qv[e] * qv[e];
      kss += kv[e] * kv[e];
    }
    const float rq = rsqrtf(ivl::warp_sum(qss) + 1e-6f);
    const float rk = rsqrtf(ivl::warp_sum(kss) + 1e-6f);
    float qn[4], kn[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      qn[e] = round_bf16(qv[e] * rq) * scale;
      kn[e] = kv[e] * rk;
    }
    *qp = make_uint2(pack_bf16(qn[0], qn[1]), pack_bf16(qn[2], qn[3]));
    *kp = make_uint2(pack_bf16(kn[0], kn[1]), pack_bf16(kn[2], kn[3]));
  }
  __syncthreads();

  // k e^gcs beta (0 outside the first segment), rounded: the right-hand
  // side of w; q e^gcs (0 outside the first segment) and k e^{gcs_C - gcs}
  // (0 outside the last), rounded, to the scratch: 16 bytes each
  const float glast = gcs[CC - 1];
  bf16* qbg = sc.qb + ch * KC;
  bf16* kog = sc.kout + ch * KC;
  for (int idx = tid; idx < CC * (CK / 8); idx += B_THREADS) {
    const int j = idx / (CK / 8), d = (idx % (CK / 8)) * 8;
    const uint4 kx = *reinterpret_cast<const uint4*>(Kn + j * KS + d);
    const uint4 qx = *reinterpret_cast<const uint4*>(Qs + j * KS + d);
    const float fk = fs[j] != 0.f ? eg[j] : 0.f;
    const float bj = bet[j];
    uint4 rk;  // (k e^gcs) beta, in this order as JAX computes it
    const uint32_t* kw = &kx.x;
    uint32_t* rw = &rk.x;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 a = unpack_bf16(kw[e]);
      rw[e] = pack_bf16(a.x * fk * bj, a.y * fk * bj);
    }
    *reinterpret_cast<uint4*>(Rk + j * KS + d) = rk;
    const float fq = fs[j] != 0.f ? eg[j] : 0.f;
    const float fo = ls[j] != 0.f ? expf(glast - gcs[j]) : 0.f;
    *reinterpret_cast<uint4*>(qbg + j * CK + d) = make_uint4(
        scale_pair(qx.x, fq), scale_pair(qx.y, fq), scale_pair(qx.z, fq), scale_pair(qx.w, fq));
    *reinterpret_cast<uint4*>(kog + j * CK + d) = make_uint4(
        scale_pair(kx.x, fo), scale_pair(kx.y, fo), scale_pair(kx.z, fo), scale_pair(kx.w, fo));
  }
  if (tid == 0) sc.bend[ch] = sid[0] == sid[CC - 1] ? expf(glast) : 0.f;

  // k k^T and q k^T on the tensor cores: warp (mt, nh) owns rows
  // 16mt..16mt+15 and columns 32nh..32nh+31; a warp wholly above the
  // diagonal has nothing to do (A and the masked q k^T are zero there, and
  // neither the substitution nor the scan reads those blocks)
  {
    const int mt = warp & 3, nh = warp >> 2;
    if (32 * nh <= 16 * mt + 15) {
      float akk[4][4], aqk[4][4];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) akk[a][c] = aqk[a][c] = 0.f;
      const int arow = 16 * mt + (lane & 7) + ((lane >> 3) & 1) * 8;
      const int brow = 32 * nh + (lane & 7) + (lane >> 4) * 8;
#pragma unroll
      for (int ks = 0; ks < CK / 16; ++ks) {
        uint32_t fk[4], fq[4];
        ldsm_x4(fk, smem_u32(Kn + arow * KS + 16 * ks + (lane >> 4) * 8));
        ldsm_x4(fq, smem_u32(Qs + arow * KS + 16 * ks + (lane >> 4) * 8));
#pragma unroll
        for (int p = 0; p < 2; ++p) {
          uint32_t fb[4];  // B[d][j] = k_j[d]: rows of Kn, not transposed
          ldsm_x4(fb, smem_u32(Kn + (brow + 16 * p) * KS + 16 * ks + ((lane >> 3) & 1) * 8));
          mma_bf16(akk[2 * p], fk, fb[0], fb[1]);
          mma_bf16(akk[2 * p + 1], fk, fb[2], fb[3]);
          mma_bf16(aqk[2 * p], fq, fb[0], fb[1]);
          mma_bf16(aqk[2 * p + 1], fq, fb[2], fb[3]);
        }
      }
      bf16* at = sc.attn + ch * (CC * CC);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int i = 16 * mt + gid + 8 * hf;
          const int j0 = 32 * nh + 8 * nt + 2 * tig;
          float av[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int j = j0 + e;
            // the clamp keeps the masked upper triangle from overflowing;
            // pairs of two segments do not interact
            const float ratio =
                j <= i && sid[i] == sid[j] ? expf(fminf(gcs[i] - gcs[j], 0.f)) : 0.f;
            AsT[j * AST + i] = j < i ? akk[nt][2 * hf + e] * ratio * bet[i] : 0.f;
            av[e] = aqk[nt][2 * hf + e] * ratio;
          }
          *reinterpret_cast<uint32_t*>(at + i * CC + j0) = pack_bf16(av[0], av[1]);
        }
    }
  }
  __syncthreads();

  if (tid < CC) {
    // (I + A)^-1 by forward substitution, column c a thread: SB rows at a
    // time in registers, finished rows in Xs (the thread's own column)
    const int c = tid;
    for (int r0 = 0; r0 < CC; r0 += SB) {
      float acc[SB];
#pragma unroll
      for (int r = 0; r < SB; ++r) acc[r] = r0 + r == c ? 1.f : 0.f;
#pragma unroll 2
      for (int j = 0; j < r0; ++j) {
        const float xj = Xs[j * CC + c];
        const float4* arow = reinterpret_cast<const float4*>(&AsT[j * AST + r0]);
#pragma unroll
        for (int r4 = 0; r4 < SB / 4; ++r4) {
          const float4 a4 = arow[r4];
          acc[4 * r4] -= a4.x * xj;
          acc[4 * r4 + 1] -= a4.y * xj;
          acc[4 * r4 + 2] -= a4.z * xj;
          acc[4 * r4 + 3] -= a4.w * xj;
        }
      }
#pragma unroll
      for (int j = 0; j < SB - 1; ++j) {
        const float4* arow = reinterpret_cast<const float4*>(&AsT[(r0 + j) * AST + r0]);
#pragma unroll
        for (int r4 = (j + 1) / 4; r4 < SB / 4; ++r4) {
          const float4 a4 = arow[r4];
          const float a[4] = {a4.x, a4.y, a4.z, a4.w};
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (4 * r4 + e > j) acc[4 * r4 + e] -= a[e] * acc[j];
        }
      }
#pragma unroll
      for (int r = 0; r < SB; ++r) {
        Xs[(r0 + r) * CC + c] = acc[r];
        Xb[(r0 + r) * XS + c] = __float2bfloat16(acc[r]);
      }
    }
  } else {
    // meanwhile the other six warps bring the chunk's v rows over Kn and Qs
    rows_async(Rv, V + 8, v + row0 * V, (size_t)H * V, V, valid, tid, CC, B_THREADS);
    cp_async_commit();
    cp_async_wait<0>();
  }
  __syncthreads();

  // v beta, rounded, in place: the right-hand side of u
  for (int idx = tid; idx < CC * (V / 8); idx += B_THREADS) {
    const int j = idx / (V / 8), c = (idx % (V / 8)) * 8;
    uint4* p = reinterpret_cast<uint4*>(Rv + j * (V + 8) + c);
    const uint4 x = *p;
    const float bj = bet[j];
    *p = make_uint4(scale_pair(x.x, bj), scale_pair(x.y, bj), scale_pair(x.z, bj),
                    scale_pair(x.w, bj));
  }
  __syncthreads();

  // [w | u] = X [k e^gcs beta | v beta] on the tensor cores, X rounded, in
  // two rounds (w, then u) through Out, so the scratch is written 16 bytes a
  // store: warp (mt, nh) owns rows 16mt.. and every other group of 64
  // columns; X is lower triangular, so its k-steps stop at the diagonal block
  {
    const int mt = warp & 3, nh = warp >> 2;
    const int arow = 16 * mt + (lane & 7) + ((lane >> 3) & 1) * 8;
    const int brow = (lane & 7) + ((lane >> 3) & 1) * 8;
    for (int round = 0; round < 2; ++round) {
      const bool is_w = round == 0;
      const bf16* R = is_w ? Rk : Rv;
      const int rs = is_w ? KS : V + 8;
      const int ncols = is_w ? CK : V;
      for (int c0 = 64 * nh; c0 < ncols; c0 += 128) {
        float acc[8][4];
#pragma unroll
        for (int a = 0; a < 8; ++a)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[a][c] = 0.f;
        for (int ks = 0; ks <= mt; ++ks) {
          uint32_t fa[4];
          ldsm_x4(fa, smem_u32(Xb + arow * XS + 16 * ks + (lane >> 4) * 8));
#pragma unroll
          for (int p = 0; p < 4; ++p) {
            uint32_t fb[4];
            ldsm_x4_trans(fb, smem_u32(R + (16 * ks + brow) * rs + c0 + 16 * p +
                                       (lane >> 4) * 8));
            mma_bf16(acc[2 * p], fa, fb[0], fb[1]);
            mma_bf16(acc[2 * p + 1], fa, fb[2], fb[3]);
          }
        }
        const int r0 = 16 * mt + gid;
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          const int col = c0 + 8 * nt + 2 * tig;
          *reinterpret_cast<uint32_t*>(Out + r0 * rs + col) = pack_bf16(acc[nt][0], acc[nt][1]);
          *reinterpret_cast<uint32_t*>(Out + (r0 + 8) * rs + col) =
              pack_bf16(acc[nt][2], acc[nt][3]);
        }
      }
      __syncthreads();
      if (is_w)
        tile_out(sc.w + ch * KC, CK, Out, KS, CK, tid);
      else
        tile_out(sc.u + ch * ((long long)CC * V), V, Out, V + 8, V, tid);
      if (is_w) __syncthreads();
    }
  }
}

// ------------------------------------------------------------ bf16 pass 2
// A block of the scan: BV value columns, WARPS = max(8, BV / 4) consumer
// warps, so that every one owns 16 rows of the state and 16 rows of y and o
// (BV 16: 16 and 8 columns; BV 32 and 64: 32 and 16), and one producer warp
// whose lane 0 streams each chunk's operands by TMA into STAGES stages
// behind mbarriers: w, q e^gcs, k e^{gcs_C - gcs} and the masked q k^T as
// boxes of 64 rows x 64 columns in the 128-byte swizzle (eight boxes a
// chunk, 56 KB), this block's columns of u as one dense box.
template <int BV>
struct ScanTile {
  static constexpr int WARPS = BV / 4 > 8 ? BV / 4 : 8;
  static constexpr int CONSUMERS = 32 * WARPS;
  static constexpr int THREADS = CONSUMERS + 32;
  static constexpr int STAGES = 3;
  static constexpr int US = BV + 8;          // bf16 row stride of Sb and Y
  static constexpr int SC = BV * 8 / WARPS;  // state columns a warp owns
  static constexpr int YC = BV * 4 / WARPS;  // columns of y and o a warp owns
  static constexpr int STAGE = 3 * KC + CC * CC + CC * BV;  // bf16 elements (all copied)
  static constexpr int SMEM = 2 * (STAGES * STAGE + (CK + CC) * US) + 64 + ivl::SMEM_ALIGN;
};

// element offset of (r, c) in a [64][64 or 128] bf16 tile held as 64-column
// boxes in the 128-byte swizzle (16-byte chunk j of row r at chunk
// j ^ (r % 8)); c a multiple of 8
__device__ __forceinline__ int swz(int r, int c) {
  return (c >> 6) * (CC * 64) + r * 64 + ((((c & 63) >> 3) ^ (r & 7)) << 3);
}

template <int BV>
__global__ void __launch_bounds__(ScanTile<BV>::THREADS)
delta_chunk_scan_bf16_kernel(const __grid_constant__ CUtensorMap wmap,  // w | qb | kout rows
                             const __grid_constant__ CUtensorMap amap,  // masked q k^T rows
                             const __grid_constant__ CUtensorMap umap,  // u rows
                             ScratchB sc,
                             const float* h0,      // [B, H, CK, V] or null; may be hT
                             bf16* __restrict__ o,  // [B, Tn, H, V]
                             float* hT,            // [B, H, CK, V]
                             int Tn, int H, int V, int N) {
  using P = ScanTile<BV>;
  constexpr int US = P::US, STAGE = P::STAGE, STAGES = P::STAGES;
  constexpr int NT = P::SC / 8;   // n-tiles of the state a warp owns
  constexpr int NTW = P::YC / 8;  // n-tiles of y and o a warp owns
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* base = ivl::aligned_smem(smem_raw);
  bf16* stages = reinterpret_cast<bf16*>(base);  // [W | QB | KO | AT | U] x STAGES
  bf16* Sb = stages + STAGES * STAGE;            // [CK][US]  the state read as bf16
  bf16* Y = Sb + CK * US;                        // [CC][US]  y
  uint64_t* full = reinterpret_cast<uint64_t*>(Y + CC * US);  // a stage has landed
  uint64_t* empty = full + STAGES;                            // its readers are done

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int v0 = blockIdx.y * BV;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  if (tid == 0) {
    for (int i = 0; i < STAGES; ++i) {
      ivl::mbar_init(&full[i], 1);
      ivl::mbar_init(&empty[i], P::WARPS);
    }
    ivl::mbar_fence_init();
  }
  __syncthreads();

  if (warp == P::WARPS) {
    // the producer: chunk n's operands into stage n % STAGES
    if (lane == 0) {
      ivl::prefetch_tensormap(&wmap);
      ivl::prefetch_tensormap(&amap);
      ivl::prefetch_tensormap(&umap);
      const int rows = (int)gridDim.x * N * CC;  // rows of one of w, qb, kout
      for (int n = 0; n < N; ++n) {
        const int s = n % STAGES;
        if (n >= STAGES) ivl::mbar_wait(&empty[s], (n / STAGES - 1) & 1);
        ivl::mbar_arrive_tx(&full[s], 2 * STAGE);
        bf16* st = stages + s * STAGE;
        const int row = (bh * N + n) * CC;
        for (int m = 0; m < 3; ++m)  // w, qb, kout: two boxes each
          for (int c = 0; c < 2; ++c)
            ivl::tma_load_2d(st + m * KC + c * CC * 64, &wmap, &full[s], 64 * c, m * rows + row);
        ivl::tma_load_2d(st + 3 * KC, &amap, &full[s], 0, row);
        ivl::tma_load_2d(st + 3 * KC + CC * CC, &umap, &full[s], v0, row);
      }
    }
    return;
  }

  const int gid = lane >> 2, tig = lane & 3;
  const int mt = warp & 3, yc0 = (warp >> 2) * P::YC;  // y and o: rows 16mt.., columns yc0..
  const int d0 = 16 * (warp & 7) + gid, sc0 = (warp >> 3) * P::SC;  // state rows, columns

  // the fp32 slab in registers: warp w owns rows d0, d0 + 8, column pairs
  // sc0 + 8nt + 2tig, as mma accumulators
  float s[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    float2 lo = make_float2(0.f, 0.f), hi = make_float2(0.f, 0.f);
    if (h0 != nullptr) {
      const size_t off = ((size_t)bh * CK + d0) * V + v0 + sc0 + 8 * nt + 2 * tig;
      lo = *reinterpret_cast<const float2*>(h0 + off);
      hi = *reinterpret_cast<const float2*>(h0 + off + 8 * (size_t)V);
    }
    s[nt][0] = lo.x;
    s[nt][1] = lo.y;
    s[nt][2] = hi.x;
    s[nt][3] = hi.y;
  }

  float keep_n = sc.keep[(long long)bh * N], bend_n = sc.bend[(long long)bh * N];
  const int arow = 16 * mt + (lane & 7) + ((lane >> 3) & 1) * 8;  // A rows (ldmatrix)
  const int acol = (lane >> 4) * 8;
  const int brow = (lane & 7) + ((lane >> 3) & 1) * 8;  // B rows (ldmatrix .trans)
  const int bcol = yc0 + (lane >> 4) * 8;

  for (int n = 0; n < N; ++n) {
    const long long ch = (long long)bh * N + n;
    float keep_next = 1.f, bend_next = 0.f;
    if (n + 1 < N) {  // read a chunk ahead, off the critical path
      keep_next = sc.keep[ch + 1];
      bend_next = sc.bend[ch + 1];
    }
    const int st = n % STAGES;
    const bf16* W = stages + st * STAGE;
    const bf16* QB = W + KC;
    const bf16* KO = QB + KC;
    const bf16* AT = KO + KC;
    const bf16* U = AT + CC * CC;  // [CC][BV], dense

    if (keep_n == 0.f) {  // a segment starts at the chunk's edge: no state enters
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
    }
    // the state as w S and q S read it: rounded to bf16 (its readers of the
    // last chunk are behind the barrier after y)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int col = sc0 + 8 * nt + 2 * tig;
      *reinterpret_cast<uint32_t*>(Sb + d0 * US + col) = pack_bf16(s[nt][0], s[nt][1]);
      *reinterpret_cast<uint32_t*>(Sb + (d0 + 8) * US + col) = pack_bf16(s[nt][2], s[nt][3]);
    }
    ivl::mbar_wait(&full[st], (n / STAGES) & 1);  // chunk n's operands have landed
    ivl::named_sync(1, P::CONSUMERS);  // Sb is whole; chunk n-1 is done with Y

    // w S and (q e^gcs) S: rows 16mt.., columns yc0..
    float ay[NTW][4], ao[NTW][4];
#pragma unroll
    for (int a = 0; a < NTW; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) ay[a][c] = ao[a][c] = 0.f;
#pragma unroll
    for (int ks = 0; ks < CK / 16; ++ks) {
      uint32_t fw[4], fq[4];
      ldsm_x4(fw, smem_u32(W + swz(arow, 16 * ks + acol)));
      ldsm_x4(fq, smem_u32(QB + swz(arow, 16 * ks + acol)));
      if constexpr (NTW >= 2) {
#pragma unroll
        for (int p = 0; p < NTW / 2; ++p) {
          uint32_t fb[4];
          ldsm_x4_trans(fb, smem_u32(Sb + (16 * ks + brow) * US + bcol + 16 * p));
          mma_bf16(ay[2 * p], fw, fb[0], fb[1]);
          mma_bf16(ay[2 * p + 1], fw, fb[2], fb[3]);
          mma_bf16(ao[2 * p], fq, fb[0], fb[1]);
          mma_bf16(ao[2 * p + 1], fq, fb[2], fb[3]);
        }
      } else {
        uint32_t fb[2];
        ldsm_x2_trans(fb, smem_u32(Sb + (16 * ks + brow) * US + yc0));
        mma_bf16(ay[0], fw, fb[0], fb[1]);
        mma_bf16(ao[0], fq, fb[0], fb[1]);
      }
    }
    // y = u - w S, rounded into Y
#pragma unroll
    for (int nt = 0; nt < NTW; ++nt) {
      const int col = yc0 + 8 * nt + 2 * tig;
      const int r0 = 16 * mt + gid;
      const float2 u0 = unpack_bf16(*reinterpret_cast<const uint32_t*>(U + r0 * BV + col));
      const float2 u1 = unpack_bf16(*reinterpret_cast<const uint32_t*>(U + (r0 + 8) * BV + col));
      *reinterpret_cast<uint32_t*>(Y + r0 * US + col) =
          pack_bf16(u0.x - ay[nt][0], u0.y - ay[nt][1]);
      *reinterpret_cast<uint32_t*>(Y + (r0 + 8) * US + col) =
          pack_bf16(u1.x - ay[nt][2], u1.y - ay[nt][3]);
    }
    ivl::named_sync(1, P::CONSUMERS);  // Y is whole; Sb is no longer read

    // o += tril(q k^T ratio) y over the key blocks at or left of the diagonal
    for (int ks = 0; ks <= mt; ++ks) {
      uint32_t fa[4];
      ldsm_x4(fa, smem_u32(AT + swz(arow, 16 * ks + acol)));
      if constexpr (NTW >= 2) {
#pragma unroll
        for (int p = 0; p < NTW / 2; ++p) {
          uint32_t fb[4];
          ldsm_x4_trans(fb, smem_u32(Y + (16 * ks + brow) * US + bcol + 16 * p));
          mma_bf16(ao[2 * p], fa, fb[0], fb[1]);
          mma_bf16(ao[2 * p + 1], fa, fb[2], fb[3]);
        }
      } else {
        uint32_t fb[2];
        ldsm_x2_trans(fb, smem_u32(Y + (16 * ks + brow) * US + yc0));
        mma_bf16(ao[0], fa, fb[0], fb[1]);
      }
    }
#pragma unroll
    for (int nt = 0; nt < NTW; ++nt) {
      const int col = v0 + yc0 + 8 * nt + 2 * tig;
      const int t = n * CC + 16 * mt + gid;
      if (t < Tn)
        *reinterpret_cast<uint32_t*>(o + (((size_t)b * Tn + t) * H + h) * V + col) =
            pack_bf16(ao[nt][0], ao[nt][1]);
      if (t + 8 < Tn)
        *reinterpret_cast<uint32_t*>(o + (((size_t)b * Tn + t + 8) * H + h) * V + col) =
            pack_bf16(ao[nt][2], ao[nt][3]);
    }

    // S' = e^{gcs_C} S + (k e^{gcs_C - gcs})^T y: rows d0.., columns sc0..
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] *= bend_n;
#pragma unroll
    for (int ks = 0; ks < CC / 16; ++ks) {
      uint32_t fk[4];  // A = K^T: rows of KO (keys) transposed
      ldsm_x4_trans(fk, smem_u32(KO + swz(16 * ks + (lane & 7) + (lane >> 4) * 8,
                                          16 * (warp & 7) + ((lane >> 3) & 1) * 8)));
#pragma unroll
      for (int p = 0; p < NT / 2; ++p) {
        uint32_t fb[4];
        ldsm_x4_trans(fb, smem_u32(Y + (16 * ks + brow) * US + sc0 + 16 * p + (lane >> 4) * 8));
        mma_bf16(s[2 * p], fk, fb[0], fb[1]);
        mma_bf16(s[2 * p + 1], fk, fb[2], fb[3]);
      }
    }
    __syncwarp();
    if (lane == 0) ivl::mbar_arrive(&empty[st]);  // this warp is done with the stage
    keep_n = keep_next;
    bend_n = bend_next;
  }

#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const size_t off = ((size_t)bh * CK + d0) * V + v0 + sc0 + 8 * nt + 2 * tig;
    *reinterpret_cast<float2*>(hT + off) = make_float2(s[nt][0], s[nt][1]);
    *reinterpret_cast<float2*>(hT + off + 8 * (size_t)V) = make_float2(s[nt][2], s[nt][3]);
  }
}

// ------------------------------------------------------------ launches
cudaError_t launch_f32(const void* q, const void* k, const void* v, const void* g,
                       const void* beta, const void* seg, const void* h0, void* o, void* hT,
                       Scratch sc, int B, int Tn, int H, int V, int N, float scale,
                       cudaStream_t stream) {
  const int smem1 = P1_SMEM_FLOATS * (int)sizeof(float);
  const int smem2 = P2_SMEM_FLOATS * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      delta_chunk_prep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem1);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(
      delta_chunk_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem2);
  if (err != cudaSuccess) return err;
  delta_chunk_prep_kernel<<<(unsigned)(B * H * N), P1_THREADS, smem1, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)g, (const float*)beta,
      (const int*)seg, sc, Tn, H, V, N, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  delta_chunk_scan_kernel<<<dim3(B * H, V / FBV), P2_THREADS, smem2, stream>>>(
      sc, (const float*)h0, (float*)o, (float*)hT, Tn, H, V, N);
  return cudaGetLastError();
}

template <int BV>
cudaError_t launch_scan_bf16(ScratchB sc, const void* h0, void* o, void* hT, int B, int Tn,
                             int H, int V, int N, cudaStream_t stream) {
  const cuuint64_t nrows = (cuuint64_t)B * H * N * CC;  // rows of one of w, qb, kout, attn, u
  const cuuint64_t wd[2] = {CK, 3 * nrows}, ad[2] = {CC, nrows}, ud[2] = {(cuuint64_t)V, nrows};
  const cuuint64_t ws[1] = {2 * CK}, as[1] = {2 * CC}, us[1] = {2 * (cuuint64_t)V};
  const cuuint32_t box[2] = {64, CC}, ubox[2] = {BV, CC};
  CUtensorMap wmap, amap, umap;
  if (!ivl::make_map(&wmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, sc.w, wd, ws, box,
                     CU_TENSOR_MAP_SWIZZLE_128B) ||
      !ivl::make_map(&amap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, sc.attn, ad, as, box,
                     CU_TENSOR_MAP_SWIZZLE_128B) ||
      !ivl::make_map(&umap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, sc.u, ud, us, ubox,
                     CU_TENSOR_MAP_SWIZZLE_NONE))
    return cudaErrorInvalidValue;
  constexpr int smem = ScanTile<BV>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(delta_chunk_scan_bf16_kernel<BV>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  delta_chunk_scan_bf16_kernel<BV><<<dim3(B * H, V / BV), ScanTile<BV>::THREADS, smem,
                                     stream>>>(wmap, amap, umap, sc, (const float*)h0,
                                               (bf16*)o, (float*)hT, Tn, H, V, N);
  return cudaGetLastError();
}

cudaError_t launch_bf16(const void* q, const void* k, const void* v, const void* g,
                        const void* beta, const void* seg, const void* h0, void* o, void* hT,
                        ScratchB sc, int B, int Tn, int H, int V, int N, float scale, int bv,
                        cudaStream_t stream) {
  const int smem1 = prep_bf16_smem();
  cudaError_t err = cudaFuncSetAttribute(
      delta_chunk_prep_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem1);
  if (err != cudaSuccess) return err;
  delta_chunk_prep_bf16_kernel<<<(unsigned)(B * H * N), B_THREADS, smem1, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const float*)g, (const float*)beta,
      (const int*)seg, sc, Tn, H, V, N, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  switch (bv) {
    case 16: return launch_scan_bf16<16>(sc, h0, o, hT, B, Tn, H, V, N, stream);
    case 32: return launch_scan_bf16<32>(sc, h0, o, hT, B, Tn, H, V, N, stream);
    case 64: return launch_scan_bf16<64>(sc, h0, o, hT, B, Tn, H, V, N, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Kernel C. fp32: `scratch` holds at least 4*B*H*ceil(Tn/64)*(3*8192 + 4096
// + 64*V + 2) bytes, V a multiple of 64; bf16: B*H*ceil(Tn/64)*(2*(3*8192 +
// 4096 + 64*V) + 8) bytes, V a multiple of 64 up to 512, `bv` (16, 32 or
// 64) the value columns a block of the scan. seg [B, Tn] int32 may be null
// (one sequence per row); h0 may be null (zero initial state) and may alias
// hT. Returns a cudaError_t code (0 = success).
int ivl_delta_chunk(int dtype, const void* q, const void* k, const void* v, const void* g,
                    const void* beta, const void* seg, const void* h0, void* o, void* hT,
                    void* scratch, long long scratch_bytes, int B, int Tn, int H, int K,
                    int V, float scale, int bv, void* stream) {
  if (K != CK || V <= 0 || V % 64 != 0 || B <= 0 || H <= 0 || Tn <= 0 || V / 16 > 65535)
    return (int)cudaErrorInvalidValue;
  const int N = (Tn + CC - 1) / CC;
  const long long nch = (long long)B * H * N;
  if (nch > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == ivl::DTYPE_F32) {
    if (scratch_bytes < nch * scratch_per_chunk(V) * (long long)sizeof(float))
      return (int)cudaErrorInvalidValue;
    return (int)launch_f32(q, k, v, g, beta, seg, h0, o, hT, carve((float*)scratch, nch, V), B,
                           Tn, H, V, N, scale, st);
  }
  if (dtype == ivl::DTYPE_BF16) {
    if (V > VMAX_BF16 || (bv != 16 && bv != 32 && bv != 64) ||
        scratch_bytes < nch * scratch_bytes_bf16(V))
      return (int)cudaErrorInvalidValue;
    return (int)launch_bf16(q, k, v, g, beta, seg, h0, o, hT, carve_bf16(scratch, nch, V), B,
                            Tn, H, V, N, scale, bv, st);
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
