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
// All arithmetic in fp32 whatever the input dtype; o in v's dtype, the
// final state fp32.
//
// The Pallas grid (B, H, N) runs its chunks in order on one core. Here
// the work is split where the math allows it:
//   pass 1, one block per (b, h, chunk): everything that needs no state.
//     q, k rows are normalized while they are loaded (one warp per row)
//     and kept transposed in shared memory; k k^T and q k^T are 4x4
//     register tiles; (I + A)^-1 is never formed: each thread owns one
//     column of [k beta e^gcs | v beta] and solves it by forward
//     substitution against A in shared memory (exact for a unit-lower
//     matrix, no barrier between rows), 16 rows at a time in registers
//     with the finished rows parked in shared memory. w, q e^gcs (both
//     transposed), k e^{gcs_C - gcs}, the masked q k^T (transposed), u and
//     e^{gcs_C} go to a scratch buffer in the layouts pass 2 reads.
//   pass 2, one block per (b, h, 64 value columns): the V columns of the
//     state are independent, so each block keeps its [128, 64] fp32 slab
//     of S in shared memory across all chunks and does the three state
//     products of a chunk from shared memory with 4x4 (8x4) register tiles.
//     The chunk's operands arrive by cp.async in two groups, each started
//     as soon as its buffers are free, so the copies run under the
//     previous products (w, q e^gcs and u of chunk n+1 under the masked
//     product and the state update of chunk n; the other two operands of
//     chunk n under its w S and q S).
//   Rows past T in the last chunk are loaded as zeros with beta = g = 0,
//   which makes them inert, so T needs no padding in device memory.
//
//   Bound on the H100: fp32 FMA throughput. One chunk of one head needs
//   16.2 MFLOP (the strictly lower half of k k^T 0.52 and the lower half
//   of q k^T 0.53, the substitution 1.55, w S and q S 4.19 each, the lower
//   half of the masked product 1.06, the state update 4.19); at T = 2048,
//   B = 1, H = 16 that is 8.3 GFLOP against 54.8 MB of inputs and outputs,
//   so the arithmetic (67 TFLOP/s fp32) and not the memory bounds it.
//   Tensor cores would round the fp32 operands (TF32).
#include "common.cuh"

namespace {

using ivl::from_f;
using ivl::to_f;

constexpr int CK = 128;     // key head dim the kernel is written for
constexpr int CC = 64;      // chunk length
constexpr int BV = 64;      // value columns per block of pass 2
constexpr int TSTR = 68;    // row stride of the transposed [CK][CC] tiles in
                            // pass 1 (16-byte aligned rows, spread over banks)
constexpr int KC = CK * CC;  // floats of one [CK][CC] or [CC][CK] tile

constexpr int P1_THREADS = 384;
constexpr int SB = 16;  // rows per block of the forward substitution
constexpr int P1_SMEM_FLOATS = 2 * CK * TSTR + CC * CC + 3 * CC + CC * P1_THREADS;
constexpr int P2_THREADS = 256;
constexpr int P2_SMEM_FLOATS = 3 * KC + CC * CC + 2 * CC * BV + CK * BV;

// floats of scratch per (b, h, chunk): wT, qbT, kout, attnT, u, bend
__host__ __device__ constexpr long long scratch_per_chunk(int V) {
  return 3LL * KC + CC * CC + (long long)CC * V + 1;
}

struct Scratch {
  float* wT;     // [NCH][CK][CC]  w transposed
  float* qbT;    // [NCH][CK][CC]  q scale e^gcs, transposed
  float* kout;   // [NCH][CC][CK]  k e^{gcs_C - gcs}
  float* attnT;  // [NCH][CC][CC]  attnT[j][i] = tril(q k^T ratio)[i][j]
  float* u;      // [NCH][CC][V]
  float* bend;   // [NCH]          e^{gcs_C}
};

__host__ Scratch carve(float* base, long long nch, int V) {
  Scratch s;
  s.wT = base;
  s.qbT = s.wT + nch * KC;
  s.kout = s.qbT + nch * KC;
  s.attnT = s.kout + nch * KC;
  s.u = s.attnT + nch * CC * CC;
  s.bend = s.u + nch * CC * V;
  return s;
}

// ------------------------------------------------------------------ pass 1
template <typename T>
__global__ void __launch_bounds__(P1_THREADS)
delta_chunk_prep_kernel(const T* __restrict__ q,         // [B, Tn, H, CK]
                        const T* __restrict__ k,
                        const T* __restrict__ v,         // [B, Tn, H, V]
                        const float* __restrict__ g,     // [B, Tn, H]
                        const float* __restrict__ beta,  // [B, Tn, H]
                        Scratch sc, int Tn, int H, int V, int N, float scale) {
  extern __shared__ __align__(16) float smem[];
  float* KT = smem;               // [CK][TSTR]  normalized k, transposed
  float* QT = KT + CK * TSTR;     // [CK][TSTR]  normalized q * scale, transposed
  float* AsT = QT + CK * TSTR;    // [CC][CC]    AsT[j][i] = A[i][j], j < i
  float* gcs = AsT + CC * CC;     // [CC]
  float* bet = gcs + CC;          // [CC]
  float* eg = bet + CC;           // [CC]        e^gcs
  float* Wsm = eg + CC;           // [CC][P1_THREADS]  solved rows, a column a thread

  const long long ch = blockIdx.x;  // (b*H + h)*N + n
  const int n = (int)(ch % N);
  const int bh = (int)(ch / N);
  const int h = bh % H, b = bh / H;
  const int t0 = n * CC;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  if (warp == 0) {
    // inclusive scan of the chunk's 64 log-decays, two per lane
    float g0 = 0.f, g1 = 0.f, b0 = 0.f, b1 = 0.f;
    const int ta = t0 + 2 * lane;
    if (ta < Tn) {
      g0 = g[((size_t)b * Tn + ta) * H + h];
      b0 = beta[((size_t)b * Tn + ta) * H + h];
    }
    if (ta + 1 < Tn) {
      g1 = g[((size_t)b * Tn + ta + 1) * H + h];
      b1 = beta[((size_t)b * Tn + ta + 1) * H + h];
    }
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
        qv[e] = to_f(q[off + 32 * e]);
        kv[e] = to_f(k[off + 32 * e]);
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
        // the clamp keeps the masked upper triangle from overflowing
        const float ratio = j <= i ? expf(fminf(gcs[i] - gcs[j], 0.f)) : 0.f;
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
          acc[r] = KT[c * TSTR + r0 + r] * bet[r0 + r] * eg[r0 + r];
      } else {
#pragma unroll
        for (int r = 0; r < SB; ++r) {
          const int t = t0 + r0 + r;
          acc[r] = t < Tn ? to_f(v[(((size_t)b * Tn + t) * H + h) * V + (c - CK)]) * bet[r0 + r]
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
    qb[idx] = QT[d * TSTR + r] * eg[r];
  }
  const float glast = gcs[CC - 1];
  float* ko = sc.kout + ch * KC;
  for (int idx = tid; idx < KC; idx += P1_THREADS) {
    const int r = idx / CK, d = idx % CK;
    ko[idx] = KT[d * TSTR + r] * expf(glast - gcs[r]);
  }
  if (tid == 0) sc.bend[ch] = expf(glast);
}

// ------------------------------------------------------------------ pass 2
__device__ __forceinline__ void store4(float* p, const float x[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float x[4]) {
  uint2 pk;
  pk.x = ivl::pack_bf16(x[0], x[1]);
  pk.y = ivl::pack_bf16(x[2], x[3]);
  *reinterpret_cast<uint2*>(p) = pk;
}

__device__ __forceinline__ void cp_async16(float* smem_dst, const float* src) {
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

template <typename T>
__global__ void __launch_bounds__(P2_THREADS)
delta_chunk_scan_kernel(Scratch sc,
                        const float* h0,     // [B, H, CK, V] or null; may be hT
                        T* __restrict__ o,   // [B, Tn, H, V]
                        float* hT,           // [B, H, CK, V]
                        int Tn, int H, int V, int N) {
  extern __shared__ __align__(16) float smem[];
  float* Ws = smem;          // [CK][CC]  w transposed
  float* Qs = Ws + KC;       // [CK][CC]  q e^gcs transposed
  float* Ko = Qs + KC;       // [CC][CK]  k e^{gcs_C - gcs}
  float* At = Ko + KC;       // [CC][CC]  attn transposed
  float* Yb = At + CC * CC;  // 2 x [CC][BV]  u, then y; chunks alternate
  float* Ss = Yb + 2 * CC * BV;  // [CK][BV]  the state slab

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int v0 = blockIdx.y * BV;
  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;

  // group A of a chunk: w, q e^gcs (transposed) and this block's columns of u
  auto load_a = [&](int n) {
    const long long ch = (long long)bh * N + n;
    copy_async(Ws, sc.wT + ch * KC, KC, tid);
    copy_async(Qs, sc.qbT + ch * KC, KC, tid);
    const float* usrc = sc.u + ch * ((long long)CC * V) + v0;
    float* ydst = Yb + (n & 1) * (CC * BV);
    for (int idx = tid; idx < CC * (BV / 4); idx += P2_THREADS) {
      const int r = idx / (BV / 4), c4 = idx % (BV / 4);
      cp_async16(ydst + 4 * idx, usrc + (size_t)r * V + 4 * c4);
    }
    cp_async_commit();
  };
  load_a(0);

  for (int idx = tid; idx < CK * (BV / 4); idx += P2_THREADS) {
    const int kk = idx / (BV / 4), c4 = idx % (BV / 4);
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (h0 != nullptr)
      val = *reinterpret_cast<const float4*>(&h0[((size_t)bh * CK + kk) * V + v0 + 4 * c4]);
    reinterpret_cast<float4*>(Ss)[idx] = val;
  }

  for (int n = 0; n < N; ++n) {
    const long long ch = (long long)bh * N + n;
    float* Ys = Yb + (n & 1) * (CC * BV);
    // group B: the operands of the masked product and of the state update;
    // their buffers were released by the barrier that ended the last chunk
    copy_async(Ko, sc.kout + ch * KC, KC, tid);
    copy_async(At, sc.attnT + ch * (CC * CC), CC * CC, tid);
    cp_async_commit();
    const float be = sc.bend[ch];
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
      const float4 s4 = *reinterpret_cast<const float4*>(&Ss[kk * BV + 4 * tx]);
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
      float* yrow = &Ys[(4 * ty + a) * BV + 4 * tx];
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
      const float4 y4 = *reinterpret_cast<const float4*>(&Ys[j * BV + 4 * tx]);
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
      const float4 y4 = *reinterpret_cast<const float4*>(&Ys[j * BV + 4 * tx]);
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
      float* srow = &Ss[(8 * ty + e) * BV + 4 * tx];
      const float4 s4 = *reinterpret_cast<const float4*>(srow);
      *reinterpret_cast<float4*>(srow) =
          make_float4(be * s4.x + as[e][0], be * s4.y + as[e][1],
                      be * s4.z + as[e][2], be * s4.w + as[e][3]);
    }
    __syncthreads();  // this chunk's readers are done; S is whole
  }

  for (int idx = tid; idx < CK * (BV / 4); idx += P2_THREADS) {
    const int kk = idx / (BV / 4), c4 = idx % (BV / 4);
    *reinterpret_cast<float4*>(&hT[((size_t)bh * CK + kk) * V + v0 + 4 * c4]) =
        reinterpret_cast<const float4*>(Ss)[idx];
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, const void* g,
                   const void* beta, const void* h0, void* o, void* hT,
                   Scratch sc, int B, int Tn, int H, int V, int N, float scale,
                   cudaStream_t stream) {
  const int smem1 = P1_SMEM_FLOATS * (int)sizeof(float);
  const int smem2 = P2_SMEM_FLOATS * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      delta_chunk_prep_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem1);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(
      delta_chunk_scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem2);
  if (err != cudaSuccess) return err;
  delta_chunk_prep_kernel<T><<<(unsigned)(B * H * N), P1_THREADS, smem1, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const float*)g, (const float*)beta,
      sc, Tn, H, V, N, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  delta_chunk_scan_kernel<T><<<dim3(B * H, V / BV), P2_THREADS, smem2, stream>>>(
      sc, (const float*)h0, (T*)o, (float*)hT, Tn, H, V, N);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Kernel C. `scratch` holds at least B*H*ceil(Tn/64)*(3*8192 + 4096 + 64*V + 1)
// floats; h0 may be null (zero initial state) and may alias hT. Returns a
// cudaError_t code (0 = success).
int ivl_delta_chunk(int dtype, const void* q, const void* k, const void* v,
                    const void* g, const void* beta, const void* h0, void* o,
                    void* hT, void* scratch, long long scratch_floats, int B,
                    int Tn, int H, int K, int V, float scale, void* stream) {
  if (K != CK || V <= 0 || V % BV != 0 || B <= 0 || H <= 0 || Tn <= 0 ||
      V / BV > 65535)
    return (int)cudaErrorInvalidValue;
  const int N = (Tn + CC - 1) / CC;
  const long long nch = (long long)B * H * N;
  if (nch > 0x7fffffffLL || scratch_floats < nch * scratch_per_chunk(V))
    return (int)cudaErrorInvalidValue;
  const Scratch sc = carve((float*)scratch, nch, V);
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == ivl::DTYPE_F32)
    return (int)launch<float>(q, k, v, g, beta, h0, o, hT, sc, B, Tn, H, V, N, scale, st);
  if (dtype == ivl::DTYPE_BF16)
    return (int)launch<__nv_bfloat16>(q, k, v, g, beta, h0, o, hT, sc, B, Tn, H, V, N,
                                      scale, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
