// Flash attention for Hopper (sm_90a): non-causal softmax attention
// softmax(q k^T * dh^-0.5) v per (sequence, head), with no mask, bias or
// segment ids, and its gradients, in three kernels and no atomics, so that
// a gradient is bitwise the same from call to call.
//
// Replaces the three TPU kernels of jax's
// jax/experimental/pallas/ops/tpu/flash_attention.py that the JAX package's
// TemporalLifter(flash=True) reaches (pose3d_tpu/models/temporal.py:84):
// - flash_fwd_kernel: _flash_attention_impl's pallas_call (:758) over
//   _flash_attention_kernel (:331): O and the softmax residuals. Here the
//   residual is one f32 log-sum-exp a row (JAX keeps its l and m apart);
// - flash_dkv_kernel: _flash_attention_bwd_dkv's pallas_call (:1121) over
//   _flash_attention_dkv_kernel (:796): dK and dV;
// - flash_dq_kernel: _flash_attention_bwd_dq's pallas_call (:1456) over
//   _flash_attention_dq_kernel (:1146): dQ (JAX's dS output, which ab=None
//   discards, is not formed).
// D = rowsum(dO * O) stays a PyTorch op (ops/flash_attention.py), as JAX
// computes it outside its kernels (flash_attention.py:273-275). A TPU grid
// walks its K/V axis in order and carries the row max and sum in scratch
// from step to step; here a block loops over the K/V (or Q) tiles itself
// and carries them in registers. The TPU kernel needs the K/V length to be
// a multiple of 128; these take any lengths and mask the partial last tile.
//
// What bounds them on this card. At the long-clip path's shape (2 clips x
// 2048 frames: 34 sequences x 8 heads, dh = 32) the forward does two
// products, 146 GFLOP (0.148 ms at 989 TFLOP/s), and one exponential per
// score, 1.14 G, which the SFU's 16 a clock an SM take ~0.27 ms at 1.98 GHz;
// it moves ~145 MB (0.043 ms at 3.35 TB/s). At dh = 32 the exponentials,
// not the tensor cores, set the floor; each backward kernel recomputes the
// exponentials beside its products (dK/dV: S, dV, dP, dK; dQ: S, dP, dQ).
// The design therefore keeps every score in registers and spends nothing
// on the L x L matrices beyond the products and one ex2 a score:
// - Q (or, in dK/dV, K and V) never enters shared memory: each warp loads
//   the A fragments of its 16 rows straight from device memory into
//   registers; shared memory holds the streamed K/V (or Q/dO) tiles of 64
//   rows, double-buffered by cp.async, so a tile's loads overlap the
//   previous tile's products;
// - a forward or dQ block takes up to 128 query rows (8 warps), so each
//   K/V tile that enters shared memory serves 8 warps;
// - mma.sync m16n8k16, bf16 in and f32 accumulate. Scores leave their
//   accumulators as the A operand of the next product (their C layout is
//   the A layout); P (forward, dV) and dS (dQ, dK) are rounded to bf16 for
//   it, and only those roundings, and the outputs', differ from f32 math;
// - exp(s * scale - m) as ex2.approx of s * scale * log2(e) - m', the scale
//   folded into one multiply; a key past the sequence gets -inf (its ex2 is
//   0) and the padded rows of a tile are zero, so every product is finite.
// The forward keeps an online row max and sum in f32 (rows g and g + 8 of
// each warp's tile, shared by the four lanes of a quad) and rescales its
// accumulators by ex2(m_old - m_new) when the max moves.
//
// Layout: q, k and v are strided (N, L, heads * dh) views, head h at
// columns [h * dh, (h + 1) * dh), rows `row` elements apart and sequences
// `seq` apart: the [q | k | v] rows of one qkv projection, or k and v from
// separate [k | v] rows of another length. dq has q's strides, dk and dv
// k's; o and dO are contiguous (N, Lq, heads * dh); the log-sum-exp and D
// are contiguous f32 (N, heads, Lq). The launchers run on the caller's
// stream, do not synchronise, allocate nothing, and return
// cudaGetLastError() (or cudaErrorInvalidValue for what they refuse).

#include "common.cuh"

namespace {

using namespace pose3d;

constexpr int kRowWarps = 8;   // the most warps of a forward / dQ block: 128 query rows
constexpr int kKeyWarps = 4;   // the most warps of a dK/dV block: 64 keys
constexpr int kTile = 64;      // rows of a streamed K/V or Q/dO tile
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

struct Rows {
  long long seq, row;  // element strides between sequences and between rows
};

template <int DH>
__host__ __device__ constexpr float head_scale() {
  return DH == 16 ? 0.25f : DH == 32 ? 0.17677669529663687f : 0.125f;
}

// shared-memory pitch of a tile row: 16 bytes of skew keep the 8 rows of
// an ldmatrix on distinct banks
template <int DH>
__host__ __device__ constexpr int pitch() {
  return DH + 8;
}

__device__ __forceinline__ float inf() { return __int_as_float(0x7f800000); }

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

__device__ __forceinline__ unsigned pack_bf16(float a, float b) {
  __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<unsigned*>(&h);
}

// The A fragments of rows [r0, r0 + 16) x DH of a strided bf16 matrix,
// from device memory: registers (row g, column 2q), (g + 8, 2q), (g, 2q +
// 8), (g + 8, 2q + 8) of each k16 step; rows at or past n are zero.
template <int DH>
__device__ __forceinline__ void load_a(const bf16* base, long long row, int r0, int n, int g,
                                       int q4, unsigned (&a)[DH / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = r0 + g + (i & 1) * 8;
      const int c = kk * 16 + 2 * q4 + (i >> 1) * 8;
      a[kk][i] = r < n ? __ldg(reinterpret_cast<const unsigned*>(base + r * row + c)) : 0u;
    }
}

// Rows [r0, r0 + kTile) of a strided bf16 matrix into a shared tile by
// cp.async (the caller commits); rows at or past n are zeroed by plain
// stores, which the barrier after the wait publishes.
template <int DH>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, long long row, int r0,
                                          int n) {
  constexpr int chunks = kTile * DH / 8;
  for (int i = threadIdx.x; i < chunks; i += blockDim.x) {
    const int r = i / (DH / 8);
    const int c = (i % (DH / 8)) * 8;
    bf16* d = dst + r * pitch<DH>() + c;
    if (r0 + r < n) cp_async16(d, src + (r0 + r) * row + c);
    else *reinterpret_cast<uint4*>(d) = make_uint4(0, 0, 0, 0);
  }
}

// s (16 x 64) = a (16 x DH, registers) @ tile^T, the tile's 64 rows as the
// columns: B fragments by ldmatrix from the rows. `lane_addr` is the
// tile's shared address plus this lane's non-transposed offset.
template <int DH>
__device__ __forceinline__ void tile_scores(const unsigned (&a)[DH / 16][4], unsigned lane_addr,
                                            float (&s)[8][4]) {
#pragma unroll
  for (int nb = 0; nb < 8; ++nb)
#pragma unroll
    for (int i = 0; i < 4; ++i) s[nb][i] = 0.f;
#pragma unroll
  for (int kb = 0; kb < 4; ++kb)
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      unsigned f[4];
      ldsm_x4(f, lane_addr + (kb * 16 * pitch<DH>() + kk * 16) * 2);
      mma_bf16(s[2 * kb], a[kk], f[0], f[1]);
      mma_bf16(s[2 * kb + 1], a[kk], f[2], f[3]);
    }
}

// acc (16 x DH) += bf16(p) (16 x 64, accumulator layout) @ tile (64 x DH):
// B fragments by transposing ldmatrix. `lane_addr` is the tile's shared
// address plus this lane's transposed offset.
template <int DH>
__device__ __forceinline__ void tile_accumulate(const float (&p)[8][4], unsigned lane_addr,
                                                float (&acc)[DH / 8][4]) {
#pragma unroll
  for (int kb = 0; kb < 4; ++kb) {
    const unsigned pa[4] = {pack_bf16(p[2 * kb][0], p[2 * kb][1]),
                            pack_bf16(p[2 * kb][2], p[2 * kb][3]),
                            pack_bf16(p[2 * kb + 1][0], p[2 * kb + 1][1]),
                            pack_bf16(p[2 * kb + 1][2], p[2 * kb + 1][3])};
#pragma unroll
    for (int d = 0; d < DH / 16; ++d) {
      unsigned f[4];
      ldsm_x4_trans(f, lane_addr + (kb * 16 * pitch<DH>() + d * 16) * 2);
      mma_bf16(acc[2 * d], pa, f[0], f[1]);
      mma_bf16(acc[2 * d + 1], pa, f[2], f[3]);
    }
  }
}

// this lane's ldmatrix offsets (bytes) into a tile: non-transposed (rows
// as B columns) and transposed (rows as the k dimension)
template <int DH>
__device__ __forceinline__ unsigned rows_offset(int lane) {
  return (((lane / 16) * 8 + lane % 8) * pitch<DH>() + ((lane / 8) % 2) * 8) * 2;
}

template <int DH>
__device__ __forceinline__ unsigned trans_offset(int lane) {
  return ((lane % 16) * pitch<DH>() + (lane / 16) * 8) * 2;
}

// rows g and g + 8 of a 16-row accumulator, times `scale`, to a strided
// bf16 matrix; rows at or past n are not written
template <int DH>
__device__ __forceinline__ void store_rows(bf16* base, long long row, int r0, int n, int g,
                                           int q4, const float (&acc)[DH / 8][4], float s0,
                                           float s1) {
#pragma unroll
  for (int nb = 0; nb < DH / 8; ++nb) {
    const int c = nb * 8 + 2 * q4;
    if (r0 + g < n) store2(base + (r0 + g) * row + c, acc[nb][0] * s0, acc[nb][1] * s0);
    if (r0 + g + 8 < n)
      store2(base + (r0 + g + 8) * row + c, acc[nb][2] * s1, acc[nb][3] * s1);
  }
}

// One block per (sequence, head, tile of 16·warps query rows).
template <int DH>
__global__ void __launch_bounds__(kRowWarps * 32)
flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, Rows qs, Rows kvs, bf16* __restrict__ o,
                 float* __restrict__ lse, int Lq, int Lk, int heads) {
  __shared__ __align__(16) bf16 ksm[2][kTile * pitch<DH>()];
  __shared__ __align__(16) bf16 vsm[2][kTile * pitch<DH>()];
  const int bm = blockDim.x / 2;  // 16 rows a warp
  const int n_qt = (Lq + bm - 1) / bm;
  const int qt = blockIdx.x % n_qt;
  const int h = (blockIdx.x / n_qt) % heads;
  const long long n = blockIdx.x / n_qt / heads;
  const int dim = heads * DH;
  const bf16* kb = k + n * kvs.seq + h * DH;
  const bf16* vb = v + n * kvs.seq + h * DH;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane / 4, q4 = lane % 4;
  const int r0 = qt * bm + warp * 16;
  const int n_kt = (Lk + kTile - 1) / kTile;
  constexpr float sl = head_scale<DH>() * kLog2e;

  load_tile<DH>(ksm[0], kb, kvs.row, 0, Lk);
  load_tile<DH>(vsm[0], vb, kvs.row, 0, Lk);
  cp_async_commit();
  unsigned qa[DH / 16][4];
  load_a<DH>(q + n * qs.seq + h * DH, qs.row, r0, Lq, g, q4, qa);
  float acc[DH / 8][4] = {};
  float m0 = -inf(), m1 = -inf(), l0 = 0.f, l1 = 0.f;
  const unsigned ro = rows_offset<DH>(lane), to = trans_offset<DH>(lane);

  for (int kt = 0; kt < n_kt; ++kt) {
    if (kt + 1 < n_kt) {
      load_tile<DH>(ksm[(kt + 1) & 1], kb, kvs.row, (kt + 1) * kTile, Lk);
      load_tile<DH>(vsm[(kt + 1) & 1], vb, kvs.row, (kt + 1) * kTile, Lk);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    float s[8][4];
    tile_scores<DH>(qa, smem_u32(ksm[kt & 1]) + ro, s);
    // scores in log2 units; keys past Lk -inf (every tile has a key
    // below Lk, so each row's max is finite)
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int nb = 0; nb < 8; ++nb)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float x = s[nb][i] * sl;
        if (kt * kTile + nb * 8 + 2 * q4 + (i & 1) >= Lk) x = -inf();
        s[nb][i] = x;
      }
#pragma unroll
    for (int nb = 0; nb < 8; ++nb) {
      mx0 = fmaxf(mx0, fmaxf(s[nb][0], s[nb][1]));
      mx1 = fmaxf(mx1, fmaxf(s[nb][2], s[nb][3]));
    }
    mx0 = quad_max(mx0);
    mx1 = quad_max(mx1);
    const float a0 = ex2(m0 - mx0), a1 = ex2(m1 - mx1);  // 0 on the first tile
    m0 = mx0;
    m1 = mx1;
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int nb = 0; nb < 8; ++nb) {
      s[nb][0] = ex2(s[nb][0] - m0);
      s[nb][1] = ex2(s[nb][1] - m0);
      s[nb][2] = ex2(s[nb][2] - m1);
      s[nb][3] = ex2(s[nb][3] - m1);
      rs0 += s[nb][0] + s[nb][1];
      rs1 += s[nb][2] + s[nb][3];
    }
    l0 = l0 * a0 + rs0;
    l1 = l1 * a1 + rs1;
#pragma unroll
    for (int nb = 0; nb < DH / 8; ++nb) {
      acc[nb][0] *= a0;
      acc[nb][1] *= a0;
      acc[nb][2] *= a1;
      acc[nb][3] *= a1;
    }
    tile_accumulate<DH>(s, smem_u32(vsm[kt & 1]) + to, acc);
    __syncthreads();  // every warp is done with this stage before it is refilled
  }
  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  store_rows<DH>(o + n * Lq * dim + h * DH, dim, r0, Lq, g, q4, acc, 1.f / l0, 1.f / l1);
  if (q4 == 0) {
    float* lb = lse + (n * heads + h) * Lq;
    if (r0 + g < Lq) lb[r0 + g] = (m0 + __log2f(l0)) * kLn2;
    if (r0 + g + 8 < Lq) lb[r0 + g + 8] = (m1 + __log2f(l1)) * kLn2;
  }
}

// One block per (sequence, head, tile of 16·warps query rows): dQ =
// scale · Σ_keys bf16(P ∘ (dO V^T - D)) K, P recomputed from the
// log-sum-exp. Two blocks an SM (128 registers a thread) at dh <= 32,
// where ptxas otherwise took 80 and spilled; one at dh = 64, which needs
// more.
template <int DH>
__global__ void __launch_bounds__(kRowWarps * 32, DH == 64 ? 1 : 2)
flash_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, Rows qs, Rows kvs, const bf16* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ delta,
                bf16* __restrict__ dq, int Lq, int Lk, int heads) {
  __shared__ __align__(16) bf16 ksm[2][kTile * pitch<DH>()];
  __shared__ __align__(16) bf16 vsm[2][kTile * pitch<DH>()];
  const int bm = blockDim.x / 2;
  const int n_qt = (Lq + bm - 1) / bm;
  const int qt = blockIdx.x % n_qt;
  const int h = (blockIdx.x / n_qt) % heads;
  const long long n = blockIdx.x / n_qt / heads;
  const int dim = heads * DH;
  const bf16* kb = k + n * kvs.seq + h * DH;
  const bf16* vb = v + n * kvs.seq + h * DH;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane / 4, q4 = lane % 4;
  const int r0 = qt * bm + warp * 16;
  const int n_kt = (Lk + kTile - 1) / kTile;
  constexpr float sl = head_scale<DH>() * kLog2e;

  load_tile<DH>(ksm[0], kb, kvs.row, 0, Lk);
  load_tile<DH>(vsm[0], vb, kvs.row, 0, Lk);
  cp_async_commit();
  unsigned qa[DH / 16][4], da[DH / 16][4];
  load_a<DH>(q + n * qs.seq + h * DH, qs.row, r0, Lq, g, q4, qa);
  load_a<DH>(dout + n * Lq * dim + h * DH, dim, r0, Lq, g, q4, da);
  const long long stat = (n * heads + h) * Lq;
  // rows past Lq: zero q and dO, so their dS is 0 whatever these are
  const float lse0 = r0 + g < Lq ? lse[stat + r0 + g] * kLog2e : 0.f;
  const float lse1 = r0 + g + 8 < Lq ? lse[stat + r0 + g + 8] * kLog2e : 0.f;
  const float d0 = r0 + g < Lq ? delta[stat + r0 + g] : 0.f;
  const float d1 = r0 + g + 8 < Lq ? delta[stat + r0 + g + 8] : 0.f;
  float acc[DH / 8][4] = {};
  const unsigned ro = rows_offset<DH>(lane), to = trans_offset<DH>(lane);

  for (int kt = 0; kt < n_kt; ++kt) {
    if (kt + 1 < n_kt) {
      load_tile<DH>(ksm[(kt + 1) & 1], kb, kvs.row, (kt + 1) * kTile, Lk);
      load_tile<DH>(vsm[(kt + 1) & 1], vb, kvs.row, (kt + 1) * kTile, Lk);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    float s[8][4], dp[8][4];
    tile_scores<DH>(qa, smem_u32(ksm[kt & 1]) + ro, s);
    tile_scores<DH>(da, smem_u32(vsm[kt & 1]) + ro, dp);
#pragma unroll
    for (int nb = 0; nb < 8; ++nb)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float p = ex2(s[nb][i] * sl - (i < 2 ? lse0 : lse1));
        if (kt * kTile + nb * 8 + 2 * q4 + (i & 1) >= Lk) p = 0.f;
        s[nb][i] = p * (dp[nb][i] - (i < 2 ? d0 : d1));
      }
    tile_accumulate<DH>(s, smem_u32(ksm[kt & 1]) + to, acc);
    __syncthreads();
  }
  constexpr float sc = head_scale<DH>();
  store_rows<DH>(dq + n * qs.seq + h * DH, qs.row, r0, Lq, g, q4, acc, sc, sc);
}

// One block per (sequence, head, tile of 16·warps keys); each warp holds
// its 16 keys' K and V as A fragments and streams the Q and dO tiles:
// dV = Σ_q bf16(P)^T dO and dK = scale · Σ_q bf16(P ∘ (dO V^T - D))^T Q,
// both formed as (keys x queries) products.
template <int DH>
__global__ void __launch_bounds__(kKeyWarps * 32)
flash_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, Rows qs, Rows kvs, const bf16* __restrict__ dout,
                 const float* __restrict__ lse, const float* __restrict__ delta,
                 bf16* __restrict__ dk, bf16* __restrict__ dv, int Lq, int Lk, int heads) {
  __shared__ __align__(16) bf16 qsm[2][kTile * pitch<DH>()];
  __shared__ __align__(16) bf16 dsm[2][kTile * pitch<DH>()];
  __shared__ float lsm[2][kTile];
  __shared__ float dlt[2][kTile];
  const int bn = blockDim.x / 2;
  const int n_kt = (Lk + bn - 1) / bn;
  const int kt = blockIdx.x % n_kt;
  const int h = (blockIdx.x / n_kt) % heads;
  const long long n = blockIdx.x / n_kt / heads;
  const int dim = heads * DH;
  const bf16* qb = q + n * qs.seq + h * DH;
  const bf16* db = dout + n * Lq * dim + h * DH;
  const long long stat = (n * heads + h) * Lq;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane / 4, q4 = lane % 4;
  const int k0 = kt * bn + warp * 16;
  const int n_qt = (Lq + kTile - 1) / kTile;
  constexpr float sl = head_scale<DH>() * kLog2e;

  // a stage: the Q and dO tiles by cp.async, the log-sum-exp (log2 units;
  // +inf past Lq, so P is 0 there) and D by plain loads
  auto load_stage = [&](int t, int st) {
    load_tile<DH>(qsm[st], qb, qs.row, t * kTile, Lq);
    load_tile<DH>(dsm[st], db, dim, t * kTile, Lq);
    cp_async_commit();
    for (int i = threadIdx.x; i < 2 * kTile; i += blockDim.x) {
      const int r = t * kTile + i % kTile;
      if (i < kTile) lsm[st][i] = r < Lq ? lse[stat + r] * kLog2e : inf();
      else dlt[st][i - kTile] = r < Lq ? delta[stat + r] : 0.f;
    }
  };
  load_stage(0, 0);
  unsigned ka[DH / 16][4], va[DH / 16][4];
  load_a<DH>(k + n * kvs.seq + h * DH, kvs.row, k0, Lk, g, q4, ka);
  load_a<DH>(v + n * kvs.seq + h * DH, kvs.row, k0, Lk, g, q4, va);
  float dka[DH / 8][4] = {}, dva[DH / 8][4] = {};
  const unsigned ro = rows_offset<DH>(lane), to = trans_offset<DH>(lane);

  for (int t = 0; t < n_qt; ++t) {
    const int st = t & 1;
    if (t + 1 < n_qt) {
      load_stage(t + 1, st ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    float s[8][4], dp[8][4];
    tile_scores<DH>(ka, smem_u32(qsm[st]) + ro, s);   // S^T: keys x queries
    tile_scores<DH>(va, smem_u32(dsm[st]) + ro, dp);  // (dO V^T)^T
#pragma unroll
    for (int nb = 0; nb < 8; ++nb)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int c = nb * 8 + 2 * q4 + (i & 1);
        const float p = ex2(s[nb][i] * sl - lsm[st][c]);
        s[nb][i] = p;
        dp[nb][i] = p * (dp[nb][i] - dlt[st][c]);
      }
    tile_accumulate<DH>(s, smem_u32(dsm[st]) + to, dva);   // P^T dO
    tile_accumulate<DH>(dp, smem_u32(qsm[st]) + to, dka);  // dS^T Q
    __syncthreads();
  }
  constexpr float sc = head_scale<DH>();
  store_rows<DH>(dk + n * kvs.seq + h * DH, kvs.row, k0, Lk, g, q4, dka, sc, sc);
  store_rows<DH>(dv + n * kvs.seq + h * DH, kvs.row, k0, Lk, g, q4, dva, 1.f, 1.f);
}

// blocks of `warps` warps (the most, or fewer where the rows are fewer)
// over `n * heads` (sequence, head) pairs and their tiles of 16·warps rows
bool grid_of(int n, int heads, int rows, int most, int& warps, unsigned& blocks) {
  warps = min(most, (rows + 15) / 16);
  const long long tiles = (rows + 16LL * warps - 1) / (16LL * warps);
  const long long total = static_cast<long long>(n) * heads * tiles;
  if (total > 0x7fffffffLL) return false;
  blocks = static_cast<unsigned>(total);
  return true;
}

bool valid(int n, int Lq, int Lk, int heads, int dh, Rows qs, Rows kvs) {
  const bool aligned = qs.seq % 8 == 0 && qs.row % 8 == 0 && kvs.seq % 8 == 0 &&
                       kvs.row % 8 == 0;
  return n >= 0 && Lq >= 1 && Lk >= 1 && heads >= 1 && aligned &&
         (dh == 16 || dh == 32 || dh == 64);
}

template <int DH>
cudaError_t fwd_dh(const bf16* q, const bf16* k, const bf16* v, Rows qs, Rows kvs, bf16* o,
                   float* lse, int n, int Lq, int Lk, int heads, cudaStream_t stream) {
  int warps;
  unsigned blocks;
  if (!grid_of(n, heads, Lq, kRowWarps, warps, blocks)) return cudaErrorInvalidValue;
  flash_fwd_kernel<DH><<<blocks, warps * 32, 0, stream>>>(q, k, v, qs, kvs, o, lse, Lq, Lk,
                                                          heads);
  return cudaGetLastError();
}

template <int DH>
cudaError_t dq_dh(const bf16* q, const bf16* k, const bf16* v, Rows qs, Rows kvs,
                  const bf16* dout, const float* lse, const float* delta, bf16* dq, int n,
                  int Lq, int Lk, int heads, cudaStream_t stream) {
  int warps;
  unsigned blocks;
  if (!grid_of(n, heads, Lq, kRowWarps, warps, blocks)) return cudaErrorInvalidValue;
  flash_dq_kernel<DH><<<blocks, warps * 32, 0, stream>>>(q, k, v, qs, kvs, dout, lse, delta,
                                                         dq, Lq, Lk, heads);
  return cudaGetLastError();
}

template <int DH>
cudaError_t dkv_dh(const bf16* q, const bf16* k, const bf16* v, Rows qs, Rows kvs,
                   const bf16* dout, const float* lse, const float* delta, bf16* dk, bf16* dv,
                   int n, int Lq, int Lk, int heads, cudaStream_t stream) {
  int warps;
  unsigned blocks;
  if (!grid_of(n, heads, Lk, kKeyWarps, warps, blocks)) return cudaErrorInvalidValue;
  flash_dkv_kernel<DH><<<blocks, warps * 32, 0, stream>>>(q, k, v, qs, kvs, dout, lse, delta,
                                                          dk, dv, Lq, Lk, heads);
  return cudaGetLastError();
}

using B = const pose3d::bf16*;

}  // namespace

// q (k, v): strided (n, Lq (Lk), heads * dh) bf16 views, rows q_row (kv_row)
// elements apart and sequences q_seq (kv_seq) apart, every stride a
// multiple of 8 elements and every pointer 16-byte aligned; o: contiguous
// (n, Lq, heads * dh) bf16; lse: contiguous (n, heads, Lq) f32. Launches on
// the calling thread's current device, which must hold the operands.
extern "C" cudaError_t flash_fwd_launch(const void* q, const void* k, const void* v,
                                        long long q_seq, long long q_row, long long kv_seq,
                                        long long kv_row, void* o, void* lse, int n, int Lq,
                                        int Lk, int heads, int dh, void* stream) {
  const Rows qs{q_seq, q_row}, kvs{kv_seq, kv_row};
  if (!valid(n, Lq, Lk, heads, dh, qs, kvs)) return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  auto* out = static_cast<pose3d::bf16*>(o);
  auto* l = static_cast<float*>(lse);
  auto s = static_cast<cudaStream_t>(stream);
  switch (dh) {
    case 16: return fwd_dh<16>(B(q), B(k), B(v), qs, kvs, out, l, n, Lq, Lk, heads, s);
    case 32: return fwd_dh<32>(B(q), B(k), B(v), qs, kvs, out, l, n, Lq, Lk, heads, s);
    default: return fwd_dh<64>(B(q), B(k), B(v), qs, kvs, out, l, n, Lq, Lk, heads, s);
  }
}

// As flash_fwd_launch; dout: contiguous (n, Lq, heads * dh) bf16; lse and
// delta: contiguous (n, heads, Lq) f32; dq has q's strides.
extern "C" cudaError_t flash_bwd_dq_launch(const void* q, const void* k, const void* v,
                                           long long q_seq, long long q_row, long long kv_seq,
                                           long long kv_row, const void* dout, const void* lse,
                                           const void* delta, void* dq, int n, int Lq, int Lk,
                                           int heads, int dh, void* stream) {
  const Rows qs{q_seq, q_row}, kvs{kv_seq, kv_row};
  if (!valid(n, Lq, Lk, heads, dh, qs, kvs)) return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  auto* l = static_cast<const float*>(lse);
  auto* d = static_cast<const float*>(delta);
  auto* out = static_cast<pose3d::bf16*>(dq);
  auto s = static_cast<cudaStream_t>(stream);
  switch (dh) {
    case 16: return dq_dh<16>(B(q), B(k), B(v), qs, kvs, B(dout), l, d, out, n, Lq, Lk, heads, s);
    case 32: return dq_dh<32>(B(q), B(k), B(v), qs, kvs, B(dout), l, d, out, n, Lq, Lk, heads, s);
    default: return dq_dh<64>(B(q), B(k), B(v), qs, kvs, B(dout), l, d, out, n, Lq, Lk, heads, s);
  }
}

// As flash_bwd_dq_launch; dk and dv have k's strides.
extern "C" cudaError_t flash_bwd_dkv_launch(const void* q, const void* k, const void* v,
                                            long long q_seq, long long q_row, long long kv_seq,
                                            long long kv_row, const void* dout, const void* lse,
                                            const void* delta, void* dk, void* dv, int n, int Lq,
                                            int Lk, int heads, int dh, void* stream) {
  const Rows qs{q_seq, q_row}, kvs{kv_seq, kv_row};
  if (!valid(n, Lq, Lk, heads, dh, qs, kvs)) return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  auto* l = static_cast<const float*>(lse);
  auto* d = static_cast<const float*>(delta);
  auto* ok = static_cast<pose3d::bf16*>(dk);
  auto* ov = static_cast<pose3d::bf16*>(dv);
  auto s = static_cast<cudaStream_t>(stream);
  switch (dh) {
    case 16:
      return dkv_dh<16>(B(q), B(k), B(v), qs, kvs, B(dout), l, d, ok, ov, n, Lq, Lk, heads, s);
    case 32:
      return dkv_dh<32>(B(q), B(k), B(v), qs, kvs, B(dout), l, d, ok, ov, n, Lq, Lk, heads, s);
    default:
      return dkv_dh<64>(B(q), B(k), B(v), qs, kvs, B(dout), l, d, ok, ov, n, Lq, Lk, heads, s);
  }
}
